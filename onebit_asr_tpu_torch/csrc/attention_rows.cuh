// The query-major kernel of the fused rel-pos attention: one CTA of 4 warps
// per (64 query rows, h, b), the keys walked in tiles of 64. Its modes (bit
// flags, template argument) make it the forward (row 3, csrc/attention.cu)
// and the first stage of the backward (row 4, csrc/attention_bwd.cu):
//   M_OUT        pass 2 forms out = bf16(bf16(dropout(attn)) v)
//   M_ROWDOT     pass 2 forms rowdot = sum_s dropout(g v^T) * attn
//   M_STATS_IN   each row's max and sum are read, not computed (no pass 1)
//   M_STATS_OUT  each row's max and sum are written
// Pass 1 (every mode but M_STATS_IN) is one piece of code, so the max and
// sum the training forward writes are the bits the backward would compute.
//
// Per (query tile, key tile) it forms the f32 scores of `_fwd_kernel`:
//   s = (qu k^T + bd) * scale (__fadd_rn, then __fmul_rn), qu = bf16(q + u),
//   bd[t, s'] = (qv p^T)[t, T-1-t+s'], qv = bf16(q + vb),
//   masked keys NEG (replaced), keys past T absent (-inf).
// The skew: the tile pair needs the 127 p rows from T-64-t0+s0 (the band),
// two blocks of 64 rows, Z_kt and Z_kt+1 with Z_n = rows [T-64-t0+64n, +64).
// Consecutive key tiles share a block, so the blocks stream through a ring
// of 4 slots, one new block a tile (two at a pass's start). Each warp
// multiplies its 16 qv rows by the 80 band rows they reach and writes the
// [16 x 80] product shifted by row (column 15 - i + s' -> s') into its own
// f32 scratch, from which bd is read in the layout of the scores.
//
// Fragments come from row-major padded tiles by ldmatrix (v by .trans for
// P v), no transposed copy; k, v, the band blocks, the key mask and the
// dropout bytes of tile i+1 are in flight (cp.async) while tile i computes.
#pragma once

#include "attention_common.cuh"

namespace {

constexpr int M_OUT = 1, M_ROWDOT = 2, M_STATS_IN = 4, M_STATS_OUT = 8;
constexpr int ROWS_WARPS = 4;
constexpr int ROWS_THREADS = 32 * ROWS_WARPS;
constexpr int ROWS_SCR_LD = BK + 4;  // f32 row stride of a warp's shifted band scores

template <int DHP>
struct RowsLayout {
  static constexpr int LD = DHP + 8;  // bf16 row stride of [row][dh] tiles
  static constexpr int TILE = 64 * LD * 2;
  // a stage (two): the key tile's k, v, dropout bytes and key mask
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int DROP = 2 * TILE;
  static constexpr int MASK = DROP + BQ * DROP_LD;
  static constexpr int STAGE = MASK + BK * 4;
  static constexpr int RING = 2 * STAGE;             // 4 slots of PBLK p rows
  // q (then qu), qv, g and the u and vb rows staged, then the band scores
  static constexpr int SCRATCH = RING + 4 * TILE;
  static constexpr int BYTES =
      SCRATCH + cmax(3 * TILE + 2 * LD * 2, ROWS_WARPS * 16 * ROWS_SCR_LD * 4);
};

struct RowsArgs {
  const bf16 *q, *k, *v, *p, *u, *vb;
  const float* key_mask;
  const uint8_t* drop8;
  const bf16* g;   // M_ROWDOT: the cotangent
  bf16* out;       // M_OUT
  float *m, *l;    // [B, H, T]: M_STATS_IN reads, M_STATS_OUT writes
  float* rowdot;   // M_ROWDOT [B, H, T]
  int B, H, T, dh;
  float scale;
  int drop_k;
  float drop_scale;
};

template <int DHP, int MODE>
__global__ void __launch_bounds__(ROWS_THREADS, 2) relpos_attention_rows_kernel(RowsArgs a) {
  using L = RowsLayout<DHP>;
  constexpr int LD = L::LD;
  constexpr int KS = DHP / 16;  // k16 steps over dh
  constexpr int NO = DHP / 8;   // n8 tiles over dh
  constexpr bool OUT = (MODE & M_OUT) != 0;
  constexpr bool ROWDOT = (MODE & M_ROWDOT) != 0;
  constexpr bool STATS_IN = (MODE & M_STATS_IN) != 0;
  constexpr bool STATS_OUT = (MODE & M_STATS_OUT) != 0;
  extern __shared__ __align__(16) unsigned char smem[];

  const int T = a.T, dh = a.dh;
  const int t0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * a.H + h;
  const int P = 2 * T - 1, nk = (T + BK - 1) / BK;
  const bf16* qg = a.q + bh * T * dh;
  const bf16* kg = a.k + bh * T * dh;
  const bf16* vg = a.v + bh * T * dh;
  const bf16* pg = a.p + (size_t)h * P * dh;
  const float* mg = a.key_mask + (size_t)b * T;
  const uint8_t* dg = a.drop8 + bh * T * T;
  const bool use_drop = a.drop_k > 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = 16 * warp;  // this warp's first row in the tile
  const int npass1 = STATS_IN ? 0 : nk;
  const int steps = npass1 + nk;
  const int z0 = T - BQ - t0;  // first p row of block Z_0

  auto stage = [&](int s) { return smem + (s & 1) * L::STAGE; };
  auto slot = [&](int e) {
    return reinterpret_cast<bf16*>(smem + L::RING + (e & 3) * L::TILE);
  };
  // ring blocks loaded through step s (two at each pass's start)
  auto events = [&](int s) { return s + 2 + s / nk; };

  auto load_step = [&](int s) {
    const bool pass2 = s >= npass1;
    const int kt = s % nk, s0 = kt * BK;
    unsigned char* st = stage(s);
    copy_rows<DHP, LD, ROWS_THREADS>(reinterpret_cast<bf16*>(st + L::K), kg, s0, BK, T, dh);
    if (pass2) {
      copy_rows<DHP, LD, ROWS_THREADS>(reinterpret_cast<bf16*>(st + L::V), vg, s0, BK, T, dh);
      if (use_drop) copy_drop<ROWS_THREADS>(st + L::DROP, dg, t0, s0, T);
    }
    copy_f32<ROWS_THREADS>(reinterpret_cast<float*>(st + L::MASK), mg, s0, BK, T);
    const int e = events(s);
    if (kt == 0) copy_rows<DHP, LD, ROWS_THREADS>(slot(e - 2), pg, z0, PBLK, P, dh);
    copy_rows<DHP, LD, ROWS_THREADS>(slot(e - 1), pg, z0 + (kt + 1) * PBLK, PBLK, P, dh);
    cp_async_commit();
  };

  // ---- q (and g) and the u and vb rows staged by cp.async, then, in
  // shared memory, qu = bf16(q + u) in place and qv = bf16(q + vb), zero
  // past T and dh; each warp keeps its 16 rows as A fragments
  uint32_t aqu[KS][4], aqv[KS][4], ag[ROWDOT ? KS : 1][4];
  {
    bf16* qus = reinterpret_cast<bf16*>(smem + L::SCRATCH);
    bf16* qvs = qus + 64 * LD;
    bf16* gs = qvs + 64 * LD;
    bf16* uvs = gs + 64 * LD;  // u, then vb, [LD] each
    copy_rows<DHP, LD, ROWS_THREADS>(qus, qg, t0, BQ, T, dh);
    if (ROWDOT) copy_rows<DHP, LD, ROWS_THREADS>(gs, a.g + bh * T * dh, t0, BQ, T, dh);
    copy_rows<DHP, LD, ROWS_THREADS>(uvs, a.u + (size_t)h * dh, 0, 1, 1, dh);
    copy_rows<DHP, LD, ROWS_THREADS>(uvs + LD, a.vb + (size_t)h * dh, 0, 1, 1, dh);
    cp_async_commit();
    load_step(0);
    cp_async_wait<1>();
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * (DHP / 8); i += ROWS_THREADS) {
      const int r = i / (DHP / 8), c = 8 * (i % (DHP / 8));
      const uint4 raw = *reinterpret_cast<const uint4*>(qus + r * LD + c);
      const uint4 ur = *reinterpret_cast<const uint4*>(uvs + c);
      const uint4 vr = *reinterpret_cast<const uint4*>(uvs + LD + c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      const bf16* ue = reinterpret_cast<const bf16*>(&ur);
      const bf16* ve = reinterpret_cast<const bf16*>(&vr);
      uint4 o1, o2;
      bf16* w1 = reinterpret_cast<bf16*>(&o1);
      bf16* w2 = reinterpret_cast<bf16*>(&o2);
      const bool live = t0 + r < T;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const float xv = __bfloat162float(e[x]);
        w1[x] = __float2bfloat16_rn(live ? __fadd_rn(xv, __bfloat162float(ue[x])) : 0.f);
        w2[x] = __float2bfloat16_rn(live ? __fadd_rn(xv, __bfloat162float(ve[x])) : 0.f);
      }
      *reinterpret_cast<uint4*>(qus + r * LD + c) = o1;
      *reinterpret_cast<uint4*>(qvs + r * LD + c) = o2;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldsm_x4(aqu[ks], frag_a(qus, LD, r0, 16 * ks, lane));
      ldsm_x4(aqv[ks], frag_a(qvs, LD, r0, 16 * ks, lane));
      if (ROWDOT) ldsm_x4(ag[ROWDOT ? ks : 0], frag_a(gs, LD, r0, 16 * ks, lane));
    }
  }
  // each thread's rows: t0 + r0 + g (r = 0) and + 8 (r = 1)
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + r0 + g + 8 * r;
    if (STATS_IN) {
      m[r] = t < T ? a.m[bh * T + t] : 0.f;
      l[r] = t < T ? a.l[bh * T + t] : 1.f;
    } else {
      m[r] = __int_as_float(0xff800000);
      l[r] = 0.f;
    }
  }
  __syncthreads();  // the staging is free: the scratch holds band scores now
  float* bs = reinterpret_cast<float*>(smem + L::SCRATCH) + warp * 16 * ROWS_SCR_LD;
  const int cb = 48 - 16 * warp;  // first band row this warp's rows reach

  float o[OUT ? NO : 1][4];
#pragma unroll
  for (int n = 0; n < (OUT ? NO : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float rd[2] = {0.f, 0.f};

  for (int s = 0; s < steps; ++s) {
    // step s's tiles have landed and step s-1 is done in every warp, so its
    // stage and ring slot take step s+1's loads
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < steps) load_step(s + 1);
    const bool pass2 = s >= npass1;
    const int s0 = (s % nk) * BK;
    const unsigned char* st = stage(s);
    const bf16* kt_s = reinterpret_cast<const bf16*>(st + L::K);
    const float* mask_s = reinterpret_cast<const float*>(st + L::MASK);
    const int e = events(s);
    const bf16* zlo = slot(e - 2);  // band rows [0, 64)
    const bf16* zhi = slot(e - 1);  // band rows [64, 128)

    // scores of this warp's 16 rows x the tile's 64 keys: sc[j][e] is row
    // g + 8 * (e >> 1), key 8 * j + 2 * tq + (e & 1)
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) sc[j][x] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bb[4];
        ldsm_x4(bb, frag_b_nk(kt_s, LD, 16 * jj, 16 * ks, lane));
        mma_bf16(sc[2 * jj], aqu[ks], bb[0], bb[1]);
        mma_bf16(sc[2 * jj + 1], aqu[ks], bb[2], bb[3]);
      }
    }
    // the band product in two halves of 48 and 32 columns; row i needs
    // band column c = 15 - i + s' for key s'
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float bd[6][4];
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) bd[j][x] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int jj = 0; jj < 3 - half; ++jj) {
          const int rb = cb + 48 * half + 16 * jj;
          uint32_t bb[4];
          ldsm_x4(bb, frag_b_nk(rb < 64 ? zlo : zhi, LD, rb & 63, 16 * ks, lane));
          mma_bf16(bd[2 * jj], aqv[ks], bb[0], bb[1]);
          mma_bf16(bd[2 * jj + 1], aqv[ks], bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 6 - 2 * half; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = g + 8 * (x >> 1);
          const int sk = 48 * half + 8 * j + 2 * tq + (x & 1) + i - 15;
          if (sk >= 0 && sk < BK) bs[i * ROWS_SCR_LD + sk] = bd[j][x];
        }
    }
    __syncwarp();
    const float absent = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = g + 8 * (x >> 1), sk = 8 * j + 2 * tq + (x & 1);
        const float v = __fmul_rn(__fadd_rn(sc[j][x], bs[i * ROWS_SCR_LD + sk]), a.scale);
        sc[j][x] = s0 + sk >= T ? absent : (mask_s[sk] > 0.f ? v : NEG);
      }
    __syncwarp();

    if (!pass2) {
      // ---- pass 1: row max and sum, online in f32
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = sc[0][2 * r];
#pragma unroll
        for (int j = 0; j < 8; ++j) tmax = fmaxf(tmax, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float mnew = fmaxf(m[r], tmax);  // finite: key s0 < T is in the tile
        // the exponentials first (independent), then their sum in order
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[j][2 * r] = sm_exp(sc[j][2 * r] - mnew);
          sc[j][2 * r + 1] = sm_exp(sc[j][2 * r + 1] - mnew);
        }
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum = __fadd_rn(sum, __fadd_rn(sc[j][2 * r], sc[j][2 * r + 1]));
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
        l[r] = __fmaf_rn(l[r], sm_exp(m[r] - mnew), sum);
        m[r] = mnew;
      }
    } else {
      const uint8_t* drop_s = st + L::DROP;
      const bf16* vt_s = reinterpret_cast<const bf16*>(st + L::V);
      const float rl[2] = {sm_rcp(l[0]), sm_rcp(l[1])};
      // attn = exp(s - m) / l, before dropout
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[j][x] = sm_exp(sc[j][x] - m[x >> 1]);
      sm_div_rows(sc, l, rl);
      if (OUT) {
        // ---- pass 2: P = bf16(dropout(attn)), out += P v
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x >> 1;
            float pr = sc[j][x];
            if (use_drop) {
              const int il = r0 + g + 8 * r, sk = 8 * j + 2 * tq + (x & 1);
              if (t0 + il < T && s0 + sk < T) {
                pr = drop_s[il * DROP_LD + sk] >= a.drop_k ? __fmul_rn(pr, a.drop_scale) : 0.f;
              }
            }
            sc[j][x] = pr;
          }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t pa[4];
          pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
          pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
          pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
          for (int nn = 0; nn < NO / 2; ++nn) {
            uint32_t bb[4];
            ldsm_x4_t(bb, frag_b_kn(vt_s, LD, 16 * kk, 16 * nn, lane));
            mma_bf16(o[OUT ? 2 * nn : 0], pa, bb[0], bb[1]);
            mma_bf16(o[OUT ? 2 * nn + 1 : 0], pa, bb[2], bb[3]);
          }
        }
      }
      if (ROWDOT) {
        // ---- pass 2: rowdot += dropout(g v^T) * attn (attn before dropout)
        float da[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) da[j][x] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t bb[4];
            ldsm_x4(bb, frag_b_nk(vt_s, LD, 16 * jj, 16 * ks, lane));
            mma_bf16(da[2 * jj], ag[ROWDOT ? ks : 0], bb[0], bb[1]);
            mma_bf16(da[2 * jj + 1], ag[ROWDOT ? ks : 0], bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x >> 1;
            const float at = sc[j][x];
            float d = da[j][x];
            if (use_drop) {
              const int il = r0 + g + 8 * r, sk = 8 * j + 2 * tq + (x & 1);
              if (t0 + il < T && s0 + sk < T) {
                d = drop_s[il * DROP_LD + sk] >= a.drop_k ? __fmul_rn(d, a.drop_scale) : 0.f;
              }
            }
            da[j][x] = __fmul_rn(d, at);
          }
        // the products first (independent), then their sum in order
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) rd[x >> 1] = __fadd_rn(rd[x >> 1], da[j][x]);
      }
    }
  }

  // ---- epilogue: rows < T
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + r0 + g + 8 * r;
    if (ROWDOT) {
      rd[r] = __fadd_rn(rd[r], __shfl_xor_sync(0xffffffffu, rd[r], 1));
      rd[r] = __fadd_rn(rd[r], __shfl_xor_sync(0xffffffffu, rd[r], 2));
      if (tq == 0 && t < T) a.rowdot[bh * T + t] = rd[r];
    }
    if (STATS_OUT && tq == 0 && t < T) {
      a.m[bh * T + t] = m[r];
      a.l[bh * T + t] = l[r];
    }
  }
  if (OUT) {
    bf16* og = a.out + bh * T * dh;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = t0 + r0 + g + 8 * (x >> 1), c = 8 * n + 2 * tq + (x & 1);
        if (t < T && c < dh) og[(size_t)t * dh + c] = __float2bfloat16_rn(o[OUT ? n : 0][x]);
      }
  }
}

template <int DHP, int MODE>
int launch_rows(const RowsArgs& a, cudaStream_t stream) {
  constexpr int smem = RowsLayout<DHP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(relpos_attention_rows_kernel<DHP, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.T + BQ - 1) / BQ), (unsigned)a.H, (unsigned)a.B);
  relpos_attention_rows_kernel<DHP, MODE><<<grid, ROWS_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// dh in [1, 64], zero-padded to the next multiple of 16
template <int MODE>
int launch_rows_dh(const RowsArgs& a, cudaStream_t stream) {
  switch ((a.dh + 15) / 16) {
    case 1: return launch_rows<16, MODE>(a, stream);
    case 2: return launch_rows<32, MODE>(a, stream);
    case 3: return launch_rows<48, MODE>(a, stream);
    default: return launch_rows<64, MODE>(a, stream);
  }
}

inline int rows_smem_bytes(int dh) {
  switch ((dh + 15) / 16) {
    case 1: return RowsLayout<16>::BYTES;
    case 2: return RowsLayout<32>::BYTES;
    case 3: return RowsLayout<48>::BYTES;
    default: return RowsLayout<64>::BYTES;
  }
}

}  // namespace

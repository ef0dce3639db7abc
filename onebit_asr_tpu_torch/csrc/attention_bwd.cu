// Fused relative-position attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel onebit_asr_tpu/ops/attention.py:165
// (_bwd_kernel, :165-232; entry _fa_bwd :299, pallas_call :306). For each
// (b, h), from the forward's inputs and the cotangent g:
//   s, attn      as the forward (csrc/attention.cu): f32 scores, softmax
//   attn_d       = keep ? attn * inv : 0                  (inv = 256/(256-k))
//   dv           = bf16(attn_d)^T g                       (f32 sums)
//   dattn        = keep ? (g v^T) * inv : 0
//   rowdot[t]    = sum_s dattn * attn      (attn before dropout, f32)
//   ds           = attn * (dattn - rowdot) * scale        (f32)
//   ds_c         = bf16(ds); dbraw[t, T-1-t+s] = ds_c[t, s] (the skew's adjoint)
//   dq           = bf16(ds_c k + dbraw p)   (the two f32 sums added, rounded once)
//   dk           = bf16(ds_c^T qu), qu = bf16(q + u)
//   dp           = sum_b dbraw^T qv;  du = sum_b,t ds_c k;  dvb = sum_b,t dbraw p
// in the order of operations and roundings of the plain version
// (ops/attention.py::fused_relpos_attention_bwd_reference). No [T, T]-or-
// wider tensor reaches device memory.
//
// What bounds it: at the train step's shape of Conformer-M (B=16, H=4,
// T=256, dh=64) the function needs eight products of 2*T*T*dh per (b, h)
// (qu k^T, the skewed band of qv p^T, g v^T, attn^T g, ds k, dbraw p,
// ds^T qu, dbraw^T qv): 4.29 GFLOP of bf16 products (4.3 us at 989
// TFLOP/s), and must move q, k, v, g in and dq, dk, dv out (7 x 2.1 MB),
// the uint8 draws (4.2 MB) and p: ~19 MB (5.7 us at 3.35 TB/s). Bytes,
// with dropout.
//
// Design (a simple, correct first kernel; wgmma/TMA and pipelining later):
//   - one CTA of 4 warps per (query tile of 64 rows, h, b), as the forward;
//     each warp owns 16 query rows. The key axis is walked in tiles of 64
//     keys three times: pass 1 gives each row's max and sum (online, f32),
//     pass 2 its rowdot, pass 3 the gradients. `rowdot` needs the f32
//     probabilities before dropout times dattn after it, so FlashAttention's
//     rowsum(dO * O) shortcut (O was formed from bf16 probabilities and
//     rounded) would round elsewhere;
//   - pass 3 keeps the warp's dq in two f32 register accumulators (ds_c k
//     and dbraw p: du and dvb need them apart, dq their sum rounded once);
//     ds_c comes from registers as an mma A fragment, as P does in the
//     forward. bf16(attn_d)^T, ds_c^T and dbraw^T go through shared memory
//     ([key][query], [key][query], [band row][query]), and each warp
//     multiplies 16 of the tile's rows by the CTA's 64 query rows: the
//     tile's partial dv, dk (64 keys) and dp (its 128-row band of p);
//   - the skew's adjoint without a scatter to device memory: the (query
//     tile, key tile) pair touches the p rows j in [T-64-t0+s0, +127); ds_c
//     is written into that band (row 63 - r + s' for query r, key s'),
//     zero elsewhere, and read back as dbraw for dq (each warp the 80 band
//     rows its 16 rows reach) and transposed for dp;
//   - sums across CTAs in a fixed order, no atomics: every CTA writes f32
//     partials of dk and dv (per query tile), dp (per query tile and key
//     tile) and du, dvb (per warp) into the caller's workspace, and a second
//     kernel sums them (b ascending, then query tile, key tile) and rounds
//     to bf16. Two launches on the same inputs give the same bits;
//   - products on mma.sync m16n8k16 bf16 -> f32; shared tiles padded by 8
//     bf16 per row; the score sum and scale as __fadd_rn then __fmul_rn,
//     the gradient formulas with _rn intrinsics (no FMA contraction), expf
//     and an IEEE divide (no --use_fast_math);
//   - query rows past T and key columns past T contribute nothing; masked
//     keys inside [0, T) take -1e9 and still count, so an all-pad row is
//     uniform 1/T, as in JAX. No load reads past T.
//
// The entry launches both kernels on the given stream, allocates nothing
// and returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it
// does not take: dh outside [1, 64], a drop threshold outside [0, 255], a
// workspace smaller than bwd_workspace_floats()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = WARPS * 16;   // query rows per CTA
constexpr int BK = 64;           // keys per tile
constexpr int NT_S = BK / 8;     // n8 score tiles per warp and key tile
constexpr int BAND = 128;        // p rows one key tile needs (127), padded
constexpr int WBAND = 80;        // band rows one warp needs (79), padded
constexpr int NT_B = WBAND / 8;  // n8 tiles of a warp's band product
constexpr int WBAND_LD = WBAND + 8;  // f32 row stride of a warp's band scores
constexpr int LDQ = BQ + 8;      // bf16 row stride of [x][query or key] tiles
constexpr int LDB = BAND + 8;    // bf16 row stride of the transposed p band
constexpr float NEG = -1e9f;
constexpr int REDUCE_THREADS = 256;

typedef __nv_bfloat16 bf16;

template <int DHP>
struct Layout {
  static constexpr int LD = DHP + 8;  // bf16 row stride of [row][dh] tiles
  static constexpr int KT = 0;                          // k tile [key][dh]
  static constexpr int KC = KT + BK * LD * 2;           // k tile [dh][key]
  static constexpr int VR = KC + DHP * LDQ * 2;         // v tile [key][dh]
  static constexpr int PB = VR + BK * LD * 2;           // p band [row][dh]
  static constexpr int PC = PB + BAND * LD * 2;         // p band [dh][row]
  static constexpr int QUR = PC + DHP * LDB * 2;        // qu [query][dh]
  static constexpr int QVR = QUR + BQ * LD * 2;         // qv [query][dh]
  static constexpr int GR = QVR + BQ * LD * 2;          // g [query][dh]
  static constexpr int QUT = GR + BQ * LD * 2;          // qu [dh][query]
  static constexpr int QVT = QUT + DHP * LDQ * 2;       // qv [dh][query]
  static constexpr int GT = QVT + DHP * LDQ * 2;        // g [dh][query]
  static constexpr int PT = GT + DHP * LDQ * 2;         // bf16(attn_d) [key][query]
  static constexpr int DST = PT + BK * LDQ * 2;         // ds_c [key][query]
  static constexpr int DBT = DST + BK * LDQ * 2;        // dbraw [band row][query]
  static constexpr int BS = DBT + BAND * LDQ * 2;       // warps' band scores, f32
  static constexpr int COLV = BS + WARPS * 16 * WBAND_LD * 4;
  static constexpr int BYTES = COLV + BK * 4;
};

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a row-major
// bf16 tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base, int ld, int r0,
                                       int c0, int g, int tq) {
  const bf16* p = base + (r0 + g) * ld + c0 + 2 * tq;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// Rows [lo, lo + n) of a row-major [rows, dh] bf16 matrix into shared
// memory: element (r, c) goes to dst[r * ld + c], or to dst[c * ld + r]
// with `transpose`; zero for rows outside [0, rows) and for c in [dh, DHP).
template <int DHP, bool transpose>
__device__ void load_rows(bf16* dst, int ld, const bf16* __restrict__ src,
                          int lo, int n, int rows, int dh) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (dh % 8 == 0) {  // 16-byte rows: one uint4 per 8 elements
    constexpr int C8 = DHP / 8;
    for (int i = threadIdx.x; i < n * C8; i += THREADS) {
      const int r = i / C8, c = 8 * (i % C8), row = lo + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row >= 0 && row < rows && c < dh) {
        val = *reinterpret_cast<const uint4*>(src + (size_t)row * dh + c);
      }
      if (transpose) {
        const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
        for (int x = 0; x < 8; ++x) dst[(c + x) * ld + r] = e[x];
      } else {
        *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
      }
    }
  } else {  // rows not 16-byte aligned (dh = 36: 72 bytes): element by element
    for (int i = threadIdx.x; i < n * DHP; i += THREADS) {
      const int r = i / DHP, c = i % DHP, row = lo + r;
      const bf16 val = (row >= 0 && row < rows && c < dh) ? src[(size_t)row * dh + c] : zero;
      dst[transpose ? c * ld + r : r * ld + c] = val;
    }
  }
}

// The workspace of f32 partials, carved as ops/attention.py::
// bwd_workspace_floats sizes it.
struct Partials {
  float* dk;   // [B, H, nq, T, dh]
  float* dv;   // [B, H, nq, T, dh]
  float* dp;   // [B, H, nq, nq, BAND, dh]
  float* du;   // [B, H, nq * WARPS, dh]
  float* dvb;  // [B, H, nq * WARPS, dh]
};

__host__ __device__ inline size_t bwd_workspace_floats(int B, int H, int T, int dh) {
  const size_t nq = (size_t)((T + BQ - 1) / BQ);
  return (size_t)B * H * nq * (2 * (size_t)T * dh + nq * BAND * dh + 2 * WARPS * (size_t)dh);
}

__host__ __device__ inline Partials carve(float* ws, int B, int H, int T, int dh) {
  const size_t nq = (size_t)((T + BQ - 1) / BQ), bhq = (size_t)B * H * nq;
  Partials w;
  w.dk = ws;
  w.dv = w.dk + bhq * T * dh;
  w.dp = w.dv + bhq * T * dh;
  w.du = w.dp + bhq * nq * BAND * dh;
  w.dvb = w.du + bhq * WARPS * dh;
  return w;
}

template <int DHP>
__global__ void __launch_bounds__(THREADS)
    relpos_attention_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ p,
                                const bf16* __restrict__ u, const bf16* __restrict__ vb,
                                const float* __restrict__ key_mask,
                                const uint8_t* __restrict__ drop8,
                                const bf16* __restrict__ gin, bf16* __restrict__ dq,
                                Partials ws, int H, int T, int dh, float scale, int drop_k,
                                float drop_scale) {
  using L = Layout<DHP>;
  constexpr int LD = L::LD;
  constexpr int KS = DHP / 16;  // k16 steps over dh
  constexpr int NO = DHP / 8;   // n8 tiles over dh (those at or past dh skipped)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kt = reinterpret_cast<bf16*>(smem + L::KT);
  bf16* kc = reinterpret_cast<bf16*>(smem + L::KC);
  bf16* vr = reinterpret_cast<bf16*>(smem + L::VR);
  bf16* pb = reinterpret_cast<bf16*>(smem + L::PB);
  bf16* pc = reinterpret_cast<bf16*>(smem + L::PC);
  bf16* qur = reinterpret_cast<bf16*>(smem + L::QUR);
  bf16* qvr = reinterpret_cast<bf16*>(smem + L::QVR);
  bf16* gr = reinterpret_cast<bf16*>(smem + L::GR);
  bf16* qut = reinterpret_cast<bf16*>(smem + L::QUT);
  bf16* qvt = reinterpret_cast<bf16*>(smem + L::QVT);
  bf16* gt = reinterpret_cast<bf16*>(smem + L::GT);
  bf16* pt = reinterpret_cast<bf16*>(smem + L::PT);
  bf16* dst = reinterpret_cast<bf16*>(smem + L::DST);
  bf16* dbt = reinterpret_cast<bf16*>(smem + L::DBT);
  float* colv = reinterpret_cast<float*>(smem + L::COLV);

  const int qt = blockIdx.x, t0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nq = gridDim.x;
  const size_t bh = (size_t)b * H + h;
  const int P = 2 * T - 1;
  const bf16* qg = q + bh * T * dh;
  const bf16* kg = k + bh * T * dh;
  const bf16* vg = v + bh * T * dh;
  const bf16* gg = gin + bh * T * dh;
  const bf16* pg = p + (size_t)h * P * dh;
  const float* mg = key_mask + (size_t)b * T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;      // this warp's first query row in the tile
  const int trow = t0 + r0 + g;  // query row of e < 2; e >= 2 is + 8

  // ---- qu = bf16(q + u), qv = bf16(q + vb) and g, zero past T and dh, row-
  // major (A fragments) and transposed (B fragments over the query axis)
  for (int i = threadIdx.x; i < BQ * DHP; i += THREADS) {
    const int r = i / DHP, c = i % DHP;
    float a = 0.f, c2 = 0.f, gv = 0.f;
    if (t0 + r < T && c < dh) {
      const float x = __bfloat162float(qg[(size_t)(t0 + r) * dh + c]);
      a = __fadd_rn(x, __bfloat162float(u[h * dh + c]));
      c2 = __fadd_rn(x, __bfloat162float(vb[h * dh + c]));
      gv = __bfloat162float(gg[(size_t)(t0 + r) * dh + c]);
    }
    const bf16 ab = __float2bfloat16_rn(a), cb2 = __float2bfloat16_rn(c2),
               gb = __float2bfloat16_rn(gv);
    qur[r * LD + c] = ab;
    qvr[r * LD + c] = cb2;
    gr[r * LD + c] = gb;
    qut[c * LDQ + r] = ab;
    qvt[c * LDQ + r] = cb2;
    gt[c * LDQ + r] = gb;
  }
  // this warp's [16 x WBAND_LD] f32 band scores
  float* bs = reinterpret_cast<float*>(smem + L::BS) + warp * 16 * WBAND_LD;
  const int cb = 48 - 16 * warp;  // first band row this warp's rows need

  // Load the key tile [s0, s0 + BK): k, its band of p, v (passes 2-3), the
  // transposed k and p band and a zeroed dbraw band (pass 3), and the column
  // states (1 valid, 0 masked, -1 past T). Brackets its loads with barriers,
  // so the tile before is no longer read.
  auto load_tile = [&](int s0, int pass) {
    __syncthreads();
    const int j0 = T - 1 - (t0 + BQ - 1) + s0;
    load_rows<DHP, false>(kt, LD, kg, s0, BK, T, dh);
    load_rows<DHP, false>(pb, LD, pg, j0, BAND, P, dh);
    if (pass >= 2) load_rows<DHP, false>(vr, LD, vg, s0, BK, T, dh);
    if (pass == 3) {
      load_rows<DHP, true>(kc, LDQ, kg, s0, BK, T, dh);
      load_rows<DHP, true>(pc, LDB, pg, j0, BAND, P, dh);
      uint4* z = reinterpret_cast<uint4*>(dbt);
      for (int i = threadIdx.x; i < BAND * LDQ * 2 / 16; i += THREADS) {
        z[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int i = threadIdx.x; i < BK; i += THREADS) {
      colv[i] = s0 + i < T ? (mg[s0 + i] > 0.f ? 1.f : 0.f) : -1.f;
    }
    __syncthreads();
  };

  // Scores of this warp's 16 rows x the tile's 64 keys: sc[j][e] is row
  // g + 8 * (e >> 1), key 8 * j + 2 * tq + (e & 1); -inf past T.
  auto scores = [&](float (&sc)[NT_S][4]) {
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      load_a(a, qur, LD, r0, 16 * ks, g, tq);
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const bf16* kr = kt + (8 * j + g) * LD + 16 * ks + 2 * tq;
        mma_bf16(sc[j], a, ld_u32(kr), ld_u32(kr + 8));
      }
    }
    {
      float bb[NT_B][4];
#pragma unroll
      for (int j = 0; j < NT_B; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) bb[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        load_a(a, qvr, LD, r0, 16 * ks, g, tq);
#pragma unroll
        for (int j = 0; j < NT_B; ++j) {
          const bf16* pr = pb + (cb + 8 * j + g) * LD + 16 * ks + 2 * tq;
          mma_bf16(bb[j], a, ld_u32(pr), ld_u32(pr + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < NT_B; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bs[(g + 8 * (e >> 1)) * WBAND_LD + 8 * j + 2 * tq + (e & 1)] = bb[j][e];
    }
    __syncwarp();
    const float absent = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g + 8 * (e >> 1), s = 8 * j + 2 * tq + (e & 1);
        // bd[t, s0 + s] = band row (t0 + BQ - 1 - t) + s of the CTA,
        // = column 15 - i + s of this warp's band product
        const float bd = bs[i * WBAND_LD + 15 - i + s];
        const float x = __fmul_rn(__fadd_rn(sc[j][e], bd), scale);
        const float cv = colv[s];
        sc[j][e] = cv > 0.f ? x : (cv == 0.f ? NEG : absent);
      }
    }
    __syncwarp();
  };

  // g v^T of this warp's 16 rows x the tile's 64 keys, in the layout of sc
  auto dattn = [&](float (&da)[NT_S][4]) {
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) da[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      load_a(a, gr, LD, r0, 16 * ks, g, tq);
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const bf16* vv = vr + (8 * j + g) * LD + 16 * ks + 2 * tq;
        mma_bf16(da[j], a, ld_u32(vv), ld_u32(vv + 8));
      }
    }
  };

  // keep byte of (query row t, key s), both < T
  auto kept = [&](int t, int s) { return (int)drop8[(bh * T + t) * T + s] >= drop_k; };

  // ---- pass 1: row max and sum, online in f32 (rows g and g + 8)
  float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
  float l[2] = {0.f, 0.f};
  for (int s0 = 0; s0 < T; s0 += BK) {
    load_tile(s0, 1);
    float sc[NT_S][4];
    scores(sc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = sc[0][2 * r];
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
        tmax = fmaxf(tmax, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mnew = fmaxf(m[r], tmax);  // finite: key s0 < T is in the tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
        sum += expf(sc[j][2 * r] - mnew) + expf(sc[j][2 * r + 1] - mnew);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * expf(m[r] - mnew) + sum;
      m[r] = mnew;
    }
  }

  // ---- pass 2: rowdot = sum_s dropout(dattn) * attn
  float rd[2] = {0.f, 0.f};
  for (int s0 = 0; s0 < T; s0 += BK) {
    load_tile(s0, 2);
    float sc[NT_S][4], da[NT_S][4];
    scores(sc);
    dattn(da);
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float a = expf(sc[j][e] - m[r]) / l[r];
        float d = da[j][e];
        if (drop_k > 0) {
          const int t = trow + 8 * r, s = s0 + 8 * j + 2 * tq + (e & 1);
          if (t < T && s < T) d = kept(t, s) ? __fmul_rn(d, drop_scale) : 0.f;
        }
        rd[r] = __fadd_rn(rd[r], __fmul_rn(d, a));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rd[r] += __shfl_xor_sync(0xffffffffu, rd[r], 1);
    rd[r] += __shfl_xor_sync(0xffffffffu, rd[r], 2);
  }

  // ---- pass 3: ds, then dq (registers) and the tile's partial dv, dk, dp
  float dqu[NO][4], dqv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqu[n][e] = dqv[n][e] = 0.f;
  const size_t part_rows = (size_t)(bh * nq + qt) * T;  // dk/dv partial rows
  for (int s0 = 0; s0 < T; s0 += BK) {
    load_tile(s0, 3);
    float sc[NT_S][4];
    {
      float da[NT_S][4];
      scores(sc);
      dattn(da);
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int il = r0 + g + 8 * r, sl = 8 * j + 2 * tq + (e & 1);
          const int t = t0 + il, s = s0 + sl;
          const float a = expf(sc[j][e] - m[r]) / l[r];
          float ad = a, d = da[j][e];
          if (drop_k > 0 && t < T && s < T) {
            const bool keep = kept(t, s);
            ad = keep ? __fmul_rn(a, drop_scale) : 0.f;
            d = keep ? __fmul_rn(d, drop_scale) : 0.f;
          }
          float ds = __fmul_rn(__fmul_rn(a, __fsub_rn(d, rd[r])), scale);
          if (t >= T) ad = ds = 0.f;
          sc[j][e] = ds;
          const bf16 dsb = __float2bfloat16_rn(ds);
          pt[sl * LDQ + il] = __float2bfloat16_rn(ad);
          dst[sl * LDQ + il] = dsb;
          dbt[(BQ - 1 - il + sl) * LDQ + il] = dsb;
        }
      }
    }
    __syncthreads();
    // dq's content part: ds_c (this warp's rows, from registers) k
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (8 * n >= dh) continue;
        const bf16* kr = kc + (8 * n + g) * LDQ + 16 * kk + 2 * tq;
        mma_bf16(dqu[n], a, ld_u32(kr), ld_u32(kr + 8));
      }
    }
    // dq's position part: dbraw (the warp's 80 band rows, gathered from the
    // transposed band) p
#pragma unroll
    for (int kk = 0; kk < WBAND / 16; ++kk) {
      const int c = cb + 16 * kk + 2 * tq;
      const int ra = r0 + g, rb = r0 + g + 8;
      uint32_t a[4];
      a[0] = pack2(dbt[c * LDQ + ra], dbt[(c + 1) * LDQ + ra]);
      a[1] = pack2(dbt[c * LDQ + rb], dbt[(c + 1) * LDQ + rb]);
      a[2] = pack2(dbt[(c + 8) * LDQ + ra], dbt[(c + 9) * LDQ + ra]);
      a[3] = pack2(dbt[(c + 8) * LDQ + rb], dbt[(c + 9) * LDQ + rb]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (8 * n >= dh) continue;
        const bf16* pr = pc + (8 * n + g) * LDB + c;
        mma_bf16(dqv[n], a, ld_u32(pr), ld_u32(pr + 8));
      }
    }
    // the tile's partial dv = bf16(attn_d)^T g and dk = ds_c^T qu over this
    // CTA's 64 query rows: keys [s0 + 16 * warp, + 16)
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const bf16* at = which == 0 ? pt : dst;
      const bf16* bt = which == 0 ? gt : qut;
      float* out = which == 0 ? ws.dv : ws.dk;
      float acc[NO][4];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        load_a(a, at, LDQ, r0, 16 * kk, g, tq);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          if (8 * n >= dh) continue;
          const bf16* br = bt + (8 * n + g) * LDQ + 16 * kk + 2 * tq;
          mma_bf16(acc[n], a, ld_u32(br), ld_u32(br + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + r0 + g + 8 * (e >> 1), c = 8 * n + 2 * tq + (e & 1);
          if (s < T && c < dh) out[(part_rows + s) * dh + c] = acc[n][e];
        }
      }
    }
    // the tile's partial dp = dbraw^T qv over its 128 band rows: this warp
    // takes rows [32 * warp, + 32)
    {
      float* out = ws.dp + (((size_t)(bh * nq + qt) * nq + s0 / BK) * BAND) * dh;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float acc[NO][4];
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          uint32_t a[4];
          load_a(a, dbt, LDQ, 32 * warp + 16 * mt, 16 * kk, g, tq);
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            if (8 * n >= dh) continue;
            const bf16* br = qvt + (8 * n + g) * LDQ + 16 * kk + 2 * tq;
            mma_bf16(acc[n], a, ld_u32(br), ld_u32(br + 8));
          }
        }
#pragma unroll
        for (int n = 0; n < NO; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 32 * warp + 16 * mt + g + 8 * (e >> 1);
            const int c = 8 * n + 2 * tq + (e & 1);
            if (c < dh) out[(size_t)row * dh + c] = acc[n][e];
          }
        }
      }
    }
  }

  // ---- epilogue: dq = bf16(dqu + dqv) for rows < T; this warp's column sums
  // of dqu and dqv (du and dvb partials, in a fixed shuffle order)
  bf16* dqg = dq + bh * T * dh;
  const size_t wrow = (bh * nq + qt) * WARPS + warp;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = trow + 8 * (e >> 1), c = 8 * n + 2 * tq + (e & 1);
      if (t < T && c < dh) {
        dqg[(size_t)t * dh + c] = __float2bfloat16_rn(__fadd_rn(dqu[n][e], dqv[n][e]));
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float su = __fadd_rn(dqu[n][x], dqu[n][x + 2]);
      float sv = __fadd_rn(dqv[n][x], dqv[n][x + 2]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        su = __fadd_rn(su, __shfl_xor_sync(0xffffffffu, su, off));
        sv = __fadd_rn(sv, __shfl_xor_sync(0xffffffffu, sv, off));
      }
      const int c = 8 * n + 2 * tq + x;
      if (g == 0 && c < dh) {
        ws.du[wrow * dh + c] = su;
        ws.dvb[wrow * dh + c] = sv;
      }
    }
  }
}

// Sums the partials in a fixed order and rounds to bf16: one thread per
// element of dk and dv (together), then of dp, then of du and dvb.
__global__ void __launch_bounds__(REDUCE_THREADS)
    relpos_attention_bwd_reduce(Partials ws, bf16* __restrict__ dk, bf16* __restrict__ dv,
                                bf16* __restrict__ dp, bf16* __restrict__ du,
                                bf16* __restrict__ dvb, int B, int H, int T, int dh, int nq) {
  const int P = 2 * T - 1;
  const size_t n1 = (size_t)B * H * T * dh, n2 = (size_t)H * P * dh, n3 = (size_t)H * dh;
  size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i < n1) {
    const size_t c = i % dh, s = (i / dh) % T, bh = i / ((size_t)T * dh);
    float a = 0.f, b2 = 0.f;
    for (int qt = 0; qt < nq; ++qt) {
      const size_t off = ((bh * nq + qt) * T + s) * dh + c;
      a = __fadd_rn(a, ws.dk[off]);
      b2 = __fadd_rn(b2, ws.dv[off]);
    }
    dk[i] = __float2bfloat16_rn(a);
    dv[i] = __float2bfloat16_rn(b2);
    return;
  }
  i -= n1;
  if (i < n2) {
    const int c = (int)(i % dh), j = (int)((i / dh) % P), h = (int)(i / ((size_t)P * dh));
    float a = 0.f;
    for (int b = 0; b < B; ++b) {
      const size_t bh = (size_t)b * H + h;
      for (int qt = 0; qt < nq; ++qt) {
        for (int kt = 0; kt < nq; ++kt) {
          // the band of (qt, kt) starts at p row T - 64 - 64 qt + 64 kt
          const int jb = j - (T - BQ - BQ * qt + BK * kt);
          if (jb < 0 || jb >= BAND) continue;
          a = __fadd_rn(a, ws.dp[(((bh * nq + qt) * nq + kt) * BAND + jb) * dh + c]);
        }
      }
    }
    dp[i] = __float2bfloat16_rn(a);
    return;
  }
  i -= n2;
  if (i < n3) {
    const size_t c = i % dh, h = i / dh;
    float a = 0.f, b2 = 0.f;
    for (int b = 0; b < B; ++b) {
      for (int w = 0; w < nq * WARPS; ++w) {
        const size_t off = (((size_t)b * H + h) * nq * WARPS + w) * dh + c;
        a = __fadd_rn(a, ws.du[off]);
        b2 = __fadd_rn(b2, ws.dvb[off]);
      }
    }
    du[i] = __float2bfloat16_rn(a);
    dvb[i] = __float2bfloat16_rn(b2);
  }
}

template <int DHP>
int launch(const void* q, const void* k, const void* v, const void* p, const void* u,
           const void* vb, const void* key_mask, const void* drop8, const void* g, void* dq,
           void* dk, void* dv, void* dp, void* du, void* dvb, Partials ws, int B, int H,
           int T, int dh, float scale, int drop_k, float drop_scale, cudaStream_t stream) {
  constexpr int smem = Layout<DHP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(relpos_attention_bwd_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (T + BQ - 1) / BQ;
  const dim3 grid((unsigned)nq, (unsigned)H, (unsigned)B);
  relpos_attention_bwd_kernel<DHP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(p), static_cast<const bf16*>(u), static_cast<const bf16*>(vb),
      static_cast<const float*>(key_mask), static_cast<const uint8_t*>(drop8),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq), ws, H, T, dh, scale, drop_k,
      drop_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)B * H * T * dh + (size_t)H * (2 * T - 1) * dh + (size_t)H * dh;
  relpos_attention_bwd_reduce<<<(unsigned)((total + REDUCE_THREADS - 1) / REDUCE_THREADS),
                                REDUCE_THREADS, 0, stream>>>(
      ws, static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<bf16*>(dp),
      static_cast<bf16*>(du), static_cast<bf16*>(dvb), B, H, T, dh, nq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Gradients of the rel-pos attention (csrc/attention.cu) for the cotangent
// g [B,H,T,dh]: dq/dk/dv [B,H,T,dh], dp [H,2T-1,dh], du/dvb [H,dh], all
// bf16; operands as the forward's (bf16, contiguous, 16-byte aligned;
// key_mask f32; drop8 read only when drop_k > 0). `workspace` holds
// `workspace_floats` f32 elements, at least bwd_workspace_floats(B,H,T,dh)
// of ops/attention.py.
int fused_relpos_attention_bwd(const void* q, const void* k, const void* v, const void* p,
                               const void* u, const void* vb, const void* key_mask,
                               const void* drop8, const void* g, void* dq, void* dk, void* dv,
                               void* dp, void* du, void* dvb, void* workspace,
                               long long workspace_floats, int B, int H, int T, int dh,
                               float scale, int drop_k, float drop_scale, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || H < 1 || T < 1 || dh < 1 || dh > 64 || drop_k < 0 || drop_k > 255 ||
      workspace_floats < 0 || (size_t)workspace_floats < bwd_workspace_floats(B, H, T, dh)) {
    return (int)cudaErrorInvalidValue;
  }
  const Partials ws = carve(static_cast<float*>(workspace), B, H, T, dh);
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((dh + 15) / 16) {
    case 1: return launch<16>(q, k, v, p, u, vb, key_mask, drop8, g, dq, dk, dv, dp, du, dvb, ws, B, H, T, dh, scale, drop_k, drop_scale, s);
    case 2: return launch<32>(q, k, v, p, u, vb, key_mask, drop8, g, dq, dk, dv, dp, du, dvb, ws, B, H, T, dh, scale, drop_k, drop_scale, s);
    case 3: return launch<48>(q, k, v, p, u, vb, key_mask, drop8, g, dq, dk, dv, dp, du, dvb, ws, B, H, T, dh, scale, drop_k, drop_scale, s);
    default: return launch<64>(q, k, v, p, u, vb, key_mask, drop8, g, dq, dk, dv, dp, du, dvb, ws, B, H, T, dh, scale, drop_k, drop_scale, s);
  }
}

}  // extern "C"

// Fused relative-position attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel onebit_asr_tpu/ops/attention.py:141
// (_fwd_kernel, :141-162; entry _fa_fwd :275, pallas_call :281). For each
// (b, h):
//   qu = bf16(q + u), qv = bf16(q + vb)
//   s[t, s'] = (qu k^T [t, s'] + (qv p^T)[t, T-1-t+s']) * scale   (f32)
//   s = key_mask[s'] > 0 ? s : -1e9
//   attn = exp(s - max) / sum                                    (f32)
//   attn = byte >= k ? attn * 256/(256-k) : 0   (uint8 draws, only if k > 0)
//   out = bf16(bf16(attn) v)                    (f32 sums)
// in the order of operations and roundings of the plain version
// (ops/attention.py::fused_relpos_attention_reference). No [T, T]-or-wider
// tensor reaches device memory.
//
// What bounds it: at the serving shape of Conformer-M (B=8, H=4, T=512,
// dh=64) the function needs qu k^T, the T x T skewed band of qv p^T and
// attn v: 2*B*H*T*(3T)*dh = 3.22 GFLOP of bf16 products (3.3 us at
// 989 TFLOP/s; the TPU kernel's CostEstimate counts its full [T, 2T-1]
// qv p^T, 4.29 GFLOP) and B*H*T*T = 8.4 M exponentials, and must move
// ~8.9 MB (2.7 us at 3.35 TB/s): operations. The unfused chain
// writes and reads back the [B, H, T, 2T] position scores and the
// [B, H, T, T] f32 scores and probabilities (33.5 MB each per block).
//
// Design (a simple, correct first kernel; wgmma/TMA and pipelining later):
//   - one CTA of 4 warps per (query tile of 64 rows, h, b); each warp owns
//     16 query rows and keeps their qu and qv as mma A fragments in
//     registers for the whole launch (dh zero-padded to the k16 step, so
//     dh = 36 runs as 48);
//   - the key axis is walked in tiles of 64 keys, twice. The normalised
//     probabilities are rounded to bf16 before the product with v, as
//     `_fwd_kernel` does, so FlashAttention's deferred normalisation would
//     round elsewhere. Pass 1 gives each row's max and sum (online, f32);
//     pass 2 recomputes the scores, forms bf16(exp(s - m) / l) (after
//     dropout) and accumulates P v in f32 registers;
//   - the skew without a gather from device memory: a key tile
//     [s0, s0+64) of a query tile [t0, t0+64) needs only the band of p rows
//     j in [T-1-(t0+63)+s0, T-1-t0+s0+63] (127 rows, loaded as 128, rows
//     outside [0, 2T-2] zero). Each warp multiplies its qv rows by the 80
//     band rows its 16 query rows need ([16 x 80] f32), stores the product
//     in its own shared memory, and reads bd[t, s'] back by index (the
//     counterpart of the `_skew` log-roll, which exists only because Mosaic
//     has no gather);
//   - products on mma.sync m16n8k16 bf16 -> f32; k tiles and p bands row-
//     major, v transposed ([dh][key]) so every B fragment register is one
//     32-bit load; rows padded by 8 bf16 so a warp's fragment loads hit 32
//     banks;
//   - the score sum and scale round as the plain version does
//     (__fadd_rn, then __fmul_rn: no FMA contraction); expf, not __expf,
//     and an IEEE divide (no --use_fast_math);
//   - key columns past T (the ragged last tile) drop out of the max and the
//     sum entirely; masked keys inside [0, T) take -1e9 and still count, so
//     an all-pad row comes out as uniform 1/T, as in JAX.
//
// The entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not
// take: dh outside [1, 64], a drop threshold outside [0, 255]).

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
constexpr int WBAND = 80;        // band columns one warp needs (79), padded
constexpr int NT_B = WBAND / 8;  // n8 tiles of a warp's band product
constexpr int WBAND_LD = WBAND + 8;  // f32 row stride of a warp's band scores
constexpr int LDV = BK + 8;      // bf16 row stride of the transposed v tile
constexpr float NEG = -1e9f;

typedef __nv_bfloat16 bf16;

template <int DHP>
struct Layout {
  static constexpr int LD = DHP + 8;  // bf16 row stride of k, p band, q staging
  static constexpr int KT = 0;
  static constexpr int PB = KT + BK * LD * 2;
  static constexpr int VT = PB + BAND * LD * 2;
  static constexpr int SCRATCH = VT + DHP * LDV * 2;
  // qu/qv staging at the start, then the warps' band scores
  static constexpr int QSTAGE_BYTES = 2 * BQ * LD * 2;
  static constexpr int BANDS_BYTES = WARPS * 16 * WBAND_LD * 4;
  static constexpr int COLV =
      SCRATCH + (QSTAGE_BYTES > BANDS_BYTES ? QSTAGE_BYTES : BANDS_BYTES);
  static constexpr int BYTES = COLV + BK * 4;
};

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int DHP>
__global__ void __launch_bounds__(THREADS)
    relpos_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ p,
                                const bf16* __restrict__ u, const bf16* __restrict__ vb,
                                const float* __restrict__ key_mask,
                                const uint8_t* __restrict__ drop8, bf16* __restrict__ out,
                                int H, int T, int dh, float scale, int drop_k,
                                float drop_scale) {
  using L = Layout<DHP>;
  constexpr int LD = L::LD;
  constexpr int KS = DHP / 16;  // k16 steps over dh
  constexpr int NO = DHP / 8;   // n8 output tiles (those at or past dh skipped)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kt = reinterpret_cast<bf16*>(smem + L::KT);
  bf16* pb = reinterpret_cast<bf16*>(smem + L::PB);
  bf16* vt = reinterpret_cast<bf16*>(smem + L::VT);
  float* colv = reinterpret_cast<float*>(smem + L::COLV);

  const int t0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int P = 2 * T - 1;
  const bf16* qg = q + bh * T * dh;
  const bf16* kg = k + bh * T * dh;
  const bf16* vg = v + bh * T * dh;
  const bf16* pg = p + (size_t)h * P * dh;
  const float* mg = key_mask + (size_t)b * T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;

  // ---- qu = bf16(q + u), qv = bf16(q + vb), zero past T and dh; then each
  // warp takes its 16 rows as A fragments
  {
    bf16* qus = reinterpret_cast<bf16*>(smem + L::SCRATCH);
    bf16* qvs = qus + BQ * LD;
    for (int i = threadIdx.x; i < BQ * DHP; i += THREADS) {
      const int r = i / DHP, c = i % DHP;
      float a = 0.f, c2 = 0.f;
      if (t0 + r < T && c < dh) {
        const float x = __bfloat162float(qg[(size_t)(t0 + r) * dh + c]);
        a = __fadd_rn(x, __bfloat162float(u[h * dh + c]));
        c2 = __fadd_rn(x, __bfloat162float(vb[h * dh + c]));
      }
      qus[r * LD + c] = __float2bfloat16_rn(a);
      qvs[r * LD + c] = __float2bfloat16_rn(c2);
    }
  }
  __syncthreads();
  uint32_t aqu[KS][4], aqv[KS][4];
  {
    const bf16* qus = reinterpret_cast<const bf16*>(smem + L::SCRATCH);
    const bf16* qvs = qus + BQ * LD;
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = 16 * ks + 2 * tq;
      aqu[ks][0] = ld_u32(qus + r0 * LD + c);
      aqu[ks][1] = ld_u32(qus + (r0 + 8) * LD + c);
      aqu[ks][2] = ld_u32(qus + r0 * LD + c + 8);
      aqu[ks][3] = ld_u32(qus + (r0 + 8) * LD + c + 8);
      aqv[ks][0] = ld_u32(qvs + r0 * LD + c);
      aqv[ks][1] = ld_u32(qvs + (r0 + 8) * LD + c);
      aqv[ks][2] = ld_u32(qvs + r0 * LD + c + 8);
      aqv[ks][3] = ld_u32(qvs + (r0 + 8) * LD + c + 8);
    }
  }
  // this warp's [16 x WBAND_LD] f32 band scores (the staging area, reused)
  float* bs = reinterpret_cast<float*>(smem + L::SCRATCH) + warp * 16 * WBAND_LD;
  const int cb = 48 - 16 * warp;  // first band row this warp's rows need

  // Load the key tile [s0, s0 + BK): k, its band of p, v (pass 2) and the
  // column states (1 valid, 0 masked, -1 past T). Brackets its loads with
  // barriers, so the tile before is no longer read.
  auto load_tile = [&](int s0, bool with_v) {
    __syncthreads();
    load_rows<DHP, false>(kt, LD, kg, s0, BK, T, dh);
    load_rows<DHP, false>(pb, LD, pg, T - 1 - (t0 + BQ - 1) + s0, BAND, P, dh);
    if (with_v) load_rows<DHP, true>(vt, LDV, vg, s0, BK, T, dh);
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
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const bf16* kr = kt + (8 * j + g) * LD + 16 * ks + 2 * tq;
        mma_bf16(sc[j], aqu[ks], ld_u32(kr), ld_u32(kr + 8));
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
#pragma unroll
        for (int j = 0; j < NT_B; ++j) {
          const bf16* pr = pb + (cb + 8 * j + g) * LD + 16 * ks + 2 * tq;
          mma_bf16(bb[j], aqv[ks], ld_u32(pr), ld_u32(pr + 8));
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

  // ---- pass 1: row max and sum, online in f32 (rows g and g + 8)
  float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
  float l[2] = {0.f, 0.f};
  for (int s0 = 0; s0 < T; s0 += BK) {
    load_tile(s0, false);
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

  // ---- pass 2: P = bf16(dropout(exp(s - m) / l)), out += P v
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const int trow = t0 + warp * 16 + g;  // query row of e < 2; e >= 2 is + 8
  for (int s0 = 0; s0 < T; s0 += BK) {
    load_tile(s0, true);
    float sc[NT_S][4];
    scores(sc);
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pr = expf(sc[j][e] - m[r]) / l[r];
        if (drop_k > 0) {
          const int t = trow + 8 * r, s = s0 + 8 * j + 2 * tq + (e & 1);
          if (t < T && s < T) {
            const int byte = drop8[(bh * T + t) * T + s];
            pr = byte >= drop_k ? __fmul_rn(pr, drop_scale) : 0.f;
          }
        }
        sc[j][e] = pr;
      }
    }
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
        const bf16* vr = vt + (8 * n + g) * LDV + 16 * kk + 2 * tq;
        mma_bf16(o[n], a, ld_u32(vr), ld_u32(vr + 8));
      }
    }
  }

  // ---- epilogue: bf16 stores of rows < T, columns < dh
  bf16* og = out + bh * T * dh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = trow + 8 * (e >> 1), c = 8 * n + 2 * tq + (e & 1);
      if (t < T && c < dh) og[(size_t)t * dh + c] = __float2bfloat16_rn(o[n][e]);
    }
  }
}

template <int DHP>
int launch(const void* q, const void* k, const void* v, const void* p, const void* u,
           const void* vb, const void* key_mask, const void* drop8, void* out, int B,
           int H, int T, int dh, float scale, int drop_k, float drop_scale,
           cudaStream_t stream) {
  constexpr int smem = Layout<DHP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(relpos_attention_fwd_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  relpos_attention_fwd_kernel<DHP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(p), static_cast<const bf16*>(u), static_cast<const bf16*>(vb),
      static_cast<const float*>(key_mask), static_cast<const uint8_t*>(drop8),
      static_cast<bf16*>(out), H, T, dh, scale, drop_k, drop_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[B,H,T,dh] (bf16) = rel-pos attention of q/k/v [B,H,T,dh], p [H,2T-1,dh],
// u/vb [H,dh] (all bf16, contiguous, 16-byte aligned), key_mask [B,T] f32,
// drop8 [B,H,T,T] uint8 (read only when drop_k > 0; drop_scale =
// 256/(256-drop_k) as f32).
int fused_relpos_attention_fwd(const void* q, const void* k, const void* v, const void* p,
                               const void* u, const void* vb, const void* key_mask,
                               const void* drop8, void* out, int B, int H, int T, int dh,
                               float scale, int drop_k, float drop_scale, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || H < 1 || T < 1 || dh < 1 || dh > 64 || drop_k < 0 || drop_k > 255) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((dh + 15) / 16) {
    case 1: return launch<16>(q, k, v, p, u, vb, key_mask, drop8, out, B, H, T, dh, scale, drop_k, drop_scale, s);
    case 2: return launch<32>(q, k, v, p, u, vb, key_mask, drop8, out, B, H, T, dh, scale, drop_k, drop_scale, s);
    case 3: return launch<48>(q, k, v, p, u, vb, key_mask, drop8, out, B, H, T, dh, scale, drop_k, drop_scale, s);
    default: return launch<64>(q, k, v, p, u, vb, key_mask, drop8, out, B, H, T, dh, scale, drop_k, drop_scale, s);
  }
}

}  // extern "C"

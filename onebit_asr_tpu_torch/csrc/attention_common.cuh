// Pieces shared by the fused rel-pos attention kernels (csrc/attention.cu,
// csrc/attention_bwd.cu): tile sizes, the cp.async tile copies, ldmatrix
// and mma.sync wrappers, and the softmax's exp and divide. Everything here
// has internal linkage, so each source that includes it owns its copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;              // query rows of a tile
constexpr int BK = 64;              // keys of a tile
constexpr int PBLK = 64;            // p rows of one block of the band ring
constexpr int DROP_LD = BK + 16;    // byte row stride of a staged [query][key] dropout tile
constexpr float NEG = -1e9f;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- cp.async: src_bytes < size zero-fills the rest (0: the whole chunk)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- ldmatrix (four or two 8x8 b16 matrices; lane L gives the address of
// row L & 7 of matrix L >> 3) and mma.sync m16n8k16 bf16 -> f32
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment addresses, for lane L of a warp, in a row-major bf16 tile with
// row stride ld (elements):
// - A of rows [r0, r0+16) x columns [c0, c0+16), ldmatrix.x4;
// - B of two n8 tiles [n0, n0+16) x k [k0, k0+16) from a tile stored
//   [n][k], ldmatrix.x4 (regs: b0, b1 of n0; b0, b1 of n0 + 8);
// - B of two n8 tiles from a tile stored [k][n], ldmatrix.x4.trans;
// - A of [m0, m0+16) x [k0, k0+16) from a tile stored [k][m],
//   ldmatrix.x4.trans;
// - B of one n8 tile from a tile stored [k][n], ldmatrix.x2.trans.
__device__ __forceinline__ const bf16* frag_a(const bf16* t, int ld, int r0, int c0, int L) {
  return t + (r0 + (L & 7) + 8 * ((L >> 3) & 1)) * ld + c0 + 8 * (L >> 4);
}
__device__ __forceinline__ const bf16* frag_b_nk(const bf16* t, int ld, int n0, int k0, int L) {
  return t + (n0 + (L & 7) + 8 * (L >> 4)) * ld + k0 + 8 * ((L >> 3) & 1);
}
__device__ __forceinline__ const bf16* frag_b_kn(const bf16* t, int ld, int k0, int n0, int L) {
  return t + (k0 + (L & 7) + 8 * ((L >> 3) & 1)) * ld + n0 + 8 * (L >> 4);
}
__device__ __forceinline__ const bf16* frag_a_km(const bf16* t, int ld, int m0, int k0, int L) {
  return t + (k0 + (L & 7) + 8 * (L >> 4)) * ld + m0 + 8 * ((L >> 3) & 1);
}
__device__ __forceinline__ const bf16* frag_b1_kn(const bf16* t, int ld, int k0, int n0, int L) {
  return t + (k0 + (L & 7) + 8 * ((L >> 3) & 1)) * ld + n0;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The softmax's exp and divide: expf (not __expf) and the IEEE quotient
// a / b, as `_fwd_kernel` and the plain version. The divisor is a row's sum
// (>= 1), the same for the whole row, so its correctly rounded reciprocal
// y = RN(1/b) (sm_rcp) is taken once per row: then q = RN(a y) is within an
// ulp of a/b, the remainder a - b q is exact in an FMA, and RN(q + (a - b q) y)
// is the correctly rounded quotient (Markstein), for a = 0 and every a from
// 2^-96 up (a/b stays normal). A smaller a (sm_div_tiny) takes the divide
// itself, in a loop of its own that the whole warp takes when any lane
// needs it (sm_div_rows), so that the common path carries no call.
// tests/test_torch_kernels_cuda.py holds sm_div against a / b on the card.
__device__ __forceinline__ float sm_exp(float x) { return expf(x); }
__device__ __forceinline__ float sm_rcp(float b) { return __frcp_rn(b); }
__device__ __forceinline__ bool sm_div_tiny(float a) { return a != 0.f && a < 0x1p-96f; }
__device__ __forceinline__ float sm_div(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// e[j][x] / l[x >> 1] in place (x >> 1 is the element's row), y = sm_rcp(l)
template <int N>
__device__ __forceinline__ void sm_div_rows(float (&e)[N][4], const float (&l)[2],
                                            const float (&y)[2]) {
  bool tiny = false;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) tiny = tiny || sm_div_tiny(e[j][x]);
  if (__any_sync(0xffffffffu, tiny)) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) e[j][x] = e[j][x] / l[x >> 1];
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) e[j][x] = sm_div(e[j][x], l[x >> 1], y[x >> 1]);
  }
}

// Rows [lo, lo + n) of a row-major [rows, dh] bf16 matrix into a shared tile
// [n][LD]: zero for rows outside [0, rows) and columns in [dh, DHP). 16-byte
// cp.async when dh % 8 == 0, 8-byte when dh % 4 == 0 (dh = 36: 72-byte rows),
// element by element (synchronous) otherwise.
template <int DHP, int LD, int THREADS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ src, int lo, int n,
                                          int rows, int dh) {
  if (dh % 8 == 0) {
    constexpr int C = DHP / 8;
    for (int i = threadIdx.x; i < n * C; i += THREADS) {
      const int r = i / C, c = 8 * (i % C), row = lo + r;
      const bool ok = row >= 0 && row < rows && c < dh;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)row * dh + c : src, ok ? 16 : 0);
    }
  } else if (dh % 4 == 0) {
    constexpr int C = DHP / 4;
    for (int i = threadIdx.x; i < n * C; i += THREADS) {
      const int r = i / C, c = 4 * (i % C), row = lo + r;
      const bool ok = row >= 0 && row < rows && c < dh;
      cp_async8(dst + r * LD + c, ok ? src + (size_t)row * dh + c : src, ok ? 8 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n * DHP; i += THREADS) {
      const int r = i / DHP, c = i % DHP, row = lo + r;
      dst[r * LD + c] = (row >= 0 && row < rows && c < dh) ? src[(size_t)row * dh + c]
                                                           : __float2bfloat16_rn(0.f);
    }
  }
}

// The [BQ queries][BK keys] dropout bytes at (t0, s0) of one (b, h)'s [T, T]
// draws into a shared tile with row stride DROP_LD, zero past T.
template <int THREADS>
__device__ __forceinline__ void copy_drop(uint8_t* dst, const uint8_t* __restrict__ src, int t0,
                                          int s0, int T) {
  if (T % 16 == 0) {
    for (int i = threadIdx.x; i < BQ * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = 16 * (i % (BK / 16)), t = t0 + r, s = s0 + c;
      const bool ok = t < T && s < T;
      cp_async16(dst + r * DROP_LD + c, ok ? src + (size_t)t * T + s : src, ok ? 16 : 0);
    }
  } else if (T % 4 == 0) {
    for (int i = threadIdx.x; i < BQ * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), c = 4 * (i % (BK / 4)), t = t0 + r, s = s0 + c;
      const bool ok = t < T && s < T;
      cp_async4(dst + r * DROP_LD + c, ok ? src + (size_t)t * T + s : src, ok ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, t = t0 + r, s = s0 + c;
      dst[r * DROP_LD + c] = (t < T && s < T) ? src[(size_t)t * T + s] : (uint8_t)0;
    }
  }
}

// src[lo .. lo + n) of an f32 vector of length len into dst, zero past len.
template <int THREADS>
__device__ __forceinline__ void copy_f32(float* dst, const float* __restrict__ src, int lo, int n,
                                         int len) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const bool ok = lo + i < len;
    cp_async4(dst + i, ok ? src + lo + i : src, ok ? 4 : 0);
  }
}

}  // namespace

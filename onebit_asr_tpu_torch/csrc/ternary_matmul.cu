// Packed-ternary matrix products for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of onebit_asr_tpu/ops/ternary_matmul.py:
//   ternary_matmul_bf16  <- _kernel      (:60-71, pallas_call at :97)
//   ternary_matmul_w2a8  <- _kernel_w2a8 (:190-203, pallas_call at :233)
//
// Both compute x[M,K] @ unpack_planar(packed)[K,N] where `packed` is the
// planar 2-bit layout of pack_planar: byte (i, n) holds rows i, i+K/4,
// i+K/2, i+3K/4 of column n in its four 2-bit slots, each storing q+1.
//
// What bounds them: on the serving path of Conformer-M (K, N in {256, 1024};
// M = B*T' = 4096 at B=8 and 16 s, and 2T'-1 = 1023 for the position
// projection) a call moves M*K*2 bytes of bf16 activations, K*N/4 bytes of
// weights and M*N*4 bytes of f32 output for 2*M*N*K operations: 85 to 170
// operations per byte at these shapes, below the ~295 (bf16) and ~590 (int8)
// at which the H100's tensor cores rather than its memory become the limit.
// So the bound is memory traffic (3.35 TB/s): at M=4096, K=1024, N=256 that
// is 12.6 MB, 3.8 us (the 2.1 GFLOP take 2.2 us at 989 TFLOP/s). The design
// keeps the weight at 2 bits per element in device memory and unpacks it into
// shared memory per tile, so weight traffic stays 8x below bf16.
//
// Design (a simple, correct first kernel; wgmma/TMA are later work):
//   - 64x64 output tile per block of 128 threads (4 warps, 32x32 each);
//   - the A tile (activations) is copied to shared memory, 16 bytes per
//     thread where K and the pointer allow it, else element by element;
//   - the B tile is unpacked from the 2-bit bytes into shared memory as bf16
//     (or int8) {-1,0,+1}, stored N-major so each thread's B fragment is one
//     32-bit load;
//   - mma.sync m16n8k16 bf16 -> f32, or m16n8k32 s8 -> s32 (exact);
//   - ragged M, N and K edges are masked in the kernel (zero fill, guarded
//     stores): the caller pads nothing.
//   - W2A8: activations arrive already quantized per row (int8 + f32 scale),
//     done in PyTorch before the launch (ops/ternary_matmul.py
//     quantize_activations_int8), as the TPU version does outside its kernel.
//     The epilogue is (float)acc * scale[m] * alpha in that order, so the
//     result equals the plain version bit for bit.
//
// Every entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int THREADS = 128;
constexpr int BK_BF16 = 32;  // two k16 steps
constexpr int BK_S8 = 64;    // two k32 steps
constexpr int PAD_BF16 = 8;  // row padding in elements (keeps 16-byte rows)
constexpr int PAD_S8 = 16;

// Weight code q in {-1,0,+1} of row k, column n of the planar-packed matrix.
__device__ __forceinline__ int weight_code(const uint8_t* __restrict__ packed,
                                           int K4, int N, int k, int n) {
  const uint8_t b = packed[(size_t)(k % K4) * N + n];
  return (int)((b >> (2 * (k / K4))) & 3u) - 1;
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies the [BM, BK] tile of a row-major [M, K] matrix at (m0, k0) into
// shared memory, zero-filling outside the matrix. VEC elements make 16 bytes;
// `vec` says that K is a multiple of VEC and the base pointer 16-byte aligned.
template <typename T, int BK, int LD, int VEC>
__device__ __forceinline__ void load_a_tile(T (*As)[LD], const T* __restrict__ x,
                                            int M, int K, int m0, int k0,
                                            int vec) {
  const int tid = threadIdx.x;
  if (vec) {
    for (int i = tid; i < BM * BK / VEC; i += THREADS) {
      const int r = i / (BK / VEC);
      const int c = (i % (BK / VEC)) * VEC;
      const int gm = m0 + r, gk = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M && gk < K) {
        v = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
      }
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
  } else {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      T v{};
      if (gm < M && gk < K) v = x[(size_t)gm * K + gk];
      As[r][c] = v;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    ternary_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const uint8_t* __restrict__ packed,
                        const float* __restrict__ alpha,
                        float* __restrict__ out, int M, int K, int N, int vec) {
  constexpr int BK = BK_BF16;
  constexpr int LD = BK + PAD_BF16;
  __shared__ __align__(16) __nv_bfloat16 As[BM][LD];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K4 = K >> 2;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a_tile<__nv_bfloat16, BK, LD, 8>(As, x, M, K, m0, k0, vec);
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int n = i % BN, kk = i / BN;
      const int gn = n0 + n, gk = k0 + kk;
      const int q = (gn < N && gk < K) ? weight_code(packed, K4, N, gk, gn) : 0;
      Bs[n][kk] = __int2bfloat16_rn(q);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        a[mi][0] = ld_u32(&As[r][ks + 2 * t]);
        a[mi][1] = ld_u32(&As[r + 8][ks + 2 * t]);
        a[mi][2] = ld_u32(&As[r][ks + 2 * t + 8]);
        a[mi][3] = ld_u32(&As[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        b[ni][0] = ld_u32(&Bs[n][ks + 2 * t]);
        b[ni][1] = ld_u32(&Bs[n][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  const float al = *alpha;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + wn + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + g + 8 * h;
        if (r >= M) continue;
        if (c < N) out[(size_t)r * N + c] = acc[mi][ni][2 * h] * al;
        if (c + 1 < N) out[(size_t)r * N + c + 1] = acc[mi][ni][2 * h + 1] * al;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    ternary_w2a8_kernel(const int8_t* __restrict__ xq,
                        const float* __restrict__ scale,
                        const uint8_t* __restrict__ packed,
                        const float* __restrict__ alpha,
                        float* __restrict__ out, int M, int K, int N, int vec) {
  constexpr int BK = BK_S8;
  constexpr int LD = BK + PAD_S8;
  __shared__ __align__(16) int8_t As[BM][LD];
  __shared__ __align__(16) int8_t Bs[BN][LD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K4 = K >> 2;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a_tile<int8_t, BK, LD, 16>(As, xq, M, K, m0, k0, vec);
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int n = i % BN, kk = i / BN;
      const int gn = n0 + n, gk = k0 + kk;
      Bs[n][kk] = (int8_t)((gn < N && gk < K)
                               ? weight_code(packed, K4, N, gk, gn) : 0);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        a[mi][0] = ld_u32(&As[r][ks + 4 * t]);
        a[mi][1] = ld_u32(&As[r + 8][ks + 4 * t]);
        a[mi][2] = ld_u32(&As[r][ks + 4 * t + 16]);
        a[mi][3] = ld_u32(&As[r + 8][ks + 4 * t + 16]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        b[ni][0] = ld_u32(&Bs[n][ks + 4 * t]);
        b[ni][1] = ld_u32(&Bs[n][ks + 4 * t + 16]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  const float al = *alpha;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + wn + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + g + 8 * h;
        if (r >= M) continue;
        const float s = scale[r];
        if (c < N) {
          out[(size_t)r * N + c] =
              __fmul_rn(__fmul_rn((float)acc[mi][ni][2 * h], s), al);
        }
        if (c + 1 < N) {
          out[(size_t)r * N + c + 1] =
              __fmul_rn(__fmul_rn((float)acc[mi][ni][2 * h + 1], s), al);
        }
      }
    }
  }
}

inline dim3 grid_for(int M, int N) {
  return dim3((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
}

}  // namespace

extern "C" {

// out[M,N] (f32) = bf16 x[M,K] @ unpack_planar(packed[K/4,N]) * alpha[0].
int ternary_matmul_bf16(const void* x, const void* packed, const void* alpha,
                        void* out, int M, int K, int N, int vec, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ternary_bf16_kernel<<<grid_for(M, N), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(alpha), static_cast<float*>(out), M, K, N, vec);
  return (int)cudaGetLastError();
}

// out[M,N] (f32) = (int32 xq[M,K] @ unpack_planar(packed)) * scale[m] * alpha.
int ternary_matmul_w2a8(const void* xq, const void* scale, const void* packed,
                        const void* alpha, void* out, int M, int K, int N,
                        int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ternary_w2a8_kernel<<<grid_for(M, N), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(scale),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(alpha),
      static_cast<float*>(out), M, K, N, vec);
  return (int)cudaGetLastError();
}

const char* onebit_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Fused Conv2dSubsampling forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel onebit_asr_tpu/ops/subsampler.py:217
// (_fwd_kernel, :217-241; entry _fs_fwd :421, pallas_call :430):
//   conv1 3x3 stride 2 VALID (C_in = 1, in f32) -> ReLU -> cast to bf16 ->
//   conv2 3x3 stride 2 VALID as the im2col product [T2*F2, 9C] x [9C, C]
//   (bf16 operands, f32 sums) -> + b2 -> ReLU -> bf16 [B, T2, F2, C],
// with the conv1 activation kept on chip: it never reaches device memory.
//
// What bounds it: on the serving path of Conformer-M (B=8, 16 s: T=1598,
// F=80, C=256 -> T2=398, F2=19) conv2 is 2*8*398*19*256*2304 = 71.4 GFLOP of
// bf16, 0.072 ms at 989 TFLOP/s, while the bytes it must move are ~36 MB
// (x 4.1 MB f32, y 31 MB bf16, w2 1.2 MB), 0.011 ms at 3.35 TB/s. conv1 is
// 1.15 GFLOP of f32 on the CUDA cores. So the bound is operations: the
// tensor cores' rate on conv2. The unfused path also writes and reads back
// the 127.5 MB conv1 activation, which this kernel keeps in shared memory.
//
// Design (a simple, correct first kernel; wgmma/TMA and pipelining later):
//   - one CTA of 256 threads per (utterance b, block of r2 output rows);
//   - conv1: the CTA copies input rows [4*t0, 4*t0 + 4*r2 + 3) to shared
//     memory and computes conv1 rows [2*t0, 2*t0 + 2*r2 + 1) x F1 x C in the
//     plain version's order (b1, then taps (i, j) in order, each product and
//     sum rounded separately, __fmul_rn/__fadd_rn), each thread holding one
//     channel pair's taps in registers; ReLU, then bf16 into dynamic shared
//     memory; each pixel row is padded by 4 bf16 so the A fragment loads of
//     one warp hit 32 distinct banks;
//   - r2 is the largest row block whose conv1 tile, B stage and input window
//     fit the 227 KB of shared memory and whose r2*F2 rows fit one 96-row M
//     group (C=256, F=80: r2=4, 206 KB; C=512: r2=2);
//   - conv2: mma.sync m16n8k16 bf16 -> f32. The A fragments are gathered
//     straight from the conv1 tile by index arithmetic (row -> (t, f), column
//     -> (tap, c)); no im2col buffer exists. w2 arrives as bf16 [9C, C]
//     (cast once when the model is loaded) and streams through shared memory
//     in K chunks of 64 rows x 128 columns, stored as (k, k+1) pairs so each
//     B fragment register is one 32-bit load; each chunk is fetched into
//     registers while the mma of the chunk before runs;
//   - 8 warps as 2 (M) x 4 (N), each 3 m16 tiles x 4 n8 tiles; the CTA loops
//     over 96-row M groups and 128-column N chunks (C=144 ends in a 16-wide
//     chunk; n8 tiles past C are skipped);
//   - epilogue: + b2, ReLU, bf16 stores with guarded rows, so T2 needs no
//     padding and the last row block may be short.
//
// The entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take:
// C not a multiple of 16, or a conv1 tile that does not fit shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS_N = 4;                 // 8 warps: 2 along M x 4 along N
constexpr int WARPS_M = THREADS / 32 / WARPS_N;
constexpr int MT_WARP = 3;                 // m16 tiles per warp per M group
constexpr int NT_WARP = 4;                 // n8 tiles per warp per N chunk
constexpr int MG = WARPS_M * MT_WARP * 16; // 96 output pixels per M group
constexpr int NCH = WARPS_N * NT_WARP * 8; // 128 output channels per N chunk
constexpr int KC = 64;                     // w2 rows per shared-memory stage
constexpr int NS = NCH + 8;                // words per k-pair row (8 mod 32)
constexpr int PIX_PAD = 4;                 // bf16 pad per conv1 pixel
constexpr int B_STAGE_BYTES = (KC / 2) * NS * 4;
constexpr int FETCH_ITEMS = (KC / 2) * (NCH / 8) / THREADS;  // per thread
static_assert(FETCH_ITEMS * THREADS == (KC / 2) * (NCH / 8), "even B stage");
constexpr int SMEM_LIMIT = 232448;         // 227 KB per block on sm_90
constexpr int R2_MAX = 8;

__host__ __device__ inline int out_len(int n) { return (n - 1) / 2; }

__host__ __device__ inline size_t c1_tile_bytes(int r2, int F1, int C) {
  const size_t b = (size_t)(2 * r2 + 1) * F1 * (C + PIX_PAD) * 2;
  return (b + 15) & ~(size_t)15;
}

// shared memory: conv1 tile | B stage | input window
inline size_t smem_bytes(int r2, int F, int C) {
  return c1_tile_bytes(r2, out_len(F), C) + B_STAGE_BYTES +
         (size_t)(4 * r2 + 3) * F * sizeof(float);
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS)
    fused_subsample_fwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ w1,
                               const float* __restrict__ b1,
                               const __nv_bfloat16* __restrict__ w2,
                               const float* __restrict__ b2,
                               __nv_bfloat16* __restrict__ y, int T, int F,
                               int C, int r2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T1 = out_len(T), F1 = out_len(F);
  const int T2 = out_len(T1), F2 = out_len(F1);
  const int PIX = C + PIX_PAD;
  const int R1 = 2 * r2 + 1;
  __nv_bfloat16* c1 = reinterpret_cast<__nv_bfloat16*>(smem);
  uint32_t* Bs = reinterpret_cast<uint32_t*>(smem + c1_tile_bytes(r2, F1, C));
  float* xs = reinterpret_cast<float*>(smem + c1_tile_bytes(r2, F1, C) + B_STAGE_BYTES);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * r2;  // first output row of this block
  const int rows = min(r2, T2 - t0);
  const float* xb = x + (size_t)b * T * F;

  // ---- the input window: rows [4*t0, 4*t0 + 4*r2 + 3) of x, f32
  const int XR = min(4 * r2 + 3, T - 4 * t0);
  for (int i = threadIdx.x; i < XR * F; i += THREADS) xs[i] = xb[(size_t)4 * t0 * F + i];
  __syncthreads();

  // ---- conv1 -> ReLU -> bf16 tile; local row r is conv1 row 2*t0 + r.
  // Each thread keeps one channel pair's 9 taps and bias in registers and
  // walks the pixels of its lane. Rows past T1 feed only output rows past T2
  // (never stored): zeros.
  const int C2 = C / 2;
  const int lanes = max(1, THREADS / C2);
  const int lane1 = threadIdx.x / C2;
  for (int cp = threadIdx.x % C2; lane1 < lanes && cp < C2; cp += THREADS) {
    const int c = 2 * cp;
    float2 w[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      w[tap] = *reinterpret_cast<const float2*>(w1 + tap * C + c);
    }
    const float2 bias = *reinterpret_cast<const float2*>(b1 + c);
    for (int pix = lane1; pix < R1 * F1; pix += lanes) {
      const int r = pix / F1, f1 = pix - r * F1;
      float acc0 = 0.f, acc1 = 0.f;
      if (2 * t0 + r < T1) {
        acc0 = bias.x;
        acc1 = bias.y;
        const float* xr = xs + 2 * r * F + 2 * f1;
#pragma unroll
        for (int ti = 0; ti < 3; ++ti) {
#pragma unroll
          for (int tj = 0; tj < 3; ++tj) {
            const float xv = xr[ti * F + tj];
            acc0 = __fadd_rn(acc0, __fmul_rn(xv, w[ti * 3 + tj].x));
            acc1 = __fadd_rn(acc1, __fmul_rn(xv, w[ti * 3 + tj].y));
          }
        }
        acc0 = relu(acc0);
        acc1 = relu(acc1);
      }
      *reinterpret_cast<__nv_bfloat162*>(c1 + (size_t)pix * PIX + c) =
          __floats2bfloat162_rn(acc0, acc1);
    }
  }
  __syncthreads();

  // ---- conv2 as [rows*F2, 9C] x [9C, C] on mma.sync
  const int M = rows * F2;
  const int K = 9 * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  for (int m0 = 0; m0 < M; m0 += MG) {
    // per m16 tile of this warp: tile offset of the tap-(0,0) pixel of its
    // rows g and g+8 (padded rows read pixel 0 and are never stored)
    int off[MT_WARP][2];
    bool mt_on[MT_WARP];
#pragma unroll
    for (int q = 0; q < MT_WARP; ++q) {
      const int base = m0 + (wm + WARPS_M * q) * 16;
      mt_on[q] = base < M;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int row = base + g + 8 * h;
        if (row >= M) row = 0;
        const int tl = row / F2, f = row % F2;
        off[q][h] = (2 * tl * F1 + 2 * f) * PIX;
      }
    }

    for (int n0 = 0; n0 < C; n0 += NCH) {
      float acc[MT_WARP][NT_WARP][4];
#pragma unroll
      for (int q = 0; q < MT_WARP; ++q)
#pragma unroll
        for (int j = 0; j < NT_WARP; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;

      // w2 rows [k0, k0+KC) x columns [n0, n0+NCH) are fetched into
      // registers one chunk ahead, so their loads overlap the mma of the
      // chunk before; staged in shared memory as word (p, n) =
      // (w2[k0+2p][n], w2[k0+2p+1][n]), low half the even row. K and C are
      // multiples of 16, so a row pair and 8 columns are all in or all out.
      uint4 pf[FETCH_ITEMS][2];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int it = 0; it < FETCH_ITEMS; ++it) {
          const int i = threadIdx.x + it * THREADS;
          const int k = k0 + 2 * (i / (NCH / 8)), n = n0 + 8 * (i % (NCH / 8));
          pf[it][0] = pf[it][1] = make_uint4(0u, 0u, 0u, 0u);
          if (k < K && n < C) {
            pf[it][0] = *reinterpret_cast<const uint4*>(w2 + (size_t)k * C + n);
            pf[it][1] = *reinterpret_cast<const uint4*>(w2 + (size_t)(k + 1) * C + n);
          }
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < K; k0 += KC) {
#pragma unroll
        for (int it = 0; it < FETCH_ITEMS; ++it) {
          const int i = threadIdx.x + it * THREADS;
          const uint4 lo = pf[it][0], hi = pf[it][1];
          uint4* dst = reinterpret_cast<uint4*>(Bs + (i / (NCH / 8)) * NS + 8 * (i % (NCH / 8)));
          dst[0] = make_uint4(__byte_perm(lo.x, hi.x, 0x5410),
                              __byte_perm(lo.x, hi.x, 0x7632),
                              __byte_perm(lo.y, hi.y, 0x5410),
                              __byte_perm(lo.y, hi.y, 0x7632));
          dst[1] = make_uint4(__byte_perm(lo.z, hi.z, 0x5410),
                              __byte_perm(lo.z, hi.z, 0x7632),
                              __byte_perm(lo.w, hi.w, 0x5410),
                              __byte_perm(lo.w, hi.w, 0x7632));
        }
        __syncthreads();
        if (k0 + KC < K) fetch(k0 + KC);
#pragma unroll
        for (int ks = 0; ks < KC; ks += 16) {
          const int k = k0 + ks;
          if (k >= K) break;  // uniform: the last chunk may be short
          // a k16 step lies inside one tap, since C % 16 == 0
          const int tap = k / C, c0 = k - tap * C;
          const int tapoff = ((tap / 3) * F1 + tap % 3) * PIX + c0 + 2 * t;
          uint32_t bf[NT_WARP][2];
#pragma unroll
          for (int j = 0; j < NT_WARP; ++j) {
            const int n = wn * (NT_WARP * 8) + j * 8 + g;
            bf[j][0] = Bs[(ks / 2 + t) * NS + n];
            bf[j][1] = Bs[(ks / 2 + t + 4) * NS + n];
          }
#pragma unroll
          for (int q = 0; q < MT_WARP; ++q) {
            if (!mt_on[q]) continue;
            uint32_t a[4];
            a[0] = ld_u32(c1 + off[q][0] + tapoff);
            a[1] = ld_u32(c1 + off[q][1] + tapoff);
            a[2] = ld_u32(c1 + off[q][0] + tapoff + 8);
            a[3] = ld_u32(c1 + off[q][1] + tapoff + 8);
#pragma unroll
            for (int j = 0; j < NT_WARP; ++j) {
              if (n0 + wn * (NT_WARP * 8) + j * 8 < C) mma_bf16(acc[q][j], a, bf[j]);
            }
          }
        }
        __syncthreads();
      }

      // ---- epilogue: + b2, ReLU, bf16; rows past this block's M skipped
#pragma unroll
      for (int q = 0; q < MT_WARP; ++q) {
        if (!mt_on[q]) continue;
#pragma unroll
        for (int j = 0; j < NT_WARP; ++j) {
          const int col = n0 + wn * (NT_WARP * 8) + j * 8 + 2 * t;
          if (col >= C) continue;
          const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + (wm + WARPS_M * q) * 16 + g + 8 * h;
            if (row >= M) continue;
            const int tl = row / F2, f = row % F2;
            const float v0 = relu(acc[q][j][2 * h] + bias.x);
            const float v1 = relu(acc[q][j][2 * h + 1] + bias.y);
            *reinterpret_cast<__nv_bfloat162*>(
                y + (((size_t)b * T2 + t0 + tl) * F2 + f) * C + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// Output rows per CTA for these shapes, or 0 when no block fits.
int pick_r2(int F, int C, int T2) {
  const int F2 = out_len(out_len(F));
  int r2 = R2_MAX;
  while (r2 > 1 && (r2 * F2 > MG || smem_bytes(r2, F, C) > SMEM_LIMIT)) --r2;
  if (smem_bytes(r2, F, C) > SMEM_LIMIT) return 0;
  return r2 < T2 ? r2 : T2;
}

}  // namespace

extern "C" {

// y[B,T2,F2,C] (bf16) = relu(conv2(relu(conv1(x[B,T,F] f32)))), with
// w1 [3,3,C] f32, b1 [C] f32, w2 [9C,C] bf16 ((i,j)-major, C_in-minor), b2 [C].
int fused_subsample_fwd(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* y, int B, int T,
                        int F, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int T2 = out_len(out_len(T)), F2 = out_len(out_len(F));
  if (B < 1 || T2 < 1 || F2 < 1 || C < 16 || C % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int r2 = pick_r2(F, C, T2);
  if (r2 < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(r2, F, C);
  err = cudaFuncSetAttribute(fused_subsample_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T2 + r2 - 1) / r2), (unsigned)B);
  fused_subsample_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(y), T, F, C,
      r2);
  return (int)cudaGetLastError();
}

}  // extern "C"

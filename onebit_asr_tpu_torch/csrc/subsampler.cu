// Fused Conv2dSubsampling, forward and backward, for Hopper (sm_90a), plain C
// interface.
//
// Forward: replaces the Pallas TPU kernel onebit_asr_tpu/ops/subsampler.py:217
// (_fwd_kernel, :217-241; entry _fs_fwd :421, pallas_call :430):
//   conv1 3x3 stride 2 VALID (C_in = 1, in f32) -> ReLU -> cast to bf16 ->
//   conv2 3x3 stride 2 VALID as the im2col product [T2*F2, 9C] x [9C, C]
//   (bf16 operands, f32 sums) -> + b2 -> ReLU -> bf16 [B, T2, F2, C],
// with the conv1 activation kept on chip: it never reaches device memory.
//
// What bounds the forward: on the serving path of Conformer-M (B=8, 16 s:
// T=1598, F=80, C=256 -> T2=398, F2=19) conv2 is 2*8*398*19*256*2304 = 71.4
// GFLOP of bf16, 0.072 ms at 989 TFLOP/s, while the bytes it must move are
// ~36 MB (x 4.1 MB f32, y 31 MB bf16, w2 1.2 MB), 0.011 ms at 3.35 TB/s.
// conv1 is 1.15 GFLOP of f32 on the CUDA cores. So the bound is operations:
// the tensor cores' rate on conv2. The unfused path also writes and reads
// back the 127.5 MB conv1 activation, which this kernel keeps in shared
// memory.
//
// Forward design (a simple, correct first kernel; wgmma/TMA and pipelining
// later):
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
// Backward: replaces the Pallas TPU kernel onebit_asr_tpu/ops/subsampler.py:244
// (_bwd_kernel, :244-356; entry _fs_bwd :447, pallas_call :462). From x, the
// weights and the cotangent g [B, T2, F2, C] (bf16):
//   gm   = y_pre > 0 ? g : 0          y_pre = pat w2 + b2 (f32 sums), recomputed
//   dw2  = pat^T gm;  db2 = sum gm    (f32; dw2 is never rounded to bf16)
//   dpat = bf16(gm w2^T)              (f32 sums, rounded before the overlap-add)
//   dc1  = the 9 taps of dpat overlap-added in f32, taps in order, then zeroed
//          where c1_pre <= 0 (c1_pre recomputed in the plain version's order)
//   db1  = sum dc1;  dw1[i,j] = sum x_ij dc1;  dx = overlap-add of sum_c dc1 w1[i,j]
// in the order of operations and roundings of the plain version
// (ops/subsampler.py::fused_subsample_bwd_reference). The conv1 activation is
// recomputed on chip and never reaches device memory here either.
//
// What bounds the backward: at the train step's shape (B=16 per branch,
// T=1024, F=80, C=256 -> T1=511, F1=39, T2=255, F2=19) it needs three
// conv2-sized bf16 products (y_pre, dpat, dw2): 3 x 2*16*255*19*2304*256 =
// 274 GFLOP, 0.28 ms at 989 TFLOP/s; conv1's three f32 passes (recompute,
// dw1, dx) are 3 x 1.47 GFLOP, 0.066 ms at 67 TFLOP/s; the bytes it must
// move (x, g, dx, w2, dw2) are ~54 MB, 0.016 ms at 3.35 TB/s. Operations.
//
// Backward design (a simple, correct first kernel; wgmma/TMA and pipelining
// later), four kernels on the caller's stream:
//   1. mask pass: the forward kernel with another epilogue writes gm (bf16,
//      exact: g is bf16) into the workspace. The mask needs all C channels of
//      y_pre, so it exists before any channel slice of pass 2 runs;
//   2. conv1 pass: one CTA per (b, block of r2 <= 4 conv2 rows) holds the
//      block's gm rows in shared memory and walks the channels in slices of
//      64 (an f32 dc1 tile of all C channels would not fit: 359 KB at r2=4).
//      Per slice and tap, w2's 64 rows of the slice are staged in shared
//      memory and dpat = gm w2^T runs on mma.sync (A = gm rows, B = w2 rows,
//      both contiguous along k); each element is rounded to bf16 and added
//      into the f32 dc1 tile [2*r2+1, F1, 64]: within a tap every element is
//      written once, and barriers order the taps, so the sum runs in the
//      plain version's order. Then the mask on c1_pre, db1 and dw1 (4
//      threads per channel, combined in order), and sum_c dc1 w1 per pixel
//      and tap, gathered into the block's f32 dx window. It writes
//      per-block partials: the dx window [4*r2+3, F], dw1 [9, C], db1 [C] and
//      db2 [C] (the gm tile's column sums);
//   3. dw2 pass: dw2 = pat^T gm is a product whose K is every pixel of the
//      batch, so it is split: one CTA per (16 channels of every tap = 144
//      rows of dw2, 128 columns, one of <= 16 ranges of the (b, block) list)
//      keeps its [144, 128] f32 tile in registers over its range. Per block
//      it recomputes conv1 for its 16 channels (as the forward, bf16 after
//      the ReLU) and lays pat^T [144, pixels] and gm^T [128, pixels] out in
//      shared memory, so that both mma.sync operands are contiguous along k;
//   4. reduce: one thread per gradient element sums the partials in a fixed
//      order (block ascending, split ascending). No atomics: two launches on
//      the same inputs give the same bits.
// The workspace (fused_subsample_bwd_workspace) holds gm and the partials:
// 40 MB + 57 MB at the train step's shape, 16 splits of dw2.
//
// The entries launch on the given stream, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for shapes they do not take:
// C not a multiple of 16, tiles that do not fit shared memory, a workspace
// smaller than fused_subsample_bwd_workspace()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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

// backward
constexpr int CS = 64;                     // channels per slice of the conv1 pass
constexpr int CS_LD = CS + 1;              // f32 stride of a dc1 pixel
constexpr int NT_BWD = 2;                  // n8 tiles per warp of a slice's dpat
static_assert(WARPS_N * NT_BWD * 8 == CS, "one slice is the 4 warps' columns");
static_assert(THREADS == 4 * CS, "4 threads per channel in the dw1 sums");
constexpr int R2_BWD = 4;                  // conv2 rows per block, at most
constexpr int DW_CS = 16;                  // channels per slice of the dw2 pass
constexpr int DW_NCH = (THREADS / 32) * 16;  // dw2 columns per CTA: 2 n8 tiles a warp
constexpr int DW_MK = 96;                  // pixels per k chunk of the dw2 pass
constexpr int DW_LD = DW_MK + 8;           // bf16 row stride of pat^T, gm^T (20 mod 32 words)
static_assert(THREADS % DW_CS == 0, "a thread's conv1 channel is fixed");
constexpr int SPLITS = 16;                 // ranges of the (b, block) list for dw2
constexpr int REDUCE_THREADS = 256;

__host__ __device__ inline int out_len(int n) { return (n - 1) / 2; }

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

__host__ __device__ inline size_t c1_tile_bytes(int r2, int F1, int C) {
  return align16((size_t)(2 * r2 + 1) * F1 * (C + PIX_PAD) * 2);
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// conv1 -> ReLU -> conv2 -> + b2 for one block of r2 output rows. MASK = false:
// the forward, y = bf16(relu(.)). MASK = true: the backward's first pass,
// y = g where the f32 pre-activation is > 0, else 0 (g read at y's index).
template <bool MASK>
__global__ void __launch_bounds__(THREADS)
    fused_subsample_conv2_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w1,
                                 const float* __restrict__ b1,
                                 const bf16* __restrict__ w2,
                                 const float* __restrict__ b2,
                                 const bf16* __restrict__ g,
                                 bf16* __restrict__ y, int T, int F, int C, int r2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T1 = out_len(T), F1 = out_len(F);
  const int T2 = out_len(T1), F2 = out_len(F1);
  const int PIX = C + PIX_PAD;
  const int R1 = 2 * r2 + 1;
  bf16* c1 = reinterpret_cast<bf16*>(smem);
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
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  for (int m0 = 0; m0 < M; m0 += MG) {
    // per m16 tile of this warp: tile offset of the tap-(0,0) pixel of its
    // rows gq and gq+8 (padded rows read pixel 0 and are never stored)
    int off[MT_WARP][2];
    bool mt_on[MT_WARP];
#pragma unroll
    for (int q = 0; q < MT_WARP; ++q) {
      const int base = m0 + (wm + WARPS_M * q) * 16;
      mt_on[q] = base < M;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int row = base + gq + 8 * h;
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
            const int n = wn * (NT_WARP * 8) + j * 8 + gq;
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

      // ---- epilogue: + b2, then ReLU and bf16 (forward) or the mask on g
      // (backward); rows past this block's M skipped
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
            const int row = m0 + (wm + WARPS_M * q) * 16 + gq + 8 * h;
            if (row >= M) continue;
            const int tl = row / F2, f = row % F2;
            const size_t idx = (((size_t)b * T2 + t0 + tl) * F2 + f) * C + col;
            const float v0 = acc[q][j][2 * h] + bias.x;
            const float v1 = acc[q][j][2 * h + 1] + bias.y;
            __nv_bfloat162 out;
            if constexpr (MASK) {
              const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(g + idx);
              const bf16 zero = __float2bfloat16_rn(0.f);
              out.x = v0 > 0.f ? gv.x : zero;
              out.y = v1 > 0.f ? gv.y : zero;
            } else {
              out = __floats2bfloat162_rn(relu(v0), relu(v1));
            }
            *reinterpret_cast<__nv_bfloat162*>(y + idx) = out;
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

template <bool MASK>
int launch_conv2(const void* x, const void* w1, const void* b1, const void* w2,
                 const void* b2, const void* g, void* y, int B, int T, int F, int C,
                 cudaStream_t stream) {
  const int T2 = out_len(out_len(T));
  const int r2 = pick_r2(F, C, T2);
  if (r2 < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(r2, F, C);
  cudaError_t err = cudaFuncSetAttribute(fused_subsample_conv2_kernel<MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T2 + r2 - 1) / r2), (unsigned)B);
  fused_subsample_conv2_kernel<MASK><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(g), static_cast<bf16*>(y), T,
      F, C, r2);
  return (int)cudaGetLastError();
}

bool shapes_taken(int B, int T, int F, int C) {
  return B >= 1 && out_len(out_len(T)) >= 1 && out_len(out_len(F)) >= 1 && C >= 16 &&
         C % 16 == 0;
}

// ---------------------------------------------------------------------------
// backward

// The workspace: gm (bf16), then f32 partials.
struct Partials {
  bf16* gm;    // [B, T2, F2, C]
  float* dx;   // [B, nblk, 4*r2+3, F]: each block's input window
  float* dw1;  // [B, nblk, 9, C]
  float* db1;  // [B, nblk, C]
  float* db2;  // [B, nblk, C]
  float* dw2;  // [nsplit, 9C, C]
};

struct Plan {
  int r2, nblk, NB, per, nsplit;  // NB = B*nblk blocks; dw2 split in ranges of `per`
  size_t gm, dx, dw1, db1, db2, dw2, floats;  // offsets in f32 elements; total
};

// shared memory of the conv1 pass, in bytes from the start
struct Conv1Smem {
  size_t xs, dxw, gms, w2s, dc1, contrib, comb, w1s, total;
};

__host__ __device__ inline Conv1Smem conv1_smem(int r2, int F, int C) {
  const int F1 = out_len(F), F2 = out_len(F1), R1 = 2 * r2 + 1, XW = 4 * r2 + 3;
  Conv1Smem s;
  size_t o = 0;
  s.xs = o;      o += align16((size_t)XW * F * 4);
  s.dxw = o;     o += align16((size_t)XW * F * 4);
  s.gms = o;     o += align16((size_t)r2 * F2 * (C + 8) * 2);
  s.w2s = o;     o += align16((size_t)CS * (C + 8) * 2);
  s.dc1 = o;     o += align16((size_t)R1 * F1 * CS_LD * 4);
  s.contrib = o; o += align16((size_t)9 * R1 * F1 * 4);
  s.comb = o;    o += align16((size_t)4 * 10 * CS * 4);
  s.w1s = o;     o += align16((size_t)9 * CS * 4);
  s.total = o;
  return s;
}

struct Dw2Smem {
  size_t xs, c1s, patT, gmT, total;
};

__host__ __device__ inline Dw2Smem dw2_smem(int r2, int F) {
  const int F1 = out_len(F), R1 = 2 * r2 + 1, XW = 4 * r2 + 3;
  Dw2Smem s;
  size_t o = 0;
  s.xs = o;   o += align16((size_t)XW * F * 4);
  s.c1s = o;  o += align16((size_t)R1 * F1 * DW_CS * 2);
  s.patT = o; o += align16((size_t)9 * DW_CS * DW_LD * 2);
  s.gmT = o;  o += align16((size_t)DW_NCH * DW_LD * 2);
  s.total = o;
  return s;
}

bool plan_bwd(int B, int T, int F, int C, Plan* p) {
  if (!shapes_taken(B, T, F, C)) return false;
  const int T2 = out_len(out_len(T)), F2 = out_len(out_len(F));
  if (pick_r2(F, C, T2) < 1) return false;  // the mask pass
  int r2 = min(R2_BWD, T2);
  while (r2 > 1 && (conv1_smem(r2, F, C).total > SMEM_LIMIT ||
                    dw2_smem(r2, F).total > SMEM_LIMIT)) {
    --r2;
  }
  if (conv1_smem(r2, F, C).total > SMEM_LIMIT || dw2_smem(r2, F).total > SMEM_LIMIT) {
    return false;
  }
  p->r2 = r2;
  p->nblk = (T2 + r2 - 1) / r2;
  p->NB = B * p->nblk;
  const int splits = min(p->NB, SPLITS);
  p->per = (p->NB + splits - 1) / splits;
  p->nsplit = (p->NB + p->per - 1) / p->per;
  const size_t nb = (size_t)p->NB;
  size_t o = 0;
  auto take = [&o](size_t floats) {
    const size_t at = o;
    o += (floats + 3) & ~(size_t)3;  // 16-byte aligned regions
    return at;
  };
  p->gm = take(((size_t)B * T2 * F2 * C + 1) / 2);
  p->dx = take(nb * (4 * r2 + 3) * F);
  p->dw1 = take(nb * 9 * C);
  p->db1 = take(nb * C);
  p->db2 = take(nb * C);
  p->dw2 = take((size_t)p->nsplit * 9 * C * C);
  p->floats = o;
  return true;
}

// Pass 2: dpat -> dc1 -> the partials of dx, dw1, db1 (and db2), per block.
__global__ void __launch_bounds__(THREADS)
    fused_subsample_bwd_conv1_kernel(const float* __restrict__ x,
                                     const float* __restrict__ w1,
                                     const float* __restrict__ b1,
                                     const bf16* __restrict__ w2, Partials ws, int T, int F,
                                     int C, int r2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T1 = out_len(T), F1 = out_len(F), T2 = out_len(T1), F2 = out_len(F1);
  const int XW = 4 * r2 + 3, LD = C + 8, C8 = C / 8;
  const Conv1Smem L = conv1_smem(r2, F, C);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* dxw = reinterpret_cast<float*>(smem + L.dxw);
  bf16* gms = reinterpret_cast<bf16*>(smem + L.gms);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2s);
  float* dc1 = reinterpret_cast<float*>(smem + L.dc1);
  float* contrib = reinterpret_cast<float*>(smem + L.contrib);
  float* comb = reinterpret_cast<float*>(smem + L.comb);
  float* w1s = reinterpret_cast<float*>(smem + L.w1s);

  const int b = blockIdx.y, nblk = gridDim.x;
  const int t0 = blockIdx.x * r2, rows = min(r2, T2 - t0);
  const int M = rows * F2;        // gm rows of the block
  const int P = (2 * rows + 1) * F1;  // conv1 pixels it touches
  const size_t q = (size_t)b * nblk + blockIdx.x;
  const int tid = threadIdx.x;

  // the input window (rows past T are never read) and the block's gm rows
  const float* xb = x + ((size_t)b * T + 4 * t0) * F;
  const int XR = min(XW, T - 4 * t0);
  for (int i = tid; i < XW * F; i += THREADS) {
    xs[i] = i < XR * F ? xb[i] : 0.f;
    dxw[i] = 0.f;
  }
  const bf16* gmb = ws.gm + ((size_t)b * T2 + t0) * F2 * C;
  for (int i = tid; i < M * C8; i += THREADS) {
    const int m = i / C8, c8 = i - m * C8;
    *reinterpret_cast<uint4*>(gms + (size_t)m * LD + 8 * c8) =
        *reinterpret_cast<const uint4*>(gmb + (size_t)m * C + 8 * c8);
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {  // db2: the tile's column sums, rows in order
    float s = 0.f;
    for (int m = 0; m < M; ++m) s = __fadd_rn(s, __bfloat162float(gms[(size_t)m * LD + c]));
    ws.db2[q * C + c] = s;
  }

  const int lane = tid & 31, warp = tid >> 5, gq = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  for (int c0 = 0; c0 < C; c0 += CS) {
    const int cs = min(CS, C - c0);
    for (int i = tid; i < (2 * r2 + 1) * F1 * CS_LD; i += THREADS) dc1[i] = 0.f;
    for (int i = tid; i < 9 * CS; i += THREADS) {
      const int tap = i / CS, c = i - tap * CS;
      w1s[i] = c < cs ? w1[tap * C + c0 + c] : 0.f;
    }
    for (int tap = 0; tap < 9; ++tap) {
      __syncthreads();  // the tap before is done with w2s; dc1's zeros are visible
      const bf16* w2t = w2 + ((size_t)tap * C + c0) * C;
      for (int i = tid; i < cs * C8; i += THREADS) {
        const int n = i / C8, c8 = i - n * C8;
        *reinterpret_cast<uint4*>(w2s + (size_t)n * LD + 8 * c8) =
            *reinterpret_cast<const uint4*>(w2t + (size_t)n * C + 8 * c8);
      }
      __syncthreads();
      const int ti = tap / 3, tj = tap - 3 * ti;
      for (int m0 = 0; m0 < M; m0 += MG) {
        int ra[MT_WARP][2];  // gm tile offsets of rows gq and gq+8 (padded: row 0)
        bool mt_on[MT_WARP];
#pragma unroll
        for (int qq = 0; qq < MT_WARP; ++qq) {
          const int base = m0 + (wm + WARPS_M * qq) * 16;
          mt_on[qq] = base < M;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = base + gq + 8 * h;
            ra[qq][h] = (row < M ? row : 0) * LD;
          }
        }
        float acc[MT_WARP][NT_BWD][4];
#pragma unroll
        for (int qq = 0; qq < MT_WARP; ++qq)
#pragma unroll
          for (int j = 0; j < NT_BWD; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[qq][j][e] = 0.f;
        // dpat[m, c] = sum_n gm[m, n] w2[tap*C + c0 + c, n]: A = gm rows, B = w2 rows
        for (int k = 0; k < C; k += 16) {
          uint32_t bfr[NT_BWD][2];
#pragma unroll
          for (int j = 0; j < NT_BWD; ++j) {
            int n = wn * (NT_BWD * 8) + j * 8 + gq;
            if (n >= cs) n = 0;
            bfr[j][0] = ld_u32(w2s + (size_t)n * LD + k + 2 * t);
            bfr[j][1] = ld_u32(w2s + (size_t)n * LD + k + 2 * t + 8);
          }
#pragma unroll
          for (int qq = 0; qq < MT_WARP; ++qq) {
            if (!mt_on[qq]) continue;
            uint32_t a[4];
            a[0] = ld_u32(gms + ra[qq][0] + k + 2 * t);
            a[1] = ld_u32(gms + ra[qq][1] + k + 2 * t);
            a[2] = ld_u32(gms + ra[qq][0] + k + 2 * t + 8);
            a[3] = ld_u32(gms + ra[qq][1] + k + 2 * t + 8);
#pragma unroll
            for (int j = 0; j < NT_BWD; ++j) {
              if (wn * (NT_BWD * 8) + j * 8 < cs) mma_bf16(acc[qq][j], a, bfr[j]);
            }
          }
        }
        // dpat in bf16, added into dc1 at conv1 pixel (2 tl + ti, 2 f + tj):
        // one element per thread within a tap
#pragma unroll
        for (int qq = 0; qq < MT_WARP; ++qq) {
          if (!mt_on[qq]) continue;
#pragma unroll
          for (int j = 0; j < NT_BWD; ++j) {
            const int col = wn * (NT_BWD * 8) + j * 8 + 2 * t;
            if (col >= cs) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = m0 + (wm + WARPS_M * qq) * 16 + gq + 8 * h;
              if (row >= M) continue;
              const int tl = row / F2, f = row - tl * F2;
              float* d = dc1 + ((size_t)(2 * tl + ti) * F1 + 2 * f + tj) * CS_LD + col;
              d[0] = __fadd_rn(d[0], round_bf16(acc[qq][j][2 * h]));
              d[1] = __fadd_rn(d[1], round_bf16(acc[qq][j][2 * h + 1]));
            }
          }
        }
      }
    }
    __syncthreads();

    // the mask: c1_pre recomputed as the plain version sums it
    for (int i = tid; i < P * cs; i += THREADS) {
      const int pix = i / cs, c = i - pix * cs;
      const int r = pix / F1, f1 = pix - r * F1;
      const float* xr = xs + 2 * r * F + 2 * f1;
      float a = b1[c0 + c];
#pragma unroll
      for (int ti = 0; ti < 3; ++ti)
#pragma unroll
        for (int tj = 0; tj < 3; ++tj)
          a = __fadd_rn(a, __fmul_rn(xr[ti * F + tj], w1s[(ti * 3 + tj) * CS + c]));
      if (!(a > 0.f)) dc1[(size_t)pix * CS_LD + c] = 0.f;
    }
    __syncthreads();

    // db1 and dw1: 4 threads per channel over every 4th pixel, then combined
    // in order; per pixel and tap, sum_c dc1 w1 (channels in order)
    {
      const int c = tid % CS, part = tid / CS;
      if (c < cs) {
        float s[10];
#pragma unroll
        for (int k = 0; k < 10; ++k) s[k] = 0.f;
        for (int p = part; p < P; p += 4) {
          const float v = dc1[(size_t)p * CS_LD + c];
          const int r = p / F1, f1 = p - r * F1;
          const float* xr = xs + 2 * r * F + 2 * f1;
          s[0] = __fadd_rn(s[0], v);
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            s[1 + tap] = __fadd_rn(s[1 + tap], __fmul_rn(xr[(tap / 3) * F + tap % 3], v));
          }
        }
#pragma unroll
        for (int k = 0; k < 10; ++k) comb[(part * 10 + k) * CS + c] = s[k];
      }
    }
    for (int p = tid; p < P; p += THREADS) {
      float s[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) s[tap] = 0.f;
      for (int c = 0; c < cs; ++c) {
        const float v = dc1[(size_t)p * CS_LD + c];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          s[tap] = __fadd_rn(s[tap], __fmul_rn(v, w1s[tap * CS + c]));
        }
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) contrib[tap * P + p] = s[tap];
    }
    __syncthreads();
    for (int i = tid; i < 10 * cs; i += THREADS) {
      const int k = i / cs, c = i - k * cs;
      float s = comb[k * CS + c];
      for (int part = 1; part < 4; ++part) s = __fadd_rn(s, comb[(part * 10 + k) * CS + c]);
      if (k == 0) {
        ws.db1[q * C + c0 + c] = s;
      } else {
        ws.dw1[(q * 9 + k - 1) * C + c0 + c] = s;
      }
    }
    // the dx window: input (row, f) gathers tap (ti, tj) of pixel
    // ((row - ti) / 2, (f - tj) / 2), taps in order
    for (int i = tid; i < (4 * rows + 3) * F; i += THREADS) {
      const int row = i / F, f = i - row * F;
      float s = dxw[i];
#pragma unroll
      for (int ti = 0; ti < 3; ++ti) {
        const int rr = row - ti;
        if (rr < 0 || (rr & 1) || rr / 2 >= 2 * rows + 1) continue;
#pragma unroll
        for (int tj = 0; tj < 3; ++tj) {
          const int ff = f - tj;
          if (ff < 0 || (ff & 1) || ff / 2 >= F1) continue;
          s = __fadd_rn(s, contrib[(ti * 3 + tj) * P + (rr / 2) * F1 + ff / 2]);
        }
      }
      dxw[i] = s;
    }
    __syncthreads();
  }
  for (int i = tid; i < XW * F; i += THREADS) ws.dx[q * XW * F + i] = dxw[i];
}

// Pass 3: dw2 = pat^T gm over the blocks [q0, q0 + per) of the (b, block)
// list, for dw2 rows (tap, c0 + c) (c < 16) and columns [n0, n0 + 128).
__global__ void __launch_bounds__(THREADS)
    fused_subsample_bwd_dw2_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w1,
                                   const float* __restrict__ b1, Partials ws, int T, int F,
                                   int C, int r2, int nblk, int NB, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T1 = out_len(T), F1 = out_len(F), T2 = out_len(T1), F2 = out_len(F1);
  const Dw2Smem L = dw2_smem(r2, F);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  bf16* c1s = reinterpret_cast<bf16*>(smem + L.c1s);
  bf16* patT = reinterpret_cast<bf16*>(smem + L.patT);
  bf16* gmT = reinterpret_cast<bf16*>(smem + L.gmT);

  const int c0 = blockIdx.x * DW_CS, n0 = blockIdx.y * DW_NCH, split = blockIdx.z;
  const int q0 = split * per, q1 = min(NB, q0 + per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, t = lane & 3;
  const int cc = tid % DW_CS;  // the channel of every conv1 element this thread computes
  float w1r[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) w1r[tap] = w1[tap * C + c0 + cc];
  const float b1r = b1[c0 + cc];
  const bf16 zero = __float2bfloat16_rn(0.f);

  float acc[9][2][4];  // m16 tile = tap (rows: its 16 channels), 2 n8 tiles
#pragma unroll
  for (int mt = 0; mt < 9; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int q = q0; q < q1; ++q) {
    const int b = q / nblk, blk = q - b * nblk;
    const int t0 = blk * r2, rows = min(r2, T2 - t0);
    const int M = rows * F2, P = (2 * rows + 1) * F1;
    __syncthreads();  // the block before is done with xs and c1s
    const float* xb = x + ((size_t)b * T + 4 * t0) * F;
    for (int i = tid; i < (4 * rows + 3) * F; i += THREADS) xs[i] = xb[i];
    __syncthreads();
    // conv1 -> ReLU -> bf16 for channels [c0, c0 + 16), as the forward
    for (int i = tid; i < P * DW_CS; i += THREADS) {
      const int pix = i / DW_CS, r = pix / F1, f1 = pix - r * F1;
      const float* xr = xs + 2 * r * F + 2 * f1;
      float a = b1r;
#pragma unroll
      for (int ti = 0; ti < 3; ++ti)
#pragma unroll
        for (int tj = 0; tj < 3; ++tj) a = __fadd_rn(a, __fmul_rn(xr[ti * F + tj], w1r[ti * 3 + tj]));
      c1s[i] = __float2bfloat16_rn(relu(a));
    }
    __syncthreads();
    const bf16* gmb = ws.gm + ((size_t)b * T2 + t0) * F2 * C;
    for (int k0 = 0; k0 < M; k0 += DW_MK) {
      const int mk = min(DW_MK, M - k0), kp = (mk + 15) & ~15;
      // pat^T [(tap, c)][k] and gm^T [n][k], zero past the block's pixels
      for (int i = tid; i < 9 * DW_CS * kp; i += THREADS) {
        const int row = i / kp, k = i - row * kp;
        bf16 v = zero;
        if (k < mk) {
          const int m = k0 + k, tl = m / F2, f = m - tl * F2;
          const int tap = row / DW_CS, c = row - tap * DW_CS;
          v = c1s[((2 * tl + tap / 3) * F1 + 2 * f + tap % 3) * DW_CS + c];
        }
        patT[row * DW_LD + k] = v;
      }
      for (int i = tid; i < kp * (DW_NCH / 8); i += THREADS) {
        const int k = i / (DW_NCH / 8), n8 = i - k * (DW_NCH / 8), n = n0 + 8 * n8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < mk && n < C) v = *reinterpret_cast<const uint4*>(gmb + (size_t)(k0 + k) * C + n);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int u = 0; u < 8; ++u) gmT[(8 * n8 + u) * DW_LD + k] = e[u];
      }
      __syncthreads();
      for (int ks = 0; ks < kp; ks += 16) {
        uint32_t bfr[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bf16* pb = gmT + (warp * 16 + j * 8 + gq) * DW_LD + ks + 2 * t;
          bfr[j][0] = ld_u32(pb);
          bfr[j][1] = ld_u32(pb + 8);
        }
#pragma unroll
        for (int mt = 0; mt < 9; ++mt) {
          const bf16* pa = patT + (mt * 16 + gq) * DW_LD + ks + 2 * t;
          const uint32_t a[4] = {ld_u32(pa), ld_u32(pa + 8 * DW_LD), ld_u32(pa + 8),
                                 ld_u32(pa + 8 * DW_LD + 8)};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (n0 + warp * 16 + j * 8 < C) mma_bf16(acc[mt][j], a, bfr[j]);
          }
        }
      }
      __syncthreads();
    }
  }
  float* out = ws.dw2 + (size_t)split * 9 * C * C;
#pragma unroll
  for (int mt = 0; mt < 9; ++mt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + warp * 16 + j * 8 + 2 * t;
      if (col >= C) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = (size_t)mt * C + c0 + gq + 8 * h;
        *reinterpret_cast<float2*>(out + row * C + col) =
            make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
    }
  }
}

// Pass 4: every gradient element sums its partials in a fixed order: dx over
// the (at most two) blocks whose window holds its row, block ascending; dw1,
// db1 and db2 over the blocks; dw2 over the splits.
__global__ void __launch_bounds__(REDUCE_THREADS)
    fused_subsample_bwd_reduce(Partials ws, float* __restrict__ dx, float* __restrict__ dw1,
                               float* __restrict__ db1, float* __restrict__ dw2,
                               float* __restrict__ db2, int B, int T, int F, int C, int r2,
                               int nblk, int nsplit) {
  const size_t NB = (size_t)B * nblk, XW = 4 * r2 + 3;
  size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  const size_t n_dx = (size_t)B * T * F;
  if (i < n_dx) {
    const int f = (int)(i % F), row = (int)((i / F) % T), b = (int)(i / ((size_t)T * F));
    float s = 0.f;
    const int hi = row / (4 * r2);
    for (int k = hi - 1; k <= hi; ++k) {
      const int lr = row - 4 * r2 * k;
      if (k < 0 || k >= nblk || lr >= (int)XW) continue;
      s = __fadd_rn(s, ws.dx[(((size_t)b * nblk + k) * XW + lr) * F + f]);
    }
    dx[i] = s;
    return;
  }
  i -= n_dx;
  if (i < (size_t)9 * C) {
    float s = 0.f;
    for (size_t q = 0; q < NB; ++q) s = __fadd_rn(s, ws.dw1[q * 9 * C + i]);
    dw1[i] = s;
    return;
  }
  i -= (size_t)9 * C;
  if (i < (size_t)C) {
    float s = 0.f, s2 = 0.f;
    for (size_t q = 0; q < NB; ++q) {
      s = __fadd_rn(s, ws.db1[q * C + i]);
      s2 = __fadd_rn(s2, ws.db2[q * C + i]);
    }
    db1[i] = s;
    db2[i] = s2;
    return;
  }
  i -= (size_t)C;
  if (i < (size_t)9 * C * C) {
    float s = 0.f;
    for (int p = 0; p < nsplit; ++p) s = __fadd_rn(s, ws.dw2[(size_t)p * 9 * C * C + i]);
    dw2[i] = s;
  }
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
  if (!shapes_taken(B, T, F, C)) return (int)cudaErrorInvalidValue;
  return launch_conv2<false>(x, w1, b1, w2, b2, nullptr, y, B, T, F, C,
                             (cudaStream_t)stream);
}

// f32 elements of fused_subsample_bwd's workspace, or -1 for shapes it does
// not take.
long long fused_subsample_bwd_workspace(int B, int T, int F, int C) {
  Plan p;
  return plan_bwd(B, T, F, C, &p) ? (long long)p.floats : -1;
}

// The backward's first pass alone: gm [B,T2,F2,C] bf16 = g where y_pre > 0.
int fused_subsample_bwd_mask(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* g, void* gm, int B, int T, int F,
                             int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shapes_taken(B, T, F, C)) return (int)cudaErrorInvalidValue;
  return launch_conv2<true>(x, w1, b1, w2, b2, g, gm, B, T, F, C, (cudaStream_t)stream);
}

// Gradients of fused_subsample_fwd for the cotangent g [B,T2,F2,C] (bf16):
// dx [B,T,F], dw1 [3,3,C], db1 [C], dw2 [9C,C], db2 [C], all f32; operands as
// the forward's (contiguous, 16-byte aligned). `workspace` holds
// `workspace_floats` f32 elements, at least fused_subsample_bwd_workspace().
int fused_subsample_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* g, void* dx, void* dw1, void* db1,
                        void* dw2, void* db2, void* workspace, long long workspace_floats,
                        int B, int T, int F, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  if (!plan_bwd(B, T, F, C, &p) || workspace_floats < 0 ||
      (size_t)workspace_floats < p.floats) {
    return (int)cudaErrorInvalidValue;
  }
  float* base = static_cast<float*>(workspace);
  const Partials ws = {reinterpret_cast<bf16*>(base + p.gm), base + p.dx, base + p.dw1,
                       base + p.db1, base + p.db2, base + p.dw2};
  const cudaStream_t s = (cudaStream_t)stream;
  int rc = launch_conv2<true>(x, w1, b1, w2, b2, g, ws.gm, B, T, F, C, s);
  if (rc != 0) return rc;

  const size_t smem1 = conv1_smem(p.r2, F, C).total;
  err = cudaFuncSetAttribute(fused_subsample_bwd_conv1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  fused_subsample_bwd_conv1_kernel<<<dim3((unsigned)p.nblk, (unsigned)B), THREADS, smem1, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), ws, T, F, C, p.r2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem3 = dw2_smem(p.r2, F).total;
  err = cudaFuncSetAttribute(fused_subsample_bwd_dw2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid3((unsigned)(C / DW_CS), (unsigned)((C + DW_NCH - 1) / DW_NCH),
                   (unsigned)p.nsplit);
  fused_subsample_bwd_dw2_kernel<<<grid3, THREADS, smem3, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), ws, T, F, C, p.r2, p.nblk, p.NB, p.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t total = (size_t)B * T * F + (size_t)10 * C + (size_t)9 * C * C;
  fused_subsample_bwd_reduce<<<(unsigned)((total + REDUCE_THREADS - 1) / REDUCE_THREADS),
                               REDUCE_THREADS, 0, s>>>(
      ws, static_cast<float*>(dx), static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dw2), static_cast<float*>(db2), B, T, F, C, p.r2, p.nblk,
      p.nsplit);
  return (int)cudaGetLastError();
}

}  // extern "C"

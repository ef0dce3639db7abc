// Fused Conv2dSubsampling, forward and backward, for Hopper (sm_90a), plain C
// interface.
//
// Forward: replaces the Pallas TPU kernel onebit_asr_tpu/ops/subsampler.py:217
// (_fwd_kernel, :217-241; entry _fs_fwd :421, pallas_call :430):
//   conv1 3x3 stride 2 VALID (C_in = 1, in f32) -> ReLU -> cast to bf16 ->
//   conv2 3x3 stride 2 VALID as the im2col product [T2*F2, 9C] x [9C, C]
//   (bf16 operands, f32 sums) -> + b2 -> ReLU -> bf16 [B, T2, F2, C],
// with the conv1 activation kept on chip: it never reaches device memory.
// Backward: replaces onebit_asr_tpu/ops/subsampler.py:244 (_bwd_kernel,
// :244-356; entry _fs_bwd :447, pallas_call :462). From x, the weights and
// the cotangent g [B, T2, F2, C] (bf16):
//   gm   = y_pre > 0 ? g : 0          y_pre = pat w2 + b2 (f32 sums), recomputed
//   dw2  = pat^T gm;  db2 = sum gm    (f32; dw2 is never rounded to bf16)
//   dpat = bf16(gm w2^T)              (f32 sums, rounded before the overlap-add)
//   dc1  = the 9 taps of dpat overlap-added in f32, taps in order, then zeroed
//          where c1_pre <= 0 (c1_pre recomputed in the plain version's order)
//   db1  = sum dc1;  dw1[i,j] = sum x_ij dc1;  dx = overlap-add of sum_c dc1 w1[i,j]
// as ops/subsampler.py::fused_subsample_bwd_reference states them. conv1 is
// always summed as the plain version sums it (b1, then taps (i, j) in order,
// __fmul_rn/__fadd_rn): its bf16 rounding feeds everything after it. Every
// other f32 sum runs in a fixed order of its own, with no atomics, so two
// launches give the same bits.
//
// What bounds each pass (H100 SXM: 989 TFLOP/s bf16, 67 TFLOP/s f32, 3.35
// TB/s), at the two shapes of Conformer-M (C=256, F=80 -> F1=39, F2=19):
//   - forward, serving (B=8, 16 s: T=1598 -> T2=398): conv2 is 71.4 GFLOP of
//     bf16, 0.072 ms; the bytes (x 4.1 MB, y 31 MB, w2 1.2 MB) 0.011 ms; conv1
//     1.15 GFLOP of f32 on the CUDA cores (about 0.08 ms of the SMs'
//     instruction slots: each product and sum is its own instruction). Operations;
//   - backward, train step (B=16, T=1024 -> T2=255): three conv2-sized bf16
//     products (y_pre, dpat, dw2), 274 GFLOP, 0.28 ms; conv1's f32 work
//     (recompute, mask, dw1, dx) 4.4 GFLOP; ~54 MB, 0.016 ms. Operations.
// Besides: every CTA that computes conv2 or dpat needs all of w2 (1.18 MB at
// C=256) from L2, so w2's L2 bytes per launch are CTAs x 1.18 MB, at an L2
// rate of ~5.4 TB/s measured (scripts/subsampler_probe.py: 0.14 ms of the
// serving forward are its w2 loads).
//
// Design. Every product runs on mma.sync m16n8k16 (bf16 -> f32) with both
// operands read by ldmatrix from shared memory: no scalar fragment loads,
// no element-wise transposes, no division in an inner loop. (wgmma would
// take A from registers gathered by the same ldmatrix, and B by descriptor
// from a swizzled stage; not tried: the probe puts the mma at 0.22 of the
// serving forward's 0.51 ms, and the rest is loads and the CUDA cores.)
// Operands that stream (w2 in the forward and the conv1 pass, gm in the dw2
// pass) come through a ring of cp.async stages several steps ahead, stored
// in the layout their ldmatrix wants. Tiles have a pixel stride that is an
// odd multiple of 16 bytes, and the conv1 tile keeps the even conv1 columns
// of a row before the odd ones, so the stride-2 pixels a warp gathers are
// adjacent: every ldmatrix phase hits 8 distinct bank groups. Each kernel is
// warp-specialised: mma warps sync among themselves on a named barrier per
// step, and CUDA-core warps (conv1, or the backward's mask and sums) work on
// the next (or previous) slice or block in a second tile at the same time,
// with one block-wide barrier per slice or block. (Running the conv1 work
// between the mma steps of the same warps, or at the slice boundary, left
// the two in series: the probe's knock-outs added up.)
//
//   1. forward and the backward's mask pass (fused_subsample_conv2_kernel):
//      512 threads per (utterance, block of r2 output rows, 256 output
//      channels), r2 * F2 <= 96; 12 mma warps (3 along M x 4 along N, 32 x
//      64 each) and 4 conv1 warps. K is walked in slices of 32 channels: the
//      conv1 warps compute slice s + 1 (R1 = 2*r2+1 rows x F1 x 40 bf16, 34 KB
//      at r2=5) while the mma warps run slice s's 9 taps, a 32-row x 256 w2
//      stage per tap through an 8-slot ring. The k order (slice, tap,
//      channel) is a permutation of the im2col order, the same for every
//      tiling: any r2 gives the same bits. r2 comes from a wave model (CTAs
//      over 132 SMs, one CTA an SM, times m16 tiles + 2): r2 = 5 at both
//      shapes, 640 CTAs at serving and 816 at the train step.
//   2. conv1 pass (fused_subsample_bwd_conv1_kernel): 512 threads per
//      (utterance, block of r2 <= 128/F2 conv2 rows, as large as fits: 6 at
//      C=256, 688 CTAs at the train step), holding the block's gm rows (the
//      A operand, loaded once). Per slice of 16 channels, 8 mma warps (4
//      along M x 2 along N; setmaxnreg gives them 168 registers and the
//      others 88) compute dpat for the slice's 9 taps, [M, 144] = gm
//      w2_slice^T with K = C, from 32-column w2 stages (144 rows x 64 bytes,
//      chunks swizzled) through a 6-slot ring, then round the taps to bf16
//      and add them into one f32 dc1 tile in four rounds ({0, 1, 3, 4}, {2,
//      5, 7}, {6}, {8}: taps meet at an element only with equal parities, so
//      every element gets its taps in order). Meanwhile 8 CUDA-core warps
//      take the other dc1 tile (slice s - 1): a 16-lane group per pixel and
//      a lane per channel recomputes c1_pre, masks, and sums db1 and dw1; a
//      thread per pixel sums dc1 w1 over the slice's channels for its 9 taps
//      into a [9, P] buffer kept over the slices (the dx sum spread over
//      slices, combined in slice order); then it clears the tile. At the end
//      the block's dx window gathers those taps in order. Per-block partials
//      of dx, dw1, db1 and db2 (the gm tile's column sums) go to the
//      workspace.
//   3. dw2 pass (fused_subsample_bwd_dw2_kernel): dw2 = pat^T gm has every
//      pixel of the batch as K. 512 threads per (16 channels of every tap =
//      144 dw2 rows, 256 columns, one of 8 splits of the list of 16-row
//      blocks): 128 CTAs at the train step. 12 mma warps (3 taps x 64
//      columns each) keep the [144, 256] f32 tile in registers; 4 conv1
//      warps compute block q + 1's conv1 for the 16 channels (each channel's
//      conv1 once per launch at C <= 256) while the mma warps run block q.
//      A = pat^T is ldmatrix.trans of the conv1 tile ([pixel][channel],
//      gathered per lane), B = gm is ldmatrix.trans of a [16 pixels, 256]
//      stage from a 10-slot ring.
//      16-row blocks give 16*19 = 304 pixels, 19 whole k16 steps at F2=19.
//      gm is read once per channel slice (16 times at C=256), from L2;
//   4. reduce: dx and dw2 a thread per element (blocks, splits ascending);
//      dw1, db1 and db2 a warp per element (lane l sums blocks l, l + 32, ...
//      in order, then a fixed butterfly).
// w2 from L2 per launch, C=256 (CTAs x 1.18 MB): forward at serving 944 MB
// (800 CTAs) -> 755 MB (640); at the train step, and its mask pass, 1.21 GB
// (1,024) -> 963 MB (816); conv1 pass 1.21 GB (1,024 CTAs) -> 811 MB (688).
// The dw2 pass reads no w2. The workspace (fused_subsample_bwd_workspace)
// holds gm and the partials: 39.7 MB + 32.6 MB at the train step's shape
// (97 MB before).
// Shapes: C a multiple of 16; F2 <= 96 (F <= 391) and tiles that fit 227 KB
// of shared memory (C=512 takes r2=4 in the conv1 pass).
//
// The entries launch on the given stream, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for shapes they do not take:
// C not a multiple of 16, F2 > 96, tiles that do not fit shared memory, a
// workspace smaller than fused_subsample_bwd_workspace()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 512;               // 16 warps in every kernel but the reduce
constexpr int SMEM_LIMIT = 232448;         // 227 KB per block on sm_90
constexpr int PLAN_SMS = 132;              // the H100 SXM's SMs, for the plan's wave model
constexpr int BAR_MMA = 1;                 // named barriers: the mma warps,
constexpr int BAR_CC = 2;                  // the CUDA-core warps (0 is __syncthreads)

// forward and mask pass: warps 0-11 run the mma (3 along M x 4 along N, 32 x
// 64 each), warps 12-15 compute the next slice's conv1
constexpr int FW_MMA = 384;                // mma threads
constexpr int FW_CS = 32;                  // conv1 channels per slice
constexpr int FW_LD = FW_CS + 8;           // bf16 per conv1 tile pixel (80 B)
constexpr int FW_NC = 256;                 // output channels per CTA
constexpr int FW_LDB = FW_NC + 8;          // bf16 per w2 stage row (528 B)
constexpr int FW_MAXM = 96;                // output pixels per CTA
constexpr int FW_SLOTS = 8;                // w2 ring: one (slice, tap) of <= 32 rows a slot
constexpr int FW_AHEAD = FW_SLOTS - 1;
constexpr int FW_STAGE = FW_CS * FW_LDB * 2;  // bytes
constexpr int FW_OVH = 2;                  // a CTA's cost besides its m16 tiles (wave model)

// conv1 pass: warps 0-7 run the mma (4 along M x 2 along N), warps 8-15 the
// CUDA-core work of the slice before
constexpr int BC_MMA = 256;                // mma threads
constexpr int BC_CC = THREADS - BC_MMA;    // CUDA-core threads
constexpr int BC_CS = 16;                  // channels per slice
constexpr int BC_LDC = BC_CS + 1;          // f32 per dc1 pixel
constexpr int BC_NT = 9 * BC_CS / 8;       // n8 tiles of a slice's dpat [M, 144]: 18
constexpr int BC_JT = BC_NT / 2;           // per warp: 9
constexpr int BC_KS = 32;                  // K (gm channels) per w2 stage
constexpr int BC_STAGE = 9 * BC_CS * BC_KS * 2;  // bytes: 144 w2 rows x 32 bf16
constexpr int BC_SLOTS = 6;
constexpr int BC_AHEAD = BC_SLOTS - 1;
constexpr int BC_MAXM = 128;               // gm rows per block: 4 warps x 2 m16 tiles
constexpr int BC_NGR = BC_CC / BC_CS;      // pixel groups of 16 lanes in the mask phase

// dw2 pass: warps 0-11 run the mma (3 taps x 64 columns each), warps 12-15
// compute the next block's conv1
constexpr int DW_MMA = 384;
constexpr int DW_CS = 16;                  // channels per CTA (one m16 tile per tap)
constexpr int DW_LD = DW_CS + 8;           // bf16 per conv1 tile pixel (48 B)
constexpr int DW_NC = 256;                 // dw2 columns per CTA: 4 warps x 64
constexpr int DW_LDB = DW_NC + 8;          // bf16 per gm stage row (528 B)
constexpr int DW_SLOTS = 10;
constexpr int DW_AHEAD = DW_SLOTS - 1;
constexpr int DW_STAGE = 16 * DW_LDB * 2;  // bytes
constexpr int DW_RD_MAX = 16;              // conv2 rows per dw2 block

constexpr int REDUCE_THREADS = 256;

__host__ __device__ inline int out_len(int n) { return (n - 1) / 2; }

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// The conv1 tile keeps, per conv1 row, the F1e = ceil(F1/2) even columns and
// then the odd ones: conv1 column f1 sits at slot slot_of(f1).
__host__ __device__ inline int slot_of(int f1, int F1e) {
  return (f1 & 1) ? F1e + (f1 >> 1) : (f1 >> 1);
}

// Slot offset of tap (i, j) from the slot of conv2 pixel (t, f)'s tap (0, 0):
// conv1 (2t + i, 2f + j) is even slot f + j/2 or odd slot f.
__host__ __device__ inline int tap_slot(int tap, int F1, int F1e) {
  const int i = tap / 3, j = tap - 3 * i;
  return i * F1 + (j == 0 ? 0 : j == 1 ? F1e : 1);
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// p / n for 0 <= p < 2^20, 1 <= n <= 1024, without an integer division:
// (p + 0.5) / n is at least 0.5 / n away from an integer, far more than the
// float rounding.
__device__ __forceinline__ int div_small(int p, float inv_n) {
  return __float2int_rz(((float)p + 0.5f) * inv_n);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
// Registers per thread of this warpgroup (sm_90a): the mma warpgroups take
// what the CUDA-core warpgroups give back.
template <int N>
__device__ __forceinline__ void regs_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N)); }
template <int N>
__device__ __forceinline__ void regs_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N)); }
// The whole block's barrier, reached from the branches of both warp roles.
__device__ __forceinline__ void block_sync() { asm volatile("bar.sync 0;\n" ::: "memory"); }

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Registers only: not volatile, so the compiler may schedule it freely.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// b1 + the 9 taps (i, j) of w1 in order, each product and sum rounded
// separately: conv1 as the plain version sums it.
__device__ __forceinline__ float conv1_sum(const float* xr, int F, const float (&w)[9],
                                           float bias) {
  float acc = bias;
#pragma unroll
  for (int k = 0; k < 9; ++k) acc = __fadd_rn(acc, __fmul_rn(xr[(k / 3) * F + k % 3], w[k]));
  return acc;
}

// conv1 -> ReLU -> bf16 of the local conv1 rows [0, R1) (row r reads window
// rows 2r..2r+2 of xs, F floats each) for channels [c0, c0 + cs), into
// tile[(r * F1 + slot_of(f1)) * ld + c - c0], by threads t < nt of a group
// of whole warps: each takes one channel pair and every lanes-th pixel, two
// pixels at a time (four independent sums). No barrier inside.
__device__ void conv1_tile(const float* xs, int F, int F1, int R1,
                           const float* __restrict__ w1, const float* __restrict__ b1, int C,
                           int c0, int cs, bf16* tile, int ld, int t, int nt) {
  const int pairs = cs >> 1;
  const int lanes = nt / pairs;
  const int cp = t % pairs, lane = t / pairs;
  const int F1e = (F1 + 1) >> 1, P = R1 * F1;
  const float inv = 1.f / (float)F1;
  const int c = c0 + 2 * cp;
  float wa[9], wb[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const float2 w = *reinterpret_cast<const float2*>(w1 + tap * C + c);
    wa[tap] = w.x;
    wb[tap] = w.y;
  }
  const float2 bias = *reinterpret_cast<const float2*>(b1 + c);
  for (int base = 0; base < P; base += 2 * lanes) {
    const int p = min(base + lane, P - 1), p2 = min(base + lane + lanes, P - 1);
    const int r = div_small(p, inv), f1 = p - r * F1;
    const int r2 = div_small(p2, inv), f2 = p2 - r2 * F1;
    const float* xa = xs + 2 * r * F + 2 * f1;
    const float* xb = xs + 2 * r2 * F + 2 * f2;
    const float a0 = conv1_sum(xa, F, wa, bias.x), a1 = conv1_sum(xa, F, wb, bias.y);
    const float b0 = conv1_sum(xb, F, wa, bias.x), b1v = conv1_sum(xb, F, wb, bias.y);
    // a repeat of the last pixel past P writes the same values again
    *reinterpret_cast<__nv_bfloat162*>(tile + (size_t)(r * F1 + slot_of(f1, F1e)) * ld + 2 * cp) =
        __floats2bfloat162_rn(relu(a0), relu(a1));
    *reinterpret_cast<__nv_bfloat162*>(tile + (size_t)(r2 * F1 + slot_of(f2, F1e)) * ld +
                                       2 * cp) = __floats2bfloat162_rn(relu(b0), relu(b1v));
  }
}

// ---------------------------------------------------------------------------
// forward and mask pass

struct FwdSmem {
  size_t c1, c1tile, ring, xs, total;  // c1: two slice tiles of c1tile bytes
};

__host__ __device__ inline FwdSmem fwd_smem(int r2, int F) {
  const int F1 = out_len(F);
  FwdSmem s;
  s.c1tile = align16((size_t)(2 * r2 + 1) * F1 * FW_LD * 2);
  s.c1 = 0;
  s.ring = 2 * s.c1tile;
  s.xs = s.ring + (size_t)FW_SLOTS * FW_STAGE;
  s.total = s.xs + align16((size_t)(4 * r2 + 3) * F * 4);
  return s;
}

// conv1 -> ReLU -> conv2 -> + b2 for one block of r2 output rows and up to
// 256 output channels. MASK = false: the forward, y = bf16(relu(.)).
// MASK = true: the backward's first pass, y = g where the f32 pre-activation
// is > 0, else 0 (g read at y's index).
template <bool MASK>
__global__ void __launch_bounds__(THREADS, 1)
    fused_subsample_conv2_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w1,
                                 const float* __restrict__ b1,
                                 const bf16* __restrict__ w2,
                                 const float* __restrict__ b2,
                                 const bf16* __restrict__ g,
                                 bf16* __restrict__ y, int T, int F, int C, int r2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T1 = out_len(T), F1 = out_len(F);
  const int T2 = out_len(T1), F2 = out_len(F1), F1e = (F1 + 1) >> 1;
  const FwdSmem L = fwd_smem(r2, F);
  unsigned char* ring = smem + L.ring;
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  auto c1buf = [&](int s) { return reinterpret_cast<bf16*>(smem + L.c1 + (s & 1) * L.c1tile); };

  const int b = blockIdx.z, n0 = blockIdx.y * FW_NC, t0 = blockIdx.x * r2;
  const int rows = min(r2, T2 - t0), M = rows * F2, R1 = 2 * rows + 1;
  const int NC = min(FW_NC, C - n0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool mma_warp = tid < FW_MMA;
  // mma warp w runs on scheduler w % 4 = wn: each scheduler gets every wm
  const int wm = warp >> 2, wn = warp & 3;
  const int nsl = (C + FW_CS - 1) / FW_CS;
  const int G = 9 * nsl;  // stages: (slice, tap)

  // w2 rows (tap, c0 + c), c < cs, columns [n0, n0 + NC) of stage gs =
  // (slice gs / 9, tap gs % 9) -> ring slot gs % FW_SLOTS, row c; by the
  // mma threads
  auto request = [&](int gs) {
    if (gs < G) {
      const int s = gs / 9, tap = gs - 9 * s;
      const int cs = min(FW_CS, C - s * FW_CS);
      const bf16* src = w2 + ((size_t)tap * C + s * FW_CS) * C + n0;
      unsigned char* dst = ring + (gs % FW_SLOTS) * FW_STAGE;
      const int n8 = NC >> 3;
      for (int i = tid; i < cs * n8; i += FW_MMA) {
        const int rr = i / n8, ch = i - rr * n8;
        cp_async16(dst + (rr * FW_LDB + 8 * ch) * 2, src + (size_t)rr * C + 8 * ch, 16);
      }
    }
    cp_async_commit();
  };

  // the input window: rows [4*t0, 4*t0 + 4*rows + 3) of x, all inside T
  const float* xb = x + ((size_t)b * T + 4 * t0) * F;
  for (int i = tid; i < (4 * rows + 3) * F; i += THREADS) xs[i] = xb[i];
  if (mma_warp) {
    for (int gs = 0; gs < FW_AHEAD; ++gs) request(gs);
  }
  __syncthreads();
  conv1_tile(xs, F, F1, R1, w1, b1, C, 0, min(FW_CS, C), c1buf(0), FW_LD, tid, THREADS);
  __syncthreads();

  if (mma_warp) {
    // this warp's m16 tiles 2 wm and 2 wm + 1: the tile element offset of
    // the lane's row (tap (0, 0), its 8-channel half); rows past M read
    // pixel 0, never stored
    int apix[2];
    bool mt_on[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int mt = 2 * wm + q;
      mt_on[q] = mt * 16 < M;
      int m = mt * 16 + (lane & 15);
      if (m >= M) m = 0;
      const int tl = m / F2, f = m - tl * F2;
      apix[q] = (2 * tl * F1 + f) * FW_LD + (lane >> 4) * 8;
    }
    float acc[2][8][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;
    // lane offset in a stage for ldmatrix.trans: k row lane & 15, columns
    // +8 for lanes 16..31
    const int boff = ((lane & 15) * FW_LDB + wn * 64 + (lane >> 4) * 8) * 2;
    const int njp = min(4, max(0, (NC - wn * 64) >> 4));  // this warp's 16-column pairs
    int gs = 0;
    for (int s = 0; s < nsl; ++s) {
      const int cs = min(FW_CS, C - s * FW_CS);
      const bf16* c1 = c1buf(s);
      for (int tap = 0; tap < 9; ++tap, ++gs) {
        cp_async_wait<FW_AHEAD - 1>();  // stage gs has landed
        bar_sync(BAR_MMA, FW_MMA);      // for every mma thread; stage gs - 1 is done
        request(gs + FW_AHEAD);
        const unsigned char* st = ring + (gs % FW_SLOTS) * FW_STAGE + boff;
        const bf16* at = c1 + tap_slot(tap, F1, F1e) * FW_LD;
#pragma unroll
        for (int kk = 0; kk < FW_CS; kk += 16) {
          if (kk >= cs) break;
          uint32_t a[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (mt_on[q]) ldmatrix_x4(a[q], at + apix[q] + kk);
          }
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            if (jp >= njp) continue;
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, st + (kk * FW_LDB + jp * 16) * 2);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              if (!mt_on[q]) continue;
              mma_bf16(acc[q][2 * jp], a[q], bb[0], bb[1]);
              mma_bf16(acc[q][2 * jp + 1], a[q], bb[2], bb[3]);
            }
          }
        }
      }
      block_sync();  // slice s + 1's tile is in; slice s's is free
    }

    // ---- epilogue: + b2, then ReLU and bf16 (forward) or the mask on g
    // (backward); rows past M and columns past C skipped
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!mt_on[q]) continue;
      const int mt = 2 * wm + q;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = wn * 64 + j * 8 + 2 * (lane & 3);
        if (cl >= NC) continue;
        const int col = n0 + cl;
        const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt * 16 + (lane >> 2) + 8 * h;
          if (row >= M) continue;
          const size_t idx = (((size_t)b * T2 + t0) * F2 + row) * C + col;
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
  } else {
    // the conv1 warps: slice s + 1 into the other tile while the mma warps
    // run slice s
    for (int s = 0; s < nsl; ++s) {
      if ((s + 1) * FW_CS < C) {
        conv1_tile(xs, F, F1, R1, w1, b1, C, (s + 1) * FW_CS, min(FW_CS, C - (s + 1) * FW_CS),
                   c1buf(s + 1), FW_LD, tid - FW_MMA, THREADS - FW_MMA);
      }
      block_sync();
    }
  }
}

bool shapes_taken(int B, int T, int F, int C) {
  return B >= 1 && out_len(out_len(T)) >= 1 && out_len(out_len(F)) >= 1 &&
         out_len(out_len(F)) <= FW_MAXM && C >= 16 && C % 16 == 0;
}

// Whether the forward takes r2 output rows per CTA at these shapes.
bool fwd_r2_ok(int T, int F, int r2) {
  const int T2 = out_len(out_len(T)), F2 = out_len(out_len(F));
  return r2 >= 1 && r2 <= T2 && r2 * F2 <= FW_MAXM && fwd_smem(r2, F).total <= SMEM_LIMIT;
}

// Output rows per CTA of the forward (and mask pass): the r2 of least cost
// in a wave model (one CTA an SM on PLAN_SMS SMs; a CTA costs its m16 tiles
// plus FW_OVH), the larger on a tie; 0 when none fits. Any r2 gives the same
// bits, so the model only sets the speed.
int pick_r2(int B, int T, int F, int C) {
  const int T2 = out_len(out_len(T)), F2 = out_len(out_len(F));
  const long long chunks = (C + FW_NC - 1) / FW_NC;
  int best = 0;
  long long best_cost = -1;
  for (int r2 = 1; fwd_r2_ok(T, F, r2); ++r2) {
    const long long ctas = (long long)B * ((T2 + r2 - 1) / r2) * chunks;
    const long long cost = (ctas + PLAN_SMS - 1) / PLAN_SMS * ((r2 * F2 + 15) / 16 + FW_OVH);
    if (best_cost < 0 || cost <= best_cost) best = r2, best_cost = cost;
  }
  return best;
}

dim3 fwd_grid(int B, int T, int C, int r2) {
  const int T2 = out_len(out_len(T));
  return dim3((unsigned)((T2 + r2 - 1) / r2), (unsigned)((C + FW_NC - 1) / FW_NC), (unsigned)B);
}

template <bool MASK>
int launch_conv2(const void* x, const void* w1, const void* b1, const void* w2,
                 const void* b2, const void* g, void* y, int B, int T, int F, int C, int r2,
                 cudaStream_t stream) {
  if (r2 == 0) r2 = pick_r2(B, T, F, C);
  if (!fwd_r2_ok(T, F, r2)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(r2, F).total;
  cudaError_t err = cudaFuncSetAttribute(fused_subsample_conv2_kernel<MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_subsample_conv2_kernel<MASK><<<fwd_grid(B, T, C, r2), THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(g), static_cast<bf16*>(y), T,
      F, C, r2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward

// The workspace: gm (bf16), then f32 partials.
struct Partials {
  bf16* gm;    // [B, T2, F2, C]
  float* dx;   // [B, nblk, 4*r2+3, F]: each conv1-pass block's input window
  float* dw1;  // [B, nblk, 9, C]
  float* db1;  // [B, nblk, C]
  float* db2;  // [B, nblk, C]
  float* dw2;  // [nsplit, 9C, C]
};

struct Plan {
  int r2f;                            // mask pass: rows per CTA
  int r2, nblk, NB;                   // conv1 pass: rows per block, blocks, B*nblk
  int rd, nblkd, per, nsplit, halves; // dw2 pass: rows per block, blocks, per split
  size_t smem1, smem2;                // shared bytes of the conv1 and dw2 passes
  size_t gm, dx, dw1, db1, db2, dw2, floats;  // offsets in f32 elements; total
};

// shared memory of the conv1 pass, in bytes from the start (two dc1 tiles)
struct Conv1Smem {
  size_t xs, gms, dc1, dc1tile, contrib, ring, w1s, comb, total;
};

__host__ __device__ inline Conv1Smem conv1_smem(int r2, int F, int C) {
  const int F1 = out_len(F), F2 = out_len(F1), R1 = 2 * r2 + 1, XW = 4 * r2 + 3;
  const int P = R1 * F1;
  Conv1Smem s;
  size_t o = 0;
  s.xs = o;      o += align16((size_t)XW * F * 4);
  s.gms = o;     o += align16((size_t)((r2 * F2 + 15) & ~15) * (C + 8) * 2);
  s.dc1tile = align16((size_t)P * BC_LDC * 4);
  s.dc1 = o;     o += 2 * s.dc1tile;
  s.contrib = o; o += align16((size_t)9 * P * 4);
  s.ring = o;    o += (size_t)BC_SLOTS * BC_STAGE;
  s.w1s = o;     o += 10 * BC_CS * 4;
  s.comb = o;    o += (size_t)BC_NGR * 10 * BC_CS * 4;
  s.total = o;
  return s;
}

struct Dw2Smem {
  size_t xs, c1, c1tile, ring, rowpix, total;  // c1: two block tiles
};

__host__ __device__ inline Dw2Smem dw2_smem(int rd, int F) {
  const int F1 = out_len(F), F2 = out_len(F1);
  Dw2Smem s;
  size_t o = 0;
  s.xs = o;     o += align16((size_t)(4 * rd + 3) * F * 4);
  s.c1tile = align16((size_t)(2 * rd + 1) * F1 * DW_LD * 2);
  s.c1 = o;     o += 2 * s.c1tile;
  s.ring = o;   o += (size_t)DW_SLOTS * DW_STAGE;
  s.rowpix = o; o += align16((size_t)rd * F2 * 4);
  s.total = o;
  return s;
}

int gcd_int(int a, int b) { return b ? gcd_int(b, a % b) : a; }

bool plan_bwd(int B, int T, int F, int C, Plan* p) {
  if (!shapes_taken(B, T, F, C)) return false;
  const int T2 = out_len(out_len(T)), F2 = out_len(out_len(F));
  p->r2f = pick_r2(B, T, F, C);
  if (p->r2f < 1) return false;
  // conv1 pass: the largest block of at most 128 gm rows that fits
  int r2 = min(T2, BC_MAXM / F2);
  while (r2 > 1 && conv1_smem(r2, F, C).total > SMEM_LIMIT) --r2;
  if (r2 < 1 || conv1_smem(r2, F, C).total > SMEM_LIMIT) return false;
  p->r2 = r2;
  p->nblk = (T2 + r2 - 1) / r2;
  p->NB = B * p->nblk;
  p->smem1 = conv1_smem(r2, F, C).total;
  // dw2 pass: blocks of rd rows with rd * F2 a multiple of 16 where that fits
  int rd = min(DW_RD_MAX / gcd_int(F2, DW_RD_MAX), T2);
  while (rd > 1 && dw2_smem(rd, F).total > SMEM_LIMIT) --rd;
  if (dw2_smem(rd, F).total > SMEM_LIMIT) return false;
  p->rd = rd;
  p->nblkd = (T2 + rd - 1) / rd;
  const int nbd = B * p->nblkd;
  p->halves = (C + DW_NC - 1) / DW_NC;
  const int ctas = (C / DW_CS) * p->halves;
  const int splits = max(1, min(nbd, PLAN_SMS / ctas));
  p->per = (nbd + splits - 1) / splits;
  p->nsplit = (nbd + p->per - 1) / p->per;
  p->smem2 = dw2_smem(rd, F).total;

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
// Slices of 16 channels. While the mma warps compute slice s's dpat and add
// its taps into one dc1 tile, the CUDA-core warps mask slice s - 1's tile,
// sum its db1 and dw1, add its dx sums per pixel and tap, and clear it.
__global__ void __launch_bounds__(THREADS, 1)
    fused_subsample_bwd_conv1_kernel(const float* __restrict__ x,
                                     const float* __restrict__ w1,
                                     const float* __restrict__ b1,
                                     const bf16* __restrict__ w2, Partials ws, int T, int F,
                                     int C, int r2) {
  constexpr int CS = BC_CS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T1 = out_len(T), F1 = out_len(F), T2 = out_len(T1), F2 = out_len(F1);
  const int XW = 4 * r2 + 3, LDA = C + 8, C8 = C >> 3;
  const Conv1Smem L = conv1_smem(r2, F, C);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  bf16* gms = reinterpret_cast<bf16*>(smem + L.gms);
  float* contrib = reinterpret_cast<float*>(smem + L.contrib);
  unsigned char* ring = smem + L.ring;
  float* w1s = reinterpret_cast<float*>(smem + L.w1s);
  float* comb = reinterpret_cast<float*>(smem + L.comb);
  auto dc1buf = [&](int s) { return reinterpret_cast<float*>(smem + L.dc1 + (s & 1) * L.dc1tile); };

  const int b = blockIdx.y, nblk = gridDim.x;
  const int t0 = blockIdx.x * r2, rows = min(r2, T2 - t0);
  const int M = rows * F2;                // gm rows of the block
  const int R1 = 2 * rows + 1, P = R1 * F1;  // conv1 rows and pixels it touches
  const size_t q = (size_t)b * nblk + blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool mma_warp = tid < BC_MMA;
  const int KS = (C + BC_KS - 1) / BC_KS;  // stages per slice
  const int nsl = C / CS;
  const int G = nsl * KS;

  // the input window (all inside T); both dc1 tiles and the dx sums cleared
  const float* xb = x + ((size_t)b * T + 4 * t0) * F;
  for (int i = tid; i < (4 * rows + 3) * F; i += THREADS) xs[i] = xb[i];
  for (int i = tid; i < 2 * (int)(L.dc1tile / 4); i += THREADS) {
    reinterpret_cast<float*>(smem + L.dc1)[i] = 0.f;
  }
  for (int i = tid; i < 9 * P; i += THREADS) contrib[i] = 0.f;

  if (mma_warp) {
    regs_inc<168>();
    // w2 rows (tap, c0 + c), c < 16, columns [32 kk, 32 kk + 32) of stage gs
    // -> stage row tap * 16 + c of 64 bytes; its 16-byte chunk ch sits at
    // ch ^ ((row >> 1) & 3), so that the 8 rows of an ldmatrix phase hit 8
    // bank groups (C % 32 == 16: the last stage's upper half is never read)
    auto request = [&](int gs) {
      if (gs < G) {
        const int s = gs / KS, kk = gs - s * KS;
        const int nch = min(4, (C - BC_KS * kk) >> 3);
        unsigned char* dst = ring + (gs % BC_SLOTS) * BC_STAGE;
        for (int i = tid; i < 9 * CS * 4; i += BC_MMA) {
          const int row = i >> 2, ch = i & 3;
          if (ch >= nch) continue;
          const int tap = row / CS, c = row - tap * CS;
          cp_async16(dst + row * 64 + ((ch ^ ((row >> 1) & 3)) << 4),
                     w2 + ((size_t)tap * C + s * CS + c) * C + BC_KS * kk + 8 * ch, 16);
        }
      }
      cp_async_commit();
    };
    // the block's gm rows, zeros up to a whole m16 tile (cp.async group 0:
    // complete at the first step's wait)
    const bf16* gmb = ws.gm + ((size_t)b * T2 + t0) * F2 * C;
    const int mtiles = (M + 15) >> 4;
    for (int i = tid; i < 16 * mtiles * C8; i += BC_MMA) {
      const int m = i / C8, c8 = i - m * C8;
      cp_async16(gms + (size_t)m * LDA + 8 * c8, m < M ? gmb + (size_t)m * C + 8 * c8 : gmb,
                 m < M ? 16 : 0);
    }
    cp_async_commit();
    for (int gs = 0; gs < BC_AHEAD; ++gs) request(gs);
    block_sync();

    // warp w runs on scheduler w % 4 = wm: m16 tiles wm and wm + 4; n8
    // tiles 9 wn .. 9 wn + 8 (tap (9 wn + j) / 2, channels 8 ((9 wn + j) % 2))
    const int wm = warp & 3, wn = warp >> 2;
    const int nq = (mtiles - wm + 3) >> 2;
    const int arow = (wm * 16 + (lane & 15)) * LDA + (lane >> 4) * 8;
    // B: lanes 0..15 read n8 tile 9 wn + j of a stage, lanes 16..31 tile
    // 9 wn + j + 1; k16 half h is chunk 2 h + ((lane >> 3) & 1), at
    // that ^ ((row >> 1) & 3) with row bits 1-2 = lane bits 1-2
    const int bswz = (lane >> 1) & 3, bch = (lane >> 3) & 1;
    const int bbase = ((9 * wn + (lane >> 4)) * 8 + (lane & 7)) * 64;
    const int bsolo = ((9 * wn) * 8 + (lane & 7)) * 64;
    int gs = 0;
    for (int s = 0; s < nsl; ++s) {
      float acc[2][BC_JT][4];
#pragma unroll
      for (int qq = 0; qq < 2; ++qq)
#pragma unroll
        for (int j = 0; j < BC_JT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[qq][j][e] = 0.f;
      // dpat[m, (tap, c)] = sum_n gm[m, n] w2[tap*C + 16 s + c, n]
      for (int kk = 0; kk < KS; ++kk, ++gs) {
        cp_async_wait<BC_AHEAD - 1>();
        bar_sync(BAR_MMA, BC_MMA);
        request(gs + BC_AHEAD);
        const unsigned char* st = ring + (gs % BC_SLOTS) * BC_STAGE;
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
          const int k = BC_KS * kk + 16 * h;
          if (k >= C) break;
          const int boff = ((2 * h + bch) ^ bswz) << 4;
          uint32_t a[2][4];
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            if (qq < nq) ldmatrix_x4(a[qq], gms + arow + (size_t)qq * 64 * LDA + k);
          }
#pragma unroll
          for (int j = 0; j < BC_JT; j += 2) {
            const bool two = j + 1 < BC_JT;
            uint32_t bb[4];
            ldmatrix_x4(bb, st + (two ? bbase : bsolo) + j * 8 * 64 + boff);
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
              if (qq >= nq) continue;
              mma_bf16(acc[qq][j], a[qq], bb[0], bb[1]);
              if (two) mma_bf16(acc[qq][j + 1], a[qq], bb[2], bb[3]);
            }
          }
        }
      }
      // dpat in bf16, added into dc1 at conv1 pixel (2 tl + ti, 2 f + tj).
      // Two taps meet at a dc1 element only if their (ti, tj) have the same
      // parities, so four rounds keep every element's taps in order: {0, 1,
      // 3, 4}, {2, 5, 7}, {6}, {8}; within a round every element is written
      // once
      float* dc1 = dc1buf(s);
      int dpix[2][2];  // the dc1 pixel of each fragment row (-1: past M)
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int mm = (wm + 4 * qq) * 16 + (lane >> 2) + 8 * h;
          const int tl = mm / F2, f = mm - tl * F2;
          dpix[qq][h] = qq < nq && mm < M ? 2 * tl * F1 + 2 * f : -1;
        }
      }
#pragma unroll
      for (int round = 0; round < 4; ++round) {
        bar_sync(BAR_MMA, BC_MMA);
#pragma unroll
        for (int j = 0; j < BC_JT; ++j) {
          const int nt = 9 * wn + j, tap = nt >> 1;
          const int tround = tap == 6 ? 2 : tap == 8 ? 3 : (tap == 2 || tap == 5 || tap == 7) ? 1 : 0;
          if (tround != round) continue;
          const int toff = (tap / 3) * F1 + tap % 3;
          const int c = 8 * (nt & 1) + 2 * (lane & 3);
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (dpix[qq][h] < 0) continue;
              float* d = dc1 + (size_t)(dpix[qq][h] + toff) * BC_LDC + c;
              d[0] = __fadd_rn(d[0], round_bf16(acc[qq][j][2 * h]));
              d[1] = __fadd_rn(d[1], round_bf16(acc[qq][j][2 * h + 1]));
            }
          }
        }
      }
      block_sync();  // slice s's tile is in; slice s - 1's was cleared
    }
    block_sync();  // the CUDA-core warps are done with the last slice
  } else {
    // the CUDA-core warps: slice s - 1 while the mma warps run slice s
    regs_dec<88>();
    const int ct = tid - BC_MMA;
    const int mc = ct % CS, grp = ct / CS;
    const float inv = 1.f / (float)F1;
    block_sync();
    block_sync();  // the mma warps run slice 0
    for (int s = 1; s <= nsl; ++s) {
      const int sp = s - 1;
      float* dc1 = dc1buf(sp);
      for (int i = ct; i < 10 * CS; i += BC_CC) {
        const int k = i / CS, c = i - k * CS;
        w1s[i] = k < 9 ? w1[k * C + sp * CS + c] : b1[sp * CS + c];
      }
      bar_sync(BAR_CC, BC_CC);
      // the mask on c1_pre (recomputed as the plain version sums it), a
      // group of 16 lanes per pixel and a lane per channel, db1 and dw1
      // summed per group in registers
      {
        float wr[9], sd[10];
#pragma unroll
        for (int k = 0; k < 9; ++k) wr[k] = w1s[k * CS + mc];
        const float br = w1s[9 * CS + mc];
#pragma unroll
        for (int k = 0; k < 10; ++k) sd[k] = 0.f;
        // two pixels an iteration (the second's sums are added to the
        // first's in a fixed order)
        float se[10];
#pragma unroll
        for (int k = 0; k < 10; ++k) se[k] = 0.f;
        for (int p = grp; p < P; p += 2 * BC_NGR) {
          const int pb = p + BC_NGR < P ? p + BC_NGR : p;
          const int r = div_small(p, inv), f1 = p - r * F1;
          const int rb = div_small(pb, inv), fb = pb - rb * F1;
          const float* xr = xs + 2 * r * F + 2 * f1;
          const float* xq = xs + 2 * rb * F + 2 * fb;
          float xv[9], xw[9];
#pragma unroll
          for (int k = 0; k < 9; ++k) xv[k] = xr[(k / 3) * F + k % 3], xw[k] = xq[(k / 3) * F + k % 3];
          float* d = dc1 + (size_t)p * BC_LDC + mc;
          float* e = dc1 + (size_t)pb * BC_LDC + mc;
          float a = br, ab = br;
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            a = __fadd_rn(a, __fmul_rn(xv[k], wr[k]));
            ab = __fadd_rn(ab, __fmul_rn(xw[k], wr[k]));
          }
          const float v = a > 0.f ? *d : 0.f;
          const float vb = pb != p && ab > 0.f ? *e : 0.f;
          *d = v;
          if (pb != p) *e = vb;
          sd[0] = __fadd_rn(sd[0], v);
          se[0] = __fadd_rn(se[0], vb);
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            sd[1 + k] = __fadd_rn(sd[1 + k], __fmul_rn(xv[k], v));
            se[1 + k] = __fadd_rn(se[1 + k], __fmul_rn(xw[k], vb));
          }
        }
#pragma unroll
        for (int k = 0; k < 10; ++k) sd[k] = __fadd_rn(sd[k], se[k]);
#pragma unroll
        for (int k = 0; k < 10; ++k) comb[(grp * 10 + k) * CS + mc] = sd[k];
      }
      bar_sync(BAR_CC, BC_CC);
      // per pixel and tap, sum_c dc1 w1 over the slice's channels (in
      // order), added to the sums of the slices before; db1 and dw1 of the
      // slice combined over the pixel groups in order
      for (int p = ct; p < P; p += BC_CC) {
        float sp9[9];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) sp9[tap] = 0.f;
        const float* d = dc1 + (size_t)p * BC_LDC;
#pragma unroll
        for (int c = 0; c < CS; c += 4) {
          const float v[4] = {d[c], d[c + 1], d[c + 2], d[c + 3]};
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const float4 w = *reinterpret_cast<const float4*>(w1s + tap * CS + c);
            sp9[tap] = __fadd_rn(sp9[tap], __fmul_rn(v[0], w.x));
            sp9[tap] = __fadd_rn(sp9[tap], __fmul_rn(v[1], w.y));
            sp9[tap] = __fadd_rn(sp9[tap], __fmul_rn(v[2], w.z));
            sp9[tap] = __fadd_rn(sp9[tap], __fmul_rn(v[3], w.w));
          }
        }
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          contrib[tap * P + p] = __fadd_rn(contrib[tap * P + p], sp9[tap]);
        }
      }
      for (int i = ct; i < 10 * CS; i += BC_CC) {
        const int k = i / CS, c = i - k * CS;
        float v = comb[k * CS + c];
        for (int gr = 1; gr < BC_NGR; ++gr) v = __fadd_rn(v, comb[(gr * 10 + k) * CS + c]);
        if (k == 0) {
          ws.db1[q * C + sp * CS + c] = v;
        } else {
          ws.dw1[(q * 9 + k - 1) * C + sp * CS + c] = v;
        }
      }
      bar_sync(BAR_CC, BC_CC);
      for (int i = ct; i < P * BC_LDC; i += BC_CC) dc1[i] = 0.f;  // for slice s + 1
      block_sync();
    }
  }

  // the dx window: input (row, f) gathers tap (ti, tj) of conv1 pixel
  // ((row - ti) / 2, (f - tj) / 2), taps in order; rows past the block's
  // window are 0
  float* dxo = ws.dx + q * XW * F;
  for (int i = tid; i < XW * F; i += THREADS) {
    const int row = i / F, f = i - row * F;
    float s = 0.f;
#pragma unroll
    for (int ti = 0; ti < 3; ++ti) {
      const int rr = row - ti;
      if (rr < 0 || (rr & 1) || (rr >> 1) >= R1) continue;
#pragma unroll
      for (int tj = 0; tj < 3; ++tj) {
        const int ff = f - tj;
        if (ff < 0 || (ff & 1) || (ff >> 1) >= F1) continue;
        s = __fadd_rn(s, contrib[(ti * 3 + tj) * P + (rr >> 1) * F1 + (ff >> 1)]);
      }
    }
    dxo[i] = s;
  }
  // db2: the gm tile's column sums, rows in order
  for (int c = tid; c < C; c += THREADS) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s = __fadd_rn(s, __bfloat162float(gms[(size_t)m * LDA + c]));
    ws.db2[q * C + c] = s;
  }
}

// Pass 3: dw2 = pat^T gm over the blocks [q0, q0 + per) of the list of
// rd-row blocks, for dw2 rows (tap, c0 + c) (c < 16) and columns
// [n0, n0 + 256). Mma warp w takes taps 3 (w / 4) .. + 2 and 64 columns;
// while the mma warps run block q, the conv1 warps compute block q + 1's
// conv1 into the other tile.
__global__ void __launch_bounds__(THREADS, 1)
    fused_subsample_bwd_dw2_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w1,
                                   const float* __restrict__ b1, Partials ws, int T, int F,
                                   int C, int rd, int nblkd, int NBd, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T1 = out_len(T), F1 = out_len(F), T2 = out_len(T1), F2 = out_len(F1);
  const int F1e = (F1 + 1) >> 1;
  const Dw2Smem L = dw2_smem(rd, F);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  unsigned char* ring = smem + L.ring;
  int* rowpix = reinterpret_cast<int*>(smem + L.rowpix);
  auto c1buf = [&](int i) { return reinterpret_cast<bf16*>(smem + L.c1 + (i & 1) * L.c1tile); };

  const int c0 = blockIdx.x * DW_CS, n0 = blockIdx.y * DW_NC, split = blockIdx.z;
  const int NC = min(DW_NC, C - n0), n8 = NC >> 3;
  const int qa = split * per, qb = min(NBd, qa + per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool mma_warp = tid < DW_MMA;

  // block qc's input window into xs (all inside T) by threads t < nt; its
  // conv1 rows
  auto load_window = [&](int qc, int t, int nt) {
    const int b = qc / nblkd, t0 = (qc - b * nblkd) * rd;
    const float* xb = x + ((size_t)b * T + 4 * t0) * F;
    for (int i = t; i < (4 * min(rd, T2 - t0) + 3) * F; i += nt) xs[i] = xb[i];
  };
  auto conv1_rows = [&](int qc) { return 2 * min(rd, T2 - (qc % nblkd) * rd) + 1; };

  // conv1 tile slot of each pixel m of a block, tap (0, 0)
  for (int m = tid; m < rd * F2; m += THREADS) {
    const int tl = m / F2;
    rowpix[m] = 2 * tl * F1 + (m - tl * F2);
  }
  if (qa < qb) load_window(qa, tid, THREADS);

  if (mma_warp) {
    // gm rows [16 kp, 16 kp + 16) of block qp (zeros past the block),
    // columns [n0, n0 + NC): the producer walks the same (block, step) list
    // as the consumer, DW_AHEAD steps ahead
    int qp = qa, kp = 0;
    auto request = [&](int slot) {
      if (qp < qb) {
        const int b = qp / nblkd, t0 = (qp - b * nblkd) * rd;
        const int M = min(rd, T2 - t0) * F2;
        const bf16* src = ws.gm + (((size_t)b * T2 + t0) * F2 + 16 * kp) * C + n0;
        unsigned char* dst = ring + slot * DW_STAGE;
        for (int i = tid; i < 16 * n8; i += DW_MMA) {
          const int r = i / n8, ch = i - r * n8;
          const bool ok = 16 * kp + r < M;
          cp_async16(dst + (r * DW_LDB + 8 * ch) * 2, ok ? src + (size_t)r * C + 8 * ch : ws.gm,
                     ok ? 16 : 0);
        }
        if (16 * ++kp >= M) kp = 0, ++qp;
      }
      cp_async_commit();
    };
    for (int i = 0; i < DW_AHEAD; ++i) request(i);
    block_sync();  // the window and rowpix are in
    if (qa < qb) {
      conv1_tile(xs, F, F1, conv1_rows(qa), w1, b1, C, c0, DW_CS, c1buf(0), DW_LD, tid,
                 THREADS);
    }
    block_sync();  // block qa's tile is in

    // warp w runs on scheduler w % 4 = wn: taps 3 tg .. 3 tg + 2, columns
    // [64 wn, 64 wn + 64)
    const int tg = warp >> 2, wn = warp & 3;
    int toff[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) toff[i] = tap_slot(3 * tg + i, F1, F1e) * DW_LD;
    float acc[3][8][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    const int njp = min(4, max(0, (NC - wn * 64) >> 4));  // this warp's 16-column pairs
    const int boff = ((lane & 15) * DW_LDB + wn * 64 + (lane >> 4) * 8) * 2;
    int gs = 0;
    for (int qc = qa; qc < qb; ++qc) {
      const int b = qc / nblkd, t0 = (qc - b * nblkd) * rd;
      const int M = min(rd, T2 - t0) * F2;
      const bf16* c1 = c1buf(qc - qa);
      for (int k0 = 0; k0 < M; k0 += 16, ++gs) {
        cp_async_wait<DW_AHEAD - 1>();
        bar_sync(BAR_MMA, DW_MMA);  // step gs is in for every mma thread
        request((gs + DW_AHEAD) % DW_SLOTS);
        const unsigned char* st = ring + (gs % DW_SLOTS) * DW_STAGE + boff;
        // A = pat^T: lanes 0-7 pixels k0..+7 channels 0-7, 8-15 the same
        // pixels channels 8-15, 16-31 pixels +8 (pixels past M read slot
        // 0: their gm rows are zeros)
        const int m = k0 + (lane & 7) + ((lane >> 4) << 3);
        const bf16* ab = c1 + (m < M ? rowpix[m] : 0) * DW_LD + ((lane >> 3) & 1) * 8;
        uint32_t a[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i) ldmatrix_x4_trans(a[i], ab + toff[i]);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp >= njp) continue;
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, st + jp * 32);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            mma_bf16(acc[i][2 * jp], a[i], bb[0], bb[1]);
            mma_bf16(acc[i][2 * jp + 1], a[i], bb[2], bb[3]);
          }
        }
      }
      block_sync();  // block qc + 1's tile is in; block qc's is free
    }
    float* out = ws.dw2 + (size_t)split * 9 * C * C;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = wn * 64 + j * 8 + 2 * (lane & 3);
        if (cl >= NC) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t row = (size_t)(3 * tg + i) * C + c0 + (lane >> 2) + 8 * h;
          *reinterpret_cast<float2*>(out + row * C + n0 + cl) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
  } else {
    // the conv1 warps: block qc + 1's window and conv1 while the mma warps
    // run block qc
    const int ct = tid - DW_MMA, nct = THREADS - DW_MMA;
    block_sync();
    if (qa < qb) {
      conv1_tile(xs, F, F1, conv1_rows(qa), w1, b1, C, c0, DW_CS, c1buf(0), DW_LD, tid,
                 THREADS);
    }
    block_sync();
    for (int qc = qa; qc < qb; ++qc) {
      if (qc + 1 < qb) {
        load_window(qc + 1, ct, nct);
        bar_sync(BAR_CC, nct);
        conv1_tile(xs, F, F1, conv1_rows(qc + 1), w1, b1, C, c0, DW_CS, c1buf(qc + 1 - qa),
                   DW_LD, ct, nct);
      }
      block_sync();
    }
  }
}

// Pass 4: every gradient element sums its partials in a fixed order: dx over
// the (at most two) blocks whose window holds its row, block ascending; dw2
// over the splits; dw1, db1 and db2 over the blocks, a warp per element: lane
// l sums blocks l, l + 32, ... in order, then the lanes combine in a fixed
// butterfly.
__global__ void __launch_bounds__(REDUCE_THREADS)
    fused_subsample_bwd_reduce(Partials ws, float* __restrict__ dx, float* __restrict__ dw1,
                               float* __restrict__ db1, float* __restrict__ dw2,
                               float* __restrict__ db2, int B, int T, int F, int C, int r2,
                               int nblk, int nsplit) {
  const size_t NB = (size_t)B * nblk, XW = 4 * r2 + 3;
  size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  const size_t n_dx = (size_t)B * T * F, n_dw2 = (size_t)9 * C * C;
  const size_t n_pt = (n_dx + n_dw2 + 31) & ~(size_t)31;  // warps start on whole warps
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
  if (i < n_dx + n_dw2) {
    i -= n_dx;
    float s = 0.f;
    for (int p = 0; p < nsplit; ++p) s = __fadd_rn(s, ws.dw2[(size_t)p * n_dw2 + i]);
    dw2[i] = s;
    return;
  }
  if (i < n_pt) return;
  const size_t e = (i - n_pt) >> 5;  // dw1 [9C], then db1 [C], then db2 [C]
  const int l = (int)(i & 31);
  if (e >= (size_t)11 * C) return;  // whole warps: uniform
  const float* src;
  size_t stride;
  float* out;
  if (e < (size_t)9 * C) {
    src = ws.dw1 + e, stride = (size_t)9 * C, out = dw1 + e;
  } else if (e < (size_t)10 * C) {
    src = ws.db1 + (e - 9 * C), stride = C, out = db1 + (e - 9 * C);
  } else {
    src = ws.db2 + (e - 10 * C), stride = C, out = db2 + (e - 10 * C);
  }
  float s = 0.f;
  for (size_t q = l; q < NB; q += 32) s = __fadd_rn(s, src[q * stride]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if (l == 0) *out = s;
}

}  // namespace

extern "C" {

// y[B,T2,F2,C] (bf16) = relu(conv2(relu(conv1(x[B,T,F] f32)))), with
// w1 [3,3,C] f32, b1 [C] f32, w2 [9C,C] bf16 ((i,j)-major, C_in-minor), b2 [C].
// r2 output rows per CTA, 0 for the plan's choice (every r2 gives the same
// bits).
int fused_subsample_fwd(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* y, int B, int T,
                        int F, int C, int r2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shapes_taken(B, T, F, C)) return (int)cudaErrorInvalidValue;
  return launch_conv2<false>(x, w1, b1, w2, b2, nullptr, y, B, T, F, C, r2,
                             (cudaStream_t)stream);
}

// f32 elements of fused_subsample_bwd's workspace, or -1 for shapes it does
// not take.
long long fused_subsample_bwd_workspace(int B, int T, int F, int C) {
  Plan p;
  return plan_bwd(B, T, F, C, &p) ? (long long)p.floats : -1;
}

// The launch plan for these shapes, into out[15]: the forward (and mask
// pass) rows per CTA, its grid (x, y, z) and shared bytes; the conv1 pass's
// rows per block, CTAs and shared bytes; the dw2 pass's rows per block,
// blocks, splits, CTAs and shared bytes; the largest r2 the forward takes;
// the workspace floats. Returns cudaErrorInvalidValue for shapes it does not
// take.
int fused_subsample_plan(int B, int T, int F, int C, long long* out) {
  Plan p;
  if (!plan_bwd(B, T, F, C, &p)) return (int)cudaErrorInvalidValue;
  const dim3 g = fwd_grid(B, T, C, p.r2f);
  int r2max = p.r2f;
  while (fwd_r2_ok(T, F, r2max + 1)) ++r2max;
  const long long v[14] = {p.r2f, g.x, g.y, g.z, (long long)fwd_smem(p.r2f, F).total,
                           p.r2, p.NB, (long long)p.smem1,
                           p.rd, (long long)B * p.nblkd, p.nsplit,
                           (long long)(C / DW_CS) * p.halves * p.nsplit, (long long)p.smem2,
                           r2max};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  out[14] = (long long)p.floats;
  return 0;
}

// The backward's first pass alone: gm [B,T2,F2,C] bf16 = g where y_pre > 0,
// r2 output rows per CTA (0: the plan's).
int fused_subsample_bwd_mask(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* g, void* gm, int B, int T, int F,
                             int C, int r2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shapes_taken(B, T, F, C)) return (int)cudaErrorInvalidValue;
  return launch_conv2<true>(x, w1, b1, w2, b2, g, gm, B, T, F, C, r2, (cudaStream_t)stream);
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
  int rc = launch_conv2<true>(x, w1, b1, w2, b2, g, ws.gm, B, T, F, C, p.r2f, s);
  if (rc != 0) return rc;

  err = cudaFuncSetAttribute(fused_subsample_bwd_conv1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem1);
  if (err != cudaSuccess) return (int)err;
  fused_subsample_bwd_conv1_kernel<<<dim3((unsigned)p.nblk, (unsigned)B), THREADS, p.smem1,
                                     s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), ws, T, F, C, p.r2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(fused_subsample_bwd_dw2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid3((unsigned)(C / DW_CS), (unsigned)p.halves, (unsigned)p.nsplit);
  fused_subsample_bwd_dw2_kernel<<<grid3, THREADS, p.smem2, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), ws, T, F, C, p.rd, p.nblkd, B * p.nblkd, p.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t total = (((size_t)B * T * F + (size_t)9 * C * C + 31) & ~(size_t)31) +
                       (size_t)32 * 11 * C;
  fused_subsample_bwd_reduce<<<(unsigned)((total + REDUCE_THREADS - 1) / REDUCE_THREADS),
                               REDUCE_THREADS, 0, s>>>(
      ws, static_cast<float*>(dx), static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dw2), static_cast<float*>(db2), B, T, F, C, p.r2, p.nblk,
      p.nsplit);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// operations per byte, below the ~295 (bf16) and ~590 (int8) at which the
// H100's tensor cores rather than its memory become the limit. So the bound
// is memory traffic at 3.35 TB/s: 5.7 us at (4096, 256, 1024), where the f32
// output is 16.8 of the 18.9 MB; 3.8 us at (4096, 1024, 256); 1.9 us at
// (4096, 256, 256); 0.5 us at (1023, 256, 256). The products take 1.1-2.2 us
// at the bf16 peak; mma.sync and the weight decode reach only part of it
// (scripts/ternary_matmul_probe.py times knock-out builds of this file).
//
// Design (mma.sync; one CTA of 4 warps owns BM = 16*MT rows of x and one or
// more 128-column chunks of the output, each warp 32 columns of a chunk):
//   - The K loop follows the TPU kernel's planar walk: a stage is SR packed
//     rows i0..i0+SR-1 (bf16 16, int8 32) of all 4 planes, i.e. the x
//     columns j*K/4 + i0 ... for j = 0..3. An A stage row is 128 bytes,
//     plane after plane, so one mma k-step is one plane. No division or
//     modulo by K/4: offsets are j*K4 + i.
//   - Weights: each stage copies its SR x 128 packed bytes into shared
//     memory with 16-byte cp.async. Each thread gathers the 4 bytes its mma
//     B fragments need into one register and decodes all 4 planes from it
//     with a shift, a mask and a byte permute (bf16: __byte_perm against a
//     two-word table; int8: a bytewise add and xor). A byte is read from
//     shared memory once per warp and never divided by anything.
//   - Loads run as one cp.async stream over (chunk, stage) steps through a
//     ring of NSLOT slots, AHEAD steps in flight: per step one wait and one
//     barrier. ldmatrix.x4 reads A from an XOR-swizzled layout, the gathers
//     read a second swizzle: no bank conflicts. Any K: bf16 A streams with
//     the weights.
//   - W2A8 quantizes inside the launch. Its CTA copies its rows' raw x (bf16,
//     or f32 without a cast kernel) of up to K = 1024 into shared memory in
//     one cp.async group, takes each row's absmax there, scale =
//     max(absmax, 1e-30f) / 127.0f, and stores q = clamp(rint(x / scale),
//     -127, 127) (IEEE division, round half to even as torch.round) as the
//     int8 A of all its chunks: x is read once and quantized once per CTA.
//     Larger K takes the absmax from device memory first, then quantizes
//     pass by pass (PCAP packed rows each). The int8 mma m16n8k32 sums are
//     exact; the epilogue is (float)acc * scale[m] * alpha in that order
//     (__fmul_rn), equal to the plain version bit for bit.
//   - Stores: each warp passes its 16 x 32 f32 blocks through a padded
//     shared-memory tile, so every store instruction writes 4 rows of 128
//     contiguous bytes (whole cache lines, 16 bytes a thread), not the 16
//     rows of 32 bytes that the mma fragments hold; the f32 output is most
//     of the bytes. Ragged M and N are masked (scalar stores when N % 4
//     != 0).
//   - Unaligned views, K/4 % 8 != 0 or N % 16 != 0 take element-wise copies
//     into the same shared layouts (zero fill beyond M, K/4 and N).
//
// Tiles per path shape (`plan` below, 132 SMs; tuned on the card): the bf16
// kernel takes the largest MT of 4, 2, 1 that gives one CTA per SM, one
// chunk per CTA; W2A8 takes MT = 2 when there are 4+ chunks to share the
// quantized rows, else 1, and the fewest splits of N that fill the card:
//   (4096, 256, 1024): bf16 MT=4, 64 x 8 = 512 CTAs; W2A8 MT=2, 128 x 2 = 256
//   (4096, 1024, 256): bf16 MT=2, 128 x 2 = 256 CTAs; W2A8 MT=1, 256 x 1 = 256
//   (4096, 256, 256):  bf16 MT=2, 128 x 2 = 256 CTAs; W2A8 MT=1, 256 x 1 = 256
//   (1023, 256, 256):  bf16 MT=1, 64 x 2 = 128 CTAs;  W2A8 MT=1, 64 x 2 = 128
// `ternary_matmul_plan` reports the tiles of any shape.
//
// Every entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;  // 4 warps, each 32 columns of a 128-column chunk
constexpr int BN = 128;
constexpr int ROWB = 128;     // bytes per row of an A or slab stage
constexpr int PCAP = 256;     // packed rows (K/4) resident at once: K <= 1024
constexpr int AHEAD = 4;      // stages in flight ahead of the one computed
constexpr int NSLOT = AHEAD + 1;  // + the stage being computed
constexpr int EP_LD = 40;     // words per row of a warp's staged 16 x 32 output
constexpr int EP_BYTES = THREADS / 32 * 16 * EP_LD * 4;  // staging, all warps

template <bool INT8>
struct Kind {
  static constexpr int SR = INT8 ? 32 : 16;  // packed rows per stage
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared memory of a launch, in bytes from the start (the kernel and the host
// compute it alike): a ring of NSLOT stage slots (bf16: A and weight slab;
// W2A8: the slab), then for W2A8 the int8 A of one pass and the raw x of one
// pass ([BM][4 planes][P] elements, each segment padded by 16 bytes so the
// quantizing threads read different banks); the output staging tiles (which
// W2A8 lays over the raw x, dead by then) and the row scales.
struct Layout {
  int ring, ares, raw, seg, ep, scale, bytes;
};
template <bool INT8>
__host__ __device__ inline Layout layout(int BM, int K4, int xbytes) {
  constexpr int SR = Kind<INT8>::SR;
  Layout l;
  l.ring = 0;
  l.ares = NSLOT * ((INT8 ? 0 : BM * ROWB) + SR * ROWB);
  const int P = ((K4 < PCAP ? K4 : PCAP) + SR - 1) / SR * SR;  // whole stages
  l.seg = P * xbytes + 16;
  l.raw = l.ares + (INT8 ? cdiv(P, SR) * BM * ROWB : 0);
  const int raw_bytes = INT8 ? BM * 4 * l.seg : 0;
  l.ep = INT8 ? l.raw : l.ares;
  l.scale = l.ep + (raw_bytes > EP_BYTES ? raw_bytes : EP_BYTES);
  l.bytes = l.scale + (INT8 ? BM * 4 : 0);
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most n groups are pending (n is clamped to 7: waiting for
// more than needed is safe).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of (row r, 16-byte chunk c) in an A stage: chunks XOR-swizzled
// by r & 7 so the 8 rows an ldmatrix phase reads hit 8 different bank groups.
__device__ __forceinline__ int a_off(int r, int c) { return r * ROWB + ((c ^ (r & 7)) << 4); }
// Byte offset of (packed row r, column n) in a slab stage: chunks swizzled by
// (r >> 1) & 7 so the rows 2t+q (bf16) and 4t+q (int8) that the 4 lanes of a
// quad read lie in different banks.
__device__ __forceinline__ int w_off(int r, int n) {
  return r * ROWB + ((((n >> 4) ^ (r >> 1)) & 7) << 4) + (n & 15);
}

// ---------------------------------------------------------------------------
// Loads into shared memory

// One slab stage: packed rows i0 .. i0+SR-1, columns n0 .. n0+127. 16-byte
// cp.async when `vec` (N % 16 == 0, aligned base), else byte by byte. Zero
// beyond K4 and N.
template <bool INT8>
__device__ __forceinline__ void load_slab(uint8_t* Ws, const uint8_t* __restrict__ packed,
                                          int K4, int N, int i0, int n0, bool vec) {
  constexpr int SR = Kind<INT8>::SR;
  if (vec) {
    for (int i = threadIdx.x; i < SR * 8; i += THREADS) {
      const int c = i & 7, rr = i >> 3, gr = i0 + rr, gn = n0 + c * 16;
      const bool ok = gr < K4 && gn < N;
      cp_async16(Ws + w_off(rr, c * 16), ok ? packed + (size_t)gr * N + gn : packed,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < SR * BN; i += THREADS) {
      const int n = i % BN, rr = i / BN, gr = i0 + rr, gn = n0 + n;
      Ws[w_off(rr, n)] = (gr < K4 && gn < N) ? packed[(size_t)gr * N + gn] : 0;
    }
  }
}

// One bf16 A stage: row r, chunk c = 2j + h holds x[m0+r][j*K4 + i0 + 8h + 0..7].
template <int BM>
__device__ __forceinline__ void load_a_bf16(uint8_t* As, const __nv_bfloat16* __restrict__ x,
                                            int M, int K, int m0, int i0, bool vec) {
  const int K4 = K >> 2;
  if (vec) {  // K4 % 8 == 0: a chunk is wholly inside or outside the plane
    for (int i = threadIdx.x; i < BM * 8; i += THREADS) {
      const int c = i & 7, r = i >> 3, gm = m0 + r, gi = i0 + (c & 1) * 8;
      const bool ok = gm < M && gi < K4;
      cp_async16(As + a_off(r, c), ok ? x + (size_t)gm * K + (c >> 1) * K4 + gi : x,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BM * 64; i += THREADS) {
      const int e = i & 63, r = i >> 6, j = e >> 4, ii = e & 15;
      const int gm = m0 + r, gi = i0 + ii;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (gm < M && gi < K4) v = x[(size_t)gm * K + j * K4 + gi];
      *reinterpret_cast<__nv_bfloat16*>(As + a_off(r, 2 * j + (ii >> 3)) + (ii & 7) * 2) = v;
    }
  }
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// 8 consecutive elements of x at p (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The raw x of the pass at packed row p0 (min(K4 - p0, PCAP) rows of each
// plane, zero-filled to whole 32-row stages) into raw[(r*4 + j) * seg ...]:
// 16-byte cp.async when `vec` (K4 % 8 == 0, aligned), else element by
// element. Zero beyond M and K4.
template <typename XT, int BM>
__device__ __forceinline__ void load_raw_pass(uint8_t* raw, int seg, const XT* __restrict__ x,
                                              int M, int K, int m0, int p0, bool vec) {
  constexpr int EPC = 16 / sizeof(XT);  // elements per 16 bytes
  const int K4 = K >> 2, chunks = cdiv(min(K4 - p0, PCAP), 32) * 32 / EPC;
  if (vec) {
    for (int i = threadIdx.x; i < BM * 4 * chunks; i += THREADS) {
      const int c = i % chunks, sg = i / chunks, r = sg >> 2, j = sg & 3;
      const int gm = m0 + r, gi = p0 + c * EPC;
      const bool ok = gm < M && gi < K4;
      cp_async16(raw + sg * seg + c * 16, ok ? x + (size_t)gm * K + j * K4 + gi : x,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BM * 4 * chunks * EPC; i += THREADS) {
      const int e = i % (chunks * EPC), sg = i / (chunks * EPC), r = sg >> 2, j = sg & 3;
      const int gm = m0 + r, gi = p0 + e;
      reinterpret_cast<XT*>(raw + sg * seg)[e] =
          (gm < M && gi < K4) ? x[(size_t)gm * K + j * K4 + gi] : XT(0.f);
    }
  }
}

// q = clamp(rint(v / scale), -127, 127) as a byte: IEEE division, then
// round half to even (torch.round) by adding 1.5 * 2^23, which leaves the
// integer in the low mantissa bits. Clamping before rounding gives the same
// q for every finite v, since -127 and 127 are integers.
__device__ __forceinline__ uint32_t quant_byte(float v, float scale) {
  const float q = fminf(fmaxf(__fdiv_rn(v, scale), -127.f), 127.f);
  return __float_as_uint(q + 12582912.0f) & 0xffu;
}
__device__ __forceinline__ uint32_t quant4(const float* v, float scale) {
  return quant_byte(v[0], scale) | quant_byte(v[1], scale) << 8 |
         quant_byte(v[2], scale) << 16 | quant_byte(v[3], scale) << 24;
}

__device__ __forceinline__ float row_scale(float amax) { return fmaxf(amax, 1e-30f) / 127.0f; }

// Row scales from the raw x of the only pass (K4 <= PCAP; zero padding does
// not change a max): 128/BM consecutive threads share a row.
template <typename XT, int BM>
__device__ __forceinline__ void scales_from_raw(float* s_scale, const uint8_t* raw, int seg,
                                                int K4) {
  constexpr int TPR = THREADS / BM;
  const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int nv = cdiv(K4, 8);  // 8-element groups per plane
  float amax = 0.f;
  for (int v = sub; v < 4 * nv; v += TPR) {
    float e[8];
    load8(reinterpret_cast<const XT*>(raw + (r * 4 + v / nv) * seg) + (v % nv) * 8, e);
#pragma unroll
    for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(e[k]));
  }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (sub == 0) s_scale[r] = row_scale(amax);
}

// Row scales over all of K read from device memory, for K4 > PCAP (and K = 0).
template <typename XT, int BM>
__device__ __forceinline__ void scales_from_x(float* s_scale, const XT* __restrict__ x, int M,
                                              int K, int m0) {
  constexpr int TPR = THREADS / BM;
  const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR, gm = m0 + r;
  float amax = 0.f;
  if (gm < M)
    for (int k = sub; k < K; k += TPR) amax = fmaxf(amax, fabsf(to_f32(x[(size_t)gm * K + k])));
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (sub == 0) s_scale[r] = row_scale(amax);
}

// int8 A of a pass from its raw x: each thread takes one (row r, plane j)
// segment (BM = 16: two threads, alternate stages) and, per stage s, its 32
// packed rows, quantized with the row's scale into chunks 2j and 2j+1 of
// row r of stage s.
template <typename XT, int BM>
__device__ __forceinline__ void quantize_a(uint8_t* As, const float* s_scale, const uint8_t* raw,
                                           int seg, int nst) {
  constexpr int SEGS = BM * 4, TPS = SEGS >= THREADS ? 1 : THREADS / SEGS;
  for (int sg = threadIdx.x / TPS; sg < SEGS; sg += THREADS / TPS) {
    const int r = sg >> 2, j = sg & 3;
    const float sc = s_scale[r];
    const XT* src = reinterpret_cast<const XT*>(raw + sg * seg);
    for (int s = threadIdx.x % TPS; s < nst; s += TPS) {
      uint32_t w[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[8];
        load8(src + s * 32 + q * 8, v);
        w[2 * q] = quant4(v, sc);
        w[2 * q + 1] = quant4(v + 4, sc);
      }
      uint8_t* dst = As + s * BM * ROWB;
      *reinterpret_cast<uint4*>(dst + a_off(r, 2 * j)) = make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(dst + a_off(r, 2 * j + 1)) = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

// ---------------------------------------------------------------------------
// One stage of products: 4 planes = 4 mma k-steps over the warp's BM x 32.

// Four slab bytes of column n at rows r0..r3 as one word (byte k = row rk).
__device__ __forceinline__ uint32_t gather4(const uint8_t* Ws, int n, int r0, int r1, int r2,
                                            int r3) {
  return (uint32_t)Ws[w_off(r0, n)] | (uint32_t)Ws[w_off(r1, n)] << 8 |
         (uint32_t)Ws[w_off(r2, n)] << 16 | (uint32_t)Ws[w_off(r3, n)] << 24;
}

template <bool INT8, int MT, typename Acc>
__device__ __forceinline__ void compute_stage(const uint8_t* As, const uint8_t* Ws,
                                              Acc (&acc)[MT][4][4], int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // B words: bf16 rows (2t, 2t+1, 2t+8, 2t+9) = b0 | b1 of one plane;
  // int8 rows 4t..4t+3 (b0) and 16+4t..16+4t+3 (b1).
  uint32_t w0[4], w1[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = warp * 32 + nt * 8 + g;
    if constexpr (INT8) {
      w0[nt] = gather4(Ws, n, 4 * t, 4 * t + 1, 4 * t + 2, 4 * t + 3);
      w1[nt] = gather4(Ws, n, 16 + 4 * t, 17 + 4 * t, 18 + 4 * t, 19 + 4 * t);
    } else {
      w0[nt] = gather4(Ws, n, 2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9);
    }
  }
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lchunk = lane >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) ldmatrix_x4(a[mi], As + a_off(mi * 16 + lrow, 2 * j + lchunk));
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t b[2];
      if constexpr (INT8) {
        // code c in {0,1,2} per byte -> int8 c - 1, no borrow between bytes
        b[0] = (((w0[nt] >> (2 * j)) & 0x03030303u) + 0x7f7f7f7fu) ^ 0x80808080u;
        b[1] = (((w1[nt] >> (2 * j)) & 0x03030303u) + 0x7f7f7f7fu) ^ 0x80808080u;
      } else {
        // byte k of sel = (c << 4) | (c + 4): selects hi byte {BF,00,3F}[c]
        // and lo byte {80,00,80}[c] of bf16 {-1, 0, +1}
        const uint32_t sel = ((w0[nt] >> (2 * j)) & 0x03030303u) * 17u + 0x04040404u;
        b[0] = __byte_perm(0x003f00bfu, 0x00800080u, sel);
        b[1] = __byte_perm(0x003f00bfu, 0x00800080u, sel >> 16);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) mma(acc[mi][nt], a[mi], b);
    }
  }
}

// ---------------------------------------------------------------------------
// Epilogue: out[r, c] = acc * alpha (bf16) or (float)acc * scale[r] * alpha.

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(int v) { return (uint32_t)v; }

__device__ __forceinline__ float finish_bits(uint32_t b, float sc, float al, bool int8) {
  return int8 ? __fmul_rn(__fmul_rn(__int2float_rn((int)b), sc), al) : __uint_as_float(b) * al;
}

// Each warp passes its 16 x 32 output blocks through `stage` (16 rows of
// EP_LD words: the padding keeps both the fragment writes and the row reads
// free of bank conflicts) so that every store instruction writes 4 rows of
// 128 contiguous bytes, whole cache lines, instead of 16 rows of 32 bytes.
template <bool INT8, int MT, typename Acc>
__device__ __forceinline__ void store_tile(float* __restrict__ out, const Acc (&acc)[MT][4][4],
                                           const float* s_scale, float al, int M, int N,
                                           int m0, int n0, int warp, int lane,
                                           uint32_t* stage) {
  const int g = lane >> 2, t = lane & 3;
  const int col = n0 + warp * 32 + (lane & 7) * 4;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint2*>(stage + (g + 8 * h) * EP_LD + nt * 8 + 2 * t) =
            make_uint2(bits(acc[mi][nt][2 * h]), bits(acc[mi][nt][2 * h + 1]));
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lr = q * 4 + (lane >> 3), row = m0 + mi * 16 + lr;
      const uint4 v = *reinterpret_cast<const uint4*>(stage + lr * EP_LD + (lane & 7) * 4);
      const float sc = INT8 ? s_scale[mi * 16 + lr] : 0.f;
      const float4 o = make_float4(finish_bits(v.x, sc, al, INT8), finish_bits(v.y, sc, al, INT8),
                                   finish_bits(v.z, sc, al, INT8), finish_bits(v.w, sc, al, INT8));
      if (row < M) {
        float* p = out + (size_t)row * N + col;
        if ((N & 3) == 0) {
          if (col < N) *reinterpret_cast<float4*>(p) = o;
        } else {
          if (col < N) p[0] = o.x;
          if (col + 1 < N) p[1] = o.y;
          if (col + 2 < N) p[2] = o.z;
          if (col + 3 < N) p[3] = o.w;
        }
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// The kernel body shared by both products. flags: bit 0 = x vector path
// (K/4 % 8 == 0 and x 16-byte aligned), bit 1 = slab vector path (N % 16 == 0
// and packed 16-byte aligned).
//
// The CTA walks one stream of steps g = (chunk, stage); step g's loads are
// one cp.async group in ring slot g % NSLOT, requested AHEAD steps early (an
// empty group past the end keeps the count uniform), so at step g one wait
// for all but AHEAD-1 groups and one barrier make it readable and free the
// slot that step g + AHEAD overwrites.

// The loads of step g = (chunk g / steps, stage g % steps) into ring slot
// g % NSLOT, as one commit group (empty past the last step).
template <bool INT8, typename XT, int BM>
__device__ __forceinline__ void request_step(uint8_t* smem, int g, int total, int steps,
                                           const XT* __restrict__ x,
                                           const uint8_t* __restrict__ packed, int M, int K,
                                           int N, int m0, int nsplit, int flags) {
  constexpr int SR = Kind<INT8>::SR, A_SLOT = INT8 ? 0 : BM * ROWB;
  if (g < total) {
    const int ci = g / steps, s = g - ci * steps;
    uint8_t* slot = smem + (g % NSLOT) * (A_SLOT + SR * ROWB);
    if constexpr (!INT8) load_a_bf16<BM>(slot, x, M, K, m0, s * SR, flags & 1);
    load_slab<INT8>(slot + A_SLOT, packed, K >> 2, N, s * SR, ((int)blockIdx.y + ci * nsplit) * BN,
                    flags & 2);
  }
  cp_async_commit();
}

template <bool INT8, typename XT, int MT>
__device__ __forceinline__ void ternary_body(const XT* __restrict__ x,
                                             const uint8_t* __restrict__ packed,
                                             const float* __restrict__ alpha,
                                             float* __restrict__ out, int M, int K, int N,
                                             int flags) {
  using Acc = typename std::conditional<INT8, int, float>::type;
  constexpr int BM = 16 * MT, SR = Kind<INT8>::SR;
  constexpr int A_SLOT = INT8 ? 0 : BM * ROWB, SLOT = A_SLOT + SR * ROWB;
  extern __shared__ __align__(128) uint8_t smem[];
  const int K4 = K >> 2, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM, nsplit = gridDim.y, tiles_n = cdiv(N, BN);
  const bool xvec = flags & 1;
  const Layout L = layout<INT8>(BM, K4, sizeof(XT));
  uint8_t* Ares = smem + L.ares;
  uint8_t* raw = smem + L.raw;
  uint32_t* ep_stage = reinterpret_cast<uint32_t*>(smem + L.ep) + warp * 16 * EP_LD;
  float* s_scale = reinterpret_cast<float*>(smem + L.scale);
  const float al = *alpha;
  const int steps = cdiv(K4, SR), npass = cdiv(K4, PCAP);
  const int total = cdiv(tiles_n - (int)blockIdx.y, nsplit) * steps;  // stream steps

  if constexpr (INT8) {
    if (npass == 1) {
      load_raw_pass<XT, BM>(raw, L.seg, x, M, K, m0, 0, xvec);
      cp_async_commit();  // the oldest group
    } else {
      scales_from_x<XT, BM>(s_scale, x, M, K, m0);
    }
  }
  for (int g = 0; g < AHEAD; ++g)
    request_step<INT8, XT, BM>(smem, g, total, steps, x, packed, M, K, N, m0, nsplit, flags);

  Acc acc[MT][4][4];
  int g = 0;  // stream index of the next stage
  for (int tn = blockIdx.y; tn < tiles_n; tn += nsplit) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0;
    for (int s = 0; s < steps; ++s, ++g) {
      if constexpr (INT8) {
        constexpr int SPP = PCAP / SR;  // stages per pass
        if (s % SPP == 0 && (g == s || npass > 1)) {  // the int8 A of pass s / SPP
          if (npass == 1) {
            cp_async_wait(AHEAD);  // the raw x, the oldest group
            __syncthreads();
            scales_from_raw<XT, BM>(s_scale, raw, L.seg, K4);
          } else {
            __syncthreads();  // every warp is done with the last pass's A (and raw)
            load_raw_pass<XT, BM>(raw, L.seg, x, M, K, m0, s * SR, xvec);
            cp_async_commit();
            cp_async_wait(0);
          }
          __syncthreads();
          quantize_a<XT, BM>(Ares, s_scale, raw, L.seg, min(SPP, steps - s));
        }
      }
      cp_async_wait(AHEAD - 1);  // step g has landed
      __syncthreads();           // ... for every thread, and step g-1's slot is free
      request_step<INT8, XT, BM>(smem, g + AHEAD, total, steps, x, packed, M, K, N, m0, nsplit,
                               flags);
      const uint8_t* slot = smem + (g % NSLOT) * SLOT;
      compute_stage<INT8, MT>(INT8 ? Ares + (s % (PCAP / SR)) * BM * ROWB : slot, slot + A_SLOT,
                              acc, warp, lane);
    }
    __syncthreads();  // the scales of K == 0 are written
    store_tile<INT8, MT>(out, acc, s_scale, al, M, N, m0, tn * BN, warp, lane, ep_stage);
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 3)
    ternary_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                        const float* __restrict__ alpha, float* __restrict__ out, int M, int K,
                        int N, int flags) {
  ternary_body<false, __nv_bfloat16, MT>(x, packed, alpha, out, M, K, N, flags);
}

template <typename XT, int MT>
__global__ void __launch_bounds__(THREADS, 3)
    ternary_w2a8_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
                        const float* __restrict__ alpha, float* __restrict__ out, int M, int K,
                        int N, int flags) {
  ternary_body<true, XT, MT>(x, packed, alpha, out, M, K, N, flags);
}

// ---------------------------------------------------------------------------
// Host side

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n <= 0)
      n = 132;
    cached[device] = n;
  }
  return cached[device];
}

// Tiles of a launch: MT (BM = 16*MT; W2A8 takes 1 or 2) and the number of
// CTAs along N. mt/nsplit > 0 are taken as given (clamped to what the
// kernel takes).
void plan(bool int8, int M, int K, int N, int device, int* mt, int* nsplit) {
  const int S = sm_count(device), tiles_n = cdiv(N, BN);
  if (*mt != 1 && *mt != 2 && *mt != 4) {
    if (int8) {
      // W2A8 quantizes a row block once per CTA: 16 rows keep 2-3 CTAs per
      // SM (the raw x and int8 A fit) unless there are 4+ chunks to share it
      *mt = tiles_n >= 4 ? 2 : 1;
    } else {
      *mt = 1;
      for (int m = 4; m > 1 && *mt == 1; m /= 2)
        if ((long long)cdiv(M, 16 * m) * tiles_n >= S) *mt = m;
    }
  }
  if (int8 && *mt > 2) *mt = 2;
  if (*nsplit <= 0) {
    *nsplit = tiles_n;
    if (int8 && (K >> 2) <= PCAP) {
      // fewer chunks per CTA re-quantize x less; keep at least one CTA per SM
      const long long rows = cdiv(M, 16 * *mt);
      for (int ns = 1; ns < tiles_n; ns *= 2) {
        if (rows * ns >= S) { *nsplit = ns; break; }
      }
    }
  }
  if (*nsplit > tiles_n) *nsplit = tiles_n;
  if (*nsplit < 1) *nsplit = 1;
}

// Raise the kernel's dynamic shared-memory limit once per device to what the
// launch needs (above 48 KB it must be asked for).
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int* set_bytes, int device, size_t smem) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if ((int)smem <= set_bytes[device]) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) set_bytes[device] = (int)smem;
  return err;
}

template <int MT>
cudaError_t launch_bf16(const void* x, const void* packed, const void* alpha, void* out, int M,
                        int K, int N, int nsplit, int flags, int device, cudaStream_t stream) {
  static int set_bytes[64] = {0};
  const size_t smem = layout<false>(16 * MT, K >> 2, 2).bytes;
  cudaError_t err = allow_smem(ternary_bf16_kernel<MT>, set_bytes, device, smem);
  if (err != cudaSuccess) return err;
  ternary_bf16_kernel<MT><<<dim3((unsigned)cdiv(M, 16 * MT), (unsigned)nsplit), THREADS, smem,
                            stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(alpha), static_cast<float*>(out), M, K, N, flags);
  return cudaGetLastError();
}

template <typename XT, int MT>
cudaError_t launch_w2a8(const void* x, const void* packed, const void* alpha, void* out, int M,
                        int K, int N, int nsplit, int flags, int device, cudaStream_t stream) {
  static int set_bytes[64] = {0};
  const size_t smem = layout<true>(16 * MT, K >> 2, sizeof(XT)).bytes;
  cudaError_t err = allow_smem(ternary_w2a8_kernel<XT, MT>, set_bytes, device, smem);
  if (err != cudaSuccess) return err;
  ternary_w2a8_kernel<XT, MT><<<dim3((unsigned)cdiv(M, 16 * MT), (unsigned)nsplit), THREADS,
                                smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(alpha), static_cast<float*>(out), M, K, N, flags);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_w2a8(int mt, const void* x, const void* packed, const void* alpha,
                          void* out, int M, int K, int N, int nsplit, int flags, int device,
                          cudaStream_t stream) {
  switch (mt) {
    case 2: return launch_w2a8<XT, 2>(x, packed, alpha, out, M, K, N, nsplit, flags, device, stream);
    default: return launch_w2a8<XT, 1>(x, packed, alpha, out, M, K, N, nsplit, flags, device, stream);
  }
}

}  // namespace

extern "C" {

// out[M,N] (f32) = bf16 x[M,K] @ unpack_planar(packed[K/4,N]) * alpha[0].
// mt, nsplit: tiles (0 = the plan's choice); flags: see ternary_body.
int ternary_matmul_bf16(const void* x, const void* packed, const void* alpha, void* out, int M,
                        int K, int N, int mt, int nsplit, int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  plan(false, M, K, N, device, &mt, &nsplit);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mt) {
    case 4: err = launch_bf16<4>(x, packed, alpha, out, M, K, N, nsplit, flags, device, st); break;
    case 2: err = launch_bf16<2>(x, packed, alpha, out, M, K, N, nsplit, flags, device, st); break;
    default: err = launch_bf16<1>(x, packed, alpha, out, M, K, N, nsplit, flags, device, st); break;
  }
  return (int)err;
}

// out[M,N] (f32) = (int32 q[M,K] @ unpack_planar(packed)) * scale[m] * alpha,
// with q, scale the per-row int8 quantization of x (bf16, or f32 when
// x_f32), computed inside the launch.
int ternary_matmul_w2a8(const void* x, int x_f32, const void* packed, const void* alpha,
                        void* out, int M, int K, int N, int mt, int nsplit, int flags,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  plan(true, M, K, N, device, &mt, &nsplit);
  const cudaStream_t st = (cudaStream_t)stream;
  err = x_f32 ? dispatch_w2a8<float>(mt, x, packed, alpha, out, M, K, N, nsplit, flags, device, st)
              : dispatch_w2a8<__nv_bfloat16>(mt, x, packed, alpha, out, M, K, N, nsplit, flags,
                                             device, st);
  return (int)err;
}

// The tiles a launch of this shape takes: plan[0] = MT (BM = 16*MT rows per
// CTA), plan[1] = CTAs along N, plan[2] = CTAs in all, plan[3] = dynamic
// shared memory in bytes (W2A8: for bf16 x).
int ternary_matmul_plan(int int8, int M, int K, int N, int device, int* out4) {
  int mt = 0, nsplit = 0;
  plan(int8 != 0, M, K, N, device, &mt, &nsplit);
  out4[0] = mt;
  out4[1] = nsplit;
  out4[2] = cdiv(M, 16 * mt) * nsplit;
  out4[3] = int8 ? layout<true>(16 * mt, K >> 2, 2).bytes : layout<false>(16 * mt, K >> 2, 2).bytes;
  return 0;
}

const char* onebit_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

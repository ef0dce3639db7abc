// CTC alpha and beta lattice recursions for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of onebit_asr_tpu/ops/ctc_pallas.py:
//   ctc_alpha_fwd  <- ctc_alpha_pallas (:194), body _alpha_kernel (:97-114)
//   ctc_beta_bwd   <- ctc_beta_pallas  (:201), body _beta_kernel  (:117-151)
// both reached through _grid_lattice_call (:154-190). Given the emissions
// emit[b, t, s] = log p_t(z_s) of the extended label sequence z (S = 2U+1),
// alpha computes, in log space,
//   alpha_0 = init;  alpha_t(s) = lae3(alpha_{t-1}(s), alpha_{t-1}(s-1),
//                                      skip(s) ? alpha_{t-1}(s-2) : NEG) + emit_t(s)
// kept frozen (alpha_t = alpha_{t-1}) where t >= len, and beta, backwards,
//   beta_{T-1} = init;  y = emit_{t+1} + beta_{t+1};
//   beta_t(s) = lae3(y(s), y(s+1), skip(s+2) ? y(s+2) : NEG)
// replaced by init where t > len-2. The whole lattice [B, T, S] is written.
// Arithmetic as the TPU kernels' and the plain versions': NEG = -1e30 is a
// value; lae3(a, b, c) = m + log(exp(a-m) + exp(b-m) + exp(c-m)), m = max,
// summed left to right, NEG where m <= NEG; expf/logf without fast math. So
// both kernels equal the plain versions bit for bit (the card tests hold
// that at every variant boundary). Writing the largest term's exp(0) as 1
// gives the same bits but was slower (selects on the chain).
//
// Layout: emit and out are [B, T, S] f32 (batch-major; the TPU kernels take
// [T, B, S]), lens [B] int32 or int64 (lens_64), skip [B, S] bytes (bool or
// uint8; nonzero = may skip from s-2), init [B, S] f32.
//
// What bounds it: the function reads the emission rows its lengths need
// and writes the lattice once: at the training path's shapes (B=48, T=256,
// S=97) at most 2*B*T*S*4 = 9.5 MB, 2.8 us at 3.35 TB/s; the arithmetic
// (3 expf + 1 logf + ~6 adds a state and step) is negligible. The time is
// set by the recursion: T-1 dependent steps per utterance, each needing the
// whole previous row, so the floor is (T-1) x one step's chain: the
// neighbours' values (a shuffle, ~30 cycles), 2 fmax, a subtract, expf
// (~8 dependent instructions with one MUFU), two adds, logf (~20 dependent
// FMA-pipe instructions), an add, a select, an add: ~35 dependent
// instructions, ~200-250 cycles, plus a barrier where the utterance spans
// warps. The lanes of a warp issue in lockstep, so K states a lane add K
// times the chain's ~70 instructions to each step: measured on an H100
// (scripts/ctc_probe.py, S=97), 4 states a lane on one warp took 0.50 us a
// step, 2 on two warps 0.32, 1 on four warps 0.21-0.23 (~420-460 cycles
// at the 1,980 MHz boost clock).
//
// Design:
//   - one block per utterance, one state a lane (the lane's state s0 = 32 x
//     warp + lane) on ceil(S/32) warps up to S = 1,024 (the training path's
//     S = 97: 4 warps; LibriSpeech's ceiling S = 457: 15), so each warp
//     issues one chain a step. Larger S (no ASR label sequence is that
//     long) take 32 contiguous states a lane on up to 16 warps (S <=
//     16,384), whose steps are issue-bound. Each is its own template
//     instance; the K-state code serves any K (the probe builds 2 and 4).
//   - neighbours by shuffle: s-1 and s-2 from lanes l-1, l-2 (alpha), s+1
//     and s+2 from l+1, l+2 (beta) with __shfl_up_sync / __shfl_down_sync;
//     across a warp boundary the warp's two edge states go through shared
//     memory, double buffered by step parity, under one named barrier
//     (bar.sync 1) of the utterance's warps a step.
//   - emissions fetched D = 8 steps ahead (3 at 32 states a lane, for
//     shared memory) into a shared-memory ring with cp.async 4-byte copies
//     (rows of S = 97 floats are not 16-byte aligned). Each lane copies and
//     later reads only its own states, so cp.async.wait_group alone orders
//     the two: no barrier. A shared ring and not a register ring: its slot
//     is a run-time index, so the time loop needs no unrolling by D. A step
//     reads the next step's row into registers after its exchange, while
//     its own chain runs, and refills the slot of its own row after its
//     chain has consumed it (the probe: a read at the step's start or end
//     put the wait and the load on the chain). Only the rows the lengths
//     need are fetched; padding states (s >= S) get zeros.
//   - the frozen rows without the recursion: alpha's rows t >= len are
//     copies of row len-1, beta's rows t > len-2 the init row: stores only.
//   - each lattice row stored as it is made (K 4-byte stores a lane; the
//     stores do not wait on anything). Beta's time loop is unrolled by 2
//     (~6% faster on the card; alpha's is faster without).
//
// Each entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 227 * 1024;  // dynamic shared memory a block may use
constexpr int MAX_STATES = 16384;     // 32 states a lane on 16 warps

// emission rows in flight: the ring's depth
__host__ __device__ constexpr int ring_depth(int K) { return K <= 4 ? 8 : 3; }

__device__ __forceinline__ float lat_exp(float x) { return expf(x); }
__device__ __forceinline__ float lat_log(float x) { return logf(x); }

// lae3(a, b, c), as the plain versions compute it (branch free, so the K
// chains of a lane interleave)
__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float sum = (lat_exp(a - m) + lat_exp(b - m)) + lat_exp(c - m);
  return m <= NEG_INF ? NEG_INF : m + lat_log(sum);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the lane's K states of emission row `row` into its ring slot; zeros past S
template <int K>
__device__ __forceinline__ void fetch_row(float* slot, const float* e, int row, int s0, int S) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = s0 + k;
    const float* src = e + (size_t)row * S + (s < S ? s : S - 1);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(slot + s)), "l"(src), "r"(s < S ? 4 : 0) : "memory");
  }
}

__device__ __forceinline__ void fetch_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the oldest group in flight has landed (D - 1 younger ones may not have)
template <int N>
__device__ __forceinline__ void fetch_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int K>
__device__ __forceinline__ void read_k(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
    }
  } else if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

template <int K>
__device__ __forceinline__ void store_row(float* row, const float (&v)[K], int s0, int S) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (s0 + k < S) row[s0 + k] = v[k];
}

__device__ __forceinline__ float lane_up(float v, int d) { return __shfl_up_sync(FULL, v, d); }
__device__ __forceinline__ float lane_down(float v, int d) { return __shfl_down_sync(FULL, v, d); }

__device__ __forceinline__ void warps_sync(int nwarps) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(nwarps * 32) : "memory");
}

// (s0-1, s0-2) of row `a`: from lanes below by shuffle, across a warp
// boundary from the two top states of the warp below through `edge`
// ([2][nwarps][2], by step parity), NEG below state 0
template <int K>
__device__ __forceinline__ void from_below(const float (&a)[K], float& p1, float& p2,
                                           float* edge, int nwarps, int warp, int lane,
                                           int parity) {
  p1 = lane_up(a[K - 1], 1);
  p2 = K == 1 ? lane_up(a[0], 2) : lane_up(a[K - 2], 1);
  if (nwarps > 1) {
    float* mine = edge + (parity * nwarps + warp) * 2;
    if (K == 1 && lane >= 30) mine[lane - 30] = a[0];
    if (K > 1 && lane == 31) mine[0] = a[K - 2], mine[1] = a[K - 1];
    warps_sync(nwarps);
    if (warp > 0 && lane == 0) p2 = mine[-2], p1 = mine[-1];
    if (warp > 0 && K == 1 && lane == 1) p2 = mine[-1];
  }
  if (warp == 0 && lane == 0) p1 = NEG_INF;
  if (warp == 0 && (lane == 0 || (K == 1 && lane == 1))) p2 = NEG_INF;
}

// (s0+K, s0+K+1) of row `y`: from lanes above by shuffle, across a warp
// boundary from the two bottom states of the warp above through `edge`,
// NEG above the last warp (whose padding states hold NEG anyway)
template <int K>
__device__ __forceinline__ void from_above(const float (&y)[K], float& n1, float& n2,
                                           float* edge, int nwarps, int warp, int lane,
                                           int parity) {
  n1 = lane_down(y[0], 1);
  n2 = K == 1 ? lane_down(y[0], 2) : lane_down(y[1], 1);
  const bool top = warp + 1 == nwarps;
  if (nwarps > 1) {
    float* mine = edge + (parity * nwarps + warp) * 2;
    if (K == 1 && lane < 2) mine[lane] = y[0];
    if (K > 1 && lane == 0) mine[0] = y[0], mine[1] = y[1];
    warps_sync(nwarps);
    if (!top && lane == 31) n1 = mine[2], n2 = mine[3];
    if (!top && K == 1 && lane == 30) n2 = mine[2];
  }
  if (top && lane == 31) n1 = NEG_INF;
  if (top && (lane == 31 || (K == 1 && lane == 30))) n2 = NEG_INF;
}

__device__ __forceinline__ int active_rows(const void* lens, int lens_64, int b, int T) {
  const long long len = lens_64 ? static_cast<const long long*>(lens)[b]
                                : static_cast<const int*>(lens)[b];
  return len < 1 ? 1 : (len > T ? T : (int)len);
}

template <int K>
__global__ void __launch_bounds__(K <= 4 ? 1024 : 512)
ctc_alpha_kernel(const float* __restrict__ emit, const void* __restrict__ lens, int lens_64,
                 const uint8_t* __restrict__ skip, const float* __restrict__ init,
                 float* __restrict__ out, int T, int S) {
  constexpr int D = ring_depth(K);
  extern __shared__ __align__(16) float smem[];
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Sp = nwarps * 32 * K;
  float* ring = smem;            // [D][Sp] emission rows
  float* edge = smem + D * Sp;   // [2][nwarps][2] warp-boundary states
  const size_t b = blockIdx.x;
  const float* e = emit + b * T * S;
  float* o = out + b * T * S;
  const int s0 = (warp * 32 + lane) * K;
  // rows 1 .. rows-1 are recursive; rows rows .. T-1 copy row rows-1
  const int rows = active_rows(lens, lens_64, (int)b, T);

  float a[K];
  bool sk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = s0 + k;
    a[k] = s < S ? init[b * S + s] : NEG_INF;
    sk[k] = s >= 2 && s < S && skip[b * S + s] != 0;
  }
  store_row<K>(o, a, s0, S);
  // row r in slot r % D, fetched D steps ahead. Each step reads the next
  // step's row into registers while its own chain runs, and refills its own
  // row's slot once the chain has consumed it.
#pragma unroll
  for (int r = 1; r <= D; ++r) {
    if (r < rows) fetch_row<K>(ring + (r % D) * Sp, e, r, s0, S);
    fetch_commit();
  }
  float en[K];
  fetch_wait<D - 1>();
  read_k<K>(ring + (1 % D) * Sp + s0, en);
  for (int t = 1; t < rows; ++t) {
    float p1, p2;
    from_below<K>(a, p1, p2, edge, nwarps, warp, lane, t & 1);
    fetch_wait<D - 2>();
    float next[K];
    read_k<K>(ring + ((t + 1) % D) * Sp + s0, next);
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {  // downwards: a[k-1], a[k-2] still row t-1
      const float a1 = k >= 1 ? a[k - 1] : p1;
      const float a2 = sk[k] ? (k >= 2 ? a[k - 2] : (k == 1 ? p1 : p2)) : NEG_INF;
      a[k] = logaddexp3(a[k], a1, a2) + en[k];
      en[k] = next[k];
    }
    store_row<K>(o + (size_t)t * S, a, s0, S);
    if (t + D < rows) fetch_row<K>(ring + (t % D) * Sp, e, t + D, s0, S);
    fetch_commit();
  }
  for (int t = rows; t < T; ++t) store_row<K>(o + (size_t)t * S, a, s0, S);
}

template <int K>
__global__ void __launch_bounds__(K <= 4 ? 1024 : 512)
ctc_beta_kernel(const float* __restrict__ emit, const void* __restrict__ lens, int lens_64,
                const uint8_t* __restrict__ skip, const float* __restrict__ init,
                float* __restrict__ out, int T, int S) {
  constexpr int D = ring_depth(K);
  extern __shared__ __align__(16) float smem[];
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Sp = nwarps * 32 * K;
  float* ring = smem;            // [D][Sp] emission rows, by step
  float* edge = smem + D * Sp;   // [2][nwarps][2] warp-boundary states
  const size_t b = blockIdx.x;
  const float* e = emit + b * T * S;
  float* o = out + b * T * S;
  const int s0 = (warp * 32 + lane) * K;
  // rows rows-1 .. T-1 are the init row; rows rows-2 .. 0 are recursive
  const int rows = active_rows(lens, lens_64, (int)b, T);

  float bt[K];
  bool sk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = s0 + k;
    bt[k] = s < S ? init[b * S + s] : NEG_INF;
    sk[k] = s + 2 < S && skip[b * S + s + 2] != 0;  // skip into s+2
  }
  for (int t = rows - 1; t < T; ++t) store_row<K>(o + (size_t)t * S, bt, s0, S);
  // step i makes row t = rows-2-i from emission row t+1 = rows-1-i, which
  // sits in slot i % D, fetched and read as alpha fetches and reads its rows
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (rows - 1 - j >= 1) fetch_row<K>(ring + j * Sp, e, rows - 1 - j, s0, S);
    fetch_commit();
  }
  float en[K];
  fetch_wait<D - 1>();
  read_k<K>(ring + s0, en);
#pragma unroll 2
  for (int i = 0; i < rows - 1; ++i) {
    const int t = rows - 2 - i;
    float y[K];
#pragma unroll
    for (int k = 0; k < K; ++k) y[k] = en[k] + bt[k];  // emit_{t+1} + beta_{t+1}
    float n1, n2;
    from_above<K>(y, n1, n2, edge, nwarps, warp, lane, i & 1);
    fetch_wait<D - 2>();
    read_k<K>(ring + ((i + 1) % D) * Sp + s0, en);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float y1 = k + 1 < K ? y[k + 1] : n1;
      const float y2 = sk[k] ? (k + 2 < K ? y[k + 2] : (k + 2 == K ? n1 : n2)) : NEG_INF;
      bt[k] = logaddexp3(y[k], y1, y2);
    }
    store_row<K>(o + (size_t)t * S, bt, s0, S);
    if (rows - 1 - (i + D) >= 1) fetch_row<K>(ring + (i % D) * Sp, e, rows - 1 - (i + D), s0, S);
    fetch_commit();
  }
}

typedef void (*LatticeKernel)(const float*, const void*, int, const uint8_t*, const float*,
                              float*, int, int);

// the variant for S: states a lane and warps an utterance
struct Variant {
  int K, warps;
};

Variant variant(int S) {
  if (S <= 1024) return {1, (S + 31) / 32};
  return {32, (S + 1023) / 1024};
}

// the emission ring and the warp-boundary slots
size_t shared_bytes(Variant v) {
  return ((size_t)ring_depth(v.K) * 32 * v.K * v.warps + 4 * (size_t)v.warps) * sizeof(float);
}

int launch(bool beta, const void* emit, const void* lens, int lens_64, const void* skip,
           const void* init, void* out, int B, int T, int S, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || T < 1 || S < 1 || S > MAX_STATES) return (int)cudaErrorInvalidValue;
  const Variant v = variant(S);
  LatticeKernel kernel;
  switch (v.K) {
    case 1: kernel = beta ? ctc_beta_kernel<1> : ctc_alpha_kernel<1>; break;
    default: kernel = beta ? ctc_beta_kernel<32> : ctc_alpha_kernel<32>; break;
  }
  const size_t smem = shared_bytes(v);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)B, (unsigned)(32 * v.warps), smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(emit), lens, lens_64, static_cast<const uint8_t*>(skip),
      static_cast<const float*>(init), static_cast<float*>(out), T, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[B,T,S] = the forward lattice of emit[B,T,S]; lens [B] int32 (lens_64
// = 0) or int64 (1), skip [B,S] bytes, init [B,S] = alpha_0.
int ctc_alpha_fwd(const void* emit, const void* lens, int lens_64, const void* skip,
                  const void* init, void* out, int B, int T, int S, int device, void* stream) {
  return launch(false, emit, lens, lens_64, skip, init, out, B, T, S, device, stream);
}

// out[B,T,S] = the reverse lattice; init [B,S] = beta_{T-1}.
int ctc_beta_bwd(const void* emit, const void* lens, int lens_64, const void* skip,
                 const void* init, void* out, int B, int T, int S, int device, void* stream) {
  return launch(true, emit, lens, lens_64, skip, init, out, B, T, S, device, stream);
}

// states a lane and warps an utterance of the variant that takes S, and the
// dynamic shared bytes of its block (cudaErrorInvalidValue beyond MAX_STATES)
int ctc_lattice_plan(int S, int* plan) {
  if (S < 1 || S > MAX_STATES) return (int)cudaErrorInvalidValue;
  const Variant v = variant(S);
  plan[0] = v.K;
  plan[1] = v.warps;
  plan[2] = (int)shared_bytes(v);
  return 0;
}

}  // extern "C"

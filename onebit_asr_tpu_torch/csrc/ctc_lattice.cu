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
// Arithmetic as the TPU kernels': NEG = -1e30 is a value; lae3(a, b, c) =
// m + log(exp(a-m) + exp(b-m) + exp(c-m)), m = max, summed left to right,
// NEG where m <= NEG; expf/logf without fast math.
//
// Layout: emit and out are [B, T, S] f32 (batch-major; the TPU kernels take
// [T, B, S]), lens [B] int32, skip [B, S] uint8 (1 = may skip from s-2),
// init [B, S] f32.
//
// What bounds it: the function reads the emissions once and writes the
// lattice once, 2*B*T*S*4 bytes: at the training path's shapes (T=256,
// B=48, S=97) 9.5 MB, 2.8 us at 3.35 TB/s; the arithmetic is negligible. The
// kernel is nowhere near that: each utterance's recursion is T-1 dependent
// steps, and every step needs the whole previous row, so the time is
// (T-1) x (latency of one step: a shared-memory read, 3 expf + 1 logf per
// state, a shared-memory write, one barrier). The B utterances run in
// parallel, one block each.
//
// Design (simple and right first; speed is later work):
//   - one block per utterance; the S states strided over the threads (NPER
//     per thread: 4 up to S = 4096, with 32..1024 threads; 32 beyond), each
//     thread keeping its states' current values, skip flags and next
//     emissions in registers, so any S whose two rows fit shared memory
//     (S <= 29056) runs;
//   - the row the next step reads (alpha_t, or y for beta) double-buffered
//     in shared memory: one barrier per time step;
//   - the next step's emission row loaded before the barrier;
//   - the lattice row stored to device memory as it is made, coalesced.
//
// Each entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 227 * 1024;   // dynamic shared memory a block may use
constexpr int SMALL_NPER = 4;          // states per thread up to S = 4096
constexpr int LARGE_NPER = 32;         // beyond: at most 908 threads

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (m <= NEG_INF) return NEG_INF;
  const float sum = (expf(a - m) + expf(b - m)) + expf(c - m);
  return m + logf(sum);
}

template <int NPER>
__global__ void __launch_bounds__(1024)
ctc_alpha_kernel(const float* __restrict__ emit, const int* __restrict__ lens,
                 const uint8_t* __restrict__ skip, const float* __restrict__ init,
                 float* __restrict__ out, int T, int S) {
  extern __shared__ float rows[];  // [2][S]: alpha_{t-1} and alpha_t
  const size_t b = blockIdx.x;
  const float* e = emit + b * T * S;
  float* o = out + b * T * S;
  const int len = lens[b];
  float a[NPER], en[NPER];
  bool sk[NPER];
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int s = threadIdx.x + j * blockDim.x;
    a[j] = NEG_INF;
    en[j] = 0.0f;
    sk[j] = false;
    if (s < S) {
      a[j] = init[b * S + s];
      sk[j] = s >= 2 && skip[b * S + s] != 0;
      rows[s] = a[j];
      o[s] = a[j];
      if (T > 1) en[j] = e[S + s];
    }
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float* prev = rows + ((t - 1) & 1) * S;
    float* cur = rows + (t & 1) * S;
    const bool active = t < len;  // the same for the whole block
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      const int s = threadIdx.x + j * blockDim.x;
      if (s < S) {
        if (active) {
          const float a1 = s >= 1 ? prev[s - 1] : NEG_INF;
          const float a2 = sk[j] ? prev[s - 2] : NEG_INF;
          a[j] = logaddexp3(a[j], a1, a2) + en[j];
        }
        cur[s] = a[j];
        o[(size_t)t * S + s] = a[j];
        if (t + 1 < T) en[j] = e[(size_t)(t + 1) * S + s];
      }
    }
    __syncthreads();
  }
}

template <int NPER>
__global__ void __launch_bounds__(1024)
ctc_beta_kernel(const float* __restrict__ emit, const int* __restrict__ lens,
                const uint8_t* __restrict__ skip, const float* __restrict__ init,
                float* __restrict__ out, int T, int S) {
  extern __shared__ float rows[];  // [2][S]: y = emit_{t+1} + beta_{t+1}
  const size_t b = blockIdx.x;
  const float* e = emit + b * T * S;
  float* o = out + b * T * S;
  const int len = lens[b];
  float bt[NPER], bi[NPER], en[NPER];
  bool sk[NPER];
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int s = threadIdx.x + j * blockDim.x;
    bi[j] = NEG_INF;
    en[j] = 0.0f;
    sk[j] = false;
    if (s < S) {
      bi[j] = init[b * S + s];
      // skip into s+2, never from the last two columns
      sk[j] = s + 2 < S && skip[b * S + s + 2] != 0;
      o[(size_t)(T - 1) * S + s] = bi[j];
      if (T > 1) en[j] = e[(size_t)(T - 1) * S + s];
    }
    bt[j] = bi[j];
  }
  for (int i = 0; i < T - 1; ++i) {
    const int t = T - 2 - i;
    float* yb = rows + (i & 1) * S;
    float y[NPER];
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      const int s = threadIdx.x + j * blockDim.x;
      y[j] = en[j] + bt[j];
      if (s < S) {
        yb[s] = y[j];
        if (t >= 1) en[j] = e[(size_t)t * S + s];
      }
    }
    __syncthreads();
    const bool active = t <= len - 2;  // the same for the whole block
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      const int s = threadIdx.x + j * blockDim.x;
      if (s < S) {
        if (active) {
          const float y1 = s + 1 < S ? yb[s + 1] : NEG_INF;
          const float y2 = sk[j] ? yb[s + 2] : NEG_INF;
          bt[j] = logaddexp3(y[j], y1, y2);
        } else {
          bt[j] = bi[j];
        }
        o[(size_t)t * S + s] = bt[j];
      }
    }
  }
}

typedef void (*LatticeKernel)(const float*, const int*, const uint8_t*, const float*,
                              float*, int, int);

int launch(LatticeKernel small, LatticeKernel large, const void* emit, const void* lens,
           const void* skip, const void* init, void* out, int B, int T, int S,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 2 * (size_t)S * sizeof(float);
  if (B < 1 || T < 1 || S < 1 || smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int nper = S <= SMALL_NPER * 1024 ? SMALL_NPER : LARGE_NPER;
  const LatticeKernel kernel = nper == SMALL_NPER ? small : large;
  const int threads = ((S + nper - 1) / nper + 31) / 32 * 32;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)B, (unsigned)threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(emit), static_cast<const int*>(lens),
      static_cast<const uint8_t*>(skip), static_cast<const float*>(init),
      static_cast<float*>(out), T, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[B,T,S] = the forward lattice of emit[B,T,S]; lens [B] int32,
// skip [B,S] uint8, init [B,S] = alpha_0.
int ctc_alpha_fwd(const void* emit, const void* lens, const void* skip, const void* init,
                  void* out, int B, int T, int S, int device, void* stream) {
  return launch(ctc_alpha_kernel<SMALL_NPER>, ctc_alpha_kernel<LARGE_NPER>, emit, lens,
                skip, init, out, B, T, S, device, stream);
}

// out[B,T,S] = the reverse lattice; init [B,S] = beta_{T-1}.
int ctc_beta_bwd(const void* emit, const void* lens, const void* skip, const void* init,
                 void* out, int B, int T, int S, int device, void* stream) {
  return launch(ctc_beta_kernel<SMALL_NPER>, ctc_beta_kernel<LARGE_NPER>, emit, lens,
                skip, init, out, B, T, S, device, stream);
}

}  // extern "C"

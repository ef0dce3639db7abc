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
// tensor reaches device memory. For training it also writes each row's max
// and sum (f32 [B, H, T]), which the backward (csrc/attention_bwd.cu) reads
// in place of recomputing them.
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
// Design (csrc/attention_rows.cuh, modes M_OUT and M_OUT | M_STATS_OUT):
//   - one CTA of 4 warps per (64 query rows, h, b), two CTAs per SM
//     (110 KB of shared memory and ~246 registers a thread at dh = 64);
//     each warp keeps its 16 rows of qu and qv as mma A fragments in
//     registers; q, u and vb are staged by cp.async and converted in
//     shared memory;
//   - the keys in tiles of 64, twice: `_fwd_kernel` rounds the normalised
//     probabilities to bf16 before `@ v`, so FlashAttention's deferred
//     normalisation would round elsewhere. Pass 1 gives each row's max and
//     sum (online, f32), pass 2 forms bf16(dropout(exp(s - m) / l)) and
//     accumulates P v in f32 registers;
//   - k, v, the key mask, the dropout bytes of the tile and its new block
//     of the p band stream through a double-buffered cp.async stage and a
//     4-slot ring of p blocks (one 64-row block a tile; two at each pass's
//     start); every fragment comes from row-major padded tiles by ldmatrix
//     (v by .trans), no transposed copy, no scalar fragment load;
//   - the skew: each warp multiplies its qv rows by the 80 band rows they
//     reach and writes the product, shifted by row, into its own f32
//     scratch, from which it reads bd in the layout of the scores;
//   - products on mma.sync m16n8k16 bf16 -> f32; the score sum and scale
//     round as the plain version does (__fadd_rn, then __fmul_rn: no FMA
//     contraction); expf, not __expf, and the IEEE quotient (sm_div: each
//     row's reciprocal taken once, then an FMA correction; the divide's
//     slow path had cost a quarter of the launch);
//   - key columns past T (the ragged last tile) drop out of the max and the
//     sum entirely; masked keys inside [0, T) take -1e9 and still count, so
//     an all-pad row comes out as uniform 1/T, as in JAX.
//
// The entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not
// take: dh outside [1, 64], a drop threshold outside [0, 255]).

#include "attention_rows.cuh"

extern "C" {

// out[B,H,T,dh] (bf16) = rel-pos attention of q/k/v [B,H,T,dh], p [H,2T-1,dh],
// u/vb [H,dh] (all bf16, contiguous, 16-byte aligned), key_mask [B,T] f32,
// drop8 [B,H,T,T] uint8 (read only when drop_k > 0; drop_scale =
// 256/(256-drop_k) as f32). With stat_m and stat_l (f32 [B,H,T], or both
// null), also each row's max and sum of exp(s - max).
int fused_relpos_attention_fwd(const void* q, const void* k, const void* v, const void* p,
                               const void* u, const void* vb, const void* key_mask,
                               const void* drop8, void* out, void* stat_m, void* stat_l, int B,
                               int H, int T, int dh, float scale, int drop_k, float drop_scale,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || H < 1 || T < 1 || dh < 1 || dh > 64 || drop_k < 0 || drop_k > 255 ||
      (stat_m == nullptr) != (stat_l == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  RowsArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.p = static_cast<const bf16*>(p);
  a.u = static_cast<const bf16*>(u);
  a.vb = static_cast<const bf16*>(vb);
  a.key_mask = static_cast<const float*>(key_mask);
  a.drop8 = static_cast<const uint8_t*>(drop8);
  a.g = nullptr;
  a.out = static_cast<bf16*>(out);
  a.m = static_cast<float*>(stat_m);
  a.l = static_cast<float*>(stat_l);
  a.rowdot = nullptr;
  a.B = B, a.H = H, a.T = T, a.dh = dh;
  a.scale = scale, a.drop_k = drop_k, a.drop_scale = drop_scale;
  const cudaStream_t s = (cudaStream_t)stream;
  return stat_m ? launch_rows_dh<M_OUT | M_STATS_OUT>(a, s) : launch_rows_dh<M_OUT>(a, s);
}

}  // extern "C"

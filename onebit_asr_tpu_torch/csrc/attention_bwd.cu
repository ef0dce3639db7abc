// Fused relative-position attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel onebit_asr_tpu/ops/attention.py:165
// (_bwd_kernel, :165-232; entry _fa_bwd :299, pallas_call :306). For each
// (b, h), from the forward's inputs and the cotangent g:
//   s, attn      as the forward (csrc/attention.cu): f32 scores, softmax
//   attn_d       = keep ? attn * inv : 0                  (inv = 256/(256-k))
//   dv           = bf16(attn_d)^T g                       (f32 sums)
//   dattn        = keep ? (g v^T) * inv : 0
//   rowdot[t]    = sum_s dattn * attn      (attn before dropout, f32)
//   ds           = attn * (dattn - rowdot) * scale        (f32)
//   ds_c         = bf16(ds); dbraw[t, T-1-t+s] = ds_c[t, s] (the skew's adjoint)
//   dq           = bf16(ds_c k + dbraw p)   (the two f32 sums added, rounded once)
//   dk           = bf16(ds_c^T qu), qu = bf16(q + u)
//   dp           = sum_b dbraw^T qv;  du = sum_b,t ds_c k;  dvb = sum_b,t dbraw p
// in the order of operations and roundings of the plain version
// (ops/attention.py::fused_relpos_attention_bwd_reference). No [T, T]-or-
// wider tensor reaches device memory.
//
// What bounds it: at the train step's shape of Conformer-M (B=16, H=4,
// T=256, dh=64) the function needs eight products of 2*T*T*dh per (b, h)
// (qu k^T, the skewed band of qv p^T, g v^T, attn^T g, ds k, dbraw p,
// ds^T qu, dbraw^T qv): 4.29 GFLOP of bf16 products (4.3 us at 989
// TFLOP/s), and must move q, k, v, g in and dq, dk, dv out (7 x 2.1 MB),
// the uint8 draws (4.2 MB) and p: ~19 MB (5.7 us at 3.35 TB/s). Bytes,
// with dropout.
//
// Design: three launches.
//   1. rowdot (csrc/attention_rows.cuh, M_ROWDOT): query-major, one CTA of
//      4 warps per (64 queries, h, b), one pass over the keys with each
//      row's max and sum as the training forward wrote them (M_STATS_IN);
//      without them (a standalone call) it runs the forward's own pass 1
//      first and writes them (M_STATS_OUT), so both give the same bits.
//      `rowdot` needs the f32 probabilities before dropout times dattn
//      after it, so FlashAttention's rowsum(dO * O) (O was formed from bf16
//      probabilities and rounded) would round elsewhere.
//   2. gradients, key-major: one CTA of 16 warps (512 threads, at most 128
//      registers each, one CTA per SM) per (64 keys, h, b) walks the query
//      tiles of 64. dk and dv of its keys stay in f32 registers over the
//      walk and are written once, in bf16: no partials. Per query tile,
//      warp (r4, cg) forms the scores of queries 16 r4.. x keys 16 cg..,
//      then attn, dattn and ds, and writes bf16(attn_d), ds_c
//      ([query][key]) and dbraw ([query][band row]) to shared memory; then
//      every operand of the five gradient products comes from those tiles
//      and the row-major q, g, k, p tiles by ldmatrix or ldmatrix.trans (no
//      transposed copy), each warp a 16 x 16 share of dq, dk and dv and a
//      16 x dh/2 share of dp. The dq of the query tile (ds_c k + dbraw p)
//      goes to a per-key-tile f32 partial. dp: the band of (query tile qt,
//      the CTA's key tile) is p blocks X_qt and X_qt-1 (X_n = rows
//      [T-64-64n+s0, +64)), so each block is touched by two consecutive
//      query tiles; warps 0-7 own the even blocks and warps 8-15 the odd
//      ones, keep the block in registers over its two tiles and then write
//      it once: nq + 1 blocks a CTA, not 2 nq. q, g, the dropout bytes, the
//      statistics and the next p block of query tile i+1 are in flight
//      (cp.async, a double-buffered stage and a 3-slot ring) while tile i
//      computes. The dbraw tile is zeroed once: every tile writes the same
//      diagonal strip of it.
//   3. a fixed-order sum of the partials (dq over key tiles; dp, du, dvb
//      with b ascending, then key tile), four columns a thread, rounded to
//      bf16. No atomics: two launches on the same inputs give the same
//      bits. The workspace is 38.1 MB at the step's shape (dq 16.8, dp 21.0).
// Products on mma.sync m16n8k16 bf16 -> f32; the score sum and scale as
// __fadd_rn then __fmul_rn, the gradient formulas with _rn intrinsics (no
// FMA contraction), expf and the correctly rounded quotient (sm_div, one
// reciprocal a row; no --use_fast_math). Query rows past T and key columns
// past T contribute nothing; masked keys inside [0, T) take -1e9 and still
// count, so an all-pad row is uniform 1/T, as in JAX. No load reads past T.
//
// The entry launches the three kernels on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for
// shapes it does not take: dh outside [1, 64], a drop threshold outside
// [0, 255], a workspace smaller than fused_relpos_attention_plan's).

#include "attention_rows.cuh"

namespace {

constexpr int BWD_WARPS = 16;
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr int PD_LD = BK + 8;        // bf16 row stride of [query][key] tiles
constexpr int DB_LD = 2 * PBLK + 8;  // bf16 row stride of the dbraw tile [query][band row]
constexpr int BSCR_LD = 16 + 4;      // f32 row stride of a warp's shifted band scores
constexpr int REDUCE_THREADS = 256;

template <int DHP>
struct BwdLayout {
  static constexpr int LD = DHP + 8;  // bf16 row stride of [row][dh] tiles
  static constexpr int TILE = 64 * LD * 2;
  static constexpr int KT = 0;              // k of the CTA's keys [key][dh]
  static constexpr int VT = KT + TILE;      // v [key][dh]
  static constexpr int MASK = VT + TILE;    // the keys' mask, f32
  static constexpr int UV = MASK + BK * 4;  // u and vb in f32 [2][DHP], zero past dh
  static constexpr int STAGES = UV + 2 * DHP * 4;
  // a stage (two): the query tile's q and g [query][dh], dropout bytes
  // [query][key], m, l and rowdot
  static constexpr int SQ = 0;
  static constexpr int SG = TILE;
  static constexpr int SDROP = 2 * TILE;
  static constexpr int SM = SDROP + BQ * DROP_LD;
  static constexpr int SL = SM + BQ * 4;
  static constexpr int SRD = SL + BQ * 4;
  static constexpr int STAGE = SRD + BQ * 4;
  static constexpr int RING = STAGES + 2 * STAGE;  // 3 slots of PBLK p rows
  static constexpr int QU = RING + 3 * TILE;       // qu [query][dh]
  static constexpr int QV = QU + TILE;             // qv [query][dh]
  static constexpr int PD = QV + TILE;             // bf16(attn_d) [query][key]
  static constexpr int DS = PD + BQ * PD_LD * 2;   // ds_c [query][key]
  static constexpr int DB = DS + BQ * PD_LD * 2;   // dbraw [query][band row]
  static constexpr int BS = DB + BQ * DB_LD * 2;   // warps' shifted band scores, f32
  // at the end: the query groups' sums of dqu and dqv, f32 [2][4][DHP]
  static constexpr int BYTES = BS + cmax(BWD_WARPS * 16 * BSCR_LD * 4, 2 * 4 * DHP * 4);
};

// The workspace, carved as fused_relpos_attention_plan sizes it.
struct Partials {
  float* dq;      // [B, H, nk, T, dh]: per key tile, dqu + dqv of every query
  float* dp;      // [B, H, nk, nk + 1, PBLK, dh]: per key tile, blocks X_-1 .. X_nk-1
  float* du;      // [B, H, nk, dh]: per key tile, column sums of dqu
  float* dvb;     // [B, H, nk, dh]: the same of dqv
  float* m;       // [B, H, T]: each row's max and sum when the caller has none
  float* l;
  float* rowdot;  // [B, H, T]
};

inline size_t bwd_workspace_floats(int B, int H, int T, int dh) {
  const size_t nk = (size_t)((T + BK - 1) / BK), bhk = (size_t)B * H * nk;
  return bhk * ((size_t)T * dh + (nk + 1) * PBLK * dh + 2 * (size_t)dh) + 3 * (size_t)B * H * T;
}

inline Partials carve(float* ws, int B, int H, int T, int dh) {
  const size_t nk = (size_t)((T + BK - 1) / BK), bhk = (size_t)B * H * nk;
  Partials w;
  w.dq = ws;
  w.dp = w.dq + bhk * T * dh;
  w.du = w.dp + bhk * (nk + 1) * PBLK * dh;
  w.dvb = w.du + bhk * dh;
  w.m = w.dvb + bhk * dh;
  w.l = w.m + (size_t)B * H * T;
  w.rowdot = w.l + (size_t)B * H * T;
  return w;
}

struct BwdArgs {
  const bf16 *q, *k, *v, *p, *u, *vb, *g;
  const float* key_mask;
  const uint8_t* drop8;
  const float *m, *l, *rowdot;
  bf16 *dk, *dv;
  Partials ws;
  int H, T, dh;
  float scale;
  int drop_k;
  float drop_scale;
};

template <int DHP>
__global__ void __launch_bounds__(BWD_THREADS, 1) relpos_attention_bwd_kernel(BwdArgs a) {
  using L = BwdLayout<DHP>;
  constexpr int LD = L::LD;
  constexpr int KS = DHP / 16;  // k16 steps over dh = column groups of 16
  constexpr int NO = DHP / 8;   // n8 tiles over dh
  constexpr int NHP = NO / 2;   // n8 tiles of half of dh (dp)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kt_s = reinterpret_cast<bf16*>(smem + L::KT);
  bf16* vt_s = reinterpret_cast<bf16*>(smem + L::VT);
  float* mask_s = reinterpret_cast<float*>(smem + L::MASK);
  float* uv = reinterpret_cast<float*>(smem + L::UV);
  bf16* qu_s = reinterpret_cast<bf16*>(smem + L::QU);
  bf16* qv_s = reinterpret_cast<bf16*>(smem + L::QV);
  bf16* pd = reinterpret_cast<bf16*>(smem + L::PD);
  bf16* dsm = reinterpret_cast<bf16*>(smem + L::DS);
  bf16* db = reinterpret_cast<bf16*>(smem + L::DB);

  const int T = a.T, dh = a.dh;
  const int kt = blockIdx.x, s0 = kt * BK, h = blockIdx.y, b = blockIdx.z;
  const int nk = gridDim.x;  // key tiles = query tiles
  const size_t bh = (size_t)b * a.H + h;
  const int P = 2 * T - 1;
  const bf16* qg = a.q + bh * T * dh;
  const bf16* gg = a.g + bh * T * dh;
  const bf16* pg = a.p + (size_t)h * P * dh;
  const uint8_t* dg = a.drop8 + bh * T * T;
  const bool use_drop = a.drop_k > 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  // warp roles: r4 = warp & 3 picks 16 query rows (scores, dq) or 16 keys
  // (dk, dv) or 16 rows of a dp block; cg = warp >> 2 a group of 16 keys
  // (scores) or of 16 columns of dh (dq, dk, dv); dp takes warps 0-7 for
  // the even blocks and 8-15 for the odd ones, each 16 rows x half of dh
  const int r4 = warp & 3, cg = warp >> 2;
  const int i0 = 16 * r4;          // query rows of the scores and of dq
  const int kw = 16 * cg;          // keys of the scores
  const bool cols = cg < KS;       // the warp has a column group of dh
  const int half = (warp >> 2) & 1, grp = warp >> 3;  // dp: half of dh, block parity
  const int xr0 = T - PBLK + s0;   // first p row of block X_0

  // block X_n (n >= -1) lives in ring slot (n + 1) % 3
  auto slot = [&](int n) {
    return reinterpret_cast<bf16*>(smem + L::RING + ((n + 1) % 3) * L::TILE);
  };
  auto stage = [&](int qt) { return smem + L::STAGES + (qt & 1) * L::STAGE; };
  auto load_stage = [&](int qt) {
    unsigned char* st = stage(qt);
    const int t0 = qt * BQ;
    copy_rows<DHP, LD, BWD_THREADS>(reinterpret_cast<bf16*>(st + L::SQ), qg, t0, BQ, T, dh);
    copy_rows<DHP, LD, BWD_THREADS>(reinterpret_cast<bf16*>(st + L::SG), gg, t0, BQ, T, dh);
    if (use_drop) copy_drop<BWD_THREADS>(st + L::SDROP, dg, t0, s0, T);
    copy_f32<BWD_THREADS>(reinterpret_cast<float*>(st + L::SM), a.m + bh * T, t0, BQ, T);
    copy_f32<BWD_THREADS>(reinterpret_cast<float*>(st + L::SL), a.l + bh * T, t0, BQ, T);
    copy_f32<BWD_THREADS>(reinterpret_cast<float*>(st + L::SRD), a.rowdot + bh * T, t0, BQ, T);
    copy_rows<DHP, LD, BWD_THREADS>(slot(qt), pg, xr0 - PBLK * qt, PBLK, P, dh);
    cp_async_commit();
  };

  // ---- the CTA's keys (k, v, mask), block X_-1, query tile 0 in flight;
  // u and vb in f32; the dbraw tile zeroed
  copy_rows<DHP, LD, BWD_THREADS>(kt_s, a.k + bh * T * dh, s0, BK, T, dh);
  copy_rows<DHP, LD, BWD_THREADS>(vt_s, a.v + bh * T * dh, s0, BK, T, dh);
  copy_f32<BWD_THREADS>(mask_s, a.key_mask + (size_t)b * T, s0, BK, T);
  copy_rows<DHP, LD, BWD_THREADS>(slot(-1), pg, xr0 + PBLK, PBLK, P, dh);
  load_stage(0);
  for (int i = threadIdx.x; i < 2 * DHP; i += BWD_THREADS) {
    const int c = i % DHP;
    const bf16* src = i < DHP ? a.u : a.vb;
    uv[i] = c < dh ? __bfloat162float(src[h * dh + c]) : 0.f;
  }
  for (int i = threadIdx.x; i < BQ * DB_LD * 2 / 16; i += BWD_THREADS) {
    reinterpret_cast<uint4*>(db)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  float* bsw = reinterpret_cast<float*>(smem + L::BS) + warp * 16 * BSCR_LD;

  float acc_dv[2][4], acc_dk[2][4], acc_dp[NHP][4], su[2][2], sv[2][2];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int x = 0; x < 4; ++x) acc_dv[n][x] = acc_dk[n][x] = 0.f;
    su[n][0] = su[n][1] = sv[n][0] = sv[n][1] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NHP; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc_dp[n][x] = 0.f;

  // block X_n's partial dp (this warp's 16 rows x half of dh) to the
  // workspace, then zero
  auto flush_dp = [&](int n) {
    float* w = a.ws.dp + (((bh * nk + kt) * (nk + 1) + (n + 1)) * PBLK + 16 * r4) * dh;
#pragma unroll
    for (int nn = 0; nn < NHP; ++nn)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int c = 8 * (half * NHP + nn) + 2 * tq + (x & 1);
        if (c < dh) w[(g + 8 * (x >> 1)) * dh + c] = acc_dp[nn][x];
        acc_dp[nn][x] = 0.f;
      }
  };

  for (int qt = 0; qt < nk; ++qt) {
    // query tile qt's stage has landed and tile qt-1 is done in every warp,
    // so its stage and ring slot take tile qt+1's loads
    cp_async_wait<0>();
    __syncthreads();
    if (qt + 1 < nk) load_stage(qt + 1);
    const int t0 = qt * BQ;
    const unsigned char* st = stage(qt);
    const bf16* qs = reinterpret_cast<const bf16*>(st + L::SQ);
    const bf16* gs = reinterpret_cast<const bf16*>(st + L::SG);
    const uint8_t* drop_s = st + L::SDROP;
    const float* ms = reinterpret_cast<const float*>(st + L::SM);
    const float* ls = reinterpret_cast<const float*>(st + L::SL);
    const float* rds = reinterpret_cast<const float*>(st + L::SRD);
    const bf16* xlo = slot(qt);      // band rows [0, 64)
    const bf16* xhi = slot(qt - 1);  // band rows [64, 128)

    // ---- qu = bf16(q + u), qv = bf16(q + vb), zero past T
    for (int i = threadIdx.x; i < BQ * (DHP / 8); i += BWD_THREADS) {
      const int r = i / (DHP / 8), c = 8 * (i % (DHP / 8));
      const uint4 raw = *reinterpret_cast<const uint4*>(qs + r * LD + c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      uint4 o1, o2;
      bf16* w1 = reinterpret_cast<bf16*>(&o1);
      bf16* w2 = reinterpret_cast<bf16*>(&o2);
      const bool live = t0 + r < T;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const float xv = __bfloat162float(e[x]);
        w1[x] = __float2bfloat16_rn(live ? __fadd_rn(xv, uv[c + x]) : 0.f);
        w2[x] = __float2bfloat16_rn(live ? __fadd_rn(xv, uv[DHP + c + x]) : 0.f);
      }
      *reinterpret_cast<uint4*>(qu_s + r * LD + c) = o1;
      *reinterpret_cast<uint4*>(qv_s + r * LD + c) = o2;
    }
    __syncthreads();

    // ---- scores of queries i0.. x keys kw..: sc[j][x] is query row
    // i0 + g + 8 * (x >> 1), key kw + 8 * j + 2 * tq + (x & 1); dattn alike
    {
      float sc[2][4], da[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[j][x] = da[j][x] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t aq[4], ag[4], bb[4];
        ldsm_x4(aq, frag_a(qu_s, LD, i0, 16 * ks, lane));
        ldsm_x4(ag, frag_a(gs, LD, i0, 16 * ks, lane));
        ldsm_x4(bb, frag_b_nk(kt_s, LD, kw, 16 * ks, lane));
        mma_bf16(sc[0], aq, bb[0], bb[1]);
        mma_bf16(sc[1], aq, bb[2], bb[3]);
        ldsm_x4(bb, frag_b_nk(vt_s, LD, kw, 16 * ks, lane));
        mma_bf16(da[0], ag, bb[0], bb[1]);
        mma_bf16(da[1], ag, bb[2], bb[3]);
      }
      {
        // the 32 band rows from cb: row i of the warp needs column
        // 15 - i + s' for its key s'
        const int cb = 48 - i0 + kw;
        float bd[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) bd[j][x] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t av[4];
          ldsm_x4(av, frag_a(qv_s, LD, i0, 16 * ks, lane));
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int rb = cb + 16 * jj;
            uint32_t bb[4];
            ldsm_x4(bb, frag_b_nk(rb < 64 ? xlo : xhi, LD, rb & 63, 16 * ks, lane));
            mma_bf16(bd[2 * jj], av, bb[0], bb[1]);
            mma_bf16(bd[2 * jj + 1], av, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = g + 8 * (x >> 1), sk = 8 * j + 2 * tq + (x & 1) + i - 15;
            if (sk >= 0 && sk < 16) bsw[i * BSCR_LD + sk] = bd[j][x];
          }
      }
      __syncwarp();
      // attn = exp(s - m) / l of the warp's elements, in the layout of sc
      const float absent = __int_as_float(0xff800000);  // -inf
      const float mr[2] = {ms[i0 + g], ms[i0 + g + 8]};
      const float lr[2] = {ls[i0 + g], ls[i0 + g + 8]};
      const float rlr[2] = {sm_rcp(lr[0]), sm_rcp(lr[1])};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int sk = 8 * j + 2 * tq + (x & 1), sl = kw + sk, s = s0 + sl;
          const float v = __fmul_rn(
              __fadd_rn(sc[j][x], bsw[(g + 8 * (x >> 1)) * BSCR_LD + sk]), a.scale);
          const float sv2 = s >= T ? absent : (mask_s[sl] > 0.f ? v : NEG);
          sc[j][x] = sm_exp(sv2 - mr[x >> 1]);
        }
      sm_div_rows(sc, lr, rlr);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int il = i0 + g + 8 * r, t = t0 + il;
        const float rdr = rds[il];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float ad2[2], ds2[2];
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int x = 2 * r + y, sl = kw + 8 * j + 2 * tq + y, s = s0 + sl;
            const float at = sc[j][x];
            float ad = at, d = da[j][x];
            if (use_drop && t < T && s < T) {
              const bool keep = drop_s[il * DROP_LD + sl] >= a.drop_k;
              ad = keep ? __fmul_rn(at, a.drop_scale) : 0.f;
              d = keep ? __fmul_rn(d, a.drop_scale) : 0.f;
            }
            float ds = __fmul_rn(__fmul_rn(at, __fsub_rn(d, rdr)), a.scale);
            if (t >= T) ad = ds = 0.f;
            ad2[y] = ad;
            ds2[y] = ds;
            db[il * DB_LD + BQ - 1 - il + sl] = __float2bfloat16_rn(ds);
          }
          const int sl0 = kw + 8 * j + 2 * tq;
          *reinterpret_cast<uint32_t*>(pd + il * PD_LD + sl0) = pack_bf16(ad2[0], ad2[1]);
          *reinterpret_cast<uint32_t*>(dsm + il * PD_LD + sl0) = pack_bf16(ds2[0], ds2[1]);
        }
      }
    }
    __syncthreads();

    if (cols) {
      // ---- dq of queries i0.., columns 16 cg..: ds_c k + dbraw p, per key tile
      float dqu[2][4], dqv[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) dqu[n][x] = dqv[n][x] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t aa[4], bb[4];
        ldsm_x4(aa, frag_a(dsm, PD_LD, i0, 16 * kk, lane));
        ldsm_x4_t(bb, frag_b_kn(kt_s, LD, 16 * kk, 16 * cg, lane));
        mma_bf16(dqu[0], aa, bb[0], bb[1]);
        mma_bf16(dqu[1], aa, bb[2], bb[3]);
      }
      const int cq = 48 - i0;  // the 80 band rows queries i0.. reach
#pragma unroll
      for (int kk = 0; kk < 5; ++kk) {
        const int rb = cq + 16 * kk;
        uint32_t aa[4], bb[4];
        ldsm_x4(aa, frag_a(db, DB_LD, i0, rb, lane));
        ldsm_x4_t(bb, frag_b_kn(rb < 64 ? xlo : xhi, LD, rb & 63, 16 * cg, lane));
        mma_bf16(dqv[0], aa, bb[0], bb[1]);
        mma_bf16(dqv[1], aa, bb[2], bb[3]);
      }
      float* wq = a.ws.dq + (bh * nk + kt) * T * dh;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = t0 + i0 + g + 8 * (x >> 1), c = 16 * cg + 8 * n + 2 * tq + (x & 1);
          if (t < T && c < dh) wq[(size_t)t * dh + c] = __fadd_rn(dqu[n][x], dqv[n][x]);
        }
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          su[n][y] = __fadd_rn(su[n][y], __fadd_rn(dqu[n][y], dqu[n][y + 2]));
          sv[n][y] = __fadd_rn(sv[n][y], __fadd_rn(dqv[n][y], dqv[n][y + 2]));
        }
      }

      // ---- dv += bf16(attn_d)^T g and dk += ds_c^T qu: keys 16 r4..,
      // columns 16 cg.., over the tile's 64 queries
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], as[4], bb[4];
        ldsm_x4_t(ap, frag_a_km(pd, PD_LD, 16 * r4, 16 * kk, lane));
        ldsm_x4_t(as, frag_a_km(dsm, PD_LD, 16 * r4, 16 * kk, lane));
        ldsm_x4_t(bb, frag_b_kn(gs, LD, 16 * kk, 16 * cg, lane));
        mma_bf16(acc_dv[0], ap, bb[0], bb[1]);
        mma_bf16(acc_dv[1], ap, bb[2], bb[3]);
        ldsm_x4_t(bb, frag_b_kn(qu_s, LD, 16 * kk, 16 * cg, lane));
        mma_bf16(acc_dk[0], as, bb[0], bb[1]);
        mma_bf16(acc_dk[1], as, bb[2], bb[3]);
      }
    }

    // ---- dp += dbraw^T qv over this warp's 16 rows x half of dh of the
    // block its group holds: warps 0-7 the even blocks, 8-15 the odd ones.
    // X_qt (band rows [0, 64)) is new; X_qt-1 ([64, 128)) is complete after
    // this tile.
    {
      const bool fresh = grp == (qt & 1);
      const int rbp = (fresh ? 0 : PBLK) + 16 * r4;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ad[4];
        ldsm_x4_t(ad, frag_a_km(db, DB_LD, rbp, 16 * kk, lane));
#pragma unroll
        for (int nn = 0; nn < NHP; ++nn) {
          uint32_t bb[2];
          ldsm_x2_t(bb, frag_b1_kn(qv_s, LD, 16 * kk, 8 * (half * NHP + nn), lane));
          mma_bf16(acc_dp[nn], ad, bb[0], bb[1]);
        }
      }
      if (!fresh) flush_dp(qt - 1);
    }
  }
  if (grp == ((nk - 1) & 1)) flush_dp(nk - 1);
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem + L::BS);  // the band scores are done

  // ---- dk, dv of the CTA's keys; the du and dvb partials
  bf16* dkg = a.dk + bh * T * dh;
  bf16* dvg = a.dv + bh * T * dh;
  if (cols) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int s = s0 + 16 * r4 + g + 8 * (x >> 1), c = 16 * cg + 8 * n + 2 * tq + (x & 1);
        if (s < T && c < dh) {
          dkg[(size_t)s * dh + c] = __float2bfloat16_rn(acc_dk[n][x]);
          dvg[(size_t)s * dh + c] = __float2bfloat16_rn(acc_dv[n][x]);
        }
      }
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        float u1 = su[n][y], v1 = sv[n][y];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          u1 = __fadd_rn(u1, __shfl_xor_sync(0xffffffffu, u1, off));
          v1 = __fadd_rn(v1, __shfl_xor_sync(0xffffffffu, v1, off));
        }
        const int c = 16 * cg + 8 * n + 2 * tq + y;
        if (g == 0) {
          sums[r4 * DHP + c] = u1;
          sums[(4 + r4) * DHP + c] = v1;
        }
      }
    }
  }
  __syncthreads();
  // the key tile's du and dvb partials: the four query groups in order
  for (int i = threadIdx.x; i < 2 * dh; i += BWD_THREADS) {
    const int which = i / dh, c = i % dh;
    const float* col = sums + 4 * which * DHP + c;
    const float acc = __fadd_rn(__fadd_rn(__fadd_rn(col[0], col[DHP]), col[2 * DHP]),
                                col[3 * DHP]);
    (which ? a.ws.dvb : a.ws.du)[(bh * nk + kt) * dh + c] = acc;
  }
}

// Sums the partials in a fixed order and rounds to bf16: one thread per V
// consecutive columns (V = 4 when dh % 4 == 0: 16-byte loads) of du and
// dvb (together), then of dp, then of dq. The sums over the batch come
// first in the grid, so that their longer chains of loads overlap the dq
// blocks' streaming; each sum runs b ascending, then key tile.
template <int V>
__device__ __forceinline__ void load_v(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void add_v(float (&acc)[V], const float* p) {
  float x[V];
  load_v<V>(x, p);
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], x[e]);
}

template <int V>
__device__ __forceinline__ void store_v(bf16* dst, const float (&acc)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) dst[e] = __float2bfloat16_rn(acc[e]);
}

template <int V>
__global__ void __launch_bounds__(REDUCE_THREADS)
    relpos_attention_bwd_reduce(Partials ws, bf16* __restrict__ dq, bf16* __restrict__ dp,
                                bf16* __restrict__ du, bf16* __restrict__ dvb, int B, int H,
                                int T, int dh, int nk) {
  const int P = 2 * T - 1, dv = dh / V;  // column groups of V
  const size_t n1 = (size_t)H * dv, n2 = (size_t)H * P * dv, n3 = (size_t)B * H * T * dv;
  size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i < n1) {
    const size_t c = V * (i % dv), h = i / dv;
    float a1[V], a2[V];
#pragma unroll
    for (int e = 0; e < V; ++e) a1[e] = a2[e] = 0.f;
#pragma unroll 4
    for (int w = 0; w < B * nk; ++w) {  // w = b * nk + kt
      const int b = w / nk, kt = w % nk;
      const size_t off = (((size_t)b * H + h) * nk + kt) * dh + c;
      add_v<V>(a1, ws.du + off);
      add_v<V>(a2, ws.dvb + off);
    }
    store_v<V>(du + h * dh + c, a1);
    store_v<V>(dvb + h * dh + c, a2);
    return;
  }
  i -= n1;
  if (i < n2) {
    const int c = V * (int)(i % dv), j = (int)((i / dv) % P), h = (int)(i / ((size_t)P * dv));
    // p row j lies in block X_n of key tile kt (rows [T-64-64n+64kt, +64))
    // for the key tiles kt in [kt_lo, kt_hi]
    const int kt_lo = max(0, (j - T) / BK);
    const int kt_hi = min(nk - 1, (BK * nk - T + j) / BK);
    const int len = kt_hi - kt_lo + 1;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int w = 0; w < B * len; ++w) {  // w = b * len + kt - kt_lo
      const int b = w / len, kt = kt_lo + w % len;
      const int n = (T - 1 + BK * kt - j + PBLK) / PBLK - 1;
      const int rho = j - (T - PBLK - PBLK * n + BK * kt);
      add_v<V>(acc, ws.dp + ((((size_t)b * H + h) * nk + kt) * (nk + 1) + n + 1) * PBLK * dh
                        + (size_t)rho * dh + c);
    }
    store_v<V>(dp + ((size_t)h * P + j) * dh + c, acc);
    return;
  }
  i -= n2;
  if (i < n3) {
    const size_t c = V * (i % dv), t = (i / dv) % T, bh = i / ((size_t)T * dv);
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll 8
    for (int kt = 0; kt < nk; ++kt) add_v<V>(acc, ws.dq + ((bh * nk + kt) * T + t) * dh + c);
    store_v<V>(dq + (bh * T + t) * dh + c, acc);
  }
}

template <int V>
int launch_reduce(const Partials& ws, void* dq, void* dp, void* du, void* dvb, int B, int H,
                  int T, int dh, cudaStream_t stream) {
  const int nk = (T + BK - 1) / BK, dv = dh / V;
  const size_t total = ((size_t)B * H * T + (size_t)H * (2 * T - 1) + H) * dv;
  relpos_attention_bwd_reduce<V><<<(unsigned)((total + REDUCE_THREADS - 1) / REDUCE_THREADS),
                                   REDUCE_THREADS, 0, stream>>>(
      ws, static_cast<bf16*>(dq), static_cast<bf16*>(dp), static_cast<bf16*>(du),
      static_cast<bf16*>(dvb), B, H, T, dh, nk);
  return (int)cudaGetLastError();
}

template <int DHP>
int launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = BwdLayout<DHP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(relpos_attention_bwd_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.T + BK - 1) / BK), (unsigned)a.H, (unsigned)B);
  relpos_attention_bwd_kernel<DHP><<<grid, BWD_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

inline int bwd_smem_bytes(int dh) {
  switch ((dh + 15) / 16) {
    case 1: return BwdLayout<16>::BYTES;
    case 2: return BwdLayout<32>::BYTES;
    case 3: return BwdLayout<48>::BYTES;
    default: return BwdLayout<64>::BYTES;
  }
}

}  // namespace

extern "C" {

// Gradients of the rel-pos attention (csrc/attention.cu) for the cotangent
// g [B,H,T,dh]: dq/dk/dv [B,H,T,dh], dp [H,2T-1,dh], du/dvb [H,dh], all
// bf16; operands as the forward's (bf16, contiguous, 16-byte aligned;
// key_mask f32; drop8 read only when drop_k > 0). stat_m and stat_l (f32
// [B,H,T], or both null) are each row's max and sum as the forward wrote
// them; without them the first launch computes them. `workspace` holds
// `workspace_floats` f32 elements, at least fused_relpos_attention_plan's.
int fused_relpos_attention_bwd(const void* q, const void* k, const void* v, const void* p,
                               const void* u, const void* vb, const void* key_mask,
                               const void* drop8, const void* g, const void* stat_m,
                               const void* stat_l, void* dq, void* dk, void* dv, void* dp,
                               void* du, void* dvb, void* workspace, long long workspace_floats,
                               int B, int H, int T, int dh, float scale, int drop_k,
                               float drop_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || H < 1 || T < 1 || dh < 1 || dh > 64 || drop_k < 0 || drop_k > 255 ||
      (stat_m == nullptr) != (stat_l == nullptr) || workspace_floats < 0 ||
      (size_t)workspace_floats < bwd_workspace_floats(B, H, T, dh)) {
    return (int)cudaErrorInvalidValue;
  }
  const Partials ws = carve(static_cast<float*>(workspace), B, H, T, dh);
  const cudaStream_t s = (cudaStream_t)stream;
  RowsArgs ra;
  ra.q = static_cast<const bf16*>(q);
  ra.k = static_cast<const bf16*>(k);
  ra.v = static_cast<const bf16*>(v);
  ra.p = static_cast<const bf16*>(p);
  ra.u = static_cast<const bf16*>(u);
  ra.vb = static_cast<const bf16*>(vb);
  ra.key_mask = static_cast<const float*>(key_mask);
  ra.drop8 = static_cast<const uint8_t*>(drop8);
  ra.g = static_cast<const bf16*>(g);
  ra.out = nullptr;
  ra.rowdot = ws.rowdot;
  ra.B = B, ra.H = H, ra.T = T, ra.dh = dh;
  ra.scale = scale, ra.drop_k = drop_k, ra.drop_scale = drop_scale;
  int rc;
  if (stat_m) {
    ra.m = const_cast<float*>(static_cast<const float*>(stat_m));
    ra.l = const_cast<float*>(static_cast<const float*>(stat_l));
    rc = launch_rows_dh<M_ROWDOT | M_STATS_IN>(ra, s);
  } else {
    ra.m = ws.m;
    ra.l = ws.l;
    rc = launch_rows_dh<M_ROWDOT | M_STATS_OUT>(ra, s);
  }
  if (rc != 0) return rc;

  BwdArgs ba;
  ba.q = ra.q, ba.k = ra.k, ba.v = ra.v, ba.p = ra.p, ba.u = ra.u, ba.vb = ra.vb, ba.g = ra.g;
  ba.key_mask = ra.key_mask;
  ba.drop8 = ra.drop8;
  ba.m = ra.m, ba.l = ra.l, ba.rowdot = ws.rowdot;
  ba.dk = static_cast<bf16*>(dk);
  ba.dv = static_cast<bf16*>(dv);
  ba.ws = ws;
  ba.H = H, ba.T = T, ba.dh = dh;
  ba.scale = scale, ba.drop_k = drop_k, ba.drop_scale = drop_scale;
  switch ((dh + 15) / 16) {
    case 1: rc = launch_bwd<16>(ba, B, s); break;
    case 2: rc = launch_bwd<32>(ba, B, s); break;
    case 3: rc = launch_bwd<48>(ba, B, s); break;
    default: rc = launch_bwd<64>(ba, B, s); break;
  }
  if (rc != 0) return rc;
  return dh % 4 == 0 ? launch_reduce<4>(ws, dq, dp, du, dvb, B, H, T, dh, s)
                     : launch_reduce<1>(ws, dq, dp, du, dvb, B, H, T, dh, s);
}

// The launch plan at (B, H, T, dh): out[0] query (= key) tiles of 64,
// out[1] threads and out[2] shared bytes of a forward-family CTA (grid
// [tiles, H, B]), out[3] threads and out[4] shared bytes of a backward
// gradient CTA (grid [tiles, H, B]), out[5] the backward's workspace in f32
// elements. Returns cudaErrorInvalidValue for shapes the kernels do not take.
int fused_relpos_attention_plan(int B, int H, int T, int dh, long long* out) {
  if (B < 1 || H < 1 || T < 1 || dh < 1 || dh > 64) return (int)cudaErrorInvalidValue;
  out[0] = (T + BQ - 1) / BQ;
  out[1] = ROWS_THREADS;
  out[2] = rows_smem_bytes(dh);
  out[3] = BWD_THREADS;
  out[4] = bwd_smem_bytes(dh);
  out[5] = (long long)bwd_workspace_floats(B, H, T, dh);
  return 0;
}

}  // extern "C"

"""Fused relative-position attention: CUDA kernels for Hopper (forward and
backward), their plain versions, and the autograd Function over them.

Counterpart of onebit_asr_tpu/ops/attention.py. For each (b, h) the whole
Transformer-XL attention

    softmax(((q+u) k^T + skew((q+vb) p^T)) * scale, key mask) -> dropout -> @ v

runs in one launch (csrc/attention.cu, replacing the TPU kernel
`_fwd_kernel`, ops/attention.py:141-162), and its gradient in three: rowdot,
the gradients and a fixed-order reduction (csrc/attention_bwd.cu, replacing
`_bwd_kernel`, :165-232): no [T, T]-or-wider tensor reaches device memory.
In training the forward also writes each row's max and sum of the softmax
(f32 [B, H, T]), which the Function saves and the backward reads in place of
recomputing them; called alone, the backward computes them with the
forward's own code, so both give the same bits.

The forward's arithmetic follows `_fwd_kernel`, which rounds differently
from the port's unfused attention chain (model/conformer.py::RelPosMHSA,
which rounds the content and position scores to the compute dtype and adds
them there):
- qu = q + u and qv = q + vb in the input dtype, rounded once;
- ac = qu k^T and braw = qv p^T in f32 (exact products of input-dtype values
  summed in f32), bd[t, s] = braw[t, T-1-t+s];
- s = (ac + bd) * scale, the sum first; masked keys take NEG (replaced, not
  added);
- softmax as max, exp(s - m), sum, then a divide, all in f32;
- dropout from precomputed uint8 draws (keep iff byte >= k, k =
  round(rate * 256), times 256 / (256 - k)) in f32;
- the probabilities cast to v's dtype, times v summed in f32, cast to v's
  dtype.

The backward follows `_bwd_kernel`: it recomputes the scores and softmax
from the inputs (drop8 included; on CUDA with the forward's row statistics),
then
- attn_d = keep ? attn * inv : 0; dv = bf16(attn_d)^T g (f32 sums);
- dattn = g v^T, then keep ? dattn * inv : 0; rowdot = sum_s dattn * attn
  over the f32 probabilities before dropout;
- ds = attn * (dattn - rowdot) * scale; ds_c = ds and dbraw = unskew(ds),
  both rounded to q's dtype;
- dqu = ds_c k, dqv = dbraw p (f32); dq = (dqu + dqv) rounded once;
  dk = ds_c^T qu; dp = sum_b dbraw^T qv; du = sum_b,t dqu and
  dvb = sum_b,t dqv, from the unrounded f32 dqu/dqv, summed over the batch
  in f32 and cast to p's and u's dtype at the end.

Each wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel (bf16 operands, dh <= 64) or raises; it never
falls back to the plain version or the unfused chain. The forward counts its
launches in `fused_relpos_attention.launches`, the backward in
`fused_relpos_attention_bwd.launches`.

The serving forward (no gradient to take, no row statistics) is also the
`torch.library` custom op `torch.ops.onebit.fused_relpos_attention`: the
plain version is its CPU kernel, the launch its CUDA kernel, and a fake
kernel gives `torch.export` v's shape and dtype. Without a gradient to
take, `fused_relpos_attention` calls the op, so an exported serving graph
holds one node per attention. The training forward and the backward stay
`_RelPosAttention`'s.
"""

from __future__ import annotations

import ctypes

import torch

from onebit_asr_tpu_torch.ops import _build
from onebit_asr_tpu_torch.ops.subsampler import _aligned, _full_f32_matmul
from onebit_asr_tpu_torch.ops.ternary_matmul import _cuda_launch_args

NEG = -1e9
MAX_HEAD_DIM = 64  # the kernels keep a warp's q rows and output in registers
# csrc/attention_bwd.cu::fused_relpos_attention_plan's outputs
PLAN_KEYS = ("tiles", "rows_threads", "rows_smem", "bwd_threads", "bwd_smem",
             "workspace_floats")


def drop_threshold(dropout_rate: float) -> int:
    """FastDropout's quantized drop threshold: drop iff byte < k."""
    return int(round(dropout_rate * 256))


def _check_operands(q, k, v, p, u, vb, key_mask, drop8, dropout_rate):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, dh], got {tuple(q.shape)}")
    B, H, T, dh = q.shape
    want = {"k": (k, (B, H, T, dh)), "v": (v, (B, H, T, dh)),
            "p": (p, (H, 2 * T - 1, dh)), "u": (u, (H, dh)), "vb": (vb, (H, dh)),
            "key_mask": (key_mask, (B, T))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
    kd = drop_threshold(dropout_rate)
    if not 0 <= kd < 256:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    if kd > 0:
        if drop8.dtype != torch.uint8 or tuple(drop8.shape) != (B, H, T, T):
            raise ValueError(
                f"drop8 must be uint8 {(B, H, T, T)}, got {drop8.dtype} {tuple(drop8.shape)}")
    return kd


def _skew_index(T, device):
    """[T, T] column of braw that bd[t, s] reads: T-1-t+s."""
    t = torch.arange(T, device=device)
    return (T - 1 - t)[:, None] + t[None, :]


def _scores(q, k, p, u, vb, key_mask, scale):
    """The masked f32 scores [B, H, T, T] of `_scores_h`."""
    f32 = torch.float32
    B, H, T, dh = q.shape
    qu = q + u[None, :, None, :]
    qv = q + vb[None, :, None, :]
    with _full_f32_matmul():
        ac = qu.to(f32) @ k.to(f32).transpose(-1, -2)  # [B, H, T, T]
        braw = qv.to(f32) @ p.to(f32).transpose(-1, -2)  # [B, H, T, 2T-1]
    bd = braw.gather(-1, _skew_index(T, q.device).expand(B, H, T, T))
    s = (ac + bd) * scale
    return torch.where(key_mask[:, None, None, :] > 0, s, NEG)


def _probs(q, k, p, u, vb, key_mask, scale):
    """The f32 softmax probabilities [B, H, T, T] of `_scores_h` and
    `_softmax_rows`."""
    s = _scores(q, k, p, u, vb, key_mask, scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.sum(dim=-1, keepdim=True)


def row_stats_reference(q, k, p, u, vb, key_mask, scale):
    """Each row's softmax max and sum of exp(s - max) (f32 [B, H, T]), from the
    scores of `_probs`: what the forward kernel writes for the backward."""
    s = _scores(q, k, p, u, vb, key_mask, scale)
    m = s.amax(dim=-1)
    return m, torch.exp(s - m[..., None]).sum(dim=-1)


def fused_relpos_attention_reference(q, k, v, p, u, vb, key_mask, drop8, scale,
                                     dropout_rate):
    """Plain version, in `_fwd_kernel`'s order of operations and roundings.
    Returns [B, H, T, dh] in v.dtype."""
    kd = _check_operands(q, k, v, p, u, vb, key_mask, drop8, dropout_rate)
    f32 = torch.float32
    attn = _probs(q, k, p, u, vb, key_mask, scale)
    if kd > 0:
        attn = torch.where(drop8.to(torch.int32) >= kd, attn * (256.0 / (256 - kd)), 0.0)
    with _full_f32_matmul():
        out = attn.to(v.dtype).to(f32) @ v.to(f32)
    return out.to(v.dtype)


def _fwd(q, k, v, p, u, vb, key_mask, drop8, scale, dropout_rate, stats=False):
    """The forward on the tensors' device: the plain version on the CPU, the
    kernel (counted in `fused_relpos_attention.launches`) on CUDA. With
    `stats`, returns (out, stats): on CUDA stats = (m, l), each row's max and
    sum (f32 [B, H, T]) written by the same launch; on the CPU ()."""
    kd = _check_operands(q, k, v, p, u, vb, key_mask, drop8, dropout_rate)
    if q.device.type == "cpu":
        out = fused_relpos_attention_reference(q, k, v, p, u, vb, key_mask, drop8, scale,
                                               dropout_rate)
        return (out, ()) if stats else out
    B, H, T, dh = q.shape
    device, stream, ops = _kernel_operands("fused_relpos_attention", kd, q, k, v, p, u, vb,
                                           key_mask, drop8)
    out = torch.empty((B, H, T, dh), dtype=torch.bfloat16, device=q.device)
    ml = tuple(torch.empty((B, H, T), dtype=torch.float32, device=q.device)
               for _ in range(2 if stats else 0))
    if B == 0 or T == 0:
        return (out, ml) if stats else out
    err = _build.library().fused_relpos_attention_fwd(
        *(t.data_ptr() for t in ops), out.data_ptr(),
        *([t.data_ptr() for t in ml] or [None, None]),
        B, H, T, dh, ctypes.c_float(scale), kd, ctypes.c_float(256.0 / (256 - kd)),
        device, stream,
    )
    _build.check(err, "fused_relpos_attention_fwd")
    fused_relpos_attention.launches += 1
    return (out, ml) if stats else out


def _fwd_saving_stats(*args):
    return _fwd(*args, stats=True)


def _kernel_operands(what, kd, q, k, v, p, u, vb, key_mask, drop8, *cotangent):
    """(device, stream, operands) of a launch: q, k, v, p, u, vb, the f32 key
    mask, the draws (the mask again, unread, without dropout) and the
    cotangent if given, contiguous and 16-byte aligned. Raises unless every
    tensor lies on one CUDA device, the float operands are bfloat16 and dh
    is at most MAX_HEAD_DIM."""
    device, stream = _cuda_launch_args(q, k, v, p, u, vb, key_mask, drop8, *cotangent)
    dtypes = {t.dtype for t in (q, k, v, p, u, vb, *cotangent)}
    if dtypes != {torch.bfloat16}:
        raise NotImplementedError(f"{what} kernel takes bfloat16 operands, got {dtypes}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{what} kernel needs dh <= {MAX_HEAD_DIM}, got {q.shape[-1]}")
    mask = _aligned(key_mask.to(torch.float32))
    d8 = _aligned(drop8) if kd > 0 else mask
    ops = [_aligned(t) for t in (q, k, v, p, u, vb)] + [mask, d8]
    return device, stream, ops + [_aligned(t) for t in cotangent]


def fused_relpos_attention_bwd_reference(q, k, v, p, u, vb, key_mask, drop8, g, scale,
                                         dropout_rate):
    """Plain backward, in `_bwd_kernel`'s order of operations and roundings:
    (dq, dk, dv) [B, H, T, dh] in q/k/v's dtype, dp [H, 2T-1, dh] in p's,
    du and dvb [H, dh] in u's and vb's."""
    kd = _check_operands(q, k, v, p, u, vb, key_mask, drop8, dropout_rate)
    if tuple(g.shape) != tuple(q.shape):
        raise ValueError(f"g {tuple(g.shape)} != {tuple(q.shape)}")
    f32 = torch.float32
    B, H, T, dh = q.shape
    attn = _probs(q, k, p, u, vb, key_mask, scale)
    with _full_f32_matmul():
        gf = g.to(f32)
        dattn = gf @ v.to(g.dtype).to(f32).transpose(-1, -2)
        if kd > 0:
            keep = drop8.to(torch.int32) >= kd
            inv = 256.0 / (256 - kd)
            attn_d = torch.where(keep, attn * inv, 0.0)
            dattn = torch.where(keep, dattn * inv, 0.0)
        else:
            attn_d = attn
        dv = attn_d.to(g.dtype).to(f32).transpose(-1, -2) @ gf
        rowdot = (dattn * attn).sum(dim=-1, keepdim=True)
        ds = attn * (dattn - rowdot) * scale  # f32 [B, H, T, T]
        qu = (q + u[None, :, None, :]).to(f32)
        qv = (q + vb[None, :, None, :]).to(f32)
        ds_c = ds.to(q.dtype).to(f32)
        # the skew's adjoint: dbraw[t, T-1-t+s] = ds[t, s], zero elsewhere
        dbraw = ds_c.new_zeros((B, H, T, 2 * T - 1))
        dbraw.scatter_(-1, _skew_index(T, q.device).expand(B, H, T, T), ds_c)
        dqu = ds_c @ k.to(f32)
        dqv = dbraw @ p.to(f32)
        dq = dqu + dqv
        dk = ds_c.transpose(-1, -2) @ qu
        dp_b = dbraw.transpose(-1, -2) @ qv  # [B, H, P, dh]
    du_b, dvb_b = dqu.sum(dim=2), dqv.sum(dim=2)  # [B, H, dh]
    dp, du, dvb = dp_b[0], du_b[0], dvb_b[0]
    for b in range(1, B):  # the batch in order, as the TPU grid accumulates it
        dp, du, dvb = dp + dp_b[b], du + du_b[b], dvb + dvb_b[b]
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dp.to(p.dtype), du.to(u.dtype),
            dvb.to(vb.dtype))


def launch_plan(B, H, T, dh) -> dict:
    """The kernels' plan at these shapes (needs the kernel library, CUDA):
    query (= key) tiles of 64; threads and shared bytes of a forward-family
    CTA (the forward and the backward's rowdot launch, grid [tiles, H, B])
    and of a backward gradient CTA (grid [tiles, H, B]); the backward's
    workspace in f32 elements."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    _build.check(_build.library().fused_relpos_attention_plan(B, H, T, dh, out),
                 "fused_relpos_attention_plan")
    return dict(zip(PLAN_KEYS, out))


def bwd_workspace_floats(B, H, T, dh):
    """f32 elements of the backward's workspace (asks the kernel library):
    per key tile the partial dq of every query, the partial dp of its
    tiles + 1 blocks of 64 p rows and the partial du and dvb; each row's
    max, sum and rowdot."""
    return launch_plan(B, H, T, dh)["workspace_floats"]


def _check_stats(stats, q):
    B, H, T, _ = q.shape
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, T) or t.device != q.device:
            raise ValueError(f"row statistics must be float32 {(B, H, T)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def fused_relpos_attention_bwd(q, k, v, p, u, vb, key_mask, drop8, g, scale, dropout_rate,
                               stats=None):
    """Gradients of `fused_relpos_attention` for the cotangent g [B, H, T, dh]:
    (dq, dk, dv, dp, du, dvb), as `fused_relpos_attention_bwd_reference`.
    On CUDA every tensor operand but key_mask and drop8 must be bfloat16,
    and dh at most 64. `stats` = (m, l), the forward kernel's row
    statistics, spares the kernel their recomputation (the same bits
    either way); the plain version on the CPU ignores them."""
    kd = _check_operands(q, k, v, p, u, vb, key_mask, drop8, dropout_rate)
    if tuple(g.shape) != tuple(q.shape):
        raise ValueError(f"g {tuple(g.shape)} != {tuple(q.shape)}")
    if q.device.type == "cpu":
        return fused_relpos_attention_bwd_reference(q, k, v, p, u, vb, key_mask, drop8, g,
                                                    scale, dropout_rate)
    B, H, T, dh = q.shape
    device, stream, ops = _kernel_operands("fused_relpos_attention_bwd", kd, q, k, v, p, u, vb,
                                           key_mask, drop8, g)
    if stats:
        _check_stats(stats, q)
        stats = [_aligned(t) for t in stats]
    bf = dict(dtype=torch.bfloat16, device=q.device)
    dq, dk, dv = (torch.empty((B, H, T, dh), **bf) for _ in range(3))
    dp = torch.empty((H, 2 * T - 1, dh), **bf)
    du, dvb = torch.empty((H, dh), **bf), torch.empty((H, dh), **bf)
    if B == 0 or T == 0:
        return dq, dk, dv, dp.zero_(), du.zero_(), dvb.zero_()
    n_ws = bwd_workspace_floats(B, H, T, dh)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    err = _build.library().fused_relpos_attention_bwd(
        *(t.data_ptr() for t in ops), *([t.data_ptr() for t in stats] if stats else [None, None]),
        *(t.data_ptr() for t in (dq, dk, dv, dp, du, dvb, ws)), ctypes.c_longlong(n_ws),
        B, H, T, dh, ctypes.c_float(scale), kd, ctypes.c_float(256.0 / (256 - kd)),
        device, stream,
    )
    _build.check(err, "fused_relpos_attention_bwd")
    fused_relpos_attention_bwd.launches += 1
    return dq, dk, dv, dp, du, dvb


fused_relpos_attention_bwd.launches = 0


class _RelPosAttention(torch.autograd.Function):
    """Rel-pos attention whose forward is fns[0] and whose backward is fns[1]
    on the saved inputs, as `_fa_fwd` saves them (drop8 included), and on
    the kernel path on CUDA each row's max and sum that the forward kernel
    wrote (fns[0] returns (out, stats); stats is () elsewhere): nothing else
    of the forward's intermediates is kept. key_mask, drop8, scale and
    dropout_rate get no gradient."""

    @staticmethod
    def forward(ctx, fns, q, k, v, p, u, vb, key_mask, drop8, scale, dropout_rate):
        ctx.bwd, ctx.scale, ctx.dropout_rate = fns[1], scale, dropout_rate
        out, stats = fns[0](q, k, v, p, u, vb, key_mask, drop8, scale, dropout_rate)
        ctx.save_for_backward(q, k, v, p, u, vb, key_mask, drop8, *stats)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        stats = {"stats": saved[8:]} if len(saved) > 8 else {}
        grads = ctx.bwd(*saved[:8], g, ctx.scale, ctx.dropout_rate, **stats)
        return (None, *grads, None, None, None, None)


def _plain_fwd(*args):
    return fused_relpos_attention_reference(*args), ()


_KERNELS = (_fwd_saving_stats, fused_relpos_attention_bwd)
_PLAIN = (_plain_fwd, fused_relpos_attention_bwd_reference)


def fused_relpos_attention(q, k, v, p, u, vb, key_mask, drop8, scale, dropout_rate):
    """dropout(softmax(((q+u) k^T + skew((q+vb) p^T)) * scale, masked)) @ v,
    differentiable in q, k, v, p, u and vb (forward kernel row 3, backward
    kernel row 4).

    q/k/v [B, H, T, dh]; p [H, 2T-1, dh] (per-head projected positions);
    u/vb [H, dh]; key_mask [B, T] float (> 0 = valid key); drop8 [B, H, T, T]
    uint8 draws (keep iff byte >= round(rate * 256)), ignored (any uint8
    tensor will do) when dropout_rate rounds to 0. Returns [B, H, T, dh] in
    v.dtype. On CUDA every tensor operand but key_mask and drop8 must be
    bfloat16, and dh at most 64. Without a gradient to take (serving), the
    forward kernel runs alone and writes no row statistics."""
    ops = (q, k, v, p, u, vb)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return _RelPosAttention.apply(_KERNELS, *ops, key_mask, drop8, scale, dropout_rate)
    return torch.ops.onebit.fused_relpos_attention(*ops, key_mask, drop8, scale, dropout_rate)


fused_relpos_attention.launches = 0


@torch.library.custom_op("onebit::fused_relpos_attention", mutates_args=(), device_types="cpu")
def _fused_relpos_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               p: torch.Tensor, u: torch.Tensor, vb: torch.Tensor,
                               key_mask: torch.Tensor, drop8: torch.Tensor, scale: float,
                               dropout_rate: float) -> torch.Tensor:
    return fused_relpos_attention_reference(q, k, v, p, u, vb, key_mask, drop8, scale,
                                            dropout_rate)


_fused_relpos_attention_op.register_kernel("cuda")(_fwd)


@_fused_relpos_attention_op.register_fake
def _(q, k, v, p, u, vb, key_mask, drop8, scale, dropout_rate):
    _check_operands(q, k, v, p, u, vb, key_mask, drop8, dropout_rate)
    return torch.empty_like(v, memory_format=torch.contiguous_format)


def fused_relpos_attention_plain(q, k, v, p, u, vb, key_mask, drop8, scale, dropout_rate):
    """`fused_relpos_attention` on the two plain versions, on any device: a
    stand-in for `RelPosMHSA.attention_fn` that compares a step on the
    kernels with the same step without them."""
    return _RelPosAttention.apply(_PLAIN, q, k, v, p, u, vb, key_mask, drop8, scale,
                                  dropout_rate)

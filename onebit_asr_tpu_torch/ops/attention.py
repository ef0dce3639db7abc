"""Fused relative-position attention forward: a CUDA kernel for Hopper + its plain version.

Counterpart of onebit_asr_tpu/ops/attention.py (the forward; the backward
belongs to training). For each (b, h) the whole Transformer-XL attention

    softmax(((q+u) k^T + skew((q+vb) p^T)) * scale, key mask) -> dropout -> @ v

runs in one launch (csrc/attention.cu, replacing the TPU kernel
`_fwd_kernel`, ops/attention.py:141-162): no [T, T]-or-wider tensor reaches
device memory.

The arithmetic follows `_fwd_kernel`, which rounds differently from the
port's unfused attention chain (model/conformer.py::RelPosMHSA, which rounds
the content and position scores to the compute dtype and adds them there):
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

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel (bf16 operands, dh <= 64) or raises; it never
falls back to the plain version or the unfused chain. It counts its launches
in `fused_relpos_attention.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from onebit_asr_tpu_torch.ops import _build
from onebit_asr_tpu_torch.ops.subsampler import _aligned, _full_f32_matmul
from onebit_asr_tpu_torch.ops.ternary_matmul import _cuda_launch_args

NEG = -1e9
MAX_HEAD_DIM = 64  # the kernel keeps a warp's q rows and output in registers


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


def fused_relpos_attention_reference(q, k, v, p, u, vb, key_mask, drop8, scale,
                                     dropout_rate):
    """Plain version, in `_fwd_kernel`'s order of operations and roundings.
    Returns [B, H, T, dh] in v.dtype."""
    kd = _check_operands(q, k, v, p, u, vb, key_mask, drop8, dropout_rate)
    f32 = torch.float32
    B, H, T, dh = q.shape
    qu = q + u[None, :, None, :]
    qv = q + vb[None, :, None, :]
    with _full_f32_matmul():
        ac = qu.to(f32) @ k.to(f32).transpose(-1, -2)  # [B, H, T, T]
        braw = qv.to(f32) @ p.to(f32).transpose(-1, -2)  # [B, H, T, 2T-1]
    t = torch.arange(T, device=q.device)
    skew = (T - 1 - t)[:, None] + t[None, :]  # bd[t, s] = braw[t, T-1-t+s]
    bd = braw.gather(-1, skew.expand(B, H, T, T))
    s = (ac + bd) * scale
    s = torch.where(key_mask[:, None, None, :] > 0, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    attn = e / e.sum(dim=-1, keepdim=True)
    if kd > 0:
        attn = torch.where(drop8.to(torch.int32) >= kd, attn * (256.0 / (256 - kd)), 0.0)
    with _full_f32_matmul():
        out = attn.to(v.dtype).to(f32) @ v.to(f32)
    return out.to(v.dtype)


def fused_relpos_attention(q, k, v, p, u, vb, key_mask, drop8, scale, dropout_rate):
    """dropout(softmax(((q+u) k^T + skew((q+vb) p^T)) * scale, masked)) @ v.

    q/k/v [B, H, T, dh]; p [H, 2T-1, dh] (per-head projected positions);
    u/vb [H, dh]; key_mask [B, T] float (> 0 = valid key); drop8 [B, H, T, T]
    uint8 draws (keep iff byte >= round(rate * 256)), ignored (any uint8
    tensor will do) when dropout_rate rounds to 0. Returns [B, H, T, dh] in
    v.dtype. On CUDA every tensor operand but key_mask and drop8 must be
    bfloat16, and dh at most 64."""
    kd = _check_operands(q, k, v, p, u, vb, key_mask, drop8, dropout_rate)
    if q.device.type == "cpu":
        return fused_relpos_attention_reference(q, k, v, p, u, vb, key_mask, drop8, scale,
                                                dropout_rate)
    device, stream = _cuda_launch_args(q, k, v, p, u, vb, key_mask, drop8)
    B, H, T, dh = q.shape
    dtypes = {t.dtype for t in (q, k, v, p, u, vb)}
    if dtypes != {torch.bfloat16}:
        raise NotImplementedError(
            f"fused_relpos_attention kernel takes bfloat16 q/k/v/p/u/vb, got {dtypes}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"fused_relpos_attention kernel needs dh <= {MAX_HEAD_DIM}, got {dh}")
    ops = [_aligned(t) for t in (q, k, v, p, u, vb)]
    mask = _aligned(key_mask.to(torch.float32))
    d8 = _aligned(drop8) if kd > 0 else mask  # not read without dropout
    out = torch.empty((B, H, T, dh), dtype=torch.bfloat16, device=q.device)
    if B == 0 or T == 0:
        return out
    err = _build.library().fused_relpos_attention_fwd(
        *(t.data_ptr() for t in ops), mask.data_ptr(), d8.data_ptr(), out.data_ptr(),
        B, H, T, dh, ctypes.c_float(scale), kd, ctypes.c_float(256.0 / (256 - kd)),
        device, stream,
    )
    _build.check(err, "fused_relpos_attention_fwd")
    fused_relpos_attention.launches += 1
    return out


fused_relpos_attention.launches = 0

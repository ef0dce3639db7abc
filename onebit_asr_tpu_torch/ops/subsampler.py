"""Fused Conv2dSubsampling forward: a CUDA kernel for Hopper + its plain version.

Counterpart of onebit_asr_tpu/ops/subsampler.py (the forward; the backward
belongs to training). conv1 (3x3 stride 2 VALID, C_in=1) -> ReLU -> conv2
(3x3 stride 2 VALID) -> ReLU in one launch, with the conv1 activation kept in
shared memory (csrc/subsampler.cu, replacing the TPU kernel `_fwd_kernel`,
ops/subsampler.py:217-241).

The arithmetic follows `_fwd_kernel`, which rounds differently from the
unfused convs of model/conformer.py (those cast the features to the compute
dtype before conv1):
- conv1 in f32: the bias, then the 9 taps (i, j) in order, each a product of
  a stride-2 input slice and w1[i, j] added to the sum;
- ReLU, then a cast to the compute dtype;
- conv2 as the im2col product [B*T2*F2, 9C] x [9C, C] ((i, j)-major, C-minor
  columns) of compute-dtype operands summed in f32, plus b2, ReLU, a cast.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel (bf16 compute dtype, C a multiple of 16) or
raises; it never falls back to convolutions. It counts its launches in
`fused_subsample.launches`.
"""

from __future__ import annotations

import contextlib

import torch

from onebit_asr_tpu_torch.ops import _build
from onebit_asr_tpu_torch.ops.ternary_matmul import _cuda_launch_args


def out_len(n: int) -> int:
    """VALID 3-wide stride-2 conv output length."""
    return (n - 1) // 2


def _check_operands(x, w1, b1, w2, b2):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, F], got {tuple(x.shape)}")
    C = w1.shape[-1]
    want = {"w1": (w1, (3, 3, C)), "b1": (b1, (C,)), "w2": (w2, (9 * C, C)),
            "b2": (b2, (C,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
    _, T, F = x.shape
    if out_len(out_len(T)) < 1 or out_len(out_len(F)) < 1:
        raise ValueError(f"x {tuple(x.shape)}: too short for two stride-2 convs")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address: the kernel reads its
    operands 8 and 16 bytes at a time."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 products in full f32 (no TF32), restored on exit."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def fused_subsample_reference(x, w1, b1, w2, b2, compute_dtype=torch.bfloat16):
    """Plain version, in `_fwd_kernel`'s order of operations and roundings.
    x [B, T, F] f32 -> [B, T2, F2, C] in compute_dtype."""
    _check_operands(x, w1, b1, w2, b2)
    f32 = torch.float32
    B, T, F = x.shape
    C = w1.shape[-1]
    T1, F1 = out_len(T), out_len(F)
    T2, F2 = out_len(T1), out_len(F1)
    x = x.to(f32)
    w1 = w1.to(f32)
    acc = b1.to(f32).expand(B, T1, F1, C)
    for i in range(3):
        for j in range(3):
            plane = x[:, i : i + 2 * T1 : 2, j : j + 2 * F1 : 2]  # [B, T1, F1]
            acc = acc + plane[..., None] * w1[i, j]
    c1 = torch.relu(acc).to(compute_dtype)
    taps = [c1[:, i : i + 2 * T2 : 2, j : j + 2 * F2 : 2]
            for i in range(3) for j in range(3)]
    pat = torch.cat(taps, dim=-1).reshape(B * T2 * F2, 9 * C)
    with _full_f32_matmul():
        y = pat.to(f32) @ w2.to(compute_dtype).to(f32)
    y = torch.relu(y + b2.to(f32))
    return y.to(compute_dtype).reshape(B, T2, F2, C)


def fused_subsample(x, w1, b1, w2, b2, compute_dtype=torch.bfloat16):
    """conv1(3x3 s2 VALID, C_in=1) -> ReLU -> conv2(3x3 s2 VALID) -> ReLU.

    x [B, T, F] f32; w1 [3, 3, C] (the conv1 HWIO kernel squeezed); b1 [C];
    w2 [9C, C] (the conv2 HWIO kernel reshaped: (i, j)-major, C_in-minor);
    b2 [C]. Returns [B, T2, F2, C] in compute_dtype. On CUDA, w2 is read as
    bf16 [9C, C]: a caller that passes it so pays no cast per call."""
    _check_operands(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_subsample_reference(x, w1, b1, w2, b2, compute_dtype)
    device, stream = _cuda_launch_args(x, w1, b1, w2, b2)
    B, T, F = x.shape
    C = w1.shape[-1]
    if compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"fused_subsample kernel computes conv2 in bfloat16, not {compute_dtype}")
    if C % 16:
        raise ValueError(f"fused_subsample kernel needs C % 16 == 0, got C={C}")
    T2, F2 = out_len(out_len(T)), out_len(out_len(F))
    xf, w1f, b1f, b2f = (_aligned(t.to(torch.float32)) for t in (x, w1, b1, b2))
    w2b = _aligned(w2.to(torch.bfloat16))
    out = torch.empty((B, T2, F2, C), dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return out
    err = _build.library().fused_subsample_fwd(
        xf.data_ptr(), w1f.data_ptr(), b1f.data_ptr(), w2b.data_ptr(),
        b2f.data_ptr(), out.data_ptr(), B, T, F, C, device, stream,
    )
    _build.check(err, "fused_subsample_fwd")
    fused_subsample.launches += 1
    return out


fused_subsample.launches = 0

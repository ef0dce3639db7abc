"""Fused Conv2dSubsampling: CUDA kernels for Hopper (forward and backward),
their plain versions, and the autograd Function over them.

Counterpart of onebit_asr_tpu/ops/subsampler.py. conv1 (3x3 stride 2 VALID,
C_in=1) -> ReLU -> conv2 (3x3 stride 2 VALID) -> ReLU runs in one launch,
with the conv1 activation kept in shared memory (csrc/subsampler.cu,
replacing the TPU kernel `_fwd_kernel`, ops/subsampler.py:217-241), and its
gradient in one launch that recomputes conv1 from the input (the same
source, replacing `_bwd_kernel`, :244-356): the conv1 activation never
reaches device memory, forward or backward.

The forward's arithmetic follows `_fwd_kernel`, which rounds differently
from the unfused convs of model/conformer.py (those cast the features to
the compute dtype before conv1):
- conv1 in f32: the bias, then the 9 taps (i, j) in order, each a product of
  a stride-2 input slice and w1[i, j] added to the sum;
- ReLU, then a cast to the compute dtype;
- conv2 as the im2col product [B*T2*F2, 9C] x [9C, C] ((i, j)-major, C-minor
  columns) of compute-dtype operands summed in f32, plus b2, ReLU, a cast.

The backward follows `_bwd_kernel`: from the inputs alone (the only
residuals) it recomputes conv1's f32 pre-activation c1_pre, the patches
`pat` and y_pre = pat w2 + b2, then
- gm = y_pre > 0 ? g : 0 in f32; dw2 = pat^T bf16(gm) and db2 = sum gm, f32;
- dpat = bf16(gm) w2^T summed in f32 and rounded to the compute dtype before
  the overlap-add;
- dc1 = the 9 taps of dpat overlap-added in f32, taps in order, then zeroed
  where c1_pre <= 0;
- db1 = sum dc1; dw1[i, j] = sum x_ij dc1; dx = the overlap-add of
  sum_c dc1 w1[i, j], all f32.
Every weight gradient is returned in its weight's dtype: with w2 passed in
f32, as the model does, dw2 is never rounded to bf16.

Each wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel (bf16 compute dtype, C a multiple of 16) or
raises; it never falls back to convolutions. The forward counts its launches
in `fused_subsample.launches`, the backward in `fused_subsample_bwd.launches`.

The forward is also the `torch.library` custom op `torch.ops.onebit.
fused_subsample`: the plain version is its CPU kernel, the launch its CUDA
kernel, and a fake kernel gives `torch.export` the [B, T2, F2, C] output in
the compute dtype. Without a gradient to take, `fused_subsample` calls the
op; with one, the autograd Function runs as before.
"""

from __future__ import annotations

import contextlib
import ctypes

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


def _check_cotangent(x, w1, g):
    B, T, F = x.shape
    want = (B, out_len(out_len(T)), out_len(out_len(F)), w1.shape[-1])
    if tuple(g.shape) != want:
        raise ValueError(f"g {tuple(g.shape)} != {want}")


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


def _taps(a, n_t, n_f):
    """The 9 stride-2 slices a[:, 2t+i, 2f+j] (t < n_t, f < n_f) of a
    [B, T, F, ...] tensor, taps (i, j) in order."""
    return [a[:, i : i + 2 * n_t : 2, j : j + 2 * n_f : 2] for i in range(3) for j in range(3)]


def _pre_activations(x, w1, b1, w2, b2, compute_dtype):
    """(c1_pre [B, T1, F1, C] f32, pat [B*T2*F2, 9C] in compute_dtype, y_pre
    [B*T2*F2, C] f32): conv1 as `_conv1_block` sums it (b1, then taps (i, j)
    in order), its ReLU's im2col patches, and conv2's pre-activation."""
    f32 = torch.float32
    B, T, F = x.shape
    C = w1.shape[-1]
    T1, F1 = out_len(T), out_len(F)
    T2, F2 = out_len(T1), out_len(F1)
    w1 = w1.to(f32)
    c1_pre = b1.to(f32).expand(B, T1, F1, C)
    for t, plane in enumerate(_taps(x.to(f32), T1, F1)):
        c1_pre = c1_pre + plane[..., None] * w1[t // 3, t % 3]
    c1 = torch.relu(c1_pre).to(compute_dtype)
    pat = torch.cat(_taps(c1, T2, F2), dim=-1).reshape(B * T2 * F2, 9 * C)
    with _full_f32_matmul():
        y_pre = pat.to(f32) @ w2.to(compute_dtype).to(f32)
    return c1_pre, pat, y_pre + b2.to(f32)


def fused_subsample_reference(x, w1, b1, w2, b2, compute_dtype=torch.bfloat16):
    """Plain version, in `_fwd_kernel`'s order of operations and roundings.
    x [B, T, F] f32 -> [B, T2, F2, C] in compute_dtype."""
    _check_operands(x, w1, b1, w2, b2)
    B, T, F = x.shape
    _, _, y_pre = _pre_activations(x, w1, b1, w2, b2, compute_dtype)
    return torch.relu(y_pre).to(compute_dtype).reshape(
        B, out_len(out_len(T)), out_len(out_len(F)), -1)


def _fwd(x, w1, b1, w2, b2, compute_dtype=torch.bfloat16):
    """The forward on the tensors' device: the plain version on the CPU, the
    kernel (counted in `fused_subsample.launches`) on CUDA."""
    _check_operands(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_subsample_reference(x, w1, b1, w2, b2, compute_dtype)
    device, stream, (xf, w1f, b1f, w2b, b2f) = _kernel_operands(
        "fused_subsample", compute_dtype, x, w1, b1, w2, b2)
    B, T, F = x.shape
    C = w1.shape[-1]
    T2, F2 = out_len(out_len(T)), out_len(out_len(F))
    out = torch.empty((B, T2, F2, C), dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return out
    err = _build.library().fused_subsample_fwd(
        xf.data_ptr(), w1f.data_ptr(), b1f.data_ptr(), w2b.data_ptr(),
        b2f.data_ptr(), out.data_ptr(), B, T, F, C, 0, device, stream,
    )
    _build.check(err, "fused_subsample_fwd")
    fused_subsample.launches += 1
    return out


def _kernel_operands(what, compute_dtype, x, w1, b1, w2, b2, *cotangent):
    """(device, stream, operands) of a launch: x, w1, b1, b2 as f32, w2 and
    the cotangent (if given) as bf16, contiguous and 16-byte aligned.
    Raises unless every tensor lies on one CUDA device, the compute dtype and
    the cotangent are bfloat16 and C is a multiple of 16."""
    device, stream = _cuda_launch_args(x, w1, b1, w2, b2, *cotangent)
    if compute_dtype != torch.bfloat16:
        raise NotImplementedError(f"{what} kernel computes conv2 in bfloat16, not {compute_dtype}")
    if any(g.dtype != torch.bfloat16 for g in cotangent):
        raise NotImplementedError(f"{what} kernel takes a bfloat16 cotangent")
    C = w1.shape[-1]
    if C % 16:
        raise ValueError(f"{what} kernel needs C % 16 == 0, got C={C}")
    f32 = [_aligned(t.to(torch.float32)) for t in (x, w1, b1)]
    ops = f32 + [_aligned(w2.to(torch.bfloat16)), _aligned(b2.to(torch.float32))]
    return device, stream, ops + [_aligned(g) for g in cotangent]


def _bwd_of_masked(x, w1, w2, c1_keep, pat, gm, compute_dtype):
    """(dx, dw1, db1, dw2, db2), all f32, from the masked cotangent gm
    [B*T2*F2, C] f32, conv1's mask c1_keep = c1_pre > 0 and the patches:
    everything of `_bwd_kernel` after the mask on y_pre, in its order."""
    f32 = torch.float32
    B, T, F = x.shape
    _, T1, F1, C = c1_keep.shape
    T2, F2 = out_len(T1), out_len(F1)
    gc = gm.to(compute_dtype).to(f32)
    with _full_f32_matmul():
        dw2 = pat.to(f32).t() @ gc
        dpat = (gc @ w2.to(compute_dtype).to(f32).t()).to(compute_dtype)
    db2 = gm.sum(dim=0)
    dpat = dpat.reshape(B, T2, F2, 9, C)
    dc1 = torch.zeros((B, T1, F1, C), dtype=f32, device=x.device)
    for t, view in enumerate(_taps(dc1, T2, F2)):
        view += dpat[:, :, :, t].to(f32)
    dc1 = torch.where(c1_keep, dc1, 0.0)
    db1 = dc1.sum(dim=(0, 1, 2))
    planes = _taps(x.to(f32), T1, F1)
    dw1 = torch.stack([(p[..., None] * dc1).sum(dim=(0, 1, 2)) for p in planes])
    w1 = w1.to(f32)
    dx = torch.zeros((B, T, F), dtype=f32, device=x.device)
    for t, view in enumerate(_taps(dx, T1, F1)):
        view += (dc1 * w1[t // 3, t % 3]).sum(dim=-1)
    return dx, dw1.reshape(3, 3, C), db1, dw2, db2


def masked_cotangent_reference(x, w1, b1, w2, b2, g, compute_dtype=torch.bfloat16):
    """The backward's mask alone, plain: (gm = y_pre > 0 ? g : 0 as
    [B*T2*F2, C] f32, y_pre [B*T2*F2, C] f32)."""
    _check_operands(x, w1, b1, w2, b2)
    _check_cotangent(x, w1, g)
    _, _, y_pre = _pre_activations(x, w1, b1, w2, b2, compute_dtype)
    return torch.where(y_pre > 0, g.reshape(y_pre.shape).to(torch.float32), 0.0), y_pre


def fused_subsample_bwd_reference(x, w1, b1, w2, b2, g, compute_dtype=torch.bfloat16):
    """Plain backward, in `_bwd_kernel`'s order of operations and roundings,
    for the cotangent g [B, T2, F2, C]: (dx [B, T, F] in x's dtype, dw1
    [3, 3, C], db1 [C], dw2 [9C, C], db2 [C] in their weights' dtypes)."""
    _check_operands(x, w1, b1, w2, b2)
    _check_cotangent(x, w1, g)
    c1_pre, pat, y_pre = _pre_activations(x, w1, b1, w2, b2, compute_dtype)
    gm = torch.where(y_pre > 0, g.reshape(y_pre.shape).to(torch.float32), 0.0)
    grads = _bwd_of_masked(x, w1, w2, c1_pre > 0, pat, gm, compute_dtype)
    return tuple(d.to(t.dtype) for d, t in zip(grads, (x, w1, b1, w2, b2)))


def bwd_of_masked_reference(x, w1, b1, w2, b2, gm, compute_dtype=torch.bfloat16):
    """The plain backward from a given masked cotangent gm [B*T2*F2, C]
    (f32 values): every step after the mask on y_pre, all five gradients
    f32. Holding the kernel's gradients against this with the kernel's own
    gm separates the mask (where an element of y_pre within f32 rounding of
    0 may fall either way) from the rest of the arithmetic."""
    _check_operands(x, w1, b1, w2, b2)
    c1_pre, pat, _ = _pre_activations(x, w1, b1, w2, b2, compute_dtype)
    return _bwd_of_masked(x, w1, w2, c1_pre > 0, pat, gm.to(torch.float32), compute_dtype)


def bwd_workspace_floats(B, T, F, C) -> int:
    """f32 elements of the backward kernel's workspace for these shapes (the
    masked cotangent in bf16, the per-block partials of dx, dw1, db1 and db2
    and the split-K partials of dw2); needs the kernel library (CUDA)."""
    n = _build.library().fused_subsample_bwd_workspace(B, T, F, C)
    if n < 0:
        raise ValueError(f"fused_subsample_bwd kernel takes no (B, T, F, C)={(B, T, F, C)}")
    return n


PLAN_KEYS = ("fwd_r2", "fwd_grid_x", "fwd_grid_y", "fwd_grid_z", "fwd_smem",
             "conv1_r2", "conv1_ctas", "conv1_smem", "dw2_rows", "dw2_blocks", "dw2_splits",
             "dw2_ctas", "dw2_smem", "fwd_r2_max", "workspace_floats")


def launch_plan(B, T, F, C) -> dict:
    """The kernels' plan for these shapes (needs the kernel library, CUDA):
    the forward's (and the mask pass's) output rows per CTA, grid and shared
    bytes; the backward's conv1 pass (rows per block, CTAs, shared bytes)
    and dw2 pass (rows per block, blocks, splits, CTAs, shared bytes); the
    largest rows per CTA the forward takes; the workspace floats."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    _build.check(_build.library().fused_subsample_plan(B, T, F, C, out), "fused_subsample_plan")
    return dict(zip(PLAN_KEYS, out))


def masked_cotangent(x, w1, b1, w2, b2, g, compute_dtype=torch.bfloat16):
    """The first pass of the backward kernel alone on CUDA: gm [B*T2*F2, C]
    in bf16 (g where y_pre > 0, else 0), as `fused_subsample_bwd` computes
    it; on the CPU the plain version's gm. Not counted as a launch: it
    exists to check the kernel."""
    _check_operands(x, w1, b1, w2, b2)
    _check_cotangent(x, w1, g)
    if x.device.type == "cpu":
        return masked_cotangent_reference(x, w1, b1, w2, b2, g, compute_dtype)[0]
    device, stream, ops = _kernel_operands("masked_cotangent", compute_dtype, x, w1, b1, w2, b2,
                                           g)
    B, T, F = x.shape
    C = w1.shape[-1]
    gm = torch.empty((g.numel() // C, C), dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return gm
    err = _build.library().fused_subsample_bwd_mask(*(t.data_ptr() for t in (*ops, gm)), B, T, F, C,
                                                    0, device, stream)
    _build.check(err, "fused_subsample_bwd_mask")
    return gm


def fused_subsample_bwd(x, w1, b1, w2, b2, g, compute_dtype=torch.bfloat16):
    """Gradients of `fused_subsample` for the cotangent g [B, T2, F2, C]:
    (dx, dw1, db1, dw2, db2), as `fused_subsample_bwd_reference`. On CUDA the
    compute dtype and g must be bfloat16 and C a multiple of 16; the kernel
    sums every gradient in a fixed order, so two launches give the same
    bits."""
    _check_operands(x, w1, b1, w2, b2)
    _check_cotangent(x, w1, g)
    if x.device.type == "cpu":
        return fused_subsample_bwd_reference(x, w1, b1, w2, b2, g, compute_dtype)
    device, stream, ops = _kernel_operands("fused_subsample_bwd", compute_dtype, x, w1, b1, w2,
                                           b2, g)
    B, T, F = x.shape
    C = w1.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((B, T, F), **f32)
    dw1, db1 = torch.empty((3, 3, C), **f32), torch.empty((C,), **f32)
    dw2, db2 = torch.empty((9 * C, C), **f32), torch.empty((C,), **f32)
    if B == 0:
        grads = (dx, dw1.zero_(), db1.zero_(), dw2.zero_(), db2.zero_())
    else:
        n_ws = bwd_workspace_floats(B, T, F, C)
        ws = torch.empty(n_ws, **f32)
        err = _build.library().fused_subsample_bwd(
            *(t.data_ptr() for t in (*ops, dx, dw1, db1, dw2, db2, ws)), ctypes.c_longlong(n_ws),
            B, T, F, C, device, stream,
        )
        _build.check(err, "fused_subsample_bwd")
        fused_subsample_bwd.launches += 1
        grads = (dx, dw1, db1, dw2, db2)
    return tuple(d.to(t.dtype) for d, t in zip(grads, (x, w1, b1, w2, b2)))


fused_subsample_bwd.launches = 0


class _FusedSubsample(torch.autograd.Function):
    """The fused subsampler whose forward is fns[0] and whose backward is
    fns[1] on the saved inputs, as `_fs_fwd` saves them: nothing of the
    forward's intermediates (the conv1 activation above all) is kept.
    compute_dtype gets no gradient."""

    @staticmethod
    def forward(ctx, fns, x, w1, b1, w2, b2, compute_dtype):
        ctx.bwd, ctx.compute_dtype = fns[1], compute_dtype
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return fns[0](x, w1, b1, w2, b2, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        return (None, *ctx.bwd(*ctx.saved_tensors, g, ctx.compute_dtype), None)


_KERNELS = (_fwd, fused_subsample_bwd)
_PLAIN = (fused_subsample_reference, fused_subsample_bwd_reference)


def fused_subsample(x, w1, b1, w2, b2, compute_dtype=torch.bfloat16):
    """conv1(3x3 s2 VALID, C_in=1) -> ReLU -> conv2(3x3 s2 VALID) -> ReLU,
    differentiable in x and the four weights (forward kernel row 5, backward
    kernel row 6).

    x [B, T, F] f32; w1 [3, 3, C] (the conv1 HWIO kernel squeezed); b1 [C];
    w2 [9C, C] (the conv2 HWIO kernel reshaped: (i, j)-major, C_in-minor);
    b2 [C]. Returns [B, T2, F2, C] in compute_dtype. On CUDA, w2 is read as
    bf16: a caller that passes it so pays no cast per call, and one that
    trains passes it in f32, which the Function casts, so that dw2 comes
    back in f32."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _FusedSubsample.apply(_KERNELS, x, w1, b1, w2, b2, compute_dtype)
    return torch.ops.onebit.fused_subsample(x, w1, b1, w2, b2, compute_dtype)


fused_subsample.launches = 0


@torch.library.custom_op("onebit::fused_subsample", mutates_args=(), device_types="cpu")
def _fused_subsample_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return fused_subsample_reference(x, w1, b1, w2, b2, compute_dtype)


_fused_subsample_op.register_kernel("cuda")(_fwd)


@_fused_subsample_op.register_fake
def _(x, w1, b1, w2, b2, compute_dtype):
    _check_operands(x, w1, b1, w2, b2)
    B, T, F = x.shape
    return x.new_empty((B, out_len(out_len(T)), out_len(out_len(F)), w1.shape[-1]),
                       dtype=compute_dtype)


def fused_subsample_plain(x, w1, b1, w2, b2, compute_dtype=torch.bfloat16):
    """`fused_subsample` on the two plain versions, on any device: a
    stand-in for `Conv2dSubsampling.subsample_fn` that compares a step on
    the kernels with the same step without them."""
    return _FusedSubsample.apply(_PLAIN, x, w1, b1, w2, b2, compute_dtype)

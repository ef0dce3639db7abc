"""CTC alpha and beta lattices: CUDA kernels for Hopper + their plain versions.

Counterpart of onebit_asr_tpu/ops/ctc_pallas.py. Each recursion runs as one
launch (csrc/ctc_lattice.cu) over the pre-gathered emissions
(losses/ctc.py::_emissions):

- `ctc_alpha`: the forward lattice, replacing the TPU kernel
  `ctc_alpha_pallas` (body `_alpha_kernel`, ops/ctc_pallas.py:97-114);
- `ctc_beta`: the reverse lattice, replacing `ctc_beta_pallas` (body
  `_beta_kernel`, :117-151).

Both follow the TPU kernels' arithmetic: NEG_INF = -1e30 is a value, not
-inf; `_logaddexp3(a, b, c)` is m + log(exp(a-m) + exp(b-m) + exp(c-m)) with
m the largest of the three, summed left to right, and NEG_INF where
m <= NEG_INF. Alpha keeps a row where t >= len. Beta keeps its init row
where t > len - 2, and may skip from s+2 where the mask at s+2 allows it
(never from the last two columns).

Layout: the port takes the emissions and returns the lattice as [B, T, S]
(batch-major, as `_emissions` gathers them), not the TPU kernels' [T, B, S]:
that skips a transpose of the emissions and of each lattice. Otherwise the
signatures are JAX's: emit f32, logit lengths [B] int, the skip mask [B, S]
(bool, uint8 or float, > 0 = may skip from s-2) and the init row [B, S] f32.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises: there is no size limit of the TPU
kind (fits_vmem) and no fallback. The kernel reads int32 or int64 lengths
and a bool or uint8 mask as they are, so on the operands that
losses/ctc.py passes (int64 lengths, a bool mask, contiguous) a call
allocates the lattice and launches one kernel, nothing else; other integer
lengths and other masks (float: > 0 = may skip) are converted first. Each
wrapper counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from onebit_asr_tpu_torch.ops import _build
from onebit_asr_tpu_torch.ops.ternary_matmul import _cuda_launch_args

NEG_INF = -1e30
# the largest variant of csrc/ctc_lattice.cu: 32 states a lane on 16 warps
MAX_STATES = 16384
# csrc/ctc_lattice.cu::ctc_lattice_plan's outputs
PLAN_KEYS = ("states_per_lane", "warps", "smem")


def _check_operands(emit, logit_lens, can_skip, init):
    if emit.dim() != 3:
        raise ValueError(f"emit must be [B, T, S], got {tuple(emit.shape)}")
    B, T, S = emit.shape
    if emit.dtype != torch.float32:
        raise TypeError(f"emit must be float32, got {emit.dtype}")
    if init.dtype != torch.float32:
        raise TypeError(f"init must be float32, got {init.dtype}")
    for name, t, shape in (("logit_lens", logit_lens, (B,)), ("can_skip", can_skip, (B, S)),
                           ("init", init, (B, S))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
    if logit_lens.dtype.is_floating_point or logit_lens.dtype == torch.bool:
        raise TypeError(f"logit_lens must be integer, got {logit_lens.dtype}")
    if T < 1 or S < 1:
        raise ValueError(f"empty lattice [T={T}, S={S}]")


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))
    return torch.where(m <= NEG_INF, NEG_INF, out)


def _shift(x, cols):
    """[B, S] shifted along S by `cols` (> 0: right, < 0: left), NEG_INF in."""
    fill = x.new_full((x.shape[0], abs(cols)), NEG_INF)
    if cols > 0:
        return torch.cat([fill, x[:, :-cols]], dim=1)[:, : x.shape[1]]
    return torch.cat([x[:, -cols:], fill], dim=1)[:, -x.shape[1]:]


def ctc_alpha_reference(emit, logit_lens, can_skip, init):
    """Plain version of `ctc_alpha`: the scan form (losses/ctc.py:111-149 of
    the JAX package) in the TPU kernel's arithmetic. [B, T, S] f32."""
    _check_operands(emit, logit_lens, can_skip, init)
    T = emit.shape[1]
    skip = can_skip > 0
    lens = logit_lens.to(emit.device)[:, None]
    alpha = init
    rows = [alpha]
    for t in range(1, T):
        a_skip = torch.where(skip, _shift(alpha, 2), NEG_INF)
        new = _logaddexp3(alpha, _shift(alpha, 1), a_skip) + emit[:, t]
        alpha = torch.where(t < lens, new, alpha)
        rows.append(alpha)
    return torch.stack(rows, dim=1)


def ctc_beta_reference(emit, logit_lens, can_skip, init):
    """Plain version of `ctc_beta`: the reverse scan (losses/ctc.py:232-261
    of the JAX package) in the TPU kernel's arithmetic. [B, T, S] f32."""
    _check_operands(emit, logit_lens, can_skip, init)
    B, T, S = emit.shape
    skip_from = torch.cat([can_skip[:, 2:] > 0, can_skip.new_zeros((B, min(2, S)), dtype=torch.bool)],
                          dim=1)[:, :S]
    lens = logit_lens.to(emit.device)[:, None]
    beta = init
    rows = [beta]
    for t in range(T - 2, -1, -1):
        y = emit[:, t + 1] + beta
        y_skip = torch.where(skip_from, _shift(y, -2), NEG_INF)
        merged = _logaddexp3(y, _shift(y, -1), y_skip)
        beta = torch.where(t <= lens - 2, merged, init)
        rows.append(beta)
    return torch.stack(rows[::-1], dim=1)


def launch_plan(S) -> dict:
    """The variant that takes S states (needs the kernel library, CUDA):
    states a lane, warps an utterance (one block each) and the block's
    dynamic shared bytes (the emission ring and the warp-boundary slots)."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    _build.check(_build.library().ctc_lattice_plan(S, out), "ctc_lattice_plan")
    return dict(zip(PLAN_KEYS, out))


def _launch(entry, wrapper, emit, logit_lens, can_skip, init):
    device, stream = _cuda_launch_args(emit, logit_lens, can_skip, init)
    B, T, S = emit.shape
    if S > MAX_STATES:
        raise ValueError(f"{entry}: S={S} states exceed the {MAX_STATES} of the largest "
                         "kernel variant")
    lens = logit_lens if logit_lens.dtype in (torch.int32, torch.int64) else logit_lens.to(
        torch.int32)
    skip = can_skip if can_skip.dtype in (torch.bool, torch.uint8) else (can_skip > 0).to(
        torch.uint8)
    emit, lens, skip, init = (t.contiguous() for t in (emit, lens, skip, init))
    out = torch.empty((B, T, S), dtype=torch.float32, device=emit.device)
    if B == 0:
        return out
    err = getattr(_build.library(), entry)(
        emit.data_ptr(), lens.data_ptr(), int(lens.dtype == torch.int64), skip.data_ptr(),
        init.data_ptr(), out.data_ptr(), B, T, S, device, stream,
    )
    _build.check(err, entry)
    wrapper.launches += 1
    return out


def ctc_alpha(emit, logit_lens, can_skip, init):
    """The CTC forward lattice in log space. emit [B, T, S] f32 (log-probs of
    the extended labels), logit_lens [B] int, can_skip [B, S] (> 0 = may
    skip from s-2), init [B, S] f32 (row t=0) -> alphas [B, T, S] f32."""
    _check_operands(emit, logit_lens, can_skip, init)
    if emit.device.type == "cpu":
        return ctc_alpha_reference(emit, logit_lens, can_skip, init)
    return _launch("ctc_alpha_fwd", ctc_alpha, emit, logit_lens, can_skip, init)


def ctc_beta(emit, logit_lens, can_skip, init):
    """The CTC reverse lattice in log space: the operands of `ctc_alpha`,
    with init [B, S] the end-state row (row T-1) -> betas [B, T, S] f32."""
    _check_operands(emit, logit_lens, can_skip, init)
    if emit.device.type == "cpu":
        return ctc_beta_reference(emit, logit_lens, can_skip, init)
    return _launch("ctc_beta_bwd", ctc_beta, emit, logit_lens, can_skip, init)


ctc_alpha.launches = 0
ctc_beta.launches = 0

"""Binary / ternary weight quantization with a learnable scale: one per
tensor (alpha a scalar) or one per output channel (alpha [N] against W
[K, N], ModelConfig.quant_per_channel).

Counterpart of onebit_asr_tpu/ops/quant.py:

forward:  Wa = W / a, a = |alpha| + ALPHA_EPS (the gradient flows through
          the abs); Q = sign(clip(Wa, -1, 1)) with 0 -> +1 (1-bit), or 0
          where |clip(Wa)| < 0.5 else its sign (ternary); W_hat = a * Q.
backward: dW = g * 1[|Wa| <= 1] (straight-through), with Wa clipped to
          +-_WA_CLIP_BWD first; da = g * term summed over every axis where
          a broadcasts (all of them for a scalar), term = -Wa + Q' where
          |Wa| < 1 else sign(Wa) ("Eq. (3)"), where Q' uses plain sign
          (0 -> 0) for the binary projection, unlike the forward.

`project_weight` is the forward projection alone, used by the packed
export (model/packed.py).
"""

from __future__ import annotations

from typing import Union

import torch

ALPHA_EPS = 1e-8  # |alpha| + ALPHA_EPS keeps the scale away from zero
_WA_CLIP_BWD = 4.0  # bound on |W/a| in the backward: da stays finite

BitSpec = Union[int, bool]
#   int 1 / 2 / 32 -> binary / ternary / full precision
#   bool           -> True = binary, False = ternary (a per-layer mask entry)


def _project(wa_clipped: torch.Tensor, binary: bool) -> torch.Tensor:
    if binary:
        return torch.where(wa_clipped >= 0, 1.0, -1.0)
    return torch.where(wa_clipped.abs() < 0.5, 0.0, torch.sign(wa_clipped))


def project_weight(kernel: torch.Tensor, alpha: torch.Tensor, binary: bool) -> torch.Tensor:
    """W -> Q in {-1,0,+1} (ternary) or {-1,+1} (binary), f32, with a =
    |alpha| + eps. A stacked alpha [L] scales kernel [L, K, N] layer by
    layer."""
    a = alpha.to(torch.float32).abs() + ALPHA_EPS
    a = a.reshape(tuple(a.shape) + (1,) * (kernel.dim() - a.dim()))
    return _project(torch.clamp(kernel.to(torch.float32) / a, -1.0, 1.0), binary)


class QuantizeSTE(torch.autograd.Function):
    """a * Q(W / a) in f32 with the straight-through backward above; `a` is a
    positive scalar tensor or, per channel, [N] against W [K, N]; `binary`
    a Python bool."""

    @staticmethod
    def forward(ctx, w, a, binary):
        wa = w.to(torch.float32) / a
        ctx.save_for_backward(wa)
        ctx.binary = bool(binary)
        ctx.alpha_shape = a.shape
        return a * _project(torch.clamp(wa, -1.0, 1.0), ctx.binary)

    @staticmethod
    def backward(ctx, g):
        (wa,) = ctx.saved_tensors
        g = g.to(torch.float32)
        wa = torch.clamp(wa, -_WA_CLIP_BWD, _WA_CLIP_BWD)
        grad_w = g * (wa.abs() <= 1.0).to(torch.float32)
        sign = torch.sign(wa)
        q_bwd = sign if ctx.binary else torch.where(wa.abs() >= 0.5, sign, 0.0)
        term = torch.where(wa.abs() < 1.0, -wa + q_bwd, sign)
        return grad_w, (g * term).sum_to_size(ctx.alpha_shape), None


def quantize_weight(w: torch.Tensor, alpha: torch.Tensor, bits: BitSpec) -> torch.Tensor:
    """Quantize `w` per `bits` (1, 2, 32, or a bool: True = binary); 32 is
    the full-precision passthrough. `alpha` is a scalar or [N] per channel.
    Returns w's dtype."""
    if isinstance(bits, bool):
        binary = bits
    elif bits == 32:
        return w
    elif bits in (1, 2):
        binary = bits == 1
    else:
        raise ValueError(f"bits must be 1, 2 or 32, got {bits}")
    a = alpha.to(torch.float32)
    # |a| whose derivative is +1 at 0, as jnp.abs's
    a = a * torch.where(a >= 0, 1.0, -1.0) + ALPHA_EPS
    return QuantizeSTE.apply(w, a, binary).to(w.dtype)

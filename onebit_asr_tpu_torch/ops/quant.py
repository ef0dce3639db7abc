"""Forward projection of full-precision weights onto ternary/binary codes.

Counterpart of the forward half of onebit_asr_tpu/ops/quant.py (and of
model/packed.py:_project). Serving needs only the projection used at export;
the straight-through backward belongs to training.
"""

from __future__ import annotations

import torch

ALPHA_EPS = 1e-8  # |alpha| + ALPHA_EPS keeps the scale away from zero


def project_weight(kernel: torch.Tensor, alpha: torch.Tensor, binary: bool) -> torch.Tensor:
    """W -> Q in {-1,0,+1} (ternary) or {-1,+1} (binary), f32.

    Q = 0 where |clip(W/a, -1, 1)| < 0.5 else sign, with a = |alpha| + eps;
    binary maps W/a >= 0 to +1. A stacked alpha [L] scales kernel [L, K, N]
    layer by layer."""
    a = alpha.to(torch.float32).abs() + ALPHA_EPS
    a = a.reshape(tuple(a.shape) + (1,) * (kernel.dim() - a.dim()))
    wa = torch.clamp(kernel.to(torch.float32) / a, -1.0, 1.0)
    if binary:
        return torch.where(wa >= 0, 1.0, -1.0)
    return torch.where(wa.abs() < 0.5, 0.0, torch.sign(wa))

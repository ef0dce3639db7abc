"""Optimizer and LR schedule in plain tensor code, in optax's order of
operations.

Counterpart of onebit_asr_tpu/train/optim.py, which chains
`optax.clip_by_global_norm` and `optax.adamw`. One update is, per parameter:

    1. g <- g if |g|_global < max_norm else (g / |g|_global) * max_norm
    2. m <- (1 - b1) g + b1 m;  v <- (1 - b2) g^2 + b2 v
    3. m^ = m / (1 - b1^(count+1));  v^ = v / (1 - b2^(count+1))
    4. u = m^ / (sqrt(v^) + 1e-8) + wd * p
    5. p <- p + (-lr(count)) * u

so weight decay is added to the Adam direction and scaled by the LR, not
applied first as `torch.optim.AdamW` does. Scalars are f32, as in JAX. The
update is made in place (the parameters and moments are the state's own
tensors).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from onebit_asr_tpu_torch.utils.config import OptimConfig

ADAM_EPS = 1e-8


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                           min_lr_ratio: float = 0.1) -> Callable[[int], np.float32]:
    """lr(step) = peak * step / warmup before warmup, then cosine decay to
    min_lr_ratio * peak at total_steps; exactly 0 at step 0. f32."""
    f = np.float32

    def schedule(step: int) -> np.float32:
        step = f(step)
        lr_warm = f(peak_lr) * min(step / f(max(warmup_steps, 1)), f(1.0))
        denom = f(max(total_steps - warmup_steps, 1))
        progress = np.clip((step - f(warmup_steps)) / denom, f(0.0), f(1.0))
        cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * progress))
        lr_cos = f(peak_lr) * (f(min_lr_ratio) + f(1.0 - min_lr_ratio) * cos)
        return f(lr_warm if step < warmup_steps else lr_cos)

    return schedule


def make_schedule(cfg: OptimConfig, total_steps: int) -> Callable[[int], np.float32]:
    return warmup_cosine_schedule(cfg.lr, cfg.warmup_steps, total_steps, cfg.min_lr_ratio)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, f32."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) * t.to(torch.float32))
                          for t in tensors))


class AdamW:
    """clip_by_global_norm(grad_clip_norm) then AdamW with the warmup-cosine
    schedule. `update(params, grads, mu, nu, count)` changes params, mu and
    nu in place and returns the global norm of the unclipped gradients.
    Given `g_norm`, the clip uses it instead of the norm of `grads`: the
    ZeRO-2 step passes shards of every leaf, whose own norm is local, with
    the global norm (parallel/fsdp.py)."""

    def __init__(self, cfg: OptimConfig, total_steps: int):
        self.cfg = cfg
        self.schedule = make_schedule(cfg, total_steps)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
               count: int, g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b1, b2 = cfg.betas
        if g_norm is None:
            g_norm = global_norm(grads.values())
        # where(|g| < max, g, g / |g| * max) without a host sync
        clip = torch.where(g_norm < cfg.grad_clip_norm, torch.ones_like(g_norm), torch.zeros_like(g_norm))
        f32 = torch.float32
        dev = g_norm.device
        bc1 = 1.0 - torch.tensor(b1, dtype=f32, device=dev) ** torch.tensor(count + 1.0, dtype=f32)
        bc2 = 1.0 - torch.tensor(b2, dtype=f32, device=dev) ** torch.tensor(count + 1.0, dtype=f32)
        step_size = -1.0 * float(self.schedule(count))
        for name, p in params.items():
            g = grads[name]
            g = torch.where(clip > 0, g, (g / g_norm) * cfg.grad_clip_norm)
            m = mu[name].mul_(b1).add_((1.0 - b1) * g)
            v = nu[name].mul_(b2).add_((1.0 - b2) * (g * g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS) + cfg.weight_decay * p
            p.add_(torch.tensor(step_size, dtype=p.dtype, device=p.device) * u)
        return g_norm

"""Train state: step, parameters, optimizer moments and count, a generator.

Counterpart of onebit_asr_tpu/train/state.py. The parameters are the QAT
model's own tensors (its `named_parameters()`, f32), so the model always
holds the state's weights; the step updates them and the moments in place.
The generator is an explicit CPU `torch.Generator`: each step draws its
stochastic-precision mask and the seeds of the three branches' dropout from
it, so a saved state resumes the same stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int
    generator: torch.Generator


def create_train_state(model: nn.Module, seed: int) -> TrainState:
    """The state of a fresh run: the model's parameters, zero moments, a
    generator seeded with `seed`."""
    params = dict(model.named_parameters())
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
    generator = torch.Generator()
    generator.manual_seed(seed)
    return TrainState(step=0, params=params, mu=zeros(), nu=zeros(), count=0,
                      generator=generator)


def param_count(params: Dict[str, torch.Tensor]) -> int:
    return sum(p.numel() for p in params.values())

"""The one collective that the model and the losses call: a differentiable
sum over a process group (sync-BN statistics, global-batch loss sums)."""

from __future__ import annotations

import torch


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`, with autograd through the sum (its backward
    sums the cotangents over the group, as the transpose of JAX's psum);
    the identity when `group` is None."""
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=group)

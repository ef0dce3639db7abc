"""The collectives that the model and the losses call, each differentiable:

- `all_sum`: a sum over a process group whose backward sums the cotangents
  over the group too (sync-BN statistics, global-batch loss sums: each
  rank's cotangent is its own);
- `copy_to_model` and `reduce_from_model`: Megatron's two operators of
  tensor parallelism over the model axis, where every rank of the group
  holds the same rows. A column-parallel projection takes its input through
  `copy_to_model` (identity forward, sum of the ranks' partial input
  gradients backward); a row-parallel projection sums its ranks' partial
  products through `reduce_from_model` (sum forward, identity backward: the
  cotangent of the sum is the same on every rank). `all_sum` is the wrong
  operator for either: its backward would sum TP equal cotangents.

Each is the identity when `group` is None.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`, with autograd through the sum (its backward
    sums the cotangents over the group, as the transpose of JAX's psum);
    the identity when `group` is None."""
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=group)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The column-parallel input: x itself; its gradient summed over the
    model `group`."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The row-parallel output: x summed over the model `group`; its
    gradient passed through."""
    return x if group is None else _ReduceFromModel.apply(x, group)

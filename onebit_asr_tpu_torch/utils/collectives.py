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
  operator for either: its backward would sum TP equal cotangents;
- `ring_shift`: JAX's `lax.ppermute` on the ring i -> i+1 of a pipeline's
  stage group (send to the next rank, receive from the previous one; the
  backward runs the reverse ring), and `anchored`, which puts tensors that
  nothing reads into the graph with a zero gradient, so that every rank's
  backward runs every shift (a shift left out on one rank would leave its
  neighbours waiting).

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


def _exchange(x: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send `x` to global rank `dst` and receive a tensor like it from
    global rank `src`, both posted at once (a blocking send on a ring
    would deadlock). gloo moves host memory only: a CUDA tensor crosses
    through the host there."""
    x = x.contiguous()
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    send = x.cpu() if staged else x
    recv = torch.empty_like(send)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                        dist.P2POp(dist.irecv, recv, src, group)]):
        work.wait()
    return recv.to(x.device) if staged else recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token, group, nxt, prev):
        ctx.group, ctx.nxt, ctx.prev = group, nxt, prev
        return _exchange(x, nxt, prev, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.prev, ctx.nxt, ctx.group), None, None, None, None


def ring_shift(x: torch.Tensor, group, nxt: int, prev: int,
               token: torch.Tensor) -> torch.Tensor:
    """x sent to global rank `nxt`, and what global rank `prev` sent
    returned, with autograd: the backward sends the cotangent to `prev` and
    receives x's from `nxt`. `token` is a 0-dim tensor in the graph of the
    gradients asked for (zero times a parameter, say), so that every call's
    backward runs, even where `x` needs no gradient (a bubble's zeros):
    each rank's backward then makes the same exchanges, which
    `torch.autograd.grad` would otherwise prune. The identity when `group`
    is None."""
    if group is None:
        return x
    return _RingShift.apply(x, token, group, nxt, prev)


class _Anchored(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(t.shape, t.dtype, t.device) for t in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.others))


def anchored(x: torch.Tensor, others) -> torch.Tensor:
    """x itself, with `others` (tensors nothing else reads) in its graph:
    the backward reaches each of them with a zero gradient."""
    others = [t for t in others if t.requires_grad]
    return _Anchored.apply(x, *others) if others else x

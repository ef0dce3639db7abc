"""FSDP / ZeRO-2: the train state sharded over the data axis, with explicit
collectives.

Counterpart of onebit_asr_tpu/parallel/fsdp.py. The layout rule is JAX's:
every leaf of at least `min_elems` elements shards its largest dim that the
axis size divides (on a tie, the later dim), and the others replicate;
params and both AdamW moments shard alike, each rank keeping its
contiguous slice (`shard_state_fsdp`). The port does not stack the blocks
as JAX's `[L, ...]` leaves, so at small widths fewer leaves reach
`min_elems` than in JAX; the arithmetic is the same.

`make_fsdp_train_step` is JAX's shard_map step (fsdp.py:94-294) on
torch.distributed: each sharded weight is all-gathered once per step, each
rank runs the 3-branch step on its rows with sync-BN and global-batch
losses, the gradients are reduce-scattered and divided by the world size
(replicated leaves averaged), the global norm sums the shards' squares
over the ranks and the replicated leaves' once, and AdamW updates the
shards with that norm. `gather_state_fsdp` puts the full state back
together, for checkpoints (in a one-process run's format) and evaluation.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from onebit_asr_tpu_torch.train.state import TrainState
from onebit_asr_tpu_torch.train.step import (
    accumulated_value_and_grad,
    make_batch_loss,
    step_draws,
)

Spec = Tuple[Optional[str], ...]


def _leaf_spec(shape, n_shards: int, axis: str = "data", min_elems: int = 4096) -> Spec:
    """JAX's PartitionSpec of a leaf of `shape`, as a tuple: `axis` at the
    dim that shards, None elsewhere; () when the leaf replicates."""
    shape = tuple(shape)
    size = int(np.prod(shape)) if shape else 0
    if size < min_elems or not shape:
        return ()
    # largest dim divisible by the axis size; ties -> later (matmul) dim
    best = None
    for d, extent in enumerate(shape):
        if extent % n_shards == 0 and (best is None or extent >= shape[best]):
            best = d
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = axis
    return tuple(spec)


def _leaf_shard_dim(shape, n_shards: int, min_elems: int = 4096) -> int:
    spec = _leaf_spec(shape, n_shards, "data", min_elems)
    return spec.index("data") if "data" in spec else -1


def shard_dims(params: Dict[str, torch.Tensor], n_shards: int,
               min_elems: int = 4096) -> Dict[str, int]:
    """{name: the dim that shards, or -1} of full-size `params`."""
    return {k: _leaf_shard_dim(v.shape, n_shards, min_elems) for k, v in params.items()}


def fsdp_state_specs(state: TrainState, n_shards: int, axis: str = "data",
                     min_elems: int = 4096) -> Dict[str, Dict[str, Spec]]:
    """The layout of a full-size state: {"params" | "mu" | "nu": {name:
    spec}} (the moments as their params)."""
    specs = {k: _leaf_spec(v.shape, n_shards, axis, min_elems) for k, v in state.params.items()}
    return {"params": specs, "mu": dict(specs), "nu": dict(specs)}


def _slice(v: torch.Tensor, d: int, n: int, i: int) -> torch.Tensor:
    return (v if d < 0 else v.chunk(n, dim=d)[i]).detach().clone()


def _copy_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def shard_state_fsdp(state: TrainState, mesh, axis: str = "data",
                     min_elems: int = 4096) -> TrainState:
    """This rank's part of a full-size `state` (left as it is): each
    sharded leaf of params, mu and nu its contiguous 1/N along its dim,
    the replicated leaves whole, all new tensors."""
    n, i = mesh.axis_size(axis), mesh.index(axis)
    dims = shard_dims(state.params, n, min_elems)
    part = lambda d_: {k: _slice(v, dims[k], n, i) for k, v in d_.items()}  # noqa: E731
    return TrainState(step=state.step, params=part(state.params), mu=part(state.mu),
                      nu=part(state.nu), count=state.count,
                      generator=_copy_generator(state.generator))


def _gather(shard: torch.Tensor, d: int, n: int, group) -> torch.Tensor:
    """The full leaf from every rank's slice along dim d (one
    all_gather_into_tensor, which concatenates along dim 0)."""
    if d < 0 or group is None:
        return shard
    s = shard.movedim(d, 0).contiguous()
    out = s.new_empty((n * s.shape[0], *s.shape[1:]))
    dist.all_gather_into_tensor(out, s, group=group)
    return out.movedim(0, d).contiguous()


def gather_state_fsdp(state: TrainState, mesh, dims: Dict[str, int],
                      axis: str = "data") -> TrainState:
    """The full-size state from the ranks' shards (`dims` from
    `shard_dims` of the full params). Collective: every rank of the axis
    calls it; each gets the whole state."""
    n, group = mesh.axis_size(axis), mesh.group_of(axis)
    with torch.no_grad():
        full = lambda d_: {k: _gather(v, dims[k], n, group) for k, v in d_.items()}  # noqa: E731
        return TrainState(step=state.step, params=full(state.params), mu=full(state.mu),
                          nu=full(state.nu), count=state.count, generator=state.generator)


def make_fsdp_train_step(model, optimizer, loss_cfg, specials, num_enc_layers: int, mesh,
                         state: TrainState, axis: str = "data", min_elems: int = 4096,
                         grad_accum: int = 1):
    """train_step(sharded_state, local_batch) -> (sharded_state, aux), the
    ZeRO-2 step over `mesh`'s `axis`; `state` is the full-size state whose
    shapes set the layout (shard it with `shard_state_fsdp`). The batch is
    this rank's contiguous rows (`shard_batch(batch, mesh)`); with
    grad_accum > 1 they split into that many micro-batches, and the
    scattered gradient shards accumulate. aux holds the global losses and
    grad_norm, the same on every rank. The clip is the optimizer's own
    (`optimizer.cfg.grad_clip_norm`), on the global norm."""
    n, group = mesh.axis_size(axis), mesh.group_of(axis)
    dims = shard_dims(state.params, n, min_elems)
    sharded = torch.tensor([d >= 0 for d in dims.values()])
    batch_loss = make_batch_loss(model, loss_cfg, specials, num_enc_layers, group)
    dropout = model.cfg.dropout > 0

    def scatter(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each rank's shard of the mean gradient: reduce-scatter / N for
        the sharded leaves, the mean for the replicated ones."""
        if group is None:
            return grads
        out = mesh.mean({k: g for k, g in grads.items() if dims[k] < 0}, axis)
        for k, g in grads.items():
            d = dims[k]
            if d < 0:
                continue
            s = g.movedim(d, 0).contiguous()
            part = s.new_empty((s.shape[0] // n, *s.shape[1:]))
            dist.reduce_scatter_tensor(part, s, group=group)
            out[k] = (part / n).movedim(0, d).contiguous()
        return {k: out[k] for k in grads}

    def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """sqrt(sum over leaves, in order, of their squares): a sharded
        leaf's summed over the ranks, a replicated leaf's taken once."""
        sq = torch.stack([torch.sum(g.to(torch.float32) * g.to(torch.float32))
                          for g in grads.values()])
        if group is not None:
            total = torch.where(sharded.to(sq.device), sq, torch.zeros_like(sq))
            dist.all_reduce(total, group=group)
            sq = torch.where(sharded.to(sq.device), total, sq)
        return torch.sqrt(sum(sq.unbind()))

    def train_step(state: TrainState, batch):
        sp_mask, seeds = step_draws(state, loss_cfg, num_enc_layers, mesh.index(axis))
        with torch.no_grad():
            full = {k: _gather(v, dims[k], n, group) for k, v in state.params.items()}
        (_, aux), grads = accumulated_value_and_grad(batch_loss, full, batch, sp_mask, seeds,
                                                     dropout, grad_accum, reduce=scatter)
        del full
        g_norm = global_norm(grads)
        optimizer.update(state.params, grads, state.mu, state.nu, state.count, g_norm=g_norm)
        aux["grad_norm"] = g_norm
        state.count += 1
        state.step += 1
        return state, aux

    return train_step

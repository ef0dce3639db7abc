"""Tensor parallelism: the Megatron layout of the encoder's quantized
projections over a mesh's `model` axis, with explicit collectives.

Counterpart of onebit_asr_tpu/parallel/sharding_rules.py. The rule is
JAX's (`_spec_for`): the `kernel` of a QATDense named

- w1, q_proj, k_proj, v_proj, pos_proj shards its output dim (column
  parallel: each rank computes a slice of the features, whole heads for
  q/k/v/pos, since the heads are contiguous columns);
- w2, out_proj shards its input dim (row parallel: partial products);

and every other leaf replicates (alpha, bias, pos_bias_u/v, norms, the conv
module, the subsampler, the decoder, whose projections are q/k/v/o and
ff1/ff2). The AdamW moments shard as their parameters. Each rank keeps its
contiguous slice.

JAX leaves the collectives to XLA's partitioner; here the model writes
them (model/layers.py::QATDense and utils/collectives.py: one sum over the
model group forward per row-parallel projection, one backward per
column-parallel one), and the step (`train/step.py::make_tp_train_step`)
puts together the gradients of the replicated leaves that each rank uses
only in part (`tp_reduce_grads`): a bias or per-channel alpha sliced to
this rank's columns, pos_bias_u/v sliced to its heads, and a scalar alpha
(or a row-parallel one), whose gradient sums over this rank's part of the
kernel. Their gradients are summed over the model group; a row-parallel
bias's is already whole, as is every other replicated leaf's, and is taken
from the group's first rank, since two ranks' copies of one computation
may differ in their last bits on the card.

The port shards whole heads, so the model axis must divide enc_heads and
enc_d_ff (`check_tp`); JAX's partitioner takes any size.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from onebit_asr_tpu_torch.parallel.fsdp import _copy_generator
from onebit_asr_tpu_torch.train.state import TrainState

Spec = Tuple[Optional[str], ...]

# QATDense module names -> which matmul dim to shard
_COLUMN_PARALLEL = {"w1", "q_proj", "k_proj", "v_proj", "pos_proj"}
_ROW_PARALLEL = {"w2", "out_proj"}


def _spec_for(name: str, ndim: int, model_axis: str) -> Spec:
    """JAX's PartitionSpec of the leaf `name` (a state-dict name), as a
    tuple: `model_axis` at the dim that shards; () when it replicates."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[-1] == "kernel":
        owner = parts[-2]
        if owner in _COLUMN_PARALLEL:
            return (None,) * (ndim - 1) + (model_axis,)
        if owner in _ROW_PARALLEL:
            return (None,) * (ndim - 2) + (model_axis, None)
    return ()


def _partial(name: str) -> bool:
    """Whether each rank's gradient of the replicated leaf `name` covers
    only its part (sliced to its columns or heads, or summed over its part
    of a kernel): all but the kernels and the row-parallel bias of the
    sharded projections, and pos_bias_u/v."""
    parts = name.split(".")
    if parts[-1] in ("pos_bias_u", "pos_bias_v"):
        return True
    if len(parts) < 2 or parts[-2] not in _COLUMN_PARALLEL | _ROW_PARALLEL:
        return False
    return parts[-1] == "alpha" or (parts[-1] == "bias" and parts[-2] in _COLUMN_PARALLEL)


def _check_axis(mesh, model_axis: str) -> None:
    if model_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {model_axis!r}: {mesh.axis_names}")


def tp_param_shardings(params: Dict[str, torch.Tensor], mesh,
                       model_axis: str = "model") -> Dict[str, Spec]:
    """{name: spec} of the Megatron layout of full-size `params`."""
    _check_axis(mesh, model_axis)
    return {k: _spec_for(k, v.dim(), model_axis) for k, v in params.items()}


def tp_state_shardings(state: TrainState, mesh,
                       model_axis: str = "model") -> Dict[str, Dict[str, Spec]]:
    """The layout of a whole TrainState: {"params" | "mu" | "nu": {name:
    spec}}, the moments as their parameters; the step, the count and the
    generator replicate."""
    specs = tp_param_shardings(state.params, mesh, model_axis)
    return {"params": specs, "mu": dict(specs), "nu": dict(specs)}


def _dim(spec: Spec) -> int:
    """The dim that shards, or -1."""
    return next((d for d, a in enumerate(spec) if a is not None), -1)


def _part(v: torch.Tensor, spec: Spec, n: int, i: int) -> torch.Tensor:
    d = _dim(spec)
    return (v if d < 0 else v.chunk(n, dim=d)[i]).detach().clone()


def shard_params_tp(params: Dict[str, torch.Tensor], mesh,
                    model_axis: str = "model") -> Dict[str, torch.Tensor]:
    """This rank's parameters: each sharded kernel's contiguous 1/TP along
    its dim, the others whole; all new tensors."""
    specs = tp_param_shardings(params, mesh, model_axis)
    n, i = mesh.axis_size(model_axis), mesh.index(model_axis)
    return {k: _part(v, specs[k], n, i) for k, v in params.items()}


def shard_state_tp(state: TrainState, mesh, model_axis: str = "model") -> TrainState:
    """This rank's part of a full-size `state` (left as it is): params, mu
    and nu by `tp_state_shardings`, all new tensors."""
    return TrainState(step=state.step, params=shard_params_tp(state.params, mesh, model_axis),
                      mu=shard_params_tp(state.mu, mesh, model_axis),
                      nu=shard_params_tp(state.nu, mesh, model_axis), count=state.count,
                      generator=_copy_generator(state.generator))


def _gather(shard: torch.Tensor, spec: Spec, n: int, group) -> torch.Tensor:
    d = _dim(spec)
    if d < 0 or group is None:
        return shard
    parts = [torch.empty_like(shard) for _ in range(n)]
    dist.all_gather(parts, shard.contiguous(), group=group)
    return torch.cat(parts, dim=d)


def gather_state_tp(state: TrainState, mesh, model_axis: str = "model") -> TrainState:
    """The full-size state from the model group's shards, in a one-process
    run's format (checkpoints, evaluation). Collective over the model axis:
    every rank of the group calls it; each gets the whole state."""
    _check_axis(mesh, model_axis)
    n, group = mesh.axis_size(model_axis), mesh.group_of(model_axis)
    with torch.no_grad():
        def full(d_):
            return {k: _gather(v, _spec_for(k, v.dim(), model_axis), n, group)
                    for k, v in d_.items()}

        return TrainState(step=state.step, params=full(state.params), mu=full(state.mu),
                          nu=full(state.nu), count=state.count, generator=state.generator)


def check_tp(cfg, size: int) -> str:
    """Why a model axis of `size` cannot split `cfg` (a ModelConfig), or
    "": the port shards whole heads and whole d_ff columns."""
    for what, n in (("enc_heads", cfg.enc_heads), ("enc_d_ff", cfg.enc_d_ff)):
        if n % size:
            return (f"--tensor_parallel {size} does not divide {what} {n} (the port shards "
                    "whole heads and feed-forward columns)")
    return ""


def tp_reduce_grads(grads: Dict[str, torch.Tensor], mesh, data_axis: str = "data",
                    model_axis: str = "model") -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(gradients, global norm) of a tensor-parallel step from each rank's
    raw gradients. One all-reduce over the model group puts the replicated
    leaves together: the partial leaves' (`_partial`) parts are summed, and
    the leaves that every rank computes whole count once, from the group's
    first rank (the others add zeros), so that every rank keeps the same
    bits even where the card's kernels do not repeat them (atomics). Then
    every leaf is averaged over the data axis (the losses sum over it: each
    rank's gradient is data-size x its rows' share), and the norm takes the
    sharded kernels' squares summed over the model group, the replicated
    leaves' once."""
    model_group = mesh.group_of(model_axis)
    names = list(grads)
    sharded = [_dim(_spec_for(k, grads[k].dim(), model_axis)) >= 0 for k in names]
    if model_group is not None:
        first = mesh.index(model_axis) == 0
        replicated = [k for k, s in zip(names, sharded) if not s]
        flat = torch.cat([(grads[k] if first or _partial(k) else torch.zeros_like(grads[k]))
                          .reshape(-1) for k in replicated])
        dist.all_reduce(flat, group=model_group)
        at = 0
        for k in replicated:
            grads[k] = flat[at : at + grads[k].numel()].view_as(grads[k])
            at += grads[k].numel()
    if mesh.axis_size(data_axis) > 1:
        grads = mesh.mean(grads, data_axis)
    sharded = torch.tensor(sharded)
    sq = torch.stack([torch.sum(grads[k].to(torch.float32) * grads[k].to(torch.float32))
                      for k in names])
    if model_group is not None:
        sharded = sharded.to(sq.device)
        total = torch.where(sharded, sq, torch.zeros_like(sq))
        dist.all_reduce(total, group=model_group)
        sq = torch.where(sharded, total, sq)
    return grads, torch.sqrt(sum(sq.unbind()))

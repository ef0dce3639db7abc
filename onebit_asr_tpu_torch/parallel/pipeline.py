"""Pipeline parallelism (GPipe) for the 3-branch QAT train step.

Counterpart of onebit_asr_tpu/parallel/pipeline.py on torch.distributed.
The ranks form a ("data", "stage") mesh of shape (n / S, S), consecutive
ranks one stage group. The encoder's blocks shard over "stage": rank p of a
group holds the L/S consecutive blocks `p*L/S .. (p+1)*L/S - 1` and their
AdamW moments (`shard_state_pipeline`), everything else is whole on every
rank, and the batch shards over "data". Each branch's encoder runs its
blocks as a microbatch pipeline (model/conformer.py::ConformerEncoder.
_pipelined_blocks: `ring_shift` between ticks, `all_sum` of the finished
microbatches); autograd's backward of those collectives is the reverse
pipeline.

Why the step equals the one-process step (JAX's argument, pipeline.py:
12-28): with a per-sample conv norm the pipelined blocks compute what the
plain stack computes (batch norm over microbatches is the GPipe-BN problem
and is refused). Everything outside the blocks runs on every stage (the
subsampler on stage 0 alone), so each stage's loss is scaled by 1/S; the
`all_sum`'s backward then delivers the true cotangent into the pipe, and a
sum over "stage" of the non-block gradients gives their true values. The
block gradients are whole and stage-local. The global-norm clip takes the
true norm: the block leaves' squares summed over the stage group, the
others' once (`pipeline_reduce_grads`, AdamW's `g_norm`).

Dropout: JAX folds only the data index into the branch keys. Here every
stage draws the data-parallel step's bytes for its rows, every block's in
the one-process order, and keeps its own blocks' (model/layers.py::
StageDraws), so the pipelined step equals the data-parallel step at any
dropout, and the one-process step at a data axis of 1.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from onebit_asr_tpu_torch.model.layers import PipelineStage
from onebit_asr_tpu_torch.parallel.fsdp import _copy_generator
from onebit_asr_tpu_torch.train.state import TrainState

Spec = Tuple  # ("stage", k): held whole by stage k; (): on every rank

_BLOCK = re.compile(r"^encoder\.blocks\.(\d+)\.")


def block_index(name: str) -> Optional[int]:
    """The encoder block a state-dict name belongs to, or None."""
    m = _BLOCK.match(name)
    return int(m.group(1)) if m else None


def pipeline_error(conv_norm: str, num_layers: int, stages: int,
                   local_batch: Optional[int] = None, microbatches: Optional[int] = None) -> str:
    """JAX's ValueError message for a pipeline that cannot run (enc_layers
    not divisible by the stages, a batch-norm conv module, a local batch
    the microbatches do not divide), or ""."""
    if num_layers % stages:
        return f"enc_layers {num_layers} not divisible by {stages} stages"
    if conv_norm == "batch_norm":
        return ("pipeline parallelism requires conv_norm in {group_norm, layer_norm}: "
                "BatchNorm statistics cannot sync across ticks")
    if local_batch is not None and local_batch % microbatches:
        return f"local batch {local_batch} not divisible by microbatches {microbatches}"
    return ""


def _num_blocks(names) -> int:
    return 1 + max(i for i in map(block_index, names) if i is not None)


def pipeline_state_specs(state: TrainState, mesh,
                         stage_axis: str = "stage") -> Dict[str, Dict[str, Spec]]:
    """The layout of a full-size state: {"params" | "mu" | "nu": {name:
    spec}}, the spec of block i's leaves ("stage", i // (L/S)), held whole by
    that stage, and () for every other leaf (on every rank). JAX's
    `pipeline_spec_tree` shards the stacked [L, ...] block leaves over the
    stage axis, which puts the same layers on the same stages."""
    S = mesh.axis_size(stage_axis)
    per = _num_blocks(state.params) // S

    def spec(name):
        i = block_index(name)
        return () if i is None else (stage_axis, i // per)

    specs = {k: spec(k) for k in state.params}
    return {"params": specs, "mu": dict(specs), "nu": dict(specs)}


def shard_state_pipeline(state: TrainState, mesh, stage_axis: str = "stage") -> TrainState:
    """This rank's part of a full-size `state` (left as it is): the leaves
    of its stage's blocks and every other leaf, of params, mu and nu, all new
    tensors."""
    specs = pipeline_state_specs(state, mesh, stage_axis)["params"]
    stage = mesh.index(stage_axis)

    def part(d_):
        return {k: v.detach().clone() for k, v in d_.items()
                if not specs[k] or specs[k][1] == stage}

    return TrainState(step=state.step, params=part(state.params), mu=part(state.mu),
                      nu=part(state.nu), count=state.count,
                      generator=_copy_generator(state.generator))


def gather_state_pipeline(state: TrainState, mesh, stage_axis: str = "stage") -> TrainState:
    """The full-size state from the stage group's parts, in a one-process
    run's format and order (checkpoints, evaluation): one all_gather over the
    stage axis of every stage's blocks (params, mu and nu). Collective: every
    rank of the group calls it; each gets the whole state."""
    S, group = mesh.axis_size(stage_axis), mesh.group_of(stage_axis)
    if group is None or S == 1:
        return state
    parts = ("params", "mu", "nu")
    mine = [k for k in state.params if block_index(k) is not None]
    first = block_index(mine[0])
    per = len({block_index(k) for k in mine})
    with torch.no_grad():
        flat = torch.cat([getattr(state, p)[k].reshape(-1) for p in parts for k in mine])
        got = [torch.empty_like(flat) for _ in range(S)]
        dist.all_gather(got, flat, group=group)
        blocks = {p: {} for p in parts}  # every stage's blocks, in block order
        for stage, buf in enumerate(got):
            at = 0
            for p in parts:
                for k in mine:
                    v = getattr(state, p)[k]
                    leaf = k.split(".", 3)[3]
                    i = stage * per + block_index(k) - first
                    blocks[p][f"encoder.blocks.{i}.{leaf}"] = buf[at : at + v.numel()].view_as(v)
                    at += v.numel()
        full = {p: {} for p in parts}
        for k in state.params:  # every block where this rank's blocks stand
            for p in parts:
                if block_index(k) is None:
                    full[p][k] = getattr(state, p)[k]
                elif k == mine[0]:
                    full[p].update(blocks[p])
    return TrainState(step=state.step, **full, count=state.count, generator=state.generator)


def pipeline_stage(mesh, stage_axis: str = "stage", microbatches: int = 2) -> PipelineStage:
    """This rank's PipelineStage on `mesh`: its stage group, index and ring
    neighbours (global ranks)."""
    S = mesh.axis_size(stage_axis)
    d = mesh.axis_names.index(stage_axis)
    index = list(mesh.coords)
    line = []
    for p in range(S):
        index[d] = p
        line.append(int(np.asarray(mesh.ranks).reshape(mesh.shape)[tuple(index)]))
    s = mesh.coords[d]
    return PipelineStage(mesh.group_of(stage_axis) if S > 1 else None, S, s, microbatches,
                         line[(s + 1) % S], line[(s - 1) % S])


def pipeline_reduce_grads(grads: Dict[str, torch.Tensor], mesh, data_axis: str = "data",
                          stage_axis: str = "stage") -> Tuple[Dict[str, torch.Tensor],
                                                              torch.Tensor]:
    """(gradients, global norm) of a pipelined step from each rank's raw
    gradients: the non-block leaves summed over the stages (and averaged
    over the data axis) in one all-reduce over the mesh, the block leaves
    averaged over the data axis; the norm is the block leaves' squares
    summed over the stage group plus the others' once (JAX pipeline.py:
    141-174). Every rank ends with the same non-block bits."""
    n_data = mesh.axis_size(data_axis)
    blocks = [k for k in grads if block_index(k) is not None]
    rest = [k for k in grads if block_index(k) is None]
    if mesh.group is not None:
        flat = torch.cat([grads[k].reshape(-1) for k in rest])
        dist.all_reduce(flat, group=mesh.group)
        if n_data > 1:
            flat = flat / n_data
        at = 0
        for k in rest:
            grads[k] = flat[at : at + grads[k].numel()].view_as(grads[k])
            at += grads[k].numel()
        if n_data > 1:
            grads.update(mesh.mean({k: grads[k] for k in blocks}, data_axis))

    def squares(names):
        return sum(torch.sum(grads[k].to(torch.float32) * grads[k].to(torch.float32))
                   for k in names)

    sq = squares(blocks)
    stage_group = mesh.group_of(stage_axis)
    if stage_group is not None and mesh.axis_size(stage_axis) > 1:
        dist.all_reduce(sq, group=stage_group)
    return grads, torch.sqrt(sq + squares(rest))


def make_pipeline_train_step(model, optimizer, loss_cfg, specials, num_enc_layers: int, mesh,
                             microbatches: int = 2, data_axis: str = "data",
                             stage_axis: str = "stage"):
    """The pipelined 3-branch QAT step over a (data x stage) mesh (JAX
    parallel/pipeline.py::make_pipeline_train_step): train_step(
    sharded_state, local_batch) -> (sharded_state, aux). The state is this
    rank's part (`shard_state_pipeline`), the batch its rows along
    `data_axis` (`shard_batch(batch, mesh, data_axis)`), split into
    `microbatches` microbatches along B. Each branch's loss is scaled by 1/S;
    the gradients go through `pipeline_reduce_grads`, and AdamW clips on its
    global norm. aux holds the unscaled losses and grad_norm, the same on
    every rank. ValueError (JAX's messages) for enc_layers not divisible by
    the stages or a batch-norm conv module; the forward raises for a local
    batch the microbatches do not divide."""
    from onebit_asr_tpu_torch.train.step import _make_step, make_batch_loss

    S = mesh.axis_size(stage_axis)
    why = pipeline_error(model.cfg.conv_norm, num_enc_layers, S)
    if why:
        raise ValueError(why)
    n_data = mesh.axis_size(data_axis)
    batch_loss = make_batch_loss(model, loss_cfg, specials, num_enc_layers,
                                 mesh.group_of(data_axis) if n_data > 1 else None,
                                 pipe=pipeline_stage(mesh, stage_axis, microbatches))

    def scaled_loss(*args):
        # 1/S: the S stages compute this same loss; all_sum's backward sums
        # their cotangents into the pipe
        total, aux = batch_loss(*args)
        return total / S, aux

    return _make_step(model, scaled_loss, optimizer, loss_cfg, num_enc_layers, 1, mesh,
                      (data_axis,),
                      lambda grads: pipeline_reduce_grads(grads, mesh, data_axis, stage_axis),
                      fold=n_data > 1)

"""Process meshes and the data-parallel collectives.

Counterpart of onebit_asr_tpu/parallel/mesh.py on `torch.distributed`. JAX
lays a `jax.sharding.Mesh` over devices and lets `shard_map` bodies name its
axes; here each rank is one process, and a `Mesh` records the process group,
the axis names, the shape, this rank's coordinates and one subgroup per
axis. Data parallelism is explicit: each rank keeps its rows of the batch
(`shard_batch`, JAX's `P(axis)` layout), the losses and the batch norm sum
their statistics over the mesh (`utils/collectives.py::all_sum`,
differentiable, like JAX's `psum`), and the gradients are averaged
(`Mesh.mean`).

Without an initialized process group the world is one rank, the mesh has
no group, and every collective below is the identity: a one-process run
computes what it computed before.

JAX's `constrain` is not ported: it is a layout hint for XLA's partitioner
and means nothing under explicit collectives.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


@dataclass
class Mesh:
    """A grid of ranks. `group` spans the mesh (None: one process, no
    collective); `ranks` lists its global ranks in row-major order over
    `shape`; `coords` is this rank's position (None for a rank outside the
    mesh); `axis_groups[name]` is the subgroup of this rank's line along
    that axis."""

    group: Optional[object]
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    ranks: Tuple[int, ...]
    coords: Optional[Tuple[int, ...]]
    axis_groups: Dict[str, Optional[object]] = field(default_factory=dict)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def member(self) -> bool:
        return self.coords is not None

    def axis_size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[self.axis_names.index(a)] for a in _names(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's row-major index over `axes` (JAX's P(axes) order:
        dcn * data_size + data)."""
        i = 0
        for a in _names(axes):
            d = self.axis_names.index(a)
            i = i * self.shape[d] + self.coords[d]
        return i

    def group_of(self, axes: Axes):
        """The group that reduces over `axes`: the mesh's for all of them,
        an axis group for one."""
        names = _names(axes)
        if set(names) == set(self.axis_names):
            return self.group
        if len(names) == 1:
            return self.axis_groups[names[0]]
        raise ValueError(f"no group over {names} of a mesh {self.axis_names}")

    def mean(self, tensors: Dict[str, torch.Tensor], axes: Axes) -> Dict[str, torch.Tensor]:
        """{name: tensor} averaged over `axes`: one summing all-reduce per
        axis, the last axis first (within a slice, then across slices),
        over all tensors flattened into one buffer; then / their size."""
        names = _names(axes)
        if self.group is None:
            return tensors
        keys = list(tensors)
        flat = torch.cat([tensors[k].reshape(-1) for k in keys])
        for a in reversed(names):
            dist.all_reduce(flat, group=self.group_of(a))
        flat = flat / self.axis_size(names)
        out, at = {}, 0
        for k in keys:
            t = tensors[k]
            out[k] = flat[at : at + t.numel()].view_as(t)
            at += t.numel()
        return out


def _names(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def world() -> Tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _build(shape: Tuple[int, ...], axes: Tuple[str, ...], ranks: List[int]) -> Mesh:
    rank, size = world()
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(f"mesh shape {shape} != #ranks {len(ranks)}")
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not name the dims of shape {shape}")
    coords = None
    if rank in ranks:
        coords = tuple(int(c) for c in np.unravel_index(ranks.index(rank), shape))
    if not dist.is_available() or not dist.is_initialized():
        return Mesh(None, axes, shape, tuple(ranks), coords, {a: None for a in axes})
    # new_group is collective over the world: every rank makes every group
    group = dist.group.WORLD if len(ranks) == size else dist.new_group(ranks)
    grid = np.asarray(ranks).reshape(shape)
    axis_groups = {}
    for d, a in enumerate(axes):
        if len(shape) == 1:
            axis_groups[a] = group
            continue
        others = [range(n) for i, n in enumerate(shape) if i != d]
        for rest in itertools.product(*others):
            index = list(rest)
            index.insert(d, slice(None))
            line = [int(r) for r in grid[tuple(index)]]
            g = dist.new_group(line)
            if rank in line:
                axis_groups[a] = g
    return Mesh(group if coords is not None else None, axes, shape, tuple(ranks), coords,
                axis_groups)


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axes: Tuple[str, ...] = ("data",),
              ranks: Optional[Iterable[int]] = None) -> Mesh:
    """A mesh over every rank of the process group (or the global `ranks`
    given, in order). Default: one `data` axis over all of them. Every rank
    of the world must call it (making a subgroup is collective); a rank
    outside `ranks` gets a mesh with `member` False."""
    ranks = list(range(world()[1]) if ranks is None else ranks)
    if shape is None:
        shape = (len(ranks),)
    return _build(tuple(shape), tuple(axes), ranks)


def make_multislice_mesh(num_slices: Optional[int] = None,
                         axes: Tuple[str, str] = ("dcn", "data")) -> Mesh:
    """The two-level data-parallel mesh: `dcn` = num_slices groups of
    world / num_slices consecutive ranks, `data` within each. Batches shard
    over both axes (`shard_batch(..., axis=("dcn", "data"))`); the gradient
    mean runs within each slice, then across slices. Raises JAX's
    ValueErrors (parallel/mesh.py:45-88): there is no slice topology to
    read here, so `num_slices` must be given and above 1."""
    n = world()[1]
    if num_slices is None or num_slices <= 1:
        raise ValueError(
            "single-slice topology: pass num_slices>1 to simulate DCN "
            "grouping (tests), or use make_mesh for a flat data axis"
        )
    if n % num_slices:
        raise ValueError(f"{n} devices not divisible by {num_slices}")
    return _build((num_slices, n // num_slices), tuple(axes), list(range(n)))


def local_rows(batch_size: int, index: int, n: int, micro: int = 1) -> np.ndarray:
    """The rows of a batch of `batch_size` that shard `index` of `n` keeps:
    of each of the `micro` consecutive micro-batches, its contiguous
    1/n. With micro = 1 that is rows [index * B/n, (index+1) * B/n)."""
    if batch_size % (n * micro):
        raise ValueError(f"batch {batch_size} not divisible by {n} shards x {micro} "
                         "micro-batches")
    m = batch_size // (n * micro)
    return np.concatenate([np.arange(i * (batch_size // micro) + index * m,
                                     i * (batch_size // micro) + (index + 1) * m)
                           for i in range(micro)])


def shard_batch(batch: Dict, mesh: Mesh, axis: Axes = "data", micro: int = 1) -> Dict:
    """This rank's rows of every batch entry (numpy arrays, tensors or
    lists, leading dim B): `local_rows(B, mesh.index(axis), size, micro)`.
    With `micro` > 1 the union of the ranks' micro-batch i is micro-batch i
    of the whole batch, as a one-process step splits it."""
    n = mesh.axis_size(axis)
    if n == 1:
        return dict(batch)
    B = len(next(iter(batch.values())))
    rows = local_rows(B, mesh.index(axis), n, micro)
    contiguous = micro == 1
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = [v[int(i)] for i in rows]
        elif contiguous:
            out[k] = v[int(rows[0]) : int(rows[-1]) + 1]
        else:
            out[k] = v[torch.from_numpy(rows).to(v.device)] if isinstance(v, torch.Tensor) \
                else v[rows]
    return out


def replicate(state, mesh: Mesh):
    """Broadcast a TrainState (or a {name: tensor} dict) from the mesh's
    first rank to the others, in place: the parameters, the moments, and
    the step, count and generator state. Returns it."""
    if mesh.group is None:
        return state
    src = mesh.ranks[0]
    tensors = state if isinstance(state, dict) else {
        **{("p", k): v for k, v in state.params.items()},
        **{("m", k): v for k, v in state.mu.items()},
        **{("v", k): v for k, v in state.nu.items()}}
    with torch.no_grad():
        for t in tensors.values():
            dist.broadcast(t, src=src, group=mesh.group)
    if not isinstance(state, dict):
        box = [(state.step, state.count, state.generator.get_state())]
        dist.broadcast_object_list(box, src=src, group=mesh.group)
        state.step, state.count = box[0][0], box[0][1]
        state.generator.set_state(box[0][2])
    return state

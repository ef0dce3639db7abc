"""Building blocks: quantized dense (packed serving form and QAT form),
dense, f32 norms (layer, masked batch and masked group norm), dropout from
uint8 draws, position tables.

Counterparts of onebit_asr_tpu/model/layers.py. Each dense module keeps the
JAX module's dtype order: operands in the compute dtype (bf16 by default),
products accumulated in f32, bias added in f32, then a cast back to the
compute dtype. Norms compute in f32.

Weights are loaded from a JAX parameter tree by `convert.py`; the modules
allocate them uninitialised.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from onebit_asr_tpu_torch.ops.attention import drop_threshold
from onebit_asr_tpu_torch.ops.quant import ALPHA_EPS, BitSpec, quantize_weight
from onebit_asr_tpu_torch.ops.ternary_matmul import (
    ternary_matmul,
    ternary_matmul_w2a8,
)
from onebit_asr_tpu_torch.utils.collectives import all_sum, copy_to_model, reduce_from_model


class QuantDense(nn.Module):
    """Serving form of the quantized dense layer (QuantDense with
    packed=True, layers.py:107-143): planar-packed 2-bit weights [K//4, N],
    a tensor-wise alpha and an f32 bias. y = cast(matmul(x, packed,
    |alpha| + eps) + bias), where `matmul` is `ternary_matmul` (bf16
    activations) or, with `int8_act`, `ternary_matmul_w2a8` (per-row int8
    activations, the ONEBIT_PACKED_INT8_ACT=1 path of the JAX package).

    `matmul` is a plain attribute: any function with the same signature (a
    plain version, say) can take its place."""

    def __init__(self, in_features: int, features: int, compute_dtype: torch.dtype,
                 int8_act: bool = False):
        super().__init__()
        if in_features % 4:
            raise ValueError(f"in_features {in_features} not a multiple of 4")
        self.in_features = in_features
        self.features = features
        self.compute_dtype = compute_dtype
        self.matmul = ternary_matmul_w2a8 if int8_act else ternary_matmul
        self.register_buffer(
            "packed_kernel", torch.empty(in_features // 4, features, dtype=torch.int8)
        )
        self.register_buffer("alpha", torch.empty((), dtype=torch.float32))
        self.register_buffer("bias", torch.empty(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor, bits: Optional[BitSpec] = None,
                tp: Optional["ModelShard"] = None) -> torch.Tensor:
        """`bits` and `tp` are accepted for the signature of `QATDense`: the
        packed weights hold the precision they were exported at, and serving
        has no model axis."""
        if tp is not None:
            raise ValueError("the packed serving form does not run tensor-parallel")
        lead = x.shape[:-1]
        y = self.matmul(
            x.reshape(-1, self.in_features).to(self.compute_dtype),
            self.packed_kernel,
            self.alpha.abs() + ALPHA_EPS,
        ).reshape(*lead, self.features)
        return (y + self.bias).to(self.compute_dtype)


@dataclass(frozen=True)
class ModelShard:
    """This rank's part of a tensor-parallel call (parallel/sharding_rules.py):
    its heads and feature columns are part `index` of `size` along the
    mesh's model axis, whose ranks hold the same rows and sum over `group`;
    its rows are part `row_index` of `row_parts` of the batch. Every rank
    draws each dropout site's bytes for the whole batch and all heads and
    features, and keeps its part: the draws of the one-process step."""

    group: object
    size: int
    index: int
    row_parts: int = 1
    row_index: int = 0

    def part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous 1/size of `t` along `dim`."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)


@dataclass(frozen=True)
class PipelineStage:
    """This rank's part of a pipelined call (parallel/pipeline.py): stage
    `index` of `size` along the mesh's stage axis, holding the consecutive
    blocks `blocks(L)`; its ranks pass activations over `group` on the ring
    `prev` -> this rank -> `nxt` (global ranks), `microbatches` microbatches
    of its rows a call. `group` None: one process, one stage."""

    group: object
    size: int
    index: int
    microbatches: int
    nxt: int
    prev: int

    def blocks(self, num_layers: int) -> range:
        n = num_layers // self.size
        return range(self.index * n, (self.index + 1) * n)


class StageDraws:
    """The dropout bytes of a pipeline stage's blocks: `sites[j]` are local
    block j's draws for the whole local batch, in the order its forward
    makes them. `at(j, m)` points the next draws at block j's microbatch m;
    each draw then takes the next site's rows of that microbatch, and
    `done()` checks that the block took every site."""

    def __init__(self, sites, microbatches: int):
        self.sites = sites
        self.microbatches = microbatches
        self.block = self.micro = self.next = 0

    def at(self, block: int, micro: int) -> None:
        self.block, self.micro, self.next = block, micro, 0

    def take(self, shape) -> torch.Tensor:
        site = self.sites[self.block][self.next]
        rows = site.shape[0] // self.microbatches
        out = site.narrow(0, self.micro * rows, rows)
        if tuple(out.shape) != tuple(shape):
            raise RuntimeError(f"block {self.block} draw {self.next}: {tuple(shape)} asked, "
                               f"{tuple(out.shape)} drawn (ConformerBlock.dropout_shapes)")
        self.next += 1
        return out

    def done(self) -> None:
        if self.next != len(self.sites[self.block]):
            raise RuntimeError(f"block {self.block} took {self.next} of "
                               f"{len(self.sites[self.block])} draws")


class QATDense(nn.Module):
    """Training form of the quantized dense layer (QuantDense with
    packed=False, layers.py:145-167): an f32 kernel [in, out], an alpha (a
    scalar, or [out] with `per_channel`) and an f32 bias; each call
    quantizes the kernel at its own `bits` (1, 2, 32 or a bool, True =
    binary) with the straight-through quantizer, so one parameter set serves
    every branch. y = cast(x @ W_hat + bias): operands rounded to the
    compute dtype, summed in f32.

    `parallel` ("column", "row" or None) is its part in a tensor-parallel
    call (`tp`, a ModelShard; None: the whole layer). Column-parallel, the
    kernel is this rank's output columns, and the bias and a per-channel
    alpha are sliced to them; the f32 input goes through `copy_to_model`.
    Row-parallel, the kernel is this rank's input rows: the f32 partial
    products are summed over the model group (`reduce_from_model`), then the
    bias is added once."""

    def __init__(self, in_features: int, features: int, compute_dtype: torch.dtype,
                 per_channel: bool = False, parallel: Optional[str] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.parallel = parallel
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.alpha = nn.Parameter(torch.empty((features,) if per_channel else ()))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor, bits: BitSpec,
                tp: Optional[ModelShard] = None) -> torch.Tensor:
        cd, f32 = self.compute_dtype, torch.float32
        column = tp is not None and self.parallel == "column"
        alpha, bias = self.alpha, self.bias
        if column:
            bias = tp.part(bias, 0)
            alpha = tp.part(alpha, 0) if alpha.dim() else alpha
        w = quantize_weight(self.kernel, alpha, bits)
        xf = x.to(cd).to(f32)
        if column:
            xf = copy_to_model(xf, tp.group)
        y = torch.matmul(xf, w.to(cd).to(f32))
        if tp is not None and self.parallel == "row":
            y = reduce_from_model(y, tp.group)
        return (y + bias).to(cd)


class DropoutRng:
    """Where the FastDropout layers of one model take their uint8 draws:
    `draws(shape, device)` returns uniform bytes, or is None (dropout off,
    as in evaluation). A training forward sets it for one call
    (`generator_draws`); a test can set any function, JAX's own draws say.
    A tensor-parallel call also sets `shard` (a ModelShard), and `draw`
    then draws the whole operand and keeps this rank's part. A pipeline
    stage's blocks take theirs from `replay` (StageDraws) while it is set."""

    def __init__(self):
        self.draws: Optional[Callable[[Tuple[int, ...], torch.device], torch.Tensor]] = None
        self.shard: Optional[ModelShard] = None
        self.replay: Optional[StageDraws] = None

    def draw(self, shape, device, model_dim: Optional[int] = None) -> torch.Tensor:
        """The bytes of a site whose operand here has `shape` (batch first;
        `model_dim`, if any, split over the model axis)."""
        if self.replay is not None:
            return self.replay.take(shape)
        tp = self.shard
        if tp is None:
            return self.draws(tuple(shape), device)
        full = list(shape)
        full[0] *= tp.row_parts
        if model_dim is not None:
            full[model_dim] *= tp.size
        out = self.draws(tuple(full), device).narrow(0, tp.row_index * shape[0], shape[0])
        return (out if model_dim is None else tp.part(out, model_dim)).contiguous()


def generator_draws(generator: torch.Generator):
    """`DropoutRng.draws` from a torch.Generator on the tensors' device."""
    def draws(shape, device):
        return torch.randint(0, 256, tuple(shape), dtype=torch.uint8, device=device,
                             generator=generator)
    return draws


def fast_dropout(x: torch.Tensor, rate: float, drop8: torch.Tensor) -> torch.Tensor:
    """FastDropout's arithmetic (layers.py:225-278): keep an element iff its
    uint8 draw is >= k = round(rate * 256), scaled by 256 / (256 - k)
    rounded to x's dtype."""
    k = drop_threshold(rate)
    if k <= 0:
        return x
    if k >= 256:
        return torch.zeros_like(x)
    scale = torch.tensor(256.0 / (256 - k), dtype=x.dtype, device=x.device)
    return torch.where(drop8 >= k, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


class FastDropout(nn.Module):
    """Dropout from uint8 draws (layers.py:197-278), active while its
    DropoutRng has draws. `model_dim`: the dim of its operand that a
    tensor-parallel call splits over the model axis, if any."""

    def __init__(self, rate: float, rng: DropoutRng, model_dim: Optional[int] = None):
        super().__init__()
        self.rate = rate
        self.rng = rng
        self.model_dim = model_dim

    @property
    def active(self) -> bool:
        return self.rng.draws is not None and drop_threshold(self.rate) > 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.active:
            return x
        return fast_dropout(x, self.rate, self.rng.draw(x.shape, x.device, self.model_dim))

    def skip(self, shape, device) -> None:
        """Draw (and drop) the bytes a call on an operand of `shape` would
        take, so that later sites draw what they would have drawn."""
        if self.active:
            self.rng.draw(tuple(shape), device, self.model_dim)


class Dense(nn.Module):
    """Full-precision dense: weight [out, in] (the JAX kernel transposed).
    Operands are rounded to the compute dtype and summed in f32, as
    `jnp.dot(..., preferred_element_type=float32)`: products of bf16 values
    are exact in f32."""

    def __init__(self, in_features: int, features: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor, bits: Optional[BitSpec] = None) -> torch.Tensor:
        """`bits` is accepted for the signature of `QATDense`: a Dense layer
        is full precision at every branch."""
        cd, f32 = self.compute_dtype, torch.float32
        y = torch.nn.functional.linear(x.to(cd).to(f32), self.weight.to(cd).to(f32))
        return (y + self.bias).to(cd)


class LayerNorm(nn.Module):
    """LayerNorm in f32 whatever the activation dtype; output in the input's
    dtype."""

    def __init__(self, dim: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(dim))  # flax "scale"
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight + self.bias).to(x.dtype)


class MaskedBatchNorm(nn.Module):
    """Batch normalization over valid frames only, in f32 (layers.py:354-395).

    Statistics come from the current batch at inference too (the reference's
    track_running_stats=False), so an utterance's output depends on which
    utterances share its batch. With a process `group` (sync-BN under data
    parallelism, JAX's `axis_name`) the count and the sums are summed over
    the group's ranks, with autograd through the sums: `n` and `s1` in one
    all-reduce, then `sq`."""

    def __init__(self, dim: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(dim))  # flax "scale"
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor, group=None) -> torch.Tensor:
        # x: [B, T, C]; frame_mask: [B, T] (True = valid)
        x32 = x.to(torch.float32)
        m = frame_mask.to(torch.float32)[..., None]
        n = m.sum()
        s1 = (x32 * m).sum(dim=(0, 1))
        if group is not None:
            n_s1 = all_sum(torch.cat([n[None], s1]), group)
            n, s1 = n_s1[0], n_s1[1:]
        n = torch.clamp(n, min=1.0)
        mean = s1 / n
        sq = ((x32 - mean).square() * m).sum(dim=(0, 1))
        var = all_sum(sq, group) / n
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        return ((y * self.weight + self.bias) * m).to(x.dtype)


class MaskedGroupNorm(nn.Module):
    """Group normalization over valid frames only, in f32 (layers.py:398-430):
    per utterance and group of C / num_groups channels, the mean and
    variance over the valid frames; the output is masked."""

    def __init__(self, dim: int, num_groups: int = 32, epsilon: float = 1e-5):
        super().__init__()
        if dim % num_groups:
            raise ValueError(f"channels {dim} not divisible by groups {num_groups}")
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(dim))  # flax "scale"
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
        # x: [B, T, C]; frame_mask: [B, T] (True = valid)
        B, T, C = x.shape
        G = self.num_groups
        x32 = x.to(torch.float32).reshape(B, T, G, C // G)
        m = frame_mask.to(torch.float32)[:, :, None, None]
        n = torch.clamp(m.sum(dim=1, keepdim=True) * (C // G), min=1.0)
        mean = (x32 * m).sum(dim=(1, 3), keepdim=True) / n  # [B, 1, G, 1]
        var = ((x32 - mean).square() * m).sum(dim=(1, 3), keepdim=True) / n
        y = ((x32 - mean) * torch.rsqrt(var + self.epsilon)).reshape(B, T, C)
        return ((y * self.weight + self.bias) * frame_mask[..., None]).to(x.dtype)


def rel_positional_encoding(length: int, d_model: int) -> np.ndarray:
    """Sinusoidal table over relative offsets [L-1 .. -(L-1)] -> [2L-1, D]
    f32; row i encodes offset L-1-i."""
    pos = np.arange(length - 1, -length, -1, dtype=np.float64)[:, None]
    div = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model)
    )
    table = np.zeros((2 * length - 1, d_model), dtype=np.float64)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table.astype(np.float32)


def abs_positional_encoding(length: int, d_model: int) -> np.ndarray:
    """Sinusoidal absolute positions 0..L-1 -> [L, D] f32."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model)
    )
    table = np.zeros((length, d_model), dtype=np.float64)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table.astype(np.float32)


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask (True = valid)."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]

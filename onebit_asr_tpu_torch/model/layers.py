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

    def forward(self, x: torch.Tensor, bits: Optional[BitSpec] = None) -> torch.Tensor:
        """`bits` is accepted for the signature of `QATDense`: the packed
        weights hold the precision they were exported at."""
        lead = x.shape[:-1]
        y = self.matmul(
            x.reshape(-1, self.in_features).to(self.compute_dtype),
            self.packed_kernel,
            self.alpha.abs() + ALPHA_EPS,
        ).reshape(*lead, self.features)
        return (y + self.bias).to(self.compute_dtype)


class QATDense(nn.Module):
    """Training form of the quantized dense layer (QuantDense with
    packed=False, layers.py:145-167): an f32 kernel [in, out], an alpha (a
    scalar, or [out] with `per_channel`) and an f32 bias; each call
    quantizes the kernel at its own `bits` (1, 2, 32 or a bool, True =
    binary) with the straight-through quantizer, so one parameter set serves
    every branch. y = cast(x @ W_hat + bias): operands rounded to the
    compute dtype, summed in f32."""

    def __init__(self, in_features: int, features: int, compute_dtype: torch.dtype,
                 per_channel: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.alpha = nn.Parameter(torch.empty((features,) if per_channel else ()))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor, bits: BitSpec) -> torch.Tensor:
        cd, f32 = self.compute_dtype, torch.float32
        w = quantize_weight(self.kernel, self.alpha, bits)
        y = torch.matmul(x.to(cd).to(f32), w.to(cd).to(f32))
        return (y + self.bias).to(cd)


class DropoutRng:
    """Where the FastDropout layers of one model take their uint8 draws:
    `draws(shape, device)` returns uniform bytes, or is None (dropout off,
    as in evaluation). A training forward sets it for one call
    (`generator_draws`); a test can set any function, JAX's own draws say."""

    def __init__(self):
        self.draws: Optional[Callable[[Tuple[int, ...], torch.device], torch.Tensor]] = None


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
    DropoutRng has draws."""

    def __init__(self, rate: float, rng: DropoutRng):
        super().__init__()
        self.rate = rate
        self.rng = rng

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rng.draws is None or drop_threshold(self.rate) <= 0:
            return x
        return fast_dropout(x, self.rate, self.rng.draws(x.shape, x.device))


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
    utterances share its batch."""

    def __init__(self, dim: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(dim))  # flax "scale"
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
        # x: [B, T, C]; frame_mask: [B, T] (True = valid)
        x32 = x.to(torch.float32)
        m = frame_mask.to(torch.float32)[..., None]
        n = torch.clamp(m.sum(), min=1.0)
        mean = (x32 * m).sum(dim=(0, 1)) / n
        var = ((x32 - mean).square() * m).sum(dim=(0, 1)) / n
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

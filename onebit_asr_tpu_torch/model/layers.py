"""Building blocks: packed quantized dense, dense, f32 norms, position table.

Counterparts of onebit_asr_tpu/model/layers.py for the serving path. Each
module keeps the JAX module's dtype order: operands in the compute dtype
(bf16 by default), products accumulated in f32, bias added in f32, then a
cast back to the compute dtype. Norms compute in f32.

Weights are loaded from a JAX parameter tree by `convert.py`; the modules
allocate them uninitialised.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from onebit_asr_tpu_torch.ops.quant import ALPHA_EPS
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = self.matmul(
            x.reshape(-1, self.in_features).to(self.compute_dtype),
            self.packed_kernel,
            self.alpha.abs() + ALPHA_EPS,
        ).reshape(*lead, self.features)
        return (y + self.bias).to(self.compute_dtype)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask (True = valid)."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]

"""Conformer encoder, serving form (packed-ternary projections).

Counterpart of onebit_asr_tpu/model/conformer.py for offline serving: the
blocks run as a Python loop over `nn.ModuleList` (the JAX package scans over
stacked [L, ...] parameters; convert.py slices them), attention is plain
tensor code (the fused attention kernel is not ported yet), and the
subsampler is either the unfused conv stack or, with `fused=True`, the fused
CUDA kernel of ops/subsampler.py. Streaming variants (chunked attention,
causal conv) and the other conv norms are not implemented here and are
refused.

Layouts inside this package are PyTorch's: the subsampler convs are NCHW
with OIHW weights, and the unfused output flattens channel-major (index
c*F'+f); convert.py permutes the JAX weights to match, so outputs agree. The
fused branch flattens as JAX does (f*C+c), and convert.py then keeps the
JAX row order of the projection.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from onebit_asr_tpu_torch.model.layers import (
    Dense,
    LayerNorm,
    MaskedBatchNorm,
    QuantDense,
    lengths_to_mask,
    rel_positional_encoding,
)
from onebit_asr_tpu_torch.ops.subsampler import fused_subsample

NEG_INF = -1e9  # finite mask fill: softmax stays NaN-free even for all-pad rows


def subsampled_length(lengths: torch.Tensor) -> torch.Tensor:
    """Exact output length of two VALID k=3 s=2 convs: ((T-1)//2 - 1)//2,
    at least 1."""
    l1 = (lengths - 1) // 2
    l2 = (l1 - 1) // 2
    return torch.clamp(l2, min=1)


def subsampled_frames(t: int) -> int:
    """Frames out of the subsampler for t input frames (static shapes)."""
    return ((t - 3) // 2 + 1 - 3) // 2 + 1


def rel_shift_padded(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T] position scores whose column 0 is zero -> [B, H, T, T]
    with out[..., t, s] = x[..., t, T-t+s] (relative offset t-s)."""
    B, H, T = x.shape[:3]
    x = x.reshape(B, H, 2 * T, T)
    x = x[:, :, 1:, :].reshape(B, H, T, 2 * T - 1)
    return x[..., :T]


class FeedForward(nn.Module):
    """Macaron feed-forward: pre-LN -> QuantDense d->d_ff -> swish ->
    QuantDense d_ff->d."""

    def __init__(self, d: int, d_ff: int, compute_dtype: torch.dtype, int8_act: bool):
        super().__init__()
        self.ln = LayerNorm(d)
        self.w1 = QuantDense(d, d_ff, compute_dtype, int8_act)
        self.w2 = QuantDense(d_ff, d, compute_dtype, int8_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(self.ln(x))))


class RelPosMHSA(nn.Module):
    """Relative-position multi-head self-attention (Transformer-XL style),
    with the separate q/k/v/pos/out projections of the serving path
    (conformer.py:237-251) and plain tensor attention (:354-397)."""

    def __init__(self, d: int, num_heads: int, compute_dtype: torch.dtype, int8_act: bool):
        super().__init__()
        if d % num_heads:
            raise ValueError(f"d_model {d} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.ln = LayerNorm(d)
        for name in ("q_proj", "k_proj", "v_proj", "pos_proj", "out_proj"):
            setattr(self, name, QuantDense(d, d, compute_dtype, int8_act))
        dh = d // num_heads
        self.pos_bias_u = nn.Parameter(torch.empty(num_heads, dh))
        self.pos_bias_v = nn.Parameter(torch.empty(num_heads, dh))

    def forward(self, x: torch.Tensor, pos: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        # x [B, T, D]; pos [2T-1, D]; key_mask [B, T] bool (True = valid)
        B, T, D = x.shape
        H = self.num_heads
        dh = D // H
        cd = self.compute_dtype
        y = self.ln(x)
        q = self.q_proj(y).reshape(B, T, H, dh)
        k = self.k_proj(y).reshape(B, T, H, dh)
        v = self.v_proj(y).reshape(B, T, H, dh)
        p = self.pos_proj(pos.to(cd)).reshape(-1, H, dh)  # [2T-1, H, dh]
        u = self.pos_bias_u.to(cd)
        vb = self.pos_bias_v.to(cd)

        # a zero row in front of the table puts rel_shift's pad column into
        # column 0 of the product (rel_shift_padded)
        p_padded = torch.cat([p.new_zeros(1, H, dh), p], dim=0)  # [2T, H, dh]
        bd = rel_shift_padded(torch.einsum("bthd,phd->bhtp", q + vb, p_padded))
        ac = torch.einsum("bthd,bshd->bhts", q + u, k)
        scores = (ac + bd).to(torch.float32) * (1.0 / math.sqrt(dh))
        scores = scores.masked_fill(~key_mask[:, None, None, :], NEG_INF)
        attn = torch.softmax(scores, dim=-1).to(cd)
        out = torch.einsum(
            "bhts,bshd->bthd", attn.to(torch.float32), v.to(torch.float32)
        ).to(cd)
        out = self.out_proj(out.reshape(B, T, D))
        return out * key_mask[..., None].to(out.dtype)  # zero padded queries


class ConvModule(nn.Module):
    """Conformer convolution module, full precision: pre-LN -> pointwise
    d->2d -> GLU -> depthwise conv (SAME, in f32) -> masked batch norm ->
    swish -> pointwise d->d. Inputs are masked before the depthwise conv."""

    def __init__(self, d: int, kernel_size: int, compute_dtype: torch.dtype):
        super().__init__()
        self.kernel_size = kernel_size
        self.compute_dtype = compute_dtype
        self.ln = LayerNorm(d)
        self.pw1 = Dense(d, 2 * d, compute_dtype)
        self.dw_kernel = nn.Parameter(torch.empty(d, 1, kernel_size))  # [D, 1, k]
        self.bn = MaskedBatchNorm(d)
        self.pw2 = Dense(d, d, compute_dtype)

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
        keep = frame_mask[..., None]
        y = F.glu(self.pw1(self.ln(x)), dim=-1)
        y = y * keep.to(y.dtype)
        k = self.kernel_size
        y = F.pad(y.to(torch.float32).transpose(1, 2), ((k - 1) // 2, k // 2))
        y = F.conv1d(y, self.dw_kernel, groups=self.dw_kernel.shape[0])
        y = y.transpose(1, 2).to(self.compute_dtype)
        y = self.pw2(F.silu(self.bn(y, frame_mask)))
        return y * keep.to(y.dtype)


class ConformerBlock(nn.Module):
    """ff1(1/2) -> MHSA -> Conv -> ff2(1/2) -> LN."""

    def __init__(self, d: int, num_heads: int, d_ff: int, conv_kernel: int,
                 compute_dtype: torch.dtype, int8_act: bool):
        super().__init__()
        self.ff1 = FeedForward(d, d_ff, compute_dtype, int8_act)
        self.mhsa = RelPosMHSA(d, num_heads, compute_dtype, int8_act)
        self.conv = ConvModule(d, conv_kernel, compute_dtype)
        self.ff2 = FeedForward(d, d_ff, compute_dtype, int8_act)
        self.ln_out = LayerNorm(d)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.ff1(x)
        x = x + self.mhsa(x, pos, key_mask)
        x = x + self.conv(x, key_mask)
        x = x + 0.5 * self.ff2(x)
        return self.ln_out(x)


class Conv2dSubsampling(nn.Module):
    """Two 3x3 stride-2 VALID convs + ReLU, flatten, Dense -> d_model
    (conformer.py:536-584).

    Unfused: both convs in the compute dtype (features cast before conv1),
    output flattened c*F'+f. With `fused=True` (conformer.py:553-560) the
    same parameters go through `fused_subsample` (conv1 in f32, the conv1
    activation never in device memory) and the output flattens f*C+c, the
    row order of the JAX projection. On CUDA the kernel's operands (w1 as
    [3, 3, C], w2 as bf16 [9C, C]) are laid out once from the conv weights
    and rebuilt only when those change.

    `subsample_fn` is a plain attribute: a function with the signature of
    `fused_subsample` (its plain version, say) can take its place."""

    def __init__(self, input_dim: int, d_model: int, compute_dtype: torch.dtype,
                 fused: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fused = fused
        self.subsample_fn = fused_subsample
        self.conv1 = nn.Conv2d(1, d_model, 3, stride=2)
        self.conv2 = nn.Conv2d(d_model, d_model, 3, stride=2)
        f2 = subsampled_frames(input_dim)
        self.proj = Dense(d_model * f2, d_model, compute_dtype)
        self._fused_operands = (None, None)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.conv2d(x, conv.weight.to(cd), conv.bias.to(cd), stride=2)

    def fused_operands(self):
        """(w1 [3, 3, C] f32, b1, w2 [9C, C] compute dtype, b2): the JAX
        kernel layout of the conv weights, cached until they change."""
        w1, w2 = self.conv1.weight, self.conv2.weight
        key = (w2.device, w1.data_ptr(), w1._version, w2.data_ptr(), w2._version)
        if self._fused_operands[0] != key:
            C = w2.shape[0]
            with torch.no_grad():
                ops = (
                    w1[:, 0].permute(1, 2, 0).contiguous(),  # OIHW -> [3, 3, C]
                    self.conv1.bias.detach(),
                    w2.permute(2, 3, 1, 0).reshape(9 * C, C)  # OIHW -> [9C, C]
                    .to(self.compute_dtype).contiguous(),
                    self.conv2.bias.detach(),
                )
            self._fused_operands = (key, ops)
        return self._fused_operands[1]

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        if self.fused:
            x = self.subsample_fn(feats.float(), *self.fused_operands(), self.compute_dtype)
            B, T, Fq, C = x.shape
            return self.proj(x.reshape(B, T, Fq * C))  # index f*C+c
        x = feats[:, None].to(self.compute_dtype)  # [B, 1, T, F]
        x = F.relu(self._conv(self.conv1, x))
        x = F.relu(self._conv(self.conv2, x))  # [B, C, T', F']
        B, C, T, Fq = x.shape
        x = x.permute(0, 2, 1, 3).reshape(B, T, C * Fq)  # index c*F'+f
        return self.proj(x)


class ConformerEncoder(nn.Module):
    """subsample -> pad time -> L blocks -> LN, returning (x, key_mask)."""

    def __init__(self, input_dim: int = 80, d_model: int = 256, num_layers: int = 12,
                 num_heads: int = 4, d_ff: int = 1024, conv_kernel: int = 31,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 time_pad_multiple: int = 128, int8_act: bool = False,
                 fused_subsampler: bool = False):
        super().__init__()
        self.d_model = d_model
        self.num_layers = num_layers
        self.time_pad_multiple = time_pad_multiple
        self.subsample = Conv2dSubsampling(input_dim, d_model, compute_dtype,
                                           fused=fused_subsampler)
        self.blocks = nn.ModuleList(
            ConformerBlock(d_model, num_heads, d_ff, conv_kernel, compute_dtype, int8_act)
            for _ in range(num_layers)
        )
        self.ln_out = LayerNorm(d_model)
        self._pos_cache: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def _pos(self, T: int, device: torch.device) -> torch.Tensor:
        key = (T, device)
        if key not in self._pos_cache:
            table = rel_positional_encoding(T, self.d_model)
            self._pos_cache[key] = torch.from_numpy(table).to(device)
        return self._pos_cache[key]

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                binary_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats [B, T, F], feat_lens [B] -> (x [B, T', D], key_mask [B, T']).

        `binary_mask` ([L] bool, True = 1-bit layer) is accepted for the JAX
        signature; packed weights already hold their precision, fixed when
        they were exported (model/packed.py), so it selects nothing here."""
        if binary_mask is not None and binary_mask.shape != (self.num_layers,):
            raise ValueError(
                f"binary_mask shape {tuple(binary_mask.shape)} != ({self.num_layers},)"
            )
        x = self.subsample(feats)
        enc_lens = subsampled_length(feat_lens)
        B, T, D = x.shape
        # pad the subsampled time axis (time_pad_multiple); padded frames are
        # masked everywhere downstream
        m = self.time_pad_multiple
        if m > 1 and T > m // 2 and T % m:
            pad = m - T % m
            x = F.pad(x, (0, 0, 0, pad))
            T += pad
        key_mask = lengths_to_mask(enc_lens, T)
        pos = self._pos(T, x.device)
        for block in self.blocks:
            x = block(x, pos, key_mask)
        return self.ln_out(x), key_mask

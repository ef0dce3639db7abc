"""Conformer encoder, in a serving form (packed-ternary projections) and a
QAT form (straight-through quantized projections, dropout).

Counterpart of onebit_asr_tpu/model/conformer.py: the blocks run as a Python
loop over `nn.ModuleList` (the JAX package scans over stacked [L, ...]
parameters; convert.py slices them), attention is either plain tensor code
or, with `fused=True`, the fused CUDA kernel of ops/attention.py, and the
subsampler is either the unfused conv stack or, with `fused=True`, the fused
CUDA kernel of ops/subsampler.py. The QAT form (per-layer `bits`, every
FastDropout site of the JAX encoder) runs either attention and either
subsampler: the fused attention differentiates through the forward and
backward kernels of ops/attention.py, with its attention dropout drawn as
uint8 bytes at the unfused chain's draw, and the fused subsampler through
those of ops/subsampler.py. Every option of the JAX encoder is here:
per-channel alpha (`Parts(per_channel=True)`), the conv module's three norms
and its causal padding, and chunked attention (a [T, T] pair mask over the
padded time axis, which the unfused chain takes: JAX's dispatch sends a
pair mask past its fused kernel, conformer.py:310-316, and so does this).

Layouts inside this package are PyTorch's: the subsampler convs are NCHW
with OIHW weights, and the unfused output flattens channel-major (index
c*F'+f); convert.py permutes the JAX weights to match, so outputs agree. The
fused branch flattens as JAX does (f*C+c), and convert.py then keeps the
JAX row order of the projection.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from onebit_asr_tpu_torch.model.layers import (
    Dense,
    DropoutRng,
    FastDropout,
    LayerNorm,
    MaskedBatchNorm,
    MaskedGroupNorm,
    QATDense,
    QuantDense,
    lengths_to_mask,
    rel_positional_encoding,
)
from onebit_asr_tpu_torch.ops.attention import drop_threshold, fused_relpos_attention
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


def chunk_pair_mask(T: int, chunk_size: int, left_chunks: int = -1,
                    device=None) -> torch.Tensor:
    """[T, T] bool, True where query frame t may attend to key frame s under
    chunked attention (conformer.py:122-140): t sees its own chunk of
    `chunk_size` frames whole and `left_chunks` chunks before it (every
    earlier chunk if left_chunks < 0)."""
    cid = torch.arange(T, device=device) // chunk_size
    q, k = cid[:, None], cid[None, :]
    mask = k <= q
    if left_chunks >= 0:
        mask = mask & (k >= q - left_chunks)
    return mask


def rel_shift_padded(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T] position scores whose column 0 is zero -> [B, H, T, T]
    with out[..., t, s] = x[..., t, T-t+s] (relative offset t-s)."""
    B, H, T = x.shape[:3]
    x = x.reshape(B, H, 2 * T, T)
    x = x[:, :, 1:, :].reshape(B, H, T, 2 * T - 1)
    return x[..., :T]


class Parts:
    """What the layers of one model are built from: the compute dtype, the
    projections (packed serving `QuantDense`, or `QATDense`, whose alpha is
    per output channel with `per_channel`) and the dropout (rate 0 and no
    draws in the serving form), all FastDropout layers drawing from one
    shared `DropoutRng`."""

    def __init__(self, compute_dtype: torch.dtype, int8_act: bool = False, qat: bool = False,
                 dropout: float = 0.0, per_channel: bool = False):
        self.compute_dtype = compute_dtype
        self.int8_act = int8_act
        self.qat = qat
        self.dropout = dropout
        self.per_channel = per_channel
        self.rng = DropoutRng()

    def proj(self, in_features: int, features: int) -> nn.Module:
        if self.qat:
            return QATDense(in_features, features, self.compute_dtype, self.per_channel)
        return QuantDense(in_features, features, self.compute_dtype, self.int8_act)

    def drop(self) -> FastDropout:
        return FastDropout(self.dropout, self.rng)


def relpos_attention_chain(q, k, v, p, u, vb, key_mask, scale, dropout=None, pair_mask=None):
    """The unfused attention of `RelPosMHSA` (JAX conformer.py:354-397): q/k/v
    [B, T, H, dh], p [2T-1, H, dh], u/vb [H, dh], all in the compute dtype;
    key_mask [B, T] bool, and pair_mask [T, T] bool (chunked attention) or
    None -> [B, T, H, dh]. The content and position scores are rounded to
    the compute dtype and added there; the softmax runs in f32 over the
    keys both masks allow, and its output is rounded to the compute dtype,
    then goes through `dropout` (a module, or None)."""
    H, dh = u.shape
    cd = v.dtype
    # a zero row in front of the table puts rel_shift's pad column into
    # column 0 of the product (rel_shift_padded)
    p_padded = torch.cat([p.new_zeros(1, H, dh), p], dim=0)  # [2T, H, dh]
    bd = rel_shift_padded(torch.einsum("bthd,phd->bhtp", q + vb, p_padded))
    ac = torch.einsum("bthd,bshd->bhts", q + u, k)
    scores = (ac + bd).to(torch.float32) * scale
    allowed = key_mask[:, None, None, :]
    if pair_mask is not None:
        allowed = allowed & pair_mask[None, None]
    scores = scores.masked_fill(~allowed, NEG_INF)
    attn = torch.softmax(scores, dim=-1).to(cd)
    if dropout is not None:
        attn = dropout(attn)
    return torch.einsum(
        "bhts,bshd->bthd", attn.to(torch.float32), v.to(torch.float32)
    ).to(cd)


class FeedForward(nn.Module):
    """Macaron feed-forward: pre-LN -> quantized d->d_ff -> swish -> dropout
    -> quantized d_ff->d -> dropout."""

    def __init__(self, d: int, d_ff: int, parts: Parts):
        super().__init__()
        self.ln = LayerNorm(d)
        self.w1 = parts.proj(d, d_ff)
        self.w2 = parts.proj(d_ff, d)
        self.drop1, self.drop2 = parts.drop(), parts.drop()

    def forward(self, x: torch.Tensor, bits=None) -> torch.Tensor:
        y = self.drop1(F.silu(self.w1(self.ln(x), bits)))
        return self.drop2(self.w2(y, bits))


class RelPosMHSA(nn.Module):
    """Relative-position multi-head self-attention (Transformer-XL style),
    with the separate q/k/v/pos/out projections of the serving path
    (conformer.py:237-251) and plain tensor attention (:354-397) or, with
    `fused=True` (:315-353), `fused_relpos_attention` on [B, H, T, dh]
    operands. A pair mask (chunked attention) always takes the plain chain,
    as JAX's dispatch does (:310-316). In the QAT form the attention
    probabilities and the output projection go through dropout while the
    model has draws; the fused branch then draws the [B, H, T, T] bytes the
    unfused chain's `attn_drop` would draw, at the same point, and hands
    them to the kernel with the dropout rate (rate 0 and no draw otherwise,
    as in serving).

    `attention_fn` is a plain attribute: a function with the signature of
    `fused_relpos_attention` (its plain version, say) can take its place."""

    def __init__(self, d: int, num_heads: int, parts: Parts, fused: bool = False):
        super().__init__()
        if d % num_heads:
            raise ValueError(f"d_model {d} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        self.compute_dtype = parts.compute_dtype
        self.fused = fused
        self.attention_fn = fused_relpos_attention
        # the drop8 operand at rate 0: never read
        self.register_buffer("no_drop", torch.zeros((1, 1, 1, 1), dtype=torch.uint8),
                             persistent=False)
        self.ln = LayerNorm(d)
        for name in ("q_proj", "k_proj", "v_proj", "pos_proj", "out_proj"):
            setattr(self, name, parts.proj(d, d))
        self.attn_drop, self.out_drop = parts.drop(), parts.drop()
        dh = d // num_heads
        self.pos_bias_u = nn.Parameter(torch.empty(num_heads, dh))
        self.pos_bias_v = nn.Parameter(torch.empty(num_heads, dh))

    def forward(self, x: torch.Tensor, pos: torch.Tensor, key_mask: torch.Tensor,
                bits=None, pair_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # x [B, T, D]; pos [2T-1, D]; key_mask [B, T] bool (True = valid);
        # pair_mask [T, T] bool (True = may attend) or None
        B, T, D = x.shape
        H = self.num_heads
        dh = D // H
        cd = self.compute_dtype
        y = self.ln(x)
        q = self.q_proj(y, bits).reshape(B, T, H, dh)
        k = self.k_proj(y, bits).reshape(B, T, H, dh)
        v = self.v_proj(y, bits).reshape(B, T, H, dh)
        p = self.pos_proj(pos.to(cd), bits).reshape(-1, H, dh)  # [2T-1, H, dh]
        u = self.pos_bias_u.to(cd)
        vb = self.pos_bias_v.to(cd)
        scale = 1.0 / math.sqrt(dh)

        # JAX takes its XLA chain whenever a pair mask is set
        # (conformer.py:310-316): the fused kernel has no pair mask
        if self.fused and pair_mask is None:
            drop, rate, drop8 = self.attn_drop, 0.0, self.no_drop
            if drop.rng.draws is not None and drop_threshold(drop.rate) > 0:
                rate, drop8 = drop.rate, drop.rng.draws((B, H, T, T), x.device)
            out = self.attention_fn(
                q.transpose(1, 2).contiguous(),  # [B, H, T, dh]
                k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(),
                p.transpose(0, 1).contiguous(),  # [H, 2T-1, dh]
                u, vb, key_mask.to(torch.float32), drop8, scale, rate,
            ).transpose(1, 2)  # back to [B, T, H, dh]
        else:
            out = relpos_attention_chain(q, k, v, p, u, vb, key_mask, scale, self.attn_drop,
                                         pair_mask)
        out = self.out_drop(self.out_proj(out.reshape(B, T, D), bits))
        return out * key_mask[..., None].to(out.dtype)  # zero padded queries


CONV_NORMS = ("batch_norm", "group_norm", "layer_norm")


def check_encoder_options(conv_norm: str, attn_chunk_size: Optional[int] = None) -> None:
    """ValueError for a conv norm other than the three of JAX's CLI, or a
    chunk size below 1 (None is full context)."""
    if conv_norm not in CONV_NORMS:
        raise ValueError(f"conv_norm {conv_norm!r} is not one of {CONV_NORMS}")
    if attn_chunk_size is not None and attn_chunk_size < 1:
        raise ValueError(f"attn_chunk_size {attn_chunk_size}: at least 1, or None for full "
                         "context")


class ConvModule(nn.Module):
    """Conformer convolution module, full precision (conformer.py:400-465):
    pre-LN -> pointwise d->2d -> GLU -> depthwise conv (in f32; SAME, or
    with `causal` padded (k-1, 0) so frame t sees frames <= t) -> norm ->
    swish -> pointwise d->d -> dropout. Inputs are masked before the
    depthwise conv. The norm is `norm`'s, under JAX's parameter name:
    "batch_norm" -> `bn` (MaskedBatchNorm), "group_norm" -> `gn`
    (MaskedGroupNorm, min(32, d) groups), "layer_norm" -> `frame_ln`
    (LayerNorm per frame, then masked)."""

    def __init__(self, d: int, kernel_size: int, parts: Parts, norm: str = "batch_norm",
                 causal: bool = False):
        super().__init__()
        check_encoder_options(norm)
        compute_dtype = parts.compute_dtype
        self.kernel_size = kernel_size
        self.compute_dtype = compute_dtype
        self.norm = norm
        self.causal = causal
        self.ln = LayerNorm(d)
        self.pw1 = Dense(d, 2 * d, compute_dtype)
        self.dw_kernel = nn.Parameter(torch.empty(d, 1, kernel_size))  # [D, 1, k]
        if norm == "group_norm":
            self.gn = MaskedGroupNorm(d, min(32, d))
        elif norm == "layer_norm":
            self.frame_ln = LayerNorm(d)
        else:
            self.bn = MaskedBatchNorm(d)
        self.pw2 = Dense(d, d, compute_dtype)
        self.drop = parts.drop()

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
        keep = frame_mask[..., None]
        y = F.glu(self.pw1(self.ln(x)), dim=-1)
        y = y * keep.to(y.dtype)
        k = self.kernel_size
        pad = (k - 1, 0) if self.causal else ((k - 1) // 2, k // 2)
        y = F.pad(y.to(torch.float32).transpose(1, 2), pad)
        y = F.conv1d(y, self.dw_kernel, groups=self.dw_kernel.shape[0])
        y = y.transpose(1, 2).to(self.compute_dtype)
        if self.norm == "group_norm":
            y = self.gn(y, frame_mask)
        elif self.norm == "layer_norm":
            y = self.frame_ln(y) * keep.to(y.dtype)
        else:
            y = self.bn(y, frame_mask)
        y = self.drop(self.pw2(F.silu(y)))
        return y * keep.to(y.dtype)


class ConformerBlock(nn.Module):
    """ff1(1/2) -> MHSA -> Conv -> ff2(1/2) -> LN."""

    def __init__(self, d: int, num_heads: int, d_ff: int, conv_kernel: int, parts: Parts,
                 fused_attention: bool = False, conv_norm: str = "batch_norm",
                 causal_conv: bool = False):
        super().__init__()
        self.ff1 = FeedForward(d, d_ff, parts)
        self.mhsa = RelPosMHSA(d, num_heads, parts, fused=fused_attention)
        self.conv = ConvModule(d, conv_kernel, parts, conv_norm, causal_conv)
        self.ff2 = FeedForward(d, d_ff, parts)
        self.ln_out = LayerNorm(d)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, key_mask: torch.Tensor,
                bits=None, pair_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + 0.5 * self.ff1(x, bits)
        x = x + self.mhsa(x, pos, key_mask, bits, pair_mask)
        x = x + self.conv(x, key_mask)
        x = x + 0.5 * self.ff2(x, bits)
        return self.ln_out(x)


class Conv2dSubsampling(nn.Module):
    """Two 3x3 stride-2 VALID convs + ReLU, flatten, Dense -> d_model
    (conformer.py:536-584).

    Unfused: both convs in the compute dtype (features cast before conv1),
    output flattened c*F'+f. With `fused=True` (conformer.py:553-560) the
    same parameters go through `fused_subsample` (conv1 in f32, the conv1
    activation never in device memory) and the output flattens f*C+c, the
    row order of the JAX projection. The kernel's operands are the conv
    weights laid out as w1 [3, 3, C] and w2 [9C, C]. Serving lays them out
    once, w2 in the compute dtype, and again only when the weights change.
    The QAT form lays them out on every call with autograd on, w2 in f32 as
    JAX passes it, so the conv weights get their gradients (dw2 in f32)
    through the fused backward, also under `torch.func.functional_call`.

    The output goes through dropout (active in the QAT form).

    `subsample_fn` is a plain attribute: a function with the signature of
    `fused_subsample` (its plain version, say) can take its place."""

    def __init__(self, input_dim: int, d_model: int, parts: Parts, fused: bool = False):
        super().__init__()
        compute_dtype = parts.compute_dtype
        self.compute_dtype = compute_dtype
        self.fused = fused
        self.qat = parts.qat
        self.subsample_fn = fused_subsample
        self.conv1 = nn.Conv2d(1, d_model, 3, stride=2)
        self.conv2 = nn.Conv2d(d_model, d_model, 3, stride=2)
        f2 = subsampled_frames(input_dim)
        self.proj = Dense(d_model * f2, d_model, compute_dtype)
        self.drop = parts.drop()
        self._fused_operands = (None, None)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.conv2d(x, conv.weight.to(cd), conv.bias.to(cd), stride=2)

    def fused_operands(self):
        """(w1 [3, 3, C] f32, b1, w2 [9C, C], b2): the JAX kernel layout of
        the conv weights. QAT: w2 in f32, built from the parameters with
        autograd on. Serving: w2 in the compute dtype, cached until the
        weights change."""
        w1, w2 = self.conv1.weight, self.conv2.weight
        C = w2.shape[0]
        if self.qat:
            return (w1[:, 0].permute(1, 2, 0), self.conv1.bias,  # OIHW -> [3, 3, C]
                    w2.permute(2, 3, 1, 0).reshape(9 * C, C), self.conv2.bias)  # -> [9C, C]
        key = (w2.device, w1.data_ptr(), w1._version, w2.data_ptr(), w2._version)
        if self._fused_operands[0] != key:
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
            return self.drop(self.proj(x.reshape(B, T, Fq * C)))  # index f*C+c
        x = feats[:, None].to(self.compute_dtype)  # [B, 1, T, F]
        x = F.relu(self._conv(self.conv1, x))
        x = F.relu(self._conv(self.conv2, x))  # [B, C, T', F']
        B, C, T, Fq = x.shape
        x = x.permute(0, 2, 1, 3).reshape(B, T, C * Fq)  # index c*F'+f
        return self.drop(self.proj(x))


class ConformerEncoder(nn.Module):
    """subsample -> pad time -> dropout -> L blocks -> LN, returning
    (x, key_mask). `parts` chooses the serving or the QAT form. With
    `attn_chunk_size` every block attends under `chunk_pair_mask` of the
    padded time axis (chunk ids count from its frame 0, as in JAX,
    conformer.py:667-671)."""

    def __init__(self, input_dim: int = 80, d_model: int = 256, num_layers: int = 12,
                 num_heads: int = 4, d_ff: int = 1024, conv_kernel: int = 31, *,
                 parts: Parts, time_pad_multiple: int = 128,
                 fused_subsampler: bool = False, fused_attention: bool = False,
                 conv_norm: str = "batch_norm", causal_conv: bool = False,
                 attn_chunk_size: Optional[int] = None, attn_left_chunks: int = -1):
        super().__init__()
        check_encoder_options(conv_norm, attn_chunk_size)
        self.qat = parts.qat
        self.d_model = d_model
        self.num_layers = num_layers
        self.time_pad_multiple = time_pad_multiple
        self.attn_chunk_size = attn_chunk_size
        self.attn_left_chunks = attn_left_chunks
        self.subsample = Conv2dSubsampling(input_dim, d_model, parts, fused=fused_subsampler)
        self.drop = parts.drop()
        self.blocks = nn.ModuleList(
            ConformerBlock(d_model, num_heads, d_ff, conv_kernel, parts, fused_attention,
                           conv_norm, causal_conv)
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

        `binary_mask` ([L] bool, True = 1-bit layer; None = full precision)
        sets each QAT block's `bits`. Packed weights already hold their
        precision, fixed when they were exported (model/packed.py), so in
        the serving form it selects nothing."""
        if binary_mask is not None and tuple(binary_mask.shape) != (self.num_layers,):
            raise ValueError(
                f"binary_mask shape {tuple(binary_mask.shape)} != ({self.num_layers},)"
            )
        bits = self.layer_bits(binary_mask)
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
        x = self.drop(x)
        pair_mask = None
        if self.attn_chunk_size is not None:
            pair_mask = chunk_pair_mask(T, self.attn_chunk_size, self.attn_left_chunks, x.device)
        for block, b in zip(self.blocks, bits):
            x = block(x, pos, key_mask, b, pair_mask)
        return self.ln_out(x), key_mask

    def layer_bits(self, binary_mask: Optional[torch.Tensor]) -> List:
        """Per-layer `bits` of the QAT projections: 32 for every layer
        without a mask, else each layer's bool (True = binary)."""
        if not self.qat:
            return [None] * self.num_layers
        if binary_mask is None:
            return [32] * self.num_layers
        return [bool(b) for b in binary_mask.tolist()]

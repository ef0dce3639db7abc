"""Transformer decoder: the training-time attention branch.

Counterpart of onebit_asr_tpu/model/decoder.py: Dense layers computing in
the compute dtype, finite masks, and dropout at every site of the JAX
decoder. Two options of the JAX ModelConfig:

- `quantize` (quant_decoder): the q/k/v/o and ff1/ff2 projections come from
  the model's `Parts` (`QATDense`, per channel if the model's projections
  are, in the QAT form; the packed `QuantDense` in the serving form) and run
  at the call's `bits`; the embedding and `out` stay full precision;
- `reference_mode` (reference_decoder): position-blind embeddings without
  embedding dropout and post-LN layers, y = ln(y + drop(sublayer(y))), on
  the same parameters. Otherwise sinusoidal positions are added to the
  embeddings (then dropout) and the layers are pre-LN.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from onebit_asr_tpu_torch.model.conformer import Parts
from onebit_asr_tpu_torch.model.layers import Dense, LayerNorm, abs_positional_encoding

NEG_INF = -1e9


def _proj(in_features: int, features: int, parts: Parts, quantize: bool) -> nn.Module:
    """A decoder projection: the quantized one of `parts` with `quantize`,
    else Dense (JAX decoder.py::_proj)."""
    if quantize:
        return parts.proj(in_features, features)
    return Dense(in_features, features, parts.compute_dtype)


class MultiHeadAttention(nn.Module):
    """Standard MHA: scores summed in f32 and divided by sqrt(dh), f32
    softmax with finite masking, dropout on the f32 probabilities, then the
    probabilities rounded to the compute dtype times v, summed in f32."""

    def __init__(self, d: int, num_heads: int, parts: Parts, quantize: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = parts.compute_dtype
        self.q, self.k, self.v, self.o = (_proj(d, d, parts, quantize) for _ in range(4))
        self.drop = parts.drop()

    def forward(self, q: torch.Tensor, kv: torch.Tensor, mask: torch.Tensor,
                bits=32) -> torch.Tensor:
        # q [B, Tq, D]; kv [B, Tk, D]; mask broadcastable to [B, 1, Tq, Tk] bool
        B, Tq, D = q.shape
        H = self.num_heads
        dh = D // H
        f32, cd = torch.float32, self.compute_dtype
        qh = self.q(q, bits).reshape(B, Tq, H, dh)
        kh = self.k(kv, bits).reshape(B, -1, H, dh)
        vh = self.v(kv, bits).reshape(B, -1, H, dh)
        scores = torch.einsum("bthd,bshd->bhts", qh.to(f32), kh.to(f32)) / math.sqrt(dh)
        scores = torch.where(mask, scores, NEG_INF)
        attn = self.drop(torch.softmax(scores, dim=-1))
        out = torch.einsum("bhts,bshd->bthd", attn.to(cd).to(f32), vh.to(f32)).to(cd)
        return self.o(out.reshape(B, Tq, D), bits)


class DecoderLayer(nn.Module):
    """Pre-LN: y + drop(self_attn(ln1 y)), + drop(cross_attn(ln2 y, memory)),
    + drop(ff2(drop(relu(ff1(ln3 y))))); in `reference_mode` post-LN:
    y = ln1(y + drop(self_attn(y))), ln2(y + drop(cross_attn(y, memory))),
    ln3(y + drop(ff(y)))."""

    def __init__(self, d: int, num_heads: int, d_ff: int, parts: Parts, quantize: bool = False,
                 reference_mode: bool = False):
        super().__init__()
        self.reference_mode = reference_mode
        self.self_attn = MultiHeadAttention(d, num_heads, parts, quantize)
        self.cross_attn = MultiHeadAttention(d, num_heads, parts, quantize)
        self.ln1, self.ln2, self.ln3 = LayerNorm(d), LayerNorm(d), LayerNorm(d)
        self.ff1 = _proj(d, d_ff, parts, quantize)
        self.ff2 = _proj(d_ff, d, parts, quantize)
        self.drop_self, self.drop_cross, self.drop_ff, self.drop_ff_inner = (
            parts.drop() for _ in range(4))

    def ff(self, h, bits):
        return self.ff2(self.drop_ff_inner(torch.relu(self.ff1(h, bits))), bits)

    def forward(self, y, memory, self_mask, cross_mask, bits=32):
        if self.reference_mode:
            y = self.ln1(y + self.drop_self(self.self_attn(y, y, self_mask, bits)))
            y = self.ln2(y + self.drop_cross(self.cross_attn(y, memory, cross_mask, bits)))
            return self.ln3(y + self.drop_ff(self.ff(y, bits)))
        h = self.ln1(y)
        y = y + self.drop_self(self.self_attn(h, h, self_mask, bits))
        y = y + self.drop_cross(self.cross_attn(self.ln2(y), memory, cross_mask, bits))
        return y + self.drop_ff(self.ff(self.ln3(y), bits))


class TransformerDecoder(nn.Module):
    """Embedding (+ positions, dropout; neither in `reference_mode`) -> N
    decoder layers -> LN -> vocab logits in the compute dtype.

    forward(tgt_inp [B, U] int, memory [B, T, D], memory_mask [B, T] bool,
    tgt_valid_mask [B, U] bool, bits) -> [B, U, V]; `bits` (32, or a bool:
    True = binary, False = ternary) sets the quantized projections'
    precision and is not read without `quantize`."""

    def __init__(self, vocab_size: int, d_model: int, num_layers: int, num_heads: int,
                 d_ff: int, parts: Parts, quantize: bool = False, reference_mode: bool = False):
        super().__init__()
        self.compute_dtype = parts.compute_dtype
        self.reference_mode = reference_mode
        self.embedding = nn.Parameter(torch.empty(vocab_size, d_model))
        self.drop = parts.drop()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, num_heads, d_ff, parts, quantize, reference_mode)
            for _ in range(num_layers))
        self.ln_out = LayerNorm(d_model)
        self.out = Dense(d_model, vocab_size, parts.compute_dtype)

    def forward(self, tgt_inp, memory, memory_mask, tgt_valid_mask, bits=32):
        B, U = tgt_inp.shape
        cd = self.compute_dtype
        y = self.embedding[tgt_inp].to(cd)
        if not self.reference_mode:
            pos = torch.from_numpy(abs_positional_encoding(U, self.embedding.shape[1]))
            y = self.drop(y + pos.to(y.device, cd)[None])
        causal = torch.ones((U, U), dtype=torch.bool, device=y.device).tril()
        self_mask = causal[None, None] & tgt_valid_mask[:, None, None, :]
        cross_mask = memory_mask[:, None, None, :]
        for layer in self.layers:
            y = layer(y, memory, self_mask, cross_mask, bits)
        return self.out(self.ln_out(y))

"""Transformer decoder: the training-time attention branch.

Counterpart of onebit_asr_tpu/model/decoder.py at its defaults: full
precision (the JAX `quant_decoder` option is refused, model/asr.py), Dense
layers computing in the compute dtype, sinusoidal positions added to the
embeddings, pre-LN layers, finite masks, and dropout at every site of the
JAX decoder.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from onebit_asr_tpu_torch.model.layers import (
    Dense,
    DropoutRng,
    FastDropout,
    LayerNorm,
    abs_positional_encoding,
)

NEG_INF = -1e9


class MultiHeadAttention(nn.Module):
    """Standard MHA: scores summed in f32 and divided by sqrt(dh), f32
    softmax with finite masking, dropout on the f32 probabilities, then the
    probabilities rounded to the compute dtype times v, summed in f32."""

    def __init__(self, d: int, num_heads: int, compute_dtype: torch.dtype, dropout: float,
                 rng: DropoutRng):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.q, self.k, self.v, self.o = (Dense(d, d, compute_dtype) for _ in range(4))
        self.drop = FastDropout(dropout, rng)

    def forward(self, q: torch.Tensor, kv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # q [B, Tq, D]; kv [B, Tk, D]; mask broadcastable to [B, 1, Tq, Tk] bool
        B, Tq, D = q.shape
        H = self.num_heads
        dh = D // H
        f32, cd = torch.float32, self.compute_dtype
        qh = self.q(q).reshape(B, Tq, H, dh)
        kh = self.k(kv).reshape(B, -1, H, dh)
        vh = self.v(kv).reshape(B, -1, H, dh)
        scores = torch.einsum("bthd,bshd->bhts", qh.to(f32), kh.to(f32)) / math.sqrt(dh)
        scores = torch.where(mask, scores, NEG_INF)
        attn = self.drop(torch.softmax(scores, dim=-1))
        out = torch.einsum("bhts,bshd->bthd", attn.to(cd).to(f32), vh.to(f32)).to(cd)
        return self.o(out.reshape(B, Tq, D))


class DecoderLayer(nn.Module):
    """Pre-LN: y + drop(self_attn(ln1 y)), + drop(cross_attn(ln2 y, memory)),
    + drop(ff2(drop(relu(ff1(ln3 y)))))."""

    def __init__(self, d: int, num_heads: int, d_ff: int, compute_dtype: torch.dtype,
                 dropout: float, rng: DropoutRng):
        super().__init__()
        self.self_attn = MultiHeadAttention(d, num_heads, compute_dtype, dropout, rng)
        self.cross_attn = MultiHeadAttention(d, num_heads, compute_dtype, dropout, rng)
        self.ln1, self.ln2, self.ln3 = LayerNorm(d), LayerNorm(d), LayerNorm(d)
        self.ff1 = Dense(d, d_ff, compute_dtype)
        self.ff2 = Dense(d_ff, d, compute_dtype)
        self.drop_self, self.drop_cross, self.drop_ff, self.drop_ff_inner = (
            FastDropout(dropout, rng) for _ in range(4))

    def forward(self, y, memory, self_mask, cross_mask):
        h = self.ln1(y)
        y = y + self.drop_self(self.self_attn(h, h, self_mask))
        y = y + self.drop_cross(self.cross_attn(self.ln2(y), memory, cross_mask))
        h = self.drop_ff_inner(torch.relu(self.ff1(self.ln3(y))))
        return y + self.drop_ff(self.ff2(h))


class TransformerDecoder(nn.Module):
    """Embedding (+ positions, dropout) -> N decoder layers -> LN -> vocab
    logits in the compute dtype.

    forward(tgt_inp [B, U] int, memory [B, T, D], memory_mask [B, T] bool,
    tgt_valid_mask [B, U] bool) -> [B, U, V]."""

    def __init__(self, vocab_size: int, d_model: int, num_layers: int, num_heads: int,
                 d_ff: int, compute_dtype: torch.dtype, dropout: float, rng: DropoutRng):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embedding = nn.Parameter(torch.empty(vocab_size, d_model))
        self.drop = FastDropout(dropout, rng)
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, num_heads, d_ff, compute_dtype, dropout, rng)
            for _ in range(num_layers))
        self.ln_out = LayerNorm(d_model)
        self.out = Dense(d_model, vocab_size, compute_dtype)

    def forward(self, tgt_inp, memory, memory_mask, tgt_valid_mask):
        B, U = tgt_inp.shape
        cd = self.compute_dtype
        y = self.embedding[tgt_inp].to(cd)
        pos = torch.from_numpy(abs_positional_encoding(U, self.embedding.shape[1]))
        y = self.drop(y + pos.to(y.device, cd)[None])
        causal = torch.ones((U, U), dtype=torch.bool, device=y.device).tril()
        self_mask = causal[None, None] & tgt_valid_mask[:, None, None, :]
        cross_mask = memory_mask[:, None, None, :]
        for layer in self.layers:
            y = layer(y, memory, self_mask, cross_mask)
        return self.out(self.ln_out(y))

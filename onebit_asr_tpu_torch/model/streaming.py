"""Streaming (incremental) encoder step over the offline encoder's weights.

Counterpart of onebit_asr_tpu/model/streaming.py. A model trained with the
chunked-causal encoder options (`attn_chunk_size=cs`, `attn_left_chunks=l`,
`causal_conv=True`, `conv_norm="layer_norm"`) is served one chunk at a
time: each step takes the raw feature window of ONE chunk plus per-layer
caches of earlier input frames, and returns that chunk's encoder output,
equal to the offline encoder's for the same frames:

- attention for a frame in chunk c covers chunks [c-l .. c]; the window
  holds exactly those frames (each layer's cache keeps that layer's INPUT
  frames, so cached frames recompute their own post-attention values with
  their own original context);
- a current frame's causal depthwise conv reads the post-attention values
  of the k-1 frames before it, which the window recomputes from the cache
  (`streaming_cache_chunks`);
- every other op of the block is per frame ("layer_norm" is the per-frame
  conv norm; batch and group statistics span the sequence).

The relative position table is translation-invariant, so the window's
[2W-1] table gives the offline scores for every pair in the window.

Unlike the JAX step, whose validity counts are scalars (its server vmaps a
B=1 step), `cache_valid` and `cur_valid` are per row ([B] tensors): the
server's batched step is one forward over all its slots, and every op in
the block is per frame or masked per row, so a row's output does not depend
on the other rows.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from onebit_asr_tpu_torch.model.conformer import (
    ConformerBlock,
    Conv2dSubsampling,
    Parts,
    chunk_pair_mask,
    mask_bits,
)
from onebit_asr_tpu_torch.model.layers import LayerNorm, rel_positional_encoding


def streaming_cache_chunks(conv_kernel: int, chunk_size: int, left_chunks: int) -> int:
    """Chunks of per-layer input history a streaming step must keep.

    A current frame's causal conv reads the POST-attention values of the
    k-1 frames before it; those cached frames are recomputed with their own
    attention context (`left_chunks` before THEM), so the window holds
    ceil((k-1)/cs) conv-history chunks plus `left_chunks` context chunks
    for the oldest of them."""
    conv_chunks = math.ceil((conv_kernel - 1) / chunk_size)
    return max(conv_chunks + left_chunks, 1)


def raw_window_size(chunk_size: int) -> int:
    """Raw (10 ms) frames one step consumes to yield exactly `chunk_size`
    subsampled frames through the two VALID k=3 s=2 convs: subsampled frame
    j needs raw frames [4j, 4j+6], so a chunk of cs frames spans 4*cs + 3
    raw frames (a 3-frame lookahead shared with the next window; the hop
    between windows is 4*cs)."""
    return 4 * chunk_size + 3


class StreamingEncoderStep(nn.Module):
    """One chunk step, in the QAT form in eval mode (dropout 0). Submodule
    names mirror `ConformerEncoder` ("subsample", "blocks", "ln_out"), so
    the offline encoder's state dict loads unchanged. The subsampler is the
    unfused one and attention takes the plain chain under the pair mask,
    as in JAX (model/streaming.py:107-109, model/conformer.py:310-316).

    JAX's step has a `packed` field that no caller sets (decode/
    streaming.py:61 and :213, export.py:124); it is not ported."""

    def __init__(self, input_dim: int, d_model: int, num_layers: int, num_heads: int,
                 d_ff: int, conv_kernel: int, chunk_size: int, left_chunks: int,
                 compute_dtype: torch.dtype = torch.bfloat16, per_channel: bool = False):
        super().__init__()
        self.d_model = d_model
        self.num_layers = num_layers
        self.chunk_size = chunk_size
        self.left_chunks = left_chunks
        self.compute_dtype = compute_dtype
        parts = Parts(compute_dtype, qat=True, dropout=0.0, per_channel=per_channel)
        self.subsample = Conv2dSubsampling(input_dim, d_model, parts, fused=False)
        self.blocks = nn.ModuleList(
            ConformerBlock(d_model, num_heads, d_ff, conv_kernel, parts,
                           conv_norm="layer_norm", causal_conv=True)
            for _ in range(num_layers)
        )
        self.ln_out = LayerNorm(d_model)
        self._tables: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}

    def _window_tables(self, W: int, device: torch.device):
        """(position table [2W-1, D], pair mask [W, W]) of a window of W
        frames, made once per (W, device)."""
        key = (W, device)
        if key not in self._tables:
            pos = torch.from_numpy(rel_positional_encoding(W, self.d_model)).to(device)
            self._tables[key] = (pos, chunk_pair_mask(W, self.chunk_size, self.left_chunks,
                                                      device))
        return self._tables[key]

    def forward(
        self,
        window_feats: torch.Tensor,  # [B, 4*cs+3, F] raw features
        caches: torch.Tensor,  # [L, B, C_len, D] per-layer input history
        cache_valid: torch.Tensor,  # [B] int: valid frames at each cache's tail
        cur_valid: torch.Tensor,  # [B] int: valid frames of this chunk (cs but
        # for a final partial chunk)
        binary_mask=None,  # [L] bool tensor or list of bools; None = full precision
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (x [B, cs, D], new caches [L, B, C_len, D])."""
        cs = self.chunk_size
        L, B, C_len, D = caches.shape
        W = C_len + cs
        dev = window_feats.device
        bits = mask_bits(binary_mask, self.num_layers)

        x = self.subsample(window_feats)  # [B, cs, D]
        pos, pair_mask = self._window_tables(W, dev)
        # frame validity (conv and attention): the cache tail's cache_valid
        # frames and the chunk's first cur_valid frames, per row
        cached_ok = torch.arange(C_len, device=dev)[None] >= (C_len - cache_valid)[:, None]
        cur_ok = torch.arange(cs, device=dev)[None] < cur_valid[:, None]
        key_mask = torch.cat([cached_ok, cur_ok], dim=1)  # [B, W]

        # The window is chunk-aligned, so the offline chunk mask in window
        # coordinates gives every frame its original attention context.
        new_caches = []
        for block, cache_l, b in zip(self.blocks, caches, bits):
            window_x = torch.cat([cache_l.to(x.dtype), x], dim=1)  # [B, W, D]
            y = block(window_x, pos, key_mask, b, pair_mask)
            new_caches.append(window_x[:, -C_len:])
            x = y[:, C_len:]
        return self.ln_out(x), torch.stack(new_caches)

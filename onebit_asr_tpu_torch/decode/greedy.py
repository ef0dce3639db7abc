"""Greedy CTC decoding on the device, batched (decode/greedy.py)."""

from __future__ import annotations

from typing import Tuple

import torch


def greedy_ctc_decode(
    logits: torch.Tensor,  # [B, T, V]
    logit_lens: torch.Tensor,  # [B]
    blank_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """argmax -> collapse repeats -> drop blanks -> left-compact.
    Returns (ids [B, T] int64, padded with -1; lens [B])."""
    B, T, _ = logits.shape
    ids = logits.argmax(dim=-1)  # first maximum on ties, as jnp.argmax
    prev = torch.cat([ids.new_full((B, 1), -1), ids[:, :-1]], dim=1)
    t = torch.arange(T, device=ids.device)[None, :]
    keep = (ids != prev) & (ids != blank_id) & (t < logit_lens[:, None])
    # a kept id lands at the count of keeps before it; the rest go to the
    # spare column T, cut off below
    pos = torch.where(keep, keep.cumsum(dim=1) - 1, T)
    out = ids.new_full((B, T + 1), -1)
    out.scatter_(1, pos, torch.where(keep, ids, -1))
    return out[:, :T], keep.sum(dim=1)

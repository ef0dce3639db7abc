"""Long-form audio: overlapped fixed windows and stitched CTC.

Counterpart of onebit_asr_tpu/decode/longform.py. A recording longer than
one window runs through windows of `chunk_frames` feature frames that
overlap by `overlap_frames`, all in one batch of one shape; the encoder
sees each window whole, and the CTC logits are stitched from each window's
centre, dropping overlap/2 input frames of margin at each inner seam (the
attention there lacks context). Greedy CTC then runs over the stitched
frames. A recording of at most one window runs in one exact pass.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from onebit_asr_tpu_torch.decode.greedy import greedy_ctc_decode
from onebit_asr_tpu_torch.model.conformer import subsampled_length


def chunk_feats(
    feats: np.ndarray,  # [T, F] one long utterance
    chunk_frames: int,
    overlap_frames: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """[T, F] -> ([n, chunk_frames, F] zero-padded windows, [n] valid
    lengths, hop)."""
    T, F = feats.shape
    hop = chunk_frames - overlap_frames
    if hop <= 0:
        raise ValueError("overlap must be smaller than chunk")
    n = max(1, math.ceil(max(T - overlap_frames, 1) / hop))
    out = np.zeros((n, chunk_frames, F), feats.dtype)
    lens = np.zeros((n,), np.int32)
    for i in range(n):
        piece = feats[i * hop : i * hop + chunk_frames]
        out[i, : len(piece)] = piece
        lens[i] = len(piece)
    return out, lens, hop


def _sub(n: int) -> int:
    return int(subsampled_length(torch.tensor([n]))[0])


@torch.inference_mode()
def longform_logits(
    model,
    feats: np.ndarray,  # [T, F] post-CMVN features of one recording
    binary_mask: Optional[torch.Tensor],
    chunk_frames: int = 3000,  # 30 s at 10 ms frames
    overlap_frames: int = 400,  # 4 s
    device="cpu",
) -> torch.Tensor:
    """The stitched CTC logits [T', V] of one recording, on `device`."""
    T = feats.shape[0]
    if T <= chunk_frames:  # one exact pass
        _, mask, logits = model(torch.as_tensor(feats, device=device)[None],
                                torch.tensor([T], device=device), binary_mask)
        return logits[0, : int(mask.sum())]
    chunks, lens, _ = chunk_feats(feats, chunk_frames, overlap_frames)
    _, mask, logits = model(torch.as_tensor(chunks, device=device),
                            torch.as_tensor(lens, device=device), binary_mask)  # [n, T', V]
    enc_lens = mask.sum(dim=-1).tolist()
    n = chunks.shape[0]
    # window i keeps the encoder frames of input frames [margin, chunk -
    # margin), the whole of its outer ends; subsampling is 4x, with the exact
    # length formula
    margin = overlap_frames // 2
    pieces = []
    for i in range(n):
        lo = _sub(margin) if i and margin else 0
        hi = enc_lens[i] if i == n - 1 else _sub(chunk_frames - margin)
        pieces.append(logits[i, lo : min(hi, enc_lens[i])])
    return torch.cat(pieces, dim=0)


def longform_greedy_decode(
    model,
    feats: np.ndarray,
    binary_mask: Optional[torch.Tensor],
    blank_id: int,
    chunk_frames: int = 3000,
    overlap_frames: int = 400,
    device="cpu",
) -> Tuple[np.ndarray, int]:
    """(label ids, count) of one arbitrarily long recording."""
    logits = longform_logits(model, feats, binary_mask, chunk_frames, overlap_frames, device)
    ids, n = greedy_ctc_decode(logits[None], torch.tensor([logits.shape[0]],
                                                          device=logits.device), blank_id)
    k = int(n[0])
    return ids[0, :k].cpu().numpy(), k

"""Batched prefix CTC beam search on the device, optionally LM-fused.

Counterpart of onebit_asr_tpu/decode/beam_device.py, which scans
`_beam_search_single` over frames and vmaps it over the batch. Here the state
is explicit, [B, W] per beam field and [B, W, max_len] for the prefixes, and
a Python loop runs over frames; the body is the same:

- each beam stays (blank, or the collapsed repeat of its last token) or
  extends with one of the frame's top-K tokens;
- beams hold unique prefixes, so an extension can only collide with a stay
  candidate whose prefix is its own: a [W, K, W] match of two 32-bit rolling
  hashes and the length finds those, merges their mass in log space and
  drops the extension;
- the best W of the W + W*K candidates survive, the extended ones get their
  new token written into their prefix row;
- past an utterance's length its state stays frozen.

`jax.lax.top_k` puts the lower index first among equal values; `torch.topk`
promises no order. Both top-k selections here (the frame's K tokens, the W
survivors) therefore take the first entries of a stable descending sort,
which orders ties as JAX does. The frames' top-K tokens do not depend on the
beam, so one sort over [B, T, V] takes them all before the loop, and the
loop stops at the longest utterance (later frames change nothing).

The hashes are uint32 arithmetic mod 2^32 kept in int64 (lm_device.mul32).
The loop launches a few dozen small kernels a frame: on the card the search
is bound by the host's launch rate, not by the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from onebit_asr_tpu_torch.decode.lm_device import DeviceLM, mul32

NEG_INF = -1e30
_MUL1 = 1000003
_MUL2 = 2654435761
_MASK32 = 0xFFFFFFFF


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    m_safe = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
    lo = torch.minimum(a, b)
    out = m_safe + torch.log1p(torch.exp(lo - m_safe) * (lo > NEG_INF))
    return torch.where(m <= NEG_INF, torch.full_like(m, NEG_INF), out)


def _reduce_logaddexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """logaddexp-reduce `dim` of `x` with NEG_INF as the identity."""
    m = x.amax(dim=dim)
    m_safe = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
    s = (torch.exp(x - m_safe.unsqueeze(dim)) * (x > NEG_INF)).sum(dim=dim)
    out = m_safe + torch.log(s.clamp(min=1e-37))
    return torch.where(m <= NEG_INF, torch.full_like(m, NEG_INF), out)


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, the lower
    index first among equal values (jax.lax.top_k's order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def beam_search_device(
    log_probs: torch.Tensor,  # [B, T, V] log-softmax
    valid_lens: torch.Tensor,  # [B]
    blank_id: int = 3,
    beam_size: int = 10,
    top_k: int = 20,
    max_len: int = 256,
    lm: Optional[DeviceLM] = None,
    lm_weight: float = 0.0,
    length_bonus: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids [B, max_len] int64, -1 past each length; lens [B]), on the
    device of `log_probs`. `lm` (a DeviceLM on the same device) is fused
    only with a nonzero `lm_weight`."""
    B, T, V = log_probs.shape
    W, K = beam_size, min(top_k, V)
    dev = log_probs.device
    lp = log_probs.to(torch.float32)
    fuse = lm is not None and bool(lm_weight)
    valid_lens = valid_lens.to(device=dev, dtype=torch.int64)
    t_end = min(T, int(valid_lens.max())) if B else 0
    topv, topi = stable_top_k(lp[:, :t_end], K)  # [B, t_end, K]
    lp_blank = lp[:, :t_end, blank_id]  # [B, t_end]

    neg = torch.full((B, W), NEG_INF, dtype=torch.float32, device=dev)
    prefixes = torch.full((B, W, max_len), -1, dtype=torch.int64, device=dev)
    plen = torch.zeros((B, W), dtype=torch.int64, device=dev)
    last = torch.full((B, W), -1, dtype=torch.int64, device=dev)
    pb = neg.clone()
    pb[:, 0] = 0.0  # the empty prefix, all its mass on blank
    pnb = neg.clone()
    # distinct hash seeds for the initially empty slots keep dead slots from
    # merging with one another
    ar = torch.arange(W, dtype=torch.int64, device=dev)
    h1 = (ar * 7919 + 1).expand(B, W).clone()
    h2 = (ar * 104729 + 2).expand(B, W).clone()
    h1[:, 0] = 0
    h2[:, 0] = 0
    rows = torch.arange(B, device=dev)[:, None]  # [B, 1]

    for t in range(t_end):
        tv, ti = topv[:, t], topi[:, t]  # [B, K]
        total = _logaddexp(pb, pnb)  # [B, W]

        # stay candidates, one per beam: the blank path and the collapsed repeat
        is_rep = ti[:, None, :] == last[:, :, None]  # [B, W, K]
        rep_lp = torch.where(is_rep, tv[:, None, :], NEG_INF).amax(dim=-1)
        stay_pb = total + lp_blank[:, t, None]
        stay_pnb = pnb + rep_lp

        # extend candidates, W x K: prefix + c, from pb alone when c == last
        src = torch.where(is_rep, pb[:, :, None], total[:, :, None])
        ext = src + tv[:, None, :]
        if fuse:
            ext = ext + lm_weight * lm.scores(prefixes, plen, ti)
        if length_bonus:
            ext = ext + length_bonus
        ext = torch.where((ti == blank_id)[:, None, :], NEG_INF, ext)
        ext = torch.where((plen >= max_len)[:, :, None], NEG_INF, ext)
        c = ti + 1  # [B, K]
        ext_h1 = (mul32(h1, _MUL1)[:, :, None] + c[:, None, :]) & _MASK32  # [B, W, K]
        ext_h2 = (mul32(h2, _MUL2)[:, :, None] + c[:, None, :]) & _MASK32

        # merge extend(w, c) into stay(w') where the prefixes match
        match = ((ext_h1[..., None] == h1[:, None, None, :])
                 & (ext_h2[..., None] == h2[:, None, None, :])
                 & ((plen + 1)[:, :, None, None] == plen[:, None, None, :]))  # [B, W, K, W]
        inflow = torch.where(match, ext[..., None], NEG_INF).reshape(B, W * K, W)
        stay_pnb = _logaddexp(stay_pnb, _reduce_logaddexp(inflow, dim=1))
        ext = torch.where(match.any(dim=-1), NEG_INF, ext)

        # the best W of W stay + W*K extend candidates
        scores = torch.cat([_logaddexp(stay_pb, stay_pnb), ext.reshape(B, W * K)], dim=1)
        _, sel = stable_top_k(scores, W)  # [B, W]
        is_stay = sel < W
        w_stay = sel.clamp(0, W - 1)
        e = (sel - W).clamp(0, W * K - 1)
        w_ext, k_ext = e // K, e % K
        parent = torch.where(is_stay, w_stay, w_ext)
        tok = ti.gather(1, k_ext)  # [B, W]

        new_prefixes = prefixes[rows, parent]  # [B, W, max_len]
        new_plen = torch.where(is_stay, plen.gather(1, w_stay), plen.gather(1, w_ext) + 1)
        new_last = torch.where(is_stay, last.gather(1, w_stay), tok)
        new_pb = torch.where(is_stay, stay_pb.gather(1, w_stay), NEG_INF)
        new_pnb = torch.where(is_stay, stay_pnb.gather(1, w_stay),
                              ext.reshape(B, W * K).gather(1, e))
        new_h1 = torch.where(is_stay, h1.gather(1, w_stay),
                             ext_h1.reshape(B, W * K).gather(1, e))
        new_h2 = torch.where(is_stay, h2.gather(1, w_stay),
                             ext_h2.reshape(B, W * K).gather(1, e))
        # write the new token of the extended beams
        pos = plen.gather(1, w_ext).clamp(0, max_len - 1)[..., None]  # [B, W, 1]
        old = new_prefixes.gather(2, pos)[..., 0]
        new_prefixes = new_prefixes.scatter(2, pos, torch.where(is_stay, old, tok)[..., None])

        # freeze past each utterance's end
        active = (t < valid_lens)[:, None]  # [B, 1]
        prefixes = torch.where(active[..., None], new_prefixes, prefixes)
        plen = torch.where(active, new_plen, plen)
        last = torch.where(active, new_last, last)
        pb = torch.where(active, new_pb, pb)
        pnb = torch.where(active, new_pnb, pnb)
        h1 = torch.where(active, new_h1, h1)
        h2 = torch.where(active, new_h2, h2)

    best = _logaddexp(pb, pnb).argmax(dim=1)  # [B]
    ids = prefixes[torch.arange(B, device=dev), best]
    n = plen[torch.arange(B, device=dev), best]
    ids = torch.where(torch.arange(max_len, device=dev)[None] < n[:, None], ids, -1)
    return ids, n

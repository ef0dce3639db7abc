"""Prefix CTC beam search on the host: batched numpy, optional LM fusion.

Own copy of onebit_asr_tpu/decode/beam.py. Beams are keyed by prefix, each
with (p_blank, p_non_blank) in log space; per frame the top-k candidates
(default 20) extend them and the best `beam_size` survive. The merge rules
are the standard Hannun ones:

    c == last:  p_nb(l)   += p_nb(l) + lp_c      (collapsed repeat)
                p_nb(l+c) += p_b(l)  + lp_c      (new char after blank)
    c != last:  p_nb(l+c) += logaddexp(p_b, p_nb) + lp_c

With `lm`, `lm_weight` and `length_bonus`, every prefix extension also
scores `lm_weight * log P_LM(c | prefix) + length_bonus` (decode/lm.py).

`ctc_beam_search_batch` runs the C++ copy (native/) by default and this
module's Python with `prefer_native=False`; decode/beam_device.py is the
batched search on the device, which this module is the reference for.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

NEG_INF = -math.inf


def _logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log1p(math.exp(-abs(a - b)))


def ctc_beam_search(
    log_probs: np.ndarray,  # [T, V] log-softmax scores (valid frames only)
    beam_size: int = 10,
    blank_id: int = 3,
    top_k_per_t: int = 20,
    lm=None,  # object with .score(prefix, c) -> log P_LM(c | prefix)
    lm_weight: float = 0.0,
    length_bonus: float = 0.0,
) -> List[int]:
    """Best label sequence for one utterance."""
    T, V = log_probs.shape
    beams: Dict[Tuple[int, ...], Tuple[float, float]] = {(): (0.0, NEG_INF)}
    fuse = lm is not None and lm_weight != 0.0
    lm_cache: Dict[Tuple[Tuple[int, ...], int], float] = {}

    def lm_bonus(prefix: Tuple[int, ...], c: int) -> float:
        if not fuse:
            return length_bonus
        # context window = order-1 tokens; for a unigram LM (order<=1) the
        # context is EMPTY — `prefix[-0:]` would be the whole prefix and the
        # cache would never hit, so special-case to ().
        ctx = getattr(lm, "order", 99) - 1
        key = (prefix[-ctx:] if ctx > 0 else (), c)
        v = lm_cache.get(key)
        if v is None:
            v = lm_weight * lm.score(key[0], c)
            lm_cache[key] = v
        return v + length_bonus

    for t in range(T):
        lp = log_probs[t]
        if top_k_per_t and top_k_per_t < V:
            cand_ids = np.argpartition(lp, -top_k_per_t)[-top_k_per_t:]
        else:
            cand_ids = np.arange(V)
        lp_blank = float(lp[blank_id])

        new_beams: Dict[Tuple[int, ...], List[float]] = {}

        def slot(prefix) -> List[float]:
            s = new_beams.get(prefix)
            if s is None:
                s = [NEG_INF, NEG_INF]
                new_beams[prefix] = s
            return s

        for prefix, (p_b, p_nb) in beams.items():
            total = _logsumexp2(p_b, p_nb)
            # blank extension keeps the prefix
            s = slot(prefix)
            s[0] = _logsumexp2(s[0], total + lp_blank)
            last = prefix[-1] if prefix else None
            for c in cand_ids:
                if c == blank_id:
                    continue
                lp_c = float(lp[c])
                if c == last:
                    # collapsed repeat stays on the prefix (from p_nb);
                    # post-blank emission extends it (from p_b)
                    s = slot(prefix)
                    s[1] = _logsumexp2(s[1], p_nb + lp_c)
                    ext = prefix + (int(c),)
                    se = slot(ext)
                    se[1] = _logsumexp2(
                        se[1], p_b + lp_c + lm_bonus(prefix, int(c))
                    )
                else:
                    ext = prefix + (int(c),)
                    se = slot(ext)
                    se[1] = _logsumexp2(
                        se[1], total + lp_c + lm_bonus(prefix, int(c))
                    )

        pruned = sorted(
            new_beams.items(),
            key=lambda kv: _logsumexp2(kv[1][0], kv[1][1]),
            reverse=True,
        )[:beam_size]
        beams = {k: (v[0], v[1]) for k, v in pruned}

    best = max(beams.items(), key=lambda kv: _logsumexp2(kv[1][0], kv[1][1]))[0]
    return list(best)


def ctc_beam_search_batch(
    log_probs: np.ndarray,  # [B, T, V] log-softmax scores
    valid_lens: np.ndarray,  # [B]
    beam_size: int = 10,
    blank_id: int = 3,
    top_k_per_t: int = 20,
    lm=None,
    lm_weight: float = 0.0,
    length_bonus: float = 0.0,
    prefer_native: bool = True,
) -> List[List[int]]:
    """Per-utterance beam search over a padded batch.

    `prefer_native` runs the C++ copy (native/, built at first use; a failed
    build raises), else this module's Python: the same algorithm."""
    if prefer_native:
        from onebit_asr_tpu_torch import native

        nlm = native.NativeLM(lm) if (lm is not None and lm_weight) else None
        return [
            native.ctc_beam_search_native(
                log_probs[b, : int(valid_lens[b])],
                beam_size=beam_size,
                blank_id=blank_id,
                top_k_per_t=top_k_per_t,
                native_lm=nlm,
                lm_weight=lm_weight,
                length_bonus=length_bonus,
            )
            for b in range(log_probs.shape[0])
        ]
    return [
        ctc_beam_search(
            log_probs[b, : int(valid_lens[b])],
            beam_size=beam_size,
            blank_id=blank_id,
            top_k_per_t=top_k_per_t,
            lm=lm,
            lm_weight=lm_weight,
            length_bonus=length_bonus,
        )
        for b in range(log_probs.shape[0])
    ]

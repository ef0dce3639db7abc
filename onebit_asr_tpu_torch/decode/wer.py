"""Word and character error rates: Levenshtein over word (character) lists
on the host. A copy of onebit_asr_tpu/decode/wer.py: `compute_wer` returns
(total edit distance, total reference words); the caller takes the ratio.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def levenshtein_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Edit distance over word lists.

    Row-vectorized DP: per row, deletion/substitution candidates are pure
    numpy; the sequential insertion chain cur[j] = min(cur[j], cur[j-1]+1)
    is solved in one pass via min-accumulate of (candidate[j] - j) + j.
    """
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    hyp_arr = np.asarray(hyp, dtype=object)
    jj = np.arange(n + 1, dtype=np.int64)
    prev = jj.copy()  # d[0][j] = j
    for i in range(1, m + 1):
        cand = np.empty(n + 1, dtype=np.int64)
        cand[0] = i  # d[i][0]
        sub = prev[:-1] + (hyp_arr != ref[i - 1])  # diagonal + cost
        dele = prev[1:] + 1  # from row above
        cand[1:] = np.minimum(sub, dele)
        # insertion chain: cur[j] = min_{k<=j} cand[k] + (j-k)
        prev = np.minimum.accumulate(cand - jj) + jj
    return int(prev[n])


def compute_wer(refs: List[str], hyps: List[str]) -> Tuple[int, int]:
    """Total (edit_distance, ref_words) over paired transcript strings.
    WER = distance / max(words, 1)."""
    total_dist = 0
    total_words = 0
    for ref, hyp in zip(refs, hyps):
        ref_words = ref.split()
        hyp_words = hyp.split()
        total_dist += levenshtein_distance(ref_words, hyp_words)
        total_words += len(ref_words)
    return total_dist, total_words


def compute_cer(refs: List[str], hyps: List[str]) -> Tuple[int, int]:
    """Character error rate counterpart: (edit_distance, ref_chars) over
    character sequences (whitespace included, as is standard)."""
    total_dist = 0
    total_chars = 0
    for ref, hyp in zip(refs, hyps):
        total_dist += levenshtein_distance(list(ref), list(hyp))
        total_chars += len(ref)
    return total_dist, total_chars

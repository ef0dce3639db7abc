"""Token n-gram language model for shallow fusion in CTC beam search.

Own copy of onebit_asr_tpu/decode/lm.py: when the beam extends a prefix with
token c, the extension's score gains  lm_weight * log P_LM(c | prefix) +
length_bonus. `NGramLM` is a stupid-backoff n-gram model over token ids (the
tokenizer's model-side ids, offset included), stored as .npz in the layout
the JAX package writes, so either package reads the other's. The beams call
`.score(context, c)` and read `.order`; `score_batch` is a convenience.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

LOG_BACKOFF = float(np.log(0.4))  # stupid backoff factor (Brants et al.)
FLOOR = -20.0  # log-prob floor for unseen unigrams


class NGramLM:
    """Stupid-backoff n-gram LM over token ids.

    score(context, c) = log(count(context+c) / count(context)) if seen,
    else log(0.4) + score(context[1:], c); unigram falls back to a floored
    MLE over the training corpus.
    """

    def __init__(self, order: int = 3):
        if order < 1:
            raise ValueError("order must be >= 1")
        self.order = order
        # counts[n] maps an n-token tuple -> count (n = 1..order)
        self.counts: List[Dict[Tuple[int, ...], int]] = [
            dict() for _ in range(order + 1)
        ]
        self.total = 0

    # ---------------------------------------------------------------- train

    def fit(self, sequences: Sequence[Sequence[int]]) -> "NGramLM":
        counts = [defaultdict(int) for _ in range(self.order + 1)]
        total = 0
        for seq in sequences:
            toks = [int(t) for t in seq]
            total += len(toks)
            for i in range(len(toks)):
                for n in range(1, self.order + 1):
                    if i + n <= len(toks):
                        counts[n][tuple(toks[i : i + n])] += 1
        self.counts = [dict(c) for c in counts]
        self.total = total
        return self

    # ---------------------------------------------------------------- score

    def score(self, context: Sequence[int], c: int) -> float:
        """log P(c | context) with stupid backoff."""
        ctx = tuple(int(t) for t in context[-(self.order - 1):]) if self.order > 1 else ()
        penalty = 0.0
        while True:
            n = len(ctx) + 1
            num = self.counts[n].get(ctx + (int(c),))
            if num:
                den = self.counts[len(ctx)].get(ctx) if ctx else self.total
                if den:
                    return penalty + float(np.log(num / den))
            if not ctx:
                return penalty + FLOOR
            ctx = ctx[1:]
            penalty += LOG_BACKOFF

    def score_batch(self, context: Sequence[int], cand_ids: np.ndarray) -> np.ndarray:
        return np.asarray([self.score(context, int(c)) for c in cand_ids], np.float32)

    # ------------------------------------------------------------------- io

    def save(self, path: str) -> None:
        keys, vals = [], []
        for n in range(1, self.order + 1):
            for k, v in self.counts[n].items():
                keys.append(np.asarray((n,) + k + (0,) * (self.order - n), np.int64))
                vals.append(v)
        np.savez_compressed(
            path,
            order=self.order,
            total=self.total,
            keys=np.stack(keys) if keys else np.zeros((0, self.order + 1), np.int64),
            vals=np.asarray(vals, np.int64),
        )

    @classmethod
    def load(cls, path: str) -> "NGramLM":
        z = np.load(path)
        lm = cls(order=int(z["order"]))
        lm.total = int(z["total"])
        for row, v in zip(z["keys"], z["vals"]):
            n = int(row[0])
            lm.counts[n][tuple(int(x) for x in row[1 : n + 1])] = int(v)
        return lm

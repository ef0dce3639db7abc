"""Synthetic data backend: a copy of onebit_asr_tpu/data/dummy.py.

Numpy only, so the same seed gives the same batches as the JAX package's:
seeded synthetic batches with the training batch contract {feats [B,T,F],
feat_lens [B], tokens [B,U], token_lens [B]} and the same default shapes
(T=160, F=80, U=40, vocab 32, 256 train / 64 valid samples). Each token id
has a fixed random "acoustic signature" tiled over its share of frames, so
the mapping audio -> tokens is learnable.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from onebit_asr_tpu_torch.utils.config import SpecialTokens


def _subsampled_length(t: int) -> int:
    """Exact two-stride-2-VALID-conv output length (model/conformer.py)."""
    return ((t - 1) // 2 - 1) // 2


class DummyDataModule:
    """Seeded synthetic dataset with static shapes.

    Token lengths are capped so every utterance has a feasible CTC
    alignment (enc_len >= token_len; generated tokens avoid immediate
    repeats so no extra blank frames are required).
    """

    def __init__(
        self,
        batch_size: int = 16,
        max_frames: int = 160,
        max_tokens: int = 40,
        vocab_size: int = 32,
        feat_dim: int = 80,
        num_train: int = 256,
        num_valid: int = 64,
        seed: int = 0,
        specials: SpecialTokens = SpecialTokens(),
    ):
        self.batch_size = batch_size
        self.max_frames = max_frames
        self.max_tokens = max_tokens
        self._vocab_size = vocab_size
        self.feat_dim = feat_dim
        self.specials = specials
        self.seed = seed

        rng = np.random.default_rng(seed)
        # one fixed signature vector per token id
        self._signatures = rng.standard_normal(
            (vocab_size, feat_dim)
        ).astype(np.float32)
        min_len = max_frames - min(4, max_frames // 8)
        u_cap = min(max_tokens, max(1, _subsampled_length(min_len)))
        self._train = self._make_split(rng, num_train, min_len, u_cap)
        self._valid = self._make_split(rng, num_valid, min_len, u_cap)

    def _make_split(self, rng, n: int, min_len: int, u_cap: int) -> Dict:
        T, U, F = self.max_frames, self.max_tokens, self.feat_dim
        off = self.specials.offset
        feats = np.zeros((n, T, F), np.float32)
        feat_lens = rng.integers(min_len, T + 1, n).astype(np.int32)
        tokens = np.zeros((n, U), np.int32)
        token_lens = rng.integers(min(2, u_cap), u_cap + 1, n).astype(np.int32)
        for i in range(n):
            u = int(token_lens[i])
            # sample without immediate repeats for CTC feasibility
            seq = rng.integers(off, self._vocab_size, u)
            for j in range(1, u):
                while seq[j] == seq[j - 1]:
                    seq[j] = rng.integers(off, self._vocab_size)
            tokens[i, :u] = seq
            t = int(feat_lens[i])
            # tile each token's signature over its share of frames
            frame_tok = seq[np.minimum((np.arange(t) * u) // t, u - 1)]
            feats[i, :t] = self._signatures[frame_tok] + 0.3 * rng.standard_normal(
                (t, F)
            ).astype(np.float32)
        return {
            "feats": feats,
            "feat_lens": feat_lens,
            "tokens": tokens,
            "token_lens": token_lens,
        }

    # -- surface (reference dataloader_stub.py:157-233 contract) --------

    def vocab_size(self) -> int:
        return self._vocab_size

    def special_ids(self) -> Dict[str, int]:
        return self.specials.as_dict()

    def num_utts(self, split: str = "train") -> int:
        return len(
            (self._train if split == "train" else self._valid)["feat_lens"]
        )

    def _batches(self, split: Dict, order: np.ndarray) -> Iterator[Dict]:
        B = self.batch_size
        for s in range(0, len(order) - B + 1, B):
            idx = order[s : s + B]
            yield {k: v[idx] for k, v in split.items()}

    def train_batches(self, epoch: int = 0) -> Iterator[Dict]:
        rng = np.random.default_rng((self.seed, 1, epoch))
        order = rng.permutation(len(self._train["feat_lens"]))
        return self._batches(self._train, order)

    def valid_batches(self) -> Iterator[Dict]:
        order = np.arange(len(self._valid["feat_lens"]))
        return self._batches(self._valid, order)

    # alias: the dummy corpus has no held-out test split distinct from valid
    test_batches = valid_batches

"""The n-gram LM as tensors, for shallow fusion inside the device beam.

Counterpart of onebit_asr_tpu/decode/lm_device.py. One open-addressed hash
table holds every stored n-gram of every level, with its local score
log(count(t_1..t_n) / count(t_1..t_{n-1})) computed at pack time. Keys are
two 32-bit multiplicative hashes of (n, t_1..t_n). `pack` builds JAX's
open-addressed table bit for bit (k1, k2, val and `max_probes`, the longest
probe distance; load factor <= 0.5), where a lookup takes the first of
`max_probes` linear probes that holds the key.

Every key is stored once, at a distance below `max_probes` from its home
slot, so that lookup hits exactly when the key is in the table, and then
returns its one value. The hashes cluster in the low bits that pick the home
slot, though: an LM of 24,018 n-grams over 5,004 tokens (500 seeded
sequences) probes 6,079 slots, and JAX unrolls them all. The lookup here
therefore searches a sorted copy of the occupied keys instead
(`torch.searchsorted`, a few launches a level whatever the clustering),
with the same hits and values.

The hashes are uint32 arithmetic that wraps mod 2^32, as JAX computes them.
PyTorch has no general uint32 arithmetic, and in int64 `h * 2654435761`
overflows once h >= 2^31, so the hashes live in int64 tensors holding values
in [0, 2^32) and `mul32` multiplies in 16-bit halves, each product below
2^48: the same bits as JAX's, on either device.

`scores` applies the backoff of `NGramLM.score`: the longest usable context
L0 = min(order-1, len(prefix)), log(0.4) per level backed off, the unigram
floor when every level misses. Every level's probe is independent, so all
run at once and the longest eligible hit wins.
"""

from __future__ import annotations

import numpy as np
import torch

from onebit_asr_tpu_torch.decode.lm import FLOOR, LOG_BACKOFF, NGramLM

_M1 = 1000003
_M2 = 2654435761
_MASK32 = 0xFFFFFFFF
_SEED1 = 2166136261
_SEED2 = 0x9E3779B9


def mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 `h` in [0, 2^32) and 0 <= m < 2^32."""
    lo = (h & 0xFFFF) * m  # < 2^48
    hi = ((h >> 16) * m) & 0xFFFF  # the high half's product, mod 2^16
    return (lo + (hi << 16)) & _MASK32


def _fold_host(h1: int, h2: int, tok: int):
    t = (int(tok) + 1) & _MASK32
    return ((h1 * _M1) + t) & _MASK32, ((h2 * _M2) + t) & _MASK32


def _hash_host(tokens) -> tuple:
    h1, h2 = _SEED1, _SEED2
    for t in tokens:
        h1, h2 = _fold_host(h1, h2, t)
    if h1 == 0 and h2 == 0:  # (0, 0) is the empty-slot sentinel
        h1 = 1
    return h1, h2


def _fold_dev(h1: torch.Tensor, h2: torch.Tensor, tok: torch.Tensor):
    t = (tok.to(torch.int64) + 1) & _MASK32
    return (mul32(h1, _M1) + t) & _MASK32, (mul32(h2, _M2) + t) & _MASK32


def _joint(h1, h2):
    """One int64 per (h1, h2) pair of 32-bit hashes, order-preserving and
    free of overflow: (h1 - 2^31) * 2^32 + h2."""
    return (h1 - (1 << 31)) * (1 << 32) + h2


class DeviceLM:
    """Packed stupid-backoff n-gram LM (see the module docstring): k1/k2
    int64 keys in [0, 2^32) and val f32 local scores, all [size] (JAX's
    table); `keys`/`vals`, the occupied slots' joint keys sorted and their
    values, serve the lookups."""

    def __init__(self, k1: torch.Tensor, k2: torch.Tensor, val: torch.Tensor, order: int,
                 max_probes: int):
        self.k1, self.k2, self.val = k1, k2, val
        self.order = int(order)
        self.max_probes = int(max_probes)
        occupied = (k1 != 0) | (k2 != 0)
        self.keys, perm = torch.sort(_joint(k1[occupied], k2[occupied]))
        self.vals = val[occupied][perm]

    @classmethod
    def pack(cls, lm: NGramLM, device="cpu") -> "DeviceLM":
        """Pack a host NGramLM into tables on `device`."""
        entries = []  # (h1, h2, local score)
        for n in range(1, lm.order + 1):
            for key, num in lm.counts[n].items():
                den = lm.total if n == 1 else lm.counts[n - 1].get(key[:-1])
                if not den:
                    continue  # unreachable for fit()-built models
                h1, h2 = _hash_host((n,) + key)
                entries.append((h1, h2, float(np.log(num / den))))
        size = 64
        while size < 2 * max(len(entries), 1):
            size *= 2
        mask = size - 1
        k1 = np.zeros((size,), np.int64)
        k2 = np.zeros((size,), np.int64)
        val = np.zeros((size,), np.float32)
        max_probes = 1
        for h1, h2, v in entries:
            j = 0
            idx = h1 & mask
            while k1[idx] or k2[idx]:
                if int(k1[idx]) == h1 and int(k2[idx]) == h2:
                    break  # a duplicate hash (an n-gram cannot recur)
                j += 1
                idx = (idx + 1) & mask
            k1[idx], k2[idx], val[idx] = h1, h2, v
            max_probes = max(max_probes, j + 1)
        as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return cls(as_t(k1), as_t(k2), as_t(val), lm.order, max_probes)

    def _probe(self, q1: torch.Tensor, q2: torch.Tensor):
        """(hit bool, value f32) for query hashes of any shape: what JAX's
        probe loop finds, by a binary search of the sorted keys."""
        q = _joint(q1, q2)
        if not len(self.keys):
            return torch.zeros_like(q, dtype=torch.bool), torch.zeros_like(q, dtype=torch.float32)
        pos = torch.searchsorted(self.keys, q).clamp(max=len(self.keys) - 1)
        found = self.keys[pos] == q
        return found, torch.where(found, self.vals[pos], 0.0)

    def scores(self, prefixes: torch.Tensor, plen: torch.Tensor,
               cand: torch.Tensor) -> torch.Tensor:
        """log P(cand | prefix) with stupid backoff, the arithmetic of
        NGramLM.score. prefixes [..., W, L] int token rows (padding ignored),
        plen [..., W] their lengths, cand [..., K] candidate tokens ->
        [..., W, K] f32."""
        lmax = self.order - 1
        plen = plen.to(torch.int64)
        # the last lmax tokens of each prefix, left-aligned into lmax slots
        pos = plen[..., None] - lmax + torch.arange(lmax, device=plen.device)
        ctx = torch.gather(prefixes.to(torch.int64), -1,
                           pos.clamp(0, prefixes.shape[-1] - 1))  # [..., W, lmax]
        l0 = plen.clamp(max=lmax)  # [..., W]
        cand = cand.to(torch.int64)[..., None, :]  # [..., 1, K]
        # all-miss base: every tried level backs off, the unigram floors
        score = (l0.to(torch.float32) * LOG_BACKOFF + FLOOR)[..., None]
        score = score.expand(*l0.shape, cand.shape[-1])
        for level in range(lmax + 1):  # ascending: the longest hit wins last
            h1 = torch.full(l0.shape, _SEED1, dtype=torch.int64, device=l0.device)
            h2 = torch.full(l0.shape, _SEED2, dtype=torch.int64, device=l0.device)
            h1, h2 = _fold_dev(h1, h2, torch.full_like(l0, level + 1))  # the n tag
            for i in range(lmax - level, lmax):
                h1, h2 = _fold_dev(h1, h2, ctx[..., i])
            q1, q2 = _fold_dev(h1[..., None], h2[..., None], cand)
            q1 = torch.where((q1 == 0) & (q2 == 0), torch.ones_like(q1), q1)
            hit, value = self._probe(q1, q2)
            eligible = hit & (level <= l0)[..., None]
            cand_score = (l0[..., None] - level).to(torch.float32) * LOG_BACKOFF + value
            score = torch.where(eligible, cand_score, score)
        return score

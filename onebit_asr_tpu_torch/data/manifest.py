"""Utterance manifests, waveform shards and length bucketing (numpy only).

Own copy of onebit_asr_tpu/data/manifest.py, which the data dirs of either
package follow: a JSONL manifest row per utterance with its sample count
cached (batching never reads audio), waveforms in npz shards keyed by
`utt_id`, and optionally a prepare-time log-mel cache (one [sum_T, F]
float16 `.npy` per split, memory-mapped; or legacy npz members).
`bucket_boundaries`/`bucketed_batches` give at most `num_buckets` padded
lengths per split, each batch drawn from one bucket; for the same lengths
and `np.random.default_rng` they give JAX's batches in JAX's order.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclass
class Utterance:
    """One manifest row. `shard`/`index` locate the waveform; `num_samples`
    is cached; `tokens` are model-side ids (offset-shifted), empty until a
    tokenize step fills them. `feat_shard`/`feat_index`/`num_frames`
    locate cached features ("" = none)."""

    utt_id: str
    shard: str
    index: int
    num_samples: int
    text: str
    tokens: List[int] = field(default_factory=list)
    feat_shard: str = ""
    feat_index: int = -1  # row offset into the .npy memmap (npz: unused)
    num_frames: int = 0


def read_manifest(path: str) -> List[Utterance]:
    utts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                utts.append(Utterance(**json.loads(line)))
    return utts


def write_manifest(path: str, utts: List[Utterance]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for u in utts:
            f.write(json.dumps(asdict(u)) + "\n")
    os.replace(tmp, path)


class ShardCache:
    """Lazy npz shard reader keeping the `max_open` newest shards open, and
    the `.npy` feature caches memory-mapped."""

    def __init__(self, data_dir: str, max_open: int = 4):
        self.data_dir = data_dir
        self.max_open = max_open
        self._open: Dict[str, "np.lib.npyio.NpzFile"] = {}
        self._mmaps: Dict[str, np.ndarray] = {}

    def _shard(self, name: str):
        if name not in self._open:
            if len(self._open) >= self.max_open:
                oldest = next(iter(self._open))
                self._open.pop(oldest).close()
            self._open[name] = np.load(os.path.join(self.data_dir, name))
        return self._open[name]

    def wav(self, utt: Utterance) -> np.ndarray:
        return np.asarray(self._shard(utt.shard)[utt.utt_id], np.float32)

    def feats(self, utt: Utterance) -> np.ndarray:
        """Cached log-mel features [T, F] (stored float16), as float32."""
        if utt.feat_shard.endswith(".npy"):
            if utt.feat_shard not in self._mmaps:
                self._mmaps[utt.feat_shard] = np.load(
                    os.path.join(self.data_dir, utt.feat_shard), mmap_mode="r")
            m = self._mmaps[utt.feat_shard]
            return np.asarray(m[utt.feat_index : utt.feat_index + utt.num_frames], np.float32)
        return np.asarray(self._shard(utt.feat_shard)[utt.utt_id], np.float32)

    def close(self) -> None:
        for f in self._open.values():
            f.close()
        self._open.clear()
        self._mmaps.clear()


def bucket_boundaries(lengths: np.ndarray, num_buckets: int) -> np.ndarray:
    """Quantile bucket upper bounds (ascending, last == max(lengths)). A
    length L belongs to bucket `min(searchsorted(bounds, L), num_buckets -
    1)`: the first bound >= L."""
    lengths = np.asarray(lengths)
    qs = np.quantile(lengths, (np.arange(num_buckets) + 1) / num_buckets)
    bounds = np.ceil(qs).astype(np.int64)
    bounds[-1] = lengths.max()
    return np.maximum.accumulate(bounds)


def bucketed_batches(
    lengths: np.ndarray,
    bounds: np.ndarray,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = True,
) -> Iterator[np.ndarray]:
    """Index arrays, each batch from ONE bucket. With `rng`, shuffled within
    buckets and in batch order; without, in length order. `drop_last=False`
    also yields each bucket's remainder as a smaller batch."""
    lengths = np.asarray(lengths)
    bucket_ids = np.minimum(np.searchsorted(bounds, lengths), len(bounds) - 1)
    batches = []
    for b in range(len(bounds)):
        idx = np.nonzero(bucket_ids == b)[0]
        if rng is not None:
            idx = rng.permutation(idx)
        n_full = len(idx) // batch_size
        for s in range(n_full):
            batches.append(idx[s * batch_size : (s + 1) * batch_size])
        if not drop_last and len(idx) % batch_size:
            batches.append(idx[n_full * batch_size :])
    if rng is not None:
        order = rng.permutation(len(batches))
        batches = [batches[i] for i in order]
    yield from batches

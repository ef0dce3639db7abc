"""LibriSpeech data module: manifest -> bucketed static batches -> frontend,
CMVN and SpecAugment on the device.

Counterpart of onebit_asr_tpu/data/librispeech.py, on the same data dirs
(`{split}_manifest.jsonl` + npz shards, a tokenizer, optionally
`cmvn_stats.npz` and a prepare-time feature cache) and with the same batch
contract {feats [B, T, F], feat_lens, tokens [B, U], token_lens}:

  manifest (lengths cached) -> quantile length buckets, one static pad each
    -> host gather of the raw waveforms -> log-mel on `device`
      -> CMVN (statistics loaded once, kept on `device`)
        -> SpecAugment (training only)

Bucketing, padding, shuffling (`np.random.default_rng((seed, epoch))`) and
the waveform, token and cached-feature batches equal JAX's exactly. The
random draws do not: JAX folds jax.random keys; here each batch `i` of
epoch `epoch` draws its SpecAugment starts (and its dither seed) from
`np.random.default_rng((seed, epoch, i))`, never from global state.

The frontend and SpecAugment run on `device` (cuda by default) and nothing
moves back to the host. Environment switches, as in JAX:
ONEBIT_NO_FEATURE_CACHE=1 ignores a feature cache (the frontend runs);
ONEBIT_F32_FEATS=1 ships cached features as float32 instead of float16.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from onebit_asr_tpu_torch.data.manifest import (
    ShardCache,
    Utterance,
    bucket_boundaries,
    bucketed_batches,
    read_manifest,
)
from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, apply_cmvn
from onebit_asr_tpu_torch.ops.specaugment import draw_starts, spec_augment_from_config
from onebit_asr_tpu_torch.utils.config import DataConfig, FrontendConfig


class LibriSpeechDataModule:
    """Bucketed, statically shaped batches from a prepared data dir; splits
    without a manifest are absent."""

    def __init__(
        self,
        data_dir: str,
        tokenizer,
        cfg: Optional[DataConfig] = None,
        seed: int = 0,
        splits: Tuple[str, ...] = ("train", "dev", "test"),
        frontend_cfg: Optional[FrontendConfig] = None,
        device="cuda",
    ):
        self.data_dir = data_dir
        self.tokenizer = tokenizer
        self.cfg = cfg or DataConfig(data_dir=data_dir)
        self.seed = seed
        self.device = torch.device(device)
        self.frontend = LogMelFrontend(frontend_cfg or FrontendConfig())
        self.shards = ShardCache(data_dir)
        self._manifests: Dict[str, List[Utterance]] = {}
        for s in splits:
            path = os.path.join(data_dir, f"{s}_manifest.jsonl")
            if os.path.exists(path):
                self._manifests[s] = read_manifest(path)
        self._cmvn = None
        cmvn_path = os.path.join(data_dir, "cmvn_stats.npz")
        if os.path.exists(cmvn_path):
            with np.load(cmvn_path) as stats:
                self._cmvn = tuple(torch.as_tensor(np.asarray(stats[k], np.float32),
                                                   device=self.device)
                                   for k in ("mean", "std"))
        fe = self.frontend
        # sample-count ceiling implied by the static frame budget
        self._max_samples = fe.frame_len + (self.cfg.max_frames - 1) * fe.frame_shift

    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size

    def special_ids(self) -> Dict[str, int]:
        return self.tokenizer.specials.as_dict()

    def num_utts(self, split: str) -> int:
        return len(self._manifests[split])

    def splits(self) -> Tuple[str, ...]:
        return tuple(self._manifests)

    def _pad_samples_for(self, max_len: int) -> int:
        """A bucket's longest sample count rounded up to a frame boundary,
        so the frontend sees one static waveform length per bucket."""
        fe = self.frontend
        n = min(int(max_len), self._max_samples)
        n = max(n, fe.frame_len)
        return fe.frame_len + (
            (n - fe.frame_len + fe.frame_shift - 1) // fe.frame_shift) * fe.frame_shift

    def _token_ids(self, u: Utterance) -> List[int]:
        """The manifest's ids, or the tokenizer's for a row without them."""
        return (u.tokens or self.tokenizer.encode(u.text))[: self.cfg.max_tokens]

    def _batch_indices(self, lengths: np.ndarray, B: int, train_like: bool, epoch: int):
        """(bucket index, utterance indices) of each batch."""
        n_buckets = max(1, min(self.cfg.num_buckets, len(lengths) // max(B, 1)))
        bounds = bucket_boundaries(lengths, n_buckets)
        rng = np.random.default_rng((self.seed, epoch)) if train_like else None
        for idx in bucketed_batches(lengths, bounds, B, rng, drop_last=train_like):
            bucket = int(np.minimum(np.searchsorted(bounds, lengths[idx]).max(),
                                    len(bounds) - 1))
            yield bounds, bucket, idx

    def wav_batches(
        self,
        split: str,
        epoch: int = 0,
        batch_size: Optional[int] = None,
        shuffle: Optional[bool] = None,
    ) -> Iterator[Dict]:
        """Raw-waveform batches on the host (numpy): {wavs [B, N], wav_lens,
        tokens [B, U], token_lens, utt_ids}, N static per bucket. Shuffled
        and `drop_last` for `train` (or with `shuffle`)."""
        utts = self._manifests[split]
        B = batch_size or self.cfg.batch_size
        U = self.cfg.max_tokens
        lengths = np.asarray([min(u.num_samples, self._max_samples) for u in utts])
        train_like = shuffle if shuffle is not None else (split == "train")
        for bounds, bucket, idx in self._batch_indices(lengths, B, train_like, epoch):
            N = self._pad_samples_for(bounds[bucket])
            n = len(idx)
            wavs = np.zeros((n, N), np.float32)
            wav_lens = np.zeros((n,), np.int32)
            tokens = np.zeros((n, U), np.int32)
            token_lens = np.zeros((n,), np.int32)
            utt_ids = []
            for i, j in enumerate(idx):
                u = utts[int(j)]
                w = self.shards.wav(u)[:N]
                wavs[i, : len(w)] = w
                wav_lens[i] = len(w)
                ids = self._token_ids(u)
                tokens[i, : len(ids)] = ids
                token_lens[i] = len(ids)
                utt_ids.append(u.utt_id)
            yield {"wavs": wavs, "wav_lens": wav_lens, "tokens": tokens,
                   "token_lens": token_lens, "utt_ids": utt_ids}

    def _augment(self, feats: torch.Tensor, feat_lens: np.ndarray,
                 rng: np.random.Generator) -> torch.Tensor:
        """SpecAugment of a batch on its device, starts drawn from `rng`."""
        fcfg = self.frontend.cfg
        starts = draw_starts(rng, feat_lens, feats.shape[-1], fcfg)
        return spec_augment_from_config(
            feats, torch.from_numpy(np.asarray(feat_lens)).to(feats.device),
            torch.from_numpy(starts).to(feats.device), fcfg)

    def featurized_batches(
        self,
        split: str,
        epoch: int = 0,
        augment: bool = False,
        batch_size: Optional[int] = None,
    ) -> Iterator[Dict]:
        """Batches with the training contract: feats [B, T, F] and feat_lens
        [B] int32 on the device, tokens [B, U] and token_lens [B] int32 on
        the host. With `augment`, SpecAugment (if the frontend config enables
        it) and dither (if its amplitude is > 0) from per-batch draws.

        If the manifest carries a feature cache for every row, batches come
        from it (float16, see `_cached_feature_batches`) and the frontend
        never runs; ONEBIT_NO_FEATURE_CACHE=1 forces the frontend."""
        utts = self._manifests[split]
        if utts and all(u.feat_shard for u in utts) and not os.environ.get(
                "ONEBIT_NO_FEATURE_CACHE"):
            yield from self._cached_feature_batches(split, epoch, augment, batch_size)
            return
        fe = self.frontend
        for i, wb in enumerate(self.wav_batches(split, epoch, batch_size=batch_size)):
            rng = np.random.default_rng((self.seed, epoch, i)) if augment else None
            generator = None
            if rng is not None and fe.cfg.dither > 0.0:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(int(rng.integers(2 ** 63)))
            feats, feat_lens = fe(torch.from_numpy(wb["wavs"]).to(self.device),
                                  torch.from_numpy(wb["wav_lens"]).to(self.device),
                                  generator=generator)
            if self._cmvn is not None:
                feats = apply_cmvn(feats, *self._cmvn)
            if augment and fe.cfg.spec_augment:
                host_lens = np.minimum(fe.frames_for_samples(torch.from_numpy(
                    wb["wav_lens"])).numpy(), feats.shape[1])
                feats = self._augment(feats, host_lens, rng)
            yield {"feats": feats, "feat_lens": feat_lens, "tokens": wb["tokens"],
                   "token_lens": wb["token_lens"]}

    def _cached_feature_batches(
        self,
        split: str,
        epoch: int = 0,
        augment: bool = False,
        batch_size: Optional[int] = None,
    ) -> Iterator[Dict]:
        """Batches from the prepare-time feature cache (CMVN baked in):
        bucketed by FRAME length, [B, T_bucket, F] float16 assembled on the
        host, shipped to the device as float16 (exact, half the bytes) and
        upcast there by the consumer (train/step.py::batch_to_device).
        SpecAugment still runs per batch on the device."""
        utts = self._manifests[split]
        B = batch_size or self.cfg.batch_size
        U = self.cfg.max_tokens
        F = self.frontend.cfg.num_mel_bins
        lengths = np.asarray([min(u.num_frames, self.cfg.max_frames) for u in utts])
        feat_dtype = np.float32 if os.environ.get("ONEBIT_F32_FEATS") else np.float16
        for i, (bounds, bucket, idx) in enumerate(
                self._batch_indices(lengths, B, split == "train", epoch)):
            T = int(bounds[bucket])
            n = len(idx)
            feats = np.zeros((n, T, F), feat_dtype)
            feat_lens = np.zeros((n,), np.int32)
            tokens = np.zeros((n, U), np.int32)
            token_lens = np.zeros((n,), np.int32)
            for r, j in enumerate(idx):
                u = utts[int(j)]
                f = self.shards.feats(u)[:T]
                feats[r, : len(f)] = f
                feat_lens[r] = len(f)
                ids = self._token_ids(u)
                tokens[r, : len(ids)] = ids
                token_lens[r] = len(ids)
            dev_feats = torch.from_numpy(feats).to(self.device)
            if augment and self.frontend.cfg.spec_augment:
                dev_feats = self._augment(dev_feats, feat_lens,
                                          np.random.default_rng((self.seed, epoch, i)))
            yield {"feats": dev_feats, "feat_lens": torch.from_numpy(feat_lens).to(self.device),
                   "tokens": tokens, "token_lens": token_lens}

    def close(self) -> None:
        self.shards.close()

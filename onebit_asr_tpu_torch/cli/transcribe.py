"""`python -m onebit_asr_tpu_torch.transcribe` — weights + audio in, text out.

Counterpart of onebit_asr_tpu/cli/transcribe.py for packed-ternary serving:
featurize (log-mel + CMVN) -> export the weights to 2-bit planar form at
`--precision` -> packed encoder + CTC head on the CUDA kernels -> greedy CTC
-> `utt_id\\ttext` lines.

The JAX package writes Orbax checkpoints, which this package does not read.
Its inputs are instead the run's `config.json` (`--config`) and an .npz of
the flattened parameter tree with "/"-joined keys (`--params`); README.md
shows how to write one from a JAX run. With `--data_dir` holding the run's
`tokenizer.json` (and the `tokenizers` package installed) lines carry text;
otherwise they carry the model-side ids, space-separated. `cmvn_stats.npz`
in `--data_dir` supplies CMVN. A config with `fused_subsampler` runs the
fused subsampler kernel; one with `fused_attention` is refused (that kernel
is not ported yet) unless `--no_fused_kernels` clears both flags.

`Transcriber` is the same path for waveforms already in memory.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from onebit_asr_tpu_torch.convert import load_npz, packed_model_from_jax
from onebit_asr_tpu_torch.decode.greedy import greedy_ctc_decode
from onebit_asr_tpu_torch.model.asr import precision_to_binary_mask
from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, apply_cmvn, resample_linear
from onebit_asr_tpu_torch.utils.config import TrainConfig, train_config_from_json


def build_argparser():
    import argparse

    p = argparse.ArgumentParser(
        "python -m onebit_asr_tpu_torch.transcribe", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--params", required=True,
                   help=".npz of the JAX run's parameter tree, '/'-joined keys")
    p.add_argument("--config", required=True, help="the JAX run's config.json")
    p.add_argument("--wav_dir", required=True,
                   help="directory tree of 16-bit PCM .wav files")
    p.add_argument("--data_dir", default="",
                   help="dir with the run's tokenizer.json and cmvn_stats.npz")
    p.add_argument("--precision", type=int, default=2, choices=(1, 2),
                   help="weight precision of the packed encoder")
    p.add_argument("--int8_act", action="store_true",
                   help="per-row int8 activations (the W2A8 kernel)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_batches", type=int, default=0, help="0 = all")
    p.add_argument("--out", default="", help="output file (default stdout)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--no_fused_kernels", action="store_true",
                   help="serve with the unfused subsampler and plain attention "
                        "(clears fused_attention and fused_subsampler)")
    return p


def _read_wav(path: str) -> np.ndarray:
    """16-bit PCM wav -> float32 mono at 16 kHz (standard library reader)."""
    import wave

    with wave.open(path, "rb") as w:
        sr, n, ch, width = w.getframerate(), w.getnframes(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(n)
    if width != 2:
        raise ValueError(f"{path}: only 16-bit PCM wav supported, got width {width}")
    wav = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if ch > 1:
        wav = wav.reshape(-1, ch).mean(axis=1)
    return resample_linear(wav, sr, 16000)


def _iter_wavs(wav_dir: str, max_samples: Optional[int] = None):
    """(utt_id, waveform) for every .wav under `wav_dir`, sorted by path."""
    paths = [
        os.path.join(root, f)
        for root, _, files in os.walk(wav_dir)
        for f in files if f.endswith(".wav")
    ]
    if not paths:
        raise FileNotFoundError(f"no .wav files under {wav_dir}")
    for path in sorted(paths):
        wav = _read_wav(path)
        if max_samples is not None:
            wav = wav[:max_samples]
        yield os.path.splitext(os.path.relpath(path, wav_dir))[0], wav


def _wav_dir_batches(wav_dir: str, batch_size: int, max_samples: int):
    """Length-sorted batches {wavs, wav_lens, utt_ids} from a directory."""
    items = sorted(_iter_wavs(wav_dir, max_samples), key=lambda kv: len(kv[1]))
    for i in range(0, len(items), batch_size):
        chunk = items[i : i + batch_size]
        wavs = np.zeros((len(chunk), max(len(w) for _, w in chunk)), np.float32)
        lens = np.zeros((len(chunk),), np.int32)
        for j, (_, w) in enumerate(chunk):
            wavs[j, : len(w)] = w
            lens[j] = len(w)
        yield {"wavs": wavs, "wav_lens": lens, "utt_ids": [u for u, _ in chunk]}


class Transcriber:
    """Packed-ternary offline transcription of in-memory waveforms.

    t = Transcriber(cfg, params); ids, lens = t.transcribe(wavs, wav_lens)

    `params` is the JAX run's training-form parameter tree (nested dicts of
    numpy arrays); `cmvn` is (mean, std) per mel bin or None. The model
    follows `cfg.model` (with `fused_subsampler` the fused subsampler
    kernel; `fused_attention` is refused). Runs on CUDA unless
    `device="cpu"`."""

    def __init__(self, cfg: TrainConfig, params: Mapping, precision: int = 2,
                 int8_act: bool = False, cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 device: str = "cuda"):
        self.device = torch.device(device)
        self.cfg = cfg
        self.model = packed_model_from_jax(
            cfg.model, params, precision, int8_act, self.device
        )
        self.frontend = LogMelFrontend(cfg.frontend)
        self.cmvn = None
        if cmvn is not None:
            self.cmvn = tuple(
                torch.as_tensor(np.asarray(a, np.float32), device=self.device) for a in cmvn
            )
        self.binary_mask = precision_to_binary_mask(precision, cfg.model.enc_layers).to(self.device)
        self.blank_id = cfg.model.specials.blank_id

    @property
    def max_samples(self) -> int:
        """Samples in the longest utterance the run was trained on."""
        fe = self.frontend
        return fe.frame_len + (self.cfg.data.max_frames - 1) * fe.frame_shift

    @torch.inference_mode()
    def log_probs(self, wavs, wav_lens) -> Tuple[torch.Tensor, torch.Tensor]:
        """wavs [B, N] f32, wav_lens [B] -> (CTC log-probs [B, T', V] f32,
        valid frames [B]); frames past a length are padding."""
        wavs = torch.as_tensor(np.asarray(wavs, np.float32), device=self.device)
        wav_lens = torch.as_tensor(np.asarray(wav_lens), device=self.device)
        feats, feat_lens = self.frontend(wavs, wav_lens)
        if self.cmvn is not None:
            feats = apply_cmvn(feats, *self.cmvn)
        _, enc_mask, logits = self.model(feats, feat_lens, self.binary_mask)
        return torch.log_softmax(logits.to(torch.float32), dim=-1), enc_mask.sum(dim=-1)

    @torch.inference_mode()
    def transcribe(self, wavs, wav_lens) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy CTC ids [B, T'] (padded with -1) and lengths [B], on the host."""
        lp, lens = self.log_probs(wavs, wav_lens)
        ids, n = greedy_ctc_decode(lp, lens, self.blank_id)
        return ids.cpu().numpy(), n.cpu().numpy()


def _load_tokenizer(data_dir: str, specials):
    """The run's tokenizer, or None (then lines carry ids)."""
    if not data_dir:
        return None
    try:
        from onebit_asr_tpu_torch.data.text import AsrTokenizer

        return AsrTokenizer.find_and_load(data_dir, specials)
    except (FileNotFoundError, ImportError) as e:
        print(f"warning: writing ids, not text ({e})", file=sys.stderr)
        return None


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    with open(args.config) as f:
        cfg = train_config_from_json(f.read())
    if args.no_fused_kernels:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, fused_attention=False, fused_subsampler=False))
    cmvn = None
    cmvn_path = os.path.join(args.data_dir, "cmvn_stats.npz")
    if args.data_dir and os.path.exists(cmvn_path):
        with np.load(cmvn_path) as stats:
            cmvn = (stats["mean"], stats["std"])
    else:
        print("warning: no cmvn_stats.npz in --data_dir; features will "
              "mismatch training", file=sys.stderr)
    tokenizer = _load_tokenizer(args.data_dir, cfg.model.specials)
    t = Transcriber(cfg, load_npz(args.params), args.precision, args.int8_act,
                    cmvn, args.device)

    out_f = open(args.out, "w") if args.out else sys.stdout
    n_done = 0
    try:
        for i, wb in enumerate(_wav_dir_batches(args.wav_dir, args.batch_size, t.max_samples)):
            if args.max_batches and i >= args.max_batches:
                break
            ids, lens = t.transcribe(wb["wavs"], wb["wav_lens"])
            for b, uid in enumerate(wb["utt_ids"]):
                seq = ids[b, : int(lens[b])]
                text = (tokenizer.ids_to_text(seq) if tokenizer is not None
                        else " ".join(str(int(x)) for x in seq))
                out_f.write(f"{uid}\t{text}\n")
                n_done += 1
        print(f"transcribed {n_done} utterances", file=sys.stderr)
    finally:
        if args.out:
            out_f.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""`python -m onebit_asr_tpu_torch.transcribe` — a trained run + audio in, text out.

Counterpart of onebit_asr_tpu/cli/transcribe.py, with its flags: featurize
(log-mel + CMVN) -> the encoder + CTC head at `--precision` -> greedy CTC,
or the prefix beam on the device (`--beam_size`) with optional n-gram LM
shallow fusion (`--lm`, `--lm_weight`, `--length_bonus`) -> `utt_id\ttext`
lines.

The run is either `--checkpoint <run_dir>`, a run this package trained
(`config.json` and the newest `ckpt/step_<n>.pt`, whose parameters alone
are read), or `--params` + `--config`: an .npz of a JAX run's flattened
parameter tree with "/"-joined keys and its config.json (README.md shows
how to write one; the JAX package's Orbax checkpoints are not read here).
Exactly one of the two is given.

Without `--packed` the run is served unpacked, as JAX does by default: the
QAT model in eval mode, no dropout, at precision 32, 2 or 1. `--packed`
serves planar-packed 2-bit weights through the packed-ternary kernels, at
precision 2 or 1, and `--int8_act` (which needs `--packed`) through the
W2A8 kernel. A config with `fused_subsampler` runs the fused subsampler
kernel, one with `fused_attention` the fused rel-pos attention kernel, in
either form; `--no_fused_kernels` clears both flags. A run of any model
option is served as it trained (a chunked-attention encoder offline with
its chunk mask over the whole utterance, as JAX's offline path does); a
per-channel run (quant_per_channel) serves unpacked only: under `--packed`
the packed export raises NotImplementedError, as JAX's does. `--longform` serves
recordings of any length through overlapped windows (`--chunk_seconds`,
`--overlap_seconds`) and stitched CTC, greedy only.

Input is `--wav_dir`, a tree of 16-bit PCM .wav files, or else the
`--split` manifest (default `test`) of `--data_dir`, read through
`LibriSpeechDataModule.wav_batches` unshuffled: the lines then carry the
manifest's `utt_id`s in the data module's order. `--data_dir` (default: the
run's training data dir) also supplies `cmvn_stats.npz` and the tokenizer
(`tokenizer.json` or `tokenizer.model`). A `--checkpoint` run without a
tokenizer exits 2, as the JAX CLI does; with `--params` + `--config`, which
JAX does not have, the lines then carry the model-side ids, space-separated,
after a warning (a `--split` needs the tokenizer there too).

`Transcriber` is the same path for waveforms already in memory.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from onebit_asr_tpu_torch.convert import (
    jax_tree_from_state_dict,
    load_npz,
    packed_model_from_jax,
    qat_model_from_jax,
)
from onebit_asr_tpu_torch.decode.beam_device import beam_search_device
from onebit_asr_tpu_torch.decode.greedy import greedy_ctc_decode
from onebit_asr_tpu_torch.decode.longform import longform_logits
from onebit_asr_tpu_torch.model.asr import precision_to_binary_mask
from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, apply_cmvn, resample_linear
from onebit_asr_tpu_torch.utils.checkpoint import load_config, restore_params
from onebit_asr_tpu_torch.utils.config import TrainConfig, train_config_from_json


def build_argparser():
    import argparse

    p = argparse.ArgumentParser(
        "python -m onebit_asr_tpu_torch.transcribe", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--checkpoint", default="",
                   help="run dir written by onebit_asr_tpu_torch.train (config.json + ckpt/)")
    p.add_argument("--params", default="",
                   help=".npz of a JAX run's parameter tree, '/'-joined keys (with --config)")
    p.add_argument("--config", default="", help="the JAX run's config.json (with --params)")
    p.add_argument("--wav_dir", default="",
                   help="directory tree of 16-bit PCM .wav files (overrides manifest input)")
    p.add_argument("--data_dir", default="",
                   help="prepared data dir: the tokenizer and cmvn_stats.npz, and (without "
                        "--wav_dir) the manifest to transcribe; default: the checkpoint's "
                        "training data dir")
    p.add_argument("--split", default="test", help="manifest split to transcribe (data-dir mode)")
    p.add_argument("--precision", type=int, default=2, choices=(32, 2, 1),
                   help="weight precision of the encoder")
    p.add_argument("--packed", action="store_true",
                   help="serve from planar-packed 2-bit weights (precision 1 or 2)")
    p.add_argument("--int8_act", action="store_true",
                   help="with --packed: per-row int8 activations (the W2A8 kernel)")
    p.add_argument("--beam_size", type=int, default=0,
                   help="prefix beam width; 0 = greedy (default)")
    p.add_argument("--lm", default="",
                   help="n-gram LM .npz for shallow fusion (beam mode only)")
    p.add_argument("--lm_weight", type=float, default=0.3)
    p.add_argument("--length_bonus", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_batches", type=int, default=0, help="0 = all")
    p.add_argument("--longform", action="store_true",
                   help="recordings of any length via overlapped fixed windows + stitched "
                        "CTC (greedy; bypasses the max_frames cap)")
    p.add_argument("--chunk_seconds", type=float, default=30.0, help="longform window length")
    p.add_argument("--overlap_seconds", type=float, default=4.0,
                   help="longform window overlap (margins discarded)")
    p.add_argument("--out", default="", help="output file (default stdout)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--no_fused_kernels", action="store_true",
                   help="serve without the fused subsampler and attention kernels, "
                        "through the unfused convs and attention chain "
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
    """Offline transcription of in-memory waveforms.

    t = Transcriber(cfg, params); ids, lens = t.transcribe(wavs, wav_lens)

    `params` is a training-form parameter tree in the JAX layout (nested
    dicts of numpy arrays or CPU tensors: a JAX run's, or
    `convert.jax_tree_from_state_dict` of a run this package trained);
    `cmvn` is (mean, std) per mel bin or None. `packed` serves planar-packed
    weights at precision 2 or 1 (with `int8_act` the W2A8 kernel); else the
    QAT model in eval mode serves at precision 32, 2 or 1. The model follows
    `cfg.model` (with `fused_subsampler` the fused subsampler kernel, with
    `fused_attention` the fused attention kernel). `beam_size` > 0 decodes
    with the device beam, `lm` (a DeviceLM) fused at `lm_weight`; 0 greedily.
    Runs on CUDA unless `device="cpu"`."""

    def __init__(self, cfg: TrainConfig, params: Mapping, precision: int = 2,
                 int8_act: bool = False, cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 device: str = "cuda", packed: bool = True, beam_size: int = 0, lm=None,
                 lm_weight: float = 0.0, length_bonus: float = 0.0):
        self.device = torch.device(device)
        self.cfg = cfg
        if packed:
            self.model = packed_model_from_jax(cfg.model, params, precision, int8_act, self.device)
        elif int8_act:
            raise ValueError("int8_act needs the packed weights (packed=True)")
        else:
            self.model = qat_model_from_jax(cfg.model, params, self.device, decoder=False)
            self.model.requires_grad_(False).eval()
        self.frontend = LogMelFrontend(cfg.frontend)
        self.cmvn = None
        if cmvn is not None:
            self.cmvn = tuple(
                torch.as_tensor(np.asarray(a, np.float32), device=self.device) for a in cmvn
            )
        mask = precision_to_binary_mask(precision, cfg.model.enc_layers)
        self.binary_mask = None if mask is None else mask.to(self.device)
        self.blank_id = cfg.model.specials.blank_id
        self.beam_size = beam_size
        self.lm = lm
        self.lm_weight = lm_weight
        self.length_bonus = length_bonus

    @property
    def max_samples(self) -> int:
        """Samples in the longest utterance the run was trained on."""
        fe = self.frontend
        return fe.frame_len + (self.cfg.data.max_frames - 1) * fe.frame_shift

    @torch.inference_mode()
    def featurize(self, wavs, wav_lens) -> Tuple[torch.Tensor, torch.Tensor]:
        """wavs [B, N] f32, wav_lens [B] -> (features [B, T, F], lengths [B])
        on the device, CMVN applied."""
        wavs = torch.as_tensor(np.asarray(wavs, np.float32), device=self.device)
        wav_lens = torch.as_tensor(np.asarray(wav_lens), device=self.device)
        feats, feat_lens = self.frontend(wavs, wav_lens)
        if self.cmvn is not None:
            feats = apply_cmvn(feats, *self.cmvn)
        return feats, feat_lens

    @torch.inference_mode()
    def log_probs(self, wavs, wav_lens) -> Tuple[torch.Tensor, torch.Tensor]:
        """wavs [B, N] f32, wav_lens [B] -> (CTC log-probs [B, T', V] f32,
        valid frames [B]); frames past a length are padding."""
        feats, feat_lens = self.featurize(wavs, wav_lens)
        _, enc_mask, logits = self.model(feats, feat_lens, self.binary_mask)
        return torch.log_softmax(logits.to(torch.float32), dim=-1), enc_mask.sum(dim=-1)

    @torch.inference_mode()
    def decode(self, lp: torch.Tensor, lens: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """CTC ids [B, *] (padded with -1) and lengths [B] on the host:
        greedy, or the device beam with `beam_size` > 0."""
        if self.beam_size:
            fuse = self.lm is not None
            ids, n = beam_search_device(
                lp, lens, blank_id=self.blank_id, beam_size=self.beam_size,
                lm=self.lm, lm_weight=self.lm_weight if fuse else 0.0,
                length_bonus=self.length_bonus)
        else:
            ids, n = greedy_ctc_decode(lp, lens, self.blank_id)
        return ids.cpu().numpy(), n.cpu().numpy()

    def transcribe(self, wavs, wav_lens) -> Tuple[np.ndarray, np.ndarray]:
        """CTC ids [B, *] (padded with -1) and lengths [B], on the host."""
        return self.decode(*self.log_probs(wavs, wav_lens))

    def longform_frames(self, chunk_seconds: float, overlap_seconds: float) -> Tuple[int, int]:
        """(window, overlap) in feature frames."""
        shift, sr = self.frontend.frame_shift, self.cfg.frontend.sample_rate
        return (max(1, int(chunk_seconds * sr) // shift),
                max(0, int(overlap_seconds * sr) // shift))

    @torch.inference_mode()
    def longform_log_probs(self, wav: np.ndarray, chunk_frames: int,
                           overlap_frames: int) -> torch.Tensor:
        """Stitched CTC log-probs [T', V] f32 of one recording of any length.
        The waveform is padded to a whole number of windows' samples before
        featurizing (the features of the real samples do not change)."""
        fe = self.frontend
        chunk_samples = fe.frame_len + (chunk_frames - 1) * fe.frame_shift
        n = len(wav)
        padded = np.zeros((1, chunk_samples * max(1, -(-n // chunk_samples))), np.float32)
        padded[0, :n] = wav
        feats, feat_lens = self.featurize(padded, np.asarray([n], np.int32))
        fv = feats[0, : int(feat_lens[0])].cpu().numpy()
        logits = longform_logits(self.model, fv, self.binary_mask, chunk_frames,
                                 overlap_frames, self.device)
        return torch.log_softmax(logits.to(torch.float32), dim=-1)

    def longform(self, wav: np.ndarray, chunk_frames: int, overlap_frames: int) -> np.ndarray:
        """Greedy CTC ids of one recording of any length."""
        lp = self.longform_log_probs(wav, chunk_frames, overlap_frames)
        ids, n = greedy_ctc_decode(lp[None], torch.tensor([lp.shape[0]], device=lp.device),
                                   self.blank_id)
        return ids[0, : int(n[0])].cpu().numpy()


def _load_tokenizer(data_dir: str, specials):
    """(the run's tokenizer, "") or (None, why there is none)."""
    if not data_dir:
        return None, "no --data_dir"
    try:
        from onebit_asr_tpu_torch.data.text import AsrTokenizer

        return AsrTokenizer.find_and_load(data_dir, specials), ""
    except (FileNotFoundError, ImportError) as e:
        return None, str(e)


def load_run(args, parser) -> Tuple[TrainConfig, Mapping]:
    """(config, JAX-layout parameter tree) of `--checkpoint` or of
    `--params` + `--config`; exactly one of the two (else the parser exits
    2)."""
    if bool(args.checkpoint) == bool(args.params or args.config):
        parser.error("give exactly one of --checkpoint or --params with --config")
    if args.checkpoint:
        cfg = load_config(args.checkpoint)
        if cfg is None:
            parser.error(f"no config.json in {args.checkpoint}")
        step, sd = restore_params(os.path.join(args.checkpoint, "ckpt"))
        print(f"restored step {step} from {args.checkpoint}", file=sys.stderr)
        # the run's own config: its fused_subsampler sets the projection's rows
        return cfg, jax_tree_from_state_dict(sd, cfg.model)
    if not (args.params and args.config):
        parser.error("--params and --config go together")
    with open(args.config) as f:
        return train_config_from_json(f.read()), load_npz(args.params)


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.packed and args.precision not in (1, 2):
        print("--packed requires --precision 1 or 2", file=sys.stderr)
        return 2
    if args.int8_act and not args.packed:
        print("--int8_act requires --packed (it selects the packed-path matmul kernel)",
              file=sys.stderr)
        return 2
    if args.longform and (args.beam_size or args.lm):
        print("--longform is greedy-only (stitched CTC)", file=sys.stderr)
        return 2
    if args.lm and not args.beam_size:
        print("--lm needs --beam_size > 0 (shallow fusion is a beam-prefix extension); "
              "drop --lm or set --beam_size", file=sys.stderr)
        return 2
    if args.longform and not args.wav_dir:
        print("--longform needs --wav_dir (manifest utterances are already capped at ingest)",
              file=sys.stderr)
        return 2
    cfg, params = load_run(args, parser)
    if args.no_fused_kernels:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, fused_attention=False, fused_subsampler=False))
    data_dir = args.data_dir or (cfg.data.data_dir if args.checkpoint else "")
    tokenizer, why = _load_tokenizer(data_dir, cfg.model.specials)
    if tokenizer is None and (args.checkpoint or not args.wav_dir):
        print(f"no tokenizer artifact in {data_dir} — pass --data_dir pointing at the dir "
              "the checkpoint was trained against", file=sys.stderr)
        return 2
    if tokenizer is None:
        print(f"warning: writing ids, not text ({why})", file=sys.stderr)
    cmvn = None
    cmvn_path = os.path.join(data_dir, "cmvn_stats.npz")
    if data_dir and os.path.exists(cmvn_path):
        with np.load(cmvn_path) as stats:
            cmvn = (stats["mean"], stats["std"])
    else:
        print(f"warning: no cmvn_stats.npz in {data_dir!r}; features will "
              "mismatch training", file=sys.stderr)
    dm = None
    if not args.wav_dir:
        from onebit_asr_tpu_torch.data.librispeech import LibriSpeechDataModule
        from onebit_asr_tpu_torch.utils.config import DataConfig

        dm = LibriSpeechDataModule(data_dir, tokenizer,
                                   DataConfig(data_dir=data_dir, batch_size=args.batch_size),
                                   splits=(args.split,), frontend_cfg=cfg.frontend,
                                   device=args.device)
        if args.split not in dm.splits():
            print(f"split {args.split!r} has no manifest in {data_dir}", file=sys.stderr)
            return 2
    lm = None
    if args.lm:
        from onebit_asr_tpu_torch.decode.lm import NGramLM
        from onebit_asr_tpu_torch.decode.lm_device import DeviceLM

        lm = DeviceLM.pack(NGramLM.load(args.lm), args.device)
    t = Transcriber(cfg, params, args.precision, args.int8_act, cmvn, args.device,
                    packed=args.packed, beam_size=args.beam_size, lm=lm,
                    lm_weight=args.lm_weight, length_bonus=args.length_bonus)
    batches = (dm.wav_batches(args.split, shuffle=False, batch_size=args.batch_size)
               if dm is not None
               else _wav_dir_batches(args.wav_dir, args.batch_size, t.max_samples))

    def text(seq):
        return (tokenizer.ids_to_text(seq) if tokenizer is not None
                else " ".join(str(int(x)) for x in seq))

    out_f = open(args.out, "w") if args.out else sys.stdout
    n_done = 0
    try:
        if args.longform:
            chunk, overlap = t.longform_frames(args.chunk_seconds, args.overlap_seconds)
            for uid, wav in _iter_wavs(args.wav_dir):
                out_f.write(f"{uid}\t{text(t.longform(wav, chunk, overlap))}\n")
                n_done += 1
                if args.max_batches and n_done >= args.max_batches:
                    break
            print(f"transcribed {n_done} recordings (longform)", file=sys.stderr)
            return 0
        for i, wb in enumerate(batches):
            if args.max_batches and i >= args.max_batches:
                break
            ids, lens = t.transcribe(wb["wavs"], wb["wav_lens"])
            for b, uid in enumerate(wb["utt_ids"]):
                out_f.write(f"{uid}\t{text(ids[b, : int(lens[b])])}\n")
                n_done += 1
        print(f"transcribed {n_done} utterances", file=sys.stderr)
    finally:
        if args.out:
            out_f.close()
        if dm is not None:
            dm.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

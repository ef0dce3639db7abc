"""`python -m onebit_asr_tpu_torch.prepare <command>` — make a data dir.

Counterpart of onebit_asr_tpu/cli/prepare.py, with its commands, flags and
defaults, plus `--device` (default cuda), where `cmvn` and `features` run
the frontend. The data dir it writes is the one `train --data_dir`,
`eval --data_dir` and `transcribe --split` read, in the JAX package's
layout, so either package reads the other's.

Commands:
  ingest      npz waveform shards + JSONL manifests with cached lengths, from
              a tree of 16-bit PCM .wav files and LibriSpeech *.trans.txt
              transcripts (`--wav_dir`, split by `--dev_fraction`), from a
              seeded synthetic corpus (`--synthetic N`: a learnable corpus of
              16 two-tone words; `--noise_only` pure noise; `--hard` 64
              confusable words, speaker jitter, noise and bigram text), or
              from HF-datasets dirs under `--in_dir` (needs `datasets`).
  tokenizer   a BPE of `--vocab_size` subwords on the train transcripts
              (needs `tokenizers`) -> tokenizer.json.
  export_spm  tokenizer.json -> a SentencePiece tokenizer.model
              (data/spm.py; `sentencepiece` is not needed).
  tokenize    fill each manifest row's model-side token ids.
  cmvn        per-mel-bin mean and std over the first `--num_utts` train
              utterances, the frontend on the device -> cmvn_stats.npz.
  features    the frontend (+ CMVN) over every split once, on the device:
              one float16 `{split}_feats.npy` per split, and `feat_shard`,
              `feat_index` and `num_frames` stamped into the manifests.
  lm          an n-gram LM of `--lm_order` on the train token ids -> lm.npz.
  all         ingest, tokenizer, tokenize, cmvn and lm (not features or
              export_spm).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np

from onebit_asr_tpu_torch.data.manifest import Utterance, read_manifest, write_manifest
from onebit_asr_tpu_torch.data.text import AsrTokenizer
from onebit_asr_tpu_torch.utils.config import FrontendConfig, SpecialTokens

SHARD_UTTS = 512  # waveforms per npz shard
BATCH = 16  # utterances per frontend call in cmvn and features


def _write_shards(out_dir: str, split: str, items: List[tuple]) -> List[Utterance]:
    """items: [(utt_id, wav f32 np.ndarray, text)] -> npz shards + utterances."""
    utts = []
    for s in range(0, len(items), SHARD_UTTS):
        chunk = items[s : s + SHARD_UTTS]
        shard_name = f"{split}_shard{s // SHARD_UTTS:05d}.npz"
        np.savez(os.path.join(out_dir, shard_name), **{uid: wav for uid, wav, _ in chunk})
        for i, (uid, wav, text) in enumerate(chunk):
            utts.append(Utterance(utt_id=uid, shard=shard_name, index=i,
                                  num_samples=len(wav), text=text, tokens=[]))
    return utts


def _write_split(args, split: str, items: List[tuple]) -> List[Utterance]:
    utts = _write_shards(args.out_dir, split, items)
    write_manifest(os.path.join(args.out_dir, f"{split}_manifest.jsonl"), utts)
    return utts


def _split_sizes(args):
    n_eval = max(8, args.synthetic // 8)
    return (("train", args.synthetic), ("dev", n_eval), ("test", n_eval))


def _ingest_wav_dir(args) -> int:
    """A tree of .wav files + LibriSpeech-style *.trans.txt files (lines
    `<utt_id> <TEXT>`), split by --dev_fraction."""
    from onebit_asr_tpu_torch.cli.transcribe import _read_wav

    trans, wavs = {}, {}
    for root, _, files in os.walk(args.wav_dir):
        for fn in files:
            p = os.path.join(root, fn)
            if fn.endswith(".trans.txt"):
                with open(p) as f:
                    for line in f:
                        uid, _, text = line.strip().partition(" ")
                        if uid:
                            trans[uid] = text
            elif fn.endswith(".wav"):
                wavs[os.path.splitext(fn)[0]] = p
    ids = sorted(set(trans) & set(wavs))
    if not ids:
        print("no (wav, transcript) pairs found", file=sys.stderr)
        return 2
    n_dev = max(1, int(len(ids) * args.dev_fraction))
    for split, split_ids in (("dev", ids[:n_dev]), ("train", ids[n_dev:])):
        utts = _write_split(args, split, [(uid, _read_wav(wavs[uid]), trans[uid])
                                          for uid in split_ids])
        print(f"{split}: {len(utts)} utterances from {args.wav_dir}")
    return 0


def _ingest_hard_synthetic(args) -> int:
    """`--synthetic N --hard`: a corpus whose converged WER stays informative.
    64 words W00..W63 whose tones sit on a `--hard_grid` steps-per-octave
    grid (near-minimal pairs), each utterance's frequencies scaled by
    +-1.5% and each word's length by +-20% (speaker jitter), additive noise
    of sigma `--hard_noise`, and texts from a sparse seeded bigram chain
    (4 likely successors a word at 0.85 of the mass), so an n-gram LM has
    something to recover. Draws from one generator in the JAX order."""
    rng = np.random.default_rng(args.seed)
    n_words = 64
    words = [f"W{i:02d}" for i in range(n_words)]
    sr = 16000
    base_sec = 0.3
    grid = float(args.hard_grid)
    noise_sigma = float(args.hard_noise)
    succ = np.stack([rng.choice(n_words, size=4, replace=False) for _ in range(n_words)])

    def next_word(w: int) -> int:
        if rng.uniform() < 0.85:
            return int(succ[w][rng.integers(0, 4)])
        return int(rng.integers(0, n_words))

    def word_wav(widx: int, f_scale: float, dur_scale: float) -> np.ndarray:
        f1 = 220.0 * (2 ** (widx / grid)) * f_scale
        f2 = 330.0 * (2 ** ((widx % 16) / 12.0)) * f_scale
        n = int(sr * base_sec * dur_scale)
        t = np.arange(n) / sr
        env = np.hanning(n).astype(np.float32)
        sig = 0.35 * np.sin(2 * np.pi * f1 * t) + 0.25 * np.sin(2 * np.pi * f2 * t)
        return (sig * env).astype(np.float32)

    max_words = max(4, int(args.max_seconds / base_sec) - 1)
    for split, n in _split_sizes(args):
        items = []
        for i in range(n):
            n_w = int(rng.integers(4, max_words + 1))
            w = int(rng.integers(0, n_words))
            word_ids = [w]
            for _ in range(n_w - 1):
                w = next_word(w)
                word_ids.append(w)
            text = " ".join(words[k] for k in word_ids)
            f_scale = float(2.0 ** (rng.uniform(-1, 1) / 48.0))
            wav = np.concatenate([word_wav(k, f_scale, float(rng.uniform(0.8, 1.2)))
                                  for k in word_ids])
            wav = wav + rng.standard_normal(len(wav)).astype(np.float32) * noise_sigma
            items.append((f"{split}-{i:06d}", wav, text))
        utts = _write_split(args, split, items)
        print(f"{split}: {len(utts)} HARD synthetic utterances "
              f"(64 confusable words, bigram text)")
    return 0


def _ingest_synthetic(args) -> int:
    """`--synthetic N`: each word of 16 a fixed two-tone signature (~0.3 s)
    plus noise, so transcripts are recoverable from the audio;
    `--noise_only` gives pure noise of 1 to --max_seconds s instead."""
    rng = np.random.default_rng(args.seed)
    words = ["THE", "CAT", "SAT", "ON", "MAT", "DOG", "RAN", "FAST", "HELLO", "WORLD",
             "SPEECH", "MODEL", "SOUND", "VOICE", "DATA", "TRAIN"]
    sr = 16000
    word_sec = 0.3
    t_axis = np.arange(int(sr * word_sec)) / sr
    envelope = np.hanning(len(t_axis)).astype(np.float32)

    def word_wav(widx: int) -> np.ndarray:
        f1 = 220.0 * (2 ** (widx / 8.0))
        f2 = 330.0 * (2 ** ((widx % 7) / 5.0))
        sig = 0.35 * np.sin(2 * np.pi * f1 * t_axis) + 0.25 * np.sin(2 * np.pi * f2 * t_axis)
        return (sig * envelope).astype(np.float32)

    max_words = max(3, int(args.max_seconds / word_sec) - 1)
    for split, n in _split_sizes(args):
        items = []
        for i in range(n):
            n_words = int(rng.integers(3, max_words + 1))
            word_ids = rng.integers(0, len(words), n_words)
            text = " ".join(words[w] for w in word_ids)
            if args.noise_only:
                sec = rng.uniform(1.0, args.max_seconds)
                wav = rng.standard_normal(int(sr * sec)).astype(np.float32) * 0.1
            else:
                wav = np.concatenate([word_wav(int(w)) for w in word_ids])
                wav = wav + rng.standard_normal(len(wav)).astype(np.float32) * 0.02
            items.append((f"{split}-{i:06d}", wav, text))
        utts = _write_split(args, split, items)
        print(f"{split}: {len(utts)} synthetic utterances")
    return 0


def _ingest_hf_datasets(args) -> int:
    """HF-datasets dirs `--in_dir/<source>` (rows with audio {array,
    sampling_rate}, text and optionally id) for the comma-separated sources
    of each split."""
    try:
        from datasets import load_from_disk
    except ImportError:
        print("datasets not available and --synthetic not given", file=sys.stderr)
        return 2
    from onebit_asr_tpu_torch.ops.frontend import resample_linear

    split_map = {"train": args.train_splits.split(","), "dev": args.dev_splits.split(","),
                 "test": args.test_splits.split(",")}
    for split, sources in split_map.items():
        items = []
        for src in sources:
            path = os.path.join(args.in_dir, src)
            if not os.path.isdir(path):
                print(f"skipping missing {path}", file=sys.stderr)
                continue
            for row in load_from_disk(path):
                audio = row["audio"]
                wav = np.asarray(audio["array"], np.float32)
                sr = int(audio.get("sampling_rate", 16000))
                if sr != 16000:
                    wav = resample_linear(wav, sr, 16000)
                items.append((row.get("id", f"{src}-{len(items)}"), wav, row["text"]))
        utts = _write_split(args, split, items)
        print(f"{split}: {len(utts)} utterances from {sources}")
    return 0


def cmd_ingest(args) -> int:
    os.makedirs(args.out_dir, exist_ok=True)
    if args.wav_dir:
        return _ingest_wav_dir(args)
    if args.synthetic and args.hard:
        return _ingest_hard_synthetic(args)
    if args.synthetic:
        return _ingest_synthetic(args)
    return _ingest_hf_datasets(args)


def cmd_tokenizer(args) -> int:
    utts = read_manifest(os.path.join(args.out_dir, "train_manifest.jsonl"))
    try:
        tok = AsrTokenizer.train((u.text for u in utts), vocab_size=args.vocab_size,
                                 specials=SpecialTokens())
    except ImportError:
        print("FATAL: `prepare tokenizer` trains its BPE with the `tokenizers` package, "
              "which is not installed; put a tokenizer.json or a SentencePiece "
              f"tokenizer.model into {args.out_dir} instead", file=sys.stderr)
        return 2
    tok.save(os.path.join(args.out_dir, "tokenizer.json"))
    print(f"tokenizer: {tok.subword_vocab_size} subwords "
          f"(+4 specials = {tok.vocab_size} model vocab)")
    return 0


def cmd_export_spm(args) -> int:
    """tokenizer.json -> tokenizer.model with the same pieces; raw ids shift
    by +3 (SentencePiece reserves ids 0-3, see data/spm.py)."""
    from onebit_asr_tpu_torch.data.spm import export_hf_to_spm

    tok = AsrTokenizer.load(os.path.join(args.out_dir, "tokenizer.json"))
    out = os.path.join(args.out_dir, "tokenizer.model")
    export_hf_to_spm(tok._tok, out)
    print(f"exported SPM model: {tok.subword_vocab_size} pieces + 4 specials -> {out}")
    return 0


def cmd_tokenize(args) -> int:
    tok = AsrTokenizer.find_and_load(args.out_dir)
    for split in ("train", "dev", "test"):
        path = os.path.join(args.out_dir, f"{split}_manifest.jsonl")
        if not os.path.exists(path):
            continue
        utts = read_manifest(path)
        for u in utts:
            u.tokens = tok.encode(u.text)
        write_manifest(path, utts)
        print(f"{split}: tokenized {len(utts)} rows")
    return 0


def _frame_grid(fe, n: int) -> int:
    """n rounded up to the frame grid: frame_len + k * frame_shift."""
    k = -(-(int(n) - fe.frame_len) // fe.frame_shift)
    return fe.frame_len + k * fe.frame_shift


def _padded_batch(shards, utts, pad: int, rows: int):
    wavs = np.zeros((rows, pad), np.float32)
    lens = np.zeros((rows,), np.int32)
    for i, u in enumerate(utts):
        w = shards.wav(u)[:pad]
        wavs[i, : len(w)] = w
        lens[i] = len(w)
    return wavs, lens


def cmd_cmvn(args) -> int:
    """Global CMVN over the first --num_utts train utterances: batches of 16
    padded to one length on the frame grid, the frontend and the f32
    (sum, sum of squares, count) on --device."""
    import torch

    from onebit_asr_tpu_torch.data.manifest import ShardCache
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, accumulate_cmvn, finalize_cmvn

    device = torch.device(args.device)
    utts = read_manifest(os.path.join(args.out_dir, "train_manifest.jsonl"))[: args.num_utts]
    shards = ShardCache(args.out_dir)
    fe = LogMelFrontend(FrontendConfig())
    F = fe.cfg.num_mel_bins
    acc = (torch.zeros(F, device=device), torch.zeros(F, device=device),
           torch.zeros((), device=device))
    pad = _frame_grid(fe, max(u.num_samples for u in utts))
    for s in range(0, len(utts), BATCH):
        wavs, lens = _padded_batch(shards, utts[s : s + BATCH], pad, BATCH)
        feats, flens = fe(torch.from_numpy(wavs).to(device), torch.from_numpy(lens).to(device))
        acc = accumulate_cmvn(feats, flens, acc)
    shards.close()
    mean, std = finalize_cmvn(acc)
    out = os.path.join(args.out_dir, "cmvn_stats.npz")
    np.savez(out, mean=mean.cpu().numpy(), std=std.cpu().numpy())
    print(f"cmvn over {len(utts)} utts -> {out}")
    return 0


def cmd_features(args) -> int:
    """The prepare-time log-mel cache: the frontend (+ CMVN, when
    cmvn_stats.npz exists) over every split once on --device, stored as one
    [sum_T, F] float16 `.npy` per split (memory-mapped at train time), with
    `feat_shard`, `feat_index` and `num_frames` stamped into the manifests.
    Utterances go length-sorted in batches of 16, each padded to its
    quantile bucket's length (at most 8 per split). Rerun it after `cmvn`."""
    import torch

    from onebit_asr_tpu_torch.data.manifest import ShardCache, bucket_boundaries
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, apply_cmvn

    device = torch.device(args.device)
    fe = LogMelFrontend(FrontendConfig())
    F = fe.cfg.num_mel_bins
    cmvn = None
    cmvn_path = os.path.join(args.out_dir, "cmvn_stats.npz")
    if os.path.exists(cmvn_path):
        with np.load(cmvn_path) as stats:
            cmvn = tuple(torch.from_numpy(np.asarray(stats[k], np.float32)).to(device)
                         for k in ("mean", "std"))
    else:
        print("warning: no cmvn_stats.npz — caching un-normalized features")

    def frames_for(n: int, pad: int) -> int:
        n = min(int(n), pad)
        return 0 if n < fe.frame_len else 1 + (n - fe.frame_len) // fe.frame_shift

    done_any = False
    for split in ("train", "dev", "test"):
        mpath = os.path.join(args.out_dir, f"{split}_manifest.jsonl")
        if not os.path.exists(mpath):
            continue
        utts = read_manifest(mpath)
        shards = ShardCache(args.out_dir)
        lens = np.asarray([u.num_samples for u in utts])
        bounds = bucket_boundaries(lens, min(8, max(1, len(utts))))
        pads = [_frame_grid(fe, max(int(b), fe.frame_len)) for b in bounds]

        def bucket_pad(n: int) -> int:
            return pads[int(min(np.searchsorted(bounds, n), len(bounds) - 1))]

        n_frames = [frames_for(u.num_samples, bucket_pad(u.num_samples)) for u in utts]
        total = int(np.sum(n_frames))
        cache_name = f"{split}_feats.npy"
        mm = np.lib.format.open_memmap(os.path.join(args.out_dir, cache_name), mode="w+",
                                       dtype=np.float16, shape=(total, F))
        offsets = np.concatenate([[0], np.cumsum(n_frames)]).astype(np.int64)
        order = np.argsort(lens, kind="stable")
        for s in range(0, len(order), BATCH):
            idx = order[s : s + BATCH]
            wavs, wlens = _padded_batch(shards, [utts[int(j)] for j in idx],
                                        bucket_pad(int(lens[idx].max())), len(idx))
            feats, flens = fe(torch.from_numpy(wavs).to(device),
                              torch.from_numpy(wlens).to(device))
            if cmvn is not None:
                feats = apply_cmvn(feats, *cmvn)
            feats = feats.to(torch.float16).cpu().numpy()
            flens = flens.cpu().numpy()
            for i, j in enumerate(idx):
                u = utts[int(j)]
                T = int(flens[i])
                assert T == n_frames[int(j)], (u.utt_id, T, n_frames[int(j)])
                mm[offsets[int(j)] : offsets[int(j)] + T] = feats[i, :T]
                u.feat_shard = cache_name
                u.feat_index = int(offsets[int(j)])
                u.num_frames = T
        mm.flush()
        del mm
        write_manifest(mpath, utts)
        shards.close()
        print(f"{split}: cached fbank for {len(utts)} utts "
              f"({total} frames -> {cache_name}, f16 memmap)")
        done_any = True
    if not done_any:
        print(f"no manifests in {args.out_dir} — run `prepare ingest` first")
        return 2
    return 0


def cmd_lm(args) -> int:
    """The shallow-fusion n-gram LM (decode/lm.py) on the train token ids."""
    from onebit_asr_tpu_torch.decode.lm import NGramLM

    utts = read_manifest(os.path.join(args.out_dir, "train_manifest.jsonl"))
    seqs = [u.tokens for u in utts if u.tokens]
    if not seqs:
        print("train manifest has no token ids — run `prepare tokenize` first")
        return 2
    lm = NGramLM(order=args.lm_order).fit(seqs)
    out = os.path.join(args.out_dir, "lm.npz")
    lm.save(out)
    n = sum(len(c) for c in lm.counts)
    print(f"lm: order {args.lm_order}, {lm.total} tokens, {n} n-grams -> {out}")
    return 0


COMMANDS = {"ingest": cmd_ingest, "tokenizer": cmd_tokenizer, "tokenize": cmd_tokenize,
            "cmvn": cmd_cmvn, "lm": cmd_lm, "features": cmd_features,
            "export_spm": cmd_export_spm}
ALL = (cmd_ingest, cmd_tokenizer, cmd_tokenize, cmd_cmvn, cmd_lm)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m onebit_asr_tpu_torch.prepare",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=["ingest", "tokenizer", "tokenize", "cmvn", "lm",
                                       "features", "export_spm", "all"])
    p.add_argument("--out_dir", type=str, default="data")
    p.add_argument("--in_dir", type=str, default="data")
    p.add_argument("--train_splits", type=str,
                   default="train.clean.100_subset,train.clean.360_subset,train.other.500_subset")
    p.add_argument("--dev_splits", type=str,
                   default="validation.clean_subset,validation.other_subset")
    p.add_argument("--test_splits", type=str, default="test.clean_subset,test.other_subset")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic train utterances instead of ingesting")
    p.add_argument("--noise_only", action="store_true",
                   help="synthetic audio as pure noise (shape testing)")
    p.add_argument("--hard_grid", type=float, default=16.0,
                   help="with --hard: word-tone grid in steps/octave "
                        "(higher = closer near-minimal pairs = harder)")
    p.add_argument("--hard_noise", type=float, default=0.05,
                   help="with --hard: additive noise sigma (signal RMS ~0.3; 0.05 ~ 14 dB SNR)")
    p.add_argument("--hard", action="store_true",
                   help="with --synthetic: 64 confusable words, speaker jitter, additive "
                        "noise and bigram-structured text")
    p.add_argument("--wav_dir", type=str, default="",
                   help="ingest a tree of .wav + LibriSpeech *.trans.txt files")
    p.add_argument("--dev_fraction", type=float, default=0.05)
    p.add_argument("--max_seconds", type=float, default=8.0)
    p.add_argument("--vocab_size", type=int, default=5000)
    p.add_argument("--num_utts", type=int, default=1000, help="CMVN sample size")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lm_order", type=int, default=3, help="n-gram order for `prepare lm`")
    p.add_argument("--device", type=str, default="cuda",
                   help="where cmvn and features run the frontend: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.command == "all":
        for cmd in ALL:
            rc = cmd(args)
            if rc:
                return rc
        return 0
    return COMMANDS[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())

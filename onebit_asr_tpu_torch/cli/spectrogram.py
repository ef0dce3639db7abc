"""Spectrogram visualization — `python -m onebit_asr_tpu_torch.cli.spectrogram`.

Counterpart of onebit_asr_tpu/cli/spectrogram.py: one utterance of a
prepared data dir (`--split`, `--index`), or with `--synthetic` a 3 s chirp,
through the port's log-mel frontend (ops/frontend.py::LogMelFrontend, plus
`apply_cmvn` when the data dir holds cmvn_stats.npz), drawn as a PNG heatmap
to `--out`. The frontend runs on `--device` (the card by default, as the
other CLIs). `log_mel` does the work and returns the [F, T] array; `main`
only draws it.

matplotlib is imported inside `main`; without it `main` exits 2 with a
message naming it, and writes nothing.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Tuple

import numpy as np
import torch


def chirp() -> np.ndarray:
    """The synthetic utterance: 3 s at 16 kHz sweeping up from 200 Hz."""
    t = np.linspace(0, 3.0, 48000, endpoint=False)
    return np.sin(2 * np.pi * (200 + 800 * t) * t).astype(np.float32)


def log_mel(data_dir: str, split: str = "dev", index: int = 0, synthetic: bool = False,
            device: str = "cuda") -> Tuple[np.ndarray, str]:
    """(the utterance's log-mel features [F, T] f32 over its valid frames,
    a title for the plot), CMVN-normalized when `data_dir` holds
    cmvn_stats.npz."""
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, apply_cmvn
    from onebit_asr_tpu_torch.utils.config import FrontendConfig

    fe = LogMelFrontend(FrontendConfig())
    title = "synthetic chirp"
    if synthetic:
        wav = chirp()
    else:
        from onebit_asr_tpu_torch.data.manifest import ShardCache, read_manifest

        u = read_manifest(os.path.join(data_dir, f"{split}_manifest.jsonl"))[index]
        wav = ShardCache(data_dir).wav(u)
        title = f"{u.utt_id}: {u.text[:60]}"
    feats, lens = fe(torch.from_numpy(wav)[None].to(device),
                     torch.tensor([len(wav)], device=device))
    cmvn_path = os.path.join(data_dir, "cmvn_stats.npz")
    if os.path.exists(cmvn_path):
        z = np.load(cmvn_path)
        feats = apply_cmvn(feats, torch.from_numpy(z["mean"]).to(device),
                           torch.from_numpy(z["std"]).to(device))
        title += " (CMVN)"
    return feats[0, : int(lens[0])].T.cpu().numpy(), title


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="render one utterance's fbank to PNG")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--split", type=str, default="dev")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", type=str, default="spectrogram.png")
    p.add_argument("--synthetic", action="store_true",
                   help="render a synthetic chirp instead of dataset audio")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    try:
        import matplotlib
    except ImportError:
        print("FATAL: drawing the spectrogram needs the matplotlib package, which is not "
              "installed", file=sys.stderr)
        return 2
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fb, title = log_mel(args.data_dir, args.split, args.index, args.synthetic, args.device)
    fig, ax = plt.subplots(figsize=(12, 4))
    im = ax.imshow(fb, aspect="auto", origin="lower", cmap="viridis")
    ax.set_xlabel("frame (10 ms)")
    ax.set_ylabel("mel bin")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out} ({fb.shape[1]} frames x {fb.shape[0]} mel bins)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

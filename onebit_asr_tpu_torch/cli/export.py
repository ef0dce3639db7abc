"""Export CLI — `python -m onebit_asr_tpu_torch.cli.export {offline,streaming,run}`.

Counterpart of onebit_asr_tpu/cli/export.py. Serializes a run this package
trained into a self-contained `torch.export` serving artifact (see
onebit_asr_tpu_torch/export.py), and runs such an artifact alone (`run`),
which loads nothing but `torch` and the package's kernel ops.

Examples:
    python -m onebit_asr_tpu_torch.cli.export offline --checkpoint runs/exp1 \\
        --precision 2 --batch 16 --frames 1024 --packed --out exp1.export
    python -m onebit_asr_tpu_torch.cli.export offline --checkpoint runs/exp1 \\
        --symbolic_batch --emit logprobs --out exp1_anyB.export
    python -m onebit_asr_tpu_torch.cli.export streaming --checkpoint runs/stream1 \\
        --precision 2 --n_streams 8 --out stream1.export
    python -m onebit_asr_tpu_torch.cli.export run --artifact exp1.export \\
        --features feats.npz

Every subcommand runs on the card unless `--device cpu`. `--platforms
cuda,cpu` writes one artifact with a program for each device (JAX's `gpu`
is `cuda`; `tpu` is refused); `run --device` (and `serve --artifact
--device`) picks the member to load, by default cuda if the artifact has
one, and refuses a device it has no member for. `offline --packed` under
ONEBIT_PACKED_INT8_ACT=1 (the JAX package's switch) exports the W2A8
kernel, as `--int8_act` does.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _restore(run_dir: str):
    """(cfg, JAX-layout params) from a cli.train run directory."""
    from onebit_asr_tpu_torch.convert import jax_tree_from_state_dict
    from onebit_asr_tpu_torch.utils.checkpoint import load_config, restore_params

    cfg = load_config(run_dir)
    if cfg is None:
        raise SystemExit(f"no config.json in {run_dir}")
    step, sd = restore_params(os.path.join(run_dir, "ckpt"))
    print(f"restored step {step} from {run_dir}")
    return cfg, jax_tree_from_state_dict(sd, cfg.model)


def _platforms(args):
    return tuple(args.platforms.split(",")) if args.platforms else None


def _refused_platforms(args) -> bool:
    """Whether the platforms asked for cannot be exported here (a message
    on stderr): before anything is restored, traced or written."""
    from onebit_asr_tpu_torch.export import export_devices

    try:
        export_devices(_platforms(args), args.device)
    except (ValueError, RuntimeError) as e:
        print(f"--platforms: {e}", file=sys.stderr)
        return True
    return False


def _cmd_offline(args) -> int:
    from onebit_asr_tpu_torch.export import artifact_meta, export_offline, save_artifact
    from onebit_asr_tpu_torch.ops.ternary_matmul import int8_act_enabled

    if _refused_platforms(args):
        return 2
    cfg, params = _restore(args.checkpoint)
    batch = None if args.symbolic_batch else args.batch
    decode_kwargs = {}
    if args.emit == "beam":
        lm = None
        if args.lm:
            from onebit_asr_tpu_torch.decode.lm import NGramLM
            from onebit_asr_tpu_torch.decode.lm_device import DeviceLM

            lm = DeviceLM.pack(NGramLM.load(args.lm), device=args.device)
            print(f"baking n-gram LM tables from {args.lm} into the artifact")
        decode_kwargs = dict(beam_size=args.beam_size, lm=lm, lm_weight=args.lm_weight,
                             length_bonus=args.length_bonus)
    # JAX's switch routes the packed path to W2A8 (ops/ternary_matmul.py)
    int8_act = args.int8_act or (args.packed and int8_act_enabled())
    t0 = time.perf_counter()
    exported = export_offline(
        cfg.model, params, args.precision, args.frames, batch, packed=args.packed,
        emit=args.emit, platforms=_platforms(args), device=args.device,
        int8_act=int8_act, **decode_kwargs,
    )
    meta = artifact_meta(
        cfg.model, args.precision, "offline", emit=args.emit, packed=args.packed,
        extra={"num_frames": args.frames,
               "batch_size": batch if batch is not None else "symbolic",
               "int8_act": int8_act,
               **({"beam_size": args.beam_size, "lm": bool(args.lm),
                   "lm_weight": args.lm_weight, "length_bonus": args.length_bonus}
                  if args.emit == "beam" else {})},
    )
    save_artifact(exported, args.out, meta)
    size = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out)
               if f.endswith(".pt2"))
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s ({size / 1e6:.2f} MB of "
          "programs)")
    return 0


def _cmd_streaming(args) -> int:
    from onebit_asr_tpu_torch.export import (
        artifact_meta,
        export_streaming,
        save_artifact,
        streaming_geometry,
    )

    if _refused_platforms(args):
        return 2
    cfg, params = _restore(args.checkpoint)
    m = cfg.model
    t0 = time.perf_counter()
    exported = export_streaming(m, params, args.precision, n_streams=args.n_streams,
                                platforms=_platforms(args), device=args.device)
    meta = artifact_meta(m, args.precision, "streaming",
                         extra={**streaming_geometry(m), "n_streams": args.n_streams})
    save_artifact(exported, args.out, meta)
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s")
    return 0


def _cmd_run(args) -> int:
    """Load an artifact and decode features with it: the hot path imports
    only torch and the package's kernel ops (the point of an export)."""
    import torch

    from onebit_asr_tpu_torch.export import greedy_ids_to_lists, load_artifact

    try:
        fn, meta = load_artifact(args.artifact, args.device)
    except (ValueError, RuntimeError) as e:
        print(f"--device {args.device}: {e}", file=sys.stderr)
        return 2
    if meta["kind"] != "offline":
        raise SystemExit("run supports offline artifacts (the streaming "
                         "step needs the session driver's state protocol)")
    T = int(meta["num_frames"])
    F = int(meta["model"]["input_dim"])
    if args.features:
        data = np.load(args.features)
        feats_in = data["feats"].astype(np.float32)
        lens_in = data["feat_lens"] if "feat_lens" in data.files else None
        if feats_in.ndim == 2:
            feats_in = feats_in[None]
        if lens_in is None:
            lens_in = np.array([feats_in.shape[1]] * len(feats_in))
    else:
        rng = np.random.default_rng(0)
        feats_in = rng.standard_normal((2, T // 2, F)).astype(np.float32)
        lens_in = np.array([T // 2, T // 3])
        print("no --features given; decoding random noise as a smoke test")
    B_art = meta["batch_size"]
    B = len(feats_in) if B_art == "symbolic" else int(B_art)
    feats = np.zeros((B, T, F), np.float32)
    lens = np.zeros((B,), np.int64)
    n = min(len(feats_in), B)
    for i in range(n):
        t = min(feats_in.shape[1], T, int(lens_in[i]))
        feats[i, :t] = feats_in[i, :t]
        lens[i] = t
    device = meta["device"]
    out = fn(torch.from_numpy(feats).to(device), torch.from_numpy(lens).to(device))
    emit = meta.get("emit", "greedy")
    if emit == "logprobs":
        log_probs, enc_lens = out
        print(f"log_probs {tuple(log_probs.shape)}, enc_lens {enc_lens[:n].tolist()}")
        return 0
    ids, lens_out = out[0], out[1]
    for i, hyp in enumerate(greedy_ids_to_lists(ids, lens_out)[:n]):
        print(f"utt {i}: {hyp}")
    return 0


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    po = sub.add_parser("offline", help="export the batch forward")
    po.add_argument("--checkpoint", required=True, help="cli.train run dir")
    po.add_argument("--out", required=True, help="artifact directory to write")
    po.add_argument("--precision", type=int, default=2, choices=(1, 2, 32))
    po.add_argument("--batch", type=int, default=8)
    po.add_argument("--symbolic_batch", action="store_true",
                    help="export a symbolic batch dim (any B, one artifact)")
    po.add_argument("--frames", type=int, default=1024,
                    help="static padded frame count T")
    po.add_argument("--packed", action="store_true",
                    help="planar-packed 2-bit weights through the ternary matmul kernel")
    po.add_argument("--int8_act", action="store_true",
                    help="with --packed: per-row int8 activations (the W2A8 kernel)")
    po.add_argument("--emit", default="greedy", choices=("greedy", "logprobs", "both", "beam"))
    po.add_argument("--beam_size", type=int, default=10)
    po.add_argument("--lm", default="",
                    help="with --emit beam: n-gram LM (.npz from `prepare lm`) packed + baked "
                         "into the artifact")
    po.add_argument("--lm_weight", type=float, default=0.3)
    po.add_argument("--length_bonus", type=float, default=0.0)
    po.add_argument("--platforms", default="",
                    help="comma-separated devices to export a program for (cuda, cpu); "
                         "default: --device")
    po.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    ps = sub.add_parser("streaming", help="export one streaming chunk step")
    ps.add_argument("--checkpoint", required=True)
    ps.add_argument("--out", required=True)
    ps.add_argument("--precision", type=int, default=2, choices=(1, 2, 32))
    ps.add_argument("--n_streams", type=int, default=1,
                    help=">1: export the StreamingServer's multiplexed batched chunk step "
                         "(serve N concurrent streams from the artifact: serve --artifact)")
    ps.add_argument("--platforms", default="",
                    help="comma-separated devices to export a program for (cuda, cpu); "
                         "default: --device")
    ps.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    pr = sub.add_parser("run", help="decode with a saved artifact")
    pr.add_argument("--artifact", required=True)
    pr.add_argument("--features", default="",
                    help="npz with feats [B,T,F] (+ optional feat_lens [B])")
    pr.add_argument("--device", default=None,
                    help="the member to run (cuda or cpu); default: cuda if the artifact "
                         "has it, else its only member")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.cmd == "offline":
        return _cmd_offline(args)
    if args.cmd == "streaming":
        return _cmd_streaming(args)
    return _cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())

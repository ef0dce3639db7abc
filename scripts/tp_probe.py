#!/usr/bin/env python3
"""How far the tensor-parallel step lands from the one-process step, and
why: per-leaf gradients at identical parameters and per-step aux terms,
each beside the one-process step's own repeat.

    python3 scripts/tp_probe.py [--seed 0] [--steps] [--device cpu]

On the card, at chip_smoke step 21's shapes (Conformer-M, B=16, 1,024
frames, `chip_smoke.dp_setup`; the TP step on two processes of the one card
in a gloo group, mesh (data 1, model 2)):

1. gradients: one step's gradients (AdamW's input) of a second one-process
   step and of the TP step (gathered over the model axis) against a first
   one-process step, from the same parameters: each leaf's |g - g_ref| /
   |g_ref|, the median and the worst leaves, in two configurations: "bf16"
   (both fused flags, step 21's) and "f32" (compute dtype float32, unfused:
   the kernels take bf16), which tells rounding apart from arithmetic;
2. with `--steps`, 1 + 3 steps (chip_smoke.dp_run) of a second one-process
   run and of the TP step twice against a first one-process run: each aux
   term's relative |d| at each step, and step 21's distances
   (`chip_smoke.dp_distance`).

With `--device cpu` part 1 runs on the CPU (two gloo processes) at a small
size: d=256, 4 heads, d_ff 1024, 2 blocks, vocabulary 64, B=8 of 32
frames. Prints the card's name and power limit beside the card's numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import multiprocessing as mp
import os
import sys
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SMALL = dict(enc_d_model=256, enc_heads=4, enc_d_ff=1024, enc_layers=2, dec_layers=1,
             dec_d_ff=256, vocab_size=64)


def setup(variant, device, seed):
    """(config, JAX-layout parameters, batch on `device`) of a variant."""
    from onebit_asr_tpu_torch.convert import init_params
    from onebit_asr_tpu_torch.data import DummyDataModule
    from onebit_asr_tpu_torch.train.step import batch_to_device

    if device == "cpu":
        from onebit_asr_tpu_torch.utils.config import ModelConfig

        cfg = dataclasses.replace(ModelConfig(), dropout=0.0, **SMALL)
        dm = DummyDataModule(batch_size=8, max_frames=32, max_tokens=6,
                             vocab_size=cfg.vocab_size)
        batch = batch_to_device(next(iter(dm.train_batches(0))), device)
        params = init_params(cfg, seed)
    else:
        cfg, params, batch = chip_smoke.dp_setup(seed)
    if variant == "f32":
        cfg = dataclasses.replace(cfg, compute_dtype="float32", fused_attention=False,
                                  fused_subsampler=False)
    return cfg, params, batch


def step_grads(cfg, params, batch, device, seed, mesh=None):
    """The gradients that one step hands AdamW, from a fresh state: the
    one-process step's, or over `mesh` the TP step's, gathered whole."""
    from onebit_asr_tpu_torch.convert import qat_model_from_jax
    from onebit_asr_tpu_torch.parallel import sharding_rules as S
    from onebit_asr_tpu_torch.train import AdamW, create_train_state, make_train_step
    from onebit_asr_tpu_torch.train.step import make_tp_train_step
    from onebit_asr_tpu_torch.utils.config import LossConfig, OptimConfig, SpecialTokens

    seen = {}

    class Recording(AdamW):
        def update(self, params, grads, mu, nu, count, g_norm=None):
            seen.update({k: g.detach().clone() for k, g in grads.items()})
            return super().update(params, grads, mu, nu, count, g_norm)

    model = qat_model_from_jax(cfg, params, device=device)
    state = create_train_state(model, seed)
    args = (model, Recording(OptimConfig(warmup_steps=1), 100_000), LossConfig(),
            SpecialTokens(), cfg.enc_layers)
    if mesh is None:
        make_train_step(*args)(state, batch)
        return {k: v.cpu().numpy() for k, v in seen.items()}
    make_tp_train_step(*args, mesh)(S.shard_state_tp(state, mesh), batch)
    group = mesh.group_of("model")
    return {k: S._gather(g, S._spec_for(k, g.dim(), "model"), mesh.axis_size("model"),
                         group).cpu().numpy() for k, g in seen.items()}


def rank_main(rank, port, outbox, variant, device, seed):
    """A TP rank: its gathered gradients (rank 0) into `outbox`."""
    import torch.distributed as dist

    from onebit_asr_tpu_torch.parallel.mesh import make_mesh

    try:
        if device == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=chip_smoke.TP_SIZE)
        try:
            mesh = make_mesh((1, chip_smoke.TP_SIZE), ("data", "model"))
            cfg, params, batch = setup(variant, device, seed)
            grads = step_grads(cfg, params, batch, device, seed, mesh)
            outbox.put((rank, True, grads if rank == 0 else None))
        finally:
            dist.destroy_process_group()
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        raise


def tp_grads(variant, device, seed):
    ctx = mp.get_context("spawn")
    outbox = ctx.Queue()
    port = chip_smoke.free_port()
    procs = [ctx.Process(target=rank_main, args=(r, port, outbox, variant, device, seed))
             for r in range(chip_smoke.TP_SIZE)]
    for p in procs:
        p.start()
    got = sorted((outbox.get(timeout=900) for _ in procs), key=lambda r: r[0])
    for p in procs:
        p.join()
    for rank, ok, value in got:
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{value}")
    return got[0][2]


def report_grads(variant, what, got, ref, tail):
    rel = {k: float(np.linalg.norm(got[k] - v) / max(np.linalg.norm(v), 1e-30))
           for k, v in ref.items()}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:6]
    by_kind = {}
    for k, v in rel.items():
        by_kind.setdefault(k.split(".")[-1], []).append(v)
    print(f"grads {variant} {what} vs one process: per-leaf |d|/|ref| median "
          f"{np.median(list(rel.values())):.3g}, by leaf kind max "
          f"{' '.join(f'{k}={max(v):.3g}' for k, v in sorted(by_kind.items()))}; worst "
          f"{' '.join(f'{k}={v:.3g}' for k, v in worst)}{tail}", flush=True)


def aux_steps(run, ref, what, tail):
    for i, (a, b) in enumerate(zip(run["aux"], ref["aux"])):
        rel = " ".join(f"{k}={abs(a[k] - v) / abs(v):.3g}" for k, v in b.items() if v)
        print(f"steps {what} step {i} relative |d|: {rel}{tail}", flush=True)
    print(f"steps {what}: {chip_smoke.dp_distance(run, ref)[2]}{tail}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", action="store_true", help="also part 2 (card only)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    tail = ""
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("tp_probe: no CUDA card", file=sys.stderr)
            return 1
        from onebit_asr_tpu_torch.ops import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.build()
        _build.library()
        tail = f" [{chip_smoke.smi_line()}]"
    else:
        torch.set_num_threads(1)
    for variant in ("bf16", "f32"):
        cfg, params, batch = setup(variant, args.device, args.seed)
        ref = step_grads(cfg, params, batch, args.device, args.seed)
        report_grads(variant, "one process again",
                     step_grads(cfg, params, batch, args.device, args.seed), ref, tail)
        report_grads(variant, "tensor parallel", tp_grads(variant, args.device, args.seed),
                     ref, tail)
    if args.steps and args.device == "cuda":
        from onebit_asr_tpu_torch.parallel.mesh import make_mesh

        kernels = chip_smoke.smoke_kernels()
        cfg, params, batch = chip_smoke.dp_setup(args.seed)
        ref = chip_smoke.dp_run("one process", cfg, params, batch, make_mesh(), kernels,
                                args.seed)
        again = chip_smoke.dp_run("one process", cfg, params, batch, make_mesh(), kernels,
                                  args.seed)
        aux_steps(again, ref, "one process again", tail)
        for i in range(2):
            # 1 + 3 TP steps of step 21's ranks: rank 0's run at dropout 0
            run = chip_smoke.as_tensors(chip_smoke.spawn_ranks(
                chip_smoke.tp_rank_work, chip_smoke.TP_SIZE, args.seed, "tensor parallel")[0][0.0])
            aux_steps(run, ref, f"tensor parallel {i}", tail)
    return 0


if __name__ == "__main__":
    sys.exit(main())

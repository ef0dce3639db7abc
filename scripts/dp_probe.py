#!/usr/bin/env python3
"""Where the data-parallel and ZeRO-2 steps' time goes over one rank, and
the one-process step's run-to-run spread, on one NVIDIA card.

    python3 scripts/dp_probe.py [--rounds 3] [--seed 0]

Over an nccl process group of world 1 (`chip_smoke.nccl_world_of_one`), at
chip_smoke step 20's shapes (Conformer-M, both fused flags, dropout 0,
B=16, 1,024 frames; `chip_smoke.dp_setup`):

1. `--rounds` rounds of the three paths (one process, data-parallel,
   ZeRO-2; the order reversed every other round), each 1 + 3 steps from a
   fresh state (`chip_smoke.dp_run`): ms per step (CUDA events), and each
   run's distance to the first one-process run in step 20's measures
   (`chip_smoke.dp_distance`); the one-process repeats' distances are the
   card's run-to-run spread, from which step 20's limits (`DP_TOL`) are set;
2. PROFILE_STEPS steps of each path under torch.profiler (CPU and CUDA
   activities), per step: wall ms, device busy ms, the ops with the most
   host time, and the ops whose host time (self CPU ms) and calls differ
   most from the one-process step's, which names where a parallel path's
   extra ms go.

Prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

KINDS = ("one process", "data parallel", "zero-2")
SPINS = 64  # opening spins of each profile (ROADMAP C3)
PROFILE_STEPS = 3


def profile_step(step, state, local):
    """PROFILE_STEPS steps under torch.profiler after one unprofiled, per
    step: (wall ms, device busy ms, kernels, opening spins kept, {op: [self
    CPU ms, calls]}, {kernel: [device ms, launches]})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, _ = step(state, local)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chip_smoke.opening_spins(SPINS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            state, _ = step(state, local)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    ops = {}
    for e in prof.key_averages():
        if e.self_cpu_time_total > 0:
            ops[e.key] = [e.self_cpu_time_total / 1e3 / PROFILE_STEPS, e.count / PROFILE_STEPS]
    kernels, spins, spans = {}, 0, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if chip_smoke.SPIN_KERNEL in e.name:
            spins += 1
            continue
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += e.time_range.elapsed_us() / 1e3 / PROFILE_STEPS
        k[1] += 1 / PROFILE_STEPS
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return (wall_ms, busy / 1e3 / PROFILE_STEPS, len(spans) / PROFILE_STEPS, spins, ops,
            kernels)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.smi_line()
    from onebit_asr_tpu_torch.ops import _build
    from onebit_asr_tpu_torch.ops import attention as fa
    from onebit_asr_tpu_torch.ops import ctc_lattice as cl
    from onebit_asr_tpu_torch.ops import subsampler as ss
    from onebit_asr_tpu_torch.parallel.mesh import shard_batch

    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    kernels = {"fused_relpos_attention": fa.fused_relpos_attention,
               "fused_relpos_attention_bwd": fa.fused_relpos_attention_bwd,
               "fused_subsample": ss.fused_subsample, "fused_subsample_bwd": ss.fused_subsample_bwd,
               "ctc_alpha": cl.ctc_alpha, "ctc_beta": cl.ctc_beta}
    cfg, params, batch = chip_smoke.dp_setup(args.seed)
    with chip_smoke.nccl_world_of_one() as mesh:
        ref, ms = None, {k: [] for k in KINDS}
        for r in range(args.rounds):
            for kind in KINDS[::1 if r % 2 == 0 else -1]:
                run = chip_smoke.dp_run(kind, cfg, params, batch, mesh, kernels, args.seed)
                ms[kind].append(run["ms"])
                if ref is None:
                    ref = run
                    print(f"spread: round 0 {kind} is the reference: launches={run['counts']}",
                          flush=True)
                    continue
                dist_, _, text = chip_smoke.dp_distance(run, ref)
                print(f"spread: round {r} {kind}: ms_per_step={run['ms']:.2f} peak_mem_gb="
                      f"{run['peak_gb']:.3f} distances={[float(f'{d:.4g}') for d in dist_]} "
                      f"{text} [{smi}]", flush=True)
                del run
        for kind in KINDS:
            print(f"ms per step: {kind}: {[round(t, 2) for t in ms[kind]]} [{smi}]", flush=True)
        del ref
        profiles = {}
        for kind in KINDS:
            step, state, _ = chip_smoke.dp_step(kind, cfg, params, mesh, args.seed)
            profiles[kind] = profile_step(step, state, shard_batch(batch, mesh))
            del step, state
            torch.cuda.empty_cache()
    base_ops, base_kernels = profiles["one process"][4], profiles["one process"][5]
    for kind in KINDS:
        wall, busy, n_kernels, spins, ops, kern = profiles[kind]
        print(f"profile {kind} (per step, {PROFILE_STEPS} steps): wall_ms={wall:.2f} "
              f"busy_ms={busy:.2f} kernels={n_kernels:.0f} "
              f"spins_kept={spins}/{SPINS} self_cpu_ms={sum(v[0] for v in ops.values()):.2f} "
              f"[{smi}]", flush=True)
        for name, (t, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:args.top]:
            print(f"profile {kind}: host {t:9.3f} ms {n:8.1f} calls  {name[:80]}")
        if kind == "one process":
            continue
        names = set(ops) | set(base_ops)
        delta = {k: (ops.get(k, [0.0, 0])[0] - base_ops.get(k, [0.0, 0])[0],
                     ops.get(k, [0.0, 0])[1] - base_ops.get(k, [0.0, 0])[1]) for k in names}
        for name, (dt, dn) in sorted(delta.items(), key=lambda kv: -abs(kv[1][0]))[:args.top]:
            print(f"profile {kind} - one process: host {dt:+9.3f} ms {dn:+8.1f} calls  "
                  f"{name[:80]}")
        names = set(kern) | set(base_kernels)
        delta = {k: (kern.get(k, [0.0, 0])[0] - base_kernels.get(k, [0.0, 0])[0],
                     kern.get(k, [0.0, 0])[1] - base_kernels.get(k, [0.0, 0])[1])
                 for k in names}
        for name, (dt, dn) in sorted(delta.items(), key=lambda kv: -abs(kv[1][0]))[:8]:
            print(f"profile {kind} - one process: device {dt:+9.3f} ms {dn:+8.1f} launches  "
                  f"{name[:80]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

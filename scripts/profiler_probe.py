#!/usr/bin/env python3
"""How many leading kernel records a torch.profiler session drops once the
process has profiled before (ROADMAP C3), on one NVIDIA card.

    python3 scripts/profiler_probe.py [--at 0,15,45,90]

Runs one `utils/profiling.trace` session of a few adds (what the train
CLI's --profile_dir takes), then, at each time of --at (seconds after that
session), sleeping on the host in between:

- a ladder: one profile of 300 spins of the card (torch.cuda._sleep, ~0.1
  ms each), printing how many it kept;
- chip_smoke.device_ms of one packed bf16 projection (M=4096, K=256,
  N=1024), printing the profiles it took and how many of its opening
  spins each lost;
- the same 20 calls profiled with no opening spins, printing how many
  kernel events that profile kept.

Nothing of step 16 or of any other phase runs: the sleep alone is the
repro. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def kept(fn, n):
    """CUDA events of one profile of `n` calls of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--at", default="0,15,45,90",
                    help="seconds after the first session at which to probe")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from onebit_asr_tpu_torch.ops import _build
    from onebit_asr_tpu_torch.ops import ternary_matmul as tm
    from onebit_asr_tpu_torch.utils.profiling import trace

    with contextlib.redirect_stdout(io.StringIO()):
        _build.build(verbose=True)
    _build.library()
    rng = np.random.default_rng(1)
    M, K, N = 4096, 256, 1024
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).cuda()
    x = x.to(torch.bfloat16)
    q = torch.from_numpy(rng.integers(-1, 2, size=(K, N)).astype(np.float32))
    packed = tm.pack_planar(q).cuda()
    alpha = torch.tensor(0.05, dtype=torch.float32, device="cuda")

    def call():
        return tm.ternary_matmul(x, packed, alpha)

    call()
    y = torch.zeros(8, 8, device="cuda")
    with tempfile.TemporaryDirectory() as d, trace(d):
        for _ in range(100):
            y = y + 1
    t0 = time.perf_counter()
    for at in (float(a) for a in args.at.split(",")):
        time.sleep(max(0.0, at - (time.perf_counter() - t0)))
        t = time.perf_counter() - t0
        ladder = kept(lambda: torch.cuda._sleep(200_000), 300)
        with contextlib.redirect_stdout(io.StringIO()):
            ms, _ = cs.device_ms(call)
        n = cs.PROFILES[-1]
        bare = [e for e in kept(call, 20) if cs.SPIN_KERNEL not in e.name]
        print(f"profiler_probe t={t:.1f}s: ladder kept {len(ladder)}/300 spins; device_ms "
              f"{ms:.5f} ms in {n} profile(s), opening spins lost {cs.PAD_LOST[-n:]}; "
              f"without spins {len(bare)}/20 kernel events", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"profiler_probe: [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

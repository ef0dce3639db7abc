#!/usr/bin/env python3
"""Where the pipelined step's distance to the one-process step comes from
(chip_smoke.py step 22; the readings that set `PP_TOL`). Card only.

    python3 scripts/pp_probe.py [--seed 0] [--runs 2]

On step 22's model (Conformer-M, per-frame layer norm, B=16, 1,024 frames)
and batch, at dropout 0: the one-process step `--runs` times (the card's
run-to-run spread), then the pipelined step on two ranks of the card over
gloo ((data 1, stage 2), `chip_smoke.spawn_ranks`) with M=2 microbatches
`--runs` times and with M=1 once (the stage split without microbatches);
first at bf16 with both fused flags, then at f32 without them (rows 3-6
take bf16 only). Each run is 1 + 3 steps from the same state; each line is
chip_smoke's `dp_distance` to the first one-process run of that dtype.
About 4 min with the build.
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pp_probe: no CUDA card", file=sys.stderr)
        return 1
    from onebit_asr_tpu_torch.ops import _build
    from onebit_asr_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    smi = C.smi_line()
    print(f"pp_probe: build {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    kernels = C.smoke_kernels()
    for flags in ({}, {"compute_dtype": "float32", "fused_attention": False,
                       "fused_subsampler": False}):
        what = flags.get("compute_dtype", "bfloat16")
        cfg, params, batch = C.pp_setup(args.seed, **flags)
        ref = C.dp_run("one process", cfg, params, batch, make_mesh(), kernels, args.seed)
        for i in range(1, args.runs):
            again = C.dp_run("one process", cfg, params, batch, make_mesh(), kernels, args.seed)
            print(f"pp_probe {what}: one process again ({i}): ms_per_step={again['ms']:.2f} "
                  f"{C.dp_distance(again, ref)[2]}", flush=True)
        del params
        for micro in [2] * args.runs + [1]:
            work = functools.partial(C.pp_rank_work, micro=micro, flags=flags, dropouts=(0.0,))
            ranks = C.spawn_ranks(work, C.PP_STAGES, args.seed, "pp_probe")
            run = C.as_tensors(ranks[0][0.0])
            same = len({r[0.0]["digest"] for r in ranks}) == 1
            print(f"pp_probe {what}: pipelined M={micro}: ms_per_step={run['ms']:.2f} ranks "
                  f"bit-equal={same} {C.dp_distance(run, ref)[2]} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

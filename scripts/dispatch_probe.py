#!/usr/bin/env python3
"""What reaching the packed kernels through their torch.library custom ops
costs on the host, on one NVIDIA card.

    python3 scripts/dispatch_probe.py [--rounds 8] [--iters 200]

The wrappers `ternary_matmul` and `ternary_matmul_w2a8` call
`torch.ops.onebit.*`, whose CUDA kernel is the ctypes launch
(`_launch_bf16`, `_launch_w2a8`). This probe times both routes to the same
kernel, in alternating rounds (`chip_smoke.paired_ms`: CUDA events around
each round's calls, the rounds' medians and the range of their ratios):

1. one call at a host-bound shape (M=8, K=256, N=256) and at the largest
   shape of a Conformer-M serving forward (4096 x 256 x 1024), `--iters`
   calls a round: us per call through the op and through the launch;
2. the live packed Conformer-M forward (random weights from `--seed`,
   precision 2, B=8, step 3 of chip_smoke's features, T=1,598), its 108
   `QuantDense.matmul` through the op (as served) and swapped for the
   direct launch: ms per batch, rounds of 3 forwards;
3. the same forward from its loaded `torch.export` artifact beside the live
   one through the op.

Prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from onebit_asr_tpu_torch.ops import ternary_matmul as tm  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.smi_line()
    from onebit_asr_tpu_torch import export as ex
    from onebit_asr_tpu_torch.convert import init_params
    from onebit_asr_tpu_torch.model.layers import QuantDense
    from onebit_asr_tpu_torch.model.presets import apply_preset
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, apply_cmvn
    from onebit_asr_tpu_torch.utils.config import ModelConfig

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    routes = {"ternary_matmul": (torch.ops.onebit.ternary_matmul, tm._launch_bf16),
              "ternary_matmul_w2a8": (torch.ops.onebit.ternary_matmul_w2a8, tm._launch_w2a8)}
    for M, K, N in ((8, 256, 256), (4096, 256, 1024)):
        x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
        q = torch.randint(-1, 2, (K, N), device="cuda", generator=g)
        packed, alpha = tm.pack_planar(q), torch.tensor(0.7, device="cuda")
        for name, (op, launch) in routes.items():
            a = op(x, packed, alpha)
            b = launch(x, packed, alpha)
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: the op and the launch differ")
            ms_op, ms_launch, ratios = chip_smoke.paired_ms(
                lambda: op(x, packed, alpha), lambda: launch(x, packed, alpha),
                rounds=args.rounds, iters=args.iters)
            print(f"dispatch {name} M={M} K={K} N={N}: us per call op={1e3 * ms_op:.2f} "
                  f"launch={1e3 * ms_launch:.2f} op-launch={1e3 * (ms_op - ms_launch):.2f} "
                  f"op/launch per round {ratios[0]:.3f}-{ratios[1]:.3f} [{smi}]", flush=True)

    cfg = apply_preset(ModelConfig(), "m")
    params = init_params(cfg, args.seed)
    batch, lens = chip_smoke.pcm_batch(chip_smoke.synthetic_waveforms(args.seed))
    cmvn = [torch.from_numpy(a).cuda() for a in chip_smoke.cmvn_of(batch, lens)]
    with torch.no_grad():
        feats, feat_lens = LogMelFrontend()(torch.from_numpy(batch).cuda(),
                                            torch.from_numpy(lens).cuda())
        feats = apply_cmvn(feats, *cmvn)
    live = ex.build_offline_forward(cfg, params, 2, packed=True, emit="logprobs",
                                    device="cuda")
    direct = ex.build_offline_forward(cfg, params, 2, packed=True, emit="logprobs",
                                      device="cuda")
    swapped = 0
    for m in direct.modules():
        if isinstance(m, QuantDense):
            m.matmul = tm._launch_bf16
            swapped += 1
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "onebit_asr_tpu_torch")) as root:
        ep = ex.export_offline(cfg, params, 2, feats.shape[1], chip_smoke.BATCH, packed=True,
                               emit="logprobs", device="cuda")
        ex.save_artifact(ep, root, ex.artifact_meta(cfg, 2, "offline", "logprobs", True))
        art, _ = ex.load_artifact(root)
    with torch.no_grad():
        want = live(feats, feat_lens)[0]
        for label, fn in (("direct launch", direct), ("artifact", art)):
            if not torch.equal(fn(feats, feat_lens)[0], want):
                raise AssertionError(f"{label}: log-probs differ from the live forward's")
        for label, fn in (("direct launch", direct), ("artifact", art)):
            ms_op, ms_other, ratios = chip_smoke.paired_ms(
                lambda: live(feats, feat_lens), lambda: fn(feats, feat_lens),
                rounds=args.rounds, iters=3)
            print(f"forward packed Conformer-M p2 B={chip_smoke.BATCH} T={feats.shape[1]} "
                  f"({swapped} QuantDense): ms per batch live through the op={ms_op:.2f} "
                  f"{label}={ms_other:.2f} live/{label} per round "
                  f"{ratios[0]:.3f}-{ratios[1]:.3f} [{smi}]", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the fused subsampler kernels' device time goes, on one NVIDIA card.

    python3 scripts/subsampler_probe.py [--package DIR] [--rows]

At the Conformer-M serving shape (B=8, T=1598) and the train step's shape
(B=16, T=1024), F=80, C=256, it prints the device time per call
(torch.profiler) of

- row 5, the forward (`fused_subsample_fwd`), at every rows-per-CTA r2 the
  kernel takes, the plan's choice marked, beside the port's unfused cuDNN
  conv pair (bf16 features -> two convs + ReLU; a yardstick only);
- row 6, the backward (`fused_subsample_bwd`), per pass: the mask pass
  (row 5's kernel with the mask epilogue), the conv1 pass, the dw2 pass and
  the fixed-order reduce, beside the cuDNN pair's backward through autograd;
- knock-out builds of onebit_asr_tpu_torch/csrc/subsampler.cu, compiled
  here from patched copies: `nomma` (no mma instruction; its operands stay
  live), `noload` (no cp.async copy and no wait: the w2 and gm stages and
  the gm tile are never loaded), `noconv1` (no conv1 recompute: the conv1
  tiles are never written). Their results are wrong by design: only their
  time is read.

The knock-out patches match the source's text and fail loudly when it
changes. Builds go to onebit_asr_tpu_torch/_build/probe/ (gitignored).

--rows prints only the device time per launch of rows 5 and 6 through their
Python wrappers (row 6 per kernel) and the cuDNN yardsticks, which works on
any checkout of the port: with --package DIR it times the
onebit_asr_tpu_torch of the repo root DIR (an earlier commit unpacked there)
instead of this one's, so that two versions compare in one run.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_build = ss = smoke = None  # the package's modules and chip_smoke, imported in main()

SHAPES = [("serving", 8, 1598, 80, 256), ("train step", 16, 1024, 80, 256)]
PASSES = (("mask", "conv2_kernel<true>"), ("conv1", "bwd_conv1_kernel"),
          ("dw2", "bwd_dw2_kernel"), ("reduce", "bwd_reduce"))
KNOCKOUTS = {
    "nomma": [(
        """                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16""",
        """                                         uint32_t b1) {
#ifdef KNOCKOUT
  asm volatile("" : "+f"(d[0]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#else
  asm(
      "mma.sync.aligned.m16n8k16"""), (
        """      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}""",
        """      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#endif
}""")],
    "noload": [(
        """  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));""",
        "  (void)dst, (void)src, (void)src_bytes;"), (
        """  asm volatile("cp.async.wait_group %0;\\n" :: "n"(N));""", "")],
    "noconv1": [("  for (int base = 0; base < P; base += 2 * lanes) {",
                 "  for (int base = P; base < P; base += 2 * lanes) {")],
}


def build_knockouts() -> dict:
    src = (_build.CSRC_DIR / "subsampler.cu").read_text()
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, patches in KNOCKOUTS.items():  # every patch applies before any build starts
        s = src
        for old, new in patches:
            if s.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has the text to patch:\n{old}")
            s = s.replace(old, new)
        paths[name] = out_dir / f"subsampler_{name}.cu"
        paths[name].write_text(s)
    procs = {}
    for name, path in paths.items():
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DKNOCKOUT", "-shared", "-o",
             str(out_dir / f"subsampler_{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"subsampler_{name}.so"))
        for fn in ("fused_subsample_fwd", "fused_subsample_bwd",
                   "fused_subsample_bwd_workspace"):
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = _build.RESTYPES.get(fn, ctypes.c_int)
        libs[name] = lib
    return libs


def device_ms_by_kernel(fn) -> dict:
    """Device ms per call of each kernel `fn` launches: chip_smoke's
    device_ms (torch.profiler) over 10 calls."""
    return smoke.device_ms(fn, iters=10, per_kernel=True)[1]

def total(by_name: dict) -> float:
    return sum(by_name.values())


def operands(B, T, F, C, seed=0):
    rng = np.random.default_rng(seed)
    x, w1, b1, w2, b2 = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        rng.standard_normal((B, T, F)), rng.standard_normal((3, 3, C)) / 3.0,
        rng.uniform(-1 / 3, 1 / 3, C), rng.standard_normal((9 * C, C)) / np.sqrt(9 * C),
        rng.uniform(-1, 1, C) / np.sqrt(9 * C)))
    T2, F2 = ss.out_len(ss.out_len(T)), ss.out_len(ss.out_len(F))
    g = torch.from_numpy(rng.standard_normal((B, T2, F2, C)).astype(np.float32)).cuda()
    return x, w1, b1, w2.to(torch.bfloat16), b2, g.to(torch.bfloat16)


def fwd(lib, ops, y, r2=0):
    x, w1, b1, w2, b2, _ = ops
    B, T, F = x.shape
    err = lib.fused_subsample_fwd(*(t.data_ptr() for t in (x, w1, b1, w2, b2, y)), B, T, F,
                                  w1.shape[-1], r2, x.device.index,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err, "probe forward")


def bwd(lib, ops, outs, ws):
    x, w1, _, _, _, _ = ops
    B, T, F = x.shape
    err = lib.fused_subsample_bwd(*(t.data_ptr() for t in (*ops, *outs, ws)),
                                  ctypes.c_longlong(ws.numel()), B, T, F, w1.shape[-1],
                                  x.device.index, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "probe backward")


def per_pass(by_name: dict) -> str:
    parts = []
    for label, key in PASSES:
        ms = sum(v for k, v in by_name.items() if key in k)
        parts.append(f"{label}={ms:.5f}")
    return " ".join(parts)


def rows_only(unfused_subsample) -> None:
    """Device ms per launch of rows 5 and 6 through the package's wrappers."""
    for label, B, T, F, C in SHAPES:
        x, w1, b1, w2, b2, g = operands(B, T, F, C)
        with torch.no_grad():
            fwd_ms = total(device_ms_by_kernel(lambda: ss.fused_subsample(x, w1, b1, w2, b2)))
            lib_ms = total(device_ms_by_kernel(lambda: unfused_subsample(x, w1, b1, w2, b2)))
        print(f"{label} B={B} T={T} F={F} C={C}: row 5 device_ms={fwd_ms:.5f} cuDNN pair "
              f"forward device_ms={lib_ms:.5f}", flush=True)
        if label == "serving":
            continue
        by = device_ms_by_kernel(lambda: ss.fused_subsample_bwd(x, w1, b1, w2, b2, g))
        leaves = [t.float().clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        yl = unfused_subsample(*leaves)
        lib_b = total(device_ms_by_kernel(
            lambda: torch.autograd.grad(yl, leaves, g, retain_graph=True)))
        del yl, leaves
        own = {}  # the launch's kernels by short name (the call also casts w2 and dw2)
        for k, v in by.items():
            if "fused_subsample" in k:
                short = k[k.index("fused_subsample"):].split("(")[0]
                own[short] = own.get(short, 0.0) + v
        print(f"{label} B={B} T={T} F={F} C={C}: row 6 device_ms={sum(own.values()):.5f} ("
              + " ".join(f"{k}={v:.5f}" for k, v in own.items())
              + f"); cuDNN pair backward device_ms={lib_b:.5f}", flush=True)


def main(argv=None) -> int:
    global _build, ss, smoke
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--package", default=REPO,
                    help="the repo root whose onebit_asr_tpu_torch is timed (default: this one)")
    ap.add_argument("--rows", action="store_true",
                    help="only rows 5 and 6 through their wrappers (no tilings, no knock-outs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("subsampler_probe: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [REPO]  # this checkout's chip_smoke, whatever --package says
    import chip_smoke as smoke
    sys.path[:0] = [os.path.abspath(args.package)]
    unfused_subsample = smoke.unfused_subsample
    from onebit_asr_tpu_torch.ops import _build
    from onebit_asr_tpu_torch.ops import subsampler as ss

    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"package: {os.path.dirname(os.path.dirname(ss.__file__))}", flush=True)
    if args.rows:
        rows_only(unfused_subsample)
        return 0
    lib = _build.library()
    knockouts = build_knockouts()

    for label, B, T, F, C in SHAPES:
        ops = operands(B, T, F, C)
        x, w1, b1, w2, b2, g = ops
        plan = ss.launch_plan(B, T, F, C)
        T2, F2 = ss.out_len(ss.out_len(T)), ss.out_len(ss.out_len(F))
        y = torch.empty((B, T2, F2, C), dtype=torch.bfloat16, device="cuda")
        with torch.no_grad():
            lib_ms = total(device_ms_by_kernel(lambda: unfused_subsample(x, w1, b1, w2, b2)))
        print(f"{label} B={B} T={T} F={F} C={C}: plan {plan}", flush=True)
        print(f"  row 5 cuDNN pair forward: device_ms={lib_ms:.5f}", flush=True)
        for r2 in range(1, plan["fwd_r2_max"] + 1):
            ms = total(device_ms_by_kernel(lambda: fwd(lib, ops, y, r2)))
            ctas = -(-T2 // r2) * B * -(-C // 256)
            mark = " <- plan" if r2 == plan["fwd_r2"] else ""
            print(f"  row 5 r2={r2} CTAs={ctas}: device_ms={ms:.5f}{mark}", flush=True)
        f32 = dict(dtype=torch.float32, device="cuda")
        outs = (torch.empty((B, T, F), **f32), torch.empty((3, 3, C), **f32),
                torch.empty((C,), **f32), torch.empty((9 * C, C), **f32),
                torch.empty((C,), **f32))
        ws = torch.empty(plan["workspace_floats"], **f32)
        by = device_ms_by_kernel(lambda: bwd(lib, ops, outs, ws))
        leaves = [t.float().clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        yl = unfused_subsample(*leaves)
        lib_b = total(device_ms_by_kernel(
            lambda: torch.autograd.grad(yl, leaves, g, retain_graph=True)))
        del yl, leaves
        print(f"  row 6 per launch: device_ms={total(by):.5f} ({per_pass(by)}) cuDNN pair "
              f"backward device_ms={lib_b:.5f} workspace {plan['workspace_floats'] * 4 / 1e6:.1f}"
              f" MB", flush=True)
        for name, k in knockouts.items():
            fms = total(device_ms_by_kernel(lambda: fwd(k, ops, y)))
            kb = device_ms_by_kernel(lambda: bwd(k, ops, outs, ws))
            print(f"  knock-out {name}: row 5 device_ms={fms:.5f}; row 6 device_ms="
                  f"{total(kb):.5f} ({per_pass(kb)})", flush=True)
        del ws, outs, ops, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

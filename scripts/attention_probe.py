#!/usr/bin/env python3
"""Where the fused rel-pos attention kernels' device time goes, on one NVIDIA card.

    python3 scripts/attention_probe.py [--package DIR] [--rows]

At the Conformer-M serving shape (B=8, H=4, T=512, dh=64, no dropout) and
the train step's shape (B=16, H=4, T=256, dh=64, dropout 0.1) it prints the
device time per call (torch.profiler) of

- row 3, the forward (`fused_relpos_attention_fwd`), in its serving form and
  in its training form (which also writes each row's max and sum);
- row 4, the backward (`fused_relpos_attention_bwd`), per kernel (rowdot,
  gradients, reduce), on the forward's row statistics and alone;
- knock-out builds of onebit_asr_tpu_torch/csrc/attention*.cu(h), compiled
  here from patched copies: `nomma` (no mma instruction; its operands stay
  live), `noload` (no cp.async copy and no wait: no tile is loaded),
  `noexp` (the softmax's expf and divide replaced by the identity and a
  multiply), `nodiv` (the divide alone), `noslowdiv` (without the divide's
  rarely taken fallback), `noband` (no band product, the
  skewed position term), and in the gradient kernel alone `nodq`, `nodkdv`,
  `nodp` (without that product). Their results are wrong by design: only
  their time is read.

The knock-out patches match the sources' text and fail loudly when it
changes. Builds go to onebit_asr_tpu_torch/_build/probe/ (gitignored).

--rows prints only the device time per launch of rows 3 and 4 through their
Python wrappers, which works on any checkout of the port: with --package
DIR it times the onebit_asr_tpu_torch of the repo root DIR (an earlier
commit unpacked there) instead of this one's, so that two versions compare
in one run. A checkout whose forward writes no row statistics is timed in
its one forward form and its backward alone.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_build = fa = smoke = None  # the package's modules and chip_smoke, imported in main()

# (label, B, H, T, dh, dropout rate)
SHAPES = [("serving", 8, 4, 512, 64, 0.0), ("train step", 16, 4, 256, 64, 0.1)]
SOURCES = ("attention.cu", "attention_bwd.cu", "attention_rows.cuh", "attention_common.cuh")
DIV_KNOCKOUT = ("attention_common.cuh", (
    """  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);""",
    "  return a * y;"))
KNOCKOUTS = {
    "nomma": [("attention_common.cuh", (
        """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));""",
        """  asm volatile("" : "+f"(d[0]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
               "r"(b1));"""))],
    "noload": [("attention_common.cuh", (
        """  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");""",
        "  (void)dst, (void)src, (void)src_bytes;")),
        ("attention_common.cuh", (
            """  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");""",
            "  (void)dst, (void)src, (void)src_bytes;")),
        ("attention_common.cuh", (
            """  asm volatile("cp.async.wait_group %0;\\n" :: "n"(N) : "memory");""", ""))],
    "noexp": [("attention_common.cuh", (
        "__device__ __forceinline__ float sm_exp(float x) { return expf(x); }",
        "__device__ __forceinline__ float sm_exp(float x) { return x; }")), DIV_KNOCKOUT],
    "nodiv": [DIV_KNOCKOUT],
    "noslowdiv": [("attention_common.cuh", (
        "  if (__any_sync(0xffffffffu, tiny)) {",
        "  if (false && __any_sync(0xffffffffu, tiny)) {"))],
    # no band product (the skewed position term): its mma and shifted writes
    "noband": [("attention_rows.cuh", (
        "    for (int half = 0; half < 2; ++half) {",
        "    for (int half = 2; half < 2; ++half) {")),
        ("attention_bwd.cu", (
            """        for (int ks = 0; ks < KS; ++ks) {
          uint32_t av[4];""",
            """        for (int ks = KS; ks < KS; ++ks) {
          uint32_t av[4];"""))],
    # the gradient kernel without one of its products: dq (ds_c k + dbraw p,
    # and its partial's stores), dv and dk, dp
    "nodq": [("attention_bwd.cu", (
        """      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t aa[4], bb[4];""",
        """      for (int kk = BK / 16; kk < BK / 16; ++kk) {
        uint32_t aa[4], bb[4];""")),
        ("attention_bwd.cu", (
            """      for (int kk = 0; kk < 5; ++kk) {
        const int rb = cq + 16 * kk;""",
            """      for (int kk = 5; kk < 5; ++kk) {
        const int rb = cq + 16 * kk;"""))],
    "nodkdv": [("attention_bwd.cu", (
        """      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], as[4], bb[4];""",
        """      for (int kk = BQ / 16; kk < BQ / 16; ++kk) {
        uint32_t ap[4], as[4], bb[4];"""))],
    "nodp": [("attention_bwd.cu", (
        """      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ad[4];""",
        """      for (int kk = BQ / 16; kk < BQ / 16; ++kk) {
        uint32_t ad[4];"""))],
}


def build_knockouts() -> dict:
    """{name: ctypes library} of each knock-out build."""
    out_dir = _build.BUILD_DIR / "probe"
    texts = {name: (_build.CSRC_DIR / name).read_text() for name in SOURCES}
    procs = {}
    for name, patches in KNOCKOUTS.items():  # every patch applies before any build starts
        srcs = dict(texts)
        for fname, (old, new) in patches:
            if srcs[fname].count(old) != 1:
                raise RuntimeError(f"{name}: {fname} no longer has the text to patch:\n{old}")
            srcs[fname] = srcs[fname].replace(old, new)
        d = out_dir / f"attention_{name}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for fname, text in srcs.items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "attention.cu"), str(d / "attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"attention_{name}" / "lib.so"))
        for fn in ("fused_relpos_attention_fwd", "fused_relpos_attention_bwd"):
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms_by_kernel(fn) -> dict:
    """Device ms per call of each kernel `fn` launches: chip_smoke's
    device_ms (torch.profiler) over 10 calls."""
    return smoke.device_ms(fn, iters=10, per_kernel=True)[1]

def short(by_name: dict) -> str:
    """'name=ms' per kernel, names cut to the template's name and arguments."""
    parts = []
    for k, v in by_name.items():
        name = k.split("(")[0].split("::")[-1] if "::" in k else k[:40]
        parts.append(f"{name}={v:.5f}")
    return " ".join(parts)


def operands(B, H, T, dh, rate, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.concatenate([[T], rng.integers(T // 2, T + 1, B - 1)])
    key_mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(np.float32)).cuda()
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, T, dh)).astype(np.float32))
                  .cuda().to(torch.bfloat16) for _ in range(4))
    p = torch.from_numpy(rng.standard_normal((H, 2 * T - 1, dh)).astype(np.float32))
    u, vb = (torch.from_numpy((0.1 * rng.standard_normal((H, dh))).astype(np.float32))
             .cuda().to(torch.bfloat16) for _ in range(2))
    drop8 = torch.from_numpy(rng.integers(0, 256, size=(B, H, T, T), dtype=np.uint8) if rate
                             else np.zeros((1, 1, 1, 1), np.uint8)).cuda()
    return (q, k, v, p.cuda().to(torch.bfloat16), u, vb, key_mask, drop8), g


def _stream():
    return torch.cuda.current_stream().cuda_stream


def fwd(lib, ops, out, stats, scale, kd):
    B, H, T, dh = ops[0].shape
    ptrs = [t.data_ptr() for t in stats] if stats else [None, None]
    err = lib.fused_relpos_attention_fwd(*(t.data_ptr() for t in ops), out.data_ptr(), *ptrs,
                                         B, H, T, dh, ctypes.c_float(scale), kd,
                                         ctypes.c_float(256.0 / (256 - kd)),
                                         ops[0].device.index, _stream())
    _build.check(err, "probe forward")


def bwd(lib, ops, g, stats, outs, ws, scale, kd):
    B, H, T, dh = ops[0].shape
    ptrs = [t.data_ptr() for t in stats] if stats else [None, None]
    err = lib.fused_relpos_attention_bwd(*(t.data_ptr() for t in ops), g.data_ptr(), *ptrs,
                                         *(t.data_ptr() for t in (*outs, ws)),
                                         ctypes.c_longlong(ws.numel()), B, H, T, dh,
                                         ctypes.c_float(scale), kd,
                                         ctypes.c_float(256.0 / (256 - kd)),
                                         ops[0].device.index, _stream())
    _build.check(err, "probe backward")


def rows_only() -> None:
    """Device ms per launch of rows 3 and 4 through the package's wrappers."""
    stats_api = hasattr(fa, "row_stats_reference")  # a forward that writes row statistics
    for label, B, H, T, dh, rate in SHAPES:
        ops, g = operands(B, H, T, dh, rate)
        scale = 1.0 / float(np.sqrt(dh))
        with torch.no_grad():
            by = device_ms_by_kernel(lambda: fa.fused_relpos_attention(*ops, scale, rate))
        print(f"{label} B={B} H={H} T={T} dh={dh} rate={rate}: row 3 serving form "
              f"device_ms={sum(by.values()):.5f} ({short(by)})", flush=True)
        if label == "serving":
            continue
        stats = None
        if stats_api:
            by = device_ms_by_kernel(lambda: fa._fwd(*ops, scale, rate, stats=True))
            print(f"{label}: row 3 training form device_ms={sum(by.values()):.5f} "
                  f"({short(by)})", flush=True)
            _, stats = fa._fwd(*ops, scale, rate, stats=True)
            by = device_ms_by_kernel(
                lambda: fa.fused_relpos_attention_bwd(*ops, g, scale, rate, stats=stats))
            print(f"{label}: row 4 on the row statistics device_ms={sum(by.values()):.5f} "
                  f"({short(by)})", flush=True)
        by = device_ms_by_kernel(lambda: fa.fused_relpos_attention_bwd(*ops, g, scale, rate))
        print(f"{label}: row 4 alone device_ms={sum(by.values()):.5f} ({short(by)})",
              flush=True)


def main(argv=None) -> int:
    global _build, fa, smoke
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--package", default=REPO,
                    help="the repo root whose onebit_asr_tpu_torch is timed (default: this one)")
    ap.add_argument("--rows", action="store_true",
                    help="only rows 3 and 4 through their wrappers (no knock-outs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [REPO]  # this checkout's chip_smoke, whatever --package says
    import chip_smoke as smoke
    sys.path[:0] = [os.path.abspath(args.package)]
    from onebit_asr_tpu_torch.ops import _build
    from onebit_asr_tpu_torch.ops import attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"package: {os.path.dirname(os.path.dirname(fa.__file__))}", flush=True)
    if args.rows:
        rows_only()
        return 0
    libs = {"kernels": _build.library(), **build_knockouts()}
    for label, B, H, T, dh, rate in SHAPES:
        ops, g = operands(B, H, T, dh, rate)
        scale, kd = 1.0 / float(np.sqrt(dh)), fa.drop_threshold(rate)
        plan = fa.launch_plan(B, H, T, dh)
        print(f"{label} B={B} H={H} T={T} dh={dh} rate={rate}: plan {plan}", flush=True)
        out = torch.empty_like(ops[0])
        stats = [torch.empty((B, H, T), dtype=torch.float32, device="cuda") for _ in range(2)]
        outs = [torch.empty_like(ops[0]) for _ in range(3)]
        outs += [torch.empty_like(ops[3]), torch.empty_like(ops[4]), torch.empty_like(ops[5])]
        ws = torch.empty(plan["workspace_floats"], dtype=torch.float32, device="cuda")
        for name, lib in libs.items():
            serve = device_ms_by_kernel(lambda: fwd(lib, ops, out, None, scale, kd))
            train = device_ms_by_kernel(lambda: fwd(lib, ops, out, stats, scale, kd))
            line = (f"  {name}: row 3 serving form device_ms={sum(serve.values()):.5f}, "
                    f"training form {sum(train.values()):.5f}")
            if label != "serving":
                fwd(libs["kernels"], ops, out, stats, scale, kd)  # the real statistics
                b4 = device_ms_by_kernel(lambda: bwd(lib, ops, g, stats, outs, ws, scale, kd))
                a4 = device_ms_by_kernel(lambda: bwd(lib, ops, g, None, outs, ws, scale, kd))
                line += (f"; row 4 on the row statistics device_ms={sum(b4.values()):.5f} "
                         f"({short(b4)}), alone {sum(a4.values()):.5f}")
            print(line, flush=True)
        del ws, outs, ops
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

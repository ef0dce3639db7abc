#!/usr/bin/env python3
"""Where the CTC lattice kernels' device time goes, on one NVIDIA card.

    python3 scripts/ctc_probe.py [--package DIR] [--rows]

On chip_smoke.py's two timed lattice cases, the train step's shape (the
three branches of B=16 in one launch: B=48, T=256, S=97) and LibriSpeech's
ceiling (B=16, T=512, S=457), with the loss's operands (int64 lengths, a
bool mask), it prints the device time per launch (torch.profiler) of

- rows 7 and 8, the alpha and beta kernels (`ctc_alpha`, `ctc_beta`), and
  the time per step of their recursion (ms / (T-1));
- builds of onebit_asr_tpu_torch/csrc/ctc_lattice.cu compiled here from
  patched copies: two other layouts, which stay right, `k2` and `k4` (2 or
  4 states a lane up to S = 1,024, on half or a quarter of the warps),
  `alphaunroll2` (alpha's time loop unrolled by 2, as beta's is) and
  `betaunroll1` (beta's not unrolled), and the knock-outs `noload` (no emission fetch: no cp.async copy and no
  wait), `noexp` (expf replaced by the identity), `nolog` (logf replaced by
  the identity), `nostore` (no lattice store: the store stays behind a test
  that no value passes, so the recursion is not removed) and `noexchange`
  (no shuffle and no warp-boundary barrier: each lane takes its own states
  as neighbours).
  A knock-out's results are wrong by design: only its time is read, and
  since it feeds other values onward, it is a hint, not a measurement of
  one part.

The patches match the source's text and fail loudly when it changes.
Builds go to onebit_asr_tpu_torch/_build/probe/ (gitignored).

--rows prints only rows 7 and 8 through their Python wrappers, which works
on any checkout of the port: with --package DIR it times the
onebit_asr_tpu_torch of the repo root DIR (an earlier commit unpacked
there) instead of this one's, so that two versions compare in one run. It
prints each call's device time and, where a wrapper launches more than the
lattice kernel (an earlier checkout converts the lengths and the mask
first), the lattice kernel's own.
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
_build = cl = smoke = None  # the package's modules and chip_smoke, imported in main()

# (label, B, T, U, V, longest length): chip_smoke.ctc_kernel_phase's cases
CASES = [("path", 48, 256, 48, 5004, 255), ("ceiling", 16, 512, 228, 5004, 400)]
SOURCE = "ctc_lattice.cu"
PATCHES = {
    # other layouts up to S = 1,024: 2 states a lane on up to 16 warps, 4 on up to 8
    "k2": [("  if (S <= 1024) return {1, (S + 31) / 32};",
            "  if (S <= 1024) return {2, (S + 63) / 64};"),
           ("    default: kernel =",
            "    case 2: kernel = beta ? ctc_beta_kernel<2> : ctc_alpha_kernel<2>; break;\n"
            "    default: kernel =")],
    "k4": [("  if (S <= 1024) return {1, (S + 31) / 32};",
            "  if (S <= 1024) return {4, (S + 127) / 128};"),
           ("    default: kernel =",
            "    case 4: kernel = beta ? ctc_beta_kernel<4> : ctc_alpha_kernel<4>; break;\n"
            "    default: kernel =")],
    # alpha's time loop unrolled by 2, as beta's is; beta's not unrolled
    "alphaunroll2": [("  for (int t = 1; t < rows; ++t) {\n    float p1, p2;",
                      "#pragma unroll 2\n  for (int t = 1; t < rows; ++t) {\n    float p1, p2;")],
    "betaunroll1": [("#pragma unroll 2\n  for (int i = 0; i < rows - 1; ++i) {",
                     "  for (int i = 0; i < rows - 1; ++i) {")],
    "noload": [
        ("""    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n"
                 :: "r"(smem_u32(slot + s)), "l"(src), "r"(s < S ? 4 : 0) : "memory");""",
         "    (void)slot, (void)src;"),
        ("""  asm volatile("cp.async.wait_group %0;\\n" :: "n"(N) : "memory");""", "")],
    "noexp": [("__device__ __forceinline__ float lat_exp(float x) { return expf(x); }",
               "__device__ __forceinline__ float lat_exp(float x) { return x; }")],
    "nolog": [("__device__ __forceinline__ float lat_log(float x) { return logf(x); }",
               "__device__ __forceinline__ float lat_log(float x) { return x; }")],
    "nostore": [("    if (s0 + k < S) row[s0 + k] = v[k];",
                 "    if (s0 + k < S && __float_as_uint(v[k]) == 0x7fc00001u) row[s0 + k] = v[k];")],
    "noexchange": [
        ("float lane_up(float v, int d) { return __shfl_up_sync(FULL, v, d); }",
         "float lane_up(float v, int d) { return v; }"),
        ("float lane_down(float v, int d) { return __shfl_down_sync(FULL, v, d); }",
         "float lane_down(float v, int d) { return v; }"),
        ("""  asm volatile("bar.sync 1, %0;\\n" :: "r"(nwarps * 32) : "memory");""",
         "  (void)nwarps;")],
}
ENTRIES = ("ctc_alpha_fwd", "ctc_beta_bwd")


def build_patched() -> dict:
    """{name: ctypes library} of each patched build, all nvcc runs at once."""
    out_dir = _build.BUILD_DIR / "probe"
    text = (_build.CSRC_DIR / SOURCE).read_text()
    procs = {}
    for name, patches in PATCHES.items():  # every patch applies before any build starts
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {SOURCE} no longer has the text to patch:\n{old}")
            src = src.replace(old, new)
        d = out_dir / f"ctc_{name}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / SOURCE).write_text(src)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"ctc_{name}" / "lib.so"))
        for fn in ENTRIES:
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def cases():
    """(label, case) of chip_smoke's path and ceiling lattice cases, drawn
    as chip_smoke draws them (seed 0)."""
    rng = np.random.default_rng(0)
    for label, *shape in CASES:
        yield label, smoke._lattice_case(rng, *shape, torch.device("cuda"))


def launch(lib, entry, c, init, out):
    B, T, S = c["emit"].shape
    err = getattr(lib, entry)(c["emit"].data_ptr(), c["lens"].data_ptr(),
                              int(c["lens"].dtype == torch.int64), c["skip"].data_ptr(),
                              init.data_ptr(), out.data_ptr(), B, T, S, c["emit"].device.index,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"probe {entry}")


def rows_only() -> None:
    """Device ms per call of rows 7 and 8 through the package's wrappers."""
    for label, c in cases():
        B, T, S = c["emit"].shape
        for name, fn, init in (("row 7 ctc_alpha", cl.ctc_alpha, "alpha0"),
                               ("row 8 ctc_beta", cl.ctc_beta, "beta0")):
            ops = (c["emit"], c["lens"], c["skip"], c[init])
            ms, per = smoke.device_ms(lambda: fn(*ops), per_kernel=True)
            own = [v for k, v in per.items() if fn.__name__ + "_kernel" in k]
            print(f"{label} B={B} T={T} S={S}: {name} device_ms={ms:.5f} per call "
                  f"({len(per)} kernels; the lattice kernel {own[0]:.5f}, "
                  f"{own[0] / (T - 1) * 1e3:.4f} us a step)", flush=True)


def main(argv=None) -> int:
    global _build, cl, smoke
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--package", default=REPO,
                    help="the repo root whose onebit_asr_tpu_torch is timed (default: this one)")
    ap.add_argument("--rows", action="store_true",
                    help="only rows 7 and 8 through their wrappers (no patched builds)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ctc_probe: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [REPO]  # this checkout's chip_smoke, whatever --package says
    import chip_smoke as smoke
    sys.path[:0] = [os.path.abspath(args.package)]
    from onebit_asr_tpu_torch.ops import _build
    from onebit_asr_tpu_torch.ops import ctc_lattice as cl

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"package: {os.path.dirname(os.path.dirname(cl.__file__))}", flush=True)
    if args.rows:
        rows_only()
        return 0
    libs = {"kernels": _build.library(), **build_patched()}
    for label, c in cases():
        B, T, S = c["emit"].shape
        print(f"{label} B={B} T={T} S={S}: plan {cl.launch_plan(S)}", flush=True)
        out = torch.empty_like(c["emit"])
        ref = {}
        for name, lib in libs.items():
            line = f"  {name}:"
            for entry, init in zip(ENTRIES, ("alpha0", "beta0")):
                ms, _ = smoke.device_ms(lambda: launch(lib, entry, c, c[init], out))
                ref.setdefault(entry, out.clone())  # the unpatched build's lattice
                line += (f" {entry} device_ms={ms:.5f} ({ms / (T - 1) * 1e3:.4f} us a step, "
                         f"{'the same' if torch.equal(out, ref[entry]) else 'other'} bits)")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the packed-ternary kernels' device time goes, on one NVIDIA card.

    python3 scripts/ternary_matmul_probe.py

For each (M, K, N) of a Conformer-M serving forward at B=8, 16 s it prints
the device time per call (torch.profiler) of

- `ternary_matmul_bf16` and `ternary_matmul_w2a8` at every tiling the
  kernels take (rows per CTA 16/32/64 and the split of N; W2A8 takes 16 or
  32 rows), the plan's choice marked, beside torch.matmul on the dense bf16
  weight;
- knock-out builds of onebit_asr_tpu_torch/csrc/ternary_matmul.cu at the
  plan's tiling, compiled here from patched copies: `nomma` (no mma
  instruction; its operands stay live), `nodecode` (the weight bytes go to
  the mma unconverted), `nowait` (no cp.async wait; the barriers stay).
  Their results are wrong by design: only their time is read.

The knock-out patches match the source's text and fail loudly when it
changes. Builds go to onebit_asr_tpu_torch/_build/probe/ (gitignored).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from onebit_asr_tpu_torch.ops import _build  # noqa: E402
from onebit_asr_tpu_torch.ops import ternary_matmul as tm  # noqa: E402

SHAPES = [(4096, 256, 1024, 24), (4096, 1024, 256, 24), (4096, 256, 256, 48), (1023, 256, 256, 12)]
KNOCKOUTS = {
    "nomma": [(
        """      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}""",
        """      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}"""), (
        """                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16""",
        """                                    const uint32_t (&b)[2]) {
#ifdef KNOCKOUT
  asm volatile("" : "+f"(d[0]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
  asm volatile(
      "mma.sync.aligned.m16n8k16"""), (
        """      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}""",
        """      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}"""), (
        """                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32""",
        """                                    const uint32_t (&b)[2]) {
#ifdef KNOCKOUT
  asm volatile("" : "+r"(d[0]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
  asm volatile(
      "mma.sync.aligned.m16n8k32""")],
    "nodecode": [(
        "        b[0] = (((w0[nt] >> (2 * j)) & 0x03030303u) + 0x7f7f7f7fu) ^ 0x80808080u;\n"
        "        b[1] = (((w1[nt] >> (2 * j)) & 0x03030303u) + 0x7f7f7f7fu) ^ 0x80808080u;",
        "        b[0] = w0[nt] + j;\n        b[1] = w1[nt] - j;"), (
        "        b[0] = __byte_perm(0x003f00bfu, 0x00800080u, sel);\n"
        "        b[1] = __byte_perm(0x003f00bfu, 0x00800080u, sel >> 16);",
        "        b[0] = sel;\n        b[1] = sel >> 16;")],
    "nowait": [("    cp_async_wait(AHEAD - 1);  // step g has landed\n", "")],
}


def build_knockouts() -> dict:
    src = (_build.CSRC_DIR / "ternary_matmul.cu").read_text()
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in KNOCKOUTS.items():
        s = src
        for old, new in patches:
            if s.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has the text to patch:\n{old}")
            s = s.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(s)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DKNOCKOUT", "-shared", "-o",
             str(out_dir / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn in ("ternary_matmul_bf16", "ternary_matmul_w2a8"):
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(fn, iters: int = 20) -> float:
    """Device ms per call: chip_smoke's device_ms (torch.profiler), each
    kernel's mean duration times its launches per call."""
    return chip_smoke.device_ms(fn, iters=iters)[0]

def launch(lib, int8, x, packed, alpha, out, mt=0, nsplit=0):
    M, K = x.shape
    N = packed.shape[1]
    args = (packed.data_ptr(), alpha.data_ptr(), out.data_ptr(), M, K, N, mt, nsplit,
            tm._flags(x, packed), x.device.index, torch.cuda.current_stream().cuda_stream)
    err = (lib.ternary_matmul_w2a8(x.data_ptr(), 0, *args) if int8
           else lib.ternary_matmul_bf16(x.data_ptr(), *args))
    _build.check(err, "probe launch")


def main() -> int:
    if not torch.cuda.is_available():
        print("ternary_matmul_probe: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib = _build.library()
    knockouts = build_knockouts()
    rng = np.random.default_rng(0)
    for M, K, N, n in SHAPES:
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).cuda()
        x = x.to(torch.bfloat16)
        packed = tm.pack_planar(torch.from_numpy(
            rng.integers(-1, 2, size=(K, N)).astype(np.float32))).cuda()
        alpha = torch.tensor(0.05, device="cuda")
        w = tm.unpack_planar(packed).to(torch.bfloat16)
        out = torch.empty(M, N, device="cuda")
        print(f"{M}x{K}x{N} x{n}/forward: torch.matmul device_ms="
              f"{device_ms(lambda: torch.matmul(x, w)):.5f}", flush=True)
        tiles_n = -(-N // 128)
        for int8 in (False, True):
            kind = "w2a8" if int8 else "bf16"
            plan = tm.launch_plan(int8, M, K, N)
            for mt in ((1, 2) if int8 else (1, 2, 4)):
                for ns in sorted({1, 2, 4, tiles_n} & set(range(1, tiles_n + 1))):
                    ms = device_ms(lambda: launch(lib, int8, x, packed, alpha, out, mt, ns))
                    mark = " <- plan" if (16 * mt, ns) == (plan["bm"], plan["nsplit"]) else ""
                    print(f"  {kind} rows/CTA {16 * mt} split {ns} CTAs "
                          f"{-(-M // (16 * mt)) * ns}: device_ms={ms:.5f}{mark}", flush=True)
            times = " ".join(
                f"{name}={device_ms(lambda: launch(k, int8, x, packed, alpha, out)):.5f}"
                for name, k in knockouts.items())
            print(f"  {kind} at the plan, knock-outs: {times}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

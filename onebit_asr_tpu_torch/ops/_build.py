"""Build the package's CUDA sources with nvcc and load them with ctypes.

`library()` compiles every `csrc/*.cu` (which may include `csrc/*.cuh`) into
one shared library with a plain C interface at first use, into `_build/`
beside this package (listed in .gitignore), and loads it: one `nvcc` per
source, all started together, then one link. The library's name carries a
hash of the sources, headers and flags, so an edited source or header is
rebuilt and an unchanged one is reused. Nothing is built or loaded when the
module is imported.

Every C entry but the workspace query returns `cudaGetLastError()` after its
launch; `check` turns a non-zero code into a RuntimeError with CUDA's own
message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argument types of every C entry in csrc/
SIGNATURES = {
    # x, packed, alpha, out, M, K, N, mt, nsplit, flags, device, stream
    "ternary_matmul_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, x_f32, packed, alpha, out, M, K, N, mt, nsplit, flags, device, stream
    "ternary_matmul_w2a8": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # int8, M, K, N, device, out[4] (MT, CTAs along N, CTAs, shared bytes)
    "ternary_matmul_plan": (_I, _I, _I, _I, _I, _P),
    # x, w1, b1, w2, b2, y, B, T, F, C, r2 (0: the plan's), device, stream
    "fused_subsample_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, p, u, vb, key_mask, drop8, out, stat_m, stat_l (both null:
    # no statistics), B, H, T, dh, scale, drop_k, drop_scale, device, stream
    "fused_relpos_attention_fwd": (_P,) * 11 + (_I, _I, _I, _I, _F, _I, _F, _I, _P),
    # q, k, v, p, u, vb, key_mask, drop8, g, stat_m, stat_l (both null: the
    # backward computes them), dq, dk, dv, dp, du, dvb, workspace,
    # workspace_floats, B, H, T, dh, scale, drop_k, drop_scale, device, stream
    "fused_relpos_attention_bwd": (_P,) * 18 + (ctypes.c_longlong, _I, _I, _I, _I, _F, _I,
                                                _F, _I, _P),
    # B, H, T, dh, out[6] (tiles, forward-family threads and shared bytes,
    # backward threads and shared bytes, backward workspace floats)
    "fused_relpos_attention_plan": (_I, _I, _I, _I, _P),
    # x, w1, b1, w2, b2, g, dx, dw1, db1, dw2, db2, workspace,
    # workspace_floats, B, T, F, C, device, stream
    "fused_subsample_bwd": (_P,) * 12 + (ctypes.c_longlong, _I, _I, _I, _I, _I, _P),
    # x, w1, b1, w2, b2, g, gm, B, T, F, C, r2 (0: the plan's), device, stream
    "fused_subsample_bwd_mask": (_P,) * 7 + (_I, _I, _I, _I, _I, _I, _P),
    # B, T, F, C -> workspace floats (-1: shapes it does not take)
    "fused_subsample_bwd_workspace": (_I, _I, _I, _I),
    # B, T, F, C, out[15] (the passes' tilings, CTAs, shared bytes; workspace)
    "fused_subsample_plan": (_I, _I, _I, _I, _P),
    # emit, lens, lens_64 (int64 lengths: 1), skip, init, out, B, T, S, device, stream
    "ctc_alpha_fwd": (_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    "ctc_beta_bwd": (_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    # S, out[3] (states a lane, warps an utterance, shared bytes)
    "ctc_lattice_plan": (_I, _P),
}
# entries that return something other than a CUDA error code
RESTYPES = {"fused_subsample_bwd_workspace": ctypes.c_longlong}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "onebit_asr_tpu_torch are compiled at first use"
        )
    return found


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [*srcs, *headers()]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds) -> str:
    """Run the commands in parallel; their output, or RuntimeError naming
    the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into _build/ unless an up-to-date library is there;
    returns its path. With `verbose`, nvcc reports each kernel's registers
    and shared memory (-Xptxas -v) on stdout."""
    srcs = sources()
    target = BUILD_DIR / f"libonebit_kernels_{_digest(srcs)}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, f"{src.stem}.o") for src in srcs]
        out = _run([[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                     "-c", "-o", obj, str(src)] for src, obj in zip(srcs, objs)])
        tmp = os.path.join(work, target.name)
        out += _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        if verbose:
            print(out, flush=True)
        os.replace(tmp, target)  # atomic: a concurrent build never sees a torn file
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            lib.onebit_cuda_error_string.argtypes = [ctypes.c_int]
            lib.onebit_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = library().onebit_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

"""Build the package's CUDA sources with nvcc and load them with ctypes.

`library()` compiles every `csrc/*.cu` into one shared library with a plain C
interface at first use, into `_build/` beside this package (listed in
.gitignore), and loads it. The library's name carries a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built or loaded when the module is imported.

Every C entry returns `cudaGetLastError()` after its launch; `check` turns a
non-zero code into a RuntimeError with CUDA's own message.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argument types of every C entry in csrc/
SIGNATURES = {
    # x, packed, alpha, out, M, K, N, vec, device, stream
    "ternary_matmul_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # xq, scale, packed, alpha, out, M, K, N, vec, device, stream
    "ternary_matmul_w2a8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w1, b1, w2, b2, y, B, T, F, C, device, stream
    "fused_subsample_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

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


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into _build/ unless an up-to-date library is there;
    returns its path. With `verbose`, nvcc reports each kernel's registers
    and shared memory (-Xptxas -v) on stdout."""
    srcs = sources()
    target = BUILD_DIR / f"libonebit_kernels_{_digest(srcs)}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
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
                fn.restype = ctypes.c_int
            lib.onebit_cuda_error_string.argtypes = [ctypes.c_int]
            lib.onebit_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = library().onebit_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

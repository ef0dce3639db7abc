"""The host prefix beam in C++, built at first use.

Own copy of onebit_asr_tpu/native/__init__.py. `native/beam.cpp` beside this
file implements the algorithm of decode/beam.py + decode/lm.py behind a C
ABI; `get_lib()` compiles it with g++ into `onebit_asr_tpu_torch/_build/`
(gitignored; the file name carries the source's hash, so an edit rebuilds)
and binds it with ctypes. A failed build raises with g++'s stderr: a caller
that asked for the native beam never gets the Python one in its place (the
JAX copy returns None and falls back quietly). The Python beam stays
callable as the plain version (`ctc_beam_search_batch(prefer_native=False)`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "beam.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _build_and_load() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD, exist_ok=True)
    so = os.path.join(_BUILD, f"libonebit_beam_{tag}.so")
    if not os.path.exists(so):
        tmp = f"{so}.tmp{os.getpid()}"
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
            capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.onebit_lm_create.restype = ctypes.c_void_p
    lib.onebit_lm_create.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
    ]
    lib.onebit_lm_free.argtypes = [ctypes.c_void_p]
    lib.onebit_ctc_beam_search.restype = ctypes.c_int32
    lib.onebit_ctc_beam_search.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,  # log_probs, T, V
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # blank, beam, topk
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float,  # lm, w, bonus
        ctypes.c_void_p, ctypes.c_int32,  # out, max_out
    ]
    return lib


def get_lib() -> ctypes.CDLL:
    """The compiled host library, built on the first call; raises when it
    cannot be built."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _build_and_load()
    return _LIB


class NativeLM:
    """C++-side handle of a decode.lm.NGramLM, built once and reused across
    utterances."""

    def __init__(self, lm):
        lib = get_lib()
        keys, vals = [], []
        for n in range(1, lm.order + 1):
            for k, v in lm.counts[n].items():
                keys.append((n,) + k + (0,) * (lm.order - n))
                vals.append(v)
        karr = (np.asarray(keys, np.int64) if keys
                else np.zeros((0, lm.order + 1), np.int64))
        varr = np.asarray(vals, np.int64)
        self._lib = lib
        self._handle = lib.onebit_lm_create(
            karr.ctypes.data_as(ctypes.c_void_p), varr.ctypes.data_as(ctypes.c_void_p),
            np.int64(len(varr)), np.int32(lm.order), np.int64(lm.total),
        )

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.onebit_lm_free(self._handle)
            self._handle = None


def ctc_beam_search_native(
    log_probs: np.ndarray,  # [T, V] float32
    beam_size: int = 10,
    blank_id: int = 3,
    top_k_per_t: int = 20,
    native_lm: Optional[NativeLM] = None,
    lm_weight: float = 0.0,
    length_bonus: float = 0.0,
) -> List[int]:
    """Best label sequence of one utterance (decode/beam.py::ctc_beam_search)."""
    lib = get_lib()
    lp = np.ascontiguousarray(log_probs, np.float32)
    T, V = lp.shape
    out = np.zeros((T,), np.int32)
    n = lib.onebit_ctc_beam_search(
        lp.ctypes.data_as(ctypes.c_void_p), np.int32(T), np.int32(V),
        np.int32(blank_id), np.int32(beam_size), np.int32(top_k_per_t),
        (native_lm._handle if native_lm is not None else None),
        np.float32(lm_weight), np.float32(length_bonus),
        out.ctypes.data_as(ctypes.c_void_p), np.int32(T),
    )
    return out[:n].tolist()

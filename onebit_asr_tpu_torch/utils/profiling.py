"""Profiling and numerics debugging.

Counterpart of onebit_asr_tpu/utils/profiling.py:

- `trace(dir)`: a torch.profiler context (host ops, and the card's kernels
  and copies when CUDA is available) that writes a Chrome trace,
  `dir/trace.json`, on exit;
- `StepTimer`: steady-state throughput, synchronizing the card before it
  reads the clock;
- `debug_nans(enable)`: autograd's anomaly mode, which raises where a
  backward makes a NaN (the train CLI's `--debug_nans`);
- `host_rss_gb` and `malloc_trim`: the host's resident set, and glibc's
  retained heap pages given back, once an epoch in the train CLI.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace(dir): ...` writes `dir/trace.json` (chrome://tracing,
    Perfetto) of what ran inside."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def debug_nans(enable: bool = True) -> None:
    """Raise where a backward produces a NaN (autograd anomaly detection)."""
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Steady-state throughput: .start() after warm-up, .stop(result) waits
    for the card to finish `result` (all its queued work) and returns the
    elapsed seconds."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.elapsed: float = 0.0
        self.count: int = 0

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def stop(self, result, n: int = 1) -> float:
        del result  # its work is queued on the card: wait for all of it
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self.t0
        self.elapsed += dt
        self.count += n
        return dt

    def per_sec(self) -> float:
        return self.count / self.elapsed if self.elapsed else 0.0


def host_rss_gb() -> float:
    """The host resident set in GiB (VmRSS of /proc/self/status; nan where
    that file does not exist)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / (1024.0 * 1024.0)
    except OSError:  # pragma: no cover - not Linux
        pass
    return float("nan")


def malloc_trim() -> bool:
    """Give freed heap pages that glibc retains back to the OS
    (malloc_trim(0)); False where libc lacks the symbol."""
    try:
        import ctypes

        return bool(ctypes.CDLL("libc.so.6", use_errno=True).malloc_trim(0))
    except Exception:  # pragma: no cover - not glibc
        return False

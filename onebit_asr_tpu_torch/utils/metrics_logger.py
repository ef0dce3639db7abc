"""Metrics logging: one JSON object per logged epoch in `metrics.jsonl` of
the run directory (onebit_asr_tpu/utils/metrics_logger.py without wandb,
which is not ported and is refused by the CLI)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, payload: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"ts": time.time(), **payload}
        if step is not None:
            rec["step"] = int(step)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

"""Checkpoints of the train state in the port's own format.

Counterpart of onebit_asr_tpu/utils/checkpoint.py (Orbax there): the whole
TrainState (parameters, moments, count, step, the generator's state) goes
into one `torch.save` file per saved step, `<directory>/step_<n>.pt`, so a
run resumes where it stopped. `save_config` writes the config.json that the
JAX package's `train_config_from_json` reads too; `load_config` reads it
back, and `restore_params` reads the parameters alone of a saved step (no
optimizer, no model), which is what serving and evaluation need.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import torch

from onebit_asr_tpu_torch.train.state import TrainState
from onebit_asr_tpu_torch.utils.config import TrainConfig, config_to_json, train_config_from_json

_STEP = re.compile(r"step_(\d+)\.pt$")


class CheckpointManager:
    """save/restore TrainState under `directory`, keeping the newest
    `max_to_keep` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _STEP.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, metrics: Optional[dict] = None) -> None:
        latest = self.latest_step()
        if latest is not None and state.step <= latest:
            print(f"WARNING: not saving step {state.step} — {self.directory} already holds "
                  f"step {latest} (stale run directory? use a fresh --run_name)")
            return
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
        payload = {"step": state.step, "count": state.count, "params": cpu(state.params),
                   "mu": cpu(state.mu), "nu": cpu(state.nu),
                   "generator": state.generator.get_state(), "metrics": metrics or {}}
        path = os.path.join(self.directory, f"step_{state.step}.pt")
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"step_{old}.pt"))

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Copy a saved step (the newest by default) into `state`'s own
        tensors, in place, and return it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        saved = torch.load(os.path.join(self.directory, f"step_{step}.pt"), weights_only=True)
        with torch.no_grad():
            for name in ("params", "mu", "nu"):
                own = getattr(state, name)
                if set(own) != set(saved[name]):
                    raise ValueError(f"checkpoint {name} do not match the model's")
                for k, v in saved[name].items():
                    own[k].copy_(v)
        state.step, state.count = int(saved["step"]), int(saved["count"])
        state.generator.set_state(saved["generator"])
        return state


def save_config(directory: str, cfg: TrainConfig) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        f.write(config_to_json(cfg))


def load_config(run_dir: str) -> Optional[TrainConfig]:
    """The run's config.json as a TrainConfig, or None when there is none."""
    path = os.path.join(run_dir, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return train_config_from_json(f.read())


def restore_params(ckpt_dir: str, step: Optional[int] = None
                   ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """(step, {state-dict name: CPU tensor}) of the parameters saved at `step`
    under `ckpt_dir` (the newest by default); the moments and the generator
    are not read."""
    if step is None:
        files = os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []
        step = max((int(m.group(1)) for f in files if (m := _STEP.match(f))), default=None)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    saved = torch.load(os.path.join(ckpt_dir, f"step_{step}.pt"), map_location="cpu",
                       weights_only=True)
    return int(saved["step"]), saved["params"]

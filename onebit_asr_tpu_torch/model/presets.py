"""Model family presets (onebit_asr_tpu/model/presets.py)."""

from __future__ import annotations

import dataclasses

from onebit_asr_tpu_torch.utils.config import ModelConfig

PRESETS = {
    # Conformer-S: paper table 1 (d=144, 16 layers, 4 heads), d_ff = 4d
    "s": dict(enc_d_model=144, enc_layers=16, enc_heads=4, enc_d_ff=576),
    # Conformer-M: the reference default
    "m": dict(enc_d_model=256, enc_layers=12, enc_heads=4, enc_d_ff=1024),
    # Conformer-L: paper table 1 (d=512, 17 layers, 8 heads)
    "l": dict(enc_d_model=512, enc_layers=17, enc_heads=8, enc_d_ff=2048),
}


def apply_preset(cfg: ModelConfig, preset: str) -> ModelConfig:
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; choose from {sorted(PRESETS)}")
    return dataclasses.replace(cfg, **PRESETS[preset])

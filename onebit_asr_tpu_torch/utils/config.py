"""Configuration of the serving path: own copies of the JAX package's
dataclasses (onebit_asr_tpu/utils/config.py), holding the fields this package
reads under the same names.

`train_config_from_json` reads the `config.json` a JAX training run writes
and keeps the fields known here; every other field is ignored.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class SpecialTokens:
    """Model-side ids: 4 reserved in front of the subword vocabulary."""

    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    blank_id: int = 3
    offset: int = 4  # subword id -> model id shift


@dataclass(frozen=True)
class FrontendConfig:
    """Kaldi-compatible log-mel fbank."""

    sample_rate: int = 16000
    num_mel_bins: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemphasis: float = 0.97
    low_freq: float = 20.0
    high_freq: float = 0.0  # 0 -> nyquist
    remove_dc: bool = True


@dataclass(frozen=True)
class ModelConfig:
    """Conformer CTC model (defaults: Conformer-M, the reference default)."""

    input_dim: int = 80
    vocab_size: int = 5004
    enc_d_model: int = 256
    enc_layers: int = 12
    enc_heads: int = 4
    enc_d_ff: int = 1024
    enc_conv_kernel: int = 31
    specials: SpecialTokens = field(default_factory=SpecialTokens)
    compute_dtype: str = "bfloat16"
    # read only to refuse what this package does not implement yet
    conv_norm: str = "batch_norm"
    quant_per_channel: bool = False
    causal_conv: bool = False
    attn_chunk_size: Optional[int] = None
    time_pad_multiple: int = 128  # pad the subsampled time axis to a
    # multiple of this when it exceeds half of it; 1 disables
    fused_attention: bool = False  # read to refuse: the fused rel-pos
    # attention kernel is not ported yet (serve with --no_fused_kernels)
    fused_subsampler: bool = False  # conv1 -> ReLU -> conv2 -> ReLU as one
    # CUDA kernel (ops/subsampler.py), conv1 in f32 as the JAX kernel does


@dataclass(frozen=True)
class DataConfig:
    max_frames: int = 1600  # longest utterance in frames (16 s at 10 ms)


@dataclass(frozen=True)
class TrainConfig:
    """The parts of a JAX run's config that serving needs."""

    model: ModelConfig = field(default_factory=ModelConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    data: DataConfig = field(default_factory=DataConfig)


def _from_dict(cls, d: Dict[str, Any]):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = _NESTED.get((cls.__name__, f.name))
        kwargs[f.name] = _from_dict(sub, v) if sub is not None else v
    return cls(**kwargs)


_NESTED = {
    ("ModelConfig", "specials"): SpecialTokens,
    ("TrainConfig", "model"): ModelConfig,
    ("TrainConfig", "frontend"): FrontendConfig,
    ("TrainConfig", "data"): DataConfig,
}


def train_config_from_json(s: str) -> TrainConfig:
    return _from_dict(TrainConfig, json.loads(s))


def config_to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)

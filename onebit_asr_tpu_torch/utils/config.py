"""Configuration: own copies of the JAX package's dataclasses
(onebit_asr_tpu/utils/config.py), holding the fields this package reads
under the same names and defaults, so that a `config.json` written by either
package is read by the other.

`FrontendConfig` and `DataConfig` hold every field of JAX's, with its names
and defaults; `ModelConfig` and `LossConfig` every field that changes what
the model computes. `train_config_from_json` keeps the fields known here;
every other field is ignored (the JAX model's `remat_blocks`,
`remat_policy`, `scan_unroll` and `split_qkv`, the train config's
`mesh_shape` and `mesh_axes`: compile, memory and parallelism knobs, which
change no result here), and a missing one takes its default (as the JAX
reader does).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class SpecialTokens:
    """Model-side ids: 4 reserved in front of the subword vocabulary."""

    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    blank_id: int = 3
    offset: int = 4  # subword id -> model id shift

    def as_dict(self) -> Dict[str, int]:
        return {"pad_id": self.pad_id, "bos_id": self.bos_id, "eos_id": self.eos_id,
                "blank_id": self.blank_id}


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
    dither: float = 0.0  # amplitude of N(0, 1) noise per frame, training only
    remove_dc: bool = True
    window: str = "povey"  # read by neither package: the window is povey
    # SpecAugment (ops/specaugment.py), training only
    spec_augment: bool = True
    freq_mask_param: int = 27
    num_freq_masks: int = 2
    time_mask_param: int = 100
    num_time_masks: int = 2
    time_mask_ratio: float = 0.3  # cap each time mask at ratio * true length


@dataclass(frozen=True)
class ModelConfig:
    """Conformer CTC + attention model (defaults: Conformer-M, the reference
    default)."""

    input_dim: int = 80
    vocab_size: int = 5004
    enc_d_model: int = 256
    enc_layers: int = 12
    enc_heads: int = 4
    enc_d_ff: int = 1024
    enc_conv_kernel: int = 31
    dropout: float = 0.1
    dec_layers: int = 2
    dec_heads: int = 4
    dec_d_ff: int = 1024
    specials: SpecialTokens = field(default_factory=SpecialTokens)
    compute_dtype: str = "bfloat16"  # activations and matmuls; params f32
    conv_norm: str = "batch_norm"  # the conv module's norm: "batch_norm"
    # (masked batch statistics), "group_norm" (masked, per utterance) or
    # "layer_norm" (per frame; the streaming-safe one)
    quant_per_channel: bool = False  # an alpha per output channel of each
    # quantized projection; the packed export needs tensor-wise alpha
    reference_decoder: bool = False  # position-blind embeddings and post-LN
    # decoder layers (pair with LossConfig.reference_smoothing)
    quant_decoder: bool = False  # the decoder's q/k/v/o and ff projections
    # quantized at the branch's base precision; embedding and out stay fp
    fused_attention: bool = False  # the whole rel-pos attention of a block
    # as one CUDA kernel (ops/attention.py), in the JAX kernel's roundings
    fused_subsampler: bool = False  # conv1 -> ReLU -> conv2 -> ReLU as one
    # CUDA kernel (ops/subsampler.py), conv1 in f32 as the JAX kernel does
    causal_conv: bool = False  # the depthwise conv sees only the past
    attn_chunk_size: Optional[int] = None  # chunked attention, in subsampled
    # frames: a frame sees its own chunk and `attn_left_chunks` before it
    attn_left_chunks: int = -1  # -1 = all history
    time_pad_multiple: int = 128  # pad the subsampled time axis to a
    # multiple of this when it exceeds half of it; 1 disables


@dataclass(frozen=True)
class LossConfig:
    """The composite 3-branch QAT loss."""

    gamma_ctc: float = 0.2
    lambda1: float = 0.5  # weight of the 1-bit and stochastic-precision losses
    lambda2: float = 1.0  # weight of the KL terms
    label_smoothing: float = 0.1
    reference_smoothing: bool = False  # eps / (V - 1) to each non-target
    # class and 1 - eps to the target, instead of (1 - eps) onehot + eps / V
    sp_low_p: float = 0.2  # stochastic-precision mask: P(1-bit) of the first
    sp_high_p: float = 0.9  # and of the last layer, log-spaced between


@dataclass(frozen=True)
class DataConfig:
    data_dir: str = "data"
    tokenizer_path: str = "src/data/tokenizer.json"
    cmvn_stats_path: str = "src/data/cmvn_stats.npz"
    vocab_size: int = 5000  # subwords, before the 4 specials
    batch_size: int = 64
    max_frames: int = 1600  # static pad ceiling per bucket (16 s at 10 ms)
    max_tokens: int = 228
    num_buckets: int = 8
    num_workers: int = 2
    cmvn_num_utts: int = 1000


@dataclass(frozen=True)
class OptimConfig:
    """AdamW + warmup-cosine."""

    lr: float = 5e-4
    warmup_steps: int = 4000
    min_lr_ratio: float = 0.1
    betas: Tuple[float, float] = (0.9, 0.98)
    weight_decay: float = 1e-2
    grad_clip_norm: float = 5.0


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    epochs: int = 40
    seed: int = 0
    save_dir: str = "./checkpoints"
    beam_size: int = 10


_NESTED = {
    ("ModelConfig", "specials"): SpecialTokens,
    ("TrainConfig", "model"): ModelConfig,
    ("TrainConfig", "loss"): LossConfig,
    ("TrainConfig", "data"): DataConfig,
    ("TrainConfig", "optim"): OptimConfig,
    ("TrainConfig", "frontend"): FrontendConfig,
}


def _from_dict(cls, d: Dict[str, Any]):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = _NESTED.get((cls.__name__, f.name))
        if sub is not None and isinstance(v, dict):
            kwargs[f.name] = _from_dict(sub, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def train_config_from_json(s: str) -> TrainConfig:
    return _from_dict(TrainConfig, json.loads(s))


def config_to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)

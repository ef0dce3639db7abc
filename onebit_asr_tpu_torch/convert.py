"""JAX parameter trees -> this package's modules.

The JAX package keeps its parameters as a nested dict (a flax tree). Here
such a tree arrives as nested dicts of numpy arrays (or as a flat mapping
with "/"-joined keys, the form an .npz holds) and becomes the state of
`ConformerASR`. Layout facts handled:

- the encoder blocks are stacked: each leaf under encoder/blocks is [L, ...]
  (conformer.py:770-785) and is sliced per layer;
- Dense kernels are [in, out]; PyTorch's weights are [out, in];
- the subsampler convs are HWIO [3, 3, I, O]; PyTorch's are OIHW;
- the depthwise kernel is [k, 1, D]; PyTorch's conv1d weight is [D, 1, k];
- the unfused subsampler output flattens as f*C+c in JAX ([B, T', F', C])
  and as c*F'+f here ([B, C, T', F'] -> [B, T', C*F']), so the rows of the
  projection's kernel are permuted; the fused subsampler flattens f*C+c, as
  JAX does, and keeps them (ModelConfig.fused_subsampler);
- LayerNorm/BatchNorm "scale" is PyTorch's "weight";
- packed quantized dense leaves (packed_kernel, alpha, bias) keep their
  layout: the CUDA kernels read the planar-packed [K/4, N] bytes directly.

The decoder subtree, which serving does not use, is ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from onebit_asr_tpu_torch.model.asr import ConformerASR
from onebit_asr_tpu_torch.model.conformer import subsampled_frames
from onebit_asr_tpu_torch.model.packed import export_packed_params
from onebit_asr_tpu_torch.utils.config import ModelConfig

Tree = Dict[str, Any]


def flatten(tree: Mapping, sep: str = "/", prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {"a/b/c": leaf}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, sep, key))
        else:
            flat[key] = v
    return flat


def unflatten(flat: Mapping[str, Any], sep: str = "/") -> Tree:
    """{"a/b/c": leaf} -> nested dict."""
    tree: Tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split(sep)
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def to_torch(tree: Mapping) -> Tree:
    """Nested dict of array-likes -> nested dict of CPU torch tensors
    (copies)."""
    return {
        k: to_torch(v) if isinstance(v, Mapping) else torch.from_numpy(np.array(v))
        for k, v in tree.items()
    }


def load_npz(path: str) -> Tree:
    """An .npz of "/"-joined flax keys -> nested dict of numpy arrays."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def init_params(cfg: ModelConfig, seed: int = 0) -> Tree:
    """A training-form JAX parameter tree of numpy arrays, drawn from `seed`
    with the JAX package's initializer families (quantized kernels
    kaiming-uniform x2 with alpha = mean|W|, lecun-normal dense and conv
    kernels, torch-uniform biases); the norms and biases get small random
    offsets so that a conversion error cannot hide behind ones and zeros.
    The draws are numpy's, not JAX's: equal in distribution only."""
    rng = np.random.default_rng(seed)
    D, L, H = cfg.enc_d_model, cfg.enc_layers, cfg.enc_heads
    dff, k, V = cfg.enc_d_ff, cfg.enc_conv_kernel, cfg.vocab_size
    f32 = np.float32

    def uni(shape, bound):
        return rng.uniform(-bound, bound, size=shape).astype(f32)

    def lecun(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(f32)

    def norm(*lead):
        return {"scale": (1.0 + uni((*lead, D), 0.1)), "bias": uni((*lead, D), 0.1)}

    def quant(fan_in, fan_out):
        kern = uni((L, fan_in, fan_out), np.sqrt(1.0 / fan_in)) * 2.0
        return {
            "kernel": kern,
            "alpha": np.abs(kern).mean(axis=(1, 2)).astype(f32),
            "bias": uni((L, fan_out), 1.0 / np.sqrt(fan_in)),
        }

    def dense(fan_in, fan_out, *lead):
        return {
            "kernel": lecun((*lead, fan_in, fan_out), fan_in),
            "bias": uni((*lead, fan_out), 1.0 / np.sqrt(fan_in)),
        }

    f2 = subsampled_frames(cfg.input_dim)
    blocks = {
        "ff1": {"ln": norm(L), "w1": quant(D, dff), "w2": quant(dff, D)},
        "mhsa": {
            "ln": norm(L),
            **{n: quant(D, D) for n in ("q_proj", "k_proj", "v_proj", "pos_proj", "out_proj")},
            "pos_bias_u": (0.01 * rng.standard_normal((L, H, D // H))).astype(f32),
            "pos_bias_v": (0.01 * rng.standard_normal((L, H, D // H))).astype(f32),
        },
        "conv": {
            "ln": norm(L),
            "pw1": dense(D, 2 * D, L),
            "dw_kernel": lecun((L, k, 1, D), k),
            "bn": norm(L),
            "pw2": dense(D, D, L),
        },
        "ff2": {"ln": norm(L), "w1": quant(D, dff), "w2": quant(dff, D)},
        "ln_out": norm(L),
    }
    return {
        "encoder": {
            "subsample": {
                "conv1": {"kernel": lecun((3, 3, 1, D), 9), "bias": uni((D,), 1 / 3.0)},
                "conv2": {
                    "kernel": lecun((3, 3, D, D), 9 * D),
                    "bias": uni((D,), 1.0 / np.sqrt(9 * D)),
                },
                "proj": dense(f2 * D, D),
            },
            "blocks": blocks,
            "ln_out": norm(),
        },
        "ctc_head": dense(D, V),
    }


def _leaf(name: str, v: torch.Tensor):
    """(torch state key suffix, value) for one JAX leaf of a block."""
    if name == "scale":  # LayerNorm / BatchNorm
        return "weight", v
    if name == "kernel":  # Dense [in, out] -> [out, in]
        return "weight", v.transpose(0, 1)
    if name == "dw_kernel":  # [k, 1, D] -> [D, 1, k]
        return "dw_kernel", v.permute(2, 1, 0)
    return name, v  # bias, packed_kernel, alpha, pos_bias_u/v


def state_dict_from_jax(params: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Serving-form (packed) JAX tree of torch tensors -> ConformerASR's
    state dict."""
    enc = params["encoder"]
    sd: Dict[str, torch.Tensor] = {}
    sub = enc["subsample"]
    for conv in ("conv1", "conv2"):
        sd[f"encoder.subsample.{conv}.weight"] = sub[conv]["kernel"].permute(3, 2, 0, 1)
        sd[f"encoder.subsample.{conv}.bias"] = sub[conv]["bias"]
    C, f2 = cfg.enc_d_model, subsampled_frames(cfg.input_dim)
    proj = sub["proj"]["kernel"]  # rows f*C+c
    if not cfg.fused_subsampler:  # -> c*F'+f, the unfused flatten order
        proj = proj.reshape(f2, C, -1).transpose(0, 1).reshape(C * f2, -1)
    sd["encoder.subsample.proj.weight"] = proj.transpose(0, 1)
    sd["encoder.subsample.proj.bias"] = sub["proj"]["bias"]
    for key, stacked in flatten(enc["blocks"]).items():
        if stacked.shape[0] != cfg.enc_layers:
            raise ValueError(
                f"encoder/blocks/{key}: {stacked.shape[0]} layers, config has {cfg.enc_layers}"
            )
        *path, name = key.split("/")
        for i in range(cfg.enc_layers):
            suffix, value = _leaf(name, stacked[i])
            sd[".".join(["encoder", "blocks", str(i), *path, suffix])] = value
    sd["encoder.ln_out.weight"] = enc["ln_out"]["scale"]
    sd["encoder.ln_out.bias"] = enc["ln_out"]["bias"]
    sd["ctc_head.weight"] = params["ctc_head"]["kernel"].transpose(0, 1)
    sd["ctc_head.bias"] = params["ctc_head"]["bias"]
    return {k: v.contiguous() for k, v in sd.items()}


def packed_model_from_jax(
    cfg: ModelConfig,
    params: Mapping,
    precision: int = 2,
    int8_act: bool = False,
    device: str = "cuda",
) -> ConformerASR:
    """Training-form JAX tree (numpy or torch leaves) -> packed ConformerASR
    on `device`, in eval mode: the weights are projected to `precision`
    (2 = ternary, 1 = binary) and planar-packed (model/packed.py)."""
    tree = to_torch({k: v for k, v in params.items() if k != "decoder"})
    packed = export_packed_params(tree, precision)
    model = ConformerASR(cfg, int8_act=int8_act)
    model.load_state_dict(state_dict_from_jax(packed, cfg), strict=True)
    return model.requires_grad_(False).to(device).eval()

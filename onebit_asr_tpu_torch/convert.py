"""JAX parameter trees -> this package's modules.

The JAX package keeps its parameters as a nested dict (a flax tree). Here
such a tree arrives as nested dicts of numpy arrays (or as a flat mapping
with "/"-joined keys, the form an .npz holds) and becomes the state of
`ConformerASR`, in its serving (packed) or its QAT form. Layout facts
handled:

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
  layout: the CUDA kernels read the planar-packed [K/4, N] bytes directly;
- QAT quantized dense leaves (kernel, alpha, bias) keep theirs too:
  `QATDense` holds its kernel [in, out], as JAX does, in the encoder and in
  a quantized decoder (ModelConfig.quant_decoder) alike; a per-channel
  alpha is [L, N] in the stack and [N] per layer;
- the conv module's norm is "bn", "gn" or "frame_ln" (ModelConfig.conv_norm)
  under the same name on both sides;
- the decoder's layers "layer{i}" are the ModuleList "layers.{i}", its
  embedding [V, D] keeps its layout.

The serving form ignores the decoder subtree unless asked to carry it (the
evaluation of packed weights takes the decoder's loss). The streaming step
(`streaming_step_from_jax`) takes the encoder and CTC head of the same tree,
always with the unfused subsampler's row order. The same mapping
carries any tree of the parameters' shape (the gradients of a JAX step, say)
onto the state dict's names, and `jax_tree_from_state_dict` is its exact
inverse: a run this package trained becomes a JAX-layout tree, which the
serving and evaluation paths take like a JAX run's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from onebit_asr_tpu_torch.model.asr import ConformerASR
from onebit_asr_tpu_torch.model.conformer import subsampled_frames
from onebit_asr_tpu_torch.model.layers import Dense
from onebit_asr_tpu_torch.model.packed import export_packed_params
from onebit_asr_tpu_torch.utils.config import ModelConfig

Tree = Dict[str, Any]

# the JAX parameter name of the conv module's norm, by ModelConfig.conv_norm
CONV_NORM_LEAF = {"batch_norm": "bn", "group_norm": "gn", "layer_norm": "frame_ln"}


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
    The tree follows `cfg`'s options: per-channel alpha (mean |W| over the
    input axis), the conv norm's leaves, the decoder's projections as
    quantized dense leaves under quant_decoder. The draws are numpy's, not
    JAX's: equal in distribution only."""
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

    def quant(fan_in, fan_out, *lead):
        kern = uni((*lead, fan_in, fan_out), np.sqrt(1.0 / fan_in)) * 2.0
        axes = -2 if cfg.quant_per_channel else (-2, -1)
        return {
            "kernel": kern,
            "alpha": np.abs(kern).mean(axis=axes).astype(f32),
            "bias": uni((*lead, fan_out), 1.0 / np.sqrt(fan_in)),
        }

    def dense(fan_in, fan_out, *lead):
        return {
            "kernel": lecun((*lead, fan_in, fan_out), fan_in),
            "bias": uni((*lead, fan_out), 1.0 / np.sqrt(fan_in)),
        }

    def decoder():
        Dd, Vd = cfg.dec_d_ff, V
        emb = rng.standard_normal((Vd, D)).astype(f32)
        emb[cfg.specials.pad_id] = 0.0  # the padding row, zeroed as JAX's init does
        proj = quant if cfg.quant_decoder else dense
        attn = lambda: {n: proj(D, D) for n in ("q", "k", "v", "o")}  # noqa: E731
        tree = {f"layer{i}": {"ln1": norm(), "self_attn": attn(), "ln2": norm(),
                              "cross_attn": attn(), "ln3": norm(),
                              "ff1": proj(D, Dd), "ff2": proj(Dd, D)}
                for i in range(cfg.dec_layers)}
        return {"embedding": emb, **tree, "ln_out": norm(), "out": dense(D, Vd)}

    f2 = subsampled_frames(cfg.input_dim)
    blocks = {
        "ff1": {"ln": norm(L), "w1": quant(D, dff, L), "w2": quant(dff, D, L)},
        "mhsa": {
            "ln": norm(L),
            **{n: quant(D, D, L) for n in ("q_proj", "k_proj", "v_proj", "pos_proj",
                                           "out_proj")},
            "pos_bias_u": (0.01 * rng.standard_normal((L, H, D // H))).astype(f32),
            "pos_bias_v": (0.01 * rng.standard_normal((L, H, D // H))).astype(f32),
        },
        "conv": {
            "ln": norm(L),
            "pw1": dense(D, 2 * D, L),
            "dw_kernel": lecun((L, k, 1, D), k),
            CONV_NORM_LEAF[cfg.conv_norm]: norm(L),
            "pw2": dense(D, D, L),
        },
        "ff2": {"ln": norm(L), "w1": quant(D, dff, L), "w2": quant(dff, D, L)},
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
        "decoder": decoder(),
    }


def _leaf(name: str, v: torch.Tensor, quantized: bool = False):
    """(torch state key suffix, value) for one JAX leaf of a block;
    `quantized`: the leaf belongs to a quantized dense (QATDense)."""
    if name == "scale":  # LayerNorm / BatchNorm
        return "weight", v
    if name == "kernel" and not quantized:  # Dense [in, out] -> [out, in]
        return "weight", v.transpose(0, 1)
    if name == "dw_kernel":  # [k, 1, D] -> [D, 1, k]
        return "dw_kernel", v.permute(2, 1, 0)
    return name, v  # bias, packed_kernel, alpha, pos_bias_u/v


def state_dict_from_jax(params: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX tree of torch tensors, serving form (packed) or training form
    (with its decoder) -> ConformerASR's state dict in the same form."""
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
    blocks = flatten(enc["blocks"])
    quantized = {k.rsplit("/", 1)[0] for k in blocks if k.endswith("/alpha")}
    for key, stacked in blocks.items():
        if stacked.shape[0] != cfg.enc_layers:
            raise ValueError(
                f"encoder/blocks/{key}: {stacked.shape[0]} layers, config has {cfg.enc_layers}"
            )
        *path, name = key.split("/")
        for i in range(cfg.enc_layers):
            suffix, value = _leaf(name, stacked[i], "/".join(path) in quantized)
            sd[".".join(["encoder", "blocks", str(i), *path, suffix])] = value
    sd["encoder.ln_out.weight"] = enc["ln_out"]["scale"]
    sd["encoder.ln_out.bias"] = enc["ln_out"]["bias"]
    sd["ctc_head.weight"] = params["ctc_head"]["kernel"].transpose(0, 1)
    sd["ctc_head.bias"] = params["ctc_head"]["bias"]
    if "decoder" in params:
        dec = flatten(params["decoder"])
        quantized = {k.rsplit("/", 1)[0] for k in dec if k.endswith("/alpha")}
        for key, v in dec.items():
            *path, name = key.split("/")
            suffix, value = _leaf(name, v, "/".join(path) in quantized)
            if path and path[0].startswith("layer"):
                path = ["layers", path[0][len("layer"):], *path[1:]]
            sd[".".join(["decoder", *path, suffix])] = value
    return {k: v.contiguous() for k, v in sd.items()}


def _unleaf(name: str, v: torch.Tensor):
    """Inverse of `_leaf`: (JAX leaf name, value) for one state-dict leaf."""
    if name == "weight" and v.dim() == 1:  # LayerNorm / BatchNorm
        return "scale", v
    if name == "weight":  # Dense [out, in] -> [in, out]
        return "kernel", v.transpose(0, 1)
    if name == "dw_kernel":  # [D, 1, k] -> [k, 1, D]
        return "dw_kernel", v.permute(2, 1, 0)
    return name, v  # bias, kernel/packed_kernel of a quantized dense, alpha, ...


def jax_tree_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Tree:
    """ConformerASR's state dict (serving or training form, with or without
    its decoder) -> the JAX tree it came from, torch leaves on the CPU: the
    exact inverse of `state_dict_from_jax`. The per-layer leaves are stacked
    back into [L, ...], Dense weights turned back to [in, out], OIHW convs to
    HWIO, the depthwise kernel to [k, 1, D], the unfused projection's rows
    back to f*C+c, and "layers.{i}" to "layer{i}"."""
    flat: Dict[str, torch.Tensor] = {}
    blocks: Dict[str, Dict[int, torch.Tensor]] = {}
    C, f2 = cfg.enc_d_model, subsampled_frames(cfg.input_dim)
    for key, v in sd.items():
        *path, name = key.split(".")
        v = v.detach().cpu()
        if path[:2] == ["encoder", "blocks"]:
            leaf, value = _unleaf(name, v)
            blocks.setdefault("/".join([*path[3:], leaf]), {})[int(path[2])] = value
            continue
        if path[:2] == ["encoder", "subsample"] and name == "weight":
            if path[2] == "proj":
                value = v.transpose(0, 1)  # rows c*F'+f unfused, f*C+c fused
                if not cfg.fused_subsampler:
                    value = value.reshape(C, f2, -1).transpose(0, 1).reshape(f2 * C, -1)
            else:
                value = v.permute(2, 3, 1, 0)  # OIHW -> HWIO
            flat["/".join([*path, "kernel"])] = value
            continue
        if path[:2] == ["decoder", "layers"]:
            path = ["decoder", f"layer{path[2]}", *path[3:]]
        leaf, value = _unleaf(name, v)
        flat["/".join([*path, leaf])] = value
    for key, per_layer in blocks.items():
        if sorted(per_layer) != list(range(cfg.enc_layers)):
            raise ValueError(f"encoder/blocks/{key}: layers {sorted(per_layer)}, "
                             f"config has {cfg.enc_layers}")
        flat[f"encoder/blocks/{key}"] = torch.stack([per_layer[i] for i in sorted(per_layer)])
    return unflatten({k: v.contiguous() for k, v in flat.items()})


def packed_model_from_jax(
    cfg: ModelConfig,
    params: Mapping,
    precision: int = 2,
    int8_act: bool = False,
    device: str = "cuda",
    decoder: bool = False,
) -> ConformerASR:
    """Training-form JAX tree (numpy or torch leaves) -> packed ConformerASR
    on `device`, in eval mode: the weights are projected to `precision`
    (2 = ternary, 1 = binary) and planar-packed (model/packed.py). With
    `decoder` the model also carries the tree's decoder, as the JAX
    package's packed model does, for `forward_with_decoder`: full precision,
    or under quant_decoder with its projections packed like the encoder's.
    A per-channel tree raises the export's NotImplementedError."""
    tree = to_torch({k: v for k, v in params.items() if decoder or k != "decoder"})
    packed = export_packed_params(tree, precision)
    model = ConformerASR(cfg, int8_act=int8_act, decoder=decoder)
    model.load_state_dict(state_dict_from_jax(packed, cfg), strict=True)
    return model.requires_grad_(False).to(device).eval()


def qat_model_from_jax(cfg: ModelConfig, params: Mapping, device: str = "cuda",
                       decoder: bool = True) -> ConformerASR:
    """Training-form JAX tree (numpy or torch leaves) -> the QAT ConformerASR
    on `device`, its parameters f32 and trainable; without `decoder` the
    tree's decoder is left out, for serving."""
    model = ConformerASR(cfg, qat=True, decoder=decoder)
    tree = to_torch({k: v for k, v in params.items() if decoder or k != "decoder"})
    sd = state_dict_from_jax(tree, cfg)
    model.load_state_dict({k: v.to(torch.float32) for k, v in sd.items()}, strict=True)
    return model.to(device)


def streaming_step_from_jax(cfg: ModelConfig, params: Mapping, device: str = "cuda"
                            ) -> Tuple[Any, Dense]:
    """Training-form JAX tree (numpy or torch leaves) -> (StreamingEncoderStep,
    CTC head) on `device`, in eval mode, f32 parameters. The step's
    subsampler is always the unfused one (JAX model/streaming.py:107-109),
    so the projection's rows take the unfused order even for a run trained
    with fused_subsampler."""
    from onebit_asr_tpu_torch.model.streaming import StreamingEncoderStep

    cfg = dataclasses.replace(cfg, fused_subsampler=False, fused_attention=False)
    sd = state_dict_from_jax(to_torch({k: params[k] for k in ("encoder", "ctc_head")}), cfg)
    cd = getattr(torch, cfg.compute_dtype)
    step = StreamingEncoderStep(
        cfg.input_dim, cfg.enc_d_model, cfg.enc_layers, cfg.enc_heads, cfg.enc_d_ff,
        cfg.enc_conv_kernel, int(cfg.attn_chunk_size), cfg.attn_left_chunks, cd,
        cfg.quant_per_channel)
    step.load_state_dict({k[len("encoder."):]: v.to(torch.float32) for k, v in sd.items()
                          if k.startswith("encoder.")}, strict=True)
    head = Dense(cfg.enc_d_model, cfg.vocab_size, cd)
    head.load_state_dict({k[len("ctc_head."):]: v.to(torch.float32) for k, v in sd.items()
                          if k.startswith("ctc_head.")}, strict=True)
    return (step.requires_grad_(False).to(device).eval(),
            head.requires_grad_(False).to(device).eval())

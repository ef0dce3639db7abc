"""Reference PyTorch checkpoints -> the JAX-layout parameter tree.

Counterpart of onebit_asr_tpu/utils/torch_import.py, the same mapping: the
reference trains `ConformerASR` in torch and checkpoints plain
`state_dict()`s; this maps such a state dict (as {name: numpy array}) onto
the JAX package's parameter tree, which the rest of this package takes
through convert.py like every tree (so a reference-trained model is
evaluated by `python -m onebit_asr_tpu_torch.eval --torch_checkpoint`).

Layout facts (reference -> JAX tree):
- Linear weights are [out, in] in torch, [in, out] in the tree -> transpose.
- Conv2d weights are [out, in, kh, kw] -> [kh, kw, in, out].
- The subsampler's flatten order differs: the reference flattens [B,T,C,F']
  as c*F'+f; the tree's projection rows are f*C+c, so the projection's
  input rows are permuted (convert.py permutes them back for this
  package's unfused subsampler, which flattens as the reference does).
- The conv module's depthwise Conv1d bias has no counterpart and needs
  none: batch normalization over batch statistics follows it, and a
  per-channel constant shifts the batch mean by itself, so it cancels
  exactly. The BatchNorm running statistics are not read either (the
  statistics are the batch's at inference too).
- The encoder blocks are stacked: per-layer leaves become [L, ...].

Placed on the analogous parameters, with other semantics (as in JAX): the
attention's position term (the reference feeds absolute positions through
a legacy relative shift; the tree's model uses the 2T-1 relative table),
and the decoder (the reference's stock post-LN `nn.TransformerDecoder`
without positions; the tree's is pre-LN with sinusoidal positions).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

__all__ = [
    "import_reference_state_dict",
    "load_reference_checkpoint",
    "load_reference_checkpoint_params",
]


def _t(w: np.ndarray) -> np.ndarray:
    """torch Linear [out, in] -> flax kernel [in, out]."""
    return np.ascontiguousarray(w.T).astype(np.float32)


def _conv2d(w: np.ndarray) -> np.ndarray:
    """torch Conv2d [out, in, kh, kw] -> flax [kh, kw, in, out]."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0)).astype(np.float32)


def _ln(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Reference LayerNorm wrapper `<prefix>.ln.{weight,bias}`
    (conformer.py:19-24) -> our {scale, bias}."""
    return {
        "scale": sd[f"{prefix}.ln.weight"].astype(np.float32),
        "bias": sd[f"{prefix}.ln.bias"].astype(np.float32),
    }


def _qdense(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Reference QuantizedLinear (quant.py:99-127) -> our QuantDense."""
    out = {
        "kernel": _t(sd[f"{prefix}.weight"]),
        "alpha": np.asarray(sd[f"{prefix}.alpha"], np.float32).reshape(()),
    }
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"].astype(np.float32)
    return out


def _dense(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"].astype(np.float32)
    return out


def _ff(sd, prefix) -> Dict:
    """FeedForwardModule (conformer.py:27-45) -> FeedForward."""
    return {
        "ln": _ln(sd, f"{prefix}.ln"),
        "w1": _qdense(sd, f"{prefix}.lin1"),
        "w2": _qdense(sd, f"{prefix}.lin2"),
    }


def _mhsa(sd, prefix) -> Dict:
    """MHSA (conformer.py:79-138) -> RelPosMHSA. pos_proj/pos_bias_* load
    onto the analogous parameters; the position-term SEMANTICS differ (2T-1
    relative table vs legacy shift) — see module docstring."""
    return {
        "ln": _ln(sd, f"{prefix}.ln"),
        "q_proj": _qdense(sd, f"{prefix}.q_proj"),
        "k_proj": _qdense(sd, f"{prefix}.k_proj"),
        "v_proj": _qdense(sd, f"{prefix}.v_proj"),
        "pos_proj": _qdense(sd, f"{prefix}.pos_proj"),
        "out_proj": _qdense(sd, f"{prefix}.out_proj"),
        "pos_bias_u": sd[f"{prefix}.pos_bias_u"].astype(np.float32),
        "pos_bias_v": sd[f"{prefix}.pos_bias_v"].astype(np.float32),
    }


def _conv_module(sd, prefix) -> Dict:
    """ConvModule (conformer.py:141-167) -> ConvModule. The torch depthwise
    bias is intentionally dropped (exactly cancelled by the following
    batch-statistics norm — module docstring)."""
    return {
        "ln": _ln(sd, f"{prefix}.ln"),
        # pointwise Conv1d k=1 [2d, d, 1] -> Dense [d, 2d]
        "pw1": {
            "kernel": _t(sd[f"{prefix}.pw1.weight"][:, :, 0]),
            "bias": sd[f"{prefix}.pw1.bias"].astype(np.float32),
        },
        # depthwise Conv1d [d, 1, k] -> [k, 1, d] ("TIO")
        "dw_kernel": np.ascontiguousarray(
            sd[f"{prefix}.dw.weight"].transpose(2, 1, 0)
        ).astype(np.float32),
        "bn": {
            "scale": sd[f"{prefix}.bn.weight"].astype(np.float32),
            "bias": sd[f"{prefix}.bn.bias"].astype(np.float32),
        },
        "pw2": {
            "kernel": _t(sd[f"{prefix}.pw2.weight"][:, :, 0]),
            "bias": sd[f"{prefix}.pw2.bias"].astype(np.float32),
        },
    }


def _block(sd, i: int) -> Dict:
    p = f"encoder.blocks.{i}"
    return {
        "ff1": _ff(sd, f"{p}.ff1"),
        "mhsa": _mhsa(sd, f"{p}.mhsa"),
        "conv": _conv_module(sd, f"{p}.conv"),
        "ff2": _ff(sd, f"{p}.ff2"),
        "ln_out": _ln(sd, f"{p}.ln"),
    }


def _stack_blocks(blocks) -> Dict:
    """Per-layer param dicts -> one dict of [L, ...]-stacked leaves (nn.scan)."""
    def rec(subtrees):
        if isinstance(subtrees[0], dict):
            return {k: rec([s[k] for s in subtrees]) for k in subtrees[0]}
        return np.stack(subtrees, axis=0)

    return rec(blocks)


def _subsample(sd, input_dim: int) -> Dict:
    """Conv2dSubsampling (conformer.py:170-208). The out-Linear's input
    order is permuted from torch's (c, f) flatten to our (f, c) flatten."""
    w_out = sd["encoder.subsample.out.weight"]  # [d, C*F']
    d_model = w_out.shape[0]
    f_sub = ((input_dim - 1) // 2 - 1) // 2
    c = w_out.shape[1] // f_sub
    # torch column index = c_i * F' + f_i ; ours = f_i * C + c_i
    w_perm = (
        w_out.reshape(d_model, c, f_sub).transpose(2, 1, 0).reshape(f_sub * c, d_model)
    )
    return {
        "conv1": {
            "kernel": _conv2d(sd["encoder.subsample.conv.0.weight"]),
            "bias": sd["encoder.subsample.conv.0.bias"].astype(np.float32),
        },
        "conv2": {
            "kernel": _conv2d(sd["encoder.subsample.conv.2.weight"]),
            "bias": sd["encoder.subsample.conv.2.bias"].astype(np.float32),
        },
        "proj": {
            "kernel": np.ascontiguousarray(w_perm).astype(np.float32),
            "bias": sd["encoder.subsample.out.bias"].astype(np.float32),
        },
    }


def _mha_from_torch(sd, prefix, d_model: int) -> Dict:
    """torch nn.MultiheadAttention -> our MultiHeadAttention {q,k,v,o}."""
    w = sd[f"{prefix}.in_proj_weight"]  # [3D, D]
    b = sd[f"{prefix}.in_proj_bias"]  # [3D]
    return {
        "q": {"kernel": _t(w[:d_model]), "bias": b[:d_model].astype(np.float32)},
        "k": {
            "kernel": _t(w[d_model : 2 * d_model]),
            "bias": b[d_model : 2 * d_model].astype(np.float32),
        },
        "v": {
            "kernel": _t(w[2 * d_model :]),
            "bias": b[2 * d_model :].astype(np.float32),
        },
        "o": _dense(sd, f"{prefix}.out_proj"),
    }


def _decoder(sd, num_layers: int, d_model: int) -> Dict:
    """Stock nn.TransformerDecoder (conformer.py:275-299) -> our pre-LN
    decoder. Placement-analogous; semantics differ (pre-LN + positions)."""
    out: Dict = {
        "embedding": sd["decoder.emb.weight"].astype(np.float32),
        "ln_out": _ln(sd, "decoder.ln"),
        "out": _dense(sd, "decoder.out"),
    }
    for i in range(num_layers):
        p = f"decoder.dec.layers.{i}"
        out[f"layer{i}"] = {
            "self_attn": _mha_from_torch(sd, f"{p}.self_attn", d_model),
            "cross_attn": _mha_from_torch(sd, f"{p}.multihead_attn", d_model),
            "ff1": _dense(sd, f"{p}.linear1"),
            "ff2": _dense(sd, f"{p}.linear2"),
            "ln1": {
                "scale": sd[f"{p}.norm1.weight"].astype(np.float32),
                "bias": sd[f"{p}.norm1.bias"].astype(np.float32),
            },
            "ln2": {
                "scale": sd[f"{p}.norm2.weight"].astype(np.float32),
                "bias": sd[f"{p}.norm2.bias"].astype(np.float32),
            },
            "ln3": {
                "scale": sd[f"{p}.norm3.weight"].astype(np.float32),
                "bias": sd[f"{p}.norm3.bias"].astype(np.float32),
            },
        }
    return out


def import_reference_state_dict(
    sd: Mapping[str, np.ndarray],
    input_dim: int = 80,
    enc_layers: int = 12,
    dec_layers: int = 2,
    include_decoder: bool = True,
) -> Dict:
    """Map a reference `ConformerASR.state_dict()` (as numpy) onto this
    framework's `{"encoder": ..., "decoder": ..., "ctc_head": ...}` params.

    Returns the tree that `ConformerASR.apply({"params": tree}, ...)`
    accepts. Encoder + CTC head are exact-by-construction (modulo the
    position-term semantics, which only matter when pos_proj is nonzero);
    decoder is placement-analogous (see module docstring).
    """
    d_model = sd["ctc_head.weight"].shape[1]
    tree: Dict = {
        "encoder": {
            "subsample": _subsample(sd, input_dim),
            "blocks": _stack_blocks([_block(sd, i) for i in range(enc_layers)]),
            "ln_out": _ln(sd, "encoder.ln_out"),
        },
        "ctc_head": _dense(sd, "ctc_head"),
    }
    if include_decoder:
        tree["decoder"] = _decoder(sd, dec_layers, d_model)
    return tree


def load_reference_checkpoint(path: str):
    """Load a reference checkpoint payload ({"model": state_dict, "args":
    vars(argparse), ...}) and return `(state_dict_as_numpy,
    train_args_dict)`. The model hyperparameters the reference's evaluation
    reads from `args` come back in the second element; a bare state_dict
    (no wrapper) yields `{}` there."""
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(payload, dict) and "model" in payload:
        sd = payload["model"]
        ta = payload.get("args") or {}
        train_args = dict(ta if isinstance(ta, dict) else vars(ta))
    else:
        sd, train_args = payload, {}
    sd_np = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    return sd_np, train_args


def load_reference_checkpoint_params(
    path: str,
    input_dim: int = 80,
    enc_layers: int = 12,
    dec_layers: int = 2,
    include_decoder: bool = True,
) -> Dict:
    """Load a reference checkpoint (the {"model": state_dict, ...} payload or
    a bare state dict) and return the JAX-layout tree."""
    sd_np, _ = load_reference_checkpoint(path)
    return import_reference_state_dict(
        sd_np, input_dim, enc_layers, dec_layers, include_decoder
    )

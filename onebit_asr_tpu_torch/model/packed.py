"""Export trained QAT parameters as packed-ternary serving parameters.

Counterpart of onebit_asr_tpu/model/packed.py. Every quantized dense
subtree (a dict holding both "kernel" and "alpha") has its weight projected
onto {-1,0,+1} (ternary) or {-1,+1} (binary) as the training quantizer's
forward does, then planar-packed 4 weights per byte: the encoder's
projections and, under ModelConfig.quant_decoder, the decoder's. Stacked
block leaves [L, K, N] pack layer by layer. A per-channel alpha (an [N] or
[L, N] alpha against an [.., K, N] kernel) is refused as JAX refuses it:
the packed kernels take one scale per matrix. The tree holds torch tensors (convert.py turns
a JAX tree of numpy arrays into one).
"""

from __future__ import annotations

from typing import Any

import torch

from onebit_asr_tpu_torch.ops.quant import project_weight
from onebit_asr_tpu_torch.ops.ternary_matmul import pack_planar


def export_packed_params(params: Any, precision: int = 2) -> Any:
    """Training tree -> serving tree with "packed_kernel" in place of
    "kernel". precision 2 -> ternary, 1 -> binary (same 2-bit format; binary
    never emits the 0 code)."""
    if precision not in (1, 2):
        raise ValueError(f"precision must be 1 or 2, got {precision}")
    binary = precision == 1

    def rec(node):
        if not isinstance(node, dict):
            return node
        if "kernel" in node and "alpha" in node:
            kernel, alpha = node["kernel"], node["alpha"]
            if alpha.dim() and alpha.shape[-1] == kernel.shape[-1]:
                # JAX's exception, word for word (model/packed.py:48-55)
                raise NotImplementedError(
                    "packed export requires tensor-wise alpha; per-channel "
                    "scales need a vector-alpha kernel "
                    "(see ModelConfig.quant_per_channel docs)"
                )
            out = {
                "packed_kernel": pack_planar(project_weight(kernel, alpha, binary)),
                "alpha": alpha,
            }
            if "bias" in node:
                out["bias"] = node["bias"]
            return out
        return {k: rec(v) for k, v in node.items()}

    return rec(params)

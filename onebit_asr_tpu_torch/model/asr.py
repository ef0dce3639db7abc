"""ConformerASR, serving form: packed-ternary encoder + CTC head.

Counterpart of the encoder and CTC-head forward of
onebit_asr_tpu/model/asr.py. The AED decoder is not on the serving path and
is not built here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from onebit_asr_tpu_torch.model.conformer import ConformerEncoder
from onebit_asr_tpu_torch.model.layers import Dense
from onebit_asr_tpu_torch.utils.config import ModelConfig


def precision_to_binary_mask(precision: int, num_layers: int) -> Optional[torch.Tensor]:
    """precision -> per-layer binary mask [L] bool (True = 1-bit), or None
    for the full-precision branch (asr.py:33-51; the stochastic-precision
    sp_mask belongs to training)."""
    if precision == 32:
        return None
    if precision in (1, 2):
        return torch.full((num_layers,), precision == 1, dtype=torch.bool)
    raise ValueError(f"precision must be 1, 2 or 32, got {precision}")


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = {
        "conv_norm": (cfg.conv_norm, "batch_norm"),
        "quant_per_channel": (cfg.quant_per_channel, False),
        "causal_conv": (cfg.causal_conv, False),
        "attn_chunk_size": (cfg.attn_chunk_size, None),
    }
    for name, (value, supported) in unsupported.items():
        if value != supported:
            raise NotImplementedError(
                f"ModelConfig.{name}={value!r}: this package serves only "
                f"{name}={supported!r} so far"
            )
    if cfg.fused_attention:
        # the JAX model takes its fused attention kernel on an accelerator
        # (model/conformer.py:310-314); this package has no port of it yet
        raise NotImplementedError(
            "ModelConfig.fused_attention=True: the fused attention kernel is "
            "not ported yet; serve this run with --no_fused_kernels (or "
            "fused_attention=False)"
        )


class ConformerASR(nn.Module):
    """enc_out, enc_mask, logits_ctc = model(feats, feat_lens, binary_mask)."""

    def __init__(self, cfg: ModelConfig, int8_act: bool = False):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        compute_dtype = getattr(torch, cfg.compute_dtype)
        self.encoder = ConformerEncoder(
            input_dim=cfg.input_dim,
            d_model=cfg.enc_d_model,
            num_layers=cfg.enc_layers,
            num_heads=cfg.enc_heads,
            d_ff=cfg.enc_d_ff,
            conv_kernel=cfg.enc_conv_kernel,
            compute_dtype=compute_dtype,
            time_pad_multiple=cfg.time_pad_multiple,
            int8_act=int8_act,
            fused_subsampler=cfg.fused_subsampler,
        )
        self.ctc_head = Dense(cfg.enc_d_model, cfg.vocab_size, compute_dtype)

    def forward(
        self,
        feats: torch.Tensor,  # [B, T, F]
        feat_lens: torch.Tensor,  # [B]
        binary_mask: Optional[torch.Tensor] = None,  # [L] bool
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        enc_out, enc_mask = self.encoder(feats, feat_lens, binary_mask)
        # logits stay in the compute dtype, as in the JAX model
        return enc_out, enc_mask, self.ctc_head(enc_out)

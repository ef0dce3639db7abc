"""ConformerASR: the Conformer encoder + CTC head, and in the QAT form the
AED decoder.

Counterpart of onebit_asr_tpu/model/asr.py. Two forms share the encoder's
code (model/conformer.py::Parts):

- serving (`qat=False`): packed-ternary projections, no dropout, and no
  decoder unless built with `decoder=True` (evaluating packed weights takes
  the decoder's loss; the JAX packed model keeps a full-precision decoder,
  or with quant_decoder packs its projections too);
- QAT (`qat=True`): straight-through quantized projections whose precision
  each call sets per layer, dropout at every site of the JAX model, and the
  decoder unless built with `decoder=False` (unpacked serving needs none).

Every option of the JAX ModelConfig builds in both forms (per-channel alpha
trains and serves unpacked; the packed export refuses it, as JAX's does).
`forward_with_decoder` runs in either form when the model has a decoder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from onebit_asr_tpu_torch.model.conformer import ConformerEncoder, Parts, check_encoder_options
from onebit_asr_tpu_torch.model.decoder import TransformerDecoder
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


def decoder_bits(quant_decoder: bool, binary_mask: Optional[torch.Tensor]):
    """The decoder's precision on a branch (asr.py:191-198): 32 without
    quant_decoder or without a mask (the full-precision branch), else
    all(binary_mask): only a branch whose every layer is binary gets a
    binary decoder (an sp mask that happens to be all True too), every other
    a ternary one."""
    if not quant_decoder or binary_mask is None:
        return 32
    return bool(binary_mask.all())


def check_trainable(cfg: ModelConfig) -> None:
    """ValueError for a ModelConfig no model can be built from, without
    building one: the encoder's own check (a conv norm other than the three
    of JAX's CLI, or a chunk size below 1). Every option of the JAX
    ModelConfig trains here."""
    check_encoder_options(cfg.conv_norm, cfg.attn_chunk_size)


class ConformerASR(nn.Module):
    """enc_out, enc_mask, logits_ctc = model(feats, feat_lens, binary_mask);
    with a decoder also forward_with_decoder."""

    def __init__(self, cfg: ModelConfig, int8_act: bool = False, qat: bool = False,
                 decoder: Optional[bool] = None):
        super().__init__()
        with_decoder = qat if decoder is None else decoder
        self.cfg = cfg
        self.qat = qat
        compute_dtype = getattr(torch, cfg.compute_dtype)
        self.parts = Parts(compute_dtype, int8_act=int8_act, qat=qat,
                           dropout=cfg.dropout if qat else 0.0,
                           per_channel=cfg.quant_per_channel)
        self.encoder = ConformerEncoder(
            input_dim=cfg.input_dim,
            d_model=cfg.enc_d_model,
            num_layers=cfg.enc_layers,
            num_heads=cfg.enc_heads,
            d_ff=cfg.enc_d_ff,
            conv_kernel=cfg.enc_conv_kernel,
            parts=self.parts,
            time_pad_multiple=cfg.time_pad_multiple,
            fused_subsampler=cfg.fused_subsampler,
            fused_attention=cfg.fused_attention,
            conv_norm=cfg.conv_norm,
            causal_conv=cfg.causal_conv,
            attn_chunk_size=cfg.attn_chunk_size,
            attn_left_chunks=cfg.attn_left_chunks,
        )
        self.ctc_head = Dense(cfg.enc_d_model, cfg.vocab_size, compute_dtype)
        if with_decoder:
            self.decoder = TransformerDecoder(
                cfg.vocab_size, cfg.enc_d_model, cfg.dec_layers, cfg.dec_heads, cfg.dec_d_ff,
                self.parts, quantize=cfg.quant_decoder, reference_mode=cfg.reference_decoder)

    def forward(
        self,
        feats: torch.Tensor,  # [B, T, F]
        feat_lens: torch.Tensor,  # [B]
        binary_mask: Optional[torch.Tensor] = None,  # [L] bool
        tgt_inp: Optional[torch.Tensor] = None,
        tgt_valid_mask: Optional[torch.Tensor] = None,
        draws=None,
    ):
        """(enc_out, enc_mask, logits_ctc); with `tgt_inp` (a model with a
        decoder) also the decoder's logits, as `forward_with_decoder`."""
        if tgt_inp is not None:
            return self.forward_with_decoder(feats, feat_lens, tgt_inp, tgt_valid_mask,
                                             binary_mask, draws)
        enc_out, enc_mask = self.encoder(feats, feat_lens, binary_mask)
        # logits stay in the compute dtype, as in the JAX model
        return enc_out, enc_mask, self.ctc_head(enc_out)

    def forward_with_decoder(self, feats, feat_lens, tgt_inp, tgt_valid_mask,
                             binary_mask: Optional[torch.Tensor] = None, draws=None):
        """One training branch (asr.py:213): encoder + CTC head + decoder at
        `decoder_bits` of the branch's mask -> (enc_out, enc_mask,
        logits_ctc, dec_logits). `draws` (see layers.DropoutRng) feeds every
        dropout site for this call; None runs without dropout."""
        if not hasattr(self, "decoder"):
            raise RuntimeError("forward_with_decoder needs a decoder: the QAT form (qat=True) "
                               "or the serving form built with decoder=True")
        self.parts.rng.draws = draws
        try:
            enc_out, enc_mask, logits_ctc = self(feats, feat_lens, binary_mask)
            dec_logits = self.decoder(tgt_inp, enc_out, enc_mask, tgt_valid_mask,
                                      decoder_bits(self.cfg.quant_decoder, binary_mask))
        finally:
            self.parts.rng.draws = None
        return enc_out, enc_mask, logits_ctc, dec_logits

"""Attention-branch losses: decoder targets, label-smoothed CE, KL distillation.

Counterpart of onebit_asr_tpu/losses/attention.py. Every loss is masked
before its reduction, so padding never contributes.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from onebit_asr_tpu_torch.utils.collectives import all_sum
from onebit_asr_tpu_torch.utils.config import SpecialTokens


def make_att_targets(tokens: torch.Tensor, token_lens: torch.Tensor,
                     specials: SpecialTokens) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens [B, U], token_lens [B] -> (tgt_inp [B, U+1] = BOS + tokens,
    tgt_out [B, U+1] = tokens + EOS at token_lens, valid [B, U+1] over the
    first token_lens + 1 positions); pad_id elsewhere."""
    B, U = tokens.shape
    tgt_inp = torch.cat([tokens.new_full((B, 1), specials.bos_id), tokens], dim=1)
    tgt_out = torch.cat([tokens, tokens.new_full((B, 1), specials.pad_id)], dim=1)
    pos = torch.arange(U + 1, device=tokens.device)[None, :]
    lens = token_lens[:, None]
    tgt_out = torch.where(pos == lens, specials.eos_id, tgt_out)
    valid = pos <= lens
    return (torch.where(valid, tgt_inp, specials.pad_id),
            torch.where(valid, tgt_out, specials.pad_id), valid)


def _masked_mean(values: torch.Tensor, valid: torch.Tensor, group) -> torch.Tensor:
    """sum(values * valid) / max(sum(valid), 1); with a process `group`
    both sums run over the global batch (one differentiable all-reduce)."""
    m = valid.to(torch.float32)
    num, den = (values * m).sum(), m.sum()
    if group is not None:
        num, den = all_sum(torch.stack([num, den]), group)
    return num / torch.clamp(den, min=1.0)


def att_ce_loss(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
                label_smoothing: float = 0.1, reference_smoothing: bool = False,
                group=None) -> torch.Tensor:
    """Label-smoothed cross-entropy, in f32, mean over valid positions (of
    the global batch with a process `group`). The target distribution is
    torch CrossEntropyLoss's ((1 - ls) * onehot + ls / V), or with
    `reference_smoothing` the reference's own (1 - ls on the target,
    ls / (V - 1) on each other class; attention.py:47-92)."""
    V = logits.shape[-1]
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    if reference_smoothing:
        # -sum(true_dist * logp) = (1 - ls) nll + ls / (V - 1) (sum(-logp) - nll)
        sum_neg = -logp.sum(dim=-1)
        loss = (1.0 - label_smoothing) * nll + (label_smoothing / (V - 1)) * (sum_neg - nll)
    else:
        smooth = -logp.mean(dim=-1)
        loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return _masked_mean(loss, valid, group)


def kl_logits(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
              valid: torch.Tensor, group=None) -> torch.Tensor:
    """KL(teacher || student) with the teacher detached, in f32, mean over
    valid positions (of the global batch with a process `group`)."""
    pt_log = F.log_softmax(teacher_logits.detach().to(torch.float32), dim=-1)
    ps_log = F.log_softmax(student_logits.to(torch.float32), dim=-1)
    kl = (pt_log.exp() * (pt_log - ps_log)).sum(dim=-1)
    return _masked_mean(kl, valid, group)

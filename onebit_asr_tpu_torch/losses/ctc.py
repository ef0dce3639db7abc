"""CTC loss with the analytic alpha-beta gradient.

Counterpart of onebit_asr_tpu/losses/ctc.py. The emissions of the extended
label sequence are gathered once from the f32 logits; the forward lattice
runs on `ops/ctc_lattice.py::ctc_alpha` and, in the backward, the reverse
lattice on `ctc_beta` (the CUDA kernels for CUDA tensors). The gradient is

    d(-log Z)/d logits[t, v] = softmax[t, v] - sum_{s: z_s = v} gamma_t(s),
    gamma_t(s) = exp(alpha_t(s) + beta_t(s) - log Z),

masked past each length and for infeasible rows; autograd never runs
through the recursion.

Semantics of torch's `CTCLoss(reduction="mean", zero_infinity=True)`: each
utterance's NLL divided by its label length, then the batch mean; an
infeasible alignment (too few frames) contributes 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from onebit_asr_tpu_torch.ops.ctc_lattice import NEG_INF, ctc_alpha, ctc_beta
from onebit_asr_tpu_torch.utils.collectives import all_sum


def _extended_targets(labels: torch.Tensor, blank_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """labels [B, U] -> z [B, S=2U+1] = blank l1 blank l2 ... blank, and the
    'may skip from s-2' mask (z[s] != blank and z[s] != z[s-2])."""
    B, U = labels.shape
    S = 2 * U + 1
    z = labels.new_full((B, S), blank_id)
    z[:, 1::2] = labels
    z_prev2 = torch.cat([labels.new_full((B, 2), blank_id), z[:, :-2]], dim=1)[:, :S]
    is_label = (torch.arange(S, device=labels.device) % 2 == 1)[None, :]
    return z, is_label & (z != z_prev2)


def _emissions(logits32: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """emit [B, T, S] = log_softmax(logits)[b, t, z[b, s]] by one gather and
    a logsumexp, and lse [B, T] for the backward's softmax."""
    lse = torch.logsumexp(logits32, dim=-1)
    B, T, _ = logits32.shape
    emit = logits32.gather(2, z[:, None, :].expand(B, T, z.shape[1])) - lse[..., None]
    return emit, lse


def _alpha0_of(emit: torch.Tensor, label_lens: torch.Tensor) -> torch.Tensor:
    B, _, S = emit.shape
    alpha0 = emit.new_full((B, S), NEG_INF)
    alpha0[:, 0] = emit[:, 0, 0]
    if S > 1:
        alpha0[:, 1] = torch.where(label_lens > 0, emit[:, 0, 1], NEG_INF)
    return alpha0


def _nll_of(alpha: torch.Tensor, label_lens: torch.Tensor) -> torch.Tensor:
    """-log Z from the last lattice row: end states 2*len (trailing blank)
    and 2*len - 1 (last label)."""
    end_blank = alpha.gather(1, (2 * label_lens)[:, None])[:, 0]
    end_label = alpha.gather(1, torch.clamp(2 * label_lens - 1, min=0)[:, None])[:, 0]
    end_label = torch.where(label_lens > 0, end_label, NEG_INF)
    return -torch.logaddexp(end_blank, end_label)


class CTCNegLogLikelihood(torch.autograd.Function):
    """Per-utterance -log P(labels | logits); infeasible -> about -NEG_INF.
    The backward computes the analytic posterior gradient."""

    @staticmethod
    def forward(ctx, logits, logit_lens, labels, label_lens, blank_id):
        z, can_skip = _extended_targets(labels, blank_id)
        emit, lse = _emissions(logits.to(torch.float32), z)
        alphas = ctc_alpha(emit, logit_lens, can_skip, _alpha0_of(emit, label_lens))
        nll = _nll_of(alphas[:, -1], label_lens)
        ctx.save_for_backward(logits, lse, logit_lens, label_lens, z, can_skip, emit, alphas, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, lse, logit_lens, label_lens, z, can_skip, emit, alphas, nll = ctx.saved_tensors
        B, T, V = logits.shape
        S = z.shape[1]
        log_z = -nll
        feasible = log_z > 0.5 * NEG_INF
        safe_log_z = torch.where(feasible, log_z, 0.0)
        s_idx = torch.arange(S, device=z.device)[None, :]
        lab = label_lens[:, None]
        is_end = (s_idx == 2 * lab) | ((s_idx == 2 * lab - 1) & (lab > 0))
        beta_init = torch.where(is_end, 0.0, NEG_INF).to(torch.float32)
        betas = ctc_beta(emit, logit_lens, can_skip, beta_init)
        gamma = torch.exp(torch.clamp(alphas + betas - safe_log_z[:, None, None], max=0.0))
        t_valid = torch.arange(T, device=z.device)[None, :] < logit_lens[:, None]  # [B, T]
        valid = (t_valid & feasible[:, None])[..., None]
        gamma = torch.where(valid, gamma, 0.0)
        scattered = torch.zeros((B, T, V), dtype=torch.float32, device=logits.device)
        scattered.scatter_add_(2, z[:, None, :].expand(B, T, S), gamma)
        softmax = torch.exp(logits.to(torch.float32) - lse[..., None])
        dlogits = torch.where(valid, softmax - scattered, 0.0) * g[:, None, None]
        return dlogits.to(logits.dtype), None, None, None, None


def ctc_neg_log_likelihood(logits, logit_lens, labels, label_lens, blank_id: int):
    """logits [B, T, V] (any float dtype), logit_lens [B], labels [B, U]
    (padding past label_lens arbitrary), label_lens [B] -> NLL [B] f32."""
    return CTCNegLogLikelihood.apply(logits, logit_lens, labels, label_lens, blank_id)


def ctc_loss(logits, logit_lens, labels, label_lens, blank_id: int,
             groups: int = 1, group=None) -> torch.Tensor:
    """Batch-mean CTC loss: per-utterance NLL / label length, then the mean
    over the batch; infeasible utterances count 0. With `groups` > 1 the
    batch is that many equal batches stacked (the branches of a train step,
    whose lattices then take one launch each way), and the result is their
    [groups] losses. With a process `group` the mean is over the global
    batch: each group's numerator and the row count are summed over its
    ranks (one differentiable all-reduce), as JAX's `axis_name` psums them."""
    nll = ctc_neg_log_likelihood(logits, logit_lens, labels, label_lens, blank_id)
    nll = torch.where(nll < -0.5 * NEG_INF, nll, 0.0)
    denom = torch.clamp(label_lens.to(torch.float32), min=1.0)
    per_utt = (nll / denom).reshape(groups, -1)
    num = per_utt.sum(dim=1)
    if group is None:
        losses = num / per_utt.shape[1]
    else:
        sums = all_sum(torch.cat([num, num.new_full((1,), per_utt.shape[1])]), group)
        losses = sums[:groups] / sums[groups]
    return losses[0] if groups == 1 else losses

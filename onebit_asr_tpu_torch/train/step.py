"""The 3-branch QAT training step, and the evaluation step.

Counterpart of onebit_asr_tpu/train/step.py. Per batch, three forwards of
one parameter set: the teacher (all layers ternary), the student (all
binary) and the stochastic-precision branch (each layer binary with a
probability log-spaced from sp_low_p to sp_high_p across depth), then

    L = Lint(t) + lambda1 (Lint(1) + Lint(sp)) + lambda2 (KL(t||1) + KL(t||sp)),
    Lint = (1 - gamma) L_att + gamma L_ctc,

its gradient, the global-norm clip and an AdamW step (train/optim.py).

The JAX step vmaps the branches; here they run one after another, which
gives each its own BatchNorm statistics as the vmap does. Their CTC losses
are taken together: the three branches' logits go through one call of the
lattice kernels (ops/ctc_lattice.py), so a step launches `ctc_alpha` once in
the forward and `ctc_beta` once in the backward. Under `fused_attention`
each encoder block's attention runs its forward and backward kernels
(ops/attention.py): 3 x L launches of each per step. Under
`fused_subsampler` each branch's subsampler runs its forward and backward
kernels (ops/subsampler.py): 3 launches of each per step. Everything else in
the backward is autograd over plain tensor code.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from onebit_asr_tpu_torch.losses import att_ce_loss, ctc_loss, kl_logits, make_att_targets
from onebit_asr_tpu_torch.model.asr import precision_to_binary_mask
from onebit_asr_tpu_torch.model.layers import generator_draws
from onebit_asr_tpu_torch.train.optim import AdamW
from onebit_asr_tpu_torch.train.state import TrainState
from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens

Batch = Dict[str, torch.Tensor]


def sp_layer_probs(num_layers: int, low: float = 0.2, high: float = 0.9) -> np.ndarray:
    """Per-layer P(1-bit) of the stochastic-precision mask: log-spaced from
    `low` (first layer) to `high` (last)."""
    return np.exp(np.linspace(np.log(low), np.log(high), num_layers)).astype(np.float32)


def sample_sp_mask(generator: torch.Generator, num_layers: int, low: float = 0.2,
                   high: float = 0.9) -> torch.Tensor:
    """[L] bool on the CPU, True = the layer runs 1-bit this step."""
    p = torch.from_numpy(sp_layer_probs(num_layers, low, high))
    return torch.bernoulli(p, generator=generator).to(torch.bool)


def batch_to_device(batch, device) -> Batch:
    """A batch of numpy arrays or tensors -> tensors on `device` (lengths
    and tokens as int64, feats as float32). Feats cross in their own dtype
    and are upcast on `device`: a float16 batch crosses as float16."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
        if k == "feats":
            out[k] = t.to(device, non_blocking=True).to(torch.float32)
        else:
            out[k] = t.to(device, torch.int64, non_blocking=True)
    return out


def make_batch_loss(model, loss_cfg: LossConfig, specials: SpecialTokens, num_enc_layers: int):
    """batch_loss(params, b, sp_mask, branch_rngs) -> (total, aux): the
    composite loss of the three branches [teacher, student, sp] at `params`
    (a {state-dict name: tensor} mapping of `model`); `branch_rngs` are three
    torch.Generators on the batch's device, or Nones for no dropout."""
    L = num_enc_layers

    def batch_loss(params, b: Batch, sp_mask: torch.Tensor,
                   branch_rngs: Sequence[Optional[torch.Generator]]):
        tgt_inp, tgt_out, tgt_valid = make_att_targets(b["tokens"], b["token_lens"], specials)
        masks = (torch.zeros(L, dtype=torch.bool), torch.ones(L, dtype=torch.bool), sp_mask)
        enc_lens, logits, dec = [], [], []
        for bm, rng in zip(masks, branch_rngs):
            _, enc_mask, logits_ctc, dec_logits = functional_call(
                model, params, (b["feats"], b["feat_lens"]),
                dict(binary_mask=bm, tgt_inp=tgt_inp, tgt_valid_mask=tgt_valid,
                     draws=None if rng is None else generator_draws(rng)))
            enc_lens.append(enc_mask.sum(dim=-1))
            logits.append(logits_ctc)
            dec.append(dec_logits)
        lc = ctc_loss(torch.cat(logits), torch.cat(enc_lens), b["tokens"].repeat(3, 1),
                      b["token_lens"].repeat(3), specials.blank_id, groups=3)
        la = [att_ce_loss(d, tgt_out, tgt_valid, loss_cfg.label_smoothing) for d in dec]
        g = loss_cfg.gamma_ctc
        li = [(1.0 - g) * la[i] + g * lc[i] for i in range(3)]
        kl1 = kl_logits(dec[0], dec[1], tgt_valid)
        kls = kl_logits(dec[0], dec[2], tgt_valid)
        total = li[0] + loss_cfg.lambda1 * (li[1] + li[2]) + loss_cfg.lambda2 * (kl1 + kls)
        aux = {
            "loss": total,
            "loss_int_2bit": li[0],
            "loss_int_1bit": li[1],
            "loss_int_sp": li[2],
            "loss_att_2bit": la[0],
            "loss_ctc_2bit": lc[0],
            "loss_kl_1bit": kl1,
            "loss_kl_sp": kls,
        }
        return total, aux

    return batch_loss


def value_and_grad(batch_loss, params, *args):
    """((total, aux), grads) with grads a {name: tensor} mapping like params."""
    names = list(params)
    leaves = {k: params[k].detach().requires_grad_(True) for k in names}
    total, aux = batch_loss(leaves, *args)
    grads = torch.autograd.grad(total, [leaves[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
    return (total.detach(), {k: v.detach() for k, v in aux.items()}), grads


def make_train_step(model, optimizer: AdamW, loss_cfg: LossConfig, specials: SpecialTokens,
                    num_enc_layers: int,
                    grad_accum: int = 1) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """train_step(state, batch) -> (state, aux): one optimizer step on a batch
    {feats [B, T, F], feat_lens [B], tokens [B, U], token_lens [B]} of
    tensors on the model's device. The state is updated in place and
    returned; aux holds the loss terms and `grad_norm` as device scalars."""
    if grad_accum != 1:
        raise NotImplementedError("grad_accum > 1 is not ported yet (later slice)")
    batch_loss = make_batch_loss(model, loss_cfg, specials, num_enc_layers)
    dropout = model.cfg.dropout > 0

    def train_step(state: TrainState, batch: Batch):
        sp_mask = sample_sp_mask(state.generator, num_enc_layers, loss_cfg.sp_low_p,
                                 loss_cfg.sp_high_p)
        seeds = torch.randint(0, 2 ** 62, (3,), generator=state.generator).tolist()
        device = batch["feats"].device
        rngs = [torch.Generator(device=device).manual_seed(s) if dropout else None
                for s in seeds]
        (_, aux), grads = value_and_grad(batch_loss, state.params, batch, sp_mask, rngs)
        aux["grad_norm"] = optimizer.update(state.params, grads, state.mu, state.nu, state.count)
        state.count += 1
        state.step += 1
        return state, aux

    return train_step


def make_eval_step(model, loss_cfg: LossConfig, specials: SpecialTokens, num_enc_layers: int,
                   precision: int):
    """eval_step(params, batch) -> (CTC log-probs [B, T', V] f32, enc_lens
    [B], the branch's loss Lint): one deterministic forward at `precision`
    (32, 2 or 1)."""
    bm = precision_to_binary_mask(precision, num_enc_layers)

    @torch.no_grad()
    def eval_step(params, batch: Batch):
        tgt_inp, tgt_out, tgt_valid = make_att_targets(batch["tokens"], batch["token_lens"],
                                                       specials)
        _, enc_mask, logits_ctc, dec_logits = functional_call(
            model, params, (batch["feats"], batch["feat_lens"]),
            dict(binary_mask=bm, tgt_inp=tgt_inp, tgt_valid_mask=tgt_valid))
        enc_lens = enc_mask.sum(dim=-1)
        l_att = att_ce_loss(dec_logits, tgt_out, tgt_valid, loss_cfg.label_smoothing)
        l_ctc = ctc_loss(logits_ctc, enc_lens, batch["tokens"], batch["token_lens"],
                         specials.blank_id)
        l_int = (1.0 - loss_cfg.gamma_ctc) * l_att + loss_cfg.gamma_ctc * l_ctc
        return torch.log_softmax(logits_ctc.to(torch.float32), dim=-1), enc_lens, l_int

    return eval_step

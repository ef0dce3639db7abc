"""The 3-branch QAT training step, and the evaluation step.

Counterpart of onebit_asr_tpu/train/step.py. Per batch, three forwards of
one parameter set: the teacher (all layers ternary), the student (all
binary) and the stochastic-precision branch (each layer binary with a
probability log-spaced from sp_low_p to sp_high_p across depth), then

    L = Lint(t) + lambda1 (Lint(1) + Lint(sp)) + lambda2 (KL(t||1) + KL(t||sp)),
    Lint = (1 - gamma) L_att + gamma L_ctc,

its gradient, the global-norm clip and an AdamW step (train/optim.py).
With quant_decoder each branch's decoder runs at that branch's base
precision (model/asr.py::decoder_bits), and L_att takes the reference's
label smoothing under LossConfig.reference_smoothing, in every step kind
and in the evaluation step, as in JAX.

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

With grad_accum > 1 each of those counts holds per micro-batch. Beside the
QAT step: the no-QAT control (`make_fp32_train_step`: one full-precision
branch, its own lattice launch per micro-batch and the 1 x L attention and
1 subsampler launches of one branch) and K steps on a stacked batch
(`make_multi_train_step`, `stack_batches`).
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
        la = [att_ce_loss(d, tgt_out, tgt_valid, loss_cfg.label_smoothing,
                          loss_cfg.reference_smoothing) for d in dec]
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


def micro_seed(seed: int, i: int) -> int:
    """The dropout seed of micro-batch `i` of a step whose branch seed is
    `seed` (the counterpart of JAX's `fold_in(key, i)`)."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0] >> np.uint64(2))


def _split_batch(batch: Batch, grad_accum: int):
    """`grad_accum` contiguous micro-batches along B, each with the whole
    batch's T and U."""
    B = batch["feats"].shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} not divisible by grad_accum {grad_accum}")
    m = B // grad_accum
    return [{k: v[i * m : (i + 1) * m] for k, v in batch.items()} for i in range(grad_accum)]


def accumulated_value_and_grad(batch_loss, params, batch: Batch, sp_mask: torch.Tensor,
                               seeds: Sequence[int], dropout: bool, grad_accum: int = 1):
    """((loss, aux), grads) of `batch_loss` on `batch`. With grad_accum > 1,
    the gradients and aux of the micro-batches (one sp mask; dropout seeds
    `micro_seed(seed, i)`) are summed in order and divided by grad_accum,
    and loss = aux["loss"]."""
    device = batch["feats"].device

    def rngs(i=None):
        if not dropout:
            return [None] * len(seeds)
        return [torch.Generator(device=device).manual_seed(s if i is None else micro_seed(s, i))
                for s in seeds]

    if grad_accum == 1:
        return value_and_grad(batch_loss, params, batch, sp_mask, rngs())
    grads = aux = None
    for i, mb in enumerate(_split_batch(batch, grad_accum)):
        (_, aux_i), g_i = value_and_grad(batch_loss, params, mb, sp_mask, rngs(i))
        if grads is None:
            grads, aux = g_i, aux_i
            continue
        for k, g in g_i.items():
            grads[k].add_(g)
        aux = {k: aux[k] + aux_i[k] for k in aux}
    grads = {k: g / grad_accum for k, g in grads.items()}
    aux = {k: a / grad_accum for k, a in aux.items()}
    return (aux["loss"], aux), grads


def _make_step(model, batch_loss, optimizer: AdamW, loss_cfg: LossConfig, num_enc_layers: int,
               grad_accum: int):
    dropout = model.cfg.dropout > 0

    def train_step(state: TrainState, batch: Batch):
        # the same draws for every kind of step, so that runs resume alike
        sp_mask = sample_sp_mask(state.generator, num_enc_layers, loss_cfg.sp_low_p,
                                 loss_cfg.sp_high_p)
        seeds = torch.randint(0, 2 ** 62, (3,), generator=state.generator).tolist()
        (_, aux), grads = accumulated_value_and_grad(batch_loss, state.params, batch, sp_mask,
                                                     seeds, dropout, grad_accum)
        aux["grad_norm"] = optimizer.update(state.params, grads, state.mu, state.nu, state.count)
        state.count += 1
        state.step += 1
        return state, aux

    return train_step


def make_train_step(model, optimizer: AdamW, loss_cfg: LossConfig, specials: SpecialTokens,
                    num_enc_layers: int,
                    grad_accum: int = 1) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """train_step(state, batch) -> (state, aux): one optimizer step on a batch
    {feats [B, T, F], feat_lens [B], tokens [B, U], token_lens [B]} of
    tensors on the model's device. The state is updated in place and
    returned; aux holds the loss terms and `grad_norm` as device scalars.

    With grad_accum > 1 the batch is split along B into that many
    micro-batches whose gradients are averaged before the one AdamW update
    (activation memory scales with B / grad_accum; BatchNorm takes each
    micro-batch's statistics, as in JAX). B must divide: else ValueError."""
    batch_loss = make_batch_loss(model, loss_cfg, specials, num_enc_layers)
    return _make_step(model, batch_loss, optimizer, loss_cfg, num_enc_layers, grad_accum)


def make_fp32_batch_loss(model, loss_cfg: LossConfig, specials: SpecialTokens):
    """batch_loss(params, b, sp_mask, branch_rngs) -> (total, aux) of the
    no-QAT control: one branch with every projection on its raw weights
    (binary_mask=None), dropout from branch_rngs[0], total = (1 - gamma)
    L_att + gamma L_ctc. sp_mask is not read."""

    def batch_loss(params, b: Batch, sp_mask, branch_rngs):
        del sp_mask
        tgt_inp, tgt_out, tgt_valid = make_att_targets(b["tokens"], b["token_lens"], specials)
        rng = branch_rngs[0]
        _, enc_mask, logits_ctc, dec_logits = functional_call(
            model, params, (b["feats"], b["feat_lens"]),
            dict(binary_mask=None, tgt_inp=tgt_inp, tgt_valid_mask=tgt_valid,
                 draws=None if rng is None else generator_draws(rng)))
        l_att = att_ce_loss(dec_logits, tgt_out, tgt_valid, loss_cfg.label_smoothing,
                            loss_cfg.reference_smoothing)
        l_ctc = ctc_loss(logits_ctc, enc_mask.sum(dim=-1), b["tokens"], b["token_lens"],
                         specials.blank_id)
        g = loss_cfg.gamma_ctc
        total = (1.0 - g) * l_att + g * l_ctc
        return total, {"loss": total, "loss_att_32bit": l_att, "loss_ctc_32bit": l_ctc}

    return batch_loss


def make_fp32_train_step(model, optimizer: AdamW, loss_cfg: LossConfig, specials: SpecialTokens,
                         num_enc_layers: int, grad_accum: int = 1):
    """The no-QAT control: make_train_step's step (the same draws from the
    state's generator, the same grad_accum path, optimizer and clip) on
    make_fp32_batch_loss. aux: loss, loss_att_32bit, loss_ctc_32bit,
    grad_norm."""
    return _make_step(model, make_fp32_batch_loss(model, loss_cfg, specials), optimizer,
                      loss_cfg, num_enc_layers, grad_accum)


def make_multi_train_step(model, optimizer: AdamW, loss_cfg: LossConfig,
                          specials: SpecialTokens, num_enc_layers: int, grad_accum: int = 1):
    """multi_step(state, stacked) -> (state, aux): make_train_step's step K
    times in order on a stacked batch [K, B, ...] (stack_batches), the same
    as K calls. aux is each key's mean over the K steps, plus `losses` [K].
    JAX runs the K steps as one dispatch; here they are K steps of host
    dispatch as before, and what the grouping saves is one host round-trip
    for the aux of K steps."""
    step = make_train_step(model, optimizer, loss_cfg, specials, num_enc_layers, grad_accum)

    def multi_step(state: TrainState, stacked: Batch):
        auxes = []
        for k in range(stacked["feats"].shape[0]):
            state, aux = step(state, {n: v[k] for n, v in stacked.items()})
            auxes.append(aux)
        out = {n: torch.stack([a[n] for a in auxes]).mean() for n in auxes[0]}
        out["losses"] = torch.stack([a["loss"] for a in auxes])
        return state, out

    return multi_step


def stack_batches(batches):
    """Batches of one shape (numpy arrays or tensors) -> one batch [K, ...]."""
    return {k: torch.stack([b[k] for b in batches]) if isinstance(batches[0][k], torch.Tensor)
            else np.stack([b[k] for b in batches]) for k in batches[0]}


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
        l_att = att_ce_loss(dec_logits, tgt_out, tgt_valid, loss_cfg.label_smoothing,
                            loss_cfg.reference_smoothing)
        l_ctc = ctc_loss(logits_ctc, enc_lens, batch["tokens"], batch["token_lens"],
                         specials.blank_id)
        l_int = (1.0 - loss_cfg.gamma_ctc) * l_att + loss_cfg.gamma_ctc * l_ctc
        return torch.log_softmax(logits_ctc.to(torch.float32), dim=-1), enc_lens, l_int

    return eval_step

"""Multi-precision evaluation: loss + WER at fp32 / 2-bit / 1-bit.

Counterpart of onebit_asr_tpu/eval/evaluate.py: per batch and precision, one
deterministic forward of the model (train/step.py::make_eval_step; the QAT
form, or the packed form with its decoder), then CTC decoding: greedy on the
device by default; with `use_beam` the prefix beam on the device
(decode/beam_device.py), optionally fused with an n-gram LM packed into
device tables once per call (JAX caches them per LM object in a module
dict); with `host_beam` as well, the host beam
(decode/beam.py, its C++ copy by default) as the oracle. WER and CER are
counted on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np

from onebit_asr_tpu_torch.decode import (
    compute_cer,
    compute_wer,
    ctc_beam_search_batch,
    greedy_ctc_decode,
)
from onebit_asr_tpu_torch.decode.beam_device import beam_search_device
from onebit_asr_tpu_torch.decode.lm_device import DeviceLM
from onebit_asr_tpu_torch.train.step import batch_to_device, make_eval_step
from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens


def _ids_to_words(ids: Sequence[int], tokenizer=None, offset: int = 4) -> str:
    """Token ids -> text via the tokenizer, or space-joined ids (dummy data)."""
    if tokenizer is not None:
        return tokenizer.ids_to_text(list(ids))
    return " ".join(str(int(i)) for i in ids if int(i) >= offset)


def build_eval_steps(model, loss_cfg: LossConfig, specials: SpecialTokens, num_enc_layers: int,
                     precisions: Sequence[int] = (32, 2, 1)) -> Dict[int, Callable]:
    return {p: make_eval_step(model, loss_cfg, specials, num_enc_layers, p) for p in precisions}


def evaluate_stream(
    model,
    params,
    batches: Iterable[Dict],
    loss_cfg: LossConfig,
    specials: SpecialTokens,
    num_enc_layers: int,
    precisions: Sequence[int] = (32, 2, 1),
    tokenizer=None,
    use_beam: bool = False,
    beam_size: int = 10,
    max_batches: Optional[int] = None,
    host_beam: bool = False,
    eval_steps: Optional[Dict[int, Callable]] = None,
    print_samples: int = 0,
    lm=None,
    lm_weight: float = 0.0,
    length_bonus: float = 0.0,
    device="cuda",
) -> Dict[str, float]:
    """{loss_<p>bit, wer_<p>bit, cer_<p>bit} per precision, plus the counts
    of batches and utterances. `params` maps `model`'s state-dict names to
    tensors (make_eval_step)."""
    if eval_steps is None:
        eval_steps = build_eval_steps(model, loss_cfg, specials, num_enc_layers, precisions)
    tot_loss = {p: 0.0 for p in precisions}
    tot = {p: [0, 0, 0, 0] for p in precisions}  # word dist, words, char dist, chars
    n_batches = n_utts = printed = 0
    device_lm = None  # the LM's device tables, packed at their first use in this call
    for batch in batches:
        if max_batches is not None and n_batches >= max_batches:
            break
        refs = [_ids_to_words(np.asarray(batch["tokens"][b][: int(batch["token_lens"][b])]),
                              tokenizer, specials.offset)
                for b in range(len(batch["tokens"]))]
        b_dev = batch_to_device(batch, device)
        for p in precisions:
            log_probs, enc_lens, loss = eval_steps[p](params, b_dev)
            tot_loss[p] += float(loss)
            if use_beam and host_beam:
                # the host beam (C++ by default), kept as the oracle
                hyp_ids = ctc_beam_search_batch(
                    log_probs.cpu().numpy(), enc_lens.cpu().numpy(), beam_size=beam_size,
                    blank_id=specials.blank_id, lm=lm, lm_weight=lm_weight,
                    length_bonus=length_bonus)
            else:
                if use_beam:
                    if lm is not None and lm_weight and device_lm is None:
                        device_lm = DeviceLM.pack(lm, device)
                    ids, lens = beam_search_device(
                        log_probs, enc_lens, blank_id=specials.blank_id, beam_size=beam_size,
                        max_len=int(log_probs.shape[1]), lm=device_lm, lm_weight=lm_weight,
                        length_bonus=length_bonus)
                else:
                    ids, lens = greedy_ctc_decode(log_probs, enc_lens, specials.blank_id)
                ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
                hyp_ids = [list(ids[b, : lens[b]]) for b in range(len(lens))]
            hyps = [_ids_to_words(h, tokenizer, specials.offset) for h in hyp_ids]
            d, w = compute_wer(refs, hyps)
            cd, cw = compute_cer(refs, hyps)
            for i, v in enumerate((d, w, cd, cw)):
                tot[p][i] += v
            if printed < print_samples and p == precisions[-1]:
                for r_, h_ in zip(refs, hyps):
                    if printed >= print_samples:
                        break
                    print(f"  REF: {r_}\n  HYP: {h_}")
                    printed += 1
        n_batches += 1
        n_utts += len(batch["tokens"])
    out: Dict[str, float] = {"eval_batches": n_batches, "eval_utts": n_utts}
    for p in precisions:
        tag = {32: "32bit", 2: "2bit", 1: "1bit"}[p]
        out[f"loss_{tag}"] = tot_loss[p] / max(n_batches, 1)
        out[f"wer_{tag}"] = tot[p][0] / max(tot[p][1], 1)
        out[f"cer_{tag}"] = tot[p][2] / max(tot[p][3], 1)
    return out

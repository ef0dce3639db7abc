"""Multi-precision evaluation: loss + WER at fp32 / 2-bit / 1-bit.

Counterpart of the greedy branch of onebit_asr_tpu/eval/evaluate.py: per
batch and precision, one deterministic forward of the QAT model
(train/step.py::make_eval_step), greedy CTC decoding on the device, and
WER/CER on the host. Beam search is not ported yet and is refused.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np

from onebit_asr_tpu_torch.decode import compute_cer, compute_wer, greedy_ctc_decode
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


def evaluate_stream(model, params, batches: Iterable[Dict], loss_cfg: LossConfig,
                    specials: SpecialTokens, num_enc_layers: int,
                    precisions: Sequence[int] = (32, 2, 1), tokenizer=None,
                    use_beam: bool = False, max_batches: Optional[int] = None,
                    eval_steps: Optional[Dict[int, Callable]] = None,
                    device="cuda") -> Dict[str, float]:
    """{loss_<p>bit, wer_<p>bit, cer_<p>bit} per precision, plus the counts
    of batches and utterances."""
    if use_beam:
        raise NotImplementedError("beam-search evaluation is not ported yet (later slice)")
    if eval_steps is None:
        eval_steps = build_eval_steps(model, loss_cfg, specials, num_enc_layers, precisions)
    tot_loss = {p: 0.0 for p in precisions}
    tot = {p: [0, 0, 0, 0] for p in precisions}  # word dist, words, char dist, chars
    n_batches = n_utts = 0
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
            ids, lens = greedy_ctc_decode(log_probs, enc_lens, specials.blank_id)
            ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
            hyps = [_ids_to_words(ids[b, : lens[b]], tokenizer, specials.offset)
                    for b in range(len(lens))]
            d, w = compute_wer(refs, hyps)
            cd, cw = compute_cer(refs, hyps)
            for i, v in enumerate((d, w, cd, cw)):
                tot[p][i] += v
        n_batches += 1
        n_utts += len(batch["tokens"])
    out: Dict[str, float] = {"eval_batches": n_batches, "eval_utts": n_utts}
    for p in precisions:
        tag = {32: "32bit", 2: "2bit", 1: "1bit"}[p]
        out[f"loss_{tag}"] = tot_loss[p] / max(n_batches, 1)
        out[f"wer_{tag}"] = tot[p][0] / max(tot[p][1], 1)
        out[f"cer_{tag}"] = tot[p][2] / max(tot[p][3], 1)
    return out

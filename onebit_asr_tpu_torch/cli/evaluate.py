"""`python -m onebit_asr_tpu_torch.eval` — multi-precision loss, WER and CER.

Counterpart of onebit_asr_tpu/cli/evaluate.py, with its flags: restore a run
(`--checkpoint <run_dir>`, a run this package trained, or `--params` +
`--config`, a JAX run's tree as an .npz with its config.json), evaluate it at
`--precisions` (default 32,2,1) with the prefix beam on the device (beam
`--beam_size`, default 10; `--lm` fuses an n-gram LM at `--lm_weight` with
`--length_bonus`) or greedy CTC (`--greedy`), and print a table per split
and, for more than one split, a summary. `--packed` evaluates planar-packed
2-bit weights on the packed-ternary kernels (one precision: the first of
`--precisions` that is not 32, else 2), with `--int8_act` on the W2A8
kernel; the decoder stays full precision, or with the run's quant_decoder
has its projections packed too, as in JAX. A per-channel run
(quant_per_channel) under `--packed` raises the packed export's
NotImplementedError, as JAX's does. Every other model option of the run's
config is evaluated as it trained. `--no_fused_kernels` clears the run's
fused_attention and fused_subsampler flags.

`--torch_checkpoint` evaluates a reference PyTorch checkpoint (a .pt with the
{"model": state_dict, "args": ...} payload or a bare state dict), as the
reference's own evaluation does: its hyperparameters come from the payload's
args, overridden by a reference config.json (`--config`, default the .pt's
sibling), the vocabulary from its CTC head, and its weights go through
utils/torch_import.py; it computes in f32 with the batch-norm conv module.
`--config` thus names the JAX run's config.json with `--params` and the
reference config.json with `--torch_checkpoint`. `--spm` names a
SentencePiece tokenizer.model to score with (default: the data dir's
tokenizer). `--streaming` decodes each utterance through the incremental
`StreamingSession` (a chunked-causal run; greedy CTC, at the first of
`--precisions` that is not 32, else 2).

The data is the synthetic backend (`--dummy_data`) or the `--splits`
(comma-separated, default `dev`) of a prepared `--data_dir` (default: the
run's training data dir; `data` for a reference checkpoint), featurized
without augmentation on the device through
`LibriSpeechDataModule.featurized_batches` and scored against the
manifest's transcripts through the tokenizer.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m onebit_asr_tpu_torch.eval", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default="",
                   help="run dir written by onebit_asr_tpu_torch.train (config.json + ckpt/)")
    p.add_argument("--params", default="",
                   help=".npz of a JAX run's parameter tree, '/'-joined keys (with --config)")
    p.add_argument("--config", default="",
                   help="with --params: the JAX run's config.json; with --torch_checkpoint: "
                        "the reference config.json whose hyperparameters override the "
                        "checkpoint's (default: the .pt's sibling config.json)")
    p.add_argument("--torch_checkpoint", default="",
                   help="a reference PyTorch checkpoint (.pt, {model, args} payload or bare "
                        "state_dict): hyperparameters from the payload's args + the "
                        "sibling/--config config.json, weights mapped via "
                        "utils/torch_import.py, WER at --precisions")
    p.add_argument("--spm", default="",
                   help="a SentencePiece tokenizer.model for text decoding (default: search "
                        "--data_dir)")
    p.add_argument("--data_dir", default="")
    p.add_argument("--splits", default="dev")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--greedy", action="store_true", help="greedy decode instead of beam")
    p.add_argument("--precisions", default="32,2,1")
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--dummy_data", action="store_true")
    p.add_argument("--print_samples", type=int, default=0,
                   help="print the first N ref/hyp pairs")
    p.add_argument("--int8_act", action="store_true",
                   help="with --packed: per-row int8 activations (the W2A8 kernel)")
    p.add_argument("--packed", action="store_true",
                   help="evaluate planar-packed 2-bit weights (precisions 2/1 only)")
    p.add_argument("--lm", default="", help="n-gram LM .npz for shallow fusion in beam search")
    p.add_argument("--lm_weight", type=float, default=0.3)
    p.add_argument("--length_bonus", type=float, default=0.0)
    p.add_argument("--no_fused_kernels", action="store_true",
                   help="evaluate without the fused attention and subsampler kernels")
    p.add_argument("--streaming", action="store_true",
                   help="decode through the incremental StreamingSession (checkpoint must be "
                        "chunked-causal; greedy CTC)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


REFERENCE_HPARAMS = ("input_dim", "enc_d_model", "enc_layers", "enc_heads", "enc_d_ff",
                    "enc_conv_kernel", "dropout", "dec_layers", "dec_heads", "dec_d_ff")


def load_reference_run(args):
    """(TrainConfig, JAX-layout tree) of `--torch_checkpoint`: the payload's
    args, overridden by the reference config.json (`--config`, default the
    .pt's sibling) for the ten hyperparameters the reference reads, the
    vocabulary from the CTC head; f32, batch-norm conv module."""
    import json
    import os

    from onebit_asr_tpu_torch.utils.config import LossConfig, ModelConfig, TrainConfig
    from onebit_asr_tpu_torch.utils.torch_import import (import_reference_state_dict,
                                                         load_reference_checkpoint)

    sd, train_args = load_reference_checkpoint(args.torch_checkpoint)
    cfg_path = args.config or os.path.join(
        os.path.dirname(os.path.abspath(args.torch_checkpoint)), "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            overrides = json.load(f)
        train_args.update({k: overrides[k] for k in REFERENCE_HPARAMS if k in overrides})
        print(f"config overrides from {cfg_path}")
    vocab_size = int(sd["ctc_head.weight"].shape[0])
    model_cfg = ModelConfig(
        input_dim=int(train_args.get("input_dim", 80)),
        vocab_size=vocab_size,
        enc_d_model=int(train_args.get("enc_d_model", 256)),
        enc_layers=int(train_args.get("enc_layers", 12)),
        enc_heads=int(train_args.get("enc_heads", 4)),
        enc_d_ff=int(train_args.get("enc_d_ff", 1024)),
        enc_conv_kernel=int(train_args.get("enc_conv_kernel", 31)),
        dropout=float(train_args.get("dropout", 0.1)),
        dec_layers=int(train_args.get("dec_layers", 2)),
        dec_heads=int(train_args.get("dec_heads", 4)),
        dec_d_ff=int(train_args.get("dec_d_ff", 1024)),
        # f32: scoring a reference-trained model is a parity surface (the
        # reference evaluates in f32 too)
        compute_dtype="float32",
        conv_norm="batch_norm",
    )
    tree = import_reference_state_dict(sd, model_cfg.input_dim, model_cfg.enc_layers,
                                       model_cfg.dec_layers)
    print(f"imported reference checkpoint {args.torch_checkpoint}: {model_cfg.enc_layers}-layer "
          f"d={model_cfg.enc_d_model} encoder, vocab {vocab_size}")
    loss_cfg = LossConfig(gamma_ctc=float(train_args.get("gamma_ctc", 0.2)))
    return TrainConfig(model=model_cfg, loss=loss_cfg), tree


def streaming_eval(model_cfg, tree, streams, precisions, tokenizer, args) -> None:
    """`--streaming`: each utterance through `streaming_greedy_decode`, one
    step built for all of them; WER and CER per split."""
    import torch

    from onebit_asr_tpu_torch.decode import compute_cer, compute_wer
    from onebit_asr_tpu_torch.decode.streaming import streaming_greedy_decode, streaming_modules
    from onebit_asr_tpu_torch.eval.evaluate import _ids_to_words

    offset = model_cfg.specials.offset
    modules = streaming_modules(model_cfg, tree, args.device)
    precision = next((q for q in precisions if q != 32), 2)
    print(f"streaming greedy decode (precision {precision})")
    for split, stream in streams.items():
        refs, hyps = [], []
        for bi, batch in enumerate(stream()):
            if args.max_batches and bi >= args.max_batches:
                break
            feats, tokens = torch.as_tensor(batch["feats"]), torch.as_tensor(batch["tokens"])
            for i in range(feats.shape[0]):
                T, U = int(batch["feat_lens"][i]), int(batch["token_lens"][i])
                ids = streaming_greedy_decode(model_cfg, None, feats[i, :T].float().cpu().numpy(),
                                              precision, device=args.device, modules=modules)
                ref_ids = tokens[i, :U].tolist()
                hyps.append(_ids_to_words(ids, tokenizer, offset))
                refs.append(_ids_to_words(ref_ids, tokenizer, offset))
                if len(refs) <= args.print_samples:
                    print(f"  ref: {refs[-1]}\n  hyp: {hyps[-1]}")
        d, w = compute_wer(refs, hyps)
        dc, c = compute_cer(refs, hyps)
        print(f"== {split} ({len(refs)} utts, streaming) ==\n"
              f"  {precision}bit: WER {d / max(w, 1) * 100:.2f}%  CER {dc / max(c, 1) * 100:.2f}%")


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    torch_mode = bool(args.torch_checkpoint)
    if torch_mode and (args.checkpoint or args.params):
        parser.error("give one of --checkpoint, --params with --config, or --torch_checkpoint")
    if torch_mode and args.streaming:
        parser.error("--streaming needs a chunked-causal checkpoint trained by this "
                     "framework; reference checkpoints are full-context")
    if args.int8_act and not args.packed:
        print("--int8_act requires --packed (it selects the packed-path matmul kernel)",
              file=sys.stderr)
        return 2

    from onebit_asr_tpu_torch.cli.transcribe import load_run
    from onebit_asr_tpu_torch.convert import packed_model_from_jax, qat_model_from_jax
    from onebit_asr_tpu_torch.data.dummy import DummyDataModule
    from onebit_asr_tpu_torch.eval import evaluate_stream

    cfg, tree = load_reference_run(args) if torch_mode else load_run(args, parser)
    model_cfg = cfg.model
    if args.no_fused_kernels:
        model_cfg = dataclasses.replace(model_cfg, fused_attention=False, fused_subsampler=False)
    specials = model_cfg.specials
    precisions = tuple(int(x) for x in args.precisions.split(","))
    tokenizer = None
    if args.dummy_data:
        dm = DummyDataModule(batch_size=args.batch_size)
        streams = {"dummy": dm.valid_batches}
    else:
        from onebit_asr_tpu_torch.data.librispeech import LibriSpeechDataModule
        from onebit_asr_tpu_torch.data.text import AsrTokenizer
        from onebit_asr_tpu_torch.utils.config import DataConfig

        data_dir = args.data_dir or cfg.data.data_dir
        try:
            tokenizer = (AsrTokenizer.load(args.spm, specials) if args.spm
                         else AsrTokenizer.find_and_load(data_dir, specials))
        except FileNotFoundError as e:
            print(e, file=sys.stderr)
            return 2
        if tokenizer.vocab_size != model_cfg.vocab_size:
            print(f"warning: tokenizer vocab {tokenizer.vocab_size} != model "
                  f"vocab {model_cfg.vocab_size}", file=sys.stderr)
        splits = args.splits.split(",")
        dm = LibriSpeechDataModule(data_dir, tokenizer,
                                   DataConfig(data_dir=data_dir, batch_size=args.batch_size),
                                   splits=tuple(splits), device=args.device)
        missing = [s for s in splits if s not in dm.splits()]
        if missing:
            print(f"split(s) {missing} have no manifest in {data_dir}", file=sys.stderr)
            return 2
        streams = {s: (lambda s=s: dm.featurized_batches(s, augment=False,
                                                         batch_size=args.batch_size))
                   for s in splits}

    if args.streaming:
        streaming_eval(model_cfg, tree, streams, precisions, tokenizer, args)
        if not args.dummy_data:
            dm.close()
        return 0
    if args.packed:
        # packed weights are projected for ONE precision at export time
        precisions = (next((q for q in precisions if q != 32), 2),)
        model = packed_model_from_jax(model_cfg, tree, precisions[0], args.int8_act,
                                      args.device, decoder=True)
        params = model.state_dict()
        print(f"packed serving: 2-bit planar weights, precisions {precisions}"
              + (", int8 activations (W2A8)" if args.int8_act else ""))
    else:
        model = qat_model_from_jax(model_cfg, tree, args.device).requires_grad_(False).eval()
        params = dict(model.named_parameters())

    lm = None
    if args.lm:
        if args.greedy:
            raise SystemExit("--lm requires beam search (shallow fusion is scored per prefix "
                             "extension); drop --greedy or drop --lm.")
        from onebit_asr_tpu_torch.decode.lm import NGramLM

        lm = NGramLM.load(args.lm)
        print(f"shallow fusion: {args.lm} (order {lm.order}, weight {args.lm_weight})")

    tags = {32: "32bit", 2: "2bit", 1: "1bit"}
    split_metrics = {}
    for split, stream in streams.items():
        m = evaluate_stream(
            model, params, stream(), cfg.loss, specials, model_cfg.enc_layers,
            precisions=precisions, tokenizer=tokenizer, use_beam=not args.greedy,
            beam_size=args.beam_size,
            max_batches=args.max_batches or None, print_samples=args.print_samples,
            lm=lm, lm_weight=args.lm_weight, length_bonus=args.length_bonus,
            device=args.device)
        split_metrics[split] = m
        print(f"== {split} ({m['eval_utts']} utts) ==")
        for prec in precisions:
            tag = tags[prec]
            print(f"  {tag:>6}: loss {m[f'loss_{tag}']:.3f}  "
                  f"WER {m[f'wer_{tag}'] * 100:.2f}%  CER {m[f'cer_{tag}'] * 100:.2f}%")
    if len(split_metrics) > 1:
        print("\n=== Summary (WER %) ===")
        print(f"{'split':<16}" + "".join(f"{tags[q]:>10}" for q in precisions))
        for split, m in split_metrics.items():
            print(f"{split:<16}" + "".join(f"{m[f'wer_{tags[q]}'] * 100:>10.2f}"
                                          for q in precisions))
    if not args.dummy_data:
        dm.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

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

The data is the synthetic backend (`--dummy_data`) or the `--splits`
(comma-separated, default `dev`) of a prepared `--data_dir` (default: the
run's training data dir), featurized without augmentation on the device
through `LibriSpeechDataModule.featurized_batches` and scored against the
manifest's transcripts through the data dir's tokenizer. Refused with exit
code 2, naming the ROADMAP queue A item that ports them: `--torch_checkpoint`
and `--spm` (item 7), `--streaming` (item 6).
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
    p.add_argument("--config", default="", help="the JAX run's config.json (with --params)")
    p.add_argument("--torch_checkpoint", default="", help="not ported yet")
    p.add_argument("--spm", default="", help="not ported yet")
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
    p.add_argument("--streaming", action="store_true", help="not ported yet")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def refusal(args) -> str:
    """What of `args` this package does not implement yet, or ""."""
    later = "not ported yet (ROADMAP queue A, item {})"
    checks = [
        (bool(args.torch_checkpoint), f"--torch_checkpoint: {later.format(7)}"),
        (bool(args.spm), f"--spm: {later.format(7)}"),
        (args.streaming, f"--streaming: {later.format(6)}"),
    ]
    return next((msg for bad, msg in checks if bad), "")


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    why = refusal(args)
    if why:
        print(f"FATAL: {why}", file=sys.stderr)
        return 2
    if args.int8_act and not args.packed:
        print("--int8_act requires --packed (it selects the packed-path matmul kernel)",
              file=sys.stderr)
        return 2

    from onebit_asr_tpu_torch.cli.transcribe import load_run
    from onebit_asr_tpu_torch.convert import packed_model_from_jax, qat_model_from_jax
    from onebit_asr_tpu_torch.data.dummy import DummyDataModule
    from onebit_asr_tpu_torch.eval import evaluate_stream

    cfg, tree = load_run(args, parser)
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
            tokenizer = AsrTokenizer.find_and_load(data_dir, specials)
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

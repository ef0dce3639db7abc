"""`python -m onebit_asr_tpu_torch.train` — 3-branch QAT training.

Counterpart of onebit_asr_tpu/cli/train.py on one device, with the same
flags: it builds the QAT Conformer from random weights drawn from `--seed`,
trains for `--epochs` (each of at most `--steps_per_epoch` steps), evaluates
at 32, 2 and 1 bits after each epoch (greedy CTC, or with `--eval_beam` the
prefix beam on the device at `--beam_size`), logs `metrics.jsonl`, and
saves the last and the best train state under `<save_dir>/<run_name>/` with
its `config.json`; `--resume` continues from the last one. A non-finite
epoch loss ends the run with "FATAL: non-finite train loss" and exit code 1.

The data is the synthetic backend (`--dummy_data`) or a `--data_dir` as
`python -m onebit_asr_tpu_torch.prepare` writes it (manifests, npz shards,
a tokenizer, optionally CMVN statistics and a feature cache): `train` in
`--num_buckets` length buckets up to `--max_frames`, featurized on the
device with SpecAugment (`--no_spec_augment` turns it off,
`--time_mask_ratio` caps its time masks), and evaluation on `dev` through
the tokenizer. An epoch has num_utts(train) // batch_size steps. Batches are
made and moved to the device on a producer thread `--prefetch_depth`
batches ahead; each epoch logs `input_wait_frac`, the share of its wall
time the step waited for them.

The step runs on the card (`--device cuda`, the default); the CTC loss
there goes through the lattice kernels of csrc/ctc_lattice.cu, with
`--fused_attention` every encoder block's attention through the fused
forward and backward kernels of csrc/attention.cu and
csrc/attention_bwd.cu, and with `--fused_subsampler` the subsampler of each
branch through the fused forward and backward kernels of
csrc/subsampler.cu. `--device cpu` runs the same step on the kernels' plain
versions.

The step options are JAX's: `--grad_accum N` splits each batch into N
micro-batches along B and averages their gradients before the one update;
`--fp32_control` trains the no-QAT control (one full-precision branch),
evaluates at 32 bits only and keeps the best checkpoint by `loss_32bit`;
`--multistep K` groups K batches of one shape into a stacked batch that
`make_multi_train_step` runs as K steps (odd leftovers go through the
single step; not with `--fp32_control`: exit 1); `--profile_dir` writes a
torch.profiler Chrome trace of this run's first epoch. Each epoch logs
`host_rss_gb` after giving glibc's retained heap pages back.

The model options are JAX's too: `--quant_per_channel` (an alpha per output
channel), `--quant_decoder` (the decoder's projections quantized at each
branch's base precision), `--reference_decoder` (position-blind, post-LN
decoder, with the reference's label smoothing), `--conv_norm
{batch_norm,group_norm,layer_norm}`, `--causal_conv` and `--attn_chunk_size
N --attn_left_chunks M` (chunked attention; with `--causal_conv --conv_norm
layer_norm` the streaming-trained encoder). The run's `config.json` carries
them, and the evaluate and transcribe CLIs read them back.

Not ported yet, and refused with exit code 2 and a message naming what is
missing: `--fsdp`, `--tensor_parallel`, `--pipeline_stages`, `--wandb`.
Flags of the JAX CLI that have no counterpart here (its memory and compile
knobs `--no_remat`, `--remat_policy`, `--scan_unroll`) are accepted and
change nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import os
import sys
import time

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m onebit_asr_tpu_torch.train", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", type=str, default="", help="model family: s / m / l")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--save_dir", type=str, default="./checkpoints")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--warmup_steps", type=int, default=4000)
    p.add_argument("--input_dim", type=int, default=80)
    p.add_argument("--enc_d_model", type=int, default=256)
    p.add_argument("--enc_layers", type=int, default=12)
    p.add_argument("--enc_heads", type=int, default=4)
    p.add_argument("--enc_d_ff", type=int, default=1024)
    p.add_argument("--enc_conv_kernel", type=int, default=31)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--dec_layers", type=int, default=2)
    p.add_argument("--dec_heads", type=int, default=4)
    p.add_argument("--dec_d_ff", type=int, default=1024)
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--gamma_ctc", type=float, default=0.2)
    p.add_argument("--lambda1", type=float, default=0.5)
    p.add_argument("--lambda2", type=float, default=1.0)
    p.add_argument("--resume", action="store_true", help="resume from save_dir/run_name")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dummy_data", action="store_true", help="synthetic data backend")
    p.add_argument("--dummy_frames", type=int, default=160,
                   help="synthetic utterance length (frames)")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--num_buckets", type=int, default=8)
    p.add_argument("--max_frames", type=int, default=1600)
    p.add_argument("--scan_unroll", type=int, default=0)
    p.add_argument("--no_spec_augment", action="store_true")
    p.add_argument("--time_mask_ratio", type=float, default=0.3)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--quant_per_channel", action="store_true")
    p.add_argument("--conv_norm", type=str, default="batch_norm",
                   choices=["batch_norm", "group_norm", "layer_norm"])
    p.add_argument("--attn_chunk_size", type=int, default=0)
    p.add_argument("--attn_left_chunks", type=int, default=-1)
    p.add_argument("--causal_conv", action="store_true")
    p.add_argument("--time_pad_multiple", type=int, default=128)
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--remat_policy", type=str, default="attn_ffn",
                   choices=["masks", "full", "attn", "attn_ffn", "dots", "fused"])
    p.add_argument("--quant_decoder", action="store_true")
    p.add_argument("--reference_decoder", action="store_true")
    p.add_argument("--fused_attention", action="store_true")
    p.add_argument("--fused_subsampler", action="store_true")
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--tensor_parallel", type=int, default=1)
    p.add_argument("--pipeline_stages", type=int, default=1)
    p.add_argument("--pipeline_microbatches", type=int, default=2)
    p.add_argument("--steps_per_epoch", type=int, default=0, help="0 = full epoch")
    p.add_argument("--multistep", type=int, default=1)
    p.add_argument("--eval_batches", type=int, default=0, help="0 = all")
    p.add_argument("--eval_beam", action="store_true")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--run_name", type=str, default="")
    p.add_argument("--summary", action="store_true", help="print a per-module parameter table")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly detection: raise where a NaN is made")
    p.add_argument("--profile_dir", type=str, default="")
    p.add_argument("--fp32_control", action="store_true")
    p.add_argument("--prefetch_depth", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def refusal(args) -> str:
    """What of `args` this package does not implement yet, or ""."""
    later = "not ported yet (later slice)"
    checks = [
        (args.fsdp, f"--fsdp: {later}"),
        (args.tensor_parallel > 1, f"--tensor_parallel: {later}"),
        (args.pipeline_stages > 1, f"--pipeline_stages: {later}"),
        (args.wandb, f"--wandb: {later}"),
    ]
    return next((msg for bad, msg in checks if bad), "")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    why = refusal(args)
    if why:
        print(f"FATAL: {why}", file=sys.stderr)
        return 2
    if args.multistep > 1 and args.fp32_control:
        print("FATAL: --multistep composes only with the plain QAT path "
              "(not fsdp/tp/pp/fp32_control)")
        return 1
    from onebit_asr_tpu_torch.utils.profiling import debug_nans, host_rss_gb, malloc_trim, trace

    if args.debug_nans:
        debug_nans(True)

    from onebit_asr_tpu_torch.convert import init_params, qat_model_from_jax
    from onebit_asr_tpu_torch.data import DummyDataModule, prefetch
    from onebit_asr_tpu_torch.eval import build_eval_steps, evaluate_stream
    from onebit_asr_tpu_torch.model.asr import check_trainable
    from onebit_asr_tpu_torch.train import (
        AdamW,
        create_train_state,
        make_fp32_train_step,
        make_multi_train_step,
        make_train_step,
        stack_batches,
    )
    from onebit_asr_tpu_torch.train.state import param_count
    from onebit_asr_tpu_torch.train.step import batch_to_device
    from onebit_asr_tpu_torch.utils.checkpoint import CheckpointManager, save_config
    from onebit_asr_tpu_torch.utils.config import (
        DataConfig,
        FrontendConfig,
        LossConfig,
        ModelConfig,
        OptimConfig,
        SpecialTokens,
        TrainConfig,
    )
    from onebit_asr_tpu_torch.utils.metrics_logger import MetricsLogger

    specials = SpecialTokens()
    tokenizer = None
    if args.dummy_data:
        dm = DummyDataModule(batch_size=args.batch_size, max_frames=args.dummy_frames)
        # every epoch of the synthetic backend trains on the batches of
        # epoch 0, as in the JAX CLI
        first_epoch = list(dm.train_batches(0))
        get_train = lambda epoch: first_epoch  # noqa: E731
        get_valid = dm.valid_batches
    else:
        from onebit_asr_tpu_torch.data.librispeech import LibriSpeechDataModule
        from onebit_asr_tpu_torch.data.text import AsrTokenizer

        try:
            tokenizer = AsrTokenizer.find_and_load(args.data_dir, specials)
        except FileNotFoundError:
            print(f"no tokenizer artifact in {args.data_dir}; run "
                  "`python -m onebit_asr_tpu_torch.prepare` first", file=sys.stderr)
            return 2
        dm = LibriSpeechDataModule(
            args.data_dir, tokenizer,
            DataConfig(data_dir=args.data_dir, batch_size=args.batch_size,
                       num_buckets=args.num_buckets, max_frames=args.max_frames),
            seed=args.seed,
            frontend_cfg=FrontendConfig(time_mask_ratio=args.time_mask_ratio,
                                        spec_augment=not args.no_spec_augment),
            device=args.device)
        get_train = lambda epoch: dm.featurized_batches("train", epoch, augment=True)  # noqa: E731
        get_valid = lambda: dm.featurized_batches("dev", augment=False)  # noqa: E731
    vocab_size = dm.vocab_size()
    if args.preset:
        from onebit_asr_tpu_torch.model.presets import PRESETS

        for k, v in PRESETS[args.preset].items():
            setattr(args, k, v)
    model_cfg = ModelConfig(
        input_dim=args.input_dim, vocab_size=vocab_size, enc_d_model=args.enc_d_model,
        enc_layers=args.enc_layers, enc_heads=args.enc_heads, enc_d_ff=args.enc_d_ff,
        enc_conv_kernel=args.enc_conv_kernel, dropout=args.dropout, dec_layers=args.dec_layers,
        dec_heads=args.dec_heads, dec_d_ff=args.dec_d_ff, specials=specials,
        compute_dtype=args.compute_dtype, conv_norm=args.conv_norm,
        quant_per_channel=args.quant_per_channel, quant_decoder=args.quant_decoder,
        reference_decoder=args.reference_decoder, causal_conv=args.causal_conv,
        attn_chunk_size=args.attn_chunk_size or None, attn_left_chunks=args.attn_left_chunks,
        time_pad_multiple=args.time_pad_multiple,
        fused_attention=args.fused_attention, fused_subsampler=args.fused_subsampler,
    )
    try:
        check_trainable(model_cfg)
    except ValueError as e:
        print(f"FATAL: {e}", file=sys.stderr)
        return 2
    # --reference_decoder pairs with the reference's smoothing, as in JAX
    loss_cfg = LossConfig(gamma_ctc=args.gamma_ctc, lambda1=args.lambda1, lambda2=args.lambda2,
                          reference_smoothing=args.reference_decoder)
    optim_cfg = OptimConfig(lr=args.lr, warmup_steps=args.warmup_steps)

    # the schedule's length: epochs * steps per epoch
    if args.dummy_data:
        steps_per_epoch = len(first_epoch)
    else:
        steps_per_epoch = max(1, dm.num_utts("train") // args.batch_size)
    if args.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
    total_steps = args.epochs * steps_per_epoch
    train_cfg = TrainConfig(
        model=model_cfg, loss=loss_cfg,
        data=DataConfig(data_dir=args.data_dir, batch_size=args.batch_size),
        optim=optim_cfg, epochs=args.epochs, seed=args.seed, save_dir=args.save_dir,
        beam_size=args.beam_size,
    )
    run_name = args.run_name or f"run-{int(time.time())}"
    run_dir = os.path.join(args.save_dir, run_name)
    os.makedirs(run_dir, exist_ok=True)
    save_config(run_dir, train_cfg)
    logger = MetricsLogger(run_dir)

    device = torch.device(args.device)
    t0 = time.time()
    model = qat_model_from_jax(model_cfg, init_params(model_cfg, args.seed), device=str(device))
    state = create_train_state(model, args.seed)
    print(f"model: {param_count(state.params) / 1e6:.2f}M params, vocab {vocab_size}, "
          f"init {time.time() - t0:.1f}s, device {device}")
    if not args.dummy_data and args.time_mask_ratio != 1.0:
        print(f"SpecAugment time masks capped at {args.time_mask_ratio}x utterance length "
              "(reference parity needs --time_mask_ratio 1.0)")
    if args.summary:
        for name, module in model.named_children():
            n = sum(p.numel() for p in module.parameters())
            print(f"  {name:12s} {n:>12,d}")

    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    ckpt_best = CheckpointManager(os.path.join(run_dir, "ckpt_best"), max_to_keep=1)
    start_epoch = 0
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        start_epoch = state.step // steps_per_epoch
        print(f"resumed at step {state.step} (epoch {start_epoch})")

    optimizer = AdamW(optim_cfg, total_steps)
    make_step = make_fp32_train_step if args.fp32_control else make_train_step
    step_fn = make_step(model, optimizer, loss_cfg, specials, args.enc_layers,
                        grad_accum=args.grad_accum)
    if args.fp32_control:
        print("fp32 control: single full-precision branch, no QAT")
    multi_step_fn = None
    if args.multistep > 1:
        multi_step_fn = make_multi_train_step(model, optimizer, loss_cfg, specials,
                                              args.enc_layers, grad_accum=args.grad_accum)
    eval_precisions = (32,) if args.fp32_control else (32, 2, 1)
    val_tag = "32bit" if args.fp32_control else "2bit"
    eval_steps = build_eval_steps(model, loss_cfg, specials, args.enc_layers,
                                  precisions=eval_precisions)

    def group_multistep(it, K):
        """Stacked [K, B, ...] batches of K same-shaped (same-bucket) batches;
        the leftovers of each shape go through the single step."""
        buf: dict = {}
        for b in it:
            k = tuple(b["feats"].shape)
            buf.setdefault(k, []).append(b)
            if len(buf[k]) == K:
                yield stack_batches(buf.pop(k))
        for bs in buf.values():
            yield from bs

    best_val = float("inf")
    for epoch in range(start_epoch, args.epochs):
        t_ep = time.time()
        losses, n_utts = [], 0
        pf_stats: dict = {}
        batches = itertools.islice(get_train(epoch), args.steps_per_epoch or None)
        if multi_step_fn is not None:
            batches = group_multistep(batches, args.multistep)
        profiling = (trace(args.profile_dir) if args.profile_dir and epoch == start_epoch
                     else contextlib.nullcontext())
        with profiling:
            for batch in prefetch(batches, transfer=lambda b: batch_to_device(b, device),
                                  depth=args.prefetch_depth, stats=pf_stats):
                if batch["feats"].ndim == 4:  # [K, B, T, F]
                    state, aux = multi_step_fn(state, batch)
                else:
                    state, aux = step_fn(state, batch)
                losses.append(aux["loss"])
                n_utts += int(np.prod(batch["tokens"].shape[:-1]))
        if args.profile_dir and epoch == start_epoch:
            print(f"profile of epoch {epoch}: {os.path.join(args.profile_dir, 'trace.json')}")
        train_loss = float(np.mean([float(l) for l in losses]))
        dt = time.time() - t_ep
        if not np.isfinite(train_loss):
            print(f"FATAL: non-finite train loss at epoch {epoch}")
            return 1
        # give retained heap pages back, so that host_rss_gb reads the live set
        malloc_trim()
        metrics = {
            "epoch": epoch,
            "train_loss": train_loss,
            "epoch_seconds": dt,
            "utt_per_sec": n_utts / dt,
            "host_rss_gb": host_rss_gb(),
            # the share of the epoch's wall time the step waited for its batch
            "input_wait_frac": pf_stats.get("wait_s", 0.0) / max(dt, 1e-9),
            "lr": float(optimizer.schedule(state.step)),
        }
        if device.type == "cuda":
            metrics["peak_device_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        eval_metrics = evaluate_stream(
            model, state.params, get_valid(), loss_cfg, specials, args.enc_layers,
            tokenizer=tokenizer, use_beam=args.eval_beam, beam_size=args.beam_size,
            max_batches=args.eval_batches or None, eval_steps=eval_steps, device=device,
            precisions=eval_precisions)
        metrics.update(eval_metrics)
        logger.log(metrics, step=state.step)
        wers = "/".join(f"{eval_metrics[f'wer_{t}']:.3f}" for t in ("32bit", "2bit", "1bit")
                        if f"wer_{t}" in eval_metrics)
        val_loss = eval_metrics[f"loss_{val_tag}"]
        print(f"epoch {epoch}: train {train_loss:.3f} val({val_tag}) {val_loss:.3f} "
              f"wer {wers} ({n_utts / dt:.1f} utt/s)")
        ckpt.save(state, metrics={"val_loss": val_loss})
        if val_loss < best_val:
            best_val = val_loss
            ckpt_best.save(state, metrics={"val_loss": best_val})
    logger.close()
    if not args.dummy_data:
        dm.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

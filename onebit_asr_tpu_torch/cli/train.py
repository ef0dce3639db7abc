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

Data parallelism, as the JAX CLI trains over every device: under
`python -m torch.distributed.run --nproc_per_node N -m
onebit_asr_tpu_torch.train ...` (WORLD_SIZE set) each rank joins one
process group (nccl on `cuda:LOCAL_RANK`, gloo with `--device cpu`), and the
largest rank count that divides `--batch_size` trains; the others print the
same "using n/N ranks" line and leave with 0. Every rank draws the same
global batch from the seed and keeps its rows before featurizing them;
each runs the step on its rows (sync-BN, global-batch losses, averaged
gradients: `train/step.py::make_sharded_train_step`), so at dropout 0 a step
equals the one-process step on the whole batch. `--fsdp` shards the
parameters and both AdamW moments over the ranks instead (ZeRO-2:
`parallel/fsdp.py::make_fsdp_train_step`; not with `--fp32_control`: exit
1); without torchrun it runs on one rank. `--multistep` needs one rank and
no `--fsdp` (exit 1). Only rank 0 logs, writes `metrics.jsonl` and the
checkpoints (the full state, in a one-process run's format, under `--fsdp`
too) and evaluates, on the full parameters over whole eval batches; the
others wait on a gloo group of their own, whose limit (`EVAL_WAIT`) covers a
whole dev split, while a collective of the step fails after
`--dist_timeout` seconds. `--resume` restores the full state, then shards it.
`utt_per_sec` counts the utterances of all ranks.

`--tensor_parallel TP` (under torchrun; composes with data parallelism and
`--grad_accum`): the ranks form a (world / TP, TP) ("data", "model") mesh,
consecutive ranks one model group; the encoder's quantized projections and
their AdamW moments shard over "model" (`parallel/sharding_rules.py`,
Megatron column/row parallel: attention on H / TP heads, d_ff / TP
feed-forward columns), the batch over "data"
(`train/step.py::make_tp_train_step`). Exit 1, with JAX's messages, beside
`--pipeline_stages` or `--fsdp`, for a world TP does not divide, for a batch
the data axis does not divide, and with `--multistep`; also beside
`--fp32_control` (JAX trains the QAT step there) and for a TP that does not
divide enc_heads and enc_d_ff (the port shards whole heads; JAX's
partitioner takes any TP). Rank 0 writes the full state, in a one-process
run's format; `--resume` shards it again.

`--pipeline_stages S --pipeline_microbatches M` (under torchrun): GPipe.
The ranks form a (world / S, S) ("data", "stage") mesh, consecutive ranks
one stage group; each rank holds L/S consecutive encoder blocks and their
AdamW moments (`parallel/pipeline.py`), runs them on M microbatches of its
rows, passing activations to the next stage, while everything outside the
blocks runs on every stage (the subsampler on stage 0 alone)
(`make_pipeline_train_step`). Exit 1, with JAX's messages, beside
`--grad_accum` > 1, for a world S does not divide, a batch the data axis
does not divide, with `--multistep`, and (JAX raises these) for a batch-norm
conv module, enc_layers not divisible by S and a local batch M does not
divide; also beside `--fp32_control` and `--fsdp` (JAX's pipeline branch
ignores both). Rank 0 writes the full state, in a one-process run's
format; `--resume` shards it again.

The model options are JAX's too: `--quant_per_channel` (an alpha per output
channel), `--quant_decoder` (the decoder's projections quantized at each
branch's base precision), `--reference_decoder` (position-blind, post-LN
decoder, with the reference's label smoothing), `--conv_norm
{batch_norm,group_norm,layer_norm}`, `--causal_conv` and `--attn_chunk_size
N --attn_left_chunks M` (chunked attention; with `--causal_conv --conv_norm
layer_norm` the streaming-trained encoder). The run's `config.json` carries
them, and the evaluate and transcribe CLIs read them back.

Refused with exit code 2 and a message naming what is missing: `--wandb`
(the `wandb` package is not installed).
Flags of the JAX CLI that have no counterpart here (its memory and compile
knobs `--no_remat`, `--remat_policy`, `--scan_unroll`) are accepted and
change nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import itertools
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


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
    p.add_argument("--dist_timeout", type=float, default=600.0,
                   help="under torchrun: seconds a collective of the step waits for the "
                        "other ranks")
    return p


# under torchrun, how long the other ranks wait while rank 0 evaluates and
# saves (a whole dev split at three precisions, the device beam too); if
# rank 0 fails, torchrun stops them sooner
EVAL_WAIT = datetime.timedelta(hours=24)


def refusal(args) -> str:
    """What of `args` this package does not implement yet, or ""."""
    later = "not ported yet (later slice)"
    checks = [
        (args.wandb, f"--wandb: {later}"),
    ]
    return next((msg for bad, msg in checks if bad), "")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.tensor_parallel > 1 and (args.pipeline_stages > 1 or args.fsdp):
        print("FATAL: --tensor_parallel composes with data parallelism and "
              "--grad_accum, not with --pipeline_stages/--fsdp (pick one "
              "model-axis strategy)")
        return 1
    why = refusal(args)
    if why:
        print(f"FATAL: {why}", file=sys.stderr)
        return 2
    if args.fsdp and args.fp32_control:
        print("FATAL: --fsdp does not compose with --fp32_control "
              "(the control run is a single-branch diagnostic)")
        return 1
    if args.tensor_parallel > 1 and args.fp32_control:
        print("FATAL: --tensor_parallel does not compose with --fp32_control "
              "(the control run is a single-branch diagnostic)")
        return 1
    if args.pipeline_stages > 1 and args.fp32_control:
        print("FATAL: --pipeline_stages does not compose with --fp32_control "
              "(the control run is a single-branch diagnostic)")
        return 1
    if args.pipeline_stages > 1 and args.fsdp:
        print("FATAL: --pipeline_stages does not compose with --fsdp (pick one "
              "model-axis strategy)")
        return 1
    if args.multistep > 1 and (args.fp32_control or args.fsdp or args.tensor_parallel > 1
                               or args.pipeline_stages > 1):
        print("FATAL: --multistep composes only with the plain QAT path "
              "(not fsdp/tp/pp/fp32_control)")
        return 1
    device = torch.device(args.device)
    distributed = "WORLD_SIZE" in os.environ
    if distributed:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=datetime.timedelta(seconds=args.dist_timeout))
    try:
        return _train(args, device, distributed)
    finally:
        if distributed:
            dist.destroy_process_group()


def _train(args, device: torch.device, distributed: bool) -> int:
    from onebit_asr_tpu_torch.parallel.mesh import (
        local_rows,
        make_mesh,
        replicate,
        shard_batch,
        world,
    )

    if args.preset:
        from onebit_asr_tpu_torch.model.presets import PRESETS

        for k, v in PRESETS[args.preset].items():
            setattr(args, k, v)
    _, n_world = world()
    TP, S = args.tensor_parallel, args.pipeline_stages
    if S > 1:
        from onebit_asr_tpu_torch.parallel.pipeline import pipeline_error

        # JAX's checks (cli/train.py:443-457), then its ValueErrors
        if args.grad_accum > 1:
            print("FATAL: --grad_accum is not supported with --pipeline_stages "
                  "(microbatches already split the batch)")
            return 1
        if n_world % S:
            print(f"FATAL: {n_world} devices not divisible by {S} stages")
            return 1
        if args.batch_size % (n_world // S):
            print(f"FATAL: batch {args.batch_size} not divisible by data axis {n_world // S}")
            return 1
        why = pipeline_error(args.conv_norm, args.enc_layers, S,
                             args.batch_size // (n_world // S), args.pipeline_microbatches)
        if why:
            print(f"FATAL: {why}")
            return 1
        mesh = make_mesh((n_world // S, S), ("data", "stage"))
        n = n_world
    elif TP > 1:
        from onebit_asr_tpu_torch.parallel.sharding_rules import check_tp

        # JAX's checks (cli/train.py:418-426), then the port's own
        if n_world % TP:
            print(f"FATAL: {n_world} devices not divisible by --tensor_parallel {TP}")
            return 1
        if args.batch_size % (n_world // TP):
            print(f"FATAL: batch {args.batch_size} not divisible by data axis "
                  f"{n_world // TP}")
            return 1
        why = check_tp(args, TP)
        if why:
            print(f"FATAL: {why}")
            return 1
        mesh = make_mesh((n_world // TP, TP), ("data", "model"))
        n = n_world
    else:
        # the largest rank count that divides the batch trains, as JAX's CLI
        # takes the largest device count (cli/train.py:469-475)
        n = n_world
        while args.batch_size % n:
            n -= 1
        mesh = make_mesh(ranks=range(n))
    n_data = mesh.axis_size("data")
    # the end of an epoch's wait, on a group whose limit is not the step's
    wait_group = (dist.new_group(list(mesh.ranks), timeout=EVAL_WAIT, backend="gloo")
                  if distributed else None)
    if n < n_world:
        print(f"using {n}/{n_world} ranks (batch divisibility)")
    if not mesh.member:
        return 0
    if args.multistep > 1 and mesh.size > 1:
        print("FATAL: --multistep is the single-chip dispatch-amortization knob; "
              "use data parallelism on multi-chip")
        return 1
    main_rank = mesh.index(mesh.axis_names) == 0
    say = print if main_rank else (lambda *a, **k: None)
    # under --fsdp each rank's rows stay contiguous and the step splits them;
    # the data-parallel step's micro-batch i spans every rank's i-th part
    micro = 1 if args.fsdp else args.grad_accum

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
        make_sharded_train_step,
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
        # this rank's rows, kept on the host
        to_device = lambda b: batch_to_device(  # noqa: E731
            shard_batch(b, mesh, micro=micro), device)
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
            device=device)
        # the data module keeps this rank's rows before featurizing them
        rows = None if n_data == 1 else (
            lambda B: local_rows(B, mesh.index("data"), n_data, micro))
        get_train = lambda epoch: dm.featurized_batches(  # noqa: E731
            "train", epoch, augment=True, rows=rows)
        get_valid = lambda: dm.featurized_batches("dev", augment=False)  # noqa: E731
        to_device = lambda b: batch_to_device(b, device)  # noqa: E731
    vocab_size = dm.vocab_size()
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
    if main_rank:
        os.makedirs(run_dir, exist_ok=True)
        save_config(run_dir, train_cfg)
        logger = MetricsLogger(run_dir)

    t0 = time.time()
    model = qat_model_from_jax(model_cfg, init_params(model_cfg, args.seed), device=str(device))
    state = create_train_state(model, args.seed)
    say(f"model: {param_count(state.params) / 1e6:.2f}M params, vocab {vocab_size}, "
        f"init {time.time() - t0:.1f}s, device {device}"
        + (f", ranks {mesh.size}" if distributed else ""))
    if not args.dummy_data and args.time_mask_ratio != 1.0:
        say(f"SpecAugment time masks capped at {args.time_mask_ratio}x utterance length "
            "(reference parity needs --time_mask_ratio 1.0)")
    if args.summary:
        for name, module in model.named_children():
            n_params = sum(p.numel() for p in module.parameters())
            say(f"  {name:12s} {n_params:>12,d}")

    if main_rank:
        ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
        ckpt_best = CheckpointManager(os.path.join(run_dir, "ckpt_best"), max_to_keep=1)
        if args.resume and ckpt.latest_step() is not None:
            ckpt.restore(state)
    replicate(state, mesh)  # rank 0's state, restored or fresh, on every rank
    start_epoch = state.step // steps_per_epoch
    if state.step:
        say(f"resumed at step {state.step} (epoch {start_epoch})")

    optimizer = AdamW(optim_cfg, total_steps)
    dims = None
    if args.fsdp:
        from onebit_asr_tpu_torch.parallel.fsdp import (
            gather_state_fsdp,
            make_fsdp_train_step,
            shard_dims,
            shard_state_fsdp,
        )

        # ZeRO-2: params + AdamW moments stored sharded, weights all-gathered
        # at use, gradients reduce-scattered, the clip on the global norm
        step_fn = make_fsdp_train_step(model, optimizer, loss_cfg, specials, args.enc_layers,
                                       mesh, state, grad_accum=args.grad_accum)
        dims = shard_dims(state.params, mesh.size)
        state = shard_state_fsdp(state, mesh)
        for p in model.parameters():  # the step and evaluation pass params in
            p.data = p.data.new_empty(0)
        say(f"FSDP/ZeRO-2: params + moments sharded over {mesh.size} ranks, gradients "
            "reduce-scattered")
    elif S > 1:
        from onebit_asr_tpu_torch.parallel.pipeline import (
            gather_state_pipeline,
            make_pipeline_train_step,
            shard_state_pipeline,
        )

        # GPipe: the encoder's blocks and their moments shard over "stage",
        # the batch over "data"
        step_fn = make_pipeline_train_step(model, optimizer, loss_cfg, specials,
                                           args.enc_layers, mesh, args.pipeline_microbatches)
        state = shard_state_pipeline(state, mesh)
        for p in model.parameters():  # the step and evaluation pass params in
            p.data = p.data.new_empty(0)
        say(f"pipeline parallelism: {S} stages x {n_data} data, "
            f"{args.pipeline_microbatches} microbatches")
    elif TP > 1:
        from onebit_asr_tpu_torch.parallel.sharding_rules import gather_state_tp, shard_state_tp
        from onebit_asr_tpu_torch.train import make_tp_train_step

        # Megatron TP: the encoder's projections and their moments shard
        # over "model", the batch over "data"
        step_fn = make_tp_train_step(model, optimizer, loss_cfg, specials, args.enc_layers, mesh,
                                     grad_accum=args.grad_accum)
        state = shard_state_tp(state, mesh)
        for p in model.parameters():  # the step and evaluation pass params in
            p.data = p.data.new_empty(0)
        say(f"tensor parallelism: {TP}-way model axis x {n_data} data")
    elif distributed:
        if args.fp32_control:
            step_fn = make_fp32_train_step(model, optimizer, loss_cfg, specials,
                                           args.enc_layers, args.grad_accum, mesh)
        else:
            step_fn = make_sharded_train_step(model, optimizer, loss_cfg, specials,
                                              args.enc_layers, mesh, grad_accum=args.grad_accum)
    else:
        make_step = make_fp32_train_step if args.fp32_control else make_train_step
        step_fn = make_step(model, optimizer, loss_cfg, specials, args.enc_layers,
                            grad_accum=args.grad_accum)
    if args.fp32_control:
        say("fp32 control: single full-precision branch, no QAT")
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

    def end_of_epoch(epoch, state, train_loss, dt, n_utts, pf_stats):
        """Rank 0's end of an epoch on the full state: metrics, evaluation
        over whole eval batches, the log line, the checkpoints."""
        nonlocal best_val
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

    for epoch in range(start_epoch, args.epochs):
        t_ep = time.time()
        losses, n_utts = [], 0
        pf_stats: dict = {}
        batches = itertools.islice(get_train(epoch), args.steps_per_epoch or None)
        if multi_step_fn is not None:
            batches = group_multistep(batches, args.multistep)
        profiling = (trace(args.profile_dir)
                     if args.profile_dir and epoch == start_epoch and main_rank
                     else contextlib.nullcontext())
        with profiling:
            for batch in prefetch(batches, transfer=to_device, depth=args.prefetch_depth,
                                  stats=pf_stats):
                if batch["feats"].ndim == 4:  # [K, B, T, F]
                    state, aux = multi_step_fn(state, batch)
                else:
                    state, aux = step_fn(state, batch)
                losses.append(aux["loss"])
                # the rows of every rank
                n_utts += int(np.prod(batch["tokens"].shape[:-1])) * n_data
        if args.profile_dir and epoch == start_epoch:
            say(f"profile of epoch {epoch}: {os.path.join(args.profile_dir, 'trace.json')}")
        # the global loss, the same on every rank
        train_loss = float(np.mean([float(l) for l in losses]))
        dt = time.time() - t_ep
        if not np.isfinite(train_loss):
            print(f"FATAL: non-finite train loss at epoch {epoch}")
            return 1
        # under --fsdp, --pipeline_stages and --tensor_parallel every rank
        # takes part in putting the full state together
        full = state
        if args.fsdp:
            full = gather_state_fsdp(state, mesh, dims)
        elif S > 1:
            full = gather_state_pipeline(state, mesh)
        elif TP > 1:
            full = gather_state_tp(state, mesh)
        if main_rank:
            end_of_epoch(epoch, full, train_loss, dt, n_utts, pf_stats)
        del full
        if wait_group is not None:
            dist.barrier(group=wait_group)
    if main_rank:
        logger.close()
    if not args.dummy_data:
        dm.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

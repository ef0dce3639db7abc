"""The ranks of tests/test_torch_parallel.py, test_torch_tensor_parallel.py
and test_torch_pipeline.py: a pool of gloo processes and the cases they run. It imports torch, numpy and the port only: a spawned
child imports this module, never the test module (which imports JAX).

`Pool(world)` starts `world` processes that join one gloo process group
(a file store under a temporary directory) and then run, all of them
together, each case `pool.run(name, **kwargs)` sends; it returns each
rank's result in rank order, or raises with the traceback of a rank that
failed.

Run as a script under torchrun, `torch_parallel_workers.py SECONDS ARGS...`
is the train CLI with ARGS, whose rank 0 evaluates SECONDS slower.
"""

import dataclasses
import multiprocessing as mp
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# JAX tests/test_fsdp.py::_setup's model and data, at f32 and dropout 0
SMALL = dict(vocab_size=16, enc_d_model=32, enc_layers=2, enc_heads=2, enc_d_ff=64,
             enc_conv_kernel=7, dec_layers=1, dec_heads=2, dec_d_ff=64, dropout=0.0,
             compute_dtype="float32")
L = 2
SP_MASK = np.array([True, False])
WARMUP, TOTAL = 1, 8
# JAX tests/test_pipeline.py::_model's depth and conv norm, over SMALL
PIPE = dict(enc_layers=4, conv_norm="layer_norm")


def sp_mask(num_layers):
    """The pinned sp mask of `num_layers` layers: every other layer binary
    (SP_MASK at 2)."""
    return np.arange(num_layers) % 2 == 0


def config(**flags):
    from onebit_asr_tpu_torch.utils.config import ModelConfig

    return dataclasses.replace(ModelConfig(), **{**SMALL, **flags})


def batches(batch_size=8, n=2):
    """The first `n` train batches of JAX's test data (the port's copy of
    its DummyDataModule gives the same arrays)."""
    from onebit_asr_tpu_torch.data.dummy import DummyDataModule

    dm = DummyDataModule(batch_size=batch_size, max_frames=32, max_tokens=6, vocab_size=16)
    return list(dm.train_batches(0))[:n]


def _optimizer():
    from onebit_asr_tpu_torch.train.optim import AdamW
    from onebit_asr_tpu_torch.utils.config import OptimConfig

    class RecordingAdamW(AdamW):
        """AdamW that keeps each update's gradients (the masks of the
        parameter comparisons)."""

        def __init__(self):
            super().__init__(OptimConfig(warmup_steps=WARMUP), TOTAL)
            self.grads = []

        def update(self, params, grads, mu, nu, count, g_norm=None):
            self.grads.append({k: g.detach().clone().numpy() for k, g in grads.items()})
            return super().update(params, grads, mu, nu, count, g_norm)

    return RecordingAdamW()


def _model(flags):
    from onebit_asr_tpu_torch.convert import init_params, qat_model_from_jax
    from onebit_asr_tpu_torch.train.state import create_train_state

    cfg = config(**flags)
    model = qat_model_from_jax(cfg, init_params(cfg, 0), device="cpu")
    return model, create_train_state(model, 0)


def _pin_sp_mask():
    """Every step's sp mask is `sp_mask(L)` (SP_MASK at L = 2), as the JAX
    side pins it."""
    from onebit_asr_tpu_torch.train import step as tstep

    tstep.sample_sp_mask = lambda _, num_layers, *a, **k: torch.from_numpy(sp_mask(num_layers))


def _np(d):
    return {k: v.detach().clone().numpy() for k, v in d.items()}


def _drive(step, state, opt, local_batches):
    from onebit_asr_tpu_torch.train.step import batch_to_device

    auxes = []
    for b in local_batches:
        state, aux = step(state, batch_to_device(b, "cpu"))
        auxes.append({k: float(v) for k, v in aux.items()})
    return dict(aux=auxes, params=_np(state.params), mu=_np(state.mu), nu=_np(state.nu),
                grads=opt.grads)


def one_process(flags=None, grad_accum=1, batch_size=8, fp32=False):
    """make_train_step (make_fp32_train_step with `fp32`) on the whole
    batches, without collectives."""
    from onebit_asr_tpu_torch.train.step import make_fp32_train_step, make_train_step
    from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens

    _pin_sp_mask()
    model, state = _model(flags or {})
    opt = _optimizer()
    make = make_fp32_train_step if fp32 else make_train_step
    step = make(model, opt, LossConfig(), SpecialTokens(), model.cfg.enc_layers, grad_accum)
    return _drive(step, state, opt, batches(batch_size))


def data_parallel(flags=None, grad_accum=1, batch_size=8, multislice=False, reference=False,
                  fp32=False):
    """make_sharded_train_step (make_fp32_train_step over the mesh with
    `fp32`) over every rank (a flat `data` mesh, or ("dcn", "data") =
    (2, world/2)) on this rank's rows of two batches. Rank 0 also returns
    the one-process step's results with `reference`."""
    from onebit_asr_tpu_torch.parallel.mesh import (
        make_mesh,
        make_multislice_mesh,
        replicate,
        shard_batch,
    )
    from onebit_asr_tpu_torch.train.step import make_fp32_train_step, make_sharded_train_step
    from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens

    _pin_sp_mask()
    axes = ("dcn", "data") if multislice else "data"
    mesh = make_multislice_mesh(2) if multislice else make_mesh()
    model, state = _model(flags or {})
    replicate(state, mesh)
    opt = _optimizer()
    if fp32:
        step = make_fp32_train_step(model, opt, LossConfig(), SpecialTokens(), L, grad_accum,
                                    mesh, axes)
    else:
        step = make_sharded_train_step(model, opt, LossConfig(), SpecialTokens(), L, mesh,
                                       axes, grad_accum)
    local = [shard_batch(b, mesh, axes, micro=grad_accum) for b in batches(batch_size)]
    out = _drive(step, state, opt, local)
    out["rows"] = int(local[0]["feats"].shape[0])
    if reference and dist.get_rank() == 0:
        out["reference"] = one_process(flags, grad_accum, batch_size, fp32)
    return out


def fsdp(grad_accum=1, batch_size=8, min_elems=256, reference=False):
    """make_fsdp_train_step over every rank on this rank's contiguous rows
    of two batches: the shards' shapes before and after, the collectives
    it called, and the gathered full state."""
    from onebit_asr_tpu_torch.parallel import fsdp as F
    from onebit_asr_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from onebit_asr_tpu_torch.train.step import batch_to_device
    from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens

    _pin_sp_mask()
    mesh = make_mesh()
    model, full = _model({})
    opt = _optimizer()
    step = F.make_fsdp_train_step(model, opt, LossConfig(), SpecialTokens(), L, mesh, full,
                                  min_elems=min_elems, grad_accum=grad_accum)
    state = F.shard_state_fsdp(full, mesh, min_elems=min_elems)

    def shapes(s):
        return {part: {k: tuple(v.shape) for k, v in getattr(s, part).items()}
                for part in ("params", "mu", "nu")}

    calls = {"all_gather_into_tensor": 0, "reduce_scatter_tensor": 0}
    saved = {name: getattr(dist, name) for name in calls}

    def counted(name):
        def call(*a, **k):
            calls[name] += 1
            return saved[name](*a, **k)
        return call

    for name in calls:
        setattr(dist, name, counted(name))
    try:
        before = shapes(state)
        auxes = []
        for b in batches(batch_size):
            state, aux = step(state, batch_to_device(shard_batch(b, mesh), "cpu"))
            auxes.append({k: float(v) for k, v in aux.items()})
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    dims = F.shard_dims(full.params, mesh.size, min_elems)
    whole = F.gather_state_fsdp(state, mesh, dims)
    # the updates saw each rank's shards: the whole gradients, for the masks
    grads = [{k: F._gather(torch.from_numpy(g), dims[k], mesh.size, mesh.group).numpy()
              for k, g in step_grads.items()} for step_grads in opt.grads]
    out = dict(aux=auxes, before=before, after=shapes(state), full_shapes=shapes(full),
               calls=calls, params=_np(whole.params), mu=_np(whole.mu), nu=_np(whole.nu),
               grads=grads)
    if reference and dist.get_rank() == 0:
        out["reference"] = one_process({}, 1, batch_size)
    return out


def tensor_parallel(shape=(2, 2), axes=("data", "model"), flags=None, grad_accum=1,
                    batch_size=8, reference=False):
    """make_tp_train_step over every rank on a mesh of `shape` over `axes`
    (the model axis "model", the data axis "data"), from shard_state_tp of
    the one-process state, on this rank's rows of two batches: the shards'
    shapes, each rank's own (sharded) state and the gathered full state.
    Rank 0 also returns the one-process step's results with `reference`."""
    from onebit_asr_tpu_torch.parallel import sharding_rules as S
    from onebit_asr_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from onebit_asr_tpu_torch.train.step import make_tp_train_step
    from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens

    _pin_sp_mask()
    mesh = make_mesh(shape, axes)
    model, full = _model(flags or {})
    opt = _optimizer()
    step = make_tp_train_step(model, opt, LossConfig(), SpecialTokens(), L, mesh,
                              grad_accum=grad_accum)
    state = S.shard_state_tp(full, mesh)
    local = [shard_batch(b, mesh, "data", micro=grad_accum) for b in batches(batch_size)]
    out = _drive(step, state, opt, local)
    out["local"] = {part: out.pop(part) for part in ("params", "mu", "nu")}
    whole = S.gather_state_tp(state, mesh)
    out.update(params=_np(whole.params), mu=_np(whole.mu), nu=_np(whole.nu),
               rows=int(local[0]["feats"].shape[0]), coords=mesh.coords)
    if reference and dist.get_rank() == 0:
        out["reference"] = one_process(flags, grad_accum, batch_size)
    return out


def _counted_rows():
    """Count the calls of rows 3-8 (their plain versions on the CPU) through
    the hooks the model reaches them by: {row: calls}, live until the
    process ends."""
    from onebit_asr_tpu_torch.losses import ctc
    from onebit_asr_tpu_torch.ops import attention as fa
    from onebit_asr_tpu_torch.ops import subsampler as ss

    calls = dict.fromkeys(("fused_relpos_attention", "fused_relpos_attention_bwd",
                           "fused_subsample", "fused_subsample_bwd", "ctc_alpha", "ctc_beta"), 0)

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    fa._KERNELS = (counted("fused_relpos_attention", fa._KERNELS[0]),
                   counted("fused_relpos_attention_bwd", fa._KERNELS[1]))
    ss._KERNELS = (counted("fused_subsample", ss._KERNELS[0]),
                   counted("fused_subsample_bwd", ss._KERNELS[1]))
    ctc.ctc_alpha = counted("ctc_alpha", ctc.ctc_alpha)
    ctc.ctc_beta = counted("ctc_beta", ctc.ctc_beta)
    return calls


def pipeline(shape=(2, 2), microbatches=2, flags=None, steps=2, reference=False, count=False):
    """make_pipeline_train_step over every rank on a ("data", "stage") mesh of
    `shape`, from shard_state_pipeline of the one-process state (PIPE's
    model: 4 blocks, layer norm), on this rank's rows of `steps` batches:
    each rank's own state before and after, the gathered full state, and
    with `count` the calls of rows 3-8 it made (the batches repeat after
    two). Rank 0 also returns, with `reference`, the
    one-process step's results at a data axis of 1, else the data-parallel
    step's over the mesh's "data" axis (every rank takes part)."""
    from onebit_asr_tpu_torch.parallel import pipeline as P
    from onebit_asr_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from onebit_asr_tpu_torch.train.step import make_sharded_train_step
    from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens

    _pin_sp_mask()
    flags = {**PIPE, **(flags or {})}
    mesh = make_mesh(shape, ("data", "stage"))
    model, full = _model(flags)
    opt = _optimizer()
    step = P.make_pipeline_train_step(model, opt, LossConfig(), SpecialTokens(),
                                      model.cfg.enc_layers, mesh, microbatches)
    state = P.shard_state_pipeline(full, mesh)
    start = _np(state.params)
    for prm in model.parameters():  # as the CLI does: the step passes params in
        prm.data = prm.data.new_empty(0)
    whole_batches = batches()
    local = [shard_batch(whole_batches[i % len(whole_batches)], mesh, "data")
             for i in range(steps)]
    calls = _counted_rows() if count else None
    out = _drive(step, state, opt, local)
    out["local"] = {part: out.pop(part) for part in ("params", "mu", "nu")}
    whole = P.gather_state_pipeline(state, mesh)
    out.update(params=_np(whole.params), mu=_np(whole.mu), nu=_np(whole.nu),
               rows=int(local[0]["feats"].shape[0]), coords=mesh.coords,
               calls=dict(calls) if count else None, step=state.step, start=start)
    if reference and mesh.axis_size("data") == 1:
        if dist.get_rank() == 0:
            out["reference"] = one_process(flags)
    elif reference:
        model, state = _model(flags)
        ref_opt = _optimizer()
        ref = make_sharded_train_step(model, ref_opt, LossConfig(), SpecialTokens(),
                                      model.cfg.enc_layers, mesh, "data")
        got = _drive(ref, state, ref_opt, local)
        if dist.get_rank() == 0:
            out["reference"] = got
    return out


def data_rows(data_dir, batch_size, cached):
    """The first train batch of epoch 0 with SpecAugment on, on this rank's
    rows (`local_rows`); rank 0 also returns the whole batch."""
    from onebit_asr_tpu_torch.data.librispeech import LibriSpeechDataModule
    from onebit_asr_tpu_torch.data.text import AsrTokenizer
    from onebit_asr_tpu_torch.parallel.mesh import local_rows, make_mesh
    from onebit_asr_tpu_torch.utils.config import DataConfig, FrontendConfig, SpecialTokens

    mesh = make_mesh()
    if not cached:
        os.environ["ONEBIT_NO_FEATURE_CACHE"] = "1"
    try:
        dm = LibriSpeechDataModule(
            data_dir, AsrTokenizer.find_and_load(data_dir, SpecialTokens()),
            DataConfig(data_dir=data_dir, batch_size=batch_size, num_buckets=1,
                       max_frames=250),
            seed=0, frontend_cfg=FrontendConfig(spec_augment=True), device="cpu")
        rows = lambda n: local_rows(n, mesh.index("data"), mesh.size)  # noqa: E731

        def first(**kw):
            b = next(iter(dm.featurized_batches("train", 0, augment=True, **kw)))
            return {k: np.asarray(v.float() if k == "feats" else v) for k, v in b.items()}

        out = {"local": first(rows=rows)}
        if dist.get_rank() == 0:
            out["whole"] = first()
        return out
    finally:
        os.environ.pop("ONEBIT_NO_FEATURE_CACHE", None)


def _serve(rank, world, store, inbox, outbox):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        while True:
            task = inbox.get()
            if task is None:
                return
            name, kwargs = task
            try:
                outbox.put((rank, True, globals()[name](**kwargs)))
            except BaseException:
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Pool:
    """`world` gloo ranks that run the cases of this module together."""

    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        self.tmp = tempfile.TemporaryDirectory()
        self.world = world
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        store = os.path.join(self.tmp.name, "store")
        self.procs = [ctx.Process(target=_serve, args=(r, world, store, q, self.outbox),
                                  daemon=True) for r, q in enumerate(self.inboxes)]
        for p in self.procs:
            p.start()

    def run(self, name, timeout=300, **kwargs):
        for q in self.inboxes:
            q.put((name, kwargs))
        got = sorted((self.outbox.get(timeout=timeout) for _ in range(self.world)),
                     key=lambda r: r[0])
        for rank, ok, value in got:
            if not ok:
                raise RuntimeError(f"rank {rank} failed in {name}:\n{value}")
        return [value for _, _, value in got]

    def close(self):
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        self.tmp.cleanup()


def slow_eval_train(seconds: float, argv) -> int:
    """The train CLI on `argv`, its evaluation (rank 0's alone) `seconds`
    slower."""
    import onebit_asr_tpu_torch.eval as ev
    from onebit_asr_tpu_torch.cli import train

    evaluate = ev.evaluate_stream

    def slow(*args, **kwargs):
        time.sleep(seconds)
        return evaluate(*args, **kwargs)

    ev.evaluate_stream = slow
    return train.main(argv)


if __name__ == "__main__":
    sys.exit(slow_eval_train(float(sys.argv[1]), sys.argv[2:]))

"""onebit_asr_tpu_torch's pipeline parallelism (parallel/pipeline.py, the
encoder's GPipe tick loop, make_pipeline_train_step, the train CLI's
--pipeline_stages under torchrun) against the data-parallel and
one-process steps and the JAX package, on CPU.

One pool of 4 gloo ranks (tests/torch_parallel_workers.py, which imports no
JAX) runs every multi-rank case; the JAX step runs in this process on 4 of
conftest's fake CPU devices. Model and data are JAX
tests/test_pipeline.py::_model's (d=32, 4 blocks, 2 heads, d_ff 64, conv
kernel 7, 1 decoder layer, layer norm, f32) on tests/test_torch_parallel.py's
batches (B=8 of 32 frames), parameters from `convert.init_params`; two
steps (the LR is 0 at step 0), the sp mask pinned to every other layer on
both sides. Tolerances:

- the pipelined step vs the data-parallel step over the mesh's data axis
  (on (2, 2)) or the one-process step (on (1, 4)) on the whole batch: those
  of tests/test_torch_parallel.py (loss and aux rtol 1e-5 atol 1e-6,
  grad_norm rtol 1e-5, m and sqrt(v) rtol 1e-4 atol 2e-6 x the largest
  gradient, parameters atol 1e-5 where the gradient exceeds 1e-6 in both
  steps), at dropout 0 and 0.1: every stage draws the data-parallel step's
  bytes and keeps its blocks'. Every rank ends with the same replicated
  leaves and the same gathered state, bit for bit;
- the port's pipelined step vs JAX's make_pipeline_train_step on a
  ("data", "stage") = (2, 2) mesh, dropout 0: loss and grad_norm rtol 2e-4,
  parameters rtol 5e-4 atol 5e-5 (JAX tests/test_pipeline.py:79-87), where
  the gradient exceeds 1e-6 in both steps.
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_workers as W
from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.parallel import mesh as jmesh
from onebit_asr_tpu.parallel import pipeline as jpipe
from onebit_asr_tpu.train import optim as joptim
from onebit_asr_tpu.train import step as jstep
from onebit_asr_tpu.train.state import TrainState as JaxTrainState
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import train as train_cli
from onebit_asr_tpu_torch.parallel import mesh as pmesh
from onebit_asr_tpu_torch.parallel import pipeline as ppipe
from onebit_asr_tpu_torch.utils.checkpoint import load_config
from test_torch_parallel import TINY_CLI, _torchrun, assert_steps_match
from torch_cpu_threads import one_thread  # noqa: F401

WORLD = 4
L = W.PIPE["enc_layers"]
FUSED = {"fused_attention": True, "fused_subsampler": True}
# (mesh shape (data, stage), microbatches, model flags, count rows 3-8):
# both meshes, M 2 and 4, dropout 0 and 0.1, unfused and both fused flags
# (their plain versions of rows 3-8 on the CPU)
CASES = {
    "2x2-M2-dropout0": ((2, 2), 2, {}, False),
    "1x4-M4-dropout0": ((1, 4), 4, {}, False),
    "2x2-M4-dropout0.1": ((2, 2), 4, {"dropout": 0.1}, False),
    "1x4-M2-dropout0.1": ((1, 4), 2, {"dropout": 0.1}, False),
    "2x2-M2-fused-dropout0.1": ((2, 2), 2, {"dropout": 0.1, **FUSED}, True),
    "1x4-M4-fused-dropout0": ((1, 4), 4, FUSED, True),
}


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(WORLD)
    yield p
    p.close()


_RUNS = {}


def run_case(pool, case):
    if case not in _RUNS:
        shape, micro, flags, count = CASES[case]
        _RUNS[case] = pool.run("pipeline", shape=shape, microbatches=micro, flags=flags,
                               count=count, reference=True)
    return _RUNS[case]


def _full_state():
    return W._model(W.PIPE)[1]


# -- the layout ----------------------------------------------------------------------------


def test_pipeline_spec_tree_covers_moments():
    """The port's layout of every leaf is JAX `pipeline_spec_tree`'s on the
    same path: JAX shards each stacked [L, ...] block leaf's layer axis over
    "stage", which puts block i on stage i // (L/S); the port keeps block i's
    leaves whole on that stage. Every other leaf is on every rank; the AdamW
    moments are laid out as their parameters on both sides."""
    params = convert.init_params(W.config(**W.PIPE), 0)
    jparams = jax.tree.map(jnp.asarray, params)
    opt = joptim.make_optimizer(jc.OptimConfig(warmup_steps=W.WARMUP), W.TOTAL)
    jstate = JaxTrainState(step=jnp.int32(0), params=jparams, opt_state=opt.init(jparams),
                           rng=jax.random.PRNGKey(0))
    jspecs = jpipe.pipeline_spec_tree(jstate, "stage")
    assert jspecs.opt_state[1][0].mu == jspecs.params == jspecs.opt_state[1][0].nu
    mesh = pmesh.make_mesh((1, 2), ("data", "stage"), ranks=range(2))
    specs = ppipe.pipeline_state_specs(_full_state(), mesh)
    assert specs["mu"] == specs["params"] == specs["nu"]

    def holder(spec, leaf):
        """1 + the stage that holds each element under JAX's spec, 0 where
        every device holds it."""
        if tuple(spec) != ("stage",):
            return np.zeros(leaf.shape, np.float32)
        stage = 1 + np.arange(L) // (L // 2)
        return np.broadcast_to(stage.reshape(L, *[1] * (leaf.ndim - 1)),
                               leaf.shape).astype(np.float32)

    held = jax.tree.map(holder, jspecs.params, params, is_leaf=lambda v: isinstance(v, P))
    cfg = W.config(**W.PIPE)
    want = {}
    for k, v in convert.state_dict_from_jax(convert.to_torch(held), cfg).items():
        assert len(np.unique(v.numpy())) == 1, k  # each port leaf on one stage, or on all
        c = int(v.flatten()[0])
        want[k] = () if c == 0 else ("stage", c - 1)
    assert specs["params"] == want
    assert {k for k, s in want.items() if s} == {k for k in want
                                                 if k.startswith("encoder.blocks.")}


@pytest.mark.parametrize("case", ["2x2-M2-dropout0", "1x4-M4-dropout0"])
def test_pipeline_state_sharding_layout(pool, case):
    """Each rank holds the L/S blocks of its stage and every other leaf, in
    params, mu and nu; those of a data group are the same blocks, and their
    leaves are the gathered state's."""
    res = run_case(pool, case)
    shape = CASES[case][0]
    per = L // shape[1]
    full = res[0]["params"]
    for r in res:
        stage = r["coords"][1]
        want = {k for k in full if ppipe.block_index(k) is None
                or ppipe.block_index(k) // per == stage}
        for part in ("params", "mu", "nu"):
            assert set(r["local"][part]) == want, (part, r["coords"])
            for k, v in r["local"][part].items():
                np.testing.assert_array_equal(v, r[part][k], err_msg=k)
        assert {ppipe.block_index(k) for k in want} - {None} == set(
            range(stage * per, (stage + 1) * per))


def test_pipeline_rejects_batch_norm():
    """BatchNorm statistics cannot sync across ticks (GPipe-BN), and the
    stages must divide the blocks: JAX's ValueErrors, before any step. A
    local batch the microbatches do not divide fails in the forward."""
    from onebit_asr_tpu_torch.train.step import batch_to_device
    from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens

    mesh = pmesh.make_mesh((1, 2), ("data", "stage"), ranks=range(2))
    for flags, msg in (({"enc_layers": 4}, "conv_norm"),
                       ({**W.PIPE, "enc_layers": 3}, "enc_layers 3 not divisible by 2 stages")):
        model, _ = W._model(flags)
        with pytest.raises(ValueError, match=msg):
            ppipe.make_pipeline_train_step(model, W._optimizer(), LossConfig(), SpecialTokens(),
                                           model.cfg.enc_layers, mesh)
    model, state = W._model(W.PIPE)
    one = pmesh.make_mesh((1, 1), ("data", "stage"))
    step = ppipe.make_pipeline_train_step(model, W._optimizer(), LossConfig(), SpecialTokens(),
                                          L, one, microbatches=3)
    with pytest.raises(ValueError, match="local batch 8 not divisible by microbatches 3"):
        step(state, batch_to_device(W.batches()[0], "cpu"))


# -- the step --------------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_step_matches_jit_step(pool, case):
    """make_pipeline_train_step on 4 ranks equals the data-parallel step
    over the same mesh's data axis (the one-process step on (1, 4)) on the
    whole batch of 8; every rank ends with the same gathered state and the
    same replicated leaves, bit for bit."""
    res = run_case(pool, case)
    shape = CASES[case][0]
    ref = res[0]["reference"]
    assert res[0]["rows"] == 8 // shape[0]
    assert_steps_match(res[0], ref, ref["grads"])
    for r in res[1:]:
        for part in ("params", "mu", "nu"):
            for k, v in res[0][part].items():
                assert np.array_equal(r[part][k], v), (part, k)
            for k, v in r["local"][part].items():
                if ppipe.block_index(k) is None:
                    assert np.array_equal(v, res[0]["local"][part][k]), (part, k)


@pytest.mark.parametrize("case", [c for c, v in CASES.items() if v[3]])
def test_pipeline_composes_with_the_kernel_rows(pool, case):
    """Each rank calls rows 3 and 4 3 x M x L/S times a step (its blocks on
    each microbatch of each branch), rows 5 and 6 3 times on stage 0 and
    never elsewhere (only stage 0 feeds the pipe), and rows 7 and 8 once (the
    loss on every stage): the table of PERF.md section 6, counted here on
    the rows' plain versions."""
    res = run_case(pool, case)
    shape, micro = CASES[case][:2]
    for r in res:
        first = r["coords"][1] == 0
        per_step = {"fused_relpos_attention": 3 * micro * L // shape[1],
                    "fused_relpos_attention_bwd": 3 * micro * L // shape[1],
                    "fused_subsample": 3 if first else 0,
                    "fused_subsample_bwd": 3 if first else 0, "ctc_alpha": 1, "ctc_beta": 1}
        assert r["calls"] == {k: 2 * n for k, n in per_step.items()}, r["coords"]


def test_pipeline_trains_multiple_steps(pool):
    """Three pipelined steps: losses finite, the step count advances, and
    every rank's blocks move after the warm-up."""
    res = pool.run("pipeline", shape=(2, 2), microbatches=2, steps=3)
    for r in res:
        assert r["step"] == 3
        assert all(np.isfinite(a["loss"]) for a in r["aux"])
        blocks = [k for k in r["start"] if ppipe.block_index(k) is not None]
        assert blocks and all(not np.array_equal(r["local"]["params"][k], r["start"][k])
                              for k in blocks if k.endswith("kernel"))


def test_one_rank_pipeline_is_the_one_process_step():
    """Without a process group a (1, 1) mesh is one stage: the pipelined step
    runs the blocks on its microbatches in turn and equals the one-process
    step, at dropout 0.1."""
    from onebit_asr_tpu_torch.train.step import batch_to_device, make_train_step
    from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens

    mesh = pmesh.make_mesh((1, 1), ("data", "stage"))
    out = []
    for pipelined in (False, True):
        model, state = W._model({**W.PIPE, "dropout": 0.1})
        opt = W._optimizer()
        args = (model, opt, LossConfig(), SpecialTokens(), L)
        step = (ppipe.make_pipeline_train_step(*args, mesh, microbatches=2) if pipelined
                else make_train_step(*args))
        auxes = []
        for b in W.batches():
            state, aux = step(state, batch_to_device(b, "cpu"))
            auxes.append({k: float(v) for k, v in aux.items()})
        out.append(dict(aux=auxes, params=W._np(state.params), mu=W._np(state.mu),
                        nu=W._np(state.nu), grads=opt.grads))
    assert_steps_match(out[1], out[0], out[0]["grads"])


@pytest.fixture(scope="module")
def jax_pipeline():
    """Two steps of JAX's make_pipeline_train_step on a ("data", "stage") =
    (2, 2) mesh of fake devices, M=2, from the port's parameters -> {aux,
    params} in the port's names. Its compile knobs (no remat, no unrolled
    block scan) change no result and save a third of the compile."""
    cfg = W.config(**W.PIPE)
    jcfg = dataclasses.replace(jc.ModelConfig(), remat_blocks=False, scan_unroll=1,
                               **{**W.SMALL, **W.PIPE})
    params = jax.tree.map(jnp.asarray, convert.init_params(cfg, 0))
    model = JaxASR.from_config(jcfg, deterministic=True)
    opt = joptim.make_optimizer(jc.OptimConfig(warmup_steps=W.WARMUP), W.TOTAL)
    state = JaxTrainState(step=jnp.int32(0), params=params, opt_state=opt.init(params),
                          rng=jax.random.PRNGKey(0))
    mesh = jmesh.make_mesh((2, 2), ("data", "stage"), devices=jax.devices()[:WORLD])
    auxes = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "sample_sp_mask", lambda *a, **k: jnp.asarray(W.sp_mask(L)))
        step = jpipe.make_pipeline_train_step(model, opt, jc.LossConfig(), jc.SpecialTokens(),
                                              L, mesh, microbatches=2)
        state = jpipe.shard_state_pipeline(state, mesh)
        for b in W.batches():
            state, aux = step(state, jmesh.shard_batch(b, mesh))
            auxes.append({k: float(v) for k, v in aux.items()})
    sd = convert.state_dict_from_jax(convert.to_torch(jax.tree.map(np.asarray, state.params)),
                                     cfg)
    return dict(aux=auxes, params={k: v.numpy() for k, v in sd.items()})


def test_pipeline_step_matches_jax(pool, jax_pipeline):
    """The port's pipelined step on (data 2, stage 2), M=2, equals JAX's on
    4 devices: the same parameters, batches and sp mask, dropout 0."""
    res = run_case(pool, "2x2-M2-dropout0")[0]
    for g, r in zip(res["aux"], jax_pipeline["aux"]):
        assert set(g) == set(r)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], r[k], rtol=2e-4, err_msg=k)
    grads = res["reference"]["grads"]
    for k, want in jax_pipeline["params"].items():
        keep = np.ones(want.shape, bool)
        for step in grads:
            keep &= np.abs(step[k]) > 1e-6
        np.testing.assert_allclose(res["params"][k][keep], want[keep], rtol=5e-4, atol=5e-5,
                                   err_msg=k)


# -- the CLI ---------------------------------------------------------------------------------


def test_torchrun_pipeline_trains_saves_and_resumes(tmp_path):
    """`--pipeline_stages 2` over 4 gloo ranks ((data 2, stage 2), one block
    a stage): two epochs; then a --resume epoch from the checkpoint over 2
    ranks ((data 1, stage 2): the full state shards again on another mesh).
    Rank 0 alone logs and saves the full state, in a one-process run's
    format."""
    common = [*TINY_CLI, "--save_dir", str(tmp_path), "--run_name", "pp", "--batch_size", "4",
              "--conv_norm", "layer_norm", "--pipeline_stages", "2"]
    first = _torchrun([*common, "--epochs", "2"], nproc=WORLD)
    assert first.returncode == 0, first.stderr[-3000:]
    assert first.stdout.count("pipeline parallelism: 2 stages x 2 data, 2 microbatches") == 1
    second = _torchrun([*common, "--epochs", "3", "--resume"], nproc=2)
    assert second.returncode == 0, second.stderr[-3000:]
    assert second.stdout.count("resumed at step 4 (epoch 2)") == 1
    run_dir = tmp_path / "pp"
    assert sorted(os.listdir(run_dir / "ckpt")) == ["step_2.pt", "step_4.pt", "step_6.pt"]
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [2, 4, 6]
    saved = torch.load(run_dir / "ckpt" / "step_6.pt", weights_only=True)
    cfg = load_config(str(run_dir)).model
    want = [(k, tuple(v.shape)) for k, v in convert.qat_model_from_jax(
        cfg, convert.init_params(cfg, 0), device="cpu").named_parameters()]
    for part in ("params", "mu", "nu"):
        assert [(k, tuple(v.shape)) for k, v in saved[part].items()] == want, part
        assert all(torch.isfinite(v).all() for v in saved[part].values())


PP_REFUSALS = [
    (["--grad_accum", "2"], "FATAL: --grad_accum is not supported with --pipeline_stages"),
    ([], "FATAL: 1 devices not divisible by 2 stages"),
    (["--world", "4", "--batch_size", "3"], "FATAL: batch 3 not divisible by data axis 2"),
    (["--multistep", "2"], "FATAL: --multistep composes only with the plain QAT path"),
    (["--fp32_control"], "FATAL: --pipeline_stages does not compose with --fp32_control"),
    (["--fsdp"], "FATAL: --pipeline_stages does not compose with --fsdp"),
    (["--world", "4", "--conv_norm", "batch_norm"],
     "FATAL: pipeline parallelism requires conv_norm in {group_norm, layer_norm}"),
    (["--world", "4", "--enc_layers", "3"], "FATAL: enc_layers 3 not divisible by 2 stages"),
    (["--world", "4", "--pipeline_microbatches", "3"],
     "FATAL: local batch 2 not divisible by microbatches 3"),
]


@pytest.mark.parametrize("flags,message", PP_REFUSALS)
def test_cli_refuses_pipeline_beside(flags, message, tmp_path, capsys, monkeypatch):
    """JAX's exit code 1 and messages for what --pipeline_stages does not
    compose with (cli/train.py:443-457, :529-533), its ValueErrors as exit 1
    (JAX crashes with a traceback there), and the port's own beside
    --fp32_control and --fsdp (JAX's pipeline branch ignores both); all
    before any process group or file (`--world N` here stands for N ranks
    under torchrun)."""
    argv = [*TINY_CLI, "--save_dir", str(tmp_path), "--batch_size", "4", "--conv_norm",
            "layer_norm", "--pipeline_stages", "2"]
    if flags[:1] == ["--world"]:
        n_world = int(flags[1])
        monkeypatch.setattr(pmesh, "world", lambda: (0, n_world))
        flags = flags[2:]
    with contextlib.redirect_stderr(io.StringIO()):
        assert train_cli.main([*argv, *flags]) == 1
    assert message in capsys.readouterr().out
    assert not os.listdir(tmp_path)

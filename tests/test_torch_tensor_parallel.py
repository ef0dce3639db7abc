"""onebit_asr_tpu_torch's tensor parallelism (parallel/sharding_rules.py, the
column/row-parallel QATDense and attention on sharded heads,
train/step.py::make_tp_train_step, the train CLI's --tensor_parallel under
torchrun) against the one-process step and the JAX package, on CPU.

One pool of 4 gloo ranks (tests/torch_parallel_workers.py, which imports no
JAX) runs every multi-rank case; the JAX step runs in this process on 4 of
conftest's fake CPU devices. Model and data are JAX
tests/test_tensor_parallel.py::_setup's model (d=32, 2 blocks, 2 heads,
d_ff 64, vocabulary 16) on tests/test_torch_parallel.py's batches (B=8 of
32 frames), f32, parameters from `convert.init_params`; two steps (the LR
is 0 at step 0), the sp mask pinned to [True, False] on both sides.
Tolerances:

- the TP step vs the one-process step on the whole batch: the
  data-parallel step's of tests/test_torch_parallel.py (loss and aux rtol
  1e-5 atol 1e-6, grad_norm rtol 1e-5, m and sqrt(v) rtol 1e-4 atol 2e-6 x
  the largest gradient, parameters atol 1e-5 where the gradient exceeds
  1e-6 in both steps), at dropout 0 and 0.1: every rank draws the
  one-process step's bytes and keeps its rows and heads or features. Every
  rank ends with the same replicated leaves and the same gathered state,
  bit for bit;
- the port's TP step vs JAX's GSPMD step (`shard_state_tp` + the jitted
  make_train_step on a ("data", "model") = (2, 2) mesh, dropout 0): loss,
  aux and grad_norm rtol 1e-4, JAX tests/test_tensor_parallel.py's own.
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
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_workers as W
from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.parallel import mesh as jmesh
from onebit_asr_tpu.parallel import sharding_rules as jrules
from onebit_asr_tpu.train import optim as joptim
from onebit_asr_tpu.train import step as jstep
from onebit_asr_tpu.train.state import TrainState as JaxTrainState
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import train as train_cli
from onebit_asr_tpu_torch.parallel import sharding_rules as rules
from onebit_asr_tpu_torch.parallel import mesh as pmesh
from onebit_asr_tpu_torch.utils.checkpoint import load_config
from test_torch_parallel import TINY_CLI, _torchrun, assert_steps_match
from torch_cpu_threads import one_thread  # noqa: F401

WORLD = 4
DATA_MODEL = dict(shape=(2, 2), axes=("data", "model"))
# (mesh, model flags, grad_accum): dropout 0 and 0.1, grad_accum 1 and 2,
# the model axis across data groups, both fused flags (their plain versions
# of rows 3-8 on the CPU, on H/TP heads), and per-channel alpha (sliced with
# a column-parallel kernel's columns, whole beside a row-parallel one)
CASES = {
    "dropout0": (DATA_MODEL, {}, 1),
    "per_channel": (DATA_MODEL, {"quant_per_channel": True}, 1),
    "dropout0.1": (DATA_MODEL, {"dropout": 0.1}, 1),
    "dropout0.1-grad_accum2": (DATA_MODEL, {"dropout": 0.1}, 2),
    "model_data-grad_accum2": (dict(shape=(2, 2), axes=("model", "data")), {}, 2),
    "fused-dropout0.1": (DATA_MODEL, {"dropout": 0.1, "fused_attention": True,
                                      "fused_subsampler": True}, 1),
}


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(WORLD)
    yield p
    p.close()


_RUNS = {}


def run_case(pool, case):
    if case not in _RUNS:
        mesh, flags, grad_accum = CASES[case]
        _RUNS[case] = pool.run("tensor_parallel", flags=flags, grad_accum=grad_accum,
                               reference=True, **mesh)
    return _RUNS[case]


def _port_specs():
    return rules.tp_state_shardings(W._model({})[1], pmesh.make_mesh((1, 1), ("data", "model")))


# -- the layout ----------------------------------------------------------------------------


def test_layout_rule_matches_jax():
    """The port's spec of every leaf is JAX `_spec_for`'s on the same path,
    without JAX's leading [L] dim of the stacked blocks: column-parallel
    w1/q/k/v/pos kernels shard their output dim, row-parallel w2/out_proj
    their input dim, everything else (alpha, bias, pos_bias_u/v, norms,
    conv, subsampler, decoder) replicates; the AdamW moments shard as
    their parameters on both sides."""
    cfg = W.config()
    params = convert.init_params(cfg, 0)
    mesh = jmesh.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    opt = joptim.make_optimizer(jc.OptimConfig(warmup_steps=W.WARMUP), W.TOTAL)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JaxTrainState(step=jnp.int32(0), params=jparams, opt_state=opt.init(jparams),
                           rng=jax.random.PRNGKey(0))
    jsh = jrules.tp_state_shardings(jstate, mesh)
    assert (jax.tree.map(lambda s: s.spec, jsh.opt_state[1][0].mu)
            == jax.tree.map(lambda s: s.spec, jsh.params))
    specs = _port_specs()
    assert specs["mu"] == specs["params"] == specs["nu"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = [str(getattr(k, "key", k)) for k in path]
        spec = tuple(jrules._spec_for(path, leaf, "model"))
        if names[:2] != ["encoder", "blocks"]:
            assert spec in ((), (None,) * leaf.ndim), names
            continue
        for i in range(W.L):  # the port keeps one leaf a block
            want[".".join(["encoder", "blocks", str(i), *names[2:]])] = spec[1:]
    got = {k: s for k, s in specs["params"].items() if s}
    assert got == {k: s for k, s in want.items() if any(s)}
    assert set(got) == {f"encoder.blocks.{i}.{m}.kernel" for i in range(W.L)
                        for m in ("ff1.w1", "ff1.w2", "ff2.w1", "ff2.w2", "mhsa.q_proj",
                                  "mhsa.k_proj", "mhsa.v_proj", "mhsa.pos_proj",
                                  "mhsa.out_proj")}
    with pytest.raises(ValueError, match="no axis 'model'"):
        rules.tp_param_shardings({}, pmesh.make_mesh())


# -- the step --------------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_matches_one_process_step(pool, case):
    """make_tp_train_step on 4 ranks (2 data x 2 model; rows 2 a rank,
    heads 1, d_ff 32) equals make_train_step on the whole batch of 8; every
    rank ends with the same gathered state and its model group's shards,
    and holds its replicated leaves bit-equal to every other rank's."""
    res = run_case(pool, case)
    ref = res[0]["reference"]
    assert res[0]["rows"] == 8 // 2
    assert_steps_match(res[0], ref, ref["grads"])
    specs = _port_specs()["params"]
    mesh, _, _ = CASES[case]
    model_dim = mesh["axes"].index("model")
    for r in res:
        for part in ("params", "mu", "nu"):
            for k, v in res[0][part].items():
                assert np.array_equal(r[part][k], v), (part, k)
            for k, v in r["local"][part].items():
                d = rules._dim(specs[k])
                if d < 0:
                    assert np.array_equal(v, res[0]["local"][part][k]), (part, k)
                    continue
                full = res[0][part][k]
                assert v.shape[d] * 2 == full.shape[d], k
                i = r["coords"][model_dim]
                np.testing.assert_array_equal(np.split(full, 2, axis=d)[i], v, err_msg=k)


def test_one_rank_tp_step_is_the_one_process_step():
    """Without a process group the (1, 1) mesh's TP step gives the
    one-process step's bits, at dropout 0.1."""
    from onebit_asr_tpu_torch.train.step import (
        batch_to_device,
        make_tp_train_step,
        make_train_step,
    )
    from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens

    mesh = pmesh.make_mesh((1, 1), ("data", "model"))
    out = []
    for tp in (False, True):
        model, state = W._model({"dropout": 0.1})
        opt = W._optimizer()
        args = (model, opt, LossConfig(), SpecialTokens(), W.L)
        if tp:
            step = make_tp_train_step(*args, mesh)
            state = rules.shard_state_tp(state, mesh)
        else:
            step = make_train_step(*args)
        for b in W.batches():
            state, aux = step(state, batch_to_device(b, "cpu"))
        out.append((float(aux["loss"]), float(aux["grad_norm"]), state.params))
    assert out[1][:2] == out[0][:2]
    assert all(torch.equal(out[1][2][k], v) for k, v in out[0][2].items())


@pytest.fixture(scope="module")
def jax_tp():
    """Two steps of JAX's GSPMD TP step: the jitted make_train_step on a
    state that shard_state_tp laid out over ("data", "model") = (2, 2), the
    batch over "data"."""
    cfg = W.config()
    jcfg = dataclasses.replace(jc.ModelConfig(), remat_blocks=False, **W.SMALL)
    params = jax.tree.map(jnp.asarray, convert.init_params(cfg, 0))
    model = JaxASR.from_config(jcfg, deterministic=True)
    opt = joptim.make_optimizer(jc.OptimConfig(warmup_steps=W.WARMUP), W.TOTAL)
    state = JaxTrainState(step=jnp.int32(0), params=params, opt_state=opt.init(params),
                          rng=jax.random.PRNGKey(0))
    mesh = jmesh.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:WORLD])
    state = jrules.shard_state_tp(state, mesh)
    rows = NamedSharding(mesh, P("data"))
    auxes = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "sample_sp_mask", lambda *a, **k: jnp.asarray(W.SP_MASK))
        step = jax.jit(jstep.make_train_step(model, opt, jc.LossConfig(), jc.SpecialTokens(),
                                             W.L))
        for b in W.batches():
            state, aux = step(state, {k: jax.device_put(v, rows) for k, v in b.items()})
            auxes.append({k: float(v) for k, v in aux.items()})
    assert state.params["encoder"]["blocks"]["ff1"]["w1"]["kernel"].sharding.spec == P(
        None, None, "model")
    return auxes


def test_tp_step_matches_jax(pool, jax_tp):
    """The port's TP step on (data 2, model 2) equals JAX's GSPMD TP step on
    4 devices: the same parameters, batches and sp mask, dropout 0."""
    got = run_case(pool, "dropout0")[0]["aux"]
    for g, r in zip(got, jax_tp):
        assert set(g) == set(r)
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, err_msg=k)


# -- the CLI ---------------------------------------------------------------------------------


def test_torchrun_tensor_parallel_trains_saves_and_resumes(tmp_path):
    """`--tensor_parallel 2` over 2 gloo ranks: an epoch, then a --resume
    epoch from its checkpoint; rank 0 alone logs and saves the full state in
    a one-process run's format, which a one-process run resumes and JAX
    evaluates as the port does."""
    base = [*TINY_CLI, "--save_dir", str(tmp_path), "--run_name", "tp", "--batch_size", "4",
            "--compute_dtype", "float32"]
    common = [*base, "--tensor_parallel", "2"]
    first = _torchrun([*common, "--epochs", "1"])
    assert first.returncode == 0, first.stderr[-3000:]
    assert first.stdout.count("tensor parallelism: 2-way model axis x 1 data") == 1
    second = _torchrun([*common, "--epochs", "2", "--resume"])
    assert second.returncode == 0, second.stderr[-3000:]
    assert second.stdout.count("resumed at step 2 (epoch 1)") == 1
    run_dir = tmp_path / "tp"
    assert sorted(os.listdir(run_dir / "ckpt")) == ["step_2.pt", "step_4.pt"]
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [2, 4]
    saved = torch.load(run_dir / "ckpt" / "step_4.pt", weights_only=True)
    cfg = load_config(str(run_dir)).model
    want = {k: tuple(v.shape) for k, v in convert.qat_model_from_jax(
        cfg, convert.init_params(cfg, 0), device="cpu").named_parameters()}
    for part in ("params", "mu", "nu"):
        assert {k: tuple(v.shape) for k, v in saved[part].items()} == want, part

    # a one-process run resumes it
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert train_cli.main([*base, "--epochs", "3", "--resume"]) == 0
    assert "resumed at step 4 (epoch 2)" in out.getvalue()

    # JAX evaluates the TP run's parameters as the port does
    from onebit_asr_tpu_torch.data import DummyDataModule
    from onebit_asr_tpu_torch.train.step import batch_to_device, make_eval_step
    from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens

    tree = convert.jax_tree_from_state_dict(saved["params"], cfg)
    jcfg = dataclasses.replace(jc.ModelConfig(), remat_blocks=False,
                               **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                                  if f.name != "specials" and hasattr(jc.ModelConfig, f.name)})
    batch = next(iter(DummyDataModule(batch_size=2, max_frames=64,
                                      vocab_size=cfg.vocab_size).valid_batches()))
    _, _, jloss = jstep.make_eval_step(JaxASR.from_config(jcfg), jc.LossConfig(),
                                       jc.SpecialTokens(), cfg.enc_layers, 2)(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.qat_model_from_jax(cfg, tree, device="cpu")
    _, _, loss = make_eval_step(model, LossConfig(), SpecialTokens(), cfg.enc_layers, 2)(
        dict(model.named_parameters()), batch_to_device(batch, "cpu"))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


TP_REFUSALS = [
    (["--fsdp"], 1, "FATAL: --tensor_parallel composes with data parallelism"),
    (["--pipeline_stages", "2"], 1, "FATAL: --tensor_parallel composes with data parallelism"),
    (["--multistep", "2"], 1, "FATAL: --multistep composes only with the plain QAT path"),
    (["--fp32_control"], 1, "FATAL: --tensor_parallel does not compose with --fp32_control"),
    ([], 1, "FATAL: 1 devices not divisible by --tensor_parallel 2"),
    (["--world", "4", "--batch_size", "3"], 1, "FATAL: batch 3 not divisible by data axis 2"),
    (["--world", "4", "--tensor_parallel", "4"], 1,
     "FATAL: --tensor_parallel 4 does not divide enc_heads 2"),
    (["--world", "6", "--tensor_parallel", "3", "--enc_heads", "3"], 1,
     "FATAL: --tensor_parallel 3 does not divide enc_d_ff 64"),
]


@pytest.mark.parametrize("flags,code,message", TP_REFUSALS)
def test_cli_refuses_tensor_parallel_beside(flags, code, message, tmp_path, capsys,
                                            monkeypatch):
    """JAX's exit codes and messages for what --tensor_parallel does not
    compose with (cli/train.py:401-426, :529-533), and the port's own for
    --fp32_control and a TP that does not divide the heads or d_ff; all
    before any process group or file (`--world N` here stands for N ranks
    under torchrun)."""
    argv = [*TINY_CLI, "--save_dir", str(tmp_path), "--batch_size", "4", "--tensor_parallel",
            "2"]
    if flags[:1] == ["--world"]:
        n_world = int(flags[1])
        monkeypatch.setattr(pmesh, "world", lambda: (0, n_world))
        flags = flags[2:]
    assert train_cli.main([*argv, *flags]) == code
    assert message in capsys.readouterr().out
    assert not os.listdir(tmp_path)

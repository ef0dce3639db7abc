"""onebit_asr_tpu_torch's step options against the JAX package, on CPU:
`grad_accum`, the K-step form, the no-QAT control, and the train CLI's
`--grad_accum`, `--multistep`, `--fp32_control` and `--profile_dir`.

The model and data are tests/test_torch_train.py's (2 encoder blocks, d=64,
vocab 32, f32, dropout 0, params from `convert.init_params`), at B=4 so
that the batch splits into 2 micro-batches of 2. The stochastic-precision
mask is pinned on both sides (`sample_sp_mask` patched in each package's
step module; under JAX's scan both of the K steps read the same constant).
Two JAX compiles cover the three options: `make_multi_train_step(K=2,
grad_accum=2)` and `make_fp32_train_step(grad_accum=2)`, each for 2
optimizer steps. Tolerances, as test_torch_train.py's `_two_steps`:

- every aux term and `grad_norm` (the K-step form: their means over K and
  `losses`) rtol 1e-5, atol 1e-6;
- the AdamW moments m and sqrt(v) rtol 1e-4, atol 2e-6 x the largest
  element of JAX's (the gradients are not returned by a step; m and
  sqrt(v) are within a factor 0.2 of them);
- the parameters atol 1e-5 (2% of one step at lr 5e-4), masking the
  elements where JAX's sqrt(v) is below 1.4e-7, that is where no step's
  gradient reached ~1e-6: there AdamW's direction g / (|g| + 1e-8) is set
  by f32 noise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.train import optim as joptim
from onebit_asr_tpu.train import step as jstep
from onebit_asr_tpu.train.state import TrainState as JaxState
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import train as cli
from onebit_asr_tpu_torch.data.dummy import DummyDataModule
from onebit_asr_tpu_torch.train import step as tstep
from onebit_asr_tpu_torch.train.optim import AdamW
from onebit_asr_tpu_torch.train.state import create_train_state
from onebit_asr_tpu_torch.utils import profiling
from onebit_asr_tpu_torch.utils.config import LossConfig, OptimConfig, SpecialTokens
from test_torch_train import TINY_CLI, _configs
from torch_cpu_threads import one_thread  # noqa: F401

SP_MASK = np.array([True, False])
GRAD_ACCUM = 2


def _batches(n=2):
    dm = DummyDataModule(batch_size=4, max_frames=72, max_tokens=6, vocab_size=32)
    return list(dm.train_batches(0))[:n]


def _run(kind):
    """2 optimizer steps of `kind` ("multi": the K=2 form, or "fp32": the
    control, one call a step), grad_accum 2, in JAX and in the port from the
    same params, batches and pinned mask. -> (jax, port) dicts of aux (per
    call), params, mu, nu as {state-dict name: tensor}."""
    jcfg, cfg = _configs()
    params = convert.init_params(cfg, 0)
    batches = _batches()
    sd = lambda tree: convert.state_dict_from_jax(convert.to_torch(tree), cfg)  # noqa: E731
    jmodel = JaxASR.from_config(jcfg, deterministic=True)
    jopt = joptim.make_optimizer(jc.OptimConfig(warmup_steps=1), 10)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JaxState(step=jnp.int32(0), params=jp, opt_state=jopt.init(jp),
                      rng=jax.random.PRNGKey(0))
    model = convert.qat_model_from_jax(cfg, params, device="cpu")
    state = create_train_state(model, 0)
    topt = AdamW(OptimConfig(warmup_steps=1), 10)
    args = (jc.LossConfig(), jc.SpecialTokens(), 2)
    targs = (LossConfig(), SpecialTokens(), 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "sample_sp_mask", lambda *a, **k: jnp.asarray(SP_MASK))
        mp.setattr(tstep, "sample_sp_mask", lambda *a, **k: torch.from_numpy(SP_MASK))
        if kind == "multi":
            jfn = jax.jit(jstep.make_multi_train_step(jmodel, jopt, *args, grad_accum=GRAD_ACCUM))
            tfn = tstep.make_multi_train_step(model, topt, *targs, grad_accum=GRAD_ACCUM)
            calls = [(jstep.stack_batches(batches), tstep.stack_batches(
                [tstep.batch_to_device(b, "cpu") for b in batches]))]
        else:
            jfn = jax.jit(jstep.make_fp32_train_step(jmodel, jopt, *args, grad_accum=GRAD_ACCUM))
            tfn = tstep.make_fp32_train_step(model, topt, *targs, grad_accum=GRAD_ACCUM)
            calls = [(b, tstep.batch_to_device(b, "cpu")) for b in batches]
        jaux, taux = [], []
        for jb, tb in calls:
            jstate, a = jfn(jstate, {k: jnp.asarray(v) for k, v in jb.items()})
            jaux.append({k: np.asarray(v) for k, v in a.items()})
            state, a = tfn(state, tb)
            taux.append({k: v.numpy() for k, v in a.items()})
    adam = jstate.opt_state[1][0]
    jax_out = dict(aux=jaux, params=sd(jstate.params), mu=sd(adam.mu), nu=sd(adam.nu),
                   step=int(jstate.step))
    port_out = dict(aux=taux, params=state.params, mu=state.mu, nu=state.nu, step=state.step)
    return jax_out, port_out


@pytest.fixture(scope="module")
def multi_steps():
    return _run("multi")


@pytest.fixture(scope="module")
def fp32_steps():
    return _run("fp32")


def _assert_aux_match(j, t, keys):
    assert len(j["aux"]) == len(t["aux"])
    for ja, ta in zip(j["aux"], t["aux"]):
        assert set(ja) == set(ta) == keys
        for k in keys:
            assert ta[k].shape == ja[k].shape, k
            np.testing.assert_allclose(ta[k], ja[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _assert_state_match(j, t):
    assert t["step"] == j["step"] == 2
    for name in ("mu", "nu"):
        ref = {k: v.numpy() for k, v in j[name].items()}
        got = {k: v.detach().numpy() for k, v in t[name].items()}
        if name == "nu":
            ref = {k: np.sqrt(v) for k, v in ref.items()}
            got = {k: np.sqrt(v) for k, v in got.items()}
        assert set(got) == set(ref)
        scale = max(float(np.abs(v).max()) for v in ref.values())
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=2e-6 * scale,
                                       err_msg=f"{name} {k}")
    masked = total = 0
    for k, ref in j["params"].items():
        keep = np.sqrt(j["nu"][k].numpy()) >= 1.4e-7
        masked += int((~keep).sum())
        total += keep.size
        np.testing.assert_allclose(t["params"][k].detach().numpy()[keep], ref.numpy()[keep],
                                   rtol=0, atol=1e-5, err_msg=k)
    assert masked < 0.3 * total


QAT_AUX = {"loss", "loss_int_2bit", "loss_int_1bit", "loss_int_sp", "loss_att_2bit",
           "loss_ctc_2bit", "loss_kl_1bit", "loss_kl_sp", "grad_norm"}
FP32_AUX = {"loss", "loss_att_32bit", "loss_ctc_32bit", "grad_norm"}


def test_multi_step_with_grad_accum_aux_matches_jax(multi_steps):
    """K=2 steps of grad_accum 2 in one call: each aux term's mean over K,
    `losses` [2] and the mean grad_norm."""
    _assert_aux_match(*multi_steps, QAT_AUX | {"losses"})
    assert multi_steps[1]["aux"][0]["losses"].shape == (2,)


def test_multi_step_with_grad_accum_params_and_moments_match_jax(multi_steps):
    _assert_state_match(*multi_steps)


def test_fp32_step_with_grad_accum_aux_matches_jax(fp32_steps):
    _assert_aux_match(*fp32_steps, FP32_AUX)


def test_fp32_step_with_grad_accum_params_and_moments_match_jax(fp32_steps):
    _assert_state_match(*fp32_steps)


# -- the port's own step contracts --------------------------------------------


def _model(dropout=0.0, seed=0):
    _, cfg = _configs(dropout=dropout)
    return convert.qat_model_from_jax(cfg, convert.init_params(cfg, seed), device="cpu")


@pytest.mark.parametrize("make", [tstep.make_train_step, tstep.make_fp32_train_step])
def test_indivisible_batch_raises(make):
    model = _model()
    step = make(model, AdamW(OptimConfig(), 10), LossConfig(), SpecialTokens(), 2,
                grad_accum=3)
    state = create_train_state(model, 0)
    with pytest.raises(ValueError, match="batch 4 not divisible by grad_accum 3"):
        step(state, tstep.batch_to_device(_batches(1)[0], "cpu"))


def test_grad_accum_averages_the_micro_batches_gradients():
    """accumulated_value_and_grad(grad_accum=2) is the mean of the two
    halves' losses, aux and gradients, each half keeping the whole batch's
    T and U; dropout 0.1 with micro_seed(seed, i) for half i."""
    model = _model(dropout=0.1)
    params = dict(model.named_parameters())
    batch = tstep.batch_to_device(_batches(1)[0], "cpu")
    loss_fn = tstep.make_batch_loss(model, LossConfig(), SpecialTokens(), 2)
    sp = torch.from_numpy(SP_MASK)
    seeds = [11, 12, 13]
    (loss, aux), grads = tstep.accumulated_value_and_grad(loss_fn, params, batch, sp, seeds,
                                                          True, grad_accum=2)
    halves = []
    for i in range(2):
        half = {k: v[2 * i : 2 * i + 2] for k, v in batch.items()}
        assert half["feats"].shape[1:] == batch["feats"].shape[1:]
        gens = [torch.Generator().manual_seed(tstep.micro_seed(s, i)) for s in seeds]
        halves.append(tstep.value_and_grad(loss_fn, params, half, sp, gens))
    assert torch.equal(loss, aux["loss"])
    for k in aux:
        torch.testing.assert_close(aux[k], (halves[0][0][1][k] + halves[1][0][1][k]) / 2,
                                   rtol=0, atol=0)
    for k in grads:
        torch.testing.assert_close(grads[k], (halves[0][1][k] + halves[1][1][k]) / 2,
                                   rtol=0, atol=0)
    assert len({tstep.micro_seed(s, i) for s in seeds for i in range(2)}) == 6


def test_fp32_and_qat_steps_draw_the_same_stream_and_the_k_step_form_is_k_steps():
    """Dropout 0.1: the control step takes the same draws from the state's
    generator as the QAT step (resumes alike), and make_multi_train_step on
    a stacked batch equals its K single steps bit for bit."""
    batches = [tstep.batch_to_device(b, "cpu") for b in _batches()]
    opt = lambda: AdamW(OptimConfig(warmup_steps=1), 10)  # noqa: E731
    gens = []
    for make in (tstep.make_train_step, tstep.make_fp32_train_step):
        model = _model(dropout=0.1)
        state = create_train_state(model, 5)
        step = make(model, opt(), LossConfig(), SpecialTokens(), 2, grad_accum=2)
        state, aux = step(state, batches[0])
        assert all(np.isfinite(float(v)) for v in aux.values())
        gens.append(state.generator.get_state())
    assert torch.equal(*gens)
    states, auxes = [], []
    for multi in (False, True):
        model = _model(dropout=0.1)
        state = create_train_state(model, 5)
        args = (model, opt(), LossConfig(), SpecialTokens(), 2)
        if multi:
            state, aux = tstep.make_multi_train_step(*args)(state, tstep.stack_batches(batches))
            auxes.append(aux["losses"])
        else:
            step = tstep.make_train_step(*args)
            losses = []
            for b in batches:
                state, aux = step(state, b)
                losses.append(aux["loss"])
            auxes.append(torch.stack(losses))
        states.append(state)
    assert torch.equal(*auxes)
    assert states[0].step == states[1].step == 2
    for k in states[0].params:
        assert torch.equal(states[0].params[k], states[1].params[k]), k


# -- the CLI --------------------------------------------------------------------


def _cli(tmp_path, run_name, *flags):
    return ["--device", "cpu", "--dummy_data", "--batch_size", "4", "--eval_batches", "1",
            "--dummy_frames", "48", "--warmup_steps", "1", "--dropout", "0.1",
            "--save_dir", str(tmp_path), "--run_name", run_name, *TINY_CLI, *flags]


def _metrics(run):
    with open(run / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_cli_grad_accum_and_multistep_train_save_and_resume(tmp_path, capsys):
    """--grad_accum 2 --multistep 2 at dropout 0.1: 3 steps an epoch (one
    stacked pair, one leftover), saved, then resumed for a second epoch;
    host_rss_gb is logged."""
    argv = _cli(tmp_path, "ms", "--grad_accum", "2", "--multistep", "2", "--steps_per_epoch",
                "3")
    assert cli.main(argv + ["--epochs", "1"]) == 0
    assert sorted(os.listdir(tmp_path / "ms" / "ckpt")) == ["step_3.pt"]
    assert cli.main(argv + ["--epochs", "2", "--resume"]) == 0
    assert "resumed at step 3 (epoch 1)" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "ms" / "ckpt")) == ["step_3.pt", "step_6.pt"]
    lines = _metrics(tmp_path / "ms")
    assert [m["step"] for m in lines] == [3, 6]
    assert all(np.isfinite(m["train_loss"]) and m["host_rss_gb"] > 0 for m in lines)
    assert all(f"wer_{t}" in m for m in lines for t in ("32bit", "2bit", "1bit"))


def test_cli_fp32_control_evaluates_32bit_only_and_profiles(tmp_path, capsys):
    """--fp32_control logs only the 32-bit evaluation and keeps its best
    checkpoint by it; --profile_dir writes a non-empty Chrome trace of the
    first epoch."""
    prof = tmp_path / "prof"
    assert cli.main(_cli(tmp_path, "fp", "--fp32_control", "--epochs", "1",
                         "--steps_per_epoch", "1", "--profile_dir", str(prof))) == 0
    out = capsys.readouterr().out
    assert "fp32 control" in out and "val(32bit)" in out
    (m,) = _metrics(tmp_path / "fp")
    assert {k for k in m if k.startswith(("loss_", "wer_", "cer_"))} == {
        "loss_32bit", "wer_32bit", "cer_32bit"}
    assert os.listdir(tmp_path / "fp" / "ckpt_best") == ["step_1.pt"]
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_cli_refuses_multistep_with_fp32_control(tmp_path, capsys):
    rc = cli.main(_cli(tmp_path, "x", "--multistep", "2", "--fp32_control"))
    assert rc == 1
    assert ("FATAL: --multistep composes only with the plain QAT path"
            in capsys.readouterr().out)
    assert not os.listdir(tmp_path)


# -- utils/profiling --------------------------------------------------------------


def test_profiling_helpers():
    timer = profiling.StepTimer()
    timer.start()
    dt = timer.stop({"a": [torch.ones(3)], "b": (torch.zeros(()),)}, n=4)
    assert dt >= 0 and timer.count == 4 and timer.per_sec() > 0
    assert 0 < profiling.host_rss_gb() < 1024
    assert isinstance(profiling.malloc_trim(), bool)
    profiling.debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()


def test_stack_batches_of_arrays_and_tensors():
    batches = _batches()
    stacked = tstep.stack_batches(batches)
    assert stacked["feats"].shape == (2, 4, 72, 80) and isinstance(stacked["feats"], np.ndarray)
    tensors = tstep.stack_batches([tstep.batch_to_device(b, "cpu") for b in batches])
    for k in stacked:
        np.testing.assert_array_equal(tensors[k].numpy(), stacked[k])

"""onebit_asr_tpu_torch's training slice against the JAX package, on CPU.

A small model (2 encoder blocks, d=64, 2 heads, 1 decoder layer, vocab 32)
gets its parameters from the port's `convert.init_params`; the same numpy
tree goes to the JAX model and, converted, to the port's QAT model. Inputs
are made with numpy from fixed seeds. Tolerances, with their reasons:

- STE quantizer, FastDropout, decoder, attention losses, optimizer: f32
  arithmetic of the same formulas in two libraries (rtol 1e-6 to 1e-5);
- the 3-branch loss at f32 with dropout 0: the loss and every aux term
  rtol 1e-5 (observed <= 2.5e-6); gradients rtol 1e-4 with atol 2e-6 x the
  largest gradient element (the leaves whose gradient is 0 in exact
  arithmetic, k and position biases, hold f32 noise of ~1e-8 on both
  sides); after two steps the moments m and sqrt(v) at the gradients'
  tolerance, and the parameters at atol 1e-5 (2% of one step at lr 5e-4),
  masking the elements whose JAX gradient is below 1e-6 in either step: at
  such elements AdamW's direction g / (|g| + 1e-8) is set by f32 noise
  (observed 6e-5 unmasked, 1e-6 masked; 19% of elements masked, most of them
  exactly 0 on both sides where the STE passes nothing);
- bf16 compute: both sides round every layer to bf16 at slightly different
  points; loss terms rtol 1e-2, atol 1e-3 (observed <= 1.2e-3 relative,
  7e-4 absolute on the smallest KL term), the gradient norm rtol 1e-2 and
  the gradients' cosine similarity >= 0.99.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onebit_asr_tpu.losses import attention as jatt
from onebit_asr_tpu.model import layers as jlayers
from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.model.decoder import TransformerDecoder as JaxDecoder
from onebit_asr_tpu.ops.quant import quantize_weight as jax_quantize
from onebit_asr_tpu.train import optim as joptim
from onebit_asr_tpu.train import step as jstep
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import train as cli
from onebit_asr_tpu_torch.data.dummy import DummyDataModule
from onebit_asr_tpu_torch.eval.evaluate import evaluate_stream
from onebit_asr_tpu_torch.losses import attention as tatt
from onebit_asr_tpu_torch.model.asr import ConformerASR
from onebit_asr_tpu_torch.model.layers import DropoutRng, FastDropout
from onebit_asr_tpu_torch.ops.quant import quantize_weight
from onebit_asr_tpu_torch.train.optim import AdamW, warmup_cosine_schedule
from onebit_asr_tpu_torch.train.state import create_train_state
from onebit_asr_tpu_torch.train.step import (
    batch_to_device,
    make_batch_loss,
    make_train_step,
    sp_layer_probs,
    value_and_grad,
)
from onebit_asr_tpu_torch.utils.config import (
    LossConfig,
    ModelConfig,
    OptimConfig,
    SpecialTokens,
)
from torch_cpu_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=32, enc_d_model=64, enc_layers=2, enc_heads=2, enc_d_ff=128,
             enc_conv_kernel=7, dec_layers=1, dec_heads=2, dec_d_ff=64, dropout=0.0)
TINY_CLI = ["--enc_layers", "2", "--enc_d_model", "64", "--enc_heads", "2", "--enc_d_ff", "128",
            "--enc_conv_kernel", "7", "--dec_layers", "1", "--dec_d_ff", "64"]


def _configs(compute_dtype="float32", **kw):
    both = dict(SMALL, compute_dtype=compute_dtype, **kw)
    jcfg = dataclasses.replace(jc.ModelConfig(), remat_blocks=False, **both)
    return jcfg, dataclasses.replace(ModelConfig(), **both)


# -- the straight-through quantizer ------------------------------------------


@pytest.mark.parametrize("alpha", [0.0, 1e-30, 1e30, 0.7, -0.3])
@pytest.mark.parametrize("bits", [1, 2, 32])
def test_quantizer_forward_and_grads_match_jax(alpha, bits):
    """W/a at exactly +-0.5, +-1, +-4 and 0, plus random values, with
    a = |alpha| + 1e-8 (alpha 0 and 1e-30 both give a = 1e-8)."""
    rng = np.random.default_rng(0)
    a = np.float32(abs(np.float32(alpha)) + np.float32(1e-8))
    ratios = np.array([0.5, -0.5, 1.0, -1.0, 4.0, -4.0, 0.0, 0.25, 2.0], np.float32)
    wa = np.concatenate([ratios, rng.uniform(-3, 3, 39).astype(np.float32)]).reshape(6, 8)
    w = (wa * a).astype(np.float32)
    g = rng.standard_normal(w.shape).astype(np.float32)

    def jf(w_, al):
        return jnp.sum(jax_quantize(w_, al, bits) * g)

    jq = np.asarray(jax_quantize(jnp.asarray(w), jnp.float32(alpha), bits))
    jgw, jga = jax.grad(jf, argnums=(0, 1))(jnp.asarray(w), jnp.float32(alpha))
    tw = torch.from_numpy(w).requires_grad_(True)
    ta = torch.tensor(alpha, dtype=torch.float32, requires_grad=True)
    tq = quantize_weight(tw, ta, bits)
    (tq * torch.from_numpy(g)).sum().backward()
    ga = torch.zeros(()) if ta.grad is None else ta.grad  # bits 32 does not read alpha
    for got, ref in ((tq.detach(), jq), (tw.grad, jgw), (ga, jga)):
        got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(ref).max()))


def test_quantizer_bool_bits_is_a_layer_mask():
    w = torch.tensor([[0.3, -0.1], [0.0, 2.0]])
    alpha = torch.tensor(1.0)
    assert torch.equal(quantize_weight(w, alpha, True), quantize_weight(w, alpha, 1))
    assert torch.equal(quantize_weight(w, alpha, False), quantize_weight(w, alpha, 2))
    with pytest.raises(ValueError):
        quantize_weight(w, alpha, 3)


# -- FastDropout ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_fast_dropout_with_jax_draws_matches_jax(rate, dtype, monkeypatch):
    """JAX's FastDropout draws uint32 words and splits them into bytes; the
    test takes those bytes and injects them into the port's FastDropout."""
    words = []
    real_bits = jax.random.bits

    def recording_bits(*a, **k):
        words.append(real_bits(*a, **k))
        return words[-1]

    monkeypatch.setattr(jax.random, "bits", recording_bits)
    x = np.random.default_rng(1).standard_normal((2, 5, 7)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ref = jlayers.FastDropout(rate, deterministic=False).apply(
        {}, jx, rngs={"dropout": jax.random.PRNGKey(3)})
    (w,) = words
    draws = np.asarray(jax.lax.bitcast_convert_type(w, jnp.uint8)).reshape(2, 5, -1)[..., :7]
    rng = DropoutRng()
    rng.draws = lambda shape, device: torch.from_numpy(np.ascontiguousarray(draws))
    got = FastDropout(rate, rng)(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    rng.draws = None  # no draws: the identity, as a deterministic JAX module
    assert torch.equal(FastDropout(rate, rng)(torch.from_numpy(x)), torch.from_numpy(x))


# -- pieces against JAX ----------------------------------------------------------


def test_decoder_forward_matches_jax():
    _, cfg = _configs()
    params = convert.init_params(cfg, 1)
    rng = np.random.default_rng(2)
    B, U, T, D = 3, 6, 11, cfg.enc_d_model
    tgt = rng.integers(0, cfg.vocab_size, (B, U)).astype(np.int32)
    valid = np.arange(U)[None] < np.array([[6], [3], [1]])
    memory = rng.standard_normal((B, T, D)).astype(np.float32)
    mem_mask = np.arange(T)[None] < np.array([[11], [7], [4]])
    jdec = JaxDecoder(cfg.vocab_size, D, cfg.dec_layers, cfg.dec_heads, cfg.dec_d_ff, 0.0,
                      compute_dtype=jnp.float32)
    ref = jdec.apply({"params": params["decoder"]}, tgt, memory, mem_mask, valid)
    model = convert.qat_model_from_jax(cfg, params, device="cpu")
    got = model.decoder(torch.from_numpy(tgt).long(), torch.from_numpy(memory),
                        torch.from_numpy(mem_mask), torch.from_numpy(valid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_attention_losses_match_jax():
    rng = np.random.default_rng(3)
    B, U, V = 4, 5, 13
    tokens = rng.integers(4, V, (B, U)).astype(np.int32)
    lens = np.array([5, 3, 0, 1], np.int32)
    sp = SpecialTokens()
    jt = jatt.make_att_targets(jnp.asarray(tokens), jnp.asarray(lens), jc.SpecialTokens())
    tt = tatt.make_att_targets(torch.from_numpy(tokens).long(), torch.from_numpy(lens).long(), sp)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, tgt_out, valid = jt
    logits, student = (rng.standard_normal((B, U + 1, V)).astype(np.float32) * 3 for _ in range(2))
    ce = jatt.att_ce_loss(jnp.asarray(logits), tgt_out, valid, 0.1)
    kl = jatt.kl_logits(jnp.asarray(logits), jnp.asarray(student), valid)
    t_valid = torch.from_numpy(np.array(valid))
    np.testing.assert_allclose(
        float(tatt.att_ce_loss(torch.from_numpy(logits), tt[1], t_valid, 0.1)), float(ce), rtol=1e-6)
    tl, ts = torch.from_numpy(logits).requires_grad_(True), torch.from_numpy(student).requires_grad_(True)
    tkl = tatt.kl_logits(tl, ts, t_valid)
    np.testing.assert_allclose(float(tkl.detach()), float(kl), rtol=1e-5)
    tkl.backward()
    assert tl.grad is None or float(tl.grad.abs().max()) == 0.0  # the teacher is detached
    jgs = jax.grad(lambda s: jatt.kl_logits(jnp.asarray(logits), s, valid))(jnp.asarray(student))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgs), rtol=1e-5, atol=1e-7)


# -- the optimizer ----------------------------------------------------------------


def test_schedule_matches_jax():
    jsched = joptim.warmup_cosine_schedule(5e-4, 4, 20, 0.1)
    tsched = warmup_cosine_schedule(5e-4, 4, 20, 0.1)
    assert tsched(0) == 0.0
    for step in (0, 1, 3, 4, 5, 12, 19, 20, 25):
        np.testing.assert_allclose(float(tsched(step)), float(jsched(step)), rtol=1e-6)


def test_clip_adamw_schedule_match_optax():
    """Three steps across the warmup boundary (warmup 2: lr 0, lr/2, lr)
    on a fixed gradient sequence whose first step is clipped."""
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (4.0, 0.3, 1e-3)]
    cfg = OptimConfig(lr=1e-2, warmup_steps=2)
    jopt = joptim.make_optimizer(jc.OptimConfig(lr=1e-2, warmup_steps=2), 10)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt = AdamW(cfg, 10)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in tp.items()}
    nu = {k: torch.zeros_like(v) for k, v in tp.items()}
    for count, g in enumerate(grads):
        assert (optax.global_norm(g) > cfg.grad_clip_norm) == (count == 0)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        gn = topt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, mu, nu, count)
        np.testing.assert_allclose(float(gn), float(optax.global_norm(g)), rtol=1e-6)
        adam = jstate[1][0]
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(mu[k].numpy(), np.asarray(adam.mu[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6, atol=1e-12)
    assert not np.allclose(tp["a"].numpy(), params["a"])


# -- the whole 3-branch step ----------------------------------------------------------

SP_MASKS = [np.array([True, False]), np.array([False, True])]


def _two_steps(compute_dtype, steps=2, loss=None, sp_masks=SP_MASKS, **flags):
    """`steps` (two) steps of (3-branch loss, grads, clip + AdamW) in JAX and
    in the port, from the same converted params, batches and sp masks
    (`sp_masks`), dropout 0; `flags` go to both models' configs, `loss` (a
    dict of LossConfig fields) to both loss configs."""
    jcfg, cfg = _configs(compute_dtype, **flags)
    params = convert.init_params(cfg, 0)
    dm = DummyDataModule(batch_size=3, max_frames=72, max_tokens=6, vocab_size=32)
    batches = list(dm.train_batches(0))[:steps]
    jmodel = JaxASR.from_config(jcfg, deterministic=True)
    jvg = jax.jit(jax.value_and_grad(
        jstep.make_batch_loss(jmodel, jc.LossConfig(**(loss or {})), jc.SpecialTokens(), 2),
        has_aux=True))
    jopt = joptim.make_optimizer(jc.OptimConfig(warmup_steps=1), 10)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(3)])
    model = convert.qat_model_from_jax(cfg, params, device="cpu")
    state = create_train_state(model, 0)
    batch_loss = make_batch_loss(model, LossConfig(**(loss or {})), SpecialTokens(), 2)
    topt = AdamW(OptimConfig(warmup_steps=1), 10)
    sd = lambda tree: convert.state_dict_from_jax(convert.to_torch(tree), cfg)  # noqa: E731
    steps = []
    for b, sp in zip(batches, sp_masks):
        (jl, jaux), jg = jvg(jp, {k: jnp.asarray(v) for k, v in b.items()}, jnp.asarray(sp), keys)
        updates, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        (tl, taux), tg = value_and_grad(batch_loss, state.params, batch_to_device(b, "cpu"),
                                        torch.from_numpy(sp), [None] * 3)
        gn = topt.update(state.params, tg, state.mu, state.nu, state.count)
        state.count += 1
        adam = jstate[1][0]
        steps.append(dict(
            jax=dict(loss=float(jl), aux={k: float(v) for k, v in jaux.items()},
                     grad_norm=float(optax.global_norm(jg)), grads=sd(jg), params=sd(jp),
                     mu=sd(adam.mu), nu=sd(adam.nu)),
            port=dict(loss=float(tl), aux={k: float(v) for k, v in taux.items()},
                      grad_norm=float(gn), grads=tg,
                      params={k: v.detach().clone() for k, v in state.params.items()},
                      mu={k: v.clone() for k, v in state.mu.items()},
                      nu={k: v.clone() for k, v in state.nu.items()})))
    return steps


@pytest.fixture(scope="module")
def f32_steps():
    return _two_steps("float32")


def _assert_grads_close(got, ref, scale):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=2e-6 * scale,
                                   err_msg=k)


def assert_loss_and_grads_match(steps):
    for step in steps:
        j, t = step["jax"], step["port"]
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        assert set(t["aux"]) == set(j["aux"])
        for k in j["aux"]:
            np.testing.assert_allclose(t["aux"][k], j["aux"][k], rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-5)
        scale = max(float(g.abs().max()) for g in j["grads"].values())
        _assert_grads_close(t["grads"], j["grads"], scale)


def test_batch_loss_and_grads_match_jax(f32_steps):
    assert_loss_and_grads_match(f32_steps)


def assert_params_and_moments_match(steps):
    """After the last of `steps`: m and sqrt(v) at the gradients' tolerance,
    the parameters at atol 1e-5 where JAX's gradient exceeds 1e-6 in every
    step."""
    j, t = steps[-1]["jax"], steps[-1]["port"]
    scale = max(float(g.abs().max()) for g in j["grads"].values())
    _assert_grads_close(t["mu"], j["mu"], scale)
    _assert_grads_close({k: v.sqrt() for k, v in t["nu"].items()},
                        {k: v.sqrt() for k, v in j["nu"].items()}, scale)
    masked = total = 0
    for k, ref in j["params"].items():
        keep = np.ones(ref.shape, bool)
        for step in steps:
            keep &= step["jax"]["grads"][k].abs().numpy() > 1e-6
        masked += int((~keep).sum())
        total += keep.size
        np.testing.assert_allclose(t["params"][k].numpy()[keep], ref.numpy()[keep], rtol=0,
                                   atol=1e-5, err_msg=k)
    assert masked < 0.3 * total
    # the step moved the parameters (the LR is 0 only at step 0)
    first = steps[0]["port"]["params"]
    assert any(not torch.equal(first[k], t["params"][k]) for k in first)


def test_params_and_moments_after_two_steps_match_jax(f32_steps):
    assert_params_and_moments_match(f32_steps)


def test_bf16_step_matches_jax_loosely():
    for step in _two_steps("bfloat16", steps=1):
        j, t = step["jax"], step["port"]
        for k in j["aux"]:
            np.testing.assert_allclose(t["aux"][k], j["aux"][k], rtol=1e-2, atol=1e-3, err_msg=k)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-2)
        flat_t = torch.cat([t["grads"][k].flatten() for k in j["grads"]])
        flat_j = torch.cat([j["grads"][k].flatten() for k in j["grads"]])
        cos = float(flat_t @ flat_j / (flat_t.norm() * flat_j.norm()))
        assert cos >= 0.99, cos


def test_dummy_data_and_sp_probs_match_jax():
    """The synthetic backend gives the JAX package's batches for a seed, and
    the stochastic-precision probabilities are JAX's."""
    from onebit_asr_tpu.data.dummy import DummyDataModule as JaxDummy

    kw = dict(batch_size=4, max_frames=64, max_tokens=6, num_train=8, num_valid=4, seed=3)
    for ours, theirs in ((DummyDataModule(**kw).train_batches(1), JaxDummy(**kw).train_batches(1)),
                         (DummyDataModule(**kw).valid_batches(), JaxDummy(**kw).valid_batches())):
        for a, b in zip(ours, theirs, strict=True):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(sp_layer_probs(12), jstep.sp_layer_probs(12))


def test_train_step_samples_mask_and_dropout_reproducibly():
    """make_train_step at dropout 0.1: finite aux with grad_norm, the step
    counter advances, and the same seed gives the same two steps."""
    _, cfg = _configs(dropout=0.1)
    dm = DummyDataModule(batch_size=2, max_frames=48, max_tokens=4, vocab_size=32)
    batch = batch_to_device(next(iter(dm.train_batches(0))), "cpu")
    runs = []
    for _ in range(2):
        model = convert.qat_model_from_jax(cfg, convert.init_params(cfg, 0), device="cpu")
        state = create_train_state(model, 7)
        step = make_train_step(model, AdamW(OptimConfig(warmup_steps=1), 10), LossConfig(),
                               SpecialTokens(), 2)
        losses = []
        for _ in range(2):
            state, aux = step(state, batch)
            assert set(aux) == {"loss", "loss_int_2bit", "loss_int_1bit", "loss_int_sp",
                                "loss_att_2bit", "loss_ctc_2bit", "loss_kl_1bit", "loss_kl_sp",
                                "grad_norm"}
            assert all(np.isfinite(float(v)) for v in aux.values())
            losses.append(float(aux["loss"]))
        assert state.step == 2 and state.count == 2
        runs.append(losses)
    assert runs[0] == runs[1]


# -- the CLI and what it refuses ---------------------------------------------------------


def test_cli_trains_evaluates_saves_and_resumes(tmp_path, capsys):
    def args(run_name):
        return ["--device", "cpu", "--dummy_data", "--steps_per_epoch", "2", "--batch_size", "4",
                "--eval_batches", "1", "--dummy_frames", "64", "--warmup_steps", "1",
                "--save_dir", str(tmp_path), "--run_name", run_name, *TINY_CLI]

    argv = args("r")
    assert cli.main(argv + ["--epochs", "1"]) == 0
    run = tmp_path / "r"
    assert sorted(os.listdir(run / "ckpt")) == ["step_2.pt"]
    assert cli.main(argv + ["--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed at step 2 (epoch 1)" in out and "epoch 1:" in out
    assert sorted(os.listdir(run / "ckpt")) == ["step_2.pt", "step_4.pt"]
    lines = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
    assert [l["step"] for l in lines] == [2, 4]
    assert all(np.isfinite(l["train_loss"]) and 0 <= l["wer_2bit"] for l in lines)
    # the JAX package reads the run's config.json
    jcfg = jc.train_config_from_json((run / "config.json").read_text())
    assert jcfg.model.enc_d_model == 64 and jcfg.model.vocab_size == 32
    assert jcfg.optim.betas == (0.9, 0.98) and jcfg.epochs == 2
    # the resumed run continues the same stream (masks, dropout seeds,
    # moments): its state equals that of one uninterrupted 2-epoch run
    assert cli.main(args("straight") + ["--epochs", "2"]) == 0
    a = torch.load(run / "ckpt" / "step_4.pt", weights_only=True)
    b = torch.load(tmp_path / "straight" / "ckpt" / "step_4.pt", weights_only=True)
    for part in ("params", "mu", "nu"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert torch.equal(a["generator"], b["generator"])


@pytest.mark.parametrize("precision", [32, 1])
def test_eval_step_matches_jax(precision):
    """One deterministic forward at a precision: f32 CTC log-probs, encoder
    lengths and the branch loss, against JAX's make_eval_step (rtol 1e-5)."""
    from onebit_asr_tpu_torch.train.step import make_eval_step

    jcfg, cfg = _configs()
    params = convert.init_params(cfg, 5)
    batch = next(iter(DummyDataModule(batch_size=3, max_frames=72, max_tokens=6).valid_batches()))
    jstep_eval = jstep.make_eval_step(JaxASR.from_config(jcfg), jc.LossConfig(),
                                      jc.SpecialTokens(), 2, precision)
    jlp, jlens, jloss = jstep_eval(params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.qat_model_from_jax(cfg, params, device="cpu")
    lp, lens, loss = make_eval_step(model, LossConfig(), SpecialTokens(), 2, precision)(
        dict(model.named_parameters()), batch_to_device(batch, "cpu"))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    mask = np.arange(lp.shape[1])[None] < np.asarray(jlens)[:, None]
    np.testing.assert_allclose(lp.numpy()[mask], np.asarray(jlp)[mask], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


REFUSED_FLAGS = [
    ([], "real data"),
    (["--fsdp"], "--fsdp"), (["--tensor_parallel", "2"], "--tensor_parallel"),
    (["--pipeline_stages", "2"], "--pipeline_stages"),
    (["--wandb"], "--wandb"),
]


@pytest.mark.parametrize("flags,names", REFUSED_FLAGS)
def test_cli_refuses_what_is_not_ported(flags, names, tmp_path, capsys):
    # real data is ported: what it refuses is a data dir without a tokenizer
    data = (["--data_dir", str(tmp_path / "no_data")] if names == "real data"
            else ["--dummy_data"])
    rc = cli.main(["--device", "cpu", "--save_dir", str(tmp_path), *data, *flags, *TINY_CLI])
    assert rc == 2
    err = capsys.readouterr().err
    assert (f"no tokenizer artifact in {tmp_path / 'no_data'}" if names == "real data"
            else names) in err
    assert not os.listdir(tmp_path)  # refused before anything is written


# each model option: its flags and the config.json fields they must set
MODEL_OPTIONS = [
    (["--quant_per_channel"], dict(quant_per_channel=True)),
    (["--quant_decoder"], dict(quant_decoder=True)),
    (["--reference_decoder"], dict(reference_decoder=True)),
    (["--conv_norm", "layer_norm"], dict(conv_norm="layer_norm")),
    (["--causal_conv"], dict(causal_conv=True)),
    (["--attn_chunk_size", "8"], dict(attn_chunk_size=8, attn_left_chunks=-1)),
    (["--attn_chunk_size", "8", "--attn_left_chunks", "1"],
     dict(attn_chunk_size=8, attn_left_chunks=1)),
]


@pytest.mark.parametrize("flags,fields", MODEL_OPTIONS)
def test_cli_trains_with_model_option(flags, fields, tmp_path, capsys):
    """One tiny step on the CPU with the option; the run's config.json
    carries it (and --reference_decoder the reference's smoothing), and
    `transcribe --checkpoint` serves the run back under it."""
    from onebit_asr_tpu_torch.cli import transcribe
    from test_torch_serve_checkpoint import _write_inputs

    assert cli.main(["--device", "cpu", "--dummy_data", "--epochs", "1", "--steps_per_epoch",
                     "1", "--batch_size", "4", "--eval_batches", "1", "--dummy_frames", "64",
                     "--save_dir", str(tmp_path), "--run_name", "r", *flags, *TINY_CLI]) == 0
    saved = json.loads((tmp_path / "r" / "config.json").read_text())
    assert {k: saved["model"][k] for k in fields} == fields
    assert saved["loss"]["reference_smoothing"] == ("--reference_decoder" in flags)
    _write_inputs(tmp_path)
    out = tmp_path / "hyp.tsv"
    capsys.readouterr()
    assert transcribe.main(["--checkpoint", str(tmp_path / "r"), "--wav_dir",
                            str(tmp_path / "wavs"), "--data_dir", str(tmp_path / "data"),
                            "--out", str(out), "--device", "cpu"]) == 0
    assert len(out.read_text().splitlines()) == 3
    assert "transcribed 3 utterances" in capsys.readouterr().err


def test_cli_eval_beam_trains_and_reports_beam_wer(tmp_path, capsys):
    """--eval_beam: one tiny epoch on the CPU, evaluated with the device
    beam at --beam_size; the logged WERs are the beam's."""
    argv = ["--device", "cpu", "--dummy_data", "--epochs", "1", "--steps_per_epoch", "1",
            "--batch_size", "4", "--eval_batches", "1", "--dummy_frames", "64",
            "--save_dir", str(tmp_path), "--run_name", "b", "--eval_beam", "--beam_size", "3",
            *TINY_CLI]
    assert cli.main(argv) == 0
    assert "wer" in capsys.readouterr().out
    with open(tmp_path / "b" / "metrics.jsonl") as f:
        logged = json.loads(f.readline())
    assert logged["eval_utts"] == 4
    for tag in ("32bit", "2bit", "1bit"):
        assert np.isfinite(logged[f"wer_{tag}"]) and logged[f"wer_{tag}"] > 0


def test_library_refusals():
    _, cfg = _configs()
    for change in (dict(fused_attention=True), dict(fused_subsampler=True),
                   dict(fused_attention=True, fused_subsampler=True)):
        ConformerASR(dataclasses.replace(cfg, **change))  # the serving form keeps both
        model = ConformerASR(dataclasses.replace(cfg, **change), qat=True)  # trains with both
        assert model.encoder.subsample.fused == change.get("fused_subsampler", False)
        assert model.encoder.subsample.qat
    model = convert.qat_model_from_jax(cfg, convert.init_params(cfg, 0), device="cpu")
    batch = batch_to_device(next(iter(DummyDataModule(batch_size=3, max_frames=48,
                                                      max_tokens=4).train_batches(0))), "cpu")
    step = make_train_step(model, AdamW(OptimConfig(), 10), LossConfig(), SpecialTokens(), 2,
                           grad_accum=2)
    with pytest.raises(ValueError, match="batch 3 not divisible by grad_accum 2"):
        step(create_train_state(model, 0), batch)
    # beam evaluation is ported: no batches, no refusal
    assert evaluate_stream(model, None, [], LossConfig(), SpecialTokens(), 2,
                           use_beam=True)["eval_batches"] == 0
    with pytest.raises(RuntimeError, match="QAT form"):
        ConformerASR(cfg).forward_with_decoder(None, None, None, None)


def test_train_module_runs_as_a_program(tmp_path):
    """`python -m onebit_asr_tpu_torch.train` is the CLI."""
    proc = subprocess.run(
        [sys.executable, "-m", "onebit_asr_tpu_torch.train", "--help"], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--dummy_data" in proc.stdout

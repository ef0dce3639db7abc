"""Training under fused_attention=True: the port's fused rel-pos attention
backward (`fused_relpos_attention_bwd`, plain version on CPU), its autograd
Function and the 3-branch step against the JAX package, on CPU.

The JAX side runs `_fa_bwd`'s Pallas kernel in interpret mode, through
`jax.vjp` of onebit_asr_tpu.ops.attention.fused_relpos_attention; the whole
step reaches it with the JAX model forced onto its fused branch
(tests/test_torch_attention.py::force_jax_fused_attention). Inputs are
numpy draws from a seed.

Tolerances, with their reasons:
- f32 operands: the same products summed in another order, each gradient
  within 1e-5 x its largest |element| (observed <= 3e-7);
- bf16 operands: both sides round the probabilities, ds and the gradients
  to bf16, but XLA:CPU compiles `q + u` and `q + vb` of bf16 operands into
  one f32 add without the bf16 rounding that the TPU kernel and the port
  make (its optimised HLO keeps the sum in f32), so the scores differ by up
  to one bf16 ulp of qu/qv and every gradient moves by about that much:
  each within 2^-7 x its largest |element| (one to two bf16 ulps of it);
  the share of bit-identical elements and the max |d| in bf16 ulps of the
  largest |element| are recorded;
- the autograd Function against autograd through the forward's plain
  version: f32 noise of two derivations, 1e-5 x the largest |element|;
- the whole step: the tolerances of
  tests/test_torch_train.py::test_batch_loss_and_grads_match_jax and
  ::test_params_and_moments_after_two_steps_match_jax.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onebit_asr_tpu.ops.attention as jax_attention
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import train as cli
from onebit_asr_tpu_torch.data.dummy import DummyDataModule
from onebit_asr_tpu_torch.ops import attention as fa
from onebit_asr_tpu_torch.train import step as tstep
from onebit_asr_tpu_torch.train.step import batch_to_device, make_batch_loss
from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens
from test_torch_attention import force_jax_fused_attention
from test_torch_train import (
    TINY_CLI,
    _configs,
    _two_steps,
    assert_loss_and_grads_match,
    assert_params_and_moments_match,
)
from torch_cpu_threads import one_thread  # noqa: F401

GRADS = ("dq", "dk", "dv", "dp", "du", "dvb")


def _operands(seed, T, dh, B=2, H=2, rate=0.0, all_pad=True):
    """q, k, v, p, u, vb, key_mask, drop8 and a cotangent g, as numpy: key
    lengths leave padded keys, and with `all_pad` the last row of the batch
    is all padding."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(4))
    p = rng.standard_normal((H, 2 * T - 1, dh)).astype(np.float32)
    u, vb = ((0.1 * rng.standard_normal((H, dh))).astype(np.float32) for _ in range(2))
    lens = rng.integers(T // 2, T, size=B)
    if all_pad:
        lens[-1] = 0
    key_mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    drop8 = (rng.integers(0, 256, size=(B, H, T, T), dtype=np.uint8) if rate
             else np.zeros((1, 1, 1, 1), np.uint8))
    return (q, k, v, p, u, vb), key_mask, drop8, g


def _bf16_ulp(x):
    """One bf16 ulp at |x| (at least that of the smallest normal)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [16, 37])
def test_bwd_reference_matches_jax(T, dtype, rate, record_property):
    """All six gradients of the plain backward against JAX's `_fa_bwd`
    (interpret mode) on the same inputs, draws and cotangent."""
    tensors, key_mask, drop8, g = _operands(T + int(100 * rate), T, 16, rate=rate)
    scale = 0.25
    jd = getattr(jnp, dtype)

    def jf(*ts):
        return jax_attention.fused_relpos_attention(*ts, jnp.asarray(key_mask),
                                                    jnp.asarray(drop8), scale, rate)

    _, vjp = jax.vjp(jf, *(jnp.asarray(t, jd) for t in tensors))
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g, jd))]
    td = getattr(torch, dtype)
    before = fa.fused_relpos_attention_bwd.launches
    got = fa.fused_relpos_attention_bwd(
        *(torch.from_numpy(t).to(td) for t in tensors), torch.from_numpy(key_mask),
        torch.from_numpy(drop8), torch.from_numpy(g).to(td), scale, rate)
    assert fa.fused_relpos_attention_bwd.launches == before  # CPU: the plain version
    shapes = [t.shape for t in tensors]
    for name, a, ref, shape in zip(GRADS, got, want, shapes):
        assert a.dtype == td and tuple(a.shape) == shape, name
        a = a.float().numpy()
        assert np.isfinite(a).all(), name
        d = np.abs(a - ref)
        top = np.abs(ref).max()
        if dtype == "float32":
            assert d.max() <= 1e-5 * top, (name, d.max(), top)
            continue
        assert d.max() <= 2.0 ** -7 * top, (name, d.max(), top)
        same = float((a == ref).mean())
        ulps = float(d.max() / _bf16_ulp(top))
        record_property(f"{name}_bit_identical_share", same)
        record_property(f"{name}_max_ulps", ulps)
        print(f"{name}: bit-identical {same:.4f}, max |d| {d.max():.4g} = {ulps:.1f} ulp")


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_function_matches_autograd_of_plain_forward(rate):
    """The autograd Function (forward row 3, backward row 4; their plain
    versions on the CPU) against torch.autograd through the forward's plain
    version, f32; key_mask and drop8 get no gradient.

    Every batch row has a valid key: on a row with none, `_bwd_kernel` (and
    so the port) forms ds = attn (dattn - rowdot) scale from its uniform
    probabilities, while autograd through the forward's mask (a `where`)
    gives 0. The model never has such a row (every length is >= 1)."""
    tensors, key_mask, drop8, g = _operands(7, 23, 8, rate=rate, all_pad=False)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in tensors]
    mask = torch.from_numpy(key_mask).requires_grad_(True)
    extra = (mask, torch.from_numpy(drop8), 0.3, rate)
    out = fa.fused_relpos_attention(*leaves, *extra)
    ref_out = fa.fused_relpos_attention_reference(*leaves, *extra)
    assert torch.equal(out, ref_out)
    got = torch.autograd.grad(out, leaves + [mask], torch.from_numpy(g), allow_unused=True)
    want = torch.autograd.grad(ref_out, leaves, torch.from_numpy(g))
    assert got[-1] is None  # key_mask
    for name, a, ref in zip(GRADS, got, want):
        top = float(ref.abs().max())
        assert float((a - ref).abs().max()) <= 1e-5 * top, name
    plain = fa.fused_relpos_attention_plain(*leaves, *extra)
    for a, b in zip(got, torch.autograd.grad(plain, leaves, torch.from_numpy(g))):
        assert torch.equal(a, b)


def test_function_saves_its_inputs_on_the_cpu_and_matches_plain_and_jax():
    """On the CUDA kernel path the Function also saves the forward kernel's
    row statistics; on the CPU (the plain versions) it saves its eight
    inputs only, its gradients equal `fused_relpos_attention_plain`'s bit for
    bit and JAX's `_fa_bwd` (interpret mode) within 1e-5 x the largest
    |element| (f32, dropout 0.1), and without a gradient to take it returns
    the same forward."""
    rate, scale = 0.1, 0.3
    tensors, key_mask, drop8, g = _operands(11, 16, 8, rate=rate, all_pad=False)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in tensors]
    extra = (torch.from_numpy(key_mask), torch.from_numpy(drop8), scale, rate)
    out = fa.fused_relpos_attention(*leaves, *extra)
    assert len(out.grad_fn.saved_tensors) == 8
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    plain = fa.fused_relpos_attention_plain(*leaves, *extra)
    for a, b in zip(got, torch.autograd.grad(plain, leaves, torch.from_numpy(g))):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(fa.fused_relpos_attention(*leaves, *extra), out)

    def jf(*ts):
        return jax_attention.fused_relpos_attention(*ts, jnp.asarray(key_mask),
                                                    jnp.asarray(drop8), scale, rate)

    _, vjp = jax.vjp(jf, *(jnp.asarray(t) for t in tensors))
    for name, a, ref in zip(GRADS, got, vjp(jnp.asarray(g))):
        ref = np.asarray(ref)
        assert float(np.abs(a.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max()), name


@pytest.fixture(scope="module")
def fused_steps():
    """Two f32 steps of the fused_attention model in JAX (forced onto its
    fused branch: Pallas forward and backward in interpret mode) and in the
    port; each port step runs the plain backward once per block and
    branch."""
    calls = []
    bwd = fa.fused_relpos_attention_bwd_reference

    def counted(*args):
        calls.append(args[0].shape)
        return bwd(*args)

    with pytest.MonkeyPatch.context() as mp:
        jax_calls = force_jax_fused_attention(mp)
        mp.setattr(fa, "fused_relpos_attention_bwd_reference", counted)
        steps = _two_steps("float32", fused_attention=True)
    assert jax_calls and all(shape[1:] == (2, 17, 32) for shape in jax_calls)
    assert calls == [(3, 2, 17, 32)] * (2 * 3 * 2)  # steps x branches x blocks
    return steps


def test_fused_attention_batch_loss_and_grads_match_jax(fused_steps):
    assert_loss_and_grads_match(fused_steps)


def test_fused_attention_params_and_moments_after_two_steps_match_jax(fused_steps):
    assert_params_and_moments_match(fused_steps)


def test_fused_and_unfused_steps_draw_the_same_bytes(monkeypatch):
    """Dropout 0.1: a seeded 3-branch loss on the fused and the unfused port
    paths takes the same uint8 draws (shapes and bytes, in order) from the
    same generators, the attention's [B, H, T, T] bytes among them; at f32
    the two losses differ only by f32 sums."""
    draws = []
    real = tstep.generator_draws

    def recording(generator):
        inner = real(generator)

        def f(shape, device):
            out = inner(shape, device)
            draws[-1].append(out.clone())
            return out
        return f

    monkeypatch.setattr(tstep, "generator_draws", recording)
    batch = batch_to_device(next(iter(DummyDataModule(
        batch_size=3, max_frames=72, max_tokens=6, vocab_size=32).train_batches(0))), "cpu")
    sp = torch.tensor([True, False])
    losses, states = [], []
    for fused in (True, False):
        _, cfg = _configs(dropout=0.1, fused_attention=fused)
        model = convert.qat_model_from_jax(cfg, convert.init_params(cfg, 0), device="cpu")
        assert all(block.mhsa.fused == fused for block in model.encoder.blocks)
        gens = [torch.Generator().manual_seed(i) for i in range(3)]
        draws.append([])
        loss, _ = make_batch_loss(model, LossConfig(), SpecialTokens(), 2)(
            dict(model.named_parameters()), batch, sp, gens)
        losses.append(float(loss.detach()))
        states.append([gen.get_state() for gen in gens])
    fused_draws, unfused_draws = draws
    assert len(fused_draws) == len(unfused_draws)
    assert any(tuple(d.shape) == (3, 2, 17, 17) for d in fused_draws)
    for a, b in zip(fused_draws, unfused_draws):
        assert a.shape == b.shape and torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(*states))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_cli_trains_with_fused_attention(tmp_path, monkeypatch):
    """`--fused_attention` trains, evaluates and saves on the CPU, and its
    steps go through the fused attention's backward."""
    calls = []
    bwd = fa.fused_relpos_attention_bwd_reference

    def counted(*args):
        calls.append(args[0].shape)
        return bwd(*args)

    monkeypatch.setattr(fa, "fused_relpos_attention_bwd_reference", counted)
    rc = cli.main(["--device", "cpu", "--dummy_data", "--fused_attention", "--epochs", "1",
                   "--steps_per_epoch", "2", "--batch_size", "4", "--eval_batches", "1",
                   "--dummy_frames", "64", "--warmup_steps", "1", "--save_dir", str(tmp_path),
                   "--run_name", "fa", *TINY_CLI])
    assert rc == 0
    run = tmp_path / "fa"
    assert sorted(os.listdir(run / "ckpt")) == ["step_2.pt"]
    assert '"fused_attention": true' in (run / "config.json").read_text()
    assert (run / "metrics.jsonl").read_text().count("\n") == 1
    assert len(calls) == 2 * 3 * 2  # steps x branches x blocks


def test_fused_attention_qat_model_is_trainable():
    """The QAT form builds with fused_attention and its u/vb biases get a
    gradient through the bf16 cast in RelPosMHSA."""
    _, cfg = _configs(compute_dtype="bfloat16", fused_attention=True)
    model = convert.qat_model_from_jax(cfg, convert.init_params(cfg, 1), device="cpu")
    batch = batch_to_device(next(iter(DummyDataModule(
        batch_size=2, max_frames=48, max_tokens=4, vocab_size=32).train_batches(0))), "cpu")
    loss, _ = make_batch_loss(model, LossConfig(), SpecialTokens(), 2)(
        dict(model.named_parameters()), batch, torch.tensor([False, True]), [None] * 3)
    loss.backward()
    mhsa = model.encoder.blocks[0].mhsa
    for p in (mhsa.pos_bias_u, mhsa.pos_bias_v):
        assert p.grad is not None and p.grad.dtype == torch.float32
        assert bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().max()) > 0

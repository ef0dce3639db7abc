"""Training under fused_subsampler=True: the port's fused subsampler backward
(`fused_subsample_bwd`, plain version on CPU), its autograd Function and the
3-branch step against the JAX package, on CPU.

The JAX side runs `_fs_bwd`'s Pallas kernel in interpret mode through
`jax.vjp` of onebit_asr_tpu.ops.subsampler.fused_subsample, as
tests/test_fused_subsampler.py runs it; the JAX model takes that branch on
the CPU too, and its train step vmaps the three branches over the
interpret-mode call. Inputs are numpy draws from a seed; T=600 gives T2=148,
which JAX's interpret mode cuts into blocks of 64 rows with a clamped,
overlapping last block.

Tolerances, with their reasons:
- f32 compute: the same products summed in another order, each gradient
  within rtol 1e-5 and atol 1e-5 x its largest |element| (observed <= 4e-7
  of it);
- bf16 compute: both sides round the conv1 activation and dpat to bf16; an
  f32 difference in a sum can round a dpat element the other way, so each
  gradient within one bf16 ulp of the element plus one of its largest
  |element| (|d| <= 2^-7 (|ref| + max|ref|)); the share of bit-identical
  elements is recorded;
- the autograd Function against autograd through the forward's plain
  version: f32 noise of two derivations, 1e-5 x the largest |element|;
  against autograd of the unfused f32 conv pair: 1e-4 of it (another conv
  summation order, as tests/test_fused_subsampler.py allows 2e-4);
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
import torch.nn.functional as F

import onebit_asr_tpu.ops.subsampler as jax_subsampler
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import train as cli
from onebit_asr_tpu_torch.data.dummy import DummyDataModule
from onebit_asr_tpu_torch.ops import subsampler as ss
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

GRADS = ("dx", "dw1", "db1", "dw2", "db2")


def _operands(seed, T, F, C, B=2):
    """x, w1, b1, w2, b2 and a cotangent g with a fifth of its elements 0,
    as numpy; about half of each ReLU's pre-activations are negative."""
    rng = np.random.default_rng(seed)
    ops = (
        rng.standard_normal((B, T, F)).astype(np.float32),
        (rng.standard_normal((3, 3, C)) * 0.3).astype(np.float32),
        (rng.standard_normal((C,)) * 0.1).astype(np.float32),
        (rng.standard_normal((9 * C, C)) * 0.1).astype(np.float32),
        (rng.standard_normal((C,)) * 0.1).astype(np.float32),
    )
    g = rng.standard_normal((B, ss.out_len(ss.out_len(T)), ss.out_len(ss.out_len(F)), C))
    g[rng.random(g.shape) < 0.2] = 0.0
    return ops, g.astype(np.float32)


# (T, F, C): one block of rows (T2=4, 9), JAX's clamped last block (T=600),
# narrow and C=144-like channel counts
SHAPES = [(21, 17, 8), (43, 20, 16), (600, 17, 8), (600, 20, 16), (43, 18, 144)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_reference_matches_jax(shape, dtype, record_property):
    """All five gradients of the plain backward against JAX's `_fs_bwd`
    (interpret mode) on the same inputs and cotangent, with negative
    pre-activations on both ReLUs and zeros in the cotangent."""
    T, F_, C = shape
    ops, g = _operands(T + F_ + C, T, F_, C)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda *a: jax_subsampler.fused_subsample(*a, jd), *map(jnp.asarray, ops))
    want = [np.asarray(w, np.float32) for w in vjp(jnp.asarray(g, jd))]
    tops = [torch.from_numpy(a) for a in ops]
    c1_pre, _, y_pre = ss._pre_activations(*tops, td)
    assert 0.3 < float((c1_pre < 0).float().mean()) < 0.7
    assert 0.3 < float((y_pre < 0).float().mean()) < 0.7
    before = ss.fused_subsample_bwd.launches
    got = ss.fused_subsample_bwd(*tops, torch.from_numpy(g).to(td), td)
    assert ss.fused_subsample_bwd.launches == before  # CPU: the plain version
    for name, a, ref, t in zip(GRADS, got, want, tops):
        assert a.dtype == torch.float32 and a.shape == t.shape, name
        a = a.numpy()
        assert np.isfinite(a).all(), name
        top = np.abs(ref).max()
        if dtype == "float32":
            np.testing.assert_allclose(a, ref, rtol=1e-5, atol=1e-5 * top, err_msg=name)
            continue
        d = np.abs(a - ref)
        assert (d <= 2.0 ** -7 * (np.abs(ref) + top)).all(), (name, d.max(), top)
        same = float((a == ref).mean())
        record_property(f"{name}_bit_identical_share", same)
        print(f"{shape} {name}: bit-identical {same:.4f}, max |d| {d.max():.3g} of {top:.3g}")


def _unfused_f32(x, w1, b1, w2, b2):
    """The conv pair in f32 with the fused layout's parameters."""
    C = w1.shape[-1]
    y = F.relu(F.conv2d(x[:, None], w1.permute(2, 0, 1)[:, None], b1, stride=2))
    y = F.relu(F.conv2d(y, w2.reshape(3, 3, C, C).permute(3, 2, 0, 1), b2, stride=2))
    return y.permute(0, 2, 3, 1)  # [B, T2, F2, C]


def test_function_matches_autograd_of_plain_forward():
    """The autograd Function (forward row 5, backward row 6; their plain
    versions on the CPU) against torch.autograd through the forward's plain
    version and through the unfused f32 conv pair, f32. It saves the five
    inputs and nothing else."""
    ops, g = _operands(5, 43, 20, 16)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ops]
    gt = torch.from_numpy(g)
    out = ss.fused_subsample(*leaves, torch.float32)
    assert [t.shape for t in out.grad_fn.saved_tensors] == [t.shape for t in leaves]
    got = torch.autograd.grad(out, leaves, gt)
    ref_out = ss.fused_subsample_reference(*leaves, torch.float32)
    assert torch.equal(out, ref_out)
    for ref_fn, tol in ((lambda: ref_out, 1e-5), (lambda: _unfused_f32(*leaves), 1e-4)):
        want = torch.autograd.grad(ref_fn(), leaves, gt)
        for name, a, w in zip(GRADS, got, want):
            top = float(w.abs().max())
            assert float((a - w).abs().max()) <= tol * top, (name, tol)
    plain = ss.fused_subsample_plain(*leaves, torch.float32)
    for a, b in zip(got, torch.autograd.grad(plain, leaves, gt)):
        assert torch.equal(a, b)


def test_masked_cotangent_and_the_rest_compose_to_the_backward():
    """The two halves that the card's checks hold the kernel against, the
    mask and everything after it, give the plain backward bit for bit."""
    ops, g = _operands(9, 43, 20, 16)
    tops = [torch.from_numpy(a) for a in ops]
    gb = torch.from_numpy(g).to(torch.bfloat16)
    gm = ss.masked_cotangent(*tops, gb)
    assert tuple(gm.shape) == (g.size // 16, 16)
    whole = ss.fused_subsample_bwd_reference(*tops, gb)
    for name, a, b in zip(GRADS, ss.bwd_of_masked_reference(*tops, gm), whole):
        assert torch.equal(a, b), name


def test_fused_subsample_bwd_checks_operands():
    ops, g = _operands(0, 43, 20, 16)
    tops = [torch.from_numpy(a) for a in ops]
    with pytest.raises(ValueError):
        ss.fused_subsample_bwd(*tops, torch.from_numpy(g)[:, :-1])
    with pytest.raises(ValueError):
        ss.fused_subsample_bwd(*tops[:3], tops[3][:-1], tops[4], torch.from_numpy(g))


def _recording_steps(**flags):
    """Two f32 steps in JAX and in the port with `flags`, and the cotangent
    shapes of each port call of the plain backward (one per branch)."""
    calls = []
    bwd = ss.fused_subsample_bwd_reference

    def counted(*args):
        calls.append(tuple(args[5].shape))
        return bwd(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ss, "fused_subsample_bwd_reference", counted)
        if flags.get("fused_attention"):
            assert force_jax_fused_attention(mp) is not None
        steps = _two_steps("float32", fused_subsampler=True, **flags)
    return steps, calls


@pytest.fixture(scope="module")
def fused_steps():
    steps, calls = _recording_steps()
    # steps x branches; 72 frames -> T2=17, F2=19, C=64
    assert calls == [(3, 17, 19, 64)] * (2 * 3)
    return steps


@pytest.fixture(scope="module")
def both_fused_steps():
    steps, calls = _recording_steps(fused_attention=True)
    assert len(calls) == 2 * 3
    return steps


def test_fused_subsampler_batch_loss_and_grads_match_jax(fused_steps):
    assert_loss_and_grads_match(fused_steps)


def test_fused_subsampler_params_and_moments_after_two_steps_match_jax(fused_steps):
    assert_params_and_moments_match(fused_steps)


def test_both_fused_batch_loss_and_grads_match_jax(both_fused_steps):
    assert_loss_and_grads_match(both_fused_steps)


def test_both_fused_params_and_moments_after_two_steps_match_jax(both_fused_steps):
    assert_params_and_moments_match(both_fused_steps)


def test_bf16_qat_model_gives_conv_weights_f32_gradients():
    """bf16 QAT model under fused_subsampler: the 3-branch loss gives conv1
    and conv2 weight and bias non-zero f32 gradients, and conv2's weight
    gradient is the Function's f32 dw2 (the backward's plain version on the
    cotangent that reached the Function), not a bf16-rounded copy."""
    _, cfg = _configs(compute_dtype="bfloat16", fused_subsampler=True)
    model = convert.qat_model_from_jax(cfg, convert.init_params(cfg, 1), device="cpu")
    sub = model.encoder.subsample
    assert sub.fused and sub.qat
    batch = batch_to_device(next(iter(DummyDataModule(
        batch_size=2, max_frames=48, max_tokens=4, vocab_size=32).train_batches(0))), "cpu")
    loss, _ = make_batch_loss(model, LossConfig(), SpecialTokens(), 2)(
        dict(model.named_parameters()), batch, torch.tensor([False, True]), [None] * 3)
    loss.backward()
    params = (sub.conv1.weight, sub.conv1.bias, sub.conv2.weight, sub.conv2.bias)
    for p in params:
        assert p.grad is not None and p.grad.dtype == torch.float32
        assert bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().max()) > 0

    seen = {}

    def recording(x, w1, b1, w2, b2, compute_dtype):
        seen["ops"] = (x, w1, b1, w2, b2)
        y = ss.fused_subsample(x, w1, b1, w2, b2, compute_dtype)
        y.register_hook(lambda g: seen.__setitem__("g", g))
        return y

    model.zero_grad()
    sub.subsample_fn = recording
    out = sub(batch["feats"])
    (out.float() * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
    x, w1, b1, w2, b2 = (t.detach() for t in seen["ops"])
    assert w2.dtype == torch.float32 and seen["g"].dtype == torch.bfloat16
    dw2 = ss.fused_subsample_bwd_reference(x, w1, b1, w2, b2, seen["g"])[3]
    C = cfg.enc_d_model
    grad = sub.conv2.weight.grad
    assert torch.equal(grad, dw2.reshape(3, 3, C, C).permute(3, 2, 0, 1))
    assert not torch.equal(grad, grad.to(torch.bfloat16).float())


@pytest.mark.parametrize("flags", [["--fused_subsampler"],
                                   ["--fused_subsampler", "--fused_attention"]])
def test_cli_trains_with_fused_subsampler(tmp_path, monkeypatch, flags):
    """`--fused_subsampler` (alone and with `--fused_attention`) trains,
    evaluates and saves on the CPU, and each branch of each step goes
    through the fused subsampler's backward."""
    calls = []
    bwd = ss.fused_subsample_bwd_reference

    def counted(*args):
        calls.append(args[0].shape)
        return bwd(*args)

    monkeypatch.setattr(ss, "fused_subsample_bwd_reference", counted)
    rc = cli.main(["--device", "cpu", "--dummy_data", *flags, "--epochs", "1",
                   "--steps_per_epoch", "2", "--batch_size", "4", "--eval_batches", "1",
                   "--dummy_frames", "64", "--warmup_steps", "1", "--save_dir", str(tmp_path),
                   "--run_name", "fs", *TINY_CLI])
    assert rc == 0
    run = tmp_path / "fs"
    assert sorted(os.listdir(run / "ckpt")) == ["step_2.pt"]
    config = (run / "config.json").read_text()
    assert '"fused_subsampler": true' in config
    assert ('"fused_attention": true' in config) == ("--fused_attention" in flags)
    assert (run / "metrics.jsonl").read_text().count("\n") == 1
    assert len(calls) == 2 * 3  # steps x branches

"""The port's fused rel-pos attention (`fused_relpos_attention`, plain version
on CPU) and the `fused_attention=True` serving path against the JAX package,
on CPU.

The JAX side runs its Pallas kernel in interpret mode, as
tests/test_fused_attention.py runs it. The JAX model takes its fused branch
only off the CPU (onebit_asr_tpu/model/conformer.py:310-314), so the
whole-model tests give `onebit_asr_tpu.model.conformer` a `jax` whose
`default_backend()` says "tpu"; Pallas still reads the real backend and
interprets. Inputs are numpy draws from a seed.

Tolerances, with their reasons:
- f32 operands: the same products summed in another order (rtol/atol 1e-5);
- bf16 operands: both round the normalised probabilities and the output to
  bf16, and an f32 difference in a sum or an exp can move either by one
  bf16 ulp (|d| <= 1e-2 + 2^-7 |ref|); the share of bit-identical elements
  is recorded;
- whole model: the bounds of tests/test_torch_transcribe.py (f32 max
  |d log p| 2e-2, mean 4e-3; bf16 0.15, 0.03).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onebit_asr_tpu.model.conformer as jax_conformer
import onebit_asr_tpu.ops.attention as jax_attention
from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.model.asr import precision_to_binary_mask as jax_binary_mask
from onebit_asr_tpu.model.packed import export_packed_params as jax_export
from onebit_asr_tpu.utils import config as jax_config
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.model.conformer import relpos_attention_chain
from onebit_asr_tpu_torch.ops import attention as fa
from onebit_asr_tpu_torch.utils.config import ModelConfig
from torch_cpu_threads import one_thread  # noqa: F401

SMALL = dict(vocab_size=40, enc_d_model=64, enc_layers=2, enc_heads=2,
             enc_d_ff=128, enc_conv_kernel=7)


def _operands(seed, T, dh, B=2, H=2, rate=0.0):
    """q, k, v, p, u, vb, key_mask, drop8 as numpy: key lengths leave padded
    keys, and the last row of the batch is all padding."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(3))
    p = rng.standard_normal((H, 2 * T - 1, dh)).astype(np.float32)
    u, vb = ((0.1 * rng.standard_normal((H, dh))).astype(np.float32) for _ in range(2))
    lens = rng.integers(T // 2, T, size=B)
    lens[-1] = 0
    key_mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    drop8 = (rng.integers(0, 256, size=(B, H, T, T), dtype=np.uint8) if rate
             else np.zeros((1, 1, 1, 1), np.uint8))
    return q, k, v, p, u, vb, key_mask, drop8


def _jax(ops, dtype, scale, rate):
    *tensors, key_mask, drop8 = ops
    out = jax_attention.fused_relpos_attention(
        *(jnp.asarray(t, getattr(jnp, dtype)) for t in tensors), jnp.asarray(key_mask),
        jnp.asarray(drop8), scale, rate)
    return np.asarray(out.astype(jnp.float32))


def _torch(ops, dtype):
    *tensors, key_mask, drop8 = map(torch.from_numpy, ops)
    return [t.to(getattr(torch, dtype)) for t in tensors] + [key_mask, drop8]


def _check(got, want, dtype, record_property):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    d = np.abs(got - want)
    assert (d <= 1e-2 + 2.0 ** -7 * np.abs(want)).all(), d.max()
    same = float((got == want).mean())
    record_property("bit_identical_share", same)
    record_property("max_abs_diff", float(d.max()))
    print(f"bf16: max |d| {d.max():.4g}, bit-identical share {same:.4f}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [16, 36])
@pytest.mark.parametrize("T", [37, 128])
def test_fused_attention_matches_jax(T, dh, dtype, record_property):
    ops = _operands(T + dh, T, dh)
    scale = 1.0 / float(np.sqrt(dh))
    want = _jax(ops, dtype, scale, 0.0)
    before = fa.fused_relpos_attention.launches
    got = fa.fused_relpos_attention(*_torch(ops, dtype), scale, 0.0)
    assert fa.fused_relpos_attention.launches == before  # CPU: the plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 2, T, dh)
    got = got.float().numpy()
    _check(got, want, dtype, record_property)
    # the all-pad row attends uniformly over all T keys, as in JAX
    uniform = np.broadcast_to(ops[2][-1].mean(-2, keepdims=True), got[-1].shape)
    np.testing.assert_allclose(got[-1], uniform, rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_dropout_matches_jax(dtype, record_property):
    """Rate 0.1 with the same uint8 draws on both sides (keep iff byte >= 26,
    times 256/230)."""
    ops = _operands(5, 37, 16, rate=0.1)
    scale = 0.25
    want = _jax(ops, dtype, scale, 0.1)
    got = fa.fused_relpos_attention(*_torch(ops, dtype), scale, 0.1).float().numpy()
    _check(got, want, dtype, record_property)
    plain = fa.fused_relpos_attention(*_torch(ops, dtype), scale, 0.0).float().numpy()
    assert not np.allclose(got, plain, atol=1e-2)  # the draws were applied


def test_fused_attention_checks_operands():
    q, k, v, p, u, vb, key_mask, drop8 = _torch(_operands(0, 24, 16), "float32")
    with pytest.raises(ValueError):
        fa.fused_relpos_attention(q, k, v, p[:, 1:], u, vb, key_mask, drop8, 0.25, 0.0)
    with pytest.raises(ValueError):
        fa.fused_relpos_attention(q, k[:, :1], v, p, u, vb, key_mask, drop8, 0.25, 0.0)
    with pytest.raises(ValueError):
        fa.fused_relpos_attention(q[0], k, v, p, u, vb, key_mask, drop8, 0.25, 0.0)
    with pytest.raises(ValueError):
        fa.fused_relpos_attention(q, k, v, p, u, vb, key_mask[:, 1:], drop8, 0.25, 0.0)
    with pytest.raises(ValueError):  # rate > 0 needs [B, H, T, T] draws
        fa.fused_relpos_attention(q, k, v, p, u, vb, key_mask, drop8, 0.25, 0.1)
    with pytest.raises(ValueError):
        fa.fused_relpos_attention(q, k, v, p, u, vb, key_mask, drop8, 0.25, 1.0)


def test_plain_version_is_not_the_unfused_chain(record_property):
    """The plain version is `_fwd_kernel`'s order (scores summed in f32),
    not the port's unfused chain (scores rounded to bf16 and added there):
    on the same bf16 inputs the two differ. The distance of each to JAX's
    kernel is recorded, not ordered."""
    T, dh = 128, 64
    ops = _operands(11, T, dh, H=4)
    scale = 1.0 / float(np.sqrt(dh))
    q, k, v, p, u, vb, key_mask, drop8 = _torch(ops, "bfloat16")
    plain = fa.fused_relpos_attention_reference(q, k, v, p, u, vb, key_mask, drop8, scale, 0.0)
    chain = relpos_attention_chain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), p.transpose(0, 1),
        u, vb, key_mask > 0, scale).transpose(1, 2)
    assert chain.dtype == plain.dtype == torch.bfloat16
    assert not torch.equal(plain, chain)
    want = _jax(ops, "bfloat16", scale, 0.0)
    d_plain = np.abs(plain.float().numpy() - want)
    d_chain = np.abs(chain.float().numpy() - want)
    for name, d in (("plain", d_plain), ("chain", d_chain)):
        record_property(f"{name}_max_abs_diff_to_jax", float(d.max()))
        record_property(f"{name}_bit_identical_share", float((d == 0).mean()))
        print(f"{name}: max |d| to JAX {d.max():.4g}, bit-identical {(d == 0).mean():.4f}")
    assert (d_plain <= 1e-2 + 2.0 ** -7 * np.abs(want)).all()


class _TpuBackendJax:
    """`jax` as onebit_asr_tpu.model.conformer sees it: every attribute is
    jax's, but the default backend is a TPU, so the model takes its fused
    attention branch."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


def force_jax_fused_attention(monkeypatch):
    """Put the JAX model on its fused attention branch (Pallas still runs in
    interpret mode: ops/attention.py reads the real backend) and return the
    list that records the q shape of each call of the JAX wrapper."""
    calls = []
    jax_fused = jax_attention.fused_relpos_attention

    def counted(*args):
        calls.append(args[0].shape)
        return jax_fused(*args)

    monkeypatch.setattr(jax_conformer, "jax", _TpuBackendJax())
    monkeypatch.setattr(jax_attention, "fused_relpos_attention", counted)
    return calls


def _configs(compute_dtype="float32", **flags):
    jcfg = dataclasses.replace(
        jax_config.ModelConfig(), dec_layers=1, dec_d_ff=64,
        compute_dtype=compute_dtype, **SMALL, **flags,
    )
    return jcfg, dataclasses.replace(ModelConfig(), compute_dtype=compute_dtype,
                                     **SMALL, **flags)


@pytest.fixture(scope="module")
def jax_params():
    """A training-form parameter tree of numpy draws in the JAX model's
    structure (convert.init_params: cheaper than tracing the JAX init)."""
    _, cfg = _configs()
    return convert.init_params(cfg, seed=2)


@pytest.mark.parametrize("compute_dtype,max_tol,mean_tol,fused_subsampler", [
    ("float32", 2e-2, 4e-3, False),
    ("float32", 2e-2, 4e-3, True),
    ("bfloat16", 0.15, 0.03, True),
])
def test_fused_attention_packed_forward_matches_jax(jax_params, monkeypatch, compute_dtype,
                                                    max_tol, mean_tol, fused_subsampler):
    """ConformerASR with fused_attention=True (alone, and with
    fused_subsampler) against the JAX packed forward on its fused attention
    branch."""
    flags = dict(fused_attention=True, fused_subsampler=fused_subsampler)
    jcfg, cfg = _configs(compute_dtype, **flags)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((3, 151, 80)).astype(np.float32)
    lens = np.array([151, 120, 77], np.int32)

    calls = force_jax_fused_attention(monkeypatch)
    jmodel = JaxASR.from_config(jcfg, packed=True)
    _, mask, jlogits = jmodel.apply({"params": jax_export(jax_params, 2)}, jnp.asarray(feats),
                                    jnp.asarray(lens), jax_binary_mask(2, 2))
    # the JAX model took its fused branch: nn.scan traces the block body (twice
    # per apply, whatever the depth), so this counts traces, not blocks
    assert calls and all(shape == (3, 2, 37, 32) for shape in calls)
    want = np.asarray(jax.nn.log_softmax(jlogits.astype(jnp.float32), -1))
    mask = np.asarray(mask)

    model = convert.packed_model_from_jax(cfg, jax_params, 2, device="cpu")
    assert all(block.mhsa.fused for block in model.encoder.blocks)
    assert model.encoder.subsample.fused == fused_subsampler
    _, got_mask, logits = model(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    got = torch.log_softmax(logits.float(), -1).numpy()
    d = np.abs(got - want)[mask]
    assert np.isfinite(got[mask]).all()
    assert d.max() <= max_tol and d.mean() <= mean_tol, (d.max(), d.mean())

"""The port at full width against the JAX package, on CPU (slow: not tier-1).

Conformer-M as `ModelConfig()` defines it (d=256, 12 blocks, 4 heads, d_ff
1024, conv kernel 31, vocab 5004), computed in f32, on one small batch
(T'=74, padded to 128). The JAX packed forward (Pallas in interpret mode)
and the port's plain path get the same JAX-initialised parameters and the
same numpy features, with the unfused and the fused subsampler, and with
the fused attention (the JAX model takes that branch only off the CPU, so
its `jax` reports a TPU backend there, as in tests/test_torch_attention.py;
Pallas still interprets). This is
where a converter or layout fault that only shows at full width (the
projection's 19*256 rows, 4 heads, the 31-tap depthwise kernel) would show.

Tolerance: both sides round activations to bf16 inside the packed
products, and f32 differences of an ulp flip some of those roundings; over
12 blocks they add up (at 2 blocks, tests/test_torch_transcribe.py bounds
them by 2e-2). So the bound is measured in the test: the JAX forward against
itself on features perturbed by 1e-6 relative (max |d log p| 0.035, mean
0.0045 when written), and the port must stay within twice that.

    python -m pytest -m slow tests/test_torch_full_width.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.model.asr import precision_to_binary_mask as jax_binary_mask
from onebit_asr_tpu.model.packed import export_packed_params as jax_export
from onebit_asr_tpu.utils import config as jax_config
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.utils.config import ModelConfig
from test_torch_attention import force_jax_fused_attention

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def jax_params():
    jcfg = dataclasses.replace(jax_config.ModelConfig(), compute_dtype="float32")
    model = JaxASR.from_config(jcfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.array([64]),
                           jax_binary_mask(2, jcfg.enc_layers))
    return jax.tree.map(np.asarray, variables["params"])


@pytest.mark.parametrize("fused_subsampler", [False, True])
def test_conformer_m_matches_jax(jax_params, fused_subsampler):
    _check_against_jax(jax_params, fused_subsampler=fused_subsampler)


def test_conformer_m_fused_attention_matches_jax(jax_params, monkeypatch):
    calls = force_jax_fused_attention(monkeypatch)
    model = _check_against_jax(jax_params, fused_attention=True)
    # both JAX forwards took the fused branch (nn.scan traces the block body,
    # so the wrapper runs per trace, not per block)
    assert len(calls) >= 2 and all(shape == (2, 4, 128, 64) for shape in calls)
    assert all(block.mhsa.fused for block in model.encoder.blocks)


def _check_against_jax(jax_params, **flags):
    jcfg = dataclasses.replace(jax_config.ModelConfig(), compute_dtype="float32", **flags)
    cfg = dataclasses.replace(ModelConfig(), compute_dtype="float32", **flags)
    assert (cfg.enc_d_model, cfg.enc_layers, cfg.enc_heads, cfg.vocab_size) == (256, 12, 4, 5004)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 300, 80)).astype(np.float32)
    lens = np.array([300, 211], np.int32)

    bm = jax_binary_mask(2, jcfg.enc_layers)
    jmodel = JaxASR.from_config(jcfg, packed=True)
    packed = jax_export(jax_params, 2)

    def jax_log_probs(x):
        _, mask, logits = jmodel.apply({"params": packed}, jnp.asarray(x), jnp.asarray(lens), bm)
        return np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1)), np.asarray(mask)

    want, mask = jax_log_probs(feats)
    nudged = feats * (1 + 1e-6 * rng.standard_normal(feats.shape)).astype(np.float32)
    spread = np.abs(jax_log_probs(nudged)[0] - want)[mask]

    model = convert.packed_model_from_jax(cfg, jax_params, 2, device="cpu")
    assert model.encoder.subsample.fused == cfg.fused_subsampler
    with torch.inference_mode():
        _, got_mask, got_logits = model(torch.from_numpy(feats), torch.from_numpy(lens))
    assert got_mask.shape == (2, 128)
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    got = torch.log_softmax(got_logits.float(), -1).numpy()
    d = np.abs(got - want)[mask]
    assert np.isfinite(got[mask]).all()
    assert d.max() <= 2 * spread.max() and d.mean() <= 2 * spread.mean(), (
        d.max(), d.mean(), spread.max(), spread.mean())
    print(f"{flags}: max |d log p| {d.max():.4g} (JAX spread {spread.max():.4g}), "
          f"mean {d.mean():.4g} ({spread.mean():.4g})")
    return model

"""SpecAugment, dither and prefetch of onebit_asr_tpu_torch against the JAX
package, on CPU.

JAX draws SpecAugment's mask starts from jax.random inside its jitted op;
the port takes them as a tensor. The tests recompute JAX's starts with the
same split chain (`split(key, B)`, then `split(k, 4)`, then one `randint(0,
hi)` per mask) and inject them: the masked features must then equal JAX's
bit for bit (masking only writes zeros), in f32 and f16. The dither noise is
JAX's `jax.random.normal(key, frames.shape)`, injected the same way, and
the features must agree at the frontend's tolerance (rtol 1e-4, atol 2e-4,
as tests/test_torch_transcribe.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_asr_tpu.data.prefetch import prefetch as jax_prefetch
from onebit_asr_tpu.ops.frontend import LogMelFrontend as JaxFrontend
from onebit_asr_tpu.ops.specaugment import spec_augment as jax_spec_augment
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch.data.prefetch import prefetch
from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend
from onebit_asr_tpu_torch.ops.specaugment import (
    draw_starts,
    spec_augment,
    spec_augment_from_config,
    time_mask_widths,
)
from onebit_asr_tpu_torch.utils.config import FrontendConfig
from torch_cpu_threads import one_thread  # noqa: F401

# lengths: full, n = 1, n = 0, below time_mask_param, and the f32 floor trap
# values at ratio 0.7 (90, 170, 180)
LENS = np.array([200, 1, 0, 37, 90, 170, 180, 99], np.int32)
T, F = 200, 80


def jax_starts(key, feat_lens, n_bins, cfg):
    """The starts JAX's spec_augment draws from `key`, recomputed outside
    its jit with the same split chain and bounds."""
    nf, nt = cfg.num_freq_masks, cfg.num_time_masks
    out = np.zeros((len(feat_lens), nf + nt), np.int64)
    f_hi = max(1, n_bins - min(cfg.freq_mask_param, n_bins))
    for b, k in enumerate(jax.random.split(key, len(feat_lens))):
        ks = jax.random.split(k, nf + nt)
        n = jnp.int32(feat_lens[b])
        t_param = jnp.minimum(jnp.int32(cfg.time_mask_param),
                              jnp.floor(cfg.time_mask_ratio * n.astype(jnp.float32))
                              .astype(jnp.int32))
        t_hi = jnp.maximum(1, n - jnp.minimum(t_param, n))
        for i in range(nf):
            out[b, i] = int(jax.random.randint(ks[i], (), 0, jnp.int32(f_hi)))
        for j in range(nt):
            out[b, nf + j] = int(jax.random.randint(ks[nf + j], (), 0, t_hi))
    return out


@pytest.mark.parametrize("ratio", [0.3, 0.7, 1.0])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_spec_augment_equals_jax_on_jax_draws(ratio, dtype):
    cfg = FrontendConfig(time_mask_ratio=ratio)
    jcfg = jc.FrontendConfig(time_mask_ratio=ratio)
    feats = np.random.default_rng(0).standard_normal((len(LENS), T, F)).astype(dtype)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_spec_augment(
        key, jnp.asarray(feats), jnp.asarray(LENS), freq_mask_param=jcfg.freq_mask_param,
        time_mask_param=jcfg.time_mask_param, num_freq_masks=jcfg.num_freq_masks,
        num_time_masks=jcfg.num_time_masks, time_mask_ratio=jcfg.time_mask_ratio))
    starts = torch.from_numpy(jax_starts(key, LENS, F, cfg))
    got = spec_augment_from_config(torch.from_numpy(feats), torch.from_numpy(LENS), starts, cfg)
    assert got.dtype == torch.from_numpy(feats).dtype
    np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))
    assert (want == 0).sum() > 0


def test_time_mask_cap_is_computed_in_float32():
    n = np.arange(3000)
    for ratio in (0.3, 0.35, 0.7, 1.0):
        want = np.asarray(jnp.minimum(
            jnp.minimum(jnp.int32(10_000),
                        jnp.floor(ratio * jnp.asarray(n, jnp.int32).astype(jnp.float32))
                        .astype(jnp.int32)), jnp.asarray(n, jnp.int32)))
        np.testing.assert_array_equal(
            time_mask_widths(torch.from_numpy(n), 10_000, ratio).numpy(), want)
    # the trap: in float64 the cap is one frame less at these lengths
    f64 = np.floor(0.7 * np.array([90, 170, 180]))
    trap = time_mask_widths(torch.tensor([90, 170, 180]), 10_000, 0.7).numpy()
    assert (trap == f64 + 1).all()


def test_own_draws_are_seeded_and_capped():
    cfg = FrontendConfig()
    lens = np.array([200, 150, 33, 1, 0, 120], np.int64)

    def masked(seed):
        starts = draw_starts(np.random.default_rng(seed), lens, F, cfg)
        x = torch.ones(len(lens), T, F)
        return starts, spec_augment_from_config(x, torch.from_numpy(lens),
                                                torch.from_numpy(starts), cfg)

    s0, m0 = masked((0, 0, 3))
    s1, m1 = masked((0, 0, 3))
    s2, _ = masked((0, 1, 3))
    assert (s0 == s1).all() and torch.equal(m0, m1) and not (s0 == s2).all()
    cap = time_mask_widths(torch.from_numpy(lens), cfg.time_mask_param,
                           cfg.time_mask_ratio).numpy()
    for b, n in enumerate(lens):
        # every frequency mask is min(27, F) bins wide inside [0, F)
        assert 0 <= s0[b, :2].min() and s0[b, :2].max() + 27 <= F
        # time masks lie in [0, n), each at most the cap
        zero_t = (m0[b] == 0).all(dim=1).numpy()
        assert not zero_t[n:].any()
        assert zero_t.sum() <= cfg.num_time_masks * cap[b]
        for j in range(cfg.num_time_masks):
            s = s0[b, 2 + j]
            assert 0 <= s < max(1, n - cap[b])
            assert zero_t[s : s + cap[b]].all()


def test_spec_augment_masks_only_the_given_ranges():
    x = torch.ones(1, 10, 6)
    got = spec_augment(x, torch.tensor([8]), torch.tensor([[1, 4, 2, 5]]), freq_mask_param=2,
                       time_mask_param=3, num_freq_masks=2, num_time_masks=2,
                       time_mask_ratio=1.0)
    want = torch.ones(1, 10, 6)
    want[..., 1:3] = 0
    want[..., 4:6] = 0
    want[:, 2:8] = 0
    assert torch.equal(got, want)


def test_dither_with_jax_noise_and_without_noise():
    rng = np.random.default_rng(1)
    wavs = (0.1 * rng.standard_normal((3, 8000))).astype(np.float32)
    lens = np.array([8000, 6000, 401], np.int32)
    cfg = FrontendConfig(dither=1.0)
    jfe = JaxFrontend(dataclasses.replace(jc.FrontendConfig(), dither=1.0))
    key = jax.random.PRNGKey(3)
    fe = LogMelFrontend(cfg)
    n_frames = fe.max_frames(wavs.shape[1])
    noise = np.array(jax.random.normal(key, (3, n_frames, fe.frame_len), jnp.float32))
    want, want_lens = jfe(jnp.asarray(wavs), jnp.asarray(lens), dither_key=key)
    got, got_lens = fe(torch.from_numpy(wavs), torch.from_numpy(lens),
                       noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-4)
    # no noise given: no dither, whatever cfg.dither says
    plain, _ = LogMelFrontend()(torch.from_numpy(wavs), torch.from_numpy(lens))
    assert torch.equal(fe(torch.from_numpy(wavs), torch.from_numpy(lens))[0], plain)
    assert not torch.equal(got, plain)
    g = torch.Generator().manual_seed(5)
    drawn = fe(torch.from_numpy(wavs), torch.from_numpy(lens), generator=g)[0]
    again = fe(torch.from_numpy(wavs), torch.from_numpy(lens),
               generator=torch.Generator().manual_seed(5))[0]
    assert torch.equal(drawn, again) and not torch.equal(drawn, plain)


def _run(pf, source, **kw):
    """(items before the exception, the exception's message or None)."""
    got = []
    try:
        for x in pf(source(), **kw):
            got.append(x)
    except RuntimeError as e:
        return got, str(e)
    return got, None


def _failing_source():
    yield from range(5)
    raise RuntimeError("source failed at 5")


def _failing_transfer(x):
    if x == 3:
        raise RuntimeError("transfer failed at 3")
    return x * 10


@pytest.mark.parametrize("case", [
    (lambda: iter(range(12)), dict(transfer=lambda x: x + 1, depth=3)),
    (lambda: iter(range(12)), dict(depth=1)),
    (_failing_source, dict(depth=2)),
    (lambda: iter(range(8)), dict(transfer=_failing_transfer, depth=4)),
])
def test_prefetch_equals_jax(case):
    source, kw = case
    stats, jstats = {}, {}
    assert _run(prefetch, source, stats=stats, **kw) == _run(jax_prefetch, source,
                                                             stats=jstats, **kw)
    assert stats["items"] == jstats["items"] and set(stats) == set(jstats)
    assert stats["wait_s"] >= 0.0

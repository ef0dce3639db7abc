"""onebit_asr_tpu_torch's decoders against the JAX package's, on CPU.

Inputs are random f32 log-probs and seeded token sequences from numpy, so no
two candidate scores tie: every decoder here must give exactly the ids of
its JAX counterpart. Cases and tolerances:

- the uint32 hashes (`mul32`, the LM's fold) equal numpy's uint32
  arithmetic bit for bit, values at and above 2^31 included;
- `DeviceLM.pack`'s tables (k1, k2, val, max_probes) equal JAX's bit for
  bit; its scores lie within 1e-6 of JAX's (f32 arithmetic of the same
  formula in two libraries);
- `beam_search_device`: ids and lengths equal JAX's exactly, for top_k = V
  and top_k = 8 < V = 40, with and without the LM; its stable top-k orders
  ties as `jax.lax.top_k`;
- the host beam: the port's Python beam equals JAX's decode/beam.py, the
  port's C++ beam its Python beam (B = 3, T = 20, V = 12, W = 8, with and
  without the LM); `NGramLM.load` reads an LM the JAX package saved;
- long-form: `chunk_feats` equals JAX's exactly, and the greedy ids of the
  stitched windows (chunk 40 frames, overlap 8, 150 frames) and of the
  short-file branch equal JAX's on the same f32 QAT model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_asr_tpu.decode import beam as jbeam
from onebit_asr_tpu.decode import longform as jlongform
from onebit_asr_tpu.decode.beam_device import beam_search_device as jax_beam_device
from onebit_asr_tpu.decode.lm import NGramLM as JaxLM
from onebit_asr_tpu.decode.lm_device import DeviceLM as JaxDeviceLM
from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.model.asr import precision_to_binary_mask as jax_binary_mask
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.decode import beam, longform
from onebit_asr_tpu_torch.decode.beam_device import beam_search_device, stable_top_k
from onebit_asr_tpu_torch.decode.lm import NGramLM
from onebit_asr_tpu_torch.decode.lm_device import DeviceLM, mul32
from onebit_asr_tpu_torch.model.asr import precision_to_binary_mask
from onebit_asr_tpu_torch.utils.config import ModelConfig
from torch_cpu_threads import one_thread  # noqa: F401


def _log_probs(seed, B, T, V, scale=2.0):
    x = np.random.default_rng(seed).standard_normal((B, T, V)) * scale
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _seqs(seed, V, n=10):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(4, V, size=rng.integers(2, 14))] for _ in range(n)]


@pytest.fixture(scope="module")
def lms():
    """The same 3-gram LM fitted by both packages on seeded sequences (V=40;
    this one probes at most 18 slots: the JAX beam unrolls every probe, and
    its compile time grows with their number)."""
    seqs = _seqs(7, 40)
    return JaxLM(3).fit(seqs), NGramLM(3).fit(seqs)


def test_mul32_and_fold_equal_uint32_arithmetic():
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    for m in (1000003, 2654435761, 7919, 2 ** 32 - 1):
        want = (h * np.uint32(m)).astype(np.int64)  # wraps mod 2^32
        got = mul32(torch.from_numpy(h.astype(np.int64)), m)
        np.testing.assert_array_equal(got.numpy(), want)


def test_device_lm_tables_and_scores_match_jax(lms):
    jlm, lm = lms
    jdev, dev = JaxDeviceLM.pack(jlm), DeviceLM.pack(lm)
    np.testing.assert_array_equal(dev.k1.numpy(), np.asarray(jdev.k1).astype(np.int64))
    np.testing.assert_array_equal(dev.k2.numpy(), np.asarray(jdev.k2).astype(np.int64))
    np.testing.assert_array_equal(dev.val.numpy(), np.asarray(jdev.val))
    assert (dev.max_probes, dev.order) == (jdev.max_probes, jdev.order)
    rng = np.random.default_rng(3)
    prefixes = rng.integers(4, 40, size=(6, 9)).astype(np.int32)
    plen = np.array([0, 1, 2, 5, 9, 3], np.int32)
    cand = rng.integers(0, 40, size=11).astype(np.int32)
    want = np.asarray(jdev.scores(jnp.asarray(prefixes), jnp.asarray(plen), jnp.asarray(cand)))
    got = dev.scores(torch.from_numpy(prefixes), torch.from_numpy(plen), torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the host LM agrees too, and a batch axis in front changes nothing
    for w in range(6):
        host = [lm.score(prefixes[w, : plen[w]], c) for c in cand]
        np.testing.assert_allclose(got[w].numpy(), host, rtol=0, atol=1e-5)
    batched = dev.scores(torch.from_numpy(prefixes)[None].repeat(2, 1, 1),
                         torch.from_numpy(plen)[None].repeat(2, 1),
                         torch.from_numpy(cand)[None].repeat(2, 1))
    assert torch.equal(batched[1], got)


def test_ngram_lm_reads_a_jax_saved_lm(lms, tmp_path):
    jlm, lm = lms
    jlm.save(str(tmp_path / "lm.npz"))
    back = NGramLM.load(str(tmp_path / "lm.npz"))
    assert back.order == jlm.order and back.total == jlm.total
    assert back.counts == jlm.counts
    lm.save(str(tmp_path / "port.npz"))
    assert JaxLM.load(str(tmp_path / "port.npz")).counts == jlm.counts


def test_stable_top_k_orders_ties_as_jax():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0], [2.0, 2.0, 2.0, 2.0, 5.0, 2.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    v, i = stable_top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("top_k,use_lm", [(40, False), (40, True), (8, False), (8, True)])
def test_device_beam_matches_jax(lms, top_k, use_lm):
    lp = _log_probs(11, 3, 20, 40)
    lens = np.array([20, 13, 1], np.int32)
    jlm, lm = lms
    kw = dict(blank_id=3, beam_size=8, top_k=top_k, max_len=20, length_bonus=0.1,
              lm_weight=0.5 if use_lm else 0.0)
    jids, jn = jax_beam_device(jnp.asarray(lp), jnp.asarray(lens),
                               lm=JaxDeviceLM.pack(jlm) if use_lm else None, **kw)
    ids, n = beam_search_device(torch.from_numpy(lp), torch.from_numpy(lens),
                                lm=DeviceLM.pack(lm) if use_lm else None, **kw)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    # and the host beam finds the same hypotheses
    host = beam.ctc_beam_search_batch(lp, lens, beam_size=8, blank_id=3, top_k_per_t=top_k,
                                      lm=lm if use_lm else None, length_bonus=0.1,
                                      lm_weight=0.5 if use_lm else 0.0, prefer_native=False)
    assert host == [ids[b, : n[b]].tolist() for b in range(3)]


@pytest.mark.parametrize("use_lm", [False, True])
def test_host_beams_match_jax(use_lm):
    lp = _log_probs(5, 3, 20, 12)
    lens = np.array([20, 9, 14], np.int32)
    seqs = _seqs(2, 12)
    kw = dict(beam_size=8, blank_id=3, top_k_per_t=6, lm_weight=0.7 if use_lm else 0.0,
              length_bonus=0.2)
    want = jbeam.ctc_beam_search_batch(lp, lens, lm=JaxLM(3).fit(seqs) if use_lm else None,
                                       prefer_native=False, **kw)
    lm = NGramLM(3).fit(seqs) if use_lm else None
    python = beam.ctc_beam_search_batch(lp, lens, lm=lm, prefer_native=False, **kw)
    native = beam.ctc_beam_search_batch(lp, lens, lm=lm, prefer_native=True, **kw)
    assert python == want
    assert native == python
    assert any(len(h) > 2 for h in python)


SMALL = dict(vocab_size=24, enc_d_model=32, enc_layers=1, enc_heads=2, enc_d_ff=64,
             enc_conv_kernel=7, dec_layers=1, dec_d_ff=32, compute_dtype="float32")


class _Jitted:
    """A flax module whose `apply` is jitted: one compile per window shape
    instead of the op-by-op dispatch of an eager apply."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply)


@pytest.fixture(scope="module")
def longform_models():
    """The same f32 QAT encoder in both packages (parameters from
    convert.init_params), and its JAX parameters."""
    cfg = dataclasses.replace(ModelConfig(), **SMALL)
    params = convert.init_params(cfg, 3)
    jmodel = JaxASR.from_config(dataclasses.replace(jc.ModelConfig(), remat_blocks=False,
                                                    **SMALL), deterministic=True)
    jmodel = _Jitted(jmodel)
    model = convert.qat_model_from_jax(cfg, params, "cpu", decoder=False).eval()
    return jmodel, params, model.requires_grad_(False)


def test_chunk_feats_matches_jax():
    feats = np.random.default_rng(0).standard_normal((150, 80)).astype(np.float32)
    for chunk, overlap in ((40, 8), (40, 0), (64, 20), (200, 8)):
        want = jlongform.chunk_feats(feats, chunk, overlap)
        got = longform.chunk_feats(feats, chunk, overlap)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    with pytest.raises(ValueError):
        longform.chunk_feats(feats, 8, 8)


@pytest.mark.parametrize("frames", [150, 37])  # stitched windows; the short-file branch
def test_longform_greedy_matches_jax(longform_models, frames):
    jmodel, params, model = longform_models
    feats = np.random.default_rng(frames).standard_normal((frames, 80)).astype(np.float32)
    want, wk = jlongform.longform_greedy_decode(
        jmodel, params, feats, jax_binary_mask(2, 1), 3, chunk_frames=40, overlap_frames=8)
    got, k = longform.longform_greedy_decode(
        model, feats, precision_to_binary_mask(2, 1), 3, chunk_frames=40, overlap_frames=8)
    assert k == wk and k > 0
    np.testing.assert_array_equal(got, np.asarray(want))

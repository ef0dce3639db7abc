"""onebit_asr_tpu_torch's model options against the JAX package, on CPU.

Every ModelConfig option that changes what the JAX model computes:
per-channel alpha, the quantized and the reference decoder (with the
reference's label smoothing), the conv module's group and layer norms, its
causal padding, and chunked attention. A small model (2 blocks, d=64, 2
heads, 1 decoder layer, vocab 32) gets its parameters from the port's
`convert.init_params` for the options at hand; the same numpy tree goes to
the JAX model and, converted, to the port's. Inputs are made with numpy
from fixed seeds; masked norms take statistics over valid frames (and
MaskedBatchNorm over the batch), so whole padded batches are compared, on
valid frames. Tolerances, with their reasons:

- quantizer, group norm, conv module, decoder, losses, the QAT encoder and
  the evaluation step at f32: the same formulas in two libraries, f32 sums
  in another order (1e-6 to 1e-5);
- conv module at bf16: both round to bf16 at the same points, but an f32
  difference of one ulp can flip a rounding: within 2 bf16 ulps of the
  largest output (2^-6 relative);
- the packed model with a quantized decoder: the bounds of
  tests/test_torch_transcribe.py's f32 FORWARD_CASES (log-probs max 2e-2,
  mean 4e-3: both sides round activations to bf16 inside the packed
  products, and an f32 difference of 1e-6 flips some of those roundings);
  under W2A8 an f32 difference can move an activation across an int8
  rounding step (1/127 of its row's largest value) in any of the 10 + 18
  projections of this model: max 6e-2, mean 8e-3 (observed over three
  parameter seeds: max 0.039, mean 0.0047; the bf16 kernel's max 0.0054);
- the whole 3-branch step (one step, f32, dropout 0) for two option
  groups: tests/test_torch_train.py's tolerances (loss and aux rtol 1e-5,
  gradients rtol 1e-4 with atol 2e-6 x the largest gradient element).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_asr_tpu.losses import attention as jatt
from onebit_asr_tpu.model import conformer as jconformer
from onebit_asr_tpu.model import layers as jlayers
from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.model.asr import precision_to_binary_mask as jax_binary_mask
from onebit_asr_tpu.model.decoder import TransformerDecoder as JaxDecoder
from onebit_asr_tpu.model.packed import export_packed_params as jax_export
from onebit_asr_tpu.ops.quant import quantize_weight as jax_quantize
from onebit_asr_tpu.train import step as jstep
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.data.dummy import DummyDataModule
from onebit_asr_tpu_torch.losses import attention as tatt
from onebit_asr_tpu_torch.model.asr import decoder_bits, precision_to_binary_mask
from onebit_asr_tpu_torch.model.conformer import RelPosMHSA, chunk_pair_mask
from onebit_asr_tpu_torch.model.layers import MaskedGroupNorm
from onebit_asr_tpu_torch.ops.quant import quantize_weight
from onebit_asr_tpu_torch.train.step import batch_to_device, make_eval_step
from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens
from test_torch_train import _configs, _two_steps, assert_loss_and_grads_match
from torch_cpu_threads import one_thread  # noqa: F401

STREAMING = dict(conv_norm="layer_norm", causal_conv=True, attn_chunk_size=8,
                 attn_left_chunks=1, time_pad_multiple=16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# -- the straight-through quantizer with an alpha per output channel ------------


@pytest.mark.parametrize("bits", [1, 2, 32, True, False])
def test_per_channel_quantizer_forward_and_grads_match_jax(bits):
    """alpha [N] against W [K, N] holding 0, a negative value, 1e-30 and
    ordinary scales; W/a at exactly +-0.5, +-1, +-4 and 0 in every column,
    plus random values. d alpha sums over K only (f32: 1e-6)."""
    rng = np.random.default_rng(0)
    alpha = np.array([0.0, -0.3, 1e-30, 0.7, 1.0, 2.5], np.float32)
    a = np.abs(alpha) + np.float32(1e-8)
    ratios = np.array([0.5, -0.5, 1.0, -1.0, 4.0, -4.0, 0.0, 0.25], np.float32)
    wa = np.concatenate([np.repeat(ratios[:, None], 6, 1),
                         rng.uniform(-3, 3, (10, 6)).astype(np.float32)])
    w = (wa * a[None]).astype(np.float32)
    g = rng.standard_normal(w.shape).astype(np.float32)
    jbits = bits if isinstance(bits, int) and not isinstance(bits, bool) else jnp.asarray(bits)
    jq, vjp = jax.vjp(lambda w_, al: jax_quantize(w_, al, jbits), jnp.asarray(w),
                      jnp.asarray(alpha))
    jgw, jga = vjp(jnp.asarray(g))
    tw = torch.from_numpy(w).requires_grad_(True)
    ta = torch.from_numpy(alpha).requires_grad_(True)
    tq = quantize_weight(tw, ta, bits)
    (tq * torch.from_numpy(g)).sum().backward()
    ga = torch.zeros(6) if ta.grad is None else ta.grad  # bits 32 does not read alpha
    assert ga.shape == ta.shape
    for got, ref in ((tq, jq), (tw.grad, jgw), (ga, jga)):
        got, ref = _np(got), _np(ref)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(ref).max()))


def test_decoder_bits_follow_the_branch():
    """32 without quant_decoder or a mask; binary only when every layer is
    binary (an sp mask that happens to be all True too)."""
    mask = lambda *b: torch.tensor(b)  # noqa: E731
    assert decoder_bits(False, mask(True, True)) == 32
    assert decoder_bits(True, None) == 32
    assert decoder_bits(True, mask(True, True)) is True
    assert decoder_bits(True, mask(True, False)) is False
    assert decoder_bits(True, mask(False, False)) is False


# -- the conv module's norms and padding -------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64])
def test_masked_group_norm_matches_jax(D, dtype):
    """min(32, D) groups (D=32: one channel a group, so the row with one
    valid frame has variance 0; D=64: two channels a group) over a padded
    batch; f32 1e-5, bf16 one ulp of the output."""
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((3, 9, D)) + 1.0).astype(np.float32)
    mask = np.arange(9)[None] < np.array([[9], [4], [1]])
    scale, bias = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32), rng.standard_normal(
        D).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = jlayers.MaskedGroupNorm(num_groups=min(32, D)).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jdt), jnp.asarray(mask))
    gn = MaskedGroupNorm(D, min(32, D))
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
    got = gn(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype) and np.isfinite(_np(got)).all()
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(_np(want)).max()
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=tol)
    assert (_np(got)[~mask] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("norm", ["batch_norm", "group_norm", "layer_norm"])
def test_conv_module_matches_jax(norm, causal, dtype):
    """The conv module of block 0 for each norm, SAME or causal, on a padded
    batch: f32 1e-5; bf16 within 2 bf16 ulps of the largest output."""
    jcfg, cfg = _configs(dtype, conv_norm=norm, causal_conv=causal)
    params = convert.init_params(cfg, 2)
    block0 = jax.tree.map(lambda a: a[0], params["encoder"]["blocks"]["conv"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 20, cfg.enc_d_model)).astype(np.float32)
    mask = np.arange(20)[None] < np.array([[20], [13], [1]])
    jdt = jnp.dtype(dtype)
    want = jconformer.ConvModule(cfg.enc_conv_kernel, 0.0, True, jdt, norm, causal).apply(
        {"params": block0}, jnp.asarray(x, jdt), jnp.asarray(mask))
    model = convert.qat_model_from_jax(cfg, params, device="cpu")
    got = model.encoder.blocks[0].conv(torch.from_numpy(x).to(getattr(torch, dtype)),
                                       torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6 * np.abs(_np(want)).max()
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=tol)


def test_causal_conv_sees_only_the_past():
    """A change at frame 10 moves no output frame before it."""
    _, cfg = _configs(causal_conv=True, conv_norm="layer_norm")
    conv = convert.qat_model_from_jax(cfg, convert.init_params(cfg, 0),
                                      device="cpu").encoder.blocks[0].conv
    x = torch.randn(1, 20, cfg.enc_d_model)
    mask = torch.ones(1, 20, dtype=torch.bool)
    y = x.clone()
    y[0, 10] += 1.0
    a, b = conv(x, mask), conv(y, mask)
    assert torch.equal(a[0, :10], b[0, :10]) and not torch.equal(a[0, 10:], b[0, 10:])


# -- chunked attention ------------------------------------------------------------------


@pytest.mark.parametrize("T,chunk,left", [(1, 1, -1), (7, 3, -1), (7, 3, 0), (17, 8, 1),
                                          (24, 8, 2), (10, 16, -1), (12, 4, 5), (9, 1, 0)])
def test_chunk_pair_mask_matches_jax(T, chunk, left):
    want = np.asarray(jconformer.chunk_pair_mask(T, chunk, left))
    got = chunk_pair_mask(T, chunk, left)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_streaming_encoder_matches_jax_at_a_padded_time_axis():
    """layer_norm + causal conv + chunks of 8 with one left chunk, T'=37
    padded to 48 by time_pad_multiple 16 (chunk ids count from frame 0 of
    the padded axis): CTC log-probs on valid frames at precision 2 and 32
    (f32: 1e-5). With fused_attention set, the pair mask keeps every block
    off the fused kernel, as JAX's dispatch does."""
    jcfg, cfg = _configs(**STREAMING)
    params = convert.init_params(cfg, 4)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((3, 151, 80)).astype(np.float32)
    lens = np.array([151, 120, 77], np.int32)
    japply = jax.jit(JaxASR.from_config(jcfg).apply)
    model = convert.qat_model_from_jax(
        dataclasses.replace(cfg, fused_attention=True), params, device="cpu", decoder=False)

    def refuse(*a, **k):
        raise AssertionError("the fused attention ran under a pair mask")

    for m in model.modules():
        if isinstance(m, RelPosMHSA):
            m.attention_fn = refuse
    for precision in (2, 32):
        _, jmask, jlogits = japply({"params": params}, jnp.asarray(feats), jnp.asarray(lens),
                                   jax_binary_mask(precision, 2))
        want = np.asarray(jax.nn.log_softmax(jlogits.astype(jnp.float32), -1))
        with torch.no_grad():
            _, mask, logits = model(torch.from_numpy(feats), torch.from_numpy(lens),
                                    precision_to_binary_mask(precision, 2))
        assert mask.shape == (3, 48)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        got = torch.log_softmax(logits.float(), -1).numpy()
        valid = mask.numpy()
        np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5, atol=1e-5)


# -- the decoder ----------------------------------------------------------------------

# (quantize, reference_mode, bits, per_channel)
DECODER_CASES = [(False, False, 32, False), (False, True, 32, False)] + [
    (True, ref, bits, False) for ref in (False, True) for bits in (32, 2, 1)
] + [(True, True, 1, True)]


@pytest.mark.parametrize("quantize,reference,bits,per_channel", DECODER_CASES)
def test_decoder_options_match_jax(quantize, reference, bits, per_channel):
    """The decoder at quant_decoder x reference_decoder x bits (32, ternary,
    binary), and once with per-channel alpha: logits at f32, 1e-5. (Its
    gradients are held in the whole-step test of group (a).)"""
    _, cfg = _configs(quant_decoder=quantize, reference_decoder=reference,
                      quant_per_channel=per_channel)
    params = convert.init_params(cfg, 6)
    rng = np.random.default_rng(7)
    B, U, T, D = 3, 6, 11, cfg.enc_d_model
    tgt = rng.integers(0, cfg.vocab_size, (B, U)).astype(np.int32)
    valid = np.arange(U)[None] < np.array([[6], [3], [1]])
    memory = rng.standard_normal((B, T, D)).astype(np.float32)
    mem_mask = np.arange(T)[None] < np.array([[11], [7], [4]])
    jdec = JaxDecoder(cfg.vocab_size, D, cfg.dec_layers, cfg.dec_heads, cfg.dec_d_ff, 0.0,
                      compute_dtype=jnp.float32, quantize=quantize, per_channel=per_channel,
                      reference_mode=reference)
    want = jdec.apply({"params": params["decoder"]}, tgt, memory, mem_mask, valid,
                      32 if bits == 32 else jnp.asarray(bits == 1))
    model = convert.qat_model_from_jax(cfg, params, device="cpu")
    with torch.no_grad():
        got = model.decoder(torch.from_numpy(tgt).long(), torch.from_numpy(memory),
                            torch.from_numpy(mem_mask), torch.from_numpy(valid),
                            32 if bits == 32 else bits == 1)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_reference_smoothing_loss_and_grad_match_jax():
    rng = np.random.default_rng(8)
    B, U, V = 4, 6, 13
    logits = (3 * rng.standard_normal((B, U, V))).astype(np.float32)
    targets = rng.integers(0, V, (B, U)).astype(np.int32)
    valid = np.arange(U)[None] < np.array([[6], [3], [0], [1]])
    for ls in (0.1, 0.0, 0.3):
        jl, jg = jax.value_and_grad(lambda x: jatt.att_ce_loss(
            x, jnp.asarray(targets), jnp.asarray(valid), ls, reference_smoothing=True))(
                jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        tl = tatt.att_ce_loss(x, torch.from_numpy(targets), torch.from_numpy(valid), ls,
                              reference_smoothing=True)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), _np(jg), rtol=1e-5, atol=1e-7)
    # the two smoothings differ (and agree at ls 0)
    x = torch.from_numpy(logits)
    t, m = torch.from_numpy(targets), torch.from_numpy(valid)
    assert float(tatt.att_ce_loss(x, t, m, 0.1, True)) != float(tatt.att_ce_loss(x, t, m, 0.1))
    assert float(tatt.att_ce_loss(x, t, m, 0.0, True)) == float(tatt.att_ce_loss(x, t, m, 0.0))


# -- serving and evaluation ----------------------------------------------------------------


@pytest.mark.parametrize("precision,int8_act", [(2, False), (1, False), (2, True)])
def test_packed_quantized_decoder_matches_jax(precision, int8_act, monkeypatch):
    """The packed model with a quantized decoder (its 10 projections packed
    like the encoder's) against JAX's packed model, Pallas in interpret
    mode: forward_with_decoder's CTC and decoder log-probs on valid
    positions within FORWARD_CASES' f32 bounds."""
    jcfg, cfg = _configs(quant_decoder=True)
    params = convert.init_params(cfg, 9)
    rng = np.random.default_rng(10)
    feats = rng.standard_normal((3, 151, 80)).astype(np.float32)
    lens = np.array([151, 120, 77], np.int32)
    tokens = rng.integers(4, 32, (3, 5)).astype(np.int32)
    tgt_valid = np.arange(5)[None] < np.array([[5], [3], [1]])
    if int8_act:
        monkeypatch.setenv("ONEBIT_PACKED_INT8_ACT", "1")
    jmodel = JaxASR.from_config(jcfg, packed=True)
    jout = jax.jit(functools.partial(jmodel.apply, method=jmodel.forward_with_decoder))(
        {"params": jax_export(params, precision)}, jnp.asarray(feats), jnp.asarray(lens),
        jnp.asarray(tokens), jnp.asarray(tgt_valid), jax_binary_mask(precision, 2))
    model = convert.packed_model_from_jax(cfg, params, precision, int8_act, "cpu", decoder=True)
    assert type(model.decoder.layers[0].ff1).__name__ == "QuantDense"
    with torch.no_grad():
        out = model.forward_with_decoder(
            torch.from_numpy(feats), torch.from_numpy(lens), torch.from_numpy(tokens).long(),
            torch.from_numpy(tgt_valid), precision_to_binary_mask(precision, 2))
    mask = out[1].numpy()
    np.testing.assert_array_equal(mask, np.asarray(jout[1]))
    for got, want, keep in ((out[2], jout[2], mask), (out[3], jout[3], tgt_valid)):
        got = torch.log_softmax(got.float(), -1).numpy()
        want = np.asarray(jax.nn.log_softmax(want.astype(jnp.float32), -1))
        d = np.abs(got - want)[keep]
        assert np.isfinite(got[keep]).all()
        max_tol, mean_tol = (6e-2, 8e-3) if int8_act else (2e-2, 4e-3)
        assert d.max() <= max_tol and d.mean() <= mean_tol, (d.max(), d.mean())


@pytest.mark.parametrize("precision", [1])
def test_eval_step_with_quantized_reference_decoder_matches_jax(precision):
    """make_eval_step with quant_decoder + reference_decoder + per-channel
    alpha + group norm, and the reference smoothing: CTC log-probs, lengths
    and the branch loss against JAX's make_eval_step (rtol 1e-5)."""
    options = dict(quant_decoder=True, reference_decoder=True, quant_per_channel=True,
                   conv_norm="group_norm")
    jcfg, cfg = _configs(**options)
    params = convert.init_params(cfg, 11)
    batch = next(iter(DummyDataModule(batch_size=3, max_frames=72, max_tokens=6).valid_batches()))
    jeval = jax.jit(jstep.make_eval_step(JaxASR.from_config(jcfg),
                                         jc.LossConfig(reference_smoothing=True),
                                         jc.SpecialTokens(), 2, precision))
    jlp, jlens, jloss = jeval(params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.qat_model_from_jax(cfg, params, device="cpu")
    lp, lens, loss = make_eval_step(model, LossConfig(reference_smoothing=True), SpecialTokens(),
                                    2, precision)(dict(model.named_parameters()),
                                                  batch_to_device(batch, "cpu"))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    mask = np.arange(lp.shape[1])[None] < np.asarray(jlens)[:, None]
    np.testing.assert_allclose(lp.numpy()[mask], np.asarray(jlp)[mask], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


# -- the whole 3-branch step ---------------------------------------------------------------


def test_step_with_quantized_reference_decoder_per_channel_and_group_norm_matches_jax():
    """Group (a): per-channel alpha, the quantized reference decoder with
    the reference smoothing, group norm; the sp mask all True, so the sp
    branch's decoder is binary."""
    assert_loss_and_grads_match(_two_steps(
        "float32", steps=1, loss=dict(reference_smoothing=True),
        sp_masks=[np.array([True, True])], quant_per_channel=True, quant_decoder=True,
        reference_decoder=True, conv_norm="group_norm"))


def test_step_with_the_streaming_encoder_matches_jax():
    """Group (b): layer norm, causal conv, chunks of 8 with one left chunk,
    T'=17 padded to 24 (time_pad_multiple 8)."""
    assert_loss_and_grads_match(_two_steps(
        "float32", steps=1, **dict(STREAMING, time_pad_multiple=8)))

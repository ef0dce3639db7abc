"""The port's fused subsampler (`fused_subsample`, plain version on CPU) and
the `fused_subsampler=True` serving path against the JAX package, on CPU.

The JAX side runs as tests/test_fused_subsampler.py runs it: its Pallas
kernel in interpret mode. Inputs are numpy draws from a seed.

Tolerances, with their reasons:
- f32 compute: both compute conv1 in the same order; conv2 sums 9C f32
  products in another order (rtol/atol 1e-5);
- bf16 compute: the conv1 activation and the output round to bf16; an f32
  difference in conv2's sum can move the output by one bf16 ulp (rtol 2^-7,
  atol 1e-3); the share of bit-identical elements is reported;
- whole model: the bounds of tests/test_torch_transcribe.py (f32 max
  |d log p| 2e-2, mean 4e-3; bf16 0.15, 0.03).
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
from onebit_asr_tpu.ops.subsampler import fused_subsample as jax_fused_subsample
from onebit_asr_tpu.utils import config as jax_config
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import transcribe as cli
from onebit_asr_tpu_torch.model.asr import ConformerASR
from onebit_asr_tpu_torch.ops import subsampler as ss
from onebit_asr_tpu_torch.utils.config import ModelConfig, train_config_from_json

SMALL = dict(vocab_size=40, enc_d_model=64, enc_layers=2, enc_heads=2,
             enc_d_ff=128, enc_conv_kernel=7)


def _operands(seed, T, F, C, B=2):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, T, F)).astype(np.float32),
        (rng.standard_normal((3, 3, C)) * 0.3).astype(np.float32),
        (rng.standard_normal((C,)) * 0.1).astype(np.float32),
        (rng.standard_normal((9 * C, C)) * 0.1).astype(np.float32),
        (rng.standard_normal((C,)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("F", [17, 80])
@pytest.mark.parametrize("T", [21, 43, 600])
def test_fused_subsample_matches_jax(T, F, C, dtype, record_property):
    ops = _operands(T + F + C, T, F, C)
    want = jax_fused_subsample(*map(jnp.asarray, ops), getattr(jnp, dtype))
    want = np.asarray(want.astype(jnp.float32))
    before = ss.fused_subsample.launches
    got = ss.fused_subsample(*map(torch.from_numpy, ops), getattr(torch, dtype))
    assert ss.fused_subsample.launches == before  # CPU: the plain version
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, ss.out_len(ss.out_len(T)), ss.out_len(ss.out_len(F)), C)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-3)
        same = float((got == want).mean())
        record_property("bit_identical_share", same)
        print(f"T={T} F={F} C={C} bf16: bit-identical share {same:.4f}")


def test_plain_version_rounds_conv1_in_f32():
    """The plain version is `_fwd_kernel`'s order, not the unfused convs:
    on features whose conv1 sum is not representable in bf16, the two
    differ, and the plain version agrees with JAX's fused kernel."""
    ops = _operands(3, 43, 80, 16)
    got = ss.fused_subsample_reference(*map(torch.from_numpy, ops)).float()
    x, w1, b1, w2, b2 = map(torch.from_numpy, ops)
    bf = torch.bfloat16
    y = torch.nn.functional.conv2d(x[:, None].to(bf), w1.permute(2, 0, 1)[:, None].to(bf),
                                   b1.to(bf), stride=2).relu()
    w2_oihw = w2.reshape(3, 3, 16, 16).permute(3, 2, 0, 1).to(bf)
    unfused = torch.nn.functional.conv2d(y, w2_oihw, b2.to(bf), stride=2).relu()
    unfused = unfused.permute(0, 2, 3, 1).float()
    want = np.asarray(jax_fused_subsample(*map(jnp.asarray, ops)).astype(jnp.float32))
    assert not torch.equal(got, unfused)
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -7, atol=1e-3)


def test_fused_subsample_checks_operands():
    x, w1, b1, w2, b2 = map(torch.from_numpy, _operands(0, 43, 80, 16))
    with pytest.raises(ValueError):
        ss.fused_subsample(x, w1, b1, w2[:-1], b2)
    with pytest.raises(ValueError):
        ss.fused_subsample(x[0], w1, b1, w2, b2)
    with pytest.raises(ValueError):
        ss.fused_subsample(x[:, :6], w1, b1, w2, b2)  # T2 would be 0


def _configs(compute_dtype="float32", **flags):
    jcfg = dataclasses.replace(
        jax_config.ModelConfig(), dec_layers=1, dec_d_ff=64,
        compute_dtype=compute_dtype, **SMALL, **flags,
    )
    return jcfg, dataclasses.replace(ModelConfig(), compute_dtype=compute_dtype,
                                     **SMALL, **flags)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs(fused_subsampler=True)
    model = JaxASR.from_config(jcfg)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 80)), jnp.array([64]),
                           jax_binary_mask(2, 2))
    return jax.tree.map(np.asarray, variables["params"])


def _feats(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, 151, 80)).astype(np.float32),
            np.array([151, 120, 77], np.int32))


@pytest.mark.parametrize("compute_dtype,max_tol,mean_tol",
                         [("float32", 2e-2, 4e-3), ("bfloat16", 0.15, 0.03)])
def test_fused_packed_forward_matches_jax(jax_params, compute_dtype, max_tol, mean_tol):
    """ConformerASR with fused_subsampler=True against the JAX packed
    forward with the same flag (its fused kernel in interpret mode)."""
    jcfg, cfg = _configs(compute_dtype, fused_subsampler=True)
    feats, lens = _feats()
    jmodel = JaxASR.from_config(jcfg, packed=True)
    _, mask, jlogits = jmodel.apply({"params": jax_export(jax_params, 2)}, jnp.asarray(feats),
                                    jnp.asarray(lens), jax_binary_mask(2, 2))
    want = np.asarray(jax.nn.log_softmax(jlogits.astype(jnp.float32), -1))
    mask = np.asarray(mask)
    model = convert.packed_model_from_jax(cfg, jax_params, 2, device="cpu")
    assert model.encoder.subsample.fused
    _, got_mask, logits = model(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    got = torch.log_softmax(logits.float(), -1).numpy()
    d = np.abs(got - want)[mask]
    assert np.isfinite(got[mask]).all()
    assert d.max() <= max_tol and d.mean() <= mean_tol, (d.max(), d.mean())


def test_fused_subsampler_keeps_jax_projection_rows(jax_params):
    """The fused branch flattens f*C+c, so the converter keeps the JAX row
    order of the projection; the unfused one permutes it to c*F'+f."""
    _, cfg = _configs(fused_subsampler=True)
    kernel = jax_params["encoder"]["subsample"]["proj"]["kernel"]
    fused = convert.packed_model_from_jax(cfg, jax_params, device="cpu")
    np.testing.assert_array_equal(fused.encoder.subsample.proj.weight.numpy(), kernel.T)
    unfused = convert.packed_model_from_jax(
        dataclasses.replace(cfg, fused_subsampler=False), jax_params, device="cpu")
    C = cfg.enc_d_model
    f2 = kernel.shape[0] // C
    np.testing.assert_array_equal(
        unfused.encoder.subsample.proj.weight.numpy(),
        kernel.reshape(f2, C, -1).transpose(1, 0, 2).reshape(f2 * C, -1).T)
    # the two branches compute the same function up to conv1's rounding
    feats, _ = _feats(1)
    a = fused.encoder.subsample(torch.from_numpy(feats))
    b = unfused.encoder.subsample(torch.from_numpy(feats))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_config_json_with_fused_subsampler_builds_fused_branch():
    jcfg, _ = _configs(fused_subsampler=True)
    got = train_config_from_json(
        jax_config.config_to_json(jax_config.TrainConfig(model=jcfg)))
    assert got.model.fused_subsampler and not got.model.fused_attention
    assert ConformerASR(got.model).encoder.subsample.fused
    _, plain = _configs()
    assert not ConformerASR(plain).encoder.subsample.fused


def test_fused_attention_is_refused():
    jcfg, _ = _configs(fused_attention=True)
    cfg = train_config_from_json(
        jax_config.config_to_json(jax_config.TrainConfig(model=jcfg))).model
    assert cfg.fused_attention
    with pytest.raises(NotImplementedError, match="--no_fused_kernels"):
        ConformerASR(cfg)


def test_no_fused_kernels_clears_both_flags(jax_params, tmp_path, monkeypatch):
    """A config with both flags: the CLI refuses it, and serves it with
    --no_fused_kernels through a model built with neither flag."""
    import wave

    from flax.traverse_util import flatten_dict

    jcfg, _ = _configs(fused_attention=True, fused_subsampler=True)
    (tmp_path / "config.json").write_text(
        jax_config.config_to_json(jax_config.TrainConfig(model=jcfg)))
    np.savez(tmp_path / "params.npz", **flatten_dict(jax_params, sep="/"))
    (tmp_path / "wavs").mkdir()
    with wave.open(str(tmp_path / "wavs" / "a.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        pcm = np.random.default_rng(0).integers(-3000, 3000, 8000, dtype=np.int16)
        w.writeframes(pcm.tobytes())
    argv = ["--params", str(tmp_path / "params.npz"), "--config", str(tmp_path / "config.json"),
            "--wav_dir", str(tmp_path / "wavs"), "--out", str(tmp_path / "hyp.tsv"),
            "--device", "cpu"]
    with pytest.raises(NotImplementedError):
        cli.main(argv)
    built = []

    class Recording(cli.Transcriber):
        def __init__(self, cfg, *args, **kwargs):
            built.append(cfg.model)
            super().__init__(cfg, *args, **kwargs)

    monkeypatch.setattr(cli, "Transcriber", Recording)
    assert cli.main(argv + ["--no_fused_kernels"]) == 0
    assert len(built) == 1
    assert not built[0].fused_attention and not built[0].fused_subsampler
    assert (tmp_path / "hyp.tsv").read_text().startswith("a\t")

"""onebit_asr_tpu_torch's serving path against the JAX package, on CPU.

A small Conformer (2 blocks, d=64, d_ff=128, 2 heads) is initialised by the
JAX package; the same parameters and the same numpy inputs go through the
JAX functions (Pallas in interpret mode) and their ports. MaskedBatchNorm
takes its statistics from the batch, so whole batches are compared, and only
valid frames, because the time axis is padded.

Tolerances, with their reasons:
- frontend: f32 FFTs of two libraries (rtol 1e-4, atol 2e-4 on log-mel);
- packed forward, f32 compute: both sides round activations to bf16 inside
  the packed product; f32 differences of 1e-6 flip some of those roundings,
  so CTC log-probs differ by up to ~6e-3 (bound 2e-2, mean 4e-3);
- bf16 compute: every layer rounds to bf16 in both, at different points
  (log-probs max 0.15, mean 0.03);
- W2A8 (f32 compute): an f32 difference can move a value across an int8
  rounding step, 1/127 of its row's largest value; rare, so the f32 bounds
  hold (observed max 8.5e-3 over three seeds).
"""

import dataclasses
import os
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from onebit_asr_tpu.data.text import AsrTokenizer as JaxTokenizer
from onebit_asr_tpu.decode.greedy import greedy_ctc_decode as jax_greedy
from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.model.asr import precision_to_binary_mask as jax_binary_mask
from onebit_asr_tpu.model.conformer import Conv2dSubsampling as JaxSubsampling
from onebit_asr_tpu.model.packed import export_packed_params as jax_export
from onebit_asr_tpu.ops.frontend import LogMelFrontend as JaxFrontend
from onebit_asr_tpu.ops.frontend import apply_cmvn as jax_cmvn
from onebit_asr_tpu.utils import config as jax_config
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import transcribe as cli
from onebit_asr_tpu_torch.decode.greedy import greedy_ctc_decode
from onebit_asr_tpu_torch.model.asr import ConformerASR, check_trainable
from onebit_asr_tpu_torch.model.packed import export_packed_params
from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, apply_cmvn
from onebit_asr_tpu_torch.utils.config import ModelConfig, train_config_from_json
from torch_cpu_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=40, enc_d_model=64, enc_layers=2, enc_heads=2,
             enc_d_ff=128, enc_conv_kernel=7)


def _configs(compute_dtype="float32"):
    jcfg = dataclasses.replace(
        jax_config.ModelConfig(), dec_layers=1, dec_d_ff=64,
        compute_dtype=compute_dtype, **SMALL,
    )
    return jcfg, dataclasses.replace(ModelConfig(), dec_layers=1, dec_d_ff=64,
                                     compute_dtype=compute_dtype, **SMALL)


@pytest.fixture(scope="module")
def jax_params():
    """Training-form parameters of a real JAX run's tree, decoder included."""
    jcfg, _ = _configs()
    model = JaxASR.from_config(jcfg)
    feats = jnp.zeros((1, 64, 80))
    lens = jnp.array([64])
    variables = model.init(
        jax.random.PRNGKey(0), feats, lens, jnp.ones((1, 4), jnp.int32),
        jnp.ones((1, 4), bool), jax_binary_mask(2, 2), method=model.forward_with_decoder,
    )
    params = jax.tree.map(np.asarray, variables["params"])
    assert "decoder" in params
    return params


def _feats(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, 151, 80)).astype(np.float32)
    return feats, np.array([151, 120, 77], np.int32)


def _waves(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([16000, 12345, 401, 9000], np.int32)
    wavs = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n)
        wavs[i, :n] = 0.1 * rng.standard_normal(n) + 0.3 * np.sin(t * rng.uniform(0.01, 0.2))
    return wavs, lens


def test_frontend_matches_jax():
    wavs, lens = _waves()
    jf, jl = JaxFrontend()(jnp.asarray(wavs), jnp.asarray(lens))
    tf, tl = LogMelFrontend()(torch.from_numpy(wavs), torch.from_numpy(lens))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4, atol=2e-4)
    mean = np.linspace(-1, 1, 80).astype(np.float32)
    std = np.linspace(0.5, 2, 80).astype(np.float32)
    np.testing.assert_allclose(
        apply_cmvn(tf, torch.from_numpy(mean), torch.from_numpy(std)).numpy(),
        np.asarray(jax_cmvn(jf, mean, std)), rtol=1e-4, atol=2e-4,
    )


def test_frontend_rejects_too_short_waveform():
    with pytest.raises(ValueError):
        LogMelFrontend()(torch.zeros(1, 399), torch.tensor([399]))


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_ids_match_jax(seed):
    rng = np.random.default_rng(seed)
    # small integer logits: many ties, so first-maximum semantics count
    logits = rng.integers(0, 4, size=(4, 30, 6)).astype(np.float32)
    lens = np.array([30, 17, 1, 0], np.int32)
    ids, n = greedy_ctc_decode(torch.from_numpy(logits), torch.from_numpy(lens), 3)
    jids, jn = jax_greedy(jnp.asarray(logits), jnp.asarray(lens), 3)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def _to_jax_tree(model: ConformerASR, cfg: ModelConfig):
    """Inverse of convert.state_dict_from_jax, written out independently."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    L, C = cfg.enc_layers, cfg.enc_d_model
    tree = {}

    def put(path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    names = {"weight": "scale"}
    for key, v in sd.items():
        parts = key.split(".")
        if parts[:2] == ["encoder", "blocks"]:
            continue
        if parts[1:3] == ["subsample", "proj"] and parts[-1] == "weight":
            f2 = v.shape[1] // C  # [D, C*F'] -> rows f*C+c
            v = v.T.reshape(C, f2, -1).transpose(1, 0, 2).reshape(f2 * C, -1)
            put(["encoder", "subsample", "proj", "kernel"], v)
        elif parts[1] == "subsample" and parts[-1] == "weight":
            put(["encoder", "subsample", parts[2], "kernel"], v.transpose(2, 3, 1, 0))
        elif parts[0] == "ctc_head" and parts[-1] == "weight":
            put(["ctc_head", "kernel"], v.T)
        else:
            put(parts[:-1] + [names.get(parts[-1], parts[-1])], v)
    blocks = {}
    for key in sd:
        parts = key.split(".")
        if parts[:2] != ["encoder", "blocks"] or parts[2] != "0":
            continue
        rest = parts[3:]
        stacked = np.stack([sd[".".join(["encoder", "blocks", str(i)] + rest)] for i in range(L)])
        leaf = rest[-1]
        if leaf == "weight" and rest[-2] in ("pw1", "pw2"):
            rest, stacked = rest[:-1] + ["kernel"], stacked.transpose(0, 2, 1)
        elif leaf == "weight":
            rest = rest[:-1] + ["scale"]
        elif leaf == "dw_kernel":
            stacked = stacked.transpose(0, 3, 2, 1)
        blocks["/".join(rest)] = stacked
    put(["encoder", "blocks"], convert.unflatten(blocks))
    return tree


@pytest.mark.parametrize("precision", [2, 1])
def test_converter_round_trip(jax_params, precision):
    """JAX tree -> port modules -> JAX tree gives back every leaf exactly
    (packed bytes, alpha, biases, norms, HWIO convs, the [k,1,D] depthwise
    kernel, the subsampler flatten order); the decoder is left out."""
    _, cfg = _configs()
    model = convert.packed_model_from_jax(cfg, jax_params, precision, device="cpu")
    want = flatten_dict(jax_export(
        {k: v for k, v in jax_params.items() if k != "decoder"}, precision), sep="/")
    got = convert.flatten(_to_jax_tree(model, cfg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_npz_flatten_unflatten_round_trip(jax_params, tmp_path):
    flat = flatten_dict(jax_params, sep="/")
    np.savez(tmp_path / "p.npz", **flat)
    back = convert.flatten(convert.load_npz(str(tmp_path / "p.npz")))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_subsampler_matches_jax(jax_params):
    """f32 subsampler with converted conv and projection weights (flatten
    order f*C+c vs c*F'+f)."""
    jcfg, cfg = _configs()
    feats, _ = _feats()
    sub = jax_params["encoder"]["subsample"]
    want = JaxSubsampling(cfg.enc_d_model, 0.0, True, jnp.float32).apply(
        {"params": sub}, jnp.asarray(feats))
    model = convert.packed_model_from_jax(cfg, jax_params, device="cpu")
    got = model.encoder.subsample(torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _jax_log_probs(jax_params, jcfg, feats, lens, precision):
    bm = jax_binary_mask(precision, jcfg.enc_layers)
    model = JaxASR.from_config(jcfg, packed=True)
    packed = jax_export(jax_params, precision)
    _, mask, logits = model.apply({"params": packed}, jnp.asarray(feats), jnp.asarray(lens), bm)
    return np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1)), np.asarray(mask)


# (compute dtype, precision, int8 activations, max |d log p|, mean |d log p|)
FORWARD_CASES = [
    ("float32", 2, False, 2e-2, 4e-3),
    ("float32", 1, False, 2e-2, 4e-3),
    ("bfloat16", 2, False, 0.15, 0.03),
    ("float32", 2, True, 2e-2, 4e-3),
]


@pytest.mark.parametrize("compute_dtype,precision,int8_act,max_tol,mean_tol", FORWARD_CASES)
def test_packed_forward_matches_jax(jax_params, monkeypatch, compute_dtype, precision,
                                    int8_act, max_tol, mean_tol):
    jcfg, cfg = _configs(compute_dtype)
    feats, lens = _feats()
    if int8_act:
        monkeypatch.setenv("ONEBIT_PACKED_INT8_ACT", "1")
    want, mask = _jax_log_probs(jax_params, jcfg, feats, lens, precision)
    model = convert.packed_model_from_jax(cfg, jax_params, precision, int8_act, "cpu")
    _, got_mask, logits = model(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    got = torch.log_softmax(logits.float(), -1).numpy()
    assert got.shape == want.shape
    d = np.abs(got - want)[mask]
    assert np.isfinite(got[mask]).all()
    assert d.max() <= max_tol and d.mean() <= mean_tol, (d.max(), d.mean())


def test_time_padding_leaves_valid_frames_unchanged(jax_params):
    """T' padded to a multiple of 32 vs unpadded: same valid frames (f32
    compute; only bf16 roundings inside the packed products may move)."""
    _, cfg = _configs()
    feats, lens = _feats()
    out = {}
    for m in (1, 32):
        model = convert.packed_model_from_jax(
            dataclasses.replace(cfg, time_pad_multiple=m), jax_params, device="cpu")
        _, mask, logits = model(torch.from_numpy(feats), torch.from_numpy(lens))
        out[m] = (mask, torch.log_softmax(logits.float(), -1))
    assert out[32][0].shape[1] == 64 and out[1][0].shape[1] == 37
    mask = out[1][0]
    np.testing.assert_allclose(
        out[32][1][:, :37][mask].numpy(), out[1][1][mask].numpy(), atol=2e-2)


# every option of the JAX ModelConfig that changes what the model computes
ALL_OPTIONS = dict(conv_norm="group_norm", quant_per_channel=True, reference_decoder=True,
                   quant_decoder=True, causal_conv=True, attn_chunk_size=16, attn_left_chunks=2,
                   fused_attention=True, fused_subsampler=True, time_pad_multiple=32)


def test_unsupported_configs_are_refused():
    """What is still refused: per-channel alpha in the packed export, by
    both packages with the same exception and words. Every option builds in
    both forms, with and without the decoder."""
    _, cfg = _configs()
    params = convert.init_params(dataclasses.replace(cfg, quant_per_channel=True), 0)
    msgs = []
    for export, tree in ((jax_export, params), (export_packed_params, convert.to_torch(params))):
        with pytest.raises(NotImplementedError) as e:
            export(tree, 2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "tensor-wise alpha" in msgs[0]
    for change in (dict(conv_norm="group_norm"), dict(conv_norm="layer_norm"),
                   dict(causal_conv=True), dict(attn_chunk_size=16, attn_left_chunks=1),
                   dict(quant_per_channel=True), dict(quant_decoder=True),
                   dict(reference_decoder=True), ALL_OPTIONS):
        for qat in (False, True):
            ConformerASR(dataclasses.replace(cfg, **change), qat=qat, decoder=True)
        check_trainable(dataclasses.replace(cfg, **change))
    for change, what in ((dict(conv_norm="instance_norm"), "conv_norm"),
                         (dict(attn_chunk_size=0), "attn_chunk_size"),
                         (dict(attn_chunk_size=-3), "attn_chunk_size")):
        with pytest.raises(ValueError, match=what):
            check_trainable(dataclasses.replace(cfg, **change))
        with pytest.raises(ValueError, match=what):
            ConformerASR(dataclasses.replace(cfg, **change))


def test_config_json_of_a_jax_run_is_read():
    """A JAX run's config.json, with every model option and the reference
    smoothing set, reads back field for field."""
    jcfg, cfg = _configs()
    jtrain = jax_config.TrainConfig(model=jcfg, data=jax_config.DataConfig(max_frames=900))
    got = train_config_from_json(jax_config.config_to_json(jtrain))
    assert got.model == cfg
    assert got.data.max_frames == 900
    jtrain = jax_config.TrainConfig(model=dataclasses.replace(jcfg, **ALL_OPTIONS),
                                    loss=jax_config.LossConfig(reference_smoothing=True))
    got = train_config_from_json(jax_config.config_to_json(jtrain))
    assert got.model == dataclasses.replace(cfg, **ALL_OPTIONS)
    assert dataclasses.asdict(got.loss) == dataclasses.asdict(jtrain.loss)
    assert dataclasses.asdict(got.frontend) == dataclasses.asdict(jtrain.frontend)
    assert dataclasses.asdict(got.data) == dataclasses.asdict(jtrain.data)


def test_config_reader_drops_only_the_jax_compile_knobs():
    """The JAX config fields the port's reader drops are exactly the knobs
    that change no result in the port (remat, scan unroll, the QKV layout,
    the mesh): a later JAX field fails here instead of vanishing from a run
    read by the port."""
    from onebit_asr_tpu_torch.utils import config as tc

    dropped = {}
    for name in ("SpecialTokens", "FrontendConfig", "ModelConfig", "LossConfig", "DataConfig",
                 "OptimConfig", "TrainConfig"):
        jax_fields = {f.name for f in dataclasses.fields(getattr(jax_config, name))}
        port_fields = {f.name for f in dataclasses.fields(getattr(tc, name))}
        assert port_fields <= jax_fields, name
        if jax_fields - port_fields:
            dropped[name] = jax_fields - port_fields
    assert dropped == {"ModelConfig": {"remat_blocks", "remat_policy", "scan_unroll",
                                       "split_qkv"},
                       "TrainConfig": {"mesh_axes", "mesh_shape"}}


def _write_wav(path, wav, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())


def test_transcribe_cli_end_to_end(jax_params, tmp_path):
    """The CLI on CPU, packed serving: .npz params + config.json + a wav dir
    -> one line per utterance, text through a tokenizer.json. Its ids equal
    the Transcriber API's on the same waveforms, and its log-probs match the
    JAX pipeline (JAX frontend + CMVN + packed model)."""
    jcfg, cfg = _configs()
    wavs, lens = _waves(1)
    (tmp_path / "wavs" / "sub").mkdir(parents=True)
    names = ["a", "sub/b", "c", "d"]
    for name, w, n in zip(names, wavs, lens):
        _write_wav(tmp_path / "wavs" / f"{name}.wav", w[:n])
    _write_wav(tmp_path / "wavs" / "e.wav", wavs[0][::2], sr=8000)  # resampled
    np.savez(tmp_path / "params.npz", **flatten_dict(jax_params, sep="/"))
    (tmp_path / "config.json").write_text(
        jax_config.config_to_json(jax_config.TrainConfig(model=jcfg)))
    data = tmp_path / "data"
    data.mkdir()
    mean = np.full(80, -3.0, np.float32)
    std = np.full(80, 2.0, np.float32)
    np.savez(data / "cmvn_stats.npz", mean=mean, std=std)
    tok = JaxTokenizer.train(["HELLO WORLD", "PACKED TERNARY SERVING"] * 20, vocab_size=36)
    tok.save(str(data / "tokenizer.json"))
    out = tmp_path / "hyp.tsv"
    argv = ["--params", str(tmp_path / "params.npz"), "--config", str(tmp_path / "config.json"),
            "--wav_dir", str(tmp_path / "wavs"), "--data_dir", str(data),
            "--batch_size", "2", "--out", str(out), "--device", "cpu", "--packed"]
    assert cli.main(argv) == 0
    rows = [line.rstrip("\n").split("\t") for line in out.read_text().splitlines()]
    assert sorted(r[0] for r in rows) == sorted(names + ["e"])

    # the API on the same batches gives the same text
    cfgs = train_config_from_json((tmp_path / "config.json").read_text())
    t = cli.Transcriber(cfgs, jax_params, cmvn=(mean, std), device="cpu")
    want = {}
    for wb in cli._wav_dir_batches(str(tmp_path / "wavs"), 2, t.max_samples):
        ids, n = t.transcribe(wb["wavs"], wb["wav_lens"])
        for b, uid in enumerate(wb["utt_ids"]):
            want[uid] = tok.ids_to_text(ids[b, : n[b]])
    assert dict(rows) == want

    # its log-probs agree with the JAX pipeline on one batch
    w4 = np.stack([np.pad(w[:n], (0, 16000 - n)) for w, n in zip(wavs, lens)])
    pcm = (np.clip(w4, -1, 1) * 32767).astype(np.int16).astype(np.float32) / 32768.0
    lp, enc_lens = t.log_probs(pcm, lens)
    jf, jl = JaxFrontend()(jnp.asarray(pcm), jnp.asarray(lens))
    want_lp, mask = _jax_log_probs(jax_params, jcfg, jax_cmvn(jf, mean, std), jl, 2)
    np.testing.assert_array_equal(enc_lens.numpy(), mask.sum(-1))
    d = np.abs(lp.numpy() - want_lp)[mask]
    assert d.max() <= 2e-2 and d.mean() <= 4e-3, (d.max(), d.mean())


def test_port_runs_without_jax_or_the_jax_package():
    """The port and chip_smoke.py import neither jax nor onebit_asr_tpu: with
    both blocked, every module imports, a tiny packed forward runs on CPU
    unfused, with the fused subsampler and with the fused attention, a tiny
    QAT model takes one 3-branch train step, its checkpoint is served back
    (the inverse converter, the device beam with a packed LM, the host beam,
    long-form windows) and evaluated, chip_smoke exits 1 without its result
    line when there is no card, and on a 12-utterance data dir that
    chip_smoke's writer makes (the port's `write_manifest`, a character-level
    tokenizer.model) the train CLI takes one real-data step through prefetch
    and the transcribe CLI serves one batch of `--split test`, and `prepare
    all --synthetic 8 --device cpu` writes a data dir."""
    code = r"""
import importlib, io, contextlib, pkgutil, sys, dataclasses
sys.modules["jax"] = None
sys.modules["onebit_asr_tpu"] = None
import torch
import onebit_asr_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from onebit_asr_tpu_torch.convert import init_params, packed_model_from_jax
from onebit_asr_tpu_torch.utils.config import ModelConfig
cfg = dataclasses.replace(ModelConfig(), vocab_size=12, enc_d_model=32, enc_layers=1,
                          enc_heads=2, enc_d_ff=64, enc_conv_kernel=3)
for fused, fused_attention in ((False, False), (True, False), (False, True)):
    c = dataclasses.replace(cfg, fused_subsampler=fused, fused_attention=fused_attention)
    model = packed_model_from_jax(c, init_params(c, 0), device="cpu")
    assert model.encoder.subsample.fused == fused
    assert model.encoder.blocks[0].mhsa.fused == fused_attention
    _, mask, logits = model(torch.randn(2, 40, 80), torch.tensor([40, 30]))
    assert logits.shape == (2, 9, 12) and torch.isfinite(logits.float()).all()
from onebit_asr_tpu_torch.convert import qat_model_from_jax
from onebit_asr_tpu_torch.data.dummy import DummyDataModule
from onebit_asr_tpu_torch.train import AdamW, create_train_state, make_train_step
from onebit_asr_tpu_torch.train.step import batch_to_device
from onebit_asr_tpu_torch.utils.config import LossConfig, OptimConfig, SpecialTokens
c = dataclasses.replace(cfg, vocab_size=32, dec_layers=1, dec_d_ff=32)
qat = qat_model_from_jax(c, init_params(c, 0), device="cpu")
state = create_train_state(qat, 0)
step = make_train_step(qat, AdamW(OptimConfig(), 10), LossConfig(), SpecialTokens(), 1)
dm = DummyDataModule(batch_size=2, max_frames=48, max_tokens=4)
state, aux = step(state, batch_to_device(next(iter(dm.train_batches(0))), "cpu"))
assert state.step == 1 and torch.isfinite(aux["loss"]) and torch.isfinite(aux["grad_norm"])
import numpy as np
from onebit_asr_tpu_torch.convert import jax_tree_from_state_dict
from onebit_asr_tpu_torch.decode import ctc_beam_search_batch
from onebit_asr_tpu_torch.decode.beam_device import beam_search_device
from onebit_asr_tpu_torch.decode.lm import NGramLM
from onebit_asr_tpu_torch.decode.lm_device import DeviceLM
from onebit_asr_tpu_torch.decode.longform import longform_greedy_decode
from onebit_asr_tpu_torch.eval import evaluate_stream
tree = jax_tree_from_state_dict(state.params, c)
served = packed_model_from_jax(c, tree, device="cpu")
_, mask, logits = served(torch.randn(2, 48, 80), torch.tensor([48, 30]))
lp = torch.log_softmax(logits.float(), -1)
lm = NGramLM(3).fit([[5, 6, 7, 5], [6, 7, 8]])
ids, n = beam_search_device(lp, mask.sum(-1), beam_size=4, lm=DeviceLM.pack(lm), lm_weight=0.3)
host = ctc_beam_search_batch(lp.numpy(), mask.sum(-1).numpy(), beam_size=4, lm=lm,
                             lm_weight=0.3, prefer_native=False)
assert host == [ids[b, : n[b]].tolist() for b in range(2)]
k = longform_greedy_decode(served, np.random.randn(90, 80).astype(np.float32), None, 3,
                           chunk_frames=40, overlap_frames=8)[1]
assert k >= 0
m = evaluate_stream(qat, state.params, [next(iter(dm.valid_batches()))], LossConfig(),
                    SpecialTokens(), 1, use_beam=True, beam_size=3, device="cpu")
assert m["eval_utts"] == 2 and np.isfinite(m["loss_2bit"])
import chip_smoke
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = chip_smoke.main([])
assert rc == 1 and '"ok"' not in buf.getvalue(), (rc, buf.getvalue())
import json, os, tempfile
from onebit_asr_tpu_torch.cli import train as tcli, transcribe as tr
with tempfile.TemporaryDirectory() as root:
    data, _ = chip_smoke.write_data_dir(root, 0, (("train", 6), ("dev", 3), ("test", 3)),
                                        (1.0, 2.0), "cpu", cached=False)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(["--device", "cpu", "--data_dir", data, "--epochs", "1",
                          "--steps_per_epoch", "1", "--batch_size", "2", "--eval_batches", "1",
                          "--save_dir", root, "--run_name", "r", "--enc_layers", "1",
                          "--enc_d_model", "32", "--enc_heads", "2", "--enc_d_ff", "64",
                          "--enc_conv_kernel", "3", "--dec_layers", "1", "--dec_d_ff", "32"]) == 0
    m = json.loads(open(os.path.join(root, "r", "metrics.jsonl")).read())
    assert m["step"] == 1 and "input_wait_frac" in m
    out = os.path.join(root, "hyp.tsv")
    assert tr.main(["--checkpoint", os.path.join(root, "r"), "--split", "test", "--batch_size",
                    "3", "--max_batches", "1", "--out", out, "--device", "cpu"]) == 0
    ids = [l.split("\t")[0] for l in open(out).read().splitlines()]
    assert sorted(ids) == [f"test-{i:06d}" for i in range(3)], ids
from onebit_asr_tpu_torch.cli import prepare as pcli
with tempfile.TemporaryDirectory() as root:
    with contextlib.redirect_stdout(io.StringIO()):
        assert pcli.main(["all", "--out_dir", root, "--synthetic", "8", "--max_seconds", "1.5",
                          "--vocab_size", "48", "--num_utts", "8", "--device", "cpu"]) == 0
    assert {"cmvn_stats.npz", "lm.npz", "tokenizer.json", "train_manifest.jsonl"} <= set(
        os.listdir(root))
assert not any(k == "jax" or k.startswith(("jax.", "onebit_asr_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("clean")
"""
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("clean")

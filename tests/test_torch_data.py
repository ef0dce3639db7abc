"""onebit_asr_tpu_torch's real-data pipeline against the JAX package, on CPU.

One data dir is made by the JAX package's own `prepare all --synthetic` (24
train utterances of 0.9-1.5 s, 8 dev, 8 test, a 64-subword tokenizer.json,
CMVN statistics, token ids in every manifest row), and a copy of it by
`prepare features` (a float16 feature cache). Both data modules read them:

- manifests written back are byte-identical; bucket bounds and bucketed
  batches are equal for several seeds and epochs;
- `wav_batches` (train epochs 0 and 1, dev) and the cached-feature batches
  are exactly equal, also with the token ids of half the rows removed (the
  tokenizer then encodes them);
- `featurized_batches(augment=False)` within the frontend's tolerance
  (rtol 1e-4, atol 2e-4, as tests/test_torch_transcribe.py), lengths and
  tokens exact;
- the three CLIs run on the JAX-prepared dir (a 2-step tiny train run,
  evaluate on it, transcribe --split), and on a run without a tokenizer
  both transcribe CLIs exit 2.
"""

import dataclasses
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from onebit_asr_tpu.cli import transcribe as jax_transcribe
from onebit_asr_tpu.cli.prepare import main as prepare_main
from onebit_asr_tpu.data import manifest as jm
from onebit_asr_tpu.data.librispeech import LibriSpeechDataModule as JaxDataModule
from onebit_asr_tpu.data.text import AsrTokenizer as JaxTokenizer
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch.cli import evaluate as eval_cli
from onebit_asr_tpu_torch.cli import train as train_cli
from onebit_asr_tpu_torch.cli import transcribe as cli
from onebit_asr_tpu_torch.convert import jax_tree_from_state_dict, qat_model_from_jax
from onebit_asr_tpu_torch.data import manifest as pm
from onebit_asr_tpu_torch.data.librispeech import LibriSpeechDataModule
from onebit_asr_tpu_torch.data.text import AsrTokenizer
from onebit_asr_tpu_torch.eval import evaluate_stream
from onebit_asr_tpu_torch.utils.checkpoint import load_config, restore_params
from onebit_asr_tpu_torch.utils.config import DataConfig
from torch_cpu_threads import one_thread  # noqa: F401

TINY = ["--enc_layers", "2", "--enc_d_model", "64", "--enc_heads", "2", "--enc_d_ff", "128",
        "--enc_conv_kernel", "7", "--dec_layers", "1", "--dec_d_ff", "64",
        "--compute_dtype", "float32"]
DCFG = dict(batch_size=4, num_buckets=2, max_frames=250, max_tokens=24)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("data") / "d")
    assert prepare_main(["all", "--out_dir", out, "--synthetic", "24", "--max_seconds", "2.0",
                         "--vocab_size", "64", "--num_utts", "8"]) == 0
    return out


@pytest.fixture(scope="module")
def cached_dir(data_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cached") / "d")
    shutil.copytree(data_dir, out)
    assert prepare_main(["features", "--out_dir", out]) == 0
    return out


def _modules(d, drop_tokens=False, **kw):
    """(JAX data module, port data module) on `d`, the port's on the CPU;
    with `drop_tokens`, every other manifest row of both loses its ids."""
    jdm = JaxDataModule(d, JaxTokenizer.find_and_load(d), jc.DataConfig(data_dir=d, **DCFG),
                        seed=3, **kw)
    pdm = LibriSpeechDataModule(d, AsrTokenizer.find_and_load(d),
                                DataConfig(data_dir=d, **DCFG), seed=3, device="cpu", **kw)
    if drop_tokens:
        for dm in (jdm, pdm):
            for utts in dm._manifests.values():
                for u in utts[::2]:
                    u.tokens = []
    return jdm, pdm


def _numpy(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_manifests_written_back_are_byte_identical(data_dir, cached_dir, tmp_path):
    for d in (data_dir, cached_dir):
        for split in ("train", "dev", "test"):
            src = os.path.join(d, f"{split}_manifest.jsonl")
            pm.write_manifest(str(tmp_path / "port.jsonl"), pm.read_manifest(src))
            jm.write_manifest(str(tmp_path / "jax.jsonl"), jm.read_manifest(src))
            port = (tmp_path / "port.jsonl").read_bytes()
            assert port == (tmp_path / "jax.jsonl").read_bytes()
            assert port == open(src, "rb").read()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucketing_equals_jax(seed):
    lengths = np.random.default_rng(seed).integers(100, 30_000, size=203)
    lengths[:20] = 4800  # ties, as the synthetic corpus has
    for n_buckets in (1, 3, 8):
        bounds = pm.bucket_boundaries(lengths, n_buckets)
        np.testing.assert_array_equal(bounds, jm.bucket_boundaries(lengths, n_buckets))
        for B, drop_last in ((8, True), (5, False)):
            for epoch in (0, 1, None):
                rngs = [None if epoch is None else np.random.default_rng((seed, epoch))
                        for _ in range(2)]
                got = list(pm.bucketed_batches(lengths, bounds, B, rngs[0], drop_last))
                want = list(jm.bucketed_batches(lengths, bounds, B, rngs[1], drop_last))
                assert len(got) == len(want) > 0
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("drop_tokens", [False, True])
def test_wav_batches_equal_jax(data_dir, drop_tokens):
    jdm, pdm = _modules(data_dir, drop_tokens)
    assert pdm.splits() == jdm.splits() and pdm.vocab_size() == jdm.vocab_size()
    assert pdm.special_ids() == jdm.special_ids() and pdm.num_utts("train") == 24
    for split, epoch, shuffle in (("train", 0, None), ("train", 1, None), ("dev", 0, None),
                                  ("test", 0, False)):
        want = list(jdm.wav_batches(split, epoch, shuffle=shuffle))
        got = list(pdm.wav_batches(split, epoch, shuffle=shuffle))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w) and g["utt_ids"] == w["utt_ids"]
            for k in ("wavs", "wav_lens", "tokens", "token_lens"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    assert {pdm._pad_samples_for(n) for n in (1, 400, 401, 24000, 10 ** 6)} == {
        jdm._pad_samples_for(n) for n in (1, 400, 401, 24000, 10 ** 6)}


def test_featurized_batches_equal_jax(data_dir):
    jdm, pdm = _modules(data_dir)
    for split, epoch in (("train", 0), ("dev", 0)):
        want = list(jdm.featurized_batches(split, epoch, augment=False))
        got = list(pdm.featurized_batches(split, epoch, augment=False))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["feats"].dtype == torch.float32 and g["feats"].device.type == "cpu"
            for k in ("feat_lens", "tokens", "token_lens"):
                np.testing.assert_array_equal(_numpy(g[k]), np.asarray(w[k]))
            np.testing.assert_allclose(g["feats"].numpy(), np.asarray(w["feats"]),
                                       rtol=1e-4, atol=2e-4)


def test_augmented_batches_are_seeded_per_epoch(data_dir):
    _, pdm = _modules(data_dir)
    plain = [b["feats"] for b in pdm.featurized_batches("train", 0)]
    a0 = [b["feats"] for b in pdm.featurized_batches("train", 0, augment=True)]
    a0_again = [b["feats"] for b in pdm.featurized_batches("train", 0, augment=True)]
    a1 = [b["feats"] for b in pdm.featurized_batches("train", 1, augment=True)]
    assert all(torch.equal(x, y) for x, y in zip(a0, a0_again))
    assert not all(torch.equal(x, y) for x, y in zip(a0, plain))
    # masking only zeroes: every other element is the plain batch's
    for x, p in zip(a0, plain):
        assert torch.equal(x[x != 0], p[x != 0]) and (x == 0).sum() > (p == 0).sum()
    assert [x.shape for x in a1] != [x.shape for x in a0] or not all(
        torch.equal(x, y) for x, y in zip(a0, a1))


@pytest.mark.parametrize("drop_tokens", [False, True])
def test_cached_feature_batches_equal_jax(cached_dir, drop_tokens, monkeypatch):
    jdm, pdm = _modules(cached_dir, drop_tokens)
    for split, epoch in (("train", 0), ("train", 1), ("dev", 0)):
        want = list(jdm.featurized_batches(split, epoch, augment=False))
        got = list(pdm.featurized_batches(split, epoch, augment=False))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["feats"].dtype == torch.float16 and w["feats"].dtype == np.float16
            for k in ("feats", "feat_lens", "tokens", "token_lens"):
                np.testing.assert_array_equal(_numpy(g[k]), np.asarray(w[k]))
    monkeypatch.setenv("ONEBIT_F32_FEATS", "1")
    b = next(pdm.featurized_batches("dev"))
    assert b["feats"].dtype == torch.float32
    monkeypatch.delenv("ONEBIT_F32_FEATS")
    monkeypatch.setenv("ONEBIT_NO_FEATURE_CACHE", "1")
    b = next(pdm.featurized_batches("dev"))  # the frontend path: bucketed by samples
    want = next(jdm.featurized_batches("dev"))
    np.testing.assert_allclose(b["feats"].numpy(), np.asarray(want["feats"]), rtol=1e-4,
                               atol=2e-4)


@pytest.fixture(scope="module")
def run(data_dir, tmp_path_factory):
    """A 2-step port train run on the JAX-prepared dir: (run dir, stdout)."""
    root = str(tmp_path_factory.mktemp("runs"))
    assert train_cli.main(["--device", "cpu", "--data_dir", data_dir, "--epochs", "1",
                           "--steps_per_epoch", "2", "--batch_size", "4", "--num_buckets", "2",
                           "--max_frames", "250", "--eval_batches", "1", "--warmup_steps", "1",
                           "--prefetch_depth", "2", "--save_dir", root, "--run_name", "r",
                           *TINY]) == 0
    return os.path.join(root, "r")


def test_train_cli_on_real_data(run, data_dir):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        (m,) = [json.loads(line) for line in f]
    assert m["step"] == 2 and np.isfinite(m["train_loss"])
    assert 0.0 <= m["input_wait_frac"] <= 1.0 and m["eval_utts"] == 4
    cfg = load_config(run)
    # the config as JAX saves it: the run's data dir and batch size, the
    # default frontend (not the CLI's mask ratio), the tokenizer's vocabulary
    jcfg = jc.train_config_from_json(open(os.path.join(run, "config.json")).read())
    assert jcfg.data == jc.DataConfig(data_dir=data_dir, batch_size=4)
    assert jcfg.frontend == jc.FrontendConfig() and jcfg.beam_size == 10
    assert cfg.model.vocab_size == JaxTokenizer.find_and_load(data_dir).vocab_size


def test_evaluate_cli_on_real_data(run, data_dir, capsys):
    assert eval_cli.main(["--checkpoint", run, "--data_dir", data_dir, "--splits", "dev,test",
                          "--greedy", "--batch_size", "4", "--max_batches", "1",
                          "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    cfg = load_config(run)
    _, sd = restore_params(os.path.join(run, "ckpt"))
    model = qat_model_from_jax(cfg.model, jax_tree_from_state_dict(sd, cfg.model), "cpu")
    model.requires_grad_(False).eval()
    tok = AsrTokenizer.find_and_load(data_dir)
    dm = LibriSpeechDataModule(data_dir, tok, DataConfig(data_dir=data_dir, batch_size=4),
                               splits=("dev", "test"), device="cpu")
    for split in ("dev", "test"):
        m = evaluate_stream(model, dict(model.named_parameters()),
                            dm.featurized_batches(split, batch_size=4), cfg.loss,
                            cfg.model.specials, cfg.model.enc_layers, tokenizer=tok,
                            max_batches=1, device="cpu")
        block = text.split(f"== {split} (")[1]
        for tag in ("32bit", "2bit", "1bit"):
            wer = float(re.search(rf"\b{tag}: loss \S+  WER (\S+)%", block).group(1))
            assert wer == pytest.approx(round(m[f"wer_{tag}"] * 100, 2), abs=1e-9)
    assert eval_cli.main(["--checkpoint", run, "--data_dir", data_dir, "--splits", "nope",
                          "--device", "cpu"]) == 2


def test_transcribe_split_in_the_data_modules_order(run, data_dir, tmp_path):
    out = tmp_path / "hyp.tsv"
    assert cli.main(["--checkpoint", run, "--split", "test", "--batch_size", "3", "--out",
                     str(out), "--device", "cpu", "--precision", "1"]) == 0
    rows = [line.split("\t") for line in out.read_text().splitlines()]
    jdm = JaxDataModule(data_dir, JaxTokenizer.find_and_load(data_dir),
                        jc.DataConfig(data_dir=data_dir, batch_size=3), splits=("test",))
    order = [u for wb in jdm.wav_batches("test", shuffle=False, batch_size=3)
             for u in wb["utt_ids"]]
    assert [r[0] for r in rows] == order and len(order) == 8
    # the text is Transcriber's on the data module's batches
    cfg = load_config(run)
    _, sd = restore_params(os.path.join(run, "ckpt"))
    with np.load(os.path.join(data_dir, "cmvn_stats.npz")) as s:
        cmvn = (s["mean"], s["std"])
    t = cli.Transcriber(cfg, jax_tree_from_state_dict(sd, cfg.model), 1, cmvn=cmvn,
                        device="cpu", packed=False)
    tok = AsrTokenizer.find_and_load(data_dir)
    want = []
    for wb in jdm.wav_batches("test", shuffle=False, batch_size=3):
        ids, n = t.transcribe(wb["wavs"], wb["wav_lens"])
        want += [[u, tok.ids_to_text(ids[b, : n[b]])] for b, u in enumerate(wb["utt_ids"])]
    assert rows == want
    for argv in (["--split", "nope"], ["--longform"]):
        assert cli.main(["--checkpoint", run, "--device", "cpu", *argv]) == 2


def test_both_transcribe_clis_exit_2_without_a_tokenizer(run, tmp_path, capsys):
    """A run whose data dir has no tokenizer: JAX reads only its config.json
    before the check, so both CLIs run on the port's run dir."""
    empty = tmp_path / "empty"
    empty.mkdir()
    impl = jax.config.jax_default_prng_impl
    try:
        assert jax_transcribe.main(["--checkpoint", run, "--data_dir", str(empty)]) == 2
    finally:
        jax.config.update("jax_default_prng_impl", impl)
    jax_err = capsys.readouterr().err
    assert cli.main(["--checkpoint", run, "--data_dir", str(empty), "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    line = f"no tokenizer artifact in {empty} — pass --data_dir"
    assert line in jax_err and line in err


def test_config_fields_equal_jax():
    from onebit_asr_tpu_torch.utils import config as pc

    for name in ("FrontendConfig", "DataConfig"):
        ours, theirs = getattr(pc, name), getattr(jc, name)
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == [
            (f.name, f.default) for f in dataclasses.fields(theirs)]


@pytest.mark.parametrize("flags,name", [(["--spm", "m.model"], "--spm"),
                                        (["--torch_checkpoint", "c.pt"], "--torch_checkpoint"),
                                        (["--streaming"], "--streaming")])
def test_evaluate_cli_still_refuses(run, data_dir, flags, name, capsys):
    assert eval_cli.main(["--checkpoint", run, "--data_dir", data_dir, "--device", "cpu",
                          *flags]) == 2
    assert name in capsys.readouterr().err

"""onebit_asr_tpu_torch's `prepare` against the JAX package's, on CPU.

Both CLIs run in process on the same seeded corpus (`--synthetic 8
--max_seconds 2.0`, 8 train, 8 dev and 8 test utterances), each into its
own dir, and their files are compared one by one:

- manifests byte for byte, shards (npz) array for array, tokenizer.json as
  JSON, tokenizer.model (export_spm) byte for byte, lm.npz array for array;
- cmvn_stats.npz: mean and std within rtol 1e-5 plus 1e-5 x the largest
  element (f32 sums over the same frames in another order, and the std
  taken as sqrt(E[x^2] - E[x]^2), which loses digits);
- the f16 feature cache, made by each package's `features` from copies of
  one dir (the JAX-prepared one, so the inputs are identical): the
  manifests (feat_shard, feat_index, num_frames) byte for byte, the
  features within the port frontend's tolerance against JAX's (rtol 1e-4,
  atol 2e-4, as tests/test_torch_data.py) plus one f16 ulp.

`ingest` is compared in its other modes too: `--hard`, `--noise_only`,
`--wav_dir` (8 kHz and 16 kHz 16-bit wavs written with `wave`, the 8 kHz
ones through the resampler) and the HF-datasets layout (a tiny
`datasets.Dataset.save_to_disk`; skipped without `datasets`).
"""

import filecmp
import json
import os
import shutil
import sys
import wave

import numpy as np
import pytest
import torch

from onebit_asr_tpu.cli.prepare import main as jax_prepare
from onebit_asr_tpu_torch.cli.prepare import main as port_prepare
from torch_cpu_threads import one_thread  # noqa: F401

CORPUS = ["--synthetic", "8", "--max_seconds", "2.0", "--vocab_size", "64", "--num_utts", "8"]
SPLITS = ("train", "dev", "test")


def _both(root, argv):
    """Run `argv` through both CLIs into root/jax and root/port."""
    out = {}
    for side, main, extra in (("jax", jax_prepare, []), ("port", port_prepare,
                                                          ["--device", "cpu"])):
        out[side] = str(root / side)
        assert main([*argv, "--out_dir", out[side], *extra]) == 0, side
    return out["jax"], out["port"]


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """`all`, then `export_spm`, on both sides; and `features` by both on
    copies of the JAX dir."""
    root = tmp_path_factory.mktemp("prepared")
    j, p = _both(root, ["all", *CORPUS])
    for d, main, extra in ((j, jax_prepare, []), (p, port_prepare, ["--device", "cpu"])):
        assert main(["export_spm", "--out_dir", d, *extra]) == 0
    fj, fp = str(root / "features_jax"), str(root / "features_port")
    shutil.copytree(j, fj)
    shutil.copytree(j, fp)
    assert jax_prepare(["features", "--out_dir", fj]) == 0
    assert port_prepare(["features", "--out_dir", fp, "--device", "cpu"]) == 0
    return dict(jax=j, port=p, features_jax=fj, features_port=fp)


def _assert_manifests_and_shards_equal(j, p):
    names = sorted(os.listdir(j))
    assert names == sorted(os.listdir(p))
    for name in names:
        a, b = os.path.join(j, name), os.path.join(p, name)
        if name.endswith(".jsonl"):
            assert filecmp.cmp(a, b, shallow=False), name
        elif name.endswith("_shard00000.npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype == np.float32
                    np.testing.assert_array_equal(zb[k], za[k], err_msg=f"{name}:{k}")


def test_all_writes_the_same_files(prepared):
    """`all` writes what JAX's writes: the same names, and the manifests
    (token ids included) and shards equal."""
    j, p = prepared["jax"], prepared["port"]
    names = sorted(os.listdir(j))
    assert names == sorted(os.listdir(p))
    assert {"cmvn_stats.npz", "lm.npz", "tokenizer.json", "tokenizer.model"} <= set(names)
    assert {f"{s}_manifest.jsonl" for s in SPLITS} <= set(names)
    _assert_manifests_and_shards_equal(j, p)
    rows = [json.loads(line) for line in open(os.path.join(p, "train_manifest.jsonl"))]
    assert len(rows) == 8 and all(r["tokens"] for r in rows)


def test_tokenizer_json_is_jax_s(prepared):
    with open(os.path.join(prepared["jax"], "tokenizer.json")) as f:
        ref = json.load(f)
    with open(os.path.join(prepared["port"], "tokenizer.json")) as f:
        assert json.load(f) == ref


def test_export_spm_writes_jax_s_bytes(prepared):
    assert filecmp.cmp(os.path.join(prepared["jax"], "tokenizer.model"),
                       os.path.join(prepared["port"], "tokenizer.model"), shallow=False)


def test_lm_is_jax_s(prepared):
    with np.load(os.path.join(prepared["jax"], "lm.npz")) as a, \
            np.load(os.path.join(prepared["port"], "lm.npz")) as b:
        assert sorted(a.files) == sorted(b.files) == ["keys", "order", "total", "vals"]
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_cmvn_within_tolerance(prepared):
    with np.load(os.path.join(prepared["jax"], "cmvn_stats.npz")) as a, \
            np.load(os.path.join(prepared["port"], "cmvn_stats.npz")) as b:
        for k in ("mean", "std"):
            assert b[k].dtype == a[k].dtype == np.float32 and b[k].shape == (80,)
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                       atol=1e-5 * float(np.abs(a[k]).max()), err_msg=k)


@pytest.mark.parametrize("split", SPLITS)
def test_features_cache_matches_jax(prepared, split):
    j, p = prepared["features_jax"], prepared["features_port"]
    assert filecmp.cmp(os.path.join(j, f"{split}_manifest.jsonl"),
                       os.path.join(p, f"{split}_manifest.jsonl"), shallow=False)
    ref = np.load(os.path.join(j, f"{split}_feats.npy"))
    got = np.load(os.path.join(p, f"{split}_feats.npy"))
    assert got.dtype == ref.dtype == np.float16 and got.shape == ref.shape
    ref32, got32 = ref.astype(np.float32), got.astype(np.float32)
    ulp = np.spacing(np.abs(ref)).astype(np.float32)
    assert (np.abs(got32 - ref32) <= 2e-4 + 1e-4 * np.abs(ref32) + ulp).all()
    assert np.isfinite(got32).all()


def test_cmvn_accumulators_match_jax():
    """accumulate_cmvn / finalize_cmvn on a padded batch against JAX's, and
    the std floor."""
    import jax.numpy as jnp

    from onebit_asr_tpu.ops import frontend as jfe
    from onebit_asr_tpu_torch.ops import frontend as tfe

    rng = np.random.default_rng(0)
    feats = (rng.standard_normal((3, 7, 5)) * 3 + 2).astype(np.float32)
    feats[:, :, 0] = 4.0  # a constant bin: variance 0, std floored
    lens = np.array([7, 4, 0], np.int32)
    jacc = (jnp.zeros(5), jnp.zeros(5), jnp.zeros(()))
    tacc = (torch.zeros(5), torch.zeros(5), torch.zeros(()))
    for _ in range(2):
        jacc = jfe.accumulate_cmvn(jnp.asarray(feats), jnp.asarray(lens), jacc)
        tacc = tfe.accumulate_cmvn(torch.from_numpy(feats), torch.from_numpy(lens), tacc)
    for a, b in zip(tacc, jacc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert float(tacc[2]) == 22.0
    for a, b in zip(tfe.finalize_cmvn(tacc), jfe.finalize_cmvn(jacc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert float(tfe.finalize_cmvn(tacc)[1][0]) == pytest.approx(1e-8, rel=0, abs=1e-7)
    empty = tfe.finalize_cmvn((torch.zeros(2), torch.zeros(2), torch.zeros(())))
    assert empty[0].tolist() == [0.0, 0.0] and empty[1].tolist() == pytest.approx([1e-8] * 2)


@pytest.mark.parametrize("mode", [["--hard"], ["--noise_only"]])
def test_synthetic_ingest_modes_match_jax(tmp_path, mode):
    j, p = _both(tmp_path, ["ingest", "--synthetic", "8", "--max_seconds", "2.0", *mode])
    _assert_manifests_and_shards_equal(j, p)


def _write_wav(path, samples, rate):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(samples.astype("<i2").tobytes())


def test_wav_dir_ingest_matches_jax(tmp_path):
    """A LibriSpeech-like tree: 8 kHz and 16 kHz wavs, *.trans.txt lines, a
    wav without a transcript (skipped) and --dev_fraction 0.3."""
    rng = np.random.default_rng(1)
    tree = tmp_path / "wavs" / "19" / "198"
    tree.mkdir(parents=True)
    lines = []
    for i in range(6):
        rate = 8000 if i % 2 else 16000
        uid = f"19-198-{i:04d}"
        _write_wav(tree / f"{uid}.wav", rng.integers(-8000, 8000, int(rate * (0.5 + 0.1 * i))),
                   rate)
        lines.append(f"{uid} WORD{i} OTHER WORDS")
    _write_wav(tree / "orphan.wav", rng.integers(-10, 10, 800), 16000)
    (tree / "19-198.trans.txt").write_text("\n".join(lines) + "\n")
    j, p = _both(tmp_path, ["ingest", "--wav_dir", str(tmp_path / "wavs"), "--dev_fraction",
                            "0.3"])
    _assert_manifests_and_shards_equal(j, p)
    rows = [json.loads(line) for line in open(os.path.join(p, "train_manifest.jsonl"))]
    assert len(rows) == 5 and rows[0]["num_samples"] == int(16000 * 0.6)  # resampled


def test_hf_datasets_ingest_matches_jax(tmp_path):
    datasets = pytest.importorskip("datasets")
    rng = np.random.default_rng(2)
    for src, rate in (("tr", 8000), ("dv", 16000), ("te", 16000)):
        rows = {"audio": [{"array": rng.standard_normal(int(rate * 0.4)).tolist(),
                           "sampling_rate": rate} for _ in range(3)],
                "text": [f"{src.upper()} TEXT {i}" for i in range(3)],
                "id": [f"{src}-{i}" for i in range(3)]}
        datasets.Dataset.from_dict(rows).save_to_disk(str(tmp_path / "hf" / src))
    j, p = _both(tmp_path, ["ingest", "--in_dir", str(tmp_path / "hf"), "--train_splits",
                            "tr,missing", "--dev_splits", "dv", "--test_splits", "te"])
    _assert_manifests_and_shards_equal(j, p)
    rows = [json.loads(line) for line in open(os.path.join(p, "train_manifest.jsonl"))]
    assert [r["utt_id"] for r in rows] == ["tr-0", "tr-1", "tr-2"]
    assert rows[0]["num_samples"] == 6400  # 0.4 s at 8 kHz, resampled to 16 kHz


def test_ingest_without_datasets_and_tokenizer_without_tokenizers_exit_2(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "datasets", None)
    assert port_prepare(["ingest", "--out_dir", str(tmp_path), "--device", "cpu"]) == 2
    assert "datasets not available and --synthetic not given" in capsys.readouterr().err
    assert port_prepare(["ingest", "--out_dir", str(tmp_path), "--synthetic", "2",
                         "--max_seconds", "1.0"]) == 0
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    assert port_prepare(["tokenizer", "--out_dir", str(tmp_path), "--vocab_size", "32"]) == 2
    assert "`tokenizers` package" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "tokenizer.json")
    assert port_prepare(["lm", "--out_dir", str(tmp_path)]) == 2  # no token ids yet
    assert port_prepare(["features", "--out_dir", str(tmp_path / "none"),
                         "--device", "cpu"]) == 2

"""onebit_asr_tpu_torch/cli/spectrogram.py against the JAX package's frontend,
on CPU.

`log_mel` (the [F, T] array the CLI draws) is held against JAX's
`LogMelFrontend` (+ `apply_cmvn` from the data dir's cmvn_stats.npz) on the
CLI's synthetic chirp and on an utterance of a data dir. Tolerance (CMVN
undone on both sides): the two f32 FFTs round in another order, an error
relative to the frame's largest bin, which a log magnifies in the bins far
below it, and the chirp's pure tone spans ~27 nats. So: mel power
|e^got - e^want| <= 1e-5 x the frame's peak power everywhere (measured
1.13e-6), and log-mel within tests/test_torch_transcribe.py::
test_frontend_matches_jax's rtol 1e-4, atol 2e-4 in the bins within 10 nats
of the frame's peak (measured 1.0e-5). `main --synthetic` writes a PNG, and
exits 2 without matplotlib.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from onebit_asr_tpu.ops.frontend import LogMelFrontend as JaxFrontend
from onebit_asr_tpu.ops.frontend import apply_cmvn as jax_cmvn
from onebit_asr_tpu_torch.cli import spectrogram
from onebit_asr_tpu_torch.data.manifest import Utterance, write_manifest
from torch_cpu_threads import one_thread  # noqa: F401


def _jax_log_mel(wav, cmvn=None):
    feats, lens = JaxFrontend()(jnp.asarray(wav)[None, :], jnp.asarray([len(wav)]))
    if cmvn is not None:
        feats = jax_cmvn(feats, jnp.asarray(cmvn["mean"]), jnp.asarray(cmvn["std"]))
    return np.asarray(feats[0, : int(lens[0])]).T


def assert_log_mel_close(got, want, cmvn=None):
    if cmvn is not None:
        got = got * cmvn["std"][:, None] + cmvn["mean"][:, None]
        want = want * cmvn["std"][:, None] + cmvn["mean"][:, None]
    peak = want.max(axis=0, keepdims=True)
    assert np.all(np.abs(np.exp(got - peak) - np.exp(want - peak)) <= 1e-5)
    near = want >= peak - 10.0
    np.testing.assert_allclose(got[near], want[near], rtol=1e-4, atol=2e-4)


def _write_cmvn(directory):
    rng = np.random.default_rng(0)
    cmvn = {"mean": rng.normal(size=80).astype(np.float32),
            "std": rng.uniform(0.5, 2.0, size=80).astype(np.float32)}
    np.savez(os.path.join(directory, "cmvn_stats.npz"), **cmvn)
    return cmvn


@pytest.mark.parametrize("cmvn", [False, True])
def test_synthetic_log_mel_matches_jax(tmp_path, cmvn):
    stats = _write_cmvn(tmp_path) if cmvn else None
    got, title = spectrogram.log_mel(str(tmp_path), synthetic=True, device="cpu")
    want = _jax_log_mel(spectrogram.chirp(), stats)
    assert got.shape == want.shape == (80, 298)
    assert_log_mel_close(got, want, stats)
    assert title == "synthetic chirp" + (" (CMVN)" if cmvn else "")


def test_data_dir_utterance_matches_jax(tmp_path):
    """--split/--index pick a manifest row; its waveform comes from its npz
    shard."""
    rng = np.random.default_rng(1)
    wavs = {f"u{i}": (0.1 * rng.standard_normal(n)).astype(np.float32)
            for i, n in enumerate((8000, 12345))}
    np.savez(tmp_path / "dev_000.npz", **wavs)
    write_manifest(str(tmp_path / "dev_manifest.jsonl"),
                   [Utterance(k, "dev_000.npz", i, len(v), f"text {i}")
                    for i, (k, v) in enumerate(wavs.items())])
    stats = _write_cmvn(tmp_path)
    got, title = spectrogram.log_mel(str(tmp_path), "dev", 1, device="cpu")
    assert_log_mel_close(got, _jax_log_mel(wavs["u1"], stats), stats)
    assert title == "u1: text 1 (CMVN)"


def test_main_writes_a_png(tmp_path, capsys):
    out = tmp_path / "s.png"
    assert spectrogram.main(["--synthetic", "--data_dir", str(tmp_path), "--out", str(out),
                             "--device", "cpu"]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert f"wrote {out} (298 frames x 80 mel bins)" in capsys.readouterr().out


def test_main_without_matplotlib_exits_2(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    out = tmp_path / "s.png"
    assert spectrogram.main(["--synthetic", "--out", str(out), "--device", "cpu"]) == 2
    assert "matplotlib" in capsys.readouterr().err
    assert not out.exists()

"""Serving and evaluating a run that onebit_asr_tpu_torch trained, on CPU,
against the JAX package.

A 2-step run of the port's train CLI (tiny widths, f32 compute, the
synthetic backend) is restored with `restore_params` and turned into a
JAX-layout tree by `convert.jax_tree_from_state_dict`. Cases and
tolerances:

- the inverse converter: JAX tree -> state dict -> tree gives back every
  leaf bit for bit (torch.equal), for fused_subsampler False and True, with
  the decoder, in the training and the packed form;
- `transcribe --checkpoint`, packed and unpacked: the ids it decodes equal
  `Transcriber`'s on the inverted tree (the same computation) exactly, its
  text equals theirs decoded by the data dir's tokenizer, and its refusals
  exit 2;
- the unpacked forward at precision 32, 2 and 1 (f32 compute) against JAX
  `model.apply` on the same tree, on valid frames: the f32 bounds of
  tests/test_torch_transcribe.py's FORWARD_CASES (max 2e-2, mean 4e-3);
- `evaluate_stream(use_beam=True)` at precision 2 against JAX's on the same
  parameters and dummy batches: WER and CER equal, the loss within rtol
  1e-5.
"""

import dataclasses
import functools
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_asr_tpu.eval.evaluate import evaluate_stream as jax_evaluate
from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.model.asr import precision_to_binary_mask as jax_binary_mask
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import train as train_cli
from onebit_asr_tpu_torch.cli import transcribe as cli
from onebit_asr_tpu_torch.data import spm
from onebit_asr_tpu_torch.data.dummy import DummyDataModule
from onebit_asr_tpu_torch.data.text import AsrTokenizer
from onebit_asr_tpu_torch.eval.evaluate import evaluate_stream
from onebit_asr_tpu_torch.model.packed import export_packed_params
from onebit_asr_tpu_torch.utils.checkpoint import load_config, restore_params
from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens
from torch_cpu_threads import one_thread  # noqa: F401

TINY = ["--enc_layers", "2", "--enc_d_model", "64", "--enc_heads", "2", "--enc_d_ff", "128",
        "--enc_conv_kernel", "7", "--dec_layers", "1", "--dec_d_ff", "64",
        "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(run dir, its config, its parameters as a JAX-layout tree)."""
    root = tmp_path_factory.mktemp("runs")
    assert train_cli.main(["--device", "cpu", "--dummy_data", "--epochs", "1",
                           "--steps_per_epoch", "2", "--batch_size", "4", "--eval_batches", "1",
                           "--dummy_frames", "64", "--warmup_steps", "1", "--save_dir", str(root),
                           "--run_name", "r", *TINY]) == 0
    run_dir = str(root / "r")
    cfg = load_config(run_dir)
    step, sd = restore_params(os.path.join(run_dir, "ckpt"))
    assert step == 2
    return run_dir, cfg, convert.jax_tree_from_state_dict(sd, cfg.model)


def _jax_cfg(cfg):
    """The JAX package's ModelConfig of the same run (its own reader of the
    same config.json fields)."""
    fields = {f.name for f in dataclasses.fields(jc.ModelConfig)}
    kw = {k: v for k, v in dataclasses.asdict(cfg.model).items()
          if k in fields and k != "specials"}
    return dataclasses.replace(jc.ModelConfig(), remat_blocks=False, **kw)


def _numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("fused", [False, True])
def test_inverse_converter_round_trips(run, fused):
    _, cfg, tree = run
    mcfg = dataclasses.replace(cfg.model, fused_subsampler=fused)
    # the inverted checkpoint is a JAX tree: JAX's own leaves and shapes
    jmodel = JaxASR.from_config(_jax_cfg(cfg))
    abstract = jax.eval_shape(
        functools.partial(jmodel.init, method=jmodel.forward_with_decoder),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.array([64]),
        jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), bool), jax_binary_mask(2, 2))["params"]
    shapes = {k: tuple(v.shape) for k, v in convert.flatten(abstract).items()}
    assert shapes == {k: tuple(v.shape) for k, v in convert.flatten(tree).items()}
    for form in (tree, export_packed_params(tree, 2)):
        back = convert.jax_tree_from_state_dict(convert.state_dict_from_jax(form, mcfg), mcfg)
        want, got = convert.flatten(form), convert.flatten(back)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _write_inputs(root):
    rng = np.random.default_rng(4)
    (root / "wavs").mkdir()
    for i, n in enumerate((16000, 7000, 23000)):
        with wave.open(str(root / "wavs" / f"u{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((0.1 * rng.standard_normal(n) * 32767).astype(np.int16).tobytes())
    (root / "data").mkdir()
    cmvn = (np.full(80, -3.0, np.float32), np.full(80, 2.0, np.float32))
    np.savez(root / "data" / "cmvn_stats.npz", mean=cmvn[0], std=cmvn[1])
    # a character-level tokenizer over the run's 32 ids: 4 reserved pieces,
    # the word marker and 23 letters
    pieces = [("<blank>", 0.0, spm.CONTROL), ("<unk>", 0.0, spm.UNKNOWN),
              ("<sos>", 0.0, spm.CONTROL), ("<eos>", 0.0, spm.CONTROL), (spm.SPACE, 0.0, spm.NORMAL)]
    pieces += [(chr(ord("A") + i), 0.0, spm.NORMAL) for i in range(23)]
    (root / "data" / "tokenizer.model").write_bytes(spm.write_model_proto(pieces))
    return cmvn


@pytest.mark.parametrize("packed", [True, False])
def test_transcribe_checkpoint_matches_transcriber(run, tmp_path, packed, monkeypatch):
    run_dir, cfg, tree = run
    cmvn = _write_inputs(tmp_path)
    out = tmp_path / "hyp.tsv"
    argv = ["--checkpoint", run_dir, "--wav_dir", str(tmp_path / "wavs"),
            "--data_dir", str(tmp_path / "data"), "--batch_size", "2", "--out", str(out),
            "--device", "cpu", "--precision", "1"] + (["--packed"] if packed else [])
    # the text is lossy (ids 0-3 dropped, control pieces decode to nothing):
    # record the ids the CLI decodes, one call a line, to compare them exactly
    decoded, ids_to_text = [], AsrTokenizer.ids_to_text

    def recording(self, ids):
        decoded.append([int(i) for i in ids])
        return ids_to_text(self, ids)

    monkeypatch.setattr(AsrTokenizer, "ids_to_text", recording)
    assert cli.main(argv) == 0
    monkeypatch.undo()
    lines = [line.split("\t") for line in out.read_text().splitlines()]
    got = dict(lines)
    got_ids = {uid: ids for (uid, _), ids in zip(lines, decoded, strict=True)}
    t = cli.Transcriber(cfg, tree, 1, cmvn=cmvn, device="cpu", packed=packed)
    tok = AsrTokenizer.load(str(tmp_path / "data" / "tokenizer.model"))
    want, want_ids = {}, {}
    for wb in cli._wav_dir_batches(str(tmp_path / "wavs"), 2, t.max_samples):
        ids, n = t.transcribe(wb["wavs"], wb["wav_lens"])
        for b, uid in enumerate(wb["utt_ids"]):
            want[uid] = tok.ids_to_text(ids[b, : n[b]])
            want_ids[uid] = [int(i) for i in ids[b, : n[b]]]
    assert got_ids == want_ids and got == want and len(got) == 3


@pytest.mark.parametrize("flags,message", [
    (["--packed", "--precision", "32"], "--packed requires --precision 1 or 2"),
    (["--int8_act"], "--int8_act requires --packed"),
])
def test_transcribe_refusals_exit_2(run, tmp_path, capsys, flags, message):
    assert cli.main(["--checkpoint", run[0], "--wav_dir", str(tmp_path), "--device", "cpu",
                     *flags]) == 2
    assert message in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:  # both ways of naming the run at once
        cli.main(["--checkpoint", run[0], "--params", "p.npz", "--config", "c.json",
                  "--wav_dir", str(tmp_path)])
    assert e.value.code == 2


@pytest.fixture(scope="module")
def jax_apply(run):
    return jax.jit(JaxASR.from_config(_jax_cfg(run[1]), deterministic=True).apply)


@pytest.mark.parametrize("precision", [32, 2, 1])
def test_unpacked_forward_matches_jax(run, jax_apply, precision):
    _, cfg, tree = run
    rng = np.random.default_rng(precision)
    feats = rng.standard_normal((3, 93, 80)).astype(np.float32)
    lens = np.array([93, 70, 41], np.int32)
    _, mask, logits = jax_apply({"params": _numpy(tree)}, jnp.asarray(feats), jnp.asarray(lens),
                                jax_binary_mask(precision, cfg.model.enc_layers))
    want = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1))
    model = convert.qat_model_from_jax(cfg.model, tree, "cpu", decoder=False).eval()
    bm = cli.precision_to_binary_mask(precision, cfg.model.enc_layers)
    with torch.inference_mode():
        _, got_mask, got = model(torch.from_numpy(feats), torch.from_numpy(lens), bm)
    mask = np.asarray(mask)
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    got = torch.log_softmax(got.float(), -1).numpy()
    d = np.abs(got - want)[mask]
    assert np.isfinite(got[mask]).all()
    assert d.max() <= 2e-2 and d.mean() <= 4e-3, (d.max(), d.mean())


def test_evaluate_stream_beam_matches_jax(run):
    _, cfg, tree = run
    batches = list(DummyDataModule(batch_size=4, max_frames=64).valid_batches())[:1]
    L = cfg.model.enc_layers
    want = jax_evaluate(JaxASR.from_config(_jax_cfg(cfg), deterministic=True), _numpy(tree),
                        batches, jc.LossConfig(), jc.SpecialTokens(), L, precisions=(2,),
                        use_beam=True, beam_size=4)
    model = convert.qat_model_from_jax(cfg.model, tree, "cpu").requires_grad_(False).eval()
    got = evaluate_stream(model, dict(model.named_parameters()), batches, LossConfig(),
                          SpecialTokens(), L, precisions=(2,), use_beam=True, beam_size=4,
                          device="cpu")
    assert got["eval_utts"] == want["eval_utts"] == 4
    assert got["wer_2bit"] == want["wer_2bit"] and got["cer_2bit"] == want["cer_2bit"]
    np.testing.assert_allclose(got["loss_2bit"], want["loss_2bit"], rtol=1e-5)

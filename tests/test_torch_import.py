"""onebit_asr_tpu_torch's reference-checkpoint import against the JAX package,
on CPU.

The original PyTorch repo is not here, so its state dicts are written by
`chip_smoke.reference_state_dict`, the inverse of the import, from a tree of
`convert.init_params` (a tiny model: d=32, 2 blocks, 2 heads, d_ff 64,
conv kernel 7, 2 decoder layers, vocab 32, the batch-norm conv module); it
also writes the depthwise conv biases and BatchNorm running statistics a
reference checkpoint carries, which the import must ignore. Cases and
tolerances:

- `import_reference_state_dict(reference_state_dict(tree)) == tree`, leaf
  for leaf, bit for bit, for the port's import and JAX's alike;
- the subsampler's double permutation: the reference's c*F'+f columns go to
  the tree's f*C+c rows and back to c*F'+f in the port's unfused model,
  exactly;
- `load_reference_checkpoint(_params)` of a {"model", "args"} payload and of
  a bare state dict, equal to JAX's;
- one f32 forward of the imported tree through the port's QAT model and
  JAX's at precisions 32, 2, 1: CTC log-probs within 1e-5 on valid frames;
- packed f32 (f32 activations into row 1): the port's row 1 rounds x to
  bf16, as JAX's golden `ternary_matmul_reference` does; so does JAX's
  Pallas kernel in interpret mode on this CPU (equal to the golden bit for
  bit at f32 x), so the kernel alone is held to both within 1e-6, and the
  packed model's log-probs to JAX's packed model on either at
  tests/test_torch_transcribe.py's f32 packed bounds (max 2e-2, mean 4e-3;
  observed mean 2.4e-4 against both);
- `evaluate --torch_checkpoint` with a sibling config.json, with
  `--config`, with `--spm`, at `--precisions 32,2,1`, greedy and beam,
  packed; its parser errors; and `--config` with `--params`, where it still
  names the JAX run's config.json.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.model.asr import precision_to_binary_mask as jax_binary_mask
from onebit_asr_tpu.model.packed import export_packed_params as jax_export
from onebit_asr_tpu.ops import ternary_matmul as jtm
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu.utils import torch_import as jimport
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import evaluate as eval_cli
from onebit_asr_tpu_torch.model.asr import precision_to_binary_mask
from onebit_asr_tpu_torch.ops.ternary_matmul import ternary_matmul
from onebit_asr_tpu_torch.utils import torch_import as pimport
from onebit_asr_tpu_torch.utils.config import ModelConfig
from torch_cpu_threads import one_thread  # noqa: F401

HP = dict(input_dim=80, enc_d_model=32, enc_layers=2, enc_heads=2, enc_d_ff=64,
          enc_conv_kernel=7, dropout=0.1, dec_layers=2, dec_heads=2, dec_d_ff=64)


def _cfgs():
    both = dict(HP, vocab_size=32, compute_dtype="float32", conv_norm="batch_norm")
    return (jc.ModelConfig(remat_blocks=False, **both),
            dataclasses.replace(ModelConfig(), **both))


@pytest.fixture(scope="module")
def reference():
    """(tree, the reference state dict it inverts to)."""
    tree = convert.init_params(_cfgs()[1], 5)
    return tree, chip_smoke.reference_state_dict(tree, seed=6)


def _leaves(tree):
    return convert.flatten(tree)


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == np.float32 and g.shape == w.shape and np.array_equal(g, w), k


def test_import_round_trip_equals_the_tree_and_jax(reference):
    tree, sd = reference
    assert {"encoder.blocks.0.conv.dw.bias", "encoder.blocks.1.conv.bn.running_var",
            "encoder.blocks.0.conv.bn.num_batches_tracked"} <= set(sd)
    got = pimport.import_reference_state_dict(sd, 80, 2, 2)
    _assert_trees_equal(got, tree)
    _assert_trees_equal(got, jimport.import_reference_state_dict(sd, 80, 2, 2))
    enc_only = pimport.import_reference_state_dict(sd, 80, 2, 2, include_decoder=False)
    assert sorted(enc_only) == ["ctc_head", "encoder"]


def test_subsampler_rows_come_back_in_the_reference_order(reference):
    _, sd = reference
    tree = convert.to_torch(pimport.import_reference_state_dict(sd, 80, 2, 2))
    _, cfg = _cfgs()
    out_w = sd["encoder.subsample.out.weight"]  # [d, C*F'], columns c*F'+f
    unfused = convert.state_dict_from_jax(tree, cfg)["encoder.subsample.proj.weight"]
    assert np.array_equal(unfused.numpy(), out_w)
    fused = convert.state_dict_from_jax(tree, dataclasses.replace(cfg, fused_subsampler=True))
    C, F2 = 32, out_w.shape[1] // 32
    assert np.array_equal(fused["encoder.subsample.proj.weight"].numpy(),
                          out_w.reshape(32, C, F2).transpose(0, 2, 1).reshape(32, -1))


@pytest.mark.parametrize("wrapped", [True, False])
def test_load_reference_checkpoint_as_jax(reference, tmp_path, wrapped):
    tree, sd = reference
    path = str(tmp_path / "ckpt.pt")
    state = {k: torch.from_numpy(v) for k, v in sd.items()}
    args = argparse.Namespace(enc_layers=2, gamma_ctc=0.3)
    torch.save({"model": state, "args": args, "epoch": 3} if wrapped else state, path)
    got_sd, got_args = pimport.load_reference_checkpoint(path)
    want_sd, want_args = jimport.load_reference_checkpoint(path)
    assert got_args == want_args == ({"enc_layers": 2, "gamma_ctc": 0.3} if wrapped else {})
    assert sorted(got_sd) == sorted(want_sd) == sorted(sd)
    assert all(np.array_equal(got_sd[k], want_sd[k]) for k in sd)
    _assert_trees_equal(pimport.load_reference_checkpoint_params(path, 80, 2, 2), tree)


@pytest.mark.parametrize("precision", [32, 2, 1])
def test_imported_forward_matches_jax(reference, precision):
    _, sd = reference
    jcfg, cfg = _cfgs()
    tree = pimport.import_reference_state_dict(sd, 80, 2, 2)
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, 97, 80)).astype(np.float32)
    lens = np.array([97, 61], np.int32)
    _, jmask, jlogits = JaxASR.from_config(jcfg).apply(
        {"params": jimport.import_reference_state_dict(sd, 80, 2, 2)}, jnp.asarray(feats),
        jnp.asarray(lens), jax_binary_mask(precision, 2))
    want = np.asarray(jax.nn.log_softmax(jlogits.astype(jnp.float32), -1))
    model = convert.qat_model_from_jax(cfg, tree, "cpu").eval()
    with torch.no_grad():
        _, mask, logits = model(torch.from_numpy(feats), torch.from_numpy(lens),
                                precision_to_binary_mask(precision, 2))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    got = torch.log_softmax(logits.float(), -1).numpy()
    m = mask.numpy()
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-5)


def test_packed_f32_forward_rounds_x_as_the_golden(reference, monkeypatch):
    _, sd = reference
    jcfg, cfg = _cfgs()
    tree = pimport.import_reference_state_dict(sd, 80, 2, 2)
    rng = np.random.default_rng(8)
    # the kernel alone, f32 x: JAX's interpret mode, its golden and the port's row 1 on
    # the CPU all round x to bf16 (vs the f32 product: ~1.6e-2 apart)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    q = rng.integers(-1, 2, (64, 32)).astype(np.float32)
    packed = jtm.pack_planar(jnp.asarray(q))
    alpha = np.float32(0.37)
    interp = np.asarray(jtm.ternary_matmul_any_m(jnp.asarray(x), packed, jnp.asarray(alpha)))
    gold = np.asarray(jtm.ternary_matmul_reference(jnp.asarray(x), packed, jnp.asarray(alpha)))
    port = ternary_matmul(torch.from_numpy(x), torch.from_numpy(np.array(packed)),
                          torch.tensor(alpha)).numpy()
    assert np.array_equal(interp, gold)
    np.testing.assert_allclose(port, gold, rtol=1e-6, atol=1e-6)
    assert np.abs(gold - (x @ q) * alpha).max() > 1e-3

    feats = rng.standard_normal((2, 97, 80)).astype(np.float32)
    lens = np.array([97, 61], np.int32)
    jmodel = JaxASR.from_config(jcfg, packed=True)
    jparams = {"params": jax_export(tree, 2)}

    def jax_log_probs():
        _, mask, logits = jax.jit(jmodel.apply)(jparams, jnp.asarray(feats), jnp.asarray(lens),
                                                jax_binary_mask(2, 2))
        return np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1)), np.asarray(mask)

    interpret, mask = jax_log_probs()
    monkeypatch.setattr(jtm, "ternary_matmul_any_m",
                        lambda x, packed, alpha, **kw: jtm.ternary_matmul_reference(x, packed,
                                                                                    alpha))
    golden, _ = jax_log_probs()
    model = convert.packed_model_from_jax(cfg, tree, 2, False, "cpu", decoder=False)
    with torch.no_grad():
        _, got_mask, logits = model(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    got = torch.log_softmax(logits.float(), -1).numpy()
    assert np.isfinite(got[mask]).all()
    for want in (golden, interpret):
        d = np.abs(got - want)[mask]
        assert d.max() <= 2e-2 and d.mean() <= 4e-3, (d.max(), d.mean())


# -- the evaluate CLI -----------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(reference, tmp_path_factory):
    """A reference checkpoint whose payload args are Conformer-M's defaults,
    overridden by a sibling config.json to the tiny model."""
    _, sd = reference
    root = tmp_path_factory.mktemp("reference")
    path = str(root / "ckpt_last.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": {"enc_layers": 12, "gamma_ctc": 0.3}}, path)
    with open(root / "config.json", "w") as f:
        json.dump(HP, f)
    return path


def _evaluate(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = eval_cli.main([*argv, "--device", "cpu", "--max_batches", "1", "--batch_size", "2"])
    return rc, out.getvalue()


def _losses(text):
    return {line.split(":")[0].strip(): float(line.split("loss ")[1].split()[0])
            for line in text.splitlines() if ": loss " in line}


@pytest.mark.parametrize("decode", [["--greedy"], ["--beam_size", "3"]])
def test_evaluate_torch_checkpoint_with_its_sibling_config(checkpoint, decode):
    rc, text = _evaluate(["--torch_checkpoint", checkpoint, "--dummy_data", *decode])
    assert rc == 0, text
    assert "config overrides from" in text
    assert "imported reference checkpoint" in text and "2-layer d=32 encoder, vocab 32" in text
    losses = _losses(text)
    assert sorted(losses) == ["1bit", "2bit", "32bit"] and np.isfinite(list(losses.values())).all()


def test_evaluate_torch_checkpoint_config_flag_and_packed(checkpoint, tmp_path):
    """--config names the reference config.json (no sibling here); --packed
    evaluates one precision on the packed weights."""
    alone = str(tmp_path / "c.pt")
    shutil.copy(checkpoint, alone)
    with pytest.raises(KeyError, match="encoder.blocks.2"):  # the payload's 12 layers
        _evaluate(["--torch_checkpoint", alone, "--dummy_data", "--greedy"])
    cfg = str(tmp_path / "ref.json")
    with open(cfg, "w") as f:
        json.dump(HP, f)
    rc, text = _evaluate(["--torch_checkpoint", alone, "--config", cfg, "--dummy_data",
                          "--greedy", "--precisions", "32,2,1"])
    assert rc == 0 and f"config overrides from {cfg}" in text
    rc, packed = _evaluate(["--torch_checkpoint", alone, "--config", cfg, "--dummy_data",
                            "--greedy", "--packed", "--precisions", "32,1"])
    assert rc == 0 and "packed serving" in packed and sorted(_losses(packed)) == ["1bit"]
    assert abs(_losses(packed)["1bit"] - _losses(text)["1bit"]) <= 0.02 * _losses(text)["1bit"]


def test_evaluate_torch_checkpoint_with_spm(checkpoint, tmp_path):
    data, _ = chip_smoke.write_data_dir(str(tmp_path), 0, (("train", 2), ("dev", 2)),
                                        (1.0, 1.5), "cpu", cached=False)
    spm_path = str(tmp_path / "tokenizer.model")
    shutil.move(os.path.join(data, "tokenizer.model"), spm_path)
    argv = ["--torch_checkpoint", checkpoint, "--data_dir", data, "--splits", "dev", "--greedy"]
    assert _evaluate(argv)[0] == 2  # no tokenizer in the data dir
    rc, text = _evaluate([*argv, "--spm", spm_path, "--print_samples", "1"])
    assert rc == 0 and "== dev (2 utts) ==" in text and "REF: " in text


@pytest.mark.parametrize("extra,message", [
    (["--checkpoint", "run"], "give one of --checkpoint"),
    (["--params", "p.npz", "--config", "c.json"], "give one of --checkpoint"),
    (["--streaming"], "--streaming needs a chunked-causal checkpoint"),
])
def test_evaluate_torch_checkpoint_parser_errors(checkpoint, extra, message, capsys):
    with pytest.raises(SystemExit) as e:
        eval_cli.main(["--torch_checkpoint", checkpoint, "--dummy_data", *extra])
    assert e.value.code == 2 and message in capsys.readouterr().err


def test_evaluate_config_with_params_names_the_jax_run_config(reference, tmp_path):
    """The other meaning of --config: with --params, the JAX run's config.json."""
    from onebit_asr_tpu_torch.utils.config import TrainConfig, config_to_json

    tree, _ = reference
    np.savez(tmp_path / "params.npz", **convert.flatten(tree))
    (tmp_path / "config.json").write_text(config_to_json(TrainConfig(model=_cfgs()[1])))
    rc, text = _evaluate(["--params", str(tmp_path / "params.npz"), "--config",
                          str(tmp_path / "config.json"), "--dummy_data", "--greedy"])
    assert rc == 0 and "config overrides" not in text
    assert sorted(_losses(text)) == ["1bit", "2bit", "32bit"]

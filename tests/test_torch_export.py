"""onebit_asr_tpu_torch's serving artifacts (export.py, cli/export.py, serve
--artifact) against the JAX package's, on CPU.

JAX's tiny export configs (tests/test_export.py TINY / TINY_STREAM: input
16, d=32, 2 layers, 2 heads, d_ff 64, conv kernel 7, vocabulary 32; chunks
of 4 with 1 left) at f32 compute, so that ids can be compared exactly; the
parameters are `convert.init_params` (numpy) handed to both sides, and the
inputs are numpy draws from a seed. Every artifact goes through save ->
load. Cases and tolerances:

- offline artifacts at precisions 32, 2 and 1, unpacked, emit "both": the
  loaded artifact equals the port's live forward bit for bit; ids, lengths
  and valid frames equal JAX's artifact's; CTC log-probs on valid frames
  within 1e-4 of JAX's (f32 sums in another order; the serving tests'
  f32 unpacked bound, tests/test_torch_serve_checkpoint.py);
- one symbolic-batch artifact serves B = 1, 3 and 5, each equal to the live
  forward bit for bit and in ids to JAX's symbolic-batch artifact; packed +
  symbolic raises JAX's ValueError;
- the packed artifact (its custom ops run the plain versions on the CPU),
  bf16 and W2A8 activations, and bf16 with both fused flags (one graph
  node of row 5, one of row 3 a block; JAX's model on its fused attention
  branch through tests/test_torch_attention.py::force_jax_fused_attention),
  against the port's live packed forward (bit for bit) and JAX's packed
  export in interpret mode (ids equal; log-probs within the packed f32
  bounds of tests/test_torch_transcribe.py and
  tests/test_torch_attention.py: max 2e-2, mean 4e-3);
- emit "beam" with and without a baked 2-gram LM: ids equal to JAX's beam
  artifact and to the port's live beam (which stops at the longest length;
  the artifact runs every frame);
- streaming artifacts: a single-stream session and an n_streams=3 server,
  token for token equal to the port's live runtimes and to JAX's
  `streaming_*_from_artifact` (the live runtimes are held against JAX's in
  tests/test_torch_streaming.py); each constructor refuses the other's kind;
- `torch.library.opcheck` of the four custom ops on CPU tensors;
- the export CLI (`offline`, `streaming`, `run`) on a tiny run the port's
  train CLI wrote, and `serve --artifact` on stdio, whose finals equal
  `serve --checkpoint`'s; `run` in a fresh process imports no module of
  `onebit_asr_tpu_torch.model` and no JAX; `serve --artifact` takes the
  artifact's precision and slots over `--precision` and `--max_streams`, as
  JAX does, and takes `--device` only for a member the artifact holds;
- members: a one-member cpu artifact loads, and refuses cuda naming cpu; a
  cuda-first two-member artifact never runs its cpu member unless asked
  (on this card-less machine its default load raises, pointing to
  `--device cpu`); exporting for ("cpu", "cuda") here raises naming cuda
  and writes nothing;
- under ONEBIT_PACKED_INT8_ACT=1, `transcribe --packed` and `export offline
  --packed` of that run call row 2's CPU kernel and never row 1's, within
  the W2A8 f32 bounds (max 2e-2, mean 4e-3) of JAX's packed model under the
  same variable, on the same features.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_asr_tpu import export as jexport
from onebit_asr_tpu.decode.lm import NGramLM as JaxNGramLM
from onebit_asr_tpu.decode.lm_device import DeviceLM as JaxDeviceLM
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch import export as pexport
from onebit_asr_tpu_torch.cli import export as export_cli
from onebit_asr_tpu_torch.cli import serve as serve_cli
from onebit_asr_tpu_torch.cli import train as train_cli
from onebit_asr_tpu_torch.decode import streaming as pstream
from onebit_asr_tpu_torch.decode.lm import NGramLM
from onebit_asr_tpu_torch.decode.lm_device import DeviceLM
from onebit_asr_tpu_torch.ops import attention as at
from onebit_asr_tpu_torch.ops import subsampler as ss
from onebit_asr_tpu_torch.ops import ternary_matmul as tm
from onebit_asr_tpu_torch.utils.config import ModelConfig
from test_torch_attention import force_jax_fused_attention
from torch_cpu_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(input_dim=16, vocab_size=32, enc_d_model=32, enc_layers=2, enc_heads=2,
            enc_d_ff=64, enc_conv_kernel=7, dec_layers=1, dec_heads=2, dec_d_ff=64,
            dropout=0.0, compute_dtype="float32")
STREAM = dict(causal_conv=True, conv_norm="layer_norm", attn_chunk_size=4, attn_left_chunks=1)
T = 40


def _configs(**extra):
    return (jc.ModelConfig(remat_blocks=False, **TINY, **extra),
            dataclasses.replace(ModelConfig(), **TINY, **extra))


@pytest.fixture(scope="module")
def params():
    return convert.init_params(_configs()[1], 0)


@pytest.fixture(scope="module")
def stream_params():
    return convert.init_params(_configs(**STREAM)[1], 3)


def _batch(B, seed=1):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, 16)).astype(np.float32)
    lens = rng.integers(T // 2, T + 1, size=(B,))
    lens[0] = T
    return feats, lens


def _port(feats, lens):
    return torch.from_numpy(feats), torch.from_numpy(np.asarray(lens, np.int64))


def _jax(feats, lens):
    return jnp.asarray(feats), jnp.asarray(lens, jnp.int32)


def _roundtrip(tmp_path, name, exported, meta, save, load):
    path = str(tmp_path / name)
    save(exported, path, meta)
    return load(path)


def _port_artifact(tmp_path, name, cfg, exported, precision, kind="offline", emit="greedy",
                   packed=False, extra=None):
    meta = pexport.artifact_meta(cfg, precision, kind, emit, packed, extra)
    return _roundtrip(tmp_path, name, exported, meta, pexport.save_artifact,
                      pexport.load_artifact)


def _jax_artifact(tmp_path, name, jcfg, exported, precision, kind="offline", emit="greedy",
                  packed=False, extra=None):
    meta = jexport.artifact_meta(jcfg, precision, kind, emit, packed, extra)
    return _roundtrip(tmp_path, name, exported, meta, jexport.save_artifact,
                      jexport.load_artifact)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _ids(ids, lens):
    return pexport.greedy_ids_to_lists(np.asarray(ids), np.asarray(lens))


def _valid_close(lp_p, lp_j, lens, max_tol, mean_tol=None):
    d = np.concatenate([np.abs(lp_p[b, :n] - np.asarray(lp_j)[b, :n])
                        for b, n in enumerate(np.asarray(lens))])
    assert d.max() <= max_tol, d.max()
    if mean_tol is not None:
        assert d.mean() <= mean_tol, d.mean()


@pytest.mark.parametrize("precision", [32, 2, 1])
def test_offline_artifact_matches_live_and_jax(params, tmp_path, precision):
    jcfg, cfg = _configs()
    feats, lens = _batch(3)
    ep = pexport.export_offline(cfg, params, precision, T, 3, emit="both", device="cpu")
    fn, meta = _port_artifact(tmp_path, "p", cfg, ep, precision, emit="both")
    live = pexport.build_offline_forward(cfg, params, precision, emit="both", device="cpu")
    got = fn(*_port(feats, lens))
    with torch.no_grad():
        _equal(got, live(*_port(feats, lens)))
    assert meta["kind"] == "offline" and meta["precision"] == precision
    assert meta["device"] == "cpu" and meta["model"]["enc_d_model"] == 32
    assert meta["in_avals"] == ["feats: float32[3, 40, 16]", "feat_lens: int64[3]"]
    assert set(jexport.artifact_meta(jcfg, precision, "offline")) <= set(meta)

    jfn, _ = _jax_artifact(tmp_path, "j", jcfg, jexport.export_offline(
        jcfg, params, precision, T, 3, emit="both"), precision, emit="both")
    ids_j, lens_j, lp_j, el_j = jfn(*_jax(feats, lens))
    ids_p, lens_p, lp_p, el_p = (t.numpy() for t in got)
    np.testing.assert_array_equal(el_p, np.asarray(el_j))
    assert _ids(ids_p, lens_p) == _ids(ids_j, lens_j)
    _valid_close(lp_p, lp_j, el_p, 1e-4)


def test_symbolic_batch_artifact_serves_any_batch(params, tmp_path):
    jcfg, cfg = _configs()
    ep = pexport.export_offline(cfg, params, 1, T, None, emit="greedy", device="cpu")
    fn, meta = _port_artifact(tmp_path, "p", cfg, ep, 1)
    assert meta["in_avals"][0].startswith("feats: float32[s")
    live = pexport.build_offline_forward(cfg, params, 1, device="cpu")
    jfn, _ = _jax_artifact(tmp_path, "j", jcfg, jexport.export_offline(jcfg, params, 1, T, None),
                           1)
    for B in (1, 3, 5):
        feats, lens = _batch(B, seed=B)
        got = fn(*_port(feats, lens))
        assert got[0].shape[0] == B
        with torch.no_grad():
            _equal(got, live(*_port(feats, lens)))
        assert _ids(*got) == _ids(*jfn(*_jax(feats, lens)))


def test_symbolic_batch_rejects_packed(params, cli_run, tmp_path, capsys):
    """Packed + symbolic raises JAX's ValueError. On a machine without a
    card, an artifact for ("cpu", "cuda") raises naming cuda before anything
    is traced, and the CLI writes no directory; "tpu" is refused (the port
    has no TPU member)."""
    with pytest.raises(ValueError, match="static batch"):
        pexport.export_offline(_configs()[1], params, 2, T, None, packed=True, device="cpu")
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda needs a CUDA card"):
        pexport.export_offline(_configs()[1], params, 2, T, 2, platforms=("cpu", "cuda"))
    with pytest.raises(ValueError, match="no TPU member"):
        pexport.export_offline(_configs()[1], params, 2, T, 2, platforms=("tpu", "cpu"))
    out = tmp_path / "two"
    assert export_cli.main(["offline", "--checkpoint", cli_run, "--out", str(out), "--frames",
                            "64", "--batch", "2", "--platforms", "cpu,cuda"]) == 2
    assert "cuda needs a CUDA card" in capsys.readouterr().err
    assert not out.exists()


def _jax_packed_outputs(tmp_path, params, flags, int8_act):
    """JAX's packed p2 artifact (emit both, B=2) of `params` -> its outputs
    on `_batch(2)`; ONEBIT_PACKED_INT8_ACT=1 with `int8_act`, JAX's fused
    attention branch with `flags`."""
    jcfg, _ = _configs(**flags)
    with pytest.MonkeyPatch.context() as mp:
        if int8_act:
            mp.setenv("ONEBIT_PACKED_INT8_ACT", "1")
        if flags:
            assert force_jax_fused_attention(mp) is not None
        jfn, _ = _jax_artifact(tmp_path, "j", jcfg, jexport.export_offline(
            jcfg, params, 2, T, 2, packed=True, emit="both"), 2, emit="both", packed=True)
        return [np.asarray(x) for x in jfn(*_jax(*_batch(2)))]


@pytest.fixture(scope="module")
def jax_w2a8(params, tmp_path_factory):
    """JAX's packed W2A8 outputs, shared by the packed-artifact test and the
    ONEBIT_PACKED_INT8_ACT case."""
    return _jax_packed_outputs(tmp_path_factory.mktemp("jax_w2a8"), params, {}, True)


@pytest.mark.parametrize("variant", ["bf16", "int8_act", "fused"])
def test_packed_artifact_matches_live_and_jax_interpret(params, tmp_path, variant, request):
    int8_act = variant == "int8_act"
    flags = dict(fused_subsampler=True, fused_attention=True) if variant == "fused" else {}
    jcfg, cfg = _configs(**flags)
    feats, lens = _batch(2)
    ep = pexport.export_offline(cfg, params, 2, T, 2, packed=True, emit="both", device="cpu",
                                int8_act=int8_act)
    op = "ternary_matmul_w2a8" if int8_act else "ternary_matmul"
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count(f"onebit.{op}.default") == 9 * cfg.enc_layers
    assert targets.count("onebit.fused_subsample.default") == int(bool(flags))
    assert targets.count("onebit.fused_relpos_attention.default") == (
        cfg.enc_layers if flags else 0)
    fn, meta = _port_artifact(tmp_path, "p", cfg, ep, 2, emit="both", packed=True)
    assert meta["packed"] is True
    got = fn(*_port(feats, lens))
    live = pexport.build_offline_forward(cfg, params, 2, packed=True, emit="both",
                                         device="cpu", int8_act=int8_act)
    with torch.no_grad():
        _equal(got, live(*_port(feats, lens)))
    ids_j, lens_j, lp_j, _ = (request.getfixturevalue("jax_w2a8") if int8_act else
                              _jax_packed_outputs(tmp_path, params, flags, False))
    ids_p, lens_p, lp_p, el_p = (t.numpy() for t in got)
    assert _ids(ids_p, lens_p) == _ids(ids_j, lens_j)
    _valid_close(lp_p, lp_j, el_p, 2e-2, 4e-3)


def test_beam_artifact_with_and_without_baked_lm(params, tmp_path):
    jcfg, cfg = _configs()
    feats, lens = _batch(2)
    corpus = [[4, 5, 6], [4, 5, 7], [4, 5]]
    cases = {"lm": dict(beam_size=4, lm_weight=0.3, length_bonus=0.1), "nolm": dict(beam_size=4)}
    for name, kw in cases.items():
        lm_p = DeviceLM.pack(NGramLM(order=2).fit(corpus)) if name == "lm" else None
        lm_j = JaxDeviceLM.pack(JaxNGramLM(order=2).fit(corpus)) if name == "lm" else None
        ep = pexport.export_offline(cfg, params, 2, T, 2, emit="beam", device="cpu", lm=lm_p,
                                    **kw)
        fn, _ = _port_artifact(tmp_path, f"p{name}", cfg, ep, 2, emit="beam")
        got = _ids(*fn(*_port(feats, lens)))
        live = pexport.build_offline_forward(cfg, params, 2, emit="beam", device="cpu", lm=lm_p,
                                             **kw)
        with torch.no_grad():
            assert got == _ids(*live(*_port(feats, lens)))
        jfn, _ = _jax_artifact(tmp_path, f"j{name}", jcfg, jexport.export_offline(
            jcfg, params, 2, T, 2, emit="beam", lm=lm_j, **kw), 2, emit="beam")
        assert got == _ids(*jfn(*_jax(feats, lens)))
        assert any(got), got


def _drain(server, recs):
    outs, sids = {}, []
    for r in recs:
        sid = server.open()
        server.feed(sid, r)
        server.close(sid)
        sids.append(sid)
        outs[sid] = []
    while server.pending():
        for sid, toks in server.step().items():
            outs[sid].extend(toks)
    return [outs[sid] for sid in sids]


def test_streaming_artifacts_match_live_and_jax(stream_params, tmp_path):
    jcfg, cfg = _configs(**STREAM)
    rng = np.random.default_rng(7)
    recs = [rng.standard_normal((n, 16)).astype(np.float32) for n in (90, 55, 70)]
    paths = {}
    for n in (1, 3):
        paths[n] = {}
        for side, mod, c in (("p", pexport, cfg), ("j", jexport, jcfg)):
            kw = dict(device="cpu") if side == "p" else {}
            p = str(tmp_path / f"{side}{n}")
            mod.save_artifact(mod.export_streaming(c, stream_params, 2, n_streams=n, **kw), p,
                              mod.artifact_meta(c, 2, "streaming", extra={"n_streams": n}))
            paths[n][side] = p
    assert "active: bool[3]" in json.load(open(os.path.join(paths[3]["p"], "meta.json")))[
        "signature"]

    want = pstream.streaming_greedy_decode(cfg, stream_params, recs[0], 2, device="cpu")
    for side, mod in (("p", pexport), ("j", jexport)):
        sess = mod.streaming_session_from_artifact(paths[1][side])
        assert sess.accept(recs[0]) + sess.finish() == want, side
    live = _drain(pstream.StreamingServer(cfg, stream_params, 2, 3, device="cpu"), recs)
    assert any(live)
    for side, mod in (("p", pexport), ("j", jexport)):
        server = mod.streaming_server_from_artifact(paths[3][side])
        assert server.n == 3 and _drain(server, recs) == live, side
    with pytest.raises(ValueError, match="single-stream"):
        pexport.streaming_session_from_artifact(paths[3]["p"])
    with pytest.raises(ValueError, match="batched"):
        pexport.streaming_server_from_artifact(paths[1]["p"])


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s, dtype=torch.float32):
        return torch.randn(*s, generator=g).to(dtype)

    packed = tm.pack_planar(torch.randint(-1, 2, (32, 24), generator=g))
    B, H, Tq, dh = 2, 2, 6, 8
    key_mask = torch.ones(B, Tq)
    key_mask[1, 4:] = 0
    bf = torch.bfloat16
    return {
        "ternary_matmul": (torch.ops.onebit.ternary_matmul,
                           (r(5, 32, dtype=bf), packed, torch.tensor(0.7))),
        "ternary_matmul_w2a8": (torch.ops.onebit.ternary_matmul_w2a8,
                                (r(5, 32), packed, torch.tensor(0.7))),
        "fused_relpos_attention": (torch.ops.onebit.fused_relpos_attention, (
            r(B, H, Tq, dh, dtype=bf), r(B, H, Tq, dh, dtype=bf), r(B, H, Tq, dh, dtype=bf),
            r(H, 2 * Tq - 1, dh, dtype=bf), r(H, dh, dtype=bf), r(H, dh, dtype=bf), key_mask,
            torch.zeros(1, 1, 1, 1, dtype=torch.uint8), dh ** -0.5, 0.0)),
        "fused_subsample": (torch.ops.onebit.fused_subsample, (
            r(2, 21, 16), r(3, 3, 16), r(16), r(144, 16), r(16), torch.bfloat16)),
    }


@pytest.mark.parametrize("name", ["ternary_matmul", "ternary_matmul_w2a8",
                                  "fused_relpos_attention", "fused_subsample"])
def test_custom_op_opcheck(name):
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
    plain = {"ternary_matmul": tm.ternary_matmul_reference,
             "ternary_matmul_w2a8": tm.ternary_matmul_w2a8_reference,
             "fused_relpos_attention": at.fused_relpos_attention_reference,
             "fused_subsample": ss.fused_subsample_reference}[name]
    assert torch.equal(op(*args), plain(*args))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A 1-step streaming run of the port's train CLI (f32, tiny) -> run dir."""
    root = tmp_path_factory.mktemp("export_runs")
    flags = ["--enc_layers", "2", "--enc_d_model", "32", "--enc_heads", "2", "--enc_d_ff", "64",
             "--enc_conv_kernel", "7", "--dec_layers", "1", "--dec_d_ff", "64",
             "--compute_dtype", "float32", "--conv_norm", "layer_norm", "--causal_conv",
             "--attn_chunk_size", "4", "--attn_left_chunks", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert train_cli.main(["--device", "cpu", "--dummy_data", "--epochs", "1",
                               "--steps_per_epoch", "1", "--batch_size", "2",
                               "--eval_batches", "1", "--dummy_frames", "64",
                               "--warmup_steps", "1", "--save_dir", str(root), "--run_name",
                               "s", *flags]) == 0
    return str(root / "s")


def _serve(argv, lines, monkeypatch):
    """serve's main on stdio, in process -> the response events."""
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(json.dumps(x) + "\n" for x in lines)))
    monkeypatch.setattr(sys, "stdout", out)
    assert serve_cli.main([*argv, "--port", "0", "--data_dir", "none"]) == 0
    monkeypatch.undo()
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_export_cli_and_serve_artifact(cli_run, tmp_path, monkeypatch, capsys):
    off, stream = str(tmp_path / "off"), str(tmp_path / "stream")
    assert export_cli.main(["offline", "--checkpoint", cli_run, "--out", off, "--frames", "64",
                            "--batch", "2", "--emit", "both", "--device", "cpu"]) == 0
    assert export_cli.main(["streaming", "--checkpoint", cli_run, "--out", stream,
                            "--n_streams", "2", "--precision", "32", "--device", "cpu"]) == 0
    capsys.readouterr()
    meta = json.load(open(os.path.join(off, "meta.json")))
    assert meta["batch_size"] == 2 and meta["num_frames"] == 64 and meta["emit"] == "both"

    feats = np.random.default_rng(5).standard_normal((2, 50, 80)).astype(np.float32)
    npz = str(tmp_path / "feats.npz")
    np.savez(npz, feats=feats, feat_lens=np.array([50, 37]))
    code = ("import sys, json; from onebit_asr_tpu_torch.cli import export; "
            f"assert export.main(['run', '--artifact', {off!r}, '--features', {npz!r}]) == 0; "
            "print(json.dumps(sorted(m for m in sys.modules if m.startswith("
            "('onebit_asr_tpu_torch.model', 'jax', 'onebit_asr_tpu.')))))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    *printed, imported = proc.stdout.splitlines()
    assert json.loads(imported) == []
    fn, _ = pexport.load_artifact(off)
    x = np.zeros((2, 64, 80), np.float32)
    x[:, :50] = feats
    x[1, 37:] = 0
    ids, lens = fn(torch.from_numpy(x), torch.tensor([50, 37]))[:2]
    assert printed == [f"utt {i}: {h}" for i, h in enumerate(_ids(ids, lens))]

    lines = [{"op": "open"}, {"op": "open"},
             {"op": "feed", "sid": 0, "feats": feats[0].tolist()},
             {"op": "feed", "sid": 1, "feats": feats[1, :37].tolist()},
             {"op": "close", "sid": 0}, {"op": "close", "sid": 1}]
    capsys.readouterr()
    # as in JAX, --precision and --max_streams beside an artifact take the
    # artifact's values (32 and 2 here), with a note; --device stays refused
    got = _serve(["--artifact", stream, "--precision", "1", "--max_streams", "5"], lines,
                 monkeypatch)
    err = capsys.readouterr().err
    assert "--precision 1 is the artifact's 32" in err
    assert "--max_streams 5 is the artifact's 2" in err
    want = _serve(["--checkpoint", cli_run, "--precision", "32", "--max_streams", "2",
                   "--device", "cpu"], lines, monkeypatch)
    finals = [e for e in got if e["event"] == "final"]
    assert len(finals) == 2 and got == want
    # --device picks a member the artifact holds, and is refused for another
    assert _serve(["--artifact", stream, "--device", "cpu"], lines, monkeypatch) == want
    capsys.readouterr()
    assert serve_cli.main(["--artifact", stream, "--device", "cuda", "--port", "0"]) == 2
    assert "--device: the artifact fixes its devices (set them when exporting it); it holds " \
        "cpu" in capsys.readouterr().err


def test_artifact_members_load_by_device(params, tmp_path, capsys):
    """A one-member cpu artifact loads by default and with device="cpu", and
    refuses cuda naming its cpu member (`export run --device cuda` exits 2).
    A two-member artifact whose meta lists cuda first (its cuda file a copy
    here: no card) loads its cpu member only when asked: by default it
    raises on this machine, pointing to --device cpu. meta.json lists the
    platforms in order and each member's file."""
    cfg = _configs()[1]
    path = str(tmp_path / "one")
    pexport.save_artifact(pexport.export_offline(cfg, params, 2, T, 2, emit="logprobs",
                                                 device="cpu"), path,
                          pexport.artifact_meta(cfg, 2, "offline", "logprobs"))
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["platforms"] == ["cpu"] and meta["members"] == {"cpu": "module.pt2"}
    args = _port(*_batch(2))
    want = pexport.load_artifact(path)[0](*args)
    for device in (None, "cpu"):
        fn, got_meta = pexport.load_artifact(path, device=device)
        assert got_meta["device"] == "cpu"
        _equal(fn(*args), want)
    with pytest.raises(ValueError, match="no cuda member \\(it holds cpu\\)"):
        pexport.load_artifact(path, device="cuda")
    assert export_cli.main(["run", "--artifact", path, "--device", "cuda"]) == 2
    assert "it holds cpu" in capsys.readouterr().err

    two = tmp_path / "two"
    two.mkdir()
    for name in ("module_cuda.pt2", "module_cpu.pt2"):
        with open(os.path.join(path, "module.pt2"), "rb") as src, open(two / name, "wb") as dst:
            dst.write(src.read())
    json.dump({**meta, "platforms": ["cuda", "cpu"], "device": "cuda",
               "members": {"cuda": "module_cuda.pt2", "cpu": "module_cpu.pt2"}},
              open(two / "meta.json", "w"))
    with pytest.raises(RuntimeError, match="load its cpu member with --device cpu"):
        pexport.load_artifact(str(two))
    fn, got_meta = pexport.load_artifact(str(two), device="cpu")
    assert got_meta["device"] == "cpu"
    _equal(fn(*args), want)


@pytest.fixture
def counted_products(monkeypatch):
    """{kernel row: calls} of the packed products' CPU kernels (row 1, the
    bf16 product; row 2, W2A8) while the test runs."""
    calls = {"ternary_matmul": 0, "ternary_matmul_w2a8": 0}
    for name in calls:
        plain = getattr(tm, f"{name}_reference")

        def counted(*a, _name=name, _plain=plain, **k):
            calls[_name] += 1
            return _plain(*a, **k)

        monkeypatch.setattr(tm, f"{name}_reference", counted)
    return calls


def test_packed_int8_act_env_routes_the_clis_to_w2a8(cli_run, params, jax_w2a8, tmp_path,
                                                     monkeypatch, counted_products, capsys):
    """Under ONEBIT_PACKED_INT8_ACT=1 (JAX's switch, read by its packed
    dense) `transcribe --packed` of the trained run and `export offline
    --packed` of a run of the tiny model call row 2 and never row 1; the
    first's log-probs match JAX's packed model under the variable on the
    same features, the second's artifact equals the live W2A8 forward and
    JAX's W2A8 export in ids (tests/test_torch_transcribe.py's W2A8 f32
    bounds on log-probs)."""
    from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
    from onebit_asr_tpu.model.asr import precision_to_binary_mask as jax_mask
    from onebit_asr_tpu.model.packed import export_packed_params as jax_packed
    from onebit_asr_tpu_torch.cli import transcribe as transcribe_cli
    from onebit_asr_tpu_torch.train.state import TrainState
    from onebit_asr_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_config,
        restore_params,
        save_config,
    )
    from onebit_asr_tpu_torch.utils.config import TrainConfig

    import chip_smoke

    monkeypatch.setenv("ONEBIT_PACKED_INT8_ACT", "1")
    cfg = load_config(cli_run)
    tree = convert.jax_tree_from_state_dict(restore_params(os.path.join(cli_run, "ckpt"))[1],
                                            cfg.model)
    jcfg = jc.train_config_from_json(open(os.path.join(cli_run, "config.json")).read())
    jmodel = JaxASR.from_config(jcfg.model, packed=True)
    jpacked = jax_packed(jax.tree.map(np.asarray, tree), 2)

    def jax_log_probs(feats, lens):
        _, mask, logits = jmodel.apply({"params": jpacked}, jnp.asarray(feats),
                                       jnp.asarray(lens, jnp.int32), jax_mask(2, 2))
        return np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1)), np.asarray(mask)

    made = []

    class Recorded(transcribe_cli.Transcriber):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(transcribe_cli, "Transcriber", Recorded)
    data = tmp_path / "data"
    chip_smoke.write_char_tokenizer(str(data))
    rng = np.random.default_rng(3)
    wavs = [0.3 * np.sin(np.arange(n) * rng.uniform(0.01, 0.2)).astype(np.float32)
            + 0.05 * rng.standard_normal(n).astype(np.float32) for n in (8000, 6100)]
    chip_smoke.write_wavs(str(tmp_path / "wavs"), wavs)
    assert transcribe_cli.main(["--checkpoint", cli_run, "--wav_dir", str(tmp_path / "wavs"),
                                "--data_dir", str(data), "--packed", "--device", "cpu",
                                "--out", str(tmp_path / "hyp.tsv")]) == 0
    assert counted_products["ternary_matmul_w2a8"] > 0
    assert counted_products["ternary_matmul"] == 0
    t = made[0]
    batch = chip_smoke.pad_batch(wavs)
    feats, feat_lens = t.featurize(*batch)
    lp, enc_lens = t.log_probs(*batch)
    lp_j, mask = jax_log_probs(feats.numpy(), feat_lens.numpy())
    np.testing.assert_array_equal(enc_lens.numpy(), mask.sum(-1))
    _valid_close(lp.numpy(), lp_j, enc_lens.numpy(), 2e-2, 4e-3)

    # export offline --packed of a run of the tiny model: row 2 only, bit-equal
    # to the live W2A8 forward, and JAX's W2A8 export's ids on the same batch
    tiny = _configs()[1]
    run = tmp_path / "tiny_run"
    save_config(str(run), TrainConfig(model=tiny))
    CheckpointManager(str(run / "ckpt")).save(TrainState(
        step=1, params=convert.state_dict_from_jax(convert.to_torch(params), tiny), mu={},
        nu={}, count=0, generator=torch.Generator()))
    out = str(tmp_path / "w2a8")
    assert export_cli.main(["offline", "--checkpoint", str(run), "--out", out, "--frames",
                            str(T), "--batch", "2", "--packed", "--emit", "both", "--device",
                            "cpu"]) == 0
    capsys.readouterr()
    fn, meta = pexport.load_artifact(out)
    assert meta["int8_act"] is True and meta["packed"] is True
    counted_products.update(ternary_matmul=0, ternary_matmul_w2a8=0)
    got = fn(*_port(*_batch(2)))
    assert counted_products["ternary_matmul_w2a8"] == 9 * tiny.enc_layers
    assert counted_products["ternary_matmul"] == 0
    live = pexport.build_offline_forward(tiny, params, 2, packed=True, emit="both",
                                         device="cpu", int8_act=True)
    with torch.no_grad():
        _equal(got, live(*_port(*_batch(2))))
    ids_j, lens_j, lp_j, _ = jax_w2a8
    ids_p, lens_p, lp_p, el_p = (t.numpy() for t in got)
    assert _ids(ids_p, lens_p) == _ids(ids_j, lens_j)
    _valid_close(lp_p, lp_j, el_p, 2e-2, 4e-3)

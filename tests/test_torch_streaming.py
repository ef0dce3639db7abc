"""onebit_asr_tpu_torch's streaming runtime against the JAX package, on CPU.

JAX's tiny streaming config (tests/test_streaming.py: d=32, 2 layers, 2
heads, d_ff 64, conv kernel 7, chunks of 4 with 1 left, vocab 32); the
parameters are `convert.init_params` (numpy) handed to both sides, with
`fused_subsampler=True` on the port's side: the streaming step must still
take the unfused subsampler's row order. Cases and tolerances:

- `StreamingEncoderStep` chunk by chunk (driven through each side's
  session): the chunk logits and the new caches. f32: within 1e-5 of the
  largest element (f32 sums in another order). bf16: max |d| within 2^-5
  of the largest element and mean |d| within 2^-7 of it (both round to
  bf16 at the same points, but XLA:CPU drops some of JAX's bf16 roundings,
  ROADMAP C's "Not port faults", a rounding flipped in layer 1 reaches
  layer 2, and the logits themselves are bf16, so an element that differs
  differs by an ulp; observed over the three precisions: logits max 0.0154,
  mean 0.0037, caches max 0.0116, mean 0.0015 of the largest);
- session ids at precisions 32, 2 and 1, fed in pushes of 1, 7 and 40
  frames: at f32 equal to JAX's `streaming_greedy_decode`; at bf16 each
  frame's argmax equals JAX's except where JAX's top-2 gap is within the
  bf16 logit tolerance (a near-tie), and the ids are the same for every
  push size;
- the session against the port's own offline chunked encoder (the QAT
  model with the chunk mask, fused flags cleared) on valid frames, at the
  same tolerances (observed: equal bit for bit at bf16);
- recordings shorter than 7 frames: one encoder frame (the minimum-1
  clamp), ids equal to JAX's;
- `StreamingServer`: ids equal to sequential sessions at f32 and bf16 and
  to JAX's `streaming_greedy_decode_batch` at f32, with slot reuse and
  interleaved feeds; a slot's ids and caches do not depend on its
  neighbours (bit for bit) and an inactive slot's caches stay bit for bit;
- `BufferOverflow` and `validate_streaming_cfg`'s four messages, as JAX's;
- the `ServeLoop` protocol as JAX's tests/test_serve.py, `--artifact` on a
  directory that holds no artifact exits 2 (tests/test_torch_export.py
  serves a real one), and `python -m onebit_asr_tpu_torch.serve --port 0
  --device cpu` in a subprocess gives the in-process loop's finals;
- `evaluate --streaming` on a run the port trained (f32, `--fused_subsampler`)
  prints the lines JAX's decode of the same tree gives.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from onebit_asr_tpu.decode import streaming as jstream
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import evaluate as eval_cli
from onebit_asr_tpu_torch.cli import serve as serve_cli
from onebit_asr_tpu_torch.cli import train as train_cli
from onebit_asr_tpu_torch.data.dummy import DummyDataModule
from onebit_asr_tpu_torch.decode import compute_cer, compute_wer
from onebit_asr_tpu_torch.decode import streaming as pstream
from onebit_asr_tpu_torch.eval.evaluate import _ids_to_words
from onebit_asr_tpu_torch.model.asr import precision_to_binary_mask
from onebit_asr_tpu_torch.utils.checkpoint import load_config, restore_params
from onebit_asr_tpu_torch.utils.config import ModelConfig
from torch_cpu_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CS = 4
TINY = dict(vocab_size=32, enc_d_model=32, enc_layers=2, enc_heads=2, enc_d_ff=64,
            enc_conv_kernel=7, dec_layers=1, dec_heads=2, dec_d_ff=64, dropout=0.0,
            conv_norm="layer_norm", causal_conv=True, attn_chunk_size=CS, attn_left_chunks=1)
BF16_MAX, BF16_MEAN = 2.0 ** -5, 2.0 ** -7  # of the largest element


def _configs(dtype="float32"):
    jcfg = jc.ModelConfig(remat_blocks=False, compute_dtype=dtype, **TINY)
    cfg = dataclasses.replace(ModelConfig(), compute_dtype=dtype, fused_subsampler=True,
                              fused_attention=True, **TINY)
    return jcfg, cfg


@pytest.fixture(scope="module")
def params():
    return convert.init_params(_configs()[1], 3)


def _feats(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 80)).astype(np.float32)


def _captured(sess, to_np):
    """Wrap a session's step to record (chunk logits [cs, V], caches)."""
    record, step = [], sess._step

    def wrapped(*a):
        logits, caches = step(*a)
        record.append((to_np(logits)[0], to_np(caches)))
        return logits, caches

    sess._step = wrapped
    return record


def _jnp(x):
    return np.asarray(x, np.float32)


def _tnp(x):
    return x.float().numpy()


def _close(got, want, dtype):
    top = np.abs(want).max()
    d = np.abs(got - want)
    if dtype == "float32":
        assert d.max() <= 1e-5 * top, d.max()
    else:
        assert d.max() <= BF16_MAX * top and d.mean() <= BF16_MEAN * top, (d.max(), d.mean(),
                                                                           top)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", [32, 2, 1])
def test_step_session_and_offline_match_jax(params, dtype, precision):
    jcfg, cfg = _configs(dtype)
    feats = _feats(150)
    sj = jstream.StreamingSession(jcfg, params, precision)
    sp = pstream.StreamingSession(cfg, params, precision, device="cpu")
    rj, rp = _captured(sj, _jnp), _captured(sp, _tnp)
    ids_j = sj.accept(feats) + sj.finish()
    ids_p = sp.accept(feats) + sp.finish()
    assert len(rj) == len(rp) == 9  # 9 windows of 19 raw frames, hop 16; no tail frame
    for (lj, cj), (lp, cp) in zip(rj, rp):
        assert cp.shape == cj.shape == (2, 1, 12, 32)  # [L, B, 3 chunks x 4, D]
        _close(lp, lj, dtype)
        _close(cp, cj, dtype)
    got = np.concatenate([lp for lp, _ in rp])
    want = np.concatenate([lj for lj, _ in rj])
    # the port's own offline chunked encoder, fused flags cleared
    model = convert.qat_model_from_jax(
        dataclasses.replace(cfg, fused_subsampler=False, fused_attention=False), params,
        device="cpu", decoder=False).eval()
    with torch.no_grad():
        _, mask, logits = model(torch.from_numpy(feats)[None], torch.tensor([150]),
                                precision_to_binary_mask(precision, 2))
    n = int(mask.sum())
    assert n == got.shape[0] == 36
    _close(got, logits[0, :n].float().numpy(), dtype)

    push_ids = {k: pstream.streaming_greedy_decode(cfg, params, feats, precision, k, "cpu")
                for k in (1, 7, 40)}
    if dtype == "float32":
        assert ids_p == ids_j
        for k, ids in push_ids.items():
            assert ids == jstream.streaming_greedy_decode(jcfg, params, feats, precision, k), k
    else:
        top2 = np.sort(want, axis=-1)[:, -2:]
        near_tie = (top2[:, 1] - top2[:, 0]) <= BF16_MAX * np.abs(want).max()
        same = got.argmax(-1) == want.argmax(-1)
        assert (same | near_tie).all(), np.flatnonzero(~same)
        assert all(ids == ids_p for ids in push_ids.values())


@pytest.mark.parametrize("n_frames", [3, 6])
def test_short_recording_emits_one_frame(params, n_frames):
    jcfg, cfg = _configs()
    feats = _feats(n_frames, 1)
    sp = pstream.StreamingSession(cfg, params, 2, device="cpu")
    record = _captured(sp, _tnp)
    ids = sp.accept(feats) + sp.finish()
    assert len(record) == 1 and sp._j_done == 1
    assert ids == jstream.streaming_greedy_decode(jcfg, params, feats, 2)
    assert sp.finish() == [] and sp._finished
    with pytest.raises(RuntimeError, match="already finished"):
        sp.accept(feats)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_server_matches_sessions_and_jax_batch(params, dtype):
    jcfg, cfg = _configs(dtype)
    recs = [_feats(t, 3 + i) for i, t in enumerate((80, 57, 33, 9))]
    seq = [pstream.streaming_greedy_decode(cfg, params, r, 2, device="cpu") for r in recs]
    got = pstream.streaming_greedy_decode_batch(cfg, params, recs, 2, max_streams=3,
                                                device="cpu")  # 4 recordings: a slot reused
    assert got == seq
    if dtype == "float32":
        assert got == jstream.streaming_greedy_decode_batch(jcfg, params, recs, 2, max_streams=3)


def test_server_interleaved_feeds_and_slot_reuse(params):
    """As JAX's test: partial feeds across two open slots, then a freed slot
    reopened for a third recording, against sequential sessions."""
    _, cfg = _configs("bfloat16")
    a, b, c = _feats(41, 7), _feats(64, 8), _feats(29, 9)
    seq = [pstream.streaming_greedy_decode(cfg, params, r, 2, device="cpu") for r in (a, b, c)]
    server = pstream.StreamingServer(cfg, params, precision=2, max_streams=2, device="cpu")
    sa, sb = server.open(), server.open()
    out = {sa: [], sb: [], "c": []}
    server.feed(sa, a[:20])
    server.feed(sb, b[:30])
    for k, v in server.step().items():
        out[k].extend(v)
    server.feed(sa, a[20:])
    server.close(sa)
    server.feed(sb, b[30:])
    while server._open[sa]:
        for k, v in server.step().items():
            out[k].extend(v)
    sc = server.open()
    assert sc == sa and torch.count_nonzero(server._caches[:, sc]) == 0
    server.feed(sc, c)
    server.close(sc)
    server.close(sb)
    while server._open[sc] or server._open[sb]:
        for k, v in server.step().items():
            out["c" if k == sc else k].extend(v)
    assert [out[sa], out[sb], out["c"]] == seq


def test_slot_does_not_depend_on_its_neighbours(params):
    """Two servers, the same recording in slot 0 and other recordings (other
    lengths) in slots 1-2: slot 0's ids and caches equal bit for bit after
    every step; a slot with no full window keeps its caches bit for bit."""
    _, cfg = _configs("bfloat16")
    mine = _feats(90, 11)
    servers = [pstream.StreamingServer(cfg, params, 2, max_streams=3, device="cpu")
               for _ in range(2)]
    for k, server in enumerate(servers):
        for j, n in enumerate((90, 45 + 30 * k, 70 - 40 * k)):
            sid = server.open()
            assert sid == j
            server.feed(sid, mine if j == 0 else _feats(n, 20 + 2 * j + k))
    ids = [[], []]
    while servers[0]._open[0]:
        if not servers[0].pending():
            for server in servers:
                server.close(0)
        before = [s._caches.clone() for s in servers]
        steps = [s.step() for s in servers]
        for k, (server, st) in enumerate(zip(servers, steps)):
            ids[k].extend(st.get(0, []))
            for sid in range(3):
                if sid not in st:  # inactive this step
                    assert torch.equal(server._caches[:, sid], before[k][:, sid])
        assert torch.equal(servers[0]._caches[:, 0], servers[1]._caches[:, 0])
    assert ids[0] == ids[1] == pstream.streaming_greedy_decode(cfg, params, mine, 2,
                                                               device="cpu")


def test_feed_buffer_overflow(params):
    _, cfg = _configs()
    server = pstream.StreamingServer(cfg, params, 2, max_streams=1, max_buffer_frames=100,
                                     device="cpu")
    assert server.max_buffer_frames == 100
    assert pstream.StreamingServer(cfg, params, 2, 1, device="cpu").max_buffer_frames == 64 * 19
    sid = server.open()
    server.feed(sid, _feats(50))
    with pytest.raises(pstream.BufferOverflow, match="backpressure"):
        server.feed(sid, _feats(100))
    server.feed(sid, _feats(50))  # the slot stays usable within its bound
    with pytest.raises(RuntimeError, match="all 1 stream slots busy"):
        server.open()
    with pytest.raises(ValueError, match="not open"):
        server.feed(3, _feats(2))


@pytest.mark.parametrize("change", [dict(attn_chunk_size=None), dict(attn_left_chunks=-1),
                                    dict(causal_conv=False), dict(conv_norm="batch_norm")])
def test_validate_streaming_cfg_refuses_as_jax(params, change):
    jcfg, cfg = _configs()
    with pytest.raises(ValueError) as want:
        jstream.validate_streaming_cfg(dataclasses.replace(jcfg, **change))
    with pytest.raises(ValueError) as got:
        pstream.StreamingSession(dataclasses.replace(cfg, **change), params, device="cpu")
    assert str(got.value) == str(want.value)


# -- the serve daemon -------------------------------------------------------------------


def _drive(loop, utts):
    """Each utterance through the protocol -> {tag: final ids}."""
    sids, events = {}, []
    for tag, f in utts.items():
        (opened,) = loop.handle_line(json.dumps({"op": "open"}))
        assert opened["event"] == "opened"
        sids[opened["sid"]] = tag
        events += loop.handle_line(json.dumps({"op": "feed", "sid": opened["sid"],
                                               "feats": f.tolist()}))
        events += loop.handle_line(json.dumps({"op": "close", "sid": opened["sid"]}))
    events += loop.pump()
    return {sids[e["sid"]]: e["ids"] for e in events if e["event"] == "final"}


def test_protocol_roundtrip_matches_sessions(params):
    _, cfg = _configs("bfloat16")
    utts = {"a": _feats(60, 30), "b": _feats(44, 31)}
    server = pstream.StreamingServer(cfg, params, 2, max_streams=2, device="cpu")
    finals = _drive(serve_cli.ServeLoop(server), utts)
    for tag, f in utts.items():
        sess = pstream.StreamingSession(cfg, params, 2, device="cpu")
        assert finals[tag] == sess.accept(f) + sess.finish(), tag


def test_protocol_slot_reuse_text_and_errors(params):
    _, cfg = _configs("bfloat16")
    server = pstream.StreamingServer(cfg, params, 2, max_streams=1, device="cpu")
    loop = serve_cli.ServeLoop(server, ids_to_text=lambda ids: f"<{len(ids)} ids>")
    for i in range(2):  # the slot frees and reopens
        assert "x" in _drive(loop, {"x": _feats(40, 40 + i)})
    (opened,) = loop.handle_line(json.dumps({"op": "open"}))
    loop.handle_line(json.dumps({"op": "feed", "sid": opened["sid"],
                                 "feats": _feats(40, 42).tolist()}))
    loop.handle_line(json.dumps({"op": "close", "sid": opened["sid"]}))
    events = loop.pump()
    assert events and all("text" in e for e in events)
    assert loop.handle_line(json.dumps({"op": "ping"})) == [{"event": "pong"}]
    for bad in ("not json", json.dumps({"op": "feed", "sid": 7, "feats": [[0.0]]}),
                json.dumps({"op": "nope"}),
                json.dumps({"op": "feed_wav", "sid": 0, "path": "a.wav"})):
        (err,) = loop.handle_line(bad)
        assert err["event"] == "error"
    (opened,) = loop.handle_line(json.dumps({"op": "open"}))  # still serving
    assert opened["event"] == "opened"


def test_protocol_feed_flood_backpressure(params):
    _, cfg = _configs("bfloat16")
    server = pstream.StreamingServer(cfg, params, 2, max_streams=2, max_buffer_frames=200,
                                     device="cpu")
    loop = serve_cli.ServeLoop(server)
    (o1,) = loop.handle_line(json.dumps({"op": "open"}))
    (o2,) = loop.handle_line(json.dumps({"op": "open"}))
    small = _feats(50, 50)
    assert loop.handle_line(json.dumps({"op": "feed", "sid": o1["sid"],
                                        "feats": small.tolist()})) == []
    (err,) = loop.handle_line(json.dumps({"op": "feed", "sid": o1["sid"],
                                          "feats": _feats(400, 51).tolist()}))
    assert err["event"] == "error" and "backpressure" in err["error"]
    for o in (o2, o1):  # the other stream, then the flooded one, end to end
        if o is o2:
            loop.handle_line(json.dumps({"op": "feed", "sid": o["sid"],
                                         "feats": small.tolist()}))
        loop.handle_line(json.dumps({"op": "close", "sid": o["sid"]}))
        assert any(e["event"] == "final" and e["sid"] == o["sid"] for e in loop.pump())


@pytest.mark.parametrize("argv,message", [
    (["--artifact", "srv"], "no streaming artifact at srv"),
    ([], "need exactly one of --checkpoint / --artifact"),
    (["--artifact", "srv", "--checkpoint", "run"], "need exactly one of"),
])
def test_serve_cli_refusals_exit_2(argv, message, capsys):
    assert serve_cli.main([*argv, "--device", "cpu"]) == 2
    assert message in capsys.readouterr().err


@pytest.fixture(scope="module")
def stream_run(tmp_path_factory):
    """A 1-step streaming run of the port's train CLI (f32, tiny, both fused
    flags) -> (run dir, config, JAX-layout tree)."""
    root = tmp_path_factory.mktemp("stream_runs")
    flags = ["--enc_layers", "2", "--enc_d_model", "32", "--enc_heads", "2", "--enc_d_ff", "64",
             "--enc_conv_kernel", "7", "--dec_layers", "1", "--dec_d_ff", "64",
             "--compute_dtype", "float32", "--conv_norm", "layer_norm", "--causal_conv",
             "--attn_chunk_size", str(CS), "--attn_left_chunks", "1", "--fused_subsampler",
             "--fused_attention"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert train_cli.main(["--device", "cpu", "--dummy_data", "--epochs", "1",
                               "--steps_per_epoch", "1", "--batch_size", "2",
                               "--eval_batches", "1", "--dummy_frames", "64",
                               "--warmup_steps", "1", "--save_dir", str(root), "--run_name",
                               "s", *flags]) == 0
    run = str(root / "s")
    cfg = load_config(run)
    _, sd = restore_params(os.path.join(run, "ckpt"))
    tree = convert.unflatten({k: v.numpy() for k, v in convert.flatten(
        convert.jax_tree_from_state_dict(sd, cfg.model)).items()})
    return run, cfg, tree


def _write_wav(path, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    w = 0.1 * np.sin(2 * np.pi * 440 * t) + 0.01 * rng.standard_normal(t.shape)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.clip(w, -1, 1) * 32767).astype(np.int16).tobytes())


def test_serve_daemon_over_stdio_matches_the_in_process_loop(stream_run, tmp_path):
    run, cfg, _ = stream_run
    wav = str(tmp_path / "a.wav")
    _write_wav(wav, 0.9, 0)
    lines = [{"op": "open"}, {"op": "open"}, {"op": "feed_wav", "sid": 0, "path": wav},
             {"op": "feed", "sid": 1, "feats": _feats(70, 60).tolist()},
             {"op": "ping"}, {"op": "close", "sid": 0}, {"op": "close", "sid": 1}]
    text = "".join(json.dumps(x) + "\n" for x in lines)
    argv = ["--checkpoint", run, "--port", "0", "--device", "cpu", "--max_streams", "2"]
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "onebit_asr_tpu_torch.serve", *argv],
                          input=text, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = [json.loads(line) for line in proc.stdout.splitlines()]

    loop, why = serve_cli.build_loop(serve_cli.build_argparser().parse_args(argv))
    assert why == ""
    want = []
    for x in lines:
        want += loop.handle_line(json.dumps(x)) + loop.pump()
    assert got == want
    finals = {e["sid"]: e["ids"] for e in got if e["event"] == "final"}
    assert sorted(finals) == [0, 1] and {"event": "pong"} in got
    # the finals are the server's: sid 1's equal a session on the same frames
    assert finals[1] == pstream.streaming_greedy_decode(cfg.model, stream_run[2], _feats(70, 60),
                                                        2, device="cpu")


def test_evaluate_streaming_matches_jax_decode(stream_run, capsys):
    run, cfg, tree = stream_run
    assert eval_cli.main(["--checkpoint", run, "--dummy_data", "--streaming", "--max_batches",
                          "1", "--batch_size", "3", "--precisions", "32,1",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    jcfg = jc.ModelConfig(remat_blocks=False, compute_dtype="float32", **TINY)
    batch = next(iter(DummyDataModule(batch_size=3).valid_batches()))
    refs, hyps = [], []
    for i in range(3):
        T, U = int(batch["feat_lens"][i]), int(batch["token_lens"][i])
        ids = jstream.streaming_greedy_decode(jcfg, tree, np.asarray(batch["feats"][i, :T]), 1)
        hyps.append(_ids_to_words(ids, None, 4))
        refs.append(_ids_to_words(batch["tokens"][i, :U].tolist(), None, 4))
    d, w = compute_wer(refs, hyps)
    dc, c = compute_cer(refs, hyps)
    assert out[-2:] == ["== dummy (3 utts, streaming) ==",
                        f"  1bit: WER {d / max(w, 1) * 100:.2f}%  CER {dc / max(c, 1) * 100:.2f}%"]
    assert "streaming greedy decode (precision 1)" in out

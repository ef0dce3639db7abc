"""Streaming ASR serving daemon: NDJSON over stdio or TCP.

Counterpart of onebit_asr_tpu/cli/serve.py, on `decode.streaming.
StreamingServer` (N concurrent streams through one batched chunk step). One
process owns the device; clients multiplex over a line protocol:

    -> {"op": "open"}                                 <- {"event":"opened","sid":0}
    -> {"op": "feed", "sid": 0, "feats": [[...80],..]} (feature frames)
    -> {"op": "feed_wav", "sid": 0, "path": "a.wav"}   (whole-file helper)
    -> {"op": "close", "sid": 0}
    -> {"op": "ping"}                                 <- {"event": "pong"}
    <- {"event": "partial", "sid": 0, "ids": [...], "text": "..."}   (per step)
    <- {"event": "final",   "sid": 0, "ids": [...], "text": "..."}   (slot freed)

Every response is one JSON line; a bad request gets an "error" event and
the daemon stays up. `text` appears when a tokenizer is found in the data
dir (`--data_dir`, default: the checkpoint's), ids otherwise. `feed_wav`
featurizes a 16-bit PCM wav on the device (log-mel, then the data dir's
cmvn_stats.npz when there is one). The checkpoint is a run this package
trained (`--checkpoint`: config.json + ckpt/), streaming-trained
(`--attn_chunk_size`, `--attn_left_chunks` >= 0, `--causal_conv`,
`--conv_norm layer_norm`), served unpacked at `--precision`. `--artifact`
serves a batched streaming artifact instead (`python -m
onebit_asr_tpu_torch.cli.export streaming --n_streams N`): its step, its N
slots and its precision come from the artifact (as in JAX, `--precision`
and `--max_streams` beside it are accepted and the artifact's values
taken, with a note on stderr when they differ), `--device` picks one of
its members (default: cuda if it has one; a device it has no member for is
refused), and `feed_wav` takes the default frontend (with `--data_dir`,
that dir's tokenizer and cmvn_stats.npz).

Run:  python -m onebit_asr_tpu_torch.serve --checkpoint runs/stream --port 7600
      python -m onebit_asr_tpu_torch.serve --artifact stream8.export --port 7600
      (--port 0 speaks the protocol on stdin/stdout; --device cpu off the card)
"""

from __future__ import annotations

import json
import os
import sys


def build_argparser():
    import argparse

    p = argparse.ArgumentParser(
        "python -m onebit_asr_tpu_torch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default="",
                   help="run dir (config.json + ckpt/), streaming-trained")
    p.add_argument("--artifact", default="",
                   help="an exported batched streaming artifact (cli.export streaming "
                        "--n_streams N); its values override --max_streams/--precision")
    p.add_argument("--precision", type=int, default=None, choices=(32, 2, 1),
                   help="with --checkpoint (default 2); an artifact's own overrides it")
    p.add_argument("--max_streams", type=int, default=None,
                   help="concurrent stream slots (one batched step serves all ready slots); "
                        "with --checkpoint (default 8), an artifact's own overrides it")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port to listen on (localhost); 0 = stdio")
    p.add_argument("--data_dir", default="",
                   help="tokenizer and cmvn_stats.npz location (default: the checkpoint's "
                        "data_dir)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; with --artifact, one of its members")
    return p


class ServeLoop:
    """Protocol core, transport-free (tested without sockets).

    `handle_line(line) -> [response dicts]` processes one request;
    `pump() -> [response dicts]` advances the device while any slot has a
    full window buffered (or is closing). The caller interleaves them as
    its transport delivers lines. `featurize(path) -> [T, F] features` is
    what `feed_wav` calls (None: `feed_wav` is an error event)."""

    def __init__(self, server, ids_to_text=None, featurize=None):
        self.server = server
        self.ids_to_text = ids_to_text
        self.featurize = featurize
        self._tokens = {}  # sid -> accumulated ids

    def _emit(self, event, sid, new_ids):
        self._tokens.setdefault(sid, []).extend(new_ids)
        out = {"event": event, "sid": sid, "ids": list(self._tokens[sid])}
        if self.ids_to_text is not None:
            out["text"] = self.ids_to_text(self._tokens[sid])
        if event == "final":
            self._tokens.pop(sid, None)
        return out

    def handle_line(self, line):
        try:
            req = json.loads(line)
            op = req["op"]
        except Exception as e:
            return [{"event": "error", "error": f"bad request: {e}"}]
        try:
            if op == "open":
                return [{"event": "opened", "sid": self.server.open()}]
            if op == "feed":
                import numpy as np

                self.server.feed(req["sid"], np.asarray(req["feats"], np.float32))
                return []
            if op == "feed_wav":
                if self.featurize is None:
                    raise RuntimeError("feed_wav needs a featurizer")
                self.server.feed(req["sid"], self.featurize(req["path"]))
                return []
            if op == "close":
                self.server.close(req["sid"])
                return []
            if op == "ping":
                return [{"event": "pong"}]
            return [{"event": "error", "error": f"unknown op {op!r}"}]
        except Exception as e:  # per-request isolation: the daemon stays up
            return [{"event": "error", "error": str(e), "op": op}]

    def pump(self):
        """Advance the device while any slot is ready; emit partials, and
        finals for slots that freed."""
        out = []
        while self.server.pending():
            open_before = list(self.server._open)
            for sid, ids in self.server.step().items():
                freed = open_before[sid] and not self.server._open[sid]
                out.append(self._emit("final" if freed else "partial", sid, ids))
        return out


def wav_featurizer(frontend_cfg, cmvn, device):
    """path -> [T, F] f32 features on the host: the port's `_read_wav`, the
    log-mel frontend on `device`, then CMVN when `cmvn` is (mean, std)."""
    import numpy as np
    import torch

    from onebit_asr_tpu_torch.cli.transcribe import _read_wav
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, apply_cmvn

    frontend = LogMelFrontend(frontend_cfg)
    stats = None if cmvn is None else tuple(
        torch.as_tensor(np.asarray(a, np.float32), device=device) for a in cmvn)

    @torch.no_grad()
    def featurize(path):
        wav = torch.from_numpy(np.ascontiguousarray(_read_wav(path), np.float32)).to(device)
        feats, lens = frontend(wav[None], torch.tensor([wav.shape[0]], device=device))
        f = feats[0, : int(lens[0])]
        if stats is not None:
            f = apply_cmvn(f, *stats)
        return f.cpu().numpy()

    return featurize


def build_loop(args):
    """(the ServeLoop of parsed `args`, ""), or (None, why they cannot be
    served)."""
    import numpy as np

    from onebit_asr_tpu_torch.utils.checkpoint import load_config, restore_params
    from onebit_asr_tpu_torch.utils.config import FrontendConfig, TrainConfig

    if bool(args.artifact) == bool(args.checkpoint):
        return None, "need exactly one of --checkpoint / --artifact"
    if args.artifact:
        from onebit_asr_tpu_torch.export import streaming_server_from_artifact

        from onebit_asr_tpu_torch.export import artifact_members

        if not os.path.isfile(os.path.join(args.artifact, "meta.json")):
            return None, f"no streaming artifact at {args.artifact} (module.pt2 + meta.json)"
        with open(os.path.join(args.artifact, "meta.json")) as f:
            meta = json.load(f)
        members = artifact_members(meta)
        if args.device is not None and args.device not in members:
            return None, ("--device: the artifact fixes its devices (set them when exporting "
                          f"it); it holds {', '.join(members)}")
        try:
            server = streaming_server_from_artifact(args.artifact, args.device)
        except (ValueError, RuntimeError) as e:
            return None, str(e)
        fixed = {"precision": meta["precision"], "max_streams": server.n}
        for k, v in fixed.items():
            if getattr(args, k) not in (None, v):
                print(f"note: --{k} {getattr(args, k)} is the artifact's {v} (fixed when it "
                      "was exported)", file=sys.stderr)
        # frontend defaults for the feed_wav helper; no checkpoint config
        cfg = TrainConfig(model=server.cfg, frontend=FrontendConfig())
        device = str(server.device)
        print(f"serving artifact {args.artifact} ({server.n} stream slots)", file=sys.stderr)
    else:
        from onebit_asr_tpu_torch.convert import jax_tree_from_state_dict
        from onebit_asr_tpu_torch.decode.streaming import StreamingServer

        cfg = load_config(args.checkpoint)
        if cfg is None:
            return None, f"no config.json in {args.checkpoint}"
        step, sd = restore_params(os.path.join(args.checkpoint, "ckpt"))
        print(f"restored step {step}", file=sys.stderr)
        device = args.device or "cuda"
        server = StreamingServer(cfg.model, jax_tree_from_state_dict(sd, cfg.model),
                                 precision=args.precision or 2,
                                 max_streams=args.max_streams or 8, device=device)
    ids_to_text = None
    data_dir = args.data_dir or cfg.data.data_dir
    if data_dir and os.path.isdir(data_dir):
        try:
            from onebit_asr_tpu_torch.data.text import AsrTokenizer

            ids_to_text = AsrTokenizer.find_and_load(data_dir, cfg.model.specials).ids_to_text
        except Exception as e:
            print(f"no tokenizer ({e}); emitting ids only", file=sys.stderr)
    cmvn = None
    cmvn_path = os.path.join(data_dir, "cmvn_stats.npz") if data_dir else ""
    if cmvn_path and os.path.exists(cmvn_path):
        with np.load(cmvn_path) as stats:
            cmvn = (stats["mean"], stats["std"])
    return ServeLoop(server, ids_to_text, wav_featurizer(cfg.frontend, cmvn, device)), ""


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    loop, why = build_loop(args)
    if loop is None:
        print(why, file=sys.stderr)
        return 2

    def session(rfile, wfile):
        def send(objs):
            for o in objs:
                wfile.write(json.dumps(o) + "\n")
            wfile.flush()

        for line in rfile:
            line = line.strip()
            if not line:
                continue
            send(loop.handle_line(line))
            send(loop.pump())

    if args.port:
        import io
        import socketserver

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                session(io.TextIOWrapper(self.rfile, "utf-8"),
                        io.TextIOWrapper(self.wfile, "utf-8"))

        with socketserver.ThreadingTCPServer(("127.0.0.1", args.port), Handler) as srv:
            print(f"serving on 127.0.0.1:{args.port} ({loop.server.n} stream slots)",
                  file=sys.stderr)
            srv.serve_forever()
    else:
        session(sys.stdin, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())

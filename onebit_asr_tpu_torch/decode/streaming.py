"""Incremental streaming ASR over a chunked-causal checkpoint.

Counterpart of onebit_asr_tpu/decode/streaming.py: host-side drivers around
`model.streaming.StreamingEncoderStep`. `StreamingSession` is one stream:
feed feature frames as they arrive (`accept`), get CTC tokens back as
chunks complete, and `finish()` drains the tail. `StreamingServer`
multiplexes up to `max_streams` streams through one batched step over all
its slots. The per-layer caches bound memory to L x cache_chunks x cs x D
frames per stream, however long the stream runs.

The transcript equals the offline chunked-causal encoder's greedy CTC
decode of the whole recording: streaming is a latency choice, not an
accuracy one.

`params` is the training-form parameter tree in the JAX layout (nested
dicts of numpy arrays or CPU tensors), as `Transcriber` takes it; the step
is built from it once per session or server (`convert.streaming_step_from_jax`),
or handed in built (`modules`) to share it across sessions. In place of
both, a session takes `step_fn` and a server `batch_step_fn`: a loaded
streaming artifact (export.py), so that no weights or modules are on the
serving host. The step runs on CUDA unless `device="cpu"`; the buffers and
the CTC collapse stay on the host, as in JAX.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from onebit_asr_tpu_torch.model.asr import precision_to_binary_mask
from onebit_asr_tpu_torch.model.streaming import raw_window_size, streaming_cache_chunks
from onebit_asr_tpu_torch.utils.config import ModelConfig


def _subsampled_len_int(n: int) -> int:
    return max(((n - 1) // 2 - 1) // 2, 0)


def validate_streaming_cfg(cfg: ModelConfig) -> None:
    """The checkpoint properties the incremental runtime requires."""
    if cfg.attn_chunk_size is None:
        raise ValueError("streaming needs cfg.attn_chunk_size")
    if cfg.attn_left_chunks < 0:
        raise ValueError("streaming needs finite cfg.attn_left_chunks")
    if not cfg.causal_conv:
        raise ValueError("streaming needs cfg.causal_conv=True")
    if cfg.conv_norm != "layer_norm":
        raise ValueError(
            "streaming needs per-frame conv_norm='layer_norm' "
            f"(got {cfg.conv_norm!r}: sequence-global statistics)"
        )


def streaming_modules(cfg: ModelConfig, params, device: str = "cuda"):
    """(StreamingEncoderStep, CTC head) of `params` on `device`: what a
    session or server runs, shareable between them."""
    from onebit_asr_tpu_torch.convert import streaming_step_from_jax

    validate_streaming_cfg(cfg)
    return streaming_step_from_jax(cfg, params, device)


class _Runtime:
    """What a session and a server share: the config's geometry, the step
    and its head on the device (or an artifact's `step_fn` with that
    signature), the precision's layer mask, and `_step(windows, caches,
    cache_valid, cur_valid) -> (f32 logits, new caches)`."""

    def __init__(self, cfg: ModelConfig, params, precision: int, device: str, modules,
                 step_fn=None):
        validate_streaming_cfg(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.cs = int(cfg.attn_chunk_size)
        self.window_raw = raw_window_size(self.cs)
        self.hop_raw = 4 * self.cs
        self.cache_chunks = streaming_cache_chunks(cfg.enc_conv_kernel, self.cs,
                                                   cfg.attn_left_chunks)
        self.blank_id = cfg.specials.blank_id
        self._cache_dtype = getattr(torch, cfg.compute_dtype)
        self._step_fn = step_fn
        if step_fn is not None:
            return
        if modules is None:
            if params is None:
                raise ValueError("need params, modules or a step function")
            modules = streaming_modules(cfg, params, device)
        self._encoder, self._head = modules
        self._bm = precision_to_binary_mask(precision, cfg.enc_layers)

    def _zero_caches(self, n: int) -> torch.Tensor:
        cfg = self.cfg
        return torch.zeros((cfg.enc_layers, n, self.cache_chunks * self.cs, cfg.enc_d_model),
                           dtype=self._cache_dtype, device=self.device)

    @torch.no_grad()  # not inference_mode: open() zeroes a slot's caches in place
    def _step(self, windows, caches, cache_valid, cur_valid):
        if self._step_fn is not None:
            return self._step_fn(windows, caches, cache_valid, cur_valid)
        enc, new_caches = self._encoder(windows, caches, cache_valid, cur_valid, self._bm)
        return self._head(enc).to(torch.float32), new_caches

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)


class StreamingSession(_Runtime):
    """Single-stream (B=1) incremental recognizer.

    cfg: a ModelConfig with `attn_chunk_size` set, `attn_left_chunks >= 0`,
    `causal_conv=True`, `conv_norm="layer_norm"` (the streaming-trained
    configuration). params: the trained model's JAX-layout tree (its
    decoder is ignored), or None when `modules` (from `streaming_modules`)
    is given. precision: 1 | 2 | 32. `step_fn` (a loaded single-stream
    artifact, `(window [1, W, F], caches, cache_valid [1], cur_valid [1]) ->
    (f32 logits, new caches)`) takes the place of params and modules."""

    def __init__(self, cfg: ModelConfig, params=None, precision: int = 2,
                 device: str = "cuda", modules=None, step_fn=None):
        super().__init__(cfg, params, precision, device, modules, step_fn)
        self._caches = self._zero_caches(1)
        self._cache_valid = 0
        self._buf = np.zeros((0, cfg.input_dim), np.float32)
        self._cursor = 0  # raw index of the next window start (= 4 * j_done)
        self._j_done = 0  # subsampled frames already emitted
        self._prev_label = self.blank_id
        self._finished = False

    # ------------------------------------------------------------------ api

    def accept(self, feats: np.ndarray) -> List[int]:
        """Feed [T, F] new feature frames; returns newly decoded token ids."""
        if self._finished:
            raise RuntimeError("session already finished")
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.cfg.input_dim:
            raise ValueError(f"expected [T, {self.cfg.input_dim}], got {feats.shape}")
        self._buf = np.concatenate([self._buf, feats], axis=0)
        out: List[int] = []
        while len(self._buf) - self._cursor >= self.window_raw:
            window = self._buf[self._cursor : self._cursor + self.window_raw]
            out.extend(self._run_chunk(window, self.cs))
            self._cursor += self.hop_raw
        # drop consumed frames, keeping the inter-window overlap
        if self._cursor > 0:
            self._buf = self._buf[self._cursor :]
            self._cursor = 0
        return out

    def finish(self) -> List[int]:
        """Flush the partial tail chunk; the session becomes unusable."""
        if self._finished:
            return []
        self._finished = True
        tail = self._buf[self._cursor :]
        # the offline encoder's minimum-1 clamp (model/conformer.py
        # subsampled_length): a recording shorter than ~7 raw frames still
        # gives 1 encoder frame offline, so the session emits it too
        total_sub = max(self._j_done + _subsampled_len_int(len(tail)), 1)
        n_rem = total_sub - self._j_done
        if n_rem <= 0:
            return []
        window = np.zeros((self.window_raw, self.cfg.input_dim), np.float32)
        window[: len(tail)] = tail
        return self._run_chunk(window, n_rem)

    # ------------------------------------------------------------- internals

    def _run_chunk(self, window: np.ndarray, n_valid: int) -> List[int]:
        logits, self._caches = self._step(
            self._to_device(np.ascontiguousarray(window)[None]), self._caches,
            torch.tensor([self._cache_valid], device=self.device),
            torch.tensor([n_valid], device=self.device))
        self._cache_valid = min(self._cache_valid + self.cs, self.cache_chunks * self.cs)
        self._j_done += n_valid
        labels = logits[0, :n_valid].argmax(dim=-1).cpu().tolist()
        out: List[int] = []
        for lab in labels:
            if lab != self.blank_id and lab != self._prev_label:
                out.append(int(lab))
            self._prev_label = lab
        return out


class BufferOverflow(RuntimeError):
    """A slot's undecoded feed buffer hit its backpressure bound."""


class StreamingServer(_Runtime):
    """Multiplexed streaming recognizer: N concurrent streams share one
    batched chunk step over all `max_streams` slots.

    Slots are opened with `open()`, fed with `feed(sid, frames)`, closed
    with `close(sid)`; `step()` advances every slot that has a full window
    buffered (and flushes closing slots) in one step, returning
    {sid: new token ids}. Each slot's tokens equal a dedicated
    `StreamingSession`'s: inactive slots keep their caches bit for bit, and
    each active slot computes exactly the window and valid counts the
    session would.

    `max_buffer_frames`: per-slot backpressure bound; `feed` raises
    `BufferOverflow` once a slot would hold more undecoded frames (<= 0
    selects the default, 64 windows' worth). The slot stays usable.

    `batch_step_fn` (a loaded batched artifact of `max_streams` slots,
    `(windows, caches, cache_valid, cur_valid, active [N] bool) -> (f32
    logits, new caches)`, inactive slots' caches passed through) takes the
    place of params and modules."""

    def __init__(self, cfg: ModelConfig, params=None, precision: int = 2,
                 max_streams: int = 8, max_buffer_frames: int = 0, device: str = "cuda",
                 modules=None, batch_step_fn=None):
        super().__init__(cfg, params, precision, device, modules, batch_step_fn)
        self.n = int(max_streams)
        self.max_buffer_frames = (int(max_buffer_frames) if max_buffer_frames > 0
                                  else 64 * self.window_raw)
        self._caches = self._zero_caches(self.n)
        self._cache_valid = np.zeros((self.n,), np.int64)
        # host-side per-slot state
        self._open = [False] * self.n
        self._closing = [False] * self.n
        self._buf = [None] * self.n
        self._j_done = [0] * self.n
        self._prev_label = [self.blank_id] * self.n

    # ------------------------------------------------------------------ api

    def open(self) -> int:
        """Claim a free slot; returns the stream id."""
        for sid in range(self.n):
            if not self._open[sid]:
                self._open[sid] = True
                self._closing[sid] = False
                self._buf[sid] = np.zeros((0, self.cfg.input_dim), np.float32)
                self._j_done[sid] = 0
                self._prev_label[sid] = self.blank_id
                self._cache_valid[sid] = 0
                self._caches[:, sid] = 0  # zero the slot's cache column
                return sid
        raise RuntimeError(f"all {self.n} stream slots busy")

    def feed(self, sid: int, feats: np.ndarray) -> None:
        """Buffer [T, F] new frames for stream `sid` (on the host; the
        device advances on `step()`)."""
        self._check(sid)
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.cfg.input_dim:
            raise ValueError(f"expected [T, {self.cfg.input_dim}], got {feats.shape}")
        if len(self._buf[sid]) + len(feats) > self.max_buffer_frames:
            raise BufferOverflow(
                f"stream {sid}: {len(self._buf[sid])} + {len(feats)} frames "
                f"exceeds the {self.max_buffer_frames}-frame buffer bound — "
                f"caller must pace feeds against decode progress "
                f"(backpressure)"
            )
        self._buf[sid] = np.concatenate([self._buf[sid], feats], axis=0)

    def close(self, sid: int) -> None:
        """Mark end-of-stream; remaining frames flush on later `step()`s and
        the slot frees itself once drained."""
        self._check(sid)
        self._closing[sid] = True

    def pending(self) -> bool:
        """True if any slot can make progress on the next step()."""
        return any(
            self._open[s] and (len(self._buf[s]) >= self.window_raw or self._closing[s])
            for s in range(self.n)
        )

    def step(self):
        """One batched chunk step over every ready slot. Returns
        {sid: [new token ids]} (closing slots emit their final tokens and
        free their slot)."""
        windows = np.zeros((self.n, self.window_raw, self.cfg.input_dim), np.float32)
        cur_valid = np.zeros((self.n,), np.int64)
        active = np.zeros((self.n,), bool)
        freed = []
        for sid in range(self.n):
            if not self._open[sid]:
                continue
            buf = self._buf[sid]
            if len(buf) >= self.window_raw:
                windows[sid] = buf[: self.window_raw]
                cur_valid[sid] = self.cs
                active[sid] = True
            elif self._closing[sid]:
                total_sub = max(self._j_done[sid] + _subsampled_len_int(len(buf)), 1)
                n_rem = total_sub - self._j_done[sid]
                if n_rem > 0:
                    windows[sid, : len(buf)] = buf
                    cur_valid[sid] = n_rem
                    active[sid] = True
                freed.append(sid)
        if not active.any():
            out = {}
            for sid in freed:
                self._open[sid] = False
                out[sid] = []
            return out

        args = (self._to_device(windows), self._caches, self._to_device(self._cache_valid),
                self._to_device(cur_valid))
        if self._step_fn is not None:  # the artifact keeps inactive caches itself
            with torch.no_grad():
                logits, self._caches = self._step_fn(*args, self._to_device(active))
        else:
            logits, new_caches = self._step(*args)
            keep = self._to_device(active)[None, :, None, None]
            self._caches = torch.where(keep, new_caches, self._caches)
        labels_all = logits.argmax(dim=-1).cpu().numpy()  # [N, cs]
        out = {}
        for sid in range(self.n):
            if not active[sid]:
                if sid in freed:
                    self._open[sid] = False
                    out[sid] = []
                continue
            nv = int(cur_valid[sid])
            self._cache_valid[sid] = min(self._cache_valid[sid] + self.cs,
                                         self.cache_chunks * self.cs)
            self._j_done[sid] += nv
            toks = []
            prev = self._prev_label[sid]
            for lab in labels_all[sid, :nv].tolist():
                if lab != self.blank_id and lab != prev:
                    toks.append(int(lab))
                prev = lab
            self._prev_label[sid] = prev
            if sid in freed:
                self._open[sid] = False
            else:
                self._buf[sid] = self._buf[sid][self.hop_raw:]
            out[sid] = toks
        return out

    # ------------------------------------------------------------- internals

    def _check(self, sid: int) -> None:
        if not (0 <= sid < self.n and self._open[sid]):
            raise ValueError(f"stream {sid} is not open")
        if self._closing[sid]:
            raise RuntimeError(f"stream {sid} already closing")


def streaming_greedy_decode_batch(cfg: ModelConfig, params, feats_list, precision: int = 2,
                                  max_streams: int = 8, device: str = "cuda", modules=None):
    """Decode N recordings ([T_i, F] each) concurrently through one
    StreamingServer; returns a list of token-id lists in input order."""
    results = [[] for _ in feats_list]
    server = StreamingServer(cfg, params, precision, max_streams, device=device,
                             modules=modules)
    i = 0
    live = {}  # sid -> recording index
    while i < len(feats_list) or live:
        while i < len(feats_list) and len(live) < server.n:
            sid = server.open()
            server.feed(sid, np.asarray(feats_list[i], np.float32))
            server.close(sid)
            live[sid] = i
            i += 1
        for sid, toks in server.step().items():
            results[live[sid]].extend(toks)
            if not server._open[sid]:
                del live[sid]
    return results


def streaming_greedy_decode(cfg: ModelConfig, params, feats: np.ndarray, precision: int = 2,
                            feed_frames: Optional[int] = None, device: str = "cuda",
                            modules=None) -> List[int]:
    """One recording ([T, F] post-CMVN features) through a StreamingSession
    in `feed_frames`-sized pushes (default: one window hop at a time)."""
    sess = StreamingSession(cfg, params, precision, device, modules)
    feed = feed_frames or sess.hop_raw
    out: List[int] = []
    for s in range(0, len(feats), feed):
        out.extend(sess.accept(feats[s : s + feed]))
    out.extend(sess.finish())
    return out

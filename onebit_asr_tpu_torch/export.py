"""Serialized serving artifacts through `torch.export`.

Counterpart of onebit_asr_tpu/export.py. The inference function is traced
once, with the weights closed over as the module's own, and saved by
`torch.export.save` as one self-contained program: the serving host loads
it with `torch` and this package's `ops` modules (which register the custom
ops of the kernels it calls), without the model's modules, its weights tree
or a checkpoint.

Three artifact kinds:

- **offline**: `(feats [B, T, F] f32, feat_lens [B] int) ->` greedy ids and
  lengths, CTC log-probs and valid frames, all four ("both"), or the device
  beam's ids and lengths ("beam"), an n-gram LM's tables baked in. B may be
  exported symbolic (`batch_size=None`); T stays static (the position table
  depends on it). The packed form runs the packed-ternary kernels
  (`torch.ops.onebit.ternary_matmul`, or `ternary_matmul_w2a8` with
  `int8_act`); a model with `fused_subsampler` or `fused_attention` runs
  `torch.ops.onebit.fused_subsample` and `fused_relpos_attention`.
- **streaming**, single stream: one chunk step, `(window [1, W, F] f32,
  caches [L, 1, C, D], cache_valid [1] int64, cur_valid [1] int64) ->
  (logits [1, cs, V] f32, new caches)`. The validity counts are per row,
  the port's streaming contract (model/streaming.py), not JAX's scalars.
- **streaming**, batched (`n_streams` > 1): the server's step over N slots,
  the same arguments at [N] plus `active [N] bool`; inactive slots' caches
  come back unchanged (`torch.where`, the server's own rule).

Every artifact is a directory: its program (`torch.export.save`) and
`meta.json` (JAX's keys, plus the signature). A `torch.export` program runs
on the device it was traced on, so JAX's `platforms` list (one program for
several platforms) becomes one member program per device: `platforms=
("cuda", "cpu")` traces the module once on each and writes
`module_cuda.pt2` and `module_cpu.pt2`; one platform keeps the single
`module.pt2`. meta.json lists `platforms` in the given order and each
member's file under `members`. JAX's "gpu" is "cuda"; "tpu" is refused (the
port has no TPU member). `load_artifact(path, device)` loads the member
for `device` (cuda if the artifact has one, else its only member), and
never another: a cuda member on a machine without a card raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from onebit_asr_tpu_torch.utils.config import ModelConfig, model_config_from_dict

FORMAT_VERSION = 1
_MODULE_FILE = "module.pt2"
_META_FILE = "meta.json"
EMITS = ("greedy", "logprobs", "both", "beam")
DEVICES = ("cuda", "cpu")


def _layer_mask(precision: int, num_layers: int):
    """The precision's layer mask as a list of bools (None at 32): a
    constant of the trace, not a tensor it reads."""
    from onebit_asr_tpu_torch.model.asr import precision_to_binary_mask

    mask = precision_to_binary_mask(precision, num_layers)
    return None if mask is None else mask.tolist()


def export_devices(platforms: Optional[Sequence[str]], device: str) -> List[str]:
    """The devices to export a member for, in order: `platforms` (JAX's
    argument; "gpu" is "cuda"), or `device`. ValueError for "tpu" or another
    platform the port has no member for; RuntimeError, before anything is
    traced, for cuda on a machine without a card."""
    names = [{"gpu": "cuda"}.get(p, p) for p in (platforms or [device])]
    if "tpu" in names:
        raise ValueError("platform 'tpu': the port has no TPU member "
                         f"(export for {' and/or '.join(DEVICES)})")
    devices = [torch.device(d).type for d in names]
    for p, d in zip(names, devices):
        if d not in DEVICES:
            raise ValueError(f"platform {p!r}: not one of {', '.join(DEVICES)}")
    if len(set(devices)) != len(devices):
        raise ValueError(f"platforms {names}: each at most once")
    if "cuda" in devices and not torch.cuda.is_available():
        raise RuntimeError(f"platforms {devices}: cuda needs a CUDA card, and this machine "
                           "has none (export for cpu alone here, or on the card)")
    return devices


def _exported(devices: List[str], trace):
    """`trace(device)` for each device: the one program, or {device:
    program} for several."""
    if len(devices) == 1:
        return trace(devices[0])
    return {d: trace(d) for d in devices}


# --------------------------------------------------------------------- build


class OfflineForward(nn.Module):
    """The offline inference module: the model (its weights its own), the
    precision's layer mask and the decode `emit` asks for."""

    def __init__(self, model: nn.Module, layer_mask, blank_id: int, emit: str, beam: dict):
        super().__init__()
        self.model = model
        self.layer_mask = layer_mask
        self.blank_id = blank_id
        self.emit = emit
        self.beam = beam

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        from onebit_asr_tpu_torch.decode.greedy import greedy_ctc_decode

        _, enc_mask, logits = self.model(feats, feat_lens, self.layer_mask)
        enc_lens = enc_mask.sum(dim=-1)
        log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
        if self.emit == "logprobs":
            return log_probs, enc_lens
        if self.emit == "beam":
            from onebit_asr_tpu_torch.decode.beam_device import beam_search_device

            return beam_search_device(log_probs, enc_lens, blank_id=self.blank_id,
                                      max_len=int(log_probs.shape[1]), all_frames=True,
                                      **self.beam)
        ids, lens = greedy_ctc_decode(log_probs, enc_lens, self.blank_id)
        if self.emit == "greedy":
            return ids, lens
        return ids, lens, log_probs, enc_lens


def build_offline_forward(
    cfg: ModelConfig,
    params: Any,
    precision: int,
    *,
    packed: bool = False,
    emit: str = "greedy",
    beam_size: int = 10,
    beam_top_k: int = 20,
    lm=None,
    lm_weight: float = 0.0,
    length_bonus: float = 0.0,
    int8_act: bool = False,
    device: str = "cuda",
) -> OfflineForward:
    """The module to export, on `device` without gradients, from a
    training-form JAX-layout tree (numpy or torch leaves).

    emit: "greedy" -> (ids [B, T'], lens [B]); "logprobs" -> (log_probs
    [B, T', V] f32, enc_lens [B]); "both" -> all four; "beam" -> (ids
    [B, T'], lens [B]) from the device prefix beam over all T' frames, with
    `lm` (a DeviceLM on `device`) fused at `lm_weight`. `packed` serves
    planar-packed weights at precision 2 or 1, `int8_act` through the W2A8
    kernel (the port's stand-in for ONEBIT_PACKED_INT8_ACT); else the QAT
    model in eval mode at precision 32, 2 or 1."""
    if emit not in EMITS:
        raise ValueError(f"emit must be greedy|logprobs|both|beam, got {emit!r}")
    from onebit_asr_tpu_torch.convert import packed_model_from_jax, qat_model_from_jax

    mask = _layer_mask(precision, cfg.enc_layers)
    if packed:
        model = packed_model_from_jax(cfg, params, precision, int8_act, device)
    elif int8_act:
        raise ValueError("int8_act needs the packed weights (packed=True)")
    else:
        model = qat_model_from_jax(cfg, params, device, decoder=False)
    model.requires_grad_(False).eval()
    beam = dict(beam_size=beam_size, top_k=beam_top_k, lm=lm, lm_weight=lm_weight,
                length_bonus=length_bonus)
    return OfflineForward(model, mask, cfg.specials.blank_id, emit, beam)


class StreamingStep(nn.Module):
    """One chunk step with its CTC head: `(window, caches, cache_valid,
    cur_valid) -> (logits f32, new caches)`."""

    def __init__(self, step: nn.Module, head: nn.Module, layer_mask):
        super().__init__()
        self.step = step
        self.head = head
        self.layer_mask = layer_mask

    def forward(self, window, caches, cache_valid, cur_valid):
        enc, new_caches = self.step(window, caches, cache_valid, cur_valid, self.layer_mask)
        return self.head(enc).to(torch.float32), new_caches


class StreamingBatchStep(nn.Module):
    """The server's step over N slots: the single step over every row, then
    each inactive slot's caches passed through unchanged."""

    def __init__(self, single: StreamingStep):
        super().__init__()
        self.single = single

    def forward(self, windows, caches, cache_valid, cur_valid, active):
        logits, new_caches = self.single(windows, caches, cache_valid, cur_valid)
        return logits, torch.where(active[None, :, None, None], new_caches, caches)


def build_streaming_step(cfg: ModelConfig, params: Any, precision: int,
                         device: str = "cuda") -> StreamingStep:
    """One chunk step with the weights as the module's own (decode/
    streaming.py's step, which takes them from a tree per session)."""
    from onebit_asr_tpu_torch.convert import streaming_step_from_jax

    step, head = streaming_step_from_jax(cfg, params, device)
    return StreamingStep(step, head, _layer_mask(precision, cfg.enc_layers)).eval()


def build_streaming_batch_step(cfg: ModelConfig, params: Any, precision: int,
                               n_streams: int, device: str = "cuda") -> StreamingBatchStep:
    """The StreamingServer's step over `n_streams` slots (the count is the
    exported shape, not a property of the module)."""
    return StreamingBatchStep(build_streaming_step(cfg, params, precision, device)).eval()


# -------------------------------------------------------------------- export


def _export(module: nn.Module, args, dynamic_shapes=None) -> "torch.export.ExportedProgram":
    """Trace `module` on `args` without gradients. One eager call first
    fills the model's caches (the position table, the window tables) with
    real tensors, which the trace then keeps as constants."""
    with torch.no_grad():
        module(*args)
        return torch.export.export(module, args, dynamic_shapes=dynamic_shapes)


def export_offline(
    cfg: ModelConfig,
    params: Any,
    precision: int,
    num_frames: int,
    batch_size: Optional[int] = 8,
    *,
    packed: bool = False,
    emit: str = "greedy",
    platforms: Optional[Sequence[str]] = None,
    device: str = "cuda",
    int8_act: bool = False,
    **decode_kwargs,
):
    """Trace and export the offline forward. batch_size=None exports a
    symbolic batch dimension (one artifact, any B); the packed form needs a
    static batch, as JAX's does. decode_kwargs (beam_size, beam_top_k, lm,
    lm_weight, length_bonus) configure emit="beam" (an `lm` lives on one
    device: one platform then). With several `platforms`, {device:
    program}, one traced on each."""
    if batch_size is None and packed:
        raise ValueError("packed export needs a static batch_size "
                         "(the packed artifact is shape-specialized, as JAX's)")
    devices = export_devices(platforms, device)
    B = 2 if batch_size is None else int(batch_size)
    feats = np.random.default_rng(0).standard_normal(
        (B, num_frames, cfg.input_dim)).astype(np.float32)
    dynamic = None
    if batch_size is None:
        b = torch.export.Dim("b", min=1)
        dynamic = ({0: b}, {0: b})

    def trace(dev):
        fn = build_offline_forward(cfg, params, precision, packed=packed, emit=emit,
                                   int8_act=int8_act, device=dev, **decode_kwargs)
        lens = torch.full((B,), num_frames, dtype=torch.int64, device=dev)
        return _export(fn, (torch.from_numpy(feats).to(dev), lens), dynamic)

    return _exported(devices, trace)


def streaming_geometry(cfg: ModelConfig) -> Dict[str, int]:
    """chunk_size, window_raw, hop_raw and cache_frames of a streaming config."""
    from onebit_asr_tpu_torch.model.streaming import raw_window_size, streaming_cache_chunks

    if cfg.attn_chunk_size is None:
        raise ValueError("streaming export needs cfg.attn_chunk_size")
    cs = int(cfg.attn_chunk_size)
    return {"chunk_size": cs, "window_raw": raw_window_size(cs), "hop_raw": 4 * cs,
            "cache_frames": streaming_cache_chunks(cfg.enc_conv_kernel, cs,
                                                   cfg.attn_left_chunks) * cs}


def export_streaming(
    cfg: ModelConfig,
    params: Any,
    precision: int,
    *,
    n_streams: int = 1,
    platforms: Optional[Sequence[str]] = None,
    device: str = "cuda",
):
    """Trace and export one streaming chunk step: the single-session step
    with n_streams == 1, the server's step over N slots (with `active`)
    with n_streams > 1. With several `platforms`, {device: program}."""
    geo = streaming_geometry(cfg)
    devices = export_devices(platforms, device)
    N = int(n_streams)
    window = np.random.default_rng(0).standard_normal(
        (N, geo["window_raw"], cfg.input_dim)).astype(np.float32)

    def trace(dev):
        args = [
            torch.from_numpy(window).to(dev),
            torch.zeros((cfg.enc_layers, N, geo["cache_frames"], cfg.enc_d_model),
                        dtype=getattr(torch, cfg.compute_dtype), device=dev),
            torch.zeros((N,), dtype=torch.int64, device=dev),
            torch.full((N,), geo["chunk_size"], dtype=torch.int64, device=dev),
        ]
        if N == 1:
            fn = build_streaming_step(cfg, params, precision, dev)
        else:
            fn = build_streaming_batch_step(cfg, params, precision, N, dev)
            args.append(torch.ones((N,), dtype=torch.bool, device=dev))
        return _export(fn, tuple(args))

    return _exported(devices, trace)


# ---------------------------------------------------------------- save/load


def artifact_meta(
    cfg: ModelConfig, precision: int, kind: str, emit: str = "greedy",
    packed: bool = False, extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": kind,  # offline | streaming
        "emit": emit,
        "precision": precision,
        "packed": packed,
        "model": dataclasses.asdict(cfg),
        "specials": dataclasses.asdict(cfg.specials),
    }
    if extra:
        meta.update(extra)
    return meta


def _spec(node) -> str:
    """"dtype[shape]" of a graph node (a symbolic dim by its symbol)."""
    val = node.meta["val"]
    dims = ", ".join(str(d) for d in val.shape)
    return f"{str(val.dtype).replace('torch.', '')}[{dims}]"


def program_specs(exported: "torch.export.ExportedProgram"):
    """(the device, the user inputs' "name: dtype[shape]", the user outputs'
    "dtype[shape]") of a program."""
    graph = exported.graph_module.graph
    user = set(exported.graph_signature.user_inputs)
    inputs = [n for n in graph.nodes if n.op == "placeholder" and n.name in user]
    outputs = next(n for n in graph.nodes if n.op == "output").args[0]
    return (inputs[0].meta["val"].device.type, [f"{n.name}: {_spec(n)}" for n in inputs],
            [_spec(n) for n in outputs])


def save_artifact(exported, path: str, meta: Dict[str, Any]) -> None:
    """Write the artifact directory: module.pt2 + meta.json for one program,
    or module_<device>.pt2 for each of {device: program} (`platforms` in
    its order)."""
    programs = exported if isinstance(exported, dict) else {None: exported}
    specs = {d: program_specs(ep) for d, ep in programs.items()}
    for d, (device, _, _) in specs.items():
        if d is not None and d != device:
            raise ValueError(f"member {d!r} holds a program traced on {device}")
    members = {device: (_MODULE_FILE if len(programs) == 1 else f"module_{device}.pt2")
               for device, _, _ in specs.values()}
    os.makedirs(path, exist_ok=True)
    for ep, name in zip(programs.values(), members.values()):
        torch.export.save(ep, os.path.join(path, name))
    device, ins, outs = next(iter(specs.values()))
    meta = dict(meta)
    meta["platforms"] = list(members)
    meta["members"] = members
    meta["device"] = device
    meta["in_avals"] = ins
    meta["out_avals"] = outs
    meta["signature"] = f"({', '.join(ins)}) -> ({', '.join(outs)})"
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def artifact_members(meta: Dict[str, Any]) -> Dict[str, str]:
    """{device: program file} of an artifact's meta (one written before
    members were: its `device` and module.pt2)."""
    return meta.get("members") or {meta["device"]: _MODULE_FILE}


def member_device(meta: Dict[str, Any], device: Optional[str] = None) -> str:
    """The member `load_artifact` takes for `device`: its type ("gpu" is
    cuda); None: cuda if the artifact has it, else its only member (the
    members are cuda and cpu at most). ValueError, naming the members, for
    a device the artifact lacks; RuntimeError for a cuda member on a
    machine without a card (no other member is taken in its place)."""
    members = artifact_members(meta)
    have = ", ".join(members)
    if device is None:
        device = "cuda" if "cuda" in members else next(iter(members))
    device = torch.device({"gpu": "cuda"}.get(device, device)).type
    if device not in members:
        raise ValueError(f"the artifact has no {device} member (it holds {have})")
    if device == "cuda" and not torch.cuda.is_available():
        other = [d for d in members if d != "cuda"]
        raise RuntimeError("the artifact's cuda member needs a CUDA card, and this machine has "
                           "none" + (f"; load its {other[0]} member with --device {other[0]} "
                                     f"(device={other[0]!r})" if other else ""))
    return device


def load_artifact(path: str, device: Optional[str] = None):
    """-> (callable, meta). The callable runs the artifact's member for
    `device` (`member_device`) without gradients on tensors on that device,
    which meta["device"] names. Loading imports `torch` and the package's
    `ops` modules, whose custom ops the program calls, and nothing of the
    model."""
    from onebit_asr_tpu_torch.ops import attention, subsampler, ternary_matmul  # noqa: F401

    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    device = member_device(meta, device)
    module = torch.export.load(os.path.join(path, artifact_members(meta)[device])).module()
    meta["device"] = device

    def call(*args):
        with torch.no_grad():
            return module(*args)

    return call, meta


def greedy_ids_to_lists(ids, lens):
    """[B, T'] padded id matrix + [B] lens (tensors or arrays) -> list of
    python id lists."""
    ids, lens = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in (ids, lens))
    return [list(map(int, ids[b, : lens[b]])) for b in range(len(lens))]


# ----------------------------------------------- artifact-backed runtimes


def streaming_session_from_artifact(path: str, device: Optional[str] = None,
                                    **session_kwargs):
    """A StreamingSession whose chunk step is a loaded artifact (its member
    for `device`, as `load_artifact`): the serving host needs the artifact
    directory, not weights or a checkpoint. Requires an
    `export_streaming(..., n_streams=1)` artifact."""
    from onebit_asr_tpu_torch.decode.streaming import StreamingSession

    fn, meta = load_artifact(path, device)
    if meta["kind"] != "streaming" or meta.get("n_streams", 1) != 1:
        raise ValueError(f"{path} is not a single-stream streaming artifact")
    session_kwargs.setdefault("device", meta["device"])
    return StreamingSession(model_config_from_dict(meta["model"]), step_fn=fn,
                            **session_kwargs)


def streaming_server_from_artifact(path: str, device: Optional[str] = None, **server_kwargs):
    """A StreamingServer multiplexing N streams through a loaded batched
    artifact (`export_streaming(..., n_streams=N)`; its member for `device`,
    as `load_artifact`); max_streams is fixed to the artifact's N."""
    from onebit_asr_tpu_torch.decode.streaming import StreamingServer

    fn, meta = load_artifact(path, device)
    n = int(meta.get("n_streams", 1))
    if meta["kind"] != "streaming" or n < 2:
        raise ValueError(f"{path} is not a batched streaming artifact")
    server_kwargs.setdefault("device", meta["device"])
    return StreamingServer(model_config_from_dict(meta["model"]), max_streams=n,
                           batch_step_fn=fn, **server_kwargs)

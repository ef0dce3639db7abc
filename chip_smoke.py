#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (onebit_asr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Drives packed-ternary offline transcription of Conformer-M at full width and
depth (d=256, 12 blocks, 4 heads, d_ff 1024, vocab 5004, bf16) with random
weights drawn from --seed, on 8 synthetic waveforms of 2-16 s:

1. build: compiles csrc/*.cu with nvcc (sm_90a) and prints the time;
2. kernels: for each distinct (M, K, N) of one forward at B=8, 16 s
   (T'=512: M=4096, and 1023 for the position projection) each packed
   CUDA kernel is held against its plain PyTorch version on the card (bf16
   kernel: |d| <= 1e-4 + 1e-5*|ref|, f32 sums in another order; W2A8:
   bit-exact) and timed with CUDA events beside its bound and torch.matmul
   on the dense unpacked bf16 weight (`library_ms`, a yardstick only); the
   fused subsampler kernel is held against its plain version at the path's
   shape (B=8, T=1598, F=80, C=256; within one bf16 ulp: rtol 2^-7, atol
   1e-3, conv2's f32 sums in another order) and timed beside the port's
   unfused cuDNN conv pair (`library_ms`, a yardstick only: it rounds conv1
   otherwise);
3. path: the transcribe CLI runs end to end on the bf16 kernel, with
   --int8_act, and with a config that sets fused_subsampler; each run must
   launch its packed kernel 108 times per batch (9 packed projections x 12
   blocks), the other never, and the fused subsampler kernel exactly once
   per batch in the fused run and never otherwise. A config that sets
   fused_attention must be refused, and served with --no_fused_kernels.
   Then the same models' CTC log-probs through the kernels are compared on
   valid frames with the models run on the plain versions on the card, and
   the greedy ids, ms per batch and peak memory are printed; the unfused
   bf16 path is also run with PyTorch's default TF32 for cuDNN and compared
   with TF32 off.

Prints a {"kernels": [...]} line, the card's name and power limit, and last
{"ok": true, "device": {...}}. Exits non-zero without that line when there
is no CUDA card or any phase fails. Imports nothing of JAX or onebit_asr_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
BATCH = 8
SAMPLE_RATE = 16000


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call on the card (CUDA events around `iters` calls)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_breakdown(fn, top: int = 15) -> None:
    """Device time of one call of `fn` by kernel name (torch.profiler), and
    the share of the call's wall time in which the card ran no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("profile: the profiler recorded no device events")
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    total = sum(by_name.values())
    log(f"profile: wall_ms={wall_ms:.2f} kernel_ms={total:.2f} busy_ms={busy / 1e3:.2f} "
        f"idle_share={1 - busy / 1e3 / wall_ms:.3f} kernels={len(kernels)}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"profile: {ms:8.3f} ms {ms / total:6.1%}  {name[:90]}")


def path_shapes(cfg, t_pad: int):
    """(M, K, N) -> launches per forward of every packed projection."""
    d, dff, L = cfg.enc_d_model, cfg.enc_d_ff, cfg.enc_layers
    M = BATCH * t_pad
    return {
        (M, d, dff): 2 * L,          # ff1.w1, ff2.w1
        (M, dff, d): 2 * L,          # ff1.w2, ff2.w2
        (M, d, d): 4 * L,            # q, k, v, out projections
        (2 * t_pad - 1, d, d): L,    # position projection
    }


def kernel_phase(cfg, t_pad, seed):
    from onebit_asr_tpu_torch.ops import ternary_matmul as tm

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    rows = {}
    for name, kind, kernel, plain in (
        ("ternary_matmul_bf16", "bf16", tm.ternary_matmul, tm.ternary_matmul_reference),
        ("ternary_matmul_w2a8", "int8", tm.ternary_matmul_w2a8, tm.ternary_matmul_w2a8_reference),
    ):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        max_err, bytes_bound = 0.0, True
        for (M, K, N), n in path_shapes(cfg, t_pad).items():
            x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev)
            x = x.to(torch.bfloat16)
            q = torch.from_numpy(rng.integers(-1, 2, size=(K, N)).astype(np.float32))
            packed = tm.pack_planar(q).to(dev)
            alpha = torch.tensor(rng.uniform(0.01, 0.1), dtype=torch.float32, device=dev)
            out = kernel(x, packed, alpha)
            ref = plain(x, packed, alpha)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            max_err = max(max_err, err)
            if kind == "int8":
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name} {M}x{K}x{N}: not bit-exact (max |d| {err})")
            elif not bool(((out - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all()):
                raise AssertionError(f"{name} {M}x{K}x{N}: max |d| {err} over tolerance")
            w = tm.unpack_planar(packed).to(torch.bfloat16)
            ms = cuda_ms(lambda: kernel(x, packed, alpha))
            plain_ms = cuda_ms(lambda: plain(x, packed, alpha))
            lib_ms = cuda_ms(lambda: torch.matmul(x, w))
            nbytes = M * K * 2 + K * N // 4 + M * N * 4 + 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2.0 * M * N * K / PEAK_OPS[kind] * 1e3
            bytes_bound &= t_bytes >= t_ops
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("bound_ms", max(t_bytes, t_ops)), ("library_ms", lib_ms)):
                tot[key] += n * v
            log(f"kernel {name} M={M} K={K} N={N} x{n}/forward: max|d|={err:.3g} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={max(t_bytes, t_ops):.4f} "
                f"library_ms={lib_ms:.4f}")
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": "onebit_asr_tpu_torch/csrc/ternary_matmul.cu",
            "replaces": ("onebit_asr_tpu/ops/ternary_matmul.py:60" if kind == "bf16"
                         else "onebit_asr_tpu/ops/ternary_matmul.py:190"),
            "launches": 0,
            "max_abs_err": max_err,
            **tot,
            "bound_by": "bytes" if bytes_bound else "operations",
        }
    return rows


def subsample_kernel_phase(cfg, frames, seed, rows):
    """The fused subsampler kernel against its plain version at the path's
    shape: one forward of B=8 utterances of `frames` log-mel frames."""
    import torch.nn.functional as F

    from onebit_asr_tpu_torch.ops import subsampler as ss

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    B, T, Fd, C = BATCH, frames, cfg.input_dim, cfg.enc_d_model
    x, w1, b1, w2, b2 = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.standard_normal((B, T, Fd)),
        rng.standard_normal((3, 3, C)) / 3.0,
        rng.uniform(-1 / 3, 1 / 3, C),
        rng.standard_normal((9 * C, C)) / np.sqrt(9 * C),
        rng.uniform(-1, 1, C) / np.sqrt(9 * C),
    ))
    w2 = w2.to(torch.bfloat16)
    out = ss.fused_subsample(x, w1, b1, w2, b2)
    ref = ss.fused_subsample_reference(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    err = d.max().item()
    same = (out == ref).float().mean().item()
    if not bool((d <= 1e-3 + 2.0 ** -7 * ref.float().abs()).all()):
        raise AssertionError(f"fused_subsample: max |d| {err} over one bf16 ulp")
    # the port's unfused path: bf16 features -> two cuDNN convs + ReLU
    w1c = w1.permute(2, 0, 1)[:, None].to(torch.bfloat16)
    w2c = w2.reshape(3, 3, C, C).permute(3, 2, 0, 1).contiguous()
    b1c, b2c = b1.to(torch.bfloat16), b2.to(torch.bfloat16)

    def unfused():
        y = F.relu(F.conv2d(x[:, None].to(torch.bfloat16), w1c, b1c, stride=2))
        return F.relu(F.conv2d(y, w2c, b2c, stride=2))

    ms = cuda_ms(lambda: ss.fused_subsample(x, w1, b1, w2, b2))
    plain_ms = cuda_ms(lambda: ss.fused_subsample_reference(x, w1, b1, w2, b2))
    lib_ms = cuda_ms(unfused)
    T2, F2 = out.shape[1], out.shape[2]
    T1, F1 = ss.out_len(T), ss.out_len(Fd)
    nbytes = x.numel() * 4 + out.numel() * 2 + w2.numel() * 2 + (11 * C) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_conv2 = 2.0 * B * T2 * F2 * C * 9 * C / PEAK_OPS["bf16"] * 1e3
    t_conv1 = 2.0 * B * T1 * F1 * C * 9 / PEAK_OPS["f32"] * 1e3
    bound = max(t_bytes, t_conv2, t_conv1)  # tensor and CUDA cores may overlap
    log(f"kernel fused_subsample B={B} T={T} F={Fd} C={C} -> T2={T2} F2={F2} x1/forward: "
        f"max|d|={err:.3g} bit_identical={same:.4f} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.4f} (bytes {t_bytes:.4f}, conv2 bf16 {t_conv2:.4f}, "
        f"conv1 f32 {t_conv1:.4f}) library_ms={lib_ms:.4f} (unfused cuDNN convs)")
    rows["fused_subsample"] = {
        "name": "fused_subsample",
        "route": "cuda",
        "source": "onebit_asr_tpu_torch/csrc/subsampler.cu",
        "replaces": "onebit_asr_tpu/ops/subsampler.py:217",
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= max(t_conv2, t_conv1) else "operations",
        "library_ms": lib_ms,
    }


def synthetic_waveforms(seed: int):
    """8 waveforms of 2-16 s (one of exactly 16 s): tone mixtures + noise."""
    rng = np.random.default_rng(seed)
    secs = np.concatenate([[16.0], rng.uniform(2.0, 16.0, BATCH - 1)])
    wavs = []
    for s in secs:
        t = np.arange(int(s * SAMPLE_RATE)) / SAMPLE_RATE
        f = rng.uniform(100.0, 3000.0, size=4)
        w = sum(np.sin(2 * np.pi * fi * t + rng.uniform(0, 6.3)) for fi in f)
        w = 0.05 * w + 0.01 * rng.standard_normal(t.shape)
        wavs.append(w.astype(np.float32))
    return wavs


def pcm16(w: np.ndarray) -> np.ndarray:
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)


def write_inputs(root, configs, params, wavs, cmvn):
    """The CLI's inputs: params .npz, one config.json per entry of
    `configs` ({name: ModelConfig}), cmvn, 16-bit PCM wavs."""
    from onebit_asr_tpu_torch.convert import flatten
    from onebit_asr_tpu_torch.utils.config import TrainConfig, config_to_json

    paths = {k: os.path.join(root, k) for k in ("params.npz", "data", "wavs")}
    np.savez(paths["params.npz"], **flatten(params))
    for name, cfg in configs.items():
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            f.write(config_to_json(TrainConfig(model=cfg)))
    os.makedirs(paths["data"])
    np.savez(os.path.join(paths["data"], "cmvn_stats.npz"), mean=cmvn[0], std=cmvn[1])
    os.makedirs(paths["wavs"])
    for i, w in enumerate(wavs):
        with wave.open(os.path.join(paths["wavs"], f"utt{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(SAMPLE_RATE)
            f.writeframes(pcm16(w).tobytes())
    return paths


def pad_batch(wavs):
    lens = np.array([len(w) for w in wavs], np.int32)
    batch = np.zeros((len(wavs), lens.max()), np.float32)
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
    return batch, lens


def _use_plain(model, int8_act):
    """Point every kernel wrapper of `model` at its plain version."""
    from onebit_asr_tpu_torch.model.layers import QuantDense
    from onebit_asr_tpu_torch.ops import subsampler as ss
    from onebit_asr_tpu_torch.ops import ternary_matmul as tm

    plain = tm.ternary_matmul_w2a8_reference if int8_act else tm.ternary_matmul_reference
    for m in model.modules():
        if isinstance(m, QuantDense):
            m.matmul = plain
    model.encoder.subsample.subsample_fn = ss.fused_subsample_reference


def _compare(name, lp, lp_ref, enc_lens, vocab, pad_multiple):
    """max/mean |d log p| and argmax agreement on valid frames."""
    T = lp.shape[1]
    if lp.shape != (BATCH, T, vocab) or T % pad_multiple:
        raise AssertionError(f"{name}: log-probs shape {tuple(lp.shape)}")
    mask = torch.arange(T, device="cuda")[None] < enc_lens[:, None]
    if not bool(torch.isfinite(lp[mask]).all()):
        raise AssertionError(f"{name}: non-finite log-probs")
    d = (lp - lp_ref).abs()[mask]
    agree = (lp.argmax(-1) == lp_ref.argmax(-1))[mask].float().mean().item()
    return mask, d.max().item(), d.mean().item(), agree


def check_variant(name, t, int8_act, batch, lens):
    """ms per batch and peak memory of Transcriber `t` on the kernels, then
    its CTC log-probs against the same model on the plain versions."""
    cfg = t.cfg.model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: t.transcribe(batch, lens), iters=5, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lp, enc_lens = t.log_probs(batch, lens)
    ids, n_ids = t.transcribe(batch, lens)
    if name == "ternary_matmul_bf16":
        # PyTorch's default lets cuDNN run the f32 depthwise conv in TF32
        torch.backends.cudnn.allow_tf32 = True
        lp_tf32, _ = t.log_probs(batch, lens)
        torch.backends.cudnn.allow_tf32 = False
        _, dmax, dmean, agree = _compare("tf32", lp_tf32, lp, enc_lens,
                                         cfg.vocab_size, cfg.time_pad_multiple)
        log(f"path tf32: cuDNN TF32 on (PyTorch default) vs off, bf16 kernel path: "
            f"logprob max|d|={dmax:.4g} mean|d|={dmean:.4g} argmax_agree={agree:.4f}")
    _use_plain(t.model, int8_act)
    lp_ref, _ = t.log_probs(batch, lens)
    ids_ref, n_ref = t.transcribe(batch, lens)
    mask, dmax, dmean, agree = _compare(name, lp, lp_ref, enc_lens,
                                        cfg.vocab_size, cfg.time_pad_multiple)
    same_ids = sum(
        int(n_ids[b] == n_ref[b] and (ids[b, : n_ids[b]] == ids_ref[b, : n_ref[b]]).all())
        for b in range(BATCH)
    )
    log(f"path {name}: audio_s={lens.sum() / SAMPLE_RATE:.2f} T'={lp.shape[1]} "
        f"valid_frames={int(mask.sum())} "
        f"logprob max|d|={dmax:.4g} mean|d|={dmean:.4g} "
        f"argmax_agree={agree:.4f} same_greedy_ids={same_ids}/{BATCH} "
        f"ms_per_batch={ms:.2f} peak_mem_gb={peak_gb:.3f}")
    if dmean > 0.05 or agree < 0.9:
        raise AssertionError(f"{name}: kernel path strays from the plain path")


def path_phase(cfg, params, wavs, rows, profile=False):
    from onebit_asr_tpu_torch.cli import transcribe as cli
    from onebit_asr_tpu_torch.ops import subsampler as ss
    from onebit_asr_tpu_torch.ops import ternary_matmul as tm
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend
    from onebit_asr_tpu_torch.utils.config import TrainConfig

    # the CLI reads 16-bit PCM: quantize here too, so both paths see one input
    batch, lens = pad_batch([pcm16(w).astype(np.float32) / 32768.0 for w in wavs])
    fe = LogMelFrontend()
    feats, flens = fe(torch.from_numpy(batch).cuda(), torch.from_numpy(lens).cuda())
    valid = torch.arange(feats.shape[1], device="cuda")[None] < flens[:, None]
    v = feats[valid]
    cmvn = (v.mean(0).cpu().numpy(), v.std(0).clamp(min=1e-8).cpu().numpy())

    kernels = {"ternary_matmul_bf16": tm.ternary_matmul,
               "ternary_matmul_w2a8": tm.ternary_matmul_w2a8,
               "fused_subsample": ss.fused_subsample}
    configs = {
        "config": cfg,
        "config_fused": dataclasses.replace(cfg, fused_subsampler=True),
        "config_fused_attention": dataclasses.replace(
            cfg, fused_attention=True, fused_subsampler=True),
    }
    L = 9 * cfg.enc_layers
    # (label, config, extra CLI arguments, launches wanted per batch)
    runs = [
        ("ternary_matmul_bf16", "config", [], {"ternary_matmul_bf16": L}),
        ("ternary_matmul_w2a8", "config", ["--int8_act"], {"ternary_matmul_w2a8": L}),
        ("fused_subsampler", "config_fused", [],
         {"ternary_matmul_bf16": L, "fused_subsample": 1}),
        ("no_fused_kernels", "config_fused_attention", ["--no_fused_kernels"],
         {"ternary_matmul_bf16": L}),
    ]
    build_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "onebit_asr_tpu_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as root:
        paths = write_inputs(root, configs, params, wavs, cmvn)

        def argv(config, extra, out):
            return ["--params", paths["params.npz"], "--config", paths[config],
                    "--wav_dir", paths["wavs"], "--data_dir", paths["data"],
                    "--batch_size", str(BATCH), "--out", out, *extra]

        try:
            cli.main(argv("config_fused_attention", [], os.path.join(root, "refused.tsv")))
        except NotImplementedError as e:
            log(f"path cli fused_attention: refused ({e})")
        else:
            raise AssertionError("a config with fused_attention=True was served")
        for label, config, extra, want in runs:
            out = os.path.join(root, f"hyp_{label}.tsv")
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(argv(config, extra, out))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in kernels.items()}
            if rc != 0:
                raise AssertionError(f"transcribe CLI ({label}) returned {rc}")
            if counts != {k: want.get(k, 0) for k in kernels}:
                raise AssertionError(f"{label}: launches {counts}, want {want}")
            if label in rows:
                rows[label]["launches"] = counts[label]
            if label == "fused_subsampler":
                rows["fused_subsample"]["launches"] = counts["fused_subsample"]
            with open(out) as f:
                lines = [l.rstrip("\n").split("\t") for l in f]
            if len(lines) != BATCH or any(len(l) != 2 for l in lines):
                raise AssertionError(f"CLI wrote {len(lines)} lines, want {BATCH}")
            log(f"path cli {label}: rc=0 launches={counts} utterances={len(lines)} "
                f"wall_s={wall:.2f} (weights export + load + featurize + forward + decode)")

    variants = (
        ("ternary_matmul_bf16", cfg, False),
        ("ternary_matmul_w2a8", cfg, True),
        ("fused_subsampler", configs["config_fused"], False),
    )
    for name, model_cfg, int8_act in variants:
        t = cli.Transcriber(TrainConfig(model=model_cfg), params, 2, int8_act, cmvn, "cuda")
        check_variant(name, t, int8_act, batch, lens)
        del t  # nothing of one variant stays allocated for the next
    # profiled last: a finished profiler run can slow later host code
    for name, model_cfg, int8_act in variants if profile else ():
        t = cli.Transcriber(TrainConfig(model=model_cfg), params, 2, int8_act, cmvn, "cuda")
        log(f"profile of one batch through {name}:")
        profile_breakdown(lambda: t.transcribe(batch, lens))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print where one batch's device time goes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from onebit_asr_tpu_torch.convert import init_params
    from onebit_asr_tpu_torch.model.conformer import subsampled_frames
    from onebit_asr_tpu_torch.model.presets import apply_preset
    from onebit_asr_tpu_torch.ops import _build
    from onebit_asr_tpu_torch.utils.config import ModelConfig

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as ptxas:
        so = _build.build(verbose=True)  # silent when already built
    _build.library()
    log(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")
    for line in ptxas.getvalue().splitlines():
        if "Compiling entry" in line or "registers" in line:
            log(f"build: {line.strip()}")

    cfg = apply_preset(ModelConfig(), "m")
    frames = 1 + (16 * SAMPLE_RATE - 400) // 160
    t_sub = subsampled_frames(frames)
    t_pad = -(-t_sub // cfg.time_pad_multiple) * cfg.time_pad_multiple
    rows = kernel_phase(cfg, t_pad, args.seed)
    subsample_kernel_phase(cfg, frames, args.seed, rows)
    log("kernels: every kernel agrees with its plain version at the path's shapes")

    params = init_params(cfg, args.seed)
    path_phase(cfg, params, synthetic_waveforms(args.seed), rows, args.profile)
    log("path: transcribe ran on the kernels and agrees with the plain path")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

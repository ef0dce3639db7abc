"""Kaldi-compatible log-mel filterbank + global CMVN, batched, in f32.

Counterpart of onebit_asr_tpu/ops/frontend.py: framing (snip edges) ->
optional dither -> DC removal -> preemphasis -> povey window -> rFFT power
spectrum (torch.fft, f32) -> mel filterbank -> log(max(e, eps)) -> optional
CMVN. Frames past an utterance's length are computed from the zero padding
and must be masked downstream with the returned lengths. The CMVN statistics
are accumulated over the valid frames of padded batches
(`accumulate_cmvn`, `finalize_cmvn`), as `prepare cmvn` does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from onebit_asr_tpu_torch.utils.config import FrontendConfig


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def povey_window(n: int) -> np.ndarray:
    """Kaldi 'povey' window: hann(n)**0.85 over n-1 denominator."""
    i = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * i / (n - 1))
    return (hann ** 0.85).astype(np.float32)


def mel_scale(freq: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(
    num_bins: int, nfft: int, sample_rate: float, low_freq: float, high_freq: float
) -> np.ndarray:
    """Kaldi-style triangular mel filterbank [nfft // 2, num_bins] (the
    nyquist bin is excluded, as in Kaldi)."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    num_fft_bins = nfft // 2
    fft_bin_width = sample_rate / nfft
    mel_low = mel_scale(np.array(low_freq))
    mel_high = mel_scale(np.array(high_freq))
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    mel_freqs = mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))
    left = mel_low + np.arange(num_bins, dtype=np.float64)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (mel_freqs[None, :] - left) / (center - left)
    down = (right - mel_freqs[None, :]) / (right - center)
    return np.maximum(0.0, np.minimum(up, down)).T.astype(np.float32)


def num_frames(num_samples: torch.Tensor, frame_len: int, frame_shift: int) -> torch.Tensor:
    """Kaldi snip-edges frame count: 0 if too short else 1+(n-len)//shift."""
    n = torch.as_tensor(num_samples)
    return torch.where(n < frame_len, 0, 1 + (n - frame_len) // frame_shift)


class LogMelFrontend:
    """fe = LogMelFrontend(FrontendConfig()); feats, lens = fe(wavs, wav_lens)."""

    def __init__(self, cfg: Optional[FrontendConfig] = None):
        self.cfg = cfg or FrontendConfig()
        c = self.cfg
        self.frame_len = int(c.sample_rate * c.frame_length_ms / 1000.0)  # 400
        self.frame_shift = int(c.sample_rate * c.frame_shift_ms / 1000.0)  # 160
        self.nfft = _next_pow2(self.frame_len)  # 512
        self._window = torch.from_numpy(povey_window(self.frame_len))
        self._mel = torch.from_numpy(
            mel_banks(c.num_mel_bins, self.nfft, c.sample_rate, c.low_freq, c.high_freq)
        )

    def frames_for_samples(self, num_samples) -> torch.Tensor:
        return num_frames(num_samples, self.frame_len, self.frame_shift)

    def max_frames(self, max_samples: int) -> int:
        return max(0, 1 + (max_samples - self.frame_len) // self.frame_shift)

    def __call__(self, wavs: torch.Tensor, wav_lens: torch.Tensor,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """wavs [B, N] f32 padded waveforms, wav_lens [B] sample counts ->
        (fbank [B, T, num_mel_bins] f32, feat_lens [B] int32).

        Dither (Kaldi's, before DC removal) adds `cfg.dither` times N(0, 1)
        noise to every frame sample when `cfg.dither` > 0 and the caller
        gives the noise: `noise` [B, T, frame_len] f32, or a `generator` on
        the waveforms' device to draw it from. Without either it never
        dithers, so serving stays deterministic."""
        c = self.cfg
        B, N = wavs.shape
        T = self.max_frames(N)
        if T <= 0:
            raise ValueError(f"waveform too short: {N} samples < {self.frame_len}")
        frames = wavs.to(torch.float32).unfold(-1, self.frame_len, self.frame_shift)
        if c.dither > 0.0 and (noise is not None or generator is not None):
            if noise is None:
                noise = torch.randn(frames.shape, generator=generator, device=frames.device)
            frames = frames + c.dither * noise.to(frames.device)
        if c.remove_dc:
            frames = frames - frames.mean(dim=-1, keepdim=True)
        if c.preemphasis > 0.0:
            prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
            frames = frames - c.preemphasis * prev
        frames = frames * self._window.to(frames.device)
        spec = torch.fft.rfft(frames, n=self.nfft, dim=-1)
        power = (spec.real.square() + spec.imag.square())[..., : self.nfft // 2]
        mel = power @ self._mel.to(frames.device)
        fbank = torch.log(torch.clamp(mel, min=torch.finfo(torch.float32).eps))
        feat_lens = torch.clamp(self.frames_for_samples(wav_lens), max=T)
        return fbank, feat_lens.to(torch.int32)


def apply_cmvn(feats: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Global CMVN: (x - mean) / std per mel bin."""
    return (feats - mean) / std


def resample_linear(wav: np.ndarray, orig_sr: int, new_sr: int = 16000) -> np.ndarray:
    """Host-side linear resampler for the rare non-16 kHz recording."""
    if orig_sr == new_sr:
        return wav
    n_out = int(round(len(wav) * new_sr / orig_sr))
    x_old = np.linspace(0.0, 1.0, num=len(wav), endpoint=False)
    x_new = np.linspace(0.0, 1.0, num=n_out, endpoint=False)
    return np.interp(x_new, x_old, wav).astype(np.float32)


def accumulate_cmvn(feats: torch.Tensor, feat_lens: torch.Tensor,
                    acc: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Add the valid frames of a padded batch (feats [B, T, F] f32, lens [B])
    to the running (sum [F], sum of squares [F], count []) on the batch's
    device."""
    s, sq, n = acc
    T = feats.shape[1]
    mask = (torch.arange(T, device=feats.device)[None, :]
            < feat_lens.to(feats.device)[:, None]).to(torch.float32)
    m = mask[..., None]
    s = s + torch.sum(feats * m, dim=(0, 1))
    sq = sq + torch.sum(feats.square() * m, dim=(0, 1))
    return s, sq, n + mask.sum()


def finalize_cmvn(acc: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                  std_floor: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares, count) -> (mean, std): mean = s / max(n, 1),
    std = max(sqrt(max(sq / n - mean^2, 0)), std_floor), in f32."""
    s, sq, n = acc
    n = torch.clamp(n, min=1.0)
    mean = s / n
    var = torch.clamp(sq / n - mean.square(), min=0.0)
    return mean, torch.clamp(torch.sqrt(var), min=std_floor)

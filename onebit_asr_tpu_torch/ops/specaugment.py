"""SpecAugment for a whole padded batch at once, from given mask starts.

Counterpart of onebit_asr_tpu/ops/specaugment.py. Per utterance,
`num_freq_masks` frequency masks and `num_time_masks` time masks, each of
FIXED width min(param, size), zero-filled, post-CMVN, training only; each
start is uniform in [0, max(1, size - width)). Each time mask is further
capped at floor(time_mask_ratio * n) frames of the true length n, computed
in float32 as JAX does (in float64 it differs by one frame for some n: at
ratio 0.7, n = 90, 170, 180, ...).

JAX draws the starts inside its jitted op from threefry or rbg keys; this
package does not reproduce those streams. `spec_augment` takes the starts as
a tensor [B, num_freq_masks + num_time_masks] (frequency masks first) and
builds every mask from index comparisons: a few launches a batch, not a
loop over utterances, and bit-exact on any device, because masking only
writes zeros. `draw_starts` draws them on the host from an explicit numpy
generator (the data module seeds one per batch from (seed, epoch, batch
index)); the tests inject JAX's draws instead.
"""

from __future__ import annotations

import numpy as np
import torch

from onebit_asr_tpu_torch.utils.config import FrontendConfig


def time_mask_widths(feat_lens: torch.Tensor, time_mask_param: int,
                     time_mask_ratio: float) -> torch.Tensor:
    """Width of every time mask of each utterance [B] (int64, on
    feat_lens' device): min(param, floor(f32(ratio) * f32(n)), n)."""
    n = feat_lens.to(torch.int64)
    ratio = torch.tensor(time_mask_ratio, dtype=torch.float32, device=n.device)
    cap = torch.floor(ratio * n.to(torch.float32)).to(torch.int64)
    return torch.minimum(torch.clamp(cap, max=time_mask_param), n)


def draw_starts(rng: np.random.Generator, feat_lens, num_mel_bins: int,
                cfg: FrontendConfig) -> np.ndarray:
    """Mask starts [B, num_freq_masks + num_time_masks] int64 from `rng`,
    each uniform in [0, max(1, size - width)) against the utterance's true
    length `feat_lens` [B] (host ints)."""
    n = torch.as_tensor(np.asarray(feat_lens, np.int64))
    B = len(n)
    f_hi = max(1, num_mel_bins - min(cfg.freq_mask_param, num_mel_bins))
    widths = time_mask_widths(n, cfg.time_mask_param, cfg.time_mask_ratio)
    t_hi = torch.clamp(n - widths, min=1).numpy()
    starts = np.empty((B, cfg.num_freq_masks + cfg.num_time_masks), np.int64)
    starts[:, : cfg.num_freq_masks] = rng.integers(0, f_hi, size=(B, cfg.num_freq_masks))
    starts[:, cfg.num_freq_masks :] = rng.integers(
        0, t_hi[:, None], size=(B, cfg.num_time_masks))
    return starts


def spec_augment(feats: torch.Tensor, feat_lens: torch.Tensor, starts: torch.Tensor,
                 freq_mask_param: int = 27, time_mask_param: int = 100,
                 num_freq_masks: int = 2, num_time_masks: int = 2,
                 time_mask_ratio: float = 0.3) -> torch.Tensor:
    """feats [B, T, F] (any float dtype), feat_lens [B], starts [B,
    num_freq_masks + num_time_masks] -> feats with every mask zeroed. All
    three on one device; the result is on it too."""
    B, T, F = feats.shape
    dev = feats.device
    starts = starts.to(dev, torch.int64)
    f_starts = starts[:, :num_freq_masks, None]  # [B, nf, 1]
    t_starts = starts[:, num_freq_masks : num_freq_masks + num_time_masks, None]
    f_width = min(freq_mask_param, F)
    t_width = time_mask_widths(feat_lens.to(dev), time_mask_param, time_mask_ratio)[:, None, None]
    f_pos = torch.arange(F, device=dev)
    t_pos = torch.arange(T, device=dev)
    f_mask = ((f_pos >= f_starts) & (f_pos < f_starts + f_width)).any(dim=1)  # [B, F]
    t_mask = ((t_pos >= t_starts) & (t_pos < t_starts + t_width)).any(dim=1)  # [B, T]
    mask = f_mask[:, None, :] | t_mask[:, :, None]
    return feats.masked_fill(mask, 0.0)


def spec_augment_from_config(feats: torch.Tensor, feat_lens: torch.Tensor,
                             starts: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    return spec_augment(feats, feat_lens, starts, freq_mask_param=cfg.freq_mask_param,
                        time_mask_param=cfg.time_mask_param,
                        num_freq_masks=cfg.num_freq_masks,
                        num_time_masks=cfg.num_time_masks,
                        time_mask_ratio=cfg.time_mask_ratio)

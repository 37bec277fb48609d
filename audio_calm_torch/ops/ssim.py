"""Structural-similarity loss on spectrograms (counterpart of
audio_calm_tpu/ops/ssim.py).

An 11-tap Gaussian window (sigma 1.5) treats the mel spectrogram as a
one-channel image; the 2-D window is separable, so each local statistic is
two 1-D convolutions (F.conv1d over each axis, zero padding 5), as the JAX
package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=4)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float64) - window_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, win: torch.Tensor, pad: int) -> torch.Tensor:
    """Separable Gaussian blur over the last two dims of [B, H, W]."""
    B, H, W = img.shape
    k = win.reshape(1, 1, -1)
    # along H: every (row of B, column) is a 1-D signal
    x = img.transpose(1, 2).reshape(B * W, 1, H)
    x = F.conv1d(x, k, padding=pad).reshape(B, W, H).transpose(1, 2)
    # along W
    x = F.conv1d(x.reshape(B * H, 1, W), k, padding=pad)
    return x.reshape(B, H, W)


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
              sigma: float = 1.5) -> torch.Tensor:
    """1 - mean(SSIM map), fp32. Inputs [B, H, W] (e.g. [B, 80, T] mel),
    or [B, 1, H, W] (channel 0)."""
    if img1.ndim == 4:
        img1, img2 = img1[:, 0], img2[:, 0]
    win = torch.as_tensor(_gaussian_window(window_size, sigma),
                          device=img1.device)
    pad = window_size // 2
    img1, img2 = img1.float(), img2.float()

    mu1 = _blur(img1, win, pad)
    mu2 = _blur(img2, win, pad)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, win, pad) - mu1_sq
    sigma2_sq = _blur(img2 * img2, win, pad) - mu2_sq
    sigma12 = _blur(img1 * img2, win, pad) - mu1_mu2

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return 1.0 - ssim_map.mean()

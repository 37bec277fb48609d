"""Acoustic VAE decoder (counterpart of audio_calm_tpu/models/vae.py).

decoder: Conv(latent->512, k3 p1) + ResBlock; per stride (reversed):
ConvTranspose(512->512, k=2s, s, p=s//2) + ResBlock; Conv(512->80, k3 p1).

With a validity mask [B, T', 1] the GroupNorm statistics cover valid frames
only and activations are re-zeroed before each conv, so a grid-padded row
decodes its valid frames exactly as the exact-length latents would. The
encoder (ASR path) is still to be ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audio_calm_torch.config import VAEModelConfig
from audio_calm_torch.models.layers import (Conv1d, ConvTranspose1d,
                                            GroupNorm, gelu)


class ResBlock(nn.Module):
    """x + [GN -> GELU -> Conv(k3 p1)] x2, masked."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(num_groups, channels)
        self.conv1 = Conv1d(channels, channels, 3, padding=1)
        self.norm2 = GroupNorm(num_groups, channels)
        self.conv2 = Conv1d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = gelu(self.norm1(x, mask))
        if mask is not None:
            h = h * mask
        h = gelu(self.norm2(self.conv1(h), mask))
        if mask is not None:
            h = h * mask
        out = x + self.conv2(h)
        return out * mask if mask is not None else out


class Decoder(nn.Module):
    def __init__(self, cfg: VAEModelConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_channels
        self.conv_in = Conv1d(cfg.latent_channels, C, 3, padding=1)
        self.res_in = ResBlock(C, cfg.norm_num_groups)
        self.strides = list(reversed(cfg.strides))
        self.up_conv = nn.ModuleList(
            ConvTranspose1d(C, C, 2 * s, stride=s, padding=s // 2)
            for s in self.strides)
        self.up_res = nn.ModuleList(ResBlock(C, cfg.norm_num_groups)
                                    for _ in self.strides)
        self.conv_out = Conv1d(C, cfg.in_channels, 3, padding=1)

    def forward(self, z: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is not None:
            mask = mask.to(z.dtype)
            z = z * mask
        x = self.conv_in(z)
        if mask is not None:
            x = x * mask
        x = self.res_in(x, mask)
        for s, up, res in zip(self.strides, self.up_conv, self.up_res):
            x = up(x)
            if mask is not None:
                mask = torch.repeat_interleave(mask, s, dim=1)
                x = x * mask
            x = res(x, mask)
        return self.conv_out(x)


class AcousticVAE(nn.Module):
    """The VAE's decode side: latents [B, T', latent] -> normalized log-mel
    [B, T' * total_stride, n_mels]."""

    def __init__(self, cfg: VAEModelConfig = VAEModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)

    def decode(self, z: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder(z, mask)


def denormalize_mel(mel_n: torch.Tensor, cfg: VAEModelConfig) -> torch.Tensor:
    return mel_n * cfg.mel_std + cfg.mel_mean

"""Acoustic VAE (counterpart of audio_calm_tpu/models/vae.py).

encoder: Conv(80->512, k3 p1); per stride s: Conv(512->512, k=2s, s, p=s//2)
+ ResBlock; GN + GELU + Conv(512->2*latent, k3 p1) -> (mu, logvar).
decoder: Conv(latent->512, k3 p1) + ResBlock; per stride (reversed):
ConvTranspose(512->512, k=2s, s, p=s//2) + ResBlock; Conv(512->80, k3 p1).

With a validity mask [B, T, 1] the GroupNorm statistics cover valid frames
only and activations are re-zeroed before each conv, so a padded row
encodes (decodes) its valid frames exactly as the exact-length tensor
would. The training losses (SSIM, multi-resolution STFT) and training-mode
sampling are still to be ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


class Encoder(nn.Module):
    def __init__(self, cfg: VAEModelConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_channels
        self.conv_in = Conv1d(cfg.in_channels, C, 3, padding=1)
        self.down_conv = nn.ModuleList(
            Conv1d(C, C, 2 * s, stride=s, padding=s // 2) for s in cfg.strides)
        self.down_res = nn.ModuleList(ResBlock(C, cfg.norm_num_groups)
                                      for _ in cfg.strides)
        self.norm_out = GroupNorm(cfg.norm_num_groups, C)
        self.conv_out = Conv1d(C, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, mel], mask [B, T, 1] of valid frames (each row's length
        a multiple of total_stride) -> (mu, logvar) [B, T / stride, latent]."""
        if mask is not None:
            mask = mask.to(x.dtype)
            x = x * mask
        x = self.conv_in(x)
        if mask is not None:
            x = x * mask
        for s, down, res in zip(self.cfg.strides, self.down_conv,
                                self.down_res):
            x = down(x)
            if mask is not None:
                mask = mask[:, ::s]
                x = x * mask
            x = res(x, mask)
        x = gelu(self.norm_out(x, mask))
        if mask is not None:
            x = x * mask
        mu, logvar = self.conv_out(x).chunk(2, dim=-1)
        return mu, logvar


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
    """normalized log-mel [B, T, n_mels] <-> latents [B, T / total_stride,
    latent]; T a multiple of total_stride (see `pad_to_stride`)."""

    def __init__(self, cfg: VAEModelConfig = VAEModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def encode(self, mel: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(mel, mask)

    def decode(self, z: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder(z, mask)

    def reparameterize(self, mu: torch.Tensor, logvar: torch.Tensor,
                       train: bool = False) -> torch.Tensor:
        """Eval mode: the mean. Training-mode sampling (noise and latent
        dropout) comes with the VAE's training step."""
        if train:
            raise NotImplementedError(
                "AcousticVAE.reparameterize(train=True) is not ported yet: "
                "ROADMAP.md Queue 1, VAE training")
        return mu


def pad_to_stride(mel: torch.Tensor, total_stride: int) -> torch.Tensor:
    """Reflect-pad the time axis of [B, T, C] to a multiple of total_stride
    (numpy's 'reflect', reference modeling_vae.py:322-327)."""
    T = mel.shape[1]
    rem = T % total_stride
    if rem == 0:
        return mel
    # reflection without the edge sample, period 2(T-1): numpy's rule, which
    # also holds when the pad is longer than the signal
    n = torch.arange(T, T + total_stride - rem, device=mel.device)
    period = max(2 * (T - 1), 1)
    m = n % period
    idx = torch.where(m < T, m, period - m)
    return torch.cat([mel, mel[:, idx]], dim=1)


def normalize_mel(mel: torch.Tensor, cfg: VAEModelConfig) -> torch.Tensor:
    return (mel - cfg.mel_mean) / cfg.mel_std


def denormalize_mel(mel_n: torch.Tensor, cfg: VAEModelConfig) -> torch.Tensor:
    return mel_n * cfg.mel_std + cfg.mel_mean

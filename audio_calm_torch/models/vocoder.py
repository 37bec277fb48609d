"""HiFi-GAN V1 generator in PyTorch (counterpart of
audio_calm_tpu/models/vocoder.py).

`HiFiGANGenerator` is the eager generator: the plain reference of the whole
generator. `HiFiGANVocoder` is the serving vocoder: its forward runs
`ops.vocoder_kernel.hifigan_apply_fused`, which on a CUDA tensor goes
through the hand-written stage kernel. Griffin-Lim is still to be ported.
"""

from __future__ import annotations

import torch
from torch import nn

from audio_calm_torch.config import HiFiGANConfig
from audio_calm_torch.models.layers import Conv1d, ConvTranspose1d
from audio_calm_torch.ops.vocoder_kernel import hifigan_apply_fused, lrelu


class ResBlock1(nn.Module):
    """HiFi-GAN V1 MRF resblock: per dilation d,
    x += Conv_k,1(LReLU(Conv_k,d(LReLU(x))))."""

    def __init__(self, channels: int, kernel_size: int, dilations, slope=0.1):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.dilations = tuple(dilations)
        self.slope = slope
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, k, padding=d * (k - 1) // 2, dilation=d)
            for d in self.dilations
        )
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, k, padding=(k - 1) // 2)
            for _ in self.dilations
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(lrelu(c1(lrelu(x, self.slope)), self.slope))
        return x


class HiFiGANGenerator(nn.Module):
    """mel [B, T, n_mels] -> waveform [B, T * total_upsample] (float32)."""

    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.in_channels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for r, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
            self.ups.append(
                ConvTranspose1d(ch, ch // 2, k, stride=r, padding=(k - r) // 2))
            ch //= 2
            self.resblocks.append(nn.ModuleList(
                ResBlock1(ch, rk, rd, cfg.lrelu_slope)
                for rk, rd in zip(cfg.resblock_kernel_sizes,
                                  cfg.resblock_dilations)
            ))
        self.conv_post = Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        slope = self.cfg.lrelu_slope
        x = self.conv_pre(mel)
        for up, blocks in zip(self.ups, self.resblocks):
            x = up(lrelu(x, slope))
            acc = None
            for blk in blocks:
                h = blk(x)
                acc = h if acc is None else acc + h
            x = acc / len(blocks)
        x = self.conv_post(lrelu(x, slope))
        return torch.tanh(x.float())[..., 0]


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """weight = g * v / ||v||, the norm over all dims but dim 0 (torch
    weight_norm default)."""
    dims = tuple(range(1, v.ndim))
    norm = torch.sqrt((v * v).sum(dim=dims, keepdim=True))
    return g * v / norm.clamp_min(1e-12)


class HiFiGANVocoder(nn.Module):
    """log-mel [B, T, n_mels] -> waveform [B, T * total_upsample].

    Runs the generator through `hifigan_apply_fused`: the stage kernel on a
    CUDA tensor, its plain version on a CPU tensor. compute_dtype is the
    stage kernels' operand dtype (accumulation stays fp32); io_dtype the
    inter-stage activation dtype (None follows the mel)."""

    def __init__(self, generator: HiFiGANGenerator,
                 compute_dtype=torch.bfloat16, io_dtype=None):
        super().__init__()
        self.generator = generator
        self.compute_dtype = compute_dtype
        self.io_dtype = io_dtype

    @property
    def cfg(self) -> HiFiGANConfig:
        return self.generator.cfg

    def forward(self, log_mel: torch.Tensor) -> torch.Tensor:
        return hifigan_apply_fused(self.generator, log_mel,
                                   compute_dtype=self.compute_dtype,
                                   io_dtype=self.io_dtype)

"""Primitive layers with the JAX package's numerics, channels-last.

Counterpart of audio_calm_tpu/models/layers.py. Every sequence tensor at a
module boundary is [B, T, C], as in the JAX package; the torch convolutions
run channels-first inside. Weights keep torch layouts: Conv1d
[C_out, C_in, k], ConvTranspose1d [C_in, C_out, k].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """nn.Linear whose weight and bias are cast at use, as flax's `dtype=`
    does: to the input's dtype, or with `promote=True` (a flax Dense with no
    `dtype`) to the promotion of the input's and the weight's dtypes. fp32
    master weights under bf16 compute then get their gradients in fp32;
    when every dtype agrees the casts are no-ops."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, promote: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.promote = promote

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = (torch.promote_types(x.dtype, self.weight.dtype) if self.promote
              else x.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Module):
    """A lookup table [num, dim] (flax nn.Embed; parameter `embedding`)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU, not the tanh approximation."""
    return F.gelu(x, approximate="none")


class Conv1d(nn.Conv1d):
    """torch.nn.Conv1d on [B, T, C_in] -> [B, T_out, C_out]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class ConvTranspose1d(nn.ConvTranspose1d):
    """torch.nn.ConvTranspose1d on [B, T, C_in]: out_len = (T-1)*s - 2p + k."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class GroupNorm(nn.Module):
    """GroupNorm over (time, channels of the group), eps 1e-6, with an
    optional validity mask [B, T, 1]: the statistics cover valid frames
    only, so a padded row normalizes exactly like the unpadded tensor."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, C = x.shape
        G = self.num_groups
        xf = x.float().reshape(B, T, G, C // G)
        if mask is None:
            m = torch.ones(B, T, 1, 1, dtype=torch.float32, device=x.device)
        else:
            m = mask.reshape(B, T, 1, 1).to(torch.float32)
        count = (m.sum(dim=1, keepdim=True) * (C // G)).clamp_min(1.0)
        mean = (xf * m).sum(dim=(1, 3), keepdim=True) / count
        var = (((xf - mean) * m) ** 2).sum(dim=(1, 3), keepdim=True) / count
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(B, T, C)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)

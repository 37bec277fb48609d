"""LoRA over a Linear projection (counterpart of
audio_calm_tpu/models/lora.py): y = x W^T + b + (alpha / r) * (x A) B.

A is [in, r] and B is [r, out], the JAX package's layout. Inference only:
no adapter dropout. int8 base weights are still to be ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LoRADense(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 rank: int = 0, alpha: float = 1.0):
        super().__init__(in_features, out_features, bias=bias)
        self.rank = rank
        if rank > 0:
            self.scaling = alpha / rank
            self.lora_a = nn.Parameter(torch.zeros(in_features, rank))
            self.lora_b = nn.Parameter(torch.zeros(rank, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight, self.bias)
        if self.rank > 0:
            y = y + self.scaling * ((x @ self.lora_a) @ self.lora_b)
        return y

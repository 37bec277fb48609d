"""CALM heads on the TTS path: the DiT flow head and the predictor MLPs
(counterpart of audio_calm_tpu/models/calm_heads.py).

All sequence tensors [B, T, C]. Key-padding masks are True at PAD, as in
the JAX package. Each module computes in the dtype of its weights (fp32 in
the parity tests, bf16 when serving) and keeps the JAX package's fp32
islands: the sinusoidal embeddings and the softmax.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_calm_torch.models.layers import gelu
from audio_calm_torch.ops.attention import MultiheadAttention


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Continuous-time sinusoidal embedding, t [B] in [0, 1] -> [B, dim]
    fp32: freqs = exp(arange(half) * -ln(10000)/(half-1)); cat(sin, cos)."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * (-math.log(10000.0) / (half - 1)))
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_position_table(max_len: int, dim: int) -> np.ndarray:
    """[max_len, dim] interleaved sin/cos position table with
    div = exp(arange(0, dim, 2) * -ln(10000)/dim), built in float64."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64)
                 * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


class TimeMLP(nn.Module):
    """SinusoidalPosEmb -> Linear -> SiLU -> Linear."""

    def __init__(self, time_dim: int = 256):
        super().__init__()
        self.time_dim = time_dim
        self.fc1 = nn.Linear(time_dim, time_dim)
        self.fc2 = nn.Linear(time_dim, time_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        e = timestep_embedding(t, self.time_dim).to(self.fc1.weight.dtype)
        return self.fc2(F.silu(self.fc1(e)))


class AdaLN(nn.Module):
    """norm(x) * (1 + scale(t)) + shift(t); LayerNorm eps 1e-6, no affine."""

    def __init__(self, dim: int, time_dim: int = 256):
        super().__init__()
        self.dim = dim
        self.emb = nn.Linear(time_dim, 2 * dim)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.emb(F.silu(t_emb)).chunk(2, dim=-1)
        x = F.layer_norm(x, (self.dim,), eps=1e-6)
        return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class DiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, time_dim: int = 256,
                 mlp_ratio: float = 4.0, cross: bool = True):
        super().__init__()
        self.adaLN1 = AdaLN(dim, time_dim)
        self.attn = MultiheadAttention(dim, num_heads)
        if cross:
            self.adaLN_ctx = AdaLN(dim, time_dim)
            self.ctx_attn = MultiheadAttention(dim, num_heads)
            self.ctx_gate = nn.Parameter(torch.zeros(1))
        self.adaLN2 = AdaLN(dim, time_dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x, t_emb, context=None, context_mask=None, x_mask=None):
        h = self.adaLN1(x, t_emb)
        x = x + self.attn(h, h, h, key_padding_mask=x_mask)
        if context is not None:
            h = self.adaLN_ctx(x, t_emb)
            out = self.ctx_attn(h, context, context,
                                key_padding_mask=context_mask)
            x = x + torch.sigmoid(self.ctx_gate.to(x.dtype)) * out
        h = self.adaLN2(x, t_emb)
        return x + self.mlp_fc2(gelu(self.mlp_fc1(h)))


class TransformerFlowHead(nn.Module):
    """DiT velocity field v(x_t, t | condition, context)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int = 1024,
                 num_layers: int = 6, num_heads: int = 16,
                 context_dim: Optional[int] = None, time_dim: int = 256,
                 max_seq_len: int = 2048):
        super().__init__()
        self.time_mlp = TimeMLP(time_dim)
        self.in_proj = nn.Linear(input_dim + output_dim, hidden_dim)
        self.register_buffer(
            "pos_table",
            torch.tensor(sinusoidal_position_table(max_seq_len, hidden_dim)),
            persistent=False)
        self.context_proj = (nn.Linear(context_dim, hidden_dim)
                             if context_dim is not None else None)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_dim, num_heads, time_dim,
                     cross=context_dim is not None)
            for _ in range(num_layers))
        self.final_adaLN = AdaLN(hidden_dim, time_dim)
        self.out_proj = nn.Linear(hidden_dim, output_dim)

    def forward(self, condition, noisy_x, t, context=None, context_mask=None,
                x_mask=None):
        T = noisy_x.shape[1]
        t_emb = self.time_mlp(t)
        x = self.in_proj(torch.cat([condition, noisy_x], dim=-1))
        x = x + self.pos_table[None, :T, :].to(x.dtype)
        proj_context = None
        if context is not None and self.context_proj is not None:
            proj_context = self.context_proj(context)
        for blk in self.blocks:
            x = blk(x, t_emb, proj_context, context_mask, x_mask)
        return self.out_proj(self.final_adaLN(x, t_emb))


class PredictorMLP(nn.Module):
    """Linear(d -> hidden) -> GELU -> Linear(hidden -> 1), squeezed."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))[..., 0]

"""CALM heads on the TTS path: the DiT flow head, the predictor MLPs and
the audio input projector, and the legacy dilated-ResNet flow head of
pre-DiT checkpoints (counterpart of audio_calm_tpu/models/calm_heads.py).

All sequence tensors [B, T, C]. Key-padding masks are True at PAD, as in
the JAX package. Each module computes in the dtype of its input and casts
its weights at use, as flax's `dtype=` does (layers.Linear); the layers
that JAX builds without a `dtype` (the predictors, the flow head's
out_proj) compute in the promotion of the input's and the weight's dtypes.
The JAX package's fp32 islands stay: the sinusoidal embeddings and the
softmax. `train=True` turns on the DiT attention dropout (masks from the
step's seed, ops/dropout.py).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_calm_torch.models.layers import Conv1d, GroupNorm, Linear, gelu
from audio_calm_torch.ops.attention import MultiheadAttention


class CausalConv1d(nn.Conv1d):
    """Left-padded conv over [B, T, C_in] -> [B, T, C_out] (k - 1 zeros
    before the first frame), weights cast to the input's dtype at use."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        super().__init__(in_channels, out_channels, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.transpose(1, 2), (self.kernel_size[0] - 1, 0))
        y = F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
        return y.transpose(1, 2)


class AudioInputProjector(nn.Module):
    """VAE latents [B, T, latent_dim] -> LLM space [B, T, llm_dim]: two
    causal convs (k=3) with GELU between, two residual MLP blocks, a post
    LayerNorm (eps 1e-6). Without RoPE, as the model builds it
    (use_rope=False in JAX)."""

    def __init__(self, latent_dim: int, llm_dim: int):
        super().__init__()
        self.conv1 = CausalConv1d(latent_dim, llm_dim, 3)
        self.conv2 = CausalConv1d(llm_dim, llm_dim, 3)
        for i in range(2):
            setattr(self, f"block{i}_ln", nn.LayerNorm(llm_dim, eps=1e-6))
            setattr(self, f"block{i}_fc1", Linear(llm_dim, 2 * llm_dim))
            setattr(self, f"block{i}_fc2", Linear(2 * llm_dim, llm_dim))
        self.post_norm = nn.LayerNorm(llm_dim, eps=1e-6)

    @staticmethod
    def _ln(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                            ln.bias.to(x.dtype), ln.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2(gelu(self.conv1(x)))
        for i in range(2):
            h = self._ln(getattr(self, f"block{i}_ln"), x)
            h = getattr(self, f"block{i}_fc1")(h)
            x = x + getattr(self, f"block{i}_fc2")(gelu(h))
        return self._ln(self.post_norm, x)


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
        self.fc1 = Linear(time_dim, time_dim)
        self.fc2 = Linear(time_dim, time_dim)

    def forward(self, t: torch.Tensor, dtype=None) -> torch.Tensor:
        """t [B] -> [B, time_dim] in `dtype` (default: the weights')."""
        e = timestep_embedding(t, self.time_dim).to(
            dtype or self.fc1.weight.dtype)
        return self.fc2(F.silu(self.fc1(e)))


class AdaLN(nn.Module):
    """norm(x) * (1 + scale(t)) + shift(t); LayerNorm eps 1e-6, no affine."""

    def __init__(self, dim: int, time_dim: int = 256):
        super().__init__()
        self.dim = dim
        self.emb = Linear(time_dim, 2 * dim)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.emb(F.silu(t_emb)).chunk(2, dim=-1)
        x = F.layer_norm(x, (self.dim,), eps=1e-6)
        return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class DiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, time_dim: int = 256,
                 mlp_ratio: float = 4.0, cross: bool = True,
                 dropout: float = 0.1):
        super().__init__()
        self.adaLN1 = AdaLN(dim, time_dim)
        self.attn = MultiheadAttention(dim, num_heads, dropout)
        if cross:
            self.adaLN_ctx = AdaLN(dim, time_dim)
            self.ctx_attn = MultiheadAttention(dim, num_heads, dropout)
            self.ctx_gate = nn.Parameter(torch.zeros(1))
        self.adaLN2 = AdaLN(dim, time_dim)
        self.mlp_fc1 = Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Linear(int(dim * mlp_ratio), dim)

    def forward(self, x, t_emb, context=None, context_mask=None, x_mask=None,
                train: bool = False, seed: int = 0):
        h = self.adaLN1(x, t_emb)
        x = x + self.attn(h, h, h, key_padding_mask=x_mask, train=train,
                          seed=seed)
        if context is not None:
            h = self.adaLN_ctx(x, t_emb)
            out = self.ctx_attn(h, context, context,
                                key_padding_mask=context_mask, train=train,
                                seed=seed)
            x = x + torch.sigmoid(self.ctx_gate.to(x.dtype)) * out
        h = self.adaLN2(x, t_emb)
        return x + self.mlp_fc2(gelu(self.mlp_fc1(h)))


class TransformerFlowHead(nn.Module):
    """DiT velocity field v(x_t, t | condition, context)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int = 1024,
                 num_layers: int = 6, num_heads: int = 16,
                 context_dim: Optional[int] = None, time_dim: int = 256,
                 max_seq_len: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.time_mlp = TimeMLP(time_dim)
        self.in_proj = Linear(input_dim + output_dim, hidden_dim)
        self.register_buffer(
            "pos_table",
            torch.tensor(sinusoidal_position_table(max_seq_len, hidden_dim)),
            persistent=False)
        self.context_proj = (Linear(context_dim, hidden_dim)
                             if context_dim is not None else None)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_dim, num_heads, time_dim,
                     cross=context_dim is not None, dropout=dropout)
            for _ in range(num_layers))
        self.final_adaLN = AdaLN(hidden_dim, time_dim)
        self.out_proj = Linear(hidden_dim, output_dim, promote=True)

    def forward(self, condition, noisy_x, t, context=None, context_mask=None,
                x_mask=None, train: bool = False, seed: int = 0):
        T = noisy_x.shape[1]
        t_emb = self.time_mlp(t, noisy_x.dtype)
        x = self.in_proj(torch.cat([condition, noisy_x], dim=-1))
        x = x + self.pos_table[None, :T, :].to(x.dtype)
        proj_context = None
        if context is not None and self.context_proj is not None:
            proj_context = self.context_proj(context)
        for blk in self.blocks:
            x = blk(x, t_emb, proj_context, context_mask, x_mask, train, seed)
        return self.out_proj(self.final_adaLN(x, t_emb))


class FlowMatchingHead(nn.Module):
    """Legacy dilated-ResNet flow head (reference modeling_calm.py:100-168),
    the module a pre-DiT checkpoint converts into
    (convert.convert_legacy_flow_head); QwenCALM's heads are DiTs. The time
    embedding per position (t [B] broadcast over frames, or t [B, T]), a
    k3 in_proj over [condition | noisy_x | t_emb], N residual blocks
    (SiLU, k3 conv with dilation 2^i, SiLU, k1 conv), GroupNorm(8, eps
    1e-5), SiLU and a zero-initialised k3 out conv. condition_mask [B]
    zeroes whole rows of the input."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int = 1024,
                 num_layers: int = 6, time_dim: int = 256):
        super().__init__()
        self.time_dim = time_dim
        self.num_layers = num_layers
        self.time_fc1 = Linear(time_dim, time_dim)
        self.time_fc2 = Linear(time_dim, time_dim)
        self.in_proj = Conv1d(input_dim + output_dim + time_dim, hidden_dim, 3,
                              padding=1)
        for i in range(num_layers):
            d = 2 ** i
            setattr(self, f"res{i}_conv1", Conv1d(hidden_dim, hidden_dim, 3,
                                                  padding=d, dilation=d))
            setattr(self, f"res{i}_conv2", Conv1d(hidden_dim, hidden_dim, 1))
        self.out_norm = GroupNorm(8, hidden_dim, eps=1e-5)
        self.out_proj = Conv1d(hidden_dim, output_dim, 3, padding=1)
        nn.init.zeros_(self.out_proj.weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, condition, noisy_x, t, condition_mask=None):
        B, T, _ = condition.shape
        if t.ndim == 1:
            t = t[:, None].expand(B, T)
        e = timestep_embedding(t.reshape(-1), self.time_dim)
        t_emb = self.time_fc2(F.silu(self.time_fc1(e))).reshape(B, T, -1)
        x = torch.cat([condition, noisy_x, t_emb.to(condition.dtype)], dim=-1)
        if condition_mask is not None:
            x = x * condition_mask.reshape(-1, 1, 1).to(x.dtype)
        x = self.in_proj(x)
        for i in range(self.num_layers):
            h = getattr(self, f"res{i}_conv1")(F.silu(x))
            x = x + getattr(self, f"res{i}_conv2")(F.silu(h))
        return self.out_proj(F.silu(self.out_norm(x)))


class PredictorMLP(nn.Module):
    """Linear(d -> hidden) -> GELU -> Linear(hidden -> 1), squeezed."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden, promote=True)
        self.fc2 = Linear(hidden, 1, promote=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))[..., 0]

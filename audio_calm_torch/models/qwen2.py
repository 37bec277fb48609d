"""Qwen2 decoder backbone in PyTorch (counterpart of
audio_calm_tpu/models/qwen2.py).

fp32 RMSNorm (eps 1e-6), half-split RoPE, GQA attention with QKV bias
through `attention_fwd` (causal + key-valid mask: the CUDA kernel on the
card), SwiGLU MLP, LoRA on the targeted projections. Only hidden states are
computed. The `segment_ids` packing path is still to be ported (training).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audio_calm_torch.config import LoRAConfig, Qwen2Config
from audio_calm_torch.models.lora import LoRADense
from audio_calm_torch.ops.attention_kernel import attention_fwd


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def make_rope_cache(positions: torch.Tensor, head_dim: int,
                    theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, T] -> (cos, sin) each [B, T, head_dim], fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, hd]; cos/sin [B, T, hd] (HF rotate_half convention)."""
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rot * s


def _proj(lora: Optional[LoRAConfig], name: str, d_in: int, d_out: int,
          bias: bool) -> LoRADense:
    if lora is not None and lora.enabled and name in lora.target_modules:
        return LoRADense(d_in, d_out, bias=bias, rank=lora.rank,
                         alpha=lora.alpha)
    return LoRADense(d_in, d_out, bias=bias)


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config, lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.cfg = cfg
        hd, D = cfg.head_dim, cfg.hidden_size
        self.q_proj = _proj(lora, "q_proj", D, cfg.num_attention_heads * hd,
                            True)
        self.k_proj = _proj(lora, "k_proj", D, cfg.num_key_value_heads * hd,
                            True)
        self.v_proj = _proj(lora, "v_proj", D, cfg.num_key_value_heads * hd,
                            True)
        self.o_proj = _proj(lora, "o_proj", cfg.num_attention_heads * hd, D,
                            False)

    def forward(self, x, cos, sin, key_valid):
        c = self.cfg
        B, T, _ = x.shape
        q = self.q_proj(x).reshape(B, T, c.num_attention_heads, c.head_dim)
        k = self.k_proj(x).reshape(B, T, c.num_key_value_heads, c.head_dim)
        v = self.v_proj(x).reshape(B, T, c.num_key_value_heads, c.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = attention_fwd(q, k, v, key_valid=key_valid, causal=True)
        return self.o_proj(out.reshape(B, T, -1))


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config, lora: Optional[LoRAConfig] = None):
        super().__init__()
        D, F_ = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _proj(lora, "gate_proj", D, F_, False)
        self.up_proj = _proj(lora, "up_proj", D, F_, False)
        self.down_proj = _proj(lora, "down_proj", F_, D, False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Qwen2Block(nn.Module):
    def __init__(self, cfg: Qwen2Config, lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Qwen2Attention(cfg, lora)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = Qwen2MLP(cfg, lora)

    def forward(self, x, cos, sin, key_valid):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, key_valid)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2Model(nn.Module):
    """Decoder stack -> final-norm hidden states [B, T, hidden], computed in
    the dtype of the weights."""

    def __init__(self, cfg: Qwen2Config, lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(Qwen2Block(cfg, lora)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, inputs_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        B, T, _ = inputs_embeds.shape
        x = inputs_embeds.to(self.norm.weight.dtype)
        if attention_mask is None:
            attention_mask = torch.ones(B, T, dtype=torch.int32,
                                        device=x.device)
        if position_ids is None:
            position_ids = (attention_mask.long().cumsum(-1) - 1).clamp_min(0)
        cos, sin = make_rope_cache(position_ids, c.head_dim, c.rope_theta)
        key_valid = attention_mask != 0  # once for all layers
        for layer in self.layers:
            x = layer(x, cos, sin, key_valid)
        return self.norm(x)


class Qwen2Embed(nn.Module):
    """Token embedding table."""

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size, cfg.hidden_size))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(input_ids, self.embedding)

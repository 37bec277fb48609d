"""Qwen2 decoder backbone in PyTorch (counterpart of
audio_calm_tpu/models/qwen2.py).

fp32 RMSNorm (eps 1e-6), half-split RoPE, GQA attention with QKV bias and
a causal + key-valid mask, SwiGLU MLP, LoRA on the targeted projections.
Only hidden states are computed, in the dtype of the input embeddings
(weights are cast at use). The attention goes through `attention_fwd` (K4 on
the card) when no gradient is needed and through `flash_attention` (K4
forward, K5 backward) when autograd records. `train=True` turns on the LoRA
adapter dropout. `remat_policy="full"` recomputes each block in the
backward (`torch.utils.checkpoint`, non-reentrant); "dots" (JAX's
`checkpoint_dots`) keeps the outputs of the block's matrix products and
recomputes the rest (selective checkpointing; the hand-written attention,
a ctypes launch no dispatch mode sees, is recomputed as under "full");
"none" keeps every activation.

Packed rows (`segment_ids`, several sequences in one row, segment 0 =
padding): the mask is causal, key-valid and block-diagonal, and the
attention takes the plain differentiable route (`masked_attention`: the
float32-min mask and an fp32 softmax), as JAX sends such rows to XLA; the
kernels know key validity only. The route follows from the arguments, the
same on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from audio_calm_torch.config import LoRAConfig, Qwen2Config
from audio_calm_torch.models.layers import Embed
from audio_calm_torch.models.lora import LoRADense
from audio_calm_torch.ops.attention_kernel import attention_fwd, flash_attention

REMAT_POLICIES = ("full", "dots", "none")
_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The "dots" policy: keep every matrix product's output."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


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
                         alpha=lora.alpha, lora_dropout=lora.dropout)
    return LoRADense(d_in, d_out, bias=bias)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """JAX's XLA attention (`sdpa` in audio_calm_tpu/models/qwen2.py), plain
    and differentiable: q [B, T, Hq, d], k/v [B, S, Hkv, d] (GQA), mask
    [B, 1, T, S] (True = attend). Scores in fp32, masked to float32 min, an
    fp32 softmax, the probabilities cast to v's dtype, P V summed in fp32,
    the output in q's dtype."""
    d = q.shape[-1]
    group = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), kf) / math.sqrt(d)
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    return torch.einsum("bhts,bshd->bthd", probs, vf).to(q.dtype)


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

    def forward(self, x, cos, sin, key_valid, train: bool = False,
                seed: int = 0, mask: Optional[torch.Tensor] = None):
        """mask [B, 1, T, T] (packed rows) selects `masked_attention`;
        without it the fused causal attention over `key_valid`."""
        c = self.cfg
        B, T, _ = x.shape
        q = self.q_proj(x, train, seed).reshape(B, T, c.num_attention_heads,
                                                c.head_dim)
        k = self.k_proj(x, train, seed).reshape(B, T, c.num_key_value_heads,
                                                c.head_dim)
        v = self.v_proj(x, train, seed).reshape(B, T, c.num_key_value_heads,
                                                c.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if mask is not None:
            out = masked_attention(q, k, v, mask)
        else:
            attend = (flash_attention if torch.is_grad_enabled()
                      else attention_fwd)
            out = attend(q, k, v, key_valid, True)
        return self.o_proj(out.reshape(B, T, -1), train, seed)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config, lora: Optional[LoRAConfig] = None):
        super().__init__()
        D, F_ = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _proj(lora, "gate_proj", D, F_, False)
        self.up_proj = _proj(lora, "up_proj", D, F_, False)
        self.down_proj = _proj(lora, "down_proj", F_, D, False)

    def forward(self, x, train: bool = False, seed: int = 0):
        h = F.silu(self.gate_proj(x, train, seed)) * self.up_proj(x, train, seed)
        return self.down_proj(h, train, seed)


class Qwen2Block(nn.Module):
    def __init__(self, cfg: Qwen2Config, lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Qwen2Attention(cfg, lora)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = Qwen2MLP(cfg, lora)

    def forward(self, x, cos, sin, key_valid, train: bool = False,
                seed: int = 0, mask: Optional[torch.Tensor] = None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, key_valid,
                               train, seed, mask)
        return x + self.mlp(self.post_attention_layernorm(x), train, seed)


class Qwen2Model(nn.Module):
    """Decoder stack -> final-norm hidden states [B, T, hidden], computed in
    the dtype of `inputs_embeds`."""

    def __init__(self, cfg: Qwen2Config, lora: Optional[LoRAConfig] = None,
                 remat_policy: str = "none"):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; "
                             f"expected one of {REMAT_POLICIES}")
        self.cfg = cfg
        self.remat_policy = remat_policy
        self.layers = nn.ModuleList(Qwen2Block(cfg, lora)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, inputs_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                train: bool = False, seed: int = 0,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """segment_ids [B, T] (packed rows; 0 = padding): a token attends
        only within its own segment, through `masked_attention`."""
        c = self.cfg
        B, T, _ = inputs_embeds.shape
        x = inputs_embeds
        if attention_mask is None:
            attention_mask = torch.ones(B, T, dtype=torch.int32,
                                        device=x.device)
        if position_ids is None:
            position_ids = (attention_mask.long().cumsum(-1) - 1).clamp_min(0)
        cos, sin = make_rope_cache(position_ids, c.head_dim, c.rope_theta)
        key_valid = attention_mask != 0  # once for all layers
        mask = None
        if segment_ids is not None:
            causal = torch.ones(T, T, dtype=torch.bool,
                                device=x.device).tril()
            mask = (causal[None, None] & key_valid[:, None, None, :]
                    & (segment_ids[:, None, :, None]
                       == segment_ids[:, None, None, :]))
        remat = self.remat_policy != "none" and torch.is_grad_enabled()
        kw = {}
        if self.remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)
        for layer in self.layers:
            if remat:
                # dropout masks come from (seed, site), not the global RNG,
                # so the recomputation needs no RNG state restored
                x = checkpoint(layer, x, cos, sin, key_valid, train, seed,
                               mask, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = layer(x, cos, sin, key_valid, train, seed, mask)
        return self.norm(x)


class Qwen2Embed(Embed):
    """Token embedding table."""

    def __init__(self, cfg: Qwen2Config):
        super().__init__(cfg.vocab_size, cfg.hidden_size)

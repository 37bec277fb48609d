"""Multi-head attention with torch.nn.MultiheadAttention semantics
(counterpart of audio_calm_tpu/ops/attention.py).

Separate q/k/v/out projections; `key_padding_mask` is True at PAD keys;
scale 1/sqrt(head_dim); fp32 softmax. Two routes, as in JAX:
  - no probability dropout (inference, or training with the rate at 0):
    the fused attention, `attention_fwd` (K3) when no gradient is needed
    and the differentiable `flash_attention` (K3 forward, K5 backward) when
    autograd records; CUDA kernels on the card, their plain versions on
    the CPU;
  - training with probability dropout: JAX computes the attention outside
    any Pallas kernel (its XLA path: float32-min mask, fp32 softmax,
    dropout, probabilities cast to v's dtype). The port does the same in
    plain differentiable torch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from audio_calm_torch.models.layers import Linear
from audio_calm_torch.ops.attention_kernel import (attention_fwd,
                                                   flash_attention)
from audio_calm_torch.ops.dropout import derive_seed, dropout


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.dropout_site = 0
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                train: bool = False, seed: int = 0) -> torch.Tensor:
        B, Tq, E = query.shape
        Tk = key.shape[1]
        H = self.num_heads
        q = self.q_proj(query).reshape(B, Tq, H, E // H)
        k = self.k_proj(key).reshape(B, Tk, H, E // H)
        v = self.v_proj(value).reshape(B, Tk, H, E // H)
        if train and self.dropout > 0:
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  k.float()) / math.sqrt(E // H)
            if key_padding_mask is not None:
                scores = scores.masked_fill(
                    key_padding_mask[:, None, None, :].bool(),
                    torch.finfo(torch.float32).min)
            probs = dropout(torch.softmax(scores, dim=-1), self.dropout,
                            derive_seed(seed, self.dropout_site))
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                               v.float()).to(q.dtype)
        else:
            key_valid = None if key_padding_mask is None else ~key_padding_mask
            attend = (flash_attention if torch.is_grad_enabled()
                      else attention_fwd)
            out = attend(q, k, v, key_valid)
        return self.out_proj(out.reshape(B, Tq, E))

"""Multi-head attention with torch.nn.MultiheadAttention semantics
(counterpart of audio_calm_tpu/ops/attention.py).

Separate q/k/v/out projections; `key_padding_mask` is True at PAD keys;
scale 1/sqrt(head_dim); fp32 softmax. The core goes through
`attention_fwd`: the CUDA kernel on the card, its plain version on the CPU.
Inference only (no attention dropout).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audio_calm_torch.ops.attention_kernel import attention_fwd


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        B, Tq, E = query.shape
        Tk = key.shape[1]
        H = self.num_heads
        q = self.q_proj(query).reshape(B, Tq, H, E // H)
        k = self.k_proj(key).reshape(B, Tk, H, E // H)
        v = self.v_proj(value).reshape(B, Tk, H, E // H)
        key_valid = None if key_padding_mask is None else ~key_padding_mask
        out = attention_fwd(q, k, v, key_valid=key_valid)
        return self.out_proj(out.reshape(B, Tq, E))

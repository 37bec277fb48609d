"""LoRA over a Linear projection (counterpart of
audio_calm_tpu/models/lora.py): y = x W^T + b + (alpha / r) * (drop(x) A) B.

A is [in, r] and B is [r, out], the JAX package's layout. In train mode the
adapter's input goes through dropout (rate `lora_dropout`, the mask fixed by
the step's seed and this module's dropout site, ops/dropout.py); the base
projection sees x as it is. Parameters are cast to the input's dtype at use
(layers.Linear), so fp32 adapter masters train under bf16 compute.

Weight-only int8 serving (models/quant.quantize_llm_int8) turns the base
weight into an int8 [out, in] tensor with an fp32 `kernel_scale` buffer
[out]; the forward dequantizes it in the compute dtype, as JAX's
`q.astype(dt) * scale.astype(dt)` (one elementwise op here: int8 times a
dt tensor promotes to dt, the same values, as |q| <= 127 is exact in
bf16), then multiplies. The adapter and the bias stay as they are.

With `batch_invariant` on (layers.batch_invariant_), the base product and
both adapter products are ops/gemm_kernel.linear.
"""

from __future__ import annotations

import torch

from audio_calm_torch.models.layers import Linear, product
from audio_calm_torch.ops.dropout import derive_seed, dropout


def base_product(mod: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x W^T + b of a projection `mod` (its weight, bias, int8
    `kernel_scale` and `batch_invariant` switch), in x's dtype."""
    dt = x.dtype
    w = mod.weight
    w = w * mod.kernel_scale.to(dt)[:, None] if w.dtype == torch.int8 \
        else w.to(dt)
    return product(mod, x, w, None if mod.bias is None else mod.bias.to(dt))


def lora_delta(mod: torch.nn.Module, x: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, site: int, train: bool, seed: int,
               cols=(0, 1)) -> torch.Tensor:
    """(alpha / r) (drop(x) a) b for the adapter settings of `mod`
    (`scaling`, `lora_dropout`) with the mask of dropout site `site`; cols
    (j, n): x is shard j of n's columns of the input, and so is its mask
    (ops/dropout.draw)."""
    xa = x
    if train:
        xa = dropout(x, mod.lora_dropout, derive_seed(seed, site), cols)
    h = product(mod, xa, a.to(x.dtype), kn=True)
    return mod.scaling * product(mod, h, b.to(x.dtype), kn=True)


class LoRADense(Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 rank: int = 0, alpha: float = 1.0, lora_dropout: float = 0.0):
        super().__init__(in_features, out_features, bias=bias)
        self.rank = rank
        if rank > 0:
            self.scaling = alpha / rank
            self.lora_dropout = lora_dropout
            self.dropout_site = 0
            self.lora_a = torch.nn.Parameter(torch.zeros(in_features, rank))
            self.lora_b = torch.nn.Parameter(torch.zeros(rank, out_features))

    def forward(self, x: torch.Tensor, train: bool = False,
                seed: int = 0) -> torch.Tensor:
        y = base_product(self, x)
        if self.rank > 0:
            y = y + lora_delta(self, x, self.lora_a, self.lora_b,
                               self.dropout_site, train, seed)
        return y

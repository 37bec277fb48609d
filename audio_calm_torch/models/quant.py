"""Weight-only int8 for the frozen LLM backbone in serving (the port's copy
of the JAX package's models/quant.py).

The seven base projections of every Qwen2 block (`_PROJ_NAMES`) become
int8 [out, in] with one fp32 scale per output channel (symmetric absmax:
scale = absmax / 127, 1.0 where absmax is 0; round half to even, clip to
+-127); LoRA A/B, norms, biases and the embedding table keep their dtype.
The server casts to its compute dtype first and quantizes after, so the
scales come from the cast weights taken to fp32 (scripts/serve.py's
order). models/lora.LoRADense dequantizes in the compute dtype before its
product, plain torch: the weight is read as int8, written and read again
in the compute dtype, so the bytes moved grow against bf16 (a fused
weight-only int8 GEMM is a later item).

Opt-in: AUDIO_CALM_LLM_WEIGHTS=int8 in the server
(`maybe_quantize_from_env`), or `quantize_llm_int8(model)` directly.
"""

from __future__ import annotations

import os
import sys
from typing import Iterator, Tuple

import torch
from torch import nn

from audio_calm_torch.models.lora import LoRADense

# the frozen base projections worth quantizing (LoRA a/b stay as they are)
_PROJ_NAMES = frozenset(
    ["q_proj", "k_proj", "v_proj", "o_proj",
     "gate_proj", "up_proj", "down_proj"])


def _projections(model: nn.Module) -> Iterator[Tuple[str, LoRADense]]:
    """The seven projections of every block under `model.llm` (or under
    `model` itself when it is the backbone)."""
    root = getattr(model, "llm", model)
    for name, mod in root.named_modules():
        if isinstance(mod, LoRADense) and name.rsplit(".", 1)[-1] in \
                _PROJ_NAMES:
            yield name, mod


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float -> (int8 [out, in], fp32 scale [out]): symmetric
    per-output-channel absmax."""
    w = w.float()
    absmax = w.abs().amax(dim=1)
    # JAX divides by 127 inside jit, which XLA folds into a product with
    # the fp32 reciprocal: the same product gives its scales bit for bit
    scale = torch.where(absmax > 0, absmax * (1.0 / 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


@torch.no_grad()
def quantize_llm_int8(model: nn.Module) -> int:
    """Quantize the LLM's seven base projections in place -> how many
    projections were quantized (those already int8 are left)."""
    n = 0
    for _, mod in _projections(model):
        if mod.weight.dtype == torch.int8:
            continue
        q, scale = quantize_weight(mod.weight)
        mod.weight = nn.Parameter(q, requires_grad=False)
        mod.register_buffer("kernel_scale", scale)
        n += 1
    return n


def quantized_bytes_saved(model: nn.Module) -> int:
    """Device bytes the int8 projections save against fp32 storage: 3 a
    parameter (the scales are left out), the JAX package's definition."""
    return sum(3 * mod.weight.numel() for _, mod in _projections(model))


def maybe_quantize_from_env(model: nn.Module) -> nn.Module:
    """AUDIO_CALM_LLM_WEIGHTS=int8 -> `quantize_llm_int8(model)`, else the
    model as it is; returns the model."""
    if os.environ.get("AUDIO_CALM_LLM_WEIGHTS", "") != "int8":
        return model
    n = quantize_llm_int8(model)
    print(f"LLM weights quantized to int8: {n} projections "
          f"({quantized_bytes_saved(model) / 1e9:.2f} GB saved vs fp32)",
          file=sys.stderr)
    return model

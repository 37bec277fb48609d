"""Dropout whose mask is fixed by an integer seed.

Training recomputes each checkpointed Qwen2 block in the backward
(`torch.utils.checkpoint`), and the recomputation must draw the same masks
as the forward. `torch.utils.checkpoint` restores the global RNG, not an
explicit generator, so every dropout site here draws its mask from a fresh
generator seeded by `derive_seed(seed, site)`: `seed` is fixed per (step,
microbatch slice) by the train step and `site` is the module's own index in
the model (`assign_dropout_sites`). Same seed, same masks, however often a
block runs.
"""

from __future__ import annotations

import torch
from torch import nn

_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer: a well-spread 64-bit hash of x."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def derive_seed(*parts: int) -> int:
    """A 63-bit seed from a sequence of integers (seed, step, slice, ...)."""
    h = 0
    for p in parts:
        h = _mix(h ^ (int(p) & _M64))
    return h & ((1 << 63) - 1)


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """flax nn.Dropout semantics: keep with probability 1 - rate, scale the
    kept values by 1 / (1 - rate); the mask comes from `seed` alone."""
    if rate <= 0.0:
        return x
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def assign_dropout_sites(model: nn.Module) -> int:
    """Number every module with a `dropout_site` attribute in module order
    -> the number of sites."""
    n = 0
    for m in model.modules():
        if hasattr(m, "dropout_site"):
            m.dropout_site = n
            n += 1
    return n

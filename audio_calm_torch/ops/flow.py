"""Rectified-flow matching loss with classifier-free-guidance dropout
(counterpart of audio_calm_tpu/ops/flow.py).

t ~ U(0, 1) per sample, x_t = (1 - t) x0 + t x1 with x0 ~ N(0, I) drawn in
the target's dtype, target velocity v = x1 - x0, masked MSE on the head's
predicted velocity. In train mode, with probability `cfg_dropout_prob` per
sample, the condition and the cross-attention context are zeroed.

Draws come from an explicit `torch.Generator` in JAX's order (drop, t, x0);
`t`, `x0` and `drop` may be passed in instead, so that a test can feed both
packages the same numbers. Under ops/dropout.row_shard the draws are a
data-parallel rank's rows of the global batch's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from audio_calm_torch.ops.dropout import draw


def compute_flow_loss(
    head_fn: Callable,
    generator: Optional[torch.Generator],
    condition: torch.Tensor,  # [B, T, C_cond]
    target: torch.Tensor,  # [B, T, D]
    mask: torch.Tensor,  # [B, T] True = valid
    cfg_dropout_prob: float = 0.0,
    context: Optional[torch.Tensor] = None,
    context_mask: Optional[torch.Tensor] = None,  # True = PAD
    x_mask: Optional[torch.Tensor] = None,  # True = PAD (default ~mask)
    train: bool = True,
    t: Optional[torch.Tensor] = None,  # [B] fp32
    x0: Optional[torch.Tensor] = None,  # [B, T, D]
    drop: Optional[torch.Tensor] = None,  # [B] bool
) -> torch.Tensor:
    """head_fn(condition, noisy_x, t, context, context_mask, x_mask) -> v."""
    B = target.shape[0]
    dev = target.device
    mask = mask.bool()
    if x_mask is None:
        x_mask = ~mask
    if train and cfg_dropout_prob > 0:
        if drop is None:
            drop = draw(torch.rand, (B,), generator=generator,
                        device=dev) < cfg_dropout_prob
        keep = ~drop.to(dev)[:, None, None]
        condition = torch.where(keep, condition, 0.0)
        if context is not None:
            context = torch.where(keep, context, 0.0)
    if t is None:
        t = draw(torch.rand, (B,), generator=generator, device=dev)
    if x0 is None:
        x0 = draw(torch.randn, target.shape, generator=generator,
                  device=dev, dtype=target.dtype)
    t, x0 = t.to(dev, torch.float32), x0.to(dev, target.dtype)
    tb = t.to(target.dtype)[:, None, None]
    xt = (1.0 - tb) * x0 + tb * target
    target_v = target - x0
    pred_v = head_fn(condition, xt, t, context, context_mask, x_mask)
    err = (pred_v.float() - target_v.float()) ** 2
    m = mask.float()
    return (err.mean(dim=-1) * m).sum() / m.sum().clamp_min(1.0)

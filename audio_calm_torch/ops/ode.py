"""ODE integrators for flow-matching inference (counterpart of
audio_calm_tpu/ops/ode.py).

Euler or midpoint over a uniform or sway time grid. Classifier-free
guidance runs the conditional and unconditional passes fused as one 2B
batch per velocity evaluation, rows [cond; uncond], as in JAX. The step
loop is a Python loop (the JAX `lax.scan`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def make_time_grid(steps: int, schedule: str = "uniform",
                   sway_coef: float = -1.0, device=None) -> torch.Tensor:
    """-> [steps + 1] monotone fp32 time points on [0, 1]."""
    t = torch.linspace(0.0, 1.0, steps + 1, dtype=torch.float32,
                       device=device)
    if schedule == "sway":
        t = t + sway_coef * (torch.cos(math.pi / 2.0 * t) - 1.0 + t)
    elif schedule != "uniform":
        raise ValueError(f"unknown time schedule {schedule!r}")
    return t


def ode_solve(head_fn: Callable, condition: torch.Tensor,
              x_init: torch.Tensor, steps: int, cfg_scale: float = 1.0,
              context: Optional[torch.Tensor] = None,
              context_mask: Optional[torch.Tensor] = None,
              x_mask: Optional[torch.Tensor] = None, method: str = "euler",
              time_schedule: str = "uniform",
              sway_coef: float = -1.0) -> torch.Tensor:
    """Integrate dx/dt = v(x, t) from t=0 to 1 over `steps` steps.

    head_fn(condition, x, t, context, context_mask, x_mask) -> v; masks are
    True at PAD."""
    if method not in ("euler", "midpoint"):
        raise ValueError(f"unknown ODE method {method!r}")
    use_cfg = cfg_scale != 1.0 and cfg_scale > 0
    B = x_init.shape[0]
    grid = make_time_grid(steps, time_schedule, sway_coef,
                          device=x_init.device)
    # host copies: the step loop is driven from Python
    t0s = grid[:-1].tolist()
    dts = (grid[1:] - grid[:-1]).tolist()

    if use_cfg:
        cond2 = torch.cat([condition, torch.zeros_like(condition)])
        ctx2 = (torch.cat([context, torch.zeros_like(context)])
                if context is not None else None)
        cmask2 = (torch.cat([context_mask, context_mask])
                  if context_mask is not None else None)
        xmask2 = torch.cat([x_mask, x_mask]) if x_mask is not None else None

        def velocity(x, t_scalar):
            t = torch.full((2 * B,), t_scalar, dtype=torch.float32,
                           device=x.device)
            v2 = head_fn(cond2, torch.cat([x, x]), t, ctx2, cmask2, xmask2)
            v_cond, v_uncond = v2[:B], v2[B:]
            return v_uncond + cfg_scale * (v_cond - v_uncond)
    else:

        def velocity(x, t_scalar):
            t = torch.full((B,), t_scalar, dtype=torch.float32,
                           device=x.device)
            return head_fn(condition, x, t, context, context_mask, x_mask)

    def advance(x, v, h: float):
        # x + h*v computed in fp32 and rounded once to the state's dtype, as
        # JAX does against its fp32 time grid (bf16 serving)
        return torch.add(x.float(), v.float(), alpha=h).to(x_init.dtype)

    x = x_init
    for t, dt in zip(t0s, dts):
        if method == "midpoint":
            v1 = velocity(x, t)
            v = velocity(advance(x, v1, dt / 2.0), t + dt / 2.0)
        else:
            v = velocity(x, t)
        x = advance(x, v, dt)
    return x

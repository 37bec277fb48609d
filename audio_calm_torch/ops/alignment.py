"""Duration -> alignment-matrix construction (counterpart of
audio_calm_tpu/ops/alignment.py).

The JAX package repairs durations with batched `lax.while_loop`s; rows are
independent, so here each loop runs per batch row until that row reaches
the same fixed point. The integer results are identical.

Semantics:
  1. zero invalid tokens; if total > budget, scale proportionally (floor,
     in fp32)
  2. clamp valid tokens to >= 1
  3. while a row is still over budget: decrement its argmax valid token by
     min(deficit, max - 1)
  4. distribute any remainder: +1 to the first `remain` valid tokens,
     repeated while remain exceeds the number of valid tokens
  5. expand to a binary [B, T_txt, t_aud] matrix from cumulative offsets
"""

from __future__ import annotations

from typing import Optional

import torch


def distribute_remainder(dur: torch.Tensor, remain: torch.Tensor,
                         valid_mask: torch.Tensor) -> torch.Tensor:
    """+1 to the first `remain[b]` valid tokens of each row (looping while
    remain exceeds the row's number of valid tokens)."""
    dur = dur.clone()
    valid_cumsum = valid_mask.int().cumsum(dim=1)
    n_valid = valid_mask.int().sum(dim=1)
    for b in range(dur.shape[0]):
        rem, nv = int(remain[b]), int(n_valid[b])
        while rem > 0 and nv > 0:
            dur[b] += (valid_mask[b] & (valid_cumsum[b] <= rem)).to(dur.dtype)
            rem = max(rem - nv, 0)
    return dur


def repair_overbudget(dur: torch.Tensor, valid_mask: torch.Tensor,
                      budget: torch.Tensor) -> torch.Tensor:
    """Decrement the argmax valid token of each row (not below 1) until the
    row fits its budget or no token can shrink."""
    dur = dur.clone()
    for b in range(dur.shape[0]):
        d, valid, t_aud = dur[b], valid_mask[b], int(budget[b])
        while True:
            masked = torch.where(valid, d, torch.zeros_like(d))
            deficit = int((d * valid.to(d.dtype)).sum()) - t_aud
            max_val = int(masked.max())
            if not (deficit > 0 and max_val > 1):
                break
            idx = int(torch.argmax(masked))  # first maximum, as jnp.argmax
            d[idx] = int(d[idx]) - min(deficit, max(int(d[idx]) - 1, 0))
    return dur


def build_alignment_from_durations(
        dur_int: torch.Tensor,  # [B, T_txt] int
        valid_mask: torch.Tensor,  # [B, T_txt] bool
        t_aud: int,
        budget: Optional[torch.Tensor] = None,  # [B] frame budget <= t_aud
        dtype=torch.float32) -> torch.Tensor:
    """-> [B, T_txt, t_aud] binary alignment; frames >= budget get no
    token."""
    B = dur_int.shape[0]
    device = dur_int.device
    if budget is None:
        budget = torch.full((B,), t_aud, dtype=torch.int32)
    # the repair loops branch per row on the host: run them on CPU copies
    budget = budget.to("cpu", torch.int32)
    valid = valid_mask.to("cpu", torch.bool)
    dur = (dur_int.cpu() * valid.to(dur_int.dtype)).to(torch.int32)
    total = dur.sum(dim=1)
    scale = torch.where(total > budget,
                        budget.float() / total.clamp_min(1).float(),
                        torch.ones((), dtype=torch.float32))
    dur = torch.floor(dur.float() * scale[:, None]).to(torch.int32)
    dur = torch.where(valid & (dur < 1), torch.ones_like(dur), dur)

    dur = repair_overbudget(dur, valid, budget)
    remain = (budget - dur.sum(dim=1)).clamp_min(0)
    dur = distribute_remainder(dur, remain, valid)

    cum = dur.cumsum(dim=1)
    start = (cum - dur).to(device)
    end = torch.minimum(cum, budget[:, None]).to(device)
    frame = torch.arange(t_aud, device=device)[None, None, :]
    align = ((frame >= start[:, :, None]) & (frame < end[:, :, None])
             & valid_mask.bool()[:, :, None])
    return align.to(dtype)

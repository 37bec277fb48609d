"""Monotonic Alignment Search on the device (counterpart of
audio_calm_tpu/ops/mas.py).

Recurrence, as in JAX and the reference (including the tie rule):
  dp[0, 0] = lp[0, 0];  dp[n, t] = lp[n, t] + max(dp[n, t-1], dp[n-1, t-1])
  (dp[n, t] = -1e30 for t < n, by initialization and propagation)
Backtrace from (N-1, T-1): move to token n-1 iff dp[n-1, t-1] > dp[n, t-1]
(strictly greater: ties stay).

The forward sweep is a loop over frames of [B, N] vector ops and the
backtrace a loop carrying the token index [B]; every step stays on the
tensor's device, with no host round trip. Each step is one fp32 add of the
same operands as JAX's, so the result is bit-exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30


def monotonic_alignment_search(log_p: torch.Tensor) -> torch.Tensor:
    """log_p [B, N_text, T_audio] -> binary alignment [B, N, T] (fp32).
    Padded rows and frames should carry large negative log-probs."""
    B, N, T = log_p.shape
    lp = log_p.float()
    dev = lp.device
    col = torch.full((B, N), NEG, dtype=torch.float32, device=dev)
    col[:, 0] = lp[:, 0, 0]
    dp = torch.empty(T, B, N, dtype=torch.float32, device=dev)
    dp[0] = col
    neg = torch.full((B, 1), NEG, dtype=torch.float32, device=dev)
    for t in range(1, T):
        col = lp[:, :, t] + torch.maximum(col, torch.cat([neg, col[:, :-1]], 1))
        dp[t] = col

    n = torch.full((B, 1), N - 1, dtype=torch.long, device=dev)
    path = torch.empty(T, B, dtype=torch.long, device=dev)
    for t in range(T - 1, -1, -1):
        path[t] = n[:, 0]
        if t > 0:
            stay = dp[t - 1].gather(1, n)
            move = dp[t - 1].gather(1, (n - 1).clamp_min(0))
            n = torch.where((n > 0) & (move > stay), n - 1, n)
    return F.one_hot(path, N).to(torch.float32).permute(1, 2, 0)

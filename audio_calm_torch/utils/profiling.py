"""FLOP counts and device peaks for the training loop's MFU (counterpart
of `lowered_flops` and `device_peak_flops` in
audio_calm_tpu/utils/profiling.py).

XLA's pre-compile cost analysis has no counterpart here: `count_flops`
runs the work once under torch's FlopCounterMode and adds the dense
product count of the hand-written attention calls, which the counter
cannot see (ops/attention_kernel.counting_flops), so the count is the same
on the card and on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# dense bf16 peak FLOP/s by device name (public H100 specifications)
_PEAK_BF16 = (("h100 pcie", 756e12), ("h100", 989e12))


def device_peak_flops(device=None) -> Optional[float]:
    """The card's dense bf16 peak FLOP/s for MFU (`device`: None = the
    current CUDA device); None on the CPU or an unknown card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in _PEAK_BF16:
        if all(word in name for word in key.split()):
            return peak
    return None


def count_flops(fn: Callable[[], object]) -> float:
    """FLOPs of running fn() once (it runs): FlopCounterMode's count of the
    products torch dispatches plus the attention calls' tally."""
    from torch.utils.flop_counter import FlopCounterMode

    from audio_calm_torch.ops.attention_kernel import counting_flops

    with counting_flops() as tally:
        with FlopCounterMode(display=False) as counter:
            fn()
    return float(counter.get_total_flops()) + tally.flops

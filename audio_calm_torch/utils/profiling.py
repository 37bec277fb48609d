"""FLOP counts, device peaks, traces and step timing (counterpart of
audio_calm_tpu/utils/profiling.py).

XLA's cost analysis (`flops_estimate`, `lowered_flops`) has one
counterpart here, `count_flops`: it runs the work once under torch's
FlopCounterMode and adds the product count of the hand-written kernels'
calls (attention, the vocoder stage and resblock), which the counter
cannot see (ops/cuda_build.counting_flops), so the count is the same on
the card and on the CPU.
`trace(log_dir)` is a torch.profiler session that writes a Chrome trace
into log_dir; `StepTimer` gives steps per second after a warmup, each
tick waiting for the device.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Optional

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
    products torch dispatches plus the kernel calls' tally."""
    from torch.utils.flop_counter import FlopCounterMode

    from audio_calm_torch.ops.cuda_build import counting_flops

    with counting_flops() as tally:
        with FlopCounterMode(display=False) as counter:
            fn()
    return float(counter.get_total_flops()) + tally.flops


def _sync(result: Any = None) -> None:
    """Wait for the CUDA work behind `result` (every tensor in a dict,
    list or tuple), or for the current device when result is None."""
    tensors = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    collect(result)
    devices = {t.device for t in tensors if t.device.type == "cuda"}
    if result is None and torch.cuda.is_available() and \
            torch.cuda.is_initialized():
        devices.add(torch.device("cuda", torch.cuda.current_device()))
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace(log_dir): step(...)`: a torch.profiler session over the
    block (CPU activity, and CUDA's when a card is present) whose Chrome
    trace is written to `<log_dir>/trace_<pid>_<n>.json` at its end."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(path)


class StepTimer:
    """Wall-clock steps per second, the first `warmup` ticks left out.
    `tick(result)` waits for the device work behind `result` (or for the
    current card when result is None), so a CUDA step is timed to its
    end."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.n = 0
        self.t0: Optional[float] = None

    def tick(self, result: Any = None) -> None:
        _sync(result)
        self.n += 1
        if self.n == self.warmup:
            self.t0 = time.perf_counter()

    @property
    def steps_per_sec(self) -> float:
        if self.t0 is None or self.n <= self.warmup:
            return float("nan")
        return (self.n - self.warmup) / (time.perf_counter() - self.t0)

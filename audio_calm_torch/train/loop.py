"""The training loop's core (counterpart of run_training in
audio_calm_tpu/train/loop.py): steps over batches, metric logging every
`logging_steps` (printed), samples per second. The JSONL/wandb metric
sinks, checkpointing, resume, periodic eval and best-model retention are
still to be ported.

Metrics stay on the device until a flush: every `metrics_drain_steps`
steps or at a logging step, the queued step metrics are read back in one
pass (which waits for the device).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List

import torch

from audio_calm_torch.config import TrainingConfig


def log_metrics(step: int, metrics: Dict[str, float]) -> None:
    items = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
    print(f"[step {step}] {items}", flush=True)


def _sync(tensors) -> None:
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_training(step_fn: Callable, batches: Iterable[Dict],
                 cfg: TrainingConfig, total_steps: int) -> List[Dict]:
    """Run up to `total_steps` steps of `step_fn(batch) -> metrics`.
    Returns one record per step: its metrics as floats. Each logging flush
    also records `steps_per_sec`, `samples_per_sec` (leading dim of the
    first tensor of each batch) and `step_s` (the window's mean wall time a
    step, ending in a device synchronize), and is printed."""
    history: List[Dict] = []
    pending: List[Dict] = []
    window_samples, window_steps = 0, 0
    t_last = time.perf_counter()
    drain = max(1, cfg.metrics_drain_steps)

    def harvest():
        _sync(v for m in pending for v in m.values())
        for m in pending:
            history.append({k: float(v) for k, v in m.items()})
        pending.clear()

    for step_idx, batch in enumerate(batches):
        if step_idx >= total_steps:
            break
        pending.append(step_fn(batch))
        window_samples += next(v.shape[0] for v in batch.values()
                               if isinstance(v, torch.Tensor) and v.ndim)
        window_steps += 1
        done = step_idx + 1
        if len(pending) >= drain or done % cfg.logging_steps == 0:
            harvest()
        if done % cfg.logging_steps == 0:
            dt = time.perf_counter() - t_last
            window = history[-window_steps:]
            out = {k: sum(r[k] for r in window) / len(window)
                   for k in window[0]}
            out.update(steps_per_sec=window_steps / dt,
                       samples_per_sec=window_samples / dt,
                       step_s=dt / window_steps)
            history[-1].update(step_s=out["step_s"],
                               samples_per_sec=out["samples_per_sec"])
            log_metrics(done, out)
            window_samples, window_steps = 0, 0
            t_last = time.perf_counter()
    harvest()
    return history

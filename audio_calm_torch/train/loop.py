"""The training loop (counterpart of audio_calm_tpu/train/loop.py): steps
over batches, metric logging every `logging_steps` (printed and appended
to `<output_dir>/metrics.jsonl`, wandb when `report_to: wandb` and it is
installed), samples per second and MFU, periodic eval, step checkpoints
with retention, resume and best-model retention.

Metrics stay on the device until a flush: every `metrics_drain_steps`
steps or at a logging step, the queued step metrics are read back in one
pass (which waits for the device). The next batch is prepared (step
chosen, samples and FLOPs counted, moved to the device) before the current
step's metrics are read, so host work overlaps the device's.

Data-parallel runs (a process group): every rank runs the loop on its
rows; the metrics are the global batch's, rank 0 alone logs, and
checkpoints are written by rank 0 (train/checkpoint.save_train_state) and
read by every rank.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from audio_calm_torch.config import TrainingConfig
from audio_calm_torch.parallel.mesh import is_primary
from audio_calm_torch.train.checkpoint import (make_manager,
                                               restore_train_state,
                                               save_train_state)
from audio_calm_torch.utils import profiling


class MetricLogger:
    """`metrics.jsonl` under output_dir plus the printed line; wandb when
    asked for and importable (else nothing more). Under a process group
    only rank 0 logs; the others' logger does nothing."""

    def __init__(self, output_dir: str, run_name: str,
                 report_to: str = "none"):
        self.enabled = is_primary()
        if not self.enabled:
            return
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self.f = open(self.path, "a")
        self.wandb = None
        if report_to == "wandb":
            try:
                import wandb

                wandb.init(project=os.environ.get("WANDB_PROJECT", run_name),
                           name=run_name)
                self.wandb = wandb
            except Exception:
                self.wandb = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if not self.enabled:
            return
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.wandb:
            self.wandb.log(metrics, step=step)
        items = " ".join(f"{k}={v:.4f}" for k, v in rec.items() if k != "step")
        print(f"[step {step}] {items}", flush=True)

    def close(self) -> None:
        if self.enabled:
            self.f.close()


def _sync(tensors) -> None:
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _n_samples(batch: Dict) -> int:
    """A packed batch's `n_samples`, else the leading dim of its first
    array."""
    return batch.get("n_samples") or next(
        (v.shape[0] for v in batch.values() if getattr(v, "ndim", 0) >= 1),
        0)


def run_training(step_fn: Optional[Callable], batches, cfg: TrainingConfig,
                 total_steps: int, optimizer=None,
                 eval_fn: Optional[Callable[[], Dict[str, float]]] = None,
                 batch_filter: Optional[Callable[[Dict], Dict]] = None,
                 step_selector: Optional[Callable[[Dict], Callable]] = None,
                 step_flops: Optional[Callable[[Dict], float]] = None,
                 device=None) -> List[Dict]:
    """Run steps until the step count reaches `total_steps` or `batches`
    runs out -> one record per step run: its metrics as floats and its
    step.

    step_fn(batch) -> metrics, or step_selector(raw batch) -> the step for
    that batch (the task routing); a step with a `count` attribute gets the
    global step count before each call. batch_filter(raw batch) -> what the
    step takes (strip host keys, move to the device). `batches` is an
    iterable or a callable `start_step -> iterable`, so a resumed run
    reseeds its data by the restored step. step_flops(raw batch) -> the
    FLOPs of its step; with a known peak (utils/profiling.
    device_peak_flops of `device`) each logging flush carries `mfu_pct`.
    Each flush logs the window's mean metrics, steps_per_sec,
    samples_per_sec (a packed batch's `n_samples`, else its leading dim)
    and step_s; the last record of the window gets step_s,
    samples_per_sec and mfu_pct too.

    With `optimizer` (train/optim.AdamW, the train state): a checkpoint
    under cfg.output_dir every `save_steps` steps, at `total_steps`, and at
    the end when the batches ran out off that grid; resume from
    cfg.resume_from_checkpoint (its latest step) before the first step;
    with cfg.load_best_model_at_end the checkpoints rank by
    cfg.metric_for_best_model (eval_fn's when it reports it, else the
    running train loss) and the best one is restored at the end.
    eval_fn() -> metrics runs every `eval_steps` steps (logged eval_*).
    """
    logger = MetricLogger(cfg.output_dir, cfg.run_name, cfg.report_to)
    track_best = bool(cfg.load_best_model_at_end)
    metric_name = cfg.metric_for_best_model or "loss"
    manager = None
    step_idx = 0
    if optimizer is not None:
        manager = make_manager(cfg.output_dir, cfg.save_total_limit,
                               best_metric=metric_name if track_best
                               else None)
        if cfg.resume_from_checkpoint:
            same = (os.path.abspath(cfg.resume_from_checkpoint)
                    == os.path.abspath(cfg.output_dir))
            resume = manager if same else make_manager(
                cfg.resume_from_checkpoint, cfg.save_total_limit,
                best_metric=None)
            if resume.latest_step() is not None:
                step_idx = restore_train_state(resume, optimizer)
                print(f"resumed from step {step_idx}", flush=True)
    if callable(batches):
        batches = batches(step_idx)
    start_step = step_idx
    peak = profiling.device_peak_flops(device) if step_flops else None

    history: List[Dict] = []
    pending: List[tuple] = []  # (step, metrics on the device)
    meters: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    last_train_loss: Optional[float] = None
    last_tracked: Optional[float] = None
    window_samples, window_flops, window_steps = 0, 0.0, 0
    saved_at = None
    drain = max(1, cfg.metrics_drain_steps)
    t_last = time.perf_counter()

    def harvest():
        nonlocal last_train_loss
        _sync(v for _, m in pending for v in m.values())
        for step, m in pending:
            rec = {k: float(v) for k, v in m.items()}
            history.append({"step": step, **rec})
            for k, v in rec.items():
                if v != 0.0 or k in ("loss", "grad_norm"):
                    meters[k] = meters.get(k, 0.0) + v
                    counts[k] = counts.get(k, 0) + 1
            last_train_loss = rec.get("loss", last_train_loss)
        pending.clear()

    def save():
        nonlocal saved_at
        tracked = last_tracked if last_tracked is not None else \
            last_train_loss
        save_train_state(manager, step_idx, optimizer, metrics=(
            {metric_name: tracked} if track_best and tracked is not None
            else None))
        saved_at = step_idx

    def prepared():
        """Per raw batch: its step, samples, FLOPs and filtered batch."""
        for raw in batches:
            fn = step_selector(raw) if step_selector else step_fn
            fl = step_flops(raw) if step_flops else 0.0
            yield fn, _n_samples(raw), fl, (batch_filter(raw) if batch_filter
                                            else raw)

    it = prepared()
    nxt = next(it, None) if step_idx < total_steps else None
    while nxt is not None and step_idx < total_steps:
        fn, n_samples, fl, batch = nxt
        window_samples += n_samples
        window_flops += fl
        window_steps += 1
        if hasattr(fn, "count"):
            fn.count = step_idx
        metrics = fn(batch)
        step_idx += 1
        pending.append((step_idx, metrics))
        # the next batch's host work overlaps this step's device work
        nxt = next(it, None) if step_idx < total_steps else None
        if len(pending) >= drain or step_idx % cfg.logging_steps == 0:
            harvest()
        if step_idx % cfg.logging_steps == 0:
            dt = time.perf_counter() - t_last
            out = {k: meters[k] / counts[k] for k in meters}
            out.update(steps_per_sec=window_steps / dt,
                       samples_per_sec=window_samples / dt,
                       step_s=dt / window_steps)
            if window_flops and peak:
                out["mfu_pct"] = 100.0 * window_flops / dt / peak
            history[-1].update({k: out[k] for k in (
                "step_s", "samples_per_sec", "mfu_pct") if k in out})
            logger.log(step_idx, out)
            meters, counts = {}, {}
            window_samples, window_flops, window_steps = 0, 0.0, 0
            t_last = time.perf_counter()
        if eval_fn is not None and step_idx % cfg.eval_steps == 0:
            eval_metrics = eval_fn()
            if eval_metrics:
                logger.log(step_idx, {f"eval_{k}": v
                                      for k, v in eval_metrics.items()})
                if metric_name in eval_metrics:
                    last_tracked = float(eval_metrics[metric_name])
        if manager is not None and (step_idx % cfg.save_steps == 0
                                    or step_idx == total_steps):
            harvest()  # the save ranks by the latest train loss
            save()
    harvest()
    if manager is not None:
        # a run that ends on exhausted batches, off the save grid, keeps
        # its final state
        if step_idx != saved_at and step_idx > start_step:
            save()
        if track_best:
            best = manager.best_step()
            if best is not None and best != step_idx:
                restore_train_state(manager, optimizer, step=best)
                print(f"loaded best checkpoint (step {best})", flush=True)
    logger.close()
    return history

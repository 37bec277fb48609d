"""The CALM train and eval steps (counterpart of audio_calm_tpu/train/
steps.py).

`make_calm_step(model, optimizer, task, microbatch=k)` returns
`step(batch) -> metrics`, one optimizer update a call. Tasks:
  - "tts": a plain batch (`forward_tts`), split into k slices along its
    leading axis; gradients and loss terms are the mean of the slices (the
    reference's solo semantics, JAX steps.py:145-193);
  - "tts_packed": a packed batch (`forward_tts_packed`, rows of several
    utterances), split into k slices of rows. The full batch's
    denominators (its slot count and valid frame count) are computed
    before the slices run and every slice's loss is built against them, so
    the slice gradients and loss terms are summed: the step equals the
    full batch's however its rows fall into slices (JAX steps.py:128-190).
Only one slice's activations are live at a time. Each slice draws its flow
noise from a generator and its dropout masks from a seed, both derived
from (seed, step, slice), so a step is reproducible; `step.count` is the
step (run_training sets it before each call).

Metrics (device scalars; the loop reads them back): loss, loss_tts,
loss_len, loss_dur, grad_norm (the norm of the step's gradients before
clipping) and, packed, loss_den (the real utterances of the batch).
`make_calm_eval_step(model, "tts")` is the eval forward under no_grad.
The ASR tasks are ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from audio_calm_torch.ops.dropout import derive_seed
from audio_calm_torch.utils.profiling import count_flops

TTS_KEYS = ("text_ids", "attention_mask", "latents", "audio_mask")
PACKED_KEYS = ("latents", "audio_mask", "text_mask", "tok_ids", "kind",
               "segment_ids", "position_ids", "ctx_idx", "soa_idx")
TASK_KEYS = {"tts": TTS_KEYS, "tts_packed": PACKED_KEYS}


def _check_task(task: str) -> None:
    if task in ("asr", "asr_packed"):
        raise NotImplementedError(
            f"task {task!r} is not ported yet (ROADMAP Queue 1 item 4, ASR "
            "training and the mix); the port trains 'tts' and 'tts_packed'")
    if task not in TASK_KEYS:
        raise ValueError(f"unknown task {task!r}")


def global_dens(batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A packed batch's (slot count, valid frame count), each at least 1."""
    slots = batch["text_mask"].any(dim=-1).float().sum().clamp_min(1.0)
    frames = batch["audio_mask"].float().sum().clamp_min(1.0)
    return slots, frames


def tts_slice_loss(model, batch: Dict[str, torch.Tensor], seed: int,
                   task: str = "tts", dens=None) -> Dict[str, torch.Tensor]:
    """The train-mode forward of one slice (`forward_tts`, or
    `forward_tts_packed` against the denominators `dens`), its flow noise
    drawn from a generator seeded by `seed` and its dropout masks fixed by
    `seed`."""
    gen = torch.Generator(device=batch["latents"].device)
    gen.manual_seed(derive_seed(seed, 0))
    args = [batch[k] for k in TASK_KEYS[task]]
    if task == "tts":
        return model.forward_tts(*args, train=True, generator=gen,
                                 seed=derive_seed(seed, 1))
    return model.forward_tts_packed(*args, global_den=dens, train=True,
                                    generator=gen, seed=derive_seed(seed, 1))


def _slices(batch: Dict[str, torch.Tensor], task: str, microbatch: int):
    keys = TASK_KEYS[task]
    B = batch[keys[0]].shape[0]
    if B % microbatch:
        raise ValueError(f"batch of {B} rows does not split into "
                         f"{microbatch} microbatch slices")
    b = B // microbatch
    return [{k: batch[k][i * b:(i + 1) * b] for k in keys}
            for i in range(microbatch)]


def accumulate_tts_grads(model, batch: Dict[str, torch.Tensor],
                         microbatch: int, seed: int, task: str = "tts"
                         ) -> Dict[str, torch.Tensor]:
    """Backward of the step's loss into each trainable tensor's .grad
    (which the caller has cleared), slice i with derive_seed(seed, i):
    "tts" the mean of the slice losses, "tts_packed" their sum against the
    full batch's denominators. Returns the step's loss terms, detached."""
    summed = task == "tts_packed"
    dens = global_dens(batch) if summed else None
    sums: Dict[str, torch.Tensor] = {}
    for i, sub in enumerate(_slices(batch, task, microbatch)):
        out = tts_slice_loss(model, sub, derive_seed(seed, i), task, dens)
        (out["loss"] if summed else out["loss"] / microbatch).backward()
        for k, v in out.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    if summed:
        return sums
    return {k: v / microbatch for k, v in sums.items()}


def make_calm_step(model, optimizer, task: str = "tts", microbatch: int = 1,
                   seed: int = 0) -> Callable:
    """step(batch) -> metrics; one optimizer update per call. The step
    count (`step.count`) folds into every slice's seed."""
    _check_task(task)
    params = optimizer.params

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        for p in params.values():
            p.grad = None
        metrics = accumulate_tts_grads(model, batch, microbatch,
                                       derive_seed(seed, step.count), task)
        metrics["grad_norm"] = optimizer.step(
            {n: p.grad for n, p in params.items()})
        step.count += 1
        return metrics

    step.count = 0
    return step


def make_calm_eval_step(model, task: str) -> Callable:
    """eval_step(batch, seed) -> the loss terms of `forward_tts(train=False)`
    under no_grad (the fused attention forward, K3/K4 on the card), its
    flow noise from a generator seeded by `seed`."""
    _check_task(task)
    if task != "tts":
        raise ValueError("the eval step runs the plain forward: task 'tts'")

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor], seed: int = 0):
        gen = torch.Generator(device=batch["latents"].device)
        gen.manual_seed(seed)
        return model.forward_tts(*(batch[k] for k in TTS_KEYS), train=False,
                                 generator=gen)

    return eval_step


def count_step_flops(model, batch: Dict[str, torch.Tensor], task: str,
                     microbatch: int = 1, seed: int = 0) -> float:
    """FLOPs of one step of `task` on `batch`: the forward and backward of
    its first slice, run once under utils/profiling.count_flops, times the
    slices (every slice has the same shapes; the counts depend on shapes
    only). The optimizer's elementwise update is not counted. The
    trainable tensors' .grad are as before the call."""
    _check_task(task)
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    saved = {n: p.grad for n, p in params.items()}
    for p in params.values():
        p.grad = None
    sub = _slices(batch, task, microbatch)[0]
    dens = global_dens(batch) if task == "tts_packed" else None

    def run():
        tts_slice_loss(model, sub, seed, task, dens)["loss"].backward()

    flops = count_flops(run)
    for n, p in params.items():
        p.grad = saved[n]
    return flops * microbatch

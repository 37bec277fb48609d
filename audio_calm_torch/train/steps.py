"""The CALM train step (counterpart of audio_calm_tpu/train/steps.py).

`make_calm_step(model, optimizer, task="tts", microbatch=k)` returns
`step(batch) -> metrics`: the batch is split into k slices along its
leading axis; each slice runs `forward_tts(train=True)` and its backward,
and the gradients and loss terms are a plain mean over the slices (the
reference's solo semantics, JAX steps.py:145-193); then one optimizer
update. Only one slice's activations are live at a time. Each slice draws
its flow noise from a generator and its dropout masks from a seed, both
derived from (seed, step, slice), so a step is reproducible.

Metrics (device scalars; the loop reads them back): loss, loss_tts,
loss_len, loss_dur, and grad_norm, the norm of the averaged gradients
before clipping.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from audio_calm_torch.ops.dropout import derive_seed

TTS_KEYS = ("text_ids", "attention_mask", "latents", "audio_mask")


def tts_slice_loss(model, batch: Dict[str, torch.Tensor],
                   seed: int) -> Dict[str, torch.Tensor]:
    """forward_tts(train=True) on one slice, its flow noise drawn from a
    generator seeded by `seed` and its dropout masks fixed by `seed`."""
    gen = torch.Generator(device=batch["latents"].device)
    gen.manual_seed(derive_seed(seed, 0))
    return model.forward_tts(*(batch[k] for k in TTS_KEYS), train=True,
                             generator=gen, seed=derive_seed(seed, 1))


def accumulate_tts_grads(model, batch: Dict[str, torch.Tensor],
                         microbatch: int, seed: int
                         ) -> Dict[str, torch.Tensor]:
    """Backward of the mean slice loss into each trainable tensor's .grad
    (which the caller has cleared); slice i uses derive_seed(seed, i).
    Returns the mean loss terms, detached."""
    B = batch["text_ids"].shape[0]
    if B % microbatch:
        raise ValueError(f"batch of {B} does not split into {microbatch} "
                         "microbatch slices")
    b = B // microbatch
    sums: Dict[str, torch.Tensor] = {}
    for i in range(microbatch):
        sub = {k: batch[k][i * b:(i + 1) * b] for k in TTS_KEYS}
        out = tts_slice_loss(model, sub, derive_seed(seed, i))
        (out["loss"] / microbatch).backward()
        for k, v in out.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    return {k: v / microbatch for k, v in sums.items()}


def make_calm_step(model, optimizer, task: str = "tts", microbatch: int = 1,
                   seed: int = 0) -> Callable:
    """step(batch) -> metrics; one optimizer update per call. The step
    count (`step.count`) folds into every slice's seed."""
    if task != "tts":
        raise NotImplementedError(f"task {task!r}: only the solo TTS step "
                                  "is ported (packed TTS and ASR are not)")
    params = optimizer.params

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        for p in params.values():
            p.grad = None
        metrics = accumulate_tts_grads(model, batch, microbatch,
                                       derive_seed(seed, step.count))
        metrics["grad_norm"] = optimizer.step(
            {n: p.grad for n, p in params.items()})
        step.count += 1
        return metrics

    step.count = 0
    return step

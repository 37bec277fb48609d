"""The CALM train and eval steps (counterpart of audio_calm_tpu/train/
steps.py).

`make_calm_step(model, optimizer, task, microbatch=k)` returns
`step(batch) -> metrics`, one optimizer update a call, the batch split
into k slices along its leading axis. Tasks:
  - "tts" (`forward_tts`) and "asr" (`forward_asr`): plain batches, every
    row one utterance; gradients and loss terms are the mean of the slices
    (the reference's solo semantics, JAX steps.py:145-193);
  - "tts_packed" (`forward_tts_packed`): the full batch's denominators (its
    slot count and valid frame count) are computed before the slices run
    and every slice's loss is built against them, so the slice gradients
    and loss terms are summed (JAX steps.py:128-190);
  - "asr_packed" (`forward_asr_packed`): each slice's loss is a masked mean
    over its valid label positions, whose count `loss_den` is data only; the
    backward of loss x loss_den a slice, and one scale of every gradient
    and loss term by 1 / the summed loss_den at the end, give the full
    batch's masked mean however the rows fall into slices (FFD fills rows
    front to back, so a tail slice can hold only dummy slots); the metric
    loss_den is the sum (JAX steps.py:128, 170-190).
Only one slice's activations are live at a time. Each slice draws its flow
noise from a generator and its dropout masks from a seed, both derived
from (seed, step, slice), so a step is reproducible; `step.count` is the
step (run_training sets it before each call).

Metrics (device scalars; the loop reads them back): the forward's loss
terms (loss and loss_tts, loss_len, loss_dur or loss_asr), grad_norm (the
norm of the step's gradients before clipping) and, packed and ASR,
loss_den. `make_calm_eval_step(model, task)` is the plain forward of
"tts" or "asr" in eval mode under no_grad.

`make_vae_step(model, optimizer)` (JAX steps.py:228-262) is the VAE's:
one update a call on {"mel"}, its eps drawn from a generator and its
latent-dropout mask from a seed, both from (seed, step); metrics the five
loss terms, mu_std (the std of mu over the batch), var_mean
(mean exp(logvar)) and grad_norm.

Data parallelism (JAX: shard_step over a "data" mesh axis): with an
optimizer built `distributed=True` over a process group of W ranks, each
rank passes its own rows (the collator's process_index slice) and the
step is the one-process step over the global batch, the ranks' rows in
rank order:
  - the CALM steps gather the batch's rows on every rank; microbatch slice
    i is rows [i b, (i + 1) b) of the global batch (b = B / k, which W
    must divide) and each rank runs its b / W of them;
  - every denominator is the global one, computed from the gathered rows:
    a plain slice's row and valid-frame counts ("tts") or valid label
    count ("asr"), the whole batch's global_dens ("tts_packed") or valid
    label count ("asr_packed"); each rank's loss terms are its rows' sums
    over them, so the ranks' terms and gradients add up to the one-process
    ones (the VAE's terms are plain means over equal shares: each rank's
    over W);
  - flow noise, the CFG drop and every dropout mask are drawn at the
    global slice's size and each rank keeps its rows (ops/dropout.
    row_shard), so a rank draws exactly its rows' one-process numbers;
  - the optimizer sums the gradients over the ranks (ZeRO-2), and the
    norm and clipping come after that sum.
With W = 1 the step is the one-process step, collectives and all.

Tensor parallelism (JAX: shard_step over a mesh whose "model" axis is >
1): `shard_step(model, mesh)` places a model that optim.freeze has
labelled, in place, as this rank's replica: row `rank` of the mesh, its
Qwen2 kernels split over that row's devices by parallel/tp_shard.
place_tensor_parallel. The data axis is the processes, as above: it must
equal the world size. Every trainable tensor stays one tensor, whole on
the row's first device under its one-device name, so the steps, AdamW
(and its ZeRO rule over the data axis), run_training and the train-state
checkpoints take the placed model as they take the one-device one. JAX
puts a TP-split trainable's optimizer moments on its split. The port
splits only the Qwen2 kernels and the embedding (tp_shard.split_dims),
which calm_param_label freezes for every task (LoRA a and b are
replicated by the rules), so the trainables' moments stay whole with
their tensors under the ZeRO rule, and `shard_step` refuses a model with
a trainable tensor among those it splits. (JAX's rules also split the
DiT heads' and the ASR cross-attention's trainable q/k/v, and their
moments; the port keeps those whole on the row's first device.) The
step's math is the one-device step's: the shards' draws are
the one-device draws (ops/dropout.draw's `cols`), and only the order of
the split sums differs. The CALM steps run their backward on the calling
thread (torch.autograd.set_multithreading_enabled(False)): a placed
model's checkpointed blocks hold tensors of several cards, and torch's
non-reentrant checkpoint recomputes a block from whichever device worker
thread first needs one of its tensors, so with a worker thread a card two
threads recompute the same block at once (on two H100s: "Unexpected
state: target_frame.early_stop is set").
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from audio_calm_torch.ops.dropout import derive_seed, row_shard
from audio_calm_torch.parallel.mesh import (Mesh, all_reduce_sum, gather_rows,
                                            rank_world)
from audio_calm_torch.parallel.tp_shard import (place_tensor_parallel,
                                                split_dims)
from audio_calm_torch.utils.profiling import count_flops

TTS_KEYS = ("text_ids", "attention_mask", "latents", "audio_mask")
PACKED_KEYS = ("latents", "audio_mask", "text_mask", "tok_ids", "kind",
               "segment_ids", "position_ids", "ctx_idx", "soa_idx")
ASR_KEYS = TTS_KEYS + ("labels",)
ASR_PACKED_KEYS = ("latents", "latent_mask", "labels", "tok_ids", "kind",
                   "gather_idx", "segment_ids", "position_ids", "ctx_idx")
TASK_KEYS = {"tts": TTS_KEYS, "tts_packed": PACKED_KEYS, "asr": ASR_KEYS,
             "asr_packed": ASR_PACKED_KEYS}
_FORWARD = {"tts": "forward_tts", "tts_packed": "forward_tts_packed",
            "asr": "forward_asr", "asr_packed": "forward_asr_packed"}


def _check_task(task: str) -> None:
    if task not in TASK_KEYS:
        raise ValueError(f"unknown task {task!r}")


def global_dens(batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A packed batch's (slot count, valid frame count), each at least 1."""
    slots = batch["text_mask"].any(dim=-1).float().sum().clamp_min(1.0)
    frames = batch["audio_mask"].float().sum().clamp_min(1.0)
    return slots, frames


def valid_count(labels: torch.Tensor) -> torch.Tensor:
    """The number of label positions that count (not -100), at least 1."""
    return (labels != -100).float().sum().clamp_min(1.0)


def slice_loss(model, batch: Dict[str, torch.Tensor], seed: int,
               task: str = "tts", dens=None, den=None
               ) -> Dict[str, torch.Tensor]:
    """The train-mode forward of one slice of `task` (`forward_tts_packed`
    against the denominators `dens`; `forward_tts` too when dens is given;
    the ASR forwards against the valid label count `den` when given), its
    flow noise drawn from a generator seeded by `seed` and its dropout
    masks fixed by `seed`."""
    gen = torch.Generator(device=batch["latents"].device)
    gen.manual_seed(derive_seed(seed, 0))
    kw = {}
    if dens is not None:
        kw["global_den" if task == "tts_packed" else "dens"] = dens
    if den is not None:
        kw["den"] = den
    return getattr(model, _FORWARD[task])(
        *(batch[k] for k in TASK_KEYS[task]), train=True, generator=gen,
        seed=derive_seed(seed, 1), **kw)


def _slices(batch: Dict[str, torch.Tensor], task: str, microbatch: int):
    keys = TASK_KEYS[task]
    B = batch[keys[0]].shape[0]
    if B % microbatch:
        raise ValueError(f"batch of {B} rows does not split into "
                         f"{microbatch} microbatch slices")
    b = B // microbatch
    return [{k: batch[k][i * b:(i + 1) * b] for k in keys}
            for i in range(microbatch)]


def accumulate_grads(model, batch: Dict[str, torch.Tensor],
                     microbatch: int, seed: int, task: str = "tts"
                     ) -> Dict[str, torch.Tensor]:
    """Backward of the step's loss into each trainable tensor's .grad
    (which the caller has cleared), slice i with derive_seed(seed, i):
    "tts" / "asr" the mean of the slice losses, "tts_packed" their sum
    against the full batch's denominators, "asr_packed" their loss_den-
    weighted mean. Returns the step's loss terms, detached, and loss_den
    summed over the slices."""
    summed = task == "tts_packed"
    weighted = task == "asr_packed"
    dens = global_dens(batch) if summed else None
    sums: Dict[str, torch.Tensor] = {}
    for i, sub in enumerate(_slices(batch, task, microbatch)):
        out = slice_loss(model, sub, derive_seed(seed, i), task, dens)
        w = out["loss_den"].detach() if weighted else None
        if summed:
            out["loss"].backward()
        elif weighted:
            (out["loss"] * w).backward()
        else:
            (out["loss"] / microbatch).backward()
        for k, v in out.items():
            v = v.detach()
            if weighted and k != "loss_den":
                v = v * w
            sums[k] = sums.get(k, 0.0) + v
    if summed:
        return sums
    total = microbatch
    if weighted:
        total = sums["loss_den"].clamp_min(1.0)
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(total)
    # loss_den, a count, is the sum over the slices
    return {k: v if k == "loss_den" else v / total for k, v in sums.items()}


def accumulate_grads_dp(model, batch: Dict[str, torch.Tensor],
                        microbatch: int, seed: int, task: str, rank: int,
                        world: int) -> Dict[str, torch.Tensor]:
    """accumulate_grads for data-parallel rank `rank` of `world` holding
    its rows of the global batch (module docstring): the .grad are this
    rank's share, which the ranks' sum makes the one-process gradient; the
    returned loss terms are already summed over the ranks."""
    keys = TASK_KEYS[task]
    full = gather_rows({k: batch[k] for k in keys})
    summed = task in ("tts_packed", "asr_packed")
    dens = global_dens(full) if task == "tts_packed" else None
    den = valid_count(full["labels"]) if task == "asr_packed" else None
    scale = 1.0 if summed else 1.0 / microbatch
    sums: Dict[str, torch.Tensor] = {}
    for i, sub in enumerate(_slices(full, task, microbatch)):
        b = sub[keys[0]].shape[0]
        if b % world:
            raise ValueError(f"a microbatch slice of {b} rows does not "
                             f"split over {world} ranks")
        n = b // world
        mine = {k: v[rank * n:(rank + 1) * n] for k, v in sub.items()}
        if task == "tts":
            dens = (torch.tensor(float(b), device=sub["latents"].device),
                    sub["audio_mask"].float().sum().clamp_min(1.0))
        elif task == "asr":
            den = valid_count(sub["labels"])
        with row_shard(rank, world):  # the backward's recomputes too
            out = slice_loss(model, mine, derive_seed(seed, i), task, dens,
                             den)
            (out["loss"] * scale).backward()
        for k, v in out.items():
            if task == "tts" and k == "loss_den":
                continue  # the one-process plain step reports none
            v = v.detach().float()
            sums[k] = sums.get(k, 0.0) + (v if k == "loss_den" else v * scale)
    names = sorted(sums)
    vec = all_reduce_sum(torch.stack([sums[k] for k in names]))
    return dict(zip(names, vec.unbind()))


def make_calm_step(model, optimizer, task: str = "tts", microbatch: int = 1,
                   seed: int = 0) -> Callable:
    """step(batch) -> metrics; one optimizer update per call. The step
    count (`step.count`) folds into every slice's seed. With a distributed
    optimizer over W > 1 ranks, `batch` is this rank's rows and the step
    is data-parallel (module docstring)."""
    _check_task(task)
    params = optimizer.params
    rank, world = getattr(optimizer, "rank", 0), getattr(optimizer,
                                                         "world", 1)

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        for p in params.values():
            p.grad = None
        with torch.autograd.set_multithreading_enabled(False):  # see above
            if world > 1:
                metrics = accumulate_grads_dp(model, batch, microbatch,
                                              derive_seed(seed, step.count),
                                              task, rank, world)
            else:
                metrics = accumulate_grads(model, batch, microbatch,
                                           derive_seed(seed, step.count),
                                           task)
        metrics["grad_norm"] = optimizer.step(
            {n: p.grad for n, p in params.items()})
        step.count += 1
        return metrics

    step.count = 0
    return step


def shard_step(model, mesh: Mesh):
    """This rank's replica of a labelled QwenCALM on `mesh` [data, model]
    (module docstring): row `rank` of the mesh, the Qwen2 kernels split
    over its devices, in place. mesh.shape["data"] must be the process
    group's world size (1 without a group); with a model axis of 1 the
    model is returned as it is."""
    rank, world = rank_world()
    if mesh.shape["data"] != world:
        raise ValueError(f"the mesh's data axis is {mesh.shape['data']}, "
                         f"the process group has {world} ranks: the port's "
                         f"data axis is its processes")
    if mesh.shape["model"] == 1:
        return model
    named = dict(model.named_parameters())
    bad = sorted(n for n in split_dims(model, mesh.shape["model"])
                 if named[n].requires_grad)
    if bad:
        raise ValueError(f"trainable tensors the model axis would split "
                         f"(freeze them first): {bad}")
    return place_tensor_parallel(model, mesh.devices[rank])


def make_calm_eval_step(model, task: str) -> Callable:
    """eval_step(batch, seed) -> the loss terms of the plain forward of
    `task` ("tts" or "asr") with train=False under no_grad (the fused
    attention forward, K3/K4 on the card), its flow noise from a generator
    seeded by `seed`."""
    if task not in ("tts", "asr"):
        raise ValueError(f"the eval step runs a plain forward: task 'tts' "
                         f"or 'asr', not {task!r}")
    forward = getattr(model, _FORWARD[task])

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor], seed: int = 0):
        gen = torch.Generator(device=batch["latents"].device)
        gen.manual_seed(seed)
        return forward(*(batch[k] for k in TASK_KEYS[task]), train=False,
                       generator=gen)

    return eval_step


VAE_LOSSES = ("loss", "rec_loss", "ssim_loss", "stft_loss", "kl_loss")


def vae_loss(model, mel: torch.Tensor, seed: int,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The VAE's train-mode forward on `mel`: eps from a generator seeded
    by derive_seed(seed, 0) (or `eps` itself), the latent-dropout mask
    fixed by derive_seed(seed, 1) (JAX's noise and dropout keys, fold_in 0
    and 1)."""
    gen = torch.Generator(device=mel.device)
    gen.manual_seed(derive_seed(seed, 0))
    return model(mel, train=True, generator=gen, seed=derive_seed(seed, 1),
                 eps=eps)


def make_vae_step(model, optimizer, seed: int = 0) -> Callable:
    """step(batch, eps=None) -> metrics; one optimizer update per call on
    batch["mel"] [B, T, n_mels]. The step count (`step.count`) folds into
    the seed; `eps` injects the reparameterization noise. With a
    distributed optimizer over W > 1 ranks, `batch` is this rank's rows:
    each rank's loss counts 1 / W, its draws are its rows of the global
    batch's, and the metrics are the global batch's."""
    params = optimizer.params
    rank, world = getattr(optimizer, "rank", 0), getattr(optimizer,
                                                         "world", 1)

    def step(batch: Dict[str, torch.Tensor],
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        for p in params.values():
            p.grad = None
        with row_shard(rank, world):
            out = vae_loss(model, batch["mel"],
                           derive_seed(seed, step.count), eps)
            (out["loss"] / world if world > 1 else out["loss"]).backward()
        metrics = {k: out[k].detach() for k in VAE_LOSSES}
        with torch.no_grad():  # latent health (reference train_vae.py)
            if world > 1:
                mu = out["mu"].float()
                vec = all_reduce_sum(torch.stack(
                    [metrics[k].float() for k in VAE_LOSSES]
                    + [torch.exp(out["logvar"].float()).mean(),
                       mu.sum(), (mu * mu).sum()]))
                metrics = dict(zip(VAE_LOSSES, (vec[:5] / world).unbind()))
                metrics["var_mean"] = vec[5] / world
                n = mu.numel() * world
                mean = vec[6] / n
                metrics["mu_std"] = torch.sqrt(
                    (vec[7] / n - mean * mean).clamp_min(0.0))
            else:
                metrics["mu_std"] = out["mu"].float().std(unbiased=False)
                metrics["var_mean"] = torch.exp(
                    out["logvar"].float()).mean()
        metrics["grad_norm"] = optimizer.step(
            {n: p.grad for n, p in params.items()})
        step.count += 1
        return metrics

    step.count = 0
    return step


def backward_flops(model, run: Callable[[], torch.Tensor]) -> float:
    """FLOPs of run() (-> a loss) and its backward, counted once under
    utils/profiling.count_flops; the trainable tensors' .grad are as
    before the call."""
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    saved = {n: p.grad for n, p in params.items()}
    for p in params.values():
        p.grad = None
    with torch.autograd.set_multithreading_enabled(False):  # as the step
        flops = count_flops(lambda: run().backward())
    for n, p in params.items():
        p.grad = saved[n]
    return flops


def count_step_flops(model, batch: Dict[str, torch.Tensor], task: str,
                     microbatch: int = 1, seed: int = 0) -> float:
    """FLOPs of one step of `task` on `batch`: the forward and backward of
    its first slice, run once under utils/profiling.count_flops, times the
    slices (every slice has the same shapes; the counts depend on shapes
    only). The optimizer's elementwise update is not counted. The
    trainable tensors' .grad are as before the call."""
    _check_task(task)
    sub = _slices(batch, task, microbatch)[0]
    dens = global_dens(batch) if task == "tts_packed" else None
    return microbatch * backward_flops(
        model, lambda: slice_loss(model, sub, seed, task, dens)["loss"])

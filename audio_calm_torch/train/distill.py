"""Few-step ODE distillation (counterpart of audio_calm_tpu/train/distill.py).

The student is the model's own flow head, trained so that K conditional
Euler steps at cfg 1.0 reproduce the teacher's classifier-free-guided
trajectory; the teacher is a frozen copy of the same head taken before any
update. Serve the result with `ode_method: euler`, `steps: K`,
`cfg_scale: 1.0`.

One step (`make_distill_step`, JAX distill.py:142-301):
  - the conditioning runs the inference path under no_grad
    (eval/infer.tts_encode + tts_condition for TTS: predicted length,
    durations, alignment; asr_encode for ASR, its query-length mask);
  - x0 ~ N(0, 1) [B, T, x_dim] from a generator seeded by (seed, step), or
    given;
  - for each of the K intervals [t, t + 1/K]: the student's velocity at the
    current state (its head evaluation checkpointed when `remat`), the
    teacher's guided field (cond and uncond rows fused as one 2B batch when
    cfg_scale != 1 and > 0) integrated by `teacher_substeps` Euler
    substeps, the regression of (x_end - x) * K with a masked mean over
    the valid frames; the student then advances on its own prediction
    (gradient stopped), so it is supervised at the states inference visits;
  - the loss is the mean over the K intervals; one optimizer update.
With a distributed optimizer over W ranks (train/optim.AdamW), each rank
runs its rows of the global batch: x0 is its rows of the global draw
(ops/dropout.row_shard) and the masked mean's denominator the global valid
count, so the ranks' losses and gradients sum to the one-process step's.
Only the K student evaluations are recorded by autograd: on the card the
teacher's attention is the fused forward (K3) and the student's K3 forward
with the K5 backward (ops/attention_kernel.flash_attention).

`quality_probe` compares, on one batch, the student (K steps, cfg 1) and
the undistilled teacher at K steps against the teacher's dense guided
solution: TTS endpoint rel-L2 over the valid frames, ASR token agreement.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from audio_calm_torch.eval.infer import (asr_encode, asr_generate_ids,
                                         tts_condition, tts_encode,
                                         tts_generate_latents)
from audio_calm_torch.models.convert import (from_jax_params, jax_path,
                                             to_jax_params)
from audio_calm_torch.ops.dropout import derive_seed, draw, row_shard
from audio_calm_torch.parallel.mesh import all_reduce_sum

BATCH_KEYS = {"tts": ("text_ids", "attention_mask"),
              "asr": ("text_ids", "attention_mask", "latents", "audio_mask")}


def head_name(task: str) -> str:
    if task not in BATCH_KEYS:
        raise ValueError(f"unknown distillation task {task!r}")
    return f"{task}_flow_head"


def distill_param_label(path: Tuple[str, ...], task: str = "tts") -> str:
    """Only the task's flow head trains ("head"); everything else (LLM,
    LoRA, projector, predictors, the other head) is frozen, so the
    conditioning stays the teacher's."""
    return "head" if path[0] == head_name(task) else "frozen"


def split_for_distill(model: nn.Module, task: str = "tts"
                      ) -> Tuple[nn.Module, Dict[str, str]]:
    """A QwenCALM -> (teacher, labels): the teacher is a detached copy of
    the task's head as it is now, frozen (no dtype cast); the model's own
    head becomes the student, trainable in fp32 masters; every other
    parameter stops requiring gradients. labels: {name:
    distill_param_label}, for train/optim.AdamW."""
    head = getattr(model, head_name(task))
    teacher = copy.deepcopy(head).requires_grad_(False).eval()
    labels = {}
    for name, p in model.named_parameters():
        labels[name] = distill_param_label(jax_path(model, name), task)
        student = labels[name] != "frozen"
        if student:
            p.data = p.data.float()
        p.requires_grad_(student)
    return teacher, labels


@torch.no_grad()
def perturb_head(model: nn.Module, task: str, sigma: float,
                 seed: int = 0) -> None:
    """Add N(0, sigma) to every float leaf of the task's head (the
    weightless mode of scripts/distill_calm.py's --perturb-teacher: an
    untrained DiT head is degenerate and distills trivially). The draws
    come from np.random.default_rng(seed) over the head's JAX tree in the
    JAX tree's leaf order (its keys sorted at every level), so one sigma
    perturbs the same weights by the same amounts in both packages."""
    name = head_name(task)
    head = getattr(model, name)
    npr = np.random.default_rng(seed)

    def noise(tree):
        if isinstance(tree, dict):
            return {k: noise(tree[k]) for k in sorted(tree)}
        return tree + npr.normal(0, sigma, tree.shape).astype(tree.dtype)

    tree = noise(to_jax_params(head.state_dict()))
    sd = from_jax_params(tree)
    head.load_state_dict({k: v.to(head.state_dict()[k].dtype)
                          for k, v in sd.items()}, strict=True)


def _velocity(head: nn.Module, task: str, condition, ctx, cmask, xmask):
    """(x, t scalar) -> head(condition, x, t [B]) in eval mode."""
    def v(x, t_scalar):
        t = torch.full((x.shape[0],), t_scalar, dtype=torch.float32,
                       device=x.device)
        if task == "tts":
            return head(condition, x, t, context=ctx, context_mask=cmask,
                        x_mask=xmask)
        return head(condition, x, t, x_mask=xmask)
    return v


@torch.no_grad()
def distill_condition(model, batch: Dict[str, torch.Tensor], task: str,
                      t_grid: Optional[int] = None):
    """The inference conditioning of a batch -> (condition [B, T, D], ctx,
    ctx pad mask (TTS; None for ASR), valid [B, T] bool, x_dim)."""
    c = model.cfg
    if task == "tts":
        cond_vec, text_ctx, text_pad, num_frames = tts_encode(
            model, batch["text_ids"], batch["attention_mask"])
        condition, valid, _ = tts_condition(
            model, cond_vec, text_ctx, text_pad, num_frames,
            t_grid or c.max_audio_len)
        return condition, text_ctx, text_pad, valid, c.latent_dim
    condition, valid, _ = asr_encode(
        model, batch["latents"], batch["audio_mask"], batch["text_ids"],
        batch["attention_mask"], t_grid or c.max_text_len)
    return condition, None, None, valid, c.qwen.hidden_size


def make_distill_step(model, teacher: nn.Module, optimizer, task: str = "tts",
                      student_steps: int = 4, cfg_scale: float = 2.5,
                      teacher_substeps: int = 8, t_grid: Optional[int] = None,
                      remat: bool = True, seed: int = 0) -> Callable:
    """step(batch, x0=None) -> metrics {loss, loss_distill, grad_norm}; one
    optimizer update per call over the student head. batch: text_ids and
    attention_mask (+ latents and audio_mask for ASR). t_grid pins the flow
    grid (default max_audio_len for TTS, max_text_len queries for ASR).
    cfg_scale is the teacher's guidance being baked in; 1.0 distills the
    plain conditional field. `step.count` (the step) folds into the seed
    of x0's generator; `step.loss(batch, step_seed, x0=None)` is the loss
    alone (for FLOP counts)."""
    head_name(task)
    K, M = int(student_steps), int(teacher_substeps)
    h = 1.0 / K
    use_cfg = cfg_scale != 1.0 and cfg_scale > 0
    student = getattr(model, head_name(task))
    params = optimizer.params

    def loss_fn(batch, step_seed: int, x0: Optional[torch.Tensor] = None):
        condition, ctx, cmask, valid, x_dim = distill_condition(
            model, batch, task, t_grid)
        B, T = valid.shape
        xmask = ~valid
        if use_cfg:
            v2 = _velocity(
                teacher, task, torch.cat([condition,
                                          torch.zeros_like(condition)]),
                None if ctx is None else torch.cat([ctx,
                                                    torch.zeros_like(ctx)]),
                None if cmask is None else torch.cat([cmask, cmask]),
                torch.cat([xmask, xmask]))

            def v_teacher(x, t):
                out = v2(torch.cat([x, x]), t)
                return out[B:] + cfg_scale * (out[:B] - out[B:])
        else:
            v_teacher = _velocity(teacher, task, condition, ctx, cmask,
                                  xmask)
        v_stu = _velocity(student, task, condition, ctx, cmask, xmask)

        def v_student(x, t):
            if remat:
                return checkpoint(v_stu, x, t, use_reentrant=False)
            return v_stu(x, t)

        @torch.no_grad()
        def fine_solve(x, t0):
            hm = h / M
            for j in range(M):
                x = (x + v_teacher(x, t0 + j * hm) * hm).to(x.dtype)
            return x

        if x0 is None:
            gen = torch.Generator(device=condition.device)
            gen.manual_seed(derive_seed(step_seed, 0))
            x0 = draw(torch.randn, (B, T, x_dim), generator=gen,
                      device=condition.device, dtype=condition.dtype)
        x = x0.to(condition.device, condition.dtype)
        mf = valid.float()
        # data-parallel ranks: the global batch's valid count
        denom = all_reduce_sum(mf.sum().detach()).clamp_min(1.0)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(K):
            t0 = i * h
            v_pred = v_student(x, t0)
            x_end = fine_solve(x, t0)
            v_star = (x_end - x) / h
            err = (v_pred.float() - v_star.float()) ** 2
            total = total + (err.mean(dim=-1) * mf).sum() / denom
            # the student advances on its own prediction, gradient stopped
            x = (x + v_pred.detach() * h).to(x.dtype)
        loss = total / K
        return {"loss": loss, "loss_distill": loss}

    rank, world = getattr(optimizer, "rank", 0), getattr(optimizer,
                                                         "world", 1)

    def step(batch: Dict[str, torch.Tensor],
             x0: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        for p in params.values():
            p.grad = None
        with row_shard(rank, world):
            out = loss_fn(batch, derive_seed(seed, step.count), x0)
            out["loss"].backward()
        metrics = {k: v.detach() for k, v in out.items()}
        if world > 1:  # each rank's loss is its rows' share of the sum
            vec = all_reduce_sum(torch.stack([metrics["loss"],
                                              metrics["loss_distill"]]))
            metrics["loss"], metrics["loss_distill"] = vec.unbind()
        metrics["grad_norm"] = optimizer.step(
            {n: p.grad for n, p in params.items()})
        step.count += 1
        return metrics

    step.count = 0
    step.loss = loss_fn
    return step


@contextlib.contextmanager
def _head_swapped(model, task: str, head: nn.Module):
    """The model with `head` in place of its task head for the block."""
    name = head_name(task)
    own = getattr(model, name)
    setattr(model, name, head)
    try:
        yield model
    finally:
        setattr(model, name, own)


@torch.no_grad()
def quality_probe(model, teacher: nn.Module, batch: Dict[str, torch.Tensor],
                  task: str, student_steps: int, cfg_scale: float,
                  dense_steps: int = 128, seed: int = 7) -> Dict[str, float]:
    """Post-distillation probe on one batch, every solve from the same
    noise (a generator seeded by `seed`). TTS -> rel_err_student and
    rel_err_teacher_coarse: endpoint rel-L2 over the valid frames against
    the teacher's dense guided solution (euler-`dense_steps`); the coarse
    row is the undistilled teacher at the student's step count. ASR ->
    token_agreement_student and token_agreement_teacher_coarse against
    the dense decode."""
    device = model.soa_embed.device
    c = model.cfg

    def gen():
        return torch.Generator(device=device).manual_seed(seed)

    if task == "tts":
        def endpoint(steps, cfg):
            lat, n = tts_generate_latents(
                model, batch["text_ids"], batch["attention_mask"], gen(),
                steps=steps, cfg_scale=cfg, t_aud=c.max_audio_len,
                device=device)
            return lat.float().cpu().numpy(), n.cpu().numpy()

        with _head_swapped(model, task, teacher):
            ref, n = endpoint(dense_steps, cfg_scale)
            coarse, _ = endpoint(student_steps, cfg_scale)
        stu, _ = endpoint(student_steps, 1.0)
        valid = (np.arange(ref.shape[1])[None, :] < n[:, None])[:, :, None]

        def rel(x):
            return float(np.linalg.norm((x - ref) * valid)
                         / max(np.linalg.norm(ref * valid), 1e-12))

        return {"rel_err_student": rel(stu),
                "rel_err_teacher_coarse": rel(coarse)}

    def decode(steps, cfg):
        ids, q = asr_generate_ids(
            model, batch["latents"], batch["audio_mask"], batch["text_ids"],
            batch["attention_mask"], gen(), steps=steps, cfg_scale=cfg,
            num_queries=c.max_text_len, device=device)
        return ids.cpu().numpy(), q.cpu().numpy()

    with _head_swapped(model, task, teacher):
        ref_ids, q = decode(dense_steps, cfg_scale)
        coarse, _ = decode(student_steps, cfg_scale)
    stu, _ = decode(student_steps, 1.0)
    valid = np.arange(ref_ids.shape[1])[None, :] < q[:, None]
    return {"token_agreement_student": float((stu == ref_ids)[valid].mean()),
            "token_agreement_teacher_coarse": float(
                (coarse == ref_ids)[valid].mean())}

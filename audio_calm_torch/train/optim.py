"""Optimizer: the 5-group AdamW of the JAX package, with optax's semantics
(counterpart of audio_calm_tpu/train/optim.py).

  group       match (first wins)                          lr mult   wd
  soa         soa_embed                                   soa_mult  0
  proj        input_proj (excluding lora_*)               proj_mult wd
  head        tts_flow_head | asr_flow_head |
              asr_cross_attn                              head_mult wd
  no_decay    bias / norm scales                          1         0
  decay       everything else trainable (incl. LoRA)      1         wd
  frozen      llm base weights, embed table, opposite-
              task heads per task_mode, optional projector  --

The VAE's labels are `vae_param_label`'s (biases and GroupNorm scales
no_decay, the rest decay); distillation's are train/distill.py's.
`freeze` marks frozen tensors `requires_grad=False` and stores them in
`frozen_weights_dtype`; trainable ones are fp32 masters. `AdamW` is
optax.chain(clip_by_global_norm, multi_transform(adamw per group)), wrapped
in optax.MultiSteps when gradient_accumulation_steps > 1, written out by
hand because torch's defaults differ from optax's:
  - the schedule is read at the update count before the increment (the
    first update of a warmup schedule has LR 0);
  - clipping scales by max / norm only when norm >= max (no 1e-6 term);
  - AdamW's epsilon sits outside the square root, after bias correction,
    and weight decay is added to the Adam direction before the LR;
  - MultiSteps averages k calls (running mean) and advances the schedule
    only on real updates;
  - a trainable tensor that got no gradient counts as a zero gradient
    (weight decay still moves it).
Everything stays on the device: no host round trip per step.

`AdamW(..., distributed=True)` is data-parallel ZeRO-2 over the default
torch.distributed group (JAX: shard_step's zero_sharding): a tensor that
parallel/mesh.zero_leaf_spec shards has its gradient reduce-scattered
(summed) on that dim, its moments kept for this rank's shard only, the
update applied to that shard and the tensor all-gathered after it; small
or indivisible tensors are all-reduced and updated whole on every rank.
The global norm (for clipping and the metric) sums the shards' squares
across ranks, in the order of the one-process sum. `state_dict()` then
gathers the moments (every rank calls it) and `load_state_dict` takes a
full state and keeps this rank's shards.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from audio_calm_torch.config import TrainingConfig
from audio_calm_torch.models.convert import jax_path
from audio_calm_torch.parallel.mesh import rank_world, zero_leaf_spec

GROUPS = ("decay", "no_decay", "proj", "head", "soa")


def calm_param_label(path: Tuple[str, ...], task_mode: str = "mix",
                     freeze_projector: bool = False) -> str:
    """A JAX parameter path -> its optimizer group (or "frozen")."""
    joined = "/".join(path)
    is_lora = path[-1] in ("lora_a", "lora_b")
    if path[0] == "llm" and not is_lora:
        return "frozen"
    if path[0] in ("embed", "vae"):
        return "frozen"
    if task_mode == "tts" and path[0] in (
            "asr_flow_head", "asr_cross_attn", "asr_query_embed"):
        return "frozen"
    if task_mode == "asr" and path[0] in (
            "tts_flow_head", "tts_len_predictor", "tts_dur_predictor"):
        return "frozen"
    if freeze_projector and path[0] == "input_proj":
        return "frozen"
    if "soa_embed" in joined:
        return "soa"
    if path[0] == "input_proj" and not is_lora:
        return "proj"
    if path[0] in ("tts_flow_head", "asr_flow_head", "asr_cross_attn"):
        return "head"
    if path[-1] in ("bias", "scale"):
        return "no_decay"
    return "decay"


def vae_param_label(path: Tuple[str, ...]) -> str:
    """A JAX AcousticVAE parameter path -> "no_decay" (biases, GroupNorm
    scales) or "decay"."""
    return "no_decay" if path[-1] in ("bias", "scale") else "decay"


def param_labels(model: nn.Module, label_fn) -> Dict[str, str]:
    """{name: label_fn(its JAX path)} over every parameter of a port
    model."""
    return {name: label_fn(jax_path(model, name))
            for name, _ in model.named_parameters()}


def freeze(model: nn.Module, cfg: TrainingConfig, task_mode: str = "tts",
           freeze_projector: bool = False) -> Dict[str, str]:
    """Label every parameter of a QwenCALM by its JAX path; frozen ones
    stop requiring gradients and are stored in `cfg.frozen_weights_dtype`,
    trainable ones become fp32 masters. Returns {name: label}."""
    frozen_dtype = getattr(torch, cfg.frozen_weights_dtype)
    labels = {}
    for name, p in model.named_parameters():
        label = calm_param_label(jax_path(model, name), task_mode,
                                 freeze_projector)
        labels[name] = label
        frozen = label == "frozen"
        p.data = p.data.to(frozen_dtype if frozen else torch.float32)
        p.requires_grad_(not frozen)
    return labels


def make_schedule(cfg: TrainingConfig, total_steps: int
                  ) -> Callable[[int], float]:
    """update count -> learning rate (optax's warmup_cosine_decay /
    joined linear / constant schedules)."""
    lr = cfg.learning_rate
    warmup = max(int(total_steps * cfg.warmup_ratio), 1)

    def linear(count, start, end, steps):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (start - end) * frac + end

    if cfg.lr_scheduler_type == "cosine":
        decay = max(total_steps, warmup + 1) - warmup

        def schedule(count):
            if count < warmup:
                return linear(count, 0.0, lr, warmup)
            c = min(count - warmup, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return schedule
    if cfg.lr_scheduler_type == "linear":
        rest = max(total_steps - warmup, 1)
        return lambda c: (linear(c, 0.0, lr, warmup) if c < warmup
                          else linear(c - warmup, lr, 0.0, rest))
    return lambda c: lr


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, fp32, on the device."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def _nccl() -> bool:
    return dist.get_backend() == "nccl"


def reduce_scatter(t: torch.Tensor, dim: int, rank: int,
                   world: int) -> torch.Tensor:
    """This rank's shard (along `dim`) of the sum over ranks of `t`, laid
    out as t is."""
    if _nccl():
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // world,) + x.shape[1:])
        dist.reduce_scatter_tensor(out, x)
        return out.movedim(0, dim).contiguous()
    dist.all_reduce(t)  # gloo has no reduce-scatter
    c = t.shape[dim] // world
    return t.narrow(dim, rank * c, c).contiguous()


def all_gather(shard: torch.Tensor, dim: int, world: int) -> torch.Tensor:
    """The ranks' shards joined along `dim`, in rank order."""
    x = shard.movedim(dim, 0).contiguous()
    if _nccl():
        buf = x.new_empty((x.shape[0] * world,) + x.shape[1:])
        dist.all_gather_into_tensor(buf, x)
    else:
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        buf = torch.cat(parts)
    return buf.movedim(0, dim)


class AdamW:
    """The JAX package's make_optimizer over named trainable tensors.

    params: {name: tensor} (updated in place); labels: {name: group}.
    `step(grads)` takes {name: gradient or None} and returns the global
    norm of those gradients (before clipping). distributed=True: ZeRO-2
    over the default process group (the module docstring); the gradients
    passed in are this rank's and are summed over the ranks here."""

    def __init__(self, params: Dict[str, torch.Tensor], labels: Dict[str, str],
                 cfg: TrainingConfig, total_steps: int,
                 distributed: bool = False):
        self.params = params
        self.distributed = distributed
        self.rank, self.world = rank_world() if distributed else (0, 1)
        # ZeRO: the dim each tensor's moments and update are sharded on
        self.zero_dim = {n: zero_leaf_spec(self.world, p) if distributed
                         else None for n, p in params.items()}
        self.schedule = make_schedule(cfg, total_steps)
        self.hyper = {  # group -> (lr multiplier, weight decay)
            "decay": (1.0, cfg.weight_decay), "no_decay": (1.0, 0.0),
            "proj": (cfg.proj_lr_mult, cfg.weight_decay),
            "head": (cfg.head_lr_mult, cfg.weight_decay),
            "soa": (cfg.soa_lr_mult, 0.0),
        }
        self.group = {n: labels[n] for n in params}
        bad = set(self.group.values()) - set(GROUPS)
        if bad:
            raise ValueError(f"no optimizer group for labels {sorted(bad)}")
        self.b1, self.b2, self.eps = (cfg.adam_beta1, cfg.adam_beta2,
                                      cfg.adam_epsilon)
        self.max_norm = cfg.max_grad_norm
        self.k = cfg.gradient_accumulation_steps
        def zeros(n, p):
            return torch.zeros_like(self._shard(n, p), dtype=torch.float32)

        self.mu = {n: zeros(n, p) for n, p in params.items()}
        self.nu = {n: zeros(n, p) for n, p in params.items()}
        self.acc = ({n: zeros(n, p) for n, p in params.items()}
                    if self.k > 1 else None)
        self.count = 0  # real updates so far (the schedule's count)
        self.mini_step = 0

    def _shard(self, n: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of tensor `n`'s full-shape `t` (t itself when
        it is not sharded)."""
        d = self.zero_dim[n]
        if d is None:
            return t
        c = t.shape[d] // self.world
        return t.narrow(d, self.rank * c, c)

    def _full(self, tensors: Optional[Dict[str, torch.Tensor]]):
        """Per-rank shards -> full tensors (collective)."""
        if tensors is None or not self.distributed:
            return tensors
        return {n: t if self.zero_dim[n] is None
                else all_gather(t, self.zero_dim[n], self.world)
                for n, t in tensors.items()}

    def state_dict(self) -> Dict:
        """The optimizer state (for train/checkpoint.py): the moments `mu`
        and `nu`, the MultiSteps accumulator `acc` (None when k = 1), the
        update count and the position inside an accumulation; full tensors
        (distributed: gathered, so every rank must call it)."""
        return {"mu": self._full(self.mu), "nu": self._full(self.nu),
                "acc": self._full(self.acc), "count": self.count,
                "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copy a `state_dict()` into this optimizer's tensors in place
        (their devices and dtypes stay; distributed, this rank's shards);
        names and shapes must match."""
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("optimizer state: gradient_accumulation_steps "
                             "differs from the saved run's")
        for key in ("mu", "nu", "acc"):
            mine, saved = getattr(self, key), state[key]
            if mine is None:
                continue
            if set(mine) != set(saved):
                raise ValueError(f"optimizer state {key}: the saved tensors "
                                 "are not this optimizer's")
            for n, t in mine.items():
                full = self.params[n].shape
                if full != saved[n].shape:
                    raise ValueError(f"optimizer state {key}.{n}: shape "
                                     f"{tuple(saved[n].shape)}, expected "
                                     f"{tuple(full)}")
                t.copy_(self._shard(n, saved[n].to(t.device)))
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    def _reduce(self, g: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Sum the ranks' gradients: this rank's shard of a sharded
        tensor's, a replicated tensor's whole."""
        out = {}
        for n, t in g.items():
            d = self.zero_dim[n]
            if d is None:
                dist.all_reduce(t)
                out[n] = t
            else:
                out[n] = reduce_scatter(t, d, self.rank, self.world)
        return out

    def _norm(self, g: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of gradients `g` (shards summed over ranks)."""
        sq = {n: (t.float() ** 2).sum() for n, t in g.items()}
        if self.distributed:
            sharded = [n for n in g if self.zero_dim[n] is not None]
            if sharded:
                vec = torch.stack([sq[n] for n in sharded])
                dist.all_reduce(vec)
                sq.update(zip(sharded, vec.unbind()))
        return torch.sqrt(sum(sq[n] for n in g))

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        g = {n: (grads.get(n) if grads.get(n) is not None
                 else torch.zeros_like(p)).float()
             for n, p in self.params.items()}
        if self.distributed:
            g = self._reduce(g)
        norm = self._norm(g)
        if self.acc is None:
            self._update(g, norm)
            return norm
        for n in g:  # optax.MultiSteps, running mean
            self.acc[n] += (g[n] - self.acc[n]) / (self.mini_step + 1)
        self.mini_step += 1
        if self.mini_step == self.k:
            self._update(self.acc, self._norm(self.acc))
            self.mini_step = 0
            for a in self.acc.values():
                a.zero_()
        return norm

    def _update(self, g: Dict[str, torch.Tensor], norm: torch.Tensor) -> None:
        """One AdamW update from gradients `g` (distributed: this rank's
        shards) whose global norm is `norm`; sharded tensors are gathered
        after it."""
        clip = norm >= self.max_norm  # optax: scale when not norm < max
        c = self.count + 1
        bc1, bc2 = 1.0 - self.b1 ** c, 1.0 - self.b2 ** c
        base_lr = self.schedule(self.count)
        for n, p in self.params.items():
            gn = torch.where(clip, g[n] / norm * self.max_norm, g[n])
            mu, nu = self.mu[n], self.nu[n]
            mu.copy_((1.0 - self.b1) * gn + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * gn * gn + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            mult, wd = self.hyper[self.group[n]]
            ps = self._shard(n, p)
            u = u + wd * ps.float()
            ps.add_((u * (-base_lr * mult)).to(p.dtype))
            if self.distributed and self.zero_dim[n] is not None:
                p.copy_(all_gather(ps, self.zero_dim[n], self.world))
        self.count = c

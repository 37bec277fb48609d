"""Distill a trained CALM flow head into a few-step student on the card
(counterpart of scripts/distill_calm.py):

    python -m audio_calm_torch.train.distill_calm --config configs/tts.yaml \\
        [--components <dir>] [--task tts|asr] [--student-steps 4] \\
        [--teacher-substeps 8] [--cfg-scale 2.5] [--max-steps N] \\
        [--perturb-teacher SIGMA] [--byte-tokenizer] [--device cpu]

The student is the same head architecture, trained (train/distill.py) so
that K conditional Euler steps reproduce the teacher's classifier-free-
guided trajectory; serve the result with evaluation.ode_method=euler,
evaluation.steps=K (asr_steps for ASR) and cfg_scale 1.0.

The teacher is the model built from training.seed (the Qwen2 base from
model.qwen_path when it is a directory), with the trained components of
--components, else those of the model.pretrained_*_path checkpoints.
--perturb-teacher adds N(0, SIGMA) to every weight of the task's head
first, for runs without trained weights (an untrained DiT head is
degenerate and distills trivially to 0 loss). TTS distillation reads only
the text prompts of the configured dataset; ASR also its audio latents.
The run lives under `<training.output_dir>/distill_<task>` (checkpoints,
resume and metrics as the training section says), for
training.max_steps steps (--max-steps, else 2000 when unset); at the end a
quality probe runs on one batch of min(batch, 4) and the components are
written in the reference layout to `<that dir>/components` (what the
server's --components reads).

--distributed: one process per device over torch.distributed, from
torchrun's variables (parallel/mesh.init_distributed_from_env; NCCL on
cuda:LOCAL_RANK, gloo with --device cpu): the global batch is
per_device_train_batch_size x the world size, each rank loads its rows
and the step is data-parallel with ZeRO-2 (train/optim.AdamW), the same
run as one process over the global batches. Rank 0 alone logs and writes
the checkpoints and the components; every rank needs the same
training.output_dir (a shared directory), where a resumed run reads them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, List

import torch
from torch import nn

from audio_calm_torch import resolve_device
from audio_calm_torch.config import CALMConfig, load_config
from audio_calm_torch.data.collator import calm_batch_iterator
from audio_calm_torch.data.datasets import CalmDataset
from audio_calm_torch.data.prefetch import prefetch
from audio_calm_torch.data.tokenizer import load_tokenizer
from audio_calm_torch.models.calm import QwenCALM
from audio_calm_torch.parallel.mesh import (barrier, finish_distributed,
                                            init_distributed_from_env,
                                            is_primary, rank_world)
from audio_calm_torch.train.checkpoint import save_components
from audio_calm_torch.train.distill import (BATCH_KEYS, make_distill_step,
                                            perturb_head, quality_probe,
                                            split_for_distill)
from audio_calm_torch.train.loop import run_training
from audio_calm_torch.train.optim import AdamW
from audio_calm_torch.train.train_calm import build_model


@dataclasses.dataclass
class DistillRun:
    """What a run leaves: the model (its head the distilled student), the
    frozen teacher head, the optimizer, the per-step records, the steps,
    where the components went, the probe's numbers, and the run's step,
    data (`batches(start_step)`) and batch filter, for measuring more steps
    of the same recipe."""
    model: QwenCALM
    teacher: nn.Module
    optimizer: AdamW
    history: List[Dict]
    total_steps: int
    components_dir: str
    probe: Dict[str, float]
    step: Callable
    batches: Callable
    batch_filter: Callable


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="configs/tts.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--task", choices=("tts", "asr"), default="tts")
    p.add_argument("--student-steps", type=int, default=4)
    p.add_argument("--teacher-substeps", type=int, default=8)
    p.add_argument("--cfg-scale", type=float, default=None,
                   help="teacher guidance scale to bake in (default: the "
                        "config's evaluation cfg scale for the task)")
    p.add_argument("--components", default=None,
                   help="trained component directory (the reference layout "
                        "train_calm writes); default: model.pretrained_* "
                        "paths")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--perturb-teacher", type=float, default=None,
                   metavar="SIGMA",
                   help="add N(0, SIGMA) to every weight of the task head "
                        "before distilling (runs without trained weights)")
    p.add_argument("--byte-tokenizer", action="store_true",
                   help="the byte fallback tokenizer (smoke runs)")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' only "
                        "when asked)")
    p.add_argument("--distributed", action="store_true",
                   help="one process per device from torchrun's variables "
                        "(NCCL; gloo with --device cpu)")
    return p.parse_args(argv)


def distill(argv=None) -> DistillRun:
    args = parse_args(argv)
    cfg = load_config(args.config, cls=CALMConfig, overrides=args.override)
    t, d, m, e = cfg.training, cfg.data, cfg.model, cfg.evaluation
    task = args.task
    cfg_scale = args.cfg_scale if args.cfg_scale is not None else (
        e.cfg_scale if task == "tts" else e.asr_cfg_scale)
    device = (init_distributed_from_env(args.device) if args.distributed
              else resolve_device(args.device))
    rank, world = rank_world()
    tokenizer = load_tokenizer(m, byte_fallback=args.byte_tokenizer)

    src = d.datasets.get(task)
    ds = CalmDataset(tokenizer,
                     asr_latent_dir=src.latent_dir if src and task == "asr"
                     else None,
                     asr_subsets=src.subsets if src else None,
                     tts_latent_dir=src.latent_dir if src and task == "tts"
                     else None,
                     tts_subsets=src.subsets if src else None,
                     max_text_len=d.max_text_len,
                     max_audio_len=d.max_audio_len, task_mode=task,
                     latent_dim=m.latent_dim)
    if len(ds) == 0:
        raise FileNotFoundError("no data found for the distillation task")

    components = (args.components if args.components
                  and os.path.isdir(args.components) else None)
    model = build_model(cfg, device, components)
    if components:
        print(f"loaded teacher components from {components}")
    if args.perturb_teacher:
        perturb_head(model, task, args.perturb_teacher)
        print(f"teacher {task}_flow_head perturbed with sigma="
              f"{args.perturb_teacher} (weightless-harness mode)")

    # the run's own output root: its train state (the head alone) is not a
    # train_calm run's
    out_root = os.path.join(t.output_dir, f"distill_{task}")
    t = dataclasses.replace(t, output_dir=out_root,
                            run_name=f"{t.run_name}_distill_{task}")
    global_bs = t.per_device_train_batch_size * world
    total_steps = args.max_steps or (t.max_steps if t.max_steps > 0
                                     else 2000)

    teacher, labels = split_for_distill(model, task)
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    n_train = sum(p.numel() for p in params.values())
    print(f"distilling {task} head ({n_train / 1e6:.2f}M params) to "
          f"{args.student_steps} steps, teacher cfg={cfg_scale} x "
          f"{args.teacher_substeps} substeps | steps: {total_steps} | "
          f"global batch: {global_bs} | device: {device}"
          + (f" | rank {rank} of {world}" if args.distributed else ""))
    opt = AdamW(params, labels, t, total_steps, distributed=args.distributed)
    step = make_distill_step(model, teacher, opt, task,
                             student_steps=args.student_steps,
                             cfg_scale=cfg_scale,
                             teacher_substeps=args.teacher_substeps,
                             seed=t.seed)
    keys = BATCH_KEYS[task]
    pad_id = tokenizer.pad_token_id or 0
    task_prob = 1.0 if task == "tts" else 0.0

    def batch_filter(raw):
        return {k: torch.from_numpy(raw[k]).to(device) for k in keys}

    def batches(start_step: int):
        return prefetch(calm_batch_iterator(
            ds, global_bs, pad_id, m.latent_dim, task_prob_tts=task_prob,
            training=True, seed=t.seed + 1_000_003 * start_step,
            process_index=rank, process_count=world))

    history = run_training(step, batches, t, total_steps, optimizer=opt,
                           batch_filter=batch_filter, device=device)

    # measured before / after on one held-out-style batch
    raw = next(iter(calm_batch_iterator(
        ds, min(global_bs, 4), pad_id, m.latent_dim, task_prob_tts=task_prob,
        training=False, seed=t.seed + 1, epochs=1)))
    probe = quality_probe(model, teacher, batch_filter(raw), task,
                          args.student_steps, cfg_scale)
    print(f"quality probe (teacher-dense reference): {json.dumps(probe)}")

    out_dir = os.path.join(out_root, "components")
    if is_primary():
        save_components(model, out_dir)
        print(f"saved distilled components to {out_dir}")
    barrier()
    print(f"serve with: evaluation.ode_method=euler "
          f"evaluation.steps={args.student_steps} evaluation.cfg_scale=1.0"
          if task == "tts" else
          f"serve with: evaluation.ode_method=euler "
          f"evaluation.asr_steps={args.student_steps} "
          f"evaluation.asr_cfg_scale=1.0")
    return DistillRun(model, teacher, opt, history, total_steps, out_dir,
                      probe, step, batches, batch_filter)


def main(argv=None) -> int:
    distill(argv)
    finish_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())

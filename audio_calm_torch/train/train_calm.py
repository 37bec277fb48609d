"""Train QwenCALM on the card (counterpart of scripts/train_calm.py, its
`task_mode: tts` recipe):

    python -m audio_calm_torch.train.train_calm --config configs/tts.yaml \\
        [--override training.learning_rate=1e-4 ...] [--max-steps N] \\
        [--byte-tokenizer] [--device cpu]

Reads the latent store the config names (data.datasets.tts), builds the
model with random weights from training.seed (the Qwen2 base from a HF
directory at model.qwen_path when there is one, then the components of
the model.pretrained_*_path checkpoints), freezes the base (stored in
training.frozen_weights_dtype), and trains through train/loop.
run_training: packed TTS steps when data.tts_pack_rows > 0 (the shipped
recipe), plain bucketed batches otherwise; each step split into
tts_microbatch_steps (or microbatch_steps) slices. With packing and no
--max-steps, the LR schedule spans the sampled estimate of the packed
steps (fill 0.87) for num_train_epochs, the data stops after that many
exact epochs and the loop is capped at 1.25 times the estimate.
Checkpoints, resume, eval on eval_latent_dir and best-model retention
follow the training section. At the end the components are written to
`<output_dir>/components` in the reference layout (the server's
`--components` reads it). task_mode asr and mix are ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Callable, Dict, List

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.config import CALMConfig, load_config
from audio_calm_torch.data.collator import (calm_batch_iterator,
                                            estimate_packed_steps_per_epoch)
from audio_calm_torch.data.datasets import CalmDataset
from audio_calm_torch.data.prefetch import prefetch
from audio_calm_torch.data.tokenizer import load_tokenizer
from audio_calm_torch.models.calm import QwenCALM
from audio_calm_torch.models.flagship import random_normal_
from audio_calm_torch.train.checkpoint import (load_qwen2_backbone,
                                               save_components, soft_restart)
from audio_calm_torch.train.loop import run_training
from audio_calm_torch.train.optim import AdamW, freeze
from audio_calm_torch.train.steps import (TASK_KEYS, count_step_flops,
                                          make_calm_eval_step, make_calm_step)

_HOST_KEYS = ("task", "n_samples")


@dataclasses.dataclass
class TrainRun:
    """What a run leaves: the trained model and its optimizer (the train
    state), the per-step records, the steps the schedule spans and the
    loop's cap, where the components went, and the run's step, data
    (`batches(start_step)`), batch filter and FLOP count, for measuring
    more steps of the same recipe."""
    model: QwenCALM
    optimizer: AdamW
    history: List[Dict]
    total_steps: int
    loop_cap: int
    components_dir: str
    step: Callable
    batches: Callable
    batch_filter: Callable
    step_flops: Callable


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="configs/calm.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--byte-tokenizer", action="store_true",
                   help="the byte fallback tokenizer (smoke runs)")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' only "
                        "when asked)")
    return p.parse_args(argv)


def _dataset(cfg: CALMConfig, tokenizer, latent_dir, subsets) -> CalmDataset:
    d, m = cfg.data, cfg.model
    return CalmDataset(tokenizer, tts_latent_dir=latent_dir,
                       tts_subsets=subsets, max_text_len=d.max_text_len,
                       max_audio_len=d.max_audio_len, task_mode=d.task_mode,
                       latent_dim=m.latent_dim)


def build_model(cfg: CALMConfig, device) -> QwenCALM:
    """The model before freezing: random normal weights from
    training.seed on `device`, the Qwen2 base from model.qwen_path when it
    is a directory, then the pretrained components."""
    m, t = cfg.model, cfg.training
    with torch.device(device):
        model = QwenCALM(m, compute_dtype=torch.bfloat16 if t.bf16
                         else torch.float32)
    random_normal_(model, seed=t.seed)
    if m.qwen_path and os.path.isdir(m.qwen_path):
        try:
            load_qwen2_backbone(model, m.qwen_path)
            print("loaded Qwen2 backbone weights")
        except Exception as e:
            print(f"warning: Qwen2 weight load failed: {e}; random init")
    soft_restart(model, {
        "input_proj": m.pretrained_projector_path,
        "tts_flow_head": m.pretrained_tts_head_path,
        "tts_len_predictor": m.pretrained_tts_len_pred_path,
        "asr_flow_head": m.pretrained_asr_head_path,
        "asr_query_embed": m.pretrained_asr_query_path,
        "lora": m.pretrained_lora_path,
    })
    return model


def train(argv=None) -> TrainRun:
    args = parse_args(argv)
    cfg = load_config(args.config, cls=CALMConfig, overrides=args.override)
    t, d, m = cfg.training, cfg.data, cfg.model
    if d.task_mode != "tts":
        raise NotImplementedError(
            f"task_mode {d.task_mode!r} is not ported yet (ROADMAP Queue 1 "
            "item 4, ASR training and the mix); the port trains 'tts'")
    if t.frozen_weights_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"unknown frozen_weights_dtype {t.frozen_weights_dtype!r}")
    device = resolve_device(args.device)
    tokenizer = load_tokenizer(m, byte_fallback=args.byte_tokenizer)
    tts = d.datasets.get("tts")
    ds = _dataset(cfg, tokenizer, tts.latent_dir if tts else None,
                  tts.subsets if tts else None)
    if len(ds) == 0:
        raise FileNotFoundError("no training data found")
    print(f"dataset: {len(ds.tts_items)} tts items")

    global_bs = t.per_device_train_batch_size
    total_steps = args.max_steps or int(
        max(len(ds) // global_bs, 1) * t.num_train_epochs)
    pack_tts = d.tts_pack_rows > 0
    k = t.tts_microbatch_steps or t.microbatch_steps
    if pack_tts and d.tts_pack_rows % max(k, 1):
        raise ValueError(f"data.tts_pack_rows={d.tts_pack_rows} must be "
                         f"divisible by microbatch_steps = {k}")
    epochs_arg, loop_cap = None, total_steps
    if not args.max_steps and pack_tts:
        spe = estimate_packed_steps_per_epoch(
            ds, "tts", d.tts_pack_rows, d.tts_pack_len, d.tts_pack_segments,
            fill=0.87)
        total_steps = max(int(np.ceil(spe * t.num_train_epochs)), 1)
        epochs_arg = max(int(np.ceil(t.num_train_epochs)), 1)
        loop_cap = int(np.ceil(total_steps * 1.25))
        print(f"packing: ~{spe} steps/epoch (sampled-cost estimate) -> LR "
              f"schedule over {total_steps} steps; stop after {epochs_arg} "
              f"exact epochs (cap {loop_cap})")

    model = build_model(cfg, device)
    labels = freeze(model, t, task_mode=d.task_mode,
                    freeze_projector=m.freeze_projector)
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    n_train = sum(p.numel() for p in trainable.values())
    n_froz = sum(p.numel() for p in model.parameters()) - n_train
    print(f"trainable: {n_train / 1e6:.2f}M | frozen: {n_froz / 1e6:.2f}M | "
          f"steps: {total_steps} | global batch: {global_bs} | device: "
          f"{device}")
    opt = AdamW(trainable, labels, t, total_steps)
    step_task = "tts_packed" if pack_tts else "tts"
    step = make_calm_step(model, opt, step_task, microbatch=k, seed=t.seed)
    flops_cache: Dict[tuple, float] = {}

    def batch_filter(raw):
        keys = TASK_KEYS[raw["task"]]
        return {key: torch.from_numpy(raw[key]).to(device) for key in keys}

    def step_flops(raw):
        """FLOPs of the step a batch dispatches, counted once per (task,
        shapes) by a run of its first slice (steps.count_step_flops)."""
        key = (raw["task"],) + tuple(sorted(
            (name, np.shape(v)) for name, v in raw.items()
            if name not in _HOST_KEYS))
        if key not in flops_cache:
            flops_cache[key] = count_step_flops(
                model, batch_filter(raw), raw["task"], k, seed=t.seed)
        return flops_cache[key]

    eval_fn = None
    if tts and tts.eval_latent_dir:
        eval_ds = _dataset(cfg, tokenizer, tts.eval_latent_dir,
                           d.eval_subsets)
        if len(eval_ds):
            eval_step = make_calm_eval_step(model, "tts")

            def eval_fn():
                losses = []
                it = calm_batch_iterator(
                    eval_ds, min(global_bs, 8), tokenizer.pad_token_id or 0,
                    m.latent_dim, task_prob_tts=d.task_prob_tts,
                    training=False, seed=0, epochs=1,
                    asr_text_pad=d.asr_text_pad)
                for i, b in enumerate(it):
                    if i >= 8:
                        break
                    out = eval_step(batch_filter(b), seed=i)
                    losses.append(float(out["loss"]))
                return ({"loss": sum(losses) / len(losses)} if losses
                        else {})

    def batches(start_step: int):
        # a resumed run reseeds its data by the step it resumed at, so the
        # epoch head is not replayed
        return prefetch(calm_batch_iterator(
            ds, global_bs, tokenizer.pad_token_id or 0, m.latent_dim,
            task_prob_tts=d.task_prob_tts, training=True,
            seed=t.seed + 1_000_003 * start_step, epochs=epochs_arg,
            audio_buckets=d.audio_buckets,
            length_group_window=d.length_group_window,
            asr_text_pad=d.asr_text_pad, asr_pack_rows=d.asr_pack_rows,
            asr_pack_len=d.asr_pack_len,
            asr_pack_segments=d.asr_pack_segments,
            tts_pack_rows=d.tts_pack_rows if pack_tts else 0,
            tts_pack_len=d.tts_pack_len,
            tts_pack_segments=d.tts_pack_segments))

    history = run_training(step, batches, t, loop_cap, optimizer=opt,
                           eval_fn=eval_fn, batch_filter=batch_filter,
                           step_flops=step_flops, device=device)
    out_dir = os.path.join(t.output_dir, "components")
    save_components(model, out_dir)
    print(f"saved components to {out_dir}")
    return TrainRun(model, opt, history, total_steps, loop_cap, out_dir,
                    step, batches, batch_filter, step_flops)


def main(argv=None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

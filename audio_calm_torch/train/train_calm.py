"""Train QwenCALM on the card (counterpart of scripts/train_calm.py):

    python -m audio_calm_torch.train.train_calm --config configs/calm.yaml \\
        [--override training.learning_rate=1e-4 ...] [--max-steps N] \\
        [--byte-tokenizer] [--device cpu]

Reads the latent stores the config names (data.datasets.asr and .tts, as
data.task_mode asks: "tts", "asr" or "mix"), builds the model with random
weights from training.seed (the Qwen2 base from a HF directory at
model.qwen_path when there is one, then the components of the
model.pretrained_*_path checkpoints), freezes the base (stored in
training.frozen_weights_dtype) and the other task's heads, and trains
through train/loop.run_training: one step per task on one AdamW, picked
per batch by its task (the mix draws each batch's task ~ Bernoulli(
task_prob_tts)); packed steps for a task whose data.<task>_pack_rows > 0,
plain bucketed batches otherwise; each step split into
<task>_microbatch_steps (or microbatch_steps) slices. With packing and no
--max-steps, the LR schedule spans the sampled estimate of the steps an
epoch takes, summed over the tasks (fill 0.95 for packed ASR, 0.87 for
packed TTS, n // batch for a plain task), for num_train_epochs; the data
stops after that many exact epochs and the loop is capped at 1.25 times
the estimate. Checkpoints, resume, eval on the eval_latent_dirs (one eval
step per task, the plain forward) and best-model retention follow the
training section. At the end the components are written to
`<output_dir>/components` in the reference layout (the server's
`--components` reads it).

`--distributed` (scripts/train_calm.py's flag): one process per device
over torch.distributed, from torchrun's variables (parallel/mesh.
init_distributed_from_env; NCCL on cuda:LOCAL_RANK, gloo with `--device
cpu`): the global batch is per_device_train_batch_size x the world size,
each rank loads its rows of every batch (the collator's process_index
slice; packing from header metadata), and the steps are data-parallel with
ZeRO-2 (train/steps.py, train/optim.AdamW), the same run as one process
over the global batches. Each microbatch slice (global rows / microbatch
steps) must divide by the world size. Rank 0 alone logs and writes the
checkpoints and the components; every rank needs the same
training.output_dir (a shared directory), where a resumed run reads them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Callable, Dict, List, Optional

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
from audio_calm_torch.parallel.mesh import (barrier, finish_distributed,
                                            init_distributed_from_env,
                                            is_primary, rank_world)
from audio_calm_torch.train.checkpoint import (COMPONENTS,
                                               load_qwen2_backbone,
                                               save_components, soft_restart)
from audio_calm_torch.train.loop import run_training
from audio_calm_torch.train.optim import AdamW, freeze
from audio_calm_torch.train.steps import (TASK_KEYS, count_step_flops,
                                          make_calm_eval_step, make_calm_step)
from audio_calm_torch.utils.profiling import device_peak_flops


@dataclasses.dataclass
class TrainRun:
    """What a run leaves: the trained model and its optimizer (the train
    state), the per-step records, the steps the schedule spans and the
    loop's cap, where the components went, and the run's steps (by batch
    task), data (`batches(start_step)`), batch filter and FLOP count, for
    measuring more steps of the same recipe."""
    model: QwenCALM
    optimizer: AdamW
    history: List[Dict]
    total_steps: int
    loop_cap: int
    components_dir: str
    steps: Dict[str, Callable]
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
    p.add_argument("--distributed", action="store_true",
                   help="one process per device from torchrun's variables "
                        "(NCCL; gloo with --device cpu)")
    return p.parse_args(argv)


def _dataset(cfg: CALMConfig, tokenizer, dirs: Dict[str, str],
             subsets: Dict[str, str]) -> CalmDataset:
    """The store of the tasks in `dirs` ({task: latent dir})."""
    d, m = cfg.data, cfg.model
    return CalmDataset(tokenizer, asr_latent_dir=dirs.get("asr"),
                       asr_subsets=subsets.get("asr"),
                       tts_latent_dir=dirs.get("tts"),
                       tts_subsets=subsets.get("tts"),
                       max_text_len=d.max_text_len,
                       max_audio_len=d.max_audio_len, task_mode=d.task_mode,
                       latent_dim=m.latent_dim)


def _fake_max_batch(cfg: CALMConfig, task: str, batch_size: int
                    ) -> Dict[str, np.ndarray]:
    """A batch of `task` at the config's largest grid (zeros; text masks
    full where the shapes need a valid text), for the FLOP line."""
    d, m = cfg.data, cfg.model
    i32, f32 = np.int32, np.float32
    L, t_aud, D = d.max_text_len, d.max_audio_len, m.latent_dim
    if task == "asr_packed":
        R, T, S = d.asr_pack_rows, d.asr_pack_len, d.asr_pack_segments
        return dict(latents=np.zeros((R, S, t_aud, D), f32),
                    latent_mask=np.zeros((R, S, t_aud), i32),
                    labels=np.zeros((R, S, L), i32),
                    tok_ids=np.zeros((R, T), i32), kind=np.zeros((R, T), i32),
                    gather_idx=np.zeros((R, T), i32),
                    segment_ids=np.zeros((R, T), i32),
                    position_ids=np.zeros((R, T), i32),
                    ctx_idx=np.zeros((R, S, t_aud), i32))
    if task == "tts_packed":
        R, T, S = d.tts_pack_rows, d.tts_pack_len, d.tts_pack_segments
        return dict(latents=np.zeros((R, S, t_aud, D), f32),
                    audio_mask=np.zeros((R, S, t_aud), i32),
                    text_mask=np.ones((R, S, L), i32),
                    tok_ids=np.zeros((R, T), i32), kind=np.zeros((R, T), i32),
                    segment_ids=np.zeros((R, T), i32),
                    position_ids=np.zeros((R, T), i32),
                    ctx_idx=np.zeros((R, S, L), i32),
                    soa_idx=np.zeros((R, S), i32))
    B = batch_size
    batch = dict(text_ids=np.zeros((B, L), i32),
                 attention_mask=np.zeros((B, L), i32),
                 latents=np.zeros((B, t_aud, D), f32),
                 audio_mask=np.zeros((B, t_aud), i32),
                 labels=np.zeros((B, L), i32))
    return {k: batch[k] for k in TASK_KEYS[task]}


def build_model(cfg: CALMConfig, device,
                components: Optional[str] = None) -> QwenCALM:
    """The model before freezing: random normal weights from
    training.seed on `device`, the Qwen2 base from model.qwen_path when it
    is a directory, then the trained components of the `components`
    directory (each component and the LoRA adapter it holds) when given,
    else the model.pretrained_*_path checkpoints."""
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
    if components:
        soft_restart(model, {c: components for c in COMPONENTS + ("lora",)})
        return model
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
    if d.task_mode not in ("tts", "asr", "mix"):
        raise ValueError(f"unknown task_mode {d.task_mode!r}")
    if t.frozen_weights_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"unknown frozen_weights_dtype {t.frozen_weights_dtype!r}")
    device = (init_distributed_from_env(args.device) if args.distributed
              else resolve_device(args.device))
    rank, world = rank_world()
    tokenizer = load_tokenizer(m, byte_fallback=args.byte_tokenizer)
    tasks = [task for task in ("tts", "asr")
             if d.task_mode in (task, "mix")]
    sources = {task: d.datasets.get(task) for task in tasks}
    sources = {task: src for task, src in sources.items() if src}
    ds = _dataset(cfg, tokenizer,
                  {task: src.latent_dir for task, src in sources.items()},
                  {task: src.subsets for task, src in sources.items()})
    if len(ds) == 0:
        raise FileNotFoundError("no training data found")
    print(f"dataset: {len(ds.tts_items)} tts + {len(ds.asr_items)} asr "
          "items")

    global_bs = t.per_device_train_batch_size * world
    total_steps = args.max_steps or int(
        max(len(ds) // global_bs, 1) * t.num_train_epochs)
    rows = {"tts": d.tts_pack_rows, "asr": d.asr_pack_rows}
    pack = {task: rows[task] > 0 for task in rows}
    k_of = {"tts": t.tts_microbatch_steps or t.microbatch_steps,
            "asr": t.asr_microbatch_steps or t.microbatch_steps}
    for task in ("asr", "tts"):
        if pack[task] and rows[task] % max(k_of[task], 1):
            raise ValueError(f"data.{task}_pack_rows={rows[task]} must be "
                             "divisible by microbatch_steps = "
                             f"{k_of[task]}")
        slice_rows = (rows[task] if pack[task] else global_bs) // max(
            k_of[task], 1)
        if world > 1 and task in tasks and slice_rows % world:
            raise ValueError(f"{task}: a microbatch slice of {slice_rows} "
                             f"rows does not split over {world} ranks")
    epochs_arg, loop_cap = None, total_steps
    if not args.max_steps and (pack["asr"] or pack["tts"]):
        spe = 0
        for task in tasks:
            n_task = len(ds.tts_items if task == "tts" else ds.asr_items)
            if n_task == 0:
                continue
            if pack[task]:
                geom = ((d.tts_pack_rows, d.tts_pack_len, d.tts_pack_segments)
                        if task == "tts" else
                        (d.asr_pack_rows, d.asr_pack_len,
                         d.asr_pack_segments))
                spe += estimate_packed_steps_per_epoch(
                    ds, task, *geom, fill=0.87 if task == "tts" else 0.95)
            else:
                spe += max(n_task // global_bs, 1)
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
          f"{device}" + (f" | rank {rank} of {world}" if args.distributed
                         else ""))
    # one optimizer for every task's step: the loop sets each step's count
    # to the global step, so the update count and the MultiSteps
    # accumulation run across tasks
    opt = AdamW(trainable, labels, t, total_steps,
                distributed=args.distributed)
    step_task = {task: task + "_packed" if pack[task] else task
                 for task in tasks}
    steps = {step_task[task]: make_calm_step(model, opt, step_task[task],
                                             microbatch=k_of[task],
                                             seed=t.seed)
             for task in tasks}
    k_task = {step_task[task]: k_of[task] for task in tasks}
    flops_cache: Dict[tuple, float] = {}

    def batch_filter(raw):
        keys = TASK_KEYS[raw["task"]]
        return {key: torch.from_numpy(raw[key]).to(device) for key in keys}

    def step_flops(raw):
        """FLOPs of the step a batch dispatches, counted once per (task,
        shapes) by a run of its first slice (steps.count_step_flops)."""
        task = raw["task"]
        key = (task,) + tuple(sorted(
            (name, np.shape(raw[name])) for name in TASK_KEYS[task]))
        if key not in flops_cache:
            flops_cache[key] = count_step_flops(
                model, batch_filter(raw), task, k_task[task], seed=t.seed)
        return flops_cache[key]

    peak = device_peak_flops(device)
    for task in steps:
        # this rank's rows of a batch at the largest grid
        fake = _fake_max_batch(cfg, task, global_bs)
        fl = step_flops(dict({k: v[:len(v) // world]
                              for k, v in fake.items()}, task=task))
        line = (f"{task} step: {fl / 1e12:.2f} TFLOPs at max grid"
                if fl >= 1e11 else
                f"{task} step: {fl / 1e9:.2f} GFLOPs at max grid")
        if peak:
            line += (f" ({fl / peak * 1e3:.1f} ms at {peak / 1e12:.0f}"
                     " TFLOP/s peak)")
        print(line)

    eval_fn = None
    eval_dirs = {task: src.eval_latent_dir for task, src in sources.items()
                 if src.eval_latent_dir}
    if eval_dirs:
        eval_ds = _dataset(cfg, tokenizer, eval_dirs,
                           {task: d.eval_subsets for task in eval_dirs})
        if len(eval_ds):
            # eval runs the plain forward of each task (plain batches)
            eval_steps = {task: make_calm_eval_step(model, task)
                          for task in {s.removesuffix("_packed")
                                       for s in steps}}

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
                    out = eval_steps[b["task"]](batch_filter(b), seed=i)
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
            asr_text_pad=d.asr_text_pad,
            asr_pack_rows=d.asr_pack_rows if pack["asr"] else 0,
            asr_pack_len=d.asr_pack_len,
            asr_pack_segments=d.asr_pack_segments,
            tts_pack_rows=d.tts_pack_rows if pack["tts"] else 0,
            tts_pack_len=d.tts_pack_len,
            tts_pack_segments=d.tts_pack_segments,
            process_index=rank, process_count=world))

    history = run_training(None, batches, t, loop_cap, optimizer=opt,
                           eval_fn=eval_fn, batch_filter=batch_filter,
                           step_selector=lambda raw: steps[raw["task"]],
                           step_flops=step_flops, device=device)
    out_dir = os.path.join(t.output_dir, "components")
    if is_primary():
        save_components(model, out_dir)
        print(f"saved components to {out_dir}")
    barrier()
    return TrainRun(model, opt, history, total_steps, loop_cap, out_dir,
                    steps, batches, batch_filter, step_flops)


def main(argv=None) -> int:
    train(argv)
    finish_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())

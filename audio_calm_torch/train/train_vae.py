"""Train the acoustic VAE on the card (counterpart of scripts/train_vae.py):

    python -m audio_calm_torch.train.train_vae --config configs/vae.yaml \\
        [--override training.learning_rate=1e-4 ...] [--max-steps N] \\
        [--device cpu]

Reads the mel crops of data.data_dir / data.train_subsets (`MelDataset`,
random crops of data.crop_size), builds the VAE in fp32 (the JAX package's
VAE takes no compute dtype, whatever training.bf16 says) with fresh
weights from training.seed (`models/vae.init_vae_`, flax's initializers),
and trains it through train/loop.run_training: one AdamW over
`vae_param_label`'s groups, steps_per_epoch = len // batch for
num_train_epochs (or --max-steps), a log with samples/s and MFU (the
step's FLOPs counted once before the run), an eval over up to 16 batches
of per_device_eval_batch_size centre crops of data.eval_data_dir,
checkpoints, resume and best-model retention as the training section
says. A resumed run reseeds its data by the step it resumed at.

The export differs from the JAX script's, which writes an orbax `params`
directory: orbax is a JAX library and the card's machine has none. The
port writes the reference torch layout instead
(models/convert_export.export_vae), one file `<output_dir>/vae.bin`, with
the same `vae_config.json` sidecar beside it. The port's
`models/vae.load_vae` reads that file, and so does the JAX package's
`load_vae` (its torch-file branch).

`--distributed`: one process per device over torch.distributed, from
torchrun's variables (parallel/mesh.init_distributed_from_env; NCCL on
cuda:LOCAL_RANK, gloo with `--device cpu`), as the JAX script's
multi-process runs: the global batch is per_device_train_batch_size x the
world size, each rank loads its rows (`mel_batch_iterator`'s
process_index slice) and the step is data-parallel with ZeRO-2
(train/optim.AdamW), the same run as one process over the global batches.
Rank 0 alone logs and writes the checkpoints and `vae.bin`; every rank
needs the same training.output_dir (a shared directory), where a resumed
run reads them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, List

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.config import VAEConfig, load_config
from audio_calm_torch.data.collator import mel_batch_iterator
from audio_calm_torch.data.datasets import MelDataset
from audio_calm_torch.data.prefetch import prefetch
from audio_calm_torch.models.convert import to_jax_params
from audio_calm_torch.models.convert_export import export_vae
from audio_calm_torch.models.vae import AcousticVAE, init_vae_
from audio_calm_torch.parallel.mesh import (barrier, finish_distributed,
                                            init_distributed_from_env,
                                            is_primary, rank_world,
                                            shard_host_batch)
from audio_calm_torch.train.loop import run_training
from audio_calm_torch.train.optim import AdamW, param_labels, vae_param_label
from audio_calm_torch.train.steps import (backward_flops, make_vae_step,
                                          vae_loss)
from audio_calm_torch.utils.profiling import device_peak_flops

EVAL_BATCHES = 16  # the JAX script's eval cap


@dataclasses.dataclass
class VAERun:
    """What a run leaves: the trained VAE and its optimizer, the per-step
    records, the steps the schedule spans, the exported file, and the
    run's step, data (`batches(start_step)`), batch filter and FLOPs a
    step, for measuring more steps of the same recipe."""
    model: AcousticVAE
    optimizer: AdamW
    history: List[Dict]
    total_steps: int
    export_path: str
    step: Callable
    batches: Callable
    batch_filter: Callable
    step_flops: float


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="configs/vae.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap steps (overrides epochs)")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' only "
                        "when asked)")
    p.add_argument("--distributed", action="store_true",
                   help="one process per device from torchrun's variables "
                        "(NCCL; gloo with --device cpu)")
    return p.parse_args(argv)


def export(model: AcousticVAE, cfg: VAEConfig, output_dir: str) -> str:
    """The VAE's weights in the reference torch layout as
    `<output_dir>/vae.bin` and its geometry as `vae_config.json` beside it
    -> the file's path."""
    os.makedirs(output_dir, exist_ok=True)
    sd = export_vae(to_jax_params(model.state_dict()),
                    tuple(cfg.model.strides))
    path = os.path.join(output_dir, "vae.bin")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    with open(os.path.join(output_dir, "vae_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg.model), f, indent=1)
    return path


def train(argv=None) -> VAERun:
    args = parse_args(argv)
    cfg = load_config(args.config, cls=VAEConfig, overrides=args.override)
    t, d = cfg.training, cfg.data
    device = (init_distributed_from_env(args.device) if args.distributed
              else resolve_device(args.device))
    rank, world = rank_world()

    train_ds = MelDataset(d.data_dir, d.train_subsets, d.crop_size,
                          training=True)
    if len(train_ds) == 0:
        raise FileNotFoundError(f"no training data under {d.data_dir}")
    print(f"train files: {len(train_ds)}")
    global_bs = t.per_device_train_batch_size * world
    steps_per_epoch = max(len(train_ds) // global_bs, 1)
    total_steps = args.max_steps or int(steps_per_epoch * t.num_train_epochs)

    with torch.device(device):
        model = AcousticVAE(cfg.model)
    init_vae_(model, seed=t.seed)
    params = dict(model.named_parameters())
    opt = AdamW(params, param_labels(model, vae_param_label), t, total_steps,
                distributed=args.distributed)
    step = make_vae_step(model, opt, seed=t.seed)
    n_params = sum(p.numel() for p in params.values())
    print(f"params: {n_params / 1e6:.2f}M | total steps: {total_steps} | "
          f"global batch: {global_bs} | device: {device}"
          + (f" | rank {rank} of {world}" if args.distributed else ""))

    # the step's FLOPs, counted once on a batch of its (this rank's) shape
    mel0 = torch.zeros(global_bs // world, d.crop_size, cfg.model.in_channels,
                       device=device)
    step_fl = backward_flops(model, lambda: vae_loss(model, mel0,
                                                     t.seed)["loss"])
    del mel0
    peak = device_peak_flops(device)
    print(f"vae step: {step_fl / 1e9:.2f} GFLOPs"
          + (f" ({step_fl / peak * 1e3:.2f} ms at peak)" if peak else ""))

    def batch_filter(raw):
        return shard_host_batch(raw, device)

    eval_fn = None
    if d.eval_data_dir:
        eval_ds = MelDataset(d.eval_data_dir, d.eval_subsets, d.crop_size,
                             training=False)
        if len(eval_ds):
            eval_bs = min(t.per_device_eval_batch_size, len(eval_ds))

            @torch.no_grad()
            def eval_fn():
                losses = []
                for raw in mel_batch_iterator(eval_ds, eval_bs,
                                              training=False, epochs=1):
                    out = model(batch_filter(raw)["mel"], train=False)
                    losses.append(float(out["loss"]))
                    if len(losses) >= EVAL_BATCHES:
                        break
                return ({"loss": sum(losses) / len(losses)} if losses
                        else {})

    def batches(start_step: int):
        # the seed folds in the resume step: no epoch-head replay
        return prefetch(mel_batch_iterator(
            train_ds, global_bs, training=True,
            seed=t.seed + 1_000_003 * start_step, process_index=rank,
            process_count=world))

    history = run_training(step, batches, t, total_steps, optimizer=opt,
                           eval_fn=eval_fn, batch_filter=batch_filter,
                           step_flops=lambda raw: step_fl, device=device)
    path = os.path.join(t.output_dir, "vae.bin")
    if is_primary():
        export(model, cfg, t.output_dir)
        print(f"saved final VAE params to {path}")
    barrier()
    return VAERun(model, opt, history, total_steps, path, step, batches,
                  batch_filter, step_fl)


def main(argv=None) -> int:
    train(argv)
    finish_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())

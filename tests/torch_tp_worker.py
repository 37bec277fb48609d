"""The two-process (2, 2) mesh run of tests/test_torch_multiprocess.py
(data x tensor parallelism): the model, batches and steps it and its
one-process reference share, and one rank's work. It imports the port
only, so each rank starts quickly:

    python -c "import torch_tp_worker as w; w.dp_tp_rank('out.json')"

with torchrun's variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE=2, RANK)
set and this directory on sys.path."""

import json

import numpy as np
import torch

from audio_calm_torch.config import (CALMModelConfig, LoRAConfig,
                                     Qwen2Config, TrainingConfig)
from audio_calm_torch.models.calm import QwenCALM
from audio_calm_torch.models.flagship import random_normal_
from audio_calm_torch.parallel import mesh as tmesh
from audio_calm_torch.parallel.tp_shard import TPAttention
from audio_calm_torch.train.optim import AdamW, freeze
from audio_calm_torch.train.steps import make_calm_step, shard_step


def tp_setup():
    """A Qwen2Config.tiny() CALM (4 q / 2 kv heads; LoRA and CFG dropout
    on) from a seed, labelled for "tts", its training config and two
    global batches of 4 rows."""
    cfg = CALMModelConfig(
        latent_dim=8, max_audio_len=16, max_text_len=8,
        tts_flow_hidden_dim=32, tts_flow_num_layers=1,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=Qwen2Config.tiny(vocab_size=128),
        lora=LoRAConfig(rank=2, alpha=4, dropout=0.05))
    model = random_normal_(QwenCALM(cfg), seed=3, scale=0.05)
    tcfg = TrainingConfig(learning_rate=1e-3, warmup_ratio=0.0,
                          lr_scheduler_type="constant")
    labels = freeze(model, tcfg, task_mode="tts")
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(2):
        tmask = np.arange(6)[None] < rng.integers(2, 7, 4)[:, None]
        amask = np.arange(16)[None] < rng.integers(8, 17, 4)[:, None]
        batches.append({
            "text_ids": torch.from_numpy(rng.integers(1, 128, (4, 6)) * tmask),
            "attention_mask": torch.from_numpy(tmask.astype(np.int32)),
            "latents": torch.from_numpy(rng.standard_normal(
                (4, 16, 8)).astype(np.float32)),
            "audio_mask": torch.from_numpy(amask.astype(np.int32))})
    return model, labels, tcfg, batches


def tts_steps(model, labels, tcfg, batches, distributed=False):
    """Two "tts" steps in 2 microbatch slices -> their metrics."""
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    opt = AdamW(params, labels, tcfg, total_steps=10,
                distributed=distributed)
    step = make_calm_step(model, opt, "tts", microbatch=2, seed=5)
    return [{k: float(v) for k, v in step(b).items()} for b in batches]


def dp_tp_rank(out_path):
    """One rank of the (2, 2) mesh run (started by
    test_two_processes_each_tensor_parallel): its rows of each global
    batch, its row of the mesh; rank 0 writes the metrics to out_path."""
    torch.set_num_threads(1)
    tmesh.init_distributed_from_env("cpu")
    rank, _ = tmesh.rank_world()
    model, labels, tcfg, batches = tp_setup()
    rep = shard_step(model, tmesh.make_mesh(2, 2, ["cpu"] * 4))
    assert all(isinstance(layer.self_attn, TPAttention)
               for layer in rep.llm.layers)
    mine = [{k: v[rank * 2:(rank + 1) * 2] for k, v in b.items()}
            for b in batches]
    hist = tts_steps(rep, labels, tcfg, mine, distributed=True)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(hist, f)
    tmesh.finish_distributed()


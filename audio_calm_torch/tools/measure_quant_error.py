"""Weight-only int8 error at the flagship's width (counterpart of
scripts/measure_quant_error.py).

    python -m audio_calm_torch.tools.measure_quant_error [--layers 28]
        [--seq 32] [--batch 2] [--device cpu]

The relative error of the int8 projections (models/quant.quantize_weight:
symmetric absmax, one scale an output channel) on random weights, where
the statistic depends on fan-in and depth, not on training:
  - one projection at fan-in 64, at the hidden width 1536 and at the MLP
    down projection's 8960 (the mean of 4 draws each), on the host in
    numpy from np.random.default_rng(0), the JAX script's draws in its
    order, so both print the same numbers;
  - the whole Qwen2 stack at the flagship's width and --layers depth (LoRA
    r 64 at its initial zero B), fp32 weights computing in bf16 (the JAX
    stack's default dtype), on the card by default: the final-norm hidden
    state of int8 projections against the bf16 ones on the same inputs
    (the rng's next draw). Its weights are flax's initializers
    with torch's draws (models/calm.init_layers_, seed 0), so its number
    is the JAX script's statistic, not its value.
Prints one JSON line with the JAX script's keys.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.models.quant import quantize_llm_int8, quantize_weight


def proj_err(rng: np.random.Generator, fan_in: int, fan_out: int, rows: int,
             n: int = 4) -> float:
    """The mean over n draws of |x Wq - x W| / |x W| for W [fan_in,
    fan_out] ~ 0.02 N(0, 1) and x [rows, fan_in] ~ N(0, 1)."""
    errs = []
    for _ in range(n):
        w = rng.standard_normal((fan_in, fan_out)).astype(np.float32)
        w *= 0.02
        x = rng.standard_normal((rows, fan_in)).astype(np.float32)
        q, s = quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
        y = x @ w
        yq = x @ (q.numpy().T.astype(np.float32) * s.numpy()[None, :])
        errs.append(float(np.linalg.norm(yq - y) / np.linalg.norm(y)))
    return sum(errs) / len(errs)


def build_stack(layers: int, device) -> torch.nn.Module:
    """The flagship's Qwen2 stack at `layers` layers with LoRA r 64 (alpha
    128, no dropout), fp32, flax's initializers from seed 0."""
    from audio_calm_torch.config import LoRAConfig, Qwen2Config
    from audio_calm_torch.models.calm import init_layers_
    from audio_calm_torch.models.qwen2 import Qwen2Model

    cfg = Qwen2Config()
    cfg.num_hidden_layers = layers
    with torch.device(device):
        model = Qwen2Model(cfg, lora=LoRAConfig(rank=64, alpha=128.0,
                                                dropout=0.0))
    init_layers_(model, torch.Generator(device).manual_seed(0))
    return model.eval().requires_grad_(False)


@torch.no_grad()
def stack_error(model: torch.nn.Module, x: torch.Tensor) -> float:
    """|h_int8 - h| / |h| of the stack's final hidden state on x (computed
    in x's dtype); the model's projections are int8 afterwards."""
    ref = model(x).float()
    quantize_llm_int8(model)
    out = model(x).float()
    return float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--layers", type=int, default=28)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from audio_calm_torch.config import Qwen2Config

    cfg = Qwen2Config()
    rng = np.random.default_rng(0)
    rows = args.batch * args.seq
    e64 = proj_err(rng, 64, 64, rows)
    e1536 = proj_err(rng, cfg.hidden_size, cfg.hidden_size, rows)
    e_mlp = proj_err(rng, cfg.intermediate_size, cfg.hidden_size, rows)

    x = torch.as_tensor(
        rng.standard_normal((args.batch, args.seq, cfg.hidden_size)),
        dtype=torch.float32, device=device).to(torch.bfloat16)
    print(f"init {args.layers}-layer flagship-width stack...",
          file=sys.stderr, flush=True)
    rel = stack_error(build_stack(args.layers, device), x)
    print(json.dumps({
        "proj_rel_err_fan64": round(e64, 5),
        "proj_rel_err_fan1536": round(e1536, 5),
        "proj_rel_err_fan8960_mlp_down": round(e_mlp, 5),
        "stack_rel_err": round(rel, 5),
        "layers": args.layers, "hidden": cfg.hidden_size,
        "seq": args.seq, "batch": args.batch,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Tensor-parallel rules, Megatron style (counterpart of audio_calm_tpu/
parallel/tp.py).

Column-parallel up-projections and row-parallel down-projections, so each
transformer block needs one sum per sublayer:
  attention q/k/v weights [out, in]  -> split out   (heads split)
  attention o weight                 -> split in
  MLP gate/up weights                -> split out
  MLP down weight                    -> split in
  embedding table [vocab, d]         -> split vocab
  LoRA a [in, r] / b [r, out]        -> replicated (r is small)
  everything else                    -> replicated

Paths are the port's parameter names split at the dots (the JAX tree's
module names; models/convert.jax_path maps one onto the other), and a
rule gives the split dim in the port's layout (a torch Linear weight is
[out, in], where a flax kernel is [in, out]). The placement that runs the
split is parallel/tp_shard.py, for inference (parallel/infer_shard.py) and
training (train/steps.shard_step). It splits the Qwen2 kernels and the
embedding; the rules also name the DiT heads' and the ASR
cross-attention's q/k/v, which GSPMD splits in JAX and the port's
placement leaves whole (tp_shard.split_dims).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

COL_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW_PARALLEL = ("o_proj", "down_proj")


def param_partition_spec(path: Tuple[str, ...]) -> Optional[int]:
    """A parameter path -> the dim split over the "model" axis, or None
    (replicated). int8 projections' per-output-channel `kernel_scale`
    follows its weight's output dim."""
    leaf = path[-1]
    if leaf in ("lora_a", "lora_b"):
        return None
    parent = path[-2] if len(path) >= 2 else ""
    if leaf in ("weight", "bias", "kernel_scale") and parent in COL_PARALLEL:
        return 0
    if leaf == "weight" and parent in ROW_PARALLEL:
        return 1
    if leaf == "embedding" and path[0] == "embed":
        return 0  # vocab-split embedding
    return None


def tp_shardings(named: Dict[str, object], mesh) -> Dict[str, Optional[int]]:
    """{name: tensor} -> {name: split dim or None}; replicated when the
    mesh's model axis is 1 or the dim does not divide by it."""
    n = mesh.shape.get("model", 1)
    out = {}
    for name, value in named.items():
        dim = param_partition_spec(tuple(name.split(".")))
        if n == 1 or dim is None or tuple(value.shape)[dim] % n:
            dim = None
        out[name] = dim
    return out

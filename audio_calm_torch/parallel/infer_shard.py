"""Inference placement over a device mesh: tensor-parallel Qwen2 kernels and
data-parallel batch rows (counterpart of audio_calm_tpu/parallel/
infer_shard.py).

JAX places the parameters with sharding annotations and GSPMD compiles the
same programs over the mesh, inserting one all-reduce per sublayer. The
port writes that out for a `parallel.mesh.Mesh` [data, model]:

  - `shard_inference_params(model, mesh)` gives one replica of the model
    per data row of the mesh. In each, the Qwen2 kernels are split over
    the row's `model` devices by parallel/tp_shard.place_tensor_parallel
    (the placement training uses too): q/k/v and gate/up by output columns
    (whole heads; at 12 q / 2 kv heads and tp = 2 each device runs 6 / 1),
    o and down by input rows, the embedding by vocabulary, each split
    sublayer's partial outputs summed on the row's first device in device
    order, where GSPMD inserts its all-reduce. Everything else (norms, the
    DiT heads, the projector, LoRA's whole a and b, which each shard
    slices at use) lives on the row's first device. A layer whose heads
    (or MLP width, or vocabulary) do not divide by the model size stays
    whole on the first device, as tp_shardings falls back to replicated.
  - `shard_batch_rows(arrays, mesh)` splits a group's rows over the data
    rows when the row count divides, else keeps them together on the first
    data row (JAX replicates them there; every replica would compute the
    same values).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from audio_calm_torch.parallel.mesh import Mesh
# the split modules live in parallel/tp_shard.py, shared with training
from audio_calm_torch.parallel.tp_shard import (TPAttention,  # noqa: F401
                                                TPEmbed, TPMLP,
                                                place_tensor_parallel)


@torch.no_grad()
def shard_replica(model: nn.Module, devices: Sequence) -> nn.Module:
    """One data row's replica of a QwenCALM: a copy on devices[0] whose
    Qwen2 kernels are split over `devices` (tp_shard.
    place_tensor_parallel; the model is left as it is)."""
    return place_tensor_parallel(copy.deepcopy(model), devices)


def shard_inference_params(model: nn.Module, mesh: Mesh) -> List[nn.Module]:
    """One replica per data row of `mesh` (`shard_replica` over the row's
    devices), in data-row order."""
    return [shard_replica(model, row) for row in mesh.devices]


def shard_batch_rows(arrays: Sequence[torch.Tensor], mesh: Optional[Mesh]
                     ) -> List[Tuple[int, Tuple[torch.Tensor, ...]]]:
    """[(data row, its rows of each array on that row's first device)]:
    the leading dim split evenly over the data rows when it divides, else
    every row on data row 0. Without a mesh: [(0, arrays)]."""
    arrays = tuple(arrays)
    if mesh is None:
        return [(0, arrays)]
    n = mesh.shape["data"]
    rows = arrays[0].shape[0]
    if rows % n:
        dev = mesh.devices[0][0]
        return [(0, tuple(a.to(dev) for a in arrays))]
    per = rows // n
    return [(d, tuple(a[d * per:(d + 1) * per].to(mesh.devices[d][0])
                      for a in arrays)) for d in range(n)]

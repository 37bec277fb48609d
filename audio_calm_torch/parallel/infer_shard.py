"""Inference placement over a device mesh: tensor-parallel Qwen2 kernels and
data-parallel batch rows (counterpart of audio_calm_tpu/parallel/
infer_shard.py).

JAX places the parameters with sharding annotations and GSPMD compiles the
same programs over the mesh, inserting one all-reduce per sublayer. The
port writes that out for a `parallel.mesh.Mesh` [data, model]:

  - `shard_inference_params(model, mesh)` gives one replica of the model
    per data row of the mesh. In each, the Qwen2 kernels follow
    parallel/tp.py: q/k/v and gate/up are split by output columns (whole
    heads; at 12 q / 2 kv heads and tp = 2 each device runs 6 / 1) across
    the row's `model` devices, o and down by input rows, and the embedding
    by vocabulary. Everything else (norms, the DiT heads, the projector,
    LoRA's a and b) lives on the row's first device. A split sublayer runs
    as per-device partial products, moved to the row's first device and
    summed there in device order, where GSPMD inserts its all-reduce.
    LoRA follows the split: a column-split layer keeps a whole and the
    columns of b that its output holds; a row-split layer keeps the rows of
    a that its input holds and the whole b, and its adapter delta joins the
    partial sum. int8 projections split their weight and, for column
    splits, the per-output scales with it. Every shard is a contiguous
    copy (the batch-invariant product wants 16-byte aligned rows). A layer
    whose heads (or MLP width, or vocabulary) do not divide by the model
    size stays whole on the first device, as tp_shardings falls back to
    replicated.
  - `shard_batch_rows(arrays, mesh)` splits a group's rows over the data
    rows when the row count divides, else keeps them together on the first
    data row (JAX replicates them there; every replica would compute the
    same values).
"""

from __future__ import annotations

import copy
import dataclasses
import types
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audio_calm_torch.models.lora import LoRADense
from audio_calm_torch.models.qwen2 import Qwen2Attention, Qwen2MLP
from audio_calm_torch.parallel.mesh import Mesh


def _piece(t: torch.Tensor, dim: int, j: int, n: int,
           device) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, j * size, size).to(device).contiguous()


@torch.no_grad()
def split_linear(mod: LoRADense, side: str, j: int, n: int,
                 device) -> LoRADense:
    """Shard j of n of a projection: side "out" (column-parallel: weight
    rows, bias, int8 scales and LoRA b's columns) or "in" (row-parallel:
    weight columns and LoRA a's rows), on `device`."""
    out = copy.copy(mod)  # the module's settings; its tensors replaced
    out._parameters = dict(mod._parameters)
    out._buffers = dict(mod._buffers)
    w = mod.weight
    if side == "out":
        out.weight = nn.Parameter(_piece(w, 0, j, n, device),
                                  requires_grad=False)
        if mod.bias is not None:
            out.bias = nn.Parameter(_piece(mod.bias, 0, j, n, device),
                                    requires_grad=False)
        if "kernel_scale" in mod._buffers:
            out._buffers["kernel_scale"] = _piece(mod.kernel_scale, 0, j, n,
                                                  device)
        if mod.rank > 0:
            out.lora_a = nn.Parameter(mod.lora_a.to(device).contiguous(),
                                      requires_grad=False)
            out.lora_b = nn.Parameter(_piece(mod.lora_b, 1, j, n, device),
                                      requires_grad=False)
    else:
        if mod.bias is not None:
            raise ValueError("a row-parallel projection with a bias would "
                             "add it once per shard")
        out.weight = nn.Parameter(_piece(w, 1, j, n, device),
                                  requires_grad=False)
        if "kernel_scale" in mod._buffers:
            out._buffers["kernel_scale"] = mod.kernel_scale.to(device)
        if mod.rank > 0:
            out.lora_a = nn.Parameter(_piece(mod.lora_a, 0, j, n, device),
                                      requires_grad=False)
            out.lora_b = nn.Parameter(mod.lora_b.to(device).contiguous(),
                                      requires_grad=False)
    out.in_features, out.out_features = out.weight.shape[1], \
        out.weight.shape[0]
    return out


def _partial_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """parts summed on `device` in order (the fixed-order all-reduce)."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


class TPAttention(nn.Module):
    """A Qwen2Attention split by heads over `devices`: shard j holds q/k/v
    heads [j Hq / n, (j + 1) Hq / n) (and kv likewise), runs its local GQA
    attention and its row slice of o; the partial outputs sum on
    devices[0]."""

    def __init__(self, attn: Qwen2Attention, devices: Sequence):
        super().__init__()
        n, c = len(devices), attn.cfg
        self.devices = [torch.device(d) for d in devices]
        local = dataclasses.replace(
            c, num_attention_heads=c.num_attention_heads // n,
            num_key_value_heads=c.num_key_value_heads // n)
        shards = []
        for j, dev in enumerate(self.devices):
            s = copy.copy(attn)
            s._modules = {}
            s.cfg = local
            for name in ("q_proj", "k_proj", "v_proj"):
                setattr(s, name, split_linear(getattr(attn, name), "out",
                                              j, n, dev))
            s.o_proj = split_linear(attn.o_proj, "in", j, n, dev)
            shards.append(s)
        self.shards = nn.ModuleList(shards)

    def forward(self, x, cos, sin, key_valid, train: bool = False,
                seed: int = 0, mask: Optional[torch.Tensor] = None):
        parts = []
        for dev, shard in zip(self.devices, self.shards):
            parts.append(shard(
                x.to(dev), cos.to(dev), sin.to(dev), key_valid.to(dev),
                train, seed, None if mask is None else mask.to(dev)))
        return _partial_sum(parts, x.device)


class TPMLP(nn.Module):
    """A Qwen2MLP split over `devices`: gate/up by output columns, down by
    input rows; the partial outputs sum on devices[0]."""

    def __init__(self, mlp: Qwen2MLP, devices: Sequence):
        super().__init__()
        n = len(devices)
        self.devices = [torch.device(d) for d in devices]
        shards = []
        for j, dev in enumerate(self.devices):
            s = copy.copy(mlp)
            s._modules = {}
            s.gate_proj = split_linear(mlp.gate_proj, "out", j, n, dev)
            s.up_proj = split_linear(mlp.up_proj, "out", j, n, dev)
            s.down_proj = split_linear(mlp.down_proj, "in", j, n, dev)
            shards.append(s)
        self.shards = nn.ModuleList(shards)

    def forward(self, x, train: bool = False, seed: int = 0):
        parts = [shard(x.to(dev), train, seed)
                 for dev, shard in zip(self.devices, self.shards)]
        return _partial_sum(parts, x.device)


class TPEmbed(nn.Module):
    """A vocabulary-split embedding table: shard j holds rows [j V / n,
    (j + 1) V / n) on devices[j]. A lookup sums the shards' masked lookups
    on devices[0] (exactly one is non-zero per id)."""

    def __init__(self, table: torch.Tensor, devices: Sequence):
        super().__init__()
        n = len(devices)
        self.devices = [torch.device(d) for d in devices]
        self.size = table.shape[0] // n
        self.tables = nn.ParameterList(
            nn.Parameter(_piece(table, 0, j, n, dev), requires_grad=False)
            for j, dev in enumerate(self.devices))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        parts = []
        for j, (dev, tab) in enumerate(zip(self.devices, self.tables)):
            local = ids.to(dev) - j * self.size
            hit = (local >= 0) & (local < self.size)
            e = F.embedding(local.clamp(0, self.size - 1), tab)
            parts.append(torch.where(hit[..., None], e, torch.zeros_like(e)))
        return _partial_sum(parts, self.devices[0])

    def nearest(self, xn: torch.Tensor) -> torch.Tensor:
        """argmax over the vocabulary of xn [Q, D] (L2-normalised, fp32)
        against the L2-normalised table: each shard's max and its index,
        the first shard with the largest value winning (torch.argmax's
        first-maximum rule)."""
        best_v = best_i = None
        for j, (dev, tab) in enumerate(zip(self.devices, self.tables)):
            tn = tab.float()
            tn = (tn / torch.linalg.vector_norm(
                tn, dim=-1, keepdim=True).clamp_min(1e-12)).t()
            v, i = torch.max(torch.matmul(xn.to(dev), tn), dim=-1)
            v, i = v.to(self.devices[0]), i.to(self.devices[0]) + \
                j * self.size
            if best_v is None:
                best_v, best_i = v, i
            else:
                better = v > best_v
                best_v = torch.where(better, v, best_v)
                best_i = torch.where(better, i, best_i)
        return best_i


def _tp_search_nearest_tokens(self, x: torch.Tensor) -> torch.Tensor:
    """QwenCALM.search_nearest_tokens over a vocabulary-split table, one
    product an item as the one-device method runs it."""
    xn = x.float()
    xn = xn / torch.linalg.vector_norm(xn, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
    if xn.dim() < 3:
        return self.embed.nearest(xn)
    items = xn.reshape(-1, *xn.shape[-2:])
    return torch.stack([self.embed.nearest(xi) for xi in items]).reshape(
        xn.shape[:-1])


@torch.no_grad()
def shard_replica(model: nn.Module, devices: Sequence) -> nn.Module:
    """One data row's replica of a QwenCALM: a copy on devices[0] whose
    Qwen2 kernels are split over `devices` (the model is left as it
    is)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    rep = copy.deepcopy(model).to(devices[0])
    if n == 1:
        return rep
    c = rep.cfg.qwen
    for layer in rep.llm.layers:
        if c.num_attention_heads % n == 0 and c.num_key_value_heads % n == 0:
            layer.self_attn = TPAttention(layer.self_attn, devices)
        if c.intermediate_size % n == 0:
            layer.mlp = TPMLP(layer.mlp, devices)
    if rep.embed.embedding.shape[0] % n == 0:
        rep.embed = TPEmbed(rep.embed.embedding, devices)
        rep.search_nearest_tokens = types.MethodType(
            _tp_search_nearest_tokens, rep)
    return rep


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

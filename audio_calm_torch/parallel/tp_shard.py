"""Tensor-parallel placement of the Qwen2 kernels over the devices of one
mesh row, for inference and for training (the port's counterpart of what
GSPMD compiles from parallel/tp.py's rules: audio_calm_tpu/parallel/
infer_shard.py and the "model" axis of audio_calm_tpu/train/steps.py
shard_step).

`place_tensor_parallel(model, devices)` turns a QwenCALM, in place, into
one replica over `devices` (n of them; the same device may repeat):

  - frozen base tensors follow tp.py's rules: q/k/v and gate/up are split
    by output columns (whole heads; at 12 q / 2 kv heads and n = 2 each
    device runs 6 / 1), o and down by input rows, the embedding by
    vocabulary. Each piece is a contiguous tensor on devices[j] with no
    gradient (the batch-invariant product wants 16-byte aligned rows);
    int8 projections split their weight and, for column splits, the
    per-output scales with it. Everything else (norms, the DiT heads, the
    projector) stays on devices[0].
  - LoRA's a and b stay one tensor each, whole on devices[0] and
    registered under the one-device names (`llm.layers.0.self_attn.
    q_proj.lora_a`: `LoRAAdapter`). Each shard reads its slice at every
    call through a differentiable narrow and copy to its device: a column
    split the columns of b its output holds, a row split the rows of a its
    input holds. Autograd sums the shards' gradients into the whole
    `.grad`, so an optimizer, a checkpoint or a label keyed by the
    one-device names sees the same tensors, and no trainable is copied.
  - a split sublayer runs as per-device partial products, moved to
    devices[0] and summed there in device order, where GSPMD inserts its
    all-reduce; the backward of that sum is the broadcast GSPMD inserts.
    A row-split layer's adapter delta joins the partial sum.
  - the LoRA dropout: a column-split shard sees the whole input and draws
    the whole mask, with the one-device seed and dropout site; a
    row-split shard draws its columns of that mask (ops/dropout.draw's
    `cols`), so the sum is the one-device layer's whatever the split.
  - a layer whose q and kv heads (or MLP width, or vocabulary) do not
    divide by n stays whole on devices[0], as tp_shardings falls back to
    replicated.

JAX's rules name q/k/v wherever they occur, so GSPMD also splits the DiT
heads' and the ASR cross-attention's q/k/v kernels (trainable) over the
model axis, and their optimizer moments with them. This placement splits
the Qwen2 kernels and the embedding only (`split_dims`): those layers stay
whole on devices[0], moments and all, with the same values.
"""

from __future__ import annotations

import copy
import dataclasses
import types
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audio_calm_torch.models.lora import LoRADense, base_product, lora_delta
from audio_calm_torch.models.qwen2 import Qwen2Attention, Qwen2MLP
from audio_calm_torch.parallel.tp import COL_PARALLEL, param_partition_spec

ATTN_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj")
MLP_PROJ = ("gate_proj", "up_proj", "down_proj")


def _piece(t: torch.Tensor, dim: int, j: int, n: int,
           device) -> torch.Tensor:
    """Piece j of n of `t` along `dim`, contiguous on `device`
    (differentiable where grad mode records)."""
    size = t.shape[dim] // n
    return t.narrow(dim, j * size, size).to(device).contiguous()


class LoRAAdapter(nn.Module):
    """The LoRA tensors of a split projection, whole: the same `lora_a` /
    `lora_b` parameters the one-device LoRADense held, and its dropout
    site. Its shards read their slices of them at use."""

    def __init__(self, mod: LoRADense):
        super().__init__()
        self.lora_a, self.lora_b = mod.lora_a, mod.lora_b
        self.dropout_site = mod.dropout_site


class ShardLinear(nn.Module):
    """Shard j of n of a LoRADense on `device`: column-parallel (its
    weight rows, bias and int8 scales; b's columns read at use) or
    row-parallel (its weight columns; a's rows read at use and its
    columns of the dropout mask drawn). `adapter` (None without LoRA) is
    read, not registered: its tensors belong to the layer."""

    batch_invariant = False

    def __init__(self, mod: LoRADense, column: bool, j: int, n: int, device,
                 adapter: Optional[LoRAAdapter]):
        super().__init__()
        self.column, self.j, self.n = column, j, n
        self.batch_invariant = mod.batch_invariant
        self.scaling = getattr(mod, "scaling", 0.0)
        self.lora_dropout = getattr(mod, "lora_dropout", 0.0)
        self.weight = nn.Parameter(
            _piece(mod.weight, 0 if column else 1, j, n, device),
            requires_grad=False)
        if mod.bias is not None and not column:
            raise ValueError("a row-parallel projection with a bias would "
                             "add it once per shard")
        self.bias = None if mod.bias is None else nn.Parameter(
            _piece(mod.bias, 0, j, n, device), requires_grad=False)
        if "kernel_scale" in mod._buffers:
            scale = mod.kernel_scale
            self.register_buffer("kernel_scale", _piece(
                scale, 0, j, n, device) if column else scale.to(device))
        self.__dict__["adapter"] = adapter

    def forward(self, x: torch.Tensor, train: bool = False,
                seed: int = 0) -> torch.Tensor:
        y = base_product(self, x)
        ad = self.adapter
        if ad is None:
            return y
        dev, j, n = x.device, self.j, self.n
        if self.column:
            a, b, cols = ad.lora_a.to(dev), _piece(ad.lora_b, 1, j, n,
                                                   dev), (0, 1)
        else:
            a, b, cols = _piece(ad.lora_a, 0, j, n, dev), ad.lora_b.to(dev), \
                (j, n)
        return y + lora_delta(self, x, a, b, ad.dropout_site, train, seed,
                              cols)


def _partial_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """parts summed on `device` in order (the fixed-order all-reduce)."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def _split_projections(owner: nn.Module, src: nn.Module, shards, names,
                       devices) -> None:
    """Register each LoRA projection of `src` named in `names` as a whole
    LoRAAdapter on `owner` (in the one-device order, so the trainable
    tensors keep their names and order), and give shard j its
    ShardLinear of every projection."""
    n = len(devices)
    for name in names:
        if getattr(src, name).rank > 0:
            setattr(owner, name, LoRAAdapter(getattr(src, name)))
    for j, (dev, shard) in enumerate(zip(devices, shards)):
        for name in names:
            setattr(shard, name, ShardLinear(
                getattr(src, name), name in COL_PARALLEL, j, n, dev,
                owner._modules.get(name)))


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
        for _ in self.devices:
            s = copy.copy(attn)
            s._modules = {}
            s.cfg = local
            shards.append(s)
        _split_projections(self, attn, shards, ATTN_PROJ, self.devices)
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
        self.devices = [torch.device(d) for d in devices]
        shards = []
        for _ in self.devices:
            s = copy.copy(mlp)
            s._modules = {}
            shards.append(s)
        _split_projections(self, mlp, shards, MLP_PROJ, self.devices)
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


def _divides(model: nn.Module, n: int) -> Tuple[bool, bool, bool]:
    """Whether the Qwen2 attention (q and kv heads), the MLP (its width)
    and the embedding (the vocabulary) of `model` split over n."""
    c = model.cfg.qwen
    return (c.num_attention_heads % n == 0 and c.num_key_value_heads % n == 0,
            c.intermediate_size % n == 0, c.vocab_size % n == 0)


def split_dims(model: nn.Module, n: int) -> Dict[str, int]:
    """{name: dim} of the parameters `place_tensor_parallel` splits over n
    devices: tp.py's rule for the Qwen2 kernels and the embedding, where
    their layer divides. (JAX's rules also split the DiT heads' and the
    ASR cross-attention's q/k/v; this placement leaves them whole.)"""
    attn, mlp, embed = _divides(model, n) if n > 1 else (False,) * 3
    out = {}
    for name, _ in model.named_parameters():
        path = tuple(name.split("."))
        dim = param_partition_spec(path)
        if dim is not None and ((path[0] == "embed" and embed) or (
                path[0] == "llm" and ((attn and "self_attn" in path)
                                      or (mlp and "mlp" in path)))):
            out[name] = dim
    return out


@torch.no_grad()
def place_tensor_parallel(model: nn.Module, devices: Sequence) -> nn.Module:
    """Split a QwenCALM's Qwen2 kernels over `devices`, in place (module
    docstring; `split_dims` names the tensors split) -> the model, on
    devices[0]. One device: the model moved there, nothing split."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    model.to(devices[0])
    if n == 1:
        return model
    attn, mlp, embed = _divides(model, n)
    for layer in model.llm.layers:
        if attn:
            layer.self_attn = TPAttention(layer.self_attn, devices)
        if mlp:
            layer.mlp = TPMLP(layer.mlp, devices)
    if embed:
        model.embed = TPEmbed(model.embed.embedding, devices)
        model.search_nearest_tokens = types.MethodType(
            _tp_search_nearest_tokens, model)
    return model

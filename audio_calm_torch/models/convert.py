"""Carry weights from a JAX parameter tree into the port's modules.

`from_jax_params(tree)` takes the JAX package's parameter tree as nested
dicts of numpy arrays and returns a `state_dict` for the port's modules,
whose names follow the tree: path components join with ".", flax's
`name_<i>` module lists become `name.<i>`, the inner `conv`/`gn` modules of
the JAX Conv1d/GroupNorm wrappers disappear, `kernel` and `scale` become
`weight`. Layouts (the JAX package's models/convert_export.py facts):
  Dense          [in, out]          -> Linear          [out, in]
  Conv           [k, C_in, C_out]   -> Conv1d          [C_out, C_in, k]
  ConvTranspose  [k, C_in, C_out]   -> ConvTranspose1d [C_in, C_out, k]
  LayerNorm / RMSNorm / GroupNorm scale and bias, LoRA A [in, r] and
  B [r, out], embeddings and bare parameters as they are.

The `load_*` helpers load with `strict=True`: every key present, none
unexpected. `jax_path` maps a QwenCALM parameter name back to its path in
the JAX tree (for optimizer labels and gradient comparisons).

`load_torch_state_dict` reads a torch checkpoint file (.bin / .pt / .ckpt,
or .safetensors through the reader below) into a flat dict of tensors.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# QwenCALM members that the port does not build yet
ASR_COMPONENTS = ("asr_cross_attn", "asr_query_embed", "asr_flow_head")
_WRAPPERS = {"conv", "gn"}
_RENAMES = (
    (re.compile(r"^(up|down)(\d+)_(conv|res)$"), r"\1_\3.\2"),  # VAE stages
    (re.compile(r"_(\d+)(?=_|$)"), r".\1"),  # flax module lists
)


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _rename(component: str) -> str:
    for pattern, repl in _RENAMES:
        component = pattern.sub(repl, component)
    return component


def _unwrap(tree: Dict) -> Dict:
    return tree["params"] if set(tree) == {"params"} else tree


def from_jax_params(tree: Dict) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of arrays) -> torch state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(_unwrap(tree)):
        *mods, leaf = path
        in_conv = bool(mods) and mods[-1] == "conv"
        mods = [m for m in mods if m not in _WRAPPERS]
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 3:
                arr = arr.transpose(2, 1, 0) if in_conv else arr.transpose(1, 2, 0)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        name = ".".join([_rename(m) for m in mods] + [leaf])
        out[name] = torch.tensor(arr, dtype=torch.float32)
    return out


def jax_path(model: torch.nn.Module, name: str) -> Tuple[str, ...]:
    """A parameter name of the port's QwenCALM -> its path in the JAX
    parameter tree: `name.<i>` module lists become `name_<i>`, a causal
    conv gets back its inner `conv` module, and `weight` becomes `scale`
    on a norm and `kernel` elsewhere."""
    from audio_calm_torch.models.calm_heads import CausalConv1d
    from audio_calm_torch.models.layers import GroupNorm
    from audio_calm_torch.models.qwen2 import RMSNorm

    *mods, leaf = name.split(".")
    path, module = [], model
    for part in mods:
        module = getattr(module, part)
        if part.isdigit():
            path[-1] = f"{path[-1]}_{part}"
        else:
            path.append(part)
    if isinstance(module, CausalConv1d):
        path.append("conv")
    if leaf == "weight":
        norms = (RMSNorm, GroupNorm, torch.nn.LayerNorm)
        leaf = "scale" if isinstance(module, norms) else "kernel"
    return tuple(path + [leaf])


def load_calm(model, tree: Dict) -> None:
    """QwenCALM (TTS members) <- the JAX QwenCALM parameter tree."""
    tree = {k: v for k, v in _unwrap(tree).items() if k not in ASR_COMPONENTS}
    model.load_state_dict(from_jax_params(tree), strict=True)


def load_vae(vae, tree: Dict) -> None:
    """AcousticVAE (encoder and decoder) <- the JAX AcousticVAE tree."""
    vae.load_state_dict(from_jax_params(tree), strict=True)


def load_hifigan(generator, tree: Dict) -> None:
    """HiFiGANGenerator <- the JAX HiFiGANGenerator parameter tree."""
    generator.load_state_dict(from_jax_params(tree), strict=True)


# safetensors dtype names -> torch dtypes (the format's own names)
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file -> {name: tensor} on the CPU, without the
    safetensors package: an 8-byte little-endian header length, a JSON
    header {name: {dtype, shape, data_offsets: [begin, end]}} (offsets into
    the data after the header; "__metadata__" aside), then the raw
    little-endian data."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"which this reader does not take")
        begin, end = info["data_offsets"]
        if begin == end:  # frombuffer refuses an empty buffer
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        flat = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        out[name] = flat.reshape(info["shape"])
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file -> {name: tensor} on the CPU: .safetensors
    through `read_safetensors`, anything else (.bin / .pt / .ckpt) through
    torch.load(weights_only=True)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return dict(sd)

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
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# QwenCALM members that the port does not build yet
ASR_COMPONENTS = ("asr_cross_attn", "asr_query_embed", "asr_flow_head")
_WRAPPERS = {"conv", "gn"}
_RENAMES = (
    (re.compile(r"^up(\d+)_(conv|res)$"), r"up_\2.\1"),  # VAE decoder stages
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
    """AcousticVAE (decoder) <- the JAX AcousticVAE parameter tree."""
    vae.load_state_dict(from_jax_params({"decoder": _unwrap(tree)["decoder"]}),
                        strict=True)


def load_hifigan(generator, tree: Dict) -> None:
    """HiFiGANGenerator <- the JAX HiFiGANGenerator parameter tree."""
    generator.load_state_dict(from_jax_params(tree), strict=True)

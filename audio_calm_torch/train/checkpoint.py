"""Component checkpoints in the reference's layout (the port's copy of the
JAX package's train/checkpoint.py, its torch-file half).

The reference saves each logical component of a CALM model as its own
`<component>.bin` (`COMPONENTS`) and the LoRA adapter in peft's
`adapter_model.bin` / `.safetensors`; `soft_restart` overlays such files
onto a port QwenCALM (the stage-2 warm start, and how the server loads a
trained model). Writing them: models/convert_export.save_reference_checkpoint.

The JAX package also writes and prefers its own orbax items
(`<dir>/<component>/`). The port cannot read them (orbax is a JAX
library): where one exists, `soft_restart` raises and names it rather than
load the torch file beside it, which JAX would not have loaded. Export
such a directory on a host with the JAX package first:
`python scripts/export_reference.py --components <dir> --out <new dir>`
(its `save_reference_checkpoint`). The orbax train-state manager
(`make_manager`, `save_train_state`, `restore_train_state`,
`save_components`, `load_component`) comes with training.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from audio_calm_torch.models import convert as C

COMPONENTS = (
    "input_proj",
    "tts_flow_head",
    "asr_flow_head",
    "soa_embed",
    "tts_len_predictor",
    "tts_dur_predictor",
    "asr_query_embed",
    "asr_cross_attn",
)
LORA_LEAVES = ("lora_a", "lora_b")
_TORCH_SUFFIXES = (".bin", ".pt", ".safetensors")


def orbax_item_error(path: str) -> ValueError:
    return ValueError(
        f"{path} is an orbax item of the JAX package, which the port cannot "
        "read; export its directory to the reference layout on a host with "
        "the JAX package (python scripts/export_reference.py --components "
        "<dir> --out <new dir>, its save_reference_checkpoint) and load the "
        "files it writes")


def load_torch_component(path: str, component: str) -> Any:
    """A reference component file -> the component's JAX-layout tree of
    numpy fp32 arrays (soa_embed: the [1, 1, D] array; lora: the partial
    llm tree of the peft adapter)."""
    sd = C.numpy_state_dict(C.load_torch_state_dict(path))
    if component in ("tts_flow_head", "asr_flow_head"):
        if C.is_legacy_flow_head(sd):
            return C.convert_legacy_flow_head(sd)
        num_layers = 0
        while any(k.startswith(f"blocks.{num_layers}.") for k in sd):
            num_layers += 1
        return C.convert_flow_head(sd, num_layers,
                                   "context_proj.weight" in sd)
    if component == "input_proj":
        return C.convert_input_projector(sd)
    if component in ("tts_len_predictor", "tts_dur_predictor"):
        return C.convert_predictor(sd)
    if component == "asr_cross_attn":
        return C.convert_torch_mha(sd)
    if component == "asr_query_embed":
        return {"embedding": np.asarray(sd["weight"]).astype(np.float32)}
    if component == "soa_embed":
        return np.asarray(sd["weight"]).astype(np.float32).reshape(1, 1, -1)
    if component == "vae":
        return C.convert_vae_params(sd)
    if component == "lora":
        return C.convert_peft_adapter(sd)
    raise ValueError(f"unknown torch component {component}")


def _find_torch_component_file(directory: str,
                               component: str) -> Optional[str]:
    """`<dir>/<comp>.bin|.pt|.safetensors`, and for LoRA first peft's
    `adapter_model.bin|.safetensors`; None when there is none."""
    names = [f"{component}{s}" for s in _TORCH_SUFFIXES]
    if component == "lora":
        names = ["adapter_model.bin", "adapter_model.safetensors"] + names
    for n in names:
        p = os.path.join(directory, n)
        if os.path.isfile(p):
            return p
    return None


def _overlay(model: torch.nn.Module, root: str, converted: Any,
             leaves: Optional[tuple] = None) -> None:
    """merge_params(the model's tree under `root`, converted) back into the
    model: every converted leaf must exist with its shape (a leaf the
    model lacks, e.g. a legacy ResNet head onto the DiT, raises)."""
    sd = model.state_dict()
    keys = [k for k in sd if (k == root or k.startswith(root + "."))
            and (leaves is None or k.rsplit(".", 1)[-1] in leaves)]
    current = C.to_jax_params({k: sd[k] for k in keys}).get(root, {})
    try:
        merged = C.merge_params(current, converted)
    except ValueError as e:
        raise ValueError(f"{root}: {e}") from None
    new = C.from_jax_params({root: merged})
    unexpected = sorted(set(new) - set(keys))
    if unexpected:
        raise ValueError(f"{root}: the checkpoint holds {len(unexpected)} "
                         f"tensors the model lacks, e.g. {unexpected[:3]}")
    model.load_state_dict(new, strict=False)


@torch.no_grad()
def soft_restart(model: torch.nn.Module,
                 paths: Dict[str, Optional[str]]) -> None:
    """Overlay pretrained components onto a port QwenCALM in place.

    paths: {component: path or None}, components from `COMPONENTS` and
    "lora". A path is a reference checkpoint directory holding
    `<comp>.bin` (or .pt / .safetensors; peft's adapter_model.* for lora)
    or one such file. A component the directory does not hold is skipped;
    a path that does not exist raises FileNotFoundError; an orbax item
    `<dir>/<comp>/` raises (see the module docstring). The peft adapter
    merges into the LoRA leaves of `llm`."""
    for comp, path in paths.items():
        if not path:
            continue
        if os.path.isdir(path):
            if os.path.isdir(os.path.join(path, comp)):
                raise orbax_item_error(os.path.join(path, comp))
            path = _find_torch_component_file(path, comp)
            if path is None:
                continue  # nothing stored for this component
        elif not os.path.exists(path):
            raise FileNotFoundError(f"soft_restart: {comp} checkpoint {path} "
                                    "does not exist")
        elif not path.endswith(_TORCH_SUFFIXES):
            raise ValueError(f"soft_restart: {path} is not a torch "
                             f"checkpoint file ({', '.join(_TORCH_SUFFIXES)})")
        converted = load_torch_component(path, comp)
        if comp == "lora":
            _overlay(model, "llm", converted, LORA_LEAVES)
        else:
            _overlay(model, comp, converted)

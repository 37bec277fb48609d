"""Checkpoints (counterpart of audio_calm_tpu/train/checkpoint.py).

Train state: `make_manager` / `save_train_state` / `restore_train_state`
keep step checkpoints of a run in torch's own format (the card's machine
has no orbax): `<dir>/<step>/state.pt` holds the step, the trainable
tensors and the optimizer's state (train/optim.AdamW.state_dict), and
`<dir>/<step>/metrics.json` the metric that ranks it. Retention is the
orbax manager's that the JAX package configures: the `max_to_keep` latest,
or with a best metric the `max_to_keep` lowest plus those saved without a
metric.

Components: the reference saves each logical component of a CALM model
as its own `<component>.bin` (`COMPONENTS`) and the LoRA adapter in peft's
`adapter_model.bin`; `save_components` writes a trained model so (with a
`components.json` manifest, as JAX's), which is what the server's
`--components` reads, and `load_component` / `soft_restart` read it back.

The reference saves each logical component of a CALM model as its own
`<component>.bin` (`COMPONENTS`) and the LoRA adapter in peft's
`adapter_model.bin` / `.safetensors`; `soft_restart` overlays such files
onto a port QwenCALM (the stage-2 warm start, and how the server loads a
trained model). Writing them: `save_components`, or
models/convert_export.save_reference_checkpoint for a JAX-layout tree.

The JAX package also writes and prefers its own orbax items
(`<dir>/<component>/`). The port cannot read them (orbax is a JAX
library): where one exists, `soft_restart` raises and names it rather than
load the torch file beside it, which JAX would not have loaded. Export
such a directory on a host with the JAX package first:
`python scripts/export_reference.py --components <dir> --out <new dir>`
(its `save_reference_checkpoint`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from audio_calm_torch.models import convert as C
from audio_calm_torch.models.convert_export import save_reference_checkpoint
from audio_calm_torch.parallel.mesh import barrier, is_primary

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


# ---------------------------------------------------------------------------
# train state
# ---------------------------------------------------------------------------
class CheckpointManager:
    """Step checkpoints under one directory (`make_manager`)."""

    def __init__(self, directory: str, max_to_keep: int = 2,
                 best_metric: Optional[str] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int, name: str = "") -> str:
        return os.path.join(self.directory, str(step), name)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          self._path(int(d), "state.pt")))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Optional[Dict[str, float]]:
        path = self._path(step, "metrics.json")
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def _ranked(self) -> List[int]:
        """Steps with the best metric, worst first (orbax's order: a stable
        descending sort, so of equal values the later step ranks better)."""
        with_metric = [s for s in self.all_steps()
                       if self.best_metric in (self.metrics(s) or {})]
        return sorted(with_metric,
                      key=lambda s: self.metrics(s)[self.best_metric],
                      reverse=True)

    def best_step(self) -> Optional[int]:
        """The step with the lowest best metric; the latest step when no
        metric is tracked; None when nothing ranks."""
        if self.best_metric is None:
            return self.latest_step()
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    def save(self, step: int, payload: Dict[str, Any],
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Write `payload` (torch.save) and `metrics` as step `step`
        (through a temporary directory, renamed when complete), then drop
        the checkpoints retention does not keep."""
        tmp = self._path(step).rstrip(os.sep) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, "state.pt"))
        if metrics:
            with open(os.path.join(tmp, "metrics.json"), "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f)
        shutil.rmtree(self._path(step), ignore_errors=True)
        os.rename(tmp, self._path(step).rstrip(os.sep))
        for old in self._to_remove():
            shutil.rmtree(self._path(old), ignore_errors=True)

    def _to_remove(self) -> List[int]:
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return []
        if self.best_metric is None:
            return steps[:len(steps) - self.max_to_keep]
        ranked = self._ranked()
        keep = set(ranked[len(ranked) - self.max_to_keep:]
                   if self.max_to_keep else [])
        keep |= set(steps) - set(ranked)  # saved without the metric
        return [s for s in steps if s not in keep]

    def restore(self, step: int) -> Dict[str, Any]:
        return torch.load(self._path(step, "state.pt"), map_location="cpu",
                          weights_only=True)


def make_manager(directory: str, save_total_limit: int = 2,
                 best_metric: Optional[str] = "loss") -> CheckpointManager:
    """A manager keeping `save_total_limit` checkpoints: the latest, or
    with `best_metric` the lowest by it (JAX: orbax max_to_keep, best_fn,
    best_mode "min")."""
    return CheckpointManager(directory, save_total_limit, best_metric)


def save_train_state(manager: CheckpointManager, step: int, optimizer,
                     metrics: Optional[Dict[str, float]] = None) -> None:
    """Checkpoint the train state: the step, the optimizer's trainable
    tensors (`optimizer.params`) and its state, copied to the host. Under
    a process group every rank calls it (a ZeRO optimizer gathers its
    moments) and rank 0 alone writes, as JAX's loop writes from
    process_index 0; the ranks wait for the write."""
    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x

    state = optimizer.state_dict()
    if is_primary():
        manager.save(step, {"step": int(step),
                            "trainable": host(optimizer.params),
                            "opt_state": host(state)}, metrics)
    barrier()


@torch.no_grad()
def restore_train_state(manager: CheckpointManager, optimizer,
                        step: Optional[int] = None) -> int:
    """Load checkpoint `step` (default the latest) into the optimizer's
    trainable tensors and state in place -> the step restored."""
    step = manager.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {manager.directory}")
    payload = manager.restore(step)
    trainable = payload["trainable"]
    if set(trainable) != set(optimizer.params):
        raise ValueError(f"checkpoint {step}: its trainable tensors are not "
                         "this model's")
    for n, p in optimizer.params.items():
        if p.shape != trainable[n].shape:
            raise ValueError(f"checkpoint {step}: {n} has shape "
                             f"{tuple(trainable[n].shape)}, expected "
                             f"{tuple(p.shape)}")
        p.copy_(trainable[n])
    optimizer.load_state_dict(payload["opt_state"])
    return int(payload["step"])


# ---------------------------------------------------------------------------
# component export
# ---------------------------------------------------------------------------
def component_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors of a QwenCALM's COMPONENTS and LoRA adapter."""
    return {k: v for k, v in model.state_dict().items()
            if k.split(".")[0] in COMPONENTS
            or k.rsplit(".", 1)[-1] in LORA_LEAVES}


def save_components(model: torch.nn.Module, directory: str) -> List[str]:
    """Write a QwenCALM's components in the reference layout
    (`<dir>/<component>.bin`, the adapter as peft's `adapter_model.bin`;
    what the server's `--components` and `soft_restart` read) plus a
    `components.json` manifest -> the components written."""
    params = C.to_jax_params(component_state_dict(model))
    save_reference_checkpoint(params, directory)
    saved = [c for c in COMPONENTS if c in params]
    if any(k.rsplit(".", 1)[-1] in LORA_LEAVES
           for k in component_state_dict(model)):
        saved.append("lora")
    with open(os.path.join(directory, "components.json"), "w") as f:
        json.dump({"components": saved}, f)
    return saved


def load_component(directory: str, component: str) -> Any:
    """One component of a `save_components` directory (or any reference
    checkpoint directory) -> its JAX-layout tree of numpy fp32 arrays (see
    `load_torch_component`)."""
    path = _find_torch_component_file(directory, component)
    if path is None:
        raise FileNotFoundError(f"no {component} checkpoint in {directory}")
    return load_torch_component(path, component)


@torch.no_grad()
def load_qwen2_backbone(model: torch.nn.Module, path: str) -> None:
    """A HF Qwen2 checkpoint directory (model.qwen_path) -> the QwenCALM's
    embedding table and LLM base weights (its LoRA leaves stay)."""
    conv = C.convert_qwen2(C.load_hf_dir_state_dict(path), model.cfg.qwen)
    _overlay(model, "embed", conv["embed"])
    _overlay(model, "llm", conv["model"])

"""Carry weights between the JAX package's layout and the port's modules,
and read the reference's torch checkpoints.

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
`to_jax_params(state_dict)` is its exact inverse, back to numpy fp32; the
modules the names alone do not tell apart are in the layout table below.

The `load_*` helpers load with `strict=True`: every key present, none
unexpected. `jax_path` maps a QwenCALM parameter name back to its path in
the JAX tree (for optimizer labels and gradient comparisons).

`load_torch_state_dict` reads a torch checkpoint file (.bin / .pt / .ckpt,
or .safetensors through the reader below) into a flat dict of tensors.
The converters of the reference's checkpoints (the port's copy of the JAX
package's models/convert.py: HF Qwen2, torch MultiheadAttention, peft
adapters, the component heads and the AcousticVAE) take a flat
`{name: np.ndarray}` (`numpy_state_dict`) and return the JAX-layout tree of
numpy fp32 arrays that `from_jax_params` carries across; `merge_params`
overlays such a tree onto another, refusing a shape mismatch.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# the QwenCALM members of the ASR branch: flax initialises lazily per code
# path, so a tree made by the TTS forward alone does not hold them
ASR_COMPONENTS = ("asr_cross_attn", "asr_query_embed", "asr_flow_head")
_WRAPPERS = {"conv", "gn"}
_RENAMES = (
    (re.compile(r"^(up|down)(\d+)_(conv|res)$"), r"\1_\3.\2"),  # VAE stages
    (re.compile(r"_(\d+)(?=_|$)"), r".\1"),  # flax module lists
)
_VAE_STAGE = re.compile(r"^(up|down)_(conv|res)$")
# the layout table: flax modules that the names alone tell apart. Bare
# nn.Conv layers (no Conv1d wrapper: the legacy flow head's) keep the Conv
# layout; a bare 3-D kernel elsewhere is a ConvTranspose1d (the VAE's
# up<i>_conv, HiFi-GAN's ups_<i>, or a tree that is the module itself). The
# VAE's GroupNorms are the JAX GroupNorm wrapper (inner `gn`); the legacy
# head's out_norm is a bare nn.GroupNorm.
_BARE_CONV = re.compile(r"^(in_proj|out_proj|res\d+_conv[12])$")
_CONV_TRANSPOSE = re.compile(r"^(up\d+_conv|ups_\d+)$")
_GN_WRAPPED = re.compile(r"^(norm1|norm2|norm_out)$")


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
                conv = in_conv or bool(mods and _BARE_CONV.match(mods[-1]))
                arr = arr.transpose(2, 1, 0) if conv else arr.transpose(1, 2, 0)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        name = ".".join([_rename(m) for m in mods] + [leaf])
        out[name] = torch.tensor(arr, dtype=torch.float32)
    return out


def _jax_modules(mods) -> list:
    """Module path components of a port name -> flax module names (the
    inverse of `_rename`): `name.<i>` -> `name_<i>`, the VAE's
    `up_conv.<i>` -> `up<i>_conv`."""
    out: list = []
    for m in mods:
        if m.isdigit() and out:
            prev = out.pop()
            stage = _VAE_STAGE.match(prev)
            out.append(f"{stage[1]}{m}_{stage[2]}" if stage else f"{prev}_{m}")
        else:
            out.append(m)
    return out


def _jax_leaf(name: str, weight_ndim: Optional[int]
              ) -> Tuple[Tuple[str, ...], Optional[Tuple[int, ...]]]:
    """A port parameter name and the ndim of its module's `weight` (None
    when the module has none) -> (its path in the JAX tree, the axes that
    transpose its array there, or None): the inverse of `from_jax_params`'s
    naming and layouts, by the layout table."""
    *names, leaf = name.split(".")
    mods = _jax_modules(names)
    module = mods[-1] if mods else ""
    axes = None
    if leaf in ("weight", "bias") and weight_ndim == 3:
        bare = bool(_BARE_CONV.match(module))
        transposed = not bare and (not module
                                   or bool(_CONV_TRANSPOSE.match(module)))
        if not (bare or transposed):
            mods.append("conv")
        if leaf == "weight":
            axes = (2, 0, 1) if transposed else (2, 1, 0)
    elif leaf in ("weight", "bias") and weight_ndim == 1 \
            and _GN_WRAPPED.match(module):
        mods.append("gn")
    if leaf == "weight":
        axes = (1, 0) if weight_ndim == 2 else axes
        leaf = "scale" if weight_ndim == 1 else "kernel"
    return tuple(mods + [leaf]), axes


def _weight_name(name: str) -> str:
    return name.rsplit(".", 1)[0] + ".weight" if "." in name else "weight"


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """torch state_dict -> the JAX parameter tree (nested dicts of numpy
    fp32 arrays): the exact inverse of `from_jax_params` for the trees of
    the port's models."""
    tree: Dict[str, Any] = {}
    for name, value in state_dict.items():
        weight = state_dict.get(_weight_name(name))
        path, axes = _jax_leaf(name, None if weight is None else weight.ndim)
        arr = value.detach().float().cpu().numpy()
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = np.ascontiguousarray(
            arr if axes is None else arr.transpose(axes))
    return tree


def jax_path(model: torch.nn.Module, name: str) -> Tuple[str, ...]:
    """A parameter name of a port model -> its path in the JAX parameter
    tree (`to_jax_params`'s naming)."""
    try:
        weight = model.get_parameter(_weight_name(name))
    except AttributeError:
        weight = None
    return _jax_leaf(name, None if weight is None else weight.ndim)[0]


def load_calm(model, tree: Dict) -> None:
    """QwenCALM <- the JAX QwenCALM parameter tree, strictly for every
    branch the tree holds: the TTS branch always, the ASR branch
    (`ASR_COMPONENTS`) whole or not at all. Every parameter of a held
    branch is loaded and the tree has no parameter the model lacks; a tree
    without the ASR branch leaves the model's ASR modules as they are."""
    tree = _unwrap(tree)
    held = [c for c in ASR_COMPONENTS if c in tree]
    if held and len(held) != len(ASR_COMPONENTS):
        raise ValueError(f"load_calm: the tree holds {held} of the ASR "
                         f"branch {ASR_COMPONENTS}, not all of it")
    if "tts_flow_head" not in tree:
        raise ValueError("load_calm: the tree has no TTS branch "
                         "(tts_flow_head)")
    missing, unexpected = model.load_state_dict(from_jax_params(tree),
                                                strict=False)
    if not held:
        missing = [k for k in missing
                   if k.split(".")[0] not in ASR_COMPONENTS]
    if missing or unexpected:
        raise RuntimeError(f"load_calm: missing {missing}, unexpected "
                           f"{unexpected}")


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


def numpy_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{name: tensor} -> {name: numpy array}, floating tensors in fp32 (the
    JAX package's loader casts every tensor with .float(), so a bf16 or
    fp16 checkpoint converts to the same values)."""
    return {k: (v.float() if v.is_floating_point() else v).numpy()
            for k, v in sd.items()}


def load_hf_dir_state_dict(path: str) -> Dict[str, np.ndarray]:
    """All weight shards of a HF checkpoint directory -> {name: numpy}:
    the .safetensors shards, or else the .bin shards that are not
    optimizer state."""
    out: Dict[str, np.ndarray] = {}
    files = sorted(os.listdir(path))
    shards = [f for f in files if f.endswith(".safetensors")]
    if not shards:
        shards = [f for f in files if f.endswith(".bin") and "optim" not in f]
    for f in shards:
        out.update(numpy_state_dict(load_torch_state_dict(
            os.path.join(path, f))))
    return out


# ---------------------------------------------------------------------------
# reference checkpoints -> JAX-layout trees (the JAX package's
# models/convert.py, copied: a flat {name: np.ndarray} in, numpy fp32 out)
# ---------------------------------------------------------------------------
def convert_qwen2(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """HF Qwen2 state dict -> {"embed": ..., "model": ...} trees (HF linear
    weights [out, in] -> kernels [in, out]); names with or without the
    "model." prefix, a bias wherever the checkpoint holds one."""

    def get(name):
        for prefix in ("model.", ""):
            if prefix + name in sd:
                return np.asarray(sd[prefix + name])
        raise KeyError(name)

    embed = {"embedding": get("embed_tokens.weight").astype(np.float32)}
    model: Dict[str, Any] = {}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        attn = {}
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            d = {"kernel": get(p + f"self_attn.{proj}.weight").T.astype(
                np.float32)}
            bname = p + f"self_attn.{proj}.bias"
            if ("model." + bname) in sd or bname in sd:
                d["bias"] = get(bname).astype(np.float32)
            attn[proj] = d
        mlp = {proj: {"kernel": get(p + f"mlp.{proj}.weight").T.astype(
            np.float32)} for proj in ("gate_proj", "up_proj", "down_proj")}
        model[f"layers_{i}"] = {
            "self_attn": attn,
            "mlp": mlp,
            "input_layernorm": {
                "scale": get(p + "input_layernorm.weight").astype(np.float32)},
            "post_attention_layernorm": {
                "scale": get(p + "post_attention_layernorm.weight").astype(
                    np.float32)},
        }
    model["norm"] = {"scale": get("norm.weight").astype(np.float32)}
    return {"embed": embed, "model": model}


def merge_params(initialized: Any, converted: Any) -> Any:
    """Overlay converted leaves onto an initialized tree; leaves the
    conversion does not provide (e.g. lora_a / lora_b) stay, new ones are
    added, and a leaf whose shape differs raises ValueError."""
    if isinstance(initialized, dict):
        out = dict(initialized)
        for k, v in (converted or {}).items():
            out[k] = merge_params(out[k], v) if k in out else v
        return out
    if converted is None:
        return initialized
    converted = np.asarray(converted)
    if np.shape(initialized) != converted.shape:
        raise ValueError(f"merge_params: shape {converted.shape} does not fit "
                         f"the initialized {np.shape(initialized)}")
    return converted


def convert_torch_mha(sd: Dict[str, np.ndarray],
                      prefix: str = "") -> Dict[str, Any]:
    """torch nn.MultiheadAttention (packed in_proj) -> {q,k,v,out}_proj
    {kernel, bias}."""
    w = np.asarray(sd[prefix + "in_proj_weight"])  # [3E, E]
    b = np.asarray(sd[prefix + "in_proj_bias"])  # [3E]
    E = w.shape[1]
    wq, wk, wv = w[:E], w[E:2 * E], w[2 * E:]
    bq, bk, bv = b[:E], b[E:2 * E], b[2 * E:]
    return {
        "q_proj": {"kernel": wq.T.astype(np.float32),
                   "bias": bq.astype(np.float32)},
        "k_proj": {"kernel": wk.T.astype(np.float32),
                   "bias": bk.astype(np.float32)},
        "v_proj": {"kernel": wv.T.astype(np.float32),
                   "bias": bv.astype(np.float32)},
        "out_proj": {
            "kernel": np.asarray(sd[prefix + "out_proj.weight"]).T.astype(
                np.float32),
            "bias": np.asarray(sd[prefix + "out_proj.bias"]).astype(
                np.float32),
        },
    }


def convert_peft_adapter(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """peft `adapter_model.bin` / `.safetensors` state dict -> the partial
    llm tree of lora_a / lora_b leaves. Keys look like
    base_model.model.model.layers.3.self_attn.q_proj.lora_A.weight (older
    saves carry a `.default.` adapter name); peft's A [r, in] and B
    [out, r] transpose to lora_a [in, r] and lora_b [r, out] (alpha / r is
    applied at run time on both sides). Entries that are not LoRA A/B are
    skipped; no A/B at all raises."""
    out: Dict[str, Any] = {}
    for key, value in sd.items():
        k = key.replace(".default.", ".")
        if ".lora_A." in k:
            leaf = "lora_a"
        elif ".lora_B." in k:
            leaf = "lora_b"
        else:
            continue
        parts = k.split(".")
        try:
            li = parts.index("layers")
        except ValueError:
            raise KeyError(f"cannot locate layer index in peft key {key!r}")
        layer, module, proj = parts[li + 1], parts[li + 2], parts[li + 3]
        w = np.asarray(value).T.astype(np.float32)
        out.setdefault(f"layers_{layer}", {}).setdefault(
            module, {}).setdefault(proj, {})[leaf] = w
    if not out:
        raise ValueError("no lora_A/lora_B tensors found in adapter state dict")
    return out


def conv1d_w(w: np.ndarray) -> np.ndarray:
    """torch Conv1d weight [out, in, k] -> flax [k, in, out]."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0))).astype(np.float32)


def conv_transpose1d_w(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose1d weight [in, out, k] -> the JAX [k, in, out]."""
    return np.ascontiguousarray(np.transpose(w, (2, 0, 1))).astype(np.float32)


def _lin(sd, name):
    """torch Linear -> flax Dense."""
    return {"kernel": np.asarray(sd[name + ".weight"]).T.astype(np.float32),
            "bias": np.asarray(sd[name + ".bias"]).astype(np.float32)}


def _conv(sd, name):
    return {"conv": {"kernel": conv1d_w(np.asarray(sd[name + ".weight"])),
                     "bias": np.asarray(sd[name + ".bias"]).astype(
                         np.float32)}}


def _gn(sd, name):
    return {"gn": _ln(sd, name)}


def _ln(sd, name):
    return {"scale": np.asarray(sd[name + ".weight"]).astype(np.float32),
            "bias": np.asarray(sd[name + ".bias"]).astype(np.float32)}


def convert_flow_head(sd: Dict[str, np.ndarray], num_layers: int,
                      has_context: bool) -> Dict[str, Any]:
    """Reference TransformerFlowHead state dict (tts_flow_head.bin /
    asr_flow_head.bin) -> the DiT head's tree."""
    out: Dict[str, Any] = {
        "time_mlp": {"fc1": _lin(sd, "time_mlp.1"),
                     "fc2": _lin(sd, "time_mlp.3")},
        "in_proj": _lin(sd, "in_proj"),
        "out_proj": _lin(sd, "out_proj"),
        "final_adaLN": {"emb": _lin(sd, "final_adaLN.emb.1")},
    }
    if has_context and "context_proj.weight" in sd:
        out["context_proj"] = _lin(sd, "context_proj")
    for i in range(num_layers):
        p = f"blocks.{i}."
        blk: Dict[str, Any] = {
            "adaLN1": {"emb": _lin(sd, p + "adaLN1.emb.1")},
            "adaLN2": {"emb": _lin(sd, p + "adaLN2.emb.1")},
            "attn": convert_torch_mha(sd, p + "attn."),
            "mlp_fc1": _lin(sd, p + "mlp.0"),
            "mlp_fc2": _lin(sd, p + "mlp.2"),
        }
        if (p + "ctx_attn.in_proj_weight") in sd:
            blk["adaLN_ctx"] = {"emb": _lin(sd, p + "adaLN_ctx.emb.1")}
            blk["ctx_attn"] = convert_torch_mha(sd, p + "ctx_attn.")
            blk["ctx_gate"] = np.asarray(sd[p + "ctx_gate"]).astype(np.float32)
        out[f"blocks_{i}"] = blk
    return out


def convert_legacy_flow_head(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Reference legacy dilated-ResNet FlowMatchingHead state dict (pre-DiT
    checkpoints: time_mlp.{1,3} Linear, in_proj Conv1d k3,
    layers.{i}.conv.{1,3} Conv1d k3 dilated and k1, out_proj.0 GroupNorm,
    out_proj.2 Conv1d k3) -> calm_heads.FlowMatchingHead's tree."""

    def conv(name):
        return {"kernel": conv1d_w(np.asarray(sd[name + ".weight"])),
                "bias": np.asarray(sd[name + ".bias"]).astype(np.float32)}

    num_layers = 0
    while f"layers.{num_layers}.conv.1.weight" in sd:
        num_layers += 1
    out: Dict[str, Any] = {
        "time_fc1": _lin(sd, "time_mlp.1"),
        "time_fc2": _lin(sd, "time_mlp.3"),
        "in_proj": conv("in_proj"),
        "out_norm": _ln(sd, "out_proj.0"),
        "out_proj": conv("out_proj.2"),
    }
    for i in range(num_layers):
        out[f"res{i}_conv1"] = conv(f"layers.{i}.conv.1")
        out[f"res{i}_conv2"] = conv(f"layers.{i}.conv.3")
    return out


def is_legacy_flow_head(sd: Dict[str, np.ndarray]) -> bool:
    """A pre-DiT ResNet head's state dict, not a DiT head's."""
    return "layers.0.conv.1.weight" in sd


def convert_input_projector(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Reference AudioInputProjector (input_proj.bin) -> its tree."""
    out: Dict[str, Any] = {
        "conv1": _conv(sd, "conv_block.0.conv"),
        "conv2": _conv(sd, "conv_block.2.conv"),
        "post_norm": _ln(sd, "post_norm"),
    }
    for i in range(2):
        out[f"block{i}_ln"] = _ln(sd, f"blocks.{i}.0")
        out[f"block{i}_fc1"] = _lin(sd, f"blocks.{i}.1")
        out[f"block{i}_fc2"] = _lin(sd, f"blocks.{i}.3")
    return out


def convert_predictor(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Reference length / duration predictor (Sequential Linear-GELU-Linear)."""
    return {"fc1": _lin(sd, "0"), "fc2": _lin(sd, "2")}


def convert_vae_params(sd: Dict[str, np.ndarray],
                       strides=(2, 2)) -> Dict[str, Any]:
    """Reference AcousticVAE state dict -> the AcousticVAE tree."""

    def res(prefix):
        return {"norm1": _gn(sd, prefix + ".conv.0"),
                "conv1": _conv(sd, prefix + ".conv.2"),
                "norm2": _gn(sd, prefix + ".conv.3"),
                "conv2": _conv(sd, prefix + ".conv.5")}

    n = len(strides)
    enc: Dict[str, Any] = {"conv_in": _conv(sd, "encoder.0")}
    for i in range(n):
        enc[f"down{i}_conv"] = _conv(sd, f"encoder.{i + 1}.0")
        enc[f"down{i}_res"] = res(f"encoder.{i + 1}.1")
    enc["norm_out"] = _gn(sd, f"encoder.{n + 1}")
    enc["conv_out"] = _conv(sd, f"encoder.{n + 3}")
    dec: Dict[str, Any] = {
        "conv_in": _conv(sd, "decoder_net.0.0"),
        "res_in": res("decoder_net.0.1"),
        "conv_out": _conv(sd, "final_proj"),
    }
    for i in range(n):
        dec[f"up{i}_conv"] = {
            "kernel": conv_transpose1d_w(
                np.asarray(sd[f"decoder_net.{i + 1}.0.weight"])),
            "bias": np.asarray(sd[f"decoder_net.{i + 1}.0.bias"]).astype(
                np.float32),
        }
        dec[f"up{i}_res"] = res(f"decoder_net.{i + 1}.1")
    return {"encoder": enc, "decoder": dec}

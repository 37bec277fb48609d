"""Reverse converters: JAX-layout trees -> the reference's torch state dicts
(the port's copy of the JAX package's models/convert_export.py).

models/convert.py makes the reference's checkpoints load into the port;
this module writes the port's weights in the reference's component-.bin
layout (one `<component>.bin` each) plus a peft-format LoRA adapter, the
files `train/checkpoint.soft_restart` and the reference's loader read.
Every exporter is the exact inverse of its counterpart in convert.py. A
port model's weights come in through `convert.to_jax_params(
model.state_dict())`, so the exporters are the JAX package's, line for
line. All outputs are {name: np.ndarray}.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def export_linear(tree: Dict, prefix: str, out: Dict) -> None:
    out[prefix + ".weight"] = _np(tree["kernel"]).T
    if "bias" in tree:
        out[prefix + ".bias"] = _np(tree["bias"])


def export_conv1d(tree: Dict, prefix: str, out: Dict) -> None:
    """[k, in, out] -> torch Conv1d [out, in, k]; a Conv1d wrapper
    ({"conv": {...}}) or a bare nn.Conv tree."""
    node = tree.get("conv", tree)
    out[prefix + ".weight"] = np.transpose(_np(node["kernel"]), (2, 1, 0))
    if "bias" in node:
        out[prefix + ".bias"] = _np(node["bias"])


def export_conv_transpose1d(tree: Dict, prefix: str, out: Dict) -> None:
    """[k, in, out] -> torch ConvTranspose1d [in, out, k]."""
    out[prefix + ".weight"] = np.transpose(_np(tree["kernel"]), (1, 2, 0))
    out[prefix + ".bias"] = _np(tree["bias"])


def export_norm(tree: Dict, prefix: str, out: Dict) -> None:
    """LayerNorm / GroupNorm {scale, bias} (possibly under "gn")."""
    node = tree.get("gn", tree)
    out[prefix + ".weight"] = _np(node["scale"])
    out[prefix + ".bias"] = _np(node["bias"])


def export_mha(tree: Dict, prefix: str, out: Dict) -> None:
    """Split q/k/v/out projections -> torch nn.MultiheadAttention's packed
    in_proj (inverse of convert.convert_torch_mha)."""
    wq = _np(tree["q_proj"]["kernel"]).T
    wk = _np(tree["k_proj"]["kernel"]).T
    wv = _np(tree["v_proj"]["kernel"]).T
    out[prefix + "in_proj_weight"] = np.concatenate([wq, wk, wv], axis=0)
    out[prefix + "in_proj_bias"] = np.concatenate([
        _np(tree["q_proj"]["bias"]),
        _np(tree["k_proj"]["bias"]),
        _np(tree["v_proj"]["bias"]),
    ])
    out[prefix + "out_proj.weight"] = _np(tree["out_proj"]["kernel"]).T
    out[prefix + "out_proj.bias"] = _np(tree["out_proj"]["bias"])


# ---------------------------------------------------------------------------
# components (inverse of convert.convert_*)
# ---------------------------------------------------------------------------
def export_flow_head(tree: Dict) -> Dict[str, np.ndarray]:
    """TransformerFlowHead tree -> reference DiT state dict."""
    sd: Dict[str, np.ndarray] = {}
    export_linear(tree["time_mlp"]["fc1"], "time_mlp.1", sd)
    export_linear(tree["time_mlp"]["fc2"], "time_mlp.3", sd)
    export_linear(tree["in_proj"], "in_proj", sd)
    export_linear(tree["out_proj"], "out_proj", sd)
    export_linear(tree["final_adaLN"]["emb"], "final_adaLN.emb.1", sd)
    if "context_proj" in tree:
        export_linear(tree["context_proj"], "context_proj", sd)
    i = 0
    while f"blocks_{i}" in tree:
        blk = tree[f"blocks_{i}"]
        p = f"blocks.{i}."
        export_linear(blk["adaLN1"]["emb"], p + "adaLN1.emb.1", sd)
        export_linear(blk["adaLN2"]["emb"], p + "adaLN2.emb.1", sd)
        export_mha(blk["attn"], p + "attn.", sd)
        export_linear(blk["mlp_fc1"], p + "mlp.0", sd)
        export_linear(blk["mlp_fc2"], p + "mlp.2", sd)
        if "ctx_attn" in blk:
            export_linear(blk["adaLN_ctx"]["emb"], p + "adaLN_ctx.emb.1", sd)
            export_mha(blk["ctx_attn"], p + "ctx_attn.", sd)
            sd[p + "ctx_gate"] = _np(blk["ctx_gate"])
        i += 1
    return sd


def export_legacy_flow_head(tree: Dict) -> Dict[str, np.ndarray]:
    """FlowMatchingHead (dilated ResNet) tree -> reference legacy state
    dict."""
    sd: Dict[str, np.ndarray] = {}
    export_linear(tree["time_fc1"], "time_mlp.1", sd)
    export_linear(tree["time_fc2"], "time_mlp.3", sd)
    export_conv1d(tree["in_proj"], "in_proj", sd)
    export_norm(tree["out_norm"], "out_proj.0", sd)
    export_conv1d(tree["out_proj"], "out_proj.2", sd)
    i = 0
    while f"res{i}_conv1" in tree:
        export_conv1d(tree[f"res{i}_conv1"], f"layers.{i}.conv.1", sd)
        export_conv1d(tree[f"res{i}_conv2"], f"layers.{i}.conv.3", sd)
        i += 1
    return sd


def export_input_projector(tree: Dict) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    export_conv1d(tree["conv1"], "conv_block.0.conv", sd)
    export_conv1d(tree["conv2"], "conv_block.2.conv", sd)
    export_norm(tree["post_norm"], "post_norm", sd)
    for i in range(2):
        export_norm(tree[f"block{i}_ln"], f"blocks.{i}.0", sd)
        export_linear(tree[f"block{i}_fc1"], f"blocks.{i}.1", sd)
        export_linear(tree[f"block{i}_fc2"], f"blocks.{i}.3", sd)
    return sd


def export_predictor(tree: Dict) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    export_linear(tree["fc1"], "0", sd)
    export_linear(tree["fc2"], "2", sd)
    return sd


def export_vae(tree: Dict, strides=(2, 2)) -> Dict[str, np.ndarray]:
    """AcousticVAE tree -> reference state dict (inverse of
    convert.convert_vae_params)."""
    sd: Dict[str, np.ndarray] = {}

    def res(rt, prefix):
        export_norm(rt["norm1"], prefix + ".conv.0", sd)
        export_conv1d(rt["conv1"], prefix + ".conv.2", sd)
        export_norm(rt["norm2"], prefix + ".conv.3", sd)
        export_conv1d(rt["conv2"], prefix + ".conv.5", sd)

    n = len(strides)
    enc = tree["encoder"]
    export_conv1d(enc["conv_in"], "encoder.0", sd)
    for i in range(n):
        export_conv1d(enc[f"down{i}_conv"], f"encoder.{i + 1}.0", sd)
        res(enc[f"down{i}_res"], f"encoder.{i + 1}.1")
    export_norm(enc["norm_out"], f"encoder.{n + 1}", sd)
    export_conv1d(enc["conv_out"], f"encoder.{n + 3}", sd)

    dec = tree["decoder"]
    export_conv1d(dec["conv_in"], "decoder_net.0.0", sd)
    res(dec["res_in"], "decoder_net.0.1")
    for i in range(n):
        export_conv_transpose1d(dec[f"up{i}_conv"], f"decoder_net.{i + 1}.0",
                                sd)
        res(dec[f"up{i}_res"], f"decoder_net.{i + 1}.1")
    export_conv1d(dec["conv_out"], "final_proj", sd)
    return sd


def export_peft_adapter(llm_tree: Dict) -> Dict[str, np.ndarray]:
    """lora_a / lora_b leaves -> peft adapter_model state dict (inverse of
    convert.convert_peft_adapter)."""
    sd: Dict[str, np.ndarray] = {}
    i = 0
    while f"layers_{i}" in llm_tree:
        layer = llm_tree[f"layers_{i}"]
        for mod in ("self_attn", "mlp"):
            for proj, node in layer.get(mod, {}).items():
                if not isinstance(node, dict) or "lora_a" not in node:
                    continue
                base = f"base_model.model.model.layers.{i}.{mod}.{proj}"
                sd[base + ".lora_A.weight"] = _np(node["lora_a"]).T
                sd[base + ".lora_B.weight"] = _np(node["lora_b"]).T
        i += 1
    return sd


def _mha_sd(tree: Dict) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    export_mha(tree, "", sd)
    return sd


_COMPONENT_EXPORTERS = {
    "input_proj": export_input_projector,
    "tts_flow_head": export_flow_head,
    "asr_flow_head": export_flow_head,
    "tts_len_predictor": export_predictor,
    "tts_dur_predictor": export_predictor,
    "asr_cross_attn": _mha_sd,
}


def export_components(params: Dict) -> Dict[str, Dict[str, np.ndarray]]:
    """A CALM tree -> {component: state dict} in the reference's save
    layout (8 component .bins + the peft adapter when LoRA is present)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, fn in _COMPONENT_EXPORTERS.items():
        if name in params:
            out[name] = fn(params[name])
    if "soa_embed" in params:
        out["soa_embed"] = {"weight": _np(params["soa_embed"])}
    if "asr_query_embed" in params:
        out["asr_query_embed"] = {
            "weight": _np(params["asr_query_embed"]["embedding"])}
    if "llm" in params:
        adapter = export_peft_adapter(params["llm"])
        if adapter:
            out["adapter_model"] = adapter
    return out


def save_reference_checkpoint(params: Dict, directory: str,
                              vae_params: Optional[Dict] = None) -> list:
    """torch.save each exported component as `<dir>/<name>.bin` (the
    reference checkpoint layout; `vae.bin` from `vae_params`) -> the list
    of files written."""
    os.makedirs(directory, exist_ok=True)
    written = []
    sds = export_components(params)
    if vae_params is not None:
        sds["vae"] = export_vae(vae_params)
    for name, sd in sds.items():
        path = os.path.join(directory, f"{name}.bin")
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in sd.items()}, path)
        written.append(path)
    return written

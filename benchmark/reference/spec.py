"""The parameters of every module the benchmark serves, and how their
seeded values are drawn: one list of (name, shape, mean, std) a module.

The names and shapes are those of the published architectures as the
served modules hold them (a Linear weight [out, in], a convolution
[out, in, k], a transposed convolution [in, out, k], LoRA's A [in, r] and
B [r, out]); the harness refuses to run when the program's modules differ
from them. Values are normal draws, scaled so that every layer changes
what it passes on: products by 1 / sqrt(fan-in), norm scales about 1,
biases, gates and tables as set below. `draw` makes them from one seed in a
few large calls, one per (mean, std) group, so the same seed gives the same
values to the program and to the reference.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], float, float]]

BIAS_STD = 0.02
NORM_STD = 0.1
LORA_B_GAIN = 0.25
# the vocoder's last convolution: its output goes through tanh, and a gain
# below 1 keeps the waveform mostly off the saturated ends
HIFIGAN_POST_GAIN = 0.15


def _linear(spec: Spec, name: str, d_in: int, d_out: int,
            bias: bool = True) -> None:
    spec.append((f"{name}.weight", (d_out, d_in), 0.0, d_in ** -0.5))
    if bias:
        spec.append((f"{name}.bias", (d_out,), 0.0, BIAS_STD))


def _norm(spec: Spec, name: str, dim: int, bias: bool = True) -> None:
    spec.append((f"{name}.weight", (dim,), 1.0, NORM_STD))
    if bias:
        spec.append((f"{name}.bias", (dim,), 0.0, BIAS_STD))


def _conv(spec: Spec, name: str, c_in: int, c_out: int, k: int,
          gain: float = 1.0) -> None:
    spec.append((f"{name}.weight", (c_out, c_in, k), 0.0,
                 gain / math.sqrt(c_in * k)))
    spec.append((f"{name}.bias", (c_out,), 0.0, BIAS_STD))


def _conv_t(spec: Spec, name: str, c_in: int, c_out: int, k: int,
            stride: int) -> None:
    spec.append((f"{name}.weight", (c_in, c_out, k), 0.0,
                 1.0 / math.sqrt(c_in * k / stride)))
    spec.append((f"{name}.bias", (c_out,), 0.0, BIAS_STD))


def _mha(spec: Spec, name: str, dim: int) -> None:
    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(spec, f"{name}.{p}", dim, dim)


def _flow_head(spec: Spec, name: str, d_in: int, d_out: int, hidden: int,
               layers: int, context_dim, time_dim: int = 256) -> None:
    _linear(spec, f"{name}.time_mlp.fc1", time_dim, time_dim)
    _linear(spec, f"{name}.time_mlp.fc2", time_dim, time_dim)
    _linear(spec, f"{name}.in_proj", d_in + d_out, hidden)
    if context_dim is not None:
        _linear(spec, f"{name}.context_proj", context_dim, hidden)
    for j in range(layers):
        b = f"{name}.blocks.{j}"
        _linear(spec, f"{b}.adaLN1.emb", time_dim, 2 * hidden)
        _mha(spec, f"{b}.attn", hidden)
        if context_dim is not None:
            spec.append((f"{b}.ctx_gate", (1,), 0.0, 1.0))
            _linear(spec, f"{b}.adaLN_ctx.emb", time_dim, 2 * hidden)
            _mha(spec, f"{b}.ctx_attn", hidden)
        _linear(spec, f"{b}.adaLN2.emb", time_dim, 2 * hidden)
        _linear(spec, f"{b}.mlp_fc1", hidden, 4 * hidden)
        _linear(spec, f"{b}.mlp_fc2", 4 * hidden, hidden)
    _linear(spec, f"{name}.final_adaLN.emb", time_dim, 2 * hidden)
    _linear(spec, f"{name}.out_proj", hidden, d_out)


def calm_spec(model: dict) -> Spec:
    """QwenCALM: the Qwen2 backbone with LoRA on its targets, the audio
    projector, SOA, the TTS DiT head and predictors, and the ASR branch."""
    q = model["qwen"]
    D, F_, hd = q["hidden_size"], q["intermediate_size"], q["head_dim"]
    Hq, Hkv = q["num_attention_heads"], q["num_key_value_heads"]
    lora = model["lora"]
    r = lora["rank"] if model.get("use_lora", True) else 0
    targets = set(lora["target_modules"]) if r else set()
    lat = model["latent_dim"]
    spec: Spec = [("soa_embed", (1, 1, D), 0.0, 1.0),
                  ("embed.embedding", (q["vocab_size"], D), 0.0, 1.0)]

    def proj(name, short, d_in, d_out, bias):
        _linear(spec, name, d_in, d_out, bias)
        if short in targets:
            spec.append((f"{name}.lora_a", (d_in, r), 0.0, d_in ** -0.5))
            spec.append((f"{name}.lora_b", (r, d_out), 0.0,
                         LORA_B_GAIN / math.sqrt(r)))

    for i in range(q["num_hidden_layers"]):
        p = f"llm.layers.{i}"
        _norm(spec, f"{p}.input_layernorm", D, bias=False)
        proj(f"{p}.self_attn.q_proj", "q_proj", D, Hq * hd, True)
        proj(f"{p}.self_attn.k_proj", "k_proj", D, Hkv * hd, True)
        proj(f"{p}.self_attn.v_proj", "v_proj", D, Hkv * hd, True)
        proj(f"{p}.self_attn.o_proj", "o_proj", Hq * hd, D, False)
        _norm(spec, f"{p}.post_attention_layernorm", D, bias=False)
        proj(f"{p}.mlp.gate_proj", "gate_proj", D, F_, False)
        proj(f"{p}.mlp.up_proj", "up_proj", D, F_, False)
        proj(f"{p}.mlp.down_proj", "down_proj", F_, D, False)
    _norm(spec, "llm.norm", D, bias=False)
    # the audio input projector (the ASR path's; drawn so that every
    # parameter the served model holds has a value)
    _conv(spec, "input_proj.conv1", lat, D, 3)
    _conv(spec, "input_proj.conv2", D, D, 3)
    for i in range(2):
        _norm(spec, f"input_proj.block{i}_ln", D)
        _linear(spec, f"input_proj.block{i}_fc1", D, 2 * D)
        _linear(spec, f"input_proj.block{i}_fc2", 2 * D, D)
    _norm(spec, "input_proj.post_norm", D)
    _flow_head(spec, "tts_flow_head", D, lat, model["tts_flow_hidden_dim"],
               model["tts_flow_num_layers"], D)
    for pred in ("tts_len_predictor", "tts_dur_predictor"):
        _linear(spec, f"{pred}.fc1", D, D // 2)
        _linear(spec, f"{pred}.fc2", D // 2, 1)
    _mha(spec, "asr_cross_attn", D)
    spec.append(("asr_query_embed.embedding", (model["max_text_len"], D),
                 0.0, 1.0))
    _flow_head(spec, "asr_flow_head", D, D, model["asr_flow_hidden_dim"],
               model["asr_flow_num_layers"], None)
    return spec


def vae_spec(vae: dict) -> Spec:
    """The acoustic VAE: encoder and decoder, masked GroupNorm ResBlocks."""
    C, lat, mel = vae["hidden_channels"], vae["latent_channels"], \
        vae["in_channels"]
    spec: Spec = []

    def res(name):
        _norm(spec, f"{name}.norm1", C)
        _conv(spec, f"{name}.conv1", C, C, 3)
        _norm(spec, f"{name}.norm2", C)
        _conv(spec, f"{name}.conv2", C, C, 3)

    _conv(spec, "encoder.conv_in", mel, C, 3)
    for i, s in enumerate(vae["strides"]):
        _conv(spec, f"encoder.down_conv.{i}", C, C, 2 * s)
    for i in range(len(vae["strides"])):
        res(f"encoder.down_res.{i}")
    _norm(spec, "encoder.norm_out", C)
    _conv(spec, "encoder.conv_out", C, 2 * lat, 3)
    _conv(spec, "decoder.conv_in", lat, C, 3)
    res("decoder.res_in")
    for i, s in enumerate(reversed(vae["strides"])):
        _conv_t(spec, f"decoder.up_conv.{i}", C, C, 2 * s, s)
    for i in range(len(vae["strides"])):
        res(f"decoder.up_res.{i}")
    _conv(spec, "decoder.conv_out", C, mel, 3)
    return spec


def hifigan_spec(h: dict) -> Spec:
    """HiFi-GAN's generator, in the official checkpoint's naming
    (resblock j of stage i at resblocks.{i * kernels + j})."""
    spec: Spec = []
    ch = h["upsample_initial_channel"]
    _conv(spec, "conv_pre", h["in_channels"], ch, 7)
    n_k = len(h["resblock_kernel_sizes"])
    for i, (r, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        _conv_t(spec, f"ups.{i}", ch, ch // 2, k, r)
        ch //= 2
    ch = h["upsample_initial_channel"]
    for i in range(len(h["upsample_rates"])):
        ch //= 2
        for j, (rk, rd) in enumerate(zip(h["resblock_kernel_sizes"],
                                         h["resblock_dilations"])):
            for conv in ("convs1", "convs2"):
                for c in range(len(rd)):
                    _conv(spec, f"resblocks.{i * n_k + j}.{conv}.{c}", ch,
                          ch, rk)
    _conv(spec, "conv_post", ch, 1, 7, gain=HIFIGAN_POST_GAIN)
    return spec


def draw(spec: Spec, seed: int, device, dtype=torch.float32
         ) -> "OrderedDict[str, torch.Tensor]":
    """The spec's tensors from one generator on `device` seeded `seed`:
    one flat `normal_` call for each (mean, std) group, in sorted group
    order, the leaves of a group in spec order, each a view of its group."""
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    groups: Dict[Tuple[float, float], list] = {}
    for name, shape, mean, std in spec:
        groups.setdefault((mean, std), []).append((name, shape))
    out: Dict[str, torch.Tensor] = {}
    for (mean, std), leaves in sorted(groups.items()):
        sizes = [math.prod(s) for _, s in leaves]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        flat.normal_(mean, std, generator=gen)
        for (name, shape), part in zip(leaves, flat.split(sizes)):
            out[name] = part.view(shape)
    return OrderedDict((name, out[name]) for name, _, _, _ in spec)


def component_seeds(seed: int) -> Tuple[int, int, int]:
    """The seeds of the CALM model, the VAE and HiFi-GAN of a run."""
    base = int(seed) % (1 << 61)
    return base * 4 + 1, base * 4 + 2, base * 4 + 3

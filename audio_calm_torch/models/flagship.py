"""Flagship model assembly (counterpart of audio_calm_tpu/models/flagship.py):
Qwen2-1.5B geometry backbone (+LoRA r=64), DiT TTS head (hidden 1024, 4
layers), 128-dim acoustic VAE, HiFi-GAN V1, with random weights made on
the card from a seed.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audio_calm_torch.config import CALMModelConfig, LoRAConfig, Qwen2Config


_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(name: str) -> torch.dtype:
    """evaluation.compute_dtype -> torch dtype: "float32" is the reference
    eval protocol, "bfloat16" the serving recipe."""
    try:
        return _COMPUTE_DTYPES[name]
    except KeyError:
        raise ValueError(
            "evaluation.compute_dtype must be one of "
            f"{sorted(_COMPUTE_DTYPES)}, got {name!r}") from None


def flagship_config(num_llm_layers: Optional[int] = None,
                    max_audio_len: int = 384,
                    max_text_len: int = 96) -> CALMModelConfig:
    qwen = Qwen2Config()
    if num_llm_layers is not None:
        qwen.num_hidden_layers = num_llm_layers
    return CALMModelConfig(
        latent_dim=128,
        max_audio_len=max_audio_len,
        max_text_len=max_text_len,
        tts_flow_hidden_dim=1024,
        tts_flow_num_layers=4,
        asr_flow_hidden_dim=1024,
        asr_flow_num_layers=4,
        flow_num_heads=16,
        qwen=qwen,
        lora=LoRAConfig(rank=64, alpha=128.0, dropout=0.05),
        latent_mean=0.039775,
        latent_std=1.190864,
    )


@torch.no_grad()
def random_normal_(module: nn.Module, seed: int = 0,
                   scale: float = 0.02) -> nn.Module:
    """Every floating parameter <- scale * N(0, 1), drawn on the parameter's
    device from one seeded generator (the JAX `device_random_params`: small
    random normals, not zeros, so no product can be folded away)."""
    gens = {}
    for p in module.parameters():
        if p.is_floating_point():
            if p.device not in gens:
                gens[p.device] = torch.Generator(p.device).manual_seed(seed)
            p.normal_(0.0, scale, generator=gens[p.device])
    return module


def build_random(factory, device, seed: int = 0, scale: float = 0.02,
                 dtype: torch.dtype = torch.float32) -> nn.Module:
    """factory() built directly on `device`, random-normal weights from
    `seed`, then cast to `dtype` (bf16 for serving, the JAX
    `cast_floating`), for inference: eval mode, no gradients."""
    with torch.device(device):
        module = factory()
    random_normal_(module, seed, scale)
    return module.to(dtype).eval().requires_grad_(False)

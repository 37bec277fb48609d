"""audio_calm_torch: the PyTorch / CUDA port of audio_calm_tpu for one
NVIDIA H100.

Layout mirrors the JAX package (config, models/, ops/, eval/); the Pallas
TPU kernels on the TTS path become hand-written CUDA C++ kernels under
csrc/, each beside a plain PyTorch version of the same function.

Device policy: entry points take `device=None`, which means the card. With
no card they raise; they run on the CPU only when the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA card (raise if there is none); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "audio_calm_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)

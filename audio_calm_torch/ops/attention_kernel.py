"""Fused attention forward: csrc/attention_fwd.cu and its plain version.

Counterpart of the Pallas kernels `fused_attention` (K3) and
`fused_attention_batched` (K4) in audio_calm_tpu/ops/pallas_attention.py,
which compute one function: SDPA over q [B, T, Hq, d], k/v [B, S, Hkv, d]
with GQA, a per-key validity mask [B, S], optional causal masking with
offset S - T, masked scores -1e30 and an fp32 softmax. One CUDA kernel
serves both call sites.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from audio_calm_torch.ops import cuda_build

NEG = -1e30
_KERNEL_HEAD_DIMS = (32, 64, 96, 128)
_KERNEL_MAX_LEN = 512  # the JAX gate attention_available


def _mask(key_valid, B, T, S, causal, device):
    if key_valid is None:
        mask = torch.ones(B, 1, 1, S, dtype=torch.bool, device=device)
    else:
        mask = key_valid.bool()[:, None, None, :]
    if causal:
        row = torch.arange(T, device=device)[:, None]
        col = torch.arange(S, device=device)[None, :]
        mask = mask & (col <= row + (S - T))
    return mask


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: Optional[torch.Tensor] = None,
                        causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of `attention_fwd` (same signature).
    Returns [B, T, Hq, d] in q's dtype. The probabilities are rounded to
    v's dtype before P @ V, as the Pallas kernel does."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), kf) / math.sqrt(d)
    scores = scores.masked_fill(~_mask(key_valid, B, T, S, causal, q.device),
                                NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    return torch.einsum("bhts,bshd->bthd", probs, vf).to(q.dtype)


def _attn_lib() -> ctypes.CDLL:
    lib = cuda_build.load("attention_fwd")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.attention_fwd.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, P]
        lib.attention_fwd.restype = I
        lib._argtypes_set = True
    return lib


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_valid: Optional[torch.Tensor] = None,
                  causal: bool = False) -> torch.Tensor:
    """Fused SDPA: q [B, T, Hq, d], k/v [B, S, Hkv, d], key_valid [B, S]
    (nonzero = valid key). CPU tensors take the plain version; CUDA
    tensors launch csrc/attention_fwd.cu."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, key_valid, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, S, Hkv, d) or v.shape != k.shape or Hq % Hkv
            or k.device != q.device or v.device != q.device):
        raise ValueError("attention_fwd: q [B,T,Hq,d], k/v [B,S,Hkv,d] with "
                         f"Hkv | Hq on one device; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"attention_fwd takes float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _KERNEL_HEAD_DIMS or T > _KERNEL_MAX_LEN or S > _KERNEL_MAX_LEN:
        raise ValueError(f"attention_fwd kernel takes d in {_KERNEL_HEAD_DIMS} "
                         f"and T, S <= {_KERNEL_MAX_LEN}; got d={d}, T={T}, "
                         f"S={S}")
    if key_valid is None:
        valid = torch.ones(B, S, dtype=torch.uint8, device=q.device)
    else:
        if tuple(key_valid.shape) != (B, S) or key_valid.device != q.device:
            raise ValueError("attention_fwd: key_valid must be [B, S] on q's "
                             "device")
        # the kernel reads bytes and tests them != 0: a bool or uint8 mask
        # is passed as it is, anything else is converted
        if key_valid.dtype == torch.bool:
            valid = key_valid.contiguous().view(torch.uint8)
        elif key_valid.dtype == torch.uint8:
            valid = key_valid.contiguous()
        else:
            valid = (key_valid != 0).to(torch.uint8).contiguous()
    # the bf16 path reads rows with 16-byte loads: a contiguous view that
    # starts off a 16-byte boundary is copied
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _attn_lib()
    status = lib.attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), B, T, S, Hq, Hkv, d,
        int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, status, "attention_fwd")
    attention_fwd.launches += 1
    return out


attention_fwd.launches = 0

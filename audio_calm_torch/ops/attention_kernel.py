"""Fused attention: csrc/attention_fwd.cu, csrc/attention_bwd.cu and their
plain versions.

Forward: counterpart of the Pallas kernels `fused_attention` (K3) and
`fused_attention_batched` (K4) in audio_calm_tpu/ops/pallas_attention.py,
which compute one function: SDPA over q [B, T, Hq, d], k/v [B, S, Hkv, d]
with GQA, a per-key validity mask [B, S], optional causal masking with
offset S - T, masked scores -1e30 and an fp32 softmax. One CUDA kernel
serves both call sites.

Backward: counterpart of `_flash_bwd_kernel` (K5), the backward of JAX
`flash_attention`. `flash_attention` here is the differentiable route: a
`torch.autograd.Function` whose forward is `attention_fwd` and whose
backward is `attention_bwd`. `attention_fwd` itself returns a tensor with
no gradient on the card, so it refuses inputs that require one.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from audio_calm_torch.ops import cuda_build

NEG = -1e30
_KERNEL_HEAD_DIMS = (32, 48, 64, 96, 128)
_KERNEL_MAX_LEN = 512  # the JAX gate attention_available
_FLASH = "audio_calm_torch.ops.attention_kernel.flash_attention"


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


def _valid_bytes(key_valid, B, S, device) -> torch.Tensor:
    """key_valid -> a contiguous uint8 [B, S] mask the kernels read as
    bytes (nonzero = valid): bool and uint8 pass as they are."""
    if key_valid is None:
        return torch.ones(B, S, dtype=torch.uint8, device=device)
    if tuple(key_valid.shape) != (B, S) or key_valid.device != device:
        raise ValueError("attention: key_valid must be [B, S] on q's device")
    if key_valid.dtype == torch.bool:
        return key_valid.contiguous().view(torch.uint8)
    if key_valid.dtype == torch.uint8:
        return key_valid.contiguous()
    return (key_valid != 0).to(torch.uint8).contiguous()


def _check_qkv(name, q, k, v) -> None:
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, S, Hkv, d) or v.shape != k.shape or Hq % Hkv
            or k.device != q.device or v.device != q.device):
        raise ValueError(f"{name}: q [B,T,Hq,d], k/v [B,S,Hkv,d] with "
                         f"Hkv | Hq on one device; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name} takes float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _KERNEL_HEAD_DIMS or T > _KERNEL_MAX_LEN or S > _KERNEL_MAX_LEN:
        raise ValueError(f"{name} kernel takes d in {_KERNEL_HEAD_DIMS} "
                         f"and T, S <= {_KERNEL_MAX_LEN}; got d={d}, T={T}, "
                         f"S={S}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, and copied when a contiguous view starts off a 16-byte
    boundary (both kernels' bf16 paths copy rows in 16-byte pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format)


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
    cuda_build.refuse_autograd("attention_fwd", (q, k, v), _FLASH)
    _check_qkv("attention_fwd", q, k, v)
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    valid = _valid_bytes(key_valid, B, S, q.device)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
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


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        key_valid: Optional[torch.Tensor] = None,
                        causal: bool = False):
    """Plain PyTorch version of `attention_bwd` (same signature), the math
    of the Pallas `_flash_bwd_kernel` step by step, all in fp32: P is
    recomputed from q and k, dV = P^T dO, dP = dO V^T, delta =
    rowsum(dO * O), dS = P * (dP - delta), dQ = dS K * s, dK = dS^T Q * s;
    GQA heads of one kv head sum into its dK and dV. Returns (dq, dk, dv)
    in the dtypes of q, k and v."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(d)
    qf, of, gf = q.float(), out.float(), dout.float()
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    scores = scores.masked_fill(~_mask(key_valid, B, T, S, causal, q.device),
                                NEG)
    p = torch.softmax(scores, dim=-1)
    dv = torch.einsum("bhts,bthd->bshd", p, gf)
    dp = torch.einsum("bthd,bshd->bhts", gf, vf)
    delta = (gf * of).sum(dim=-1).transpose(1, 2)[..., None]  # [B, Hq, T, 1]
    ds = p * (dp - delta)
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, qf) * scale

    def per_kv_head(x):
        return x.reshape(B, S, Hkv, group, d).sum(dim=3)

    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load("attention_bwd")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.attention_bwd.argtypes = [P] * 10 + [I] * 8 + [P]
        lib.attention_bwd.restype = I
        lib._argtypes_set = True
    return lib


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, dout: torch.Tensor,
                  key_valid: Optional[torch.Tensor] = None,
                  causal: bool = False):
    """Gradients of `attention_fwd` -> (dq, dk, dv), given its inputs, its
    output and the output's gradient. CPU tensors take the plain version;
    CUDA tensors launch csrc/attention_bwd.cu."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, dout, key_valid, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd: unsupported device {q.device}")
    cuda_build.refuse_autograd("attention_bwd", (q, k, v, out, dout),
                               _FLASH)
    _check_qkv("attention_bwd", q, k, v)
    if (out.shape != q.shape or dout.shape != q.shape
            or out.dtype != q.dtype or out.device != q.device
            or dout.device != q.device):
        raise ValueError("attention_bwd: out and dout must be like q")
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    valid = _valid_bytes(key_valid, B, S, q.device)
    q, k, v, out = (_aligned(t) for t in (q, k, v, out))
    dout = _aligned(dout.to(q.dtype))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per query row: the softmax max, 1 / sum and delta = rowsum(dO * O)
    stats = torch.empty(B, Hq, T, 4, dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    status = lib.attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), valid.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), int(q.dtype == torch.bfloat16),
        B, T, S, Hq, Hkv, d, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, status, "attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, causal):
        out = attention_fwd(q, k, v, key_valid, causal)
        ctx.save_for_backward(q, k, v, out, key_valid)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, key_valid = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, dout, key_valid, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Differentiable fused attention (counterpart of JAX
    `flash_attention`): the forward is `attention_fwd` (K4 on the card),
    the backward `attention_bwd` (K5). Same [B, T, H, d] layout, GQA,
    key_valid and causal semantics as `attention_fwd`."""
    return _FlashAttention.apply(q, k, v, key_valid, causal)

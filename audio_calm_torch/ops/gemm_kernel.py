"""A batch-invariant bf16 matrix product (csrc/gemm.cu) and its plain
version, for the served engine's projections.

Replaces no TPU kernel: the JAX package leaves these products to XLA. The
served product needs a row of a batch to equal the same request served
alone (the contracts of tests/test_serve.py::
test_tts_concurrent_requests_batch_safely and tests/test_serving_batch.py::
test_asr_batch_matches_solo_rows). cuBLAS picks its kernel by the row count
M, so on the card a batched row summed its products in another order than
a solo one. Here every choice that orders a row's sums depends on N, K and
the dtype only: one tile shape and K cut into `split_count(N, K)` chunks,
each summed from zero, added in chunk order. Whether the chunks run in
blocks of their own or one after another in one block (`spread`) depends
on M and changes no bit.

`linear(x, w, bias, kn=False)`: x [..., K] and w [N, K] (a Linear's weight;
`kn=True`: w [K, N], LoRA's A and B) -> [..., N] = x w^T + bias (or x w),
fp32 sums, the bias added in fp32, one rounding to x's dtype. CPU tensors
take `linear_plain`; CUDA tensors launch the kernel (bf16 only) or raise.
`linear_plain` keeps the property on the CPU: it multiplies in fp32 over
fixed blocks of PLAIN_ROWS rows (zero-padded), so every row goes through a
product of one shape whatever M is.

Training keeps cuBLAS: no contract asks a training step to be batch
invariant. models/layers.batch_invariant_ turns this route on for a served
model's projections (serving/server.make_engine, bf16 models).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from audio_calm_torch.ops import cuda_build

BM, BN, BK = 64, 128, 32  # csrc/gemm.cu's tile (checked against the library)
_MIN_SPLIT_TILES = 4  # K tiles of 32 a split takes at least
_MAX_SPLITS = 16
_TARGET_BLOCKS = 64  # column tiles x splits a row tile should reach
PLAIN_ROWS = 64


def split_count(N: int, K: int) -> int:
    """The kernel's K split for an [N, K] weight, from N and K alone: enough
    splits that a row tile has about _TARGET_BLOCKS blocks (a small M then
    still streams the weight on many SMs), each split at least
    _MIN_SPLIT_TILES tiles of K, at most _MAX_SPLITS."""
    n_tiles = -(-N // BN)
    k_tiles = -(-K // BK)
    want = -(-_TARGET_BLOCKS // n_tiles)
    return max(1, min(want, _MAX_SPLITS, k_tiles // _MIN_SPLIT_TILES))


def spread(M: int, N: int, K: int, splits: int, sms: int) -> bool:
    """Whether the K chunks run in blocks of their own (their fp32 partial
    sums through device memory, added by a second kernel) rather than one
    after another in one block: where the grid of tiles is smaller than
    the card's `sms` SMs and the partials (8 M N splits bytes, written and
    read) move at most four times the weight's 2 N K. Bit-neutral: a
    function of M."""
    return (splits > 1 and -(-M // BM) * -(-N // BN) < sms
            and M * splits <= K)


def linear_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 kn: bool = False) -> torch.Tensor:
    """Plain PyTorch version of `linear` (same signature): fp32 products
    over blocks of PLAIN_ROWS rows, the bias added in fp32, rounded to x's
    dtype. A row's result does not depend on M or on the other rows."""
    K = x.shape[-1]
    wt = (w.float() if kn else w.float().t()).contiguous()  # [K, N]
    x2 = x.reshape(-1, K).float()
    M = x2.shape[0]
    Mp = -(-max(M, 1) // PLAIN_ROWS) * PLAIN_ROWS
    xp = torch.zeros(Mp, K, dtype=torch.float32, device=x.device)
    xp[:M] = x2
    y = torch.cat([xp[i:i + PLAIN_ROWS] @ wt
                   for i in range(0, Mp, PLAIN_ROWS)])[:M]
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], wt.shape[1])


def _gemm_lib() -> ctypes.CDLL:
    lib = cuda_build.load("gemm")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gemm_bf16.argtypes = [P] * 5 + [I] * 6 + [P]
        lib.gemm_bf16.restype = I
        lib.gemm_limits.argtypes = [P]
        lib.gemm_limits.restype = None
        got = (ctypes.c_int * 3)()
        lib.gemm_limits(got)
        if tuple(got) != (BM, BN, BK):
            raise RuntimeError(f"csrc/gemm.cu tiles {tuple(got)}, the "
                               f"wrapper plans with {(BM, BN, BK)}")
        lib._argtypes_set = True
    return lib


def _check(x, w, bias, kn) -> None:
    K = x.shape[-1]
    N = w.shape[1] if kn else w.shape[0]
    if w.dim() != 2 or (w.shape[0] if kn else w.shape[1]) != K:
        raise ValueError(f"gemm: x [..., {K}] against w {tuple(w.shape)} "
                         f"({'[K, N]' if kn else '[N, K]'})")
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"gemm: bias must be [{N}], got {tuple(bias.shape)}")
    if any(t is not None and t.device != x.device for t in (w, bias)):
        raise ValueError("gemm: x, w and bias must share a device")
    if x.device.type == "cuda":
        if any(t is not None and t.dtype != torch.bfloat16
               for t in (x, w, bias)):
            raise TypeError("gemm kernel takes bfloat16 x, w and bias")
        if K % 8 or (kn and N % 8):
            raise ValueError(f"gemm kernel needs K % 8 == 0 (and N % 8 == 0 "
                             f"for w [K, N]); got K={K}, N={N}")


def linear(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           kn: bool = False) -> torch.Tensor:
    """x w^T + bias (kn: x w + bias), batch invariant. CPU tensors take the
    plain version; CUDA tensors launch csrc/gemm.cu."""
    _check(x, w, bias, kn)
    if x.device.type == "cpu":
        return linear_plain(x, w, bias, kn)
    if x.device.type != "cuda":
        raise ValueError(f"gemm: unsupported device {x.device}")
    cuda_build.refuse_autograd("gemm", (x, w, bias))
    K = x.shape[-1]
    N = w.shape[1] if kn else w.shape[0]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    out = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    x2, w = x2.contiguous(), w.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    if w.data_ptr() % 16:
        w = w.clone()
    b = None if bias is None else bias.contiguous()
    splits = split_count(N, K)
    spread_ = spread(M, N, K, splits, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    work = (torch.empty(splits, M, N, dtype=torch.float32, device=x.device)
            if spread_ else None)
    lib = _gemm_lib()
    status = lib.gemm_bf16(
        x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), None if work is None else work.data_ptr(),
        M, N, K, int(not kn), splits, int(spread_),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, status, "gemm")
    linear.launches += 1
    return out


linear.launches = 0

"""A batch-invariant bf16 matrix product (csrc/gemm.cu) and its plain
version, for the served engine's projections.

Replaces no TPU kernel: the JAX package leaves these products to XLA. The
served product needs a row of a batch to equal the same request served
alone (the contracts of tests/test_serve.py::
test_tts_concurrent_requests_batch_safely and tests/test_serving_batch.py::
test_asr_batch_matches_solo_rows). cuBLAS picks its kernel by the row count
M, so on the card a batched row summed its products in another order than
a solo one. Here every choice that orders a row's sums depends on N, K and
the dtype only (`gemm_plan`): the tile's width (`tile_n`) and K cut into
chunks of `chunk_steps(N, K)` k16 steps, each summed from zero, added in
chunk order. What follows M changes no bit: how many row tiles there are,
how many warpgroups (64 rows each) a block holds, and whether the chunks
run in blocks of their own or one after another in one block (`spread`).

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
from typing import List, NamedTuple, Optional, Tuple

import torch

from audio_calm_torch.ops import cuda_build

BK, KSTEP = 64, 16  # csrc/gemm.cu's K tile and k step (checked against it)
SMS = 132  # the H100's SMs: the card the chunks are counted for
# row tiles of 64 whose spread chunks make SMS blocks: the chunk count's
# target (8 beat 1, 2 and 4 at the served rows: PERF.md section 6)
_FILL_ROW_TILES = 8
_MAX_CHUNK_STEPS = 96  # k16 steps a chunk holds at most: 1536 columns of K
_WIDE_N = 768  # N above which a tile is 128 columns wide, else 64
# the spread chunks' fp32 partial sums, written and read, move at most this
# many times the bytes of x and w the product reads anyway
_SPREAD_BYTES = 4
PLAIN_ROWS = 64


class GemmPlan(NamedTuple):
    """How csrc/gemm.cu runs one product. From (N, K): `bn`, the tile's
    columns; `chunk_steps`, the k16 steps of a K chunk; `splits`, the
    chunks. From M (bit-neutral): `nc`, the tile's warpgroups of 64 rows;
    `spread`, each chunk in a block of its own; `blocks`, the grid."""
    bn: int
    chunk_steps: int
    splits: int
    nc: int
    spread: bool
    blocks: int


def tile_n(N: int) -> int:
    """The tile's columns, from N alone: 64 up to _WIDE_N (LoRA's A, the
    k/v projections, calm.yaml's DiT: more column tiles at a few row
    tiles), else 128."""
    return 64 if N <= _WIDE_N else 128


def chunk_steps(N: int, K: int) -> int:
    """The k16 steps of a K chunk, from N and K alone: whole 64-column
    tiles, as even as they allow, enough chunks that _FILL_ROW_TILES row
    tiles spread make SMS blocks, and none longer than _MAX_CHUNK_STEPS
    (a long K, down_proj's 8960, spreads over more blocks at a small M,
    where its partial sums weigh little against its weight)."""
    ksteps = -(-K // KSTEP)
    want = max(-(-SMS // (_FILL_ROW_TILES * -(-N // tile_n(N)))),
               -(-ksteps // _MAX_CHUNK_STEPS))
    steps = -(-ksteps // want)
    steps = -(-steps // 4) * 4  # whole tiles
    while steps > 4 and -(-ksteps // steps) < want:
        steps -= 4
    return steps


def split_count(N: int, K: int) -> int:
    """The K chunks of an [N, K] weight, from N and K alone."""
    ksteps = -(-K // KSTEP)
    return -(-ksteps // chunk_steps(N, K))


def chunk_bounds(N: int, K: int) -> List[Tuple[int, int]]:
    """Each chunk's [k0, k1) in K, from N and K alone."""
    step = KSTEP * chunk_steps(N, K)
    return [(k, min(k + step, K)) for k in range(0, K, step)]


def candidate_plans(M: int, N: int, K: int) -> List[GemmPlan]:
    """Every plan the kernel takes for this product: one to three
    warpgroups a tile, the chunks spread or not; the arithmetic (bn,
    chunk_steps) is the same in all."""
    bn, steps, splits = tile_n(N), chunk_steps(N, K), split_count(N, K)
    plans = []
    for nc in (1, 2, 3):
        for spread in ((False, True) if splits > 1 else (False,)):
            tiles = -(-M // (64 * nc)) * -(-N // bn)
            plans.append(GemmPlan(bn, steps, splits, nc, spread,
                                  tiles * (splits if spread else 1)))
    return plans


def gemm_plan(M: int, N: int, K: int, sms: int = SMS) -> GemmPlan:
    """The plan for an [M, K] x [N, K] product, among candidate_plans. The
    chunks spread where the 64-row tiles leave SMs idle and their partial
    sums stay within _SPREAD_BYTES times x's and w's bytes. The warpgroups a
    tile: the fewest rounds of work an SM, reckoned as blocks over the
    card's slots (two blocks an SM of one warpgroup, else one) times the
    warpgroups a slot holds; of equals, two where M fills two tiles of 128
    rows and their grid half the card or more, else one (a small M then
    wastes no warpgroup on zero rows, and a small grid reaches more SMs).
    Chosen on the served rows' times at their M and at M = 50
    (tools/gemm_probe.py --plans [--m 50])."""
    plans = candidate_plans(M, N, K)
    one = plans[0]  # one warpgroup a tile, the chunks in one block
    spread = (one.splits > 1 and one.blocks < sms and 8 * M * N * one.splits
              <= _SPREAD_BYTES * 2 * (M + N) * K)
    by_nc = {p.nc: p for p in plans if p.spread == spread}

    def rounds(p):
        slots = sms * (2 if p.nc == 1 else 1)
        return -(-p.blocks // slots) * (2 if p.nc == 1 else p.nc)

    least = min(rounds(p) for p in by_nc.values())
    best = [nc for nc in (1, 2, 3) if rounds(by_nc[nc]) == least]
    if 2 in best and M >= 256 and by_nc[2].blocks >= sms // 2:
        return by_nc[2]
    return by_nc[best[0]]


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
        lib.gemm_bf16.argtypes = [P] * 5 + [I] * 8 + [P]
        lib.gemm_bf16.restype = I
        lib.gemm_limits.argtypes = [P]
        lib.gemm_limits.restype = None
        got = (ctypes.c_int * 2)()
        lib.gemm_limits(got)
        if tuple(got) != (BK, KSTEP):
            raise RuntimeError(f"csrc/gemm.cu tiles K by {tuple(got)}, the "
                               f"wrapper plans with {(BK, KSTEP)}")
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


def _sms(device: torch.device) -> int:
    """The card's SM count, read once a device (the wrapper is on every
    served projection)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


_SM_COUNT: dict = {}


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
    M = x.numel() // x.shape[-1] if x.shape[-1] else 0
    N = w.shape[1] if kn else w.shape[0]
    plan = gemm_plan(M, N, x.shape[-1], _sms(x.device)) if M else None
    return _linear(x, w, bias, kn, plan)


def _linear(x, w, bias, kn, plan: Optional[GemmPlan]) -> torch.Tensor:
    """The launch under `plan` (`linear`'s, or another of candidate_plans
    for a probe; the bits are the same under all)."""
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
    work = (torch.empty(plan.splits, M, N, dtype=torch.float32,
                        device=x.device) if plan.spread else None)
    lib = _gemm_lib()
    with torch.cuda.device(x.device):  # a shard's card need not be current
        status = lib.gemm_bf16(
            x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(),
            M, N, K, int(not kn), plan.bn, plan.nc, plan.chunk_steps,
            int(plan.spread), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, status, "gemm")
    linear.launches += 1
    return out


linear.launches = 0

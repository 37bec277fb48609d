"""Fused attention: csrc/attention_fwd.cu, csrc/attention_bwd.cu and their
plain versions.

Forward: counterpart of the Pallas kernels `fused_attention` (K3) and
`fused_attention_batched` (K4) in audio_calm_tpu/ops/pallas_attention.py,
which compute one function: SDPA over q [B, T, Hq, d], k/v [B, S, Hkv, d]
with GQA, a per-key validity mask [B, S], optional causal masking with
offset S - T, masked scores -1e30 and an fp32 softmax. One CUDA kernel
serves both call sites, at any T and S: in bf16 one warpgroup's wgmma
products over 64 query rows, K/V tiles copied in by TMA on a ring of
mbarriers, causal key tiles past the diagonal skipped; `attention_plan`
chooses from (T, S, Hq, Hkv, d, causal), never from the batch, whether the
GQA heads of a kv head share a tile and whether two warpgroups split a
tile's keys, so a batch row's output does not depend on its batch.

Backward: counterpart of `_flash_bwd_kernel` (K5), the backward of JAX
`flash_attention`. `flash_attention` here is the differentiable route: a
`torch.autograd.Function` whose forward is `attention_fwd` and whose
backward is `attention_bwd`. `attention_fwd` itself returns a tensor with
no gradient on the card, so it refuses inputs that require one. Neither
kernel has a length limit: K5 streams key and query tiles through its
rings and keeps one row statistic a query row, sized from T (the TPU's
512 gate was a limit of its VMEM, and JAX sends longer rows to XLA).

Head dims the kernels have no instantiation for (d <= 128 outside
_KERNEL_HEAD_DIMS: d = 24 in the end-to-end proof's Qwen2 and DiT; JAX
sends d % 32 != 0 to XLA attention) go through them zero-padded
(`padded_head_dim`): q, k and v get zero columns up to the next kernel
dim, q is scaled by sqrt(d_pad / d) so the kernel's 1 / sqrt(d_pad) scale
is the true 1 / sqrt(d), and the output and gradients are cut back to d.
The zero columns add nothing to q k^T, the padded v columns give output
columns that are cut, and the padded columns' gradients are cut the same
way (`_pad_head_dim`, held on the CPU with the plain versions).

FLOP counts (`counting_flops`, used by utils/profiling.count_flops): a
ctypes launch is invisible to torch's FlopCounterMode, so while a count is
taken each call adds its dense product count to a tally, and the plain
versions (the CPU route) run hidden from the counter: the count is the
same on both routes.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes

from audio_calm_torch.ops import cuda_build

NEG = -1e30
_KERNEL_HEAD_DIMS = (32, 48, 64, 96, 128)
_TILE_ROWS = 64  # query rows of a bf16 tile (one warpgroup product)
_KEY_TILE = 64  # keys of a streamed tile
# The plan's thresholds, chosen on an H100 (PERF.md section 6;
# audio_calm_torch/tools/attention_probe.py --plans times every plan):
_PACK_T = (128, 512)  # causal GQA rows packed for T in (lo, hi]
_SPLIT_MIN_WALK = 4  # key split only where a tile walks this many key tiles
_SPLIT_PROGRAMS = 32  # ... and a batch row has at most this many programs,
_SPLIT_PROGRAMS_CAUSAL = 192  # or this many where causal
_FLASH = "audio_calm_torch.ops.attention_kernel.flash_attention"


class FlopTally:
    """Dense product FLOPs of the attention calls made while a count is
    taken: 4 B Hq T S d a forward (Q K^T and P V), 10 B Hq T S d a backward
    (its five products, P recomputed), masked and causal-skipped work
    included, as a FLOP counter counts the plain versions' products."""
    active = False
    flops = 0.0


_TALLY = FlopTally()


@contextlib.contextmanager
def counting_flops():
    """Tally the attention calls' FLOPs for the block (yields the tally);
    their plain versions run with the torch dispatch modes (a
    FlopCounterMode) disabled."""
    _TALLY.active, _TALLY.flops = True, 0.0
    try:
        yield _TALLY
    finally:
        _TALLY.active = False


def _tally(q, k, products: int):
    """Add a call's products to the tally -> the context its plain version
    runs in."""
    if not _TALLY.active:
        return contextlib.nullcontext()
    B, T, Hq, d = q.shape
    _TALLY.flops += 2.0 * products * B * Hq * T * k.shape[1] * d
    return _disable_current_modes()


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
    """What both kernels take: shapes, dtypes, devices, head dims."""
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
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel takes d in {_KERNEL_HEAD_DIMS} "
                         f"(a smaller d zero-padded to one); got d={d}")


def padded_head_dim(d: int) -> int:
    """The kernel head dim a call at head dim d runs at: d itself, or the
    next kernel dim for a d <= 128 the kernels have no instantiation for."""
    if d in _KERNEL_HEAD_DIMS or d > _KERNEL_HEAD_DIMS[-1]:
        return d
    return next(k for k in _KERNEL_HEAD_DIMS if k >= d)


def _pad_head_dim(fn, q, k, v, *rest, grads: bool = False):
    """fn(q, k, v, *rest) at padded_head_dim(d): q, k, v (and for the
    backward, grads=True, its out and dout, the first two of `rest`) with
    zero columns up to d_pad, q scaled by sqrt(d_pad / d) so the kernel's
    1 / sqrt(d_pad) is 1 / sqrt(d); results cut back to d (dq scaled by the
    same factor: the kernel differentiates with respect to the scaled q)."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    if dp == d:
        return fn(q, k, v, *rest)
    c = math.sqrt(dp / d)

    def pad(t):
        return torch.nn.functional.pad(t, (0, dp - d))

    if grads:
        rest = (pad(rest[0]), pad(rest[1])) + tuple(rest[2:])
    res = fn(pad(q * c), pad(k), pad(v), *rest)
    if not grads:
        return res[..., :d].contiguous()
    dq, dk, dv = res
    return ((dq[..., :d] * c).contiguous(), dk[..., :d].contiguous(),
            dv[..., :d].contiguous())


def _check_bwd(q, k, v, out, dout) -> None:
    """attention_bwd's arguments: out and dout like q."""
    _check_qkv("attention_bwd", q, k, v)
    if (out.shape != q.shape or dout.shape != q.shape
            or out.dtype != q.dtype or out.device != q.device
            or dout.device != q.device):
        raise ValueError("attention_bwd: out and dout must be like q")


class AttentionPlan(NamedTuple):
    """How the bf16 kernel tiles one call. `group`: q heads a tile takes
    together (1, or Hq / Hkv with GQA rows packed); `positions`: query
    positions a tile (64 // group); `tiles`: query tiles per (head group,
    batch row); `consumers`: warpgroups splitting a tile's key tiles."""
    group: int
    positions: int
    tiles: int
    consumers: int


def _plan(T, Hq, Hkv, pack, consumers) -> AttentionPlan:
    group = Hq // Hkv if pack else 1
    positions = _TILE_ROWS // group
    return AttentionPlan(group, positions, -(-T // positions), consumers)


def attention_plan(T: int, S: int, Hq: int, Hkv: int, d: int,
                   causal: bool) -> AttentionPlan:
    """The bf16 kernel's plan for one call: a function of the shape and
    causality alone, never of the batch, so that a row of a batch gets
    the same tiles, the same key order and so the same bits as the row
    launched alone.

    Two consumer warpgroups split a tile's key tiles where the longest
    walk is long and a batch row has few programs (a short critical path
    beats a full SM there: the ASR query cross-attention, causal rows up
    to 1024); the causal tiles' imbalance widens that to more programs.
    GQA rows are packed for a causal encode of moderate length (the ASR
    encode, L = 461), where the finer position tiles walk fewer key tiles
    along the diagonal. At the short text encodes packing measured slower:
    a tile's latency is the same with 1 or 6 heads in its rows, and
    packing only cuts the number of blocks, which a B = 1 encode of 12-24
    blocks on 132 SMs does not miss."""
    walk = -(-S // _KEY_TILE)
    programs = -(-T // _TILE_ROWS) * Hq
    split = walk >= _SPLIT_MIN_WALK and (
        programs <= _SPLIT_PROGRAMS
        or causal and programs <= _SPLIT_PROGRAMS_CAUSAL)
    pack = Hq > Hkv and causal and _PACK_T[0] < T <= _PACK_T[1]
    return _plan(T, Hq, Hkv, pack, 2 if split else 1)


def plan_blocks(plan: AttentionPlan, Hq: int, B: int):
    """The bf16 kernel's grid under `plan`: for each block index, its
    (query tile, head group, batch row), the last (heaviest causal) query
    tiles first. The kernel decodes blockIdx.x so (attention_kernel in
    csrc/attention_fwd.cu)."""
    groups = Hq // plan.group
    return [(plan.tiles - 1 - bid // (groups * B), bid % groups,
             bid // groups % B) for bid in range(plan.tiles * groups * B)]


def plan_rows(plan: AttentionPlan, T: int, tile: int, group: int):
    """The (position, q head) rows of one block's tile, in row order."""
    t0 = tile * plan.positions
    return [(t, group * plan.group + h)
            for t in range(t0, min(T, t0 + plan.positions))
            for h in range(plan.group)]


def plan_key_tiles(plan: AttentionPlan, T: int, S: int, tile: int,
                   causal: bool, key_valid_row) -> int:
    """How many key tiles of 64 the block of query tile `tile` walks, as
    the kernel decides: causal tiles stop at the tile holding the last
    row's diagonal key, unless the tile's first row sees no valid key (the
    reference then averages all S keys: every tile)."""
    walk = -(-S // _KEY_TILE)
    if not causal:
        return walk
    t0 = tile * plan.positions
    t_last = min(T, t0 + plan.positions) - 1
    lim = min(S, t0 + S - T + 1)
    if not any(bool(key_valid_row[s]) for s in range(max(lim, 0))):
        return walk
    return min(walk, (t_last + S - T) // _KEY_TILE + 1)


def candidate_plans(T: int, S: int, Hq: int, Hkv: int, d: int,
                    causal: bool) -> List[AttentionPlan]:
    """Every plan the kernel takes at this shape (the probe times them)."""
    packs = (False, True) if Hq > Hkv and Hq // Hkv <= _TILE_ROWS else (False,)
    return [_plan(T, Hq, Hkv, pack, nc) for pack in packs for nc in (1, 2)]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, and copied when a contiguous view starts off a 16-byte
    boundary (the forward's tensor maps and the backward's 16-byte copies
    need 16-byte aligned rows)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format)


def _attn_lib() -> ctypes.CDLL:
    lib = cuda_build.load("attention_fwd")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.attention_fwd.argtypes = [P, P, P, P, P] + [I] * 10 + [P]
        lib.attention_fwd.restype = I
        lib._argtypes_set = True
    return lib


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_valid: Optional[torch.Tensor] = None,
                  causal: bool = False) -> torch.Tensor:
    """Fused SDPA: q [B, T, Hq, d], k/v [B, S, Hkv, d], key_valid [B, S]
    (nonzero = valid key), any T and S, d <= 128 (zero-padded to a kernel
    dim where the kernel has none). CPU tensors take the plain version;
    CUDA tensors launch csrc/attention_fwd.cu, bf16 under
    `attention_plan`."""
    return _attention_fwd(q, k, v, key_valid, causal, None)


def _attention_fwd(q, k, v, key_valid, causal,
                   plan: Optional[AttentionPlan]) -> torch.Tensor:
    """`attention_fwd` under `plan` (None: `attention_plan`'s); another
    plan only for measurements and tests (tools/attention_probe.py)."""
    hidden = _tally(q, k, 2)
    if q.device.type == "cpu":
        with hidden:
            return attention_fwd_plain(q, k, v, key_valid, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    cuda_build.refuse_autograd("attention_fwd", (q, k, v), _FLASH)
    return _pad_head_dim(_launch_fwd, q, k, v, key_valid, causal, plan)


def _launch_fwd(q, k, v, key_valid, causal, plan) -> torch.Tensor:
    """One launch of csrc/attention_fwd.cu at a kernel head dim."""
    _check_qkv("attention_fwd", q, k, v)  # any T and S
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if plan is None:
        plan = attention_plan(T, S, Hq, Hkv, d, causal)
    valid = _valid_bytes(key_valid, B, S, q.device)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lib = _attn_lib()
    status = lib.attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), B, T, S, Hq, Hkv, d,
        int(causal), int(plan.group > 1), plan.consumers,
        torch.cuda.current_stream(q.device).cuda_stream,
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
    hidden = _tally(q, k, 5)
    if q.device.type == "cpu":
        with hidden:
            return attention_bwd_plain(q, k, v, out, dout, key_valid, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd: unsupported device {q.device}")
    cuda_build.refuse_autograd("attention_bwd", (q, k, v, out, dout),
                               _FLASH)
    return _pad_head_dim(_launch_bwd, q, k, v, out, dout, key_valid, causal,
                         grads=True)


def _launch_bwd(q, k, v, out, dout, key_valid, causal):
    """One launch of csrc/attention_bwd.cu at a kernel head dim."""
    _check_bwd(q, k, v, out, dout)
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

"""HiFi-GAN vocoder kernels and the generator orchestration around them.

Counterpart of audio_calm_tpu/ops/pallas_vocoder.py:
  - `vocoder_stage` (Pallas `fused_upsample_stage`, K1): lrelu ->
    ConvTranspose1d(stride r) -> three MRF resblocks -> mean in one launch
    of csrc/vocoder_stage.cu; `ups_w=None` groups the resblocks + mean over
    an already-upsampled input. It takes every C <= 128 dividing 128, as
    the JAX kernel does: below 32 the channels are zero-padded to 32.
    `vocoder_stage_plain` is the same function in plain PyTorch.
  - `fused_resblock` (Pallas `fused_resblock`, K6): one MRF resblock,
    routed as JAX routes it: C < 128 dividing 128 -> `vocoder_stage` with
    one block; any other C up to 256 -> one launch of csrc/resblock.cu.
    `fused_resblock_plain` is the same function in plain PyTorch.
  - `hifigan_apply_fused` (the JAX orchestration, K2): conv_pre, the
    upsamples that stay plain convolutions, the C > 128 resblocks in plain
    PyTorch, the kernels where the JAX package routes to Pallas, and
    conv_post + tanh.

While a FLOP count is taken (utils/profiling.count_flops) both wrappers
add their plain version's products, worked out from the shapes
(`stage_flops`, `resblock_flops`), to the kernels' tally
(cuda_build.counting_flops) and run the plain version hidden from the
counter: a launch is invisible to it, and the count is the same on the
card and on the CPU.

Weights are passed in the JAX kernel layout, [k, C_in, C_out] per conv, so
the tests compare like with like. Operands are rounded to `compute_dtype`
and accumulated in fp32, as the TPU kernel feeds its MXU.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from audio_calm_torch.ops import cuda_build

Block = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int,
              Tuple[int, ...]]  # w1 [n_d,k,C,C], b1 [n_d,C], w2, b2, k, dils

_MAX_DIL = 4  # csrc/vocoder_stage.cu and csrc/resblock.cu kMaxDil
# resblocks above this width stay plain convolutions (as in JAX)
_KERNEL_MAX_CHANNELS = 128
# the stage kernel's smallest width; narrower stages are zero-padded to it
_STAGE_MIN_CHANNELS = 32
# csrc/resblock.cu: widest C, largest k
_RESBLOCK_MAX_CHANNELS = 256
_RESBLOCK_MAX_K = 11
_SMEM_BYTES = 227 * 1024  # shared memory one block may use on the H100


def lrelu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype`, back in fp32 (products of rounded operands are
    exact in fp32, so an fp32 conv over them is fp32 accumulation)."""
    return x.to(dtype).float()


def _conv_same(h, w, b, d: int, cdt):
    """'same' zero-padded dilated conv, h [B, T, C] fp32, w [k, Cin, Cout]."""
    c = (w.shape[0] - 1) // 2
    y = F.conv1d(_round(h, cdt).transpose(1, 2),
                 _round(w, cdt).permute(2, 1, 0), b.float(),
                 padding=c * d, dilation=d)
    return y.transpose(1, 2)


def vocoder_stage_plain(x: torch.Tensor, ups_w: Optional[torch.Tensor],
                        ups_b: Optional[torch.Tensor], blocks: Sequence[Block],
                        r: int = 2, slope: float = 0.1,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of `vocoder_stage` (same signature)."""
    cdt = compute_dtype
    xf = x.float()
    if ups_w is None:
        base = xf
    else:
        p = (ups_w.shape[0] - r) // 2
        base = F.conv_transpose1d(
            _round(lrelu(xf, slope), cdt).transpose(1, 2),
            _round(ups_w, cdt).permute(1, 2, 0), ups_b.float(),
            stride=r, padding=p,
        ).transpose(1, 2)
    acc = None
    for w1, b1, w2, b2, _k, dils in blocks:
        cur = base
        for i, d in enumerate(dils):
            h = _conv_same(lrelu(cur, slope), w1[i], b1[i], d, cdt)
            h = _conv_same(lrelu(h, slope), w2[i], b2[i], 1, cdt)
            cur = cur + h
        acc = cur if acc is None else acc + cur
    return (acc / len(blocks)).to(x.dtype)


def _pad_to(t: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """Zero-pad the trailing len(sizes) dims of t up to `sizes`."""
    pad: List[int] = []
    for have, want in zip(reversed(t.shape[-len(sizes):]), reversed(sizes)):
        pad += [0, want - have]
    return F.pad(t, pad) if any(pad) else t


def pad_stage(x, ups_w, ups_b, blocks: Sequence[Block], Cp: int):
    """A stage's arguments with C zero-padded to Cp (and C_in = 2C to 2Cp):
    zero channels with zero weights and biases stay zero through every conv
    (lrelu(0) = 0), so out[..., :C] of the padded stage is the stage."""
    C = blocks[0][0].shape[-1]
    cin_p = Cp if ups_w is None else (
        2 * Cp if x.shape[-1] == 2 * C else x.shape[-1])
    blocks_p = [(_pad_to(w1, (Cp, Cp)), _pad_to(b1, (Cp,)),
                 _pad_to(w2, (Cp, Cp)), _pad_to(b2, (Cp,)), k, dils)
                for w1, b1, w2, b2, k, dils in blocks]
    return (_pad_to(x, (cin_p,)),
            None if ups_w is None else _pad_to(ups_w, (cin_p, Cp)),
            None if ups_b is None else _pad_to(ups_b, (Cp,)), blocks_p)


# csrc/vocoder_stage.cu, bf16 path: window rows one pass of the warps'
# accumulators covers (Layout<C>::kRows), the mbarrier and counter header
# (kBarBytes), the ring's stage limit (kMaxStages), as the library reports
# them (`_stage_lib` checks); the fewest stages a plan keeps
_STAGE_PASS_ROWS = {32: 1152, 64: 512, 128: 256}
_STAGE_BAR_BYTES = 256
_STAGE_MAX_RING = 16
_STAGE_MIN_RING = 2


def _stage_lib(defines: Sequence[str] = ()) -> ctypes.CDLL:
    """csrc/vocoder_stage.cu's library (a probe variant with `defines`),
    its limits held against the copies `stage_plan` plans with."""
    lib = cuda_build.load("vocoder_stage", defines)
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.vocoder_stage.argtypes = [P, P, ctypes.c_longlong, P, P, P, I, I,
                                      I, I, I, I, I, I, I, P, P, P,
                                      ctypes.c_float, I, I, I, P]
        lib.vocoder_stage.restype = I
        lib.vocoder_stage_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.vocoder_stage_limits.restype = None
        limits = (ctypes.c_int * 5)()
        lib.vocoder_stage_limits(limits)
        ours = [_STAGE_PASS_ROWS[c] for c in (32, 64, 128)] + [
            _STAGE_BAR_BYTES, _STAGE_MAX_RING]
        if list(limits) != ours:
            raise RuntimeError("vocoder_stage: the library's plan limits "
                               f"{list(limits)} differ from the wrapper's "
                               f"{ours}")
        lib._argtypes_set = True
    return lib


class StagePlan(NamedTuple):
    """Launch shape of the bf16 stage kernel."""
    Lp: int          # window rows in shared memory (a multiple of 16 r)
    tile: int        # output rows a block: Lp - 2 halo
    halo: int        # rows each side: the widest resblock's, rounded to r
    stages: int      # weight ring stages of a k16 slice pair (64 C bytes)
    smem: int        # dynamic shared memory bytes
    grid: Tuple[int, int]  # (time tiles, batch rows)


def stage_halo(geom: Sequence[Tuple[int, Sequence[int]]], r: int) -> int:
    """The stage's halo: the widest resblock's (k, dilations) margin,
    rounded up to a multiple of r so the upsample's phases line up."""
    h = max(_halo(k, dils) for k, dils in geom)
    return -(-h // r) * r


def stage_plan(C: int, r: int, geom: Sequence[Tuple[int, Sequence[int]]],
               T_out: int, B: int = 1) -> StagePlan:
    """The bf16 kernel's tile plan at width C (32, 64 or 128) and upsample
    rate r (1: grouped): the window Lp is the most rows whose fp32 residual
    and bf16 operand ((C + 8) * 6 bytes a row) fit in 227 KB beside the
    mbarriers and a ring of at least 2 stages (a pair of weight slices
    each), capped at one pass of the warps' accumulators and, for a short
    T_out, at what the tile needs; the ring then takes the shared memory
    left, up to 16 stages. Raises ValueError when the halo leaves less
    than one m16 unit of tile."""
    unit = 16 * r
    row, slice_bytes = (C + 8) * 6, 64 * C
    halo = stage_halo(geom, r)
    room = _SMEM_BYTES - _STAGE_BAR_BYTES
    lp_max = min((room - _STAGE_MIN_RING * slice_bytes) // row,
                 _STAGE_PASS_ROWS[C]) // unit * unit
    Lp = min(lp_max, -(-(max(T_out, unit) + 2 * halo) // unit) * unit)
    if Lp - 2 * halo < unit:
        raise ValueError(f"vocoder_stage: a halo of {halo} rows leaves no "
                         f"tile in a {Lp}-row window at C={C}")
    stages = min(_STAGE_MAX_RING, (room - Lp * row) // slice_bytes)
    smem = _STAGE_BAR_BYTES + stages * slice_bytes + Lp * row
    tile = Lp - 2 * halo
    return StagePlan(Lp, tile, halo, stages, smem, (-(-T_out // tile), B))


def _smem_slices(w: torch.Tensor) -> torch.Tensor:
    """Conv weight [k, C_in, C_out] -> flat bf16: per tap and k16 slice the
    [16, C_out] image the stage kernel copies into shared memory as it is
    (csrc/vocoder_stage.cu `slice_chunk`). Element (j, ci, co) sits at
    ((j * C_in/16 + ci // 16) * 16 + kr) * C_out + pos * 8 + co % 8, with
    kr = ci % 16 and pos = co // 8 XOR (kr % 8 for C_out >= 64, (kr // 2) %
    4 for C_out = 32): the eight rows an ldmatrix.trans reads fall in eight
    distinct bank groups."""
    k, c_in, c_out = w.shape
    n_ch = c_out // 8
    kr = torch.arange(16, device=w.device)[:, None]
    swz = kr % 8 if c_out >= 64 else (kr // 2) % 4
    pos = torch.arange(n_ch, device=w.device)[None, :] ^ swz  # pos <-> ch
    w = w.to(torch.bfloat16).reshape(k, c_in // 16, 16, n_ch, 8)
    return w[:, :, kr, pos].reshape(-1)


def weight_stream(ups_w: Optional[torch.Tensor], blocks: Sequence[Block],
                  r: int) -> torch.Tensor:
    """The bf16 stage kernel's weights: every k16 slice image
    (`_smem_slices`) of one launch in the order its warps consume them
    (csrc/vocoder_stage.cu `Ring`): per resblock, the upsample's slices
    (per output phase ph, the kernel rows (ph + p) % r + r*i, i < k_up/r,
    p = (k_up - r) / 2; the upsample is recomputed per resblock, so its
    slices recur), then per dilation conv1's and conv2's."""
    ups: List[torch.Tensor] = []
    if ups_w is not None:
        k_up = ups_w.shape[0]
        p = (k_up - r) // 2
        rows = [(ph + p) % r + r * i for ph in range(r)
                for i in range(k_up // r)]
        ups = [_smem_slices(ups_w[rows])]
    parts: List[torch.Tensor] = []
    for w1, _, w2, _, _, _ in blocks:
        parts += ups
        # per dilation conv1's taps, then conv2's: one image for the block
        C = w1.shape[-1]
        parts.append(_smem_slices(torch.stack((w1, w2), dim=1)
                                  .reshape(-1, C, C)))
    return torch.cat(parts).contiguous()


def vocoder_stage(x: torch.Tensor, ups_w: Optional[torch.Tensor],
                  ups_b: Optional[torch.Tensor], blocks: Sequence[Block],
                  r: int = 2, slope: float = 0.1,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One HiFi-GAN stage: x [B, T_in, C_in] -> [B, T_in * r, C_out]
    (r treated as 1 when ups_w is None). CPU tensors take the plain
    version; CUDA tensors launch csrc/vocoder_stage.cu."""
    hidden = cuda_build.tally(stage_flops(x.shape, ups_w, blocks, r))
    if x.device.type == "cpu":
        with hidden:
            return vocoder_stage_plain(x, ups_w, ups_b, blocks, r, slope,
                                       compute_dtype)
    return _launch_stage(x, ups_w, ups_b, blocks, r, slope, compute_dtype)


def stage_flops(x_shape, ups_w: Optional[torch.Tensor],
                blocks: Sequence[Block], r: int = 2) -> float:
    """The products of one stage as a FLOP counter counts its plain
    version: the transposed conv 2 B T_in C_in C k_up, then two k-tap
    convs a dilation of each resblock, 2 B T C C k each, at T = T_in r."""
    B, T, C = x_shape
    flops = 0.0
    if ups_w is not None:
        k_up, C_in, C = ups_w.shape
        flops += 2.0 * B * T * C_in * C * k_up
        T *= r
    for block in blocks:
        flops += resblock_flops((B, T, C), block)
    return flops


def resblock_flops(x_shape, block: Block) -> float:
    """The products of one MRF resblock on x [B, T, C]: two k-tap convs a
    dilation, 2 B T C C k each."""
    B, T, C = x_shape
    w1 = block[0]
    return 2 * len(block[5]) * 2.0 * B * T * C * C * w1.shape[1]


def _launch_stage(x, ups_w, ups_b, blocks, r, slope, compute_dtype):
    """`vocoder_stage` on a CUDA tensor: one launch of
    csrc/vocoder_stage.cu."""
    if x.device.type != "cuda":
        raise ValueError(f"vocoder_stage: unsupported device {x.device}")
    cuda_build.refuse_autograd(
        "vocoder_stage", (x, ups_w, ups_b, *(w for b in blocks for w in b[:4])))
    ok_types = (torch.float32, torch.bfloat16)
    if x.dtype not in ok_types or compute_dtype not in ok_types:
        raise TypeError("vocoder_stage takes float32/bfloat16 activations "
                        f"and compute dtypes, got {x.dtype}/{compute_dtype}")
    B, T_in, C_in = x.shape
    if ups_w is None:
        C, k_up, r = C_in, 0, 1
    else:
        k_up, c_in_w, C = ups_w.shape
        if c_in_w != C_in or tuple(ups_b.shape) != (C,):
            raise ValueError("vocoder_stage: upsample weight/bias shapes do "
                             f"not match x: {tuple(ups_w.shape)}, "
                             f"{tuple(ups_b.shape)}, C_in={C_in}")
    if not 1 <= len(blocks) <= 4:
        raise ValueError("vocoder_stage takes 1 to 4 resblocks")
    if C < _STAGE_MIN_CHANNELS and 128 % C == 0:
        out = _launch_stage(*pad_stage(x, ups_w, ups_b, blocks,
                                       _STAGE_MIN_CHANNELS),
                            r, slope, compute_dtype)
        return out[..., :C]
    tensor_cores = compute_dtype == torch.bfloat16
    if tensor_cores and (C not in (32, 64, 128) or (ups_w is not None and (
            C_in != 2 * C or k_up % r or k_up < r))):
        raise ValueError("vocoder_stage with bf16 operands takes C <= 128 "
                         "dividing 128 and, with the upsample, C_in = 2C "
                         f"and r | k_up; got C={C}, C_in={C_in}, r={r}, "
                         f"k_up={k_up}")
    if not tensor_cores and (C % 4 or C > _KERNEL_MAX_CHANNELS or 8192 % C):
        raise ValueError(f"vocoder_stage with fp32 operands takes C <= 128 "
                         f"dividing 128, or a multiple of 4 dividing 8192, "
                         f"got C={C}")
    weights: List[torch.Tensor] = []
    biases: List[torch.Tensor] = []
    if ups_w is not None:
        weights.append(ups_w)
        biases.append(ups_b.reshape(-1))
    ksize, n_dil, dil = [], [], []
    for w1, b1, w2, b2, k, dils in blocks:
        n_d = len(dils)
        if (tuple(w1.shape) != (n_d, k, C, C) or w2.shape != w1.shape
                or tuple(b1.shape) != (n_d, C) or b2.shape != b1.shape
                or n_d > _MAX_DIL or k % 2 == 0):
            raise ValueError("vocoder_stage: resblock weights must be "
                             f"[n_d, k, C, C] with odd k, n_d <= {_MAX_DIL}")
        ksize.append(k)
        n_dil.append(n_d)
        dil.extend(list(dils) + [0] * (_MAX_DIL - n_d))
        for i in range(n_d):
            weights += [w1[i], w2[i]]
            biases += [b1[i], b2[i]]
    for t in weights + biases:
        if t.device != x.device:
            raise ValueError("vocoder_stage: weights must be on x's device")
    if tensor_cores:
        w = weight_stream(ups_w, blocks, r)
        plan = stage_plan(C, r, [(b[4], b[5]) for b in blocks], T_in * r, B)
    else:
        w = torch.cat([t.float().reshape(-1) for t in weights]).contiguous()
        plan = StagePlan(0, 0, 0, 0, 0, (0, 0))
    bias = torch.cat([t.float() for t in biases]).contiguous()
    x = x.contiguous()
    out = torch.empty(B, T_in * r, C, dtype=x.dtype, device=x.device)
    # the tensor-core path sums the resblocks in fp32 device memory: the
    # output itself when it is fp32, else this scratch
    acc = (torch.empty(out.shape, dtype=torch.float32, device=x.device)
           if tensor_cores and x.dtype != torch.float32 else None)
    ints = ctypes.c_int * len(ksize)
    lib = _stage_lib()
    with torch.cuda.device(x.device):  # x's card need not be current
        status = lib.vocoder_stage(
            x.data_ptr(), w.data_ptr(), w.numel(), bias.data_ptr(),
            out.data_ptr(), None if acc is None else acc.data_ptr(),
            int(x.dtype == torch.bfloat16), int(tensor_cores),
            B, T_in, C_in, C, r, k_up, len(blocks), ints(*ksize),
            ints(*n_dil), (ctypes.c_int * len(dil))(*dil), float(slope),
            plan.Lp, plan.tile, plan.stages,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_build.check(lib, status, "vocoder_stage")
    vocoder_stage.launches += 1
    return out


vocoder_stage.launches = 0


def fused_resblock_plain(x: torch.Tensor, block: Block, slope: float = 0.1,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of `fused_resblock` (same signature): the
    stage function with one block and no upsample."""
    return vocoder_stage_plain(x, None, None, [block], slope=slope,
                               compute_dtype=compute_dtype)


def _halo(k: int, dils: Sequence[int]) -> int:
    """Stacked receptive margin of the resblock's conv chain, each side."""
    c = (k - 1) // 2
    return sum(c * d + c for d in dils)


def _check_resblock(x: torch.Tensor, block: Block, compute_dtype) -> None:
    """Raise ValueError, naming the limit, outside csrc/resblock.cu's domain:
    1 <= C <= 256, odd k <= 11, 1 to 4 dilations >= 1, float32/bfloat16
    activations and compute dtypes, weights [n_d, k, C, C] on x's device."""
    w1, b1, w2, b2, k, dils = block
    ok_types = (torch.float32, torch.bfloat16)
    if x.dtype not in ok_types or compute_dtype not in ok_types:
        raise ValueError("fused_resblock takes float32/bfloat16 activations "
                         f"and compute dtypes, got {x.dtype}/{compute_dtype}")
    if x.ndim != 3 or not 1 <= x.shape[-1] <= _RESBLOCK_MAX_CHANNELS:
        raise ValueError("fused_resblock takes x [B, T, C] with 1 <= C <= "
                         f"{_RESBLOCK_MAX_CHANNELS}, got {tuple(x.shape)}")
    if k % 2 == 0 or not 1 <= k <= _RESBLOCK_MAX_K:
        raise ValueError(f"fused_resblock takes an odd k <= {_RESBLOCK_MAX_K}"
                         f", got k={k}")
    n_d = len(dils)
    if not 1 <= n_d <= _MAX_DIL or any(int(d) < 1 for d in dils):
        raise ValueError(f"fused_resblock takes 1 to {_MAX_DIL} dilations "
                         f">= 1, got {tuple(dils)}")
    C = x.shape[-1]
    if (tuple(w1.shape) != (n_d, k, C, C) or w2.shape != w1.shape
            or tuple(b1.shape) != (n_d, C) or b2.shape != b1.shape):
        raise ValueError("fused_resblock: weights must be [n_d, k, C, C] and "
                         f"biases [n_d, C] for C={C}, k={k}, n_d={n_d}")
    if any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("fused_resblock: weights must be on x's device")


def simt_plan(C: int, k: int, dils: Sequence[int],
              T: int) -> Tuple[int, int, int, bool]:
    """csrc/resblock.cu's fp32 launch shape -> (C_k, Lp, tile, scratch):
    C zero-padded to a multiple of 4, the window rows Lp = tile + 2H (the
    most that fit in shared memory, fewer for a short T), and whether the
    fp32 residual lives in a device-memory scratch (C_k > 64) rather than
    in shared memory. Raises ValueError when the halo leaves no tile."""
    C_k = -(-C // 4) * 4
    scratch = C_k > 64
    row = (C_k + 1) * 4 * (1 if scratch else 2)  # conv1's output (+ residual)
    H = _halo(k, dils)
    lp_max = _SMEM_BYTES // row
    if lp_max - 2 * H < 1:
        raise ValueError(_halo_error(C, k, dils, H, lp_max))
    Lp = min(lp_max, T + 2 * H)
    return C_k, Lp, Lp - 2 * H, scratch


def _halo_error(C, k, dils, H, lp_max) -> str:
    return (f"fused_resblock: the halo of k={k}, dilations={tuple(dils)} "
            f"(H={H}) leaves no tile in a window at C={C}: the window "
            f"holds {lp_max} rows, so H <= {(lp_max - 1) // 2}")


# csrc/resblock.cu, bf16 path (namespace tc `Width`): per kernel width W (C
# is zero-padded up to the next), (KP, NN, R): the operand channels (W
# rounded up to 16: the k padding, zero weight rows), the output channels
# one warpgroup product covers (W / NN passes over the weights a conv) and
# the 64-row groups a warpgroup owns, whose residual it keeps in registers
# (R * (W + NN) / 2 fp32 a thread). Then the warpgroups a block and the
# ring's stage limit. The library reports them and `_resblock_lib` holds
# them against these.
_RESBLOCK_WIDTHS = {16: (16, 16, 12), 24: (32, 24, 8), 32: (32, 32, 6),
                    48: (48, 48, 4), 64: (64, 64, 3), 96: (96, 96, 2),
                    128: (128, 64, 2), 192: (192, 96, 1), 256: (256, 64, 1)}
_RESBLOCK_CONSUMERS = 2
_RESBLOCK_MAX_RING = 8
_RESBLOCK_INFLIGHT = 1  # taps in flight a warp: the ring needs one more
_RESBLOCK_HEADER = 256  # mbarriers, release counters, 128-byte alignment


class ResblockPlan(NamedTuple):
    """Launch shape of the bf16 resblock kernel; a function of (C, k,
    dilations, T) alone, never of the batch."""
    width: int      # W: the kernel's channels, C zero-padded up to it
    kpad: int       # KP: operand channels, W rounded up to 16
    split: int      # NN: output channels a product covers (W / NN passes)
    groups: int     # 64-row groups a warpgroup owns at most
    consumers: int  # warpgroups a block
    Lp: int         # window rows, a multiple of 64
    tile: int       # output rows a block: Lp - 2 halo
    halo: int       # rows each side: the conv chain's receptive margin
    margin: int     # rows of 16 bytes either side of the operand buffers
    stages: int     # weight ring stages, one [KP, NN] tap image each
    smem: int       # dynamic shared memory bytes


def _plan_at(W: int, C: int, k: int, dils: Sequence[int], T: int,
             Lp: Optional[int] = None) -> ResblockPlan:
    KP, NN, R = _RESBLOCK_WIDTHS[W]
    H = _halo(k, dils)
    lp_max = 64 * _RESBLOCK_CONSUMERS * R
    if lp_max - 2 * H < 1:
        raise ValueError(_halo_error(C, k, dils, H, lp_max))
    if Lp is None:
        Lp = min(lp_max, -(-(T + 2 * H) // 64) * 64)
    margin = (k - 1) // 2 * max(dils)  # the widest tap shift
    # + two bf16 buffers of the widest window, whatever Lp (compile-time
    # offsets in the kernel)
    fixed = _RESBLOCK_HEADER + 32 * margin + 4 * lp_max * KP
    unit = 2 * KP * NN
    stages = min(_RESBLOCK_MAX_RING, (_SMEM_BYTES - fixed) // unit)
    return ResblockPlan(W, KP, NN, R, _RESBLOCK_CONSUMERS, Lp, Lp - 2 * H, H,
                        margin, stages, fixed + stages * unit)


def resblock_plan(C: int, k: int, dils: Sequence[int],
                  T: int) -> ResblockPlan:
    """The bf16 resblock kernel's plan at width C, kernel k, dilations
    `dils` and sequence length T: C zero-padded up to the next kernel
    width (unpadded at 16, 24, 32, 48, 64, 96, 128, 192, 256; the k side
    rounded up to 16), the largest window its warpgroups' registers hold
    (64 x consumers x groups rows), fewer for a short T, and as many ring
    stages as the shared memory left holds, up to 8. Raises ValueError
    when the halo leaves no tile."""
    W = next(w for w in _RESBLOCK_WIDTHS if w >= C)
    return _plan_at(W, C, k, dils, T)


def candidate_plans(C: int, k: int, dils: Sequence[int],
                    T: int) -> List[ResblockPlan]:
    """resblock_plan's choice first, then the windows one and two groups
    of 64 rows smaller and, at width 24 (N = 24 takes no swizzled layout),
    the width padded to 32 (tools/resblock_probe.py times them)."""
    best = resblock_plan(C, k, dils, T)
    plans = [best]
    for less in (64, 128):
        if best.Lp - less - 2 * best.halo >= 1:
            plans.append(_plan_at(best.width, C, k, dils, T, best.Lp - less))
    if best.width % 16:
        plans.append(resblock_plan(-(-best.width // 16) * 16, k, dils, T))
    return plans


def resblock_products(plan: ResblockPlan, C: int, k: int,
                      dils: Sequence[int]) -> Tuple[float, float]:
    """(executed, useful) multiply-adds of one block with a full tile,
    reckoned from the plan, not measured: executed over every 64-row group
    the warpgroups own (each issues its products for every conv: csrc/
    resblock.cu `conv`) at KP x W channels, useful 2 n_d tile k C^2."""
    rows = 64 * plan.consumers * plan.groups * 2 * len(dils)
    executed = float(rows) * k * plan.kpad * plan.width
    return executed, 2.0 * len(dils) * plan.tile * k * C * C


def resblock_stream(w1: torch.Tensor, w2: torch.Tensor,
                    plan: ResblockPlan) -> torch.Tensor:
    """The bf16 resblock kernel's weights, w1 and w2 [n_d, k, C, C] in the
    JAX kernel layout: one [KP, NN] image a (dilation, conv, pass, tap),
    in the order the kernel consumes them, zero-padded to [KP, W], each
    the shared-memory image its ring stage takes as it is: wgmma's
    no-swizzle MN-major layout of 8 x 8 core matrices (8 input channels x
    8 output channels, 128 contiguous bytes, output channels innermost),
    output-channel groups 128 bytes apart, input-channel groups 16 NN bytes
    apart. Element (ci, co) of a pass's image sits at (ci // 8) * 8 NN +
    (co // 8) * 64 + (ci % 8) * 8 + co % 8."""
    W, KP, NN = plan.width, plan.kpad, plan.split
    n_d, k = w1.shape[:2]
    w = _pad_to(torch.stack((w1, w2), dim=1).to(torch.bfloat16), (KP, W))
    w = w.reshape(n_d, 2, k, KP // 8, 8, W // NN, NN // 8, 8)
    # dims: dilation, conv, tap, ci // 8, ci % 8, pass, co // 8, co % 8
    return w.permute(0, 1, 5, 2, 3, 6, 4, 7).reshape(-1)


def _resblock_lib(defines: Sequence[str] = ()) -> ctypes.CDLL:
    """csrc/resblock.cu's library (a probe variant with `defines`), its
    plan limits held against the copies `resblock_plan` plans with."""
    lib = cuda_build.load("resblock", defines)
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_resblock.argtypes = [P, P, ctypes.c_longlong, P, P, P, I, I,
                                       I, I, I, I, I, P, ctypes.c_float, I,
                                       I, I, I, P]
        lib.fused_resblock.restype = I
        n = len(_RESBLOCK_WIDTHS)
        lib.resblock_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.resblock_limits.restype = None
        limits = (ctypes.c_int * (4 * n + 4))()
        lib.resblock_limits(limits)
        ours = [v for W, t in _RESBLOCK_WIDTHS.items() for v in (W, *t)] + [
            _RESBLOCK_CONSUMERS, _RESBLOCK_MAX_RING, _RESBLOCK_INFLIGHT,
            _RESBLOCK_HEADER]
        if list(limits) != ours:
            raise RuntimeError("fused_resblock: the library's plan limits "
                               f"{list(limits)} differ from the wrapper's "
                               f"{ours}")
        lib._argtypes_set = True
    return lib


def _resblock_call(x: torch.Tensor, block: Block, slope: float,
                   compute_dtype, plan: Optional[ResblockPlan] = None,
                   defines: Sequence[str] = ()):
    """Everything csrc/resblock.cu's C entry takes, laid out once -> (call,
    out): call() launches the kernel into out (the [B, T, C] result, a
    view when C was padded) and raises on an error. `plan` (bf16 only)
    replaces resblock_plan's and `defines` picks a probe build of the
    library (tools/resblock_probe.py)."""
    w1, b1, w2, b2, k, dils = block
    B, T, C = x.shape
    n_d = len(dils)
    if compute_dtype == torch.bfloat16:
        plan = plan or resblock_plan(C, k, dils, T)
        C_k, Lp, scratch = plan.width, plan.Lp, None
        w = resblock_stream(w1, w2, plan)
        kpad, split, stages = plan.kpad, plan.split, plan.stages
    else:
        C_k, Lp, tile, in_scratch = simt_plan(C, k, dils, T)
        w = _pad_to(torch.stack((w1, w2), dim=1).float(), (C_k, C_k))
        w = w.reshape(-1)
        scratch = (torch.empty(-(-T // tile) * B * Lp * C_k,
                               dtype=torch.float32, device=x.device)
                   if in_scratch else None)
        kpad = split = stages = 0
    # zero channels stay zero (zero weights and biases, lrelu(0) = 0):
    # exact, sliced off below
    x = _pad_to(x, (C_k,)).contiguous()
    bias = _pad_to(torch.stack((b1, b2), dim=1).float(), (C_k,)).reshape(-1)
    out = torch.empty(B, T, C_k, dtype=x.dtype, device=x.device)
    dil = (ctypes.c_int * n_d)(*[int(d) for d in dils])
    lib = _resblock_lib(defines)
    args = (x.data_ptr(), w.data_ptr(), w.numel(), bias.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            int(x.dtype == torch.bfloat16),
            int(compute_dtype == torch.bfloat16), B, T, C_k, k, n_d, dil,
            float(slope), Lp, kpad, split, stages,
            torch.cuda.current_stream(x.device).cuda_stream)
    keep = (x, w, bias, scratch)  # alive as long as the call is

    def call():
        with torch.cuda.device(x.device):  # x's card need not be current
            status = lib.fused_resblock(*args)
        cuda_build.check(lib, status, "fused_resblock")
        return keep

    return call, out[..., :C] if C_k > C else out


def fused_resblock(x: torch.Tensor, block: Block, slope: float = 0.1,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One MRF resblock (Pallas `fused_resblock`): x [B, T, C] -> per
    dilation d, x + conv_k,1(lrelu(conv_k,d(lrelu(x)))), in x's dtype.
    Routed as in JAX: C < 128 dividing 128 -> the stage kernel with this
    one block (K1); any other C -> csrc/resblock.cu (K6). CPU tensors take
    the plain version; on a CUDA tensor a kernel runs or the call raises."""
    hidden = cuda_build.tally(resblock_flops(x.shape, block))
    if x.device.type == "cpu":
        with hidden:
            return fused_resblock_plain(x, block, slope, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock: unsupported device {x.device}")
    C = x.shape[-1]
    if C < 128 and 128 % C == 0:
        return _launch_stage(x, None, None, [block], 1, slope, compute_dtype)
    cuda_build.refuse_autograd("fused_resblock", (x, *block[:4]))
    _check_resblock(x, block, compute_dtype)
    call, out = _resblock_call(x, block, slope, compute_dtype)
    call()
    fused_resblock.launches += 1
    return out


fused_resblock.launches = 0


def _conv1d(x, weight, bias, pad: int, dilation: int = 1):
    """Channels-last conv in x's dtype; torch weight [C_out, C_in, k]."""
    y = F.conv1d(x.transpose(1, 2), weight.to(x.dtype), bias.to(x.dtype),
                 padding=pad, dilation=dilation)
    return y.transpose(1, 2)


def _conv_transpose1d(x, weight, bias, stride: int, pad: int):
    """Channels-last transposed conv; torch weight [C_in, C_out, k]."""
    y = F.conv_transpose1d(x.transpose(1, 2), weight.to(x.dtype),
                           bias.to(x.dtype), stride=stride, padding=pad)
    return y.transpose(1, 2)


def _plain_resblock(x, rb, slope: float):
    """MRF resblock as plain convolutions (the JAX `_xla_resblock`)."""
    k = rb.kernel_size
    c = (k - 1) // 2
    for d, c1, c2 in zip(rb.dilations, rb.convs1, rb.convs2):
        h = _conv1d(lrelu(x, slope), c1.weight, c1.bias, pad=c * d,
                    dilation=d)
        h = _conv1d(lrelu(h, slope), c2.weight, c2.bias, pad=c)
        x = x + h
    return x


def stack_resblock(rb) -> Block:
    """A ResBlock1 module -> (w1, b1, w2, b2, k, dils) in the kernel layout."""
    w1 = torch.stack([c.weight.permute(2, 1, 0) for c in rb.convs1])
    b1 = torch.stack([c.bias for c in rb.convs1])
    w2 = torch.stack([c.weight.permute(2, 1, 0) for c in rb.convs2])
    b2 = torch.stack([c.bias for c in rb.convs2])
    return w1, b1, w2, b2, rb.kernel_size, tuple(rb.dilations)


def hifigan_apply_fused(gen, mel: torch.Tensor, compute_dtype=torch.bfloat16,
                        io_dtype=None) -> torch.Tensor:
    """Generator forward over a `HiFiGANGenerator`'s weights with the JAX
    package's routing (pallas_vocoder.hifigan_apply_fused): r=2 stages with
    C_in <= 128 dividing 128 -> the whole stage in `vocoder_stage`; other
    stages -> lrelu + transposed conv, then the grouped `vocoder_stage`
    when C_out <= 128 divides 128, else per-resblock plain convolutions
    (C > 128) or `fused_resblock`. Returns the waveform
    [B, T * total_upsample] in float32. io_dtype sets the inter-stage
    activation dtype (None follows mel)."""
    cfg = gen.cfg
    slope = cfg.lrelu_slope
    if io_dtype is not None:
        mel = mel.to(io_dtype)
    x = _conv1d(mel, gen.conv_pre.weight, gen.conv_pre.bias, pad=3)
    for i, (r, k_up) in enumerate(zip(cfg.upsample_rates,
                                      cfg.upsample_kernel_sizes)):
        C_in = x.shape[-1]
        C_out = C_in // 2
        up = gen.ups[i]
        blocks = [stack_resblock(rb) for rb in gen.resblocks[i]]
        if (r == 2 and k_up % r == 0 and (k_up - r) % 2 == 0
                and C_in <= _KERNEL_MAX_CHANNELS and 128 % C_in == 0):
            x = vocoder_stage(x, up.weight.permute(2, 0, 1), up.bias, blocks,
                              r=r, slope=slope, compute_dtype=compute_dtype)
            continue
        x = _conv_transpose1d(lrelu(x, slope), up.weight, up.bias, stride=r,
                              pad=(k_up - r) // 2)
        if C_out <= _KERNEL_MAX_CHANNELS and 128 % C_out == 0:
            x = vocoder_stage(x, None, None, blocks, slope=slope,
                              compute_dtype=compute_dtype)
            continue
        acc = None
        for rb, block in zip(gen.resblocks[i], blocks):
            if x.shape[-1] > _KERNEL_MAX_CHANNELS:
                h = _plain_resblock(x, rb, slope)
            else:
                h = fused_resblock(x, block, slope=slope,
                                   compute_dtype=compute_dtype)
            acc = h if acc is None else acc + h
        x = acc / len(blocks)
    x = _conv1d(lrelu(x, slope), gen.conv_post.weight, gen.conv_post.bias,
                pad=3)
    return torch.tanh(x.float())[..., 0]

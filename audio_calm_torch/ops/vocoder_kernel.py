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

Weights are passed in the JAX kernel layout, [k, C_in, C_out] per conv, so
the tests compare like with like. Operands are rounded to `compute_dtype`
and accumulated in fp32, as the TPU kernel feeds its MXU.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

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
# csrc/resblock.cu: widest C, largest k, tensor-core channel granules
_RESBLOCK_MAX_CHANNELS = 256
_RESBLOCK_MAX_K = 11
_RESBLOCK_GRANULES = (32, 64, 96, 128, 192, 256)
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


def _stage_lib() -> ctypes.CDLL:
    lib = cuda_build.load("vocoder_stage")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.vocoder_stage.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I,
                                      I, P, P, P, ctypes.c_float, P]
        lib.vocoder_stage.restype = I
        lib._argtypes_set = True
    return lib


def _mma_fragments(w: torch.Tensor) -> torch.Tensor:
    """Conv weight [k, C_in, C_out] -> flat bf16 in the order the tensor-core
    path reads it: per (tap, 16-row k slice, 32-channel group, half) the 32
    lanes' mma.m16n8k16 B fragments, 4 words a lane (n8 tiles 2*half and
    2*half+1, registers b0 and b1 each), a word holding the bf16 pair
    (k, k+1). Lane 4n+q of register b_i holds B[k = 8i + 2q + e][n]."""
    k, c_in, c_out = w.shape
    w = w.to(torch.bfloat16).reshape(k, c_in // 16, 2, 4, 2, c_out // 32, 2,
                                     2, 8)
    # dims: tap, kk, b_i, q, e, group, half, tile-in-half, n
    return w.permute(0, 1, 5, 6, 8, 3, 7, 2, 4).reshape(-1)


def vocoder_stage(x: torch.Tensor, ups_w: Optional[torch.Tensor],
                  ups_b: Optional[torch.Tensor], blocks: Sequence[Block],
                  r: int = 2, slope: float = 0.1,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One HiFi-GAN stage: x [B, T_in, C_in] -> [B, T_in * r, C_out]
    (r treated as 1 when ups_w is None). CPU tensors take the plain
    version; CUDA tensors launch csrc/vocoder_stage.cu."""
    if x.device.type == "cpu":
        return vocoder_stage_plain(x, ups_w, ups_b, blocks, r, slope,
                                   compute_dtype)
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
        out = vocoder_stage(*pad_stage(x, ups_w, ups_b, blocks,
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
    layout = _mma_fragments if tensor_cores else (
        lambda t: t.float().reshape(-1))
    w = torch.cat([layout(t) for t in weights]).contiguous()
    bias = torch.cat([t.float() for t in biases]).contiguous()
    x = x.contiguous()
    out = torch.empty(B, T_in * r, C, dtype=x.dtype, device=x.device)
    # the tensor-core path sums the resblocks in fp32 device memory: the
    # output itself when it is fp32, else this scratch
    acc = (torch.empty(out.shape, dtype=torch.float32, device=x.device)
           if tensor_cores and x.dtype != torch.float32 else None)
    ints = ctypes.c_int * len(ksize)
    lib = _stage_lib()
    status = lib.vocoder_stage(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        None if acc is None else acc.data_ptr(),
        int(x.dtype == torch.bfloat16), int(tensor_cores),
        B, T_in, C_in, C, r, k_up, len(blocks), ints(*ksize), ints(*n_dil),
        (ctypes.c_int * len(dil))(*dil), float(slope),
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


def _resblock_plan(C: int, k: int, dils: Sequence[int], T: int,
                   tensor_cores: bool) -> Tuple[int, int, int, bool]:
    """csrc/resblock.cu's launch shape -> (C_k, Lp, tile, scratch): the
    kernel's channel count (C zero-padded to a granule: a width of 32
    channel groups for the tensor cores, a multiple of 4 on the CUDA cores),
    the window rows Lp = tile + 2H (the most that fit in shared memory,
    fewer for a short T; a multiple of 16 for the tensor cores), and whether
    the fp32 residual lives in a device-memory scratch (C_k > 64) rather
    than in shared memory. Raises ValueError when the halo leaves no tile."""
    if tensor_cores:
        C_k = next(g for g in _RESBLOCK_GRANULES if g >= C)
    else:
        C_k = -(-C // 4) * 4
    scratch = C_k > 64
    if tensor_cores:  # two bf16 operand buffers (+ the fp32 residual)
        row, unit = (C_k + 8) * 4 * (1 if scratch else 2), 16
    else:  # conv1's fp32 output (+ the fp32 residual)
        row, unit = (C_k + 1) * 4 * (1 if scratch else 2), 1
    H = _halo(k, dils)
    lp_max = _SMEM_BYTES // row // unit * unit
    if lp_max - 2 * H < 1:
        raise ValueError(
            f"fused_resblock: the halo of k={k}, dilations={tuple(dils)} "
            f"(H={H}) leaves no tile in shared memory at C={C}: the window "
            f"holds {lp_max} rows, so H <= {(lp_max - 1) // 2}")
    Lp = min(lp_max, -(-(T + 2 * H) // unit) * unit)
    return C_k, Lp, Lp - 2 * H, scratch


def _resblock_lib() -> ctypes.CDLL:
    lib = cuda_build.load("resblock")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_resblock.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P,
                                       ctypes.c_float, I, P]
        lib.fused_resblock.restype = I
        lib._argtypes_set = True
    return lib


def fused_resblock(x: torch.Tensor, block: Block, slope: float = 0.1,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One MRF resblock (Pallas `fused_resblock`): x [B, T, C] -> per
    dilation d, x + conv_k,1(lrelu(conv_k,d(lrelu(x)))), in x's dtype.
    Routed as in JAX: C < 128 dividing 128 -> the stage kernel with this
    one block (K1); any other C -> csrc/resblock.cu (K6). CPU tensors take
    the plain version; on a CUDA tensor a kernel runs or the call raises."""
    if x.device.type == "cpu":
        return fused_resblock_plain(x, block, slope, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock: unsupported device {x.device}")
    C = x.shape[-1]
    if C < 128 and 128 % C == 0:
        return vocoder_stage(x, None, None, [block], slope=slope,
                             compute_dtype=compute_dtype)
    cuda_build.refuse_autograd("fused_resblock", (x, *block[:4]))
    _check_resblock(x, block, compute_dtype)
    w1, b1, w2, b2, k, dils = block
    B, T, _ = x.shape
    tensor_cores = compute_dtype == torch.bfloat16
    C_k, Lp, tile, in_scratch = _resblock_plan(C, k, dils, T, tensor_cores)
    if C_k > C:  # zero channels stay zero: exact, sliced off below
        x = _pad_to(x, (C_k,))
        w1, w2 = _pad_to(w1, (C_k, C_k)), _pad_to(w2, (C_k, C_k))
        b1, b2 = _pad_to(b1, (C_k,)), _pad_to(b2, (C_k,))
    layout = _mma_fragments if tensor_cores else (
        lambda t: t.float().reshape(-1))
    n_d = len(dils)
    w = torch.cat([layout(t) for i in range(n_d) for t in (w1[i], w2[i])])
    bias = torch.cat([t.float() for i in range(n_d) for t in (b1[i], b2[i])])
    x = x.contiguous()
    out = torch.empty(B, T, C_k, dtype=x.dtype, device=x.device)
    scratch = (torch.empty(-(-T // tile) * B * Lp * C_k, dtype=torch.float32,
                           device=x.device) if in_scratch else None)
    lib = _resblock_lib()
    status = lib.fused_resblock(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        int(x.dtype == torch.bfloat16), int(tensor_cores), B, T, C_k, k, n_d,
        (ctypes.c_int * n_d)(*[int(d) for d in dils]), float(slope), Lp,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(lib, status, "fused_resblock")
    fused_resblock.launches += 1
    return out[..., :C] if C_k > C else out


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

"""HiFi-GAN stage kernel and the generator orchestration around it.

Counterpart of audio_calm_tpu/ops/pallas_vocoder.py:
  - `vocoder_stage` (Pallas `fused_upsample_stage`, K1): lrelu ->
    ConvTranspose1d(stride r) -> three MRF resblocks -> mean in one launch
    of csrc/vocoder_stage.cu; `ups_w=None` groups the resblocks + mean over
    an already-upsampled input. `vocoder_stage_plain` is the same function
    in plain PyTorch.
  - `hifigan_apply_fused` (the JAX orchestration, K2): conv_pre, the
    upsamples that stay plain convolutions, the C=256 resblocks in plain
    PyTorch, the stage kernel where the JAX package routes to Pallas, and
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

_MAX_DIL = 4  # csrc/vocoder_stage.cu kMaxDil
# resblocks at or above this width stay plain convolutions (as in JAX)
_KERNEL_MAX_CHANNELS = 128


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
    tensor_cores = compute_dtype == torch.bfloat16
    if tensor_cores and (C not in (32, 64, 128) or (ups_w is not None and (
            C_in != 2 * C or k_up % r or k_up < r))):
        raise ValueError("vocoder_stage with bf16 operands takes C in "
                         "(32, 64, 128) and, with the upsample, C_in = 2C "
                         f"and r | k_up; got C={C}, C_in={C_in}, r={r}, "
                         f"k_up={k_up}")
    if not tensor_cores and (C % 4 or C > _KERNEL_MAX_CHANNELS or 8192 % C
                             or C < 16):
        raise ValueError(f"vocoder_stage with fp32 operands takes "
                         f"16 <= C <= 128 dividing 8192, got C={C}")
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


def fused_resblock(x: torch.Tensor, block: Block, slope: float = 0.1,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One MRF resblock at C <= 128 that the stage kernel does not cover
    (Pallas `fused_resblock`, K6). Not on the V1 path; on a CPU tensor its
    plain version runs."""
    if x.device.type != "cpu":
        raise NotImplementedError(
            "fused_resblock (TPU kernel K6) is not ported yet: ROADMAP.md "
            "Queue 2, K6")
    return vocoder_stage_plain(x, None, None, [block], slope=slope,
                               compute_dtype=compute_dtype)


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

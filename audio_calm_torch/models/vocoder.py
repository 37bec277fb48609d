"""Vocoders in PyTorch (counterpart of audio_calm_tpu/models/vocoder.py):
the HiFi-GAN generator and the Griffin-Lim fallback.

`HiFiGANGenerator` is the eager generator: the plain reference of the whole
generator. `HiFiGANVocoder` is the serving vocoder: its forward runs
`ops.vocoder_kernel.hifigan_apply_fused`, which on a CUDA tensor goes
through the hand-written kernels. `load_vocoder` builds the product's
vocoder: HiFi-GAN from a weight-normed torch checkpoint (official or
SpeechBrain naming), or Griffin-Lim when there is none, as the shipped
configs (`vocoder_path: null`) have it.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_calm_torch import resolve_device
from audio_calm_torch.config import HiFiGANConfig
from audio_calm_torch.models.convert import load_torch_state_dict
from audio_calm_torch.models.layers import Conv1d, ConvTranspose1d
from audio_calm_torch.ops.mel import (dft_basis, frame_signal, hann_window,
                                      mel_filterbank)
from audio_calm_torch.ops.vocoder_kernel import hifigan_apply_fused, lrelu


class ResBlock1(nn.Module):
    """HiFi-GAN V1 MRF resblock: per dilation d,
    x += Conv_k,1(LReLU(Conv_k,d(LReLU(x))))."""

    def __init__(self, channels: int, kernel_size: int, dilations, slope=0.1):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.dilations = tuple(dilations)
        self.slope = slope
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, k, padding=d * (k - 1) // 2, dilation=d)
            for d in self.dilations
        )
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, k, padding=(k - 1) // 2)
            for _ in self.dilations
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(lrelu(c1(lrelu(x, self.slope)), self.slope))
        return x


class HiFiGANGenerator(nn.Module):
    """mel [B, T, n_mels] -> waveform [B, T * total_upsample] (float32)."""

    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.in_channels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for r, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
            self.ups.append(
                ConvTranspose1d(ch, ch // 2, k, stride=r, padding=(k - r) // 2))
            ch //= 2
            self.resblocks.append(nn.ModuleList(
                ResBlock1(ch, rk, rd, cfg.lrelu_slope)
                for rk, rd in zip(cfg.resblock_kernel_sizes,
                                  cfg.resblock_dilations)
            ))
        self.conv_post = Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        slope = self.cfg.lrelu_slope
        x = self.conv_pre(mel)
        for up, blocks in zip(self.ups, self.resblocks):
            x = up(lrelu(x, slope))
            acc = None
            for blk in blocks:
                h = blk(x)
                acc = h if acc is None else acc + h
            x = acc / len(blocks)
        x = self.conv_post(lrelu(x, slope))
        return torch.tanh(x.float())[..., 0]


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """weight = g * v / ||v||, the norm over all dims but dim 0 (torch
    weight_norm default)."""
    dims = tuple(range(1, v.ndim))
    norm = torch.sqrt((v * v).sum(dim=dims, keepdim=True))
    return g * v / norm.clamp_min(1e-12)


class HiFiGANVocoder(nn.Module):
    """log-mel [B, T, n_mels] -> waveform [B, T * total_upsample].

    Runs the generator through `hifigan_apply_fused`: the stage kernel on a
    CUDA tensor, its plain version on a CPU tensor. compute_dtype is the
    stage kernels' operand dtype (accumulation stays fp32); io_dtype the
    inter-stage activation dtype (None follows the mel)."""

    def __init__(self, generator: HiFiGANGenerator,
                 compute_dtype=torch.bfloat16, io_dtype=None):
        super().__init__()
        self.generator = generator
        self.compute_dtype = compute_dtype
        self.io_dtype = io_dtype

    @property
    def cfg(self) -> HiFiGANConfig:
        return self.generator.cfg

    def forward(self, log_mel: torch.Tensor) -> torch.Tensor:
        return hifigan_apply_fused(self.generator, log_mel,
                                   compute_dtype=self.compute_dtype,
                                   io_dtype=self.io_dtype)


# ---------------------------------------------------------------------------
# Loading torch HiFi-GAN checkpoints
# ---------------------------------------------------------------------------
def convert_hifigan(sd: Dict[str, torch.Tensor],
                    cfg: HiFiGANConfig = HiFiGANConfig()
                    ) -> Dict[str, torch.Tensor]:
    """A torch generator state dict (weight-normed, `ups.N` / `resblocks.M`
    naming of the official and SpeechBrain checkpoints) -> the state dict of
    `HiFiGANGenerator(cfg)`: weight norm folded (weight_g / weight_v or
    parametrizations.weight.original0 / original1; else a plain .weight),
    resblock M of stage i at M = i * n_kernels + j, float32."""

    def weight(prefix):
        for g, v in ((".weight_g", ".weight_v"),
                     (".parametrizations.weight.original0",
                      ".parametrizations.weight.original1")):
            if prefix + g in sd:
                return fold_weight_norm(sd[prefix + g].float(),
                                        sd[prefix + v].float())
        return sd[prefix + ".weight"].float()

    out: Dict[str, torch.Tensor] = {}

    def put(src, dst):
        out[dst + ".weight"] = weight(src)
        out[dst + ".bias"] = sd[src + ".bias"].float()

    put("conv_pre", "conv_pre")
    put("conv_post", "conv_post")
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        put(f"ups.{i}", f"ups.{i}")
        for j in range(n_k):
            for ci in range(len(cfg.resblock_dilations[j])):
                for conv in ("convs1", "convs2"):
                    put(f"resblocks.{i * n_k + j}.{conv}.{ci}",
                        f"resblocks.{i}.{j}.{conv}.{ci}")
    return out


def _strip_state_dict_prefix(sd: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """Strip any wrapper prefix (e.g. "generator.", "module.", "model.") so
    keys start at conv_pre / ups / resblocks / conv_post."""
    anchor = None
    for k in sd:
        i = k.find("conv_pre.")
        if i >= 0:
            anchor = k[:i]
            break
    if not anchor:
        return sd
    return {k[len(anchor):]: v for k, v in sd.items() if k.startswith(anchor)}


# a checkpoint directory's files, in the order they are looked for
_CHECKPOINT_NAMES = ("generator.ckpt", "model.ckpt", "generator.bin",
                     "pytorch_model.bin", "model.safetensors")


def load_vocoder(path: Optional[str] = None,
                 cfg: HiFiGANConfig = HiFiGANConfig(), device=None):
    """The product's vocoder on `device` (None = the card): HiFi-GAN when a
    checkpoint exists at `path`, Griffin-Lim otherwise (reference
    eval_calm.py:169-208). `path` is a torch checkpoint file (.bin / .pt /
    .ckpt / .safetensors) or a SpeechBrain-style directory holding one of
    generator.ckpt, model.ckpt, generator.bin, pytorch_model.bin,
    model.safetensors (the first found)."""
    device = resolve_device(device)
    sd = None
    if path:
        candidate = None
        if os.path.isdir(path):
            for name in _CHECKPOINT_NAMES:
                p = os.path.join(path, name)
                if os.path.exists(p):
                    candidate = p
                    break
        elif os.path.isfile(path):
            candidate = path
        if candidate:
            sd = _strip_state_dict_prefix(load_torch_state_dict(candidate))
        else:
            print(f"warning: vocoder checkpoint not found at {path}; "
                  "falling back to Griffin-Lim")
    if sd is None:
        return GriffinLimVocoder(device=device)
    with torch.device(device):
        gen = HiFiGANGenerator(cfg)
    gen.load_state_dict(convert_hifigan(sd, cfg), strict=True)
    return HiFiGANVocoder(gen.eval().requires_grad_(False))


# ---------------------------------------------------------------------------
# Griffin-Lim fallback
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def _istft_basis(n_fft: int):
    """Inverse real-DFT basis (Cs, Ss), each [n_bins, n_fft]: a frame is
    re @ Cs + im @ Ss (the inner bins counted twice, Hermitian)."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * n * k / n_fft
    scale = np.ones(n_bins)
    scale[1:-1] = 2.0
    Cs = (np.cos(ang) * scale / n_fft).T.astype(np.float32)
    Ss = (-np.sin(ang) * scale / n_fft).T.astype(np.float32)
    return Cs, Ss


def _overlap_add(frames: torch.Tensor, win: torch.Tensor, hop: int,
                 length: int) -> torch.Tensor:
    """Windowed frames [B, T, n_fft] -> signal [B, length] by overlap-add,
    normalized by the summed squared window, centered.

    The frames go in r = ceil(n_fft / hop) phases (frames j, j + r, ...
    do not overlap, so each phase is one reshape) summed in a fixed order:
    the same bits on every run. A scatter-add (`index_add_`) sums with
    atomics on the card, in the order its threads land, so a seeded
    request would not give the same audio twice."""
    B, T, n_fft = frames.shape
    r = -(-n_fft // hop)
    out_len = n_fft + (T - 1) * hop

    def add_phases(f: torch.Tensor) -> torch.Tensor:
        f = F.pad(f, (0, r * hop - n_fft))
        out = f.new_zeros(*f.shape[:-2], (T + r) * hop)
        for j in range(min(r, T)):
            p = f[..., j::r, :].reshape(*f.shape[:-2], -1)
            out[..., j * hop: j * hop + p.shape[-1]] += p
        return out[..., :out_len]

    x = add_phases(frames * win)
    wsum = add_phases((win * win).expand(T, n_fft))
    x = x / torch.clamp(wsum, min=1e-8)
    pad = n_fft // 2
    return x[:, pad: pad + length]


def _istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
           length: int) -> torch.Tensor:
    """Inverse STFT with a hann window and overlap-add (center=True
    layout): re/im [B, frames, bins] -> [B, length]."""
    Cs, Ss = (torch.as_tensor(a, device=re.device) for a in _istft_basis(n_fft))
    win = torch.as_tensor(hann_window(n_fft), device=re.device)
    return _overlap_add(re @ Cs + im @ Ss, win, hop, length)


def griffin_lim(magnitude: torch.Tensor, n_fft: int = 1024, hop: int = 256,
                n_iter: int = 32, angle: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Phase reconstruction by iterative STFT consistency: magnitude
    [B, frames, bins] -> waveform [B, frames * hop].

    The initial phase is one field [1, frames, bins] that every row shares,
    so a row's waveform depends on its own magnitudes only. It is `angle`
    when given, else uniform in [-pi, pi) drawn from `generator` (default: a
    CPU generator seeded 0, the same field on every device). The JAX
    package draws it from PRNGKey(0), a stream torch cannot reproduce: pass
    that field as `angle` to match it."""
    B, T, n_bins = magnitude.shape
    dev = magnitude.device
    length = (T - 1) * hop  # the consistency loop round-trips T frames
    if angle is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        u = torch.rand((1, T, n_bins), generator=generator,
                       device=generator.device)
        angle = (2 * u - 1) * math.pi
    angle = angle.to(dev, torch.float32)
    C, S = dft_basis(n_fft, n_fft, dev)
    Cs, Ss = (torch.as_tensor(a, device=dev) for a in _istft_basis(n_fft))
    win = torch.as_tensor(hann_window(n_fft), device=dev)
    re = magnitude * torch.cos(angle)
    im = magnitude * torch.sin(angle)
    for _ in range(n_iter):
        x = _overlap_add(re @ Cs + im @ Ss, win, hop, length)
        p = n_fft // 2
        fr = frame_signal(F.pad(x[:, None], (p, p), mode="reflect")[:, 0],
                          n_fft, hop)
        re2, im2 = fr @ C, fr @ S
        mag2 = torch.sqrt(torch.clamp(re2 * re2 + im2 * im2, min=1e-12))
        re, im = magnitude * re2 / mag2, magnitude * im2 / mag2
    # the final synthesis emits all T * hop samples, the HiFi-GAN
    # samples-per-frame contract
    return _istft(re, im, n_fft, hop, T * hop)


class GriffinLimVocoder(nn.Module):
    """log-mel [B, T, n_mels] -> waveform [B, T * hop]: exp -> pinv of the
    mel filterbank -> sqrt magnitude -> Griffin-Lim (reference fallback,
    eval_calm.py:184-208; the hop of the mel frontend, not torchaudio's
    n_fft // 2). Its tensors live on `device` (None = the card)."""

    def __init__(self, n_mels: int = 80, n_fft: int = 1024, hop: int = 256,
                 sample_rate: int = 16000, f_max: float = 8000.0,
                 n_iter: int = 32, device=None):
        super().__init__()
        fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, 0.0, f_max)
        self.register_buffer("inv_fb", torch.as_tensor(
            np.linalg.pinv(fb), device=resolve_device(device)))  # [mels, bins]
        self.n_fft, self.hop, self.n_iter = n_fft, hop, n_iter

    def forward(self, log_mel: torch.Tensor,
                angle: Optional[torch.Tensor] = None) -> torch.Tensor:
        energy = torch.exp(log_mel.float())
        power = torch.clamp(energy @ self.inv_fb, min=1e-8)
        return griffin_lim(torch.sqrt(power), self.n_fft, self.hop,
                           self.n_iter, angle=angle)

"""Log-mel spectrogram frontend (counterpart of audio_calm_tpu/ops/mel.py).

Matched to the reference frontend (preprocess/core.py:23-61): torchaudio
MelSpectrogram(sr=16k, n_fft=1024, hop=256, n_mels=80, power=2.0, f_min=0,
f_max=8000, norm="slaney", mel_scale="slaney", center=True,
pad_mode="reflect", periodic hann), then ln(clamp(mel, 1e-5)).

The STFT is two matmuls against a windowed real-DFT basis, as the JAX
package computes it, and framing takes the hop-divides-n_fft reshape path
where it can. The filterbank, window and basis are host constants in
numpy (float64 arithmetic, float32 out), the same numbers as the JAX
package's.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_calm_torch import resolve_device
from audio_calm_torch.config import MelConfig


def hz_to_mel(freq, mel_scale: str = "slaney") -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    safe = np.maximum(freq, 1e-10)
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(safe / min_log_hz) / logstep, mels)


def mel_to_hz(mels, mel_scale: str = "slaney") -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: Optional[float] = None,
                   norm: str = "slaney", mel_scale: str = "slaney"
                   ) -> np.ndarray:
    """Triangular mel filterbank, shape [n_freqs, n_mels] (fp64 -> fp32)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min, mel_scale),
                        hz_to_mel(f_max, mel_scale), n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]  # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[:-1]  # rising edge
    up = slopes[:, 2:] / f_diff[1:]  # falling edge
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    denom = win_length if periodic else win_length - 1
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))).astype(np.float32)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[B, T] -> [B, n_frames, n_fft] frames at stride `hop` (no padding).
    When hop divides n_fft: a reshape into hop-blocks and n_fft // hop
    shifted slices; otherwise one gather."""
    B, T = x.shape
    n_frames = (T - n_fft) // hop + 1
    if n_fft % hop == 0:
        k = n_fft // hop
        n_blocks = T // hop
        blocks = x[:, : n_blocks * hop].reshape(B, n_blocks, hop)
        return torch.cat([blocks[:, i: i + n_frames] for i in range(k)], 2)
    idx = (torch.arange(n_frames, device=x.device)[:, None] * hop
           + torch.arange(n_fft, device=x.device)[None, :])
    return x[:, idx]


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis (C, S), each [n_fft, n_fft // 2 + 1]: frames
    @ C is the real part, frames @ S the imaginary. A window shorter than
    n_fft is centered in it, as torch.stft does."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    win = hann_window(win_length).astype(np.float64)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = np.zeros(n_fft)
        w[pad: pad + win_length] = win
        win = w
    C = (np.cos(ang) * win[:, None]).astype(np.float32)
    S = (-np.sin(ang) * win[:, None]).astype(np.float32)
    return C, S


def dft_basis(n_fft: int, win_length: int, device) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """`_dft_basis` as float32 tensors on `device`."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _dft_basis(n_fft, win_length))


def stft_power(x: torch.Tensor, n_fft: int, hop: int,
               win_length: Optional[int] = None, center: bool = True,
               pad_mode: str = "reflect", power: float = 2.0) -> torch.Tensor:
    """Power (or magnitude) spectrogram: [B, T] -> [B, n_frames, n_fft//2+1]."""
    win_length = win_length or n_fft
    if center:
        p = n_fft // 2
        x = F.pad(x[:, None], (p, p), mode=pad_mode)[:, 0]
    frames = frame_signal(x, n_fft, hop).float()
    C, S = dft_basis(n_fft, win_length, x.device)
    re = frames @ C
    im = frames @ S
    p2 = re * re + im * im
    if power == 2.0:
        return p2
    if power == 1.0:
        return torch.sqrt(torch.clamp(p2, min=1e-30))
    return torch.pow(torch.clamp(p2, min=1e-30), power / 2.0)


class MelFrontend:
    """Log-mel extractor (the reference MelExtractor, preprocess/core.py:
    23-61): wav [B, T] (or [T]) -> log-mel [B, n_frames, n_mels],
    channels-last, on `device` (None = the card)."""

    def __init__(self, cfg: MelConfig = MelConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fb = torch.as_tensor(
            mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate,
                           cfg.f_min, cfg.f_max, norm="slaney",
                           mel_scale="slaney"), device=self.device)

    def __call__(self, wav) -> torch.Tensor:
        cfg = self.cfg
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        if wav.ndim == 1:
            wav = wav[None, :]
        spec = stft_power(wav, cfg.n_fft, cfg.hop_length, cfg.win_length,
                          center=cfg.center, pad_mode=cfg.pad_mode,
                          power=cfg.power)
        mel = spec @ self.fb  # [B, frames, n_mels]
        return torch.log(torch.clamp(mel, min=cfg.log_clamp))


def process_audio_chunk(wav: torch.Tensor, peak: float = 0.95
                        ) -> torch.Tensor:
    """Mono mix + peak normalization (reference preprocess/core.py:93-112):
    wav [C, T] or [T] -> [T], peak-normalized to +-0.95."""
    if wav.ndim == 2:
        wav = wav.mean(dim=0)
    p = wav.abs().max()
    return torch.where(p > 0, wav / (p + 1e-8) * peak, wav)

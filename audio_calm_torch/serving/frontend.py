"""Bucketed, batched, length-exact ASR wav -> latent frontend
(counterpart of audio_calm_tpu/serving/frontend.py).

Serving quantizes wav lengths to the latent-grid buckets so that concurrent
ASR requests share one static-shape (padded B, bucket) encode. The VAE
encoder normalizes with GroupNorm over time, so a silence-padded row would
shift every valid latent; this frontend makes the bucketing invisible:

- the host pad continues the signal by reflection (what the exact-length
  STFT's center reflect pad reads past the end), so every valid mel frame
  equals the exact-length one;
- the mel frames between the valid length and the stride boundary repeat
  pad_to_stride's reflect pad through a gather;
- the VAE encode masks its GroupNorm statistics and conv inputs to the
  valid region (AcousticVAE.encode(mel, mask)).

As in the JAX frontend, the VAE encodes the log-mel as the mel frontend
gives it (no mel_mean / mel_std normalization).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.config import MelConfig, VAEModelConfig
from audio_calm_torch.models.vae import AcousticVAE, pad_to_stride
from audio_calm_torch.ops.mel import MelFrontend


def make_asr_frontend(vae: AcousticVAE, vae_cfg: VAEModelConfig,
                      mel_cfg: MelConfig, lat_buckets: List[int],
                      device=None):
    """-> (prep, batch): host-side bucketing and a batched masked encode on
    `device` (None = the card), where the VAE must already live.

    prep(wav_f32) -> (bucket, padded [bucket], n_samples)
    batch(items)  -> [latents [n_lat_i, latent_dim]] as float32 numpy, for
                     items (padded, n) sharing one bucket, each row equal
                     to its solo exact-length encode."""
    device = resolve_device(device)
    frontend = MelFrontend(mel_cfg, device=device)
    hop = mel_cfg.hop_length
    stride = vae_cfg.total_stride
    wav_buckets = [int(b) * stride * hop for b in lat_buckets]

    def prep(wav_f32) -> Tuple[int, np.ndarray, int]:
        n = min(len(wav_f32), wav_buckets[-1])
        # a bucket that also fits the n_fft / 2 reflect tail (only the
        # largest bucket truncates it)
        r_want = min(mel_cfg.n_fft // 2, n - 1)
        bucket = next((b for b in wav_buckets if n + r_want <= b),
                      wav_buckets[-1])
        padded = np.zeros(bucket, np.float32)
        padded[:n] = np.asarray(wav_f32[:n], np.float32)
        r = min(mel_cfg.n_fft // 2, n - 1, bucket - n)
        if r > 0:
            padded[n:n + r] = padded[n - 2:n - 2 - r:-1]
        return bucket, padded, n

    @torch.no_grad()
    def encode(wavs: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
        # per-row peak normalization (the reflect tail only repeats
        # in-signal values, so it never changes a row's peak), log-mel,
        # the masked VAE encode; ns = true sample counts
        p = wavs.abs().amax(dim=1, keepdim=True)
        w = torch.where(p > 0, wavs / (p + 1e-8) * 0.95, wavs)
        mel = pad_to_stride(frontend(w), stride)
        n_mel = ns // hop + 1
        n_valid = -(-n_mel // stride) * stride
        t = torch.arange(mel.shape[1], device=device)[None, :]
        idx = torch.where(t < n_mel[:, None], t, 2 * n_mel[:, None] - 2 - t)
        idx = idx.clamp(0, mel.shape[1] - 1)
        mel = torch.take_along_dim(mel, idx[..., None], dim=1)
        mask = (t < n_valid[:, None])[..., None]
        mel = torch.where(mask, mel, torch.zeros_like(mel))
        mu, _ = vae.encode(mel, mask.to(mel.dtype))
        return mu

    def batch(items) -> List[np.ndarray]:
        wavs = np.stack([w for w, _ in items])
        ns = np.array([n for _, n in items], np.int64)
        B = wavs.shape[0]
        Bp = 1 << (B - 1).bit_length()  # a few batch shapes only
        wavs = np.concatenate([wavs, np.repeat(wavs[:1], Bp - B, 0)])
        ns = np.concatenate([ns, np.repeat(ns[:1], Bp - B)])
        mu = encode(torch.as_tensor(wavs, device=device),
                    torch.as_tensor(ns, device=device)).float().cpu().numpy()
        out = []
        for i, (_, n) in enumerate(items):
            n_lat = -(-(n // hop + 1) // stride)
            out.append(mu[i, :n_lat])
        return out

    return prep, batch


def encode_chunks(prep, batch, chunks: List[np.ndarray]) -> List[np.ndarray]:
    """Encode variable-length wav chunks through a make_asr_frontend pair:
    one batched masked encode per wav bucket, in input order (rows are
    length-exact, so grouping never changes a chunk's latents)."""
    prepped = [prep(c) for c in chunks]
    by_bucket: dict = {}
    for i, (bucket, padded, n) in enumerate(prepped):
        by_bucket.setdefault(bucket, []).append((i, padded, n))
    out: List[np.ndarray] = [None] * len(chunks)  # type: ignore[list-item]
    for grp in by_bucket.values():
        lats = batch([(p, n) for _, p, n in grp])
        for (i, _, _), lat in zip(grp, lats):
            out[i] = lat
    return out

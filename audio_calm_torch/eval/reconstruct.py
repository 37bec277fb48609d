"""VAE reconstruction of log-mels (counterpart of the loop of
scripts/eval_vae.py:71-111, over mels the caller passes in).

Per utterance, as that loop runs `AcousticVAE.__call__(mel, train=False)`:
reflect-pad to the VAE's stride, normalize with the global mel statistics,
encode, take the mean (eval mode), decode, denormalize. The statistics are
the loop's: reconstruction MSE and L1 against the padded input, the KL
term mean(0.5 (mu^2 + e^logvar - 1 - logvar)), the standard deviation of
mu and the mean of e^logvar, each averaged over the utterances.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.models.vae import (AcousticVAE, denormalize_mel,
                                         normalize_mel, pad_to_stride)
from audio_calm_torch.models.vocoder import GriffinLimVocoder


@torch.no_grad()
def reconstruct(vae: AcousticVAE, mels: Sequence[np.ndarray], device=None,
                vocoder: Optional[GriffinLimVocoder] = None) -> Dict:
    """mels: log-mels [T, n_mels], one per utterance -> {"recons": [(padded
    input, reconstruction)] and "mu": [latent means] as float32 numpy,
    "mse", "l1", "kl_mean", "mu_std", "var_mean"} and, with a vocoder,
    "wavs": [(input wav, reconstruction wav)]. The VAE (and vocoder) live
    on `device` (None = the card)."""
    device = resolve_device(device)
    cfg = vae.cfg
    stats = {k: [] for k in ("mse", "l1", "kl_mean", "mu_std", "var_mean")}
    recons, mus, wavs = [], [], []
    for mel in mels:
        x = pad_to_stride(torch.as_tensor(np.asarray(mel, np.float32),
                                          device=device)[None],
                          cfg.total_stride)
        mu, logvar = vae.encode(normalize_mel(x, cfg))
        recon = denormalize_mel(vae.decode(vae.reparameterize(mu, logvar)),
                                cfg)
        mu, logvar = mu.float(), logvar.float()
        stats["mse"].append(float(torch.mean((recon - x) ** 2)))
        stats["l1"].append(float(torch.mean(torch.abs(recon - x))))
        stats["kl_mean"].append(float(torch.mean(
            0.5 * (mu ** 2 + torch.exp(logvar) - 1.0 - logvar))))
        stats["mu_std"].append(float(torch.std(mu, unbiased=False)))
        stats["var_mean"].append(float(torch.mean(torch.exp(logvar))))
        recons.append((x[0].cpu().numpy(), recon[0].float().cpu().numpy()))
        mus.append(mu[0].cpu().numpy())
        if vocoder is not None:
            wavs.append(tuple(vocoder(m)[0].cpu().numpy() for m in (x, recon)))
    out: Dict = {k: float(np.mean(v)) for k, v in stats.items()}
    out["recons"] = recons
    out["mu"] = mus
    if vocoder is not None:
        out["wavs"] = wavs
    return out

"""Acoustic VAE (counterpart of audio_calm_tpu/models/vae.py).

encoder: Conv(80->512, k3 p1); per stride s: Conv(512->512, k=2s, s, p=s//2)
+ ResBlock; GN + GELU + Conv(512->2*latent, k3 p1) -> (mu, logvar).
decoder: Conv(latent->512, k3 p1) + ResBlock; per stride (reversed):
ConvTranspose(512->512, k=2s, s, p=s//2) + ResBlock; Conv(512->80, k3 p1).

With a validity mask [B, T, 1] the GroupNorm statistics cover valid frames
only and activations are re-zeroed before each conv, so a padded row
encodes (decodes) its valid frames exactly as the exact-length tensor
would. `load_vae` reads a reference (torch) checkpoint file.

Training (JAX vae.py:134-153, 176-232): `AcousticVAE.forward(mel, train)`
normalizes the mel, encodes, samples z = mu + eps * exp(logvar / 2) with
latent dropout in train mode (the mean in eval mode), decodes, and returns
the loss terms on the normalized mel: L1 (or MSE), `ssim_weight` x SSIM
(ops/ssim.py), `stft_loss_weight` x `multires_stft_loss` and `kl_weight` x
KL, with the reconstruction, z, mu and logvar. eps comes from an explicit
generator (or is passed in) and the dropout mask from a seed, as the CALM
training steps draw theirs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from audio_calm_torch import resolve_device
from audio_calm_torch.config import VAEModelConfig, from_dict
from audio_calm_torch.models.layers import (Conv1d, ConvTranspose1d,
                                            GroupNorm, gelu)
from audio_calm_torch.ops.dropout import draw, dropout
from audio_calm_torch.ops.mel import stft_power
from audio_calm_torch.ops.ssim import ssim_loss


class ResBlock(nn.Module):
    """x + [GN -> GELU -> Conv(k3 p1)] x2, masked."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(num_groups, channels)
        self.conv1 = Conv1d(channels, channels, 3, padding=1)
        self.norm2 = GroupNorm(num_groups, channels)
        self.conv2 = Conv1d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = gelu(self.norm1(x, mask))
        if mask is not None:
            h = h * mask
        h = gelu(self.norm2(self.conv1(h), mask))
        if mask is not None:
            h = h * mask
        out = x + self.conv2(h)
        return out * mask if mask is not None else out


class Encoder(nn.Module):
    def __init__(self, cfg: VAEModelConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_channels
        self.conv_in = Conv1d(cfg.in_channels, C, 3, padding=1)
        self.down_conv = nn.ModuleList(
            Conv1d(C, C, 2 * s, stride=s, padding=s // 2) for s in cfg.strides)
        self.down_res = nn.ModuleList(ResBlock(C, cfg.norm_num_groups)
                                      for _ in cfg.strides)
        self.norm_out = GroupNorm(cfg.norm_num_groups, C)
        self.conv_out = Conv1d(C, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, mel], mask [B, T, 1] of valid frames (each row's length
        a multiple of total_stride) -> (mu, logvar) [B, T / stride, latent]."""
        if mask is not None:
            mask = mask.to(x.dtype)
            x = x * mask
        x = self.conv_in(x)
        if mask is not None:
            x = x * mask
        for s, down, res in zip(self.cfg.strides, self.down_conv,
                                self.down_res):
            x = down(x)
            if mask is not None:
                mask = mask[:, ::s]
                x = x * mask
            x = res(x, mask)
        x = gelu(self.norm_out(x, mask))
        if mask is not None:
            x = x * mask
        mu, logvar = self.conv_out(x).chunk(2, dim=-1)
        return mu, logvar


class Decoder(nn.Module):
    def __init__(self, cfg: VAEModelConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_channels
        self.conv_in = Conv1d(cfg.latent_channels, C, 3, padding=1)
        self.res_in = ResBlock(C, cfg.norm_num_groups)
        self.strides = list(reversed(cfg.strides))
        self.up_conv = nn.ModuleList(
            ConvTranspose1d(C, C, 2 * s, stride=s, padding=s // 2)
            for s in self.strides)
        self.up_res = nn.ModuleList(ResBlock(C, cfg.norm_num_groups)
                                    for _ in self.strides)
        self.conv_out = Conv1d(C, cfg.in_channels, 3, padding=1)

    def forward(self, z: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is not None:
            mask = mask.to(z.dtype)
            z = z * mask
        x = self.conv_in(z)
        if mask is not None:
            x = x * mask
        x = self.res_in(x, mask)
        for s, up, res in zip(self.strides, self.up_conv, self.up_res):
            x = up(x)
            if mask is not None:
                mask = torch.repeat_interleave(mask, s, dim=1)
                x = x * mask
            x = res(x, mask)
        return self.conv_out(x)


class AcousticVAE(nn.Module):
    """normalized log-mel [B, T, n_mels] <-> latents [B, T / total_stride,
    latent]; T a multiple of total_stride (see `pad_to_stride`)."""

    def __init__(self, cfg: VAEModelConfig = VAEModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def encode(self, mel: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(mel, mask)

    def decode(self, z: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder(z, mask)

    def reparameterize(self, mu: torch.Tensor, logvar: torch.Tensor,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None,
                       seed: int = 0, eps: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Eval mode: the mean. Train mode: mu + eps * exp(logvar / 2), eps
        standard normal from `generator` unless given, then latent dropout
        at cfg.latent_dropout (kept values scaled by 1 / (1 - rate)) with
        the mask fixed by `seed`."""
        if not train:
            return mu
        std = torch.exp(0.5 * logvar)
        if eps is None:
            eps = draw(torch.randn, mu.shape, generator=generator,
                       device=mu.device, dtype=mu.dtype)
        z = mu + eps.to(mu.dtype) * std
        return dropout(z, self.cfg.latent_dropout, seed)

    def forward(self, mel: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, seed: int = 0,
                eps: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """mel [B, T, n_mels] raw log-mel, T a multiple of total_stride ->
        loss, rec_loss, ssim_loss, stft_loss, kl_loss (fp32 scalars),
        recon_mel (denormalized), z, mu, logvar."""
        c = self.cfg
        if mel.shape[1] % c.total_stride != 0:
            raise ValueError(
                f"mel time dim {mel.shape[1]} must be a multiple of "
                f"total_stride={c.total_stride}; use vae.pad_to_stride() "
                "first")
        mel_n = (mel - c.mel_mean) / c.mel_std
        mu, logvar = self.encode(mel_n)
        z = self.reparameterize(mu, logvar, train, generator, seed, eps)
        recon = self.decode(z)
        if c.use_l1_loss:
            rec_loss = (recon - mel_n).abs().mean()
        else:
            rec_loss = ((recon - mel_n) ** 2).mean()
        ssim = ssim_loss(recon.transpose(1, 2), mel_n.transpose(1, 2))
        stft_l = multires_stft_loss(recon, mel_n)
        mu_f, lv_f = mu.float(), logvar.float()
        kl = (0.5 * (mu_f ** 2 + torch.exp(lv_f) - 1.0 - lv_f)).mean()
        loss = (rec_loss + c.ssim_weight * ssim + c.stft_loss_weight * stft_l
                + c.kl_weight * kl)
        return {"loss": loss, "rec_loss": rec_loss, "ssim_loss": ssim,
                "stft_loss": stft_l, "kl_loss": kl,
                "recon_mel": recon * c.mel_std + c.mel_mean, "z": z,
                "mu": mu, "logvar": logvar}


def multires_stft_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Multi-resolution STFT magnitude L1 over mel-bin "channels": x, y
    [B, T, C], each of the C bins a 1-D signal; specs (256, 64), (128, 32),
    (64, 16) filtered to n_fft <= T, center=False, Hann window, the mean
    |mag_x - mag_y| of each, averaged over the specs (0 when none fits)."""
    B, T, C = x.shape
    specs = [(n, h) for (n, h) in ((256, 64), (128, 32), (64, 16)) if n <= T]
    if not specs:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    xf = x.transpose(1, 2).reshape(B * C, T).float()
    yf = y.transpose(1, 2).reshape(B * C, T).float()
    loss = 0.0
    for n_fft, hop in specs:
        mx = stft_power(xf, n_fft, hop, center=False, power=1.0)
        my = stft_power(yf, n_fft, hop, center=False, power=1.0)
        loss = loss + (mx - my).abs().mean()
    return loss / len(specs)


@torch.no_grad()
def init_vae_(vae: AcousticVAE, seed: int = 0) -> AcousticVAE:
    """Fresh training weights drawn from one seeded generator, with flax's
    initializers (the JAX package's `model.init`): every conv and
    transposed-conv kernel lecun-normal (a normal truncated at 2 sigma,
    variance 1 / (k x C_in)), biases 0, GroupNorm scales 1 and biases 0."""
    gens = {}
    for m in vae.modules():
        if isinstance(m, (Conv1d, ConvTranspose1d)):
            w = m.weight
            if w.device not in gens:
                gens[w.device] = torch.Generator(w.device).manual_seed(seed)
            c_in = w.shape[1] if isinstance(m, Conv1d) else w.shape[0]
            # flax's truncated normal: unit variance after truncation
            std = (1.0 / (c_in * w.shape[2])) ** 0.5 / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gens[w.device])
            m.bias.zero_()
        elif isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return vae


def load_vae(ckpt_path: str, cfg: Optional[VAEModelConfig] = None,
              device=None) -> AcousticVAE:
    """A pretrained VAE from a reference torch checkpoint file (.bin / .pt
    / .safetensors, reference preprocess/core.py:63-91) -> AcousticVAE on
    `device` (None = the card), eval mode, no gradients. Without `cfg`, a
    `vae_config.json` sidecar in the directory or beside the file gives the
    geometry (scripts/train_vae.py and train/train_vae.py write it, the
    latter beside its exported vae.bin), else VAEModelConfig(). A
    directory is the JAX package's orbax checkpoint, which the port cannot
    read: it raises, as a missing file does. (models/convert.load_vae
    carries a JAX tree across instead.)"""
    from audio_calm_torch.models import convert as C
    from audio_calm_torch.train.checkpoint import orbax_item_error

    device = resolve_device(device)
    if cfg is None:
        for candidate in (
                os.path.join(ckpt_path, "vae_config.json"),
                os.path.join(os.path.dirname(ckpt_path.rstrip("/")),
                             "vae_config.json")):
            if os.path.exists(candidate):
                with open(candidate) as f:
                    cfg = from_dict(VAEModelConfig, json.load(f))
                break
    cfg = cfg or VAEModelConfig()
    if os.path.isdir(ckpt_path):
        raise orbax_item_error(ckpt_path)
    if not os.path.isfile(ckpt_path):
        raise FileNotFoundError(f"load_vae: {ckpt_path} does not exist")
    sd = C.numpy_state_dict(C.load_torch_state_dict(ckpt_path))
    with torch.device(device):
        vae = AcousticVAE(cfg)
    init = C.to_jax_params(vae.state_dict())
    vae.load_state_dict(C.from_jax_params(C.merge_params(
        init, C.convert_vae_params(sd, tuple(cfg.strides)))), strict=True)
    return vae.eval().requires_grad_(False)


def pad_to_stride(mel: torch.Tensor, total_stride: int) -> torch.Tensor:
    """Reflect-pad the time axis of [B, T, C] to a multiple of total_stride
    (numpy's 'reflect', reference modeling_vae.py:322-327)."""
    T = mel.shape[1]
    rem = T % total_stride
    if rem == 0:
        return mel
    # reflection without the edge sample, period 2(T-1): numpy's rule, which
    # also holds when the pad is longer than the signal
    n = torch.arange(T, T + total_stride - rem, device=mel.device)
    period = max(2 * (T - 1), 1)
    m = n % period
    idx = torch.where(m < T, m, period - m)
    return torch.cat([mel, mel[:, idx]], dim=1)


def normalize_mel(mel: torch.Tensor, cfg: VAEModelConfig) -> torch.Tensor:
    return (mel - cfg.mel_mean) / cfg.mel_std


def denormalize_mel(mel_n: torch.Tensor, cfg: VAEModelConfig) -> torch.Tensor:
    return mel_n * cfg.mel_std + cfg.mel_mean

"""Latent -> waveform rendering: masked VAE decode, mel denormalization,
then the vocoder, HiFi-GAN or Griffin-Lim (counterpart of
audio_calm_tpu/eval/render.py).

`render(latents, n)` takes GRID-PADDED latents and returns the valid audio:
the decode is masked to the first n frames (the decoder's GroupNorms
normalize over time, so unmasked padding would shift every valid frame),
the mel beyond 4n frames is zeroed (what HiFi-GAN's conv padding reads at
an exact-length boundary), and the waveform is cut to n frames. Griffin-Lim
renders the same masked mel grid; its log-mel 0 past the valid frames is a
nonzero magnitude, so its tail stays coupled to the grid, as in JAX.

The render runs its convolutions in full fp32 (`fp32_convs`: cuDNN's TF32
off for the call). cuDNN picks a convolution's algorithm by the batch; in
TF32 two algorithms' sums can differ by more than the served contract
allows between a row rendered in a batch and alone (2 LSB of 16-bit
audio), in fp32 by far less (chip_smoke.py phase 5g holds the contract).
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Callable, List, Sequence, Union

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.config import VAEModelConfig
from audio_calm_torch.models.vae import AcousticVAE, denormalize_mel
from audio_calm_torch.models.vocoder import GriffinLimVocoder, HiFiGANVocoder

# samples of 16 kHz audio per latent frame: VAE 4x time upsample * hop 256
SAMPLES_PER_FRAME = 4 * 256


@contextlib.contextmanager
def fp32_convs():
    """cuDNN's TF32 convolutions off for the block (the flag is the
    process's: the served engine renders on one worker thread)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def make_renderer(vae: AcousticVAE, vae_cfg: VAEModelConfig,
                  vocoder: Union[HiFiGANVocoder, GriffinLimVocoder],
                  device=None) -> Callable[[np.ndarray, int], np.ndarray]:
    """-> render(latents [T_grid, D], n_frames) -> wav float32 [n * 1024],
    with `render.batch(latents [B, T_grid, D], n_frames)` -> list of wavs
    and `render.decode_mel(latents, ns)` -> masked mel [B, up*T_grid, 80].
    The VAE and vocoder must live on `device` (None = the card)."""
    device = resolve_device(device)
    up = vae_cfg.total_stride
    for name, mod in (("vae", vae), ("vocoder", vocoder)):
        p = next(itertools.chain(mod.parameters(), mod.buffers()))
        if p.device.type != device.type:
            raise ValueError(f"{name} weights are on {p.device}, the renderer "
                             f"runs on {device}")

    @torch.no_grad()
    def decode_mel(latents: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
        T = latents.shape[1]
        frames = torch.arange(T, device=device)[None, :]
        mask = (frames < ns[:, None])[..., None].float()
        with fp32_convs():
            mel = denormalize_mel(vae.decode(latents, mask), vae_cfg)
        mframes = torch.arange(up * T, device=device)[None, :]
        return mel * (mframes < up * ns[:, None])[..., None].to(mel.dtype)

    @torch.no_grad()
    def _run(lat: np.ndarray, ns: Sequence[int]) -> np.ndarray:
        x = torch.as_tensor(np.asarray(lat, np.float32), device=device)
        n = torch.as_tensor(np.asarray(ns, np.int64), device=device)
        with fp32_convs():
            return vocoder(decode_mel(x, n)).float().cpu().numpy()

    def render(latents, n_frames: int) -> np.ndarray:
        wav = _run(np.asarray(latents, np.float32)[None], [int(n_frames)])
        return wav[0][: int(n_frames) * SAMPLES_PER_FRAME]

    def render_batch(latents, n_frames) -> List[np.ndarray]:
        """latents [B, T_grid, D] (one shared grid), n_frames per item ->
        list of waveforms. B pads to the next power of two by repeating
        row 0, as the JAX renderer does; rows are independent, so padding
        cannot change an item's audio."""
        lat = np.asarray(latents, np.float32)
        ns = [int(n) for n in n_frames]
        B = lat.shape[0]
        Bp = 1 << (B - 1).bit_length()
        if Bp > B:
            lat = np.concatenate([lat, np.repeat(lat[:1], Bp - B, 0)])
            ns = ns + [ns[0]] * (Bp - B)
        wav = _run(lat, ns)
        return [wav[i][: n * SAMPLES_PER_FRAME]
                for i, n in enumerate(ns[:B])]

    render.batch = render_batch
    render.decode_mel = decode_mel
    return render

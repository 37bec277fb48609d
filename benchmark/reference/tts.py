"""A /tts request computed by the plain reference: the text split into
prompt-budget chunks, each chunk a row from its prompt to its waveform,
the rows joined by the crossfade, the joined audio clipped to [-1, 1].

Where the served program floors its durations to whole frames, a row can
follow the program's own durations (`durations`): a duration a hair from
an integer floors to either side in two precisions, and a frame moved
from one token to the next changes the condition there. The durations
themselves are compared apart (check.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from benchmark.reference import model as M
from benchmark.reference import text as T

SAMPLE_RATE = 16000


@dataclass
class RefRow:
    n_frames: int
    grid: int
    hidden: torch.Tensor  # [L + 1, D]: the prompt's states, then SOA's
    durations: torch.Tensor  # [L], fp32
    latents: torch.Tensor  # [n, latent]
    wav: np.ndarray  # [n * samples a frame], clipped


def noise(seed: int, rows: int, dim: int, device) -> torch.Tensor:
    """A row's ODE noise: standard normal [rows, dim] from its own seed."""
    g = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    return torch.randn(rows, dim, generator=g, device=device)


def stride(vae: dict) -> int:
    s = 1
    for x in vae["strides"]:
        s *= x
    return s


@torch.no_grad()
def row(Wc, Wv, Wh, conf: dict, chunk: str, seed: int,
        durations: Optional[torch.Tensor] = None) -> RefRow:
    """One chunk: its prompt through Qwen2, its length and durations, the
    guided ODE on its own frames, the VAE decoder and HiFi-GAN on its
    bucket's grid (the mel past its frames zero, as the grid holds it)."""
    m, ev, vae, h = conf["model"], conf["evaluation"], conf["vae"], \
        conf["hifigan"]
    dev = Wc["soa_embed"].device
    hidden = M.qwen2_encode(Wc, m, T.prompt_ids(chunk))
    cond_vec, text_ctx = hidden[-1], hidden[:-1]
    n = M.predict_length(Wc, m, text_ctx)
    grid = T.pick_grid(n, ev["audio_buckets"], m["max_audio_len"])
    n = min(n, grid)
    dur = M.predict_durations(Wc, text_ctx, n)
    follow = dur if durations is None else durations
    tok = M.alignment(M.durations_to_int(follow), n)
    cond = torch.zeros(n, text_ctx.shape[1], device=dev)
    cond[:len(tok)] = text_ctx[torch.as_tensor(tok, device=dev)]
    cond = cond + cond_vec
    x0 = noise(seed, m["max_audio_len"], m["latent_dim"], dev)[:n]
    x = M.ode_cfg(Wc, m, ev, cond, text_ctx, x0)
    lat = x * torch.as_tensor(m["latent_std"], device=dev) + \
        torch.as_tensor(m["latent_mean"], device=dev)
    mel = M.vae_decode(Wv, vae, lat) * vae["mel_std"] + vae["mel_mean"]
    up = stride(vae)
    mel = torch.cat([mel, mel.new_zeros(up * (grid - n), mel.shape[1])])
    per_frame = up
    for r in h["upsample_rates"]:
        per_frame *= r
    wav = M.hifigan(Wh, h, mel)[: n * per_frame]
    return RefRow(n, grid, hidden, dur, lat,
                  np.clip(wav.cpu().numpy(), -1.0, 1.0))


def chunks(conf: dict, text: str):
    """The request's chunks and their seeds."""
    m, ev = conf["model"], conf["evaluation"]
    budget = min(m["max_text_len"], max(ev["text_buckets"]))
    return T.split_text(text, budget)


def audio(conf: dict, wavs) -> np.ndarray:
    """The request's audio from its rows' waveforms."""
    if len(wavs) == 1:
        return wavs[0]
    return np.clip(T.crossfade(wavs, SAMPLE_RATE,
                               conf["evaluation"]["crossfade_ms"]), -1.0, 1.0)

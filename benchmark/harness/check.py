"""Whether what the timed path served is right: a sample of the window's
finished requests, drawn from the seed with the longest among them, is
computed again by the plain reference (benchmark/reference/) and compared.

Numbers compared, each against the limit in the configuration's "check":
  frames_off   the largest gap between a row's served frame count and the
               reference's (an integer; limit 0)
  hidden_gap   the largest relative L2 gap between the Qwen2 states of a
               row's prompt and SOA as the program computed them and the
               reference's
  dur_gap      the largest relative L2 gap between a row's durations as
               the program predicted them and the reference's
  latent_gap   the largest relative L2 gap between a row's served latents
               and the reference's, over the row's own frames
  audio_gap    the largest relative L2 gap between the audio the server
               sent (16-bit PCM) and the reference's; a length that
               differs is an infinite gap
A request that failed, or whose rows the program never produced, makes the
run not correct. The reference runs after the window, once the program's
state is freed, with its weights drawn again from the seed. Where the
program floors durations to whole frames, the reference follows the
program's durations (reference/tts.py); the durations are compared by
themselves (dur_gap), and so are the states they come from (hidden_gap).
"""

from __future__ import annotations

import gc
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.reference import model as M
from benchmark.reference import spec as S
from benchmark.reference import tts as R
from benchmark.reference.text import chunk_seeds, prompt_ids

NAMES = ("frames_off", "hidden_gap", "dur_gap", "latent_gap", "audio_gap")


@dataclass
class Served:
    """What the timed path produced for a row, or what the control does in
    its place."""
    n_frames: int
    hidden: torch.Tensor  # [L + 1, D]
    durations: Optional[torch.Tensor]  # [L]
    latents: torch.Tensor  # [n, latent]


def sample(sent, seed: int, k: int) -> list:
    """k finished requests drawn from the seed, the one with the most
    audio always among them."""
    done = [r for r in sent if r.ok]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].body))
    rng = np.random.default_rng([int(seed) % (1 << 63), 11])
    rest = [i for i in range(len(done)) if i != longest]
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [done[longest]] + [done[rest[int(i)]] for i in sorted(pick)]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def reference_weights(conf: dict, seed: int, device):
    s_calm, s_vae, s_voc = S.component_seeds(seed)
    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[conf["evaluation"]["compute_dtype"]]
    # the served values (drawn in the served type), held in float32
    Wc = M.Weights({k: v.float() for k, v in S.draw(
        S.calm_spec(conf["model"]), s_calm, device, dtype).items()})
    gc.collect()
    Wv = M.Weights(S.draw(S.vae_spec(conf["vae"]), s_vae, device))
    Wh = M.Weights(S.draw(S.hifigan_spec(conf["hifigan"]), s_voc, device))
    return Wc, Wv, Wh


def served_audio(body: bytes) -> np.ndarray:
    return np.frombuffer(body[44:], "<i2").astype(np.float32) / 32767.0


def _served(row, L: int, device) -> Served:
    h = row.hidden
    hidden = None if h is None else torch.cat([h[:L], h[-1:]]).to(
        device, torch.float32)
    return Served(row.n_frames, hidden,
                  None if row.durations is None
                  else row.durations[:L].float().to(device),
                  torch.as_tensor(np.asarray(row.latents), device=device))


def run_check(conf: dict, sent, rows: Dict[int, object], seed: int,
              device, k: int, control: Optional[str] = None
              ) -> Tuple[Dict[str, float], List[str]]:
    """-> ({number: value}, [notes]) over the sample. control="fp8": the
    reference in float8 takes the served rows' and audio's place."""
    M.exact_fp32()
    W = reference_weights(conf, seed, device)
    Q = tuple(M.fp8_weights(w) for w in W) if control == "fp8" else None
    got = {n: 0.0 for n in NAMES}
    notes: List[str] = []
    flips = tokens = 0
    for rec in sample(sent, seed, k):
        parts = R.chunks(conf, rec.req.text)
        seeds = chunk_seeds(rec.req.seed, len(parts))
        wavs, theirs = [], []
        for part, s in zip(parts, seeds):
            L = len(prompt_ids(part))
            if Q is not None:
                c = R.row(*Q, conf, part, s)
                prog = Served(c.n_frames, c.hidden, c.durations, c.latents)
                theirs.append(c.wav)
            elif int(s) in rows:
                prog = _served(rows[int(s)], L, device)
            else:
                notes.append(f"request {rec.req.index}: no served row for "
                             f"chunk seed {s}")
                got["latent_gap"] = math.inf
                continue
            ref = R.row(*W, conf, part, s, prog.durations)
            got["frames_off"] = max(got["frames_off"],
                                    abs(prog.n_frames - ref.n_frames))
            if prog.hidden is not None:
                got["hidden_gap"] = max(got["hidden_gap"],
                                        rel(prog.hidden, ref.hidden))
            if prog.durations is not None:
                got["dur_gap"] = max(got["dur_gap"],
                                     rel(prog.durations, ref.durations))
                flips += sum(int(math.floor(a) != math.floor(b)) for a, b in
                             zip(prog.durations.tolist(),
                                 ref.durations.tolist()))
                tokens += L
            n = min(prog.n_frames, ref.n_frames)
            got["latent_gap"] = max(got["latent_gap"],
                                    rel(prog.latents[:n], ref.latents[:n]))
            wavs.append(ref.wav)
        if len(wavs) == len(parts):
            want = R.audio(conf, wavs)
            have = (R.audio(conf, theirs) if Q is not None
                    else served_audio(rec.body))
            gap = (math.inf if len(have) != len(want) else
                   float(np.linalg.norm(have - want)
                         / max(np.linalg.norm(want), 1e-30)))
            got["audio_gap"] = max(got["audio_gap"], gap)
        else:
            got["audio_gap"] = math.inf
    notes.append(f"durations floored to another integer than the "
                 f"reference's: {flips} of {tokens} tokens")
    del W, Q
    gc.collect()
    return got, notes

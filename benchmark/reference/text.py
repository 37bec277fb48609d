"""The request side of TTS, written out plainly: the byte tokenizer, the
ChatML prompt, the split of a long text into prompt-budget chunks, each
chunk's seed, the equal-power crossfade that joins chunk audio, and the
choice of a grid from the audio buckets. These are the semantics the
served system states for a /tts request; the reference applies them to
the request as the client sent it.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Sequence

import numpy as np

TTS_PROMPT = (
    "<|im_start|>user\nRead this text:\n{}<|im_end|>\n<|im_start|>assistant\n"
)
BYTE_EOS = 1
IM_END = "<|im_end|>"


def byte_encode(text: str) -> List[int]:
    """Bytes shifted by 2 (0 = pad, 1 = EOS); each <|im_end|> -> EOS."""
    ids: List[int] = []
    for chunk in text.split(IM_END):
        ids.extend(b + 2 for b in chunk.encode("utf-8"))
        ids.append(BYTE_EOS)
    return ids[:-1]


def prompt_ids(text: str) -> List[int]:
    return byte_encode(TTS_PROMPT.format(text))


def split_text(text: str, max_tokens: int) -> List[str]:
    """Sentences (cut after . ! ? ; : and whitespace) packed greedily while
    the whole prompt stays within `max_tokens`; a sentence past the budget
    is cut at whitespace the same way."""

    def n_tok(s: str) -> int:
        return len(prompt_ids(s))

    parts = [p for p in re.split(r"(?<=[.!?;:])\s+", text.strip()) if p]
    if not parts:
        return [text]
    units: List[str] = []
    for p in parts:
        if n_tok(p) <= max_tokens:
            units.append(p)
            continue
        cur = ""
        for w in p.split():
            cand = (cur + " " + w).strip()
            if cur and n_tok(cand) > max_tokens:
                units.append(cur)
                cur = w
            else:
                cur = cand
        if cur:
            units.append(cur)
    chunks: List[str] = []
    cur = ""
    for u in units:
        cand = (cur + " " + u).strip()
        if cur and n_tok(cand) > max_tokens:
            chunks.append(cur)
            cur = u
        else:
            cur = cand
    if cur:
        chunks.append(cur)
    return chunks or [text]


def chunk_seeds(seed: int, n: int) -> List[int]:
    """A one-chunk request keeps its seed; chunk i of many gets the 63-bit
    BLAKE2b hash of "seed/i"."""
    if n == 1:
        return [int(seed)]
    out = []
    for i in range(n):
        d = hashlib.blake2b(f"{int(seed)}/{i}".encode(), digest_size=8)
        out.append(int.from_bytes(d.digest(), "little") >> 1)
    return out


def crossfade(wavs: Sequence[np.ndarray], sample_rate: int = 16000,
              ms: float = 20.0) -> np.ndarray:
    """Join waveforms with an equal-power (cos / sin) crossfade of `ms` at
    each boundary: the last `ms` of what is joined so far (of the latest
    piece, where that is shorter) fades into the next piece's start."""
    fade = int(sample_rate * ms / 1000.0)
    done: List[np.ndarray] = []
    held = None
    for w in wavs:
        w = np.asarray(w, np.float32)
        if held is not None:
            f = min(fade, len(held), len(w))
            if f > 0:
                t = np.linspace(0.0, np.pi / 2.0, f, dtype=np.float32)
                w = np.concatenate([held[:len(held) - f],
                                    held[len(held) - f:] * np.cos(t)
                                    + w[:f] * np.sin(t), w[f:]])
            else:
                w = np.concatenate([held, w])
        if len(w) > fade:
            done.append(w[:len(w) - fade])
            held = w[len(w) - fade:]
        else:
            held = w
    if held is not None and len(held):
        done.append(held)
    return np.concatenate(done) if done else np.zeros(0, np.float32)


def pick_grid(n_frames: int, buckets: Sequence[int], max_len: int) -> int:
    """The smallest audio bucket that holds n_frames (max_len past all)."""
    n_frames = min(n_frames, max_len)
    for b in sorted(buckets):
        if b >= n_frames:
            return min(b, max_len)
    return max_len

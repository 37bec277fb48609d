"""Non-autoregressive TTS and ASR inference (counterpart of
audio_calm_tpu/eval/infer.py).

Everything runs on a static [B, t_aud] / [B, num_queries] grid with per-row
lengths and masks, as in JAX. Random numbers come from an explicit
`torch.Generator`; every noise site also takes an explicit `x_init`.
Entry points: `tts_generate_latents` (with eval.render.make_renderer after
it), `asr_generate_ids`, and `CALMInference`, the host-side wrapper the
server drives: bucketed single-chunk and batched TTS, long-form TTS (whole,
streamed, batched), batched ASR and long-form and streaming ASR, with the
text / wav splitters and crossfades they share.
"""

from __future__ import annotations

import hashlib
import re
import warnings
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.models.calm import QwenCALM
from audio_calm_torch.ops.alignment import build_alignment_from_durations
from audio_calm_torch.ops.ode import ode_solve
from audio_calm_torch.parallel.infer_shard import (shard_batch_rows,
                                                   shard_inference_params)

TTS_PROMPT = (
    "<|im_start|>user\nRead this text:\n{}<|im_end|>\n<|im_start|>assistant\n"
)
ASR_PROMPT = (
    "<|im_start|>user\nTranscribe audio to text embedding.<|im_end|>\n"
    "<|im_start|>assistant\n"
)
# Qwen2 ChatML terminators (reference eval_calm.py:365-372)
EOS_CANDIDATES = (151643, 151645)


def _on_model_device(model: QwenCALM, device) -> torch.device:
    device = resolve_device(device)
    if model.soa_embed.device.type != device.type:
        raise ValueError(f"model weights are on {model.soa_embed.device}, "
                         f"the call runs on {device}")
    return device


@torch.no_grad()
def tts_encode(model: QwenCALM, text_ids: torch.Tensor,
               attention_mask: torch.Tensor):
    """Phase 1: LLM encode + length prediction ->
    (cond_vec, text_ctx, text_pad, num_frames [B] int32)."""
    cond_vec, text_ctx, text_pad = model.encode_text_for_tts(text_ids,
                                                             attention_mask)
    num_frames = model.predict_length(text_ctx, text_pad).to(torch.int32)
    return cond_vec, text_ctx, text_pad, num_frames


@torch.no_grad()
def tts_condition(model: QwenCALM, cond_vec, text_ctx, text_pad,
                  num_frames, t_aud: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Durations -> alignment -> per-frame DiT condition on a [B, t_aud]
    grid -> (condition [B, t_aud, D], frame_valid [B, t_aud] bool,
    num_frames clipped to t_aud)."""
    num_frames = torch.clamp_max(num_frames, t_aud)
    dur_scaled = model.predict_durations(text_ctx, text_pad, num_frames)
    valid = ~text_pad
    dur_int = torch.floor(dur_scaled).to(torch.int32)
    dur_int = torch.where(valid, dur_int.clamp_min(1),
                          torch.zeros_like(dur_int))
    align = build_alignment_from_durations(dur_int, valid, t_aud,
                                           budget=num_frames)
    aligned_text = torch.einsum("bnt,bnd->btd", align.to(text_ctx.dtype),
                                text_ctx)
    condition = aligned_text + cond_vec
    frame_valid = (torch.arange(t_aud, device=num_frames.device)[None, :]
                   < num_frames[:, None])
    condition = condition * frame_valid[:, :, None].to(condition.dtype)
    return condition, frame_valid, num_frames


@torch.no_grad()
def tts_decode(model: QwenCALM, cond_vec, text_ctx, text_pad, num_frames,
               generator: Optional[torch.Generator] = None, steps: int = 50,
               cfg_scale: float = 2.5, t_aud: int = 384,
               method: str = "euler", time_schedule: str = "uniform",
               x_init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase 2: durations -> alignment -> CFG flow ODE on a [B, t_aud] grid
    -> denormalized fp32 latents [B, t_aud, latent_dim]; frames >=
    num_frames[b] are padding. The ODE starts from `x_init` when given,
    else from standard normal noise drawn from `generator`."""
    condition, frame_valid, num_frames = tts_condition(
        model, cond_vec, text_ctx, text_pad, num_frames, t_aud)
    B = cond_vec.shape[0]
    if x_init is None:
        x_init = torch.randn(B, t_aud, model.cfg.latent_dim,
                             generator=generator, device=condition.device,
                             dtype=torch.float32)
    x_init = x_init.to(condition.device, condition.dtype)
    x = ode_solve(model.tts_flow_fn, condition, x_init, steps, cfg_scale,
                  context=text_ctx, context_mask=text_pad,
                  x_mask=~frame_valid, method=method,
                  time_schedule=time_schedule)
    return model.denormalize_latents(x)


@torch.no_grad()
def tts_generate_latents(model: QwenCALM, text_ids, attention_mask,
                         generator: Optional[torch.Generator] = None,
                         steps: int = 50, cfg_scale: float = 2.5,
                         t_aud: int = 384,
                         num_frames_override: Optional[int] = None,
                         method: str = "euler",
                         time_schedule: str = "uniform",
                         x_init: Optional[torch.Tensor] = None,
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Text ids [B, T_txt] -> (denormalized latents [B, t_aud, latent_dim],
    num_frames [B]). `device=None` runs on the card (and raises without
    one); the model must already live there. num_frames_override pins the
    generated length (the length predictor still runs)."""
    device = _on_model_device(model, device)
    text_ids = torch.as_tensor(text_ids, device=device)
    attention_mask = torch.as_tensor(attention_mask, device=device)
    cond_vec, text_ctx, text_pad, num_frames = tts_encode(
        model, text_ids, attention_mask)
    if num_frames_override is not None:
        num_frames = torch.full_like(num_frames, num_frames_override)
    latents = tts_decode(model, cond_vec, text_ctx, text_pad, num_frames,
                         generator=generator, steps=steps,
                         cfg_scale=cfg_scale, t_aud=t_aud, method=method,
                         time_schedule=time_schedule, x_init=x_init)
    return latents, torch.clamp_max(num_frames, t_aud)


@torch.no_grad()
def asr_encode(model: QwenCALM, latents: torch.Tensor,
               audio_mask: torch.Tensor, prompt_ids: torch.Tensor,
               prompt_mask: torch.Tensor, num_queries: int = 96
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 1: [audio | SOA | prompt] encode and query cross-attention ->
    (condition [B, num_queries, D] zeroed past each row's query length,
    q_valid [B, num_queries] bool, q_len [B]). The query length is
    clip(valid audio frames // 4, 10, max_text_len) (reference
    eval_calm.py:334)."""
    condition = model.asr_encode_audio(latents, audio_mask, prompt_ids,
                                       prompt_mask, num_queries)
    valid = audio_mask.long().sum(dim=1)
    q_len = torch.clamp(valid // 4, 10, model.cfg.max_text_len)
    q_valid = (torch.arange(num_queries, device=q_len.device)[None, :]
               < q_len[:, None])
    condition = condition * q_valid[:, :, None].to(condition.dtype)
    return condition, q_valid, q_len


@torch.no_grad()
def asr_decode(model: QwenCALM, condition: torch.Tensor,
               q_valid: torch.Tensor,
               generator: Optional[torch.Generator] = None, steps: int = 20,
               cfg_scale: float = 1.0, method: str = "euler",
               time_schedule: str = "uniform",
               x_init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase 2: the flow ODE over the ASR head -> the state before the
    nearest-token search [B, num_queries, hidden], in the model's dtype.
    It starts from `x_init` when given, else from standard normal noise
    drawn from `generator`."""
    if x_init is None:
        x_init = torch.randn(condition.shape, generator=generator,
                             device=condition.device, dtype=torch.float32)
    x_init = x_init.to(condition.device, condition.dtype)
    return ode_solve(model.asr_flow_fn, condition, x_init, steps, cfg_scale,
                     x_mask=~q_valid, method=method,
                     time_schedule=time_schedule)


@torch.no_grad()
def asr_generate_ids(model: QwenCALM, latents, audio_mask, prompt_ids,
                     prompt_mask, generator: Optional[torch.Generator] = None,
                     steps: int = 20, cfg_scale: float = 1.0,
                     num_queries: int = 96, method: str = "euler",
                     time_schedule: str = "uniform",
                     x_init: Optional[torch.Tensor] = None, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw audio latents [B, T_aud, latent_dim] + mask, prompt ids + mask
    -> (token ids [B, num_queries], query lengths [B]). euler-20 at cfg 1
    is the reference protocol (eval_calm.py:340-360). `x_init` ([B,
    num_queries, hidden]) supplies the ODE noise explicitly; else it is
    drawn from `generator`. `device=None` runs on the card."""
    device = _on_model_device(model, device)
    latents, audio_mask, prompt_ids, prompt_mask = (
        torch.as_tensor(a, device=device)
        for a in (latents, audio_mask, prompt_ids, prompt_mask))
    condition, q_valid, q_len = asr_encode(model, latents, audio_mask,
                                           prompt_ids, prompt_mask,
                                           num_queries)
    x = asr_decode(model, condition, q_valid, generator, steps, cfg_scale,
                   method, time_schedule, x_init)
    return model.search_nearest_tokens(x), q_len


def truncate_at_eos(ids: np.ndarray, q_len: int,
                    extra_eos: Optional[set] = None) -> list:
    """Host-side EOS truncation (reference eval_calm.py:365-379)."""
    eos = set(EOS_CANDIDATES) | (extra_eos or set())
    out = []
    for tid in np.asarray(ids)[:q_len].tolist():
        if tid in eos:
            break
        out.append(tid)
    return out


def split_text_for_tts(text: str, tokenizer, max_tokens: int,
                       prompt_template: str = TTS_PROMPT) -> list:
    """Split long text into TTS-able chunks: sentences (split at .!?;:)
    greedily packed so that the FULL prompt (template.format(chunk)) stays
    within `max_tokens`; a single over-budget sentence is hard-split on
    whitespace. The check tokenizes the assembled prompt, because BPE
    merges at the template seam can make it differ from the sum of the
    parts. -> a non-empty list of chunks covering the text."""

    def n_tok(s: str) -> int:
        return len(tokenizer.encode(prompt_template.format(s),
                                    add_special_tokens=False))

    parts = [p for p in re.split(r"(?<=[.!?;:])\s+", text.strip()) if p]
    if not parts:
        return [text]
    units: list = []
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
    chunks: list = []
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


def split_wav_for_asr_stream(pieces: Iterable, max_samples: int,
                             search_samples: Optional[int] = None,
                             frame: int = 400, tagged: bool = False):
    """Split waveform pieces arriving in time into <= max_samples chunks
    at low-energy points: greedy left to right, each cut in the middle of
    the quietest `frame`-sample window of the last `search_samples` of the
    current window. A chunk is yielded as soon as its cut is decided (more
    than `max_samples` of audio buffered); only the last waits for the
    end. The chunks concatenate back to the input exactly; each is
    non-empty except for a zero-length input, which gives one empty chunk.
    tagged=True yields (chunk, is_final): a chunk made by a cut always has
    audio behind it."""
    if search_samples is None:
        search_samples = max(frame, max_samples // 8)
    buf = np.zeros(0, np.float32)
    for piece in pieces:
        piece = np.asarray(piece, np.float32)
        buf = piece if not len(buf) else np.concatenate([buf, piece])
        while len(buf) > max_samples:
            lo = max(max_samples - int(search_samples), 1)
            seg = buf[lo:max_samples]
            k = len(seg) // frame * frame
            if k >= frame:
                rms = np.square(seg[:k].reshape(-1, frame)).mean(axis=1)
                cut = lo + int(np.argmin(rms)) * frame + frame // 2
            else:
                cut = max_samples
            yield (buf[:cut], False) if tagged else buf[:cut]
            buf = buf[cut:]
    yield (buf, True) if tagged else buf


def split_wav_for_asr(wav: np.ndarray, max_samples: int,
                      search_samples: Optional[int] = None,
                      frame: int = 400) -> list:
    """split_wav_for_asr_stream over a whole waveform: the list of its
    chunks."""
    return list(split_wav_for_asr_stream([wav], max_samples, search_samples,
                                         frame))


def crossfade_stream(wavs: Iterable, sample_rate: int = 16000,
                     crossfade_ms: float = 20.0) -> Iterator[np.ndarray]:
    """Equal-power crossfade over an iterable of waveform chunks, yielding
    audio as it goes (each chunk's fade-length tail waits for the next
    chunk; empty chunks drop out)."""
    fade = int(sample_rate * crossfade_ms / 1000.0)
    held = None  # tail of the previous chunk, not yet emitted
    for wav in wavs:
        wav = np.asarray(wav, np.float32)
        if held is not None:
            f = min(fade, len(held), len(wav))
            if f > 0:
                t = np.linspace(0.0, np.pi / 2.0, f, dtype=np.float32)
                wav = np.concatenate([
                    held[: len(held) - f],
                    held[len(held) - f:] * np.cos(t) + wav[:f] * np.sin(t),
                    wav[f:],
                ])
            else:
                wav = np.concatenate([held, wav])
        if len(wav) > fade:
            yield wav[: len(wav) - fade]
            held = wav[len(wav) - fade:]
        else:
            held = wav
    if held is not None and len(held):
        yield held


def crossfade_concat(wavs: list, sample_rate: int = 16000,
                     crossfade_ms: float = 20.0) -> np.ndarray:
    """Concatenate waveform chunks with an equal-power crossfade at each
    boundary: crossfade_stream's pieces, joined."""
    pieces = list(crossfade_stream(wavs, sample_rate, crossfade_ms))
    return np.concatenate(pieces) if pieces else np.zeros((0,), np.float32)


def chunk_seed(seed: int, i: int) -> int:
    """Chunk i's seed of a many-chunk request seeded `seed`: a 63-bit hash
    of the pair (the port's counterpart of jax.random.fold_in)."""
    digest = hashlib.blake2b(f"{int(seed)}/{int(i)}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def chunk_seeds(seed: int, n: int) -> List[int]:
    """The seeds of a request's n chunks: the request's own seed when it
    has one chunk (so a long-form call of a short input is its solo call),
    else chunk_seed(seed, i). A chunk's seed depends on its index alone,
    never on how chunks are grouped into batches or streamed. The port's
    counterpart of the JAX package's CALMInference.chunk_keys (sequential
    splits, for TTS) and fold_in (for ASR), whose streams torch's
    generators cannot reproduce."""
    return [int(seed)] if n == 1 else [chunk_seed(seed, i) for i in range(n)]


class CALMInference:
    """Host-side wrapper binding a model and a tokenizer on one device
    (counterpart of the JAX package's CALMInference).

    audio_buckets (ascending frame counts): the TTS flow ODE runs on the
    smallest bucket grid that fits the predicted length. text_buckets
    (ascending token counts): prompts are right-padded (pad id, mask 0) to
    the smallest bucket that fits, and truncated past the largest. ASR
    pads audio to one [max_audio_len] grid.

    Noise: each row's ODE noise is drawn from its own integer seed by a
    `torch.Generator` on the model's device, at the full grid (TTS
    [max_audio_len, latent_dim], sliced to the bucket; ASR [max_text_len,
    hidden]), so neither the bucket nor the batch changes a row's noise,
    and a request's output depends on its seed alone. (The seeds do not
    give JAX's draws: the two generators differ.) Every method that draws
    noise also takes `x_init`, rows of that full-grid noise as arrays (one
    per item, or per chunk of a long-form call), used instead of the
    draws.
    `device=None` is the card.

    mesh (parallel.mesh.Mesh [data, model]): the engine runs one replica of
    the model per data row, its Qwen2 kernels split over the row's model
    devices (parallel/infer_shard.shard_inference_params; the model passed
    in is left as it is), and `tts_batch` / `asr_batch` split a group's
    rows over the data rows when they divide (shard_batch_rows), else run
    them on the first. Noise is drawn for the whole group first, so a row's
    output does not depend on where it runs. `device` is then the mesh's
    first device."""

    def __init__(self, model: QwenCALM, tokenizer=None,
                 max_audio_len: Optional[int] = None,
                 audio_buckets: Optional[Sequence[int]] = None,
                 text_buckets: Optional[Sequence[int]] = None, device=None,
                 mesh=None):
        self.mesh = mesh
        if mesh is not None:
            self.replicas = shard_inference_params(model, mesh)
            model, device = self.replicas[0], mesh.devices[0][0]
        else:
            self.replicas = [model]
        self.model = model
        self.tokenizer = tokenizer
        self.max_audio_len = max_audio_len or model.cfg.max_audio_len
        self.audio_buckets = sorted(audio_buckets) if audio_buckets else None
        self.text_buckets = sorted(text_buckets) if text_buckets else None
        self.device = _on_model_device(model, device)

    def _row_groups(self, *arrays: torch.Tensor):
        """[(replica, its device, its rows of each array there)]: the whole
        batch on the one model, or parallel/infer_shard.shard_batch_rows
        over the mesh."""
        return [(self.replicas[d], part[0].device, part)
                for d, part in shard_batch_rows(arrays, self.mesh)]

    # ---- prompts, grids, noise -----------------------------------------
    def _encode_prompt(self, text: str) -> np.ndarray:
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        return np.asarray(ids, np.int64)

    def _pad_id(self) -> int:
        return getattr(self.tokenizer, "pad_token_id", None) or 0

    def _prompt_arrays(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [1, L], mask [1, L]); with text_buckets, L is the
        smallest bucket that fits (pad id, mask 0), and a prompt past the
        largest bucket is truncated to it with a warning."""
        ids = self._encode_prompt(text)
        if not self.text_buckets:
            return ids[None], np.ones_like(ids)[None]
        L = len(ids)
        bucket = next((b for b in self.text_buckets if b >= L),
                      self.text_buckets[-1])
        if L > bucket:
            warnings.warn(
                f"prompt of {L} tokens truncated to largest text bucket "
                f"{bucket}; content (possibly the ChatML suffix) was cut",
                stacklevel=2)
        ids = ids[:bucket]
        out = np.full((bucket,), self._pad_id(), np.int64)
        out[: len(ids)] = ids
        mask = (np.arange(bucket) < len(ids)).astype(np.int64)
        return out[None], mask[None]

    def pick_bucket(self, n_frames: int) -> int:
        n_frames = min(n_frames, self.max_audio_len)
        for b in self.audio_buckets or ():
            if b >= n_frames:
                return min(b, self.max_audio_len)
        return self.max_audio_len

    def _noise(self, seeds: Sequence[int], x_init, rows: int, dim: int,
               pad_to: int) -> torch.Tensor:
        """[pad_to, rows, dim] fp32 on the device: x_init when given, else
        row i drawn from seeds[i] alone; rows past len(seeds) repeat row 0
        (the pad rows of a power-of-two batch)."""
        if x_init is not None:
            x = torch.as_tensor(np.stack([np.asarray(r, np.float32)
                                          for r in x_init]),
                                device=self.device)
            if x.shape != (len(seeds), rows, dim):
                raise ValueError(f"x_init of shape {tuple(x.shape)}, want "
                                 f"{(len(seeds), rows, dim)}")
        else:
            x = torch.stack([
                torch.randn(rows, dim, device=self.device,
                            generator=torch.Generator(self.device)
                            .manual_seed(int(s)))
                for s in seeds])
        return torch.cat([x, x[:1].expand(pad_to - len(seeds), rows, dim)])

    @staticmethod
    def _padded(n: int, pad_batch: bool) -> int:
        """n, or with pad_batch the next power of two (a few batch shapes
        only)."""
        return 1 << (n - 1).bit_length() if pad_batch else n

    # ---- TTS -------------------------------------------------------------
    def tts_batch(self, texts: Sequence[str], seeds: Sequence[int],
                  steps: int = 50, cfg_scale: float = 2.5,
                  method: str = "euler", time_schedule: str = "uniform",
                  pad_batch: bool = True, x_init=None):
        """Batched single-chunk synthesis as one encode and one decode: raw
        (un-templated) texts, one seed per text. All rows share one ODE grid,
        the bucket that fits the longest predicted length (masks keep
        shorter rows exact). pad_batch pads B to the next power of two
        (repeating row 0). x_init: [B, max_audio_len, latent_dim] noise.
        -> (latents [B, t_grid, latent_dim] fp32 numpy, n_frames, t_grid)."""
        if not texts or len(texts) != len(seeds):
            raise ValueError("tts_batch: one seed per text")
        B = len(texts)
        Bp = self._padded(B, pad_batch)
        arrs = [self._prompt_arrays(TTS_PROMPT.format(t)) for t in texts]
        L = max(a.shape[1] for a, _ in arrs)
        ids = np.full((Bp, L), self._pad_id(), np.int64)
        mask = np.zeros((Bp, L), np.int64)
        for i in range(Bp):
            a, m = arrs[i if i < B else 0]
            ids[i, : a.shape[1]] = a[0]
            mask[i, : m.shape[1]] = m[0]
        noise = self._noise(seeds, x_init, self.max_audio_len,
                            self.model.cfg.latent_dim, Bp)
        ids_t, mask_t = (torch.as_tensor(a, device=self.device)
                         for a in (ids, mask))
        encoded = [(rep, tts_encode(rep, i, m), x) for rep, _, (i, m, x)
                   in self._row_groups(ids_t, mask_t, noise)]
        nf = torch.cat([e[3].cpu() for _, e, _ in encoded]).numpy()[:B]
        t_aud = self.pick_bucket(int(nf.max()))
        latents = torch.cat([tts_decode(
            rep, *e, steps=steps, cfg_scale=cfg_scale, t_aud=t_aud,
            method=method, time_schedule=time_schedule,
            x_init=x[:, :t_aud]).float().cpu() for rep, e, x in encoded])
        return (latents[:B].numpy(),
                [int(min(n, t_aud)) for n in nf], t_aud)

    def tts(self, text: str, seed: int, steps: int = 50,
            cfg_scale: float = 2.5, method: str = "euler",
            time_schedule: str = "uniform", pad_to_grid: bool = False,
            x_init=None) -> Tuple[np.ndarray, int]:
        """-> (latents [T, latent_dim], num_frames): sliced to num_frames,
        or with pad_to_grid the whole bucket grid (for a renderer).
        x_init: [max_audio_len, latent_dim] noise."""
        latents, (n,), _ = self.tts_batch(
            [text], [seed], steps, cfg_scale, method, time_schedule,
            pad_batch=False, x_init=None if x_init is None else [x_init])
        return (latents[0] if pad_to_grid else latents[0, :n]), n

    def split_chunks(self, text: str,
                     max_chunk_tokens: Optional[int] = None) -> list:
        """Sentence-pack `text` into prompt-budget chunks (kept within the
        largest text bucket, past which a prompt would be cut)."""
        budget = max_chunk_tokens or self.model.cfg.max_text_len
        if self.text_buckets:
            budget = min(budget, self.text_buckets[-1])
        return split_text_for_tts(text, self.tokenizer, budget)

    def tts_long_stream(self, text: str, seed: int, render, steps: int = 50,
                        cfg_scale: float = 2.5, method: str = "euler",
                        time_schedule: str = "uniform",
                        crossfade_ms: float = 20.0,
                        max_chunk_tokens: Optional[int] = None, x_init=None):
        """Generator form of tts_long: yields waveform pieces as each text
        chunk is synthesized and rendered (`render` from
        eval.render.make_renderer); the pieces concatenate to tts_long's
        output. x_init: one noise row per chunk."""
        chunks = self.split_chunks(text, max_chunk_tokens)

        def chunk_wavs():
            for i, (chunk, s) in enumerate(zip(
                    chunks, chunk_seeds(seed, len(chunks)))):
                latents, n = self.tts(
                    chunk, s, steps=steps, cfg_scale=cfg_scale, method=method,
                    time_schedule=time_schedule, pad_to_grid=True,
                    x_init=None if x_init is None else x_init[i])
                yield np.asarray(render(latents, n), np.float32)

        yield from crossfade_stream(chunk_wavs(), crossfade_ms=crossfade_ms)

    def tts_long(self, text: str, seed: int, render, steps: int = 50,
                 cfg_scale: float = 2.5, method: str = "euler",
                 time_schedule: str = "uniform", crossfade_ms: float = 20.0,
                 max_chunk_tokens: Optional[int] = None,
                 x_init=None) -> np.ndarray:
        """Long-form text -> waveform: prompt-budget chunks, each
        synthesized on its bucket grid and rendered, crossfaded at the
        boundaries. Short text is one tts() call with `seed` itself."""
        pieces = list(self.tts_long_stream(
            text, seed, render, steps, cfg_scale, method, time_schedule,
            crossfade_ms, max_chunk_tokens, x_init))
        if not pieces:
            return np.zeros((0,), np.float32)
        return np.concatenate(pieces)

    def tts_long_batched(self, text: str, seed: int, render,
                         steps: int = 50, cfg_scale: float = 2.5,
                         method: str = "euler",
                         time_schedule: str = "uniform",
                         crossfade_ms: float = 20.0,
                         max_chunk_tokens: Optional[int] = None,
                         batch_size: int = 8, x_init=None) -> np.ndarray:
        """tts_long with the chunks in groups of up to `batch_size`, each
        one tts_batch and one render.batch; the same chunk seeds, so the
        latents are tts_long's (exactly on the CPU in fp32)."""
        chunks = self.split_chunks(text, max_chunk_tokens)
        seeds = chunk_seeds(seed, len(chunks))
        wavs = []
        for i in range(0, len(chunks), batch_size):
            latents, n_frames, _ = self.tts_batch(
                chunks[i:i + batch_size], seeds[i:i + batch_size],
                steps=steps, cfg_scale=cfg_scale, method=method,
                time_schedule=time_schedule,
                x_init=None if x_init is None else x_init[i:i + batch_size])
            wavs.extend(render.batch(latents, n_frames))
        return crossfade_concat(wavs, crossfade_ms=crossfade_ms)

    # ---- ASR -------------------------------------------------------------
    def _asr_pad(self, latents: np.ndarray):
        """One item's raw latents [T, D] -> (padded [t_max, D], mask)."""
        T = latents.shape[0]
        t_max = self.max_audio_len
        pad = np.zeros((t_max, latents.shape[1]), np.float32)
        pad[: min(T, t_max)] = latents[:t_max]
        mask = (np.arange(t_max) < T).astype(np.int32)
        return pad, mask

    def _asr_decode_row(self, ids_row: np.ndarray, q_len: int) -> str:
        extra = set()
        if self.tokenizer is not None and getattr(
                self.tokenizer, "eos_token_id", None) is not None:
            extra.add(self.tokenizer.eos_token_id)
        final = truncate_at_eos(np.asarray(ids_row), int(q_len), extra)
        return self.tokenizer.decode(final, skip_special_tokens=True)

    def _asr_inputs(self, latents_list: Sequence[np.ndarray],
                    seeds: Sequence[int], pad_batch: bool = True,
                    x_init=None):
        """Items' raw latents [T_i, latent_dim] and seeds -> the model's
        inputs on its device: (latents [B', max_audio_len, latent_dim],
        audio mask, prompt ids, prompt mask, x_init [B', max_text_len,
        hidden]); B' is B, or with pad_batch the next power of two (row 0
        repeated)."""
        if not latents_list or len(latents_list) != len(seeds):
            raise ValueError("asr_batch: one seed per latents item")
        B = len(latents_list)
        Bp = self._padded(B, pad_batch)
        padded = [self._asr_pad(np.asarray(x, np.float32))
                  for x in latents_list]
        padded += padded[:1] * (Bp - B)
        prompt = np.repeat(self._encode_prompt(ASR_PROMPT)[None], Bp, 0)
        arrays = (np.stack([p for p, _ in padded]),
                  np.stack([m for _, m in padded]), prompt,
                  np.ones_like(prompt))
        c = self.model.cfg
        return (*(torch.as_tensor(a, device=self.device) for a in arrays),
                self._noise(seeds, x_init, c.max_text_len,
                            c.qwen.hidden_size, Bp))

    def _asr_ids(self, latents_list: Sequence[np.ndarray],
                 seeds: Sequence[int], steps: int = 20,
                 cfg_scale: float = 1.0, method: str = "euler",
                 time_schedule: str = "uniform", pad_batch: bool = True,
                 x_init=None) -> Tuple[np.ndarray, np.ndarray]:
        """`asr_batch`'s device work -> (ids [B, max_text_len], q_len [B]) as
        numpy, the padded rows dropped."""
        ids, q_len = [], []
        for rep, dev, (*inputs, noise) in self._row_groups(
                *self._asr_inputs(latents_list, seeds, pad_batch, x_init)):
            i, q = asr_generate_ids(
                rep, *inputs, steps=steps, cfg_scale=cfg_scale,
                num_queries=self.model.cfg.max_text_len, method=method,
                time_schedule=time_schedule, x_init=noise, device=dev)
            ids.append(i.cpu())
            q_len.append(q.cpu())
        B = len(latents_list)
        return (torch.cat(ids).numpy()[:B], torch.cat(q_len).numpy()[:B])

    def asr_batch(self, latents_list: Sequence[np.ndarray],
                  seeds: Sequence[int], steps: int = 20,
                  cfg_scale: float = 1.0, method: str = "euler",
                  time_schedule: str = "uniform",
                  pad_batch: bool = True, x_init=None) -> List[str]:
        """Batched ASR as one device program: latents_list holds each
        item's raw latents [T_i, latent_dim], seeds one integer per item.
        pad_batch pads B to the next power of two (repeating row 0).
        x_init: [B, max_text_len, hidden] noise. -> one transcript per item,
        each the one `asr` gives for the same seed."""
        ids, q_len = self._asr_ids(latents_list, seeds, steps, cfg_scale,
                                   method, time_schedule, pad_batch, x_init)
        return [self._asr_decode_row(ids[i], int(q_len[i]))
                for i in range(len(latents_list))]

    def asr(self, latents: np.ndarray, seed: int, steps: int = 20,
            cfg_scale: float = 1.0, method: str = "euler",
            time_schedule: str = "uniform", x_init=None) -> str:
        """latents [T, latent_dim] -> transcript string."""
        return self.asr_batch(
            [latents], [seed], steps, cfg_scale, method, time_schedule,
            pad_batch=False, x_init=None if x_init is None else [x_init])[0]

    def asr_long(self, wav: np.ndarray, seed: int, encode,
                 max_wav_samples: int, steps: int = 20,
                 cfg_scale: float = 1.0, method: str = "euler",
                 time_schedule: str = "uniform", search_ms: float = 1500.0,
                 sample_rate: int = 16000, max_decode_batch: int = 8,
                 x_init=None) -> str:
        """Long-form waveform -> transcript: split at low-energy points into
        <= max_wav_samples chunks (split_wav_for_asr), encode them
        (`encode`: list of wav chunks -> list of latents [T_i, latent_dim],
        e.g. serving.frontend.encode_chunks), decode them in batches of
        `max_decode_batch`, and join. Chunk seeds are chunk_seeds(seed, n),
        so a wav that fits decodes as its solo asr(seed) and the transcript
        never depends on the grouping. x_init: one noise row per chunk."""
        chunks = [c for c in split_wav_for_asr(
            wav, int(max_wav_samples),
            search_samples=int(search_ms / 1000.0 * sample_rate)) if len(c)]
        if not chunks:
            return ""
        lats = encode(chunks)
        seeds = chunk_seeds(seed, len(chunks))
        texts: list = []
        for i in range(0, len(lats), max_decode_batch):
            texts.extend(self.asr_batch(
                lats[i:i + max_decode_batch], seeds[i:i + max_decode_batch],
                steps=steps, cfg_scale=cfg_scale, method=method,
                time_schedule=time_schedule,
                x_init=None if x_init is None
                else x_init[i:i + max_decode_batch]))
        return " ".join(t.strip() for t in texts if t.strip())

    def asr_stream(self, pieces: Iterable, seed: int, encode,
                   max_wav_samples: int, steps: int = 20,
                   cfg_scale: float = 1.0, method: str = "euler",
                   time_schedule: str = "uniform", search_ms: float = 1500.0,
                   sample_rate: int = 16000, x_init=None):
        """Generator: incremental transcription of audio arriving in pieces.
        Each decode chunk is encoded and transcribed alone the moment its
        cut is decided and its text yielded. The yields, joined by spaces
        (empty ones dropped), equal asr_long of the whole audio: the same
        cuts, the same chunk seeds (a cut chunk has audio behind it, so it
        is one of many; a single final chunk decodes with `seed`), and a
        row's transcript never depends on its batch (exactly on the CPU in
        fp32). x_init: one noise row per chunk."""
        i = 0
        for chunk, is_final in split_wav_for_asr_stream(
                pieces, int(max_wav_samples),
                search_samples=int(search_ms / 1000.0 * sample_rate),
                tagged=True):
            if not len(chunk):
                continue  # only the remainder at the end can be empty
            s = seed if (is_final and i == 0) else chunk_seed(seed, i)
            yield self.asr_batch(
                encode([chunk]), [s], steps=steps, cfg_scale=cfg_scale,
                method=method, time_schedule=time_schedule,
                x_init=None if x_init is None else [x_init[i]])[0].strip()
            i += 1

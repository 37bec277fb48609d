"""Non-autoregressive TTS and ASR inference (counterpart of
audio_calm_tpu/eval/infer.py).

Everything runs on a static [B, t_aud] / [B, num_queries] grid with per-row
lengths and masks, as in JAX. Random numbers come from an explicit
`torch.Generator`; every noise site also takes an explicit `x_init`.
Entry points: `tts_generate_latents` (with eval.render.make_renderer after
it), `asr_generate_ids`, and `CALMInference`'s ASR members. Still to be
ported: CALMInference's TTS members, `asr_long` / `asr_stream` and the
text / wav splitters.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.models.calm import QwenCALM
from audio_calm_torch.ops.alignment import build_alignment_from_durations
from audio_calm_torch.ops.ode import ode_solve

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


class CALMInference:
    """Host-side wrapper binding a model and a tokenizer: the ASR members
    of the JAX package's CALMInference (its TTS members, `asr_long` and
    `asr_stream` are still to be ported).

    Audio pads to one [max_audio_len] grid. Each row's ODE noise is drawn
    from its own integer seed at the fixed (num_queries, hidden) grid by a
    `torch.Generator` on the model's device, so a transcript depends on its
    seed alone, never on what it was batched with. (The seeds do not give
    JAX's draws: the two generators differ.) `device=None` is the card."""

    def __init__(self, model: QwenCALM, tokenizer=None,
                 max_audio_len: Optional[int] = None, device=None):
        self.model = model
        self.tokenizer = tokenizer
        self.max_audio_len = max_audio_len or model.cfg.max_audio_len
        self.device = _on_model_device(model, device)

    def _encode_prompt(self, text: str) -> np.ndarray:
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        return np.asarray(ids, np.int64)

    def _asr_pad(self, latents: np.ndarray):
        """One item's raw latents [T, D] -> (padded [t_max, D], mask)."""
        T = latents.shape[0]
        t_max = self.max_audio_len
        pad = np.zeros((t_max, latents.shape[1]), np.float32)
        pad[: min(T, t_max)] = latents[:t_max]
        mask = (np.arange(t_max) < T).astype(np.int32)
        return pad, mask

    def _row_noise(self, seed: int) -> torch.Tensor:
        """Row noise [num_queries, hidden] from `seed` alone."""
        c = self.model.cfg
        g = torch.Generator(self.device).manual_seed(int(seed))
        return torch.randn(c.max_text_len, c.qwen.hidden_size, generator=g,
                           device=self.device, dtype=torch.float32)

    def _asr_decode_row(self, ids_row: np.ndarray, q_len: int) -> str:
        extra = set()
        if self.tokenizer is not None and getattr(
                self.tokenizer, "eos_token_id", None) is not None:
            extra.add(self.tokenizer.eos_token_id)
        final = truncate_at_eos(np.asarray(ids_row), int(q_len), extra)
        return self.tokenizer.decode(final, skip_special_tokens=True)

    def _asr_inputs(self, latents_list: Sequence[np.ndarray],
                    seeds: Sequence[int], pad_batch: bool = True):
        """Items' raw latents [T_i, latent_dim] and seeds -> the model's
        inputs on its device: (latents [B', max_audio_len, latent_dim],
        audio mask, prompt ids, prompt mask, x_init [B', max_text_len,
        hidden]); B' is B, or with pad_batch the next power of two (row 0
        repeated)."""
        if not latents_list or len(latents_list) != len(seeds):
            raise ValueError("asr_batch: one seed per latents item")
        padded = [self._asr_pad(np.asarray(x, np.float32))
                  for x in latents_list]
        seeds = list(seeds)
        if pad_batch:
            B = len(padded)
            Bp = 1 << (B - 1).bit_length()
            padded += padded[:1] * (Bp - B)
            seeds += seeds[:1] * (Bp - B)
        prompt = np.repeat(self._encode_prompt(ASR_PROMPT)[None], len(seeds),
                           0)
        arrays = (np.stack([p for p, _ in padded]),
                  np.stack([m for _, m in padded]), prompt,
                  np.ones_like(prompt))
        return (*(torch.as_tensor(a, device=self.device) for a in arrays),
                torch.stack([self._row_noise(s) for s in seeds]))

    def _asr_ids(self, latents_list: Sequence[np.ndarray],
                 seeds: Sequence[int], steps: int = 20,
                 cfg_scale: float = 1.0, method: str = "euler",
                 time_schedule: str = "uniform", pad_batch: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """`asr_batch`'s device work -> (ids [B, max_text_len], q_len [B]) as
        numpy, the padded rows dropped."""
        *inputs, x_init = self._asr_inputs(latents_list, seeds, pad_batch)
        ids, q_len = asr_generate_ids(
            self.model, *inputs, steps=steps, cfg_scale=cfg_scale,
            num_queries=self.model.cfg.max_text_len, method=method,
            time_schedule=time_schedule, x_init=x_init, device=self.device)
        B = len(latents_list)
        return ids.cpu().numpy()[:B], q_len.cpu().numpy()[:B]

    def asr_batch(self, latents_list: Sequence[np.ndarray],
                  seeds: Sequence[int], steps: int = 20,
                  cfg_scale: float = 1.0, method: str = "euler",
                  time_schedule: str = "uniform",
                  pad_batch: bool = True) -> List[str]:
        """Batched ASR as one device program: latents_list holds each
        item's raw latents [T_i, latent_dim], seeds one integer per item.
        pad_batch pads B to the next power of two (repeating row 0).
        -> one transcript per item, each the one `asr` gives for the same
        seed."""
        ids, q_len = self._asr_ids(latents_list, seeds, steps, cfg_scale,
                                   method, time_schedule, pad_batch)
        return [self._asr_decode_row(ids[i], int(q_len[i]))
                for i in range(len(latents_list))]

    def asr(self, latents: np.ndarray, seed: int, steps: int = 20,
            cfg_scale: float = 1.0, method: str = "euler",
            time_schedule: str = "uniform") -> str:
        """latents [T, latent_dim] -> transcript string."""
        return self.asr_batch([latents], [seed], steps, cfg_scale, method,
                              time_schedule, pad_batch=False)[0]

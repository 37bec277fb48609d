"""Non-autoregressive TTS inference (counterpart of the TTS half of
audio_calm_tpu/eval/infer.py).

Everything runs on a static [B, t_aud] grid with per-row lengths and masks,
as in JAX. Random numbers come from an explicit `torch.Generator`; every
noise site also takes an explicit `x_init`. `tts_generate_latents` is the
entry point (with eval.render.make_renderer after it); `CALMInference`,
ASR and serving are still to be ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.models.calm import QwenCALM
from audio_calm_torch.ops.alignment import build_alignment_from_durations
from audio_calm_torch.ops.ode import ode_solve


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
    device = resolve_device(device)
    if model.soa_embed.device.type != device.type:
        raise ValueError(f"model weights are on {model.soa_embed.device}, "
                         f"the call runs on {device}")
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

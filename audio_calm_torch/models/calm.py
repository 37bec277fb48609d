"""QwenCALM, TTS inference members (counterpart of
audio_calm_tpu/models/calm.py).

The Qwen2 backbone (+LoRA) encodes [text | SOA]; the length and duration
predictors size the audio; the DiT flow head is the ODE's velocity field.
Module names follow the JAX parameter tree (embed, llm, soa_embed,
tts_flow_head, tts_len_predictor, tts_dur_predictor) so weights carry
across one-to-one (models/convert.py). The ASR members (input_proj,
asr_cross_attn, asr_query_embed, asr_flow_head) and the training forwards
are still to be ported.

The model computes in the dtype of its weights: fp32 for the parity tests,
bf16 for serving, with fp32 norms, softmax, predictor outputs and
denormalized latents as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from audio_calm_torch.config import CALMModelConfig
from audio_calm_torch.models.calm_heads import PredictorMLP, TransformerFlowHead
from audio_calm_torch.models.qwen2 import Qwen2Embed, Qwen2Model


def _as_stat(x, dim: int, device) -> torch.Tensor:
    """Scalar or [D] normalization stat -> broadcastable [1, 1, D or 1]."""
    arr = torch.as_tensor(x, dtype=torch.float32, device=device)
    if arr.ndim == 1:
        if arr.shape[0] != dim:
            raise ValueError(f"latent stat has {arr.shape[0]} entries, "
                             f"expected {dim}")
        return arr[None, None, :]
    return arr.reshape(1, 1, 1)


class QwenCALM(nn.Module):
    def __init__(self, cfg: CALMModelConfig):
        super().__init__()
        self.cfg = cfg
        qdim = cfg.qwen.hidden_size
        self.embed = Qwen2Embed(cfg.qwen)
        self.llm = Qwen2Model(cfg.qwen, lora=cfg.lora if cfg.use_lora else None)
        self.soa_embed = nn.Parameter(torch.zeros(1, 1, qdim))
        self.tts_flow_head = TransformerFlowHead(
            input_dim=qdim, output_dim=cfg.latent_dim,
            hidden_dim=cfg.tts_flow_hidden_dim,
            num_layers=cfg.tts_flow_num_layers,
            num_heads=cfg.flow_num_heads, context_dim=qdim,
        )
        self.tts_len_predictor = PredictorMLP(qdim, qdim // 2)
        self.tts_dur_predictor = PredictorMLP(qdim, qdim // 2)

    @property
    def dtype(self) -> torch.dtype:
        return self.soa_embed.dtype

    def normalize_latents(self, latents: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        mean = _as_stat(c.latent_mean, c.latent_dim, latents.device)
        std = _as_stat(c.latent_std, c.latent_dim, latents.device)
        return ((latents - mean) / std).to(self.dtype)

    def denormalize_latents(self, latents: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        mean = _as_stat(c.latent_mean, c.latent_dim, latents.device)
        std = _as_stat(c.latent_std, c.latent_dim, latents.device)
        return latents.float() * std + mean

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embed(ids)

    def _llm_encode(self, inputs_embeds, attention_mask):
        pos_ids = (attention_mask.long().cumsum(-1) - 1).clamp_min(0)
        return self.llm(inputs_embeds, attention_mask=attention_mask,
                        position_ids=pos_ids)

    def encode_text_for_tts(self, text_ids: torch.Tensor,
                            attention_mask: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """[text, SOA] through the LLM -> (condition_vec [B, 1, D],
        text_context [B, T, D], text_pad_mask [B, T] True = PAD)."""
        B = text_ids.shape[0]
        text_embeds = self.embed_tokens(text_ids).to(self.dtype)
        soa = self.soa_embed.expand(B, 1, -1)
        inp = torch.cat([text_embeds, soa], dim=1)
        full_mask = torch.cat(
            [attention_mask, torch.ones_like(attention_mask[:, :1])], dim=1)
        hidden = self._llm_encode(inp, full_mask)
        return hidden[:, -1:, :], hidden[:, :-1, :], attention_mask == 0

    def predict_length(self, text_ctx: torch.Tensor,
                       text_pad: torch.Tensor) -> torch.Tensor:
        """Clamped frame-count prediction [B], fp32."""
        valid_f = (~text_pad).float()
        text_mean = (text_ctx.float() * valid_f[:, :, None]).sum(dim=1) / \
            valid_f.sum(dim=1, keepdim=True).clamp_min(1.0)
        len_pred = self.tts_len_predictor(text_mean.to(self.dtype)).float()
        text_len = valid_f.sum(dim=1)
        min_f = torch.clamp_min(text_len * 2.0, 10.0)
        max_f = torch.clamp_max(text_len * 12.0, float(self.cfg.max_audio_len))
        return torch.minimum(torch.maximum(len_pred, min_f), max_f)

    def predict_durations(self, text_ctx: torch.Tensor, text_pad: torch.Tensor,
                          num_frames: torch.Tensor) -> torch.Tensor:
        """softplus durations scaled to num_frames [B], fp32."""
        dur_raw = self.tts_dur_predictor(text_ctx).float()
        dur = torch.logaddexp(dur_raw, torch.zeros_like(dur_raw)) + 1e-4
        dur = torch.where(text_pad, torch.zeros_like(dur), dur)
        dsum = dur.sum(dim=1, keepdim=True).clamp_min(1e-4)
        return dur * (num_frames[:, None].float() / dsum)

    def tts_flow_fn(self, condition, x, t, context, context_mask, x_mask):
        return self.tts_flow_head(condition, x, t, context=context,
                                  context_mask=context_mask, x_mask=x_mask)

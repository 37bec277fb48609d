"""QwenCALM (counterpart of audio_calm_tpu/models/calm.py).

TTS: the Qwen2 backbone (+LoRA) encodes [text | SOA]; the length and
duration predictors size the audio; the DiT flow head is the ODE's velocity
field. ASR: [audio | SOA | prompt] through the same backbone, positional
queries cross-attend to the audio positions, a context-free DiT head is
the velocity field over LLM-embedding space, and the nearest vocab rows by
cosine are the token ids. Module names follow the JAX parameter tree
(embed, llm, input_proj, soa_embed, tts_flow_head, tts_len_predictor,
tts_dur_predictor, asr_cross_attn, asr_query_embed, asr_flow_head) so
weights carry across one-to-one (models/convert.py); the ASR modules are
registered after the TTS ones, so the TTS dropout sites keep their
numbers. Training: `forward_tts` and `forward_asr` with the reference's
solo semantics (every row one utterance), `forward_tts_packed` (several
[text | SOA] segments share an LLM row under a block-diagonal mask; dummy
slots drop out of every loss term) and `forward_asr_packed` (several
[audio | SOA | prompt] segments a row; the loss a masked mean over the
valid label positions, whose count it returns as `loss_den`).

The model computes in `compute_dtype` (default: the dtype of its weights;
fp32 for the parity tests, bf16 for serving and training) and casts its
weights at use, with fp32 norms, softmax, predictor outputs and
denormalized latents as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from audio_calm_torch.config import CALMModelConfig
from audio_calm_torch.models.calm_heads import (AudioInputProjector,
                                                PredictorMLP,
                                                TransformerFlowHead)
from audio_calm_torch.models.layers import Embed
from audio_calm_torch.models.qwen2 import Qwen2Embed, Qwen2Model
from audio_calm_torch.ops.attention import MultiheadAttention
from audio_calm_torch.ops.dropout import assign_dropout_sites
from audio_calm_torch.ops.flow import compute_flow_loss
from audio_calm_torch.ops.mas import monotonic_alignment_search


def _as_stat(x, dim: int, device) -> torch.Tensor:
    """Scalar or [D] normalization stat -> broadcastable [1, 1, D or 1]."""
    arr = torch.as_tensor(x, dtype=torch.float32, device=device)
    if arr.ndim == 1:
        if arr.shape[0] != dim:
            raise ValueError(f"latent stat has {arr.shape[0]} entries, "
                             f"expected {dim}")
        return arr[None, None, :]
    return arr.reshape(1, 1, 1)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """F.smooth_l1_loss (beta=1), mean reduction, written as JAX's."""
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


class QwenCALM(nn.Module):
    def __init__(self, cfg: CALMModelConfig,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        qdim = cfg.qwen.hidden_size
        self.embed = Qwen2Embed(cfg.qwen)
        self.llm = Qwen2Model(cfg.qwen, lora=cfg.lora if cfg.use_lora else None,
                              remat_policy=cfg.remat_policy)
        self.input_proj = AudioInputProjector(cfg.latent_dim, qdim)
        self.soa_embed = nn.Parameter(torch.zeros(1, 1, qdim))
        self.tts_flow_head = TransformerFlowHead(
            input_dim=qdim, output_dim=cfg.latent_dim,
            hidden_dim=cfg.tts_flow_hidden_dim,
            num_layers=cfg.tts_flow_num_layers,
            num_heads=cfg.flow_num_heads, context_dim=qdim,
        )
        self.tts_len_predictor = PredictorMLP(qdim, qdim // 2)
        self.tts_dur_predictor = PredictorMLP(qdim, qdim // 2)
        # ASR branch (after the TTS modules: see the module docstring)
        self.asr_cross_attn = MultiheadAttention(qdim, 16, dropout=0.1)
        self.asr_query_embed = Embed(cfg.max_text_len, qdim)
        self.asr_flow_head = TransformerFlowHead(
            input_dim=qdim, output_dim=qdim,
            hidden_dim=cfg.asr_flow_hidden_dim,
            num_layers=cfg.asr_flow_num_layers,
            num_heads=cfg.flow_num_heads, context_dim=None,
        )
        assign_dropout_sites(self)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.compute_dtype or self.soa_embed.dtype

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

    def search_nearest_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Cosine-nearest vocab ids for continuous embeddings [..., Q, D]:
        both sides L2-normalised in fp32, a [Q, D] @ [D, V] product for
        each leading item, argmax (JAX computes it outside any kernel; here
        torch.matmul, in full fp32 under PyTorch's default, TF32 off for
        matmuls). One product an item: cuBLAS picks its kernel by the row
        count, so an item's ids do not depend on its batch."""
        xn = x.float()
        xn = xn / torch.linalg.vector_norm(
            xn, dim=-1, keepdim=True).clamp_min(1e-12)
        tn = self.embed.embedding.float()
        tn = (tn / torch.linalg.vector_norm(
            tn, dim=-1, keepdim=True).clamp_min(1e-12)).t()
        if xn.dim() < 3:
            return torch.argmax(torch.matmul(xn, tn), dim=-1)
        items = xn.reshape(-1, *xn.shape[-2:])
        return torch.stack([torch.argmax(torch.matmul(xi, tn), dim=-1)
                            for xi in items]).reshape(xn.shape[:-1])

    def _llm_encode(self, inputs_embeds, attention_mask, train=False, seed=0):
        pos_ids = (attention_mask.long().cumsum(-1) - 1).clamp_min(0)
        return self.llm(inputs_embeds, attention_mask=attention_mask,
                        position_ids=pos_ids, train=train, seed=seed)

    def encode_text_for_tts(self, text_ids: torch.Tensor,
                            attention_mask: torch.Tensor, train: bool = False,
                            seed: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """[text, SOA] through the LLM -> (condition_vec [B, 1, D],
        text_context [B, T, D], text_pad_mask [B, T] True = PAD)."""
        B = text_ids.shape[0]
        text_embeds = self.embed_tokens(text_ids).to(self.dtype)
        soa = self.soa_embed.to(self.dtype).expand(B, 1, -1)
        inp = torch.cat([text_embeds, soa], dim=1)
        full_mask = torch.cat(
            [attention_mask, torch.ones_like(attention_mask[:, :1])], dim=1)
        hidden = self._llm_encode(inp, full_mask, train, seed)
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

    def asr_flow_fn(self, condition, x, t, context=None, context_mask=None,
                    x_mask=None):
        return self.asr_flow_head(condition, x, t, x_mask=x_mask)

    def asr_encode_audio(self, latents: torch.Tensor,
                         audio_mask: torch.Tensor, prompt_ids: torch.Tensor,
                         prompt_mask: torch.Tensor,
                         num_queries: int) -> torch.Tensor:
        """Raw latents [B, T_aud, latent_dim] + mask, prompt ids + mask ->
        [audio | SOA | prompt] through the LLM, then positional queries
        clip(arange(num_queries), 0, max_text_len - 1) cross-attend to the
        audio positions -> condition [B, num_queries, D]."""
        c = self.cfg
        gt = self.normalize_latents(latents)
        B, T_aud, _ = gt.shape
        audio_embeds = self.input_proj(gt).to(self.dtype)
        soa = self.soa_embed.to(self.dtype).expand(B, 1, -1)
        prompt_embeds = self.embed_tokens(prompt_ids).to(self.dtype)
        inp = torch.cat([audio_embeds, soa, prompt_embeds], dim=1)
        audio_mask = audio_mask.long()
        full_mask = torch.cat([audio_mask, torch.ones_like(audio_mask[:, :1]),
                               prompt_mask.long()], dim=1)
        hidden = self._llm_encode(inp, full_mask)
        audio_context = hidden[:, :T_aud, :]
        pos = torch.arange(num_queries, device=gt.device).clamp(
            0, c.max_text_len - 1)
        queries = self.asr_query_embed(pos)[None].to(self.dtype).expand(
            B, -1, -1)
        return self.asr_cross_attn(queries, audio_context, audio_context,
                                   key_padding_mask=audio_mask == 0)

    # ------------------------------------------------------------------
    # TTS training (JAX calm.py:170-312, solo semantics: real=None)
    # ------------------------------------------------------------------
    def forward_tts(self, text_ids: torch.Tensor, attention_mask: torch.Tensor,
                    latents: torch.Tensor, audio_mask: torch.Tensor,
                    train: bool = True,
                    generator: Optional[torch.Generator] = None,
                    seed: int = 0, t: Optional[torch.Tensor] = None,
                    x0: Optional[torch.Tensor] = None,
                    drop: Optional[torch.Tensor] = None, dens=None
                    ) -> Dict[str, torch.Tensor]:
        """text ids [B, T_txt] + mask, raw latents [B, T_aud, latent_dim] +
        mask -> {loss, loss_tts, loss_len, loss_dur}. `generator` draws the
        flow loss's noise (t, x0 and the CFG drop may be passed in instead);
        `seed` fixes the dropout masks (LoRA and DiT attention) when
        train=True. dens: (row count, valid frame count) of a larger batch
        these rows belong to (a data-parallel rank's share): each term is
        then these rows' sum over those denominators (and `loss_den` is
        added), so that the ranks' terms sum to the whole batch's."""
        gt = self.normalize_latents(latents)
        cond_vec, text_ctx, text_pad = self.encode_text_for_tts(
            text_ids, attention_mask, train, seed)
        real = None if dens is None else torch.ones(
            gt.shape[0], dtype=torch.bool, device=gt.device)
        return self._tts_condition_and_loss(
            cond_vec, text_ctx, text_pad, gt, audio_mask.bool(), train,
            generator, seed, t, x0, drop, real=real, dens=dens)

    def _tts_condition_and_loss(self, cond_vec, text_ctx, text_pad, gt,
                                tgt_mask, train, generator, seed, t=None,
                                x0=None, drop=None, real=None, dens=None
                                ) -> Dict[str, torch.Tensor]:
        """MAS + len/dur predictors + flow loss on the LLM outputs.

        real=None: the reference's solo semantics (every row one utterance,
        each term a plain mean). real [B] bool (packed batches, with dummy
        slots): each term a masked sum over real rows over `dens`, the
        (slot count, valid frame count) of the full batch, so that
        microbatch slices sum to the full batch's loss; dens=None takes
        them from this batch. Adds `loss_den`, the real row count."""
        c = self.cfg
        T_aud = gt.shape[1]

        # length prediction
        valid_f = (~text_pad).float()
        text_mean = (text_ctx.float() * valid_f[:, :, None]).sum(dim=1) / \
            valid_f.sum(dim=1, keepdim=True).clamp_min(1.0)
        len_pred = self.tts_len_predictor(text_mean.to(self.dtype)).float()
        gt_len = tgt_mask.float().sum(dim=1)
        text_len = valid_f.sum(dim=1)
        min_f = torch.clamp_min(text_len * 2.0, 10.0)
        max_f = torch.clamp_max(text_len * 12.0, float(c.max_audio_len))
        len_pred_c = torch.minimum(torch.maximum(len_pred, min_f), max_f)
        if real is None:
            len_loss = smooth_l1(torch.log1p(len_pred_c), torch.log1p(gt_len))
        else:
            real_f = real.float()
            d = (torch.log1p(len_pred_c) - torch.log1p(gt_len)).abs()
            len_num = (torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
                       * real_f).sum()

        # MAS duration targets, without gradient (JAX: stop_gradient); the
        # similarity in fp32 after L2 normalisation, as JAX computes it
        with torch.no_grad():
            audio = self.input_proj(gt).float()
            tn = text_ctx.float()
            tn = tn / torch.linalg.vector_norm(
                tn, dim=-1, keepdim=True).clamp_min(1e-12)
            an = audio / torch.linalg.vector_norm(
                audio, dim=-1, keepdim=True).clamp_min(1e-12)
            sim = torch.einsum("bnd,btd->bnt", tn, an)
            sim = sim.masked_fill(text_pad[:, :, None], -1e9)
            sim = sim.masked_fill(~tgt_mask[:, None, :], -1e9)
            align_gt = monotonic_alignment_search(
                torch.log_softmax(sim, dim=1))
        gt_dur = align_gt.sum(dim=-1)

        # duration prediction
        dur_raw = self.tts_dur_predictor(text_ctx).float()
        dur_pred = torch.logaddexp(dur_raw, torch.zeros_like(dur_raw)) + 1e-4
        dur_pred = torch.where(text_pad, 0.0, dur_pred)
        dur_sum = dur_pred.sum(dim=1, keepdim=True).clamp_min(1e-4)
        dur_scaled = dur_pred * (T_aud / dur_sum)
        dur_abs = (torch.log1p(dur_scaled * valid_f)
                   - torch.log1p(gt_dur * valid_f)).abs()
        if real is None:
            dur_loss = dur_abs.mean()
        else:
            dur_num = (dur_abs * real_f[:, None]).sum()

        # condition + flow loss (teacher-forced MAS alignment)
        aligned = torch.einsum("bnt,bnd->btd", align_gt.to(text_ctx.dtype),
                               text_ctx)
        condition = (aligned + cond_vec) * tgt_mask[:, :, None].to(
            text_ctx.dtype)
        target = gt * tgt_mask[:, :, None].to(gt.dtype)

        def head_fn(cond, x, t_, ctx, cmask, xmask):
            return self.tts_flow_head(cond, x, t_, context=ctx,
                                      context_mask=cmask, x_mask=xmask,
                                      train=train, seed=seed)

        tts_loss = compute_flow_loss(
            head_fn, generator, condition, target, tgt_mask,
            cfg_dropout_prob=c.cfg_dropout_prob if train else 0.0,
            context=text_ctx, context_mask=text_pad, train=train,
            t=t, x0=x0, drop=drop)
        out: Dict[str, torch.Tensor] = {}
        if real is not None:
            # dummy slots have no frames, so the flow loss's masked mean
            # already leaves them out: rescale its local denominator to the
            # global one
            frames = tgt_mask.float().sum()
            n_real = real_f.sum()
            if dens is None:
                den_slots, den_frames = n_real.clamp_min(1.0), \
                    frames.clamp_min(1.0)
            else:
                den_slots, den_frames = dens
            tts_loss = tts_loss * (frames / den_frames)
            len_loss = len_num / den_slots
            dur_loss = dur_num / (den_slots * float(text_pad.shape[1]))
            out["loss_den"] = n_real
        loss = (tts_loss * c.tts_loss_weight + len_loss * c.len_pred_loss_weight
                + dur_loss * c.dur_pred_loss_weight)
        out.update(loss=loss, loss_tts=tts_loss, loss_len=len_loss,
                   loss_dur=dur_loss)
        return out

    def forward_tts_packed(self, latents: torch.Tensor,
                           audio_mask: torch.Tensor, text_mask: torch.Tensor,
                           tok_ids: torch.Tensor, kind: torch.Tensor,
                           segment_ids: torch.Tensor,
                           position_ids: torch.Tensor, ctx_idx: torch.Tensor,
                           soa_idx: torch.Tensor, global_den=None,
                           train: bool = True,
                           generator: Optional[torch.Generator] = None,
                           seed: int = 0, t: Optional[torch.Tensor] = None,
                           x0: Optional[torch.Tensor] = None,
                           drop: Optional[torch.Tensor] = None
                           ) -> Dict[str, torch.Tensor]:
        """Packed TTS training (JAX calm.py:314-373; the batch layout is
        data/collator.pack_tts_window's): per-slot raw latents [R, S, T_aud,
        D] + mask, text mask [R, S, T_txt]; per row the text ids, `kind`
        (0 pad / 1 text / 2 SOA), segment ids (0 = pad), positions within
        the segment; `ctx_idx` [R, S, T_txt] and `soa_idx` [R, S] index the
        row's hidden states plus one zero column (T_pack). The LLM sees only
        real tokens; each utterance's text states and SOA condition are
        gathered back for the per-utterance MAS / duration / flow tail, on
        R x S rows in slot order. global_den: the full batch's (slot count,
        frame count), fp32 scalars. Draws as in forward_tts (t, x0, drop on
        the R x S rows)."""
        R, S, T_aud, D = latents.shape
        T_txt = text_mask.shape[-1]
        H = self.cfg.qwen.hidden_size
        gt = self.normalize_latents(latents.reshape(R * S, T_aud, D))
        tok = self.embed_tokens(tok_ids).to(self.dtype)
        soa = self.soa_embed.to(self.dtype)
        kindb = kind[..., None]
        inp = (torch.where(kindb == 1, tok, torch.zeros_like(tok))
               + torch.where(kindb == 2, soa, torch.zeros_like(soa)))
        hidden = self.llm(inp, attention_mask=(kind != 0).int(),
                          position_ids=position_ids, train=train, seed=seed,
                          segment_ids=segment_ids)
        hflat = torch.cat([hidden, hidden.new_zeros(R, 1, H)], dim=1)
        text_ctx = torch.gather(
            hflat, 1, ctx_idx.reshape(R, S * T_txt, 1).long().expand(
                -1, -1, H)).reshape(R * S, T_txt, H)
        cond_vec = torch.gather(
            hflat, 1, soa_idx.reshape(R, S, 1).long().expand(-1, -1, H)
        ).reshape(R * S, 1, H)
        flat_text = text_mask.reshape(R * S, T_txt)
        return self._tts_condition_and_loss(
            cond_vec, text_ctx, flat_text == 0, gt,
            audio_mask.reshape(R * S, T_aud).bool(), train, generator, seed,
            t, x0, drop, real=flat_text.any(dim=-1), dens=global_den)

    # ------------------------------------------------------------------
    # ASR training (JAX calm.py:375-528)
    # ------------------------------------------------------------------
    def forward_asr(self, text_ids: torch.Tensor,
                    attention_mask: torch.Tensor, latents: torch.Tensor,
                    audio_mask: torch.Tensor, labels: torch.Tensor,
                    train: bool = True,
                    generator: Optional[torch.Generator] = None,
                    seed: int = 0, t: Optional[torch.Tensor] = None,
                    x0: Optional[torch.Tensor] = None,
                    drop: Optional[torch.Tensor] = None, den=None
                    ) -> Dict[str, torch.Tensor]:
        """prompt ids [B, T_txt] + mask, raw latents [B, T_aud, latent_dim]
        + mask, target ids [B, T_text] (-100 = ignore) -> {loss, loss_asr,
        loss_den}: [audio | SOA | prompt] through the LLM, then the
        per-utterance tail on the audio positions. Draws as in
        forward_tts; `den` as in _asr_condition_and_loss."""
        gt = self.normalize_latents(latents)
        B, T_aud, _ = gt.shape
        audio_embeds = self.input_proj(gt).to(self.dtype)
        text_embeds = self.embed_tokens(text_ids).to(self.dtype)
        soa = self.soa_embed.to(self.dtype).expand(B, 1, -1)
        inp = torch.cat([audio_embeds, soa, text_embeds], dim=1)
        audio_mask = audio_mask.int()
        full_mask = torch.cat([audio_mask, torch.ones_like(audio_mask[:, :1]),
                               attention_mask.int()], dim=1)
        hidden = self._llm_encode(inp, full_mask, train, seed)
        return self._asr_condition_and_loss(
            hidden[:, :T_aud], audio_mask, labels, train, generator, seed, t,
            x0, drop, den)

    def _asr_condition_and_loss(self, audio_context, audio_mask, labels,
                                train, generator, seed, t=None, x0=None,
                                drop=None, den=None
                                ) -> Dict[str, torch.Tensor]:
        """Positional-query cross-attention + flow loss on the LLM's audio
        states [B, T_ctx, D] (mask [B, T_ctx], 1 = valid): the queries
        clip(arange(T_text), 0, max_text_len - 1), the condition and the
        target (the label embeddings) zeroed past the labels, the flow
        loss over the valid label positions, whose count is `loss_den`.
        den: the valid count of a larger batch these rows belong to (a
        data-parallel rank's share); the loss is then these rows' sum over
        it."""
        c = self.cfg
        B, T_text = labels.shape
        valid = labels != -100
        target_embs = self.embed_tokens(torch.where(valid, labels, 0))
        pos = torch.arange(T_text, device=labels.device).clamp(
            0, c.max_text_len - 1)
        queries = self.asr_query_embed(pos)[None].to(self.dtype).expand(
            B, -1, -1)
        attn_out = self.asr_cross_attn(queries, audio_context, audio_context,
                                       key_padding_mask=audio_mask == 0,
                                       train=train, seed=seed)
        condition = attn_out * valid[:, :, None].to(attn_out.dtype)
        target = target_embs.to(self.dtype) * valid[:, :, None].to(self.dtype)

        def head_fn(cond, x, t_, ctx, cmask, xmask):
            return self.asr_flow_head(cond, x, t_, x_mask=xmask, train=train,
                                      seed=seed)

        asr_loss = compute_flow_loss(
            head_fn, generator, condition, target, valid,
            cfg_dropout_prob=c.cfg_dropout_prob if train else 0.0,
            x_mask=~valid, train=train, t=t, x0=x0, drop=drop)
        n_valid = valid.float().sum()
        if den is not None:
            asr_loss = asr_loss * (n_valid / den)
        return {"loss": asr_loss * c.asr_loss_weight, "loss_asr": asr_loss,
                "loss_den": n_valid}

    def forward_asr_packed(self, latents: torch.Tensor,
                           latent_mask: torch.Tensor, labels: torch.Tensor,
                           tok_ids: torch.Tensor, kind: torch.Tensor,
                           gather_idx: torch.Tensor,
                           segment_ids: torch.Tensor,
                           position_ids: torch.Tensor, ctx_idx: torch.Tensor,
                           train: bool = True,
                           generator: Optional[torch.Generator] = None,
                           seed: int = 0, t: Optional[torch.Tensor] = None,
                           x0: Optional[torch.Tensor] = None,
                           drop: Optional[torch.Tensor] = None, den=None
                           ) -> Dict[str, torch.Tensor]:
        """Packed ASR training (the batch layout is data/collator.
        pack_asr_window's): per-slot raw latents [R, S, L, D] + mask,
        target ids [R, S, T_text]; per row the prompt ids, `kind` (0 pad /
        1 audio / 2 SOA / 3 prompt), `gather_idx` into the row's S x L
        audio embeddings plus one zero column, segment ids (0 = pad),
        positions within the segment; `ctx_idx` [R, S, L] indexes the
        row's hidden states plus one zero column. The projector runs on
        the per-slot layout (its causal convs never cross segments), the
        LLM on the packed rows with segment ids (the plain masked
        attention), and each utterance's audio states are gathered back
        for the tail, on R x S rows in slot order. Draws as in forward_tts
        (t, x0, drop on the R x S rows)."""
        R, S, L, D = latents.shape
        H = self.cfg.qwen.hidden_size
        gt = self.normalize_latents(latents.reshape(R * S, L, D))
        flat = self.input_proj(gt).to(self.dtype).reshape(R, S * L, H)
        flat = torch.cat([flat, flat.new_zeros(R, 1, H)], dim=1)
        audio_part = torch.gather(
            flat, 1, gather_idx.long()[..., None].expand(-1, -1, H))
        tok = self.embed_tokens(tok_ids).to(self.dtype)
        soa = self.soa_embed.to(self.dtype)
        kindb = kind[..., None]
        inp = (torch.where(kindb == 1, audio_part,
                           torch.zeros_like(audio_part))
               + torch.where(kindb == 2, soa, torch.zeros_like(soa))
               + torch.where(kindb == 3, tok, torch.zeros_like(tok)))
        hidden = self.llm(inp, attention_mask=(kind != 0).int(),
                          position_ids=position_ids, train=train, seed=seed,
                          segment_ids=segment_ids)
        hflat = torch.cat([hidden, hidden.new_zeros(R, 1, H)], dim=1)
        ctx = torch.gather(hflat, 1, ctx_idx.reshape(R, S * L, 1).long()
                           .expand(-1, -1, H))
        return self._asr_condition_and_loss(
            ctx.reshape(R * S, L, H), latent_mask.reshape(R * S, L),
            labels.reshape(R * S, labels.shape[-1]), train, generator, seed,
            t, x0, drop, den)


@torch.no_grad()
def init_layers_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Flax's default initializers for every Dense, LoRA, conv and norm
    under `module`, drawn from `gen` in module order: Dense and conv
    kernels lecun-normal (a normal truncated at 2 sigma, variance 1 /
    fan_in), biases 0; LoRA's A uniform in +-1 / sqrt(fan_in), B 0; norm
    scales 1."""
    from audio_calm_torch.models.calm_heads import CausalConv1d
    from audio_calm_torch.models.layers import Linear
    from audio_calm_torch.models.lora import LoRADense
    from audio_calm_torch.models.qwen2 import RMSNorm

    def lecun_(w: torch.Tensor, fan_in: int) -> None:
        std = (1.0 / fan_in) ** 0.5 / .87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)

    for m in module.modules():
        if isinstance(m, Linear):
            lecun_(m.weight, m.weight.shape[1])
            if m.bias is not None:
                m.bias.zero_()
            if isinstance(m, LoRADense) and m.rank > 0:
                bound = m.weight.shape[1] ** -0.5
                m.lora_a.uniform_(-bound, bound, generator=gen)
                m.lora_b.zero_()
        elif isinstance(m, CausalConv1d):
            lecun_(m.weight, m.weight.shape[1] * m.weight.shape[2])
            m.bias.zero_()
        elif isinstance(m, (RMSNorm, nn.LayerNorm)):
            if m.weight is not None:
                m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    return module


@torch.no_grad()
def init_calm_(model: QwenCALM, seed: int = 0) -> QwenCALM:
    """Fresh training weights from one seeded generator with the JAX
    package's initializers (init_calm_params, flax's defaults):
    `init_layers_` over every layer; the Qwen2 embedding N(0, 0.02), the
    ASR query table N(0, 1 / width) (flax's Embed); the DiT context gates
    and the flow heads' out_proj 0; SOA the mean of the embedding rows
    [min(1000, V // 2), min(2000, V)). The draws are torch's, not JAX's."""
    gen = torch.Generator(model.soa_embed.device).manual_seed(seed)
    init_layers_(model, gen)
    model.embed.embedding.normal_(0.0, 0.02, generator=gen)
    q = model.asr_query_embed.embedding
    q.normal_(0.0, q.shape[1] ** -0.5, generator=gen)
    for head in (model.tts_flow_head, model.asr_flow_head):
        head.out_proj.weight.zero_()
        head.out_proj.bias.zero_()
        for blk in head.blocks:
            if hasattr(blk, "ctx_gate"):
                blk.ctx_gate.zero_()
    table = model.embed.embedding
    v = table.shape[0]
    lo, hi = min(1000, max(v // 2, 0)), min(2000, v)
    model.soa_embed.copy_(table[lo:hi].mean(dim=0).reshape(1, 1, -1))
    return model

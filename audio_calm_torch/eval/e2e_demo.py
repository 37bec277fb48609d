"""End-to-end proof (counterpart of scripts/e2e_demo.py): train the whole
stack from scratch on synthetic tone "words", then synthesize each word and
check its pitch.

    python -m audio_calm_torch.eval.e2e_demo [--steps-vae 400]
        [--steps-calm 600] [--distill-steps 300 --distill-k 4]
        [--write-wavs DIR] [--vocoder CKPT] [--device cpu]

Pipeline: MelFrontend -> AcousticVAE training -> latent extraction ->
QwenCALM TTS training (a tiny LLM with LoRA, MAS duration targets, flow
matching; the LLM's and the DiT's head dim is 24, which the attention
kernels take zero-padded to 32) -> length / duration prediction -> CFG
flow ODE -> VAE decode -> the generated mel's dominant band against the
word's own. Optionally a few-step distilled student (distill_steps > 0,
K = distill_k, cfg baked in) is checked the same way. The corpus, its
mels and the batches come from numpy's generator with the JAX script's
draws; the model weights, training noise and ODE noise are torch's
(JAX's random streams cannot be reproduced). It runs on the card unless
`device="cpu"` is passed. The JAX script's criterion: every word for the
exit code 0; tests/test_e2e_synthesis.py accepts 2 of 3 in both legs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SR = 16000
WORDS = {"A": 300.0, "B": 600.0, "C": 1200.0}
T_TXT, T_AUD = 8, 48
CROP = 24
BAND_TOLERANCE = 4


def utter(words) -> np.ndarray:
    """A tone 0.4 s long per word, concatenated."""
    segs = [0.35 * np.sin(2 * np.pi * WORDS[w] * np.arange(int(0.4 * SR))
                          / SR) for w in words]
    return np.concatenate(segs).astype(np.float32)


def tone_corpus(seed: int = 0, n: int = 48):
    """-> (the numpy generator after the draws, [(text, wav)]): n
    utterances of 1-3 words, drawn as the JAX script draws them; the
    generator goes on to draw the batches."""
    rng = np.random.default_rng(seed)
    keys = list(WORDS)
    corpus = []
    for _ in range(n):
        ws = [keys[rng.integers(0, 3)] for _ in range(rng.integers(1, 4))]
        corpus.append((" ".join(ws), utter(ws)))
    return rng, corpus


def dominant_band(mel: np.ndarray) -> int:
    """The mel bin with the largest mean over time of a log-mel [T, 80]."""
    return int(np.argmax(np.asarray(mel).mean(axis=0)))


def band_matches(mel: np.ndarray, ref_mel: np.ndarray) -> Tuple[bool, int,
                                                                int]:
    """-> (match, generated band, reference band): the dominant bands
    within BAND_TOLERANCE bins."""
    band, ref = dominant_band(mel), dominant_band(ref_mel)
    return abs(band - ref) <= BAND_TOLERANCE, band, ref


def vae_batch(rng, mels: List[np.ndarray], bs: int = 16) -> np.ndarray:
    """[bs, CROP, 80] random crops, zero-padded (the JAX script's draws)."""
    idx = rng.integers(0, len(mels), bs)
    out = np.zeros((bs, CROP, 80), np.float32)
    for j, i in enumerate(idx):
        m = mels[i]
        t0 = rng.integers(0, max(m.shape[0] - CROP, 1))
        seg = m[t0:t0 + CROP]
        out[j, :len(seg)] = seg
    return out


def calm_batch(rng, enc: List[np.ndarray], latents: List[np.ndarray],
               latent_dim: int, bs: int = 16) -> Dict[str, np.ndarray]:
    """One TTS batch of bs random utterances (the JAX script's draws)."""
    idx = rng.integers(0, len(enc), bs)
    ti = np.zeros((bs, T_TXT), np.int32)
    am = np.zeros((bs, T_TXT), np.int32)
    la = np.zeros((bs, T_AUD, latent_dim), np.float32)
    aum = np.zeros((bs, T_AUD), np.int32)
    for j, i in enumerate(idx):
        ids = enc[i]
        ti[j, :len(ids)] = ids
        am[j, :len(ids)] = 1
        ln = latents[i][:T_AUD]
        la[j, :len(ln)] = ln
        aum[j, :len(ln)] = 1
    return dict(text_ids=ti, attention_mask=am, latents=la, audio_mask=aum)


def demo_configs(mel_mean: float, mel_std: float):
    """-> (VAEModelConfig, CALMModelConfig without latent stats): the JAX
    script's geometry."""
    from audio_calm_torch.config import (CALMModelConfig, LoRAConfig,
                                         Qwen2Config, VAEModelConfig)

    vcfg = VAEModelConfig(
        hidden_channels=64, latent_channels=8, norm_num_groups=8,
        ssim_weight=0.3, stft_loss_weight=0.0, kl_weight=1e-4,
        mel_mean=mel_mean, mel_std=mel_std, latent_dropout=0.0)
    ccfg = CALMModelConfig(
        latent_dim=8, max_audio_len=T_AUD, max_text_len=T_TXT,
        tts_flow_hidden_dim=96, tts_flow_num_layers=2,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=Qwen2Config(
            vocab_size=260, hidden_size=96, intermediate_size=192,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=24, rope_theta=10000.0),
        lora=LoRAConfig(rank=4, alpha=8, dropout=0.0), cfg_dropout_prob=0.1)
    return vcfg, ccfg


def _launches():
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_fwd)
    return attention_fwd.launches, attention_bwd.launches


def run_demo(steps_vae: int, steps_calm: int, wav_dir: Optional[str] = None,
             seed: int = 0, vocoder_path: Optional[str] = None,
             distill_steps: int = 0, distill_k: int = 4, device=None,
             stats: Optional[Dict] = None):
    """-> (matched_words, total_words, distilled_matched_or_None).

    distill_steps > 0 adds few-step distillation (train/distill.py) and
    checks every word again with the K = distill_k student (cfg 1.0).
    `stats`, when given, receives each stage's wall seconds, the last
    losses, each word's bands and the attention launches (forward,
    backward) of each stage."""
    from audio_calm_torch import resolve_device
    from audio_calm_torch.config import MelConfig, TrainingConfig
    from audio_calm_torch.data.tokenizer import ByteTokenizer
    from audio_calm_torch.eval.infer import tts_generate_latents
    from audio_calm_torch.models.calm import QwenCALM, init_calm_
    from audio_calm_torch.models.vae import (AcousticVAE, init_vae_,
                                             normalize_mel, pad_to_stride)
    from audio_calm_torch.ops.mel import MelFrontend
    from audio_calm_torch.train.optim import (AdamW, freeze, param_labels,
                                              vae_param_label)
    from audio_calm_torch.train.steps import make_calm_step, make_vae_step

    device = resolve_device(device)
    stats = {} if stats is None else stats
    t00 = time.perf_counter()
    rng, corpus = tone_corpus(seed)
    fe = MelFrontend(MelConfig(), device=device)
    mels = [fe(w[None])[0].cpu().numpy() for _, w in corpus]
    mel_mean = float(np.mean([m.mean() for m in mels]))
    mel_std = float(np.mean([m.std() for m in mels]))
    vcfg, ccfg = demo_configs(mel_mean, mel_std)

    def stage(name, t0, l0):
        if device.type == "cuda":
            torch.cuda.synchronize()
        l1 = _launches()
        stats[f"{name}_s"] = time.perf_counter() - t0
        stats.setdefault("launches", {})[name] = [b - a for a, b in
                                                 zip(l0, l1)]
        return time.perf_counter(), l1

    # ---- stage 1: VAE training
    t0, l0 = time.perf_counter(), _launches()
    with torch.device(device):
        vae = AcousticVAE(vcfg)
    init_vae_(vae, seed=seed)
    vopt = AdamW(dict(vae.named_parameters()),
                 param_labels(vae, vae_param_label),
                 TrainingConfig(learning_rate=2e-3, warmup_ratio=0.05),
                 steps_vae)
    vstep = make_vae_step(vae, vopt, seed=seed)
    vae.train()
    for _ in range(steps_vae):
        mt = vstep({"mel": torch.as_tensor(vae_batch(rng, mels),
                                           device=device)})
    vae.eval()
    stats["vae_loss"] = float(mt["loss"]) if steps_vae else None
    print(f"[e2e] vae loss {stats['vae_loss']} "
          f"({time.perf_counter() - t00:.0f}s)")
    t0, l0 = stage("vae", t0, l0)

    @torch.no_grad()
    def encode(mel):
        m = normalize_mel(torch.as_tensor(mel[None], device=device), vcfg)
        mu, _ = vae.encode(pad_to_stride(m, vcfg.total_stride))
        return mu[0].cpu().numpy()

    latents = [encode(m) for m in mels]
    lat_all = np.concatenate(latents, 0)
    ccfg.latent_mean, ccfg.latent_std = (float(lat_all.mean()),
                                         float(lat_all.std()))

    # ---- stage 2: CALM TTS training
    tok = ByteTokenizer()
    with torch.device(device):
        calm = QwenCALM(ccfg, compute_dtype=torch.float32)
    init_calm_(calm, seed=seed)
    tcfg = TrainingConfig(learning_rate=2e-3, warmup_ratio=0.05,
                          head_lr_mult=3.0, soa_lr_mult=3.0)
    labels = freeze(calm, tcfg, task_mode="tts")
    params = {n: p for n, p in calm.named_parameters() if p.requires_grad}
    copt = AdamW(params, labels, tcfg, steps_calm)
    cstep = make_calm_step(calm, copt, "tts", seed=seed)
    enc = [np.asarray(tok.encode(t), np.int32)[:T_TXT] for t, _ in corpus]

    def batch_on_device(b):
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    calm.train()
    for _ in range(steps_calm):
        mt = cstep(batch_on_device(calm_batch(rng, enc, latents,
                                              ccfg.latent_dim)))
    calm.eval()
    stats["calm_loss"] = float(mt["loss_tts"]) if steps_calm else None
    print(f"[e2e] calm tts loss {stats['calm_loss']} "
          f"({time.perf_counter() - t00:.0f}s)")
    t0, l0 = stage("calm", t0, l0)

    def check_words(steps: int, cfg_scale: float, tag: str = "") -> int:
        matched = 0
        bands = stats.setdefault("bands", {})
        for w in WORDS:
            ids = torch.as_tensor(np.asarray(tok.encode(w), np.int64)[None],
                                  device=device)
            gen = torch.Generator(device).manual_seed(3)
            lat, nf = tts_generate_latents(
                calm, ids, torch.ones_like(ids), gen, steps=steps,
                cfg_scale=cfg_scale, t_aud=T_AUD, device=device)
            n = max(4, int(nf[0]) // 4 * 4)
            with torch.no_grad():
                mel_n = vae.decode(lat[:, :n].float())
            mel_dn = mel_n[0].cpu().numpy() * mel_std + mel_mean
            ok, band, ref = band_matches(mel_dn, fe(utter([w])[None])[0]
                                         .cpu().numpy())
            matched += ok
            bands[f"{tag}{w}"] = [band, ref]
            print(f"[e2e] {tag}word {w}: gen band {band} vs ref {ref} "
                  f"-> {'OK' if ok else 'MISS'}")
            if wav_dir:
                write_wav(wav_dir, f"{tag.strip('[] ') or 'calm'}_{w}.wav",
                          mel_dn, vocoder_path, device)
        return matched

    matches = check_words(steps=32, cfg_scale=2.0)
    t0, l0 = stage("check", t0, l0)
    if not distill_steps:
        return matches, len(WORDS), None

    # ---- stage 3: few-step distillation, checked on the audio
    from audio_calm_torch.train.distill import (make_distill_step,
                                                split_for_distill)

    teacher, dlabels = split_for_distill(calm, "tts")
    dparams = {n: p for n, p in calm.named_parameters() if p.requires_grad}
    dopt = AdamW(dparams, dlabels,
                 TrainingConfig(learning_rate=1e-3, warmup_ratio=0.05,
                                weight_decay=0.0), distill_steps)
    dstep = make_distill_step(calm, teacher, dopt, "tts",
                              student_steps=distill_k, cfg_scale=2.0,
                              teacher_substeps=8, t_grid=T_AUD, seed=seed)
    for _ in range(distill_steps):
        b = batch_on_device(calm_batch(rng, enc, latents, ccfg.latent_dim))
        dmt = dstep({k: b[k] for k in ("text_ids", "attention_mask")})
    stats["distill_loss"] = float(dmt["loss_distill"])
    print(f"[e2e] distill loss {stats['distill_loss']} "
          f"({time.perf_counter() - t00:.0f}s)")
    t0, l0 = stage("distill", t0, l0)
    student = check_words(steps=distill_k, cfg_scale=1.0,
                          tag=f"[distilled-{distill_k}] ")
    stage("check_distilled", t0, l0)
    return matches, len(WORDS), student


def write_wav(wav_dir: str, name: str, mel: np.ndarray,
              vocoder_path: Optional[str], device) -> str:
    """mel [T, 80] -> a 16-bit 16 kHz WAV through load_vocoder (Griffin-Lim
    without a checkpoint) -> its path."""
    from audio_calm_torch.models.vocoder import load_vocoder
    from audio_calm_torch.serving.server import wav_bytes

    os.makedirs(wav_dir, exist_ok=True)
    voc = load_vocoder(vocoder_path, device=device)
    with torch.no_grad():
        wav = voc(torch.as_tensor(mel[None], device=device))[0]
    path = os.path.join(wav_dir, name)
    with open(path, "wb") as f:
        f.write(wav_bytes(np.clip(wav.float().cpu().numpy(), -1, 1), SR))
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps-vae", type=int, default=400)
    p.add_argument("--steps-calm", type=int, default=600)
    p.add_argument("--write-wavs", default=None, help="dir for generated wavs")
    p.add_argument("--vocoder", default=None,
                   help="HiFi-GAN checkpoint path (default Griffin-Lim)")
    p.add_argument("--distill-steps", type=int, default=0,
                   help="few-step distillation steps (0 = off)")
    p.add_argument("--distill-k", type=int, default=4,
                   help="student ODE step count for --distill-steps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' only "
                        "when asked)")
    args = p.parse_args(argv)
    matches, total, distilled = run_demo(
        args.steps_vae, args.steps_calm, args.write_wavs, seed=args.seed,
        vocoder_path=args.vocoder, distill_steps=args.distill_steps,
        distill_k=args.distill_k, device=args.device)
    print(f"pitch match: {matches}/{total}")
    ok = matches == total
    if distilled is not None:
        print(f"distilled-{args.distill_k} pitch match: {distilled}/{total}")
        ok = ok and distilled == total
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

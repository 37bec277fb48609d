"""Evaluate CALM: ASR WER / CER and TTS synthesis (counterpart of
scripts/eval_calm.py):

    python -m audio_calm_torch.eval.eval_calm --config configs/asr.yaml \\
        [--override evaluation.max_samples=10] [--components <dir>] \\
        [--byte-tokenizer] [--device cpu]

The model: random weights from evaluation.seed, the Qwen2 base from
model.qwen_path when it is a directory (train/checkpoint.
load_qwen2_backbone), the trained components of --components (default
<evaluation.checkpoint_path>/components) through soft_restart, cast to
evaluation.compute_dtype (float32, the reference eval protocol, or
bfloat16, the serving recipe), then int8 LLM projections when
AUDIO_CALM_LLM_WEIGHTS=int8 (models/quant.maybe_quantize_from_env).

evaluation.task "asr" or "mix": each stored latent of the ASR dataset (up
to max_samples) through CALMInference.asr (item i seeded
eval.infer.chunk_seed(evaluation.seed, i), the port's counterpart of JAX's
fold_in), WER / CER against the normalized reference and
`<output_dir>/asr_results.csv` (id, ref, pred, wer, cer). "tts" or "mix":
each text of the TTS dataset through CALMInference.tts on its bucket grid
(item i seeded chunk_seed(seed, 1000 + i)), rendered through the VAE
(model.vae_path, else a seeded random one with a warning) and the vocoder
(evaluation.vocoder_path, else Griffin-Lim; the `vocoder: <class>` line)
into `<output_dir>/tts_wavs/tts_NNNN.wav`. evaluation.eval_asr_model names
an optional round-trip judge (a transformers ASR pipeline); when it cannot
be loaded a warning says so and only the round-trip WER is skipped.
Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.config import CALMConfig, VAEModelConfig, load_config
from audio_calm_torch.data.datasets import load_array, scan_corpus
from audio_calm_torch.data.tokenizer import load_tokenizer
from audio_calm_torch.eval.infer import CALMInference, chunk_seed
from audio_calm_torch.eval.metrics import cer, normalize_text, wer
from audio_calm_torch.eval.render import make_renderer
from audio_calm_torch.models.calm import QwenCALM
from audio_calm_torch.models.flagship import (build_random,
                                              resolve_compute_dtype)
from audio_calm_torch.models.quant import maybe_quantize_from_env
from audio_calm_torch.models.vae import AcousticVAE, load_vae
from audio_calm_torch.models.vocoder import load_vocoder
from audio_calm_torch.train.checkpoint import (COMPONENTS,
                                               load_qwen2_backbone,
                                               soft_restart)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="configs/calm.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--components", default=None,
                   help="components dir (defaults to "
                        "evaluation.checkpoint_path/components)")
    p.add_argument("--byte-tokenizer", action="store_true",
                   help="the byte fallback tokenizer (smoke tests)")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' only "
                        "when asked)")
    return p.parse_args(argv)


def build_model(cfg: CALMConfig, device, components=None) -> QwenCALM:
    """The evaluated model (the module docstring's order) on `device`."""
    m, e = cfg.model, cfg.evaluation
    model = build_random(lambda: QwenCALM(m), device, seed=e.seed)
    if m.qwen_path and os.path.isdir(m.qwen_path):
        load_qwen2_backbone(model, m.qwen_path)
        print("loaded Qwen2 backbone weights")
    if components and os.path.isdir(components):
        soft_restart(model, {c: components for c in COMPONENTS + ("lora",)})
        print(f"loaded components from {components}")
    return maybe_quantize_from_env(
        model.to(resolve_compute_dtype(e.compute_dtype)))


def write_wav(path: str, x: np.ndarray, sr: int = 16000) -> None:
    """float audio -> a 16-bit mono WAV, clipped to [-1, 1]."""
    from audio_calm_torch.serving.server import wav_bytes

    with open(path, "wb") as f:
        f.write(wav_bytes(np.clip(np.asarray(x, np.float32), -1, 1), sr))


def _asr_judge(name):
    """The optional round-trip ASR judge (a transformers pipeline), or None
    with a warning when it cannot be loaded."""
    try:
        from transformers import pipeline as hf_pipeline

        return hf_pipeline("automatic-speech-recognition", model=name)
    except Exception as ex:
        print(f"warning: ASR judge unavailable ({ex}); skipping "
              "round-trip WER")
        return None


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = load_config(args.config, cls=CALMConfig, overrides=args.override)
    m, e = cfg.model, cfg.evaluation
    device = resolve_device(args.device)
    os.makedirs(e.output_dir, exist_ok=True)
    tokenizer = load_tokenizer(m, byte_fallback=args.byte_tokenizer)
    comp_dir = args.components or (
        os.path.join(e.checkpoint_path, "components")
        if e.checkpoint_path else None)
    model = build_model(cfg, device, comp_dir)
    inf = CALMInference(model, tokenizer, audio_buckets=e.audio_buckets,
                        text_buckets=e.text_buckets, device=device)
    ode = dict(method=e.ode_method, time_schedule=e.time_schedule)

    if e.task in ("asr", "mix"):
        src = e.datasets["asr"]
        data = scan_corpus(src.latent_dir, src.subsets, "asr")[:e.max_samples]
        rows, refs, preds = [], [], []
        for i, item in enumerate(data):
            latent = load_array(item["file_path"], expected_dim=m.latent_dim)
            pred = inf.asr(latent, chunk_seed(e.seed, i), steps=e.asr_steps,
                           cfg_scale=e.asr_cfg_scale, **ode)
            r, h = normalize_text(item["text"]), normalize_text(pred)
            refs.append(r or "<empty>")
            preds.append(h)
            rows.append([i, r, h, wer([r or "<empty>"], [h]),
                         cer([r or "<empty>"], [h])])
        out_csv = os.path.join(e.output_dir, "asr_results.csv")
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "ref", "pred", "wer", "cer"])
            w.writerows(rows)
        if refs:
            print(f"ASR WER: {wer(refs, preds):.2%}  CER: "
                  f"{cer(refs, preds):.2%} ({len(refs)} samples) -> "
                  f"{out_csv}")

    if e.task in ("tts", "mix"):
        if m.vae_path and os.path.exists(m.vae_path):
            vae = load_vae(m.vae_path, device=device)
            vae_cfg = vae.cfg
        else:
            print("warning: no VAE checkpoint; using random VAE decoder")
            vae_cfg = VAEModelConfig(latent_channels=m.latent_dim)
            vae = build_random(lambda: AcousticVAE(vae_cfg), device, seed=1)
        vocoder = load_vocoder(e.vocoder_path, device=device)
        print(f"vocoder: {type(vocoder).__name__}")
        render = make_renderer(vae, vae_cfg, vocoder, device=device)
        judge = _asr_judge(e.eval_asr_model) if e.eval_asr_model else None

        src = e.datasets["tts"]
        data = scan_corpus(src.latent_dir, src.subsets, "tts")[:e.max_samples]
        wav_dir = os.path.join(e.output_dir, "tts_wavs")
        os.makedirs(wav_dir, exist_ok=True)
        rt_refs, rt_preds = [], []
        for i, item in enumerate(data):
            latents, n = inf.tts(item["text"], chunk_seed(e.seed, 1000 + i),
                                 steps=e.steps, cfg_scale=e.cfg_scale,
                                 pad_to_grid=True, **ode)
            wav = render(latents, n)
            write_wav(os.path.join(wav_dir, f"tts_{i:04d}.wav"), wav)
            if judge is not None:
                hyp = judge({"array": wav, "sampling_rate": 16000})["text"]
                rt_refs.append(normalize_text(item["text"]) or "<empty>")
                rt_preds.append(normalize_text(hyp))
        print(f"wrote {len(data)} wavs to {wav_dir}")
        if rt_refs:
            print(f"TTS round-trip WER: {wer(rt_refs, rt_preds):.2%}  "
                  f"CER: {cer(rt_refs, rt_preds):.2%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

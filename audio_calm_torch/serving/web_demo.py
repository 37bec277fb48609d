"""Gradio two-tab TTS / ASR demo of the port (counterpart of
scripts/web_demo.py). Needs the optional `gradio` package; without it the
demo says so on stderr and returns 1.

    python -m audio_calm_torch.serving.web_demo --config configs/calm.yaml \\
        --components outputs/checkpoints/omni_flow/components [--device cpu]

The model as the JAX script builds it: seed 0 weights in fp32, the
--components laid over them, cast to evaluation.compute_dtype; a seeded
random VAE and load_vocoder (Griffin-Lim without evaluation.vocoder_path).
The TTS tab runs CALMInference.tts_long_batched through the renderer; the
ASR tab mixes an upload to mono, runs it through the bucketed frontend
(serving/frontend.make_asr_frontend / encode_chunks) and asr_long, so an
upload past the largest latent bucket is cut at quiet points rather than
truncated. Each call takes the next seed of one counter. Runs on the card
unless --device cpu.
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="configs/calm.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--components", default=None)
    p.add_argument("--byte-tokenizer", action="store_true")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' only "
                        "when asked)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import gradio as gr
    except ImportError:
        print("gradio is not installed; the web demo is optional. Use "
              "python -m audio_calm_torch.eval.eval_calm for batch "
              "inference.", file=sys.stderr)
        return 1

    from audio_calm_torch import resolve_device
    from audio_calm_torch.config import (CALMConfig, MelConfig,
                                         VAEModelConfig, load_config)
    from audio_calm_torch.data.tokenizer import load_tokenizer
    from audio_calm_torch.eval.infer import CALMInference
    from audio_calm_torch.eval.render import make_renderer
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.flagship import (build_random,
                                                  resolve_compute_dtype)
    from audio_calm_torch.models.vae import AcousticVAE
    from audio_calm_torch.models.vocoder import load_vocoder
    from audio_calm_torch.serving.frontend import (encode_chunks,
                                                   make_asr_frontend)
    from audio_calm_torch.train.checkpoint import COMPONENTS, soft_restart

    cfg = load_config(args.config, cls=CALMConfig, overrides=args.override)
    m, e = cfg.model, cfg.evaluation
    device = resolve_device(args.device)
    tokenizer = load_tokenizer(m, byte_fallback=args.byte_tokenizer)
    model = build_random(lambda: QwenCALM(m), device, seed=0)
    if args.components:
        soft_restart(model, {c: args.components
                             for c in COMPONENTS + ("lora",)})
    model = model.to(resolve_compute_dtype(e.compute_dtype))
    inf = CALMInference(model, tokenizer, audio_buckets=e.audio_buckets,
                        text_buckets=e.text_buckets, device=device)
    vae_cfg = VAEModelConfig(latent_channels=m.latent_dim)
    vae = build_random(lambda: AcousticVAE(vae_cfg), device, seed=1)
    mel_cfg = MelConfig()
    vocoder = load_vocoder(e.vocoder_path, device=device)
    print(f"vocoder: {type(vocoder).__name__}", file=sys.stderr)
    render = make_renderer(vae, vae_cfg, vocoder, device=device)
    seeds = itertools.count()

    def tts_fn(text, steps, cfg_scale):
        wav = inf.tts_long_batched(
            text, next(seeds), render, steps=int(steps),
            cfg_scale=float(cfg_scale), method=e.ode_method,
            time_schedule=e.time_schedule, crossfade_ms=e.crossfade_ms)
        return 16000, (np.clip(wav, -1, 1) * 32767).astype(np.int16)

    lat_buckets = e.audio_buckets or [m.max_audio_len]
    prep_a, batch_a = make_asr_frontend(vae, vae_cfg, mel_cfg, lat_buckets,
                                        device=device)
    max_asr = lat_buckets[-1] * vae_cfg.total_stride * mel_cfg.hop_length

    def asr_fn(audio, steps):
        sr, wav = audio
        wav = np.asarray(wav, np.float32) / 32768.0
        if wav.ndim == 2:  # mono mix (the frontend peak-normalizes)
            wav = wav.mean(axis=1 if wav.shape[1] <= 2 else 0)
        return inf.asr_long(
            wav, next(seeds), lambda cs: encode_chunks(prep_a, batch_a, cs),
            max_asr, steps=int(steps), method=e.ode_method,
            time_schedule=e.time_schedule)

    with gr.Blocks(title="Audio-CALM (PyTorch)") as demo:
        gr.Markdown("# Audio-CALM — NAR flow-matching TTS / ASR")
        with gr.Tab("TTS"):
            t_in = gr.Textbox(label="Text")
            t_steps = gr.Slider(4, 100, value=e.steps, step=1,
                                label="ODE steps")
            t_cfg = gr.Slider(1.0, 5.0, value=e.cfg_scale, label="CFG scale")
            t_btn = gr.Button("Synthesize")
            t_out = gr.Audio(label="Audio")
            t_btn.click(tts_fn, [t_in, t_steps, t_cfg], t_out)
        with gr.Tab("ASR"):
            a_in = gr.Audio(label="Audio", sources=["upload", "microphone"])
            a_steps = gr.Slider(4, 50, value=e.asr_steps, step=1,
                                label="ODE steps")
            a_btn = gr.Button("Transcribe")
            a_out = gr.Textbox(label="Transcript")
            a_btn.click(asr_fn, [a_in, a_steps], a_out)
    demo.launch(server_port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())

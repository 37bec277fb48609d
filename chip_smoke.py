#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (audio_calm_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes, fp32 and bf16 (the attention backward at the Qwen2
     training shapes of TTS and of plain ASR (461 positions), the DiT
     self- and cross-attention shapes and the ASR head's (d = 48), and a
     causal row of T = S = 1024 past the TPU's 512 gate, two launches
     giving the same bits, the forward also at the ASR path's three shapes
     and at T = S = 1024 and 2048, and the flash_attention Function
     against autograd through the plain forward; the resblock kernel at
     C = 12, 24, 48, 96, 128, 256 and k = 3, 7, 11 with a ragged last tile,
     the sequence edges held on their own; the stage kernel at HiFi-GAN
     V2's C = 16 and C = 8; the batch-invariant product (csrc/gemm.cu) at
     every row of GEMM_ROWS, the served engine's shapes, rows against the
     row launched alone, and under every plan the row takes, repeated
     launches with the first one's bits and the ragged-edge rows with their
     solo bits; the attention forward and backward at head dims they take
     zero-padded, the end-to-end proof's d = 24 and d = 40);
  4. the serving slice at full widths with 2 LLM layers on the 96-frame
     grid, fp32, on the card and on the CPU, same weights and ODE noise;
     then one TTS training step (forward_tts + backward) at full widths
     with 2 LLM layers, fp32, dropouts off, on both, same weights and flow
     noise: loss terms, every trainable gradient, and the card's attention
     kernel launches (Qwen2 and DiT attention both through K4/K5); then
     one packed TTS step (forward_tts_packed: 7 utterances in 2 rows of
     256 tokens x 4 slots, one dummy slot, the 96-frame grid) the same
     way: the Qwen2 rows, which carry segment ids, launch no kernel (the
     plain masked attention on both devices), the DiT K3/K5;
  5. the serving path at full width: the flagship (28-layer Qwen2-1.5B, DiT
     1024x4, VAE, HiFi-GAN V1, random bf16 weights from a seed) serves a
     batch of 2 texts on the 384-frame grid and 1 text on the 192-frame grid
     (125 frames), midpoint-12, cfg 2.5; every kernel's launch count must
     rise as the path requires; per-phase times and the realtime factor;
  5b. the training path at full width: the 28-layer flagship under the
     tts.yaml plain-batch recipe (B=32 in 2 microbatch slices, texts padded
     to 96 + SOA, the 384-frame audio grid, frozen weights bf16, fp32
     masters, bf16 compute, full remat, LoRA and DiT dropout on) takes 5
     steps through run_training; finite metrics, frozen tensors unchanged,
     trainable ones unchanged after the LR-0 first step and changed after
     the second, kernel launches as full remat requires; step time,
     samples/s, MFU (the step's FLOPs counted once before the run by
     train/steps.count_step_flops), peak memory;
  5c. the vocoder layer as the product loads it: weight-normed torch
     checkpoints of two generators made from a seed (odd widths: V1's rates
     with 384 initial channels, whose resblocks at C = 96, 48, 24 take the
     resblock kernel; HiFi-GAN V2, C = 64..8, the stage kernel) go through
     load_vocoder onto the card and are held against the same files loaded
     on the CPU; then make_renderer renders a B=2 batch on the 384-frame
     grid with the flagship VAE through each of them and through the
     Griffin-Lim vocoder the shipped configs use: launch counts, finite
     waveforms of n * 1024 samples, the time of each;
  5d. VAE reconstruction: 8 s of a seeded synthetic signal through the mel
     frontend and eval/reconstruct at the flagship VAE's width, on the card
     and on the CPU, fp32: log-mel, latent means and reconstruction agree;
  5e. ASR at configs/asr.yaml's widths (Qwen2-1.5B widths, heads 768 x 4
     with 16 heads: head dim 48) with 2 LLM layers, fp32, card vs CPU on
     the same weights, latents and ODE noise: the condition, the Euler-20
     ODE's output and the nearest-token ids (margin-aware), and the card's
     attention launches;
  5f. the ASR path at asr.yaml's full width: two seeded wavs (24.576 s and
     15 s) through the bucketed frontend (buckets 96/192/288/384 latent
     frames, the flagship VAE) and encode_chunks, then CALMInference.
     asr_batch (28 layers, random bf16 weights from a seed, Euler-20, cfg
     1, one seed a row): launches, batch rows against solo calls, phase
     walls (frontend, encode, ODE, nearest-token search), the realtime
     factor and one profiled request's device busy share;
  5g. the served product: configs/calm.yaml read by the port's load_config
     (model.vae_path=null) and served by audio_calm_torch.serving.server in
     this process on the card (byte tokenizer, random bf16 weights from a
     seed, Griffin-Lim, a 200 ms batch window), over HTTP: /health, two
     concurrent /tts (one group of 2) twice (equal bytes), the first alone
     (the pair's row equals it: latents bit for bit, audio within 2/32768
     before the last 4096 samples, no module's row 0 differing), a
     long-form /tts (3 chunks or more), a streamed /tts, /asr of 15 s and
     of 40 s (long-form; its chunks batched give every solo call's ids),
     the 40 s again as a chunked streaming upload (held against the
     buffered transcript margin-aware), /stats; each request's attention
     and batch-invariant product launches, groups, wall, audio and
     realtime factor, the streams' time to first audio and first transcript, and one
     profiled session's device busy share and the attention forward's
     device time per instantiation;
  5h. the served product on checkpoint weights: a seeded source model
     (calm.yaml's width, fresh components and LoRA) and VAE written by
     save_reference_checkpoint to a temporary directory; the server's
     load_models at fp32 equals them bit for bit; the bf16 server started
     with --components and model.vae_path answers a seeded /tts and an
     /asr with the bytes and ids of an engine built on the source; with
     AUDIO_CALM_LLM_WEIGHTS=int8 the 196 LLM projections are int8 on the
     card, the hidden state and latents stay within 2e-2 and 0.1 of bf16,
     a /tts and an /asr complete; engine memory and the B=1 encode's
     device time in bf16 and int8, with the card's name and power limit;
  5i. (run after phase 6) the shipped TTS training recipe:
     configs/tts.yaml at full width
     (packed rows, 16 x 256 tokens in 2 slices, length-grouped buckets)
     through `python -m audio_calm_torch.train.train_calm` in this
     process, on a synthetic store written by audio_calm_torch.data.
     synth_corpus (640 utterances, 16 held out, the byte tokenizer):
     2 steps with an eval and a checkpoint at step 2, the train state
     restored bit for bit, a second run resuming from that checkpoint to
     step 6 (evals, checkpoints, best-model retention), finite loss,
     samples/s and MFU in its metrics.jsonl, K3/K4 only in the eval
     forwards; 4 more steps of the recipe's batches timed one by one
     (step time, utterances/s, MFU, peak memory, launches a step); the
     exported components served through build_engine's --components
     equal to the trained tensors;
  5j. (run last, after phase 7's profiles of the served requests and the
     TTS steps) ASR training and the mix: one asr_packed and one plain
     asr step at asr.yaml's widths with 2 LLM layers, fp32, card vs CPU
     (loss terms, every trainable gradient, launches); on a synthetic
     store with both tasks (384 utterances each, 16 held out),
     configs/asr.yaml at full width (packed ASR rows, 16 x 512 tokens in 8
     slices) through train_calm for 3 steps (an eval and checkpoints),
     K3/K4 only in its eval forwards; 4 of its packed steps timed one by
     one (2 of them again in 2 slices), then 4 plain ASR steps (B = 16 in 8 slices, the 384 grid: rows
     of 384 + SOA + the 76-token prompt) on the same model and optimizer,
     K4 and K5 in every Qwen2 layer of every slice; configs/calm.yaml (the
     mix, one optimizer over packed ASR at k = 8 and packed TTS at k = 2)
     for 4 steps that take both tasks, an eval over both, its components
     served through --components equal to the trained tensors, each
     task's steps timed one by one;
  5k. (run last, after 5j and its profiles) VAE training and few-step
     distillation: one VAE step and one TTS distillation step on tiny
     models, fp32, card vs CPU (loss terms, every gradient, the
     distillation step's launches); a seeded mel store (harmonic tones
     and noise through the port's log-mel frontend) and configs/vae.yaml
     at full width (B = 256 crops of 256) through `python -m
     audio_calm_torch.train.train_vae` for 3 steps (an eval, checkpoints,
     the exported vae.bin loaded back by load_vae), 4 of its steps timed
     one by one; configs/tts.yaml (B = 32) and configs/asr.yaml (B = 16)
     through `python -m audio_calm_torch.train.distill_calm` (a seeded
     random teacher, its head perturbed; K = 4, M = 8, cfg 2.5 / 3.0) for
     2 steps each: the run's attention launches as its steps and quality
     probe need, the components served through --components equal to the
     trained tensors, 4 steps timed one by one with K4 / K3 / K5 launches
     asserted; one step of each profiled (a lead step first);
  5l. (run last) data preparation and the end-to-end proof: a seeded
     corpus of 96 LibriSpeech-layout WAVs of 1.5-35 s (every bucket of
     the processor) through `python -m audio_calm_torch.data.
     process_dataset`'s main, mel-only and through a seeded configs/
     vae.yaml VAE exported by train_vae (files/s, seconds of audio a
     second), 4 files' latents in fp32 against the same VAE on the CPU,
     compute_stats and --stats, the store as reference .pt payloads
     through convert_store, read back by CalmDataset; then
     eval/e2e_demo.run_demo at the JAX script's counts (VAE 400, CALM 600,
     distillation 300 steps, K = 4; head dim 24 through the padded
     attention kernels): at least 2 of 3 words in both legs, each
     stage's wall and attention launches; then the batch-invariant
     products' cost against cuBLAS, in turns: the served pair's group
     (wall, device ms), its B = 1 encode and the flagship's ODE (device
     ms);
  6. per kernel: its launches on its main path, its device time per launch
     at main-path shapes, the bound, the plain version's and the library
     call's device time (the batch-invariant product: at GEMM_ROWS, its
     launches those of phase 5g's session, cuBLAS its library call, and on
     each row's log line the plan's reduction and grid and the earlier
     design's time quoted from PERF.md, GEMM_EARLIER_MS); for the stage
     kernel, per V1 stage on a log line
     (not in the `kernels` line), the tile, the executed/useful product
     ratio and the L2 weight bytes its tile plan reckons, beside the
     earlier three-buffer design's time quoted from PERF.md; the attention
     forward at every row of tools/attention_probe.ROWS (the flagship's,
     calm.yaml's and asr.yaml's served shapes, T = S = 1024 and 2048;
     phase 5f holds the ASR rows to its request's shapes) through
     attention_probe.time_row: held against its plain version, device
     time beside SDPA's and the bound, the host time of a call, on a log
     line the earlier design's time quoted from PERF.md (K3_EARLIER_MS),
     and each row of a B=4 launch against the same row launched alone,
     bit for bit; the resblock kernel at the odd-width render's 9 shapes
     and V1's C = 128 and 256 through tools/resblock_probe.time_shape on
     the generators' weights: the kernel alone and the whole wrapper call,
     the plain version and the bound, and on each shape's log line the
     plan (tile, window, ring stages, N split) and the earlier design's
     time quoted from PERF.md (K6_EARLIER_MS);
  7. the served requests once more under torch.profiler (device activity
     only): the device's busy share, the kernels that take most time and
     the stage kernel's device time;
     then one more training step, the same way, with K5's share of it,
     and one more packed TTS step (its busy share); after phase 5j, one
     more packed ASR and plain ASR step the same way. Phase 6 times the
     attention backward also at the distillation students' shapes.
Then the card, one `kernels` JSON line, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from audio_calm_torch.tools.attention_probe import (ROWS, attn_cost,
                                                    row_inputs, time_row)
from audio_calm_torch.tools.gemm_probe import ROWS as GEMM_ROWS
from audio_calm_torch.tools.gemm_probe import inputs as gemm_inputs
from audio_calm_torch.tools.gemm_probe import repeat_row as gemm_repeat_row
from audio_calm_torch.tools.profiler_probe import (H100_BYTES_PER_S, bound_ms,
                                                   device_ms, device_profile)

# the batch-invariant product's earlier design (an mma.sync kernel on a
# cp.async ring, one 64 x 128 tile) at GEMM_ROWS, label -> device ms a
# launch: PERF.md section 6, that design's final check
GEMM_EARLIER_MS = {
    "Qwen2 q/o, /tts pair": 0.0190, "Qwen2 k/v, /tts pair": 0.0290,
    "Qwen2 gate/up, /tts pair": 0.0496, "Qwen2 down, /tts pair": 0.0500,
    "LoRA A, /tts pair": 0.0254, "LoRA B, /tts pair": 0.0059,
    "DiT q/k/v/o, /tts pair": 0.0182, "DiT mlp_fc1, /tts pair": 0.0339,
    "DiT mlp_fc2, /tts pair": 0.0494, "Qwen2 down, /asr B=2": 0.1707,
}
SEC_PER_FRAME = 4 * 256 / 16000  # one latent frame = 1024 samples at 16 kHz
# the stage kernel's earlier design (three shared buffers, weights streamed
# per warp from L2) at V1's three stages, B=2 on the 384-frame grid: PERF.md
# section 6, kernel table, run C
K1_THREE_BUFFER_MS = {1: 5.321, 2: 3.622, 3: 2.368}
# the attention forward's earlier design (mma.sync, a cp.async double
# buffer, every causal key tile, T and S <= 512) at the rows of
# tools/attention_probe.ROWS, device ms per launch: PERF.md section 6, run P
# (the earlier design measured before the redesign)
K3_EARLIER_MS = {
    "flagship Qwen2 encode": 0.005128,
    "flagship DiT self": 0.019130,
    "flagship DiT cross": 0.006164,
    "TTS DiT self d=48 T=96 B=2": 0.004988,
    "TTS DiT self d=48 T=96 B=4": 0.005141,
    "TTS DiT self d=48 T=192 B=2": 0.006845,
    "TTS DiT self d=48 T=192 B=4": 0.008375,
    "TTS DiT self d=48 T=384 B=2": 0.013998,
    "TTS DiT self d=48 T=384 B=4": 0.017357,
    "TTS DiT cross d=48 T=384 S=64 B=2": 0.004670,
    "TTS DiT cross d=48 T=384 S=64 B=4": 0.006231,
    "Qwen2 encode 33 B=1": 0.005311,
    "Qwen2 encode 65 B=1": 0.008967,
    "Qwen2 encode 97 B=1": 0.009072,
    "Qwen2 encode 65 B=2": 0.009133,
    "ASR Qwen2 encode L=461": 0.033552,
    "ASR cross d=96": 0.015127,
    "ASR DiT self d=48": 0.005034,
}
# the resblock kernel's earlier design (mma.sync on 32-channel
# granules, weights read from L2 per warp, the residual in device memory
# above C = 64) at tools/resblock_probe.SHAPES, (label, k) -> device ms a
# launch of the kernel alone: PERF.md section 6, run U14 (the probe's
# --old-csrc timing, in one process with the redesign)
K6_EARLIER_MS = {
    ("odd-width C=96", 3): 0.9155, ("odd-width C=96", 7): 1.7985,
    ("odd-width C=96", 11): 2.5715,
    ("odd-width C=48", 3): 0.7275, ("odd-width C=48", 7): 1.4873,
    ("odd-width C=48", 11): 2.2365,
    ("odd-width C=24", 3): 0.5713, ("odd-width C=24", 7): 0.9466,
    ("odd-width C=24", 11): 1.2790,
    ("V1 C=128", 3): 1.4346, ("V1 C=128", 7): 2.9338, ("V1 C=128", 11): 4.9345,
    ("V1 C=256", 3): 1.1018, ("V1 C=256", 7): 1.9982, ("V1 C=256", 11): 4.0990,
}
TRAIN_STEPS = 5
# configs/asr.yaml, written out by hand: the card's machine has no YAML
# loader (tests/test_torch_asr_frontend.py holds these against the JAX
# package's load_config); the model in asr_yaml_config below
ASR_BUCKETS = [96, 192, 288, 384]  # data.audio_buckets, latent frames
ASR_ODE = dict(steps=20, method="euler", cfg_scale=1.0)  # reference protocol
ASR_SEEDS = [11, 12]
# the served product: configs/calm.yaml through the port's own load_config
# and HTTP server, with a batch window wide enough that two concurrent
# requests coalesce whatever the threads' timing
SERVE_ARGV = ["--config", "configs/calm.yaml", "--byte-tokenizer", "--port",
              "0", "--override", "model.vae_path=null",
              "--batch-window-ms", "200"]
SERVE_PAIR = [("Hello from the served product.", 101),
              ("A second voice joins in.", 102)]
SERVE_LONG = ("The served product reads long text in chunks. Each chunk fits "
              "the prompt budget. The chunks ride one batch together. Their "
              "audio is crossfaded at the seams.")
SERVE_STREAM = ("Streaming sends the first chunk alone. The rest follow "
                "together.")
# the served product on checkpoint weights (phase 5h): the components' seed
# (the base LLM and embedding are the server's own seed-0 init), the
# source VAE's seed (the server's random VAE is seed 1), one request each
CKPT_SEED, CKPT_VAE_SEED = 7, 3
CKPT_TEXT, CKPT_TTS_SEED, CKPT_ASR_SEED = (
    "Trained weights speak through the served product.", 111, 112)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


@contextlib.contextmanager
def exact_fp32():
    """fp32 means fp32 on both sides of a comparison: cuDNN's convolutions
    default to TF32 (matmuls do not), so switch TF32 off for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def synced(fn):
    """Host wall time of fn() ending in a device synchronize -> (out, s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
def build_models(device, num_llm_layers=None, calm_dtype=torch.bfloat16,
                 compute_dtype=torch.bfloat16):
    from audio_calm_torch.config import HiFiGANConfig, VAEModelConfig
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.flagship import build_random, flagship_config
    from audio_calm_torch.models.vae import AcousticVAE
    from audio_calm_torch.models.vocoder import (HiFiGANGenerator,
                                                 HiFiGANVocoder)

    cfg = flagship_config(num_llm_layers)
    calm = build_random(lambda: QwenCALM(cfg), device, seed=0,
                        dtype=calm_dtype)
    vae_cfg = VAEModelConfig()
    vae = build_random(lambda: AcousticVAE(vae_cfg), device, seed=1)
    gen = build_random(lambda: HiFiGANGenerator(HiFiGANConfig()), device,
                       seed=2)
    return calm, vae, vae_cfg, HiFiGANVocoder(gen, compute_dtype=compute_dtype)


def asr_yaml_config(num_llm_layers=None):
    """configs/asr.yaml's model: Qwen2-1.5B (28 layers, hidden 1536, 12/2
    heads) with LoRA r=64 alpha=128, TTS and ASR heads 768 x 4 layers with
    16 heads (head dim 48), latent 128, max_text_len 96, max_audio_len 384;
    `num_llm_layers` cuts the depth."""
    from audio_calm_torch.config import (CALMModelConfig, LoRAConfig,
                                         Qwen2Config)

    qwen = Qwen2Config()
    if num_llm_layers is not None:
        qwen.num_hidden_layers = num_llm_layers
    return CALMModelConfig(
        tts_loss_weight=0.0, asr_loss_weight=1.0, len_pred_loss_weight=0.1,
        dur_pred_loss_weight=0.0, use_lora=True,
        lora=LoRAConfig(rank=64, alpha=128.0, dropout=0.05),
        freeze_projector=True, use_precomputed_latents=True, latent_dim=128,
        tts_flow_hidden_dim=768, tts_flow_num_layers=4,
        asr_flow_hidden_dim=768, asr_flow_num_layers=4,
        mel_mean=-6.589515, mel_std=3.860679, max_text_len=96,
        max_audio_len=384, qwen=qwen)


def asr_wavs(seed=0):
    """Two 16 kHz test signals from a seed: 24.576 s (the 384-frame grid's
    393,216 samples) and 15 s; each a few sines whose pitch glides, with
    noise."""
    rng = np.random.default_rng(seed)
    wavs = []
    for n in (384 * 1024, 15 * 16000):
        t = np.arange(n) / 16000
        f0 = rng.uniform(120, 260)
        glide = 1 + 0.2 * np.sin(2 * np.pi * t / rng.uniform(1.5, 4))
        w = sum(a * np.sin(2 * np.pi * f0 * h * np.cumsum(glide) / 16000)
                for h, a in ((1, 0.4), (2, 0.2), (3, 0.1)))
        wavs.append((w + 0.02 * rng.standard_normal(n)).astype(np.float32))
    return wavs


def served_wav(seconds, seed):
    """A 16 kHz test signal from a seed: phrases of 1.5 to 4 s of gliding
    harmonic tones, with 0.3 s pauses between them, and noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    w = np.zeros(n)
    pos = 0
    while pos < n:
        m = min(n - pos, int(rng.uniform(1.5, 4.0) * 16000))
        t = np.arange(m) / 16000
        f0 = rng.uniform(120, 260) * (1 + 0.2 * np.sin(2 * np.pi * t / 2.0))
        phase = 2 * np.pi * np.cumsum(f0) / 16000
        w[pos:pos + m] = sum(a * np.sin(h * phase)
                             for h, a in ((1, 0.4), (2, 0.2), (3, 0.1)))
        pos += m + int(0.3 * 16000)
    return (w + 0.02 * rng.standard_normal(n)).astype(np.float32)


def odd_width_config():
    """V1's rates, kernels and dilations at 384 initial channels: widths
    192 (plain resblocks), 96, 48, 24 (neither above 128 nor dividing it:
    the resblock kernel, 3 launches a stage)."""
    from audio_calm_torch.config import HiFiGANConfig

    return HiFiGANConfig(upsample_initial_channel=384)


def v2_config():
    """HiFi-GAN V2 (jik876/hifi-gan config_v2.json): 128 initial channels,
    rates 8, 8, 2, 2; widths 64, 32, 16, 8, all through the stage kernel."""
    from audio_calm_torch.config import HiFiGANConfig

    return HiFiGANConfig(upsample_initial_channel=128)


def seeded_generator(cfg, seed):
    """HiFiGANGenerator(cfg) on the CPU with torch's default (fan-in scaled)
    initialization under `seed`: a live waveform at every width."""
    from audio_calm_torch.models.vocoder import HiFiGANGenerator

    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return HiFiGANGenerator(cfg).eval().requires_grad_(False)


def weight_normed_state_dict(gen, seed):
    """A torch checkpoint of `gen` in the official HiFi-GAN layout: every
    weight as weight_g / weight_v (v each output row of W rescaled by a
    random positive factor, g = ||W|| over all dims but the first, so that
    folding gives W back), resblocks flattened to resblocks.{i * n_k + j}."""
    g = torch.Generator().manual_seed(seed)
    n_k = len(gen.cfg.resblock_kernel_sizes)
    sd = {}
    for name, t in gen.state_dict().items():
        t = t.detach().float().cpu()
        m = re.match(r"resblocks\.(\d+)\.(\d+)\.(.*)", name)
        if m:
            name = f"resblocks.{int(m[1]) * n_k + int(m[2])}.{m[3]}"
        if name.endswith(".weight"):
            row = (t.shape[0],) + (1,) * (t.ndim - 1)
            sd[name + "_v"] = t * (0.5 + torch.rand(row, generator=g))
            sd[name + "_g"] = t.norm(dim=tuple(range(1, t.ndim)),
                                     keepdim=True)
        else:
            sd[name] = t
    return sd


def text_batch(lengths, seed=0):
    """Random token ids (as bench.py: ids in [10, 5000)), right-padded."""
    T = max(lengths)
    ids = np.random.default_rng(seed).integers(10, 5000, (len(lengths), T))
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None])
    return (torch.as_tensor(ids * mask, dtype=torch.long),
            torch.as_tensor(mask, dtype=torch.int32))


def stage_args(gen, index, x):
    """The stage kernel's arguments for HiFi-GAN stage `index` on input x,
    as hifigan_apply_fused routes them (index 0, 1: the grouped resblocks
    after a plain upsample; 2, 3: with the r=2 upsample)."""
    from audio_calm_torch.ops.vocoder_kernel import stack_resblock

    blocks = [stack_resblock(rb) for rb in gen.resblocks[index]]
    if index < 2:
        return (x, None, None, blocks)
    up = gen.ups[index]
    return (x, up.weight.permute(2, 0, 1), up.bias, blocks)


def stage_cost(args, io_bytes, op_bytes):
    """(FLOP, bytes) the stage needs: resblocks 2*sum(6k)*C^2 per output
    sample, the upsample 2*(k_up/r)*C_in*C; bytes: input, output, weights."""
    x, ups_w, _, blocks = args
    B, T_in, C_in = x.shape
    C = blocks[0][0].shape[-1]
    T_out = T_in * (2 if ups_w is not None else 1)
    per_sample = sum(2 * len(b[5]) * b[4] for b in blocks) * C * C
    w_elems = sum(b[0].numel() + b[2].numel() for b in blocks)
    if ups_w is not None:
        per_sample += (ups_w.shape[0] // 2) * C_in * C
        w_elems += ups_w.numel()
    flops = 2.0 * B * T_out * per_sample
    nbytes = (B * T_in * C_in + B * T_out * C) * io_bytes + w_elems * op_bytes
    return flops, nbytes


def stage_reckoning(plan, C, C_in, r, k_up, geom, T_out):
    """(executed / useful products, L2 weight bytes) of one launch of the
    bf16 stage kernel under `plan` (ops/vocoder_kernel.stage_plan), reckoned
    from the tile walk, not measured. Executed: per block and resblock, the
    upsample over the whole window and each conv over its output rows
    rounded out to m16 tiles; useful: the same products over the rows inside
    [0, T_out). Weights: each block reads every slice of each resblock (the
    upsample again per resblock) once, in bf16."""
    halo, tile = plan.halo, plan.tile
    ups = (k_up // r) * C_in * C if k_up else 0  # MACs an output row
    executed = useful = 0
    for blk in range(plan.grid[0]):
        rows = max(0, min(tile, T_out - blk * tile))
        for k, dils in geom:
            c = (k - 1) // 2
            hb = sum(c * d + c for d in dils)  # this resblock's halo
            lo, hi = halo - hb, halo + tile + hb
            executed += plan.Lp * ups
            useful += rows * (ups + 2 * len(dils) * k * C * C)
            consumed = 0
            for d in dils:
                r1lo, r1hi = lo + consumed + c * d, hi - consumed - c * d
                for a, b in ((r1lo, r1hi), (r1lo + c, r1hi - c)):
                    executed += (-(-b // 16) - a // 16) * 16 * k * C * C
                consumed += c * d + c
    per_block = sum(k_up * C_in * C + 2 * len(dils) * k * C * C
                    for k, dils in geom) * 2
    return executed / useful, plan.grid[0] * plan.grid[1] * per_block


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
SPLIT_REPEATS = 2000  # phase 3: launches of each key-split shape


def phase_kernels(gen, card):
    """Each kernel vs its plain version; returns the worst errors."""
    from audio_calm_torch.ops.attention_kernel import (attention_fwd,
                                                       attention_fwd_plain,
                                                       attention_plan)
    from audio_calm_torch.ops.vocoder_kernel import (vocoder_stage,
                                                     vocoder_stage_plain)
    from audio_calm_torch.tools.attention_probe import (ROWS,
                                                        repeat_mismatches,
                                                        row_inputs)

    g = torch.Generator(card).manual_seed(0)
    worst = {"vocoder_stage": 0.0, "attention_fwd": 0.0}
    # V1 stage inputs: C=128 grouped, 128->64 and 64->32 upsample stages;
    # full length = the 384-frame grid at B=1, short = a ragged length
    geoms = [(1, 128, 98304, 1531), (2, 128, 98304, 777), (3, 64, 196608, 1201)]
    for index, C_in, t_full, t_short in geoms:
        for T in (t_short, t_full):
            x = torch.randn(1, T, C_in, generator=g, device=card)
            args = stage_args(gen, index, x)
            for cdt in (torch.float32, torch.bfloat16):
                out = vocoder_stage(*args, compute_dtype=cdt)
                ref = vocoder_stage_plain(*args, compute_dtype=cdt)
                err = (out - ref).abs().max().item()
                # fp32: summation order only; bf16: one rounding step of an
                # operand or of the largest output
                bound = (1e-4 if cdt == torch.float32
                         else 2 ** -7 * ref.abs().max().item())
                log(f"  vocoder_stage stage={index} T_in={T} C_in={C_in} "
                    f"{str(cdt)[6:]}: max_abs_err {err:.3e} bound "
                    f"{bound:.3e}")
                check(err <= bound and out.shape == ref.shape,
                      f"vocoder_stage stage {index} T={T} {cdt}")
                if cdt == torch.bfloat16 and T == t_full:
                    worst["vocoder_stage"] = max(worst["vocoder_stage"], err)
    shapes = [  # (B, T, S, Hq, Hkv, d, causal, label)
        (2, 384, 384, 16, 16, 64, False, "DiT self"),
        (2, 384, 25, 16, 16, 64, False, "DiT cross"),
        (1, 25, 25, 12, 2, 128, True, "Qwen2 T=25"),
        (2, 97, 97, 12, 2, 128, True, "Qwen2 T=97"),
        # ASR at configs/asr.yaml's width: the query cross-attention (16
        # heads over 1536), the ASR head's self-attention (768 / 16), the
        # Qwen2 encode over [audio 384 | SOA | 76 prompt tokens]
        (2, 96, 384, 16, 16, 96, False, "ASR cross d=96"),
        (2, 96, 96, 16, 16, 48, False, "ASR DiT self d=48"),
        (2, 461, 461, 12, 2, 128, True, "ASR Qwen2 L=461"),
        # past the TPU's 512 gate, which the forward no longer has
        (1, 1024, 1024, 12, 2, 128, True, "causal T=S=1024"),
        (1, 2048, 2048, 12, 2, 128, True, "causal T=S=2048"),
    ]
    for B, T, S, Hq, Hkv, d, causal, label in shapes:
        valid = torch.ones(B, S, dtype=torch.bool, device=card)
        if B > 1:
            valid[1, S // 2: S - 1] = False  # mid-sequence pad, last valid
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, T, Hq, d, generator=g, device=card).to(dt)
            k = torch.randn(B, S, Hkv, d, generator=g, device=card).to(dt)
            v = torch.randn(B, S, Hkv, d, generator=g, device=card).to(dt)
            out = attention_fwd(q, k, v, valid, causal).float()
            ref = attention_fwd_plain(q, k, v, valid, causal).float()
            err = (out - ref).abs().max().item()
            bound = (2e-5 if dt == torch.float32
                     else 2 ** -7 * ref.abs().max().item())
            log(f"  attention_fwd {label} {str(dt)[6:]}: max_abs_err "
                f"{err:.3e} bound {bound:.3e}")
            check(err <= bound, f"attention_fwd {label} {dt}")
            if dt == torch.bfloat16:
                worst["attention_fwd"] = max(worst["attention_fwd"], err)
    # the key split (two consumer warpgroups on one ring) at the ASR
    # distillation's batch: repeated launches give the same bits
    for label in ("ASR Qwen2 encode L=461", "ASR cross d=96"):
        row = next(r for r in ROWS if r[0] == label)
        _, _, T, S, Hq, Hkv, d, causal, _, _ = row
        check(attention_plan(T, S, Hq, Hkv, d, causal).consumers == 2,
              f"attention_fwd {label} takes the key split")
        q, k, v, valid = row_inputs((label, 16) + row[2:], card, seed=3)
        bad = repeat_mismatches(q, k, v, valid, causal, SPLIT_REPEATS)
        log(f"  attention_fwd {label} B=16 key split: {bad} of "
            f"{SPLIT_REPEATS} repeated launches differ from the first")
        check(bad == 0, f"attention_fwd {label}: repeated launches agree")
    return worst


# the batch-invariant product (csrc/gemm.cu) runs at GEMM_ROWS, the served
# engine's shapes (tools/gemm_probe.ROWS: the /tts pair's Qwen2 encode with
# LoRA r 64, its DiT under CFG, the ASR encode's down_proj)
GEMM_REPEATS = 200  # phase 3: launches of each row under each plan
# the attention kernels at head dims they take zero-padded: the end-to-end
# proof's Qwen2 encode (B = 16 rows of 8 text + SOA positions), its DiT
# self- and cross-attention (2B = 32 rows on the 48-frame grid), d = 40
PADDED_ATTN = [  # (B, T, S, Hq, Hkv, d, causal, label)
    (16, 9, 9, 4, 2, 24, True, "e2e Qwen2 d=24"),
    (32, 48, 48, 4, 4, 24, False, "e2e DiT self d=24"),
    (32, 48, 9, 4, 4, 24, False, "e2e DiT cross d=24"),
    (2, 70, 130, 8, 4, 40, True, "d=40 GQA"),
]


def phase_served_kernels(card):
    """The batch-invariant product against its plain version at the served
    shapes (bf16: 2^-7 of the largest output), each checked row's bits
    against the row launched alone, and under every plan the shape takes
    GEMM_REPEATS launches back to back with the first one's bits and the
    rows next to the ragged edges of M with their solo bits
    (tools/gemm_probe.repeat_row); the attention kernels at head dims
    they take zero-padded against their plain versions, forward and
    backward (fp32 2e-5 / 2e-4, bf16 2^-7 of the largest magnitude), one
    launch each way -> the worst bf16 errors."""
    from audio_calm_torch.ops import attention_kernel as ak
    from audio_calm_torch.ops.gemm_kernel import linear, linear_plain

    worst = {"gemm": 0.0, "attention_fwd_padded": 0.0,
             "attention_bwd_padded": 0.0}
    for i, (label, M, N, K, kn) in enumerate(GEMM_ROWS):
        x, w, b = gemm_inputs(M, N, K, kn, card, i)
        out = linear(x, w, b, kn=kn)
        ref = linear_plain(x, w, b, kn=kn).float()
        err = (out.float() - ref).abs().max().item()
        bound = 2 ** -7 * ref.abs().max().item()
        rows = [torch.equal(linear(x[r:r + 1], w, b, kn=kn), out[r:r + 1])
                for r in (0, M // 2, M - 1)]
        log(f"  gemm {label} [{M}, {K}] x {'[K, N]' if kn else '[N, K]'} "
            f"N={N}: max_abs_err {err:.3e} bound {bound:.3e}; rows equal "
            f"to M=1 launches {rows}")
        check(err <= bound and all(rows), f"gemm {label}")
        worst["gemm"] = max(worst["gemm"], err)
        rep = gemm_repeat_row((label, M, N, K, kn), card, GEMM_REPEATS)
        log(f"  gemm {label}: of {GEMM_REPEATS} repeated launches, "
            f"{rep['mismatched']} differ from the first; ragged-edge rows "
            f"equal to solo launches: {rep['edges_agree']}")
        check(rep["edges_agree"] and not any(rep["mismatched"].values()),
              f"gemm {label}: repeated launches and edge rows agree")
    g = torch.Generator(card).manual_seed(5)
    for B, T, S, Hq, Hkv, d, causal, label in PADDED_ATTN:
        valid = torch.ones(B, S, dtype=torch.bool, device=card)
        valid[1, S // 2:] = False
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, T, Hq, d, generator=g, device=card).to(dt)
            k, v = (torch.randn(B, S, Hkv, d, generator=g, device=card)
                    .to(dt) for _ in range(2))
            dout = torch.randn(B, T, Hq, d, generator=g, device=card).to(dt)
            f0, b0 = ak.attention_fwd.launches, ak.attention_bwd.launches
            out = ak.attention_fwd(q, k, v, valid, causal)
            grads = ak.attention_bwd(q, k, v, out, dout, valid, causal)
            torch.cuda.synchronize()
            check((ak.attention_fwd.launches, ak.attention_bwd.launches)
                  == (f0 + 1, b0 + 1), f"attention {label}: one launch "
                  "each way")
            # the backward's plain version on the kernel's output, as the
            # card tests hold it
            ref = ak.attention_fwd_plain(q, k, v, valid, causal)
            refs = ak.attention_bwd_plain(q, k, v, out, dout, valid, causal)
            errs, bounds = [], []
            for a, b_, tol in [(out, ref, 2e-5)] + [
                    (a, b_, 2e-4) for a, b_ in zip(grads, refs)]:
                a, b_ = a.float(), b_.float()
                errs.append((a - b_).abs().max().item())
                bounds.append(tol if dt == torch.float32
                              else 2 ** -7 * b_.abs().max().item())
            log(f"  attention {label} {str(dt)[6:]} padded to d="
                f"{ak.padded_head_dim(d)}: max_abs_err out / dq / dk / dv "
                f"{[f'{e:.3e}' for e in errs]}, bounds "
                f"{[f'{b_:.3e}' for b_ in bounds]}")
            check(all(e <= b_ for e, b_ in zip(errs, bounds)),
                  f"attention {label} {dt} (padded to d="
                  f"{ak.padded_head_dim(d)})")
            if dt == torch.bfloat16:
                worst["attention_fwd_padded"] = max(
                    worst["attention_fwd_padded"], errs[0])
                worst["attention_bwd_padded"] = max(
                    worst["attention_bwd_padded"], *errs[1:])
    return worst


def kernel_time_gemm(launches, err, card):
    """The batch-invariant product's line: device ms a launch at each of
    GEMM_ROWS beside the plain version, cuBLAS (F.linear, the library call
    the served engine no longer makes) and the bound, their means; each
    row's log line also has the plan's reduction and grid and the earlier
    design's time (GEMM_EARLIER_MS, quoted, not measured here)."""
    from torch.nn.functional import linear as f_linear

    from audio_calm_torch.ops.gemm_kernel import (_sms, gemm_plan, linear,
                                                  linear_plain, split_count)

    def timed(fn, iters):
        # a session whose every record the tracer lost reads 0: again
        for _ in range(3):
            ms = device_ms(fn, iters)
            if ms > 0:
                return ms
        check(False, "the profiler recorded the product's device time")

    rows = []
    for i, (label, M, N, K, kn) in enumerate(GEMM_ROWS):
        x, w, b = gemm_inputs(M, N, K, kn, card, i)
        ms = timed(lambda: linear(x, w, b, kn=kn), 10)
        plain = timed(lambda: linear_plain(x, w, b, kn=kn), 3)
        lib = timed(lambda: x @ w if kn else f_linear(x, w, b), 10)
        nbytes = 2 * (M * K + N * K + M * N + (0 if kn else N))
        bnd, by = bound_ms(2.0 * M * N * K, nbytes)
        rows.append({"shape": label, "M": M, "N": N, "K": K,
                     "splits": split_count(N, K), "ms": ms,
                     "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
                     "bound_by": by})
        plan = gemm_plan(M, N, K, _sms(card))
        log(f"  gemm {json.dumps(rows[-1])}; reduction "
            f"{'gemm_reduce' if plan.spread else 'in the block'}, grid "
            f"{plan.blocks} blocks of {plan.nc} warpgroups; earlier design "
            f"{GEMM_EARLIER_MS.get(label)} ms (PERF.md)")
    by = max(("operations", "bytes"),
             key=lambda k: sum(r["bound_by"] == k for r in rows))
    return {
        "name": "gemm", "route": "cuda",
        "source": "audio_calm_torch/csrc/gemm.cu",
        "replaces": "audio_calm_tpu/models/lora.py:50",
        "replaces_note": "no pallas_call: XLA's dot of the served "
                         "projections, made batch invariant on the card",
        "launches": launches, "max_abs_err": err,
        "ms": float(np.mean([r["ms"] for r in rows])),
        "plain_ms": float(np.mean([r["plain_ms"] for r in rows])),
        "bound_ms": float(np.mean([r["bound_ms"] for r in rows])),
        "bound_by": by,
        "library_ms": float(np.mean([r["library_ms"] for r in rows])),
        "per_launch": "mean over GEMM_ROWS, the served engine's shapes",
        "shapes": rows}


def resblock_inputs(C, k, T, card, g):
    """x [2, T, C] and one resblock's weights (dilations 1, 3, 5; weights
    N(0, 1/(k C)), biases N(0, 0.01)) made on the card from `g`."""
    def w(*shape, scale):
        return scale * torch.randn(*shape, generator=g, device=card)

    s = 1.0 / np.sqrt(k * C)
    x = torch.randn(2, T, C, generator=g, device=card)
    return x, (w(3, k, C, C, scale=s), w(3, C, scale=0.1),
               w(3, k, C, C, scale=s), w(3, C, scale=0.1), k, (1, 3, 5))


def vocoder_kernel_bound(out, ref, cdt):
    """The JAX vocoder kernels' bounds -> (error, bound, held): fp32 rtol/
    atol 1e-5 (error = the largest |out - ref| - 1e-5 |ref| excess over
    1e-5); bf16 operands 5e-3 max-abs, relative to the output's largest
    magnitude where that exceeds 1 (JAX sets it on a waveform in [-1, 1];
    a resblock's output is not squashed, and a flipped bf16 operand moves
    it in proportion)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    if cdt == torch.float32:
        excess = ((out - ref).abs() - 1e-5 * ref.abs()).max().item()
        return err, 1e-5 + err - excess, excess <= 1e-5
    bound = 5e-3 * max(1.0, ref.abs().max().item())
    return err, bound, err < bound


def phase_vocoder_kernels(v2_gen, card):
    """The resblock kernel (K6) against its plain version at the odd widths
    and V1's C=128 and C=256, k = 3, 7, 11, with several tiles and a
    ragged last one, the first and last H frames held on their own; the
    stage kernel (K1) at V2's C=16 and C=8 stages, with the upsample.
    Returns the worst bf16 errors."""
    from audio_calm_torch.ops.vocoder_kernel import (_halo, fused_resblock,
                                                     fused_resblock_plain,
                                                     resblock_plan, simt_plan,
                                                     vocoder_stage,
                                                     vocoder_stage_plain)

    g = torch.Generator(card).manual_seed(4)
    worst = {"fused_resblock": 0.0, "vocoder_stage_narrow": 0.0}
    for C in (12, 24, 48, 96, 128, 256):
        for k in (3, 7, 11):
            # two of the larger of the two paths' tiles and a ragged third
            tile = max(resblock_plan(C, k, (1, 3, 5), 10 ** 7).tile,
                       simt_plan(C, k, (1, 3, 5), 10 ** 7)[2])
            T = 2 * tile + tile // 3 + 1
            H = _halo(k, (1, 3, 5))
            x, block = resblock_inputs(C, k, T, card, g)
            for cdt in (torch.float32, torch.bfloat16):
                out = fused_resblock(x, block, compute_dtype=cdt)
                ref = fused_resblock_plain(x, block, compute_dtype=cdt)
                res = [vocoder_kernel_bound(out[:, sl], ref[:, sl], cdt)
                       for sl in (slice(None), slice(0, H), slice(-H, None))]
                log(f"  fused_resblock C={C} k={k} T={T} {str(cdt)[6:]}: "
                    f"max_abs_err {res[0][0]:.3e} bound {res[0][1]:.3e}; "
                    f"edges {res[1][0]:.3e} / {res[2][0]:.3e}")
                check(out.shape == ref.shape and all(r[2] for r in res),
                      f"fused_resblock C={C} k={k} {cdt}")
                if cdt == torch.bfloat16:
                    worst["fused_resblock"] = max(worst["fused_resblock"],
                                                  res[0][0])
    # V2's last two stages: C_in 32 -> C 16 and 16 -> 8, full 384-grid
    # lengths at B=1 and a ragged short one
    for index, C_in, t_full, t_short in ((2, 32, 98304, 1201),
                                         (3, 16, 196608, 777)):
        for T in (t_short, t_full):
            x = torch.randn(1, T, C_in, generator=g, device=card)
            args = stage_args(v2_gen, index, x)
            for cdt in (torch.float32, torch.bfloat16):
                out = vocoder_stage(*args, compute_dtype=cdt)
                ref = vocoder_stage_plain(*args, compute_dtype=cdt)
                err, bound, held = vocoder_kernel_bound(out, ref, cdt)
                log(f"  vocoder_stage V2 stage={index} T_in={T} C_in={C_in} "
                    f"C={C_in // 2} {str(cdt)[6:]}: max_abs_err {err:.3e} "
                    f"bound {bound:.3e}")
                check(held and out.shape == ref.shape == (1, 2 * T, C_in // 2),
                      f"vocoder_stage V2 stage {index} T={T} {cdt}")
                if cdt == torch.bfloat16:
                    worst["vocoder_stage_narrow"] = max(
                        worst["vocoder_stage_narrow"], err)
    return worst


def qwen_train_inputs(B, dt, card, seed=0):
    """Qwen2 attention operands of the training path: q/dout [B, 97, 12,
    128], k/v [B, 97, 2, 128], the [text | pads | SOA] key mask with mixed
    text lengths."""
    g = torch.Generator(card).manual_seed(seed)
    t_txt = 96
    T = t_txt + 1
    q, dout = (torch.randn(B, T, 12, 128, generator=g, device=card).to(dt)
               for _ in range(2))
    k, v = (torch.randn(B, T, 2, 128, generator=g, device=card).to(dt)
            for _ in range(2))
    lengths = torch.randint(4, t_txt + 1, (B,), generator=g, device=card)
    valid = torch.arange(T, device=card)[None, :] < lengths[:, None]
    valid[:, -1] = True  # SOA
    return q, k, v, dout, valid


def dit_train_inputs(B, dt, card, seed=0):
    """DiT self-attention operands of a dropout-off training slice: q/k/v/
    dout [B, 384, 16, 64], the audio-frame key mask (48-384 valid frames)."""
    g = torch.Generator(card).manual_seed(seed)
    q, k, v, dout = (torch.randn(B, 384, 16, 64, generator=g,
                                 device=card).to(dt) for _ in range(4))
    frames = torch.randint(48, 385, (B,), generator=g, device=card)
    valid = torch.arange(384, device=card)[None, :] < frames[:, None]
    return q, k, v, dout, valid


def attn_inputs(B, T, S, H, d, lo, dt, card, seed=0):
    """Attention operands q/dout [B, T, H, d], k/v [B, S, H, d] and a key
    mask with lo..S valid keys a row."""
    g = torch.Generator(card).manual_seed(seed)
    q, dout = (torch.randn(B, T, H, d, generator=g, device=card).to(dt)
               for _ in range(2))
    k, v = (torch.randn(B, S, H, d, generator=g, device=card).to(dt)
            for _ in range(2))
    n = torch.randint(lo, S + 1, (B,), generator=g, device=card)
    valid = torch.arange(S, device=card)[None, :] < n[:, None]
    return q, k, v, dout, valid


def dit_cross_inputs(B, dt, card, seed=0):
    """The DiT's cross-attention in a distillation student: 384 audio
    queries over the 96-position text context (4-96 valid), 16 heads of
    64 (tts.yaml)."""
    return attn_inputs(B, 384, 96, 16, 64, 4, dt, card, seed)


def asr_head_inputs(B, dt, card, seed=0):
    """The ASR head's self-attention in a distillation student: 96 queries
    (10-96 valid), 16 heads of 48 (asr.yaml's 768-wide head)."""
    return attn_inputs(B, 96, 96, 16, 48, 10, dt, card, seed)


def long_causal_inputs(B, dt, card, seed=0):
    """Causal GQA 12/2 attention operands at T = S = 1024, d = 128, past the
    TPU's 512 gate (K5 has none): q/dout [B, 1024, 12, 128], k/v [B, 1024,
    2, 128], 64-1024 valid keys a row."""
    g = torch.Generator(card).manual_seed(seed)
    q, dout = (torch.randn(B, 1024, 12, 128, generator=g, device=card).to(dt)
               for _ in range(2))
    k, v = (torch.randn(B, 1024, 2, 128, generator=g, device=card).to(dt)
            for _ in range(2))
    n = torch.randint(64, 1025, (B,), generator=g, device=card)
    valid = torch.arange(1024, device=card)[None, :] < n[:, None]
    return q, k, v, dout, valid


def asr_train_inputs(B, dt, card, seed=0):
    """Qwen2 attention operands of a plain ASR training slice (asr.yaml:
    B = 16 in 8 slices): q/dout [B, 461, 12, 128], k/v [B, 461, 2, 128]
    (the 384-frame grid, SOA and the byte tokenizer's 76-token prompt),
    the [audio frames | pads | SOA | prompt] key mask with mixed audio
    lengths."""
    g = torch.Generator(card).manual_seed(seed)
    T = 384 + 1 + asr_prompt_len()
    q, dout = (torch.randn(B, T, 12, 128, generator=g, device=card).to(dt)
               for _ in range(2))
    k, v = (torch.randn(B, T, 2, 128, generator=g, device=card).to(dt)
            for _ in range(2))
    frames = torch.randint(48, 385, (B,), generator=g, device=card)
    valid = torch.arange(T, device=card)[None, :] < frames[:, None]
    valid[:, 384:] = True  # SOA and the prompt
    return q, k, v, dout, valid


def phase_attention_bwd(card):
    """K5 vs its plain version at the Qwen2 training shapes (TTS and plain
    ASR), the DiT self- and cross-attention shapes and the ASR head's
    (d = 48, the distillation students'), and a causal row of 1024 past the
    TPU's 512 gate, fp32 and bf16; two bf16
    launches give the same bits; the flash_attention Function vs autograd
    through the plain forward."""
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_bwd_plain,
                                                       attention_fwd,
                                                       attention_fwd_plain,
                                                       flash_attention)

    worst = 0.0
    cases = [("Qwen2 [16, 97, 12/2, 128]", qwen_train_inputs, 16, True),
             ("Qwen2 plain ASR [2, 461, 12/2, 128]", asr_train_inputs, 2,
              True),
             ("DiT self [4, 384, 16, 64]", dit_train_inputs, 4, False),
             ("DiT cross [4, 384 / 96, 16, 64]", dit_cross_inputs, 4, False),
             ("ASR head self [4, 96, 16, 48]", asr_head_inputs, 4, False),
             ("causal past 512 [2, 1024, 12/2, 128]", long_causal_inputs, 2,
              True)]
    for label, inputs, B, causal in cases:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, dout, valid = inputs(B, dt, card)
            with torch.no_grad():
                out = attention_fwd(q, k, v, valid, causal)
                got = attention_bwd(q, k, v, out, dout, valid, causal)
                ref = attention_bwd_plain(q, k, v, out, dout, valid, causal)
                again = attention_bwd(q, k, v, out, dout, valid, causal)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"attention_bwd {label} {dt}: two launches, same bits")
            for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
                a, b = a.float(), b.float()
                err = (a - b).abs().max().item()
                # fp32: summation order over up to 6 heads x S keys; bf16:
                # one rounding step of the largest gradient
                bound = (2e-5 if dt == torch.float32 else 2 ** -7) * \
                    b.abs().max().item()
                log(f"  attention_bwd {label} {name} {str(dt)[6:]}: "
                    f"max_abs_err {err:.3e} bound {bound:.3e}")
                check(err <= bound and a.shape == b.shape,
                      f"attention_bwd {label} {name} {dt}")
                if dt == torch.bfloat16:
                    worst = max(worst, err)
    q, k, v, dout, valid = qwen_train_inputs(4, torch.float32, card, seed=1)
    grads = []
    for fn in (flash_attention, attention_fwd_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, valid, True)
        (out * dout).sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves])
    for a, b, name in zip(*grads, ("out", "dq", "dk", "dv")):
        err = (a - b).abs().max().item()
        bound = 2e-5 * b.abs().max().item()
        log(f"  flash_attention vs autograd of the plain forward {name}: "
            f"max_abs_err {err:.3e} bound {bound:.3e}")
        check(err <= bound, f"flash_attention {name}")
    return worst


def phase_reduced_depth(card):
    """Full widths, 2 LLM layers, 96-frame grid, fp32: card vs CPU."""
    import copy

    from audio_calm_torch.eval.infer import tts_generate_latents
    from audio_calm_torch.eval.render import make_renderer

    cpu = build_models("cpu", num_llm_layers=2, calm_dtype=torch.float32,
                       compute_dtype=torch.float32)
    calm, vae, vae_cfg, voc = cpu
    dev = (copy.deepcopy(calm).to(card), copy.deepcopy(vae).to(card),
           vae_cfg, copy.deepcopy(voc).to(card))
    ids, mask = text_batch([24, 16], seed=1)
    x0 = torch.randn(2, 96, 128, generator=torch.Generator().manual_seed(7))
    out = {}
    for name, (calm, vae, vae_cfg, voc), device in (("cpu", cpu, "cpu"),
                                                    ("card", dev, card)):
        lat, nf = tts_generate_latents(
            calm, ids, mask, steps=2, cfg_scale=2.5, t_aud=96,
            num_frames_override=80, method="midpoint", x_init=x0,
            device=device)
        render = make_renderer(vae, vae_cfg, voc, device=device)
        wavs = render.batch(lat.cpu().numpy(), nf.tolist())
        out[name] = (lat.float().cpu().numpy(), wavs)
    lat_err = float(np.abs(out["cpu"][0] - out["card"][0]).max())
    wav_err = max(float(np.abs(a - b).max())
                  for a, b in zip(out["cpu"][1], out["card"][1]))
    # fp32 everywhere, TF32 off: the two devices sum in other orders
    log(f"  latents max_abs_err {lat_err:.3e} bound 1e-3; waveform "
        f"max_abs_err {wav_err:.3e} bound 1e-3")
    check(lat_err < 1e-3 and wav_err < 1e-3, "reduced-depth card vs CPU")
    check(all(w.shape == (80 * 1024,) and np.isfinite(w).all()
              for w in out["card"][1]), "reduced-depth waveform shape")


def train_batch(B, card, gen, t_aud=384):
    """A plain TTS batch: random token ids with mixed text lengths padded
    to 96, latents on the t_aud grid with mixed valid lengths (the
    flagship's latent statistics), all made on `card` from `gen`."""
    lengths = torch.randint(8, 97, (B,), generator=gen, device=card)
    tmask = torch.arange(96, device=card)[None, :] < lengths[:, None]
    ids = torch.randint(10, 5000, (B, 96), generator=gen, device=card)
    frames = torch.randint(t_aud // 8, t_aud + 1, (B,), generator=gen,
                           device=card)
    amask = torch.arange(t_aud, device=card)[None, :] < frames[:, None]
    lat = 0.039775 + 1.190864 * torch.randn(B, t_aud, 128, generator=gen,
                                            device=card)
    return {"text_ids": ids * tmask, "attention_mask": tmask.int(),
            "latents": lat, "audio_mask": amask.int()}


def check_card_vs_cpu(res, trainable, what):
    """A training step's results on both devices, res[device] = (loss terms,
    {name: gradient}): every loss term within 1e-4 relative, the same
    tensors with gradients (all trainable), each gradient within 1e-3 of
    its largest value (fp32 on both, TF32 off: summation order; a floor of
    1e-3 of the largest gradient for tensors whose gradient is zero
    analytically, the key biases) -> the worst error over its bound."""
    for k, ref in res["cpu"][0].items():
        err = abs(res["card"][0][k] - ref)
        log(f"  {what} {k}: cpu {ref:.6f} card {res['card'][0][k]:.6f}")
        check(err <= 1e-4 * abs(ref), f"{what} {k} card vs CPU")
    grads_cpu, grads_card = res["cpu"][1], res["card"][1]
    check(set(grads_card) == set(grads_cpu) and set(grads_cpu) <= trainable,
          f"{what}: the same tensors get gradients on both devices")
    top = max(g.abs().max().item() for g in grads_cpu.values())
    worst = 0.0
    for n, ref in grads_cpu.items():
        err = (grads_card[n] - ref).abs().max().item()
        bound = 1e-3 * max(ref.abs().max().item(), 1e-3 * top)
        worst = max(worst, err / bound)
        check(err <= bound, f"{what} gradient of {n}")
    log(f"  {what}: {len(grads_cpu)} trainable gradients agree, worst error "
        f"{worst:.3f} of its bound (1e-3 of the tensor's largest value)")
    return worst


def phase_train_step_card_vs_cpu(card):
    """One TTS training step's loss and gradients, full widths, 2 LLM
    layers, fp32, dropouts off (the CFG drop injected), card vs CPU. With
    the attention dropout off, the DiT attention takes the fused route as
    the Qwen2 attention does: K3/K4 forward, K5 backward on the card."""
    import copy

    from audio_calm_torch.config import TrainingConfig
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.flagship import flagship_config, random_normal_
    from audio_calm_torch.ops.attention import MultiheadAttention
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_fwd)
    from audio_calm_torch.train.optim import freeze

    cfg = flagship_config(2)
    cfg.lora.dropout = 0.0
    cpu = QwenCALM(cfg)
    random_normal_(cpu, seed=3)
    for m in cpu.modules():
        if isinstance(m, MultiheadAttention):
            m.dropout = 0.0
    labels = freeze(cpu, TrainingConfig())
    dev = copy.deepcopy(cpu).to(card)
    g = torch.Generator(card).manual_seed(5)
    batch = train_batch(4, card, g, t_aud=192)
    flow = {"t": torch.rand(4, generator=g, device=card),
            "x0": torch.randn(4, 192, 128, generator=g, device=card),
            "drop": torch.tensor([False, True, False, False], device=card)}
    res = {}
    for name, model, device in (("cpu", cpu, "cpu"), ("card", dev, card)):
        args = {k: v.to(device) for k, v in {**batch, **flow}.items()}
        attention_fwd.launches = attention_bwd.launches = 0
        out = model.forward_tts(train=True, seed=1, **args)
        out["loss"].backward()
        res[name] = ({k: float(v.detach()) for k, v in out.items()},
                     {n: p.grad.detach().cpu() for n, p in
                      model.named_parameters() if p.grad is not None})
    counts = {"attention_fwd": attention_fwd.launches,
              "attention_bwd": attention_bwd.launches}
    L, n_dit = cfg.qwen.num_hidden_layers, 2 * cfg.tts_flow_num_layers
    remat = 2 if cfg.remat_policy == "full" else 1
    want = {"attention_fwd": remat * L + n_dit, "attention_bwd": L + n_dit}
    log(f"  train step launches on the card: {counts} (expected {want}: "
        f"{L} Qwen2 layers, {n_dit} DiT attentions)")
    check(counts == want, "kernel launch counts of the card's training step")
    check_card_vs_cpu(res, {n for n, lab in labels.items()
                            if lab != "frozen"}, "train step")


def phase_train_main_path(card):
    """The training path at full width: 28-layer flagship, tts.yaml's
    plain-batch recipe, TRAIN_STEPS steps through run_training."""
    from audio_calm_torch.config import TrainingConfig
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.flagship import flagship_config, random_normal_
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_fwd)
    from audio_calm_torch.train.loop import run_training
    from audio_calm_torch.train.optim import AdamW, freeze
    from audio_calm_torch.train.steps import count_step_flops, make_calm_step
    from audio_calm_torch.utils.profiling import device_peak_flops

    steps = TRAIN_STEPS
    # configs/tts.yaml, training: (plain batches); metrics.jsonl to a
    # temporary directory
    out_dir = tempfile.mkdtemp(prefix="plain_training_")
    tcfg = TrainingConfig(
        per_device_train_batch_size=32, microbatch_steps=2, soa_lr_mult=3.0,
        proj_lr_mult=1.0, head_lr_mult=3.0, learning_rate=5e-5,
        frozen_weights_dtype="bfloat16", lr_scheduler_type="cosine",
        warmup_ratio=0.1, max_grad_norm=1.0, logging_steps=1,
        output_dir=out_dir)
    cfg = flagship_config()
    t0 = time.perf_counter()
    with torch.device(card):
        model = QwenCALM(cfg, compute_dtype=torch.bfloat16)
    random_normal_(model, seed=0)
    labels = freeze(model, tcfg, task_mode="tts")
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    start = {n: p.detach().clone() for n, p in trainable.items()}
    opt = AdamW(trainable, labels, tcfg, total_steps=steps)
    k = tcfg.tts_microbatch_steps or tcfg.microbatch_steps
    step = make_calm_step(model, opt, "tts", microbatch=k, seed=tcfg.seed)
    n_train = sum(p.numel() for p in trainable.values())
    torch.cuda.synchronize()
    log(f"  flagship for training built in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"{n_train / 1e6:.1f} M trainable (fp32 masters), "
        f"{cfg.qwen.num_hidden_layers} LLM layers, remat {cfg.remat_policy}")
    gen = torch.Generator(card).manual_seed(11)
    batches = [train_batch(tcfg.per_device_train_batch_size, card, gen)
               for _ in range(steps)]
    snaps = []

    def feed():
        for b in batches:
            yield b
            snaps.append({n: p.detach().clone() for n, p in trainable.items()}
                         if len(snaps) < 2 else None)

    # the step's FLOPs (one slice run under the counter, before the run)
    flops = count_step_flops(model, batches[0], "tts", k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention_fwd.launches = 0
    attention_bwd.launches = 0
    history = run_training(step, feed(), tcfg, total_steps=steps,
                           step_flops=lambda b: flops, device=card)
    shutil.rmtree(out_dir, ignore_errors=True)
    counts = {"attention_fwd": attention_fwd.launches,
              "attention_bwd": attention_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    L = cfg.qwen.num_hidden_layers
    # full remat: each block's forward runs again in the backward
    want = {"attention_fwd": 2 * L * k * steps,
            "attention_bwd": L * k * steps}
    log(f"  launches on the training path: {counts} (expected {want}: K5 "
        f"once per layer and slice, K4 twice under full remat)")
    check(counts == want, "kernel launch counts on the training path")
    check(len(history) == steps and all(
        np.isfinite(v) for r in history for v in r.values()),
        "finite training metrics")
    for n, p in model.named_parameters():
        if not p.requires_grad:
            check(torch.equal(p, frozen[n]), f"frozen tensor {n} unchanged")
    check(all(torch.equal(snaps[0][n], start[n]) for n in trainable),
          "trainable tensors unchanged after step 1 (LR 0)")
    still = [n for n in trainable if torch.equal(snaps[1][n], start[n])]
    moved = len(trainable) - len(still)
    log(f"  after step 2: {moved} of {len(trainable)} trainable tensors "
        f"changed; unchanged: {still}")
    # random weights put every length prediction below its clip floor
    # (10 frames), so the length predictor gets a zero gradient; its
    # weights still move by weight decay, its biases (no decay) cannot
    check(all(n.startswith("tts_len_predictor.") and labels[n] == "no_decay"
              for n in still),
          f"every trainable tensor with a gradient or weight decay changed "
          f"by step 2 ({still})")
    check({labels[n] for n in trainable if n not in still}
          == {"decay", "no_decay", "proj", "head", "soa"},
          "every optimizer group moved by step 2")
    for i, r in enumerate(history):
        log(f"  step {i + 1}: " + " ".join(
            f"{key}={r[key]:.5f}" for key in ("loss", "loss_tts", "loss_len",
                                              "loss_dur", "grad_norm"))
            + f" step_s={r['step_s']:.4f}")
    steady = sorted(r["step_s"] for r in history[1:])
    step_s = steady[len(steady) // 2]
    B = tcfg.per_device_train_batch_size
    summary = {"steps": steps, "batch": B, "microbatch": k,
               "step_s_first": history[0]["step_s"],
               "step_s_median_after_first": step_s,
               "samples_per_s": B / step_s, "peak_mem_gb": peak / 1e9,
               "tflop_per_step": flops / 1e12,
               "mfu_pct": 100.0 * flops / step_s / device_peak_flops(card),
               "launches": counts, "losses": [r["loss"] for r in history],
               "grad_norms": [r["grad_norm"] for r in history]}
    log("  training " + json.dumps(summary))
    del frozen, start, snaps
    torch.cuda.empty_cache()
    return counts, summary, (model, opt, step, batches[0])


def phase_train_profile(probe, step_s):
    """Where a training step's time goes: the host wall of its parts (each
    ending in a device synchronize), then one more step under the profiler
    (device activity only): the device's busy share of the step and the
    kernels that take the most device time."""
    from audio_calm_torch.ops.mas import monotonic_alignment_search
    from audio_calm_torch.train.steps import TTS_KEYS

    model, opt, step, batch = probe
    half = {k: batch[k][:16] for k in TTS_KEYS}
    parts = {}
    with torch.no_grad():
        _, parts["forward_one_slice_no_grad_s"] = synced(
            lambda: model.forward_tts(**half, train=True, seed=1))
        log_p = torch.log_softmax(torch.randn(16, 96, 384, device="cuda"), 1)
        _, parts["mas_one_slice_s"] = synced(
            lambda: monotonic_alignment_search(log_p))
    grads = {n: p.grad for n, p in opt.params.items()}
    _, parts["optimizer_update_s"] = synced(lambda: opt.step(grads))
    _, parts["whole_step_s"] = synced(lambda: step(batch))
    log("  training step parts (host wall, synchronized) " + json.dumps(parts))
    p_wall, rows = device_profile(lambda: step(batch))
    busy = sum(r[1] for r in rows)
    check(busy > 0, "the profiler saw device time in the training step")
    log(f"  profiled training step: wall {p_wall:.4f} s, device busy "
        f"{busy:.4f} s: {100 * busy / p_wall:.1f}% of the profiled wall, "
        f"{100 * busy / step_s:.1f}% of the unprofiled step {step_s:.4f} s")
    for name, s_, n in rows[:12]:
        log(f"    {1e3 * s_:9.3f} ms {n:6d} calls  {name[:90]}")
    launches = sum(r[2] for r in rows)
    log(f"  device kernels and copies in the step: {launches}")
    # K5's two passes (csrc/attention_bwd.cu: dq_kernel, dkv_kernel)
    k5 = [r for r in rows if re.search(r"\bd(q|kv)_kernel<", r[0])]
    k5_s = sum(r[1] for r in k5)
    check(sum(r[2] for r in k5) > 0, "the profiler saw K5 in the step")
    log(f"  K5 in the step: {1e3 * k5_s:.3f} ms device time in "
        f"{sum(r[2] for r in k5)} kernel calls, {100 * k5_s / busy:.1f}% of "
        f"the step's device time")
    return {"profiled_step_wall_s": p_wall, "step_device_busy_s": busy,
            "step_device_ops": launches, "k5_device_s": k5_s,
            "k5_share_of_device": k5_s / busy, "parts": parts}


def phase_main_path(card):
    from audio_calm_torch.eval.infer import (tts_decode, tts_encode,
                                             tts_generate_latents)
    from audio_calm_torch.eval.render import make_renderer
    from audio_calm_torch.ops.attention_kernel import attention_fwd
    from audio_calm_torch.ops.vocoder_kernel import vocoder_stage

    (calm, vae, vae_cfg, voc), build_s = synced(lambda: build_models(card))
    log(f"  flagship built in {build_s:.1f} s: "
        f"{sum(p.numel() for p in calm.parameters()) / 1e9:.3f} B CALM params "
        f"(bf16), {calm.cfg.qwen.num_hidden_layers} LLM layers")
    render = make_renderer(vae, vae_cfg, voc, device=card)
    gen = torch.Generator(card).manual_seed(0)
    requests = [  # (text lengths, grid, frames)
        ([24, 16], 384, 384),
        ([24], 192, 125),
    ]
    ode = dict(steps=12, method="midpoint", cfg_scale=2.5)

    def serve():
        wavs = []
        for lengths, grid, frames in requests:
            ids, mask = text_batch(lengths)
            lat, nf = tts_generate_latents(calm, ids, mask, gen, t_aud=grid,
                                           num_frames_override=frames,
                                           device=card, **ode)
            if len(lengths) > 1:
                wavs += render.batch(lat.cpu().numpy(), nf.tolist())
            else:
                wavs.append(render(lat[0].cpu().numpy(), int(nf[0])))
        return wavs

    synced(serve)  # warm-up: cuBLAS/cuDNN plans, allocator
    vocoder_stage.launches = 0
    attention_fwd.launches = 0
    wavs, wall = synced(serve)
    counts = {"vocoder_stage": vocoder_stage.launches,
              "attention_fwd": attention_fwd.launches}
    n_layers = calm.cfg.qwen.num_hidden_layers
    evals = 2 * ode["steps"]  # midpoint: two velocity evaluations a step
    want = {"vocoder_stage": 3 * len(requests),
            "attention_fwd": len(requests) * (n_layers + 2 * 4 * evals)}
    log(f"  launches on the main path: {counts} (expected {want})")
    check(counts == want, "kernel launch counts on the main path")
    frames = [f for lengths, _, f in requests for _ in lengths]
    for w, f in zip(wavs, frames):
        check(w.shape == (f * 1024,) and np.isfinite(w).all(),
              f"main-path waveform of {f} frames")
    audio_s = sum(frames) * SEC_PER_FRAME
    log(f"  served {len(wavs)} utterances, {audio_s:.3f} s of audio in "
        f"{wall:.3f} s wall: realtime factor {audio_s / wall:.2f}x")

    phases = []
    for lengths, grid, frames_ in requests:
        ids, mask = text_batch(lengths)
        ids, mask = ids.to(card), mask.to(card)
        with torch.no_grad():
            enc, t_enc = synced(lambda: tts_encode(calm, ids, mask))
            cv, ctx, pad, nf = enc
            nf = torch.full_like(nf, frames_)
            lat, t_ode = synced(lambda: tts_decode(
                calm, cv, ctx, pad, nf, gen, t_aud=grid, **ode))
            B = lat.shape[0]
            Bp = 1 << (B - 1).bit_length()
            lat_p = torch.cat([lat, lat[:1].repeat(Bp - B, 1, 1)])
            nf_p = torch.cat([nf, nf[:1].repeat(Bp - B)])
            mel, t_vae = synced(lambda: render.decode_mel(lat_p, nf_p))
            _, t_voc = synced(lambda: voc(mel))
        row = {"texts": len(lengths), "grid": grid, "frames": frames_,
               "encode_s": t_enc, "ode_s": t_ode, "vae_decode_s": t_vae,
               "vocoder_s": t_voc,
               "audio_s": len(lengths) * frames_ * SEC_PER_FRAME}
        row["realtime_factor"] = row["audio_s"] / (t_enc + t_ode + t_vae
                                                   + t_voc)
        phases.append(row)
        log("  phase times " + json.dumps(row))
    return calm, voc, counts, serve, {"wall_s": wall, "audio_s": audio_s,
                                      "phases": phases}


def phase_profile(serve, wall):
    """The served requests once more under the profiler: device busy share
    and the kernels that take the most device time."""
    p_wall, rows = device_profile(serve)
    busy, top = sum(r[1] for r in rows), rows[:8]
    check(busy > 0, "the profiler saw device time")
    log(f"  profiled serve: wall {p_wall:.4f} s, device busy {busy:.4f} s: "
        f"{100 * busy / p_wall:.1f}% of the profiled wall, "
        f"{100 * busy / wall:.1f}% of the unprofiled wall {wall:.4f} s")
    for name, s, n in top:
        log(f"    {1e3 * s:9.3f} ms {n:6d} calls  {name[:90]}")
    # the stage kernel's share (its template instantiations, one per width)
    k1 = sum(r[1] for r in rows if "stage_kernel" in r[0])
    log(f"  vocoder_stage in the served requests: {1e3 * k1:.3f} ms device "
        f"time, {100 * k1 / busy:.1f}% of the device time")
    return {"profiled_wall_s": p_wall, "device_busy_s": busy,
            "vocoder_stage_device_s": k1}


def phase_load_vocoders(gens, card, tmp):
    """Each seeded generator saved as a weight-normed torch checkpoint in a
    directory of its own, loaded by load_vocoder onto the card and onto the
    CPU, and held card against CPU on one mel: fp32 operands within 1e-4
    (the JAX package's test_hifigan_torch_parity bound), the default bf16
    operands within 5e-3 (its bf16 vocoder bound)."""
    from audio_calm_torch.models.vocoder import HiFiGANVocoder, load_vocoder

    mel = torch.randn(2, 48, 80, generator=torch.Generator().manual_seed(9))
    loaded = {}
    for (name, (cfg, gen)), fname in zip(gens.items(),
                                         ("generator.ckpt", "generator.bin")):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        torch.save(weight_normed_state_dict(gen, seed=len(loaded)),
                   os.path.join(d, fname))
        voc, load_s = synced(lambda: load_vocoder(d, cfg))
        cpu = load_vocoder(d, cfg, device="cpu")
        check(isinstance(voc, HiFiGANVocoder) and isinstance(cpu,
                                                            HiFiGANVocoder),
              f"load_vocoder({name}) gives HiFi-GAN")
        for cdt, bound in ((torch.float32, 1e-4), (torch.bfloat16, 5e-3)):
            with exact_fp32(), torch.no_grad():
                a = HiFiGANVocoder(voc.generator, compute_dtype=cdt)(
                    mel.to(card)).cpu()
                b = HiFiGANVocoder(cpu.generator, compute_dtype=cdt)(mel)
            err = (a - b).abs().max().item()
            log(f"  load_vocoder {name} ({fname}, loaded in {load_s:.2f} s) "
                f"{str(cdt)[6:]}: card vs CPU max_abs_err {err:.3e} bound "
                f"{bound:.0e}; |wav| max {b.abs().max().item():.3f}")
            check(err < bound and a.shape == (2, 48 * 256)
                  and b.abs().max().item() > 0.05,
                  f"loaded {name} card vs CPU {cdt}")
        loaded[name] = voc
    return loaded


def phase_vocoder_path(vocs, card):
    """The product's render with each vocoder, at full width on the
    384-frame grid, B=2 (one row 384 frames, one 311): the flagship VAE's
    masked decode, then the vocoder; launch counts, waveforms, times."""
    from audio_calm_torch.config import VAEModelConfig
    from audio_calm_torch.eval.render import make_renderer
    from audio_calm_torch.models.flagship import build_random
    from audio_calm_torch.models.vae import AcousticVAE
    from audio_calm_torch.models.vocoder import load_vocoder
    from audio_calm_torch.ops.vocoder_kernel import (fused_resblock,
                                                     vocoder_stage)

    vae_cfg = VAEModelConfig()
    vae = build_random(lambda: AcousticVAE(vae_cfg), card, seed=1)
    g = torch.Generator(card).manual_seed(3)
    lat = (0.039775 + 1.190864 * torch.randn(2, 384, 128, generator=g,
                                             device=card)).cpu().numpy()
    ns = [384, 311]
    variants = [  # (name, vocoder, launches per render call)
        ("odd_width_hifigan", vocs["odd_width"],
         {"fused_resblock": 9, "vocoder_stage": 0}),
        ("v2_hifigan", vocs["v2"], {"fused_resblock": 0, "vocoder_stage": 4}),
        ("griffin_lim_32", load_vocoder(None),
         {"fused_resblock": 0, "vocoder_stage": 0}),
    ]
    rows, counts_all, calls = [], {}, 2
    for name, voc, per_call in variants:
        render = make_renderer(vae, vae_cfg, voc, device=card)
        synced(lambda: render.batch(lat, ns))  # warm-up: plans, allocator
        fused_resblock.launches = vocoder_stage.launches = 0
        times = []
        for _ in range(calls):
            wavs, t = synced(lambda: render.batch(lat, ns))
            times.append(t)
        counts = {"fused_resblock": fused_resblock.launches,
                  "vocoder_stage": vocoder_stage.launches}
        want = {k: v * calls for k, v in per_call.items()}
        log(f"  render {name}: launches {counts} (expected {want}); "
            f"{calls} calls of B=2, {[f'{t:.4f}' for t in times]} s")
        check(counts == want, f"launch counts of the {name} render")
        for w, n in zip(wavs, ns):
            check(w.shape == (n * 1024,) and np.isfinite(w).all(),
                  f"{name} waveform of {n} frames")
        audio_s = sum(ns) * SEC_PER_FRAME
        rows.append({"vocoder": name, "render_s": min(times),
                     "render_s_all": times, "audio_s": audio_s,
                     "realtime_factor": audio_s / min(times),
                     "launches": counts, "wav_abs_max": float(
                         max(np.abs(w).max() for w in wavs))})
        counts_all[name] = counts
    log("  vocoder path " + json.dumps(rows))
    return counts_all, rows


def phase_reconstruct(card):
    """8 s of a seeded synthetic signal (three sines and noise, 16 kHz)
    through MelFrontend and eval/reconstruct at the flagship VAE's width
    (512 hidden channels, random weights from a seed), fp32, on the card
    and on the CPU; the card also renders both mels with Griffin-Lim."""
    import copy

    from audio_calm_torch.config import MelConfig, VAEModelConfig
    from audio_calm_torch.eval.reconstruct import reconstruct
    from audio_calm_torch.models.flagship import build_random
    from audio_calm_torch.models.vae import AcousticVAE
    from audio_calm_torch.models.vocoder import GriffinLimVocoder
    from audio_calm_torch.ops.mel import MelFrontend

    sr = 16000
    t = np.arange(8 * sr) / sr
    rng = np.random.default_rng(5)
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 1375 * t)
           + 0.1 * np.sin(2 * np.pi * 3600 * t)
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    cpu_vae = build_random(lambda: AcousticVAE(VAEModelConfig()), "cpu",
                           seed=1)
    res = {}
    for name, vae, device in (("cpu", cpu_vae, "cpu"),
                              ("card", copy.deepcopy(cpu_vae).to(card), card)):
        mel, mel_s = synced(lambda: MelFrontend(MelConfig(), device=device)(wav))
        voc = GriffinLimVocoder(device=device) if name == "card" else None
        out, rec_s = synced(lambda: reconstruct(
            vae, [mel[0].cpu().numpy()], device=device, vocoder=voc))
        res[name] = (mel[0].cpu().numpy(), out, mel_s, rec_s)
    (mel_c, out_c, _, _), (mel_d, out_d, mel_s, rec_s) = res["cpu"], res["card"]
    # fp32 both sides, TF32 off: log-mel within 1e-3 (the JAX frontend's
    # mel-L1 bound, here max-abs), latent means within 2e-4 of their scale
    # (PARITY.md's VAE bound), the denormalized reconstruction within 1e-3
    # (that bound times the mel std 3.86)
    errs = {"log_mel": float(np.abs(mel_d - mel_c).max()),
            "mu": float(np.abs(out_d["mu"][0] - out_c["mu"][0]).max()),
            "recon_mel": float(np.abs(out_d["recons"][0][1]
                                      - out_c["recons"][0][1]).max())}
    bounds = {"log_mel": 1e-3,
              "mu": 2e-4 * max(1.0, float(np.abs(out_c["mu"][0]).max())),
              "recon_mel": 1e-3}
    stats = {k: (out_c[k], out_d[k]) for k in ("mse", "l1", "kl_mean",
                                              "mu_std", "var_mean")}
    log(f"  reconstruction of {mel_c.shape[0]} mel frames: card vs CPU "
        f"max_abs_err {errs} bounds {bounds}; stats (cpu, card) {stats}; "
        f"card: mel {mel_s:.4f} s, reconstruct + 2 Griffin-Lim renders "
        f"{rec_s:.4f} s")
    check(all(errs[k] < bounds[k] for k in errs),
          "reconstruction card vs CPU")
    check(all(abs(a - b) <= 1e-3 * abs(a) + 1e-6 for a, b in stats.values()),
          "reconstruction statistics card vs CPU")
    T_pad = out_d["recons"][0][0].shape[0]
    for w in out_d["wavs"][0]:
        check(w.shape == (T_pad * 256,) and np.isfinite(w).all(),
              "Griffin-Lim render of the reconstruction")
    return {"frames": int(mel_c.shape[0]), "errors": errs,
            "stats_card": {k: out_d[k] for k in stats}, "mel_s": mel_s,
            "reconstruct_with_gl_s": rec_s}


def ids_agreement(x_ref, x_dev, table, ids_ref, ids_dev):
    """Margin-aware agreement of nearest-token ids: a query's id must agree
    wherever the reference's top-1 minus top-2 cosine exceeds twice the
    distance between the two unit-normalised states (no cosine to a unit
    row moves by more than that distance). -> (checked, agreeing, total,
    disagreeing among the checked); computed on x_dev's device, fp32."""
    dev = x_dev.device
    xr, xd, tn = (torch.nn.functional.normalize(t.to(dev).float(), dim=-1)
                  for t in (x_ref, x_dev, table))
    top2 = torch.topk(torch.matmul(xr, tn.t()), 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    bound = 2 * (xd - xr).norm(dim=-1) + 1e-6
    checked = margin > bound
    agree = ids_ref.to(dev) == ids_dev.to(dev)
    return (int(checked.sum()), int(agree.sum()), agree.numel(),
            int((checked & ~agree).sum()))


def first_row_gaps(model, batched, solo, n=3):
    """The first `n` (None: all) modules, in call order, whose output's row
    0 under batched() differs from its row 0 under solo() (the solo
    request's row, or under CFG its conditional row) -> [(name, max
    gap)]."""
    outs = {}

    def hook(name):
        def record(_, __, out):
            if isinstance(out, torch.Tensor):
                outs.setdefault(name, out.detach().clone())
        return record

    handles = [m.register_forward_hook(hook(name))
               for name, m in model.named_modules() if name]
    try:
        with torch.no_grad():
            batched()
            first, outs = outs, {}
            solo()
    finally:
        for h in handles:
            h.remove()
    gaps = [(k, (first[k][:1].float() - v[:1].float()).abs().max().item())
            for k, v in outs.items()
            if k in first and first[k].shape[1:] == v.shape[1:]
            and not torch.equal(first[k][:1], v[:1])]
    return gaps[:n]


def asr_batch_vs_solo(inf, lats, ids, card):
    """asr_batch's rows (ids [B, Q]) against solo calls with the same
    seeds: ids equal a row, the ODE states' largest gap, the margin-aware
    agreement (ids_agreement, the solo call as the reference) and the
    first modules whose batch row 0 differs from the solo row."""
    from audio_calm_torch.eval.infer import asr_decode, asr_encode

    calm = inf.model
    solo = [inf._asr_ids([x], [s], pad_batch=False, **ASR_ODE)[0][0]
            for x, s in zip(lats, ASR_SEEDS)]
    runs = []
    with torch.no_grad():
        for rows in (range(len(lats)),) + tuple((i,) for i in range(
                len(lats))):
            *args, x_init = inf._asr_inputs([lats[i] for i in rows],
                                            [ASR_SEEDS[i] for i in rows])
            cond, q_valid, _ = asr_encode(calm, *args, num_queries=96)
            runs.append((args, cond, asr_decode(
                calm, cond, q_valid, x_init=x_init, **ASR_ODE)))
        (args_b, cond_b, x_b), solos = runs[0], runs[1:]
        t = torch.full((len(lats),), 0.5, device=card)
        where = {
            "encode": first_row_gaps(
                calm, lambda: calm.asr_encode_audio(*args_b, 96),
                lambda: calm.asr_encode_audio(*solos[0][0], 96)),
            "asr_head": first_row_gaps(
                calm, lambda: calm.asr_flow_fn(cond_b, x_b, t),
                lambda: calm.asr_flow_fn(cond_b[:1], x_b[:1], t[:1]))}
    return {"ids_equal": [int((a == b).sum()) for a, b in zip(ids, solo)],
            "state_gap": [(x_b[i] - x[0]).float().abs().max().item()
                          for i, (_, _, x) in enumerate(solos)],
            "margin_aware": ids_agreement(
                torch.cat([x for _, _, x in solos]), x_b,
                calm.embed.embedding, torch.as_tensor(np.stack(solo)),
                torch.as_tensor(ids)),
            "first_differing_modules": where}


def phase_asr_reduced_depth(card):
    """configs/asr.yaml's widths with 2 LLM layers, fp32, card vs CPU, same
    weights, latents and ODE noise: asr_encode's condition, the Euler-20
    ODE's output (the ASR head at d = 48 through K3 on the card) and the
    nearest-token ids, held margin-aware; the card's K3/K4 launches."""
    import copy

    from audio_calm_torch.data.tokenizer import ByteTokenizer
    from audio_calm_torch.eval.infer import (ASR_PROMPT, asr_decode,
                                             asr_encode)
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.flagship import random_normal_
    from audio_calm_torch.ops.attention_kernel import attention_fwd

    cfg = asr_yaml_config(num_llm_layers=2)
    cpu = QwenCALM(cfg).eval().requires_grad_(False)
    random_normal_(cpu, seed=4)
    dev = copy.deepcopy(cpu).to(card)
    g = torch.Generator().manual_seed(8)
    lat = torch.randn(2, 384, 128, generator=g)
    amask = (torch.arange(384)[None, :] < torch.tensor([[384], [235]])).int()
    prompt = torch.tensor([ByteTokenizer().encode(ASR_PROMPT)] * 2)
    x0 = torch.randn(2, 96, 1536, generator=g)
    res = {}
    for name, model, device in (("cpu", cpu, "cpu"), ("card", dev, card)):
        args = [t.to(device) for t in (lat, amask, prompt,
                                       torch.ones_like(prompt))]
        attention_fwd.launches = 0
        cond, q_valid, q_len = asr_encode(model, *args, num_queries=96)
        x = asr_decode(model, cond, q_valid, x_init=x0.to(device), **ASR_ODE)
        ids = model.search_nearest_tokens(x)
        res[name] = [t.cpu() for t in (cond, x, ids, q_len)]
        res[name].append(attention_fwd.launches)
    (cond_c, x_c, ids_c, q_c, _), (cond_d, x_d, ids_d, q_d, n_d) = (
        res["cpu"], res["card"])
    L, n_dit = 2, cfg.asr_flow_num_layers * ASR_ODE["steps"]
    want = L + 1 + n_dit  # Qwen2 layers, cross-attention, DiT self
    errs = {"condition": (cond_d - cond_c).abs().max().item(),
            "ode_state": (x_d - x_c).abs().max().item()}
    # fp32 both sides, TF32 off: summation order through 2 LLM layers and
    # one cross-attention (1e-4 of the largest value), then 20 Euler steps
    # of the 4-layer head (1e-3 of the largest value)
    bounds = {"condition": 1e-4 * max(1.0, cond_c.abs().max().item()),
              "ode_state": 1e-3 * max(1.0, x_c.abs().max().item())}
    checked, agree, total, bad = ids_agreement(
        x_c, x_d.to(card), dev.embed.embedding, ids_c, ids_d)
    log(f"  ASR reduced depth: q_len {q_c.tolist()} / {q_d.tolist()}; "
        f"max_abs_err {errs} bounds {bounds}; ids agree {agree} of {total} "
        f"({100 * agree / total:.1f}%), {checked} past the margin bound, "
        f"{bad} of them disagree; card launches {n_d} (expected {want})")
    check(torch.equal(q_c, q_d) and q_c.tolist() == [96, 58],
          "ASR query lengths")
    check(all(errs[k] <= bounds[k] for k in errs), "ASR card vs CPU")
    check(bad == 0, "ASR ids card vs CPU where the margin decides them")
    check(n_d == want, "ASR kernel launches at reduced depth")
    return {"errors": errs, "bounds": bounds, "ids_agree": agree,
            "ids_total": total, "ids_past_margin": checked}


def phase_asr_main_path(card):
    """ASR at configs/asr.yaml's full width: two seeded wavs through the
    bucketed frontend (flagship VAE, 512 channels) and encode_chunks, then
    CALMInference.asr_batch (28-layer Qwen2 over [audio | SOA | prompt],
    query cross-attention, Euler-20 over the 768 x 4 ASR head at cfg 1,
    nearest-token ids; random bf16 weights from a seed), one seed a row.
    Launches, batch rows against solo calls, phase walls, realtime factor,
    and one profiled request."""
    from audio_calm_torch.config import MelConfig, VAEModelConfig
    from audio_calm_torch.data.tokenizer import ByteTokenizer
    from audio_calm_torch.eval.infer import (ASR_PROMPT, CALMInference,
                                             asr_decode, asr_encode)
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.flagship import build_random
    from audio_calm_torch.models.vae import AcousticVAE
    from audio_calm_torch.ops.attention_kernel import attention_fwd
    from audio_calm_torch.serving.frontend import (encode_chunks,
                                                   make_asr_frontend)

    cfg = asr_yaml_config()
    calm, build_s = synced(lambda: build_random(
        lambda: QwenCALM(cfg), card, seed=5, dtype=torch.bfloat16))
    vae_cfg = VAEModelConfig()
    vae = build_random(lambda: AcousticVAE(vae_cfg), card, seed=1)
    log(f"  asr.yaml model built in {build_s:.1f} s: "
        f"{sum(p.numel() for p in calm.parameters()) / 1e9:.3f} B params "
        f"(bf16), {cfg.qwen.num_hidden_layers} LLM layers, heads "
        f"{cfg.asr_flow_hidden_dim}/{cfg.flow_num_heads}")
    prep, batch = make_asr_frontend(vae, vae_cfg, MelConfig(), ASR_BUCKETS,
                                    device=card)
    inf = CALMInference(calm, ByteTokenizer(), device=card)
    wavs = asr_wavs()
    audio_s = sum(len(w) for w in wavs) / 16000

    def request():
        lats = encode_chunks(prep, batch, wavs)
        return lats, inf.asr_batch(lats, ASR_SEEDS, **ASR_ODE)

    synced(request)  # warm-up: cuBLAS/cuDNN plans, allocator
    attention_fwd.launches = 0
    (lats, texts), wall = synced(request)
    launches = attention_fwd.launches
    # the request's ids, for the checks (the same device work again)
    ids, q_len = inf._asr_ids(lats, ASR_SEEDS, **ASR_ODE)
    L = cfg.qwen.num_hidden_layers
    want = L + 1 + cfg.asr_flow_num_layers * ASR_ODE["steps"]
    prompt_len = len(inf._encode_prompt(ASR_PROMPT))
    seq = cfg.max_audio_len + 1 + prompt_len
    log(f"  ASR request: wavs {[len(w) for w in wavs]} samples -> latents "
        f"{[x.shape[0] for x in lats]} frames (buckets of "
        f"{[prep(w)[0] for w in wavs]} samples); prompt {prompt_len} tokens, "
        f"LLM sequence L = {seq}; q_len {q_len.tolist()}; attention_fwd "
        f"launches {launches} (expected {want}: {L} Qwen2 layers, 1 cross, "
        f"{want - L - 1} ASR head)")
    check(launches == want, "ASR path kernel launches")
    check([x.shape for x in lats] == [(385, 128), (235, 128)] and all(
        np.isfinite(x).all() for x in lats), "ASR frontend latents")
    check(q_len.tolist() == [96, 58] and ids.shape == (2, 96)
          and ((ids >= 0) & (ids < cfg.qwen.vocab_size)).all(),
          "ASR ids and query lengths")
    check(texts == [inf._asr_decode_row(ids[i], q_len[i]) for i in range(2)],
          "asr_batch's transcripts are its ids' decodes")
    check_asr_rows(seq, [min(x.shape[0], cfg.max_audio_len) for x in lats],
                   ids.shape[1], q_len.tolist(), cfg.max_audio_len)
    solo_texts = [inf.asr(x, s, **ASR_ODE) for x, s in zip(lats, ASR_SEEDS)]
    vs_solo = asr_batch_vs_solo(inf, lats, ids, card)
    log(f"  asr_batch rows vs solo asr: {vs_solo}; transcripts equal "
        f"{texts == solo_texts}, {[len(t) for t in texts]} characters")
    # the noise is the seed's alone, but cuBLAS picks its GEMM kernels by
    # row count, so a bf16 row of a batch is a rounding away from the solo
    # row (ROADMAP Queue 3): its ids must agree wherever the margin between
    # the two nearest rows exceeds what that rounding can move
    check(vs_solo["margin_aware"][3] == 0, "asr_batch rows agree with solo "
          "asr calls with the same seeds wherever the margin decides the id")

    # phase walls (host, each ending in a device synchronize)
    walls = {}
    _, walls["frontend_s"] = synced(lambda: encode_chunks(prep, batch, wavs))
    *args, x_init = inf._asr_inputs(lats, ASR_SEEDS)
    with torch.no_grad():
        (cond, q_valid, _), walls["encode_s"] = synced(
            lambda: asr_encode(calm, *args, num_queries=96))
        x, walls["ode_s"] = synced(lambda: asr_decode(
            calm, cond, q_valid, x_init=x_init, **ASR_ODE))
        ids2, walls["search_s"] = synced(lambda: calm.search_nearest_tokens(x))
    check(bool(torch.isfinite(x).all()) and np.array_equal(
        ids2.cpu().numpy(), ids), "ASR phases give the request's ids")
    phase_sum = sum(walls.values())
    row = {"audio_s": audio_s, "wall_s": wall, "realtime_factor": audio_s
           / wall, **walls, "realtime_factor_phase_sum": audio_s / phase_sum,
           "launches": launches, "prompt_tokens": prompt_len, "llm_len": seq,
           "q_len": q_len.tolist(), "latent_frames": [x.shape[0]
                                                       for x in lats],
           "batch_vs_solo": vs_solo}
    p_wall, rows = device_profile(request)
    busy = sum(r[1] for r in rows)
    check(busy > 0, "the profiler saw device time in the ASR request")
    row.update({"profiled_wall_s": p_wall, "device_busy_s": busy,
                "busy_share_of_wall": busy / wall})
    log(f"  ASR: {audio_s:.3f} s of audio in {wall:.4f} s wall, realtime "
        f"factor {audio_s / wall:.2f}x; phases {walls}; device busy "
        f"{busy:.4f} s, {100 * busy / wall:.1f}% of the unprofiled wall")
    for name, s_, n in rows[:8]:
        log(f"    {1e3 * s_:9.3f} ms {n:6d} calls  {name[:90]}")
    return launches, row


def check_asr_rows(llm_len, frames, queries, q_len, audio_grid):
    """The ASR rows phase 6 times (tools/attention_probe.ROWS) are this
    request's shapes: the encode's length and audio frames, the query
    cross-attention's queries, audio grid and frames, the ASR head's
    queries and query lengths."""
    rows = {r[0]: r for r in ROWS}
    enc, cross, head = (rows["ASR Qwen2 encode L=461"], rows["ASR cross d=96"],
                        rows["ASR DiT self d=48"])
    got = [(enc[2], enc[3], enc[8][1]), (cross[2], cross[3], cross[8][1]),
           (head[2], head[3], head[8][1])]
    want = [(llm_len, llm_len, frames), (queries, audio_grid, frames),
            (queries, queries, q_len)]
    log(f"  phase 6's ASR rows {got}; this request's shapes {want}")
    check(got == want, "phase 6's ASR rows (tools/attention_probe.ROWS) "
          "are the ASR request's shapes")


def http_call(port, method, path, body=None, ctype=None, chunks=None,
              first_after=None):
    """One HTTP request to the server on localhost -> (status, headers,
    body, first_s); `chunks` (an iterable of bytes) sends a chunked upload;
    first_s is the time from the request until the body held more than
    `first_after` bytes (None when not asked)."""
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=600)
    try:
        headers = {"Content-Type": ctype} if ctype else {}
        t0 = time.perf_counter()
        if chunks is not None:
            headers["Transfer-Encoding"] = "chunked"
            conn.request(method, path, body=chunks, headers=headers,
                         encode_chunked=True)
        else:
            conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        if first_after is None:
            return resp.status, dict(resp.headers), resp.read(), None
        data, first_s = b"", None
        while True:
            piece = resp.read1(65536)
            if not piece:
                break
            data += piece
            if first_s is None and len(data) > first_after:
                first_s = time.perf_counter() - t0
        return resp.status, dict(resp.headers), data, first_s
    finally:
        conn.close()


def wav_pcm(data):
    """The int16 samples of a WAV body (a streamed one: after its
    44-byte header)."""
    import io
    import wave

    if data[4:8] == b"\xff\xff\xff\xff":
        return np.frombuffer(data[44:], "<i2")
    with wave.open(io.BytesIO(data)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def group_launches(key, cfg):
    """attention_fwd launches of one batcher group: Qwen2's layers, then
    per velocity evaluation the DiT's self and cross attention (TTS) or
    the query cross-attention once and the head's self-attention (ASR)."""
    m, e = cfg.model, cfg.evaluation
    if key[0] == "fe":
        return 0
    evals = key[1] * (2 if e.ode_method == "midpoint" else 1)
    L = m.qwen.num_hidden_layers
    if key[0] == "tts":
        return L + 2 * m.tts_flow_num_layers * evals
    return L + 1 + m.asr_flow_num_layers * evals


def asr_group_states(engine, items):
    """An asr batcher group's device work once more, as asr_batch does it
    (same rows, same padding): seed -> (ODE state, ids, q_len)."""
    from audio_calm_torch.eval.infer import asr_decode, asr_encode

    inf, e = engine.inf, engine.cfg.evaluation
    with torch.inference_mode():
        *args, x_init = inf._asr_inputs([lat for lat, _ in items],
                                        [s for _, s in items])
        cond, q_valid, q_len = asr_encode(inf.model, *args,
                                          num_queries=inf.model.cfg
                                          .max_text_len)
        x = asr_decode(inf.model, cond, q_valid, x_init=x_init,
                       steps=e.asr_steps, cfg_scale=e.asr_cfg_scale,
                       method=e.ode_method, time_schedule=e.time_schedule)
        ids = inf.model.search_nearest_tokens(x)
    return {s: (x[i], ids[i], int(q_len[i])) for i, (_, s) in
            enumerate(items)}


def phase_served_product(card):
    """configs/calm.yaml served by the port's HTTP server in this process
    on the card (read from the file by the port's load_config; byte
    tokenizer, random bf16 weights from a seed, the seeded random VAE,
    Griffin-Lim): a concurrent /tts pair (twice), the first request alone,
    a long-form /tts, a streamed /tts, a 15 s /asr, a 40 s long-form /asr,
    the same 40 s as a chunked streaming upload, /stats. Each request's
    attention launches (none runs beside another), batch groups, wall,
    audio and realtime factor (and the streams' time to their first audio
    or transcript); the repeated pair's bytes; the stream against the
    buffered transcript, margin-aware; the batch-invariant served rows:
    the pair's first row against the solo request (latents bit for bit,
    audio within 2/32768 before the last 4096 samples) and the 40 s
    request's chunks batched against solo calls (every id equal), with no
    module's row 0 differing in either; the batch-invariant product's
    launches on every /tts and /asr; one profiled session's device busy
    share."""
    import gc
    import threading

    from audio_calm_torch.config import load_config
    from audio_calm_torch.ops.attention_kernel import attention_fwd
    from audio_calm_torch.ops.gemm_kernel import linear as gemm_linear
    from audio_calm_torch.serving import server

    gc.collect()
    torch.cuda.empty_cache()
    log(f"  device memory in use before: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB (the models "
        "phases 6 and 7 still time)")
    args = server.parse_args(SERVE_ARGV)
    cfg = load_config(args.config, overrides=args.override)
    m, e = cfg.model, cfg.evaluation
    check((m.qwen.num_hidden_layers, m.qwen.hidden_size,
           m.qwen.num_attention_heads, m.qwen.num_key_value_heads,
           m.lora.rank, m.tts_flow_hidden_dim, m.tts_flow_num_layers,
           m.asr_flow_hidden_dim, m.asr_flow_num_layers, m.flow_num_heads)
          == (28, 1536, 12, 2, 64, 768, 4, 768, 4, 16)
          and e.audio_buckets == [96, 192, 384]
          and e.text_buckets == [32, 64, 96]
          and e.compute_dtype == "bfloat16" and e.vocoder_path is None
          and m.vae_path is None, "configs/calm.yaml read by load_config")
    engine, build_s = synced(lambda: server.build_engine(args))
    calm = engine.inf.model
    check(calm.dtype == torch.bfloat16 and engine.inf.device.type == "cuda",
          "the engine serves calm.yaml on the card in bf16")
    log(f"  calm.yaml engine built in {build_s:.1f} s: "
        f"{sum(p.numel() for p in calm.parameters()) / 1e9:.3f} B CALM "
        f"params (bf16), {m.qwen.num_hidden_layers} LLM layers, heads "
        f"{m.tts_flow_hidden_dim} x {m.tts_flow_num_layers} / "
        f"{m.flow_num_heads}; vocoder Griffin-Lim; {e.ode_method} "
        f"{e.steps} steps cfg {e.cfg_scale} (TTS), {e.asr_steps} (ASR)")

    groups = []  # (key, items, results, seconds) of every batcher group
    run_group = engine.run_group

    def recording(key, items):
        t0 = time.perf_counter()
        out = run_group(key, items)
        groups.append((key, list(items), out, time.perf_counter() - t0))
        return out

    engine.run_group = recording
    srv = server.make_server(engine, args).start()
    port = srv.port
    wav15 = asr_wavs()[1]
    wav40 = served_wav(40, seed=3)
    body15, body40 = (server.wav_bytes(w) for w in (wav15, wav40))

    def call(method, path, body=None, ctype=None, chunked=False,
             first_after=None):
        attention_fwd.launches = 0
        gemm_linear.launches = 0
        g0 = len(groups)
        t0 = time.perf_counter()
        res = http_call(port, method, path, body, ctype, chunks=(
            (body[i:i + 65536] for i in range(0, len(body), 65536))
            if chunked else None), first_after=first_after)
        wall = time.perf_counter() - t0
        return {"status": res[0], "headers": res[1], "data": res[2],
                "first_s": res[3], "wall_s": wall,
                "launches": attention_fwd.launches,
                "gemm_launches": gemm_linear.launches, "groups": groups[g0:]}

    def tts(text, seed, first_after=None, **extra):
        return call("POST", "/tts", json.dumps(
            {"text": text, "seed": seed, **extra}).encode(),
            "application/json", first_after=first_after)

    def pair():
        attention_fwd.launches = 0
        gemm_linear.launches = 0
        g0 = len(groups)
        out = [None, None]
        barrier = threading.Barrier(2)

        def client(i):
            barrier.wait()
            out[i] = http_call(port, "POST", "/tts", json.dumps(
                {"text": SERVE_PAIR[i][0], "seed": SERVE_PAIR[i][1]})
                .encode(), "application/json")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "the /tts pair ended")
        return {"status": [o[0] for o in out], "data": [o[2] for o in out],
                "wall_s": wall, "launches": attention_fwd.launches,
                "gemm_launches": gemm_linear.launches,
                "groups": groups[g0:]}

    def session():
        return {
            "health": call("GET", "/health"),
            "tts_pair": pair(),
            "tts_pair_again": pair(),
            "tts_solo": tts(*SERVE_PAIR[0]),
            "tts_long": tts(SERVE_LONG, 103),
            # the first audio: past the 44-byte WAV header
            "tts_stream": tts(SERVE_STREAM, 104, first_after=44,
                              stream=True),
            "asr_15s": call("POST", "/asr?seed=105", body15, "audio/wav"),
            "asr_40s": call("POST", "/asr?seed=106", body40, "audio/wav"),
            "asr_40s_stream": call("POST", "/asr?stream=1&seed=106", body40,
                                   "audio/wav", chunked=True, first_after=0),
            "stats": call("GET", "/stats"),
        }

    try:
        session()  # warm-up: cuBLAS/cuDNN plans, allocator
        groups.clear()
        r, wall = synced(session)
        busy_wall, rows = device_profile(session)
    finally:
        srv.close()
    busy = sum(x[1] for x in rows)
    check(busy > 0, "the profiler saw device time in the served session")

    # status codes, bodies, groups
    check(r["health"]["status"] == 200 and json.loads(r["health"]["data"])
          == {"status": "ok"}, "/health")
    for name in ("tts_pair", "tts_pair_again"):
        tg = [g for g in r[name]["groups"] if g[0][0] == "tts"]
        check(r[name]["status"] == [200, 200] and len(tg) == 1
              and len(tg[0][1]) == 2, f"{name}: two requests, one group of 2")
    for a, b in zip(r["tts_pair"]["data"], r["tts_pair_again"]["data"]):
        if a != b:
            pa, pb = wav_pcm(a), wav_pcm(b)
            log(f"  repeated pair: {len(pa)} / {len(pb)} samples, "
                f"{int((pa != pb).sum())} differ, by up to "
                f"{int(np.abs(pa.astype(np.int32) - pb).max())} LSB")
    check(r["tts_pair"]["data"] == r["tts_pair_again"]["data"],
          "the repeated pair (same seeds, same group) returns equal bytes")
    check(r["tts_solo"]["status"] == 200 and [len(g[1]) for g in
                                              r["tts_solo"]["groups"]] == [1],
          "the solo /tts: one group of 1")
    fade = int(16000 * e.crossfade_ms / 1000)
    for name, text in (("tts_long", SERVE_LONG), ("tts_stream", SERVE_STREAM)):
        chunks = engine.inf.split_chunks(text)
        lens = [len(w) for g in r[name]["groups"] for w in g[2]]
        pcm = wav_pcm(r[name]["data"])
        check(r[name]["status"] == 200 and len(lens) == len(chunks)
              and len(pcm) == sum(lens) - (len(lens) - 1) * fade,
              f"{name}: {len(chunks)} chunks, crossfaded sample count")
    check(len(engine.inf.split_chunks(SERVE_LONG)) >= 3,
          "the long-form text has 3 chunks or more")
    st = r["tts_stream"]
    check(st["headers"].get("Transfer-Encoding") == "chunked"
          and st["data"][:44] == server.streaming_wav_header()
          and len(st["groups"][0][1]) == 1,
          "the stream: chunked, sentinel header, chunk 0 alone first")
    for name in ("tts_pair", "tts_solo", "tts_long"):
        d = r[name]["data"]
        for x in (d if isinstance(d, list) else [d]):
            check(x[:4] == b"RIFF" and x[8:12] == b"WAVE",
                  f"{name}: a WAV body")
    a15 = json.loads(r["asr_15s"]["data"])
    check(r["asr_15s"]["status"] == 200 and isinstance(a15["text"], str)
          and [(g[0][0], len(g[1])) for g in r["asr_15s"]["groups"]]
          == [("fe", 1), ("asr", 1)], "/asr of 15 s: one frontend, one decode")
    a40 = json.loads(r["asr_40s"]["data"])
    check(r["asr_40s"]["status"] == 200 and a40["chunks"] >= 2,
          "/asr of 40 s: long-form, 2 chunks or more")
    lines = [json.loads(x) for x in r["asr_40s_stream"]["data"].decode()
             .splitlines()]
    done = lines[-1]
    check(r["asr_40s_stream"]["status"] == 200 and done.get("done") is True
          and done["chunks"] == a40["chunks"]
          and [x["chunk"] for x in lines[:-1]] == list(range(done["chunks"]))
          and " ".join(t for t in (x["text"] for x in lines[:-1]) if t)
          == done["text"], "the streamed 40 s upload's NDJSON")
    stats = json.loads(r["stats"]["data"])
    check(stats["batches"]["tts"]["sizes"].get("2", 0) >= 2,
          "/stats: the pairs coalesced into groups of 2")

    # launches: every request's groups, the kernel on the card each time
    for name, x in r.items():
        want = sum(group_launches(g[0], cfg) for g in x["groups"])
        check(x["launches"] == want, f"{name}: attention launches "
              f"{x['launches']} (expected {want})")
    check(all(r[n]["launches"] > 0 for n in r if n.startswith(("tts", "asr"))),
          "K3/K4 launched on every /tts and /asr")
    check(all(r[n]["gemm_launches"] > 0 for n in r
              if n.startswith(("tts", "asr"))),
          "the batch-invariant product launched on every /tts and /asr")

    # the stream against the buffered transcript, margin-aware: the same
    # chunks and seeds, the stream's decoded alone (or as they coalesced),
    # the buffered ones as one batch
    states = {}
    for name in ("asr_40s", "asr_40s_stream"):
        states[name] = {}
        for g in r[name]["groups"]:
            if g[0][0] == "asr":
                got = asr_group_states(engine, g[1])
                check([engine.inf._asr_decode_row(ids.cpu().numpy(), q)
                       for _, ids, q in got.values()] == g[2],
                      f"{name}: the recomputed group gives its transcripts")
                states[name].update(got)
    seeds = list(states["asr_40s"])
    check(sorted(seeds) == sorted(states["asr_40s_stream"]),
          "the stream and the buffered request decode the same chunk seeds")
    (xb, ib), (xs, is_) = ((torch.stack([states[n][s][i] for s in seeds])
                            for i in (0, 1))
                           for n in ("asr_40s", "asr_40s_stream"))
    margin = ids_agreement(xb, xs, calm.embed.embedding, ib, is_)
    stream_vs_buffered = {
        "texts_equal": done["text"] == a40["text"],
        "ids_equal": int((ib == is_).sum()), "ids_total": ib.numel(),
        "state_gap": (xb.float() - xs.float()).abs().max().item(),
        "margin_aware": margin,
        "stream_groups": [len(g[1]) for g in r["asr_40s_stream"]["groups"]
                          if g[0][0] == "asr"],
        "buffered_groups": [len(g[1]) for g in r["asr_40s"]["groups"]
                            if g[0][0] == "asr"]}
    log(f"  /asr stream vs buffered (40 s, {a40['chunks']} chunks): "
        f"{stream_vs_buffered}")
    check(margin[3] == 0, "the streamed transcript agrees with the buffered "
          "one wherever the margin decides the id")

    # the batched row against the solo request, the served contract
    # (tests/test_serve.py::test_tts_concurrent_requests_batch_safely):
    # within 2 LSB of 16-bit audio except the last 4096 samples, the
    # latents bit for bit; no module's row 0 differs
    (key, items, outs, _), = [g for g in r["tts_pair"]["groups"]
                             if g[0][0] == "tts"]
    row = [t for t, _ in items].index(SERVE_PAIR[0][0])
    texts, seeds = [t for t, _ in items], [s for _, s in items]
    kw = dict(steps=key[1], cfg_scale=key[2], method=e.ode_method,
              time_schedule=e.time_schedule)
    with torch.inference_mode():
        lat_b, n_b, grid_b = engine.inf.tts_batch(texts, seeds, **kw)
        lat_s, n_s, grid_s = engine.inf.tts_batch([SERVE_PAIR[0][0]],
                                                  [SERVE_PAIR[0][1]], **kw)
        again = np.clip(engine.render.batch(lat_b, n_b)[row], -1, 1)
    check(np.array_equal(again, outs[row]),
          "the recomputed pair gives the served row")
    tts_gaps = first_row_gaps(
        calm, lambda: engine.inf.tts_batch(
            [texts[row]] + texts[:row] + texts[row + 1:],
            [seeds[row]] + seeds[:row] + seeds[row + 1:], **kw),
        lambda: engine.inf.tts_batch([SERVE_PAIR[0][0]],
                                     [SERVE_PAIR[0][1]], **kw), n=None)
    n = min(n_b[row], n_s[0])
    pb = wav_pcm(r["tts_pair"]["data"][[t for t, _ in SERVE_PAIR].index(
        SERVE_PAIR[0][0])])
    ps = wav_pcm(r["tts_solo"]["data"])
    m_ = min(len(pb), len(ps))
    d = np.abs(pb[:m_].astype(np.int32) - ps[:m_])
    batched_vs_solo = {
        "frames_batched": n_b[row], "frames_solo": n_s[0],
        "grids": [grid_b, grid_s],
        "latent_gap": float(np.abs(lat_b[row, :n] - lat_s[0, :n]).max()),
        "audio_gap_lsb": int(d.max()),
        "audio_gap_lsb_before_last_4096": int(d[:-4096].max()),
        "audio_samples_differing": float((d > 0).mean()),
        "bytes_equal": r["tts_pair"]["data"][0] == r["tts_solo"]["data"],
        "first_differing_modules": tts_gaps}
    log(f"  /tts row of the pair vs the solo request (bf16): "
        f"{batched_vs_solo}")
    check(grid_b == grid_s and n_b[row] == n_s[0] and len(pb) == len(ps),
          "the pair's row and the solo request share a grid and a length")
    check(batched_vs_solo["latent_gap"] == 0.0 and not tts_gaps,
          "the pair's row has the solo request's latents, bit for bit, and "
          "no module's row differs")
    check(batched_vs_solo["audio_gap_lsb_before_last_4096"] <= 2,
          "the pair's row is the solo request's audio within 2/32768 "
          "before the last 4096 samples")
    # asr_batch's rows against solo calls with the same seeds (tests/
    # test_serving_batch.py::test_asr_batch_matches_solo_rows): the 40 s
    # request's chunks as one batch
    a_items = [it for g in r["asr_40s"]["groups"] if g[0][0] == "asr"
               for it in g[1]]
    batch_states = asr_group_states(engine, a_items)
    solo_states = {}
    for it in a_items:
        solo_states.update(asr_group_states(engine, [it]))
    ids_equal = [int((batch_states[s][1] == solo_states[s][1]).sum())
                 for _, s in a_items]
    with torch.inference_mode():
        *args_b, _ = engine.inf._asr_inputs([lat for lat, _ in a_items],
                                            [s for _, s in a_items])
        *args_s, _ = engine.inf._asr_inputs([a_items[0][0]],
                                            [a_items[0][1]], pad_batch=False)
    q = calm.cfg.max_text_len
    asr_gaps = first_row_gaps(
        calm, lambda: calm.asr_encode_audio(*args_b, q),
        lambda: calm.asr_encode_audio(*args_s, q), n=None)
    asr_vs_solo = {
        "rows": len(a_items), "ids_equal": ids_equal, "ids_total": q,
        "state_gap": max((batch_states[s][0].float() - solo_states[s][0]
                          .float()).abs().max().item() for _, s in a_items),
        "first_differing_modules": asr_gaps}
    log(f"  asr_batch rows vs solo calls (bf16): {asr_vs_solo}")
    check(len(a_items) >= 2 and all(k == q for k in ids_equal)
          and not asr_gaps,
          "asr_batch's ids equal the solo calls' ids, every one, and no "
          "module's row differs")

    # per endpoint: wall, device-call seconds, audio, realtime factor,
    # batch sizes, launches
    rows_out = {}
    for name, x in r.items():
        if name in ("health", "stats"):
            audio = 0.0
        elif name.startswith("tts"):
            d = x["data"] if isinstance(x["data"], list) else [x["data"]]
            audio = sum(len(wav_pcm(b)) for b in d) / 16000
        else:
            audio = len(wav40 if "40" in name else wav15) / 16000
        row_ = {"wall_s": x["wall_s"], "device_call_s": sum(
                    g[3] for g in x["groups"]), "audio_s": audio,
                "realtime_factor": audio / x["wall_s"],
                "batches": [f"{g[0][0]}:{len(g[1])}" for g in x["groups"]],
                "launches": x["launches"],
                "gemm_launches": x["gemm_launches"]}
        first = ""
        if x.get("first_s") is not None:
            row_["first_s"] = x["first_s"]
            first = (f", first {'audio' if name.startswith('tts') else 'text'}"
                     f" at {x['first_s']:.4f} s")
        rows_out[name] = row_
        log(f"  {name:15s} wall {x['wall_s']:.4f} s, device calls "
            f"{row_['device_call_s']:.4f} s, audio {audio:.3f} s, realtime "
            f"factor {row_['realtime_factor']:.2f}x, batches "
            f"{row_['batches']}, launches {x['launches']} (gemm "
            f"{x['gemm_launches']}){first}")
    launches = sum(x["launches"] for x in r.values())
    gemm_launches = sum(x["gemm_launches"] for x in r.values())
    log(f"  served session: {wall:.4f} s wall, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}% of the unprofiled wall; profiled wall "
        f"{busy_wall:.4f} s), attention launches {launches}")
    for name, s_, k in rows[:6]:
        log(f"    {1e3 * s_:9.3f} ms {k:6d} calls  {name[:90]}")
    # the attention forward's share, per instantiation (head dim, warpgroups)
    attn = []
    for name, s_, k in rows:
        m = re.search(r"(tc|simt)::attention_kernel<[^>]*>", name)
        if m:
            attn.append({"kernel": m[0], "ms": 1e3 * s_, "calls": k,
                         "us_per_call": 1e6 * s_ / k})
            log(f"    attention forward {m[0]}: {1e3 * s_:.3f} ms in {k} "
                f"calls, {1e6 * s_ / k:.2f} us a call")
    log(f"    attention forward: {sum(a['calls'] for a in attn)} device "
        f"records for {launches} launches")
    check(attn and sum(a["calls"] for a in attn) <= launches,
          "the served session's profile names the attention kernel")
    del engine, srv, calm
    gc.collect()
    torch.cuda.empty_cache()
    return launches, gemm_launches, {"build_s": build_s,
                                     "session_wall_s": wall,
                      "device_busy_s": busy,
                      "busy_share_of_wall": busy / wall,
                      "endpoints": rows_out,
                      "stream_vs_buffered": stream_vs_buffered,
                      "batched_vs_solo_tts": batched_vs_solo,
                      "asr_batch_vs_solo": asr_vs_solo,
                      "stats_tts_sizes": stats["batches"]["tts"]["sizes"],
                      "attention_forward_device": attn}


def encode_profile(model, ids, mask, iters=10):
    """Device time of one encode_text_for_tts (mean of `iters` after a
    warm-up) -> (ms, its 5 costliest kernels as (name, ms, calls) per
    encode)."""
    def fn():
        return model.encode_text_for_tts(ids, mask)

    fn()
    _, rows = device_profile(fn, iters)
    return (1e3 * sum(r[1] for r in rows) / iters,
            [(k[:70], 1e3 * t / iters, n // iters) for k, t, n in rows[:5]])


def phase_checkpoint_product(card, smi):
    """configs/calm.yaml served on checkpoint weights through build_engine
    and HTTP, in this process on the card. A source model (the server's
    seed-0 base, every component and LoRA leaf drawn again from a seed) and
    a source VAE are written by save_reference_checkpoint into a temporary
    directory; then:
      - load_models at fp32 (no cast) equals the source bit for bit, VAE
        included;
      - the server (`--components <dir> --override
        model.vae_path=<dir>/vae.bin`, bf16) holds the source cast to bf16
        bit for bit, and a seeded /tts and an /asr give the bytes, the
        transcript and the ids of an engine built in this process on the
        source itself;
      - AUDIO_CALM_LLM_WEIGHTS=int8: 196 int8 projections on the card, the
        device memory of the two engines, the encode's hidden state and the
        TTS latents against bf16 (relative errors below 2e-2 and 0.1), the
        device time of one B=1 encode in each, and a /tts and an /asr
        served on int8 weights.
    Every request's attention launches are counted; `smi` (the card's name
    and power limit) goes beside the times."""
    import gc

    from audio_calm_torch.config import CALMConfig, VAEModelConfig, load_config
    from audio_calm_torch.data.tokenizer import load_tokenizer
    from audio_calm_torch.eval.infer import tts_generate_latents
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.convert import to_jax_params
    from audio_calm_torch.models.convert_export import \
        save_reference_checkpoint
    from audio_calm_torch.models.flagship import build_random
    from audio_calm_torch.models.lora import LoRADense
    from audio_calm_torch.models.quant import (_PROJ_NAMES,
                                               quantized_bytes_saved)
    from audio_calm_torch.models.vae import AcousticVAE
    from audio_calm_torch.ops.attention_kernel import attention_fwd
    from audio_calm_torch.serving import server
    from audio_calm_torch.train.checkpoint import COMPONENTS, LORA_LEAVES

    gc.collect()
    torch.cuda.empty_cache()
    out, launches = {}, 0
    tmp = tempfile.mkdtemp()
    try:
        argv = ["--config", "configs/calm.yaml", "--byte-tokenizer",
                "--port", "0", "--components", tmp, "--override",
                f"model.vae_path={tmp}/vae.bin"]
        args = server.parse_args(argv)
        cfg = load_config(args.config, cls=CALMConfig,
                          overrides=args.override)
        m, e = cfg.model, cfg.evaluation
        check(e.compute_dtype == "bfloat16" and m.lora.rank == 64
              and m.qwen.num_hidden_layers == 28,
              "configs/calm.yaml with its checkpoint overrides")

        # 1. the source model and its reference-layout directory
        source = build_random(lambda: QwenCALM(m), card, seed=0)
        trained = [k for k, _ in source.named_parameters()
                   if k.split(".")[0] in COMPONENTS
                   or k.endswith(LORA_LEAVES)]
        g = torch.Generator(card).manual_seed(CKPT_SEED)
        params = dict(source.named_parameters())
        with torch.no_grad():
            for k in trained:
                params[k].normal_(0.0, 0.02, generator=g)
        vae_cfg = VAEModelConfig(latent_channels=m.latent_dim)
        src_vae = build_random(lambda: AcousticVAE(vae_cfg), card,
                               seed=CKPT_VAE_SEED)
        sd = source.state_dict()
        files, write_s = synced(lambda: save_reference_checkpoint(
            to_jax_params({k: sd[k] for k in trained}), tmp,
            vae_params=to_jax_params(src_vae.state_dict())))
        names = sorted(os.path.basename(f) for f in files)
        check(names == sorted([f"{c}.bin" for c in COMPONENTS]
                              + ["adapter_model.bin", "vae.bin"]),
              f"the reference layout: {names}")
        dir_bytes = sum(os.path.getsize(f) for f in files)
        n_trained = sum(params[k].numel() for k in trained)
        log(f"  wrote {len(files)} files, {dir_bytes / 1e9:.3f} GB "
            f"({n_trained / 1e6:.1f} M trained CALM params + the VAE) in "
            f"{write_s:.2f} s")

        # 2a. the loader before the cast: fp32, bit for bit
        cfg32 = load_config(args.config, cls=CALMConfig,
                            overrides=args.override
                            + ["evaluation.compute_dtype=float32"])
        (m32, v32), load32_s = synced(lambda: server.load_models(cfg32, card,
                                                                 tmp))
        got = m32.state_dict()
        check(set(got) == set(sd) and not [k for k in sd if not torch.equal(
            got[k], sd[k])], "every CALM parameter loads bit for bit (fp32)")
        vsd = src_vae.state_dict()
        check(all(torch.equal(t, vsd[k]) for k, t in
                  v32.state_dict().items()) and set(vsd) == set(
                      v32.state_dict()), "the VAE loads bit for bit")
        del m32, v32, got
        gc.collect()
        torch.cuda.empty_cache()

        # 2b. the served product on the loaded weights (bf16) against an
        # engine on the source itself
        mem0 = torch.cuda.memory_allocated()
        engine, build_s = synced(lambda: server.build_engine(args))
        mem_bf16 = torch.cuda.memory_allocated() - mem0
        model = engine.inf.model
        source.to(torch.bfloat16)  # as load_models casts
        got = model.state_dict()
        sd = source.state_dict()
        check(set(got) == set(sd) and all(torch.equal(got[k], sd[k])
                                          for k in sd)
              and model.dtype == torch.bfloat16,
              "the served model is the source cast to bf16, bit for bit")
        del got
        ref = server.make_engine(engine.cfg, source, src_vae,
                                 load_tokenizer(m, byte_fallback=True), card)
        body15 = server.wav_bytes(asr_wavs()[1])

        def serve(eng):
            """One seeded /tts and one /asr -> (responses, launches, asr
            groups)."""
            groups = []
            run_group = eng.run_group

            def recording(key, items):
                res = run_group(key, items)
                groups.append((key, list(items), res))
                return res

            eng.run_group = recording
            srv = server.make_server(eng, args).start()
            try:
                res, n = [], []
                for path, body, ctype in (
                        ("/tts", json.dumps({"text": CKPT_TEXT,
                                             "seed": CKPT_TTS_SEED}).encode(),
                         "application/json"),
                        (f"/asr?seed={CKPT_ASR_SEED}", body15, "audio/wav")):
                    attention_fwd.launches = 0
                    status, _, data, _ = http_call(srv.port, "POST", path,
                                                   body, ctype)
                    n.append(attention_fwd.launches)
                    check(status == 200, f"{path} on checkpoint weights")
                    res.append(data)
            finally:
                srv.close()
                eng.run_group = run_group
            want = sum(group_launches(k, eng.cfg) for k, _, _ in groups)
            check(sum(n) == want > 0, f"attention launches {n} (expected "
                  f"{want} in total)")
            return res, n, [gr for gr in groups if gr[0][0] == "asr"]

        (tts_l, asr_l), n_l, asr_groups = serve(engine)
        (tts_r, asr_r), n_r, _ = serve(ref)
        launches += sum(n_l) + sum(n_r)
        n_ids = 0
        for _, items, _ in asr_groups:
            sl, sr = (asr_group_states(x, items) for x in (engine, ref))
            check(all(torch.equal(sl[k][1], sr[k][1]) for k in sl),
                  "/asr on the loaded server = the source engine: ids")
            n_ids += sum(v[1].numel() for v in sl.values())
        check(tts_l[:4] == b"RIFF" and tts_l == tts_r,
              "a seeded /tts on the loaded server = the same request on the "
              "source engine, byte for byte")
        check(asr_l == asr_r, "/asr on the loaded server = the source "
              "engine: the transcript")
        log(f"  loaded fp32 in {load32_s:.2f} s; bf16 engine built in "
            f"{build_s:.2f} s; /tts {len(wav_pcm(tts_l)) / 16000:.3f} s of "
            f"audio, equal bytes; /asr {json.loads(asr_l)['text'][:40]!r}, "
            f"equal ids ({n_ids}); launches {n_l} / {n_r}")
        del ref, source, src_vae, sd
        gc.collect()
        torch.cuda.empty_cache()

        # 3. int8 LLM weights through the environment switch
        os.environ["AUDIO_CALM_LLM_WEIGHTS"] = "int8"
        try:
            mem0 = torch.cuda.memory_allocated()
            engine8, build8_s = synced(lambda: server.build_engine(args))
            mem_int8 = torch.cuda.memory_allocated() - mem0
        finally:
            del os.environ["AUDIO_CALM_LLM_WEIGHTS"]
        m8 = engine8.inf.model
        proj = [mod for name, mod in m8.llm.named_modules()
                if isinstance(mod, LoRADense)
                and name.rsplit(".", 1)[-1] in _PROJ_NAMES]
        check(len(proj) == 7 * m.qwen.num_hidden_layers and all(
            p.weight.dtype == torch.int8 and p.weight.is_cuda for p in proj),
            "AUDIO_CALM_LLM_WEIGHTS=int8: the 196 projections are int8 on "
            "the card")
        n_proj = sum(p.weight.numel() for p in proj)
        scale_bytes = sum(4 * p.kernel_scale.numel() for p in proj)

        ids, mask = engine.inf._prompt_arrays(CKPT_TEXT)
        ids_t = torch.as_tensor(ids, device=card)
        mask_t = torch.as_tensor(mask, device=card)
        valid = torch.cat([mask_t[0], mask_t.new_ones(1)]) != 0

        def hidden(mdl):
            cond, ctx, _ = mdl.encode_text_for_tts(ids_t, mask_t)
            return torch.cat([ctx, cond], dim=1)[0, valid].float()

        with torch.inference_mode():
            h16, h8 = hidden(model), hidden(m8)
            rel_h = ((h8 - h16).norm() / h16.norm()).item()
            n16 = int(model.predict_length(*model.encode_text_for_tts(
                ids_t, mask_t)[1:]).item())
            n8 = int(m8.predict_length(*m8.encode_text_for_tts(
                ids_t, mask_t)[1:]).item())
            grid = next(b for b in e.audio_buckets if b >= n16)
            x0 = torch.randn(1, grid, m.latent_dim, device=card,
                             generator=torch.Generator(card).manual_seed(5))
            kw = dict(steps=16, cfg_scale=e.cfg_scale, t_aud=grid,
                      num_frames_override=n16, method=e.ode_method,
                      time_schedule=e.time_schedule, x_init=x0, device=card)
            l16 = tts_generate_latents(model, ids_t, mask_t, **kw)[0][0, :n16]
            l8 = tts_generate_latents(m8, ids_t, mask_t, **kw)[0][0, :n16]
            rel_l = ((l8 - l16).norm() / l16.norm()).item()
            enc16, top16 = encode_profile(model, ids_t, mask_t)
            enc8, top8 = encode_profile(m8, ids_t, mask_t)
        check(np.isfinite(rel_h) and rel_h < 2e-2,
              f"int8 hidden state within 2e-2 of bf16 ({rel_h:.3e})")
        check(np.isfinite(rel_l) and rel_l < 0.1,
              f"int8 TTS latents within 0.1 of bf16 ({rel_l:.3e})")
        (tts8, asr8), n8_launches, _ = serve(engine8)
        launches += sum(n8_launches)
        check(tts8[:4] == b"RIFF" and len(wav_pcm(tts8)) > 0
              and isinstance(json.loads(asr8)["text"], str),
              "/tts and /asr served on int8 weights")
        out = {
            "card": smi, "dir_bytes": dir_bytes, "write_s": write_s,
            "load_fp32_s": load32_s, "build_bf16_s": build_s,
            "build_int8_s": build8_s, "int8_projections": len(proj),
            "int8_params": n_proj,
            "bf16_weight_bytes_same_projections": 2 * n_proj,
            "scale_bytes": scale_bytes,
            "bytes_saved_vs_fp32": quantized_bytes_saved(m8),
            "engine_memory_bf16": mem_bf16, "engine_memory_int8": mem_int8,
            "prompt_positions": int(valid.sum()), "frames": [n16, n8],
            "hidden_rel_err": rel_h, "latent_rel_err": rel_l,
            "encode_ms_bf16": enc16, "encode_ms_int8": enc8,
            "encode_top_kernels_bf16": top16, "encode_top_kernels_int8": top8,
            "encode_bound_ms_bf16": 2 * n_proj / H100_BYTES_PER_S * 1e3,
            "encode_bound_ms_int8_plain": 5 * n_proj / H100_BYTES_PER_S
            * 1e3, "launches": launches}
        log(f"  int8 ({smi}): {len(proj)} projections, {n_proj / 1e9:.3f} B "
            f"params: {2 * n_proj / 1e9:.3f} GB in bf16, {n_proj / 1e9:.3f} "
            f"GB in int8 + {scale_bytes / 1e6:.2f} MB of scales; engine "
            f"memory {mem_bf16 / 1e9:.3f} GB bf16, {mem_int8 / 1e9:.3f} GB "
            f"int8 (torch.cuda.memory_allocated after - before each build); "
            f"hidden rel err {rel_h:.3e}, latents {rel_l:.3e} (frames "
            f"{n16} / {n8}); B=1 encode of {int(valid.sum())} positions "
            f"{enc16:.4f} ms bf16, {enc8:.4f} ms int8 (device time)")
        for name, rows in (("bf16", top16), ("int8", top8)):
            for kname, ms, calls in rows:
                log(f"    {name} encode: {ms:8.4f} ms {calls:4d} calls  "
                    f"{kname}")
        del engine, engine8, model, m8
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def kernel_time_resblock(vocs, v1_gen, launches, worst, card):
    """K6 per launch at the odd-width render's resblock shapes (B=2,
    384-frame grid: [2, 98304, 96], [2, 196608, 48], [2, 393216, 24], k =
    3, 7, 11) and at V1's C=128 and C=256 resblock shapes, fp32
    activations and bf16 operands as the render runs them, on the
    generators' own weights, through tools/resblock_probe.time_shape: the
    kernel alone (`ms`) and the whole wrapper call, weight layout included
    (`call_ms`), beside the bound and the plain version; no single library
    call computes a resblock. Each shape's log line carries its plan and
    the earlier design's time (K6_EARLIER_MS), which the `kernels` line
    does not."""
    from audio_calm_torch.ops.vocoder_kernel import stack_resblock
    from audio_calm_torch.tools.resblock_probe import time_shape

    g = torch.Generator(card).manual_seed(6)
    odd = vocs["odd_width"].generator
    rows = []
    for label, gen, index, T in (("odd-width C=96", odd, 1, 98304),
                                 ("odd-width C=48", odd, 2, 196608),
                                 ("odd-width C=24", odd, 3, 393216),
                                 ("V1 C=128", v1_gen, 1, 98304),
                                 ("V1 C=256", v1_gen, 0, 12288)):
        for rb in gen.resblocks[index]:
            block = stack_resblock(rb)
            k, C = block[4], block[0].shape[-1]
            x = torch.randn(2, T, C, generator=g, device=card)
            row = time_shape(label, x, block, reps=1)
            rows.append(row)
            p = row["plan"]
            log(f"  fused_resblock {label} k={k}: {row['ms']:.4f} ms "
                f"(call {row['call_ms']:.4f}; earlier design "
                f"{K6_EARLIER_MS.get((label, k))} ms, PERF.md run U14), plain "
                f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"({row['bound_by']}); plan: tile {p['tile']}, window "
                f"{p['Lp']}, {p['stages']} stages, N {p['split']} of "
                f"{p['width']} (k padded to {p['kpad']}); executed/useful "
                f"{row['executed']:.3f}")
    path = [r for r in rows if r["shape"].startswith("odd-width")]

    def mean(key):
        return float(np.mean([r[key] for r in path]))

    bound_by = max(("operations", "bytes"),
                   key=lambda b: sum(r["bound_by"] == b for r in path))
    return {
        "name": "fused_resblock", "route": "cuda",
        "source": "audio_calm_torch/csrc/resblock.cu",
        "replaces": "audio_calm_tpu/ops/pallas_vocoder.py:249",
        "launches": launches, "max_abs_err": worst,
        "ms": mean("ms"), "call_ms": mean("call_ms"),
        "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": bound_by, "library_ms": None,
        "library": "none (no single call computes a resblock)",
        "per_launch": "mean over the odd-width render's 9 resblock shapes "
                      "(B=2, 384-frame grid: C=96, 48, 24 x k=3, 7, 11), "
                      "the kernel alone; call_ms the whole wrapper call; "
                      "V1's C=128 and C=256 shapes listed beside",
        "shapes": [{key: r[key] for key in (
            "shape", "x", "k", "ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "executed", "padding", "max_abs_err")} for r in rows],
    }


def kernel_time_narrow_stages(v2_gen, card):
    """K1 at HiFi-GAN V2's two narrowest stages (B=2, 384-frame grid):
    C_in 32 -> C 16 and 16 -> 8, channels zero-padded to 32 inside."""
    from audio_calm_torch.ops.vocoder_kernel import (vocoder_stage,
                                                     vocoder_stage_plain)

    g = torch.Generator(card).manual_seed(7)
    rows = []
    for index, C_in, T in ((2, 32, 98304), (3, 16, 196608)):
        args = stage_args(v2_gen, index, torch.randn(2, T, C_in, generator=g,
                                                     device=card))
        ms = device_ms(lambda: vocoder_stage(*args), 3)
        plain = device_ms(lambda: vocoder_stage_plain(*args), 3)
        flops, nbytes = stage_cost(args, 4, 2)
        b, by = bound_ms(flops, nbytes)
        rows.append({"stage": f"V2 {index}", "x": list(args[0].shape),
                     "C": C_in // 2, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by})
        log("  vocoder_stage " + json.dumps(rows[-1]))
    return rows


def attention_batch_invariance(card):
    """Each row of a B = 4 launch equals the same row launched alone, bit
    for bit, at a served shape of each plan kind (calm.yaml's DiT self
    attention on the 192 grid; the ASR encode, packed with its keys split
    between two warpgroups)."""
    from audio_calm_torch.ops.attention_kernel import attention_fwd

    out = {}
    for label in ("TTS DiT self d=48 T=192 B=4", "ASR Qwen2 encode L=461"):
        row = next(r for r in ROWS if r[0] == label)
        q, k, v, valid = row_inputs((label, 4) + row[2:], card, seed=2)
        causal = row[7]
        batch = attention_fwd(q, k, v, valid, causal)
        equal = [torch.equal(batch[b], attention_fwd(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], valid[b:b + 1], causal)[0])
            for b in range(4)]
        log(f"  attention_fwd batch invariance, {label}: B=4 rows equal to "
            f"B=1 launches, bit for bit: {equal}")
        check(all(equal), f"attention_fwd {label}: a batch row differs "
              f"from the row launched alone")
        out[label] = sum(equal)
    return out


def phase_kernel_times(voc, counts, errs, card):
    """ms per launch at main-path shapes, beside bound, plain and library."""
    from audio_calm_torch.ops.vocoder_kernel import (stage_plan,
                                                     vocoder_stage,
                                                     vocoder_stage_plain)

    g = torch.Generator(card).manual_seed(1)
    gen = voc.generator
    cdt = voc.compute_dtype
    kernels = []

    # vocoder: the three stages of the 384-frame render (batch padded to 2)
    rows = []
    for index, C_in, T in ((1, 128, 98304), (2, 128, 98304), (3, 64, 196608)):
        args = stage_args(gen, index, torch.randn(2, T, C_in, generator=g,
                                                  device=card))
        ms = device_ms(lambda: vocoder_stage(*args, compute_dtype=cdt), 3)
        plain = device_ms(
            lambda: vocoder_stage_plain(*args, compute_dtype=cdt), 3)
        flops, nbytes = stage_cost(args, 4, 2 if cdt == torch.bfloat16 else 4)
        b, by = bound_ms(flops, nbytes)
        # the bf16 kernel's tile plan and what it reckons (not measured):
        # this log line only, beside the earlier design's time (a constant)
        x, ups_w, _, blocks = args
        B, T_in, C_in = x.shape
        C, r = blocks[0][0].shape[-1], (1 if ups_w is None else 2)
        geom = [(blk[4], blk[5]) for blk in blocks]
        plan = stage_plan(C, r, geom, T_in * r, B)
        ratio, l2 = stage_reckoning(plan, C, C_in, r,
                                    0 if ups_w is None else ups_w.shape[0],
                                    geom, T_in * r)
        rows.append({"stage": index, "x": list(x.shape), "ms": ms,
                     "plain_ms": plain, "bound_ms": b, "bound_by": by,
                     "flop": flops, "bytes": nbytes})
        log(f"  vocoder_stage stage {index}: {ms:.3f} ms (bound {b:.3f}, "
            f"plain {plain:.3f}; three-buffer design "
            f"{K1_THREE_BUFFER_MS[index]:.3f}, PERF.md); plan: tile "
            f"{plan.tile}, window {plan.Lp}, ring {plan.stages} stages, "
            f"executed/useful {ratio:.3f}, L2 weight bytes {l2:.4g}")
    kernels.append({
        "name": "vocoder_stage", "route": "cuda",
        "source": "audio_calm_torch/csrc/vocoder_stage.cu",
        "replaces": "audio_calm_tpu/ops/pallas_vocoder.py:514",
        "launches": counts["vocoder_stage"],
        "max_abs_err": errs["vocoder_stage"],
        "ms": float(np.mean([r["ms"] for r in rows])),
        "plain_ms": float(np.mean([r["plain_ms"] for r in rows])),
        "bound_ms": float(np.mean([r["bound_ms"] for r in rows])),
        "bound_by": "operations", "library_ms": None,
        "per_launch": "mean over the 3 stages of one B=2 render at the "
                      "384-frame grid", "stages": rows,
    })
    check(all(r["bound_by"] == "operations" for r in rows), "stage bound")

    # attention: every row of tools/attention_probe.ROWS (the flagship's
    # request, calm.yaml's TTS head and text buckets, asr.yaml's request, two
    # rows past the old 512 gate); the line's numbers are the mean weighted
    # by each served row's launches a request
    rows = []
    for row in ROWS:
        rows.append(time_row(row, card, reps=1, seed=1))
        log(f"  attention_fwd {json.dumps(rows[-1])}; earlier design "
            f"{K3_EARLIER_MS.get(row[0])} ms (PERF.md, run P)")
    served = [r for r in rows if r["launches_per_request"] > 0]
    w = np.array([r["launches_per_request"] for r in served], float)

    def wmean(key):
        return float(np.dot(w, [r[key] for r in served]) / w.sum())

    bound_by = max(("operations", "bytes"),
                   key=lambda k: sum(wi for wi, r in zip(w, served)
                                     if r["bound_by"] == k))
    kernels.append({
        "name": "attention_fwd", "route": "cuda",
        "source": "audio_calm_torch/csrc/attention_fwd.cu",
        "replaces": "audio_calm_tpu/ops/pallas_attention.py:91",
        "also_replaces": "audio_calm_tpu/ops/pallas_attention.py:181",
        "launches": counts["attention_fwd"],
        "max_abs_err": max(errs["attention_fwd"],
                           max(r["max_abs_err"] for r in rows)),
        "ms": wmean("ms"), "plain_ms": wmean("plain_ms"),
        "bound_ms": wmean("bound_ms"), "bound_by": bound_by,
        "library_ms": wmean("library_ms"),
        "per_launch": "mean over the served rows of "
                      "tools/attention_probe.ROWS (the flagship's request, "
                      "calm.yaml's TTS head and text buckets, asr.yaml's "
                      "request), weighted by each row's launches a request",
        "shapes": rows,
        "batch_invariance": attention_batch_invariance(card),
    })
    return kernels


def kernel_time_attention_bwd(train_counts, train_steps, errs, card):
    """K5 at the training path's shape (one Qwen2 layer of one microbatch
    slice: B=16, bf16, causal, the [text | pads | SOA] key mask), at the
    plain ASR step's (B=2 of asr.yaml's 16 in 8 slices, 461 positions, the
    [audio | pads | SOA | prompt] key mask) and at the DiT self-attention
    shape of a dropout-off training slice (B=16, 384 frames, the
    audio-frame key mask), and at the distillation students' shapes
    (tts.yaml's DiT self and cross at B=32, asr.yaml's ASR head self at
    B=16, d = 48), and at a causal row of 1024 past the TPU's 512 gate:
    device ms per launch beside the bound, the plain
    version and autograd's backward of SDPA. The row's top-level numbers
    are the Qwen2 shape's, the path's K5 launches."""
    import torch.nn.functional as F

    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_bwd_plain,
                                                       attention_fwd)

    rows = []
    for label, inputs, B, causal in (
            ("Qwen2 training slice", qwen_train_inputs, 16, True),
            ("Qwen2 plain-ASR training slice", asr_train_inputs, 2, True),
            ("DiT self training slice", dit_train_inputs, 16, False),
            ("DiT self distillation student", dit_train_inputs, 32, False),
            ("DiT cross distillation student", dit_cross_inputs, 32,
             False),
            ("ASR head self distillation student", asr_head_inputs, 16,
             False),
            ("causal past 512", long_causal_inputs, 2, True)):
        q, k, v, dout, valid = inputs(B, torch.bfloat16, card, seed=2)
        B, T, Hq, d = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        with torch.no_grad():
            out = attention_fwd(q, k, v, valid, causal)
            bwd = lambda: attention_bwd(q, k, v, out, dout, valid, causal)
            bwd()
            _, prof = device_profile(bwd, 50)
            passes = {f"pass_{name}_ms": 1e3 / 50 * sum(
                r[1] for r in prof if re.search(rf"\b{kern}_kernel<", r[0]))
                for name, kern in (("a", "dq"), ("b", "dkv"))}
            ms = 1e3 / 50 * sum(r[1] for r in prof)
            plain = device_ms(lambda: attention_bwd_plain(
                q, k, v, out, dout, valid, causal), 10)
        mask = valid[:, None, None, :]
        if causal:
            mask = mask & torch.ones(T, S, dtype=torch.bool,
                                     device=card).tril(S - T)
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, enable_gqa=Hq != Hkv)
        g = dout.transpose(1, 2)
        lib = device_ms(lambda: torch.autograd.grad(lib_out, leaves, g,
                                                    retain_graph=True), 50)
        # five products of 2*d per attended (query, key) pair and head;
        # bytes: q, k, v, o, dO read once, dq, dk, dv written once, the mask
        flops = 2.5 * attn_cost(q, k, valid, causal)[0]
        nbytes = (4 * q.numel() + 4 * k.numel()) * 2 + valid.numel()
        b, by = bound_ms(flops, nbytes)
        rows.append({"shape": label, "q": [B, T, Hq, d], "kv": [B, S, Hkv, d],
                     "causal": causal, "ms": ms, **passes, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": b, "bound_by": by,
                     "flop": flops, "bytes": nbytes})
        log("  attention_bwd " + json.dumps(rows[-1]))
    top = rows[0]
    return {
        "name": "attention_bwd", "route": "cuda",
        "source": "audio_calm_torch/csrc/attention_bwd.cu",
        "replaces": "audio_calm_tpu/ops/pallas_attention.py:306",
        "launches": train_counts["attention_bwd"],
        "launches_per_step": train_counts["attention_bwd"] // train_steps,
        "max_abs_err": errs["attention_bwd"],
        **{key: top[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        "per_launch": "one Qwen2 layer's backward for one microbatch slice: "
                      "q [16, 97, 12, 128], k/v [16, 97, 2, 128], bf16, "
                      "causal, ragged key mask; the plain-ASR, DiT self and "
                      "distillation students' and a causal row of 1024 "
                      "beside",
        "shapes": rows,
    }


# the packed training recipe (phase 5i): configs/tts.yaml through the port's
# train_calm on a synthetic store the port writes (the byte tokenizer; no
# download); run 1 takes PACKED_STEPS steps, run 2 resumes from its
# checkpoint to PACKED_RESUME_TO, then PACKED_TIMED more steps are timed
PACKED_STORE = ["--asr-n", "0", "--tts-n", "640", "--dev-n", "16",
                "--seed", "3"]
PACKED_EVAL_BATCHES = 2  # 16 dev items in eval batches of 8
PACKED_STEPS, PACKED_RESUME_TO, PACKED_TIMED = 2, 6, 4


CORPUS = {"asr": "LibriSpeech", "tts": "LibriTTS_R"}


def recipe_argv(config, tasks, store, out, max_steps, *extra):
    """train_calm's argv for a shipped config at full width on `store`
    (the synthetic corpus of each task in `tasks`, its dev split for
    eval): the byte tokenizer, no Qwen2 base weights, a log every step,
    then the overrides in `extra`; everything else the recipe's."""
    argv = ["--config", config, "--byte-tokenizer", "--max-steps",
            str(max_steps)]
    ovs = []
    for task in tasks:
        src = f"data.datasets.{task}"
        ovs += [f"{src}.latent_dir={store}/train/{CORPUS[task]}",
                f"{src}.eval_latent_dir={store}/dev/{CORPUS[task]}",
                f"{src}.subsets=train-clean-100"]
    for ov in ovs + ["model.qwen_path=null", f"training.output_dir={out}",
                     "training.logging_steps=1", *extra]:
        argv += ["--override", ov]
    return argv


def packed_train_argv(store, out, max_steps, *extra):
    """train_calm's argv for configs/tts.yaml at full width on `store`: a
    save and an eval every 2 steps."""
    return recipe_argv("configs/tts.yaml", ("tts",), store, out, max_steps,
                       "training.save_steps=2", "training.eval_steps=2",
                       *extra)


def time_steps(step, raws, batches, flops, counters, zero, card):
    """Each batch's step timed alone (the first batch's step once before,
    to warm its shape): step seconds, utterances (or mels)/s, MFU, peak
    memory (of
    the process, whatever else it holds, and the steps' own: the peak's
    rise above what was allocated before them) and the attention launches
    a step."""
    from audio_calm_torch.utils.profiling import device_peak_flops

    synced(lambda: step(batches[0]))
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero()
    times = [synced(lambda b=b: step(b))[1] for b in batches]
    counts = counters()
    n_utt = [raw.get("n_samples") or raw["mel" if "mel" in raw
                                          else "latents"].shape[0]
             for raw in raws]
    return {"steps": len(times), "utterances": n_utt, "step_s": times,
            "step_s_median": sorted(times)[len(times) // 2],
            "utterances_per_s": sum(n_utt) / sum(times),
            "tflop_per_step": [f / 1e12 for f in flops],
            "mfu_pct": 100.0 * sum(flops) / sum(times)
            / device_peak_flops(card),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "step_mem_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
            "launches_per_step": {k: v // len(times)
                                  for k, v in counts.items()},
            "launches": counts}


def packed_records(out):
    """metrics.jsonl of a run -> (train records, eval records)."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return ([r for r in recs if "loss" in r],
            [r for r in recs if "eval_loss" in r])


def check_packed_run(run, out, counts, first_step, cfg):
    """Finite metrics.jsonl with samples_per_sec and mfu_pct each step, the
    steps numbered on from `first_step`, and the launches: none in the
    packed steps (Qwen2 rows with segment ids take the plain masked
    attention, the DiT with its dropout on plain torch), K3/K4 once a
    Qwen2 layer and twice a DiT layer in each eval forward."""
    train, evals = packed_records(out)
    steps = [r["step"] for r in train]
    check(steps == list(range(first_step, first_step + len(steps)))
          and [r["step"] for r in run.history] == steps,
          f"packed run steps {steps}")
    for r in train:
        check(all(np.isfinite(r[k]) and r[k] > 0 for k in (
            "loss", "samples_per_sec", "mfu_pct", "loss_den")),
            f"packed step {r['step']} metrics {r}")
    check(len(evals) >= 1 and all(np.isfinite(r["eval_loss"])
                                  for r in evals), "packed run eval loss")
    per_eval = cfg.qwen.num_hidden_layers + 2 * cfg.tts_flow_num_layers
    want = {"attention_fwd": len(evals) * PACKED_EVAL_BATCHES * per_eval,
            "attention_bwd": 0}
    log(f"  launches: {counts} (expected {want}: 0 in {len(train)} packed "
        f"steps, {per_eval} in each of {len(evals) * PACKED_EVAL_BATCHES} "
        "eval forwards)")
    check(counts == want, "kernel launches of the packed training run")
    return train, evals


def check_components_served(config, run):
    """The components a train_calm run exported, loaded through the served
    product's --components path (build_engine, fp32), equal the trained
    tensors -> the load's wall seconds."""
    from audio_calm_torch.serving.server import build_engine
    from audio_calm_torch.serving.server import parse_args as serve_args
    from audio_calm_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    engine = build_engine(serve_args([
        "--config", config, "--byte-tokenizer",
        "--components", run.components_dir,
        "--override", "model.vae_path=null",
        "--override", "evaluation.compute_dtype=float32"]))
    served = engine.inf.model.state_dict()
    trained = ckpt.component_state_dict(run.model)
    same = [n for n, v in trained.items()
            if torch.equal(served[n], v.float())]
    wall = time.perf_counter() - t0
    log(f"  --components: {len(same)} of {len(trained)} component and "
        f"LoRA tensors served equal to the trained ones ({wall:.1f} s)")
    check(len(same) == len(trained) > 0,
          "the exported components load through --components")
    del engine, served
    return wall


def phase_packed_training(card, smi):
    """The shipped TTS training recipe at full width: configs/tts.yaml
    (Qwen2-1.5B 28 layers, frozen bf16 base, LoRA r64, DiT 1024 x 4, full
    remat, packed rows of 256 tokens, 16 rows in 2 slices) through
    `python -m audio_calm_torch.train.train_calm` in this process, on a
    synthetic store written by audio_calm_torch.data.synth_corpus: run 1
    takes 2 steps (an eval and a checkpoint at step 2), its train state
    restores bit for bit, run 2 resumes from it to step 6 (evals and
    checkpoints at 4 and 6, the best kept), then 4 more steps on the
    recipe's own batches are timed one by one; the exported components
    load through the served product's --components path (build_engine)
    and equal the trained tensors."""
    import gc

    from audio_calm_torch.config import TrainingConfig
    from audio_calm_torch.data import synth_corpus
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_fwd)
    from audio_calm_torch.train import checkpoint as ckpt
    from audio_calm_torch.train import train_calm
    from audio_calm_torch.train.optim import AdamW

    def counters():
        return {"attention_fwd": attention_fwd.launches,
                "attention_bwd": attention_bwd.launches}

    def zero():
        attention_fwd.launches = attention_bwd.launches = 0

    walls = {}
    tmp = tempfile.mkdtemp(prefix="packed_training_")
    try:
        store = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        check(synth_corpus.main(["--out", store] + PACKED_STORE) == 0,
              "synthetic store")
        walls["store_s"] = time.perf_counter() - t0

        out1 = os.path.join(tmp, "run1")
        zero()
        run1, walls["run1_s"] = synced(lambda: train_calm.train(
            packed_train_argv(store, out1, PACKED_STEPS)))
        cfg = run1.model.cfg
        run_launches = {"run1": counters()}
        check_packed_run(run1, out1, run_launches["run1"], 1, cfg)

        # the train state of step 2 restores bit for bit
        opt = run1.optimizer
        clone = AdamW({n: torch.zeros_like(p) for n, p in opt.params.items()},
                      opt.group, TrainingConfig(), 1)
        manager = ckpt.make_manager(out1, best_metric=None)
        check(manager.all_steps() == [PACKED_STEPS]
              and ckpt.restore_train_state(manager, clone) == PACKED_STEPS,
              "run 1's checkpoint")
        exact = all(torch.equal(getattr(clone, k)[n], getattr(opt, k)[n])
                    for k in ("params", "mu", "nu") for n in opt.params)
        check(exact and (clone.count, clone.mini_step)
              == (opt.count, opt.mini_step) == (PACKED_STEPS, 0),
              "the restored train state is bit for bit the saved one")
        n_train = sum(p.numel() for p in opt.params.values())
        log(f"  run 1: {PACKED_STEPS} steps in {walls['run1_s']:.1f} s; "
            f"{len(opt.params)} trainable tensors ({n_train / 1e6:.1f} M) "
            f"and their moments restored bit for bit")
        del run1, opt, clone
        gc.collect()
        torch.cuda.empty_cache()

        out2 = os.path.join(tmp, "run2")
        zero()
        run2, walls["run2_s"] = synced(lambda: train_calm.train(
            packed_train_argv(store, out2, PACKED_RESUME_TO,
                              f"training.resume_from_checkpoint={out1}")))
        run_launches["run2"] = counters()
        train, evals = check_packed_run(run2, out2, run_launches["run2"],
                                        PACKED_STEPS + 1, cfg)
        kept = ckpt.make_manager(out2, 2, "loss").all_steps()
        check(len(kept) == 2 and max(kept) <= PACKED_RESUME_TO,
              f"run 2's checkpoints {kept}")
        for r in train:
            log(f"  step {r['step']}: " + " ".join(
                f"{k}={r[k]:.5f}" for k in ("loss", "loss_tts", "loss_dur",
                                            "grad_norm", "loss_den",
                                            "step_s", "samples_per_sec",
                                            "mfu_pct") if k in r))
        log(f"  run 2 resumed at step {PACKED_STEPS}: steps "
            f"{train[0]['step']}-{train[-1]['step']} in "
            f"{walls['run2_s']:.1f} s, eval loss "
            f"{[round(r['eval_loss'], 5) for r in evals]}, checkpoints "
            f"kept {kept}")

        # the recipe's steps timed one by one (FLOPs counted first)
        it = run2.batches(0)
        raws = [next(it) for _ in range(PACKED_TIMED)]
        it.close()  # its prefetch thread ends
        flops = [run2.step_flops(raw) for raw in raws]
        batches = [run2.batch_filter(raw) for raw in raws]
        timed = time_steps(run2.steps["tts_packed"], raws, batches, flops,
                           counters, zero, card)
        check(timed["launches"] == {"attention_fwd": 0, "attention_bwd": 0},
              f"no attention kernel in a packed step ({timed['launches']})")
        summary = {
            "rows": raws[0]["tok_ids"].shape[0],
            "row_len": raws[0]["tok_ids"].shape[1],
            "t_aud": [raw["latents"].shape[2] for raw in raws], **timed,
            "run_launches": run_launches,
            "loop_step_s": [r["step_s"] for r in train],
            "loop_mfu_pct": [r["mfu_pct"] for r in train],
            "card": smi}
        log("  packed training " + json.dumps(summary))

        # the components through the served product's --components path
        walls["serve_load_s"] = check_components_served("configs/tts.yaml",
                                                        run2)
        probe = (run2.steps["tts_packed"], batches[0],
                 summary["step_s_median"])
        return summary, walls, probe
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase_packed_step_card_vs_cpu(card):
    """One packed TTS step's loss and gradients (forward_tts_packed,
    backward), full widths, 2 LLM layers, fp32, dropouts off (the flow
    draws and the CFG drop injected), card vs CPU, with the bound of the
    plain step's check. The Qwen2 rows take the plain masked attention on
    both devices, the DiT attention K3/K5 on the card."""
    import copy

    from audio_calm_torch.config import TrainingConfig
    from audio_calm_torch.data.collator import pack_tts_window
    from audio_calm_torch.data.datasets import CalmExample
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.flagship import flagship_config, random_normal_
    from audio_calm_torch.ops.attention import MultiheadAttention
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_fwd)
    from audio_calm_torch.train.optim import freeze
    from audio_calm_torch.train.steps import PACKED_KEYS

    cfg = flagship_config(2)
    cfg.lora.dropout = 0.0
    cpu = QwenCALM(cfg)
    random_normal_(cpu, seed=4)
    for m in cpu.modules():
        if isinstance(m, MultiheadAttention):
            m.dropout = 0.0
    labels = freeze(cpu, TrainingConfig())
    dev = copy.deepcopy(cpu).to(card)
    rng = np.random.default_rng(8)
    exs = [CalmExample(input_ids=rng.integers(10, 5000, n).astype(np.int32),
                       labels=np.full((n,), -100, np.int32),
                       audio=(0.039775 + 1.190864 * rng.standard_normal(
                           (a, 128))).astype(np.float32), mode="tts")
           for n, a in zip([96, 60, 33, 71, 12, 45, 90], [96, 80, 20, 64,
                                                          11, 50, 70])]
    batch, left = pack_tts_window(exs, 2, 256, 4, 96, 128, 96)
    check(not left, "the card-vs-CPU packed batch holds every utterance")
    slots = batch["text_mask"].shape[0] * batch["text_mask"].shape[1]
    g = torch.Generator().manual_seed(6)
    flow = {"t": torch.rand(slots, generator=g),
            "x0": torch.randn(slots, 96, 128, generator=g),
            "drop": torch.arange(slots) == 2}
    res = {}
    for name, model, device in (("cpu", cpu, "cpu"), ("card", dev, card)):
        args = [torch.from_numpy(batch[k]).to(device) for k in PACKED_KEYS]
        attention_fwd.launches = attention_bwd.launches = 0
        out = model.forward_tts_packed(*args, train=True, seed=1,
                                       **{k: v.to(device)
                                          for k, v in flow.items()})
        out["loss"].backward()
        res[name] = ({k: float(v.detach()) for k, v in out.items()},
                     {n: p.grad.detach().cpu() for n, p in
                      model.named_parameters() if p.grad is not None})
    counts = {"attention_fwd": attention_fwd.launches,
              "attention_bwd": attention_bwd.launches}
    n_dit = 2 * cfg.tts_flow_num_layers
    want = {"attention_fwd": n_dit, "attention_bwd": n_dit}
    log(f"  packed step launches on the card: {counts} (expected {want}: "
        f"none in the {cfg.qwen.num_hidden_layers} Qwen2 layers, {n_dit} "
        "DiT attentions)")
    check(counts == want, "kernel launches of the card's packed step")
    check(res["cpu"][0]["loss_den"] == res["card"][0]["loss_den"]
          == len(exs), "packed step loss_den")
    check_card_vs_cpu(res, {n for n, lab in labels.items()
                            if lab != "frozen"}, "packed step")


def phase_step_profile(probe, what, lead=False):
    """One more step of `what` under the profiler (device activity only):
    the device's busy share of the step and the kernels that take the most
    device time. With `lead`, one step more runs inside the profiler's
    window before it (after phase 5j a session loses the records of its
    first launches: the lead's)."""
    step, batch, step_s = probe
    p_wall, rows = device_profile(
        lambda: step(batch), lead=(lambda: step(batch)) if lead else None)
    busy = sum(r[1] for r in rows)
    check(busy > 0, f"the profiler saw device time in the {what} step")
    log(f"  profiled {what} step: wall {p_wall:.4f} s, device busy "
        f"{busy:.4f} s: {100 * busy / p_wall:.1f}% of the profiled wall, "
        f"{100 * busy / step_s:.1f}% of the unprofiled step {step_s:.4f} s")
    for name, s_, n in rows[:12]:
        log(f"    {1e3 * s_:9.3f} ms {n:6d} calls  {name[:90]}")
    return {"profiled_step_wall_s": p_wall, "step_device_busy_s": busy,
            "busy_share_of_step": busy / step_s,
            "step_device_ops": sum(r[2] for r in rows)}


# ASR training and the mix (phase 5j): configs/asr.yaml and configs/
# calm.yaml through train_calm on a synthetic store with both tasks (the
# byte tokenizer: a 76-token ASR prompt); seed 42's first task draws over
# 384 items a task are A T T A, so the mix's 4 steps train both tasks
ASR_STORE = ["--asr-n", "384", "--tts-n", "384", "--dev-n", "16", "--seed",
             "4"]
ASR_EVAL_BATCHES = 2  # 16 dev utterances a task in eval batches of 8
ASR_STEPS, MIX_STEPS, ASR_TIMED = 3, 4, 4
ASR_PLAIN_B, ASR_PLAIN_K = 16, 8  # plain ASR: asr.yaml's batch and slices
# asr.yaml's warm start reads tts.yaml's output, whose TTS head is 1024
# wide against asr.yaml's 768 (ROADMAP Queue 3): no warm start here
NO_WARM_START = [f"model.pretrained_{c}_path=null" for c in (
    "projector", "tts_head", "tts_len_pred", "lora")]


def asr_prompt_len():
    """Tokens of the ASR prompt under the byte tokenizer."""
    from audio_calm_torch.data.datasets import ASR_PROMPT
    from audio_calm_torch.data.tokenizer import ByteTokenizer

    return len(ByteTokenizer().encode(ASR_PROMPT, add_special_tokens=False))


def asr_forward_launches(cfg):
    """Attention launches of one eval forward: the plain ASR forward (the
    Qwen2 layers K4, the query cross-attention and the head's layers K3)
    and the TTS forward (the Qwen2 layers, the DiT's self and cross)."""
    L = cfg.qwen.num_hidden_layers
    return {"asr": L + 1 + cfg.asr_flow_num_layers,
            "tts": L + 2 * cfg.tts_flow_num_layers}


def asr_examples(frames, label_lens, seed):
    """ASR examples at asr.yaml's widths: the byte tokenizer's prompt,
    random label ids, latents at the flagship's statistics."""
    from audio_calm_torch.data.datasets import ASR_PROMPT, CalmExample
    from audio_calm_torch.data.tokenizer import ByteTokenizer

    prompt = np.asarray(ByteTokenizer().encode(
        ASR_PROMPT, add_special_tokens=False), np.int32)
    rng = np.random.default_rng(seed)
    return prompt, [CalmExample(
        input_ids=prompt, labels=rng.integers(10, 5000, n).astype(np.int32),
        audio=(0.039775 + 1.190864 * rng.standard_normal((a, 128))).astype(
            np.float32), mode="asr") for a, n in zip(frames, label_lens)]


def phase_asr_steps_card_vs_cpu(card):
    """One asr_packed step's and one plain asr step's loss and gradients
    (forward_asr_packed / forward_asr, backward) at asr.yaml's widths with
    2 LLM layers, fp32, dropouts off (the flow draws and the CFG drop
    injected), card vs CPU, with the bounds of the plain TTS step's check.
    Packed rows take the plain masked attention on both devices; the plain
    rows' Qwen2 attention K4/K5 on the card (the row 384 + SOA + the
    prompt), the query cross-attention (d = 96) and the head (d = 48)
    K3/K5."""
    import copy

    from audio_calm_torch.config import TrainingConfig
    from audio_calm_torch.data.collator import collate_calm, pack_asr_window
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.flagship import random_normal_
    from audio_calm_torch.ops.attention import MultiheadAttention
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_fwd)
    from audio_calm_torch.train.optim import freeze
    from audio_calm_torch.train.steps import ASR_KEYS, ASR_PACKED_KEYS

    cfg = asr_yaml_config(2)
    cfg.lora.dropout = 0.0
    cpu = QwenCALM(cfg)
    random_normal_(cpu, seed=6)
    for m in cpu.modules():
        if isinstance(m, MultiheadAttention):
            m.dropout = 0.0
    labels = freeze(cpu, TrainingConfig(), task_mode="asr")
    trainable = {n for n, lab in labels.items() if lab != "frozen"}
    dev = copy.deepcopy(cpu).to(card)
    prompt, exs = asr_examples([384, 200, 150], [96, 40, 17], seed=9)
    packed, left = pack_asr_window(exs, prompt, 2, 512, 4, 384, 128, 96)
    check(not left, "the card-vs-CPU packed ASR batch holds every "
          "utterance")
    P = len(prompt)
    # asr.yaml's asr_text_pad 32, clamped up to the prompt as the iterator
    # clamps it
    plain = collate_calm(exs[:2], 0, 96, 384, 128, text_pad=max(32, P))
    check(plain["text_ids"].shape[1] == P and 384 + 1 + P <= 512,
          f"the plain ASR row: 384 frames + SOA + the {P}-token prompt "
          "(asr_text_pad clamped up to it), within K5's 512")
    L, n_head = cfg.qwen.num_hidden_layers, 1 + cfg.asr_flow_num_layers
    remat = 2 if cfg.remat_policy != "none" else 1
    cases = {"asr_packed": (packed, ASR_PACKED_KEYS, "forward_asr_packed",
                            {"attention_fwd": n_head,
                             "attention_bwd": n_head}),
             "asr": (plain, ASR_KEYS, "forward_asr",
                     {"attention_fwd": remat * L + n_head,
                      "attention_bwd": L + n_head})}
    worst = 0.0
    for task, (batch, keys, forward, want) in cases.items():
        rows = batch["labels"].reshape(-1, 96).shape[0]
        g = torch.Generator().manual_seed(7)
        flow = {"t": torch.rand(rows, generator=g),
                "x0": torch.randn(rows, 96, cfg.qwen.hidden_size,
                                  generator=g),
                "drop": torch.arange(rows) == 1}
        res = {}
        for name, model, device in (("cpu", cpu, "cpu"), ("card", dev, card)):
            model.zero_grad(set_to_none=True)
            args = [torch.from_numpy(batch[k]).to(device) for k in keys]
            attention_fwd.launches = attention_bwd.launches = 0
            out = getattr(model, forward)(
                *args, train=True, seed=1,
                **{k: v.to(device) for k, v in flow.items()})
            out["loss"].backward()
            res[name] = ({k: float(v.detach()) for k, v in out.items()},
                         {n: p.grad.detach().cpu() for n, p in
                          model.named_parameters() if p.grad is not None})
        counts = {"attention_fwd": attention_fwd.launches,
                  "attention_bwd": attention_bwd.launches}
        log(f"  {task} step launches on the card: {counts} (expected "
            f"{want})")
        check(counts == want, f"kernel launches of the card's {task} step")
        n_valid = int((batch["labels"] != -100).sum())
        check(res["cpu"][0]["loss_den"] == res["card"][0]["loss_den"]
              == n_valid, f"{task} step loss_den")
        worst = max(worst, check_card_vs_cpu(res, trainable, f"{task} step"))
    return worst


def run_tasks(run):
    """The task of each step a train_calm run took, from its records."""
    return ["asr" if "loss_asr" in r else "tts" for r in run.history]


def check_recipe_run(run, out, counts, want, tasks):
    """Finite metrics.jsonl with samples_per_sec and mfu_pct each step,
    evals, the tasks the steps took and the run's attention launches."""
    train, evals = packed_records(out)
    check([r["step"] for r in train] == [r["step"] for r in run.history]
          == list(range(1, len(train) + 1)), "the run's steps")
    for r in train:
        check(all(np.isfinite(r[k]) and r[k] > 0 for k in (
            "loss", "samples_per_sec", "mfu_pct", "loss_den")),
            f"step {r['step']} metrics {r}")
    check(len(evals) >= 1 and all(np.isfinite(r["eval_loss"])
                                  for r in evals), "the run's eval loss")
    check(set(run_tasks(run)) == set(tasks),
          f"the run's tasks {run_tasks(run)}")
    log(f"  launches: {counts} (expected {want}: none in a packed step, "
        "the rest in the eval forwards)")
    check(counts == want, "kernel launches of the run")
    for r in train:
        log(f"  step {r['step']}: " + " ".join(
            f"{k}={r[k]:.5f}" for k in ("loss", "loss_asr", "loss_tts",
                                        "grad_norm", "loss_den", "step_s",
                                        "samples_per_sec", "mfu_pct")
            if k in r))
    return train, evals


def phase_asr_training(card, smi):
    """ASR training and the mix at full width (Qwen2-1.5B 28 layers, frozen
    bf16 base, LoRA r64, ASR and TTS heads 768 x 4 / 16, full remat)
    through `python -m audio_calm_torch.train.train_calm` in this process,
    on a synthetic store with both tasks: the two steps checked card vs CPU
    at 2 layers first; configs/asr.yaml (packed ASR rows, 16 x 512 in 8
    slices) for 3 steps with an eval and checkpoints, its packed steps
    timed alone (and in 2 slices), then plain ASR steps (B = 16 in 8 slices, the 384 grid) on
    the same model and optimizer timed alone; configs/calm.yaml (the mix:
    packed ASR at k = 8, packed TTS at k = 2, one optimizer) for 4 steps
    with an eval and checkpoints, its exported components served through
    --components equal to the trained tensors, each task's steps timed
    alone."""
    import gc

    from audio_calm_torch.data import synth_corpus
    from audio_calm_torch.data.collator import calm_batch_iterator
    from audio_calm_torch.data.datasets import CalmDataset
    from audio_calm_torch.data.tokenizer import ByteTokenizer
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_fwd)
    from audio_calm_torch.train import checkpoint as ckpt
    from audio_calm_torch.train import train_calm
    from audio_calm_torch.train.steps import count_step_flops, make_calm_step

    def counters():
        return {"attention_fwd": attention_fwd.launches,
                "attention_bwd": attention_bwd.launches}

    def zero():
        attention_fwd.launches = attention_bwd.launches = 0

    walls, result = {}, {"card": smi}
    t0 = time.perf_counter()
    with exact_fp32():
        result["card_vs_cpu_worst"] = phase_asr_steps_card_vs_cpu(card)
    walls["card_vs_cpu_s"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="asr_training_")
    try:
        store = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        check(synth_corpus.main(["--out", store] + ASR_STORE) == 0,
              "synthetic store")
        walls["store_s"] = time.perf_counter() - t0

        # configs/asr.yaml: packed ASR
        out = os.path.join(tmp, "asr")
        zero()
        run, walls["asr_run_s"] = synced(lambda: train_calm.train(
            recipe_argv("configs/asr.yaml", ("asr",), store, out, ASR_STEPS,
                        "training.save_steps=2", "training.eval_steps=2",
                        *NO_WARM_START)))
        cfg = run.model.cfg
        per_eval = asr_forward_launches(cfg)
        counts = counters()
        check_recipe_run(run, out, counts, {
            "attention_fwd": ASR_EVAL_BATCHES * per_eval["asr"],
            "attention_bwd": 0}, ["asr"])
        result["asr_run_launches"] = counts
        check(ckpt.make_manager(out, 2, "loss").all_steps() == [2, ASR_STEPS],
              "asr.yaml run's checkpoints")
        it = run.batches(0)
        raws = [next(it) for _ in range(ASR_TIMED)]
        it.close()  # its prefetch thread ends
        check(all(raw["task"] == "asr_packed" and raw["tok_ids"].shape == (
            16, 512) for raw in raws), "asr.yaml's batches: 16 rows of 512")
        flops = [run.step_flops(raw) for raw in raws]
        batches = [run.batch_filter(raw) for raw in raws]
        step = run.steps["asr_packed"]
        packed = time_steps(step, raws, batches, flops, counters, zero, card)
        check(packed["launches"] == {"attention_fwd": 0,
                                     "attention_bwd": 0},
              f"no attention kernel in a packed ASR step "
              f"({packed['launches']})")
        packed["slots_real"] = [int(raw["n_samples"]) for raw in raws]
        log("  packed ASR " + json.dumps(packed))
        # the same batches in 2 slices (asr.yaml's 8 fit a 16 GB chip):
        # what the slice count costs the step
        k2 = time_steps(make_calm_step(run.model, run.optimizer, "asr_packed",
                                       microbatch=2, seed=1),
                        raws[:2], batches[:2], flops[:2], counters, zero,
                        card)
        log("  packed ASR in 2 slices " + json.dumps(k2))
        packed["two_slices"] = {k: k2[k] for k in (
            "step_s", "step_s_median", "utterances_per_s", "mfu_pct",
            "peak_mem_gb", "step_mem_gb")}
        probes = {"asr_packed": (step, batches[0], packed["step_s_median"])}

        # plain ASR steps on the same model and optimizer: asr.yaml with
        # data.asr_pack_rows=0 (B = 16 in 8 slices, the 384 grid)
        ds = CalmDataset(ByteTokenizer(), asr_latent_dir=os.path.join(
            store, "train", CORPUS["asr"]), asr_subsets="train-clean-100",
            max_text_len=96, max_audio_len=384, task_mode="asr",
            latent_dim=128)
        it = calm_batch_iterator(ds, ASR_PLAIN_B, 0, 128, task_prob_tts=0.0,
                                 seed=5, asr_text_pad=32)
        raws = [next(it) for _ in range(ASR_TIMED)]
        row = 384 + 1 + raws[0]["text_ids"].shape[1]
        check(row == 384 + 1 + asr_prompt_len() <= 512 and all(
            raw["latents"].shape[1] == 384 for raw in raws),
            f"the plain ASR row of {row} positions (K5 takes at most 512)")
        plain_step = make_calm_step(run.model, run.optimizer, "asr",
                                    microbatch=ASR_PLAIN_K, seed=1)
        batches = [run.batch_filter(raw) for raw in raws]
        flops = [count_step_flops(run.model, b, "asr", ASR_PLAIN_K)
                 for b in batches[:1]] * ASR_TIMED
        plain = time_steps(plain_step, raws, batches, flops, counters, zero,
                           card)
        L = cfg.qwen.num_hidden_layers
        want = {"attention_fwd": 2 * L * ASR_PLAIN_K,
                "attention_bwd": L * ASR_PLAIN_K}
        log(f"  plain ASR launches a step {plain['launches_per_step']} "
            f"(expected {want}: the Qwen2 layers' forward and recompute "
            "K4, backward K5, in each slice; the cross-attention and the "
            "head take plain torch while their dropout is on)")
        check(plain["launches_per_step"] == want,
              "kernel launches of the plain ASR step")
        plain["row"] = row
        log("  plain ASR " + json.dumps(plain))
        probes["asr"] = (plain_step, batches[0], plain["step_s_median"])
        result.update(asr_packed=packed, asr_plain=plain)
        del run, step, plain_step, batches, it
        gc.collect()
        torch.cuda.empty_cache()

        # configs/calm.yaml: the mix
        out = os.path.join(tmp, "mix")
        zero()
        run, walls["mix_run_s"] = synced(lambda: train_calm.train(
            recipe_argv("configs/calm.yaml", ("asr", "tts"), store, out,
                        MIX_STEPS, "training.save_steps=2",
                        f"training.eval_steps={MIX_STEPS}")))
        counts = counters()
        evals = ASR_EVAL_BATCHES * (per_eval["asr"] + per_eval["tts"])
        check_recipe_run(run, out, counts, {"attention_fwd": evals,
                                            "attention_bwd": 0},
                         ["asr", "tts"])
        tasks = run_tasks(run)
        check(sorted(run.steps) == ["asr_packed", "tts_packed"]
              and run.optimizer.count == MIX_STEPS // 2,
              "the mix's two steps share one optimizer (MultiSteps of 2)")
        check(ckpt.make_manager(out, 2, "loss").all_steps() == [2, MIX_STEPS],
              "calm.yaml run's checkpoints")
        # before the timed steps below update the model
        walls["mix_serve_load_s"] = check_components_served(
            "configs/calm.yaml", run)
        it = run.batches(0)
        raws = [next(it) for _ in range(2 * ASR_TIMED)]
        it.close()
        mix = {"tasks": tasks, "batch_tasks": [raw["task"] for raw in raws]}
        for task in ("asr_packed", "tts_packed"):
            mine = [raw for raw in raws if raw["task"] == task][:2]
            check(len(mine) == 2, f"two {task} batches of the mix")
            mix[task] = time_steps(
                run.steps[task], mine, [run.batch_filter(r) for r in mine],
                [run.step_flops(r) for r in mine], counters, zero, card)
            check(mix[task]["launches"] == {"attention_fwd": 0,
                                            "attention_bwd": 0},
                  f"no attention kernel in the mix's {task} step")
        log("  mix " + json.dumps(mix))
        result["mix"] = mix
        del run
        return result, walls, probes
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# VAE training and few-step distillation (phase 5k): configs/vae.yaml
# through train_vae on a mel store the phase writes (seeded tones and noise
# through the port's log-mel frontend), then configs/tts.yaml and
# configs/asr.yaml through distill_calm on a synthetic latent store, the
# teacher a seeded random model perturbed as --perturb-teacher does
VAE_STORE = (288, 32)  # train and dev mels, each around the 256-frame crop
VAE_STEPS, VAE_TIMED = 3, 4
DISTILL_STORE = ["--asr-n", "48", "--tts-n", "48", "--dev-n", "4", "--seed",
                 "6"]
DISTILL_STEPS, DISTILL_TIMED = 2, 4
DISTILL_K, DISTILL_M, DISTILL_SIGMA = 4, 8, 0.02
DISTILL_CFG = {"tts": 2.5, "asr": 3.0}  # tts.yaml's and asr.yaml's cfg_scale
PROBE_DENSE = 128  # quality_probe's dense teacher solve


def write_mel_store(root, card, seed=0):
    """`root`/train/train-clean-100 and `root`/dev/dev-clean: VAE_STORE
    `.npz` files of {"mel": [T, 80]}, T 224-320 frames, log-mels of seeded
    harmonic tones (f0 90-320 Hz with vibrato, 1-4 harmonics, a random
    envelope) plus noise through ops/mel.MelFrontend on the card ->
    seconds."""
    from audio_calm_torch.ops.mel import MelFrontend

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    n = sum(VAE_STORE)
    frames = rng.integers(224, 321, n)
    L = 320 * 256
    t = np.arange(L) / 16000.0
    f0 = rng.uniform(90, 320, (n, 1)) * (1 + 0.03 * np.sin(
        2 * np.pi * rng.uniform(3, 7, (n, 1)) * t))
    phase = 2 * np.pi * np.cumsum(f0, axis=1) / 16000.0
    wav = sum(rng.uniform(0, 1, (n, 1)) / h * np.sin(h * phase)
              for h in range(1, 5))
    env = np.interp(t, np.linspace(0, t[-1], 9),
                    rng.uniform(0.1, 1.0, 9)).astype(np.float32)
    wav = (wav * env + 0.02 * rng.standard_normal((n, L))).astype(np.float32)
    mels = MelFrontend(device=card)(wav).cpu().numpy()
    for i, T in enumerate(frames):
        split, subset = (("train", "train-clean-100") if i < VAE_STORE[0]
                         else ("dev", "dev-clean"))
        d = os.path.join(root, split, subset, str(100 + i % 8), "1")
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, f"{100 + i % 8}-1-{i:04d}.npz"),
                 mel=mels[i, :T])
    return time.perf_counter() - t0


def vae_argv(store, out, max_steps):
    """train_vae's argv for configs/vae.yaml at full width on `store`: a
    log every step, an eval and a save every 2."""
    argv = ["--config", "configs/vae.yaml", "--max-steps", str(max_steps)]
    for ov in (f"data.data_dir={store}/train",
               f"data.eval_data_dir={store}/dev",
               "data.train_subsets=train-clean-100",
               "data.eval_subsets=dev-clean", f"training.output_dir={out}",
               "training.logging_steps=1", "training.save_steps=2",
               "training.eval_steps=2"):
        argv += ["--override", ov]
    return argv


def distill_argv(task, store, out, max_steps):
    """distill_calm's argv for tts.yaml (task tts) or asr.yaml (task asr)
    at full width on the synthetic `store`: the byte tokenizer, no Qwen2
    base weights and no warm start (a seeded random teacher, its head
    perturbed), K = 4, M = 8 at the config's cfg scale, a log every step."""
    config = {"tts": "configs/tts.yaml", "asr": "configs/asr.yaml"}[task]
    argv = ["--config", config, "--task", task, "--byte-tokenizer",
            "--max-steps", str(max_steps), "--perturb-teacher",
            str(DISTILL_SIGMA), "--student-steps", str(DISTILL_K),
            "--teacher-substeps", str(DISTILL_M), "--cfg-scale",
            str(DISTILL_CFG[task])]
    src = f"data.datasets.{task}"
    for ov in [f"{src}.latent_dir={store}/train/{CORPUS[task]}",
               f"{src}.subsets=train-clean-100", "model.qwen_path=null",
               f"training.output_dir={out}", "training.logging_steps=1",
               *NO_WARM_START]:
        argv += ["--override", ov]
    return argv


def distill_launches(cfg, task, K, M):
    """Attention launches of one distillation step: the conditioning's
    Qwen2 encode (K4 a layer; ASR also its query cross-attention, K3), the
    teacher's K x M head evaluations (K3 for each self- and cross-attention
    of each layer; CFG fuses the two halves into one launch), the
    student's K evaluations (K3 forward and again in the checkpointed
    block's recompute, K5 in the backward)."""
    L = cfg.qwen.num_hidden_layers
    per_eval = (2 * cfg.tts_flow_num_layers if task == "tts"
                else cfg.asr_flow_num_layers)
    encode = L + (task == "asr")
    return {"attention_fwd": encode + K * M * per_eval + 2 * K * per_eval,
            "attention_bwd": K * per_eval,
            "k4": L, "k3_teacher": K * M * per_eval,
            "k3_student": 2 * K * per_eval}


def probe_launches(cfg, task, K):
    """Attention launches of distill.quality_probe: three solves (dense
    teacher, coarse teacher, student), each an encode and one launch a
    layer (and attention) a velocity evaluation."""
    L = cfg.qwen.num_hidden_layers
    per_eval = (2 * cfg.tts_flow_num_layers if task == "tts"
                else cfg.asr_flow_num_layers)
    encode = L + (task == "asr")
    return 3 * encode + (PROBE_DENSE + 2 * K) * per_eval


def phase_vae_distill_card_vs_cpu(card):
    """One VAE step and one TTS distillation step, tiny models in fp32
    with TF32 off, card vs CPU on the same weights and draws (eps, x0):
    the loss terms and every trainable gradient, with
    phase_train_step_card_vs_cpu's bounds; the distillation step's
    attention launches on the card. -> the worst error over its bound."""
    import copy

    from audio_calm_torch.config import (CALMModelConfig, LoRAConfig,
                                         Qwen2Config, TrainingConfig,
                                         VAEModelConfig)
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.flagship import random_normal_
    from audio_calm_torch.models.vae import AcousticVAE, init_vae_
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_fwd)
    from audio_calm_torch.train.distill import (make_distill_step,
                                                perturb_head,
                                                split_for_distill)
    from audio_calm_torch.train.optim import AdamW
    from audio_calm_torch.train.steps import VAE_LOSSES, vae_loss

    worst = 0.0
    # the VAE: vae.yaml's geometry at hidden 64, latent 16
    cpu = AcousticVAE(VAEModelConfig(hidden_channels=64, latent_channels=16,
                                     norm_num_groups=8, latent_dropout=0.0))
    init_vae_(cpu, 4)
    dev = copy.deepcopy(cpu).to(card)
    g = torch.Generator().manual_seed(8)
    mel = torch.randn(4, 256, 80, generator=g) * 3.8 - 6.5
    eps = torch.randn(4, 64, 16, generator=g)
    res = {}
    for name, model, device in (("cpu", cpu, "cpu"), ("card", dev, card)):
        out = vae_loss(model, mel.to(device), 0, eps.to(device))
        out["loss"].backward()
        res[name] = ({k: float(out[k].detach()) for k in VAE_LOSSES},
                     {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()})
    worst = max(worst, check_card_vs_cpu(
        res, {n for n, _ in cpu.named_parameters()}, "VAE step"))

    # TTS distillation: 2 LLM layers, a 2-layer DiT of 256 (4 heads of 64)
    cfg = CALMModelConfig(
        latent_dim=16, max_audio_len=64, max_text_len=16,
        tts_flow_hidden_dim=256, tts_flow_num_layers=2,
        asr_flow_hidden_dim=256, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=Qwen2Config(vocab_size=258, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         head_dim=64),
        lora=LoRAConfig(rank=4, alpha=8, dropout=0.0))
    cpu = QwenCALM(cfg)
    random_normal_(cpu, seed=5, scale=0.05)
    perturb_head(cpu, "tts", 0.05)
    dev = copy.deepcopy(cpu).to(card)
    g = torch.Generator().manual_seed(9)
    ids = torch.randint(1, 258, (3, 16), generator=g)
    mask = (torch.arange(16)[None] < torch.tensor([16, 11, 6])[:, None])
    batch = {"text_ids": ids * mask, "attention_mask": mask.int()}
    x0 = torch.randn(3, 64, 16, generator=g)
    K, M = 2, 2
    res = {}
    for name, model, device in (("cpu", cpu, "cpu"), ("card", dev, card)):
        teacher, labels = split_for_distill(model, "tts")
        params = {n: p for n, p in model.named_parameters()
                  if p.requires_grad}
        step = make_distill_step(model, teacher, AdamW(
            params, labels, TrainingConfig(), 10), "tts", student_steps=K,
            cfg_scale=2.5, teacher_substeps=M)
        attention_fwd.launches = attention_bwd.launches = 0
        out = step.loss({k: v.to(device) for k, v in batch.items()}, 0,
                        x0.to(device))
        out["loss"].backward()
        res[name] = ({"loss": float(out["loss"].detach())},
                     {n: p.grad.detach().cpu() for n, p in params.items()})
    counts = {"attention_fwd": attention_fwd.launches,
              "attention_bwd": attention_bwd.launches}
    want = distill_launches(cfg, "tts", K, M)
    want = {k: want[k] for k in counts}
    log(f"  distillation step launches on the card: {counts} (expected "
        f"{want})")
    check(counts == want, "kernel launches of the card's distillation step")
    worst = max(worst, check_card_vs_cpu(res, set(params),
                                         "distillation step"))
    return worst


def phase_vae_training(card, smi, tmp):
    """configs/vae.yaml at full width through train_vae in this process on
    a seeded mel store: VAE_STEPS steps with an eval and checkpoints,
    finite metrics with samples/s and MFU, the exported vae.bin loaded by
    load_vae equal to the trained tensors; VAE_TIMED steps of the run's
    own batches timed alone and one profiled (its busy share)."""
    from audio_calm_torch.models.vae import load_vae
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_fwd)
    from audio_calm_torch.train import checkpoint as ckpt
    from audio_calm_torch.train import train_vae

    def counters():
        return {"attention_fwd": attention_fwd.launches,
                "attention_bwd": attention_bwd.launches}

    def zero():
        attention_fwd.launches = attention_bwd.launches = 0

    walls = {}
    store = os.path.join(tmp, "mels")
    walls["mel_store_s"] = write_mel_store(store, card)
    out = os.path.join(tmp, "vae")
    run, walls["run_s"] = synced(lambda: train_vae.train(
        vae_argv(store, out, VAE_STEPS)))
    train, evals = packed_records(out)
    check([r["step"] for r in train] == list(range(1, VAE_STEPS + 1)),
          "the VAE run's steps")
    for r in train:
        check(all(np.isfinite(r[k]) for k in (
            "loss", "rec_loss", "ssim_loss", "stft_loss", "kl_loss",
            "mu_std", "var_mean", "grad_norm")) and r["samples_per_sec"] > 0
              and r["mfu_pct"] > 0, f"VAE step {r['step']} metrics {r}")
        log(f"  step {r['step']}: " + " ".join(
            f"{k}={r[k]:.5f}" for k in ("loss", "rec_loss", "ssim_loss",
                                        "stft_loss", "kl_loss", "mu_std",
                                        "var_mean", "grad_norm", "step_s",
                                        "samples_per_sec", "mfu_pct")))
    check(len(evals) == 1 and np.isfinite(evals[0]["eval_loss"]),
          "the VAE run's eval loss")
    check(ckpt.make_manager(out, 3).all_steps() == [2, VAE_STEPS],
          "the VAE run's checkpoints")
    loaded = load_vae(run.export_path, device=card).state_dict()
    trained = run.model.state_dict()
    check(set(loaded) == set(trained) and all(
        torch.equal(loaded[n], trained[n]) for n in trained),
        "the exported vae.bin loads through load_vae as trained")
    log(f"  vae.bin: {len(trained)} tensors loaded back equal; "
        f"{walls['run_s']:.1f} s for the run")

    it = run.batches(0)
    raws = [next(it) for _ in range(VAE_TIMED)]
    it.close()  # its prefetch thread ends
    batches = [run.batch_filter(raw) for raw in raws]
    timed = time_steps(run.step, raws, batches, [run.step_flops] * VAE_TIMED,
                       counters, zero, card)
    check(timed["launches"] == {"attention_fwd": 0, "attention_bwd": 0},
          "no attention kernel in a VAE step")
    timed["mels_per_s"] = timed.pop("utterances_per_s")
    timed["crop"] = list(raws[0]["mel"].shape)
    timed["conv_tf32"] = torch.backends.cudnn.allow_tf32
    timed["matmul_tf32"] = torch.backends.cuda.matmul.allow_tf32
    timed["eval_loss"] = evals[0]["eval_loss"]
    timed["loop_step_s"] = [r["step_s"] for r in train]
    timed["card"] = smi
    step = run.step
    timed.update(phase_step_profile(
        (lambda b: step(b), batches[0], timed["step_s_median"]), "VAE",
        lead=True))
    log("  VAE training " + json.dumps(timed))
    return timed, walls


def phase_distillation(card, smi, tmp, store, task):
    """distill_calm --task `task` at full width in this process: tts.yaml
    (Qwen2-1.5B 28 layers, DiT 1024 x 4 / 16, B = 32) or asr.yaml (ASR
    head 768 x 4 / 16, B = 16), K = 4, M = 8 at the config's cfg scale,
    a seeded random teacher perturbed; DISTILL_STEPS steps with finite
    metrics, the probe's numbers, the run's attention launches as the
    steps and the probe need, the components served through
    --components equal to the trained tensors; DISTILL_TIMED steps of the
    run's batches timed alone (the step's FLOPs counted once) and one
    profiled."""
    import gc

    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_fwd)
    from audio_calm_torch.train import distill_calm
    from audio_calm_torch.train.steps import backward_flops

    def counters():
        return {"attention_fwd": attention_fwd.launches,
                "attention_bwd": attention_bwd.launches}

    def zero():
        attention_fwd.launches = attention_bwd.launches = 0

    walls = {}
    out = os.path.join(tmp, f"distill_{task}")
    zero()
    run, walls["run_s"] = synced(lambda: distill_calm.distill(
        distill_argv(task, store, out, DISTILL_STEPS)))
    run_counts = counters()
    cfg = run.model.cfg
    per_step = distill_launches(cfg, task, DISTILL_K, DISTILL_M)
    want = {"attention_fwd": DISTILL_STEPS * per_step["attention_fwd"]
            + probe_launches(cfg, task, DISTILL_K),
            "attention_bwd": DISTILL_STEPS * per_step["attention_bwd"]}
    log(f"  {task} distillation run launches: {run_counts} (expected "
        f"{want}: {DISTILL_STEPS} steps of {per_step} and the probe's "
        f"{probe_launches(cfg, task, DISTILL_K)})")
    check(run_counts == want, f"kernel launches of the {task} distillation "
          "run")
    recs, _ = packed_records(os.path.join(out, f"distill_{task}"))
    check([r["step"] for r in recs] == list(range(1, DISTILL_STEPS + 1))
          and all(np.isfinite(r["loss"]) and r["loss"] > 0
                  and np.isfinite(r["grad_norm"]) for r in recs),
          f"the {task} distillation run's metrics {recs}")
    check(all(np.isfinite(v) for v in run.probe.values()),
          f"the {task} quality probe {run.probe}")
    for r in recs:
        log(f"  step {r['step']}: " + " ".join(
            f"{k}={r[k]:.6f}" for k in ("loss", "grad_norm", "step_s",
                                        "samples_per_sec")))
    config = {"tts": "configs/tts.yaml", "asr": "configs/asr.yaml"}[task]
    walls["serve_load_s"] = check_components_served(config, run)

    it = run.batches(0)
    raws = [next(it) for _ in range(DISTILL_TIMED)]
    it.close()
    batches = [run.batch_filter(raw) for raw in raws]
    fl = backward_flops(run.model, lambda: run.step.loss(batches[0], 0)[
        "loss"])
    timed = time_steps(run.step, raws, batches, [fl] * DISTILL_TIMED,
                       counters, zero, card)
    check(timed["launches_per_step"] == {
        k: per_step[k] for k in ("attention_fwd", "attention_bwd")},
        f"kernel launches of a {task} distillation step "
        f"({timed['launches_per_step']}, expected {per_step})")
    timed.update(
        launches_expected=per_step, run_launches=run_counts,
        losses=[r["loss"] for r in recs], probe=run.probe,
        cfg_scale=DISTILL_CFG[task], K=DISTILL_K, M=DISTILL_M,
        text=list(raws[0]["text_ids"].shape), card=smi)
    if task == "asr":
        timed["latents"] = list(raws[0]["latents"].shape)
    step = run.step
    timed.update(phase_step_profile(
        (lambda b: step(b), batches[0], timed["step_s_median"]),
        f"{task} distillation", lead=True))
    log(f"  {task} distillation " + json.dumps(timed))
    del run, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return timed, walls


def phase_vae_and_distillation(card, smi):
    """Phase 5k: the card-vs-CPU checks, VAE training, then TTS and ASR
    distillation, each at full width through its entry point."""
    import gc

    from audio_calm_torch.data import synth_corpus

    result, walls = {"card": smi}, {}
    t0 = time.perf_counter()
    with exact_fp32():
        result["card_vs_cpu_worst"] = phase_vae_distill_card_vs_cpu(card)
    walls["card_vs_cpu_s"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="vae_distill_")
    try:
        t0 = time.perf_counter()
        result["vae"], walls["vae"] = phase_vae_training(card, smi, tmp)
        walls["vae_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        store = os.path.join(tmp, "latents")
        check(synth_corpus.main(["--out", store] + DISTILL_STORE) == 0,
              "synthetic store")
        for task in ("tts", "asr"):
            t0 = time.perf_counter()
            result[task], walls[task] = phase_distillation(
                card, smi, tmp, store, task)
            walls[f"{task}_s"] = time.perf_counter() - t0
        return result, walls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# data preparation and the end-to-end proof (phase 5l): a seeded corpus of
# LibriSpeech-layout WAVs whose lengths fill every bucket of the processor
# (2 / 5 / 10 / 20 / 40 s), at configs/vae.yaml's width; PREP_CHECKED files
# (one of each of the shorter buckets) held against the CPU
PREP_FILES = 96
PREP_EDGES = (1.5, 2.0, 5.0, 10.0, 20.0, 35.0)  # seconds
PREP_CHECKED = 4
VAE_TOL = 2e-4  # tests/test_torch_vae.py's bound against JAX, fp32


def write_wav_corpus(root, n, seed=0):
    """n 16 kHz mono 16-bit WAVs (served_wav's signals) spread over the
    buckets, in LibriSpeech's layout: <root>/<spk>/<chap>/<spk>-<chap>-<i>
    .wav beside <spk>-<chap>.trans.txt -> seconds of audio."""
    from audio_calm_torch.serving.server import wav_bytes

    rng = np.random.default_rng(seed)
    total = 0.0
    for i in range(n):
        b = i % (len(PREP_EDGES) - 1)
        sec = float(rng.uniform(PREP_EDGES[b], PREP_EDGES[b + 1]))
        spk, chap = 100 + i % 4, 10 + i % 3
        d = os.path.join(root, str(spk), str(chap))
        os.makedirs(d, exist_ok=True)
        fid = f"{spk}-{chap}-{i:04d}"
        x = np.clip(served_wav(sec, seed=1000 + i), -1, 1)
        with open(os.path.join(d, fid + ".wav"), "wb") as f:
            f.write(wav_bytes(x))
        with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "a") as f:
            f.write(f"{fid} utterance number {i}\n")
        total += len(x) / 16000
    return total


def npz_files(root):
    return sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root)
                  for f in fs if f.endswith(".npz"))


def phase_data_prep(card, smi, tmp):
    """process_dataset over a seeded corpus of PREP_FILES WAVs, mel-only
    and through a seeded configs/vae.yaml VAE exported by train_vae's
    `export` (PyTorch's default numerics: cuDNN's TF32 convolutions), timed;
    PREP_CHECKED files' latents on the card in fp32 against the same VAE on
    the CPU; compute_stats and --stats; the latent store as reference .pt
    payloads through convert_store, read back through CalmDataset."""
    from audio_calm_torch.config import VAEConfig, load_config
    from audio_calm_torch.data import convert_store, process_dataset
    from audio_calm_torch.data.datasets import CalmDataset, load_array
    from audio_calm_torch.data.preprocess import (CorpusProcessor,
                                                  compute_stats,
                                                  scan_audio_files)
    from audio_calm_torch.data.tokenizer import ByteTokenizer
    from audio_calm_torch.models.vae import (AcousticVAE, init_vae_,
                                             load_vae, normalize_mel)
    from audio_calm_torch.train.train_vae import export

    raw = os.path.join(tmp, "raw", "train-clean-100")
    audio_s = write_wav_corpus(raw, PREP_FILES)
    cfg = load_config("configs/vae.yaml", cls=VAEConfig)
    m = cfg.model
    check((m.hidden_channels, m.latent_channels, list(m.strides))
          == (512, 128, [2, 2]), "configs/vae.yaml's width")
    with torch.device(card):
        vae = AcousticVAE(m)
    init_vae_(vae, seed=7)
    ckpt = export(vae, cfg, os.path.join(tmp, "vae"))
    del vae
    result = {"files": PREP_FILES, "audio_s": audio_s, "card": smi}
    roots = {"mel_only": os.path.join(tmp, "mels", "train-clean-100"),
             "latents": os.path.join(tmp, "latents", "train-clean-100")}
    for name, extra in (("mel_only", ["--mel_only"]),
                        ("latents", ["--vae_ckpt", ckpt])):
        t0 = time.perf_counter()
        rc = process_dataset.main(["--input_dir", raw, "--output_dir",
                                   roots[name], "--dataset", "librispeech",
                                   "--device", card.type] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        files = npz_files(roots[name])
        check(rc == 0 and len(files) == PREP_FILES,
              f"process_dataset {name}: {PREP_FILES} files")
        result[name] = {"wall_s": wall, "files_per_s": PREP_FILES / wall,
                        "audio_s_per_s": audio_s / wall}
        log(f"  process_dataset {name}: {PREP_FILES} files, {audio_s:.1f} s "
            f"of audio in {wall:.3f} s: {PREP_FILES / wall:.2f} files/s, "
            f"{audio_s / wall:.1f} s of audio a second ({smi})")
    wavs = scan_audio_files(raw)

    def stored(root, wav):
        return os.path.join(root, os.path.relpath(wav, raw)[:-4] + ".npz")

    for wav in wavs:
        n = os.path.getsize(wav) // 2 - 22  # 16-bit samples past the header
        lat_f = stored(roots["latents"], wav)
        mel, lat = load_array(stored(roots["mel_only"], wav)), load_array(
            lat_f)
        check(mel.shape == (n // 256 + 1, 80)
              and lat.shape == (-(-(n // 256 + 1) // 4), 128)
              and np.isfinite(lat).all(), f"{os.path.basename(lat_f)}: "
              "mel [n // 256 + 1, 80], latent [ceil(frames / 4), 128]")

    # PREP_CHECKED files, one a bucket (files 0, 1, ... fill buckets 0, 1,
    # ...), on the card in fp32 and on the CPU
    picked = [w for w in wavs
              if int(os.path.basename(w)[-8:-4]) < PREP_CHECKED]
    lats = {}
    for key, dev in (("card", card), ("cpu", torch.device("cpu"))):
        v = load_vae(ckpt, device=dev)
        proc = CorpusProcessor(
            vae_apply=lambda x, v=v: v.encode(normalize_mel(x, v.cfg))[0],
            total_stride=v.cfg.total_stride, device=dev)
        out = os.path.join(tmp, f"check_{key}")
        with exact_fp32():
            proc.process_corpus(picked, out, raw)
        lats[key] = [load_array(stored(out, w)) for w in picked]
    gaps = [float(np.abs(a - b).max()) for a, b in zip(lats["card"],
                                                       lats["cpu"])]
    tf32 = [float(np.abs(load_array(stored(roots["latents"], w)) - b).max())
            for w, b in zip(picked, lats["cpu"])]
    result["card_vs_cpu_fp32"] = gaps
    result["store_tf32_vs_cpu"] = tf32
    log(f"  {PREP_CHECKED} files' latents, card (fp32) vs CPU: max gaps "
        f"{gaps} (bound {VAE_TOL}); the store's (TF32 convolutions) "
        f"{tf32}")
    check(len(gaps) == PREP_CHECKED and max(gaps) <= VAE_TOL,
          "latents on the card within the VAE's fp32 bound of the CPU's")

    # statistics, the CLI's --stats, convert_store, the port's loader
    lat_files = npz_files(roots["latents"])
    mean, std = compute_stats(lat_files, key_priority=("latent",))
    mean_d, _ = compute_stats(lat_files, key_priority=("latent",),
                              per_dim=True)
    check(np.isfinite(mean) and std > 0 and mean_d.shape == (128,),
          "compute_stats over the latent store")
    check(process_dataset.main(["--stats", roots["latents"], "--stats_key",
                                "latent"]) == 0, "process_dataset --stats")
    result["latent_mean"], result["latent_std"] = float(mean), float(std)
    pt_root = os.path.join(tmp, "pt")
    for f in lat_files + [p for p in (
            os.path.join(dp, x) for dp, _, xs in os.walk(roots["latents"])
            for x in xs) if p.endswith(".trans.txt")]:
        dst = os.path.join(pt_root, os.path.relpath(f, os.path.dirname(
            roots["latents"])))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if f.endswith(".npz"):
            torch.save({"latent": torch.from_numpy(
                np.ascontiguousarray(load_array(f).T))}, dst[:-4] + ".pt")
        else:
            shutil.copy(f, dst)
    t0 = time.perf_counter()
    rc = convert_store.main(["--root", pt_root, "--dim", "128"])
    result["convert_store_s"] = time.perf_counter() - t0
    check(rc == 0 and len(npz_files(pt_root)) == PREP_FILES,
          "convert_store wrote a sidecar for every .pt")
    tok = ByteTokenizer()
    for root in (os.path.dirname(roots["latents"]), pt_root):
        ds = CalmDataset(tok, tts_latent_dir=root,
                         tts_subsets="train-clean-100", task_mode="tts",
                         max_audio_len=10 ** 6, latent_dim=128)
        check(len(ds.tts_items) == PREP_FILES and ds.supports_meta("tts"),
              f"CalmDataset reads {root}: every item, header metadata")
        for i in (0, PREP_FILES // 2, PREP_FILES - 1):
            ex = ds.get("tts", i)
            ref = load_array(os.path.join(roots["latents"], os.path.relpath(
                ds.tts_items[i]["file_path"], os.path.join(
                    root, "train-clean-100"))))
            check(ex is not None and np.array_equal(ex.audio, ref),
                  "a stored latent read back through CalmDataset")
    log(f"  compute_stats: latent mean {float(mean):.5f} std "
        f"{float(std):.5f}; convert_store {PREP_FILES} sidecars in "
        f"{result['convert_store_s']:.2f} s, read back by CalmDataset")
    return result


def phase_e2e_proof(card):
    """The end-to-end proof at the JAX script's counts: the VAE and the
    tiny CALM (head dim 24: the attention kernels zero-padded to 32)
    trained from scratch on the tone words, each word synthesized (32
    steps, cfg 2) and then by the distilled 4-step student, its pitch
    checked; at least 2 of 3 in both legs (tests/test_e2e_synthesis.py).
    The attention launches of each stage, counted from 0 before the run."""
    from audio_calm_torch.eval.e2e_demo import run_demo
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_fwd)

    stats = {}
    attention_fwd.launches = attention_bwd.launches = 0
    (matches, total, distilled), wall = synced(lambda: run_demo(
        400, 600, distill_steps=300, distill_k=4, device=card, stats=stats))
    out = {"matches": matches, "total": total, "distilled_matches": distilled,
           "wall_s": wall, "run_launches": {
               "attention_fwd": attention_fwd.launches,
               "attention_bwd": attention_bwd.launches}, **stats}
    log(f"  pitch match {matches}/{total}, distilled-4 {distilled}/{total}; "
        f"bands {stats['bands']}; walls " + json.dumps(
            {k: v for k, v in stats.items() if k.endswith("_s")})
        + f"; launches (forward, backward) {stats['launches']}")
    st = stats["launches"]
    check(st["calm"][0] > 0 and st["calm"][1] > 0 and st["check"][0] > 0
          and st["distill"][0] > 0 and st["distill"][1] > 0
          and st["check_distilled"][0] > 0,
          "the proof's training, synthesis and distillation launched the "
          "attention kernels (K4 / K3 forward, K5 backward) at head dim 24")
    check(total == 3 and matches >= 2 and distilled >= 2,
          "the trained stack and its 4-step student synthesize the words' "
          "pitch (at least 2 of 3 each)")
    return out


def phase_invariance_cost(card):
    """The batch-invariant products' cost against cuBLAS, in turns (on,
    off, on, off) in this process, run last (each profile with a lead
    call: late sessions lose their first records): the served calm.yaml
    engine's /tts pair group (tts_batch + render.batch; host wall and
    device ms) and its B = 1 encode (device ms), and the flagship's ODE
    (2 texts on the 384 grid, midpoint-12, cfg 2.5; device ms), whose
    main path runs cuBLAS."""
    import gc

    from audio_calm_torch.eval.infer import tts_decode, tts_encode
    from audio_calm_torch.models.layers import batch_invariant_
    from audio_calm_torch.serving import server

    engine = server.build_engine(server.parse_args(SERVE_ARGV))
    inf, calm, e = engine.inf, engine.inf.model, engine.cfg.evaluation
    texts, seeds = [t for t, _ in SERVE_PAIR], [s for _, s in SERVE_PAIR]
    kw = dict(steps=e.steps, cfg_scale=e.cfg_scale, method=e.ode_method,
              time_schedule=e.time_schedule)
    ids = torch.as_tensor(inf._prompt_arrays(texts[0])[0], device=card)

    def pair():
        with torch.inference_mode():
            lat, n, _ = inf.tts_batch(texts, seeds, **kw)
            return engine.render.batch(lat, n)

    def encode():
        with torch.inference_mode():
            return calm.encode_text_for_tts(ids, torch.ones_like(ids))

    flagship = build_models(card)[0]
    fids, fmask = (t.to(card) for t in text_batch([24, 16]))
    with torch.inference_mode():
        cv, ctx, pad, nf = tts_encode(flagship, fids, fmask)
    nf = torch.full_like(nf, 384)

    def ode():
        with torch.inference_mode():
            return tts_decode(flagship, cv, ctx, pad, nf,
                              torch.Generator(card).manual_seed(0),
                              t_aud=384, steps=12, method="midpoint",
                              cfg_scale=2.5)

    out = {"invariant": [], "cublas": []}
    for on in (True, False, True, False):
        batch_invariant_(calm, on)
        batch_invariant_(flagship, on)
        pair()
        _, wall = synced(pair)
        out["invariant" if on else "cublas"].append({
            "pair_wall_s": wall, "pair_device_ms": device_ms(pair, 1),
            "encode_b1_device_ms": device_ms(encode, 10),
            "flagship_ode_device_ms": device_ms(ode, 1)})
    log(f"  batch-invariant products vs cuBLAS, in turns: {json.dumps(out)}")
    del engine, calm, inf, flagship
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    from audio_calm_torch.ops import cuda_build

    card = torch.device("cuda")
    t_start = time.perf_counter()
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    logs, build_s = synced(cuda_build.build_all)
    log(f"phase build: {build_s:.1f} s")
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                # the mangled entry, shortened to namespace, name and the
                # template's integer arguments: tc::attention_kernel<48>
                m = re.search(r"(simt|tc)\d+(\w+?kernel)I(\w+?)EE",
                              line.split()[-1])
                entry = (f"{m[1]}::{m[2]}<" + ",".join(
                    re.findall(r"Li(\d+)E", m[3] + "E")) + ">"
                         if m else line.split()[-1][:60])
            elif "registers" in line or "spill" in line:
                log(f"  {name} {entry}: {line.strip()}")

    # 3. kernels vs plain
    t0 = time.perf_counter()
    from audio_calm_torch.config import HiFiGANConfig
    from audio_calm_torch.models.flagship import build_random
    from audio_calm_torch.models.vocoder import HiFiGANGenerator

    gen = build_random(lambda: HiFiGANGenerator(HiFiGANConfig()), card,
                       seed=2)
    gens = {"odd_width": (odd_width_config(),
                          seeded_generator(odd_width_config(), 21)),
            "v2": (v2_config(), seeded_generator(v2_config(), 22))}
    v2_card = seeded_generator(v2_config(), 22).to(card)
    with exact_fp32():
        with torch.no_grad():  # direct kernel calls take no gradient
            errs = phase_kernels(gen, card)
            errs.update(phase_vocoder_kernels(v2_card, card))
            errs.update(phase_served_kernels(card))
        errs["attention_bwd"] = phase_attention_bwd(card)
    log(f"phase kernels vs plain: ok in {time.perf_counter() - t0:.1f} s")

    # 4. reduced depth, card vs CPU
    t0 = time.perf_counter()
    with exact_fp32():
        phase_reduced_depth(card)
    log(f"phase reduced-depth card vs CPU: ok in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with exact_fp32():
        phase_train_step_card_vs_cpu(card)
    log(f"phase training step card vs CPU: ok in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with exact_fp32():
        phase_packed_step_card_vs_cpu(card)
    log(f"phase packed training step card vs CPU: ok in "
        f"{time.perf_counter() - t0:.1f} s")

    # 5. main path at full width, with PyTorch's default numerics (the
    # plain fp32 convolutions of the VAE and the vocoder in TF32)
    t0 = time.perf_counter()
    _, voc, counts, serve, served = phase_main_path(card)
    log(f"phase main path: ok in {time.perf_counter() - t0:.1f} s")

    # 5b. the training path at full width
    t0 = time.perf_counter()
    train_counts, trained, train_probe = phase_train_main_path(card)
    log(f"phase training path: ok in {time.perf_counter() - t0:.1f} s")

    # 5c. the vocoder layer as the product loads it
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        vocs = phase_load_vocoders(gens, card, tmp)
    voc_counts, voc_path = phase_vocoder_path(vocs, card)
    log(f"phase vocoder layer: ok in {time.perf_counter() - t0:.1f} s")

    # 5d. VAE reconstruction, card vs CPU
    t0 = time.perf_counter()
    with exact_fp32():
        recon = phase_reconstruct(card)
    log(f"phase reconstruction: ok in {time.perf_counter() - t0:.1f} s")

    # 5e. ASR at asr.yaml's widths, 2 LLM layers, card vs CPU
    t0 = time.perf_counter()
    with exact_fp32():
        asr_reduced = phase_asr_reduced_depth(card)
    log(f"phase ASR reduced-depth card vs CPU: ok in "
        f"{time.perf_counter() - t0:.1f} s")

    # 5f. the ASR path at asr.yaml's full width (its model freed after)
    t0 = time.perf_counter()
    asr_launches, asr = phase_asr_main_path(card)
    torch.cuda.empty_cache()
    log(f"phase ASR path: ok in {time.perf_counter() - t0:.1f} s")

    # 5g. the served product: configs/calm.yaml through the port's own
    # load_config and HTTP server, requests over HTTP (its engine freed
    # after)
    t0 = time.perf_counter()
    served_launches, gemm_launches, served_product = phase_served_product(
        card)
    log(f"phase served product: ok in {time.perf_counter() - t0:.1f} s")

    # 5h. the served product on checkpoint weights: reference-layout files
    # in, bf16 and int8 LLM weights
    t0 = time.perf_counter()
    ckpt_launches, ckpt_product = phase_checkpoint_product(card, smi)
    log(f"phase checkpoint product: ok in {time.perf_counter() - t0:.1f} s")

    # 6. kernel times (the plain versions as they were compared)
    with exact_fp32():
        with torch.no_grad():
            kernels = phase_kernel_times(voc, counts, errs, card)
            kernels[0]["v2_stages"] = kernel_time_narrow_stages(v2_card, card)
            kernels[0]["v2_render_launches"] = \
                voc_counts["v2_hifigan"]["vocoder_stage"]
            kernels[0]["max_abs_err_v2_stages"] = errs["vocoder_stage_narrow"]
        kernels.append(kernel_time_attention_bwd(
            train_counts, trained["steps"], errs, card))
        with torch.no_grad():
            kernels.append(kernel_time_resblock(
                vocs, gen, voc_counts["odd_width_hifigan"]["fused_resblock"],
                errs["fused_resblock"], card))
    kernels[1]["training_launches"] = train_counts["attention_fwd"]
    kernels[1]["max_abs_err_padded_head_dims"] = errs["attention_fwd_padded"]
    next(k for k in kernels if k["name"] == "attention_bwd")[
        "max_abs_err_padded_head_dims"] = errs["attention_bwd_padded"]
    with torch.no_grad():
        kernels.append(kernel_time_gemm(gemm_launches, errs["gemm"], card))

    # 5i. the shipped TTS training recipe: packed steps at full width
    # through train_calm, resume, eval, components served (after the
    # kernel times: their short profiler sessions ran before it when they
    # were chosen)
    t0 = time.perf_counter()
    packed, packed_walls, packed_probe = phase_packed_training(card, smi)
    log(f"phase packed training: ok in {time.perf_counter() - t0:.1f} s "
        + json.dumps(packed_walls))
    # the packed recipe's run 2 (steps 3-6): K3/K4 in its eval forwards
    # only, no K5
    kernels[1]["packed_training_launches"] = \
        packed["run_launches"]["run2"]["attention_fwd"]
    next(k for k in kernels if k["name"] == "attention_bwd")[
        "packed_training_launches"] = \
        packed["run_launches"]["run2"]["attention_bwd"]
    kernels[1]["asr_launches"] = asr_launches
    kernels[1]["served_product_launches"] = served_launches
    kernels[1]["checkpoint_product_launches"] = ckpt_launches

    # 7. where the device time of the served requests goes (last: the
    # profiler slows what runs after it)
    t0 = time.perf_counter()
    served.update(phase_profile(serve, served["wall_s"]))
    log(f"phase profile: ok in {time.perf_counter() - t0:.1f} s")
    log("served " + json.dumps(served))
    t0 = time.perf_counter()
    trained.update(phase_train_profile(
        train_probe, trained["step_s_median_after_first"]))
    del train_probe
    log(f"phase training profile: ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    packed.update(phase_step_profile(packed_probe, "packed"))
    del packed_probe
    log(f"phase packed training profile: ok in "
        f"{time.perf_counter() - t0:.1f} s")

    # 5j. ASR training and the mix: asr.yaml and calm.yaml at full width
    # through train_calm, plain ASR steps, components served, then its
    # steps profiled (after the profiles above: after 5j, each profiler
    # session lost the records of its first 13-15 launches, more than a
    # short session may lose)
    t0 = time.perf_counter()
    asr_trained, asr_walls, asr_probes = phase_asr_training(card, smi)
    log(f"phase ASR training: ok in {time.perf_counter() - t0:.1f} s "
        + json.dumps(asr_walls))
    # the asr.yaml run: K3/K4 in its eval forwards only; a plain ASR step:
    # K4 and K5 in every Qwen2 layer of every slice
    kernels[1]["asr_training_launches"] = {
        "asr_yaml_run": asr_trained["asr_run_launches"]["attention_fwd"],
        "plain_asr_step": asr_trained["asr_plain"]["launches_per_step"][
            "attention_fwd"]}
    next(k for k in kernels if k["name"] == "attention_bwd")[
        "asr_training_launches"] = {
        "asr_yaml_run": asr_trained["asr_run_launches"]["attention_bwd"],
        "plain_asr_step": asr_trained["asr_plain"]["launches_per_step"][
            "attention_bwd"]}
    t0 = time.perf_counter()
    asr_trained["asr_packed"].update(phase_step_profile(
        asr_probes.pop("asr_packed"), "packed ASR"))
    asr_trained["asr_plain"].update(phase_step_profile(
        asr_probes.pop("asr"), "plain ASR"))
    log(f"phase ASR training profile: ok in "
        f"{time.perf_counter() - t0:.1f} s")

    # 5k. VAE training and few-step distillation at full width through
    # train_vae and distill_calm (after 5j: its steps are profiled with a
    # lead step)
    t0 = time.perf_counter()
    vae_distill, vd_walls = phase_vae_and_distillation(card, smi)
    log(f"phase VAE training and distillation: ok in "
        f"{time.perf_counter() - t0:.1f} s " + json.dumps(vd_walls))
    fwd = kernels[1]
    bwd = next(k for k in kernels if k["name"] == "attention_bwd")
    for task in ("tts", "asr"):
        per_step = vae_distill[task]["launches_per_step"]
        fwd.setdefault("distillation_launches", {})[task] = {
            "per_step": per_step["attention_fwd"],
            "run": vae_distill[task]["run_launches"]["attention_fwd"]}
        bwd.setdefault("distillation_launches", {})[task] = {
            "per_step": per_step["attention_bwd"],
            "run": vae_distill[task]["run_launches"]["attention_bwd"]}
    # 5l. data preparation at vae.yaml's width through process_dataset,
    # compute_stats and convert_store; then the end-to-end proof
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        prep = phase_data_prep(card, smi, tmp)
    log(f"phase data preparation: ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    proof = phase_e2e_proof(card)
    log(f"phase end-to-end proof: ok in {time.perf_counter() - t0:.1f} s")
    fwd["e2e_proof_launches"] = proof["run_launches"]["attention_fwd"]
    bwd["e2e_proof_launches"] = proof["run_launches"]["attention_bwd"]
    # the batch-invariant products' cost against cuBLAS (last: profiles)
    t0 = time.perf_counter()
    served_product["invariance_cost"] = phase_invariance_cost(card)
    log(f"phase batch-invariance cost: ok in "
        f"{time.perf_counter() - t0:.1f} s")
    log("trained " + json.dumps(trained))
    log("packed_training " + json.dumps(packed))
    log("asr_training " + json.dumps(asr_trained))
    log("vae_distillation " + json.dumps(vae_distill))
    log("vocoder_path " + json.dumps(voc_path))
    log("reconstruction " + json.dumps(recon))
    log("asr " + json.dumps({**asr, "reduced_depth": asr_reduced}))
    log("served_product " + json.dumps(served_product))
    log("checkpoint_product " + json.dumps(ckpt_product))
    log("data_prep " + json.dumps(prep))
    log("e2e_proof " + json.dumps(proof))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

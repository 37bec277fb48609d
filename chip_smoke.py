#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (audio_calm_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes, fp32 and bf16 (the attention backward at the Qwen2
     training shape, and the flash_attention Function against autograd
     through the plain forward; the resblock kernel at C = 12, 24, 48, 96,
     128, 256 and k = 3, 7, 11 with a ragged last tile, the sequence
     edges held on their own; the stage kernel at HiFi-GAN V2's C = 16
     and C = 8);
  4. the serving slice at full widths with 2 LLM layers on the 96-frame
     grid, fp32, on the card and on the CPU, same weights and ODE noise;
     then one TTS training step (forward_tts + backward) at full widths
     with 2 LLM layers, fp32, dropouts off, on both, same weights and flow
     noise: loss terms, every trainable gradient, and the card's attention
     kernel launches (Qwen2 and DiT attention both through K4/K5);
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
     samples/s, peak memory;
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
  6. per kernel: its launches on its main path, its device time per launch
     at main-path shapes, the bound, the plain version's and the library
     call's device time;
  7. the served requests once more under torch.profiler (device activity
     only): the device's busy share and the kernels that take most time;
     then one more training step, the same way.
Then the card, one `kernels` JSON line, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, NVIDIA H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3
SEC_PER_FRAME = 4 * 256 / 16000  # one latent frame = 1024 samples at 16 kHz
TRAIN_STEPS = 5


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


def device_profile(fn, iters: int = 1):
    """fn() `iters` times under torch.profiler, device activity only ->
    (host wall s, [(kernel, device s, calls)] by device time). The device
    time of every kernel and copy counts once (one stream: no overlap);
    host time between launches does not."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = synced(lambda: [fn() for _ in range(iters)])
    rows = [(e.key, e.self_device_time_total * 1e-6, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    return wall, sorted(rows, key=lambda r: -r[1])


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` runs after one warm-up: the
    sum over the kernels it launches. A loop timed with CUDA events would
    count the host's time to launch them at these small shapes."""
    fn()
    _, rows = device_profile(fn, iters)
    return 1e3 * sum(r[1] for r in rows) / iters


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


def attn_cost(q, k, valid, causal, dtype_bytes):
    """(FLOP, bytes) attention needs on this data: 4*d per (query, head,
    attended key) pair; q, k, v, out and the key mask read/written once."""
    B, T, Hq, d = q.shape
    S = k.shape[1]
    m = valid.bool()[:, None, :].expand(B, T, S)
    if causal:
        tri = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
        m = m & tri
    pairs = int(m.sum())
    flops = 4.0 * d * Hq * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * dtype_bytes + valid.numel()
    return flops, nbytes


def bound_ms(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_kernels(gen, card):
    """Each kernel vs its plain version; returns the worst errors."""
    from audio_calm_torch.ops.attention_kernel import (attention_fwd,
                                                       attention_fwd_plain)
    from audio_calm_torch.ops.vocoder_kernel import (vocoder_stage,
                                                     vocoder_stage_plain)

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
    return worst


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
    from audio_calm_torch.ops.vocoder_kernel import (_halo, _resblock_plan,
                                                     fused_resblock,
                                                     fused_resblock_plain,
                                                     vocoder_stage,
                                                     vocoder_stage_plain)

    g = torch.Generator(card).manual_seed(4)
    worst = {"fused_resblock": 0.0, "vocoder_stage_narrow": 0.0}
    for C in (12, 24, 48, 96, 128, 256):
        for k in (3, 7, 11):
            # two of the larger of the two paths' tiles and a ragged third
            tile = max(_resblock_plan(C, k, (1, 3, 5), 10 ** 7, tc)[2]
                       for tc in (True, False))
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


def phase_attention_bwd(card):
    """K5 vs its plain version at the training shape, fp32 and bf16, and the
    flash_attention Function vs autograd through the plain forward."""
    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_bwd_plain,
                                                       attention_fwd,
                                                       attention_fwd_plain,
                                                       flash_attention)

    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, dout, valid = qwen_train_inputs(16, dt, card)
        with torch.no_grad():
            out = attention_fwd(q, k, v, valid, True)
            got = attention_bwd(q, k, v, out, dout, valid, True)
            ref = attention_bwd_plain(q, k, v, out, dout, valid, True)
        for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
            a, b = a.float(), b.float()
            err = (a - b).abs().max().item()
            # fp32: summation order over up to 6 heads x 97 keys; bf16:
            # one rounding step of the largest gradient
            bound = (2e-5 if dt == torch.float32 else 2 ** -7) * \
                b.abs().max().item()
            log(f"  attention_bwd Qwen2 [16, 97, 12/2, 128] {name} "
                f"{str(dt)[6:]}: max_abs_err {err:.3e} bound {bound:.3e}")
            check(err <= bound and a.shape == b.shape,
                  f"attention_bwd {name} {dt}")
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
    for k, ref in res["cpu"][0].items():
        err = abs(res["card"][0][k] - ref)
        log(f"  train step {k}: cpu {ref:.6f} card {res['card'][0][k]:.6f}")
        check(err <= 1e-4 * abs(ref), f"train step {k} card vs CPU")
    grads_cpu, grads_card = res["cpu"][1], res["card"][1]
    trainable = {n for n, lab in labels.items() if lab != "frozen"}
    check(set(grads_card) == set(grads_cpu) and set(grads_cpu) <= trainable,
          "the same tensors get gradients on both devices")
    top = max(g.abs().max().item() for g in grads_cpu.values())
    worst = 0.0
    for n, ref in grads_cpu.items():
        err = (grads_card[n] - ref).abs().max().item()
        # fp32 on both, TF32 off: summation order; a floor for tensors whose
        # gradient is zero analytically (the key biases)
        bound = 1e-3 * max(ref.abs().max().item(), 1e-3 * top)
        worst = max(worst, err / bound)
        check(err <= bound, f"train step gradient of {n}")
    log(f"  train step: {len(grads_cpu)} trainable gradients agree, worst "
        f"error {worst:.3f} of its bound (1e-3 of the tensor's largest "
        "value)")


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
    from audio_calm_torch.train.steps import make_calm_step

    steps = TRAIN_STEPS
    # configs/tts.yaml, training: (plain batches)
    tcfg = TrainingConfig(
        per_device_train_batch_size=32, microbatch_steps=2, soa_lr_mult=3.0,
        proj_lr_mult=1.0, head_lr_mult=3.0, learning_rate=5e-5,
        frozen_weights_dtype="bfloat16", lr_scheduler_type="cosine",
        warmup_ratio=0.1, max_grad_norm=1.0, logging_steps=1)
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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention_fwd.launches = 0
    attention_bwd.launches = 0
    history = run_training(step, feed(), tcfg, total_steps=steps)
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
    return {"profiled_step_wall_s": p_wall, "step_device_busy_s": busy,
            "step_device_ops": launches, "parts": parts}


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
    return {"profiled_wall_s": p_wall, "device_busy_s": busy}


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


def kernel_time_resblock(vocs, v1_gen, launches, worst, card):
    """K6 per launch at the odd-width render's resblock shapes (B=2,
    384-frame grid: [2, 98304, 96], [2, 196608, 48], [2, 393216, 24], k =
    3, 7, 11) and at V1's C=128 and C=256 resblock shapes, fp32
    activations and bf16 operands as the render runs it, beside the bound,
    the plain version; no single library call computes a resblock."""
    from audio_calm_torch.ops.vocoder_kernel import (fused_resblock,
                                                     fused_resblock_plain,
                                                     stack_resblock)

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
            k, n_d, C = block[4], len(block[5]), block[0].shape[-1]
            x = torch.randn(2, T, C, generator=g, device=card)
            ms = device_ms(lambda: fused_resblock(x, block), 3)
            plain = device_ms(lambda: fused_resblock_plain(x, block), 3)
            flops = 2.0 * 2 * n_d * x.shape[0] * T * k * C * C
            nbytes = 2 * x.numel() * 4 + 2 * n_d * (k * C * C * 2 + C * 4)
            b, by = bound_ms(flops, nbytes, H100_BF16_FLOPS)
            rows.append({"shape": label, "x": list(x.shape), "k": k,
                         "ms": ms, "plain_ms": plain, "bound_ms": b,
                         "bound_by": by, "flop": flops, "bytes": nbytes})
            log("  fused_resblock " + json.dumps(rows[-1]))
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
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": bound_by,
        "library_ms": None, "library": "none (no single call computes a "
                                       "resblock)",
        "per_launch": "mean over the odd-width render's 9 resblock shapes "
                      "(B=2, 384-frame grid: C=96, 48, 24 x k=3, 7, 11); "
                      "V1's C=128 and C=256 shapes listed beside",
        "shapes": rows,
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
        b, by = bound_ms(flops, nbytes, H100_BF16_FLOPS)
        rows.append({"stage": f"V2 {index}", "x": list(args[0].shape),
                     "C": C_in // 2, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by})
        log("  vocoder_stage " + json.dumps(rows[-1]))
    return rows


def phase_kernel_times(calm, voc, counts, errs, card):
    """ms per launch at main-path shapes, beside bound, plain and library."""
    import torch.nn.functional as F

    from audio_calm_torch.ops.attention_kernel import (attention_fwd,
                                                       attention_fwd_plain)
    from audio_calm_torch.ops.vocoder_kernel import (vocoder_stage,
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
        b, by = bound_ms(flops, nbytes, H100_BF16_FLOPS)
        rows.append({"stage": index, "x": list(args[0].shape), "ms": ms,
                     "plain_ms": plain, "bound_ms": b, "bound_by": by,
                     "flop": flops, "bytes": nbytes})
        log("  vocoder_stage " + json.dumps(rows[-1]))
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

    # attention: the 384-grid request's shapes, weighted by launches
    B, S_txt = 2, 24
    dt = calm.dtype
    shapes = [  # (label, B, T, S, Hq, Hkv, d, causal, launches per request)
        ("Qwen2 encode", B, S_txt + 1, S_txt + 1, 12, 2, 128, True, 28),
        ("DiT self", 2 * B, 384, 384, 16, 16, 64, False, 96),
        ("DiT cross", 2 * B, 384, S_txt, 16, 16, 64, False, 96),
    ]
    rows = []
    for label, b_, T, S, Hq, Hkv, d, causal, n in shapes:
        q = torch.randn(b_, T, Hq, d, generator=g, device=card).to(dt)
        k = torch.randn(b_, S, Hkv, d, generator=g, device=card).to(dt)
        v = torch.randn(b_, S, Hkv, d, generator=g, device=card).to(dt)
        valid = torch.ones(b_, S, dtype=torch.bool, device=card)
        if label != "DiT self":
            valid[1::2, 16:S_txt] = False  # the shorter text's pad
        ms = device_ms(lambda: attention_fwd(q, k, v, valid, causal), 50)
        plain = device_ms(
            lambda: attention_fwd_plain(q, k, v, valid, causal), 50)
        mask = valid[:, None, None, :].expand(b_, 1, T, S)
        if causal:
            mask = mask & torch.ones(T, S, dtype=torch.bool,
                                     device=card).tril(S - T)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv), 50)
        flops, nbytes = attn_cost(q, k, valid, causal, 2)
        b, by = bound_ms(flops, nbytes, H100_BF16_FLOPS)
        rows.append({"shape": label, "q": [b_, T, Hq, d], "S": S,
                     "launches_per_request": n, "ms": ms, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": b, "bound_by": by})
        log("  attention_fwd " + json.dumps(rows[-1]))
    w = np.array([r["launches_per_request"] for r in rows], float)

    def wmean(key):
        return float(np.dot(w, [r[key] for r in rows]) / w.sum())

    bound_by = max(("operations", "bytes"),
                   key=lambda k: sum(wi for wi, r in zip(w, rows)
                                     if r["bound_by"] == k))
    kernels.append({
        "name": "attention_fwd", "route": "cuda",
        "source": "audio_calm_torch/csrc/attention_fwd.cu",
        "replaces": "audio_calm_tpu/ops/pallas_attention.py:91",
        "also_replaces": "audio_calm_tpu/ops/pallas_attention.py:181",
        "launches": counts["attention_fwd"],
        "max_abs_err": errs["attention_fwd"],
        "ms": wmean("ms"), "plain_ms": wmean("plain_ms"),
        "bound_ms": wmean("bound_ms"), "bound_by": bound_by,
        "library_ms": wmean("library_ms"),
        "per_launch": "launch-weighted mean over the 384-grid request's "
                      "shapes (28 Qwen2, 96 DiT self, 96 DiT cross)",
        "shapes": rows,
    })
    return kernels


def kernel_time_attention_bwd(train_counts, train_steps, errs, card):
    """K5 at the training path's shape (one microbatch slice: B=16, bf16,
    causal, the [text | pads | SOA] key mask): device ms per launch beside
    the bound, the plain version and autograd's backward of SDPA."""
    import torch.nn.functional as F

    from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                       attention_bwd_plain,
                                                       attention_fwd)

    B = 16
    q, k, v, dout, valid = qwen_train_inputs(B, torch.bfloat16, card, seed=2)
    _, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    with torch.no_grad():
        out = attention_fwd(q, k, v, valid, True)
        ms = device_ms(lambda: attention_bwd(q, k, v, out, dout, valid, True),
                       50)
        plain = device_ms(lambda: attention_bwd_plain(q, k, v, out, dout,
                                                      valid, True), 20)
    mask = (valid[:, None, None, :] & torch.ones(
        T, S, dtype=torch.bool, device=card).tril(S - T))
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             enable_gqa=True)
    g = dout.transpose(1, 2)
    lib = device_ms(lambda: torch.autograd.grad(lib_out, leaves, g,
                                                retain_graph=True), 50)
    # JAX's cost estimate of the backward: 5 products of 2*T*S*d per head;
    # bytes: q, k, v, o, dO read once, dq, dk, dv written once, the mask
    flops = 5 * 2.0 * B * Hq * T * S * d
    nbytes = (4 * q.numel() + 4 * k.numel()) * 2 + valid.numel()
    b, by = bound_ms(flops, nbytes, H100_BF16_FLOPS)
    row = {
        "name": "attention_bwd", "route": "cuda",
        "source": "audio_calm_torch/csrc/attention_bwd.cu",
        "replaces": "audio_calm_tpu/ops/pallas_attention.py:306",
        "launches": train_counts["attention_bwd"],
        "launches_per_step": train_counts["attention_bwd"] // train_steps,
        "max_abs_err": errs["attention_bwd"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": by, "library_ms": lib,
        "per_launch": "one Qwen2 layer's backward for one microbatch slice: "
                      f"q [{B}, {T}, {Hq}, {d}], k/v [{B}, {S}, {Hkv}, {d}], "
                      "bf16, causal, ragged key mask",
        "flop": flops, "bytes": nbytes,
    }
    log("  attention_bwd " + json.dumps(row))
    return row


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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

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

    # 5. main path at full width, with PyTorch's default numerics (the
    # plain fp32 convolutions of the VAE and the vocoder in TF32)
    t0 = time.perf_counter()
    calm, voc, counts, serve, served = phase_main_path(card)
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

    # 6. kernel times (the plain versions as they were compared)
    with exact_fp32():
        with torch.no_grad():
            kernels = phase_kernel_times(calm, voc, counts, errs, card)
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
    log("trained " + json.dumps(trained))
    log("vocoder_path " + json.dumps(voc_path))
    log("reconstruction " + json.dumps(recon))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (audio_calm_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, fp32 and bf16;
  4. the whole slice at full widths with 2 LLM layers on the 96-frame grid,
     fp32, on the card and on the CPU, same weights and ODE noise;
  5. the main path at full width: the flagship (28-layer Qwen2-1.5B, DiT
     1024x4, VAE, HiFi-GAN V1, random bf16 weights from a seed) serves a
     batch of 2 texts on the 384-frame grid and 1 text on the 192-frame grid
     (125 frames), midpoint-12, cfg 2.5; every kernel's launch count must
     rise as the path requires; per-phase times and the realtime factor;
  6. per kernel: its launches on the main path, its device time per launch
     at main-path shapes, the bound, the plain version's and the library
     call's device time;
  7. the served requests once more under torch.profiler (device activity
     only): the device's busy share and the kernels that take most time.
Then the card, one `kernels` JSON line, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, NVIDIA H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3
SEC_PER_FRAME = 4 * 256 / 16000  # one latent frame = 1024 samples at 16 kHz


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


def text_batch(lengths, seed=0):
    """Random token ids (as bench.py: ids in [10, 5000)), right-padded."""
    T = max(lengths)
    ids = np.random.default_rng(seed).integers(10, 5000, (len(lengths), T))
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None])
    return (torch.as_tensor(ids * mask, dtype=torch.long),
            torch.as_tensor(mask, dtype=torch.int32))


def stage_args(gen, index, x):
    """The stage kernel's arguments for HiFi-GAN stage `index` on input x,
    as hifigan_apply_fused routes them (index 1: grouped, 2/3: upsample)."""
    from audio_calm_torch.ops.vocoder_kernel import stack_resblock

    blocks = [stack_resblock(rb) for rb in gen.resblocks[index]]
    if index == 1:
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
    with exact_fp32():
        errs = phase_kernels(gen, card)
    log(f"phase kernels vs plain: ok in {time.perf_counter() - t0:.1f} s")

    # 4. reduced depth, card vs CPU
    t0 = time.perf_counter()
    with exact_fp32():
        phase_reduced_depth(card)
    log(f"phase reduced-depth card vs CPU: ok in "
        f"{time.perf_counter() - t0:.1f} s")

    # 5. main path at full width, with PyTorch's default numerics (the
    # plain fp32 convolutions of the VAE and the vocoder in TF32)
    t0 = time.perf_counter()
    calm, voc, counts, serve, served = phase_main_path(card)
    log(f"phase main path: ok in {time.perf_counter() - t0:.1f} s")

    # 6. kernel times (the plain versions as they were compared)
    with exact_fp32():
        kernels = phase_kernel_times(calm, voc, counts, errs, card)

    # 7. where the device time of the served requests goes (last: the
    # profiler slows what runs after it)
    t0 = time.perf_counter()
    served.update(phase_profile(serve, served["wall_s"]))
    log(f"phase profile: ok in {time.perf_counter() - t0:.1f} s")
    log("served " + json.dumps(served))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

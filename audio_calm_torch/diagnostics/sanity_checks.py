"""Sanity-check harness (counterpart of scripts/sanity_checks.py):

    python -m audio_calm_torch.diagnostics.sanity_checks \\
        --config configs/tts.yaml [--components DIR] \\
        [--latent-audit data/latents/dev] [--vae-upper-bound DIR \\
        [--vae-ckpt <train_vae output_dir or its vae.bin>] \\
        [--vocoder CKPT]] [--byte-tokenizer] [--device cpu]

Checks, each printing its verdict line:
  1. the latent-store audit (NaN / Inf / moments, with rescale advice);
  2. the VAE upper bound: up to 10 stored latents of --vae-upper-bound
     decoded by the VAE, then the vocoder (Griffin-Lim without --vocoder),
     written to --out-dir as upper_bound_<i>.wav. --vae-ckpt is what the
     port's train_vae writes (its vae.bin, or the directory holding it); a
     directory without one (a JAX orbax directory) raises, as
     train/checkpoint.orbax_item_error says. Without it the VAE is random,
     with a warning;
  3. flow learning: the eval-mode TTS flow loss over up to --max-batches
     batches of 2 of the config's TTS store against the pred_v = 0
     baseline of 2.0 (the model: seed 0 weights in fp32 with the
     --components laid over them; its noise from a generator seeded 0);
  4. the length predictor's relative error on the same batches
     (encode_text_for_tts, then predict_length, against the batches'
     audio_mask.sum(1)).
Exit code 1 when any check says FAIL (or the upper bound finds no
latent), else 0. Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.diagnostics.sanity import (audit_latents,
                                                 check_flow_learning,
                                                 predictor_error_stats)

_LATENT_SUFFIXES = (".npz", ".npy", ".pt")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="configs/calm.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--components", default=None)
    p.add_argument("--latent-audit", default=None)
    p.add_argument("--vae-upper-bound", default=None,
                   help="latent dir: decode stored GT latents -> wav")
    p.add_argument("--vae-ckpt", default=None,
                   help="the VAE train_vae wrote (vae.bin or its directory)")
    p.add_argument("--vocoder", default=None,
                   help="HiFi-GAN checkpoint (file or SpeechBrain dir); "
                        "default Griffin-Lim")
    p.add_argument("--out-dir", default="outputs/sanity")
    p.add_argument("--max-batches", type=int, default=4)
    p.add_argument("--byte-tokenizer", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' only "
                        "when asked)")
    return p.parse_args(argv)


def latent_files(root: str):
    return sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root)
                  for f in fs if f.endswith(_LATENT_SUFFIXES))


def load_upper_bound_vae(path, latent_dim: int, device):
    """-> (VAE, its config): the file train_vae exported (a directory is
    searched for vae.bin, and load_vae raises for one without it), or a
    random VAE from seed 0 when path is None."""
    from audio_calm_torch.config import VAEModelConfig
    from audio_calm_torch.models.flagship import build_random
    from audio_calm_torch.models.vae import AcousticVAE, load_vae

    if path is None:
        print("[vae upper bound] WARNING: random-init VAE")
        cfg = VAEModelConfig(latent_channels=latent_dim)
        return build_random(lambda: AcousticVAE(cfg), device, seed=0), cfg
    if os.path.isdir(path) and os.path.isfile(os.path.join(path, "vae.bin")):
        path = os.path.join(path, "vae.bin")
    vae = load_vae(path, device=device)
    return vae, vae.cfg


def vae_upper_bound(args, device) -> bool:
    """Check 2: stored latents -> VAE decode -> vocoder -> wavs; False
    when there is no latent to decode."""
    from audio_calm_torch.data.datasets import load_array
    from audio_calm_torch.eval.eval_calm import write_wav
    from audio_calm_torch.models.vae import denormalize_mel
    from audio_calm_torch.models.vocoder import load_vocoder

    files = latent_files(args.vae_upper_bound)
    if not files:
        print("[vae upper bound] no latents found")
        return False
    lat_dim = load_array(files[0]).shape[1]
    vae, vae_cfg = load_upper_bound_vae(args.vae_ckpt, lat_dim, device)
    voc = load_vocoder(args.vocoder, device=device)
    print(f"[vae upper bound] vocoder: {type(voc).__name__}")
    os.makedirs(args.out_dir, exist_ok=True)
    files = files[:10]
    with torch.no_grad():
        for i, fp in enumerate(files):
            lat = torch.as_tensor(load_array(fp)[None], device=device)
            mel = denormalize_mel(vae.decode(lat), vae_cfg)
            wav = voc(mel)[0].float().cpu().numpy()
            write_wav(os.path.join(args.out_dir, f"upper_bound_{i}.wav"),
                      wav)
    print(f"[vae upper bound] decoded {len(files)} latents -> "
          f"{args.out_dir} (listen to judge the ceiling)")
    return True


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    ok = True

    if args.latent_audit:
        audit = audit_latents(latent_files(args.latent_audit))
        print(f"[latent audit] {audit.verdict}: {audit.n_files} files, "
              f"mean={audit.mean:.4f} std={audit.std:.4f} "
              f"range=[{audit.vmin:.2f},{audit.vmax:.2f}] "
              f"nan={audit.n_nan} inf={audit.n_inf}")
        if audit.advice:
            print(f"  advice: {audit.advice}")
        ok &= audit.verdict != "FAIL"

    if args.vae_upper_bound and not vae_upper_bound(args, device):
        return 1

    from audio_calm_torch.config import CALMConfig, load_config
    from audio_calm_torch.data.collator import calm_batch_iterator
    from audio_calm_torch.data.datasets import CalmDataset
    from audio_calm_torch.data.tokenizer import load_tokenizer
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.flagship import build_random
    from audio_calm_torch.train.checkpoint import COMPONENTS, soft_restart

    cfg = load_config(args.config, cls=CALMConfig, overrides=args.override)
    m, d = cfg.model, cfg.data
    tokenizer = load_tokenizer(m, byte_fallback=args.byte_tokenizer)
    tts = d.datasets.get("tts")
    if not tts or not tts.latent_dir or not os.path.isdir(tts.latent_dir):
        print("[flow check] skipped: no tts latent dir")
        return 0 if ok else 1
    ds = CalmDataset(tokenizer, tts_latent_dir=tts.latent_dir,
                     tts_subsets=tts.subsets, max_text_len=d.max_text_len,
                     max_audio_len=d.max_audio_len, task_mode="tts",
                     latent_dim=m.latent_dim)
    model = build_random(lambda: QwenCALM(m), device, seed=0)
    if args.components:
        soft_restart(model, {c: args.components
                             for c in COMPONENTS + ("lora",)})

    batches = []
    for b in calm_batch_iterator(ds, 2, tokenizer.pad_token_id or 0,
                                 m.latent_dim, task_prob_tts=1.0,
                                 training=False, seed=0, epochs=1):
        batches.append({k: torch.as_tensor(v, device=device)
                        for k, v in b.items() if k != "task"})
        if len(batches) >= args.max_batches:
            break
    if not batches:
        print("[flow check] skipped: no batches")
        return 0 if ok else 1

    res = check_flow_learning(
        model, batches, generator=torch.Generator(device).manual_seed(0))
    print(f"[flow check] {res['verdict']}: loss_tts={res['loss_tts']:.4f} "
          f"(pred_v=0 baseline={res['baseline']})")
    ok &= res["verdict"] != "FAIL"

    preds, gts = [], []
    with torch.no_grad():
        for b in batches:
            _, text_ctx, text_pad = model.encode_text_for_tts(
                b["text_ids"], b["attention_mask"])
            preds.append(model.predict_length(text_ctx, text_pad)
                         .float().cpu().numpy())
            gts.append(b["audio_mask"].sum(dim=1).float().cpu().numpy())
    stats = predictor_error_stats(np.concatenate(preds), np.concatenate(gts))
    print(f"[len predictor] rel err mean={stats['mean']:.3f} "
          f"p50={stats['p50']:.3f} p90={stats['p90']:.3f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

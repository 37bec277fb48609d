"""Evaluate a VAE's reconstruction (counterpart of scripts/eval_vae.py):

    python -m audio_calm_torch.eval.eval_vae --config configs/vae.yaml \\
        --ckpt <training.output_dir>/vae.bin [--max-samples 10] \\
        [--write-wavs] [--out-dir outputs/vae_eval] [--device cpu]

Reconstructs up to --max-samples centre crops of data.eval_data_dir /
eval_subsets (else data_dir / train_subsets) through the VAE with the
global mel normalization of training (eval/reconstruct.py) and prints the
reconstruction MSE and L1 and the latent health (KL, std of mu, mean of
exp(logvar)); --write-wavs writes Griffin-Lim wav pairs of the first five
to --out-dir. --ckpt is the torch file train_vae exports (or a reference
VAE checkpoint; `vae_config.json` beside it gives the geometry, else the
config's); without it the VAE has fresh weights, with a warning.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np

from audio_calm_torch import resolve_device
from audio_calm_torch.config import VAEConfig, load_config
from audio_calm_torch.data.datasets import MelDataset
from audio_calm_torch.eval.reconstruct import reconstruct
from audio_calm_torch.models.vae import AcousticVAE, init_vae_, load_vae
from audio_calm_torch.models.vocoder import GriffinLimVocoder

WAV_PAIRS = 5


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="configs/vae.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--ckpt", default=None,
                   help="the VAE file train_vae exports (vae.bin)")
    p.add_argument("--max-samples", type=int, default=10)
    p.add_argument("--out-dir", default="outputs/vae_eval")
    p.add_argument("--write-wavs", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' only "
                        "when asked)")
    return p.parse_args(argv)


def evaluate(argv=None) -> Dict:
    """-> reconstruct()'s statistics over the eval crops (and "wav_dir"
    when wavs were written); raises FileNotFoundError without data."""
    from audio_calm_torch.serving.server import wav_bytes

    args = parse_args(argv)
    cfg = load_config(args.config, cls=VAEConfig, overrides=args.override)
    d = cfg.data
    device = resolve_device(args.device)
    ds = MelDataset(d.eval_data_dir or d.data_dir,
                    d.eval_subsets or d.train_subsets, crop_size=d.crop_size,
                    training=False, max_samples=args.max_samples)
    if len(ds) == 0:
        raise FileNotFoundError("no eval data")
    if args.ckpt:
        vae = load_vae(args.ckpt, device=device)
    else:
        print("warning: random-init VAE (pass --ckpt for a real eval)")
        vae = AcousticVAE(cfg.model).to(device)
        init_vae_(vae, 0)
        vae.eval().requires_grad_(False)
    mels = [ds.get(i) for i in range(min(len(ds), args.max_samples))]
    out = reconstruct(vae, mels, device=device)
    print(f"samples: {len(mels)}")
    print(f"recon MSE: {out['mse']:.5f}  L1: {out['l1']:.5f}")
    print(f"latent health: kl_mean={out['kl_mean']:.5f} "
          f"mu_std={out['mu_std']:.4f} var_mean={out['var_mean']:.4f}")
    if args.write_wavs:
        import torch

        voc = GriffinLimVocoder(n_mels=vae.cfg.in_channels, device=device)
        os.makedirs(args.out_dir, exist_ok=True)
        for i, pair in enumerate(out["recons"][:WAV_PAIRS]):
            for tag, mel in zip(("orig", "recon"), pair):
                wav = voc(torch.as_tensor(mel, device=device)[None])[0]
                with open(os.path.join(args.out_dir, f"{i}_{tag}.wav"),
                          "wb") as f:
                    f.write(wav_bytes(np.clip(wav.cpu().numpy(), -1, 1)))
        out["wav_dir"] = args.out_dir
        print(f"wrote wav pairs to {args.out_dir}")
    return out


def main(argv=None) -> int:
    try:
        evaluate(argv)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Offline corpus preprocessing CLI (counterpart of
scripts/process_dataset.py).

  # mel extraction
  python -m audio_calm_torch.data.process_dataset \
      --input_dir raw/LibriTTS_R/dev-clean \
      --output_dir data/mels/dev/LibriTTS_R/dev-clean --dataset libritts \
      --mel_only

  # VAE latent extraction: a trained VAE in the reference torch layout
  # (train/train_vae.py writes <output_dir>/vae.bin and vae_config.json)
  python -m audio_calm_torch.data.process_dataset \
      --input_dir raw/LibriSpeech/dev-clean \
      --output_dir data/latents/dev/LibriSpeech/dev-clean \
      --dataset librispeech --vae_ckpt outputs/vae/vae.bin

  # corpus statistics
  python -m audio_calm_torch.data.process_dataset --stats data/mels/dev \
      --stats_key mel

The latents are the VAE encoder's means of the NORMALIZED log-mel ((mel -
mel_mean) / mel_std, the distribution the VAE trained on), as the JAX
script does. `--num_shards N --shard_id i` takes files[i::N], one process
each; their transcripts merge on disk. It runs on the card unless
`--device cpu` is given. Exit code 0, or 2 when a file failed.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir")
    p.add_argument("--output_dir")
    p.add_argument("--dataset", default="librispeech",
                   choices=["librispeech", "libritts", "commonvoice"])
    p.add_argument("--cv_tsv", help="CommonVoice split tsv")
    p.add_argument("--mel_only", action="store_true")
    p.add_argument("--vae_ckpt", help="VAE checkpoint file (reference torch "
                   "layout, models/vae.load_vae) for latents")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--no_skip_existing", action="store_true")
    p.add_argument("--stats", help="compute mean/std over stored arrays in dir")
    p.add_argument("--stats_key", default="mel", choices=["mel", "latent"])
    p.add_argument("--per_dim", action="store_true")
    p.add_argument("--num_shards", type=int, default=1,
                   help="split the corpus across N independent jobs, each "
                        "taking files[shard_id::num_shards]")
    p.add_argument("--shard_id", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' only "
                        "when asked)")
    args = p.parse_args(argv)
    if not 0 <= args.shard_id < args.num_shards:
        p.error("--shard_id must be in [0, num_shards)")
    if not args.stats and not (args.input_dir and args.output_dir):
        p.error("--input_dir and --output_dir required (or use --stats)")
    if args.dataset == "commonvoice" and not args.stats and not args.cv_tsv:
        p.error("--cv_tsv required for commonvoice")
    return args


def stats_main(args) -> int:
    from audio_calm_torch.data.preprocess import compute_stats

    files = [os.path.join(dp, f)
             for dp, _, fs in os.walk(args.stats) for f in fs
             if f.endswith((".npz", ".npy", ".pt"))]
    mean, std = compute_stats(files, key_priority=(args.stats_key,),
                              per_dim=args.per_dim)
    print(f"files: {len(files)}")
    print(f"mean: {mean.tolist() if args.per_dim else float(mean)}")
    print(f"std:  {std.tolist() if args.per_dim else float(std)}")
    return 0


def make_vae_apply(vae_ckpt: str, device):
    """-> (mel [B, T, 80] -> latent means [B, T / stride, D], the VAE's
    total stride): the VAE of `vae_ckpt` (its vae_config.json sidecar gives
    the geometry) encoding the normalized log-mel."""
    from audio_calm_torch.models.vae import load_vae, normalize_mel

    vae = load_vae(vae_ckpt, device=device)

    def vae_apply(mel):
        mu, _ = vae.encode(normalize_mel(mel, vae.cfg))
        return mu

    return vae_apply, vae.cfg.total_stride


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.stats:
        return stats_main(args)

    from audio_calm_torch import resolve_device
    from audio_calm_torch.data.preprocess import (TEXT_RESOLVERS,
                                                  CorpusProcessor,
                                                  commonvoice_map,
                                                  scan_audio_files)

    device = resolve_device(args.device)
    vae_apply, total_stride = None, 4
    if args.vae_ckpt and not args.mel_only:
        vae_apply, total_stride = make_vae_apply(args.vae_ckpt, device)
    resolver, cv_map = None, None
    if args.dataset == "commonvoice":
        cv_map = commonvoice_map(args.cv_tsv)
    else:
        resolver = TEXT_RESOLVERS[args.dataset]

    files = scan_audio_files(args.input_dir)
    print(f"found {len(files)} audio files")
    if args.num_shards > 1:
        files = files[args.shard_id::args.num_shards]
        print(f"shard {args.shard_id}/{args.num_shards}: {len(files)} files")
    proc = CorpusProcessor(vae_apply=vae_apply, total_stride=total_stride,
                           batch_size=args.batch_size, device=device)

    def progress(n):
        if n % 100 == 0:
            print(f"  processed {n}/{len(files)}", flush=True)

    stats = proc.process_corpus(
        files, args.output_dir, args.input_dir, text_resolver=resolver,
        cv_text_map=cv_map, skip_existing=not args.no_skip_existing,
        progress=progress)
    print(f"done: {stats.processed} processed, {stats.skipped} skipped, "
          f"{stats.failed} failed")
    for f in stats.failures[:10]:
        print(f"  FAIL {f}", file=sys.stderr)
    return 0 if stats.failed == 0 else 2


if __name__ == "__main__":
    sys.exit(main())

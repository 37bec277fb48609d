"""One-shot ingest: write `.npz` sidecars for a reference `.pt` latent store
(counterpart of scripts/convert_store.py, single host).

The reference preprocessor stores one torch payload per utterance
(`{"latent": (D, T)}`), which has no cheap header, so the data pipeline
cannot read its frame counts without loading it (data/datasets.
array_frames returns None for `.pt`). This converter walks a store and
writes a canonical `.npz` (`{"latent"/"mel": (T, D) float32}`, the layout
data/preprocess.py emits) next to each `.pt`; data/datasets.scan_corpus
prefers `.npz` over `.pt`, so a converted store regains header-only
metadata with no config change. The layout is data/datasets.load_array's
(the (D, T) transpose decided exactly with --dim).

    python -m audio_calm_torch.data.convert_store \
        --root data/latents/train/LibriSpeech --dim 128

Resume-safe: a file with a readable sidecar is skipped (a truncated one is
rewritten); a sidecar is written to a temporary file and renamed, so a
killed run leaves no partial `.npz`. Corrupt `.pt` files are counted and
left alone. It prints one JSON line of counts; exit code 1 when a file
failed. Multi-host conversion waits for the port's parallel layer.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zipfile
from glob import glob

import numpy as np
import torch

from audio_calm_torch.data.datasets import _is_dt_layout


def convert_file(path: str, expected_dim=None, keys=("latent", "mel")):
    """-> (npz_path, key) or raises. Canonicalizes the layout to [T, D]."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    key = "latent"
    if isinstance(payload, dict):
        key = next((k for k in keys if k in payload), None)
        if key is None:
            raise ValueError(f"no {keys} key in {path}")
        payload = payload[key]
    arr = np.asarray(payload.float().numpy(), np.float32)
    if arr.ndim == 2 and _is_dt_layout(arr.shape, expected_dim):
        arr = arr.T
    out = path[: -len(".pt")] + ".npz"
    tmp = out + ".tmp"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **{key: arr})
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, key


def _sidecar_ok(path: str) -> bool:
    """A sidecar whose zip directory reads and lists an array."""
    try:
        with np.load(path, allow_pickle=False) as z:
            return len(z.files) > 0
    except (OSError, ValueError, zipfile.BadZipFile):
        return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True,
                   help="store root (searched recursively for *.pt)")
    p.add_argument("--dim", type=int, default=None,
                   help="the configured latent/mel channel dim: decides the "
                        "(D, T) or (T, D) layout exactly (without it the "
                        "channel-count heuristic applies)")
    p.add_argument("--delete-pt", action="store_true",
                   help="remove each .pt after a successful conversion")
    p.add_argument("--force", action="store_true",
                   help="overwrite existing .npz sidecars")
    args = p.parse_args(argv)

    files = sorted(glob(os.path.join(args.root, "**", "*.pt"),
                        recursive=True))
    done = skipped = failed = 0
    for f in files:
        out = f[: -len(".pt")] + ".npz"
        if os.path.exists(out) and not args.force:
            if _sidecar_ok(out):
                skipped += 1
                continue
            print(f"warning: {out}: corrupt sidecar, reconverting",
                  file=sys.stderr)
        try:
            convert_file(f, expected_dim=args.dim)
        except Exception as ex:  # a corrupt .pt: count it and go on
            print(f"warning: {f}: {ex}", file=sys.stderr)
            failed += 1
            continue
        done += 1
        if args.delete_pt:
            os.remove(f)
    print(json.dumps({"root": args.root, "converted": done,
                      "skipped": skipped, "failed": failed,
                      "total_pt": len(files)}))
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

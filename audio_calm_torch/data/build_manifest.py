"""Build a JSONL manifest over the latent / mel store (counterpart of
scripts/build_manifest.py): one `{id, audio, text}` line per item that
data/datasets.scan_corpus finds, in its order.

    python -m audio_calm_torch.data.build_manifest \\
        --latent_dir data/latents/dev/LibriSpeech --subsets dev-clean \\
        --out manifest.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

from audio_calm_torch.data.datasets import scan_corpus


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--latent_dir", required=True)
    p.add_argument("--subsets", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    items = scan_corpus(args.latent_dir, args.subsets, "any")
    with open(args.out, "w", encoding="utf-8") as f:
        for i, it in enumerate(items):
            f.write(json.dumps(
                {"id": i, "audio": it["file_path"], "text": it["text"]},
                ensure_ascii=False) + "\n")
    print(f"wrote {len(items)} entries to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

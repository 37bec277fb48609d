"""A synthetic latent corpus with realistic length distributions
(counterpart of scripts/make_synth_corpus.py: the same arguments, seeds and
files, so one --seed writes the same arrays and transcripts).

Writes a CalmDataset store, `<out>/<split>/<corpus>/<subset>/<chunk>/
<chunk>.trans.txt` plus one array file per utterance, so that the port's
training entry point (audio_calm_torch.train.train_calm) runs end to end
with no download:

    python -m audio_calm_torch.data.synth_corpus --out data/synth \\
        --asr-n 0 --tts-n 8000 --dev-n 64

Durations are lognormal (mean 12.8 s for ASR, LibriSpeech-like; 5.9 s for
TTS, LibriTTS-like); latents are normal noise at the flagship latent
statistics; transcripts are word salad sized so that the byte tokenizer's
prompt-token count grows as TOK0 + rate * duration. `--format pt` writes
the reference's torch payloads ({"latent": (D, T)}) instead of npz.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from audio_calm_torch.data.datasets import ASR_PROMPT, TTS_PROMPT_TEMPLATE
from audio_calm_torch.data.tokenizer import ByteTokenizer

# 384 latent frames = 24.576 s -> 15.625 frames/s
FPS = 384 / 24.576
MEAN_S = {"asr": 12.8, "tts": 5.9}
LAT_MEAN, LAT_STD = 0.039775, 1.190864  # the flagship latent statistics

WORDS = ("the quick brown fox jumps over lazy dog and runs far away with "
         "a small red hat on its head near old green trees by blue water "
         "under warm sun light while birds sing soft songs").split()


def synth_text(rng: np.random.Generator, n_bytes: int) -> str:
    """Word salad of about n_bytes UTF-8 bytes (at least one word)."""
    out = []
    total = 0
    while total < n_bytes:
        w = WORDS[int(rng.integers(0, len(WORDS)))]
        out.append(w)
        total += len(w) + 1
    return " ".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="data/synth")
    p.add_argument("--asr-n", type=int, default=8000)
    p.add_argument("--tts-n", type=int, default=8000)
    p.add_argument("--dev-n", type=int, default=64,
                   help="held-out items per task (eval_latent_dir)")
    p.add_argument("--latent-dim", type=int, default=128)
    p.add_argument("--sigma", type=float, default=0.6,
                   help="lognormal sigma of the durations")
    p.add_argument("--tok-rate", type=float, default=3.3,
                   help="text tokens per second of speech (bytes == tokens "
                        "under the byte tokenizer)")
    p.add_argument("--chunk", type=int, default=200,
                   help="utterances per directory / transcript chunk")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--format", choices=("npz", "pt"), default="npz")
    args = p.parse_args(argv)

    tok = ByteTokenizer()
    # the byte tokenizer's ChatML wrapper: prompt tokens of an empty text
    tts_tok0 = len(tok.encode(TTS_PROMPT_TEMPLATE.format("")))
    asr_prompt_len = len(tok.encode(ASR_PROMPT))
    corpus_of = {"asr": "LibriSpeech", "tts": "LibriTTS_R"}

    def write_split(task: str, split: str, n: int, seed: int):
        rng = np.random.default_rng(seed)
        mu = float(np.log(MEAN_S[task]) - 0.5 * args.sigma ** 2)
        dur = np.exp(rng.normal(mu, args.sigma, n))
        frames = np.clip(np.round(dur * FPS).astype(int), 8, 384)
        subset = "train-clean-100" if split == "train" else "dev-clean"
        root = os.path.join(args.out, split, corpus_of[task], subset)
        for c0 in range(0, n, args.chunk):
            chunk_id = c0 // args.chunk
            d = os.path.join(root, f"{chunk_id:04d}")
            os.makedirs(d, exist_ok=True)
            lines = []
            for i in range(c0, min(c0 + args.chunk, n)):
                fid = f"{task}-{split}-{i:06d}"
                n_fr = int(frames[i])
                text = synth_text(rng, max(
                    int(round(n_fr / FPS * args.tok_rate)), 4))
                lat = (rng.standard_normal((n_fr, args.latent_dim))
                       .astype(np.float32) * LAT_STD + LAT_MEAN)
                path = os.path.join(d, fid)
                if args.format == "pt":
                    import torch

                    # the reference's layout: (D, T) under "latent"
                    torch.save({"latent": torch.from_numpy(lat.T)},
                               path + ".pt")
                else:
                    np.savez(path + ".npz", latent=lat)
                lines.append(f"{fid} {text}")
            with open(os.path.join(d, f"{chunk_id:04d}.trans.txt"), "w",
                      encoding="utf-8") as fh:
                fh.write("\n".join(lines) + "\n")
        return frames

    stats = {}
    for task, n in (("asr", args.asr_n), ("tts", args.tts_n)):
        if n <= 0:
            continue
        # a fixed offset per task (str hashes vary between interpreters)
        fr = write_split(task, "train", n,
                         args.seed + {"asr": 0, "tts": 1}[task])
        if args.dev_n:
            write_split(task, "dev", args.dev_n, args.seed + 77)
        stats[task] = {"n": n, "mean_s": round(float(fr.mean() / FPS), 2),
                       "mean_frames": round(float(fr.mean()), 1)}

    print(json.dumps({
        "out": args.out, "format": args.format, "stats": stats,
        "byte_tok_model": {"tts_tok0": tts_tok0, "tok_rate": args.tok_rate,
                           "asr_prompt_len": asr_prompt_len},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

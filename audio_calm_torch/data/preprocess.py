"""Offline preprocessing: wav corpus -> mel / VAE-latent store (counterpart
of audio_calm_tpu/data/preprocess.py).

Files are grouped into length buckets (2/5/10/20/40 s) and go through the
log-mel frontend (ops/mel.MelFrontend), reflect-padded to the VAE's
stride, and optionally a VAE encode, one batch of a bucket at a time on
the device (the card unless the caller passes "cpu").

Output contract (the reference store): per utterance an `.npz` with "mel"
[T, 80] or "latent" [T', D], channels-last, under the input's relative
path, beside `<dir>.trans.txt` files of "<file_id> <text>" lines, merged
with what is already on disk so sharded jobs and resumed runs compose;
existing outputs are skipped.

Audio IO: Python's `wave` plus numpy for PCM WAV; `soundfile` for other
formats where it is installed.
"""

from __future__ import annotations

import csv
import os
import wave
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.config import MelConfig
from audio_calm_torch.data.datasets import load_array
from audio_calm_torch.models.vae import pad_to_stride
from audio_calm_torch.ops.mel import MelFrontend

AUDIO_EXTS = (".wav", ".flac", ".mp3")


# ---------------------------------------------------------------------------
# Audio IO
# ---------------------------------------------------------------------------
def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """-> (mono float32 [T], sample_rate). Peak normalization is separate."""
    if path.endswith(".wav"):
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            ch = w.getnchannels()
            raw = w.readframes(n)
        if width == 2:
            x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
        elif width == 1:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported WAV sample width {width}")
        if ch > 1:
            x = x.reshape(-1, ch).mean(axis=1)
        return x, sr
    try:
        import soundfile as sf
    except ImportError as e:
        raise RuntimeError(
            f"cannot read {path}: non-WAV formats need the optional "
            "`soundfile` package") from e
    x, sr = sf.read(path, dtype="float32", always_2d=True)
    return x.mean(axis=1), sr


def resample_linear(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Linear-interpolation resampler (adequate for 22k/24k/44.1k -> 16k
    speech)."""
    if sr == target_sr:
        return x
    n_out = int(round(len(x) * target_sr / sr))
    t = np.arange(n_out, dtype=np.float64) * (sr / target_sr)
    i0 = np.minimum(t.astype(np.int64), len(x) - 1)
    i1 = np.minimum(i0 + 1, len(x) - 1)
    frac = (t - i0).astype(np.float32)
    return x[i0] * (1 - frac) + x[i1] * frac


def peak_normalize(x: np.ndarray, peak: float = 0.95) -> np.ndarray:
    p = np.abs(x).max()
    return x / (p + 1e-8) * peak if p > 0 else x


# ---------------------------------------------------------------------------
# Transcript resolvers
# ---------------------------------------------------------------------------
def librispeech_text(audio_path: str) -> Optional[str]:
    """LibriSpeech: `<spk>-<chap>.trans.txt` next to the audio file."""
    folder = os.path.dirname(audio_path)
    fid = os.path.splitext(os.path.basename(audio_path))[0]
    parts = fid.split("-")
    if len(parts) < 3:
        return None
    trans = os.path.join(folder, f"{parts[0]}-{parts[1]}.trans.txt")
    if not os.path.exists(trans):
        return None
    with open(trans, encoding="utf-8") as f:
        for line in f:
            p = line.strip().split(" ", 1)
            if len(p) == 2 and p[0] == fid:
                return p[1]
    return None


def libritts_text(audio_path: str) -> Optional[str]:
    """LibriTTS: `<file_id>.normalized.txt` next to the audio file."""
    p = os.path.splitext(audio_path)[0] + ".normalized.txt"
    if os.path.exists(p):
        with open(p, encoding="utf-8") as f:
            return f.read().strip()
    return None


def commonvoice_map(tsv_path: str) -> Dict[str, str]:
    """CommonVoice: {clip_filename: sentence} from the split TSV."""
    out = {}
    with open(tsv_path, encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            if row.get("path") and row.get("sentence"):
                out[row["path"]] = row["sentence"]
    return out


TEXT_RESOLVERS: Dict[str, Callable[[str], Optional[str]]] = {
    "librispeech": librispeech_text,
    "libritts": libritts_text,
}


def scan_audio_files(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(AUDIO_EXTS):
                out.append(os.path.join(dirpath, f))
    return out


# ---------------------------------------------------------------------------
# Bucketed batch encoder
# ---------------------------------------------------------------------------
@dataclass
class PreprocessStats:
    processed: int = 0
    skipped: int = 0
    failed: int = 0
    failures: List[str] = field(default_factory=list)


class CorpusProcessor:
    """wav -> log-mel (and optionally -> VAE latent) batch pipeline.
    `vae_apply` maps a log-mel batch [B, T, 80] (T a multiple of
    total_stride) on the device to latents [B, T / total_stride, D]."""

    def __init__(
        self,
        mel_cfg: MelConfig = MelConfig(),
        vae_apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        total_stride: int = 4,
        buckets: Tuple[int, ...] = (2, 5, 10, 20, 40),  # seconds
        batch_size: int = 16,
        device=None,
    ):
        self.mel_cfg = mel_cfg
        self.device = resolve_device(device)
        self.frontend = MelFrontend(mel_cfg, device=self.device)
        self.vae_apply = vae_apply
        self.total_stride = total_stride
        self.bucket_samples = tuple(
            int(b * mel_cfg.sample_rate) for b in buckets)
        self.batch_size = batch_size

    @torch.no_grad()
    def _encode(self, wavs: np.ndarray) -> np.ndarray:
        mel = pad_to_stride(self.frontend(wavs), self.total_stride)
        if self.vae_apply is not None:
            mel = self.vae_apply(mel)
        return mel.float().cpu().numpy()

    def bucket_for(self, n: int) -> int:
        for b in self.bucket_samples:
            if n <= b:
                return b
        return self.bucket_samples[-1]

    def encode_batch(self, wavs: List[np.ndarray]) -> List[np.ndarray]:
        """Encode a list of equal-bucket wavs; returns per-file arrays
        trimmed to their true frame counts."""
        bucket = self.bucket_for(max(len(w) for w in wavs))
        hop = self.mel_cfg.hop_length
        batch = np.zeros((len(wavs), bucket), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : min(len(w), bucket)] = w[:bucket]
        out = self._encode(batch)
        results = []
        for w in wavs:
            n_frames = min(len(w), bucket) // hop + 1
            if self.vae_apply is not None:
                n_frames = -(-n_frames // self.total_stride)  # ceil
            results.append(out[len(results), :n_frames].astype(np.float32))
        return results

    def process_corpus(
        self,
        files: Iterable[str],
        out_root: str,
        in_root: str,
        text_resolver: Optional[Callable[[str], Optional[str]]] = None,
        cv_text_map: Optional[Dict[str, str]] = None,
        skip_existing: bool = True,
        progress: Optional[Callable[[int], None]] = None,
    ) -> PreprocessStats:
        """Process files into `<out_root>/<relpath>/<fid>.npz` + transcripts."""
        stats = PreprocessStats()
        transcripts: Dict[str, Dict[str, str]] = {}
        pending: Dict[int, List[Tuple[str, np.ndarray]]] = {}

        def flush(bucket: int):
            group = pending.pop(bucket, [])
            if not group:
                return
            arrays = self.encode_batch([w for _, w in group])
            key = "latent" if self.vae_apply is not None else "mel"
            for (out_path, _), arr in zip(group, arrays):
                os.makedirs(os.path.dirname(out_path), exist_ok=True)
                np.savez(out_path, **{key: arr})
                stats.processed += 1
                if progress:
                    progress(stats.processed)

        for path in files:
            rel = os.path.relpath(path, in_root)
            fid = os.path.splitext(os.path.basename(path))[0]
            out_dir = os.path.join(out_root, os.path.dirname(rel))
            out_path = os.path.join(out_dir, fid + ".npz")

            text = None
            if cv_text_map is not None:
                text = cv_text_map.get(os.path.basename(path))
            elif text_resolver is not None:
                text = text_resolver(path)
            if text:
                transcripts.setdefault(out_dir, {})[fid] = text

            if skip_existing and os.path.exists(out_path):
                stats.skipped += 1
                continue
            try:
                wav, sr = load_audio(path)
                wav = resample_linear(wav, sr, self.mel_cfg.sample_rate)
                wav = peak_normalize(wav)
            except Exception as e:  # a corrupt file: record and go on
                stats.failed += 1
                stats.failures.append(f"{path}: {e}")
                continue
            bucket = self.bucket_for(len(wav))
            pending.setdefault(bucket, []).append((out_path, wav))
            if len(pending[bucket]) >= self.batch_size:
                flush(bucket)

        for bucket in list(pending):
            flush(bucket)

        # transcripts, merged with the entries already on disk
        for out_dir, entries in transcripts.items():
            os.makedirs(out_dir, exist_ok=True)
            name = os.path.basename(out_dir.rstrip("/")) or "corpus"
            path = os.path.join(out_dir, f"{name}.trans.txt")
            merged: Dict[str, str] = {}
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        parts = line.rstrip("\n").split(" ", 1)
                        if len(parts) == 2:
                            merged[parts[0]] = parts[1]
            merged.update(entries)
            with open(path, "w", encoding="utf-8") as f:
                for fid, text in sorted(merged.items()):
                    f.write(f"{fid} {text}\n")
        return stats


# ---------------------------------------------------------------------------
# Corpus statistics
# ---------------------------------------------------------------------------
def compute_stats(
    files: Iterable[str], key_priority=("mel", "latent"), per_dim: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Streaming global (or per-dim) mean/std over stored arrays [T, D]."""
    s = None
    sq = None
    n = 0
    for path in files:
        arr = load_array(path, key_priority=key_priority).astype(np.float64)
        axis = 0 if per_dim else None
        if s is None:
            s = arr.sum(axis=axis)
            sq = (arr**2).sum(axis=axis)
        else:
            s += arr.sum(axis=axis)
            sq += (arr**2).sum(axis=axis)
        n += arr.shape[0] if per_dim else arr.size
    mean = s / n
    std = np.sqrt(np.maximum(sq / n - mean**2, 1e-12))
    return np.asarray(mean), np.asarray(std)

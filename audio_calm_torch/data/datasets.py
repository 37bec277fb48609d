"""Datasets over the offline latent and mel stores (counterpart of
audio_calm_tpu/data/datasets.py): `CalmDataset` for CALM training,
`MelDataset` (mel crops) for VAE training.

Storage contract (the reference's): per utterance one array file next to
`*.trans.txt` transcript files of "<file_id> <text>" lines. Read: the
reference's torch `.pt` files ({"latent": (D, T)} / {"mel": (D, T)}) and
the native `.npz` / `.npy` equivalents ({"latent"/"mel": (T, D)},
channels-last).

Prompts (the reference's train_calm.py):
  TTS: ChatML "Read this text:\\n{text}" prompt, labels all -100
  ASR: the fixed "Transcribe audio to text embedding." prompt,
       labels = tokenize(text + "<|im_end|>")
"""

from __future__ import annotations

import os
import zipfile
from dataclasses import dataclass
from glob import glob
from typing import Dict, List, Optional

import numpy as np

TTS_PROMPT_TEMPLATE = (
    "<|im_start|>user\nRead this text:\n{}\n<|im_end|>\n<|im_start|>assistant\n"
)
ASR_PROMPT = (
    "<|im_start|>user\nTranscribe audio to text embedding.<|im_end|>\n"
    "<|im_start|>assistant\n"
)
ARRAY_EXTS = (".npz", ".npy", ".pt")
#: channel counts the layout heuristic recognises (the reference's set:
#: the known latent / mel widths)
CHANNEL_DIMS = (64, 80, 128, 192)


def scan_corpus(root_dir: str, subsets: str, mode: str) -> List[Dict]:
    """`<root>/<subset>/**/*.trans.txt` -> [{text, file_path, mode}], in
    sorted transcript order; an id with no array file is skipped."""
    items: List[Dict] = []
    if not root_dir or not subsets:
        return items
    for subset in [s.strip() for s in subsets.split(",") if s.strip()]:
        pattern = os.path.join(root_dir, subset, "**", "*.trans.txt")
        for trans_file in sorted(glob(pattern, recursive=True)):
            folder = os.path.dirname(trans_file)
            with open(trans_file, encoding="utf-8") as fh:
                for line in fh:
                    parts = line.strip().split(" ", 1)
                    if len(parts) != 2:
                        continue
                    fid, txt = parts
                    for ext in ARRAY_EXTS:
                        p = os.path.join(folder, fid + ext)
                        if os.path.exists(p):
                            items.append(
                                {"text": txt, "file_path": p, "mode": mode})
                            break
    return items


def _npy_header_shape(f):
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, _, _ = np.lib.format.read_array_header_1_0(f)
    else:
        shape, _, _ = np.lib.format.read_array_header_2_0(f)
    return shape


def _is_dt_layout(shape, expected_dim: Optional[int]) -> bool:
    """True when a 2-D stored array is (D, T) and must be transposed to
    [T, D]. With expected_dim (the configured latent / mel width) the
    layout is decided exactly; without it, only when dim 0 is a known
    channel count and dim 1 is not (the reference transposes whenever dim 0
    is one, which misreads a [T, D] store whose frame count is 64, 80, 128
    or 192)."""
    d0, d1 = int(shape[0]), int(shape[1])
    if expected_dim is not None:
        return d0 == expected_dim and d1 != expected_dim
    return d0 in CHANNEL_DIMS and d1 not in CHANNEL_DIMS


def array_frames(path: str, key_priority=("latent", "mel"),
                 expected_dim: Optional[int] = None) -> Optional[int]:
    """The time length of a stored array from its npy header alone (for
    npz, the zip member's header: nothing is decompressed), equal to
    load_array(path).shape[0]. None for `.pt` (which needs a full load) and
    for unreadable files."""
    try:
        if path.endswith(".npy"):
            with open(path, "rb") as f:
                shape = _npy_header_shape(f)
        elif path.endswith(".npz"):
            with zipfile.ZipFile(path) as z:
                names = z.namelist()
                member = next(
                    (k + ".npy" for k in key_priority if k + ".npy" in names),
                    names[0] if names else None)
                if member is None:
                    return None
                with z.open(member) as f:
                    shape = _npy_header_shape(f)
        else:
            return None
    except Exception:
        return None
    if len(shape) == 2 and _is_dt_layout(shape, expected_dim):
        return int(shape[1])
    return int(shape[0]) if shape else None


def load_array(path: str, key_priority=("latent", "mel"),
               expected_dim: Optional[int] = None) -> np.ndarray:
    """A stored latent / mel as [T, D] float32 (`.pt`, `.npz` or `.npy`;
    the layout decided by _is_dt_layout)."""
    if path.endswith(".pt"):
        import torch

        payload = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(payload, dict):
            for k in key_priority:
                if k in payload:
                    payload = payload[k]
                    break
        arr = payload.float().numpy()
    elif path.endswith(".npz"):
        z = np.load(path)
        arr = None
        for k in key_priority:
            if k in z:
                arr = z[k]
                break
        if arr is None:
            arr = z[list(z.files)[0]]
    else:
        arr = np.load(path)
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2 and _is_dt_layout(arr.shape, expected_dim):
        arr = arr.T
    return arr


@dataclass
class CalmExample:
    input_ids: np.ndarray  # [T_txt]
    labels: np.ndarray  # [T_lab] (-100 = ignore)
    audio: np.ndarray  # [T_aud, D]
    mode: str


class CalmDataset:
    """Latent + transcript dataset for CALM training, items split per task
    so that batches are task-homogeneous."""

    def __init__(self, tokenizer, asr_latent_dir: Optional[str] = None,
                 asr_subsets: Optional[str] = None,
                 tts_latent_dir: Optional[str] = None,
                 tts_subsets: Optional[str] = None, max_text_len: int = 96,
                 max_audio_len: int = 384, task_mode: str = "mix",
                 max_samples: Optional[int] = None,
                 latent_dim: Optional[int] = None):
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.max_audio_len = max_audio_len
        self.task_mode = task_mode
        self.latent_dim = latent_dim  # decides the store layout exactly
        self.asr_items = (scan_corpus(asr_latent_dir, asr_subsets, "asr")
                          if task_mode in ("asr", "mix") else [])
        self.tts_items = (scan_corpus(tts_latent_dir, tts_subsets, "tts")
                          if task_mode in ("tts", "mix") else [])
        if max_samples:
            self.asr_items = self.asr_items[:max_samples]
            self.tts_items = self.tts_items[:max_samples]
        self.asr_prompt_ids = np.asarray(
            tokenizer.encode(ASR_PROMPT, add_special_tokens=False), np.int32)

    def __len__(self):
        return len(self.asr_items) + len(self.tts_items)

    def _tts_ids(self, text: str) -> List[int]:
        return self.tokenizer.encode(TTS_PROMPT_TEMPLATE.format(text),
                                     add_special_tokens=False
                                     )[: self.max_text_len]

    def meta(self, mode: str, idx: int) -> Optional[tuple]:
        """(LLM prompt tokens, capped latent frames) without loading the
        array (a header read; cached on the item). None when the store has
        no cheap header (.pt) or the header is unreadable."""
        items = self.tts_items if mode == "tts" else self.asr_items
        item = items[idx]
        if "meta" not in item:
            frames = array_frames(item["file_path"],
                                  expected_dim=self.latent_dim)
            if frames is None:
                item["meta"] = None
            else:
                n_tok = (len(self._tts_ids(item["text"])) if mode == "tts"
                         else len(self.asr_prompt_ids))
                item["meta"] = (n_tok, min(frames, self.max_audio_len))
        return item["meta"]

    def supports_meta(self, mode: str) -> bool:
        """True when the store supports header-only metadata (probes the
        first 8 items: one corrupt file does not disable it)."""
        items = self.tts_items if mode == "tts" else self.asr_items
        return any(self.meta(mode, i) is not None
                   for i in range(min(len(items), 8)))

    def get(self, mode: str, idx: int) -> Optional[CalmExample]:
        """One example, its audio capped at max_audio_len frames; None when
        the array does not load (the iterator skips it)."""
        items = self.tts_items if mode == "tts" else self.asr_items
        item = items[idx]
        try:
            audio = load_array(item["file_path"],
                               expected_dim=self.latent_dim)
        except Exception:
            return None
        audio = audio[: self.max_audio_len]
        if mode == "tts":
            ids = self._tts_ids(item["text"])
            labels = np.full((len(ids),), -100, np.int32)
        else:
            ids = self.asr_prompt_ids[: self.max_text_len]
            target = self.tokenizer.encode(
                f"{item['text']}<|im_end|>", add_special_tokens=False
            )[: self.max_text_len]
            labels = np.asarray(target, np.int32)
        return CalmExample(input_ids=np.asarray(ids, np.int32),
                           labels=labels, audio=audio, mode=mode)


class MelDataset:
    """Mel-crop dataset for VAE training (reference train_vae.py:27-107):
    every array file under `<data_dir>/<subset>/**`, per subset and
    extension in sorted glob order, the first `max_samples` kept."""

    def __init__(self, data_dir: str, subsets: str, crop_size: int = 256,
                 training: bool = True, max_samples: Optional[int] = None,
                 n_mels: int = 80):
        self.crop_size = crop_size
        self.training = training
        self.n_mels = n_mels  # decides the stored layout (_is_dt_layout)
        self.files: List[str] = []
        for subset in [s.strip() for s in subsets.split(",") if s.strip()]:
            for ext in ARRAY_EXTS:
                self.files.extend(sorted(glob(
                    os.path.join(data_dir, subset, "**", f"*{ext}"),
                    recursive=True)))
        if max_samples:
            self.files = self.files[:max_samples]

    def __len__(self):
        return len(self.files)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None
            ) -> np.ndarray:
        """-> [crop_size, n_mels] float32: a random crop from `rng` when
        training, else the centre crop; a short mel zero-padded."""
        mel = load_array(self.files[idx], key_priority=("mel", "latent"),
                         expected_dim=self.n_mels)
        T = mel.shape[0]
        cs = self.crop_size
        if T >= cs:
            if self.training and rng is not None:
                t0 = int(rng.integers(0, T - cs + 1))
            else:
                t0 = (T - cs) // 2
            return mel[t0: t0 + cs]
        out = np.zeros((cs, mel.shape[1]), np.float32)
        out[:T] = mel
        return out

"""WER / CER metrics (counterpart of audio_calm_tpu/eval/metrics.py).

Levenshtein edit distance over words (WER) and characters (CER), with the
reference's normalization: lowercase, punctuation stripped. Pure Python:
the JAX package's optional C extension (audio_calm_native) computes the
same distance, and the port does not import it.
"""

from __future__ import annotations

import re
from typing import List, Sequence


def normalize_text(text: str) -> str:
    text = text.lower()
    text = re.sub(r"[^\w\s']", "", text)
    return " ".join(text.split())


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with O(len(hyp)) memory."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def wer(references: List[str], predictions: List[str]) -> float:
    """Corpus-level word error rate."""
    errs, total = 0, 0
    for r, p in zip(references, predictions):
        rw, pw = r.split(), p.split()
        errs += edit_distance(rw, pw)
        total += len(rw)
    return errs / max(total, 1)


def cer(references: List[str], predictions: List[str]) -> float:
    """Corpus-level character error rate."""
    errs, total = 0, 0
    for r, p in zip(references, predictions):
        errs += edit_distance(list(r), list(p))
        total += len(r)
    return errs / max(total, 1)

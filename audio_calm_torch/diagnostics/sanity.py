"""Sanity-check invariants (counterpart of audio_calm_tpu/diagnostics/
sanity.py): the reference's three invariants plus the latent-store audit.

  1. VAE upper bound: decode ground-truth latents; if this is bad nothing
     downstream can work (diagnostics/sanity_checks.py writes the wavs).
  2. Flow learning: the eval-mode TTS flow loss against the analytic
     pred_v = 0 baseline of 2.0 (E||x1 - x0||^2 for unit Gaussians),
     verdict thresholds 0.5x / 0.9x.
  3. Length predictor accuracy: relative-error mean / p50 / p90.
  4. Latent store audit: NaN / Inf counts and global moments, with rescale
     advice when the std is outside [0.5, 2.0].

Everything but `check_flow_learning` is plain numpy. The flow check runs
the port's `forward_tts` in eval mode under no_grad; its noise comes from
an explicit torch.Generator or from injected `x0` arrays, never from the
global RNG.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from audio_calm_torch.data.datasets import load_array

FLOW_BASELINE = 2.0  # pred_v = 0 MSE for unit-Gaussian pairs


def flow_learning_verdict(loss: float) -> str:
    """The reference's thresholds (run_sanity_checks.py:261-269)."""
    if loss < 0.5 * FLOW_BASELINE:
        return "PASS"  # clearly learning
    if loss < 0.9 * FLOW_BASELINE:
        return "WARN"  # barely below the baseline
    return "FAIL"  # not learning


@dataclass
class LatentAudit:
    n_files: int
    n_nan: int
    n_inf: int
    mean: float
    std: float
    vmin: float
    vmax: float

    @property
    def verdict(self) -> str:
        if self.n_nan or self.n_inf:
            return "FAIL"
        if not (0.5 <= self.std <= 2.0):
            return "WARN"  # rescale advised (check_latents.py:113-121)
        return "PASS"

    @property
    def advice(self) -> Optional[str]:
        if self.verdict == "WARN":
            return (
                f"latent std {self.std:.3f} outside [0.5, 2.0]; set "
                f"latent_mean={self.mean:.6f} latent_std={self.std:.6f} in "
                "the model config"
            )
        return None


def audit_latents(files: Iterable[str], max_files: int = 200) -> LatentAudit:
    """NaN / Inf counts and the moments of the finite values over up to
    `max_files` stored latents (float64 sums)."""
    s = sq = 0.0
    n = n_nan = n_inf = count = 0
    vmin, vmax = np.inf, -np.inf
    for path in files:
        if count >= max_files:
            break
        arr = load_array(path).astype(np.float64)
        n_nan += int(np.isnan(arr).sum())
        n_inf += int(np.isinf(arr).sum())
        finite = arr[np.isfinite(arr)]
        if finite.size:
            s += finite.sum()
            sq += (finite ** 2).sum()
            n += finite.size
            vmin = min(vmin, float(finite.min()))
            vmax = max(vmax, float(finite.max()))
        count += 1
    mean = s / max(n, 1)
    std = float(np.sqrt(max(sq / max(n, 1) - mean ** 2, 0.0)))
    return LatentAudit(count, n_nan, n_inf, float(mean), std, vmin, vmax)


def stored_vs_fresh_encode(stored_latent: np.ndarray, fresh_mu: np.ndarray
                           ) -> Dict[str, object]:
    """check_pt.py's PASS / WARN / FAIL at L1 thresholds 0.1 / 0.5."""
    T = min(stored_latent.shape[0], fresh_mu.shape[0])
    l1 = float(np.mean(np.abs(stored_latent[:T] - fresh_mu[:T])))
    verdict = "PASS" if l1 < 0.1 else ("WARN" if l1 < 0.5 else "FAIL")
    return {"l1": l1, "verdict": verdict}


def predictor_error_stats(pred: np.ndarray, gt: np.ndarray
                          ) -> Dict[str, float]:
    """Relative-error mean / p50 / p90 (run_sanity_checks.py:105-183)."""
    rel = np.abs(pred - gt) / np.maximum(np.abs(gt), 1e-6)
    return {"mean": float(rel.mean()),
            "p50": float(np.percentile(rel, 50)),
            "p90": float(np.percentile(rel, 90))}


@torch.no_grad()
def check_flow_learning(model, batches: List[Dict[str, torch.Tensor]],
                        generator: Optional[torch.Generator] = None,
                        x0: Optional[Sequence] = None) -> Dict[str, object]:
    """The eval-mode TTS flow loss (`forward_tts`, train=False) averaged
    over `batches` (text_ids, attention_mask, latents, audio_mask on the
    model's device), with its verdict. Batch i draws its flow time and
    noise from `generator`, or takes them from x0[i] = (t [B], x0 [B, T,
    D]) when given (a test feeds JAX's draws this way)."""
    losses = []
    for i, b in enumerate(batches):
        kw = {}
        if x0 is not None:
            t, noise = x0[i]
            dev = b["latents"].device
            kw = {"t": torch.as_tensor(np.asarray(t), device=dev),
                  "x0": torch.as_tensor(np.asarray(noise), device=dev)}
        out = model.forward_tts(b["text_ids"], b["attention_mask"],
                                b["latents"], b["audio_mask"], train=False,
                                generator=generator, **kw)
        losses.append(float(out["loss_tts"]))
    loss = float(np.mean(losses))
    return {"loss_tts": loss, "baseline": FLOW_BASELINE,
            "verdict": flow_learning_verdict(loss)}

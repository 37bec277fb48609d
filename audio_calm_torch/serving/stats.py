"""Serving telemetry: request counts, coalesced-batch sizes, latency
(counterpart of audio_calm_tpu/serving/stats.py, copied: the JAX package's
serving package imports jax). Counters and bounded latency reservoirs under
one lock, exported as one JSON-able snapshot (the server's GET /stats).
"""

from __future__ import annotations

import threading
import time
from collections import Counter, defaultdict, deque
from typing import Dict, Optional


def _percentiles(samples, qs=(0.5, 0.95, 0.99)) -> Dict[str, float]:
    if not samples:
        return {}
    s = sorted(samples)
    out = {}
    for q in qs:
        i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        out[f"p{int(q * 100)}"] = s[i]
    out["mean"] = sum(s) / len(s)
    out["count"] = len(samples)
    return out


class ServingStats:
    """Thread-safe serving counters.

    record_request(kind, seconds): one client request completed (kind is
    a route label like "tts", "tts_stream", "asr"); errors counted
    separately via error=True. record_group(kind, batch_size, seconds):
    one coalesced device call of the batcher. Latency reservoirs keep the
    most recent `max_samples` observations (enough for stable p99 without
    unbounded memory)."""

    def __init__(self, max_samples: int = 4096):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._max = max_samples
        self._requests: Counter = Counter()
        self._errors: Counter = Counter()
        self._batches: Dict[str, Counter] = defaultdict(Counter)
        self._req_lat: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=max_samples))
        self._grp_lat: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=max_samples))

    def record_request(self, kind: str, seconds: float,
                       error: bool = False) -> None:
        with self._lock:
            if error:
                self._errors[kind] += 1
            else:
                self._requests[kind] += 1
                self._req_lat[kind].append(seconds)

    def record_latency(self, kind: str, seconds: float) -> None:
        """Latency-only observation (e.g. time-to-first-audio of a stream):
        feeds request_latency_s percentiles WITHOUT counting a request, so
        synthetic kinds never inflate the route counters."""
        with self._lock:
            self._req_lat[kind].append(seconds)

    def record_group(self, kind: str, batch_size: int,
                     seconds: float) -> None:
        with self._lock:
            self._batches[kind][int(batch_size)] += 1
            self._grp_lat[kind].append(seconds)

    def snapshot(self) -> Dict:
        """One JSON-able dict: uptime, per-route request/error counts and
        client-latency percentiles, per-task coalesced-batch-size
        histograms and device-call latency percentiles, plus the mean
        coalesced batch size (the "is batching working" number)."""
        with self._lock:
            batches = {}
            for kind, hist in self._batches.items():
                total = sum(hist.values())
                items = sum(size * n for size, n in hist.items())
                batches[kind] = {
                    "sizes": {str(k): v for k, v in sorted(hist.items())},
                    "calls": total,
                    "mean_batch": items / total if total else 0.0,
                    "latency_s": _percentiles(self._grp_lat[kind]),
                }
            return {
                "uptime_s": time.monotonic() - self._t0,
                "requests": dict(self._requests),
                "errors": dict(self._errors),
                "request_latency_s": {
                    k: _percentiles(v) for k, v in self._req_lat.items()
                },
                "batches": batches,
            }

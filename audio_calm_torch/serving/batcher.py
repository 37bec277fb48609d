"""Dynamic request batching for serving (counterpart of
audio_calm_tpu/serving/batcher.py, copied: the JAX package's serving
package imports jax).

`submit(group_key, item)` returns a concurrent Future. One worker thread
takes the oldest queued item, holds the batch open for `window_ms` (or
until `max_batch` items of the same key arrived), calls
`run_batch(group_key, items)` and resolves every Future. Items of another
group key stay queued for the next cycle, so different settings serialize
instead of mixing. An error fails the Futures of its own group only.

Priority lane: `submit(..., priority=True)` marks latency-critical work (a
stream's first chunk). Priority items preempt the bulk queue, skip the
coalescing window and cap their batch at `priority_max_batch` (default
min(4, max_batch)). As in the JAX package, a steady stream of priority
items can hold bulk groups back (the lane is served first whenever it is
non-empty).

The worker thread calls run_batch; whatever thread-local state the device
work needs (torch's grad mode) is run_batch's to set.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, List, Tuple


class RequestBatcher:
    """Coalesce concurrent submit() calls into run_batch() groups.

    run_batch(group_key, items) -> list of per-item results (must be the
    same length as items; anything else fails the whole group).
    window_ms=0 disables coalescing-by-waiting (each cycle takes whatever
    is already queued); max_batch=1 degenerates to a serialized queue.
    """

    def __init__(self, run_batch: Callable[[Any, List[Any]], List[Any]],
                 max_batch: int = 8, window_ms: float = 10.0,
                 priority_max_batch: int = 0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._run = run_batch
        self.max_batch = max_batch
        # priority lane cap (time-to-first-audio work): first-audio items
        # must never ride a near-full bulk batch. 0 -> min(4, max_batch).
        self.priority_max_batch = (
            priority_max_batch if priority_max_batch >= 1
            else max(1, min(4, max_batch))
        )
        self.window = max(0.0, window_ms) / 1000.0
        self._dq: deque = deque()  # (key, item, future)
        self._pq: deque = deque()  # priority lane (same tuples)
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="request-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, group_key: Any, item: Any,
               priority: bool = False) -> Future:
        """priority=True routes through the latency lane: the next worker
        cycle serves priority items FIRST, with no coalescing window and a
        small batch cap, so time-to-first-result stays one small device
        call even under bulk backlog. Use for a stream's first chunk;
        throughput work keeps the default lane."""
        f: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            (self._pq if priority else self._dq).append((group_key, item, f))
            self._cv.notify_all()
        return f

    def _take_group(self):
        """Block until an item exists. Priority items preempt: they pop
        immediately (no window, capped at priority_max_batch, same-key
        only). Otherwise hold the window open for more of the SAME key,
        then pop that group (FIFO across keys)."""
        with self._cv:
            while not self._dq and not self._pq and not self._closed:
                self._cv.wait()
            if not self._dq and not self._pq:
                return None  # closed and drained
            if self._pq:
                return self._pop_priority()
            key = self._dq[0][0]
            deadline = time.monotonic() + self.window
            while True:
                n_same = sum(1 for k, _, _ in self._dq if k == key)
                if n_same >= self.max_batch or self._closed:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
                if self._pq:
                    # a priority item arrived mid-window: serve it now,
                    # the bulk group stays queued for the next cycle
                    return self._pop_priority()
            group: List[Tuple[Any, Future]] = []
            rest: deque = deque()
            for k, item, f in self._dq:
                if k == key and len(group) < self.max_batch:
                    group.append((item, f))
                else:
                    rest.append((k, item, f))
            self._dq = rest
        return key, group

    def _pop_priority(self):
        """Pop a same-key group from the priority lane (cv held)."""
        key = self._pq[0][0]
        group: List[Tuple[Any, Future]] = []
        rest: deque = deque()
        for k, item, f in self._pq:
            if k == key and len(group) < self.priority_max_batch:
                group.append((item, f))
            else:
                rest.append((k, item, f))
        self._pq = rest
        return key, group

    def _loop(self):
        while True:
            got = self._take_group()
            if got is None:
                return
            key, group = got
            try:
                results = self._run(key, [item for item, _ in group])
                if len(results) != len(group):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results "
                        f"for {len(group)} items"
                    )
            except Exception as ex:  # fan the failure out to the group
                for _, f in group:
                    if not f.cancelled():
                        f.set_exception(ex)
                continue
            for (_, f), r in zip(group, results):
                if not f.cancelled():
                    f.set_result(r)

    def close(self, timeout: float = 30.0):
        """Stop accepting work, drain what is queued, join the worker."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

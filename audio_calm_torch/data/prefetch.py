"""Background-thread batch prefetching (counterpart of
audio_calm_tpu/data/prefetch.py): one daemon thread keeps a small queue of
ready batches, so that host-side loading (file reads, packing, padding)
overlaps the device's steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch(iterable: Iterable, buffer_size: int = 4) -> Iterator:
    """Yield the items of `iterable` in order, produced by a background
    thread; an exception the producer raises is raised to the consumer
    after the items produced before it. When the consumer stops early (the
    generator is closed or dropped), the thread ends after the item it is
    making."""
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # hand producer errors to the consumer
            err.append(e)
        put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()

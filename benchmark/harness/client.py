"""The load: an asyncio HTTP/1.1 client on one thread, one connection a
request, driving the closed and the open loop over a fixed window.

Each request records when it was due (the open loop's schedule; the send
time in the closed loop), sent, answered in full, its status and body. A
request that is still open `drain_s` after the window closes is failed.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from benchmark.harness.traffic import Request

# the closed loop cycles its texts; each pass gets fresh request seeds
SEED_STRIDE = 0x9E3779B97F4A7C15


@dataclass
class Sent:
    req: Request
    due: float  # perf_counter seconds
    sent: float = 0.0
    done: float = 0.0
    status: int = 0
    body: bytes = b""
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.status == 200 and not self.error

    def audio_s(self, sample_rate: int = 16000) -> float:
        """Seconds of 16-bit mono audio in a WAV reply."""
        return max(len(self.body) - 44, 0) / 2.0 / sample_rate


async def post(port: int, path: str, payload: dict, rec: Sent) -> None:
    body = json.dumps(payload).encode()
    rec.sent = time.perf_counter()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(
            f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            f"Content-Type: application/json\r\nContent-Length: {len(body)}"
            f"\r\nConnection: close\r\n\r\n".encode() + body)
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        rec.status = int(lines[0].split()[1])
        length = 0
        for line in lines[1:]:
            k, _, v = line.partition(":")
            if k.strip().lower() == "content-length":
                length = int(v)
        rec.body = await reader.readexactly(length)
        rec.done = time.perf_counter()
        writer.close()
    except (OSError, asyncio.IncompleteReadError, ValueError,
            IndexError) as ex:
        rec.error = repr(ex)
        rec.done = time.perf_counter()


def payload(req: Request, seed: int) -> dict:
    return {"text": req.text, "seed": seed}


async def _closed(port, path, pool: List[Request], clients: int,
                  t0: float, seconds: float, out: List[Sent]) -> None:
    counter = iter(range(1 << 60))
    t_end = t0 + seconds

    async def client():
        while time.perf_counter() < t_end:
            i = next(counter)
            req = pool[i % len(pool)]
            seed = (req.seed + (i // len(pool)) * SEED_STRIDE) % (1 << 62)
            rec = Sent(Request(i, req.text, seed), due=time.perf_counter())
            out.append(rec)
            await post(port, path, payload(req, seed), rec)

    await asyncio.gather(*(client() for _ in range(clients)))


async def _open(port, path, schedule: List[Request], t0: float,
                out: List[Sent]) -> None:
    tasks = []
    for req in schedule:
        due = t0 + req.due
        delay = due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        rec = Sent(req, due=due)
        out.append(rec)
        tasks.append(asyncio.ensure_future(
            post(port, path, payload(req, req.seed), rec)))
    await asyncio.gather(*tasks)


def drive(port: int, mix: dict, reqs: List[Request], t0: float,
          seconds: float, drain_s: float) -> List[Sent]:
    """Run the mix's loop from perf_counter time t0 for `seconds`, then
    wait up to drain_s for what is still open -> one Sent a request."""
    out: List[Sent] = []

    async def main():
        if mix["loop"] == "open":
            work = _open(port, mix["endpoint"], reqs, t0, out)
        else:
            work = _closed(port, mix["endpoint"], reqs, int(mix["clients"]),
                           t0, seconds, out)
        task = asyncio.ensure_future(work)
        left = t0 + seconds + drain_s - time.perf_counter()
        done, _ = await asyncio.wait([task], timeout=max(left, 0.0))
        if not done:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        else:
            task.result()

    delay = t0 - time.perf_counter()
    if delay > 0:
        time.sleep(delay)
    asyncio.run(main())
    for rec in out:
        if not rec.done:
            rec.error = rec.error or "unfinished at the drain cap"
    return out


def drive_in_thread(*args) -> Tuple[threading.Thread, List[Sent]]:
    """drive() on a thread of its own -> (the thread, its list, filled
    when the thread has ended)."""
    box: List[List[Sent]] = []
    t = threading.Thread(target=lambda: box.append(drive(*args)),
                         name="load", daemon=True)
    t.start()
    return t, box


def percentile(values: List[float], q: float) -> Optional[float]:
    """The nearest-rank q-quantile (q in [0, 1]) of the values."""
    if not values:
        return None
    xs = sorted(values)
    i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[i]

"""The one generator of request traffic: a mix is a JSON file of
parameters (benchmark/traffic/<mix>.json) and this reads it.

Every seed gets the same work in another order: the text lengths are fixed
quantiles of the mix's length distribution, which the seed shuffles, and
the seed draws the letters and the request seeds. The open loop's arrivals
are one fixed schedule for every seed: the quantiles of the exponential
in one order drawn from the mix's `arrival_seed`, so that a seed moves
texts between arrivals and not the bursts of the schedule. The words of a
text follow one fixed pattern of lengths, so where a long text splits into
prompt-budget chunks depends on its length alone.

Keys of a mix:
  endpoint     "/tts"
  loop         "closed" (clients that each wait for their reply) or
               "open" (arrivals on a schedule, whatever the replies)
  clients      closed loop: the number of clients
  rate_per_s   open loop: the mean arrival rate (Poisson: exponential gaps)
  arrival_seed open loop: the order of the gaps
  text_chars   {"median", "sigma", "min", "max"}: a lognormal length in
               characters, clipped
  pool         closed loop: texts in the cycle the clients draw from
  server       {"max_batch", "batch_window_ms"}: the server's settings
  drain_s      how long after the window a reply may still come
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import List

import numpy as np

WORD_LENGTHS = (4, 6, 3, 7, 5, 2, 8, 4, 5, 6, 3, 9)
LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


@dataclass
class Request:
    index: int
    text: str
    seed: int
    due: float = 0.0  # seconds after the window opens (open loop)


def text_lengths(mix: dict, n: int) -> List[int]:
    """n lengths at the quantiles (i + 1/2) / n of the mix's lognormal,
    clipped and rounded."""
    c = mix["text_chars"]
    nd = statistics.NormalDist(math.log(c["median"]), c["sigma"])
    out = []
    for i in range(n):
        x = math.exp(nd.inv_cdf((i + 0.5) / n))
        out.append(int(round(min(max(x, c["min"]), c["max"]))))
    return out


def make_text(n_chars: int, rng: np.random.Generator) -> str:
    """n_chars characters: words of the fixed length pattern, separated by
    spaces, ending in a period; the letters drawn from rng."""
    pieces, k = [], 0
    while sum(len(p) + 1 for p in pieces) < n_chars:
        pieces.append("".join(rng.choice(LETTERS, WORD_LENGTHS[k % len(
            WORD_LENGTHS)])))
        k += 1
    body = " ".join(pieces)[: n_chars - 1]
    if body.endswith(" "):
        body = body[:-1] + str(rng.choice(LETTERS))
    return body + "."


def requests(mix: dict, seed: int, seconds: float) -> List[Request]:
    """The closed loop's cycle of texts, or the open loop's schedule of
    arrivals due in [0, seconds)."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    if mix["loop"] == "open":
        rate = float(mix["rate_per_s"])
        n = max(1, int(round(rate * seconds)))
        gaps = np.array([-math.log(1.0 - (i + 0.5) / n) / rate
                         for i in range(n)])
        np.random.default_rng(int(mix["arrival_seed"])).shuffle(gaps)
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    else:
        n = int(mix["pool"])
        due = np.zeros(n)
    lengths = np.array(text_lengths(mix, n))
    rng.shuffle(lengths)
    seeds = rng.integers(0, 1 << 62, size=n)
    out = [Request(i, make_text(int(lengths[i]), rng), int(seeds[i]),
                   float(due[i])) for i in range(n)]
    return [r for r in out if r.due < seconds] if mix["loop"] == "open" \
        else out

"""Dropout whose mask is fixed by an integer seed.

Training recomputes each checkpointed Qwen2 block in the backward
(`torch.utils.checkpoint`), and the recomputation must draw the same masks
as the forward. `torch.utils.checkpoint` restores the global RNG, not an
explicit generator, so every dropout site here draws its mask from a fresh
generator seeded by `derive_seed(seed, site)`: `seed` is fixed per (step,
microbatch slice) by the train step and `site` is the module's own index in
the model (`assign_dropout_sites`). Same seed, same masks, however often a
block runs.

Data parallelism (train/steps.py with a process group): each process runs
its share of a batch's rows, and every draw over a batch-major tensor must
give those rows the numbers the one-process run gives them. Inside
`row_shard(rank, world)`, `draw` makes the draw at the global leading size
(world x the local one) and keeps this process's rows, so a rank's masks
and noise are the rows of the one-process draw. The state is one module
global, not a thread-local: autograd recomputes checkpointed blocks on its
own device thread, and the recomputation must draw the same rows.

Tensor parallelism (parallel/tp_shard.py): a row-split projection (o_proj,
down_proj) on shard j of n sees columns [j m, (j + 1) m) of its input, and
its LoRA dropout mask must be those columns of the one-device mask. `draw`
and `dropout` take `cols=(j, n)`: the draw is made at n x the last size
and shard j's columns are kept. The share is an argument of the shard's
own call, so a checkpointed block's recomputation, which runs the shard's
forward again on whatever thread autograd picks, draws the same columns.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence, Tuple

import torch
from torch import nn

_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer: a well-spread 64-bit hash of x."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def derive_seed(*parts: int) -> int:
    """A 63-bit seed from a sequence of integers (seed, step, slice, ...)."""
    h = 0
    for p in parts:
        h = _mix(h ^ (int(p) & _M64))
    return h & ((1 << 63) - 1)


_ROWS = (0, 1)  # (rank, world) of the batch-major draws


@contextlib.contextmanager
def row_shard(rank: int, world: int):
    """Within the block, `draw` keeps rows [rank n, (rank + 1) n) of a draw
    made for world x n rows."""
    global _ROWS
    saved = _ROWS
    _ROWS = (int(rank), int(world))
    try:
        yield
    finally:
        _ROWS = saved


def draw(fn: Callable, shape: Sequence[int], cols: Tuple[int, int] = (0, 1),
         **kw) -> torch.Tensor:
    """fn(shape, **kw) (torch.rand / torch.randn with a generator) for this
    process's rows: under row_shard(rank, world) the draw is made for the
    global leading size and this rank's rows of it are returned. cols (j,
    n): the draw is made for n x the last size and columns [j m, (j + 1) m)
    of it are returned (m the last size of `shape`)."""
    rank, world = _ROWS
    j, n = cols
    shape = list(shape)
    if world == 1 and n == 1:
        return fn(tuple(shape), **kw)
    rows, m = shape[0], shape[-1]
    shape[0] *= world
    shape[-1] *= n
    return fn(tuple(shape), **kw).narrow(0, rank * rows, rows).narrow(
        -1, j * m, m)


def dropout(x: torch.Tensor, rate: float, seed: int,
            cols: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """flax nn.Dropout semantics: keep with probability 1 - rate, scale the
    kept values by 1 / (1 - rate); the mask comes from `seed` alone (with
    `cols`, shard j of n's columns of the mask of the whole width)."""
    if rate <= 0.0:
        return x
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    keep = draw(torch.rand, x.shape, cols, generator=g,
                device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def assign_dropout_sites(model: nn.Module) -> int:
    """Number every module with a `dropout_site` attribute in module order
    -> the number of sites."""
    n = 0
    for m in model.modules():
        if hasattr(m, "dropout_site"):
            m.dropout_site = n
            n += 1
    return n

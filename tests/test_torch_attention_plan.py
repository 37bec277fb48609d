"""The bf16 attention kernel's plan (audio_calm_torch.ops.attention_kernel:
attention_plan and the grid, rows and key walk it gives the kernel), and the
plain forward past the TPU's 512 gate against JAX's fused_attention /
fused_attention_batched in interpret mode, on the CPU.

The plan is all of the kernel's tiling that a CPU can hold: which blocks
exist, which rows each takes and which key tiles it walks. Bound for the
plain forward: 2e-5, the JAX package's own (tests/test_pallas_attention.py).
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.ops.attention_kernel import (attention_fwd_plain,
                                                   attention_plan,
                                                   candidate_plans,
                                                   plan_blocks,
                                                   plan_key_tiles, plan_rows)
from audio_calm_tpu.ops.pallas_attention import (fused_attention,
                                                 fused_attention_batched)

TOL = 2e-5

# (T, S, Hq, Hkv, d, causal): the shapes the shipped configs launch (the
# flagship's, calm.yaml's TTS head and Qwen2 text buckets, asr.yaml's
# request), and two past the old 512 gate
SERVED = [
    (25, 25, 12, 2, 128, True),
    (384, 384, 16, 16, 64, False),
    (384, 24, 16, 16, 64, False),
    (96, 96, 16, 16, 48, False),
    (192, 192, 16, 16, 48, False),
    (384, 384, 16, 16, 48, False),
    (384, 64, 16, 16, 48, False),
    (33, 33, 12, 2, 128, True),
    (65, 65, 12, 2, 128, True),
    (97, 97, 12, 2, 128, True),
    (461, 461, 12, 2, 128, True),
    (96, 384, 16, 16, 96, False),
    (1024, 1024, 12, 2, 128, True),
    (2048, 2048, 12, 2, 128, True),
]
ODD = [(70, 130, 8, 4, 96, True), (130, 70, 8, 4, 48, True),
       (5, 9, 4, 1, 32, False), (100, 300, 6, 2, 32, True)]


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _qkv(seed, B, T, S, Hq, Hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d))]


@pytest.mark.parametrize("B,T,S,Hq,Hkv,d,jax_fn", [
    (1, 640, 640, 4, 2, 32, fused_attention),  # T = S past the gate
    (2, 96, 640, 4, 2, 32, fused_attention_batched),  # offset S - T = 544
])
def test_plain_matches_fused_attention_past_512(B, T, S, Hq, Hkv, d, jax_fn):
    q, k, v = _qkv(7, B, T, S, Hq, Hkv, d)
    valid = np.ones((B, S), bool)
    valid[-1, S // 2: S // 2 + 40] = False  # mid-sequence pad
    ref = np.asarray(jax_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            key_valid=jnp.asarray(valid.astype(np.int32)),
                            causal=True, interpret=True))
    out = attention_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                              torch.from_numpy(valid), True).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_plan_takes_no_batch():
    assert list(inspect.signature(attention_plan).parameters) == [
        "T", "S", "Hq", "Hkv", "d", "causal"]


@pytest.mark.parametrize("shape", SERVED)
def test_plan_is_the_same_for_every_batch(shape):
    """Row b's blocks take the same tiles, rows and key walk whatever B:
    so a batch row's output equals the row launched alone."""
    T, S, Hq, Hkv, d, causal = shape
    plan = attention_plan(*shape)
    rng = np.random.default_rng(0)
    valid = rng.random(S) < 0.9
    work = []
    for B in (1, 2, 4, 8):
        row0 = sorted((tile, grp, tuple(plan_rows(plan, T, tile, grp)),
                       plan_key_tiles(plan, T, S, tile, causal, valid))
                      for tile, grp, b in plan_blocks(plan, Hq, B) if b == 0)
        work.append(row0)
    assert all(w == work[0] for w in work)


@pytest.mark.parametrize("shape", SERVED + ODD)
def test_plan_tiles_cover_every_row_once(shape):
    """Every plan the kernel takes: each (batch row, position, q head) is
    in exactly one block's tile, and a tile holds at most 64 rows."""
    T, S, Hq, Hkv, d, causal = shape
    B = 3
    for plan in candidate_plans(*shape) + [attention_plan(*shape)]:
        blocks = plan_blocks(plan, Hq, B)
        assert len(set(blocks)) == len(blocks)
        seen = []
        for tile, grp, b in blocks:
            rows = plan_rows(plan, T, tile, grp)
            assert len(rows) <= 64
            seen += [(b, t, h) for t, h in rows]
        assert sorted(seen) == [(b, t, h) for b in range(B)
                                for t in range(T) for h in range(Hq)]


@pytest.mark.parametrize("shape", SERVED + ODD)
@pytest.mark.parametrize("mask", ["all", "ragged", "late_first_key"])
def test_plan_skips_no_attended_key_tile(shape, mask):
    """A block walks every key tile any of its rows attends; a tile with a
    row that attends no valid key walks all of them (the reference's
    uniform average over every key)."""
    T, S, Hq, Hkv, d, causal = shape
    rng = np.random.default_rng(1)
    valid = np.ones(S, bool)
    if mask == "ragged":
        valid &= rng.random(S) < 0.8
    elif mask == "late_first_key":
        valid[:min(S - 1, 70)] = False
    # the last valid key at or before each index (-1: none)
    last = np.maximum.accumulate(np.where(valid, np.arange(S), -1))
    for plan in candidate_plans(*shape):
        for tile in range(plan.tiles):
            walk = plan_key_tiles(plan, T, S, tile, causal, valid)
            assert 1 <= walk <= math.ceil(S / 64)
            for t, _ in plan_rows(plan, T, tile, 0):
                reach = min(S - 1, t + S - T) if causal else S - 1
                seen = last[reach] if reach >= 0 else -1
                if seen < 0:  # a fully masked row averages all S keys
                    assert walk == math.ceil(S / 64)
                else:
                    assert seen // 64 < walk


def test_plan_packs_only_causal_gqa():
    for shape in SERVED:
        plan = attention_plan(*shape)
        T, S, Hq, Hkv, d, causal = shape
        assert plan.group in (1, Hq // Hkv)
        assert plan.group == 1 or (causal and Hq > Hkv)
        assert plan.consumers in (1, 2)

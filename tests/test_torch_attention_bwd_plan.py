"""The bf16 attention backward's plan (audio_calm_torch.ops.attention_kernel:
attention_bwd_plan, candidate_bwd_plans, attention_bwd_plan_items,
bwd_first_query_tile), and a plain emulation of the dK/dV split against
JAX `flash_attention`'s gradients (its backward is the Pallas
`_flash_bwd_kernel`, run in interpret mode), on the CPU.

The plan is all of csrc/attention_bwd.cu's work division that a CPU can
hold: how many blocks share a key tile's (query head, query tile) items,
which items each takes, and the order their fp32 partials are added in.
The emulation sums dK and dV the way dkv_kernel and dkv_reduce_kernel do (each
split's partial over its items, the partials added in split order) and is
held against JAX at 2e-4 (fp32, the JAX package's tolerance for these
gradients) and, with P and dS rounded to bf16 as product operands,
against the fp32 plain backward within 2^-7 of the largest gradient (the
card's bf16 bound)."""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.ops.attention_kernel import (_BWD_MIN_ITEMS, BwdPlan,
                                                   attention_bwd_plain,
                                                   attention_bwd_plan,
                                                   attention_bwd_plan_items,
                                                   attention_fwd_plain,
                                                   bwd_first_query_tile,
                                                   bwd_partial_bytes,
                                                   candidate_bwd_plans)
from audio_calm_torch.tools.attention_bwd_probe import ROWS
from audio_calm_tpu.ops.pallas_attention import flash_attention

TOL = 2e-4
SMS = 132  # an H100's SMs
SMALL = [(2, 16, 16, 4, 2, 32, True), (1, 70, 130, 6, 1, 64, True),
         (2, 40, 40, 6, 1, 48, False), (2, 5, 9, 4, 1, 32, False),
         (1, 130, 70, 8, 4, 96, True)]


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_bwd_plan_reads_shapes_only():
    """The plan takes integers and a flag (the shape, causality and the
    card's SM count), nothing of the data, and gives one answer a shape."""
    params = list(inspect.signature(attention_bwd_plan).parameters)
    assert params == ["B", "T", "S", "Hq", "Hkv", "d", "causal", "sms"]
    for row in ROWS:
        assert attention_bwd_plan(*row[1:8]) == attention_bwd_plan(
            *row[1:8], SMS)


@pytest.mark.parametrize("shape", [r[1:8] for r in ROWS] + SMALL,
                         ids=[r[0] for r in ROWS] + [str(s) for s in SMALL])
def test_bwd_plan_items_land_in_one_split(shape):
    """Under every plan the kernel takes at a shape, and from every first
    query tile causal skipping can give, each (query head, query tile) item
    of a key tile lands in exactly one split, the splits contiguous ranges
    in head-major order (the order their partials are added in)."""
    B, T, S, Hq, Hkv, d, causal = shape
    G = Hq // Hkv
    for plan in candidate_bwd_plans(*shape) + [attention_bwd_plan(*shape)]:
        for t_lo in range(plan.query_tiles):
            splits = attention_bwd_plan_items(plan, Hq, Hkv, t_lo)
            assert len(splits) == plan.splits
            flat = [item for part in splits for item in part]
            want = [(g, t) for g in range(G)
                    for t in range(t_lo, plan.query_tiles)]
            assert flat == want, (plan, t_lo)
            sizes = [len(part) for part in splits]
            assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_bwd_plan_fills_the_card(row):
    """At the training rows the dK/dV launch gives every SM a block where
    the shape has that much work: blocks of at least _BWD_MIN_ITEMS items
    each (fewer cost more in fixed work than they save), and the dQ and
    statistics launches one block per (query tile, head, batch row)."""
    B, T, S, Hq, Hkv, d, causal = row[1:8]
    plan = attention_bwd_plan(B, T, S, Hq, Hkv, d, causal, SMS)
    items = Hq // Hkv * plan.query_tiles
    blocks = plan.key_tiles * Hkv * B * plan.splits
    assert 1 <= plan.splits <= max(1, items // _BWD_MIN_ITEMS)
    assert blocks >= SMS or plan.splits == items // _BWD_MIN_ITEMS
    assert plan.query_tiles * Hq * B >= SMS
    assert bwd_partial_bytes(plan, B, S, Hkv, d) == (
        0 if plan.splits == 1 else plan.splits * 2 * B * S * Hkv * d * 4)


def test_bwd_plans_at_the_training_rows():
    """The plans chosen on the card (PERF.md section 6): the Qwen2 slice
    and the causal rows split their few key tiles, the DiT and ASR-head
    rows fill the card unsplit."""
    plans = {r[0]: attention_bwd_plan(*r[1:8], SMS).splits for r in ROWS}
    assert plans == {"Qwen2 training slice": 2,
                     "Qwen2 TP-shard training slice": 2,
                     "Qwen2 plain-ASR training slice": 6,
                     "DiT self training slice": 1,
                     "DiT self distillation student": 1,
                     "DiT cross distillation student": 1,
                     "ASR head self distillation student": 1,
                     "causal past 512": 6}


def test_bwd_plan_splits_at_one_kv_head():
    """A tensor-parallel shard's Qwen2 heads (6 q / 1 kv at tp 2): half the
    dK/dV blocks of the one-device row, so the plan splits them, bounded
    by _BWD_MIN_ITEMS: 2 at the 16-row slice (12 items a key tile), 8 at
    a 461-position row (48 items)."""
    tts = attention_bwd_plan(16, 97, 97, 6, 1, 128, True, SMS)
    asr = attention_bwd_plan(2, 461, 461, 6, 1, 128, True, SMS)
    assert (tts.key_tiles, tts.query_tiles, tts.splits) == (2, 2, 2)
    assert (asr.key_tiles, asr.query_tiles, asr.splits) == (8, 8, 8)
    for plan in (tts, asr):
        items = 6 * plan.query_tiles
        assert plan.splits == items // _BWD_MIN_ITEMS
        assert [len(p) for p in attention_bwd_plan_items(plan, 6, 1)] == \
            [_BWD_MIN_ITEMS] * plan.splits


@pytest.mark.parametrize("T,S,causal,valid0,want", [
    (70, 130, True, True, [0, 0, 1]),  # shift 60: key 128 from row 68 on
    (130, 70, True, True, [0, 0]),     # S < T: shift -60
    (128, 128, True, True, [0, 1]),
    (128, 128, True, False, [0, 0]),   # row 0 sees no valid key
    (128, 128, False, True, [0, 0]),
])
def test_bwd_first_query_tile(T, S, causal, valid0, want):
    valid = np.ones(S, bool)
    valid[0] = valid0
    got = [bwd_first_query_tile(T, S, kt, causal, valid)
           for kt in range(-(-S // 64))]
    assert got == want


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _probs(q, k, v, out, dout, valid, causal):
    """P and dS [B, Hq, T, S] in fp32, as attention_bwd_plain has them."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    kf = k.repeat_interleave(Hq // Hkv, dim=2)
    vf = v.repeat_interleave(Hq // Hkv, dim=2)
    mask = valid[:, None, None, :].expand(B, 1, T, S)
    if causal:
        mask = mask & torch.ones(T, S, dtype=torch.bool).tril(S - T)
    scores = torch.einsum("bthd,bshd->bhts", q, kf) / math.sqrt(d)
    p = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    dp = torch.einsum("bthd,bshd->bhts", dout, vf)
    delta = (dout * out).sum(-1).transpose(1, 2)[..., None]
    return p, p * (dp - delta)


def split_dkv(q, k, v, out, dout, valid, causal, plan: BwdPlan,
              bf16_operands: bool):
    """dK, dV summed as dkv_kernel and dkv_reduce_kernel sum them: per key
    tile, each split's fp32 partial over its items
    (attention_bwd_plan_items from bwd_first_query_tile), the partials
    added in split order, dK scaled after the sum; with `bf16_operands`, P
    and dS rounded to bf16 as product operands."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    p, ds = _probs(q, k, v, out, dout, valid, causal)
    if bf16_operands:
        p, ds = _bf16(p), _bf16(ds)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b in range(B):
        for hk in range(Hkv):
            for kt in range(plan.key_tiles):
                keys = slice(64 * kt, min(S, 64 * kt + 64))
                t_lo = bwd_first_query_tile(T, S, kt, causal, valid[b])
                acc_k = acc_v = None
                for items in attention_bwd_plan_items(plan, Hq, Hkv, t_lo):
                    part_k = torch.zeros(keys.stop - keys.start, d)
                    part_v = torch.zeros_like(part_k)
                    for g, t in items:
                        h, rows = hk * G + g, slice(64 * t, min(T, 64 * t + 64))
                        part_v += p[b, h, rows, keys].T @ dout[b, rows, h]
                        part_k += ds[b, h, rows, keys].T @ q[b, rows, h]
                    acc_k = part_k if acc_k is None else acc_k + part_k
                    acc_v = part_v if acc_v is None else acc_v + part_v
                dk[b, keys, hk] = acc_k / math.sqrt(d)
                dv[b, keys, hk] = acc_v
    return dk, dv


def _case(name):
    """(q, k, v, dout, key_valid, causal) of one emulation case, numpy
    draws from a seed, bf16-representable values."""
    B, T, S, Hq, Hkv, d, causal = {
        "gqa_causal_t_ne_s": (1, 70, 130, 6, 1, 64, True),  # group of 6
        "fully_masked_row": (2, 40, 40, 6, 1, 48, False),
        "d48_causal": (2, 97, 97, 4, 2, 48, True),
    }[name]
    rng = np.random.default_rng(21)
    q, k, v, dout = (_bf16(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)))
        for s in ((B, T, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d),
                  (B, T, Hq, d)))
    valid = torch.ones(B, S, dtype=torch.bool)
    if name == "fully_masked_row":
        valid[0] = False
        valid[1, 25:] = False
    elif name == "d48_causal":
        valid[1, 30:96] = False  # [text | pads | SOA]
    else:
        valid[0, 100:120] = False
    return q, k, v, dout, valid, causal


@pytest.mark.parametrize("name", ["gqa_causal_t_ne_s", "fully_masked_row",
                                  "d48_causal"])
def test_split_emulation_matches_jax_flash_attention(name):
    """fp32: under every plan the kernel takes, the split partials added in
    split order are JAX flash_attention's dK and dV (interpret mode)
    within 2e-4."""
    q, k, v, dout, valid, causal = _case(name)
    kv = jnp.asarray(valid.numpy().astype(np.int32))
    w = jnp.asarray(dout.numpy())

    def loss(q_, k_, v_):
        return jnp.sum(flash_attention(q_, k_, v_, kv, causal, True) * w)

    _, jdk, jdv = (np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v))))
    out = attention_fwd_plain(q, k, v, valid, causal)
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    for plan in candidate_bwd_plans(B, T, S, Hq, Hkv, d, causal):
        dk, dv = split_dkv(q, k, v, out, dout, valid, causal, plan, False)
        np.testing.assert_allclose(dk.numpy(), jdk, rtol=TOL, atol=TOL,
                                   err_msg=f"dk {plan}")
        np.testing.assert_allclose(dv.numpy(), jdv, rtol=TOL, atol=TOL,
                                   err_msg=f"dv {plan}")


@pytest.mark.parametrize("name", ["gqa_causal_t_ne_s", "fully_masked_row",
                                  "d48_causal"])
def test_split_emulation_bf16_operands_meet_the_card_bound(name):
    """With P and dS rounded to bf16 as product operands, the split sums
    of every plan stay within 2^-7 of the largest gradient of the fp32
    plain backward, and two emulations give the same bits (the partials'
    order is fixed)."""
    q, k, v, dout, valid, causal = _case(name)
    out = _bf16(attention_fwd_plain(q, k, v, valid, causal))
    _, rdk, rdv = attention_bwd_plain(q, k, v, out, dout, valid, causal)
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    for plan in candidate_bwd_plans(B, T, S, Hq, Hkv, d, causal):
        got = split_dkv(q, k, v, out, dout, valid, causal, plan, True)
        again = split_dkv(q, k, v, out, dout, valid, causal, plan, True)
        for a, a2, ref in zip(got, again, (rdk, rdv)):
            assert torch.equal(a, a2)
            err = (a - ref).abs().max().item()
            assert err <= 2 ** -7 * ref.abs().max().item(), (plan, err)

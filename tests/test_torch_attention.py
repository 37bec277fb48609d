"""The attention kernel's plain version (audio_calm_torch.ops.attention_kernel)
vs the Pallas `fused_attention` / `fused_attention_batched` in interpret
mode, and the port's MultiheadAttention vs flax, fp32 on the CPU.

Bound 2e-5, the JAX package's own (tests/test_pallas_attention.py): both
sides take an fp32 softmax over fp32 scores; the sums run in another
order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.models.convert import from_jax_params
from audio_calm_torch.ops.attention import MultiheadAttention as TMHA
from audio_calm_torch.ops.attention_kernel import (attention_fwd,
                                                   attention_fwd_plain)
from audio_calm_tpu.ops.attention import MultiheadAttention
from audio_calm_tpu.ops.pallas_attention import (fused_attention,
                                                 fused_attention_batched)

TOL = 2e-5


def _qkv(seed, B, T, S, Hq, Hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d))]


def _both(q, k, v, valid, causal, jax_fn):
    ref = np.asarray(jax_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            key_valid=jnp.asarray(valid.astype(np.int32)),
                            causal=causal, interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    out = attention_fwd_plain(tq, tk, tv, tvalid, causal).numpy()
    # on CPU tensors the kernel wrapper runs the plain version
    launches = attention_fwd.launches
    np.testing.assert_array_equal(
        attention_fwd(tq, tk, tv, tvalid, causal).numpy(), out)
    assert attention_fwd.launches == launches
    return out, ref


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("gqa", [1, 2])
def test_attention_plain_matches_fused_attention(causal, gqa):
    B, T, Hq, d = 2, 16, 4, 64
    q, k, v = _qkv(0, B, T, T, Hq, Hq // gqa, d)
    valid = np.arange(T)[None, :] < np.array([[12], [16]])
    valid[1, 5:8] = False  # mid-sequence pad
    out, ref = _both(q, k, v, valid, causal, fused_attention)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_attention_plain_cross_lengths():
    q, k, v = _qkv(1, 2, 8, 24, 2, 2, 64)
    valid = np.ones((2, 24), bool)
    valid[0, -5:] = False
    out, ref = _both(q, k, v, valid, False, fused_attention)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_attention_plain_matches_batched_qwen_layout():
    """[text | SOA] with mid-sequence pad between the text and SOA, causal
    GQA (the Qwen2 encode site of fused_attention_batched)."""
    B, T, Hq, Hkv, d = 2, 13, 6, 2, 32
    q, k, v = _qkv(2, B, T, T, Hq, Hkv, d)
    valid = np.ones((B, T), bool)
    valid[1, 8:12] = False  # text pad, then the SOA position stays valid
    out, ref = _both(q, k, v, valid, True, fused_attention_batched)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_attention_fully_masked_row_is_uniform_average():
    q, k, v = _qkv(3, 2, 5, 9, 4, 2, 32)
    valid = np.ones((2, 9), bool)
    valid[0] = False  # no valid key in batch row 0
    out, ref = _both(q, k, v, valid, False, fused_attention)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    mean_v = np.repeat(v[0].mean(axis=0), 2, axis=0)  # [Hq, d]
    np.testing.assert_allclose(out[0], np.broadcast_to(mean_v, out[0].shape),
                               rtol=TOL, atol=TOL)


def test_multihead_attention_matches_flax():
    rng = np.random.default_rng(4)
    B, Tq, Tk, E, H = 2, 10, 7, 32, 4
    query = rng.standard_normal((B, Tq, E)).astype(np.float32)
    kv = rng.standard_normal((B, Tk, E)).astype(np.float32)
    pad = np.zeros((B, Tk), bool)
    pad[1, -3:] = True
    m = MultiheadAttention(E, H)
    params = m.init(jax.random.PRNGKey(0), query, kv, kv)["params"]
    ref = np.asarray(m.apply({"params": params}, query, kv, kv,
                             key_padding_mask=jnp.asarray(pad)))
    tm = TMHA(E, H)
    tm.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(query), torch.from_numpy(kv),
                 torch.from_numpy(kv), torch.from_numpy(pad)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)

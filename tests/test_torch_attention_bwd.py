"""The attention backward of the port (audio_calm_torch.ops.attention_kernel:
`attention_bwd_plain`, and `flash_attention` through autograd) vs the
gradients of JAX `flash_attention`, whose backward is the Pallas
`_flash_bwd_kernel`, in interpret mode, fp32 on the CPU; past the Pallas
gate (T = S = 640) vs `jax.grad` of the XLA attention the JAX package
sends such rows to (models/qwen2.sdpa).

Bound rtol/atol 2e-4, the JAX package's own for these gradients
(tests/test_pallas_attention.py): fp32 everywhere, the sums in another
order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                   attention_bwd_plain,
                                                   attention_fwd_plain,
                                                   flash_attention as
                                                   t_flash_attention)
from audio_calm_tpu.models.qwen2 import sdpa
from audio_calm_tpu.ops.pallas_attention import flash_attention

TOL = 2e-4


def _qkv(seed, B, T, S, Hq, Hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d),
                      (B, T, Hq, d))]


def _jax_grads(q, k, v, w, valid, causal):
    kv = None if valid is None else jnp.asarray(valid.astype(np.int32))

    def loss(q, k, v):
        return jnp.sum(flash_attention(q, k, v, kv, causal, True) * w)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _check(q, k, v, w, valid, causal):
    ref = _jax_grads(q, k, v, w, valid, causal)
    tvalid = None if valid is None else torch.from_numpy(valid)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = t_flash_attention(tq, tk, tv, tvalid, causal)
    (out * torch.from_numpy(w)).sum().backward()
    for a, b, name in zip((tq.grad, tk.grad, tv.grad), ref, "qkv"):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL,
                                   err_msg=f"flash_attention d{name}")
    # the plain backward directly, on the forward's output; on CPU tensors
    # the kernel wrapper runs it and launches nothing
    args = [torch.from_numpy(a) for a in (q, k, v)]
    o = attention_fwd_plain(*args, tvalid, causal)
    plain = attention_bwd_plain(*args, o, torch.from_numpy(w), tvalid, causal)
    launches = attention_bwd.launches
    wrapped = attention_bwd(*args, o, torch.from_numpy(w), tvalid, causal)
    assert attention_bwd.launches == launches
    for a, b, c, name in zip(plain, wrapped, ref, "qkv"):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(a.numpy(), c, rtol=TOL, atol=TOL,
                                   err_msg=f"attention_bwd_plain d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("gqa", [1, 2])
def test_grads_match_jax_flash_attention(causal, gqa):
    """The cases of test_flash_attention_grads_match_xla: key lengths 12
    and 16, causal or not, with and without GQA."""
    B, T, Hq, d = 2, 16, 4, 32
    q, k, v, w = _qkv(3, B, T, T, Hq, Hq // gqa, d)
    valid = np.arange(T)[None, :] < np.array([[12], [16]])
    _check(q, k, v, w, valid, causal)


def test_grads_cross_lengths():
    """T != S with no key mask (test_flash_attention_grads_cross_len)."""
    q, k, v, _ = _qkv(4, 1, 8, 24, 2, 2, 32)
    w = 2 * attention_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    _check(q, k, v, w.numpy(), None, False)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_fully_masked_row_and_qwen_layout(causal):
    """Batch row 0 has no valid key (a uniform P); row 1 is the Qwen2
    [text | pads | SOA] layout with GQA 6/2, where the padded query rows
    still see the earlier valid keys."""
    B, T, Hq, Hkv, d = 2, 13, 6, 2, 32
    q, k, v, w = _qkv(5, B, T, T, Hq, Hkv, d)
    valid = np.ones((B, T), bool)
    valid[0] = False
    valid[1, 8:12] = False
    _check(q, k, v, w, valid, causal)


def test_grads_past_512_match_jax_xla_attention():
    """T = S = 640, past the TPU kernel's 512 gate, where JAX runs XLA
    attention (models/qwen2.sdpa): causal GQA 4/2 with a key-padded batch
    row, the port's flash_attention gradients (the plain route on the CPU)
    vs jax.grad of sdpa under the same mask, at 2e-4."""
    B, T, Hq, Hkv, d = 2, 640, 4, 2, 32
    q, k, v, w = _qkv(6, B, T, T, Hq, Hkv, d)
    valid = np.ones((B, T), bool)
    valid[1, 500:600] = False
    mask = valid[:, None, None, :] & np.tril(np.ones((T, T), bool))

    def loss(q, k, v):
        return jnp.sum(sdpa(q, k, v, jnp.asarray(mask)) * w)

    ref = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = t_flash_attention(tq, tk, tv, torch.from_numpy(valid), True)
    (out * torch.from_numpy(w)).sum().backward()
    for a, b, name in zip((tq.grad, tk.grad, tv.grad), ref, "qkv"):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL,
                                   err_msg=f"flash_attention d{name} at 640")


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bwd_bf16_operands(q, k, v, out, dout, valid, causal):
    """attention_bwd_plain with P and dS rounded to bf16 as the operands of
    dV = P^T dO, dQ = dS K and dK = dS^T Q, all else fp32: the numeric
    design of K5's bf16 path on the tensor cores."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / np.sqrt(d)
    kf = k.repeat_interleave(group, dim=2)
    vf = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, kf) * scale
    mask = valid[:, None, None, :].expand(B, 1, T, S)
    if causal:
        mask = mask & torch.ones(T, S, dtype=torch.bool).tril(S - T)
    p = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    dv = torch.einsum("bhts,bthd->bshd", _bf16(p), dout)
    dp = torch.einsum("bthd,bshd->bhts", dout, vf)
    delta = (dout * out).sum(dim=-1).transpose(1, 2)[..., None]
    ds = _bf16(p * (dp - delta))
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q) * scale
    return (dq, dk.reshape(B, S, Hkv, group, d).sum(3),
            dv.reshape(B, S, Hkv, group, d).sum(3))


@pytest.mark.parametrize("shape", [
    "qwen2_training",   # [B, 97, 12/2, 128], causal, [text | pads | SOA]
    "dit_self",         # [B, 384, H, 64], S 384, key pads
    "dit_cross",        # [B, 384, H, 64], S 25
])
def test_bf16_operand_rounding_meets_the_card_bound(shape):
    """Rounding P and dS to bf16 only as product operands keeps every
    gradient within 2^-7 of its largest magnitude of the fp32 plain
    backward (the card tests' bf16 bound), on bf16-representable inputs:
    the bound is reachable before the kernel runs. Shapes as on the
    training paths, at a reduced batch and head count."""
    B, T, S, Hq, Hkv, d, causal = {
        "qwen2_training": (2, 97, 97, 12, 2, 128, True),
        "dit_self": (2, 384, 384, 2, 2, 64, False),
        "dit_cross": (2, 384, 25, 2, 2, 64, False),
    }[shape]
    rng = np.random.default_rng(11)
    q, k, v, dout = (_bf16(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)))
        for s in ((B, T, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d),
                  (B, T, Hq, d)))
    valid = torch.ones(B, S, dtype=torch.bool)
    if causal:
        valid[1, 40:S - 1] = False  # a 40-token text, pads, SOA
    else:
        valid[1, S // 2:] = False
    out = _bf16(attention_fwd_plain(q, k, v, valid, causal))
    ref = attention_bwd_plain(q, k, v, out, dout, valid, causal)
    got = _bwd_bf16_operands(q, k, v, out, dout, valid, causal)
    for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
        err = (a - b).abs().max().item()
        bound = 2 ** -7 * b.abs().max().item()
        assert err <= bound, (name, err, bound)

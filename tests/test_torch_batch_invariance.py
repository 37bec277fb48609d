"""Batch-invariant served rows and the padded attention route, on the CPU.

- ops/gemm_kernel.linear_plain (the plain twin of csrc/gemm.cu): a row's
  bits do not depend on M, on its position or on the other rows (bf16 and
  fp32, both weight layouts), and it is the fp32 product within a rounding
  of the output dtype; the kernel's tile width and K chunks are a function
  of (N, K) alone, at every M, and the served rows take their plans.
- models/layers.batch_invariant_: the switch routes Linear, LoRADense and
  the causal conv through it, equal to their plain forms within an fp32
  rounding; a tiny bf16 served engine gives a row of a batched /tts its
  solo latents bit for bit and a batched ASR row its solo ids.
- ops/attention_kernel._pad_head_dim at d = 24 (the end-to-end proof's
  head dim, which the kernels take zero-padded to 32) around the plain
  forward and backward against JAX's XLA attention (models/qwen2.sdpa,
  where the JAX package sends d % 32 != 0): forward 2e-5, gradients 2e-4
  in fp32 (the JAX package's attention bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.models.calm_heads import CausalConv1d
from audio_calm_torch.models.layers import Linear, batch_invariant_
from audio_calm_torch.models.lora import LoRADense
from audio_calm_torch.ops import attention_kernel as ak
from audio_calm_torch.ops import gemm_kernel
from audio_calm_torch.tools.gemm_probe import ROWS, SHAPES as GEMM_SHAPES
from audio_calm_tpu.models.qwen2 import sdpa


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,K,kn", [(96, 160, False), (40, 1032, False),
                                    (64, 160, True)])
def test_plain_twin_rows_do_not_depend_on_the_batch(N, K, kn, dtype):
    g = torch.Generator().manual_seed(N + K)
    x = torch.randn(257, K, generator=g).to(dtype)
    w = (torch.randn((K, N) if kn else (N, K), generator=g) / K ** 0.5
         ).to(dtype)
    b = None if kn else torch.randn(N, generator=g).to(dtype)
    full = gemm_kernel.linear_plain(x, w, b, kn)
    for M in (1, 3, 64, 257):
        assert torch.equal(gemm_kernel.linear_plain(x[:M], w, b, kn),
                           full[:M])
        assert torch.equal(gemm_kernel.linear_plain(x[257 - M:], w, b, kn),
                           full[257 - M:])
    perm = torch.randperm(257, generator=g)
    assert torch.equal(gemm_kernel.linear_plain(x[perm], w, b, kn),
                       full[perm])
    ref = x.double() @ (w.double() if kn else w.double().t())
    if b is not None:
        ref = ref + b.double()
    eps = torch.finfo(dtype).eps
    assert ((full.double() - ref).abs() <= eps * ref.abs() + 1e-4).all()
    # the wrapper on CPU tensors is the plain twin and launches nothing
    n = gemm_kernel.linear.launches
    assert torch.equal(gemm_kernel.linear(x, w, b, kn=kn), full)
    assert gemm_kernel.linear.launches == n


def test_split_count_depends_on_n_and_k_only():
    """The arithmetic of the plan (the tile's width, the K chunks and their
    boundaries) is a function of (N, K) alone: the same at every M from 1
    to 1024, in every plan the kernel may take; only the warpgroups a tile,
    the spread and the grid follow M."""
    assert gemm_kernel.split_count(1536, 8960) == 6  # down_proj
    assert gemm_kernel.split_count(8960, 1536) == 1  # gate / up
    assert gemm_kernel.split_count(1536, 64) == 1  # LoRA's B
    for N, K, _ in GEMM_SHAPES:
        bn, steps = gemm_kernel.tile_n(N), gemm_kernel.chunk_steps(N, K)
        bounds = gemm_kernel.chunk_bounds(N, K)
        s = gemm_kernel.split_count(N, K)
        assert bn == (64 if N <= 768 else 128)
        assert steps % 4 == 0 and len(bounds) == s
        assert bounds[0][0] == 0 and bounds[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(k1 - k0 == 16 * steps for k0, k1 in bounds[:-1])
        assert 1 <= s <= -(-K // gemm_kernel.BK)
        for M in range(1, 1025):
            plans = gemm_kernel.candidate_plans(M, N, K)
            assert gemm_kernel.gemm_plan(M, N, K) in plans
            assert {(p.bn, p.chunk_steps, p.splits) for p in plans} == \
                {(bn, steps, s)}


def test_spread_partials_count_x_and_w():
    """Chunks spread only where the tiles leave SMs idle and their fp32
    partial sums (written and read) move at most _SPREAD_BYTES times the
    bytes of x and w: the ASR projector's conv (N 1536, K 256) at M = 512
    has 8 x 12 tiles but runs its 2 chunks in one block."""
    cap = gemm_kernel._SPREAD_BYTES
    for N, K, _ in GEMM_SHAPES:
        for M in range(1, 1025, 3):
            p = gemm_kernel.gemm_plan(M, N, K)
            if p.spread:
                assert p.blocks // p.splits < gemm_kernel.SMS
                assert 8 * M * N * p.splits <= cap * 2 * (M + N) * K
    one = gemm_kernel.candidate_plans(512, 1536, 256)[0]
    assert one.splits == 2 and one.blocks < gemm_kernel.SMS
    assert not gemm_kernel.gemm_plan(512, 1536, 256).spread


# tools/gemm_probe.ROWS: label -> the plan's (warpgroups a tile, spread,
# grid blocks) on 132 SMs: at every row the fastest of candidate_plans in
# the card's measurements (tools/gemm_probe.py --plans)
SERVED_PLANS = {
    "Qwen2 q/o, /tts pair": (1, True, 96),
    "Qwen2 k/v, /tts pair": (1, True, 80),
    "Qwen2 gate/up, /tts pair": (1, False, 280),
    "Qwen2 down, /tts pair": (1, True, 288),
    "LoRA A, /tts pair": (1, True, 96),
    "LoRA B, /tts pair": (1, False, 48),
    "DiT q/k/v/o, /tts pair": (2, False, 72),
    "DiT mlp_fc1, /tts pair": (3, False, 96),
    "DiT mlp_fc2, /tts pair": (2, False, 72),
    "Qwen2 down, /asr B=2": (2, False, 96),
}


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_plan_at_the_served_rows(row):
    """The served rows' plans. The /tts pair's Qwen2 products at M = 194
    spread their K chunks where the 64-row tiles leave SMs idle: LoRA's A
    in 24 chunks over 96 blocks (4 blocks of 24 K tiles each without),
    down_proj in 6 over 288. The DiT's at M = 768 take 72 blocks of two
    warpgroups (144 warpgroups of 64 rows, on every SM's tensor cores) and
    its fc1 96 blocks of three: one round on 132 SMs where 288 blocks of
    one or 144 of two take two."""
    label, M, N, K, _ = row
    p = gemm_kernel.gemm_plan(M, N, K)
    assert (p.nc, p.spread, p.blocks) == SERVED_PLANS[label]
    tiles = -(-M // (64 * p.nc)) * -(-N // p.bn)
    assert p.blocks == tiles * (p.splits if p.spread else 1)


def test_batch_invariant_switch_routes_every_projection():
    torch.manual_seed(0)
    lin, conv = Linear(16, 24), CausalConv1d(8, 16, 3)
    lora = LoRADense(16, 24, rank=4, alpha=8)
    torch.nn.init.normal_(lora.lora_b)
    mods = torch.nn.ModuleList([lin, conv, lora])
    x16, x8 = torch.randn(3, 5, 16), torch.randn(2, 10, 8)
    with torch.no_grad():
        before = [lin(x16), conv(x8), lora(x16)]
        batch_invariant_(mods)
        assert all(m.batch_invariant for m in mods)
        n = [0]
        orig = gemm_kernel.linear_plain

        def counting(*a, **k):
            n[0] += 1
            return orig(*a, **k)

        gemm_kernel.linear_plain = counting
        try:
            after = [lin(x16), conv(x8), lora(x16)]
        finally:
            gemm_kernel.linear_plain = orig
    assert n[0] == 1 + 1 + 3  # LoRADense: base, A and B
    for a, b in zip(before, after):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    batch_invariant_(mods, False)
    assert not any(m.batch_invariant for m in mods)


def test_bf16_served_rows_equal_solo_requests(tmp_path):
    """A tiny bf16 engine (make_engine switches the products on): the
    first row of a /tts pair has the solo request's latents bit for bit,
    and a batched ASR row the solo ids."""
    from test_torch_serving import TINY_YAML

    from audio_calm_torch.serving import server

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    engine = server.build_engine(server.parse_args(
        ["--config", str(cfg), "--byte-tokenizer", "--device", "cpu"]))
    inf = engine.inf
    assert inf.model.dtype == torch.bfloat16
    assert inf.model.llm.layers[0].mlp.down_proj.batch_invariant
    texts = ["Hello from the served product.", "A second voice joins in."]
    lb, nb, gb = inf.tts_batch(texts, [101, 102], steps=4, cfg_scale=2.5)
    ls, ns, gs = inf.tts_batch(texts[:1], [101], steps=4, cfg_scale=2.5)
    assert gb == gs and nb[0] == ns[0]
    assert np.array_equal(lb[0], ls[0])
    rng = np.random.default_rng(0)
    lats = [rng.standard_normal((20, 8)).astype(np.float32),
            rng.standard_normal((12, 8)).astype(np.float32)]
    ib, _ = inf._asr_ids(lats, [11, 12], steps=4)
    is_, _ = inf._asr_ids(lats[:1], [11], steps=4, pad_batch=False)
    assert np.array_equal(ib[0], is_[0])


def _sdpa_ref(q, k, v, valid, causal):
    T, S = q.shape[1], k.shape[1]
    mask = valid[:, None, None, :]
    if causal:
        mask = mask & (np.arange(S)[None, :] <= np.arange(T)[:, None]
                       + S - T)[None, None]
    return lambda q_, k_, v_: sdpa(q_, k_, v_, jnp.asarray(mask))


@pytest.mark.parametrize("causal", [False, True])
def test_padded_head_dim_matches_jax_attention(causal):
    assert ak.padded_head_dim(24) == 32 and ak.padded_head_dim(40) == 48
    assert ak.padded_head_dim(48) == 48 and ak.padded_head_dim(160) == 160
    rng = np.random.default_rng(5)
    B, T, S, Hq, Hkv, d = 2, 12, 16, 4, 2, 24
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d)))
    w = rng.standard_normal((B, T, Hq, d)).astype(np.float32)
    valid = np.arange(S)[None, :] < np.array([[16], [11]])
    fn = _sdpa_ref(q, k, v, valid, causal)
    ref = np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    tvalid = torch.from_numpy(valid)
    out = ak._pad_head_dim(ak.attention_fwd_plain, tq, tk, tv, tvalid, causal)
    assert out.shape == (B, T, Hq, d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    got = ak._pad_head_dim(ak.attention_bwd_plain, tq, tk, tv, out, tw,
                           tvalid, causal, grads=True)
    for a, b, name in zip(got, grads, "qkv"):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{name}")

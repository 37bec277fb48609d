"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: they skip where there is no NVIDIA card (CUDA kernels have
no interpret mode). Run them on a machine with one:
    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -s

Bounds: fp32 operands 1e-4 max-abs (TF32 is off for the plain side, so
only the fp32 summation order differs); bf16 operands or outputs 2^-7 of
the largest output magnitude (a last-bit difference in an fp32 sum can
round a bf16 operand, or the output, one step the other way). The
resblock kernel (K6) and the stage kernel at the padded widths C=16 and
C=8 are held to the JAX vocoder kernels' own bounds: fp32 rtol/atol 1e-5;
bf16 operands on fp32 activations 5e-3 max-abs, a bound the JAX package
sets on a waveform in [-1, 1] and taken here relative to the output's
largest magnitude where that exceeds 1 (a resblock's output is not
squashed; a flipped bf16 operand moves it in proportion). The attention backward:
fp32 2e-5 of the largest gradient (its sums run over up to 6 heads x S
keys in another order), bf16 as above."""

import numpy as np
import pytest
import torch

from audio_calm_torch.config import HiFiGANConfig
from audio_calm_torch.models.vocoder import HiFiGANGenerator
from audio_calm_torch.ops import cuda_build
from audio_calm_torch.ops.attention_kernel import (_attention_fwd,
                                                   attention_bwd,
                                                   attention_bwd_plain,
                                                   attention_fwd,
                                                   attention_fwd_plain,
                                                   attention_plan,
                                                   candidate_plans,
                                                   flash_attention)
from audio_calm_torch.ops.vocoder_kernel import (_halo, fused_resblock,
                                                 fused_resblock_plain,
                                                 hifigan_apply_fused,
                                                 stage_plan, vocoder_stage,
                                                 vocoder_stage_plain)
from audio_calm_torch.tools import gemm_probe
from audio_calm_torch.tools.attention_probe import (ROWS, repeat_mismatches,
                                                    row_inputs)

pytestmark = pytest.mark.cuda

V1_BLOCKS = ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5)))


@pytest.fixture
def card():
    """The card, with TF32 off for the plain side's fp32 convolutions and
    matmuls (restored afterwards)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _stage_inputs(C_in, C, T, ups, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)

    def w(*shape, scale):
        return scale * torch.randn(*shape, generator=g, device=device)

    x = torch.randn(2, T, C_in, generator=g, device=device)
    ups_w = w(4, C_in, C, scale=0.2) if ups else None
    ups_b = w(C, scale=0.1) if ups else None
    blocks = []
    for k, dils in V1_BLOCKS:
        s = 1.0 / np.sqrt(k * C)
        blocks.append((w(3, k, C, C, scale=s), w(3, C, scale=0.1),
                       w(3, k, C, C, scale=s), w(3, C, scale=0.1), k, dils))
    return x, ups_w, ups_b, blocks


def test_kernels_build(card):
    for name, log in cuda_build.build_all().items():
        print(f"--- {name}\n{log}")


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("C_in,C,T,ups", [(128, 128, 1531, False),
                                          (128, 64, 777, True),
                                          (64, 32, 1201, True),
                                          (128, 128, 40, False),  # < 1 tile
                                          (64, 32, 5, True)])
def test_vocoder_stage_matches_plain(card, C_in, C, T, ups, cdt):
    cdt = getattr(torch, cdt)
    x, ups_w, ups_b, blocks = _stage_inputs(C_in, C, T, ups, card)
    out = vocoder_stage(x, ups_w, ups_b, blocks, compute_dtype=cdt)
    ref = vocoder_stage_plain(x, ups_w, ups_b, blocks, compute_dtype=cdt)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    bound = 1e-4 if cdt == torch.float32 else 2 ** -7 * ref.abs().max().item()
    assert out.shape == ref.shape
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_vocoder_stage_bf16_io(card, cdt):
    cdt = getattr(torch, cdt)
    x, ups_w, ups_b, blocks = _stage_inputs(64, 32, 999, True, card, seed=1)
    x = x.bfloat16()
    out = vocoder_stage(x, ups_w, ups_b, blocks, compute_dtype=cdt)
    ref = vocoder_stage_plain(x, ups_w, ups_b, blocks, compute_dtype=cdt)
    assert out.dtype == ref.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    assert (out - ref).abs().max().item() <= 2 ** -7 * ref.abs().max().item()


V1_STAGES = [(128, 128, False), (128, 64, True),  # C_in, C, ups
             (64, 32, True)]


def _edge_length(C, ups, edge):
    """An output length at the edge of the bf16 tile plan of V1's stage:
    a tile less or more one input row (r output rows), one tile, a length
    under one halo, and a ragged length over several tiles."""
    r = 2 if ups else 1
    tile = stage_plan(C, r, V1_BLOCKS, 1 << 20).tile
    return {"tile-1": tile - r, "tile": tile, "tile+1": tile + r,
            "under-halo": 40, "ragged": 3 * tile + 38}[edge]


@pytest.mark.parametrize("edge", ["tile-1", "tile", "tile+1", "under-halo",
                                  "ragged"])
@pytest.mark.parametrize("C_in,C,ups", V1_STAGES)
def test_vocoder_stage_tile_edges(card, C_in, C, ups, edge):
    T_out = _edge_length(C, ups, edge)
    T_in = T_out // (2 if ups else 1)
    x, ups_w, ups_b, blocks = _stage_inputs(C_in, C, T_in, ups, card, seed=3)
    out = vocoder_stage(x, ups_w, ups_b, blocks, compute_dtype=torch.bfloat16)
    ref = vocoder_stage_plain(x, ups_w, ups_b, blocks,
                              compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (2, T_out, C)
    err = (out - ref).abs().max().item()
    assert err <= 2 ** -7 * ref.abs().max().item(), err


@pytest.mark.parametrize("C_in,C,ups", V1_STAGES)
def test_vocoder_stage_is_deterministic(card, C_in, C, ups):
    """The weight ring changes no order of any sum and no output is summed
    by atomics: two launches give the same bits."""
    T_in = _edge_length(C, ups, "ragged") // (2 if ups else 1)
    args = _stage_inputs(C_in, C, T_in, ups, card, seed=4)
    first = vocoder_stage(*args, compute_dtype=torch.bfloat16)
    second = vocoder_stage(*args, compute_dtype=torch.bfloat16)
    assert torch.equal(first, second)


def test_vocoder_stage_refuses_a_short_weight_stream(card, monkeypatch):
    """The bf16 kernel's bulk copies read every slice of the weight stream,
    so it holds the buffer's length against what the shapes read: a stream
    one k16 slice short is refused with a CUDA error, not read past its
    end."""
    from audio_calm_torch.ops import vocoder_kernel

    args = _stage_inputs(128, 64, 100, True, card, seed=5)
    stream = vocoder_kernel.weight_stream
    monkeypatch.setattr(vocoder_kernel, "weight_stream",
                        lambda *a: stream(*a)[:-16 * 64])
    launches = vocoder_stage.launches
    with pytest.raises(RuntimeError, match="vocoder_stage: CUDA error"):
        vocoder_stage(*args, compute_dtype=torch.bfloat16)
    assert vocoder_stage.launches == launches


def _held(out, ref, cdt):
    """The JAX vocoder kernels' bounds: fp32 rtol/atol 1e-5; bf16 operands
    5e-3 max-abs, relative to the output's largest magnitude above 1."""
    out, ref = out.float(), ref.float()
    if cdt == torch.float32:
        return bool(((out - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all())
    scale = max(1.0, ref.abs().max().item())
    return (out - ref).abs().max().item() < 5e-3 * scale


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("C_in,C,T", [(32, 16, 1201), (16, 8, 777),
                                      (16, 8, 5)])
def test_vocoder_stage_narrow_widths(card, C_in, C, T, cdt):
    """V2's last two stages (C=16, C=8, with the upsample): the wrapper
    pads the channels to 32 and slices the output back."""
    cdt = getattr(torch, cdt)
    x, ups_w, ups_b, blocks = _stage_inputs(C_in, C, T, True, card, seed=2)
    launches = vocoder_stage.launches
    out = vocoder_stage(x, ups_w, ups_b, blocks, compute_dtype=cdt)
    ref = vocoder_stage_plain(x, ups_w, ups_b, blocks, compute_dtype=cdt)
    torch.cuda.synchronize()
    assert vocoder_stage.launches == launches + 1
    assert out.shape == ref.shape == (2, 2 * T, C)
    assert _held(out, ref, cdt), (out - ref).abs().max().item()


def _resblock_inputs(C, k, T, device, dils=(1, 3, 5), seed=0):
    g = torch.Generator(device).manual_seed(seed)
    n, s = len(dils), 1.0 / np.sqrt(k * C)

    def w(*shape, scale):
        return scale * torch.randn(*shape, generator=g, device=device)

    x = torch.randn(2, T, C, generator=g, device=device)
    block = (w(n, k, C, C, scale=s), w(n, C, scale=0.1),
             w(n, k, C, C, scale=s), w(n, C, scale=0.1), k, dils)
    return x, block


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", [12, 24, 48, 96, 128, 192, 256])
def test_fused_resblock_matches_plain(card, C, k, cdt):
    """K6 at the odd widths, V1's C=128 and C=256 and at C=192; T gives
    several tiles and a ragged last one on both paths; the first and last
    H frames (the sequence edges) are held on their own too."""
    cdt = getattr(torch, cdt)
    x, block = _resblock_inputs(C, k, 2500, card)
    launches = fused_resblock.launches
    out = fused_resblock(x, block, compute_dtype=cdt)
    ref = fused_resblock_plain(x, block, compute_dtype=cdt)
    torch.cuda.synchronize()
    assert fused_resblock.launches == launches + 1
    assert out.shape == ref.shape == x.shape
    H = _halo(k, (1, 3, 5))
    for sl in (slice(None), slice(0, H), slice(-H, None)):
        assert _held(out[:, sl], ref[:, sl], cdt), (sl, (out - ref).abs().max())


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_fused_resblock_bf16_io_and_short_rows(card, cdt):
    """bf16 activations in and out (one output rounding step, 2^-7), a
    sequence shorter than the halo, and four dilations."""
    cdt = getattr(torch, cdt)
    for C, k, T, dils in ((96, 11, 999, (1, 3, 5)), (24, 3, 7, (1, 3, 5)),
                          (48, 5, 300, (1, 2, 4, 8))):
        x, block = _resblock_inputs(C, k, T, card, dils=dils, seed=3)
        x = x.bfloat16()
        out = fused_resblock(x, block, compute_dtype=cdt)
        ref = fused_resblock_plain(x, block, compute_dtype=cdt)
        assert out.dtype == ref.dtype == torch.bfloat16
        out, ref = out.float(), ref.float()
        assert (out - ref).abs().max().item() <= \
            2 ** -7 * ref.abs().max().item(), (C, k, T)


@pytest.mark.parametrize("C,k", [(24, 11), (48, 7), (96, 11), (256, 3)])
def test_fused_resblock_batch_rows_equal_solo_launches(card, C, k):
    """The plan is a function of (C, k, dilations, T), never of B, and a
    block's work depends on its (tile, batch row) alone: row 1 of a B=2
    launch equals the same row launched alone, bit for bit."""
    x, block = _resblock_inputs(C, k, 3000, card, seed=5)
    both = fused_resblock(x, block)
    alone = fused_resblock(x[1:].contiguous(), block)
    assert torch.equal(both[1:], alone)


@pytest.mark.parametrize("C", [24, 48, 96])
def test_fused_resblock_is_deterministic(card, C):
    """The weight ring changes no order of any sum and no output is summed
    by atomics: two launches give the same bits."""
    x, block = _resblock_inputs(C, 11, 2000, card, seed=6)
    assert torch.equal(fused_resblock(x, block), fused_resblock(x, block))


def test_fused_resblock_refuses_a_short_weight_stream(card, monkeypatch):
    """The bf16 kernel's bulk copies read every tap image of the weight
    stream, so it holds the buffer's length against what the shapes read: a
    stream one image short is refused with a CUDA error, not read past its
    end."""
    from audio_calm_torch.ops import vocoder_kernel

    x, block = _resblock_inputs(96, 3, 300, card, seed=7)
    stream = vocoder_kernel.resblock_stream
    monkeypatch.setattr(vocoder_kernel, "resblock_stream",
                        lambda w1, w2, p: stream(w1, w2, p)[
                            :-p.kpad * p.split])
    launches = fused_resblock.launches
    with pytest.raises(RuntimeError, match="fused_resblock: CUDA error"):
        fused_resblock(x, block)
    assert fused_resblock.launches == launches


def test_fused_resblock_routes_as_jax(card):
    """C=64 divides 128: the stage kernel (K1) runs, not K6; C=96 runs K6.
    Outside K6's domain the wrapper raises ValueError naming the limit."""
    x, block = _resblock_inputs(64, 3, 300, card)
    k1, k6 = vocoder_stage.launches, fused_resblock.launches
    out = fused_resblock(x, block)
    assert (vocoder_stage.launches, fused_resblock.launches) == (k1 + 1, k6)
    assert _held(out, fused_resblock_plain(x, block), torch.bfloat16)
    x, block = _resblock_inputs(96, 3, 300, card)
    fused_resblock(x, block)
    assert (vocoder_stage.launches, fused_resblock.launches) == (k1 + 1,
                                                                 k6 + 1)
    for bad, match in (((300, 3, (1, 3, 5)), "C <= 256"),
                       ((96, 13, (1, 3, 5)), "k <= 11"),
                       ((96, 3, (1, 2, 3, 4, 5)), "dilations")):
        C, k, dils = bad
        x, block = _resblock_inputs(C, k, 50, card, dils=dils)
        with pytest.raises(ValueError, match=match):
            fused_resblock(x, block)
    x, block = _resblock_inputs(96, 3, 50, card)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        fused_resblock(x.half(), block)
    x, block = _resblock_inputs(256, 11, 50, card, dils=(1, 9, 11, 13))
    with pytest.raises(ValueError, match="halo"):
        fused_resblock(x, block)


def test_hifigan_apply_fused_card_matches_cpu(card):
    """The V1 generator through hifigan_apply_fused, bf16 operands, on the
    card (three stage launches) and on the CPU (plain twins), same weights:
    within the JAX package's bf16 vocoder bound, 5e-3."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        gen = HiFiGANGenerator(HiFiGANConfig()).eval()
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 24, 80)).astype(np.float32))
    with torch.no_grad():
        ref = hifigan_apply_fused(gen, mel)
        launches = vocoder_stage.launches
        out = hifigan_apply_fused(gen.to(card), mel.to(card)).cpu()
    assert vocoder_stage.launches == launches + 3
    assert out.shape == ref.shape == (2, 24 * 256)
    assert (out - ref).abs().max().item() < 5e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,d,causal", [
    (2, 384, 384, 16, 16, 64, False),   # DiT self-attention (CFG 2B)
    (2, 384, 25, 16, 16, 64, False),    # DiT cross-attention
    (2, 97, 97, 12, 2, 128, True),      # Qwen2 causal GQA
    (2, 70, 130, 8, 4, 96, True),       # the other head widths, S > T
    (2, 5, 9, 4, 1, 32, False),
    (2, 70, 130, 8, 4, 48, True),       # d = 48 (768 / 16 heads), S > T
    (2, 96, 384, 16, 16, 96, False),    # ASR query cross-attention
    (2, 96, 96, 16, 16, 48, False),     # ASR head self-attention
    (2, 461, 461, 12, 2, 128, True),    # Qwen2 over [audio | SOA | prompt]
])
def test_attention_matches_plain(card, B, T, S, Hq, Hkv, d, causal, dtype):
    dtype = getattr(torch, dtype)
    g = torch.Generator(card).manual_seed(0)
    q = torch.randn(B, T, Hq, d, generator=g, device=card).to(dtype)
    k = torch.randn(B, S, Hkv, d, generator=g, device=card).to(dtype)
    v = torch.randn(B, S, Hkv, d, generator=g, device=card).to(dtype)
    valid = torch.ones(B, S, dtype=torch.bool, device=card)
    valid[1, S // 2: S // 2 + 3] = False  # mid-sequence pad
    valid[1, -2:] = False
    out = attention_fwd(q, k, v, valid, causal=causal).float()
    ref = attention_fwd_plain(q, k, v, valid, causal=causal).float()
    err = (out - ref).abs().max().item()
    bound = 2e-5 if dtype == torch.float32 else 2 ** -7 * ref.abs().max().item()
    assert err <= bound, err


def test_attention_key_mask_dtypes_agree(card):
    """A bool mask goes to the kernel as bytes, a uint8 one as it is, any
    other dtype through `!= 0`: the same keys, the same output."""
    g = torch.Generator(card).manual_seed(2)
    q, k, v = (torch.randn(2, 9, 4, 64, generator=g, device=card).bfloat16()
               for _ in range(3))
    valid = torch.ones(2, 9, dtype=torch.bool, device=card)
    valid[1, 3:6] = False
    outs = [attention_fwd(q, k, v, m, causal=True)
            for m in (valid, valid.to(torch.uint8), 7 * valid.int(),
                      valid.float())]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_fully_masked_row_is_uniform(card, dtype):
    """Every key masked: a uniform average over all S keys, as -1e30 (and
    the plain version's masked scores) give. bf16 bound: 2^-7 of |out|."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(card).manual_seed(1)
    q = torch.randn(2, 7, 4, 64, generator=g, device=card).to(dtype)
    k = torch.randn(2, 11, 2, 64, generator=g, device=card).to(dtype)
    v = torch.randn(2, 11, 2, 64, generator=g, device=card).to(dtype)
    valid = torch.ones(2, 11, dtype=torch.bool, device=card)
    valid[0] = False
    out = attention_fwd(q, k, v, valid).float()
    ref = attention_fwd_plain(q, k, v, valid).float()
    mean_v = v[0].float().mean(dim=0).repeat_interleave(2, dim=0)  # [Hq, d]
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7 * ref.abs().max().item()
    torch.testing.assert_close(out[0], mean_v.expand(7, 4, 64), rtol=0,
                               atol=tol)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=2e-5 if dtype == torch.float32 else tol)


def _bf16_bound(ref):
    return 2 ** -7 * ref.abs().max().item()


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_attention_fwd_matches_plain_at_served_rows(card, row):
    """Every row chip_smoke.py's phase 6 times (tools/attention_probe.ROWS,
    bf16, the served masks), under attention_plan and under every other
    plan the kernel takes there."""
    q, k, v, valid = row_inputs(row, card, seed=3)
    causal = row[7]
    ref = attention_fwd_plain(q, k, v, valid, causal).float()
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    for plan in [None] + candidate_plans(T, S, Hq, Hkv, d, causal):
        out = _attention_fwd(q, k, v, valid, causal, plan).float()
        assert (out - ref).abs().max().item() <= _bf16_bound(ref), plan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 48, 64, 96, 128])
@pytest.mark.parametrize("T,S", [(70, 200), (200, 70), (130, 131)])
def test_attention_head_dims_causal_t_ne_s(card, d, T, S, dtype):
    """Every head width, causal with offset S - T both ways (T > S leaves
    the first T - S rows no key: the uniform average), GQA 6/2, a ragged
    key mask, every plan."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(card).manual_seed(d + T)
    q = torch.randn(2, T, 6, d, generator=g, device=card).to(dtype)
    k = torch.randn(2, S, 2, d, generator=g, device=card).to(dtype)
    v = torch.randn(2, S, 2, d, generator=g, device=card).to(dtype)
    valid = torch.rand(2, S, generator=g, device=card) < 0.8
    ref = attention_fwd_plain(q, k, v, valid, True).float()
    bound = 2e-5 if dtype == torch.float32 else _bf16_bound(ref)
    for plan in [None] + candidate_plans(T, S, 6, 2, d, True):
        out = _attention_fwd(q, k, v, valid, True, plan).float()
        assert (out - ref).abs().max().item() <= bound, plan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_causal_rows_with_no_valid_key(card, dtype):
    """Causal rows that see no valid key (the first 100 keys masked, so
    the first 100 rows of a T = S = 300 encode attend nothing) average
    every one of the S keys, as the reference's -1e30 scores do, though
    the kernel skips key tiles past the diagonal elsewhere."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(card).manual_seed(4)
    q = torch.randn(1, 300, 12, 128, generator=g, device=card).to(dtype)
    k = torch.randn(1, 300, 2, 128, generator=g, device=card).to(dtype)
    v = torch.randn(1, 300, 2, 128, generator=g, device=card).to(dtype)
    valid = torch.ones(1, 300, dtype=torch.bool, device=card)
    valid[0, :100] = False
    ref = attention_fwd_plain(q, k, v, valid, True).float()
    mean_v = v[0].float().mean(dim=0).repeat_interleave(6, dim=0)
    bound = 2e-5 if dtype == torch.float32 else _bf16_bound(ref)
    for plan in [None] + candidate_plans(300, 300, 12, 2, 128, True):
        out = _attention_fwd(q, k, v, valid, True, plan).float()
        assert (out - ref).abs().max().item() <= bound, plan
        assert (out[0, :100] - mean_v).abs().max().item() <= max(bound, 1e-5)


@pytest.mark.parametrize("row", [r for r in ROWS if r[1] > 1],
                         ids=[r[0] for r in ROWS if r[1] > 1])
def test_attention_batch_rows_equal_solo_launches(card, row):
    """No tiling, packing or key split is chosen by B: each row of a
    batch equals the same row launched alone, bit for bit (here as a
    B = 4 batch against four B = 1 launches)."""
    label, _, T, S, Hq, Hkv, d, causal, _, _ = row
    q, k, v, valid = row_inputs((label, 4) + row[2:], card, seed=5)
    batch = attention_fwd(q, k, v, valid, causal)
    for b in range(4):
        solo = attention_fwd(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                             valid[b:b + 1], causal)
        assert torch.equal(solo[0], batch[b]), b


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_attention_fwd_is_deterministic(card, row):
    """Two launches on the same inputs give the same bits (the key split
    merges its warpgroups in a fixed order)."""
    q, k, v, valid = row_inputs(row, card, seed=6)
    first = attention_fwd(q, k, v, valid, row[7])
    assert torch.equal(attention_fwd(q, k, v, valid, row[7]), first)


@pytest.mark.parametrize("label", ["ASR Qwen2 encode L=461",
                                   "ASR cross d=96"])
def test_attention_key_split_repeats_agree(card, label):
    """The key split (two consumer warpgroups sharing one ring of K/V
    stages) at a B = 16 batch: 2000 launches, each after an L2 flush,
    give the first launch's bits. A ring stage shared by both
    warpgroups lets one wait on it two phases ahead and read a tile that
    has not landed, a few times in a thousand launches."""
    row = next(r for r in ROWS if r[0] == label)
    T, S, Hq, Hkv, d, causal = row[2:8]
    assert attention_plan(T, S, Hq, Hkv, d, causal).consumers == 2
    q, k, v, valid = row_inputs((label, 16) + row[2:], card, seed=3)
    assert repeat_mismatches(q, k, v, valid, causal, 2000) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_fwd_at_2048(card, dtype):
    """Past the TPU's 512 gate: T = S = 2048, causal GQA 12/2, d = 128."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(card).manual_seed(7)
    q = torch.randn(1, 2048, 12, 128, generator=g, device=card).to(dtype)
    k = torch.randn(1, 2048, 2, 128, generator=g, device=card).to(dtype)
    v = torch.randn(1, 2048, 2, 128, generator=g, device=card).to(dtype)
    valid = torch.ones(1, 2048, dtype=torch.bool, device=card)
    valid[0, 1000:1100] = False
    out = attention_fwd(q, k, v, valid, True).float()
    ref = attention_fwd_plain(q, k, v, valid, True).float()
    bound = 2e-5 if dtype == torch.float32 else _bf16_bound(ref)
    assert (out - ref).abs().max().item() <= bound


def test_flash_attention_grads_past_512(card):
    """flash_attention at T = 640, past the TPU's 512 gate: the forward and
    K5's backward both compute (K5 refused past 512 until its gate was
    lifted), the gradients within the bf16 bound of autograd through the
    plain forward."""
    g = torch.Generator(card).manual_seed(8)
    q, k, v = (torch.randn(1, 640, 4, 64, generator=g, device=card)
               .bfloat16().requires_grad_() for _ in range(3))
    out = flash_attention(q, k, v, None, True)
    ref = attention_fwd_plain(q.detach(), k.detach(), v.detach(), None, True)
    assert (out.detach().float() - ref.float()).abs().max().item() <= \
        _bf16_bound(ref.float())
    out.float().sum().backward()
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    attention_fwd_plain(*leaves, None, True).sum().backward()
    for a, b in zip((q, k, v), leaves):
        assert (a.grad.float() - b.grad).abs().max().item() <= \
            _bf16_bound(b.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [1024, 2048])
def test_attention_bwd_past_512(card, T, causal, d, dtype):
    """K5 at T = S = 1024 and 2048, GQA 12/2, with key padding, against
    its plain version on the forward's output: the JAX package's
    tolerance, 2e-4 in fp32 (rtol and atol), bf16 within 2^-7 of the
    largest gradient."""
    dtype = getattr(torch, dtype)
    q, k, v, dout, valid = _bwd_inputs(card, 1, T, T, 12, 2, d, dtype, 11)
    valid[0, T // 3:T // 3 + 100] = False
    out = attention_fwd(q, k, v, valid, causal)
    got = attention_bwd(q, k, v, out, dout, valid, causal)
    ref = attention_bwd_plain(q, k, v, out, dout, valid, causal)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == dtype
        a, b = a.float(), b.float()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
        else:
            assert (a - b).abs().max().item() <= 2 ** -7 * \
                b.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_packed_misaligned_views_match_aligned(card, dtype):
    """The packed, key-split plan of the ASR encode (L = 461) on views one
    element off a 16-byte boundary: realigned, the aligned result."""
    dtype = getattr(torch, dtype)
    q, k, v, _, valid = _bwd_inputs(card, 2, 461, 461, 12, 2, 128, dtype, 9)
    assert attention_plan(461, 461, 12, 2, 128, True).group == 6
    out = attention_fwd(q, k, v, valid, True)
    mq, mk, mv = (_off_boundary(t) for t in (q, k, v))
    assert torch.equal(attention_fwd(mq, mk, mv, valid, True), out)


def _bwd_inputs(card, B, T, S, Hq, Hkv, d, dtype, seed=0):
    g = torch.Generator(card).manual_seed(seed)
    q = torch.randn(B, T, Hq, d, generator=g, device=card).to(dtype)
    k = torch.randn(B, S, Hkv, d, generator=g, device=card).to(dtype)
    v = torch.randn(B, S, Hkv, d, generator=g, device=card).to(dtype)
    dout = torch.randn(B, T, Hq, d, generator=g, device=card).to(dtype)
    lengths = torch.randint(S // 3, S + 1, (B,), generator=g, device=card)
    valid = torch.arange(S, device=card)[None, :] < lengths[:, None]
    valid[0] = True
    if B > 1:
        valid[1, S // 2: S // 2 + 3] = False  # mid-sequence pad
    return q, k, v, dout, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,d,causal", [
    (16, 97, 97, 12, 2, 128, True),     # Qwen2 training slice
    (2, 384, 384, 16, 16, 64, False),   # DiT self-attention, dropout off
    (2, 384, 25, 16, 16, 64, False),    # DiT cross-attention
    (2, 70, 130, 8, 4, 96, True),       # S > T, other head widths
    (2, 5, 9, 4, 1, 32, False),
    (3, 33, 65, 4, 4, 64, False),       # ragged tiles both ways
    (2, 96, 96, 16, 16, 48, False),     # d = 48: the ASR head's shape
    (2, 70, 130, 8, 4, 48, True),       # d = 48, S > T, GQA
    (2, 384, 384, 16, 16, 48, False),   # d = 48 at the long-sequence tiles
])
def test_attention_bwd_matches_plain(card, B, T, S, Hq, Hkv, d, causal, dtype):
    dtype = getattr(torch, dtype)
    q, k, v, dout, valid = _bwd_inputs(card, B, T, S, Hq, Hkv, d, dtype)
    out = attention_fwd(q, k, v, valid, causal)
    launches = attention_bwd.launches
    got = attention_bwd(q, k, v, out, dout, valid, causal)
    ref = attention_bwd_plain(q, k, v, out, dout, valid, causal)
    torch.cuda.synchronize()
    assert attention_bwd.launches == launches + 1
    for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        a, b = a.float(), b.float()
        scale = 2e-5 if dtype == torch.float32 else 2 ** -7
        err = (a - b).abs().max().item()
        assert err <= scale * b.abs().max().item(), (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_fully_masked_row(card, dtype):
    dtype = getattr(torch, dtype)
    q, k, v, dout, valid = _bwd_inputs(card, 2, 7, 11, 4, 2, 64, dtype, 3)
    valid[0] = False
    out = attention_fwd(q, k, v, valid)
    got = attention_bwd(q, k, v, out, dout, valid)
    ref = attention_bwd_plain(q, k, v, out, dout, valid)
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        scale = 2e-5 if dtype == torch.float32 else 2 ** -7
        assert (a - b).abs().max().item() <= scale * b.abs().max().item()


@pytest.mark.parametrize("B,T,S,Hq,Hkv,d,causal", [
    (16, 97, 97, 12, 2, 128, True),     # Qwen2 training slice
    (2, 384, 384, 16, 16, 64, False),   # DiT self-attention
])
def test_attention_bwd_is_deterministic(card, B, T, S, Hq, Hkv, d, causal):
    """No atomics: two launches on the same inputs give the same bits (the
    query heads of a kv head sum into dK/dV in a fixed order)."""
    q, k, v, dout, valid = _bwd_inputs(card, B, T, S, Hq, Hkv, d,
                                       torch.bfloat16, 4)
    out = attention_fwd(q, k, v, valid, causal)
    first = attention_bwd(q, k, v, out, dout, valid, causal)
    second = attention_bwd(q, k, v, out, dout, valid, causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _off_boundary(t):
    """The same values in a contiguous view that starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_misaligned_views_match_aligned(card, dtype):
    """Views that start off a 16-byte boundary (the kernels copy rows in
    16-byte pieces): the wrappers realign them, and forward and backward
    give exactly the aligned inputs' results."""
    dtype = getattr(torch, dtype)
    q, k, v, dout, valid = _bwd_inputs(card, 2, 97, 97, 12, 2, 128, dtype, 5)
    out = attention_fwd(q, k, v, valid, True)
    grads = attention_bwd(q, k, v, out, dout, valid, True)
    mq, mk, mv, mdout, mout = (_off_boundary(t) for t in (q, k, v, dout, out))
    assert torch.equal(attention_fwd(mq, mk, mv, valid, True), out)
    for a, b in zip(attention_bwd(mq, mk, mv, mout, mdout, valid, True),
                    grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_d48_misaligned_views_match_aligned(card, dtype):
    """d = 48 rows are 96 bytes: views one element off a 16-byte boundary
    are realigned by the wrappers, with the aligned inputs' results."""
    dtype = getattr(torch, dtype)
    q, k, v, dout, valid = _bwd_inputs(card, 2, 96, 96, 16, 16, 48, dtype, 6)
    out = attention_fwd(q, k, v, valid)
    grads = attention_bwd(q, k, v, out, dout, valid)
    mq, mk, mv, mdout, mout = (_off_boundary(t) for t in (q, k, v, dout, out))
    assert torch.equal(attention_fwd(mq, mk, mv, valid), out)
    for a, b in zip(attention_bwd(mq, mk, mv, mout, mdout, valid), grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("context", [False, True])
def test_flow_head_at_asr_yaml_width_runs_on_the_card(card, context):
    """A TransformerFlowHead at configs/asr.yaml's 768 / 16 heads (d = 48):
    its attentions launch the kernel on the card, and its velocity agrees
    with the CPU's (fp32, TF32 off: 1e-4 of the largest value), with
    masked frames and, for the TTS head, masked context keys."""
    import copy

    from audio_calm_torch.models.calm_heads import TransformerFlowHead

    torch.manual_seed(0)
    cpu = TransformerFlowHead(1536, 128 if context else 1536, 768, 4, 16,
                              context_dim=1536 if context else None).eval()
    for p in cpu.parameters():
        torch.nn.init.normal_(p, 0.0, 0.02)
    dev = copy.deepcopy(cpu).to(card)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 96, 128 if context else 1536, generator=g)
    cond = torch.randn(2, 96, 1536, generator=g)
    t = torch.rand(2, generator=g)
    x_mask = torch.arange(96)[None, :] >= torch.tensor([[96], [58]])
    ctx = torch.randn(2, 24, 1536, generator=g) if context else None
    ctx_mask = (torch.arange(24)[None, :] >= torch.tensor([[24], [16]])
                if context else None)
    outs = []
    for m, device in ((cpu, "cpu"), (dev, card)):
        launches = attention_fwd.launches
        with torch.no_grad():
            outs.append(m(*(a.to(device) for a in (cond, x, t)),
                          context=None if ctx is None else ctx.to(device),
                          context_mask=None if ctx is None
                          else ctx_mask.to(device),
                          x_mask=x_mask.to(device)).cpu())
        n = attention_fwd.launches - launches
        assert n == (4 * (2 if context else 1) if device == card else 0)
    ref = outs[0]
    assert (outs[1] - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_flash_attention_function_matches_autograd(card):
    """flash_attention (K4 forward, K5 backward) vs autograd through the
    plain forward, fp32, the Qwen2 training shape."""
    q, k, v, dout, valid = _bwd_inputs(card, 4, 97, 97, 12, 2, 128,
                                       torch.float32, 1)
    grads = []
    for fn in (flash_attention, attention_fwd_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, valid, True)
        (out * dout).sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 2e-5 * b.abs().max().item()


@pytest.mark.parametrize("Tk", [96, 384])  # DiT cross / self attention
def test_multihead_attention_backward_runs_k5(card, Tk):
    """With no probability dropout, the DiT attention's backward on the card
    runs K5 (through flash_attention) and its gradients agree with the
    CPU's (the plain forward and backward), fp32, key pads in one row."""
    import copy

    from audio_calm_torch.ops.attention import MultiheadAttention

    torch.manual_seed(0)
    cpu = MultiheadAttention(1024, 16)
    dev = copy.deepcopy(cpu).to(card)
    x = torch.randn(2, 384, 1024)
    ctx = torch.randn(2, Tk, 1024)
    w = torch.randn(2, 384, 1024)
    pad = torch.zeros(2, Tk, dtype=torch.bool)
    pad[1, Tk // 3:] = True
    grads = []
    for m, device in ((cpu, "cpu"), (dev, card)):
        xs, cs = (t.detach().to(device).requires_grad_() for t in (x, ctx))
        launches = attention_bwd.launches
        out = m(xs, cs, cs, pad.to(device), train=True)
        (out * w.to(device)).sum().backward()
        assert attention_bwd.launches == launches + (device == card)
        grads.append([xs.grad, cs.grad] + [p.grad for p in m.parameters()])
    for a, b in zip(grads[1], grads[0]):
        a = a.cpu()
        # fp32 on both sides, TF32 off: summation order; a floor for the
        # key bias, whose gradient is zero analytically
        top = max(g.abs().max().item() for g in grads[0])
        bound = 1e-4 * max(b.abs().max().item(), 1e-3 * top)
        assert (a - b).abs().max().item() <= bound


def test_kernels_refuse_autograd(card):
    """A kernel's output has no grad_fn: on the card, attention_fwd and
    vocoder_stage refuse inputs that require a gradient, unless autograd
    is off."""
    q, k, v, _, valid = _bwd_inputs(card, 1, 9, 9, 4, 2, 64, torch.bfloat16)
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="flash_attention"):
        attention_fwd(q, k, v, valid, True)
    with torch.no_grad():
        attention_fwd(q, k, v, valid, True)
    x, ups_w, ups_b, blocks = _stage_inputs(64, 32, 40, True, card)
    with pytest.raises(RuntimeError, match="no_grad"):
        vocoder_stage(x.requires_grad_(), ups_w, ups_b, blocks)
    with torch.no_grad():
        vocoder_stage(x, ups_w, ups_b, blocks)
    x, block = _resblock_inputs(96, 3, 40, card)
    with pytest.raises(RuntimeError, match="no_grad"):
        fused_resblock(x.requires_grad_(), block)
    with torch.no_grad():
        fused_resblock(x, block)


# a tiny served configuration whose every attention takes the kernel: Qwen2
# head dim 128, the DiT heads at 128 / 4 = 32, the ASR query
# cross-attention at 512 / 16 = 32
SERVED_YAML = """
model:
  latent_dim: 8
  max_audio_len: 32
  max_text_len: 96
  tts_flow_hidden_dim: 128
  tts_flow_num_layers: 1
  asr_flow_hidden_dim: 128
  asr_flow_num_layers: 1
  flow_num_heads: 4
  qwen:
    vocab_size: 512
    hidden_size: 512
    intermediate_size: 1024
    num_hidden_layers: 2
    num_attention_heads: 4
    num_key_value_heads: 2
    head_dim: 128
    rope_theta: 10000.0
evaluation:
  audio_buckets: [16, 32]
  text_buckets: [64, 96]
  compute_dtype: bfloat16
"""


def test_server_worker_thread_runs_kernels(card, tmp_path):
    """The server does its device work on the batcher's worker thread,
    whose grad mode is its own: one /tts and one /asr there launch the
    attention kernel as many times as the path requires (the wrappers
    would raise under autograd)."""
    import io
    import json
    import urllib.request
    import wave

    from audio_calm_torch.serving import server

    cfg = tmp_path / "served.yaml"
    cfg.write_text(SERVED_YAML)
    args = server.parse_args(["--config", str(cfg), "--byte-tokenizer",
                              "--port", "0"])
    srv = server.make_server(server.build_engine(args), args).start()

    def post(path, data, ctype):
        req = urllib.request.Request(f"http://localhost:{srv.port}{path}",
                                     data=data, headers={"Content-Type":
                                                         ctype})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        t = np.arange(16000) / 16000
        w.writeframes((0.3 * np.sin(2 * np.pi * 220 * t) * 32767)
                      .astype("<i2").tobytes())
    try:
        attention_fwd.launches = 0
        wav = post("/tts", json.dumps({"text": "hello", "seed": 1, "steps": 2,
                                       "cfg_scale": 1.5}).encode(),
                   "application/json")
        n_tts = attention_fwd.launches
        attention_fwd.launches = 0
        text = json.loads(post("/asr?seed=1", buf.getvalue(),
                               "audio/wav"))["text"]
        n_asr = attention_fwd.launches
    finally:
        srv.close()
    e = srv.engine.cfg.evaluation
    assert wav[:4] == b"RIFF" and len(wav) > 44 and isinstance(text, str)
    # Qwen2 layers, then the DiT's self and cross attention at each of the
    # midpoint solver's 2 evaluations a step; ASR: the layers, the query
    # cross-attention, the head's self-attention at each evaluation
    assert e.ode_method == "midpoint"
    assert n_tts == 2 + 1 * 2 * (2 * 2)
    assert n_asr == 2 + 1 + 1 * (2 * e.asr_steps)


def test_griffin_lim_is_deterministic_on_the_card(card):
    """The served product's vocoder: the same magnitudes twice give the
    same bits on the card (its overlap-add sums in a fixed order; a
    scatter-add with atomics would not), so a seeded /tts is
    reproducible."""
    from audio_calm_torch.models.vocoder import GriffinLimVocoder

    g = torch.Generator(card).manual_seed(0)
    log_mel = torch.randn(2, 768, 80, generator=g, device=card) - 4.0
    voc = GriffinLimVocoder(device=card)
    a, b = voc(log_mel), voc(log_mel)
    assert a.shape == (2, 768 * 256)
    assert torch.equal(a, b)


def test_int8_lora_dense_matches_the_cpu(card):
    """Weight-only int8 at the Qwen2-1.5B gate_proj shape (1536 -> 8960,
    LoRA r 64, alpha 128), bf16: quantized on each device from the same
    bf16 weights, the int8 weights and scales are equal, and the card's
    output (a B=1 encode of 97 positions) is the CPU's within the bf16
    bound (the products sum in another order)."""
    from audio_calm_torch.models.lora import LoRADense
    from audio_calm_torch.models.quant import quantize_llm_int8

    g = torch.Generator().manual_seed(0)
    layer = LoRADense(1536, 8960, bias=False, rank=64, alpha=128.0)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=g))
    x = torch.randn(1, 97, 1536, generator=g).to(torch.bfloat16)
    outs, states = [], []
    for dev in ("cpu", card):
        holder = torch.nn.ModuleDict({"gate_proj": LoRADense(
            1536, 8960, bias=False, rank=64, alpha=128.0)})
        holder.load_state_dict({"gate_proj." + k: v for k, v in
                                layer.state_dict().items()})
        holder = holder.to(dev).to(torch.bfloat16)
        assert quantize_llm_int8(holder) == 1
        with torch.no_grad():
            outs.append(holder["gate_proj"](x.to(dev)).float().cpu())
        states.append({k: v.cpu() for k, v in holder.state_dict().items()})
    assert states[1]["gate_proj.weight"].dtype == torch.int8
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
    ref = outs[0]
    assert ref.abs().max() > 0.1
    assert (outs[1] - ref).abs().max() <= 2 ** -7 * ref.abs().max()


# ---------------------------------------------------------------------------
# the batch-invariant product (csrc/gemm.cu) at the served engine's shapes:
# calm.yaml's Qwen2 projections, LoRA's A and B (r 64), the DiT at 768 and
# at the flagship's 1024, the ASR projector's causal convs
# (tools/gemm_probe.SHAPES)
# ---------------------------------------------------------------------------
GEMM_SHAPES = gemm_probe.SHAPES


@pytest.mark.parametrize("N,K,kn", GEMM_SHAPES)
def test_gemm_rows_do_not_depend_on_the_batch(card, N, K, kn):
    """Every M from 1 to 512, the served rows' 194, 768 and 922 (and 1024,
    where the K chunks run in one block instead of blocks of their own)
    gives each row the bits it has at M = 1024, at any position; within
    bf16 rounding of F.linear."""
    from audio_calm_torch.ops.gemm_kernel import linear

    g = torch.Generator(card).manual_seed(N + K)
    x = torch.randn(1024, K, generator=g, device=card).bfloat16()
    w = (torch.randn((K, N) if kn else (N, K), generator=g, device=card)
         / K ** 0.5).bfloat16()
    b = None if kn else torch.randn(N, generator=g, device=card).bfloat16()
    full = linear(x, w, b, kn=kn)
    for M in list(range(1, 513, 7)) + [64, 96, 128, 192, 194, 256, 512,
                                       768, 922]:
        assert torch.equal(linear(x[:M], w, b, kn=kn), full[:M]), M
        assert torch.equal(linear(x[1024 - M:], w, b, kn=kn),
                           full[1024 - M:]), M
    ref = (x @ w if kn else torch.nn.functional.linear(x, w, b)).float()
    err = (full.float() - ref).abs().max().item()
    assert err <= 2 ** -7 * ref.abs().max().item(), err


# rows of tools/gemm_probe.ROWS, and two whose M and N end mid-tile
GEMM_REPEAT_ROWS = gemm_probe.ROWS + [("ragged N=200", 130, 200, 1000, False),
                                      ("ragged kn N=72", 70, 72, 136, True)]


@pytest.mark.parametrize("row", GEMM_REPEAT_ROWS,
                         ids=[r[0] for r in GEMM_REPEAT_ROWS])
def test_gemm_repeated_launches_agree(card, row):
    """Under every plan the row may take (1 to 3 warpgroups a tile, the
    K chunks spread or in one block), 500 launches back to back give the
    first launch's bits, and the rows next to the ragged edges of M (and
    of N, where the last column tile is partial) equal the same rows
    launched alone: the TMA ring's stages are neither read before they
    land nor refilled before every consumer is done with them."""
    got = gemm_probe.repeat_row(row, card, 500)
    assert got["edges_agree"], got
    assert not any(got["mismatched"].values()), got


def test_gemm_launches_and_refusals(card):
    from audio_calm_torch.ops.gemm_kernel import linear

    x = torch.randn(3, 5, 64, device=card).bfloat16()
    w = torch.randn(24, 64, device=card).bfloat16()
    n = linear.launches
    y = linear(x, w)
    torch.cuda.synchronize()
    assert y.shape == (3, 5, 24) and linear.launches == n + 1
    with pytest.raises(TypeError, match="bfloat16"):
        linear(x.float(), w.float())
    with pytest.raises(ValueError, match="K % 8"):
        linear(x[..., :60], w[:, :60])
    with pytest.raises(RuntimeError, match="no_grad"):
        linear(x, w.requires_grad_())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [24, 40])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_padded_head_dims_match_plain(card, d, causal, dtype):
    """Head dims the kernels lack go through them zero-padded (24 -> 32,
    40 -> 48), one launch each way: forward 2e-5 and gradients 2e-4 in
    fp32, bf16 2^-7 of the largest magnitude."""
    dtype = getattr(torch, dtype)
    q, k, v, dout, valid = _bwd_inputs(card, 2, 50, 70, 4, 2, d, dtype, 5)
    f0, b0 = attention_fwd.launches, attention_bwd.launches
    out = attention_fwd(q, k, v, valid, causal)
    got = attention_bwd(q, k, v, out, dout, valid, causal)
    torch.cuda.synchronize()
    assert (attention_fwd.launches, attention_bwd.launches) == (f0 + 1,
                                                                b0 + 1)
    ref = attention_fwd_plain(q, k, v, valid, causal)
    refs = attention_bwd_plain(q, k, v, out, dout, valid, causal)
    for a, b, tol in [(out, ref, 2e-5)] + [(a, b, 2e-4)
                                           for a, b in zip(got, refs)]:
        assert a.shape == b.shape and a.dtype == b.dtype == dtype
        a, b = a.float(), b.float()
        bound = (tol if dtype == torch.float32
                 else 2 ** -7 * b.abs().max().item())
        assert (a - b).abs().max().item() <= bound

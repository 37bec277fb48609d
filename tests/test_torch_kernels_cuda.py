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
from audio_calm_torch.ops.attention_kernel import (attention_bwd,
                                                   attention_bwd_plain,
                                                   attention_fwd,
                                                   attention_fwd_plain,
                                                   flash_attention)
from audio_calm_torch.ops.vocoder_kernel import (_halo, fused_resblock,
                                                 fused_resblock_plain,
                                                 hifigan_apply_fused,
                                                 vocoder_stage,
                                                 vocoder_stage_plain)

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
@pytest.mark.parametrize("C", [12, 24, 48, 96, 128, 256])
def test_fused_resblock_matches_plain(card, C, k, cdt):
    """K6 at the odd widths, V1's C=128 and C=256; T gives several tiles
    and a ragged last one on both paths; the first and last H frames (the
    sequence edges) are held on their own too."""
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
    (2, 70, 130, 8, 4, 96, True),       # S > T, other head widths
    (2, 5, 9, 4, 1, 32, False),
    (3, 33, 65, 4, 4, 64, False),       # ragged tiles both ways
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

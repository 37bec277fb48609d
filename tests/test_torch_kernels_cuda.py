"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: they skip where there is no NVIDIA card (CUDA kernels have
no interpret mode). Run them on a machine with one:
    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -s

Bounds: fp32 operands 1e-4 max-abs (TF32 is off for the plain side, so
only the fp32 summation order differs); bf16 operands or outputs 2^-7 of
the largest output magnitude (a last-bit difference in an fp32 sum can
round a bf16 operand, or the output, one step the other way)."""

import numpy as np
import pytest
import torch

from audio_calm_torch.config import HiFiGANConfig
from audio_calm_torch.models.vocoder import HiFiGANGenerator
from audio_calm_torch.ops import cuda_build
from audio_calm_torch.ops.attention_kernel import (attention_fwd,
                                                   attention_fwd_plain)
from audio_calm_torch.ops.vocoder_kernel import (hifigan_apply_fused,
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

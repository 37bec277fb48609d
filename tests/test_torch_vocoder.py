"""PyTorch port of the HiFi-GAN stage kernel's function and the generator
(audio_calm_torch.ops.vocoder_kernel, models.vocoder) vs the JAX package:
the Pallas `fused_upsample_stage` in interpret mode, `hifigan_apply_fused`
and the flax generator, on the same carried-across weights, on the CPU.

Bounds are the JAX package's own (tests/test_pallas_vocoder.py): 1e-5 in
fp32 (only the fp32 summation order differs), max-abs 5e-3 with bf16
operands (both sides round the same operands to bf16 and accumulate in
fp32; a 1-ulp flip of a rounded operand where the fp32 inputs differ in
their last bits moves an output by ~1e-3 of the tanh range at most)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import HiFiGANConfig as THiFiGANConfig
from audio_calm_torch.models.convert import load_hifigan
from audio_calm_torch.models.vocoder import (HiFiGANGenerator as TGenerator,
                                             HiFiGANVocoder as TVocoder,
                                             fold_weight_norm as t_fold)
from audio_calm_torch.ops.vocoder_kernel import (_mma_fragments,
                                                 hifigan_apply_fused as
                                                 t_apply_fused,
                                                 vocoder_stage,
                                                 vocoder_stage_plain)
from audio_calm_tpu.models.vocoder import (HiFiGANConfig, HiFiGANGenerator,
                                           fold_weight_norm)
from audio_calm_tpu.ops.pallas_vocoder import (fused_upsample_stage,
                                               hifigan_apply_fused)

V1_BLOCKS = ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5)))
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-3)}


def _stage_weights(rng, C_in, C, ups):
    """Random stage weights in the kernel layout, as numpy."""
    def w(*shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    ups_w = w(4, C_in, C, scale=0.2) if ups else None
    ups_b = w(C, scale=0.1) if ups else None
    blocks = []
    for k, dils in V1_BLOCKS:
        n = len(dils)
        s = 1.0 / np.sqrt(k * C)
        blocks.append((w(n, k, C, C, scale=s), w(n, C, scale=0.1),
                       w(n, k, C, C, scale=s), w(n, C, scale=0.1), k, dils))
    return ups_w, ups_b, blocks


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["grouped", "upsample"])
def test_vocoder_stage_plain_matches_pallas(variant, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    ups = variant == "upsample"
    # ragged T: not a multiple of the Pallas tile nor of the CUDA tile
    C_in, C, T = (32, 16, 70) if ups else (16, 16, 75)
    x = rng.standard_normal((2, T, C_in)).astype(np.float32)
    ups_w, ups_b, blocks = _stage_weights(rng, C_in, C, ups)
    ref = np.asarray(fused_upsample_stage(
        jnp.asarray(x), None if ups_w is None else jnp.asarray(ups_w),
        None if ups_b is None else jnp.asarray(ups_b),
        [tuple(jnp.asarray(a) for a in b[:4]) + b[4:] for b in blocks],
        r=2, compute_dtype=jdt, tile_rows=16, interpret=True))
    tb = [tuple(torch.from_numpy(a) for a in b[:4]) + b[4:] for b in blocks]
    args = (torch.from_numpy(x),
            None if ups_w is None else torch.from_numpy(ups_w),
            None if ups_b is None else torch.from_numpy(ups_b), tb)
    out = vocoder_stage_plain(*args, r=2, compute_dtype=tdt).numpy()
    assert out.shape == ref.shape == (2, T * (2 if ups else 1), C)
    assert np.max(np.abs(out - ref)) < tol
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    # on a CPU tensor the kernel wrapper runs the plain version
    launches = vocoder_stage.launches
    np.testing.assert_array_equal(
        vocoder_stage(*args, r=2, compute_dtype=tdt).numpy(), out)
    assert vocoder_stage.launches == launches


@pytest.fixture(scope="module")
def v1():
    cfg = HiFiGANConfig()
    mel = np.random.default_rng(0).standard_normal((1, 8, 80)).astype(
        np.float32)
    gen = HiFiGANGenerator(cfg)
    params = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.asarray(mel))
    tgen = TGenerator(THiFiGANConfig())
    load_hifigan(tgen, params)
    return cfg, gen, params, tgen, mel


def test_hifigan_apply_fused_matches_jax_v1(v1):
    """V1 widths, 8 mel frames, fp32: the routing takes every V1 branch
    (the C=256 plain resblocks, the grouped C=128 stage, both r=2 stages,
    and conv_post after the last stage)."""
    cfg, _, params, tgen, mel = v1
    fused = jax.jit(lambda p, m: hifigan_apply_fused(
        p, m, cfg, compute_dtype=jnp.float32, interpret=True))
    ref = np.asarray(fused(params, jnp.asarray(mel)))
    with torch.no_grad():
        out = t_apply_fused(tgen, torch.from_numpy(mel),
                            compute_dtype=torch.float32).numpy()
        voc = TVocoder(tgen, compute_dtype=torch.float32)(
            torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (1, 8 * 256)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(voc, out)


def test_hifigan_apply_fused_bf16_dtypes_keep_their_meaning():
    """compute_dtype and io_dtype keep the JAX package's meaning: bf16
    operands (5e-3) and bf16 inter-stage activations (2e-2, float32 out),
    each held against the fp32 generator with the JAX package's own bounds
    and geometry (tests/test_pallas_vocoder.py: an r=4 stage with the
    grouped resblocks, then a fused r=2 stage). The generator itself is
    held against flax below."""
    kw = dict(upsample_initial_channel=32, upsample_rates=(4, 2),
              upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 5),
              resblock_dilations=((1, 2), (2, 6)))
    with torch.random.fork_rng():
        torch.manual_seed(4)
        tgen = TGenerator(THiFiGANConfig(**kw))
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 50, 80)).astype(np.float32))
    with torch.no_grad():
        ref = tgen(mel)
        out_bf = t_apply_fused(tgen, mel)
        out_io = t_apply_fused(tgen, mel, io_dtype=torch.bfloat16)
    assert out_io.dtype == torch.float32 and out_io.shape == (2, 400)
    assert ref.abs().max() > 0.1  # a live waveform
    assert (out_bf - ref).abs().max() < 5e-3
    assert (out_io - ref).abs().max() < 2e-2


def test_hifigan_generator_matches_flax(v1):
    _, gen, params, tgen, mel = v1
    ref = np.asarray(jax.jit(gen.apply)(params, jnp.asarray(mel)))
    with torch.no_grad():
        out = tgen(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) < 1e-4


def test_mma_fragment_order_matches_ptx_layout():
    """The tensor-core path's weight order: for tap j, k16 slice kk, channel
    group g and n8 tile nt, lane 4n+q's register b_i holds the bf16 pair
    B[k = 16kk + 8i + 2q + e][n = 32g + 8nt + n], e = 0, 1 (PTX
    mma.m16n8k16 B fragment), 4 words a lane per half (tiles 2h, 2h+1)."""
    k, c_in, c_out = 3, 32, 64
    w = (torch.arange(k * c_in * c_out, dtype=torch.float32) % 251).reshape(
        k, c_in, c_out)  # integers below 256: exact in bf16
    packed = _mma_fragments(w).float().numpy().reshape(
        k, c_in // 16, c_out // 32, 2, 32, 4, 2)  # j kk g half lane word e
    j, kk, g, half, lane, word, e = np.indices(packed.shape)
    nt = 2 * half + word // 2
    row = 16 * kk + 8 * (word % 2) + 2 * (lane % 4) + e
    col = 32 * g + 8 * nt + lane // 4
    np.testing.assert_array_equal(packed, w.numpy()[j, row, col])


def test_fold_weight_norm_matches_jax():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((8, 1, 1)).astype(np.float32)
    v = rng.standard_normal((8, 5, 7)).astype(np.float32)
    ref = fold_weight_norm(g, v)
    out = t_fold(torch.from_numpy(g), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)

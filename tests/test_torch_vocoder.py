"""PyTorch port of the HiFi-GAN kernels' functions, the generator and
Griffin-Lim (audio_calm_torch.ops.vocoder_kernel, models.vocoder) vs the
JAX package: the Pallas `fused_upsample_stage` and `fused_resblock` in
interpret mode, `hifigan_apply_fused`, the flax generator and
`griffin_lim`, on the same carried-across weights, on the CPU.

Bounds are the JAX package's own (tests/test_pallas_vocoder.py): 1e-5 in
fp32 (only the fp32 summation order differs), max-abs 5e-3 with bf16
operands (both sides round the same operands to bf16 and accumulate in
fp32; a 1-ulp flip of a rounded operand where the fp32 inputs differ in
their last bits moves an output by ~1e-3 of the tanh range at most).
Griffin-Lim takes JAX's initial phase (its PRNGKey(0) draw). At 4
iterations (the vocoder and the renderer) it is held to 1e-5 of the
waveform's largest magnitude, the bound of JAX's
test_make_renderer_matches_manual_path scaled to the signal; at 8
iterations to 1e-4 of it: each iteration divides by the spectrum's
magnitude, which amplifies the fp32 summation-order differences of
near-silent bins, so the difference grows with the iterations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import HiFiGANConfig as THiFiGANConfig
from audio_calm_torch.config import VAEModelConfig as TVAEConfig
from audio_calm_torch.eval.render import make_renderer as t_make_renderer
from audio_calm_torch.models.convert import load_hifigan, load_vae
from audio_calm_torch.models.vae import AcousticVAE as TVAE
from audio_calm_torch.models.vocoder import (GriffinLimVocoder as TGriffinLim,
                                             HiFiGANGenerator as TGenerator,
                                             HiFiGANVocoder as TVocoder,
                                             _istft as t_istft,
                                             fold_weight_norm as t_fold,
                                             griffin_lim as t_griffin_lim)
from audio_calm_torch.ops.vocoder_kernel import (_check_resblock,
                                                 fused_resblock,
                                                 fused_resblock_plain,
                                                 hifigan_apply_fused as
                                                 t_apply_fused, pad_stage,
                                                 resblock_plan, simt_plan,
                                                 vocoder_stage,
                                                 vocoder_stage_plain)
from audio_calm_tpu.config import VAEModelConfig
from audio_calm_tpu.eval.render import make_renderer
from audio_calm_tpu.models.vae import AcousticVAE
from audio_calm_tpu.models.vocoder import (GriffinLimVocoder, HiFiGANConfig,
                                           HiFiGANGenerator, ResBlock1,
                                           _istft, fold_weight_norm,
                                           griffin_lim)
from audio_calm_tpu.ops.pallas_vocoder import (_stack_resblock_weights,
                                               fused_resblock as j_resblock,
                                               fused_upsample_stage,
                                               hifigan_apply_fused)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread each runs them in well
    under a millisecond, where a full pool of threads per worker waits on
    the others."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


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


def test_fold_weight_norm_matches_jax():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((8, 1, 1)).astype(np.float32)
    v = rng.standard_normal((8, 5, 7)).astype(np.float32)
    ref = fold_weight_norm(g, v)
    out = t_fold(torch.from_numpy(g), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def _random_tree(shapes, seed):
    """Random weights for a JAX parameter tree of these shapes, without
    compiling an init: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.05),
    biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            scale = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        else:
            scale = 0.05 if name == "scale" else 0.1
        x = scale * rng.standard_normal(s.shape)
        return (x + (name == "scale")).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _resblock_params(C, k, dils, seed=0):
    shapes = jax.eval_shape(ResBlock1(C, k, dils).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, C)))
    return _random_tree(shapes, seed)


@pytest.mark.parametrize("C,k,dils,T,tile", [
    (16, 3, (1, 3, 5), 700, 256),   # tests/test_pallas_vocoder.py's cases
    (16, 11, (1, 3, 5), 200, 128),
    (32, 7, (1, 3, 5), 96, 96),
    (16, 3, (1, 2), 130, 64),
    (24, 3, (1, 3, 5), 130, 64),    # 128 % C != 0: the unpacked kernel
    (64, 3, (1, 3, 5), 96, 32),
    (96, 7, (1, 3, 5), 150, 64),    # the odd-width path's widest stage
    (128, 11, (1, 3, 5), 140, 64),  # V1's C=128 resblock shape
])
def test_fused_resblock_plain_matches_pallas(C, k, dils, T, tile):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    w = _stack_resblock_weights(_resblock_params(C, k, dils)["params"],
                                len(dils))
    ref = np.asarray(jax.jit(lambda x, *w: j_resblock(
        x, *w, kernel_size=k, dilations=dils, compute_dtype=jnp.float32,
        tile=tile, interpret=True))(jnp.asarray(x), *w))
    block = tuple(torch.tensor(np.asarray(a)) for a in w) + (k, dils)
    out = fused_resblock_plain(torch.from_numpy(x), block,
                               compute_dtype=torch.float32).numpy()
    assert out.shape == ref.shape == (2, T, C)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # on a CPU tensor the kernel wrapper runs the plain version
    launches = fused_resblock.launches
    np.testing.assert_array_equal(
        fused_resblock(torch.from_numpy(x), block,
                       compute_dtype=torch.float32).numpy(), out)
    assert fused_resblock.launches == launches


def test_fused_resblock_plain_edge_zero_padding():
    """The sequence edges see zeros at every conv: the first and last H
    frames against JAX (tests/test_pallas_vocoder.py's edge case)."""
    rng = np.random.default_rng(1)
    C, k, dils, T = 8, 3, (1, 3, 5), 64
    H = (k - 1) // 2 * sum(d + 1 for d in dils)
    x = rng.standard_normal((1, T, C)).astype(np.float32)
    p = _resblock_params(C, k, dils, seed=2)
    w = _stack_resblock_weights(p["params"], len(dils))
    ref = np.asarray(jax.jit(ResBlock1(C, k, dils).apply)(p, jnp.asarray(x)))
    block = tuple(torch.tensor(np.asarray(a)) for a in w) + (k, dils)
    out = fused_resblock_plain(torch.from_numpy(x), block,
                               compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(out[0, :H], ref[0, :H], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[0, -H:], ref[0, -H:], rtol=1e-5, atol=1e-5)


# init 48: widths 24 -> 12, each stage's resblocks through fused_resblock
# (JAX's `_resblock_kernel`) twice; init 32: widths 16 -> 8, the grouped
# stage kernel at C=16 and the whole-stage kernel at C=8 (V2's widths)
ODD = dict(upsample_initial_channel=48, upsample_rates=(4, 2),
           upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 5),
           resblock_dilations=((1, 2), (2, 6)))
V2_SHAPED = dict(ODD, upsample_initial_channel=32)


@pytest.mark.parametrize("geom", [ODD, V2_SHAPED], ids=["odd", "v2_shaped"])
def test_hifigan_apply_fused_matches_jax_narrow_widths(geom):
    cfg = HiFiGANConfig(**geom)
    mel = np.random.default_rng(3).standard_normal((2, 20, 80)).astype(
        np.float32)
    params = _random_tree(jax.eval_shape(
        HiFiGANGenerator(cfg).init, jax.random.PRNGKey(4), jnp.asarray(mel)),
        seed=4)
    ref = np.asarray(jax.jit(lambda p, m: hifigan_apply_fused(
        p, m, cfg, compute_dtype=jnp.float32, interpret=True))(
            params, jnp.asarray(mel)))
    tgen = TGenerator(THiFiGANConfig(**geom))
    load_hifigan(tgen, params)
    with torch.no_grad():
        out = t_apply_fused(tgen, torch.from_numpy(mel),
                            compute_dtype=torch.float32).numpy()
    assert out.shape == ref.shape == (2, 20 * 8)
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_stage_channel_padding_is_exact():
    """The stage kernel's wrapper pads C < 32 to 32 (and C_in = 2C to 64):
    the padded stage's first C channels are the stage (plain versions)."""
    rng = np.random.default_rng(5)
    for C_in, C, ups in ((16, 8, True), (32, 16, True), (16, 16, False)):
        x = torch.from_numpy(rng.standard_normal((2, 37, C_in)).astype(
            np.float32))
        args = (x,) + tuple(None if a is None else torch.from_numpy(a)
                            for a in _stage_weights(rng, C_in, C, ups)[:2])
        blocks = [tuple(torch.from_numpy(a) for a in b[:4]) + b[4:]
                  for b in _stage_weights(rng, C_in, C, ups)[2]]
        padded = pad_stage(*args, blocks, 32)
        assert padded[0].shape[-1] == (64 if ups else 32)
        for cdt in (torch.float32, torch.bfloat16):
            ref = vocoder_stage_plain(*args, blocks, compute_dtype=cdt)
            out = vocoder_stage_plain(*padded, compute_dtype=cdt)
            assert out.shape[-1] == 32
            torch.testing.assert_close(out[..., :C], ref, rtol=1e-6,
                                       atol=1e-6)
            assert out[..., C:].abs().max() == 0


def test_resblock_kernel_domain_and_plan():
    """The resblock kernel's limits raise ValueError naming the limit
    (checked before any launch), and its plan: the kernel width, k
    padding, N split, window and tile each width gets at k=11, dilations
    1/3/5."""
    def block(C, k=3, dils=(1, 3, 5)):
        n = len(dils)
        return (torch.zeros(n, k, C, C), torch.zeros(n, C),
                torch.zeros(n, k, C, C), torch.zeros(n, C), k, dils)

    x = torch.zeros(1, 40, 96)
    _check_resblock(x, block(96), torch.bfloat16)
    for args, match in (((torch.zeros(1, 4, 300), block(300)), "C <= 256"),
                        ((x, block(96, k=13)), "k <= 11"),
                        ((x, block(96, k=4)), "odd k"),
                        ((x, block(96, dils=(1, 2, 3, 4, 5))), "dilations"),
                        ((x, block(96, dils=(1, 0))), "dilations"),
                        ((x.half(), block(96)), "float32/bfloat16"),
                        ((x, block(48)), r"\[n_d, k, C, C\]")):
        with pytest.raises(ValueError, match=match):
            _check_resblock(*args, torch.bfloat16)
    plans = {C: resblock_plan(C, 11, (1, 3, 5), 10 ** 6)
             for C in (12, 24, 48, 96, 128, 192, 256)}
    assert {C: (p.width, p.kpad, p.split, p.Lp, p.tile)
            for C, p in plans.items()} == {
        12: (16, 16, 16, 1536, 1416), 24: (24, 32, 24, 1024, 904),
        48: (48, 48, 48, 512, 392), 96: (96, 96, 96, 256, 136),
        128: (128, 128, 64, 256, 136), 192: (192, 192, 96, 128, 8),
        256: (256, 256, 64, 128, 8)}
    assert simt_plan(24, 3, (1, 3, 5), 10 ** 6)[:3] == (24, 1162, 1138)
    p = resblock_plan(96, 3, (1, 3, 5), 70)
    assert (p.Lp, p.tile) == (128, 104)
    with pytest.raises(ValueError, match="halo"):
        resblock_plan(256, 11, (1, 9, 11, 13), 100)


@pytest.fixture(scope="module")
def jax_angle():
    """JAX griffin_lim's initial phase for a [*, T, bins] magnitude."""
    def draw(T, bins):
        return np.asarray(jax.random.uniform(
            jax.random.PRNGKey(0), (1, T, bins), minval=-np.pi,
            maxval=np.pi))
    return draw


def _close_to_scale(out, ref, tol=1e-5):
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) < tol * np.abs(ref).max(), \
        np.max(np.abs(out - ref)) / np.abs(ref).max()


def test_istft_and_griffin_lim_match_jax(jax_angle):
    rng = np.random.default_rng(6)
    re, im = (rng.standard_normal((2, 9, 129)).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(_istft(jnp.asarray(re), jnp.asarray(im), 256, 64, 500))
    out = t_istft(torch.from_numpy(re), torch.from_numpy(im), 256, 64,
                  500).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    t = np.arange(4096) / 16000
    wav = (0.5 * np.sin(2 * np.pi * 440 * t)[None]
           + 0.05 * rng.standard_normal((2, 4096))).astype(np.float32)
    from audio_calm_tpu.ops.mel import stft_power

    mag = np.asarray(stft_power(jnp.asarray(wav), 256, 64, power=1.0))
    ref = np.asarray(griffin_lim(jnp.asarray(mag), 256, 64, n_iter=8))
    out = t_griffin_lim(torch.from_numpy(mag), 256, 64, n_iter=8,
                        angle=torch.from_numpy(jax_angle(*mag.shape[1:])))
    assert out.shape == (2, mag.shape[1] * 64)
    _close_to_scale(out.numpy(), ref, tol=1e-4)
    # without `angle`: a seeded CPU draw, the same on every call
    a = t_griffin_lim(torch.from_numpy(mag), 256, 64, n_iter=2)
    b = t_griffin_lim(torch.from_numpy(mag), 256, 64, n_iter=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_griffin_lim_vocoder_matches_jax(jax_angle):
    rng = np.random.default_rng(7)
    log_mel = (rng.standard_normal((2, 12, 80)) - 4.0).astype(np.float32)
    ref = np.asarray(GriffinLimVocoder(n_iter=4)(jnp.asarray(log_mel)))
    voc = TGriffinLim(n_iter=4, device="cpu")
    np.testing.assert_array_equal(voc.inv_fb.numpy(),
                                  np.asarray(GriffinLimVocoder().inv_fb))
    out = voc(torch.from_numpy(log_mel),
              angle=torch.from_numpy(jax_angle(12, 513))).numpy()
    assert out.shape == (2, 12 * 256)
    _close_to_scale(out, ref)


def test_griffin_lim_renderer_matches_jax(jax_angle):
    """make_renderer with the Griffin-Lim vocoder: the masked decode, the
    masked mel grid, GL over it, cut to n frames; solo and batched."""
    geom = dict(hidden_channels=16, latent_channels=4, norm_num_groups=4)
    cfg = VAEModelConfig(**geom)
    vae = AcousticVAE(cfg)
    params = _random_tree(jax.eval_shape(lambda: vae.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, 80)), train=False)), seed=0)
    render = make_renderer(vae, params, cfg, GriffinLimVocoder(n_iter=4))
    tvae = TVAE(TVAEConfig(**geom)).eval()
    load_vae(tvae, params)
    voc = TGriffinLim(n_iter=4, device="cpu")
    angle = torch.from_numpy(jax_angle(4 * 16, 513))
    voc.forward = lambda m, _f=voc.forward: _f(m, angle=angle)
    trender = t_make_renderer(tvae, TVAEConfig(**geom), voc, device="cpu")
    lat = np.random.default_rng(0).standard_normal((2, 16, 4)).astype(
        np.float32)
    ref = render(lat[0], 10)
    out = trender(lat[0], 10)
    assert out.shape == ref.shape == (10 * 1024,)
    _close_to_scale(out, ref)
    for o, r in zip(trender.batch(lat, [10, 7]), render.batch(lat, [10, 7])):
        assert np.isfinite(o).all()
        _close_to_scale(o, r)

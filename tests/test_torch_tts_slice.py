"""The whole text -> waveform TTS slice of the PyTorch port vs the JAX
package at a tiny size, on the CPU: text ids -> tts_encode -> num_frames
-> tts_decode(x_init) -> render / render.batch, on the same carried-across
weights and the same ODE noise.

Bounds: predicted num_frames and the alignment are integers and must be
identical. Latents 1e-3: a 2-layer LLM, then 8 evaluations of a perturbed
2-layer DiT under CFG 2.5 (which amplifies the conditional/unconditional
difference 2.5x), all fp32 summed in another order. Waveform 5e-3, the
JAX package's bf16 vocoder bound: JAX's fused vocoder
(HiFiGANVocoder(fused=True)) feeds bf16 operands to its stage kernels, and
the port's vocoder does the same; a last-bit difference in the fp32 mel
can round an operand the other way."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_calm_torch
from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import HiFiGANConfig as THiFiGANConfig
from audio_calm_torch.config import VAEModelConfig as TVAEConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.eval import infer as tinfer
from audio_calm_torch.eval.render import make_renderer as t_make_renderer
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import load_calm, load_hifigan, load_vae
from audio_calm_torch.models.vae import AcousticVAE as TVAE
from audio_calm_torch.models.vocoder import HiFiGANGenerator as TGenerator
from audio_calm_torch.models.vocoder import HiFiGANVocoder as TVocoder
from audio_calm_tpu.config import (CALMModelConfig, LoRAConfig, Qwen2Config,
                                   VAEModelConfig)
from audio_calm_tpu.eval.infer import tts_decode, tts_encode
from audio_calm_tpu.eval.render import make_renderer
from audio_calm_tpu.models.calm import QwenCALM
from audio_calm_tpu.models.vae import AcousticVAE
from audio_calm_tpu.models.vocoder import (HiFiGANConfig, HiFiGANGenerator,
                                           HiFiGANVocoder)

T_AUD = 16
STEPS, CFG, METHOD = 4, 2.5, "midpoint"
VAE_GEOM = dict(hidden_channels=32, latent_channels=8, norm_num_groups=4)
# V1 rates (8,8,2,2: 256 samples per mel frame) at narrow widths with two
# small resblocks per stage; every stage goes through the stage kernel's
# function on both sides
HIFI_GEOM = dict(upsample_initial_channel=64, resblock_kernel_sizes=(3, 5),
                 resblock_dilations=((1, 2), (2, 6)))


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32), tree)


@pytest.fixture(scope="module")
def slice_models():
    rng = np.random.default_rng(0)
    cfg = CALMModelConfig(
        latent_dim=8, max_audio_len=T_AUD, max_text_len=12,
        tts_flow_hidden_dim=32, tts_flow_num_layers=2, flow_num_heads=4,
        qwen=Qwen2Config.tiny(vocab_size=256),
        lora=LoRAConfig(rank=2, alpha=4.0, dropout=0.0),
        latent_mean=0.1, latent_std=1.2,
    )
    model = QwenCALM(cfg, dtype=jnp.float32)
    ids = jnp.zeros((1, 6), jnp.int32)
    init = jax.jit(lambda r: model.init(
        {"params": r, "flow": jax.random.fold_in(r, 1)}, ids,
        jnp.ones_like(ids), jnp.zeros((1, T_AUD, 8)),
        jnp.ones((1, T_AUD), jnp.int32), train=False,
        method=QwenCALM.forward_tts))
    params = {"params": _perturb(init(jax.random.PRNGKey(0))["params"], rng)}

    vcfg = VAEModelConfig(**VAE_GEOM)
    vae = AcousticVAE(vcfg)
    vae_params = {"params": _perturb(vae.init(
        {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)},
        jnp.zeros((1, 16, 80)), train=False)["params"], rng)}
    hcfg = HiFiGANConfig(**HIFI_GEOM)
    gen_params = jax.jit(HiFiGANGenerator(hcfg).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 80)))["params"]
    renderer = make_renderer(vae, vae_params, vcfg,
                             HiFiGANVocoder(gen_params, hcfg, fused=True))

    import dataclasses

    tmodel = TQwenCALM(from_dict(TCALMConfig, dataclasses.asdict(cfg))).eval()
    load_calm(tmodel, params)
    tvcfg = TVAEConfig(**VAE_GEOM)
    tvae = TVAE(tvcfg).eval()
    load_vae(tvae, vae_params)
    tgen = TGenerator(THiFiGANConfig(**HIFI_GEOM)).eval()
    load_hifigan(tgen, gen_params)
    trenderer = t_make_renderer(tvae, tvcfg, TVocoder(tgen), device="cpu")
    return (model, params, renderer), (tmodel, trenderer)


def _inputs():
    ids = np.array([[11, 23, 5, 77, 41, 9], [3, 8, 130, 64, 0, 0]], np.int32)
    mask = np.array([[1] * 6, [1, 1, 1, 1, 0, 0]], np.int32)
    x0 = np.random.default_rng(5).standard_normal((2, T_AUD, 8)).astype(
        np.float32)
    return ids, mask, x0


def test_tts_slice_matches_jax(slice_models):
    (model, params, renderer), (tmodel, trenderer) = slice_models
    ids, mask, x0 = _inputs()
    nf_fixed = np.array([12, 9], np.int32)

    cv, ctx, pad, nf = tts_encode(model, params, jnp.asarray(ids),
                                  jnp.asarray(mask))
    lat = np.asarray(tts_decode(model, params, cv, ctx, pad,
                                jnp.asarray(nf_fixed), None, steps=STEPS,
                                cfg_scale=CFG, t_aud=T_AUD, method=METHOD,
                                x_init=jnp.asarray(x0)))
    tcv, tctx, tpad, tnf = tinfer.tts_encode(
        tmodel, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_array_equal(tnf.numpy(), np.asarray(nf))
    tlat = tinfer.tts_decode(tmodel, tcv, tctx, tpad,
                             torch.from_numpy(nf_fixed), steps=STEPS,
                             cfg_scale=CFG, t_aud=T_AUD, method=METHOD,
                             x_init=torch.from_numpy(x0)).numpy()
    assert tlat.shape == lat.shape == (2, T_AUD, 8)
    assert np.max(np.abs(tlat - lat)) < 1e-3

    wavs = renderer.batch(lat, nf_fixed)  # B=2
    twavs = trenderer.batch(tlat, nf_fixed)
    for w, tw, n in zip(wavs, twavs, nf_fixed):
        assert tw.shape == w.shape == (n * 1024,)
        assert np.isfinite(tw).all()
        assert np.max(np.abs(tw - w)) < 5e-3
    # a batched row is the row rendered solo, up to the bf16 bound (the
    # batched fp32 convolutions may sum in another order)
    twav = trenderer(tlat[1], 9)
    assert twav.shape == (9 * 1024,)
    assert np.max(np.abs(twavs[1] - twav)) < 5e-3


def test_tts_generate_latents_entry_point(slice_models):
    """The port's one-call entry point == the JAX encode -> override ->
    decode chain."""
    (model, params, _), (tmodel, trenderer) = slice_models
    ids, mask, x0 = _inputs()
    cv, ctx, pad, nf = tts_encode(model, params, jnp.asarray(ids),
                                  jnp.asarray(mask))
    nf = jnp.full_like(nf, 10)
    lat = np.asarray(tts_decode(model, params, cv, ctx, pad, nf, None,
                                steps=STEPS, cfg_scale=CFG, t_aud=T_AUD,
                                method=METHOD, x_init=jnp.asarray(x0)))
    tlat, tnf = tinfer.tts_generate_latents(
        tmodel, ids, mask, steps=STEPS, cfg_scale=CFG, t_aud=T_AUD,
        num_frames_override=10, method=METHOD, x_init=torch.from_numpy(x0),
        device="cpu")
    np.testing.assert_array_equal(tnf.numpy(), [10, 10])
    assert np.max(np.abs(tlat.numpy() - lat)) < 1e-3
    wavs = trenderer.batch(tlat.numpy()[:1].repeat(3, 0), [10, 7, 4])  # B=3 -> 4
    assert [w.shape[0] for w in wavs] == [10240, 7168, 4096]
    # noise from a seeded generator when no x_init is given: reproducible
    a, _ = tinfer.tts_generate_latents(
        tmodel, ids, mask, torch.Generator().manual_seed(3), steps=2,
        t_aud=T_AUD, device="cpu")
    b, _ = tinfer.tts_generate_latents(
        tmodel, ids, mask, torch.Generator().manual_seed(3), steps=2,
        t_aud=T_AUD, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_entry_points_default_to_the_card(slice_models, monkeypatch):
    """Without `device`, the entry points run on the card, and raise when
    there is none (no hidden CPU fallback)."""
    _, (tmodel, _) = slice_models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ids, mask, _ = _inputs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinfer.tts_generate_latents(tmodel, ids, mask)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_make_renderer(None, None, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        audio_calm_torch.resolve_device()


def test_port_imports_neither_jax_nor_the_jax_package():
    pkg = Path(audio_calm_torch.__file__).parent
    modules = sorted(
        "audio_calm_torch." + ".".join(p.relative_to(pkg).with_suffix("")
                                       .parts).replace(".__init__", "")
        for p in pkg.rglob("*.py"))
    # the training, vocoder, serving and checkpoint slices' modules and the
    # kernel wrappers are covered
    for name in ("train.optim", "train.steps", "train.loop", "ops.mas",
                 "ops.flow", "ops.dropout", "ops.attention_kernel",
                 "ops.cuda_build", "ops.mel", "ops.vocoder_kernel",
                 "models.vocoder", "eval.reconstruct", "serving.frontend",
                 "data.tokenizer", "config", "serving.batcher",
                 "serving.stats", "serving.wav_stream", "serving.server",
                 "models.convert_export", "models.quant",
                 "train.checkpoint", "train.train_calm", "data.datasets",
                 "data.collator", "data.prefetch", "data.synth_corpus",
                 "utils.profiling", "ops.gemm_kernel", "data.preprocess",
                 "data.process_dataset", "data.convert_store",
                 "eval.metrics", "eval.e2e_demo"):
        assert f"audio_calm_torch.{name}" in modules, name
    from audio_calm_torch.ops import cuda_build
    for src in cuda_build.SOURCES:
        assert (pkg / "csrc" / f"{src}.cu").exists(), src
    assert {"attention_bwd", "resblock", "gemm"} <= set(cuda_build.SOURCES)
    code = ("import sys\n"
            + "".join(f"import {m.removesuffix('.__init__')}\n"
                      for m in modules)
            # the card's machine has no PyYAML: the port reads YAML itself
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'orbax', 'audio_calm_tpu', "
              "'audio_calm_native', 'yaml')]\n"
              "print(len(bad), bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=pkg.parent, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("0 "), res.stdout
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|orbax|audio_calm_tpu|"
        r"audio_calm_native|yaml)\b",
        re.M)
    for path in list(pkg.rglob("*.py")) + [pkg.parent / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path

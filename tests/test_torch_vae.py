"""The port's VAE (audio_calm_torch.models.vae: masked encode and decode,
pad_to_stride) and its reconstruction loop (eval/reconstruct.py) vs the
JAX package's AcousticVAE and the loop of scripts/eval_vae.py, fp32 on the
CPU.

Bounds: 2e-4 against JAX (PARITY.md's VAE bound: seven convs and five
GroupNorms in fp32, summed in another order); 1e-4 for grid invariance
(the JAX package's own masked-decode equivalence bound, tests/test_vae.py;
masked encode: rtol 1e-4, atol 1e-5 as there); pad_to_stride exact; the
reconstruction statistics 1e-4 relative (means of the same fp32
tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import VAEModelConfig as TVAEConfig
from audio_calm_torch.eval.reconstruct import reconstruct
from audio_calm_torch.models.convert import load_vae
from audio_calm_torch.models.vae import AcousticVAE as TVAE
from audio_calm_torch.models.vae import denormalize_mel as t_denorm
from audio_calm_torch.models.vae import normalize_mel as t_norm
from audio_calm_torch.models.vae import pad_to_stride as t_pad_to_stride
from audio_calm_torch.models.vocoder import GriffinLimVocoder as TGriffinLim
from audio_calm_tpu.config import VAEModelConfig
from audio_calm_tpu.models.vae import (AcousticVAE, denormalize_mel,
                                       normalize_mel, pad_to_stride)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread each runs them in well
    under a millisecond, where a full pool of threads per worker waits on
    the others."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


GEOM = dict(hidden_channels=32, latent_channels=8, norm_num_groups=4)


@pytest.fixture(scope="module")
def vae():
    cfg = VAEModelConfig(**GEOM)
    m = AcousticVAE(cfg)
    rng = np.random.default_rng(0)
    params = m.init({"params": jax.random.PRNGKey(0),
                     "noise": jax.random.PRNGKey(1)},
                    jnp.zeros((1, 16, 80)), train=False)["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    tcfg = TVAEConfig(**GEOM)
    tm = TVAE(tcfg).eval()
    load_vae(tm, params)
    return m, {"params": params}, tm, cfg, tcfg


def _latents_and_mask(B=2, T=12, lengths=(12, 7), seed=1):
    z = np.random.default_rng(seed).standard_normal((B, T, 8)).astype(
        np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None])[..., None]
    return z, mask.astype(np.float32)


def test_masked_decode_matches_jax(vae):
    m, params, tm, cfg, tcfg = vae
    z, mask = _latents_and_mask()
    ref = np.asarray(denormalize_mel(
        m.apply(params, z, mask, method=AcousticVAE.decode), cfg))
    with torch.no_grad():
        out = t_denorm(tm.decode(torch.from_numpy(z), torch.from_numpy(mask)),
                       tcfg).numpy()
    assert out.shape == ref.shape == (2, 48, 80)
    valid = np.repeat(mask, 4, axis=1)[..., 0] > 0
    assert np.max(np.abs(out[valid] - ref[valid])) < 2e-4
    # unmasked decode too
    ref = np.asarray(m.apply(params, z, method=AcousticVAE.decode))
    with torch.no_grad():
        out = tm.decode(torch.from_numpy(z)).numpy()
    assert np.max(np.abs(out - ref)) < 2e-4


def test_masked_decode_is_grid_invariant(vae):
    """Valid frames of a padded grid == the exact-length decode."""
    _, _, tm, _, _ = vae
    z, mask = _latents_and_mask(B=1, T=12, lengths=(7,))
    z[:, 7:] = 5.0  # padding garbage must not leak into valid frames
    with torch.no_grad():
        padded = tm.decode(torch.from_numpy(z), torch.from_numpy(mask))
        exact = tm.decode(torch.from_numpy(z[:, :7]))
    np.testing.assert_allclose(padded[:, :28].numpy(), exact.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_masked_encode_matches_jax(vae):
    m, params, tm, cfg, tcfg = vae
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((2, 48, 80)).astype(np.float32)
    mask = (np.arange(48)[None, :] < np.array([48, 28])[:, None])[..., None]
    for args in ((mel,), (mel, mask.astype(np.float32))):
        ref = m.apply(params, *[jnp.asarray(a) for a in args],
                      method=AcousticVAE.encode)
        with torch.no_grad():
            out = tm.encode(*[torch.from_numpy(a) for a in args])
        for o, r in zip(out, ref):
            r = np.asarray(r)
            assert o.shape == r.shape == (2, 12, 8)
            valid = (np.arange(12)[None, :] < np.array([12, 7])[:, None]
                     if len(args) == 2 else np.ones((2, 12), bool))
            assert np.max(np.abs(o.numpy()[valid] - r[valid])) < 2e-4


def test_masked_encode_is_length_invariant(vae):
    """A padded row, masked, encodes as the exact-length tensor does
    (tests/test_vae.py's contract; lengths multiples of the stride)."""
    _, _, tm, _, _ = vae
    rng = np.random.default_rng(0)
    for T in (48, 44, 24, 8):
        mel = rng.standard_normal((1, T, 80)).astype(np.float32)
        buf = np.full((1, 48, 80), 3.0, np.float32)  # garbage padding
        buf[:, :T] = mel
        mask = (np.arange(48) < T)[None, :, None].astype(np.float32)
        with torch.no_grad():
            exact = tm.encode(torch.from_numpy(mel))
            masked = tm.encode(torch.from_numpy(buf), torch.from_numpy(mask))
        for a, b in zip(masked, exact):
            np.testing.assert_allclose(a[:, : T // 4].numpy(), b.numpy(),
                                       rtol=1e-4, atol=1e-5)
    mu, lv = exact
    assert tm.reparameterize(mu, lv) is mu
    # train mode samples mu + eps * exp(logvar / 2), eps from the generator,
    # then latent dropout (tests/test_torch_vae_train.py holds it against
    # JAX)
    z = tm.reparameterize(mu, lv, train=True,
                          generator=torch.Generator().manual_seed(0))
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(0))
    kept = z != 0
    rate = tm.cfg.latent_dropout
    torch.testing.assert_close(
        z[kept], ((mu + eps * torch.exp(0.5 * lv)) / (1 - rate))[kept])


def test_pad_to_stride_and_normalize_match_jax(vae):
    _, _, _, cfg, tcfg = vae
    rng = np.random.default_rng(3)
    for T in (61, 64, 2, 1):
        mel = rng.standard_normal((2, T, 5)).astype(np.float32)
        ref = np.asarray(pad_to_stride(jnp.asarray(mel), 4))
        out = t_pad_to_stride(torch.from_numpy(mel), 4).numpy()
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(
        t_norm(torch.from_numpy(mel), tcfg).numpy(),
        np.asarray(normalize_mel(jnp.asarray(mel), cfg)), rtol=1e-6)


def test_reconstruct_matches_eval_vae_loop(vae):
    """eval/reconstruct on the same weights and mels as the loop of
    scripts/eval_vae.py (AcousticVAE.__call__(train=False) per utterance,
    then the statistics it prints), plus Griffin-Lim renders of both."""
    m, params, tm, cfg, _ = vae
    rng = np.random.default_rng(4)
    mels = [(3.0 * rng.standard_normal((T, 80)) - 6.0).astype(np.float32)
            for T in (30, 16)]
    stats = {k: [] for k in ("mse", "l1", "kl_mean", "mu_std", "var_mean")}
    refs = []
    for mel in mels:
        x = pad_to_stride(jnp.asarray(mel)[None], cfg.total_stride)
        out = m.apply(params, x, train=False)
        recon, orig = np.asarray(out["recon_mel"])[0], np.asarray(x)[0]
        stats["mse"].append(float(np.mean((recon - orig) ** 2)))
        stats["l1"].append(float(np.mean(np.abs(recon - orig))))
        stats["kl_mean"].append(float(out["kl_loss"]))
        stats["mu_std"].append(float(jnp.std(out["mu"])))
        stats["var_mean"].append(float(jnp.mean(jnp.exp(out["logvar"]))))
        refs.append((orig, recon, np.asarray(out["mu"])[0]))
    res = reconstruct(tm, mels, device="cpu",
                      vocoder=TGriffinLim(n_iter=2, device="cpu"))
    for k, v in stats.items():
        assert abs(res[k] - np.mean(v)) <= 1e-4 * abs(np.mean(v)), k
    for (o, r), mu, (ro, rr, rmu) in zip(res["recons"], res["mu"], refs):
        np.testing.assert_array_equal(o, ro)  # the padded input itself
        assert np.max(np.abs(r - rr)) < 2e-4
        assert mu.shape == rmu.shape and np.max(np.abs(mu - rmu)) < 2e-4
    assert [w.shape for pair in res["wavs"] for w in pair] == [
        (32 * 256,)] * 2 + [(16 * 256,)] * 2
    assert all(np.isfinite(w).all() for pair in res["wavs"] for w in pair)

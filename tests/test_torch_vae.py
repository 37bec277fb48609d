"""The port's masked VAE decode (audio_calm_torch.models.vae) vs the JAX
package's AcousticVAE.decode, fp32 on the CPU.

Bounds: 2e-4 against JAX (PARITY.md's VAE bound: seven convs and five
GroupNorms in fp32, summed in another order); 1e-4 for grid invariance
(the JAX package's own masked-decode equivalence bound, tests/test_vae.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import VAEModelConfig as TVAEConfig
from audio_calm_torch.models.convert import load_vae
from audio_calm_torch.models.vae import AcousticVAE as TVAE
from audio_calm_torch.models.vae import denormalize_mel as t_denorm
from audio_calm_tpu.config import VAEModelConfig
from audio_calm_tpu.models.vae import AcousticVAE, denormalize_mel

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

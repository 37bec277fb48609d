"""PyTorch port primitives (audio_calm_torch.models.layers) vs the JAX
package's flax layers, on the same carried-across weights, fp32 on the CPU.

Bound 1e-5: one conv / norm in fp32 on both sides; the only difference is
the order of the fp32 sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.models import layers as tl
from audio_calm_torch.models.convert import from_jax_params
from audio_calm_tpu.models import layers as jl

TOL = 1e-5


def _perturbed(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32), params)


@pytest.mark.parametrize("k,stride,pad,dil", [(3, 1, 1, 1), (7, 1, 9, 3),
                                              (4, 2, 1, 1)])
def test_conv1d_matches_flax(k, stride, pad, dil):
    x = np.random.default_rng(0).standard_normal((2, 37, 6)).astype(np.float32)
    m = jl.Conv1d(5, k, stride=stride, padding=pad, dilation=dil)
    params = m.init(jax.random.PRNGKey(0), x)["params"]
    ref = np.asarray(m.apply({"params": params}, x))
    conv = tl.Conv1d(6, 5, k, stride=stride, padding=pad, dilation=dil)
    conv.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        out = conv(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("stride,k", [(2, 4), (8, 16)])
def test_conv_transpose1d_matches_flax(stride, k):
    x = np.random.default_rng(1).standard_normal((2, 13, 6)).astype(np.float32)
    pad = (k - stride) // 2
    m = jl.ConvTranspose1d(5, k, stride=stride, padding=pad)
    params = _perturbed(m.init(jax.random.PRNGKey(1), x)["params"], 1)
    ref = np.asarray(m.apply({"params": params}, x))
    conv = tl.ConvTranspose1d(6, 5, k, stride=stride, padding=pad)
    conv.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        out = conv(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 13 * stride, 5)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_group_norm_matches_flax(masked):
    rng = np.random.default_rng(2)
    x = (3.0 + 2.0 * rng.standard_normal((3, 20, 16))).astype(np.float32)
    lengths = np.array([20, 13, 7])  # ragged valid lengths
    mask = (np.arange(20)[None, :] < lengths[:, None])[..., None]
    m = jl.GroupNorm(4)
    params = _perturbed(m.init(jax.random.PRNGKey(2), x)["params"], 2)
    jmask = jnp.asarray(mask) if masked else None
    ref = np.asarray(m.apply({"params": params}, x, jmask))
    gn = tl.GroupNorm(4, 16)
    gn.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        out = gn(torch.from_numpy(x),
                 torch.from_numpy(mask) if masked else None).numpy()
    if masked:  # flax leaves the statistics of padded frames undefined
        out, ref = out * mask, ref * mask
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_gelu_is_exact_erf():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    ref = np.asarray(jl.gelu(jnp.asarray(x)))
    out = tl.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)

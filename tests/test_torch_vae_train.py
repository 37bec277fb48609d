"""VAE training in the PyTorch port vs the JAX package, fp32 on the CPU at a
narrow width (hidden 32, latent 8, 8 groups): `ssim_loss`,
`multires_stft_loss`, `AcousticVAE.forward` (its loss terms and outputs),
`vae_param_label` and one `make_vae_step` update.

Bounds, each with its reason:
  - ssim_loss: rtol 1e-5, atol 1e-6 (the same separable fp32 blurs, summed
    in another order).
  - multires_stft_loss: rtol 1e-5 (the same matmul DFT basis, fp32).
  - forward's loss terms and outputs, eval mode and train mode with JAX's
    eps injected: 1e-5 of each tensor's largest value (seven convs and
    five GroupNorms in fp32, summed in another order; eps is recovered as
    (z - mu) / exp(logvar / 2) from JAX's own outputs).
  - one make_vae_step update: metrics and every parameter after the
    update within 2e-4 of the tensor's largest value (the bound of
    tests/test_torch_train_tts.py for a step through fp32 convolutions),
    under the AdamW of both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from audio_calm_torch.config import TrainingConfig as TTrainingConfig
from audio_calm_torch.config import VAEModelConfig as TVAEConfig
from audio_calm_torch.models.convert import (from_jax_params, jax_path,
                                             to_jax_params)
from audio_calm_torch.models.vae import AcousticVAE as TVAE
from audio_calm_torch.models.vae import init_vae_
from audio_calm_torch.models.vae import multires_stft_loss as t_stft_loss
from audio_calm_torch.ops.ssim import ssim_loss as t_ssim
from audio_calm_torch.train import optim as toptim
from audio_calm_torch.train.steps import make_vae_step
from audio_calm_tpu.config import TrainingConfig, VAEModelConfig
from audio_calm_tpu.models.vae import AcousticVAE, multires_stft_loss
from audio_calm_tpu.ops.ssim import ssim_loss
from audio_calm_tpu.train.optim import make_optimizer, vae_param_label
from audio_calm_tpu.train.steps import init_train_state
from audio_calm_tpu.train.steps import make_vae_step as j_make_vae_step

GEOM = dict(hidden_channels=32, latent_channels=8, norm_num_groups=8)
B, T = 3, 64


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread each (see tests/test_torch_vae.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _mel(seed=0, b=B, t=T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, 80)) * 3.8 - 6.5).astype(np.float32)


def _port_vae(seed=0, **overrides):
    """A port VAE with fresh weights from `seed`, its biases and GroupNorm
    parameters perturbed so every gradient is exercised."""
    vae = TVAE(TVAEConfig(**{**GEOM, **overrides}))
    init_vae_(vae, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in vae.named_parameters():
            if p.ndim == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return vae


def _jax_tree(vae):
    return {"params": to_jax_params(vae.state_dict())}


def _close(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.max(np.abs(got - ref)) if got.size else 0.0
    scale = max(np.max(np.abs(ref)) if ref.size else 0.0, 1e-12)
    assert err <= rel * scale, (what, err, scale)


# --------------------------------------------------------------------------
# the loss terms
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["mel", "image_4d", "identical"])
def test_ssim_matches_jax(case):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 80, 40)).astype(np.float32)
    b = (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    if case == "image_4d":
        a, b = a[:, None], b[:, None]
    if case == "identical":
        b = a
    ref = float(ssim_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(t_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    if case == "identical":
        assert abs(got) <= 1e-6


@pytest.mark.parametrize("t", [32, 64, 200, 256])
def test_multires_stft_loss_matches_jax(t):
    """No spec fits below 64 frames (0), one at 64, two at 128-255, all
    three from 256."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 5)).astype(np.float32)
    y = (x + 0.5 * rng.standard_normal(x.shape)).astype(np.float32)
    ref = float(multires_stft_loss(jnp.asarray(x), jnp.asarray(y)))
    got = t_stft_loss(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    if t < 64:
        assert ref == float(got) == 0.0
    else:
        assert ref > 0
        np.testing.assert_allclose(float(got), ref, rtol=1e-5)


def test_vae_param_labels_match_jax():
    vae = _port_vae()
    shapes = jax.eval_shape(lambda: AcousticVAE(VAEModelConfig(**GEOM)).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 16, 80)), train=False))["params"]
    want = {k: vae_param_label(k) for k in flatten_dict(shapes)}
    got = {jax_path(vae, n): lab for n, lab in
           toptim.param_labels(vae, toptim.vae_param_label).items()}
    assert got == want
    assert set(got.values()) == {"decay", "no_decay"}


# --------------------------------------------------------------------------
# forward and one step against JAX
# --------------------------------------------------------------------------
def _eps(out):
    """JAX's reparameterization noise, recovered from its outputs."""
    return (np.asarray(out["z"]) - np.asarray(out["mu"])) / np.exp(
        0.5 * np.asarray(out["logvar"]))


def _step_outputs(vae, tree, jmodel, apply, mel, tx, opt, rng):
    """JAX's jitted make_vae_step and the port's on the same weights and
    eps -> (JAX metrics, JAX parameters after, port metrics)."""
    state = init_train_state(flatten_dict(tree["params"]), tx)
    new_state, jm = jax.jit(j_make_vae_step(jmodel, tx))(
        state, {"mel": jnp.asarray(mel)}, rng)
    # the eps of the step's draws (its step-0 keys)
    key = jax.random.fold_in(rng, 0)
    eps = _eps(apply(tree, jnp.asarray(mel), jax.random.fold_in(key, 0),
                     jax.random.fold_in(key, 1)))
    tm = make_vae_step(vae, opt)(
        {"mel": torch.from_numpy(mel)}, eps=torch.from_numpy(eps))
    jnew = from_jax_params(unflatten_dict(
        {k: np.asarray(v) for k, v in new_state.trainable.items()}))
    return jm, jnew, tm


def test_vae_forward_and_step_match_jax():
    """Eval-mode forward; train-mode forward with JAX's eps; one step under
    AdamW (decay and no_decay groups, clipping at 1.0): its metrics
    (grad_norm included) and every parameter after the update against
    JAX's."""
    cfg = VAEModelConfig(**GEOM, latent_dropout=0.0)
    vae = _port_vae(latent_dropout=0.0)
    tree = _jax_tree(vae)
    jmodel = AcousticVAE(cfg)
    mel = _mel()
    keys = ("loss", "rec_loss", "ssim_loss", "stft_loss", "kl_loss",
            "recon_mel", "z", "mu", "logvar")

    ref = jax.jit(lambda p, m: jmodel.apply(p, m, train=False))(
        tree, jnp.asarray(mel))
    with torch.no_grad():
        got = vae(torch.from_numpy(mel), train=False)
    for k in keys:
        _close(got[k], ref[k], 1e-5, f"eval {k}")
    assert float(ref["stft_loss"]) > 0  # T = 64: one spec fits

    apply = jax.jit(lambda p, m, kn, kd: jmodel.apply(
        p, m, train=True, rngs={"noise": kn, "dropout": kd}))
    ref = apply(tree, jnp.asarray(mel), jax.random.PRNGKey(5),
                jax.random.PRNGKey(6))
    eps = _eps(ref)
    with torch.no_grad():
        got = vae(torch.from_numpy(mel), train=True,
                  eps=torch.from_numpy(eps))
    for k in keys:
        _close(got[k], ref[k], 1e-5, f"train {k}")

    # one AdamW update over vae_param_label's groups
    mkeys = ("loss", "rec_loss", "ssim_loss", "stft_loss", "kl_loss",
             "mu_std", "var_mean", "grad_norm")
    params = dict(vae.named_parameters())
    tcfg = dict(learning_rate=1e-3, lr_scheduler_type="constant",
                weight_decay=0.1, max_grad_norm=1.0)
    labels = toptim.param_labels(vae, toptim.vae_param_label)
    tx = make_optimizer(TrainingConfig(**tcfg),
                        flatten_dict(tree["params"]), vae_param_label, 10)
    opt = toptim.AdamW(params, labels, TTrainingConfig(**tcfg), 10)
    jm, jnew, tm = _step_outputs(vae, tree, jmodel, apply, _mel(1), tx,
                                 opt, jax.random.PRNGKey(8))
    for k in mkeys:
        _close(tm[k], jm[k], 2e-4, k)
    for n, p in params.items():
        _close(p.detach().numpy(), jnew[n].numpy(), 2e-4, f"adamw {n}")


# --------------------------------------------------------------------------
# the port alone
# --------------------------------------------------------------------------
def test_reparameterize_draws_and_latent_dropout():
    vae = _port_vae(latent_dropout=0.25)
    g = torch.Generator().manual_seed(0)
    mu = torch.randn(2, 16, 8, generator=g)
    logvar = 0.1 * torch.randn(2, 16, 8, generator=g)
    assert torch.equal(vae.reparameterize(mu, logvar, train=False), mu)

    def draw(seed, gen_seed):
        return vae.reparameterize(
            mu, logvar, train=True, seed=seed,
            generator=torch.Generator().manual_seed(gen_seed))

    z = draw(1, 2)
    assert torch.equal(z, draw(1, 2))
    assert not torch.equal(z, draw(1, 3)) and not torch.equal(z, draw(4, 2))
    kept = z != 0
    assert 0.6 < kept.float().mean() < 0.9
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(2))
    np.testing.assert_allclose(
        z[kept], ((mu + eps * torch.exp(0.5 * logvar)) / 0.75)[kept],
        rtol=1e-6)


def test_forward_refuses_a_length_off_the_stride():
    with pytest.raises(ValueError, match="multiple of total_stride=4"):
        _port_vae()(torch.zeros(1, 30, 80))


def test_vae_training_loss_decreases():
    """tests/test_train_steps.py::test_vae_training_loss_decreases in the
    port: 30 steps of AdamW (LR 3e-3, clipping 1.0) on one batch."""
    torch.manual_seed(0)
    vae = TVAE(TVAEConfig(hidden_channels=32, latent_channels=8,
                          norm_num_groups=4, ssim_weight=0.0,
                          stft_loss_weight=0.0))
    init_vae_(vae, 0)
    mel = torch.from_numpy(_mel(0, 8, 32))
    tcfg = TTrainingConfig(learning_rate=3e-3, warmup_ratio=0.0,
                           max_grad_norm=1.0)
    params = dict(vae.named_parameters())
    opt = toptim.AdamW(params, toptim.param_labels(
        vae, toptim.vae_param_label), tcfg, 100)
    step = make_vae_step(vae, opt, seed=42)
    losses = []
    for i in range(30):
        step.count = i
        losses.append(float(step({"mel": mel})["loss"]))
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0] * 0.9, losses


def test_init_vae_is_flax_shaped():
    """Fresh weights: GroupNorm scales 1 and biases 0, conv biases 0, conv
    kernels with variance about 1 / fan_in, one seed one draw."""
    a, b = TVAE(TVAEConfig(**GEOM)), TVAE(TVAEConfig(**GEOM))
    init_vae_(a, 3)
    init_vae_(b, 3)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    w = a.decoder.conv_in.weight  # [32, 8, 3]: fan_in 24
    assert abs(float(w.detach().var()) * 24 - 1.0) < 0.25
    assert float(w.abs().max()) <= 2.0 / np.sqrt(24) / .87962566103423978
    for n, p in a.named_parameters():
        if p.ndim == 1:
            want = 1.0 if ("norm" in n and n.endswith("weight")) else 0.0
            assert torch.all(p == want), n
    assert dataclasses.asdict(a.cfg)["norm_num_groups"] == 8

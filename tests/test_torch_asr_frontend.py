"""The port's bucketed ASR frontend (audio_calm_torch.serving.frontend:
make_asr_frontend, encode_chunks) vs the JAX package's on the same tiny
VAE weights, fp32 on the CPU; and chip_smoke.py's hand-written copy of
configs/asr.yaml vs the JAX package's load_config.

Bounds: against JAX 2e-4 (PARITY.md's VAE bound: seven convs and five
GroupNorms in fp32, summed in another order); a bucketed row against the
solo exact-length encode rtol 2e-4, atol 2e-5 (tests/test_serving_batch.py's
bound for the same contract)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import MelConfig as TMelConfig
from audio_calm_torch.config import VAEModelConfig as TVAEConfig
from audio_calm_torch.models.convert import load_vae
from audio_calm_torch.models.vae import AcousticVAE as TVAE
from audio_calm_torch.models.vae import pad_to_stride as t_pad_to_stride
from audio_calm_torch.ops.mel import MelFrontend as TMelFrontend
from audio_calm_torch.serving.frontend import encode_chunks as t_encode_chunks
from audio_calm_torch.serving.frontend import \
    make_asr_frontend as t_make_asr_frontend
from audio_calm_tpu.config import MelConfig, VAEModelConfig, load_config
from audio_calm_tpu.models.vae import AcousticVAE
from audio_calm_tpu.serving.frontend import make_asr_frontend

GEOM = dict(hidden_channels=32, latent_channels=8, norm_num_groups=8)
LAT_BUCKETS = [8, 16]
SPF = 4 * 256  # wav samples per latent frame


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread each runs them fastest."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def frontends():
    """JAX's and the port's frontend on the same random VAE weights (shapes
    traced by jax.eval_shape, values from numpy: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.05^2), biases N(0, 0.05^2))."""
    cfg = VAEModelConfig(**GEOM)
    vae = AcousticVAE(cfg)
    shapes = jax.eval_shape(lambda: vae.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, 80)), train=False))["params"]
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.05 * z if name == "scale" else 0.05 * z

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    jax_fe = make_asr_frontend(vae, {"params": params}, cfg, MelConfig(),
                               LAT_BUCKETS)
    tcfg = TVAEConfig(**GEOM)
    tvae = TVAE(tcfg).eval()
    load_vae(tvae, params)
    port_fe = t_make_asr_frontend(tvae, tcfg, TMelConfig(), LAT_BUCKETS,
                                  device="cpu")
    return jax_fe, port_fe, tvae, tcfg


def _wavs():
    """Lengths: deep inside the 8-latent bucket, near-full, an exact fit
    (the reflect tail needs room: next bucket), the second bucket, and
    over the largest grid (clamped)."""
    rng = np.random.default_rng(7)
    lens = [2500, 8 * SPF - 1024, 8 * SPF, 12000, 20 * SPF]
    return [rng.standard_normal(n).astype(np.float32) * 0.3 for n in lens]


def _exact(tvae, tcfg, wav):
    """The solo exact-length encode: peak-normalise the exact wav, its own
    log-mel, pad_to_stride, unmasked encode."""
    w = np.asarray(wav, np.float32)
    p = np.max(np.abs(w))
    if p > 0:
        w = w / (p + 1e-8) * 0.95
    mel = t_pad_to_stride(TMelFrontend(TMelConfig(), device="cpu")(w[None]),
                          tcfg.total_stride)
    with torch.no_grad():
        mu, _ = tvae.encode(mel)
    n_lat = -(-(len(w) // 256 + 1) // tcfg.total_stride)
    return mu[0, :n_lat].numpy()


def test_prep_matches_jax(frontends):
    (jprep, _), (tprep, _), _, _ = frontends
    for w in _wavs():
        jb, jpad, jn = jprep(w)
        tb, tpad, tn = tprep(w)
        assert (tb, tn) == (jb, jn)
        np.testing.assert_array_equal(tpad, jpad)
    buckets = sorted({tprep(w)[0] for w in _wavs()})
    assert buckets == [8 * SPF, 16 * SPF]


def test_bucketed_batch_matches_jax_and_solo(frontends):
    """Each bucket's batch (2 rows; 3 rows padded to 4) against JAX's
    batch, and each row against its solo exact-length encode."""
    (jprep, jbatch), (tprep, tbatch), tvae, tcfg = frontends
    groups = {}
    for w in _wavs():
        bucket, padded, n = tprep(w)
        groups.setdefault(bucket, []).append(((padded, n), w))
    assert sorted(len(g) for g in groups.values()) == [2, 3]
    for pairs in groups.values():
        items = [it for it, _ in pairs]
        ours, ref = tbatch(items), jbatch(items)
        for lat, jlat, ((_, n), w) in zip(ours, ref, pairs):
            assert lat.shape == jlat.shape == (-(-(n // 256 + 1) // 4), 8)
            assert np.max(np.abs(lat - np.asarray(jlat))) < 2e-4
            np.testing.assert_allclose(lat, _exact(tvae, tcfg, w[:n]),
                                       rtol=2e-4, atol=2e-5)


def test_encode_chunks_keeps_order(frontends):
    """encode_chunks groups by bucket and gives the latents back in input
    order, each equal to its row of its bucket's batch."""
    _, (tprep, tbatch), _, _ = frontends
    wavs = [_wavs()[i] for i in (3, 0, 2, 1)]  # buckets 16, 8, 16, 8
    out = t_encode_chunks(tprep, tbatch, wavs)
    assert [o.shape[0] for o in out] == [
        -(-(len(w) // 256 + 1) // 4) for w in wavs]
    for rows in ((0, 2), (1, 3)):
        ref = tbatch([tprep(wavs[i])[1:] for i in rows])
        for i, lat in zip(rows, ref):
            np.testing.assert_array_equal(out[i], lat)


def test_chip_smoke_asr_config_is_configs_asr_yaml():
    """chip_smoke.py writes configs/asr.yaml's model out by hand (the card's
    machine has no YAML loader); it must equal what load_config reads, the
    checkpoint paths aside."""
    from chip_smoke import ASR_BUCKETS, asr_yaml_config

    ref = load_config("configs/asr.yaml")

    def fields(cfg):
        return {k: v for k, v in dataclasses.asdict(cfg).items()
                if not k.endswith("_path")}

    assert fields(asr_yaml_config()) == fields(ref.model)
    assert ASR_BUCKETS == ref.data.audio_buckets
    assert (ref.data.max_text_len, ref.data.max_audio_len) == (96, 384)
    assert dataclasses.asdict(TMelConfig()) == dataclasses.asdict(ref.mel)
    reduced = asr_yaml_config(num_llm_layers=2)
    assert reduced.qwen.num_hidden_layers == 2
    assert fields(reduced)["qwen"] == dict(fields(ref.model)["qwen"],
                                           num_hidden_layers=2)

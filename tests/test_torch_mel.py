"""The port's log-mel frontend (audio_calm_torch.ops.mel) vs the JAX
package's (audio_calm_tpu.ops.mel), on the same numpy inputs, on the CPU.

Bounds are the JAX package's own (tests/test_mel.py): filterbank 1e-5,
Hann window 1e-6, STFT 1e-3 relative (to max(|ref|, 1e-3)), log-mel 1e-3
mean-abs. The host constants (filterbank, window, DFT basis) are the same
numpy arithmetic on both sides and must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import MelConfig as TMelConfig
from audio_calm_torch.ops import mel as tmel
from audio_calm_tpu.config import MelConfig
from audio_calm_tpu.ops import mel as jmel


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread each runs them in well
    under a millisecond, where a full pool of threads per worker waits on
    the others."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("scale", ["slaney", "htk"])
def test_mel_scale_and_filterbank_match_jax(scale):
    f = np.array([0.0, 50.0, 999.0, 1000.0, 4321.0, 8000.0])
    np.testing.assert_array_equal(tmel.hz_to_mel(f, scale),
                                  jmel.hz_to_mel(f, scale))
    m = jmel.hz_to_mel(f, scale)
    np.testing.assert_array_equal(tmel.mel_to_hz(m, scale),
                                  jmel.mel_to_hz(m, scale))
    ours = tmel.mel_filterbank(513, 80, 16000, 0.0, 8000.0, mel_scale=scale)
    ref = jmel.mel_filterbank(513, 80, 16000, 0.0, 8000.0, mel_scale=scale)
    assert ours.shape == ref.shape == (513, 80)
    assert np.max(np.abs(ours - ref)) < 1e-5


@pytest.mark.parametrize("periodic", [True, False])
def test_hann_window_and_dft_basis_match_jax(periodic):
    assert np.max(np.abs(tmel.hann_window(1024, periodic)
                         - jmel.hann_window(1024, periodic))) < 1e-6
    # a window shorter than n_fft is centered in it
    for n_fft, win in ((1024, 1024), (512, 400)):
        for a, b in zip(tmel._dft_basis(n_fft, win),
                        jmel._dft_basis(n_fft, win)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (400, 160)])
def test_frame_signal_matches_jax(n_fft, hop):
    """hop | n_fft takes the reshape path, 160 | 400 does not (gather)."""
    x = np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32)
    ours = tmel.frame_signal(torch.from_numpy(x), n_fft, hop).numpy()
    ref = np.asarray(jmel.frame_signal(jnp.asarray(x), n_fft, hop))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("power,win", [(2.0, None), (1.0, None), (2.0, 800)])
def test_stft_power_matches_jax(power, win):
    wav = np.random.default_rng(1).standard_normal((2, 8000)).astype(
        np.float32)
    ours = tmel.stft_power(torch.from_numpy(wav), 1024, 256, win,
                           power=power).numpy()
    ref = np.asarray(jmel.stft_power(jnp.asarray(wav), 1024, 256, win,
                                     power=power))
    assert ours.shape == ref.shape == (2, 32, 513)
    assert np.max(np.abs(ours - ref) / np.maximum(np.abs(ref), 1e-3)) < 1e-3


def test_log_mel_frontend_matches_jax():
    rng = np.random.default_rng(2)
    wav = (0.5 * np.sin(2 * np.pi * 440 * np.arange(16000) / 16000)
           + 0.1 * rng.standard_normal(16000)).astype(np.float32)
    ours = tmel.MelFrontend(TMelConfig(), device="cpu")(wav).numpy()
    ref = np.asarray(jmel.MelFrontend(MelConfig())(jnp.asarray(wav)))
    assert ours.shape == ref.shape == (1, 63, 80)
    assert np.mean(np.abs(ours - ref)) < 1e-3
    assert ours.min() >= np.log(1e-5) - 1e-6  # the ln clamp floor


def test_process_audio_chunk_matches_jax():
    rng = np.random.default_rng(3)
    for wav in (10.0 * rng.standard_normal((2, 256)),
                rng.standard_normal(300), np.zeros(50)):
        wav = wav.astype(np.float32)
        ours = tmel.process_audio_chunk(torch.from_numpy(wav)).numpy()
        ref = np.asarray(jmel.process_audio_chunk(jnp.asarray(wav)))
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)

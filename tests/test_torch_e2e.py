"""The port's end-to-end proof (audio_calm_torch.eval.e2e_demo) against the
JAX script's (scripts/e2e_demo.py) setup, on the CPU.

- The tone corpus, the generator's state after it and the batches drawn
  from it equal the JAX script's for the same numpy seed (its lines are
  copied below: run_demo is one function there); the log-mels within
  tests/test_torch_mel.py's 1e-3 mean-abs.
- The pitch check gives the JAX script's verdicts and bands on the same
  mels.
- A 3-step run on the CPU: finite losses, every word checked in both
  legs. The full run (400 / 600 / 300 steps, at least 2 of 3 words in
  both legs, tests/test_e2e_synthesis.py's criterion) is marked slow; on
  the card chip_smoke.py runs it at 400 / 500 / 150 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import MelConfig as TMelConfig
from audio_calm_torch.eval import e2e_demo
from audio_calm_torch.ops.mel import MelFrontend as TMelFrontend
from audio_calm_tpu.config import MelConfig
from audio_calm_tpu.ops.mel import MelFrontend


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_setup(seed=0):
    """scripts/e2e_demo.py's corpus and mels (run_demo's first lines)."""
    SR = 16000
    WORDS = {"A": 300.0, "B": 600.0, "C": 1200.0}
    rng = np.random.default_rng(seed)

    def utter(words):
        segs = [
            0.35 * np.sin(2 * np.pi * WORDS[w] * np.arange(int(0.4 * SR)) / SR)
            for w in words
        ]
        return np.concatenate(segs).astype(np.float32)

    keys = list(WORDS)
    corpus = []
    for _ in range(48):
        ws = [keys[rng.integers(0, 3)] for _ in range(rng.integers(1, 4))]
        corpus.append((" ".join(ws), utter(ws)))
    fe = MelFrontend(MelConfig())
    mels = [np.asarray(fe(jnp.asarray(w[None])))[0] for _, w in corpus]
    return rng, corpus, mels, utter


def _jax_vae_batch(rng, mels, bs=16, crop=24):
    """scripts/e2e_demo.py's vae_batch."""
    idx = rng.integers(0, len(mels), bs)
    out = np.zeros((bs, crop, 80), np.float32)
    for j, i in enumerate(idx):
        m = mels[i]
        t0 = rng.integers(0, max(m.shape[0] - crop, 1))
        seg = m[t0: t0 + crop]
        out[j, : len(seg)] = seg
    return out


def _jax_band_ok(mel_dn, ref_mel):
    """scripts/e2e_demo.py's pitch check."""
    band = int(np.argmax(mel_dn.mean(axis=0)))
    ref_band = int(np.argmax(ref_mel.mean(0)))
    return abs(band - ref_band) <= 4, band, ref_band


def test_tone_corpus_and_mels_match_jax_setup():
    jrng, jcorpus, jmels, jutter = _jax_setup()
    rng, corpus = e2e_demo.tone_corpus(0)
    assert [t for t, _ in corpus] == [t for t, _ in jcorpus]
    for (_, w), (_, jw) in zip(corpus, jcorpus):
        np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(e2e_demo.utter(["B", "A"]),
                                  jutter(["B", "A"]))
    fe = TMelFrontend(TMelConfig(), device="cpu")
    for (_, w), jm in zip(corpus[:12], jmels[:12]):
        m = fe(w[None])[0].numpy()
        assert m.shape == jm.shape and np.mean(np.abs(m - jm)) < 1e-3
    # the generator goes on with the same batches
    np.testing.assert_array_equal(e2e_demo.vae_batch(rng, jmels),
                                  _jax_vae_batch(jrng, jmels))
    enc = [np.full(1 + i % 7, i + 1, np.int32) for i in range(48)]
    lats = [np.full((5 + i, 8), i, np.float32) for i in range(48)]
    b = e2e_demo.calm_batch(rng, enc, lats, 8)
    idx = jrng.integers(0, 48, 16)
    np.testing.assert_array_equal(b["text_ids"][:, 0], idx + 1)
    np.testing.assert_array_equal(b["latents"][:, 0, 0], idx)
    np.testing.assert_array_equal(b["audio_mask"].sum(1),
                                  np.minimum(5 + idx, e2e_demo.T_AUD))
    np.testing.assert_array_equal(b["attention_mask"].sum(1), 1 + idx % 7)


def test_band_check_gives_the_jax_verdicts():
    _, _, jmels, jutter = _jax_setup()
    fe = MelFrontend(MelConfig())
    refs = {w: np.asarray(fe(jnp.asarray(jutter([w])[None])))[0]
            for w in e2e_demo.WORDS}
    rng = np.random.default_rng(7)
    verdicts = []
    for m in jmels[:16] + [rng.standard_normal((20, 80)) for _ in range(8)]:
        for w, ref in refs.items():
            got = e2e_demo.band_matches(m, ref)
            assert got == _jax_band_ok(m, ref)
            verdicts.append(got[0])
    assert any(verdicts) and not all(verdicts)


def test_three_step_demo_runs_on_the_cpu():
    stats = {}
    matches, total, distilled = e2e_demo.run_demo(
        3, 3, distill_steps=2, device="cpu", stats=stats)
    assert total == 3 and 0 <= matches <= 3 and 0 <= distilled <= 3
    for k in ("vae_loss", "calm_loss", "distill_loss"):
        assert np.isfinite(stats[k]), k
    assert len(stats["bands"]) == 6
    assert set(stats["launches"]) == {"vae", "calm", "check", "distill",
                                      "check_distilled"}
    # the CPU runs the plain versions: no kernel launch
    assert all(v == [0, 0] for v in stats["launches"].values())


@pytest.mark.slow
def test_trained_stack_synthesizes_correct_pitch():
    matches, total, distilled = e2e_demo.run_demo(
        400, 600, distill_steps=300, distill_k=4, device="cpu")
    assert total == 3
    assert matches >= 2, f"only {matches}/3 words matched pitch"
    assert distilled >= 2, (
        f"distilled-4 student matched only {distilled}/3 words")

"""The plain reference agrees with the port at a tiny size on the CPU in
float32, through a whole run of the harness (server, traffic, check); and
a run whose timed path is broken underneath comes out not correct."""

import numpy as np
import pytest

from bench_tiny import tiny_cell
from benchmark import run

# float32 on the CPU: the port and the reference differ by rounding, and
# the served vocoder rounds its products' operands to bf16
TIGHT = {"frames_off": 0, "hidden_gap": 1e-5, "dur_gap": 1e-5,
         "latent_gap": 1e-5, "audio_gap": 0.02}


def _run(**kw):
    return run.run_cell("tts-flagship-batch", 3000000019, 2.0, False,
                        device="cpu", cell=tiny_cell(limits=TIGHT),
                        log=lambda s: None, **kw)


def test_reference_agrees_with_the_port():
    out = _run()
    c = out["check"]
    assert c["frames_off"]["value"] == 0
    assert c["hidden_gap"]["value"] < 1e-5
    assert c["dur_gap"]["value"] < 1e-6
    assert c["latent_gap"]["value"] < 1e-5
    assert c["audio_gap"]["value"] < 0.02
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["correct"] is True
    assert "setup_s" in out["metrics"]


def _state_unchanged(monkeypatch):
    import audio_calm_torch.eval.infer as infer
    monkeypatch.setattr(infer, "ode_solve",
                        lambda fn, cond, x_init, *a, **k: x_init)


def _half_the_batch(monkeypatch):
    from audio_calm_torch.eval.infer import CALMInference
    orig = CALMInference.tts_batch

    def half(self, texts, seeds, *a, **k):
        h = max(1, len(texts) // 2)
        lat, nf, grid = orig(self, list(texts[:h]), list(seeds[:h]), *a, **k)
        idx = [i % h for i in range(len(texts))]
        return lat[idx], [nf[i] for i in idx], grid

    monkeypatch.setattr(CALMInference, "tts_batch", half)


def _answer_altered(monkeypatch):
    from audio_calm_torch.eval.infer import CALMInference
    orig = CALMInference.tts_batch

    def altered(self, *a, **k):
        lat, nf, grid = orig(self, *a, **k)
        lat = np.array(lat)
        lat[0, : nf[0]] *= 1.05
        return lat, nf, grid

    monkeypatch.setattr(CALMInference, "tts_batch", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _answer_altered])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = _run()
    assert out["correct"] is False

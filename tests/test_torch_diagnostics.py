"""The port's diagnostics (audio_calm_torch/diagnostics/sanity.py) and
profiling utilities vs the JAX package's, case by case as
tests/test_diagnostics.py checks them: flow verdicts, the latent audit on
the same files, stored-vs-fresh, predictor stats (numpy: equal); the flow
check on the same tiny weights (carried across by load_calm) and the
noise JAX's keys draw (its loss within 2e-4 relative, the bound of
tests/test_torch_train_tts.py's forward_tts comparison); `trace` leaves a
trace file and `StepTimer` counts steps per second."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_calm_tpu.models.calm as jcalm
from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.diagnostics import sanity as T
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import load_calm
from audio_calm_torch.utils.profiling import StepTimer, trace
from audio_calm_tpu.config import CALMModelConfig, LoRAConfig, Qwen2Config
from audio_calm_tpu.diagnostics import sanity as J
from audio_calm_tpu.models.calm import QwenCALM, init_calm_params
from audio_calm_tpu.ops.flow import compute_flow_loss


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("loss", [0.0, 0.5, 0.99, 1.0, 1.7, 1.8, 2.1, 9.0])
def test_flow_verdicts_match_jax(loss):
    assert T.flow_learning_verdict(loss) == J.flow_learning_verdict(loss)
    assert T.FLOW_BASELINE == J.FLOW_BASELINE == 2.0


def test_latent_audit_matches_jax(tmp_path):
    def audits():
        files = sorted(str(p) for p in tmp_path.glob("*.npz"))
        a, b = T.audit_latents(files), J.audit_latents(files)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.verdict, a.advice) == (b.verdict, b.advice)
        return a

    for i in range(3):
        np.savez(tmp_path / f"a{i}.npz", latent=np.random.default_rng(i)
                 .standard_normal((20, 16)).astype(np.float32))
    assert audits().verdict == "PASS"
    np.savez(tmp_path / "big.npz", latent=(10 * np.random.default_rng(9)
                                           .standard_normal((20, 16)))
             .astype(np.float32))
    assert audits().verdict == "WARN"
    np.savez(tmp_path / "nan.npz", latent=np.full((4, 16), np.nan,
                                                  np.float32))
    assert audits().verdict == "FAIL"
    files = sorted(str(p) for p in tmp_path.glob("*.npz"))
    assert dataclasses.asdict(T.audit_latents(files, max_files=2)) == \
        dataclasses.asdict(J.audit_latents(files, max_files=2))


@pytest.mark.parametrize("shift", [0.0, 0.05, 0.3, 2.0])
def test_stored_vs_fresh_matches_jax(shift):
    a = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32)
    b = np.concatenate([a + shift, a[:3]])  # longer fresh encode: trimmed
    assert T.stored_vs_fresh_encode(a, b) == J.stored_vs_fresh_encode(a, b)


def test_predictor_error_stats_matches_jax():
    rng = np.random.default_rng(3)
    gt = rng.integers(0, 300, 40).astype(np.float64)
    pred = gt + rng.normal(0, 20, 40)
    assert T.predictor_error_stats(pred, gt) == \
        J.predictor_error_stats(pred, gt)
    s = T.predictor_error_stats(np.array([110.0, 180.0]),
                                np.array([100.0, 200.0]))
    assert abs(s["mean"] - 0.1) < 1e-6


def test_check_flow_learning_matches_jax(monkeypatch):
    cfg = CALMModelConfig(
        latent_dim=8, max_audio_len=16, max_text_len=8,
        tts_flow_hidden_dim=32, tts_flow_num_layers=1,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=Qwen2Config.tiny(vocab_size=128),
        lora=LoRAConfig(rank=2, alpha=4, dropout=0.0),
        latent_mean=0.1, latent_std=1.2)
    model = QwenCALM(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: init_calm_params(model,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
        shapes)
    batches = []
    for i in range(2):
        r = np.random.default_rng(10 + i)
        tmask = np.arange(6)[None] < r.integers(2, 7, 2)[:, None]
        amask = np.arange(16)[None] < r.integers(8, 17, 2)[:, None]
        batches.append(dict(
            text_ids=(r.integers(1, 128, (2, 6)) * tmask).astype(np.int32),
            attention_mask=tmask.astype(np.int32),
            latents=r.standard_normal((2, 16, 8)).astype(np.float32),
            audio_mask=amask.astype(np.int32)))

    seen = []

    def recording(head_fn, rng_, condition, target, *a, **kw):
        # the flow key and the target's shape, read back from inside the
        # jitted forward
        jax.debug.callback(lambda k, x: seen.append((np.array(k), x.shape)),
                           rng_, target)
        return compute_flow_loss(head_fn, rng_, condition, target, *a, **kw)

    class Jitted:  # JAX's check_flow_learning on a jitted apply
        apply = staticmethod(jax.jit(model.apply,
                                     static_argnames=("train", "method")))

    monkeypatch.setattr(jcalm, "compute_flow_loss", recording)
    ref = J.check_flow_learning(
        Jitted, {"params": params},
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        jax.random.PRNGKey(4))
    monkeypatch.undo()
    draws = []
    for key, shape in seen:  # compute_flow_loss splits (drop, t, x0)
        _, r_t, r_x0 = jax.random.split(key, 3)
        draws.append((np.array(jax.random.uniform(r_t, (shape[0],))),
                      np.array(jax.random.normal(r_x0, shape))))

    port = TQwenCALM(from_dict(TCALMConfig, dataclasses.asdict(cfg))).eval()
    load_calm(port, {"params": params})
    got = T.check_flow_learning(
        port, [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in batches], x0=draws)
    assert got["verdict"] == ref["verdict"]
    assert got["baseline"] == ref["baseline"]
    assert abs(got["loss_tts"] - ref["loss_tts"]) <= \
        2e-4 * abs(ref["loss_tts"])
    # drawn from a generator instead: reproducible, and a different draw
    gen = [T.check_flow_learning(
        port, [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in batches], generator=torch.Generator().manual_seed(0))
        ["loss_tts"] for _ in range(2)]
    assert gen[0] == gen[1] and np.isfinite(gen[0])


def test_trace_and_step_timer(tmp_path):
    x = torch.ones(64, 64)
    with trace(str(tmp_path / "tb")):
        (x @ x).sum()
    dumped = [os.path.join(dp, f) for dp, _, fs in os.walk(tmp_path / "tb")
              for f in fs]
    assert dumped and all(os.path.getsize(f) > 0 for f in dumped)
    t = StepTimer(warmup=1)
    assert np.isnan(t.steps_per_sec)
    for _ in range(3):
        t.tick((x @ x).sum())
    assert t.steps_per_sec > 0

"""The port's evaluation, sanity and demo entry points on the CPU (the
stages of scripts/quickstart_smoke.sh that reach scripts/eval_calm.py,
scripts/sanity_checks.py and scripts/web_demo.py), on a tiny synthetic
store written by audio_calm_torch.data.synth_corpus:

  - `python -m audio_calm_torch.eval.eval_calm --device cpu` (its main)
    writes asr_results.csv, whose transcripts are CALMInference.asr's for
    the same seeds, and one wav a TTS item whose length is a multiple of
    1024, and prints the vocoder line;
  - `python -m audio_calm_torch.diagnostics.sanity_checks --device cpu`
    prints every verdict line and exits 0 on a sound store, 1 on a store
    holding a NaN latent; a VAE directory it cannot read raises;
  - `audio_calm_torch.serving.web_demo` with a stub gradio registers both
    callbacks, which run (tests/test_web_demo.py's stub), and returns 1
    without gradio.
"""

import csv
import os
import sys
import types
import wave

import numpy as np
import pytest
import torch

from audio_calm_torch.config import CALMConfig, load_config
from audio_calm_torch.data import synth_corpus
from audio_calm_torch.data.datasets import load_array, scan_corpus
from audio_calm_torch.data.tokenizer import ByteTokenizer
from audio_calm_torch.diagnostics import sanity_checks
from audio_calm_torch.eval import eval_calm
from audio_calm_torch.eval.infer import CALMInference, chunk_seed
from audio_calm_torch.eval.metrics import normalize_text
from audio_calm_torch.serving import web_demo

MODEL = """\
model:
  latent_dim: 8
  max_text_len: 96
  max_audio_len: 48
  tts_flow_hidden_dim: 32
  tts_flow_num_layers: 1
  asr_flow_hidden_dim: 32
  asr_flow_num_layers: 1
  flow_num_heads: 4
  latent_mean: 0.0
  latent_std: 4.0
  lora: {rank: 2, alpha: 4, dropout: 0.0}
  qwen: {vocab_size: 258, hidden_size: 64, intermediate_size: 128, \
num_hidden_layers: 2, num_attention_heads: 4, num_key_value_heads: 2, \
head_dim: 16, rope_theta: 10000.0}
data:
  datasets:
    tts: {latent_dir: {store}/dev/LibriTTS_R, subsets: dev-clean}
  max_text_len: 96
  max_audio_len: 48
evaluation:
  task: mix
  output_dir: {out}
  max_samples: 2
  audio_buckets: [24, 48]
  steps: 2
  asr_steps: 2
  seed: 7
  datasets:
    asr: {latent_dir: {store}/dev/LibriSpeech, subsets: dev-clean}
    tts: {latent_dir: {store}/dev/LibriTTS_R, subsets: dev-clean}
"""


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    assert synth_corpus.main(["--out", str(root), "--asr-n", "4",
                              "--tts-n", "4", "--dev-n", "3",
                              "--latent-dim", "8", "--chunk", "4"]) == 0
    return root


def _config(tmp_path, store, out):
    path = tmp_path / "tiny.yaml"
    path.write_text(MODEL.replace("{store}", str(store)).replace(
        "{out}", str(out)))
    return str(path)


def test_eval_calm_on_cpu(tmp_path, store, capsys):
    out = tmp_path / "eval"
    cfg_path = _config(tmp_path, store, out)
    assert eval_calm.main(["--config", cfg_path, "--byte-tokenizer",
                           "--device", "cpu"]) == 0
    log = capsys.readouterr().out
    assert "vocoder: GriffinLimVocoder" in log and "ASR WER: " in log
    assert "wrote 2 wavs" in log
    with open(out / "asr_results.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["id", "ref", "pred", "wer", "cer"] and len(rows) == 3
    for i in range(2):
        with wave.open(str(out / "tts_wavs" / f"tts_{i:04d}.wav")) as w:
            assert w.getframerate() == 16000 and w.getsampwidth() == 2
            n = w.getnframes()
        assert n > 0 and n % 1024 == 0, n

    # the CSV's transcripts are CALMInference.asr's with the same seeds
    cfg = load_config(cfg_path, cls=CALMConfig)
    e = cfg.evaluation
    inf = CALMInference(eval_calm.build_model(cfg, "cpu"), ByteTokenizer(),
                        audio_buckets=e.audio_buckets, device="cpu")
    items = scan_corpus(e.datasets["asr"].latent_dir,
                        e.datasets["asr"].subsets, "asr")[:2]
    for i, item in enumerate(items):
        pred = inf.asr(load_array(item["file_path"], expected_dim=8),
                       chunk_seed(e.seed, i), steps=2,
                       method=e.ode_method, time_schedule=e.time_schedule)
        assert rows[1 + i][2] == normalize_text(pred)


def test_sanity_checks_on_cpu(tmp_path, store, capsys):
    cfg_path = _config(tmp_path, store, tmp_path / "unused")
    argv = ["--config", cfg_path, "--byte-tokenizer", "--device", "cpu",
            "--max-batches", "1", "--out-dir", str(tmp_path / "sanity")]
    rc = sanity_checks.main(argv + [
        "--latent-audit", str(store / "dev"),
        "--vae-upper-bound", str(store / "dev" / "LibriTTS_R")])
    log = capsys.readouterr().out
    for line in ("[latent audit] ", "[vae upper bound] decoded ",
                 "[flow check] ", "[len predictor] rel err mean="):
        assert line in log, log
    assert "[latent audit] FAIL" not in log and "[flow check] FAIL" not in log
    assert rc == 0
    assert os.path.isfile(tmp_path / "sanity" / "upper_bound_0.wav")

    bad = tmp_path / "bad"
    bad.mkdir()
    np.savez(bad / "nan.npz", latent=np.full((4, 8), np.nan, np.float32))
    assert sanity_checks.main(argv + ["--latent-audit", str(bad)]) == 1
    assert "[latent audit] FAIL" in capsys.readouterr().out

    with pytest.raises(ValueError, match="orbax item"):
        sanity_checks.main(argv + [
            "--vae-upper-bound", str(store / "dev"),
            "--vae-ckpt", str(tmp_path / "sanity")])


class _Widget:
    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _fake_gradio(registry):
    gr = types.ModuleType("gradio")

    class Button(_Widget):
        def click(self, fn, inputs, outputs):
            registry["clicks"].append(fn)

    class Blocks(_Widget):
        def launch(self, **kw):
            registry["launched"] = kw

    for name in ("Markdown", "Tab", "Textbox", "Slider", "Audio"):
        setattr(gr, name, _Widget)
    gr.Button, gr.Blocks = Button, Blocks
    return gr


def test_web_demo_on_cpu(tmp_path, store, monkeypatch):
    cfg_path = _config(tmp_path, store, tmp_path / "unused")
    monkeypatch.setitem(sys.modules, "gradio", None)  # ImportError
    assert web_demo.main(["--config", cfg_path]) == 1

    registry = {"clicks": [], "launched": None}
    monkeypatch.setitem(sys.modules, "gradio", _fake_gradio(registry))
    assert web_demo.main(["--config", cfg_path, "--device", "cpu",
                          "--byte-tokenizer"]) == 0
    assert registry["launched"] == {"server_port": 7860}
    tts_fn, asr_fn = registry["clicks"]
    sr, wav = tts_fn("hello world", steps=2, cfg_scale=1.5)
    assert sr == 16000 and wav.dtype == np.int16
    assert wav.shape[0] >= 1024 and wav.shape[0] % 1024 == 0
    assert isinstance(asr_fn((16000, wav), steps=2), str)
    # past the 48-latent budget (48 x 1024 samples): asr_long's chunks
    rng = np.random.default_rng(2)
    long_wav = (np.clip(rng.standard_normal(2 * 48 * 1024) * 0.2, -1, 1)
                * 32767).astype(np.int16)
    assert isinstance(asr_fn((16000, np.stack([long_wav, long_wav], 1)),
                             steps=2), str)

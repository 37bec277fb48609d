"""Data-parallel training of the port in two real processes (counterpart of
tests/test_multiprocess.py).

Two gloo processes of the port's own CLIs (`python -m
audio_calm_torch.train.train_vae --device cpu --distributed`, then
`train_calm` for TTS at a Qwen2Config.tiny()-sized model, packed rows in
2 microbatch slices, LoRA and CFG dropout on, and `distill_calm`) over
torchrun's variables
and one shared training.output_dir. Each rank loads only its rows of
every global batch; rank 0's logged losses must equal a one-process run of
the same CLI over the same global batches (the two ranks' iterators
zipped and their rows concatenated in rank order, as JAX's comparator
assembles them) within 1e-4, the bound of tests/test_multiprocess.py
(relative for a value past 1, such as a gradient norm).
Only rank 0 logs and writes the exported weights.

Data x tensor parallelism: two gloo processes, each a row of a (2, 2) mesh
of CPU entries through train/steps.shard_step (the Qwen2 kernels split
over the row's two entries), take two "tts" steps on their rows of the
global batches; rank 0's metrics against one process on one device within
the same 1e-4.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_calm_torch.data import collator, synth_corpus
from audio_calm_torch.train import train_calm, train_vae

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)

from test_torch_train_loop import TINY_YAML, VAE_YAML, _mel_store  # noqa
from torch_tp_worker import tp_setup, tts_steps  # noqa


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_ranks(module, argv, log_dir):
    """Run `python -m module argv` as ranks 0 and 1 of a gloo group ->
    their stdout texts."""
    return _two_processes([sys.executable, "-m", module, *argv, "--device",
                           "cpu", "--distributed"], log_dir)


def _two_processes(cmd, log_dir):
    """Run `cmd` as ranks 0 and 1 of a group (torchrun's variables set) ->
    their stdout texts."""
    port = _free_port()
    procs, logs = [], []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        log = open(os.path.join(log_dir, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    for p in procs:
        p.wait(timeout=600)
    outs = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.close()
        outs.append(open(log.name).read())
        assert p.returncode == 0, f"rank {rank}:\n{outs[-1]}"
    return outs


def _assembled(real):
    """An iterator factory that zips rank 0's and rank 1's iterators of a
    training stream (process_count 2) and joins their rows in rank order:
    the global batches of the two-process run."""

    def make(dataset, batch_size, *args, training=True, **kw):
        if not training:
            return real(dataset, batch_size, *args, training=False, **kw)
        assert kw.pop("process_count") == 1 and kw.pop("process_index") == 0
        its = [real(dataset, batch_size, *args, training=True,
                    process_index=i, process_count=2, **kw)
               for i in range(2)]

        def gen():
            for parts in zip(*its):
                assert len({p.get("task") for p in parts}) == 1
                out = {}
                for k, v in parts[0].items():
                    if k == "task":
                        out[k] = v
                    elif k == "n_samples":
                        out[k] = sum(p[k] for p in parts)
                    else:
                        out[k] = np.concatenate([p[k] for p in parts])
                yield out

        return gen()

    return make


def _close(a, b):
    """Within 1e-4 (tests/test_multiprocess.py's bound), relative for
    values past 1 (a gradient norm)."""
    return abs(a - b) <= 1e-4 * max(1.0, abs(b))


def _losses(path):
    recs = [json.loads(line) for line in open(path)]
    train = [r for r in recs if "loss" in r]
    steps = [r["step"] for r in train]
    assert steps == sorted(set(steps)), "a step was logged twice"
    return train, [r for r in recs if "eval_loss" in r]


def test_two_process_train_vae(tmp_path, monkeypatch):
    """train_vae in two gloo processes (global batch 4 = 2 per rank, 3
    steps, the second a checkpoint) against one process over the
    assembled global batches: every logged loss term within 1e-4; only
    rank 0 exported vae.bin."""
    store = tmp_path / "mels"
    _mel_store(store)
    yaml = VAE_YAML.replace("{store}", str(store)).replace(
        "  eval_data_dir: {store}/dev\n", "")
    dist_out, ref_out = tmp_path / "dist", tmp_path / "ref"
    cfg = tmp_path / "vae.yaml"
    cfg.write_text(yaml.replace("{out}", str(dist_out)).replace(
        "per_device_train_batch_size: 4", "per_device_train_batch_size: 2"))
    outs = _two_ranks("audio_calm_torch.train.train_vae",
                      ["--config", str(cfg), "--max-steps", "3"], tmp_path)
    assert "global batch: 4" in outs[0] and "rank 1 of 2" in outs[1]
    assert "saved final VAE params" in outs[0]
    assert "saved final VAE params" not in outs[1]
    assert os.path.isfile(dist_out / "vae.bin")
    got, _ = _losses(dist_out / "metrics.jsonl")

    ref_cfg = tmp_path / "vae_ref.yaml"
    ref_cfg.write_text(yaml.replace("{out}", str(ref_out)))
    monkeypatch.setattr(train_vae, "mel_batch_iterator",
                        _assembled(collator.mel_batch_iterator))
    run = train_vae.train(["--config", str(ref_cfg), "--device", "cpu",
                           "--max-steps", "3"])
    assert [r["step"] for r in got] == [r["step"] for r in run.history] \
        == [1, 2, 3]
    for a, b in zip(got, run.history):
        for k in ("loss", "rec_loss", "ssim_loss", "stft_loss", "kl_loss",
                  "mu_std", "var_mean", "grad_norm"):
            assert _close(a[k], b[k]), (k, got, run.history)


def test_two_process_train_calm(tmp_path, monkeypatch):
    """train_calm for TTS in two gloo processes: packed rows (4 global, 2
    per rank) in 2 microbatch slices, so each slice of 2 rows splits 1 + 1
    over the ranks; LoRA and CFG dropout draw their rows of the global
    masks. Rank 0's losses (and the eval at step 2) against one process
    over the assembled global batches within 1e-4; only rank 0 wrote the
    components."""
    store = tmp_path / "store"
    assert synth_corpus.main(["--out", str(store), "--asr-n", "0",
                              "--tts-n", "20", "--dev-n", "4",
                              "--latent-dim", "8", "--chunk", "10"]) == 0
    dist_out, ref_out = tmp_path / "dist", tmp_path / "ref"
    yaml = TINY_YAML.replace("{store}", str(store))
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.replace("{out}", str(dist_out)).replace(
        "per_device_train_batch_size: 4", "per_device_train_batch_size: 2"))
    argv = ["--config", str(cfg), "--byte-tokenizer", "--max-steps", "3"]
    outs = _two_ranks("audio_calm_torch.train.train_calm", argv, tmp_path)
    assert "saved components" in outs[0]
    assert "saved components" not in outs[1]
    assert os.path.isfile(dist_out / "components" / "components.json")
    got, got_eval = _losses(dist_out / "metrics.jsonl")

    ref_cfg = tmp_path / "tiny_ref.yaml"
    ref_cfg.write_text(yaml.replace("{out}", str(ref_out)))
    monkeypatch.setattr(train_calm, "calm_batch_iterator",
                        _assembled(collator.calm_batch_iterator))
    run = train_calm.train(["--config", str(ref_cfg), "--byte-tokenizer",
                            "--device", "cpu", "--max-steps", "3"])
    assert [r["step"] for r in got] == [r["step"] for r in run.history] \
        == [1, 2, 3]
    for a, b in zip(got, run.history):
        # the log leaves out a term that is 0.0 over its window
        for k in ("loss", "loss_tts", "loss_len", "loss_dur", "loss_den",
                  "grad_norm"):
            assert _close(a.get(k, 0.0), b[k]), (k, got, run.history)
    _, ref_eval = _losses(ref_out / "metrics.jsonl")
    assert [r["step"] for r in got_eval] == [r["step"] for r in ref_eval] \
        == [2]
    assert _close(got_eval[0]["eval_loss"], ref_eval[0]["eval_loss"])


def test_two_process_distill_calm(tmp_path, monkeypatch):
    """distill_calm (TTS, K = 2, M = 2, cfg 2.0, the teacher perturbed) in
    two gloo processes (2 rows a rank) against one process over the
    assembled global batches: each rank draws its rows of the global x0
    and divides by the global valid count; losses within 1e-4; only rank
    0 wrote the components."""
    from test_torch_distill import TINY_YAML as DISTILL_YAML

    from audio_calm_torch.train import distill_calm

    store = tmp_path / "store"
    assert synth_corpus.main(["--out", str(store), "--asr-n", "12",
                              "--tts-n", "12", "--dev-n", "2",
                              "--latent-dim", "8", "--chunk", "10"]) == 0
    dist_out, ref_out = tmp_path / "dist", tmp_path / "ref"
    yaml = DISTILL_YAML.replace("{store}", str(store)).replace(
        "{task}", "tts")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.replace("{out}", str(dist_out)).replace(
        "per_device_train_batch_size: 4", "per_device_train_batch_size: 2"))
    argv = ["--task", "tts", "--byte-tokenizer", "--max-steps", "3",
            "--perturb-teacher", "0.05", "--student-steps", "2",
            "--teacher-substeps", "2"]
    outs = _two_ranks("audio_calm_torch.train.distill_calm",
                      ["--config", str(cfg)] + argv, tmp_path)
    assert "saved distilled components" in outs[0]
    assert "saved distilled components" not in outs[1]
    got, _ = _losses(dist_out / "distill_tts" / "metrics.jsonl")

    ref_cfg = tmp_path / "tiny_ref.yaml"
    ref_cfg.write_text(yaml.replace("{out}", str(ref_out)))
    monkeypatch.setattr(distill_calm, "calm_batch_iterator",
                        _assembled(collator.calm_batch_iterator))
    run = distill_calm.distill(["--config", str(ref_cfg), "--device", "cpu"]
                               + argv)
    assert [r["step"] for r in got] == [r["step"] for r in run.history] \
        == [1, 2, 3]
    for a, b in zip(got, run.history):
        for k in ("loss", "loss_distill", "grad_norm"):
            assert _close(a[k], b[k]), (k, got, run.history)


def test_two_processes_each_tensor_parallel(tmp_path):
    """Two gloo ranks, each with its Qwen2 kernels split over two CPU
    entries (a (2, 2) mesh), two "tts" steps with LoRA and CFG dropout on:
    every metric against one process on one device over the same global
    batches within 1e-4."""
    out = tmp_path / "rank0.json"
    code = (f"import sys; sys.path.insert(0, {TESTS!r}); "
            f"import torch_tp_worker as w; w.dp_tp_rank({str(out)!r})")
    _two_processes([sys.executable, "-c", code], tmp_path)
    got = json.loads(out.read_text())
    ref = tts_steps(*tp_setup())
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in b:
            assert _close(a[k], b[k]), (k, got, ref)

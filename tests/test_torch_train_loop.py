"""The port's training loop, train-state checkpoints and training entry
point on the CPU (mirroring tests/test_resume.py and
tests/test_observability.py of the JAX package).

Bounds: none but exact ones. Restored tensors and optimizer state are
compared bit for bit; checkpoint retention is compared with orbax's
manager under the options the JAX package sets; MFU is checked against
its own formula to 1e-6 relative (float arithmetic on logged values).
"""

import json
import os

import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from audio_calm_torch.config import CALMConfig, TrainingConfig, load_config
from audio_calm_torch.data import synth_corpus
from audio_calm_torch.models.calm import QwenCALM
from audio_calm_torch.train import checkpoint as tckpt
from audio_calm_torch.train import train_calm
from audio_calm_torch.train.loop import run_training
from audio_calm_torch.train.optim import AdamW
from audio_calm_torch.utils import profiling
from audio_calm_tpu.train.checkpoint import make_manager as j_make_manager

TINY_YAML = """\
model:
  latent_dim: 8
  max_text_len: 96
  max_audio_len: 48
  tts_flow_hidden_dim: 32
  tts_flow_num_layers: 1
  asr_flow_hidden_dim: 32
  asr_flow_num_layers: 1
  flow_num_heads: 4
  latent_mean: 0.039775
  latent_std: 1.190864
  lora: {rank: 2, alpha: 4, dropout: 0.05}
  qwen: {vocab_size: 258, hidden_size: 64, intermediate_size: 128, \
num_hidden_layers: 2, num_attention_heads: 4, num_key_value_heads: 2, \
head_dim: 16, rope_theta: 10000.0}
data:
  task_mode: tts
  task_prob_tts: 1.0
  datasets:
    tts:
      latent_dir: {store}/train/LibriTTS_R
      eval_latent_dir: {store}/dev/LibriTTS_R
      subsets: train-clean-100
  eval_subsets: dev-clean
  max_text_len: 96
  max_audio_len: 48
  audio_buckets: [24, 48]
  length_group_window: 2
  tts_pack_rows: 4
  tts_pack_len: 128
  tts_pack_segments: 2
training:
  output_dir: {out}
  per_device_train_batch_size: 4
  microbatch_steps: 2
  learning_rate: 1e-3
  num_train_epochs: 1
  frozen_weights_dtype: bfloat16
  logging_steps: 1
  save_steps: 2
  eval_steps: 2
  save_total_limit: 2
  seed: 42
"""


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# --------------------------------------------------------------------------
# the loop over a tiny problem: least squares with the port's AdamW
# --------------------------------------------------------------------------
TARGET = torch.linspace(-1.0, 1.0, 12).reshape(3, 4)


def _problem(cfg, total):
    torch.manual_seed(0)
    params = {"w": torch.randn(3, 4), "b": torch.zeros(4)}
    opt = AdamW(params, {"w": "decay", "b": "no_decay"}, cfg, total)

    def step(batch):
        x = batch["x"]
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        loss = ((x @ params["w"] + params["b"] - x @ TARGET) ** 2).mean()
        loss.backward()
        norm = opt.step({n: p.grad for n, p in params.items()})
        for p in params.values():
            p.requires_grad_(False)
        step.count += 1
        return {"loss": loss.detach(), "grad_norm": norm}

    step.count = 0
    return params, opt, step


def _batches(n=None, rows=5):
    g = torch.Generator().manual_seed(1)
    i = 0
    while n is None or i < n:
        yield {"x": torch.randn(rows, 3, generator=g)}
        i += 1


def _cfg(out, **kw):
    base = dict(learning_rate=3e-2, warmup_ratio=0.0, output_dir=str(out),
                logging_steps=100, save_steps=3, eval_steps=100,
                load_best_model_at_end=False, lr_scheduler_type="constant")
    return TrainingConfig(**{**base, **kw})


def _state(params, opt):
    return {**{f"p.{n}": t.clone() for n, t in params.items()},
            **{f"{k}.{n}": t.clone() for k in ("mu", "nu")
               for n, t in getattr(opt, k).items()},
            "count": opt.count, "mini_step": opt.mini_step}


def _assert_bit_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_resume_continues_from_checkpoint(tmp_path):
    """6 steps saving every 3; a second run resuming from that directory
    restores step 6 bit for bit and runs steps 7-10; a run whose batches
    run out off the save grid checkpoints its last step."""
    out = tmp_path / "run"
    cfg = _cfg(out)
    params, opt, step = _problem(cfg, 20)
    hist = run_training(step, _batches(), cfg, 6, optimizer=opt)
    assert [r["step"] for r in hist] == [1, 2, 3, 4, 5, 6]
    assert tckpt.make_manager(out, best_metric=None).all_steps() == [3, 6]
    saved = _state(params, opt)

    cfg2 = _cfg(out, resume_from_checkpoint=str(out))
    params2, opt2, step2 = _problem(cfg2, 20)
    fresh = _state(params2, opt2)
    seen = []

    def batches(start_step):
        seen.append(start_step)
        return _batches()

    manager = tckpt.make_manager(out, best_metric=None)
    assert tckpt.restore_train_state(manager, opt2) == 6
    _assert_bit_equal(_state(params2, opt2), saved)
    params2, opt2, step2 = _problem(cfg2, 20)  # from scratch again
    _assert_bit_equal(_state(params2, opt2), fresh)
    hist2 = run_training(step2, batches, cfg2, 10, optimizer=opt2)
    assert seen == [6]  # the data reseeds by the restored step
    assert [r["step"] for r in hist2] == [7, 8, 9, 10]
    assert opt2.count == 10 and step2.count == 10
    assert not torch.equal(params2["w"], saved["p.w"])
    assert tckpt.make_manager(out, best_metric=None).all_steps() == [9, 10]

    out3 = tmp_path / "exhausted"
    params3, opt3, step3 = _problem(_cfg(out3), 20)
    hist3 = run_training(step3, _batches(n=4), _cfg(out3), 20,
                         optimizer=opt3)
    assert len(hist3) == 4
    manager3 = tckpt.make_manager(out3, best_metric=None)
    assert manager3.all_steps() == [3, 4]  # the final, off-grid step kept
    params4, opt4, _ = _problem(_cfg(out3), 20)
    assert tckpt.restore_train_state(manager3, opt4) == 4
    _assert_bit_equal(_state(params4, opt4), _state(params3, opt3))
    with pytest.raises(ValueError, match="not this model"):
        tckpt.restore_train_state(manager3, AdamW(
            {"v": torch.zeros(2)}, {"v": "decay"}, _cfg(out3), 5))


def test_best_model_retention_restores_lowest_loss(tmp_path):
    """Every step saved with its train loss, 2 kept: the two lowest stay
    and the lowest is loaded at the end; an eval metric, when there is
    one, ranks instead."""
    out = tmp_path / "best"
    cfg = _cfg(out, save_steps=1, save_total_limit=2,
               load_best_model_at_end=True)
    params, opt, step = _problem(cfg, 20)
    losses = iter([5.0, 2.0, 4.0, 1.0, 3.0, 6.0])
    snaps = {}

    def scripted(batch):
        m = step(batch)
        snaps[step.count] = _state(params, opt)
        return {**m, "loss": torch.tensor(next(losses))}

    scripted.count = 0
    run_training(scripted, _batches(), cfg, 6, optimizer=opt)
    manager = tckpt.make_manager(out, 2, "loss")
    assert manager.all_steps() == [2, 4] and manager.best_step() == 4
    _assert_bit_equal(_state(params, opt), snaps[4])

    out2 = tmp_path / "best_eval"
    cfg2 = _cfg(out2, save_steps=2, eval_steps=2, save_total_limit=1,
                load_best_model_at_end=True)
    params2, opt2, step2 = _problem(cfg2, 20)
    evals = iter([0.3, 0.1, 0.2])
    calls = []

    def eval_fn():
        calls.append(step2.count)
        return {"loss": next(evals)}

    run_training(step2, _batches(), cfg2, 6, optimizer=opt2, eval_fn=eval_fn)
    assert calls == [2, 4, 6]  # every eval_steps
    assert tckpt.make_manager(out2, 1, "loss").all_steps() == [4]
    recs = [json.loads(l) for l in open(out2 / "metrics.jsonl")]
    assert [r["eval_loss"] for r in recs if "eval_loss" in r] == [0.3, 0.1,
                                                                   0.2]


@pytest.mark.parametrize("best", [None, "loss"])
def test_retention_matches_orbax(tmp_path, best):
    """The same saves (steps, metrics) through the port's manager and
    through orbax's under the JAX package's options keep the same steps
    and name the same best step."""
    metrics = [3.0, 1.0, 2.0, 1.0, 5.0, 0.5, 4.0]
    ours = tckpt.make_manager(tmp_path / "port", 3, best)
    theirs = j_make_manager(str(tmp_path / "orbax"), 3, best)
    for i, v in enumerate(metrics):
        ours.save(i + 1, {"x": torch.tensor(v)}, {"loss": v})
        theirs.save(i + 1, args=ocp.args.StandardSave(
            {"x": np.float32(v)}), metrics={"loss": v})
    theirs.wait_until_finished()
    assert ours.all_steps() == sorted(theirs.all_steps())
    assert ours.best_step() == theirs.best_step()
    assert ours.latest_step() == theirs.latest_step()


def test_metrics_jsonl_samples_per_sec_and_mfu(tmp_path, monkeypatch):
    """Every logging flush writes samples_per_sec (5 rows a step here, a
    packed batch's n_samples when it has one) and, with a known peak,
    mfu_pct = 100 x FLOPs a step x steps/s / peak."""
    out = tmp_path / "obs"
    cfg = _cfg(out, logging_steps=2, save_steps=100)
    params, opt, step = _problem(cfg, 10)
    monkeypatch.setattr(profiling, "device_peak_flops",
                        lambda device=None: 1e12)
    fl = 3.5e9
    run_training(step, _batches(), cfg, 4, optimizer=opt,
                 step_flops=lambda b: fl)
    recs = [json.loads(l) for l in open(out / "metrics.jsonl")]
    assert len(recs) == 2
    for r in recs:
        assert abs(r["samples_per_sec"] / r["steps_per_sec"] - 5.0) < 1e-6
        assert r["mfu_pct"] > 0
        assert abs(r["mfu_pct"] - 100 * fl * r["steps_per_sec"] / 1e12) \
            <= 1e-6 * r["mfu_pct"]
    out2 = tmp_path / "packed"
    cfg2 = _cfg(out2, logging_steps=2, save_steps=100)
    params2, opt2, step2 = _problem(cfg2, 10)
    packed = ({**b, "n_samples": 7} for b in _batches())
    chosen = []

    def select(raw):  # the per-batch step routing
        chosen.append(raw["n_samples"])
        return step2

    run_training(None, packed, cfg2, 2, optimizer=opt2,
                 batch_filter=lambda raw: {"x": raw["x"]},
                 step_selector=select)
    assert chosen == [7, 7] and step2.count == 2
    (r,) = [json.loads(l) for l in open(out2 / "metrics.jsonl")]
    assert abs(r["samples_per_sec"] / r["steps_per_sec"] - 7.0) < 1e-6
    assert "mfu_pct" not in r  # no FLOP count, no MFU


def test_device_peak_flops_by_name(monkeypatch):
    """Dense bf16 peaks by card name; None on the CPU and unknown cards."""
    assert profiling.device_peak_flops("cpu") is None
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, n=name: n)
        assert profiling.device_peak_flops("cuda") == peak, name


def test_qwen2_backbone_loads_from_a_hf_directory(tmp_path):
    """model.qwen_path: a HF Qwen2 directory's base weights (HF names,
    [out, in] linears) overlay the embedding and the LLM; LoRA stays."""
    cfg = load_config(str(_tiny_yaml(tmp_path, tmp_path, tmp_path)),
                      cls=CALMConfig)
    torch.manual_seed(3)
    source = QwenCALM(cfg.model)
    for p in source.parameters():
        p.data.normal_()
    hf = {"model.embed_tokens.weight": source.embed.embedding.detach()}
    hf.update({"model." + k[len("llm."):]: v.detach()
               for k, v in source.state_dict().items()
               if k.startswith("llm.") and "lora_" not in k})
    (tmp_path / "qwen").mkdir()
    torch.save(hf, tmp_path / "qwen" / "pytorch_model.bin")
    target = QwenCALM(cfg.model)
    lora = {k: v.clone() for k, v in target.state_dict().items()
            if "lora_" in k}
    tckpt.load_qwen2_backbone(target, str(tmp_path / "qwen"))
    got = target.state_dict()
    for k, v in source.state_dict().items():
        if k.startswith(("llm.", "embed.")):
            want = lora[k] if "lora_" in k else v
            assert torch.equal(got[k], want), k


def _tiny_yaml(tmp_path, store, out):
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML.replace("{store}", str(store)).replace(
        "{out}", str(out)))
    return path


# --------------------------------------------------------------------------
# the entry point
# --------------------------------------------------------------------------
def test_train_calm_entry_point_on_cpu(tmp_path, capsys):
    """`python -m audio_calm_torch.train.train_calm --device cpu
    --byte-tokenizer --max-steps 3` in-process (its `train`) on a 2-layer config over a
    synthetic store: packed steps in 2 slices, an eval and checkpoints at
    step 2, the final step saved, the components written in the
    reference layout and loaded back by load_component and soft_restart."""
    store, out = tmp_path / "store", tmp_path / "out"
    assert synth_corpus.main(["--out", str(store), "--asr-n", "0",
                              "--tts-n", "20", "--dev-n", "4",
                              "--latent-dim", "8", "--chunk", "10"]) == 0
    cfg_path = _tiny_yaml(tmp_path, store, out)
    argv = ["--config", str(cfg_path), "--byte-tokenizer", "--device", "cpu",
            "--max-steps", "3"]
    run = train_calm.train(argv)
    log = capsys.readouterr().out
    assert "dataset: 20 tts items" in log and "[step 2] eval_loss=" in log
    recs = [json.loads(l) for l in open(out / "metrics.jsonl")]
    train_recs = [r for r in recs if "loss" in r]
    assert [r["step"] for r in train_recs] == [1, 2, 3]
    for r in train_recs:
        assert np.isfinite(r["loss"]) and r["loss_den"] > 0
        assert r["samples_per_sec"] > 0
    manager = tckpt.make_manager(out, 2, "loss")
    assert manager.all_steps() == [2, 3]

    assert [r["step"] for r in run.history] == [1, 2, 3]
    comp = run.components_dir
    assert comp == str(out / "components")
    listed = json.load(open(os.path.join(comp, "components.json")))
    assert "lora" in listed["components"]
    assert "tts_flow_head" in listed["components"]
    tree = tckpt.load_component(comp, "tts_flow_head")
    assert "in_proj" in tree
    with pytest.raises(FileNotFoundError):
        tckpt.load_component(str(tmp_path), "tts_flow_head")
    fresh = QwenCALM(load_config(str(cfg_path), cls=CALMConfig).model)
    tckpt.soft_restart(fresh, {c: comp for c in tckpt.COMPONENTS + ("lora",)})
    trained = run.model.state_dict()
    loaded = fresh.state_dict()
    names = list(tckpt.component_state_dict(run.model))
    assert len(names) > 40
    for n in names:  # fp32 masters through the reference layout, exactly
        assert torch.equal(loaded[n], trained[n].float()), n

"""The port's training loop, train-state checkpoints and training entry
point on the CPU (mirroring tests/test_resume.py and
tests/test_observability.py of the JAX package), for task_mode tts, asr
and mix, and the VAE's entry point (train_vae) with its export and the
eval CLI (eval_vae) on it.

Bounds: exact ones but three. Restored tensors and optimizer state are
compared bit for bit; checkpoint retention is compared with orbax's
manager under the options the JAX package sets; MFU is checked against
its own formula to 1e-6 relative (float arithmetic on logged values); the
optimizer over a mix's tasks against optax to 1e-6 of the largest value
(fp32 Adam arithmetic, the schedule in float64 here, the bound of
tests/test_torch_train_tts.py); the exported VAE's decode in both
packages to 1e-5 of its largest value (fp32 convolutions summed in
another order).
"""

import json
import os

import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from audio_calm_torch.config import CALMConfig, TrainingConfig, load_config
from audio_calm_torch.data import synth_corpus
from audio_calm_torch.models.calm import QwenCALM
from audio_calm_torch.train import checkpoint as tckpt
from audio_calm_torch.train import train_calm
from audio_calm_torch.train.loop import run_training
from audio_calm_torch.train.optim import AdamW, calm_param_label
from audio_calm_torch.utils import profiling
from audio_calm_tpu.config import TrainingConfig as JTrainingConfig
from audio_calm_tpu.train.checkpoint import make_manager as j_make_manager
from audio_calm_tpu.train.optim import calm_param_label as j_label
from audio_calm_tpu.train.optim import make_optimizer as j_make_optimizer

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
    assert "dataset: 20 tts + 0 asr items" in log and "[step 2] eval_loss=" in log
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


# --------------------------------------------------------------------------
# ASR and the mix
# --------------------------------------------------------------------------
MIX_DATA = """\
data:
  task_mode: {mode}
  task_prob_tts: 0.5
  datasets:
    asr:
      latent_dir: {store}/train/LibriSpeech
      eval_latent_dir: {store}/dev/LibriSpeech
      subsets: train-clean-100
    tts:
      latent_dir: {store}/train/LibriTTS_R
      eval_latent_dir: {store}/dev/LibriTTS_R
      subsets: train-clean-100
  eval_subsets: dev-clean
  max_text_len: 96
  max_audio_len: 48
  audio_buckets: [24, 48]
  length_group_window: 2
  asr_text_pad: 32
  asr_pack_rows: 4
  asr_pack_len: 160
  asr_pack_segments: 2
  tts_pack_rows: 4
  tts_pack_len: 128
  tts_pack_segments: 2
training:
  output_dir: {out}
  per_device_train_batch_size: 4
  gradient_accumulation_steps: 2
  microbatch_steps: 4
  tts_microbatch_steps: 2
"""


def _mix_yaml(tmp_path, store, out, mode):
    """TINY_YAML's model and training with both tasks' data: packed ASR
    rows in 4 slices, packed TTS rows in 2, updates every 2 steps."""
    model = TINY_YAML[:TINY_YAML.index("data:")]
    train = TINY_YAML[TINY_YAML.index("training:"):].split("\n", 2)[2]
    path = tmp_path / f"{mode}.yaml"
    path.write_text(model + MIX_DATA.replace("{mode}", mode).replace(
        "{store}", str(store)).replace("{out}", str(out)) + train)
    return path


@pytest.mark.parametrize("mode, steps", [("asr", 3), ("mix", 4)])
def test_train_calm_asr_and_mix_on_cpu(tmp_path, capsys, mode, steps):
    """train_calm in-process on a store with both tasks: task_mode asr
    trains packed ASR steps only; the mix (seed 42) trains both tasks'
    packed steps on one optimizer, whose update count runs across them;
    evals (over both tasks in the mix), checkpoints, and the components
    loaded back through load_component."""
    store, out = tmp_path / "store", tmp_path / "out"
    assert synth_corpus.main(["--out", str(store), "--asr-n", "16",
                              "--tts-n", "16", "--dev-n", "4",
                              "--latent-dim", "8", "--chunk", "8"]) == 0
    argv = ["--config", str(_mix_yaml(tmp_path, store, out, mode)),
            "--byte-tokenizer", "--device", "cpu", "--max-steps", str(steps)]
    run = train_calm.train(argv)
    log = capsys.readouterr().out
    tts = 16 if mode == "mix" else 0
    assert f"dataset: {tts} tts + 16 asr items" in log
    assert "asr_packed step: " in log and ("tts_packed step: " in log) == (
        mode == "mix")
    assert "[step 2] eval_loss=" in log
    assert sorted(run.steps) == (["asr_packed", "tts_packed"]
                                 if mode == "mix" else ["asr_packed"])
    kinds = ["asr" if "loss_asr" in r else "tts" for r in run.history]
    assert [r["step"] for r in run.history] == list(range(1, steps + 1))
    assert set(kinds) == ({"asr", "tts"} if mode == "mix" else {"asr"})
    for r in run.history:
        assert np.isfinite(r["loss"]) and r["loss_den"] > 0
        assert r["samples_per_sec"] > 0
    # one optimizer: `steps` calls, MultiSteps updates every 2 across tasks
    assert run.optimizer.count == steps // 2
    assert tckpt.make_manager(out, 2, "loss").all_steps() == [2, steps]
    comp = run.components_dir
    listed = json.load(open(os.path.join(comp, "components.json")))
    assert {"lora", "asr_flow_head", "asr_query_embed"} <= set(
        listed["components"])
    trained = tckpt.component_state_dict(run.model)
    assert "in_proj" in tckpt.load_component(comp, "asr_flow_head")
    fresh = QwenCALM(load_config(str(_mix_yaml(tmp_path, store, out, mode)),
                                 cls=CALMConfig).model)
    tckpt.soft_restart(fresh, {c: comp for c in tckpt.COMPONENTS + ("lora",)})
    loaded = fresh.state_dict()
    for n, v in trained.items():
        assert torch.equal(loaded[n], v.float()), n


MIX_PARAMS = {  # JAX paths: both tasks' heads and what they share
    ("tts_flow_head", "in_proj", "kernel"): (4, 3),
    ("tts_len_predictor", "fc1", "bias"): (5,),
    ("asr_flow_head", "in_proj", "kernel"): (4, 3),
    ("asr_cross_attn", "q_proj", "bias"): (4,),
    ("asr_query_embed", "embedding"): (6, 4),
    ("llm", "layers_0", "self_attn", "q_proj", "lora_a"): (4, 2),
    ("soa_embed",): (1, 1, 4),
}
ASR_ONLY = ("asr_flow_head", "asr_cross_attn", "asr_query_embed")
TTS_ONLY = ("tts_flow_head", "tts_len_predictor", "tts_dur_predictor")


def test_idle_task_moves_by_decay_as_in_jax():
    """The mix's one optimizer over tasks that alternate: each step's
    other-task tensors get no gradient (None in the port, zeros in JAX's
    tree) and still move by AdamW's momentum and decay, and MultiSteps
    accumulates a TTS and an ASR batch into one update, as optax does."""
    cfg = dict(learning_rate=1e-2, weight_decay=0.1, warmup_ratio=0.0,
               gradient_accumulation_steps=2, max_grad_norm=0.5)
    rng = np.random.default_rng(6)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in MIX_PARAMS.items()}
    names = {k: "/".join(k) for k in MIX_PARAMS}
    labels = {k: calm_param_label(k, task_mode="mix") for k in MIX_PARAMS}
    assert labels == {k: j_label(k, task_mode="mix") for k in MIX_PARAMS}
    tx = j_make_optimizer(JTrainingConfig(**cfg), init,
                          lambda k: j_label(k, task_mode="mix"), 6)
    state, jparams = tx.init(init), dict(init)
    tparams = {names[k]: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = AdamW(tparams, {names[k]: labels[k] for k in MIX_PARAMS},
                TrainingConfig(**cfg), 6)
    before = None
    for i, task in enumerate(["tts", "asr", "asr", "tts", "tts", "tts"]):
        idle = ASR_ONLY if task == "tts" else TTS_ONLY
        g = {k: (np.zeros(s, np.float32) if k[0] in idle else
                 rng.standard_normal(s).astype(np.float32))
             for k, s in MIX_PARAMS.items()}
        upd, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step({names[k]: None if k[0] in idle else torch.from_numpy(v)
                  for k, v in g.items()})
        for k in MIX_PARAMS:
            ref = np.asarray(jparams[k])
            err = np.max(np.abs(tparams[names[k]].numpy() - ref))
            assert err <= 1e-6 * np.max(np.abs(ref)), (i, k)
        if i == 3:
            before = {k: tparams[names[k]].clone() for k in MIX_PARAMS}
    assert opt.count == 3
    # steps 5-6 were TTS batches only: the ASR heads moved all the same
    for k in MIX_PARAMS:
        if k[0] in ASR_ONLY:
            assert not torch.equal(tparams[names[k]], before[k]), k


# --------------------------------------------------------------------------
# the VAE's entry point
# --------------------------------------------------------------------------
VAE_YAML = """\
model:
  hidden_channels: 32
  latent_channels: 8
  norm_num_groups: 8
  strides: [2, 2]
data:
  data_dir: {store}/train
  eval_data_dir: {store}/dev
  train_subsets: "train-clean-100"
  eval_subsets: "dev-clean"
  crop_size: 64
training:
  output_dir: {out}
  run_name: vae_tiny
  per_device_train_batch_size: 4
  per_device_eval_batch_size: 4
  learning_rate: 1e-3
  lr_scheduler_type: cosine
  warmup_ratio: 0.05
  num_train_epochs: 1
  logging_steps: 1
  save_steps: 2
  eval_steps: 2
  save_total_limit: 2
  bf16: true
  seed: 42
"""


def _mel_store(root):
    rng = np.random.default_rng(9)
    for split, subset, n in (("train", "train-clean-100", 14),
                             ("dev", "dev-clean", 5)):
        d = root / split / subset / "19" / "198"
        d.mkdir(parents=True)
        for i in range(n):
            T = int(rng.integers(48, 90))  # around the crop of 64
            np.savez(d / f"19-198-{i:04d}.npz", mel=(
                rng.standard_normal((T, 80)) * 2.0 - 6.5).astype(np.float32))


def test_train_vae_entry_point_on_cpu(tmp_path, capsys):
    """`python -m audio_calm_torch.train.train_vae --device cpu
    --max-steps 3` in-process on a narrow VAE over a tiny mel store: an
    eval and a checkpoint at step 2, the final step saved, a second run
    resuming from it to step 5; the exported vae.bin (with its
    vae_config.json) loads through the port's load_vae and through the
    JAX package's, and both decode a latent to the same mel (1e-5 of its
    largest value: fp32 convolutions summed in another order)."""
    import jax

    from audio_calm_torch.models.vae import load_vae
    from audio_calm_torch.train import train_vae
    from audio_calm_tpu.models.vae import load_vae as j_load_vae

    store, out1, out2 = tmp_path / "mels", tmp_path / "run1", tmp_path / "run2"
    _mel_store(store)
    cfg_path = tmp_path / "vae.yaml"
    cfg_path.write_text(VAE_YAML.replace("{store}", str(store)).replace(
        "{out}", str(out1)))
    argv = ["--config", str(cfg_path), "--device", "cpu"]
    run = train_vae.train(argv + ["--max-steps", "3"])
    log = capsys.readouterr().out
    assert "train files: 14" in log and "vae step: " in log
    assert run.step_flops > 0 and run.total_steps == 3
    recs = [json.loads(l) for l in open(out1 / "metrics.jsonl")]
    train_recs = [r for r in recs if "loss" in r]
    assert [r["step"] for r in train_recs] == [1, 2, 3]
    for r in train_recs:
        assert all(np.isfinite(r[k]) for k in (
            "loss", "rec_loss", "ssim_loss", "stft_loss", "kl_loss",
            "mu_std", "var_mean", "grad_norm", "samples_per_sec"))
    assert [r["step"] for r in recs if "eval_loss" in r] == [2]
    assert tckpt.make_manager(str(out1), 2).all_steps() == [2, 3]
    with pytest.raises(RuntimeError, match="torchrun's variables"):
        train_vae.train(argv + ["--distributed"])

    run2 = train_vae.train(argv + [
        "--max-steps", "5", "--override", f"training.output_dir={out2}",
        "--override", f"training.resume_from_checkpoint={out1}"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert [r["step"] for r in run2.history] == [4, 5]
    assert run2.optimizer.count == 5

    path = run2.export_path
    assert path == str(out2 / "vae.bin")
    assert json.load(open(out2 / "vae_config.json"))["hidden_channels"] == 32
    mine = load_vae(path, device="cpu")
    trained = run2.model.state_dict()
    for n, v in mine.state_dict().items():
        assert torch.equal(v, trained[n]), n
    jmodel, jparams = j_load_vae(path)
    assert jmodel.cfg.hidden_channels == 32
    z = np.random.default_rng(1).standard_normal((1, 16, 8)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        p, x, method=type(jmodel).decode))(jparams, z))
    with torch.no_grad():
        got = mine.decode(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (1, 64, 80)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))

    # the eval CLI on the exported file: the dev crops' statistics (its
    # loop is held against scripts/eval_vae.py's in tests/test_torch_vae.py)
    from audio_calm_torch.eval import eval_vae

    wavs = tmp_path / "wavs"
    stats = eval_vae.evaluate(argv + ["--ckpt", path, "--write-wavs",
                                      "--out-dir", str(wavs)])
    log = capsys.readouterr().out
    assert "samples: 5" in log and f"recon MSE: {stats['mse']:.5f}" in log
    assert len(stats["recons"]) == 5 and np.isfinite(stats["kl_mean"])
    assert sorted(os.listdir(wavs)) == sorted(
        f"{i}_{t}.wav" for i in range(5) for t in ("orig", "recon"))

"""Few-step distillation in the PyTorch port vs the JAX package, fp32 on
the CPU on the 2-layer tiny config of tests/test_distill.py:
`make_distill_step` (TTS and ASR), `split_for_distill`, the
--perturb-teacher draws and `distill_calm` in-process.

Bounds, each with its reason:
  - one distillation step (the same weights, JAX's x0 injected): the loss,
    grad_norm, every head gradient and every head tensor after one AdamW
    update within 2e-4 of the tensor's largest value, at least 2e-8 (the
    bound of tests/test_torch_train_tts.py: fp32 through a 2-layer LLM,
    the alignment and K x M head evaluations, summed in another order; a
    gradient that is zero but for rounding, as the key bias's, sits at
    the floor).
  - the perturbation: bit for bit (the same numpy draws added in fp32 to
    the same values, in the same leaf order).
  - the exported components: bit for bit (fp32 through the reference
    layout).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import unflatten_dict

from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import TrainingConfig as TTrainingConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.data import synth_corpus
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import from_jax_params, load_calm
from audio_calm_torch.models.flagship import random_normal_
from audio_calm_torch.train import checkpoint as tckpt
from audio_calm_torch.train import distill_calm
from audio_calm_torch.train.distill import (make_distill_step, perturb_head,
                                            split_for_distill)
from audio_calm_torch.train.optim import AdamW
from audio_calm_tpu.config import (CALMModelConfig, LoRAConfig, Qwen2Config,
                                   TrainingConfig)
from audio_calm_tpu.models.calm import QwenCALM, init_calm_params
from audio_calm_tpu.train.distill import distill_param_label as j_label
from audio_calm_tpu.train.distill import make_distill_step as j_make_step
from audio_calm_tpu.train.distill import split_for_distill as j_split
from audio_calm_tpu.train.optim import make_optimizer
from audio_calm_tpu.train.steps import init_train_state

B, T_TXT, T_AUD, LAT = 3, 6, 16, 8
SIGMA = 0.05
# the shipped recipes' LR: Adam's first update is g / (|g| + eps) times the
# LR, so a gradient near eps moves its tensor by up to 2 x LR x head_lr_mult
# for a rounding of the gradient; at 5e-5 that stays inside the bound
OPT = dict(learning_rate=5e-5, lr_scheduler_type="constant",
           weight_decay=0.01, max_grad_norm=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg():
    return CALMModelConfig(
        latent_dim=LAT, max_audio_len=T_AUD, max_text_len=8,
        tts_flow_hidden_dim=64, tts_flow_num_layers=2,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=Qwen2Config.tiny(vocab_size=64),
        lora=LoRAConfig(rank=4, alpha=8, dropout=0.0), cfg_dropout_prob=0.1)


def _jax_noise(tree, npr, sigma):
    """scripts/distill_calm.py's `_noise`, as it is written there."""
    if isinstance(tree, dict):
        return {k: _jax_noise(v, npr, sigma) for k, v in tree.items()}
    arr = np.asarray(tree)
    if not np.issubdtype(arr.dtype, np.floating):
        return tree
    return jnp.asarray(arr + npr.normal(0, sigma, arr.shape).astype(
        arr.dtype))


@pytest.fixture(scope="module")
def models():
    """JAX weights -> (config, params): the tree of init_calm_params (its
    leaf order included), traced, not run; values from numpy (kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2), the rest N(0, 0.05^2),
    as in tests/test_torch_asr_train.py)."""
    cfg = _cfg()
    shapes = jax.eval_shape(lambda: init_calm_params(
        QwenCALM(cfg, dtype=jnp.float32), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape)
        if name == "kernel":
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            z = 1.0 + 0.05 * z if name == "scale" else 0.05 * z
        return z.astype(np.float32)  # the dtype of flax's parameters

    return cfg, jax.tree_util.tree_map_with_path(draw, shapes)


def _port(cfg, params):
    model = TQwenCALM(from_dict(TCALMConfig, dataclasses.asdict(cfg)))
    load_calm(model, params)
    return model


def _batch(task, seed=0):
    rng = np.random.default_rng(seed)
    tmask = np.arange(T_TXT)[None] < np.array([T_TXT, 4, 3])[:, None]
    out = dict(text_ids=(rng.integers(1, 64, (B, T_TXT)) * tmask).astype(
        np.int32), attention_mask=tmask.astype(np.int32))
    if task == "asr":
        amask = np.arange(T_AUD)[None] < np.array([T_AUD, 12, 9])[:, None]
        out["latents"] = (rng.standard_normal((B, T_AUD, LAT))
                          * amask[..., None]).astype(np.float32)
        out["audio_mask"] = amask.astype(np.int32)
    return out


def _capturing(tx):
    """tx whose state also keeps the gradients it was last given."""
    def init(params):
        return (jax.tree_util.tree_map(jnp.zeros_like, params),
                tx.init(params))

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.max(np.abs(got - ref))
    assert err <= 2e-4 * max(np.max(np.abs(ref)), 1e-4), (what, err)


@pytest.mark.parametrize("task, K, M, cfg_scale",
                         [("tts", 4, 8, 2.0), ("asr", 2, 4, 1.0)])
def test_distill_step_matches_jax(models, task, K, M, cfg_scale):
    """One step of JAX's jitted make_distill_step and the port's on the
    same weights (the task head perturbed as --perturb-teacher does) and
    JAX's x0: TTS at cfg 2.0 (the 2B teacher batch), K = 4, M = 8 on a
    16-frame grid; ASR at cfg 1.0, K = 2, M = 4 on the 8-query grid."""
    cfg, params = models
    head = f"{task}_flow_head"
    params = dict(params, **{head: _jax_noise(
        params[head], np.random.default_rng(0), SIGMA)})
    batch = _batch(task)
    jmodel = QwenCALM(cfg, dtype=jnp.float32)
    trainable, frozen_wt = j_split(params, task)
    tx = _capturing(make_optimizer(TrainingConfig(**OPT), trainable,
                                   lambda k: j_label(k, task), 10))
    rng = jax.random.PRNGKey(3)
    t_grid = 16 if task == "tts" else None
    new_state, jm = jax.jit(j_make_step(
        jmodel, tx, task, student_steps=K, cfg_scale=cfg_scale,
        teacher_substeps=M, t_grid=t_grid))(
        init_train_state(trainable, tx), frozen_wt,
        {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    x_dim = LAT if task == "tts" else cfg.qwen.hidden_size
    T = 16 if task == "tts" else cfg.max_text_len
    x0 = np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.fold_in(rng, 0), 0), (B, T, x_dim),
        jnp.float32))

    model = _port(cfg, params)
    teacher, labels = split_for_distill(model, task)
    tparams = {n: p for n, p in model.named_parameters() if p.requires_grad}
    opt = AdamW(tparams, labels, TTrainingConfig(**OPT), 10)
    step = make_distill_step(model, teacher, opt, task, student_steps=K,
                             cfg_scale=cfg_scale, teacher_substeps=M,
                             t_grid=t_grid)
    tm = step({k: torch.from_numpy(v) for k, v in batch.items()},
              x0=torch.from_numpy(x0.copy()))
    assert float(jm["loss"]) > 1e-4  # a perturbed head: a real target
    for k in ("loss", "loss_distill", "grad_norm"):
        _close(tm[k], jm[k], k)
    grads = from_jax_params(unflatten_dict(
        {k: np.asarray(v) for k, v in new_state.opt_state[0].items()}))
    after = from_jax_params(unflatten_dict(
        {k: np.asarray(v) for k, v in new_state.trainable.items()}))
    assert set(grads) == set(tparams) and all(
        n.startswith(head + ".") for n in tparams)
    for n, p in tparams.items():
        _close(p.grad.numpy(), grads[n].numpy(), f"grad {n}")
        _close(p.detach().numpy(), after[n].numpy(), f"after {n}")


def test_perturb_teacher_draws_match_the_jax_script(models):
    """perturb_head adds the JAX script's draws (default_rng(0), the JAX
    tree's leaf order) to the same leaves, bit for bit, per task."""
    cfg, params = models
    model = _port(cfg, params)
    for task in ("tts", "asr"):
        head = f"{task}_flow_head"
        want = from_jax_params({head: jax.tree_util.tree_map(
            np.asarray, _jax_noise(params[head], np.random.default_rng(0),
                                   SIGMA))})
        perturb_head(model, task, SIGMA)
        got = model.state_dict()
        assert len(want) > 10
        for n, v in want.items():
            assert torch.equal(got[n], v), n


def test_split_for_distill_trains_the_head_alone():
    """The teacher equals the student at step 0 and stays as it was after
    a step; only the head trains, in fp32; every other tensor is frozen
    and unchanged."""
    cfg = from_dict(TCALMConfig, dataclasses.asdict(_cfg()))
    model = TQwenCALM(cfg)
    random_normal_(model, seed=1, scale=0.1)
    before = {n: v.clone() for n, v in model.state_dict().items()}
    teacher, labels = split_for_distill(model, "tts")
    t_sd = teacher.state_dict()
    s_sd = model.tts_flow_head.state_dict()
    assert set(t_sd) == set(s_sd) and all(
        torch.equal(t_sd[k], s_sd[k]) for k in t_sd)
    assert not any(p.requires_grad for p in teacher.parameters())
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trainable == {n for n, lab in labels.items() if lab == "head"}
    assert trainable == {n for n in before if n.startswith("tts_flow_head.")}
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    opt = AdamW(params, labels, TTrainingConfig(**OPT), 10)
    step = make_distill_step(model, teacher, opt, "tts", student_steps=2,
                             cfg_scale=2.0, teacher_substeps=2, t_grid=16)
    m = step({k: torch.from_numpy(v) for k, v in _batch("tts").items()})
    assert np.isfinite(float(m["loss"])) and step.count == 1
    assert all(torch.equal(teacher.state_dict()[k], t_sd[k]) for k in t_sd)
    after = model.state_dict()
    moved = {n for n in before if not torch.equal(after[n], before[n])}
    assert moved and moved <= trainable


TINY_YAML = """\
model:
  latent_dim: 8
  max_text_len: 96
  max_audio_len: 32
  tts_flow_hidden_dim: 32
  tts_flow_num_layers: 1
  asr_flow_hidden_dim: 32
  asr_flow_num_layers: 1
  flow_num_heads: 4
  lora: {rank: 2, alpha: 4, dropout: 0.05}
  qwen: {vocab_size: 258, hidden_size: 64, intermediate_size: 128, \
num_hidden_layers: 2, num_attention_heads: 4, num_key_value_heads: 2, \
head_dim: 16, rope_theta: 10000.0}
data:
  task_mode: {task}
  datasets:
    asr:
      latent_dir: {store}/train/LibriSpeech
      subsets: train-clean-100
    tts:
      latent_dir: {store}/train/LibriTTS_R
      subsets: train-clean-100
  max_text_len: 96
  max_audio_len: 32
training:
  output_dir: {out}
  run_name: tiny
  per_device_train_batch_size: 4
  learning_rate: 1e-3
  logging_steps: 1
  save_steps: 2
  save_total_limit: 2
  seed: 42
evaluation:
  cfg_scale: 2.0
"""


@pytest.mark.parametrize("task", ["tts", "asr"])
def test_distill_calm_on_cpu(tmp_path, capsys, task):
    """`python -m audio_calm_torch.train.distill_calm --device cpu
    --byte-tokenizer --perturb-teacher 0.05 --max-steps 3` in-process on a
    2-layer config over a synthetic store: 3 steps under
    <output_dir>/distill_<task>, checkpoints at 2 and 3, the probe
    printed, the components loaded back by load_component equal to the
    distilled head, the teacher unchanged."""
    store, out = tmp_path / "store", tmp_path / "out"
    assert synth_corpus.main(["--out", str(store), "--asr-n", "12",
                              "--tts-n", "12", "--dev-n", "2",
                              "--latent-dim", "8", "--chunk", "10"]) == 0
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_YAML.replace("{store}", str(store)).replace(
        "{out}", str(out)).replace("{task}", task))
    run = distill_calm.distill([
        "--config", str(cfg_path), "--task", task, "--byte-tokenizer",
        "--device", "cpu", "--max-steps", "3", "--perturb-teacher", "0.05",
        "--student-steps", "2", "--teacher-substeps", "2"])
    log = capsys.readouterr().out
    assert f"teacher {task}_flow_head perturbed with sigma=0.05" in log
    assert ("teacher cfg=2.0" if task == "tts" else "teacher cfg=1.0") in log
    probe = json.loads(log.split("quality probe (teacher-dense reference): ")
                       [1].splitlines()[0])
    keys = (("rel_err_student", "rel_err_teacher_coarse") if task == "tts"
            else ("token_agreement_student",
                  "token_agreement_teacher_coarse"))
    assert set(probe) == set(keys) and probe == run.probe
    assert all(np.isfinite(v) for v in probe.values())
    assert "serve with: evaluation.ode_method=euler" in log
    root = out / f"distill_{task}"
    recs = [json.loads(l) for l in open(root / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 3] == [
        r["step"] for r in run.history]
    assert all(np.isfinite(r["loss_distill"]) and r["loss"] > 0
               for r in recs)
    assert tckpt.make_manager(str(root), 2).all_steps() == [2, 3]
    assert run.components_dir == str(root / "components")
    head = f"{task}_flow_head"
    tree = tckpt.load_component(run.components_dir, head)
    loaded = from_jax_params({head: tree})
    trained = run.model.state_dict()
    assert len(loaded) > 10
    for n, v in loaded.items():
        assert torch.equal(v, trained[n].float()), n
    moved = [n for n, v in run.teacher.state_dict().items()
             if not torch.equal(v, trained[f"{head}.{n}"])]
    assert moved  # the student left the teacher
    with pytest.raises(RuntimeError, match="torchrun's variables"):
        distill_calm.distill(["--config", str(cfg_path), "--distributed"])
    assert os.path.isfile(os.path.join(run.components_dir,
                                       "components.json"))

"""The port's tensor-parallel training step (train/steps.shard_step over a
(data 1, model 2) mesh of two CPU entries) vs the JAX package and vs the
port's one-device step, on the CPU at the geometry of
tests/test_tensor_parallel.py::_setup (Qwen2Config.tiny: 4 q / 2 kv heads,
so 2 / 1 a shard; LoRA rank 2; fp32).

Bounds, each with its reason:
  - against JAX (`jax.value_and_grad` of forward_tts / forward_asr on the
    same converted weights, JAX's flow draws injected): every loss term and
    every trainable gradient within 2e-4 of the largest value of the
    tensor, at least 2e-8 (tests/test_torch_train_tts.py's bound: fp32
    through a 2-layer LLM, MAS and a DiT, summed in another order).
  - against the one-device step (make_calm_step, LoRA dropout 0.05,
    microbatch 2, one update): every metric, gradient, updated trainable
    and Adam moment within 1e-5 of the largest value of its tensor, and
    at least 1e-7 of the largest over all tensors (about two fp32 steps of
    it: the rounding noise of a gradient that is zero analytically, such
    as the DiT's key biases): the same draws and the same ops, only the
    split sums add in another order. The learning rate is
    small (1e-6): Adam's first update is g / (|g| + eps) x LR, which moves
    a tensor whose gradient is rounding noise by up to LR.
  - dropout columns, placement and checkpoints: exact.
"""

import copy
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import audio_calm_tpu.models.calm as jcalm
from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import TrainingConfig as TTrainingConfig
from audio_calm_torch.config import from_dict, load_config
from audio_calm_torch.data import collator as tcol
from audio_calm_torch.data.datasets import CalmExample
from audio_calm_torch.models import lora as tlora
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import (from_jax_params, jax_path,
                                             load_calm)
from audio_calm_torch.models.qwen2 import Qwen2Attention
from audio_calm_torch.ops.dropout import draw, row_shard
from audio_calm_torch.parallel import tp_shard
from audio_calm_torch.parallel.mesh import make_mesh, zero_leaf_spec
from audio_calm_torch.parallel.tp import tp_shardings
from audio_calm_torch.train import optim as toptim
from audio_calm_torch.train.checkpoint import (make_manager,
                                               restore_train_state,
                                               save_train_state)
from audio_calm_torch.train.steps import (ASR_KEYS, TTS_KEYS, make_calm_step,
                                          shard_step)
from audio_calm_tpu.config import CALMModelConfig, LoRAConfig, Qwen2Config
from audio_calm_tpu.models.calm import QwenCALM, init_calm_params
from audio_calm_tpu.ops.flow import compute_flow_loss

B, T_TXT, T_AUD, LAT, V = 4, 6, 16, 8, 128
PROMPT = np.asarray([5, 6, 7], np.int32)
TP2 = ["cpu", "cpu"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = {"tts": "tts", "tts_packed": "tts", "asr": "asr",
         "asr_packed": "asr"}  # step task -> task_mode


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(**qwen):
    return CALMModelConfig(
        latent_dim=LAT, max_audio_len=T_AUD, max_text_len=8,
        tts_flow_hidden_dim=32, tts_flow_num_layers=1,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=dataclasses.replace(Qwen2Config.tiny(vocab_size=V), **qwen),
        lora=LoRAConfig(rank=2, alpha=4, dropout=0.0),
        latent_mean=0.1, latent_std=1.2)


def _jax_params(cfg, seed=0):
    """JAX's tree for `cfg`: shapes traced from init_calm_params, values
    from numpy (kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2), the
    rest N(0, 0.05^2), so LoRA's b and the DiT's output are not zero)."""
    model = QwenCALM(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: init_calm_params(model,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.05 * z if path[-1].key == "scale" else 0.05 * z

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    model, params = _jax_params(cfg)
    return model, cfg, params


def _port_model(params, cfg, lora_dropout=0.0, **overrides):
    tcfg = from_dict(TCALMConfig, dataclasses.asdict(cfg))
    tcfg = dataclasses.replace(
        tcfg, lora=dataclasses.replace(tcfg.lora, dropout=lora_dropout),
        **overrides)
    model = TQwenCALM(tcfg)
    load_calm(model, {"params": params})
    return model


def _tp(model):
    return shard_step(model, make_mesh(1, 2, TP2))


def _plain_batch(task, seed=0):
    rng = np.random.default_rng(seed)
    amask = np.arange(T_AUD)[None] < rng.integers(8, T_AUD + 1, B)[:, None]
    amask[0] = True
    out = dict(latents=rng.standard_normal((B, T_AUD, LAT)).astype(
        np.float32), audio_mask=amask.astype(np.int32))
    if task == "tts":
        tmask = np.arange(T_TXT)[None] < rng.integers(2, T_TXT + 1,
                                                      B)[:, None]
        tmask[0] = True
        out.update(text_ids=(rng.integers(1, V, (B, T_TXT)) * tmask).astype(
            np.int32), attention_mask=tmask.astype(np.int32))
    else:
        lab = rng.integers(1, V, (B, 8)).astype(np.int32)
        lab[np.arange(8)[None] >= rng.integers(1, 9, B)[:, None]] = -100
        out.update(text_ids=np.tile(PROMPT, (B, 1)),
                   attention_mask=np.ones((B, len(PROMPT)), np.int32),
                   labels=lab)
    return out


def _packed_batch(task, seed=0):
    """4 rows x 2 slots of FFD-packed utterances (one dummy slot)."""
    rng = np.random.default_rng(seed)
    n = 7
    if task == "tts_packed":
        exs = [CalmExample(rng.integers(1, V, int(k)).astype(np.int32),
                           np.zeros(0, np.int32),
                           rng.standard_normal((int(a), LAT)).astype(
                               np.float32), "tts")
               for k, a in zip(rng.integers(2, 9, n),
                               rng.integers(8, T_AUD + 1, n))]
        batch, left = tcol.pack_tts_window(exs, 4, 18, 2, T_AUD, LAT, 8)
    else:
        exs = [CalmExample(PROMPT.copy(),
                           rng.integers(1, V, int(k)).astype(np.int32),
                           rng.standard_normal((int(a), LAT)).astype(
                               np.float32), "asr")
               for k, a in zip(rng.integers(1, 9, n),
                               rng.integers(5, T_AUD + 1, n))]
        batch, left = tcol.pack_asr_window(exs, PROMPT, 4,
                                           2 * (T_AUD + 1 + len(PROMPT)), 2,
                                           T_AUD, LAT, 8)
    assert not left
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _trainable(model):
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


# --------------------------------------------------------------------------
# against JAX: loss terms and every trainable gradient
# --------------------------------------------------------------------------
@pytest.mark.parametrize("task", ["tts", "asr"])
def test_tp_forward_and_grads_match_jax(setup, monkeypatch, task):
    model, cfg, params = setup
    batch = _plain_batch(task, seed=3)
    keys = TTS_KEYS if task == "tts" else ASR_KEYS
    method = QwenCALM.forward_tts if task == "tts" else QwenCALM.forward_asr
    seen = []

    def recording(head_fn, rng, condition, target, *a, **kw):
        seen.append((rng, target.shape))
        return compute_flow_loss(head_fn, rng, condition, target, *a, **kw)

    monkeypatch.setattr(jcalm, "compute_flow_loss", recording)

    @jax.jit
    @functools.partial(jax.value_and_grad, has_aux=True)
    def loss_fn(p):
        out = model.apply({"params": p}, *(jnp.asarray(batch[k])
                                            for k in keys),
                          train=False, rngs={"flow": jax.random.PRNGKey(2)},
                          method=method)
        return out["loss"], (out, seen[-1][0])

    (_, (ref, key)), grads = loss_fn(params)
    monkeypatch.undo()
    _, r_t, r_x0 = jax.random.split(key, 3)
    shape = seen[-1][1]
    t = torch.from_numpy(np.array(jax.random.uniform(
        r_t, (shape[0],), dtype=jnp.float32)))
    x0 = torch.from_numpy(np.array(jax.random.normal(r_x0, shape,
                                                     jnp.float32)))

    tmodel = _port_model(params, cfg)
    labels = toptim.freeze(tmodel, TTrainingConfig(), task_mode=task)
    rep = _tp(tmodel)
    assert isinstance(rep.llm.layers[1].self_attn, tp_shard.TPAttention)
    forward = getattr(rep, method.__name__)
    out = forward(*(torch.from_numpy(batch[k]) for k in keys), train=False,
                  t=t, x0=x0)
    out["loss"].backward()
    for k in ("loss", "loss_tts", "loss_len", "loss_dur") if task == "tts" \
            else ("loss", "loss_asr"):
        val, want = float(out[k].detach()), float(ref[k])
        assert abs(val - want) <= 2e-4 * abs(want), k
    gflat, gport = flatten_dict(grads), from_jax_params(grads)
    n_checked = 0
    for name, p in _trainable(rep).items():
        assert labels[name] != "frozen" and jax_path(tmodel, name) in gflat
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        ref_g = gport[name].numpy()
        err = np.max(np.abs(g - ref_g))
        assert err <= 2e-4 * max(np.max(np.abs(ref_g)), 1e-4), (name, err)
        n_checked += 1
    assert n_checked == sum(lab != "frozen" for lab in labels.values()) > 30


# --------------------------------------------------------------------------
# against the one-device step
# --------------------------------------------------------------------------
def _close_tensors(got, ref, what, tol=1e-5):
    ref = {n: r.detach() for n, r in ref.items()}
    top = max(float(r.abs().max()) for r in ref.values())
    for n, r in ref.items():
        err = float((got[n].detach() - r).abs().max())
        assert err <= tol * max(float(r.abs().max()), 1e-2 * top), (
            what, n, err)


def _one_step(model, labels, batch, task, tcfg):
    params = _trainable(model)
    opt = toptim.AdamW(params, labels, tcfg, total_steps=10)
    step = make_calm_step(model, opt, task, microbatch=2, seed=3)
    step.count = 1
    metrics = {k: float(v) for k, v in step(_torch(batch)).items()}
    grads = {n: p.grad.clone() for n, p in params.items()
             if p.grad is not None}
    return metrics, grads, opt


STEP_CFG = TTrainingConfig(learning_rate=1e-6, warmup_ratio=0.0,
                           lr_scheduler_type="constant")


@pytest.mark.parametrize("task", list(TASKS))
def test_tp_step_matches_one_device_step(setup, task):
    """One make_calm_step update in train mode (LoRA dropout 0.05, CFG
    drop and flow noise drawn), microbatch 2: the TP replica's metrics,
    gradients, updated trainables and moments against the one-device
    model's."""
    _, cfg, params = setup
    batch = (_plain_batch(task, seed=5) if task in ("tts", "asr")
             else _packed_batch(task, seed=5))
    one = _port_model(params, cfg, lora_dropout=0.05)
    labels = toptim.freeze(one, STEP_CFG, task_mode=TASKS[task])
    rep = _tp(copy.deepcopy(one))
    assert list(_trainable(rep)) == list(_trainable(one))
    m1, g1, o1 = _one_step(one, labels, batch, task, STEP_CFG)
    m2, g2, o2 = _one_step(rep, labels, batch, task, STEP_CFG)
    assert set(m1) == set(m2) and "grad_norm" in m1
    for k, v in m1.items():
        assert abs(m2[k] - v) <= 1e-5 * max(abs(v), 1e-6), (k, m2[k], v)
    assert set(g1) == set(g2) and len(g1) > 30
    _close_tensors(g2, g1, "grad")
    _close_tensors(o2.params, o1.params, "updated")
    _close_tensors(o2.mu, o1.mu, "mu")
    _close_tensors(o2.nu, o1.nu, "nu")


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------
def test_placement_splits_frozen_kernels_and_keeps_trainables_whole(setup):
    _, cfg, params = setup
    one = _port_model(params, cfg)
    labels = toptim.freeze(one, TTrainingConfig(), task_mode="tts")
    rep = _tp(copy.deepcopy(one))
    attn, mlp = rep.llm.layers[0].self_attn, rep.llm.layers[0].mlp
    assert isinstance(attn, tp_shard.TPAttention)
    assert isinstance(mlp, tp_shard.TPMLP)
    assert isinstance(rep.embed, tp_shard.TPEmbed)
    w = one.llm.layers[0].self_attn.q_proj.weight
    for j, shard in enumerate(attn.shards):
        assert shard.cfg.num_attention_heads == 2
        assert shard.cfg.num_key_value_heads == 1
        assert torch.equal(shard.q_proj.weight, w[32 * j:32 * (j + 1)])
        assert not shard.q_proj.weight.requires_grad
        d = one.llm.layers[0].mlp.down_proj.weight
        assert torch.equal(mlp.shards[j].down_proj.weight,
                           d[:, 64 * j:64 * (j + 1)])
    # the trainables: one tensor each, whole, under the one-device names
    t1, t2 = _trainable(one), _trainable(rep)
    assert list(t1) == list(t2)
    assert "llm.layers.0.self_attn.q_proj.lora_a" in t2
    for n in t1:
        assert t2[n].shape == t1[n].shape and torch.equal(t2[n], t1[n])
        assert toptim.calm_param_label(jax_path(rep, n), "tts") == labels[n]
        assert zero_leaf_spec(2, t2[n]) == zero_leaf_spec(2, t1[n])
    assert attn.q_proj.lora_a is attn.shards[1].q_proj.adapter.lora_a


HEAD_ATTN = ("tts_flow_head", "asr_flow_head", "asr_cross_attn")


@pytest.mark.parametrize("config", ["tts", "asr", "calm"])
def test_no_trainable_is_split_at_the_yaml_widths(config):
    """At configs/<config>.yaml's widths, for the tts, asr and mix label
    sets: every tensor the placement splits (the Qwen2 kernels and the
    embedding, by tp.py's rules) is frozen, so the trainables and their
    moments stay whole (train/steps.shard_step's docstring). The rules
    also split q/k/v elsewhere: only in the DiT heads and the ASR
    cross-attention, which the placement leaves whole."""
    cfg = load_config(os.path.join(REPO, "configs", f"{config}.yaml")).model
    with torch.device("meta"):
        model = TQwenCALM(cfg)
    named = dict(model.named_parameters())
    placed = tp_shard.split_dims(model, 2)
    rules = tp_shardings(named, make_mesh(1, 2, TP2))
    assert len(placed) == 7 * cfg.qwen.num_hidden_layers + 3 * \
        cfg.qwen.num_hidden_layers + 1  # weights, q/k/v biases, the table
    for n, dim in rules.items():
        if dim is not None and n not in placed:
            assert n.split(".")[0] in HEAD_ATTN and n.split(".")[-2] in (
                "q_proj", "k_proj", "v_proj"), n
    for mode in ("tts", "asr", "mix"):
        for n, dim in placed.items():
            assert rules[n] == dim
            assert toptim.calm_param_label(jax_path(model, n),
                                           mode) == "frozen", (mode, n)


def test_indivisible_heads_stay_whole_and_the_step_still_matches():
    """3 q heads do not divide by 2: the attention stays whole, the MLP
    splits, and a step equals the one-device step."""
    cfg = _cfg(hidden_size=48, num_attention_heads=3, num_key_value_heads=1)
    _, params = _jax_params(cfg, seed=1)
    one = _port_model(params, cfg)
    labels = toptim.freeze(one, STEP_CFG, task_mode="tts")
    rep = _tp(copy.deepcopy(one))
    for layer in rep.llm.layers:
        assert type(layer.self_attn) is Qwen2Attention
        assert isinstance(layer.mlp, tp_shard.TPMLP)
    batch = _plain_batch("tts", seed=2)
    m1, g1, _ = _one_step(one, labels, batch, "tts", STEP_CFG)
    m2, g2, _ = _one_step(rep, labels, batch, "tts", STEP_CFG)
    for k, v in m1.items():
        assert abs(m2[k] - v) <= 1e-5 * max(abs(v), 1e-6), k
    _close_tensors(g2, g1, "grad")


def test_shard_step_checks_the_mesh_and_the_labels(setup):
    _, cfg, params = setup
    model = _port_model(params, cfg)
    toptim.freeze(model, TTrainingConfig(), task_mode="tts")
    with pytest.raises(ValueError, match="data axis is 2"):
        shard_step(model, make_mesh(2, 2, ["cpu"] * 4))
    assert shard_step(model, make_mesh(1, 1, ["cpu"])) is model
    model.llm.layers[0].mlp.up_proj.weight.requires_grad_(True)
    with pytest.raises(ValueError, match="up_proj.weight"):
        shard_step(model, make_mesh(1, 2, TP2))


# --------------------------------------------------------------------------
# the row-split layers' dropout columns
# --------------------------------------------------------------------------
def test_draw_takes_rows_and_columns_of_the_global_draw():
    def make(shape):
        return torch.rand(shape, generator=torch.Generator().manual_seed(9))

    full = make((8, 3, 12))
    with row_shard(1, 2):
        got = draw(make, (4, 3, 6), cols=(1, 2))
    assert torch.equal(got, full[4:, :, 6:])
    assert torch.equal(draw(make, (8, 3, 4), cols=(2, 3)), full[..., 8:])
    assert torch.equal(draw(make, (8, 3, 12)), full)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_row_split_masks_are_columns_of_the_one_device_mask(
        setup, monkeypatch, remat):
    """Every LoRA dropout mask a shard draws, in the forward and in the
    checkpointed blocks' recomputation: a column-split shard's equals the
    one-device mask, a row-split shard's its columns."""
    _, cfg, params = setup
    real = tlora.dropout

    def run(model, masks):
        def recording(x, rate, seed, cols=(0, 1)):
            keep = real(torch.ones_like(x), rate, seed, cols) != 0
            masks.setdefault((seed, cols), []).append(keep)
            return real(x, rate, seed, cols)

        monkeypatch.setattr(tlora, "dropout", recording)
        b = _torch(_plain_batch("tts", seed=1))
        model.forward_tts(**b, train=True, seed=17)["loss"].backward()
        monkeypatch.undo()

    one = _port_model(params, cfg, lora_dropout=0.3, remat_policy=remat)
    toptim.freeze(one, TTrainingConfig(), task_mode="tts")
    rep = _tp(copy.deepcopy(one))
    whole, shards = {}, {}
    run(one, whole)
    run(rep, shards)
    n_row = 0
    for (seed, (j, n)), calls in shards.items():
        # the forward and the recomputation, of each shard where n = 1
        assert len(calls) == (4 if n == 1 else 2)
        ref = whole[(seed, (0, 1))][0]
        m = ref.shape[-1] // n
        for keep in calls:
            assert torch.equal(keep, ref[..., j * m:(j + 1) * m])
        n_row += n == 2
    # o_proj and down_proj of both layers, two shards each
    assert n_row == 2 * 2 * 2
    assert {s for s, _ in shards} == {s for s, _ in whole}


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
def test_tp_checkpoint_restores_into_the_one_device_run(setup, tmp_path):
    _, cfg, params = setup
    one = _port_model(params, cfg, lora_dropout=0.05)
    labels = toptim.freeze(one, STEP_CFG, task_mode="tts")
    rep = _tp(copy.deepcopy(one))
    _, _, opt = _one_step(rep, labels, _plain_batch("tts", seed=4), "tts",
                          STEP_CFG)
    manager = make_manager(str(tmp_path / "ckpt"))
    save_train_state(manager, 1, opt, {"loss": 1.0})
    fresh = toptim.AdamW(_trainable(one), labels, STEP_CFG, total_steps=10)
    assert restore_train_state(manager, fresh) == 1
    for key in ("params", "mu", "nu"):
        got, want = getattr(fresh, key), getattr(opt, key)
        assert set(got) == set(want)
        for n in want:
            assert torch.equal(got[n], want[n]), (key, n)
    assert fresh.count == opt.count == 1

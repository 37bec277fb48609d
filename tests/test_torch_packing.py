"""Packed TTS training in the PyTorch port vs the JAX package, on the CPU at
a tiny size shaped like `tiny_calm_tts` of tests/test_packing.py.

Bounds, each with its reason:
  - the pack plan (`plan_pack`, `pack_tts_window`, `materialize_tts_rows`,
    `estimate_packed_steps_per_epoch`): array-equal (integer index
    arithmetic and copies of the same numpy arrays).
  - Qwen2 hidden states under segment ids: 2e-4 of the largest value (the
    JAX package's Qwen2 bound: two fp32 decoder layers summed in another
    order).
  - forward_tts_packed's loss terms and every trainable gradient, and the
    updated tensors of one tts_packed step: 2e-4 of the largest value of
    the tensor, at least 2e-8 (fp32 through a 2-layer LLM, the MAS and a
    DiT, summed in another order; the bound of
    tests/test_torch_train_tts.py). The flow draws are JAX's, injected.
  - packed vs solo in the port: 1e-4 relative (the bound of
    tests/test_packing.py: the same utterances through other attention
    layouts and sums).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import audio_calm_torch.models.calm as tcalm_mod
import audio_calm_torch.models.qwen2 as tqwen2_mod
import audio_calm_tpu.models.calm as jcalm
from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import LoRAConfig as TLoRAConfig
from audio_calm_torch.config import Qwen2Config as TQwen2Config
from audio_calm_torch.config import TrainingConfig as TTrainingConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.data import collator as tcol
from audio_calm_torch.data.datasets import CalmExample as TExample
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import (from_jax_params, jax_path,
                                             load_calm)
from audio_calm_torch.models.qwen2 import Qwen2Model as TQwen2Model
from audio_calm_torch.ops.attention import MultiheadAttention as TMHA
from audio_calm_torch.ops.flow import compute_flow_loss as t_flow_loss
from audio_calm_torch.train import optim as toptim
from audio_calm_torch.train.steps import PACKED_KEYS, make_calm_step
from audio_calm_tpu.config import CALMModelConfig, LoRAConfig, Qwen2Config
from audio_calm_tpu.data import collator as jcol
from audio_calm_tpu.data.datasets import CalmExample
from audio_calm_tpu.models.calm import QwenCALM, init_calm_params
from audio_calm_tpu.models.calm_heads import TransformerFlowHead
from audio_calm_tpu.models.qwen2 import Qwen2Model
from audio_calm_tpu.ops.flow import compute_flow_loss
from audio_calm_tpu.train.optim import calm_param_label, partition_params
from audio_calm_tpu.train.steps import init_train_state
from audio_calm_tpu.train.steps import make_calm_step as j_make_calm_step

LAT, T_AUD, T_TXT, ROW = 8, 16, 6, 14


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread each runs them fastest."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _examples(text_lens, audio_lens, seed=0, cls=TExample):
    rng = np.random.default_rng(seed)
    return [cls(input_ids=rng.integers(1, 200, n).astype(np.int32),
                labels=np.full((n,), -100, np.int32),
                audio=rng.standard_normal((a, LAT)).astype(np.float32),
                mode="tts") for n, a in zip(text_lens, audio_lens)]


def _both(text_lens, audio_lens, seed=0):
    """The same examples as the port's and as JAX's CalmExample."""
    t = _examples(text_lens, audio_lens, seed)
    j = [CalmExample(e.input_ids, e.labels, e.audio, e.mode) for e in t]
    return t, j


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# --------------------------------------------------------------------------
# the pack plan: array-equal
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    # (text lens, audio lens, rows, row_len, segments, t_aud, max_text_len)
    ([5, 3, 6, 2], [9, 6, 12, 3], 2, 14, 2, 16, 6),
    ([5, 3, 6], [9, 6, 12], 2, 14, 2, 16, 6),  # a dummy slot
    ([5, 3, 6, 2], [9, 6, 12, 3], 4, 14, 2, 16, 6),  # two dummy rows
    ([7, 1, 4, 4, 9, 2, 6, 3, 5], [20, 4, 9, 9, 30, 2, 16, 5, 12], 2, 12, 3,
     24, 8),  # leftovers, truncated texts and audio
])
def test_pack_plan_matches_jax(case):
    text_lens, audio_lens, rows, row_len, segs, t_aud, max_txt = case
    tex, jex = _both(text_lens, audio_lens, seed=len(text_lens))
    got, left = tcol.pack_tts_window(tex, rows, row_len, segs, t_aud, LAT,
                                     max_txt)
    ref, jleft = jcol.pack_tts_window(jex, rows, row_len, segs, t_aud, LAT,
                                      max_text_len=max_txt)
    assert left == jleft
    _assert_batches_equal(got, ref)
    # failed loads (None) become dummy slots the same way
    row_t = [[tex[0], None], [None, tex[1]]]
    row_j = [[jex[0], None], [None, jex[1]]]
    _assert_batches_equal(
        tcol.materialize_tts_rows(row_t, row_len, segs, t_aud, LAT, max_txt),
        jcol.materialize_tts_rows(row_j, row_len, segs, t_aud, LAT, max_txt))
    costs = [min(n, max_txt) + 1 for n in text_lens]
    assert tcol.plan_pack(costs, rows, row_len, segs) == jcol.plan_pack(
        costs, rows, row_len, segs)
    with pytest.raises(ValueError, match="cannot fit"):
        tcol.pack_tts_window(tex, rows, max_txt, segs, t_aud, LAT, max_txt)


class _Store:
    """A stand-in dataset with the attributes the estimate reads."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.max_text_len, self.max_audio_len = 40, 64
        self.tts_items, self.asr_items = list(range(n)), []
        self.asr_prompt_ids = np.arange(5, dtype=np.int32)
        self.ex = _examples(rng.integers(3, 60, n), rng.integers(4, 90, n),
                            seed)

    def get(self, mode, idx):
        return None if idx % 11 == 5 else self.ex[idx]  # a few failed loads


@pytest.mark.parametrize("n, rows, row_len, segs, fill", [
    (300, 8, 96, 4, 0.87), (50, 4, 64, 8, 0.9), (7, 16, 256, 8, 0.87)])
def test_estimate_packed_steps_matches_jax(n, rows, row_len, segs, fill):
    store = _Store(n, seed=n)
    for task in ("tts", "asr"):
        got = tcol.estimate_packed_steps_per_epoch(store, task, rows, row_len,
                                                   segs, fill=fill, seed=3)
        ref = jcol.estimate_packed_steps_per_epoch(store, task, rows, row_len,
                                                   segs, fill=fill, seed=3)
        assert got == ref, task


# --------------------------------------------------------------------------
# Qwen2 under segment ids
# --------------------------------------------------------------------------
def test_qwen2_segment_ids_match_jax(monkeypatch):
    """Block-diagonal causal attention with per-segment positions, a pad
    tail and an all-pad row position; the port takes masked_attention,
    never the fused kernels' route, because segment ids are given."""
    cfg = Qwen2Config.tiny()
    lora = LoRAConfig(rank=4, alpha=8.0, dropout=0.0)
    rng = np.random.default_rng(0)
    B, T = 2, 12
    x = rng.standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    seg = np.array([[1, 1, 1, 2, 2, 2, 2, 3, 3, 0, 0, 0],
                    [1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 0]], np.int32)
    pos = np.zeros_like(seg)
    for b in range(B):
        for s in set(seg[b]) - {0}:
            idx = np.nonzero(seg[b] == s)[0]
            pos[b, idx] = np.arange(len(idx))
    mask = (seg != 0).astype(np.int32)
    m = Qwen2Model(cfg, lora=lora, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), x,
                                           jnp.asarray(mask))["params"])
    params = jax.tree_util.tree_map(
        lambda a: (1.0 if len(a.shape) == 1 else 0.0) + 0.05 * (
            rng.standard_normal(a.shape).astype(np.float32)), shapes)
    ref = np.asarray(jax.jit(lambda p: m.apply(
        {"params": p}, x, jnp.asarray(mask), jnp.asarray(pos),
        segment_ids=jnp.asarray(seg)))(params))
    tm = TQwen2Model(TQwen2Config.tiny(),
                     lora=TLoRAConfig(rank=4, alpha=8.0, dropout=0.0))
    tm.load_state_dict(from_jax_params(params), strict=True)

    def refuse(*a, **k):
        raise AssertionError("packed rows reached the fused attention")

    monkeypatch.setattr(tqwen2_mod, "flash_attention", refuse)
    monkeypatch.setattr(tqwen2_mod, "attention_fwd", refuse)
    args = [torch.from_numpy(a) for a in (x, mask, pos)]
    with torch.no_grad():
        out = tm(*args, segment_ids=torch.from_numpy(seg)).numpy()
    xg = args[0].clone().requires_grad_()
    tm(xg, *args[1:], segment_ids=torch.from_numpy(seg)).sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= 2e-4 * np.max(np.abs(ref))


# --------------------------------------------------------------------------
# forward_tts_packed and the tts_packed step
# --------------------------------------------------------------------------
def _cfg():
    return CALMModelConfig(
        latent_dim=LAT, max_audio_len=T_AUD, max_text_len=T_TXT,
        tts_flow_hidden_dim=32, tts_flow_num_layers=1,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=Qwen2Config.tiny(vocab_size=256),
        lora=LoRAConfig(rank=2, alpha=4, dropout=0.0),
        cfg_dropout_prob=0.0, latent_mean=0.04, latent_std=1.19)


@pytest.fixture(scope="module")
def packed_models():
    """JAX and port models on the same weights: shapes from
    init_calm_params, traced, not run; values from numpy (kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2), the rest N(0, 0.05^2),
    so LoRA and the DiT's output projection are not zero)."""
    cfg = _cfg()
    model = QwenCALM(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: init_calm_params(model,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.05 * z if name == "scale" else 0.05 * z

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return model, cfg, params


def _port_model(params, cfg):
    tmodel = TQwenCALM(from_dict(TCALMConfig, dataclasses.asdict(cfg)))
    load_calm(tmodel, {"params": params})
    return tmodel


def _packed(text_lens, audio_lens, rows, seed):
    tex, _ = _both(text_lens, audio_lens, seed)
    batch, left = tcol.pack_tts_window(tex, rows, ROW, 2, T_AUD, LAT, T_TXT)
    assert not left
    return batch


def _injecting(monkeypatch, draws):
    """The port's flow loss takes its t and x0 from `draws`, in call
    order (JAX's, computed from its keys)."""
    def fn(head_fn, generator, condition, target, mask, *a, **kw):
        kw["t"], kw["x0"] = draws.pop(0)
        return t_flow_loss(head_fn, generator, condition, target, mask, *a,
                           **kw)

    monkeypatch.setattr(tcalm_mod, "compute_flow_loss", fn)


def _jax_draws(key, rows):
    _, r_t, r_x0 = jax.random.split(key, 3)
    t = jax.random.uniform(r_t, (rows,), dtype=jnp.float32)
    x0 = jax.random.normal(r_x0, (rows, T_AUD, LAT), jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(x0))


def _close(got, ref, what):
    err = np.max(np.abs(got - ref))
    assert err <= 2e-4 * max(np.max(np.abs(ref)), 1e-4), (what, err)


def test_forward_tts_packed_loss_and_grads_match_jax(packed_models,
                                                     monkeypatch):
    """Three utterances in 2 rows x 2 slots (one dummy slot): the loss
    terms, loss_den and the gradient of every trainable tensor."""
    model, cfg, params = packed_models
    batch = _packed([5, 3, 6], [9, 6, 12], rows=2, seed=4)
    assert int(batch["text_mask"].any(-1).sum()) == 3
    seen = {}

    def recording(head_fn, rng, condition, target, *a, **kw):
        seen["rng"] = rng
        return compute_flow_loss(head_fn, rng, condition, target, *a, **kw)

    monkeypatch.setattr(jcalm, "compute_flow_loss", recording)

    @jax.jit
    @functools.partial(jax.value_and_grad, has_aux=True)
    def loss_fn(p):
        out = model.apply({"params": p},
                          *(jnp.asarray(batch[k]) for k in PACKED_KEYS),
                          train=False, rngs={"flow": jax.random.PRNGKey(2)},
                          method=QwenCALM.forward_tts_packed)
        return out["loss"], (out, seen["rng"])

    (_, (ref, key)), grads = loss_fn(params)
    monkeypatch.undo()
    _injecting(monkeypatch, [_jax_draws(key, 4)])
    tmodel = _port_model(params, cfg)
    labels = toptim.freeze(tmodel, TTrainingConfig(), task_mode="tts")
    out = tmodel.forward_tts_packed(
        *(torch.from_numpy(batch[k]) for k in PACKED_KEYS), train=False)
    out["loss"].backward()
    assert float(out["loss_den"]) == float(ref["loss_den"]) == 3.0
    for k in ("loss", "loss_tts", "loss_len", "loss_dur"):
        _close(np.float32(out[k].detach()), np.float32(ref[k]), k)
    gflat, gport = flatten_dict(grads), from_jax_params(grads)
    n_checked = 0
    for name, p in tmodel.named_parameters():
        if labels[name] == "frozen":
            assert p.grad is None
            continue
        assert jax_path(tmodel, name) in gflat
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        _close(g, gport[name].numpy(), name)
        n_checked += 1
    assert n_checked > 40


def _solo(packed):
    """The per-utterance solo batch of a packed one, in slot order."""
    R, S = packed["text_mask"].shape[:2]
    ids = np.zeros((R * S, T_TXT), np.int32)
    for r in range(R):
        for s in range(S):
            n = int(packed["text_mask"][r, s].sum())
            ids[r * S + s, :n] = packed["tok_ids"][r, packed["ctx_idx"][r, s,
                                                                        :n]]
    return dict(text_ids=ids,
                attention_mask=packed["text_mask"].reshape(R * S, T_TXT),
                latents=packed["latents"].reshape(R * S, T_AUD, LAT),
                audio_mask=packed["audio_mask"].reshape(R * S, T_AUD))


def test_packed_equals_solo_in_the_port(packed_models):
    """All utterances real: the packed losses equal forward_tts on the same
    utterances in slot order with the same draws; moving one segment's
    context gather moves the loss (the control)."""
    _, cfg, params = packed_models
    tmodel = _port_model(params, cfg)
    packed = _packed([5, 3, 6, 2], [9, 6, 12, 3], rows=2, seed=3)
    solo = _solo(packed)
    g = torch.Generator().manual_seed(0)
    draws = dict(t=torch.rand(4, generator=g),
                 x0=torch.randn(4, T_AUD, LAT, generator=g))

    def packed_loss(b):
        with torch.no_grad():
            return tmodel.forward_tts_packed(
                *(torch.from_numpy(b[k]) for k in PACKED_KEYS), train=False,
                **draws)

    with torch.no_grad():
        ref = tmodel.forward_tts(**{k: torch.from_numpy(v)
                                    for k, v in solo.items()}, train=False,
                                 **draws)
    out = packed_loss(packed)
    for k in ("loss", "loss_tts", "loss_len", "loss_dur"):
        assert float(out[k]) == pytest.approx(float(ref[k]), rel=1e-4), k
    assert float(out["loss_den"]) == 4.0
    bad = dict(packed, ctx_idx=packed["ctx_idx"].copy())
    bad["ctx_idx"][0, 0] = (bad["ctx_idx"][0, 0] + 5) % ROW
    assert abs(float(packed_loss(bad)["loss"]) - float(out["loss"])) > 1e-6


class _SGD:
    """p <- p - g: the update shows the step's gradient itself (the AdamW
    of both packages is held against optax in test_torch_train_tts.py)."""

    def __init__(self, params):
        self.params = params

    @torch.no_grad()
    def step(self, grads):
        g = {n: (grads[n] if grads[n] is not None
                 else torch.zeros_like(p)) for n, p in self.params.items()}
        for n, p in self.params.items():
            p.sub_(g[n])
        return toptim.global_norm(g.values())


def test_tts_packed_microbatch_step_matches_jax(packed_models, monkeypatch):
    """microbatch=2 over 4 rows whose last two are dummies: JAX's jitted
    tts_packed step (train mode, every dropout rate 0, SGD with LR 1) and
    the port's give the same metrics and the same updated tensors."""
    model, cfg, params = packed_models
    batch = _packed([5, 3, 6, 2], [9, 6, 12, 3], rows=4, seed=11)
    assert list(batch["text_mask"].reshape(4, -1).sum(-1) > 0) == [
        True, True, False, False]
    # the DiT attention's dropout (0.1 in train mode) off on both sides
    monkeypatch.setattr(jcalm, "TransformerFlowHead", functools.partial(
        TransformerFlowHead, dropout=0.0))
    keys = []  # the flow keys of the slices, read as the step runs

    def recording(head_fn, rng, condition, target, *a, **kw):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), rng,
                           ordered=True)
        return compute_flow_loss(head_fn, rng, condition, target, *a, **kw)

    monkeypatch.setattr(jcalm, "compute_flow_loss", recording)
    label = functools.partial(calm_param_label, task_mode="tts")
    trainable, frozen = partition_params(params, label)
    tx = optax.sgd(1.0)
    step = jax.jit(j_make_calm_step(model, tx, "tts_packed", microbatch=2))
    rng = jax.random.PRNGKey(9)
    new_state, metrics = step(init_train_state(trainable, tx), frozen,
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              rng)
    jax.effects_barrier()
    monkeypatch.undo()
    assert len(keys) == 2
    draws = [_jax_draws(jnp.asarray(k), 4) for k in keys]
    _injecting(monkeypatch, draws)

    tmodel = _port_model(params, cfg)
    for m in tmodel.modules():
        if isinstance(m, TMHA):
            m.dropout = 0.0
    toptim.freeze(tmodel, TTrainingConfig(), task_mode="tts")
    tparams = {n: p for n, p in tmodel.named_parameters() if p.requires_grad}
    tstep = make_calm_step(tmodel, _SGD(tparams), "tts_packed", microbatch=2)
    out = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
    assert not draws  # one flow loss a slice
    assert float(out["loss_den"]) == float(metrics["loss_den"]) == 4.0
    for k in ("loss", "loss_tts", "loss_len", "loss_dur", "grad_norm"):
        _close(np.float32(out[k]), np.float32(metrics[k]), k)
    # the updates themselves (old - new: the gradients), port names
    old = from_jax_params(params)
    jnew = from_jax_params(unflatten_dict(
        {k: np.asarray(v) for k, v in new_state.trainable.items()}))
    assert set(jnew) == set(tparams)
    for name, p in tparams.items():
        _close((old[name] - p.detach()).numpy(),
               (old[name] - jnew[name]).numpy(), name)

"""ASR training in the PyTorch port vs the JAX package, on the CPU at a tiny
size (2 Qwen2 layers, widths of `tiny_calm` in tests/test_packing.py).

Bounds, each with its reason:
  - forward_asr's and forward_asr_packed's loss terms and every trainable
    gradient, and the updated tensors and metrics of one asr_packed step:
    2e-4 of the largest value of the tensor, at least 2e-8 (fp32 through a
    2-layer LLM, the query cross-attention and a DiT, summed in another
    order; the bound of tests/test_torch_train_tts.py). The flow draws are
    JAX's, injected; loss_den (a count) exactly.
  - packed vs solo in the port: 2e-5 relative (the bound of
    tests/test_packing.py::test_forward_asr_packed_matches_solo: the same
    utterances through other attention layouts and sums).
  - the plain asr step vs the mean of its slices, and the remat policies
    against each other: 1e-6 relative, 1e-7 absolute (the same ops, the
    backward split or recomputed).
"""

import copy
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
from audio_calm_torch.config import TrainingConfig as TTrainingConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.data import collator as tcol
from audio_calm_torch.data.datasets import CalmExample as TExample
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import (from_jax_params, jax_path,
                                             load_calm)
from audio_calm_torch.ops.attention import MultiheadAttention as TMHA
from audio_calm_torch.ops.dropout import derive_seed
from audio_calm_torch.ops.flow import compute_flow_loss as t_flow_loss
from audio_calm_torch.train import optim as toptim
from audio_calm_torch.train.steps import (ASR_KEYS, ASR_PACKED_KEYS,
                                          accumulate_grads, make_calm_step,
                                          slice_loss)
from audio_calm_tpu.config import CALMModelConfig, LoRAConfig, Qwen2Config
from audio_calm_tpu.models.calm import QwenCALM, init_calm_params
from audio_calm_tpu.models.calm_heads import TransformerFlowHead
from audio_calm_tpu.ops.attention import MultiheadAttention
from audio_calm_tpu.ops.flow import compute_flow_loss
from audio_calm_tpu.train.optim import calm_param_label, partition_params
from audio_calm_tpu.train.steps import init_train_state
from audio_calm_tpu.train.steps import make_calm_step as j_make_calm_step

LAT, L, T_TXT, H = 8, 16, 6, 64
PROMPT = np.asarray([5, 6, 7], np.int32)
ROW = 2 * (L + 1 + len(PROMPT))  # two max-length segments a row


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread each runs them fastest."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg():
    return CALMModelConfig(
        latent_dim=LAT, max_audio_len=L, max_text_len=T_TXT,
        tts_flow_hidden_dim=32, tts_flow_num_layers=1,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=Qwen2Config.tiny(vocab_size=256),
        lora=LoRAConfig(rank=2, alpha=4, dropout=0.0),
        cfg_dropout_prob=0.0, latent_mean=0.04, latent_std=1.19)


@pytest.fixture(scope="module")
def asr_models():
    """JAX model and weights: shapes from init_calm_params, traced, not
    run; values from numpy (kernels N(0, 1/fan_in), norm scales 1 +
    N(0, 0.05^2), the rest N(0, 0.05^2), so LoRA and the DiT's output
    projection are not zero)."""
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

    return model, cfg, jax.tree_util.tree_map_with_path(draw, shapes)


def _port_model(params, cfg, **overrides):
    tcfg = dataclasses.replace(
        from_dict(TCALMConfig, dataclasses.asdict(cfg)), **overrides)
    tmodel = TQwenCALM(tcfg)
    load_calm(tmodel, {"params": params})
    return tmodel


def _examples(lengths, label_lens, seed=0):
    rng = np.random.default_rng(seed)
    return [TExample(input_ids=PROMPT.copy(),
                     labels=rng.integers(1, 200, n).astype(np.int32),
                     audio=rng.standard_normal((a, LAT)).astype(np.float32),
                     mode="asr") for a, n in zip(lengths, label_lens)]


def _packed(lengths, label_lens, rows, seed):
    batch, left = tcol.pack_asr_window(_examples(lengths, label_lens, seed),
                                       PROMPT, rows, ROW, 2, L, LAT, T_TXT)
    assert not left
    return batch


def _plain(seed, n=4, text_pad=4):
    """A plain ASR batch: the prompt padded to `text_pad` (narrower than
    max_text_len, as asr_text_pad pads it), ragged audio, labels of 1 to
    T_TXT positions, one row with a single label."""
    rng = np.random.default_rng(seed)
    exs = _examples(rng.integers(5, L + 1, n), [T_TXT, 1] + list(
        rng.integers(1, T_TXT + 1, n - 2)), seed)
    return tcol.collate_calm(exs, 0, T_TXT, L, LAT, text_pad=text_pad)


def _solo(packed):
    """The per-utterance solo batch of a packed one, in slot order."""
    R, S = packed["latent_mask"].shape[:2]
    return dict(text_ids=np.tile(PROMPT, (R * S, 1)),
                attention_mask=np.ones((R * S, len(PROMPT)), np.int32),
                latents=packed["latents"].reshape(R * S, L, LAT),
                audio_mask=packed["latent_mask"].reshape(R * S, L),
                labels=packed["labels"].reshape(R * S, T_TXT))


def _recording(seen):
    def fn(head_fn, rng, condition, target, *a, **kw):
        seen.append((rng, target.shape))
        return compute_flow_loss(head_fn, rng, condition, target, *a, **kw)
    return fn


def _draws(key, shape):
    """JAX's t and x0 from a flow key."""
    _, r_t, r_x0 = jax.random.split(key, 3)
    t = jax.random.uniform(r_t, (shape[0],), dtype=jnp.float32)
    x0 = jax.random.normal(r_x0, shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(x0))


def _injecting(monkeypatch, draws):
    """The port's flow loss takes its t and x0 from `draws`, in call
    order."""
    def fn(head_fn, generator, condition, target, mask, *a, **kw):
        kw["t"], kw["x0"] = draws.pop(0)
        return t_flow_loss(head_fn, generator, condition, target, mask, *a,
                           **kw)

    monkeypatch.setattr(tcalm_mod, "compute_flow_loss", fn)


def _close(got, ref, what):
    err = np.max(np.abs(got - ref))
    assert err <= 2e-4 * max(np.max(np.abs(ref)), 1e-4), (what, err)


@pytest.mark.parametrize("packed", [False, True])
def test_forward_asr_loss_and_grads_match_jax(asr_models, monkeypatch,
                                              packed):
    """forward_asr on a plain batch whose prompt is padded narrower than
    max_text_len, and forward_asr_packed on 3 utterances in 2 rows x 2
    slots (one dummy slot): the loss terms, loss_den and the gradient of
    every trainable tensor (task_mode asr)."""
    model, cfg, params = asr_models
    if packed:
        batch = _packed([9, 6, 12], [4, 2, 5], rows=2, seed=4)
        keys, method = ASR_PACKED_KEYS, QwenCALM.forward_asr_packed
        assert int((batch["latent_mask"].sum(-1) > 0).sum()) == 3
    else:
        batch = _plain(seed=3)
        keys, method = ASR_KEYS, QwenCALM.forward_asr
        assert batch["text_ids"].shape[1] == 4 < T_TXT
    seen = []
    monkeypatch.setattr(jcalm, "compute_flow_loss", _recording(seen))

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
    _injecting(monkeypatch, [_draws(key, seen[-1][1])])
    tmodel = _port_model(params, cfg)
    labels = toptim.freeze(tmodel, TTrainingConfig(), task_mode="asr")

    def refuse(*a, **k):
        raise AssertionError("packed rows reached the fused attention")

    if packed:  # rows with segment ids take the plain masked attention
        monkeypatch.setattr(tqwen2_mod, "flash_attention", refuse)
    forward = getattr(tmodel, method.__name__)
    out = forward(*(torch.from_numpy(batch[k]) for k in keys), train=False)
    out["loss"].backward()
    n_valid = int((batch["labels"] != -100).sum())
    assert float(out["loss_den"]) == float(ref["loss_den"]) == n_valid
    for k in ("loss", "loss_asr"):
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
    assert n_checked > 30


def test_packed_equals_solo_in_the_port(asr_models):
    """Four utterances in 2 rows x 2 slots: forward_asr_packed's loss
    equals forward_asr on the same utterances in slot order with the same
    draws; moving one segment's context gather moves the loss (the
    control)."""
    _, cfg, params = asr_models
    tmodel = _port_model(params, cfg)
    packed = _packed([9, 6, 12, 3], [4, 2, 5, 3], rows=2, seed=3)
    assert int((packed["latent_mask"].sum(-1) > 0).sum()) == 4
    g = torch.Generator().manual_seed(0)
    draws = dict(t=torch.rand(4, generator=g),
                 x0=torch.randn(4, T_TXT, H, generator=g))

    def packed_loss(b):
        with torch.no_grad():
            return tmodel.forward_asr_packed(
                *(torch.from_numpy(b[k]) for k in ASR_PACKED_KEYS),
                train=False, **draws)

    with torch.no_grad():
        ref = tmodel.forward_asr(**{k: torch.from_numpy(v) for k, v in
                                    _solo(packed).items()}, train=False,
                                 **draws)
    out = packed_loss(packed)
    for k in ("loss", "loss_asr"):
        assert float(out[k]) == pytest.approx(float(ref[k]), rel=2e-5), k
    assert float(out["loss_den"]) == float(ref["loss_den"]) == 14.0
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


def _no_dropout(monkeypatch):
    """The DiT's and the query cross-attention's dropout (0.1 in train
    mode) off in the JAX model."""
    monkeypatch.setattr(jcalm, "TransformerFlowHead", functools.partial(
        TransformerFlowHead, dropout=0.0))
    monkeypatch.setattr(jcalm, "MultiheadAttention", lambda *a, **k: (
        MultiheadAttention(*a, **{**k, "dropout": 0.0})))


def test_asr_packed_microbatch_step_matches_jax(asr_models, monkeypatch):
    """microbatch=2 over 4 rows whose last two are dummies (the tail slice
    holds no utterance): JAX's jitted asr_packed step (train mode, every
    dropout rate 0, SGD with LR 1) and the port's give the same
    loss_den-weighted metrics, the summed loss_den and the same updated
    tensors, which are slice 0's gradients alone."""
    model, cfg, params = asr_models
    batch = _packed([9, 6, 12, 3], [4, 2, 5, 3], rows=4, seed=11)
    assert list(batch["latent_mask"].reshape(4, -1).sum(-1) > 0) == [
        True, True, False, False]
    _no_dropout(monkeypatch)
    keys = []  # the flow keys of the slices, read as the step runs

    def recording(head_fn, rng, condition, target, *a, **kw):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), rng,
                           ordered=True)
        return compute_flow_loss(head_fn, rng, condition, target, *a, **kw)

    monkeypatch.setattr(jcalm, "compute_flow_loss", recording)
    jmodel = QwenCALM(cfg, dtype=jnp.float32)  # built under the patches
    label = functools.partial(calm_param_label, task_mode="asr")
    trainable, frozen = partition_params(params, label)
    tx = optax.sgd(1.0)
    step = jax.jit(j_make_calm_step(jmodel, tx, "asr_packed", microbatch=2))
    new_state, metrics = step(init_train_state(trainable, tx), frozen,
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(9))
    jax.effects_barrier()
    monkeypatch.undo()
    assert len(keys) == 2
    draws = [_draws(jnp.asarray(k), (4, T_TXT, H)) for k in keys]
    _injecting(monkeypatch, draws)

    tmodel = _port_model(params, cfg)
    for m in tmodel.modules():
        if isinstance(m, TMHA):
            m.dropout = 0.0
    toptim.freeze(tmodel, TTrainingConfig(), task_mode="asr")
    tparams = {n: p for n, p in tmodel.named_parameters() if p.requires_grad}
    tstep = make_calm_step(tmodel, _SGD(tparams), "asr_packed", microbatch=2)
    out = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
    assert not draws  # one flow loss a slice
    assert float(out["loss_den"]) == float(metrics["loss_den"]) == 14.0
    for k in ("loss", "loss_asr", "grad_norm"):
        _close(np.float32(out[k]), np.float32(metrics[k]), k)
    old = from_jax_params(params)
    jnew = from_jax_params(unflatten_dict(
        {k: np.asarray(v) for k, v in new_state.trainable.items()}))
    assert set(jnew) == set(tparams)
    for name, p in tparams.items():
        _close((old[name] - p.detach()).numpy(),
               (old[name] - jnew[name]).numpy(), name)


def test_asr_packed_slices_weighted_by_loss_den(asr_models):
    """In the port alone, dropouts on: the weighted step over 2 slices
    equals loss_den-weighting each slice's own forward and backward by
    hand; a plain mean of the slice means (what "asr" does) differs."""
    _, cfg, params = asr_models
    tmodel = _port_model(params, cfg, cfg_dropout_prob=0.2)
    toptim.freeze(tmodel, TTrainingConfig(), task_mode="asr")
    batch = {k: torch.from_numpy(v) for k, v in _packed(
        [9, 6, 12, 3, 14, 5], [4, 2, 5, 3, 6, 1], rows=4, seed=5).items()}
    metrics = accumulate_grads(tmodel, batch, 2, seed=9, task="asr_packed")
    got = {n: p.grad.clone() for n, p in tmodel.named_parameters()
           if p.grad is not None}
    outs, grads = [], []
    for i in range(2):
        tmodel.zero_grad(set_to_none=True)
        sub = {k: batch[k][2 * i: 2 * i + 2] for k in ASR_PACKED_KEYS}
        out = slice_loss(tmodel, sub, derive_seed(9, i), "asr_packed")
        out["loss"].backward()
        outs.append({k: float(v) for k, v in out.items()})
        grads.append({n: p.grad.clone() for n, p in
                      tmodel.named_parameters() if p.grad is not None})
    w = [o["loss_den"] for o in outs]
    assert w[0] != w[1] and float(metrics["loss_den"]) == sum(w)
    want = sum(o["loss"] * wi for o, wi in zip(outs, w)) / sum(w)
    assert float(metrics["loss"]) == pytest.approx(want, rel=1e-6)
    assert abs(want - (outs[0]["loss"] + outs[1]["loss"]) / 2) > 1e-4
    for n, g in got.items():
        ref = (w[0] * grads[0][n] + w[1] * grads[1][n]) / sum(w)
        torch.testing.assert_close(g, ref, rtol=1e-6, atol=1e-7)


def test_plain_asr_step_is_the_mean_of_its_slices(asr_models):
    """The plain asr step with microbatch=2: gradients and loss terms the
    mean of the two slices' (each with its own seed), loss_den their
    sum."""
    _, cfg, params = asr_models
    tmodel = _port_model(params, cfg)
    toptim.freeze(tmodel, TTrainingConfig(), task_mode="asr")
    batch = {k: torch.from_numpy(v) for k, v in _plain(seed=6).items()}
    metrics = accumulate_grads(tmodel, batch, 2, seed=9, task="asr")
    got = {n: p.grad.clone() for n, p in tmodel.named_parameters()
           if p.grad is not None}
    outs, grads = [], []
    for i in range(2):
        tmodel.zero_grad(set_to_none=True)
        sub = {k: batch[k][2 * i: 2 * i + 2] for k in ASR_KEYS}
        out = slice_loss(tmodel, sub, derive_seed(9, i), "asr")
        out["loss"].backward()
        outs.append({k: float(v) for k, v in out.items()})
        grads.append({n: p.grad.clone() for n, p in
                      tmodel.named_parameters() if p.grad is not None})
    assert float(metrics["loss_den"]) == outs[0]["loss_den"] + \
        outs[1]["loss_den"]
    for k in ("loss", "loss_asr"):
        assert float(metrics[k]) == pytest.approx(
            (outs[0][k] + outs[1][k]) / 2, rel=1e-6), k
    assert set(got) == set(grads[0])
    for n, g in got.items():
        torch.testing.assert_close(g, (grads[0][n] + grads[1][n]) / 2,
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("task", ["asr", "asr_packed"])
def test_remat_policies_agree_on_asr(asr_models, task):
    """'dots', 'full' and 'none' give the same ASR loss and gradients, in
    train mode with every dropout on (packed rows: the masked attention's
    products kept under 'dots')."""
    _, cfg, params = asr_models
    batch = (_packed([9, 6, 12], [4, 2, 5], rows=2, seed=2)
             if task == "asr_packed" else _plain(seed=2))
    results = []
    for policy in ("dots", "full", "none"):
        tmodel = _port_model(params, cfg, remat_policy=policy,
                             lora=TLoRAConfig(rank=2, alpha=4, dropout=0.1),
                             cfg_dropout_prob=0.2)
        toptim.freeze(tmodel, TTrainingConfig(), task_mode="asr")
        out = slice_loss(tmodel, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, 5, task)
        out["loss"].backward()
        results.append((float(out["loss"]),
                        [copy.deepcopy(p.grad) for p in tmodel.parameters()
                         if p.requires_grad]))
    for other in results[1:]:
        assert other[0] == results[0][0]
        for a, b in zip(results[0][1], other[1]):
            if a is None:
                assert b is None
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

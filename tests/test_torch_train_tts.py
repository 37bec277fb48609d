"""The TTS training step of the PyTorch port vs the JAX package, on the CPU
at a tiny size shaped like `calm_setup` of tests/test_train_steps.py.

Bounds, each with its reason:
  - MAS: bit-exact (one fp32 add of the same operands per cell, the same
    strict `>` tie rule).
  - compute_flow_loss: 1e-6 relative; the same draws injected on both
    sides, fp32, sums in another order.
  - forward_tts loss terms and every trainable gradient: 2e-4 of the
    largest value of the tensor, at least 2e-8 (fp32 through a 2-layer LLM,
    the MAS and a DiT, summed in another order; the JAX package's Qwen2
    bound).
  - optimizer updates: 1e-6 of the largest parameter value (fp32 Adam
    arithmetic; the schedule and bias corrections in float64 on the host
    here, float32 in optax).
  - microbatch mean, checkpointed vs plain block: 1e-6 (the same ops, the
    backward split or recomputed).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import audio_calm_tpu.models.calm as jcalm
from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import TrainingConfig as TTrainingConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import (from_jax_params, jax_path,
                                             load_calm)
from audio_calm_torch.models.qwen2 import Qwen2Model as TQwen2Model
from audio_calm_torch.ops.attention import MultiheadAttention as TMHA
from audio_calm_torch.ops.dropout import derive_seed
from audio_calm_torch.ops.flow import compute_flow_loss as t_flow_loss
from audio_calm_torch.ops.mas import monotonic_alignment_search as t_mas
from audio_calm_torch.train import optim as toptim
from audio_calm_torch.train.loop import run_training
from audio_calm_torch.train.steps import (accumulate_grads, make_calm_step,
                                          slice_loss)
from audio_calm_tpu.config import (CALMModelConfig, LoRAConfig, Qwen2Config,
                                   TrainingConfig)
from audio_calm_tpu.models.calm import QwenCALM
from audio_calm_tpu.ops.flow import compute_flow_loss
from audio_calm_tpu.ops.mas import monotonic_alignment_search
from audio_calm_tpu.train.optim import calm_param_label, make_optimizer

B, T_TXT, T_AUD, LAT = 4, 6, 16, 8


def _cfg(lora_dropout=0.0):
    return CALMModelConfig(
        latent_dim=LAT, max_audio_len=T_AUD, max_text_len=8,
        tts_flow_hidden_dim=32, tts_flow_num_layers=1,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=Qwen2Config.tiny(vocab_size=128),
        lora=LoRAConfig(rank=2, alpha=4, dropout=lora_dropout),
        latent_mean=0.1, latent_std=1.2,
    )


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    tmask = (np.arange(T_TXT)[None] < rng.integers(2, T_TXT + 1, n)[:, None])
    amask = (np.arange(T_AUD)[None] < rng.integers(8, T_AUD + 1, n)[:, None])
    tmask[0], amask[0] = True, True
    return dict(
        text_ids=(rng.integers(1, 128, (n, T_TXT)) * tmask).astype(np.int32),
        attention_mask=tmask.astype(np.int32),
        latents=rng.standard_normal((n, T_AUD, LAT)).astype(np.float32),
        audio_mask=amask.astype(np.int32),
    )


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_model(params, cfg, **overrides):
    tcfg = from_dict(TCALMConfig, dataclasses.asdict(cfg))
    tcfg = dataclasses.replace(tcfg, **overrides)
    model = TQwenCALM(tcfg)
    load_calm(model, params)
    return model


@pytest.fixture(scope="module")
def calm_setup():
    cfg = _cfg()
    model = QwenCALM(cfg, dtype=jnp.float32)
    b = _batch()
    init = jax.jit(lambda r: model.init(
        {"params": r, "flow": jax.random.fold_in(r, 1)}, b["text_ids"],
        b["attention_mask"], b["latents"], b["audio_mask"], train=False,
        method=QwenCALM.forward_tts))
    params = init(jax.random.PRNGKey(0))["params"]
    # lora_b and the flow head's out_proj are zero at init: perturb every
    # leaf so each gradient is exercised
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    return model, cfg, {"params": params}, b


def _rel_err(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


# --------------------------------------------------------------------------
# MAS and the flow loss
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["random", "ties", "padding"])
def test_mas_bit_exact(case):
    rng = np.random.default_rng({"random": 0, "ties": 1, "padding": 2}[case])
    Bm, N, T = 3, 7, 20
    if case == "ties":  # few distinct values: many equal candidates
        lp = rng.integers(-2, 1, (Bm, N, T)).astype(np.float32)
    else:
        lp = np.log(rng.dirichlet(np.ones(N), (Bm, T))).transpose(0, 2, 1)
        lp = lp.astype(np.float32)
    if case == "padding":  # the model's masking: -1e9 before log_softmax
        sim = rng.standard_normal((Bm, N, T)).astype(np.float32)
        sim[1, 4:] = -1e9
        sim[2, :, 13:] = -1e9
        lp = np.asarray(jax.nn.log_softmax(jnp.asarray(sim), axis=1))
    ref = np.asarray(monotonic_alignment_search(jnp.asarray(lp)))
    out = t_mas(torch.tensor(lp)).numpy()
    assert out.dtype == np.float32 and out.shape == (Bm, N, T)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("train", [False, True])
def test_flow_loss_matches_jax_with_its_draws(train):
    rng = np.random.default_rng(3)
    Bf, T, C, D = 4, 10, 6, 5
    cond = rng.standard_normal((Bf, T, C)).astype(np.float32)
    target = rng.standard_normal((Bf, T, D)).astype(np.float32)
    ctx = rng.standard_normal((Bf, 3, C)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([[10], [7], [4], [9]])
    w = rng.standard_normal((C + D + C, D)).astype(np.float32)

    def head(xp):
        def fn(c, x, t, cx, cm, xm):
            h = xp.concatenate([c, x, xp.broadcast_to(
                cx.mean(1, keepdims=True), c.shape)], -1)
            return (h @ w) * t[:, None, None]
        return fn

    key = jax.random.PRNGKey(11)
    ref = float(compute_flow_loss(
        head(jnp), key, jnp.asarray(cond), jnp.asarray(target),
        jnp.asarray(mask), cfg_dropout_prob=0.5, context=jnp.asarray(ctx),
        train=train))
    r_drop, r_t, r_x0 = jax.random.split(key, 3)
    drop = np.asarray(jax.random.uniform(r_drop, (Bf,)) < 0.5)
    t = np.asarray(jax.random.uniform(r_t, (Bf,), dtype=jnp.float32))
    x0 = np.asarray(jax.random.normal(r_x0, target.shape, jnp.float32))
    assert 0 < drop.sum() < Bf  # the draw drops some rows, not all
    w_t = torch.from_numpy(w)

    def t_head(c, x, t_, cx, cm, xm):
        h = torch.cat([c, x, cx.mean(1, keepdim=True).expand_as(c)], -1)
        return (h @ w_t) * t_[:, None, None]

    out = float(t_flow_loss(
        t_head, None, torch.from_numpy(cond), torch.from_numpy(target),
        torch.from_numpy(mask), cfg_dropout_prob=0.5,
        context=torch.from_numpy(ctx), train=train, t=torch.from_numpy(t),
        x0=torch.from_numpy(x0), drop=torch.from_numpy(drop)))
    assert abs(out - ref) <= 1e-6 * abs(ref)
    # drawn by the port's own generator: reproducible from its seed
    draws = [float(t_flow_loss(t_head, torch.Generator().manual_seed(5),
                               torch.from_numpy(cond),
                               torch.from_numpy(target),
                               torch.from_numpy(mask), 0.5,
                               torch.from_numpy(ctx), train=train))
             for _ in range(2)]
    assert draws[0] == draws[1] and np.isfinite(draws[0])


# --------------------------------------------------------------------------
# forward_tts: loss terms and gradients vs jax.value_and_grad
# --------------------------------------------------------------------------
def _jax_flow_draws(model, params, batch, monkeypatch):
    """The t and x0 that JAX forward_tts(train=False) draws from its flow
    rng, read by recording the key handed to compute_flow_loss."""
    seen = {}

    def recording(head_fn, rng, condition, target, *a, **kw):
        seen["rng"], seen["shape"] = rng, target.shape
        return compute_flow_loss(head_fn, rng, condition, target, *a, **kw)

    monkeypatch.setattr(jcalm, "compute_flow_loss", recording)
    model.apply(params, *(jnp.asarray(batch[k]) for k in (
        "text_ids", "attention_mask", "latents", "audio_mask")),
        train=False, rngs={"flow": jax.random.PRNGKey(2)},
        method=QwenCALM.forward_tts)
    monkeypatch.undo()
    _, r_t, r_x0 = jax.random.split(seen["rng"], 3)
    t = jax.random.uniform(r_t, (seen["shape"][0],), dtype=jnp.float32)
    x0 = jax.random.normal(r_x0, seen["shape"], jnp.float32)
    return torch.from_numpy(np.asarray(t)), torch.from_numpy(np.asarray(x0))


def test_forward_tts_loss_and_grads_match_jax(calm_setup, monkeypatch):
    model, cfg, params, batch = calm_setup
    t, x0 = _jax_flow_draws(model, params, batch, monkeypatch)

    def loss_fn(p):
        out = model.apply({"params": p}, *(jnp.asarray(batch[k]) for k in (
            "text_ids", "attention_mask", "latents", "audio_mask")),
            train=False, rngs={"flow": jax.random.PRNGKey(2)},
            method=QwenCALM.forward_tts)
        return out["loss"], out

    (_, ref), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params["params"])
    gflat = flatten_dict(grads)
    gport = from_jax_params(grads)  # port names and layouts

    tmodel = _port_model(params, cfg)
    labels = toptim.freeze(tmodel, TTrainingConfig())
    out = tmodel.forward_tts(**_torch_batch(batch), train=False, t=t, x0=x0)
    out["loss"].backward()
    for k in ("loss", "loss_tts", "loss_len", "loss_dur"):
        val = float(out[k].detach())
        assert abs(val - float(ref[k])) <= 2e-4 * abs(float(ref[k])), k
    n_checked = 0
    for name, p in tmodel.named_parameters():
        if labels[name] == "frozen":
            assert p.grad is None
            continue
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        assert jax_path(tmodel, name) in gflat
        ref_g = gport[name].numpy()
        err = np.max(np.abs(g - ref_g))
        # floor: a gradient that is zero analytically (the key biases:
        # softmax is shift-invariant) carries rounding noise only
        assert err <= 2e-4 * max(np.max(np.abs(ref_g)), 1e-4), (name, err)
        n_checked += 1
    assert n_checked > 40


# --------------------------------------------------------------------------
# train mode: the dropouts
# --------------------------------------------------------------------------
def _set_rates(model, lora, attn, cfg_drop):
    for m in model.modules():
        if hasattr(m, "lora_dropout"):
            m.lora_dropout = lora
        if isinstance(m, TMHA):
            m.dropout = attn
    model.cfg = dataclasses.replace(model.cfg, cfg_dropout_prob=cfg_drop)


@pytest.mark.parametrize("site", ["lora", "attn", "cfg"])
def test_train_mode_dropouts(calm_setup, site):
    _, cfg, params, batch = calm_setup
    tmodel = _port_model(params, cfg)
    tb = _torch_batch(batch)
    g = torch.Generator().manual_seed(0)
    t, x0 = torch.rand(B, generator=g), torch.randn(B, T_AUD, LAT, generator=g)
    drop = torch.tensor([True, False, True, False])

    def loss(train, seed=7):
        with torch.no_grad():
            return float(tmodel.forward_tts(**tb, train=train, seed=seed, t=t,
                                            x0=x0, drop=drop)["loss"])

    _set_rates(tmodel, 0.0, 0.0, 0.0)
    assert loss(True) == loss(False)  # rates of 0 == train=False
    _set_rates(tmodel, *(0.5 * (s == site) for s in ("lora", "attn", "cfg")))
    on = loss(True)
    assert on != loss(False)  # this dropout is on
    assert on == loss(True)  # the same seed, the same masks
    if site != "cfg":  # the CFG drop is injected here, not drawn
        assert on != loss(True, seed=8)


# --------------------------------------------------------------------------
# labels, the frozen split and the optimizer
# --------------------------------------------------------------------------
def test_labels_and_frozen_split(calm_setup):
    model, cfg, params, batch = calm_setup
    full = model.init({"params": jax.random.PRNGKey(0),
                       "flow": jax.random.PRNGKey(1)},
                      *(jnp.asarray(batch[k]) for k in (
                          "text_ids", "attention_mask", "latents",
                          "audio_mask")),
                      jnp.zeros((B, 8), jnp.int32), train=False,
                      method=QwenCALM.forward_asr)["params"]
    jflat = {**flatten_dict(params["params"]), **flatten_dict(full)}
    tmodel = _port_model(params, cfg)
    paths = {name: jax_path(tmodel, name)
             for name, _ in tmodel.named_parameters()}
    # one-to-one with the JAX tree, both branches
    assert set(paths.values()) == set(jflat)
    labels = toptim.freeze(tmodel, TTrainingConfig(
        frozen_weights_dtype="bfloat16"), task_mode="tts")
    for name, p in tmodel.named_parameters():
        assert labels[name] == calm_param_label(paths[name], task_mode="tts")
        frozen = labels[name] == "frozen"
        assert p.requires_grad == (not frozen)
        assert p.dtype == (torch.bfloat16 if frozen else torch.float32)
    assert {labels[n] for n in labels} == {"frozen", "decay", "no_decay",
                                           "proj", "head", "soa"}
    for path in (("asr_flow_head", "in_proj", "kernel"),
                 ("tts_flow_head", "in_proj", "kernel")):
        for mode in ("tts", "asr", "mix"):
            assert toptim.calm_param_label(path, mode) == calm_param_label(
                path, mode)


OPT_PARAMS = {  # one tensor per group, JAX paths
    ("tts_flow_head", "in_proj", "kernel"): (4, 3),
    ("soa_embed",): (1, 1, 4),
    ("llm", "layers_0", "self_attn", "q_proj", "lora_a"): (4, 2),
    ("input_proj", "conv1", "conv", "kernel"): (3, 2, 4),
    ("tts_len_predictor", "fc1", "bias"): (5,),
    ("tts_dur_predictor", "fc2", "kernel"): (5, 1),
}


@pytest.mark.parametrize("case", ["warmup_cosine", "clip", "linear",
                                  "multisteps"])
def test_optimizer_matches_optax(case):
    cfg = dict(learning_rate=1e-2, weight_decay=0.1)
    cfg.update({
        "warmup_cosine": dict(warmup_ratio=0.2),
        "clip": dict(lr_scheduler_type="constant", max_grad_norm=0.05),
        "linear": dict(lr_scheduler_type="linear", warmup_ratio=0.2),
        "multisteps": dict(gradient_accumulation_steps=2, warmup_ratio=0.0,
                           max_grad_norm=0.5),
    }[case])
    total, calls = 6, (6 if case == "multisteps" else 3)
    rng = np.random.default_rng(4)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in OPT_PARAMS.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * (0.3 + i)
              for k, s in OPT_PARAMS.items()} for i in range(calls)]
    # the input projector gets no gradient in forward_tts: None in the
    # port, zeros in JAX
    no_grad = ("input_proj", "conv1", "conv", "kernel")
    for g in grads:
        g[no_grad] = np.zeros_like(g[no_grad])

    label = lambda k: calm_param_label(k, task_mode="tts")  # noqa: E731
    tx = make_optimizer(TrainingConfig(**cfg), init, label, total)
    state = tx.init(init)
    jparams = dict(init)
    names = {k: "/".join(k) for k in OPT_PARAMS}
    tparams = {names[k]: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = toptim.AdamW(tparams, {names[k]: label(k) for k in OPT_PARAMS},
                       TTrainingConfig(**cfg), total)
    assert set(opt.group.values()) == set(toptim.GROUPS)
    last = init
    for i, g in enumerate(grads):
        upd, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        norm = opt.step({names[k]: (None if k == no_grad
                                    else torch.from_numpy(v))
                         for k, v in g.items()})
        assert abs(float(norm) - float(optax.global_norm(g))) <= 1e-6 * float(
            norm)
        for k in OPT_PARAMS:
            ref = np.asarray(jparams[k])
            assert _rel_err(tparams[names[k]].numpy(), ref) <= 1e-6, (i, k)
        if i == 0 and case in ("warmup_cosine", "linear"):
            for k in OPT_PARAMS:  # LR 0 at the first update
                np.testing.assert_array_equal(tparams[names[k]].numpy(),
                                              init[k])
        if case == "multisteps" and i % 2 == 0:  # mid-accumulation
            for k in OPT_PARAMS:
                np.testing.assert_array_equal(tparams[names[k]].numpy(),
                                              last[k])
        last = {k: tparams[names[k]].numpy().copy() for k in OPT_PARAMS}
    assert opt.count == (calls // 2 if case == "multisteps" else calls)


# --------------------------------------------------------------------------
# the step: microbatches, checkpointing, the loop
# --------------------------------------------------------------------------
def test_microbatch_grads_are_the_mean_of_the_slices(calm_setup):
    _, cfg, params, batch = calm_setup
    tmodel = _port_model(params, cfg)
    _set_rates(tmodel, 0.3, 0.3, 0.5)
    toptim.freeze(tmodel, TTrainingConfig())
    tb = _torch_batch(batch)
    trainable = [p for p in tmodel.parameters() if p.requires_grad]
    metrics = accumulate_grads(tmodel, tb, 2, seed=9)
    acc = [None if p.grad is None else p.grad.clone() for p in trainable]
    per_slice, losses = [], []
    for i in range(2):
        for p in trainable:
            p.grad = None
        sub = {k: v[2 * i:2 * i + 2] for k, v in tb.items()}
        out = slice_loss(tmodel, sub, derive_seed(9, i))
        out["loss"].backward()
        losses.append(float(out["loss"]))
        per_slice.append([None if p.grad is None else p.grad.clone()
                          for p in trainable])
    assert abs(float(metrics["loss"]) - np.mean(losses)) <= 1e-6 * abs(
        np.mean(losses))
    for a, g0, g1 in zip(acc, *per_slice):
        if a is None:
            assert g0 is None and g1 is None
            continue
        torch.testing.assert_close(a, (g0 + g1) / 2, rtol=1e-6, atol=1e-7)


def test_checkpointed_block_equals_plain_with_dropout():
    """Full and selective ("dots") remat against no remat, LoRA dropout on:
    the same output bit for bit and the same gradients, on plain rows and
    on packed rows (segment ids: the plain masked attention, whose
    products "dots" keeps)."""
    from audio_calm_torch.config import LoRAConfig as TLoRAConfig
    from audio_calm_torch.config import Qwen2Config as TQwen2Config

    lora = TLoRAConfig(rank=4, alpha=8.0, dropout=0.5)
    torch.manual_seed(0)
    plain = TQwen2Model(TQwen2Config.tiny(), lora, remat_policy="none")
    for p in plain.parameters():
        p.data.normal_(0.0, 0.1)
    models = [plain]
    for policy in ("full", "dots"):
        models.append(TQwen2Model(TQwen2Config.tiny(), lora,
                                  remat_policy=policy))
        models[-1].load_state_dict(plain.state_dict())
    for model in models:  # the same site numbers in every model
        for i, m in enumerate(m for m in model.modules()
                              if hasattr(m, "dropout_site")):
            m.dropout_site = i
    x = torch.randn(2, 9, 64)
    mask = torch.ones(2, 9, dtype=torch.int32)
    mask[1, 4:8] = 0
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 2, 2, 0], [1, 1, 2, 2, 2, 3, 3, 3,
                                                      3]])
    for kw in ({}, {"segment_ids": seg}):
        outs, grads = [], []
        for model in models:
            model.zero_grad(set_to_none=True)
            xi = x.clone().requires_grad_()
            out = model(xi, mask, train=True, seed=3, **kw)
            (out * torch.linspace(-1, 1, 64)).sum().backward()
            outs.append(out.detach())
            grads.append([xi.grad] + [p.grad for p in model.parameters()])
        for other in (1, 2):
            torch.testing.assert_close(outs[0], outs[other], rtol=0, atol=0)
            for a, b in zip(grads[0], grads[other]):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with torch.no_grad():  # dropout is on: another seed, another output
        assert not torch.equal(plain(x, mask, train=True, seed=4),
                               plain(x, mask, train=True, seed=3))
    with pytest.raises(ValueError, match="remat_policy"):
        TQwen2Model(TQwen2Config.tiny(), lora, remat_policy="some")


def test_dots_remat_keeps_the_products():
    """Under "dots" the backward recomputes no matrix product: it runs as
    many as with no remat, and "full" runs the forward's again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from audio_calm_torch.config import LoRAConfig as TLoRAConfig
    from audio_calm_torch.config import Qwen2Config as TQwen2Config

    class Products(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm,
                                       torch.ops.aten.bmm):
                self.n += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for policy in ("none", "dots", "full"):
        torch.manual_seed(0)
        model = TQwen2Model(TQwen2Config.tiny(), TLoRAConfig(
            rank=4, alpha=8.0, dropout=0.5), remat_policy=policy)
        out = model(torch.randn(2, 9, 64, requires_grad=True), train=True,
                    seed=1)
        with Products() as mode:
            out.sum().backward()
        counts[policy] = mode.n
    assert counts["dots"] == counts["none"] < counts["full"], counts


def test_training_loop_bf16_compute(calm_setup, tmp_path):
    """The flagship recipe at a tiny size: frozen weights stored bf16, fp32
    masters, bf16 compute, full remat, B=4 in 2 slices, warmup-cosine over
    4 steps: LR 0 at the first update, every trainable group moves at the
    second, frozen tensors never move."""
    _, cfg, params, _ = calm_setup
    tmodel = _port_model(params, cfg, lora=dataclasses.replace(
        _port_model(params, cfg).cfg.lora, dropout=0.05))
    tmodel.compute_dtype = torch.bfloat16
    tcfg = TTrainingConfig(frozen_weights_dtype="bfloat16", logging_steps=1,
                           microbatch_steps=2, warmup_ratio=0.1,
                           learning_rate=1e-3, output_dir=str(tmp_path))
    labels = toptim.freeze(tmodel, tcfg, task_mode="tts")
    trainable = {n: p for n, p in tmodel.named_parameters() if p.requires_grad}
    opt = toptim.AdamW(trainable, labels, tcfg, total_steps=4)
    step = make_calm_step(tmodel, opt, "tts", microbatch=2, seed=1)
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    snapshots = []

    def batches():
        for i in range(4):
            yield _torch_batch(_batch(seed=10 + i))
            snapshots.append({n: p.detach().clone()
                              for n, p in trainable.items()})

    history = run_training(step, batches(), tcfg, total_steps=4)
    assert len(history) == 4 and step.count == 4
    for rec in history:
        assert set(rec) >= {"loss", "loss_tts", "loss_len", "loss_dur",
                            "grad_norm", "step_s", "samples_per_sec"}
        assert all(np.isfinite(v) for v in rec.values())
    for n, p in tmodel.named_parameters():
        if labels[n] == "frozen":
            torch.testing.assert_close(p, before[n], rtol=0, atol=0)
            assert p.dtype == torch.bfloat16
    for n in trainable:  # after step 1 (LR 0): unchanged
        torch.testing.assert_close(snapshots[0][n], before[n], rtol=0, atol=0)
    moved = {labels[n] for n in trainable
             if not torch.equal(snapshots[1][n], before[n])}
    assert moved == {"decay", "no_decay", "proj", "head", "soa"}
    for p in trainable.values():
        assert p.dtype == torch.float32


def test_remat_policies_agree(calm_setup):
    """'full' recomputes every block, 'dots' keeps the products' outputs
    and recomputes the rest, 'none' keeps activations: the same loss and
    gradients (JAX's test of its policies)."""
    _, cfg, params, batch = calm_setup
    results = []
    for policy in ("full", "dots", "none"):
        tmodel = _port_model(params, cfg, remat_policy=policy)
        toptim.freeze(tmodel, TTrainingConfig())
        out = slice_loss(tmodel, _torch_batch(batch), seed=5)
        out["loss"].backward()
        results.append((float(out["loss"]),
                        [copy.deepcopy(p.grad) for p in tmodel.parameters()
                         if p.requires_grad]))
    for other in results[1:]:
        assert results[0][0] == other[0]
        for a, b in zip(results[0][1], other[1]):
            if a is None:
                assert b is None
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

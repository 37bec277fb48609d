"""The port's DiT flow head, predictor and ODE solver vs the JAX package,
fp32 on the CPU, on the same carried-across weights and the same explicit
ODE noise `x_init`.

Bound 5e-4, the JAX package's flow-head parity bound
(tests/test_component_parity.py::test_flow_head_parity): several fp32
layers (attention, LayerNorm, GELU MLPs) whose sums run in another order;
the ODE repeats the head a few times."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.models.calm_heads import (PredictorMLP as TPredictor,
                                                TransformerFlowHead as THead)
from audio_calm_torch.models.convert import from_jax_params
from audio_calm_torch.ops.ode import ode_solve as t_ode_solve
from audio_calm_tpu.models.calm_heads import PredictorMLP, TransformerFlowHead
from audio_calm_tpu.ops.ode import ode_solve

TOL = 5e-4
IN, OUT, HID, LAYERS, HEADS, CTX = 24, 12, 64, 2, 4, 24
B, T, S = 2, 10, 7


def _perturbed(params, seed, scale=0.05):
    """Init values + noise: the zero-init out_proj and ctx_gate must not
    hide the network from the comparison."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def head():
    rng = np.random.default_rng(0)
    inputs = dict(
        cond=rng.standard_normal((B, T, IN)).astype(np.float32),
        noisy=rng.standard_normal((B, T, OUT)).astype(np.float32),
        t=np.array([0.3, 0.8], np.float32),
        ctx=rng.standard_normal((B, S, CTX)).astype(np.float32),
        cmask=np.zeros((B, S), bool),
        xmask=np.zeros((B, T), bool),
    )
    inputs["cmask"][:, -2:] = True
    inputs["xmask"][0, -3:] = True
    m = TransformerFlowHead(input_dim=IN, output_dim=OUT, hidden_dim=HID,
                            num_layers=LAYERS, num_heads=HEADS,
                            context_dim=CTX, dropout=0.0)
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = m.init(jax.random.PRNGKey(0), j["cond"], j["noisy"], j["t"],
                    context=j["ctx"], context_mask=j["cmask"],
                    x_mask=j["xmask"])["params"]
    params = _perturbed(params, 1)
    tm = THead(IN, OUT, HID, LAYERS, HEADS, context_dim=CTX).eval()
    tm.load_state_dict(from_jax_params(params), strict=True)
    return m, {"params": params}, tm, inputs


def test_flow_head_matches_jax(head):
    m, params, tm, x = head
    ref = np.asarray(m.apply(params, x["cond"], x["noisy"], x["t"],
                             context=x["ctx"], context_mask=x["cmask"],
                             x_mask=x["xmask"]))
    with torch.no_grad():
        out = tm(*(torch.from_numpy(x[k]) for k in
                   ("cond", "noisy", "t", "ctx", "cmask", "xmask"))).numpy()
    assert np.abs(ref).max() > 1e-2  # out_proj perturbed: a live output
    assert np.max(np.abs(out - ref)) < TOL


def test_predictor_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 5, 16)).astype(
        np.float32)
    m = PredictorMLP(8)
    params = _perturbed(m.init(jax.random.PRNGKey(2), x)["params"], 3)
    ref = np.asarray(m.apply({"params": params}, x))
    tm = TPredictor(16, 8)
    tm.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (3, 5)
    assert np.max(np.abs(out - ref)) < TOL


@pytest.mark.parametrize("schedule", ["uniform", "sway"])
@pytest.mark.parametrize("method", ["euler", "midpoint"])
def test_ode_solve_bf16_state_updates_as_jax(method, schedule):
    """Serving keeps the ODE state in bf16. JAX computes each update
    x + dt*v in fp32 (its time grid is fp32) and rounds once; so does the
    port. With a velocity that is the same bf16 tensor on both sides, the
    12-step states agree but for rare last-bit flips of the fp32 sums
    (1 bf16 step at most)."""
    rng = np.random.default_rng(6)
    x0, v = (rng.standard_normal((2, 16, 8)).astype(np.float32)
             for _ in range(2))
    ref = np.asarray(ode_solve(
        lambda c, *a: c, jnp.asarray(v, jnp.bfloat16),
        jnp.asarray(x0, jnp.bfloat16), 12, method=method,
        time_schedule=schedule).astype(jnp.float32))
    out = t_ode_solve(lambda c, *a: c, torch.from_numpy(v).bfloat16(),
                      torch.from_numpy(x0).bfloat16(), 12, method=method,
                      time_schedule=schedule)
    assert out.dtype == torch.bfloat16
    diff = np.abs(out.float().numpy() - ref)
    assert diff.max() <= 2 ** -7 * np.abs(ref).max()
    assert (diff > 0).mean() < 0.05


@pytest.mark.parametrize("schedule", ["uniform", "sway"])
@pytest.mark.parametrize("cfg_scale", [1.0, 2.5])
@pytest.mark.parametrize("method", ["euler", "midpoint"])
def test_ode_solve_matches_jax(head, method, cfg_scale, schedule):
    m, params, tm, x = head
    x_init = np.random.default_rng(4).standard_normal((B, T, OUT)).astype(
        np.float32)

    def jax_head(c, xx, t, ctx, cm, xm):
        return m.apply(params, c, xx, t, context=ctx, context_mask=cm,
                       x_mask=xm)

    ref = np.asarray(ode_solve(
        jax_head, jnp.asarray(x["cond"]), jnp.asarray(x_init), 3, cfg_scale,
        context=jnp.asarray(x["ctx"]), context_mask=jnp.asarray(x["cmask"]),
        x_mask=jnp.asarray(x["xmask"]), method=method,
        time_schedule=schedule))
    with torch.no_grad():
        out = t_ode_solve(
            tm, torch.from_numpy(x["cond"]), torch.from_numpy(x_init), 3,
            cfg_scale, context=torch.from_numpy(x["ctx"]),
            context_mask=torch.from_numpy(x["cmask"]),
            x_mask=torch.from_numpy(x["xmask"]), method=method,
            time_schedule=schedule).numpy()
    assert np.max(np.abs(out - x_init)) > 1e-2  # the ODE moved the state
    assert np.max(np.abs(out - ref)) < TOL

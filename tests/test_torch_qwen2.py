"""The port's Qwen2 backbone with LoRA and the duration -> alignment build
vs the JAX package, fp32 on the CPU.

Bounds: 2e-4 for the backbone (the JAX package's Qwen2 parity bound,
tests/test_qwen2.py: two decoder layers in fp32, summed in another order);
the alignment is integer and must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import LoRAConfig as TLoRAConfig
from audio_calm_torch.config import Qwen2Config as TQwen2Config
from audio_calm_torch.models.convert import from_jax_params
from audio_calm_torch.models.qwen2 import Qwen2Model as TQwen2Model
from audio_calm_torch.ops.alignment import (
    build_alignment_from_durations as t_build)
from audio_calm_tpu.config import LoRAConfig, Qwen2Config
from audio_calm_tpu.models.qwen2 import Qwen2Model
from audio_calm_tpu.ops.alignment import build_alignment_from_durations


def test_qwen2_lora_matches_jax():
    cfg = Qwen2Config.tiny()
    lora = LoRAConfig(rank=4, alpha=8.0, dropout=0.0)
    B, T = 2, 9
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 4:8] = 0  # mid-sequence pad: text pad, then a valid SOA
    m = Qwen2Model(cfg, lora=lora, dtype=jnp.float32)
    params = m.init(jax.random.PRNGKey(0), x, jnp.asarray(mask))["params"]
    # lora_b is zero at init: perturb every leaf so the adapter counts
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    ref = np.asarray(m.apply({"params": params}, x, jnp.asarray(mask)))
    tm = TQwen2Model(TQwen2Config.tiny(),
                     lora=TLoRAConfig(rank=4, alpha=8.0, dropout=0.0)).eval()
    tm.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) < 2e-4


@pytest.mark.parametrize("case", [
    # (durations, valid, budget): in budget with a remainder to spread
    ([[3, 1, 2, 0, 0], [1, 1, 1, 1, 1]], [[1, 1, 1, 0, 0], [1] * 5], [12, 16]),
    # over budget: proportional floor shrink, then argmax repair
    ([[9, 9, 9, 1, 1], [20, 1, 1, 1, 1]], [[1] * 5, [1] * 5], [10, 7]),
    # over budget even at all ones (cannot shrink below 1 per token)
    ([[5, 5, 5, 5, 5], [2, 2, 0, 0, 0]], [[1] * 5, [1, 1, 0, 0, 0]], [3, 30]),
    # remainder larger than the number of valid tokens (several passes)
    ([[1, 1, 0, 0, 0], [0, 0, 0, 0, 0]], [[1, 1, 0, 0, 0], [0] * 5], [25, 9]),
    # invalid tokens carry durations that must be ignored
    ([[4, 7, 2, 8, 1], [2, 3, 4, 5, 6]], [[1, 0, 1, 0, 1], [0, 1, 1, 1, 0]],
     [9, 20]),
])
def test_alignment_is_bit_identical(case):
    dur, valid, budget = (np.asarray(a) for a in case)
    valid = valid.astype(bool)
    t_aud = 32
    ref = np.asarray(build_alignment_from_durations(
        jnp.asarray(dur, jnp.int32), jnp.asarray(valid), t_aud,
        budget=jnp.asarray(budget, jnp.int32)))
    out = t_build(torch.from_numpy(dur.astype(np.int32)),
                  torch.from_numpy(valid), t_aud,
                  budget=torch.from_numpy(budget.astype(np.int32))).numpy()
    np.testing.assert_array_equal(out, ref)


def test_alignment_random_batches_bit_identical():
    rng = np.random.default_rng(7)
    for _ in range(5):
        dur = rng.integers(0, 12, (4, 11)).astype(np.int32)
        valid = rng.random((4, 11)) < 0.8
        budget = rng.integers(1, 40, (4,)).astype(np.int32)
        ref = np.asarray(build_alignment_from_durations(
            jnp.asarray(dur), jnp.asarray(valid), 40,
            budget=jnp.asarray(budget)))
        out = t_build(torch.from_numpy(dur), torch.from_numpy(valid), 40,
                      budget=torch.from_numpy(budget)).numpy()
        np.testing.assert_array_equal(out, ref)

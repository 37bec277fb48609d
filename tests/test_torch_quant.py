"""The port's weight-only int8 LLM serving (models/quant.py, the int8 base of
models/lora.LoRADense) vs the JAX package's models/quant.py on the CPU, at
a tiny geometry (Qwen2Config.tiny(), LoRA r 2; a 2-layer DiT of 32 x 2).

Bounds: int8 weights and scales equal JAX's bit for bit, after the same
cast (fp32 and the server's bf16); bytes saved equal; the port's int8 TTS
latents within 1e-3 of JAX's int8 latents (the slice bound of
tests/test_torch_tts_slice.py); and JAX's own int8-vs-float bounds of
tests/test_quant.py held by the port: the hidden state's relative error
below 2e-2, the latents' below 0.1."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.eval import infer as tinfer
from audio_calm_torch.models import quant as TQ
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import load_calm
from audio_calm_torch.models.lora import LoRADense
from audio_calm_tpu.config import CALMModelConfig, LoRAConfig, Qwen2Config
from audio_calm_tpu.eval.infer import tts_decode, tts_encode
from audio_calm_tpu.models import quant as JQ
from audio_calm_tpu.models.calm import QwenCALM, init_calm_params
from audio_calm_tpu.models.flagship import cast_floating

T_AUD = 16
STEPS, CFG, METHOD = 4, 2.5, "midpoint"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def calm():
    cfg = CALMModelConfig(
        latent_dim=8, max_audio_len=T_AUD, max_text_len=8,
        tts_flow_hidden_dim=32, tts_flow_num_layers=2,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=2,
        qwen=Qwen2Config.tiny(vocab_size=256),
        lora=LoRAConfig(rank=2, alpha=4.0, dropout=0.0),
        latent_mean=0.1, latent_std=1.2,
    )
    model = QwenCALM(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: init_calm_params(model,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return (z / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (1.0 + 0.05 * z) if name == "scale" else 0.05 * z

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    # one column of zeros: its scale is 1.0, its int8 row all zeros
    params["llm"]["layers_0"]["mlp"]["up_proj"]["kernel"][:, 3] = 0.0
    return cfg, model, params


def _port(cfg, params):
    tmodel = TQwenCALM(from_dict(TCALMConfig, dataclasses.asdict(cfg))).eval()
    load_calm(tmodel, params)
    return tmodel


def _walk_int8(tree, scales, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            if "kernel" in v and v["kernel"].dtype == jnp.int8:
                yield path + (k,), v["kernel"], scales[k]["kernel_scale"]
            else:
                yield from _walk_int8(v, scales.get(k, {}), path + (k,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_weights_and_scales_equal_jax(calm, dtype):
    """The server's order: cast to the compute dtype, then quantize."""
    cfg, _, params = calm
    jparams = params if dtype == "float32" else cast_floating(
        params, jnp.bfloat16)
    qparams, qscale = JQ.quantize_llm_int8(jparams)
    tmodel = _port(cfg, params).to(getattr(torch, dtype))
    assert TQ.quantize_llm_int8(tmodel) == 7 * cfg.qwen.num_hidden_layers
    assert TQ.quantize_llm_int8(tmodel) == 0  # already int8
    sd = tmodel.state_dict()
    int8 = set()
    for path, q, s in _walk_int8(qparams["llm"], qscale["llm"]):
        name = "llm." + ".".join(path).replace("layers_", "layers.")
        np.testing.assert_array_equal(sd[name + ".weight"].numpy(),
                                      np.asarray(q).T, err_msg=name)
        np.testing.assert_array_equal(sd[name + ".kernel_scale"].numpy(),
                                      np.asarray(s), err_msg=name)
        int8.add(name + ".weight")
    assert len(int8) == 7 * cfg.qwen.num_hidden_layers
    assert sd["llm.layers.0.mlp.up_proj.kernel_scale"][3] == 1.0
    assert not sd["llm.layers.0.mlp.up_proj.weight"][3].any()
    # LoRA A/B, norms, biases, the embedding and the heads keep their dtype
    for k, v in sd.items():
        want = (torch.int8 if k in int8 else torch.float32
                if k.endswith(".kernel_scale") else getattr(torch, dtype))
        assert v.dtype == want, k


def test_int8_roundtrip_exact_for_small_ints():
    """Entries that are exact multiples of absmax/127 survive (the JAX
    package's case), and the kernel's values equal JAX's."""
    rng = np.random.default_rng(1)
    ints = rng.integers(-127, 128, (16, 8))
    ints[0, :] = 127
    w = (ints.astype(np.float32) / 127.0
         * rng.uniform(0.5, 2.0, (1, 8)).astype(np.float32))  # [in, out]
    q, s = TQ.quantize_weight(torch.from_numpy(w.T.copy()))
    jq, js = jax.jit(JQ._quantize_kernel)(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = q.float().numpy() * s.numpy()[:, None]
    np.testing.assert_allclose(back, w.T, rtol=0, atol=1e-6)


def test_bytes_saved_equal_jax(calm):
    cfg, _, params = calm
    tmodel = _port(cfg, params)
    want = JQ.quantized_bytes_saved(params)
    assert TQ.quantized_bytes_saved(tmodel) == want > 0
    TQ.quantize_llm_int8(tmodel)  # counted from the shapes either way
    assert TQ.quantized_bytes_saved(tmodel) == want


def test_int8_hidden_and_latents_match_jax(calm):
    """int8 encode and TTS latents, port vs JAX (fp32 compute), and JAX's
    int8-vs-float bounds held by the port."""
    cfg, model, params = calm
    ids = np.array([[11, 23, 5, 77, 41, 9], [3, 8, 130, 64, 0, 0]], np.int32)
    mask = np.array([[1] * 6, [1, 1, 1, 1, 0, 0]], np.int32)
    x0 = np.random.default_rng(5).standard_normal((2, T_AUD, 8)).astype(
        np.float32)
    qparams, qscale = JQ.quantize_llm_int8(params)
    jvars = {"params": qparams, "qscale": qscale}
    cv, ctx, pad, nf = tts_encode(model, jvars, jnp.asarray(ids),
                                  jnp.asarray(mask))
    nf = jnp.full_like(nf, 12)
    lat = np.asarray(tts_decode(model, jvars, cv, ctx, pad, nf, None,
                                steps=STEPS, cfg_scale=CFG, t_aud=T_AUD,
                                method=METHOD, x_init=jnp.asarray(x0)))
    tfloat = _port(cfg, params)
    tq = _port(cfg, params)
    TQ.quantize_llm_int8(tq)
    kw = dict(steps=STEPS, cfg_scale=CFG, t_aud=T_AUD,
              num_frames_override=12, method=METHOD,
              x_init=torch.from_numpy(x0), device="cpu")
    tlat = tinfer.tts_generate_latents(tq, ids, mask, **kw)[0].numpy()
    flat = tinfer.tts_generate_latents(tfloat, ids, mask, **kw)[0].numpy()
    assert np.abs(lat).max() > 1e-2
    assert np.max(np.abs(tlat - lat)) < 1e-3
    assert np.linalg.norm(tlat - flat) / np.linalg.norm(flat) < 0.1

    with torch.no_grad():
        t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
        h_q = tq.encode_text_for_tts(t_ids, t_mask)[1].numpy()
        h_f = tfloat.encode_text_for_tts(t_ids, t_mask)[1].numpy()
    assert np.linalg.norm(h_q - h_f) / np.linalg.norm(h_f) < 2e-2
    np.testing.assert_allclose(h_q, np.asarray(ctx), rtol=0, atol=1e-4)


def test_maybe_quantize_from_env(calm, monkeypatch):
    cfg, _, params = calm
    tmodel = _port(cfg, params)
    monkeypatch.delenv("AUDIO_CALM_LLM_WEIGHTS", raising=False)
    assert TQ.maybe_quantize_from_env(tmodel) is tmodel
    assert all(m.weight.dtype == torch.float32 for m in tmodel.modules()
               if isinstance(m, LoRADense))
    monkeypatch.setenv("AUDIO_CALM_LLM_WEIGHTS", "int8")
    assert TQ.maybe_quantize_from_env(tmodel) is tmodel
    assert tmodel.llm.layers[1].mlp.up_proj.weight.dtype == torch.int8
    # only the backbone: the heads' projections keep their weights
    assert tmodel.asr_cross_attn.q_proj.weight.dtype == torch.float32

"""The port's ASR path (QwenCALM's ASR members, load_calm with both
branches, eval/infer's asr_encode / asr_decode / asr_generate_ids,
truncate_at_eos, CALMInference.asr / asr_batch, data/tokenizer's
ByteTokenizer) vs the JAX package on the CPU, at a tiny geometry whose ASR
head has asr.yaml's head dim: hidden 96 over 2 heads, d = 48.

Both branches' weights are random, from numpy, in the shapes JAX's
init_calm_params gives. Bounds, fp32 on both sides: the condition 1e-4 (a
2-layer LLM and one cross-attention summed in another order); ids and
query lengths equal; the ODE state before the search 1e-3 (a 2-layer DiT
evaluated 4 or 8 times, under CFG 2 in one case); nearest-token ids equal, as in
tests/test_calm_model.py; transcripts of a batch equal the solo ones, the
contract of tests/test_serving_batch.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.data.tokenizer import ByteTokenizer as TByteTokenizer
from audio_calm_torch.eval import infer as tinfer
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import ASR_COMPONENTS, load_calm
from audio_calm_tpu.config import CALMModelConfig, LoRAConfig, Qwen2Config
from audio_calm_tpu.data.tokenizer import ByteTokenizer
from audio_calm_tpu.eval import infer as jinfer
from audio_calm_tpu.models.calm import QwenCALM, init_calm_params
from audio_calm_tpu.ops.ode import ode_solve

T_AUD, Q = 48, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread each runs them fastest."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def asr_models():
    cfg = CALMModelConfig(
        latent_dim=8, max_audio_len=T_AUD, max_text_len=Q,
        tts_flow_hidden_dim=32, tts_flow_num_layers=1,
        asr_flow_hidden_dim=96, asr_flow_num_layers=2, flow_num_heads=2,
        qwen=Qwen2Config.tiny(), lora=LoRAConfig(rank=2, alpha=4.0,
                                                 dropout=0.0),
        latent_mean=0.1, latent_std=1.2,
    )
    model = QwenCALM(cfg, dtype=jnp.float32)
    # both branches' shapes from init_calm_params, traced, not run; values
    # from numpy: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2),
    # everything else N(0, 0.05^2)
    shapes = jax.eval_shape(lambda: init_calm_params(model,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.05 * z if name == "scale" else 0.05 * z

    params = {"params": jax.tree_util.tree_map_with_path(draw, shapes)}
    tmodel = TQwenCALM(from_dict(TCALMConfig, dataclasses.asdict(cfg))).eval()
    load_calm(tmodel, params)
    return model, params, tmodel


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((2, T_AUD, 8)).astype(np.float32)
    amask = (np.arange(T_AUD)[None, :] < np.array([[T_AUD], [30]])).astype(
        np.int32)
    prompt = np.array([[5, 9, 33, 71, 2, 0], [40, 41, 42, 43, 44, 45]],
                      np.int32)
    pmask = np.array([[1, 1, 1, 1, 1, 0], [1] * 6], np.int32)
    return lat, amask, prompt, pmask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_condition(model, params, *inputs):
    return jax.jit(lambda p, *a: model.apply(
        p, *a, Q, method=QwenCALM.asr_encode_audio))(params, *inputs)


def test_asr_encode_audio_matches_jax(asr_models):
    model, params, tmodel = asr_models
    lat, amask, prompt, pmask = _inputs()
    ref = np.asarray(_jax_condition(model, params, lat, amask, prompt,
                                    pmask))
    with torch.no_grad():
        out = tmodel.asr_encode_audio(*_t(lat, amask, prompt, pmask),
                                      Q).numpy()
    assert out.shape == ref.shape == (2, Q, 64)
    assert np.abs(ref).max() > 1e-2
    assert np.max(np.abs(out - ref)) < 1e-4


def test_search_nearest_tokens_matches_jax(asr_models):
    model, params, tmodel = asr_models
    table = params["params"]["embed"]["embedding"]
    probe = np.stack([table[5], table[42], table[200]])[None]  # [1, 3, D]
    x = np.random.default_rng(2).standard_normal((2, 7, 64)).astype(
        np.float32)
    for arr in (probe, x):
        ref = np.asarray(model.apply(params, arr,
                                     method=QwenCALM.search_nearest_tokens))
        out = tmodel.search_nearest_tokens(torch.from_numpy(arr)).numpy()
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        tmodel.search_nearest_tokens(torch.from_numpy(probe)).numpy()[0],
        [5, 42, 200])


@pytest.mark.parametrize("method,cfg_scale,steps", [("euler", 1.0, 4),
                                                    ("midpoint", 2.0, 4)])
def test_asr_generate_ids_matches_jax(asr_models, method, cfg_scale, steps):
    """ids and query lengths equal; the ODE state before the search within
    1e-3 of JAX's (the same x_init on both sides)."""
    model, params, tmodel = asr_models
    lat, amask, prompt, pmask = _inputs()
    x0 = np.random.default_rng(3).standard_normal((2, Q, 64)).astype(
        np.float32)
    ode = dict(steps=steps, cfg_scale=cfg_scale, method=method)
    ids, q_len = jax.jit(lambda p, *a: jinfer.asr_generate_ids(
        model, p, *a, jax.random.PRNGKey(0), num_queries=Q,
        x_init=jnp.asarray(x0), **ode))(params, lat, amask, prompt, pmask)

    # JAX's state before the search: asr_generate_ids' own steps
    def state_fn(p, *a):
        cond = model.apply(p, *a, Q, method=QwenCALM.asr_encode_audio)
        q_valid = jnp.arange(Q)[None, :] < q_len[:, None]
        return ode_solve(
            lambda c, x, t, ctx, cm, xm: model.apply(
                p, c, x, t, ctx, cm, xm, method=QwenCALM.asr_flow_fn),
            cond * q_valid[:, :, None], jnp.asarray(x0), steps, cfg_scale,
            x_mask=~q_valid, method=method)

    state = np.asarray(jax.jit(state_fn)(params, lat, amask, prompt, pmask))

    tids, tq_len = tinfer.asr_generate_ids(
        tmodel, lat, amask, prompt, pmask, num_queries=Q,
        x_init=torch.from_numpy(x0), device="cpu", **ode)
    np.testing.assert_array_equal(tq_len.numpy(), np.asarray(q_len))
    np.testing.assert_array_equal(tq_len.numpy(), [12, 10])  # 48//4, 30//4
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    cond_t, qv_t, _ = tinfer.asr_encode(tmodel, *_t(lat, amask, prompt,
                                                    pmask), Q)
    tstate = tinfer.asr_decode(tmodel, cond_t, qv_t, x_init=torch.from_numpy(
        x0), **ode).numpy()
    assert np.max(np.abs(tstate - state)) < 1e-3
    assert np.abs(tstate - x0).max() > 1e-2  # the ODE moved the state


def test_asr_noise_from_a_generator(asr_models):
    """Without x_init the noise comes from the generator: reproducible."""
    _, _, tmodel = asr_models
    lat, amask, prompt, pmask = _inputs()
    a, b = (tinfer.asr_generate_ids(
        tmodel, lat, amask, prompt, pmask, torch.Generator().manual_seed(4),
        steps=2, num_queries=Q, device="cpu")[0] for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_truncate_at_eos():
    """The cases of tests/test_infer.py, against JAX's function too."""
    cases = [(np.array([5, 9, 151643, 7]), 4, None),
             (np.array([5, 9, 151643, 7]), 2, None),
             (np.array([1, 2, 3]), 3, {2}),
             (np.array([4, 151645, 6]), 3, None)]
    for ids, n, extra in cases:
        assert tinfer.truncate_at_eos(ids, n, extra) == \
            jinfer.truncate_at_eos(ids, n, extra)
    assert tinfer.truncate_at_eos(cases[0][0], 4) == [5, 9]
    assert tinfer.truncate_at_eos(cases[1][0], 2) == [5, 9]
    assert tinfer.truncate_at_eos(cases[2][0], 3, extra_eos={2}) == [1]
    assert tinfer.ASR_PROMPT == jinfer.ASR_PROMPT
    assert tinfer.EOS_CANDIDATES == jinfer.EOS_CANDIDATES


@pytest.mark.parametrize("text", ["hello world", "",
                                  "päivää <|im_end|> 你好\n",
                                  jinfer.ASR_PROMPT])
def test_byte_tokenizer_round_trips(text):
    tok, ref = TByteTokenizer(), ByteTokenizer()
    ids = tok.encode(text)
    assert ids == ref.encode(text)
    assert tok.decode(ids, skip_special_tokens=False) == text
    assert tok.decode(ids) == text.replace("<|im_end|>", "")
    assert tok.decode(ids + [300, 0]) == ref.decode(ids + [300, 0])
    assert (tok.pad_token_id, tok.eos_token_id, tok.vocab_size) == (0, 1, 258)


def test_asr_batch_rows_equal_solo(asr_models):
    """Row i of a batch (3 items, padded to 4) is the transcript and the ids
    that solo `asr` gives for the same seed: the noise is drawn from the
    seed alone and the batch compute is masked per row."""
    _, _, tmodel = asr_models
    inf = tinfer.CALMInference(tmodel, TByteTokenizer(), device="cpu")
    rng = np.random.default_rng(3)
    lats = [rng.standard_normal((t, 8)).astype(np.float32)
            for t in (40, 16, 60)]  # 60 > max_audio_len: truncated
    seeds = [5, 6, 7]
    texts = inf.asr_batch(lats, seeds, steps=3)
    ids, q_len = inf._asr_ids(lats, seeds, steps=3)
    assert len(texts) == 3 and ids.shape == (3, Q)
    np.testing.assert_array_equal(q_len, [10, 10, 12])
    for i, (lat, seed) in enumerate(zip(lats, seeds)):
        assert texts[i] == inf.asr(lat, seed, steps=3)
        solo_ids, _ = inf._asr_ids([lat], [seed], steps=3,
                                        pad_batch=False)
        np.testing.assert_array_equal(ids[i], solo_ids[0])
    # the seed sets the row: another seed, other ids
    other, _ = inf._asr_ids(lats[:1], [8], steps=3)
    assert not np.array_equal(other[0], ids[0])


def test_load_calm_branches(asr_models):
    """Strict per branch: the whole tree loads; a tree with part of the ASR
    branch, or without the TTS branch, or with an unknown tensor, is
    refused; a TTS-only tree leaves the ASR modules as they were."""
    _, params, tmodel = asr_models
    tree = params["params"]
    fresh = TQwenCALM(tmodel.cfg)
    q_before = fresh.asr_query_embed.embedding.detach().clone()
    load_calm(fresh, {k: v for k, v in tree.items()
                      if k not in ASR_COMPONENTS})
    assert torch.equal(fresh.asr_query_embed.embedding, q_before)
    torch.testing.assert_close(fresh.soa_embed,
                               torch.from_numpy(tree["soa_embed"]))
    for drop in ASR_COMPONENTS:
        with pytest.raises(ValueError, match="not all of it"):
            load_calm(fresh, {k: v for k, v in tree.items() if k != drop})
    with pytest.raises(ValueError, match="TTS branch"):
        load_calm(fresh, {k: v for k, v in tree.items()
                          if k != "tts_flow_head"})
    extra = dict(tree, asr_query_embed={"embedding": tree["asr_query_embed"][
        "embedding"], "bias": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="unexpected"):
        load_calm(fresh, extra)
    load_calm(fresh, params)
    torch.testing.assert_close(
        fresh.asr_query_embed.embedding,
        torch.from_numpy(tree["asr_query_embed"]["embedding"]))


def test_asr_dropout_sites_follow_the_tts_ones(asr_models):
    """The ASR modules' dropout sites come after every TTS site, so the
    TTS training masks keep their seeds."""
    _, _, tmodel = asr_models
    sites = {name: m.dropout_site for name, m in tmodel.named_modules()
             if hasattr(m, "dropout_site")}
    asr = [s for n, s in sites.items() if n.split(".")[0] in ASR_COMPONENTS]
    tts = [s for n, s in sites.items()
           if n.split(".")[0] not in ASR_COMPONENTS]
    assert asr and tts and min(asr) > max(tts)
    assert sorted(sites.values()) == list(range(len(sites)))

"""The rest of the port's CALMInference (audio_calm_torch/eval/infer.py) vs
the JAX package, at the tiny geometry of tests/test_serving_batch.py:
the text / wav splitters and crossfades (exact), prompt bucketing and
pick_bucket (equal), tts and tts_batch on JAX's own noise (latents within
1e-3, the bound of tests/test_torch_tts_slice.py; lengths and grids
equal), and the contracts of tests/test_serving_batch.py,
tests/test_asr_stream.py and tests/test_infer.py on the port alone, in
fp32: a batched row equals its solo synthesis exactly on the same grid
(within 1e-4 across grids, the JAX test's bound: the masked attention sums
over another length), long-form streamed == whole == batched, asr_stream
== asr_long == the per-chunk solo decodes.

Weights: numpy values; for the comparison with JAX in the shapes of JAX's
init_calm_params (traced, not run), carried across by load_calm. The tests
of the port's own contracts build no JAX model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import MelConfig as TMelConfig
from audio_calm_torch.config import VAEModelConfig as TVAEConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.data.tokenizer import ByteTokenizer as TByteTokenizer
from audio_calm_torch.eval import infer as tinfer
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import load_calm
from audio_calm_torch.models.flagship import build_random
from audio_calm_torch.models.vae import AcousticVAE as TVAE
from audio_calm_torch.serving.frontend import encode_chunks, make_asr_frontend
from audio_calm_tpu.config import CALMModelConfig, LoRAConfig, Qwen2Config
from audio_calm_tpu.data.tokenizer import ByteTokenizer
from audio_calm_tpu.eval import infer as jinfer
from audio_calm_tpu.models.calm import QwenCALM, init_calm_params

BUCKETS = dict(audio_buckets=[16, 32], text_buckets=[64, 96])
ODE = dict(steps=2, cfg_scale=1.5)
TEXTS, SEEDS = ["hi", "hello world", "cats"], [11, 22, 33]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread each runs them fastest."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class WordTokenizer:
    """A tokenizer of whole words, so short prompts predict short lengths
    and land on the 16-frame grid (bytes put every prompt past 32)."""

    pad_token_id, eos_token_id = 0, 1

    def encode(self, text, add_special_tokens=False):
        return [2 + sum(map(ord, w)) % 250 for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _jax_cfg():
    return CALMModelConfig(
        latent_dim=8, max_audio_len=32, max_text_len=12,
        tts_flow_hidden_dim=32, tts_flow_num_layers=1,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=Qwen2Config.tiny(vocab_size=256),
        lora=LoRAConfig(rank=2, alpha=4.0, dropout=0.0),
        latent_mean=0.1, latent_std=1.2)


def _numpy_draw(rng, shape, fan_in, norm_scale):
    """Kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2), the rest
    N(0, 0.05^2)."""
    z = rng.standard_normal(shape).astype(np.float32)
    if len(shape) >= 2:
        return z / np.sqrt(fan_in)
    return 1.0 + 0.05 * z if norm_scale else 0.05 * z


@pytest.fixture(scope="module")
def tmodel():
    """The port's model alone, numpy weights on its own parameters: the
    port-side contracts need no JAX."""
    model = TQwenCALM(from_dict(TCALMConfig,
                                dataclasses.asdict(_jax_cfg()))).eval()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(_numpy_draw(
                rng, tuple(p.shape), np.prod(p.shape[1:]), "norm" in name)))
    return model


def _tinf(model, tok=None, **buckets):
    return tinfer.CALMInference(model, tok or TByteTokenizer(),
                                device="cpu", **(buckets or BUCKETS))


# ---------------------------------------------------------------------------
# splitters and crossfades: exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("text,extra", [
    ("The cat sat on the mat. It was a sunny day! Dogs bark loudly; cats "
     "purr quietly. The end.", 30),
    ("word " * 40, 20),
    ("One. Two? Three! Four; five: six.", 4),
    ("", 10),
])
def test_split_text_for_tts_matches_jax(text, extra):
    tok = ByteTokenizer()
    budget = len(tok.encode(jinfer.TTS_PROMPT.format(""))) + extra
    ref = jinfer.split_text_for_tts(text, tok, budget)
    assert tinfer.split_text_for_tts(text, TByteTokenizer(), budget) == ref


def test_split_text_budgets_the_assembled_prompt():
    """A seam-taxing tokenizer (tests/test_infer.py): the port packs by the
    assembled prompt, chunk for chunk as JAX does."""

    class SeamTokenizer:
        def encode(self, s, add_special_tokens=False):
            return list(range(len(s.split()) + (5 if "text:\nZed" in s
                                                else 0)))

    text = ("Zed went home early today because rain. Zed ate beans and "
            "toast for dinner. Zed slept soundly through the night.")
    budget = len(SeamTokenizer().encode(jinfer.TTS_PROMPT.format(""))) + 12
    assert (tinfer.split_text_for_tts(text, SeamTokenizer(), budget)
            == jinfer.split_text_for_tts(text, SeamTokenizer(), budget))


def _random_pieces(rng, wav):
    pieces, pos = [], 0
    while pos < len(wav):
        n = int(rng.choice([0, 1, 37, 400, 1000, 5000, 16000]))
        pieces.append(wav[pos: pos + n])
        pos += n
    return pieces + [wav[len(wav):]]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_split_wav_matches_jax(seed):
    rng = np.random.default_rng(seed)
    max_s = int(rng.integers(2000, 20000))
    search = int(rng.integers(400, max_s))
    wav = (rng.standard_normal(int(rng.integers(0, 5 * max_s))) * 0.5
           ).astype(np.float32)
    if len(wav) > 1200:
        at = int(rng.integers(0, len(wav) - 1200))
        wav[at: at + 1200] = 0.0
    ref = jinfer.split_wav_for_asr(wav, max_s, search_samples=search)
    out = tinfer.split_wav_for_asr(wav, max_s, search_samples=search)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    pieces = _random_pieces(rng, wav)
    tagged = list(tinfer.split_wav_for_asr_stream(
        iter(pieces), max_s, search_samples=search, tagged=True))
    ref_tagged = list(jinfer.split_wav_for_asr_stream(
        iter(pieces), max_s, search_samples=search, tagged=True))
    assert [f for _, f in tagged] == [f for _, f in ref_tagged]
    for (a, _), b in zip(tagged, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ms", [0.0, 20.0, 500.0])
@pytest.mark.parametrize("lengths", [(1000, 0, 500, 7, 2000), (0,), (5,),
                                     (320, 320, 1, 640, 0, 0, 321)])
def test_crossfades_match_jax(ms, lengths):
    rng = np.random.default_rng(int(ms))
    wavs = [rng.standard_normal(n).astype(np.float32) for n in lengths]
    ref = jinfer.crossfade_concat(wavs, crossfade_ms=ms)
    np.testing.assert_array_equal(
        tinfer.crossfade_concat(wavs, crossfade_ms=ms), ref)
    pieces = list(tinfer.crossfade_stream(iter(wavs), crossfade_ms=ms))
    ref_pieces = list(jinfer.crossfade_stream(iter(wavs), crossfade_ms=ms))
    assert len(pieces) == len(ref_pieces)
    for a, b in zip(pieces, ref_pieces):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        np.concatenate(pieces or [np.zeros(0, np.float32)]), ref)
    assert tinfer.crossfade_concat([]).shape == (0,)


# ---------------------------------------------------------------------------
# prompts, buckets, noise
# ---------------------------------------------------------------------------
def test_prompt_arrays_and_pick_bucket_match_jax(tmodel):
    ref = jinfer.CALMInference(QwenCALM(_jax_cfg()), None, ByteTokenizer(),
                               **BUCKETS)
    out = _tinf(tmodel)
    for text in ("hi", "a" * 20, "b" * 30):
        a, m = out._prompt_arrays(jinfer.TTS_PROMPT.format(text))
        ra, rm = ref._prompt_arrays(jinfer.TTS_PROMPT.format(text))
        np.testing.assert_array_equal(a, ra)
        np.testing.assert_array_equal(m, rm)
    with pytest.warns(UserWarning, match="truncated"):
        a, m = out._prompt_arrays("x" * 120)
    with pytest.warns(UserWarning, match="truncated"):
        ra, rm = ref._prompt_arrays("x" * 120)
    np.testing.assert_array_equal(a, ra)
    np.testing.assert_array_equal(m, rm)
    for n in (1, 5, 16, 17, 32, 999):
        assert out.pick_bucket(n) == ref.pick_bucket(n)
    plain = _tinf(tmodel, audio_buckets=None, text_buckets=None)
    assert plain.pick_bucket(5) == 32
    assert plain._prompt_arrays("hi")[0].shape == (1, 2)


def test_noise_is_the_seeds_alone(tmodel):
    """A row's noise is drawn at the full grid from its seed, the same
    whatever the batch; pad rows repeat row 0."""
    inf = _tinf(tmodel)
    a = inf._noise([5, 6, 7], None, 32, 8, 4)
    b = inf._noise([6], None, 32, 8, 1)
    assert torch.equal(a[1], b[0]) and torch.equal(a[3], a[0])
    assert not torch.equal(a[0], a[1])


# ---------------------------------------------------------------------------
# TTS against JAX, and the batch contracts
# ---------------------------------------------------------------------------
def test_tts_and_tts_batch_match_jax():
    """The port's tts_batch of three texts and tts of one, on the JAX
    package's weights and on the noise its keys draw at the full grid, vs
    JAX's: predicted lengths and grids equal, latents within 1e-3. With
    the word tokenizer the solo text runs on the 16-frame grid, its noise
    sliced from the full grid as JAX slices it. (One test: the JAX side
    compiles each shape once.)"""
    cfg = _jax_cfg()
    model = QwenCALM(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: init_calm_params(model,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    params = {"params": jax.tree_util.tree_map_with_path(
        lambda path, leaf: _numpy_draw(rng, leaf.shape,
                                       np.prod(leaf.shape[:-1]),
                                       path[-1].key == "scale"), shapes)}
    port = TQwenCALM(from_dict(TCALMConfig, dataclasses.asdict(cfg))).eval()
    load_calm(port, params)
    keys = [jax.random.PRNGKey(s) for s in SEEDS]
    for tok, ttok, texts, buckets, solo, solo_grid in (
            (ByteTokenizer(), TByteTokenizer(), TEXTS, BUCKETS, 1, 32),
            (WordTokenizer(), WordTokenizer(),
             ["hi", "a b c d e f g h i j k", "cats and dogs"],
             dict(audio_buckets=[16, 32], text_buckets=[8, 16]), 0, 16)):
        ref = jinfer.CALMInference(model, params, tok, **buckets)
        noise = np.asarray(ref._noise_stack(jnp.stack(keys), 32, 32, 8,
                                            jnp.float32))
        inf = _tinf(port, ttok, **buckets)
        rlat, rnf, rgrid = ref.tts_batch(texts, keys, **ODE)
        lat, nf, grid = inf.tts_batch(texts, SEEDS, x_init=noise, **ODE)
        assert (nf, grid) == (rnf, rgrid) and lat.shape == rlat.shape
        assert np.abs(rlat).max() > 0.1
        assert np.max(np.abs(lat - rlat)) < 1e-3
        rgrid_lat, rn = ref.tts(texts[solo], keys[solo], pad_to_grid=True,
                                **ODE)
        grid_lat, n = inf.tts(texts[solo], SEEDS[solo], pad_to_grid=True,
                              x_init=noise[solo], **ODE)
        assert n == rn and grid_lat.shape == rgrid_lat.shape == (solo_grid, 8)
        assert np.max(np.abs(grid_lat - rgrid_lat)) < 1e-3
        lat1, n1 = inf.tts(texts[solo], SEEDS[solo], x_init=noise[solo], **ODE)
        assert n1 == n and np.array_equal(lat1, grid_lat[:n])


@pytest.mark.parametrize("tok", ["bytes", "words"])
def test_tts_batch_rows_equal_solo(tmodel, tok):
    """Row i of a batch (padded 3 -> 4) is the solo synthesis with seed i:
    exactly where the solo call picks the batch's grid, within 1e-4 (the
    JAX test's bound) where it picks a smaller one."""
    if tok == "bytes":
        inf, texts = _tinf(tmodel), TEXTS
    else:
        inf = _tinf(tmodel, WordTokenizer(), audio_buckets=[16, 32],
                    text_buckets=[8, 16])
        texts = ["hi", "a b c d e f g h i j k", "cats and dogs"]
    lat, nf, grid = inf.tts_batch(texts, SEEDS, **ODE)
    assert lat.shape[0] == 3
    for i, text in enumerate(texts):
        solo, n = inf.tts(text, SEEDS[i], pad_to_grid=True, **ODE)
        assert n == nf[i]
        if solo.shape[0] == grid:
            np.testing.assert_array_equal(solo, lat[i])
        else:
            np.testing.assert_allclose(solo[:n], lat[i, :n], rtol=1e-4,
                                       atol=1e-4)
    if tok == "words":
        assert grid == 32 and min(nf) < 16  # a row crossed grids


def _value_render(latents, n):
    """A deterministic "waveform" made from the latent values: any latent
    difference shows in the audio."""
    return np.repeat(np.asarray(latents[: int(n)], np.float32).sum(axis=1),
                     1024)


_value_render.batch = lambda lat, ns: [_value_render(lat[i], n)
                                       for i, n in enumerate(ns)]


def test_tts_long_stream_whole_and_batched_agree(tmodel):
    inf = _tinf(tmodel)
    tok = TByteTokenizer()
    budget = len(tok.encode(tinfer.TTS_PROMPT.format(""))) + 16
    text = "The cat sat. The dog ran! All done."
    chunks = inf.split_chunks(text, budget)
    assert len(chunks) == 3
    kw = dict(max_chunk_tokens=budget, **ODE)
    pieces = list(inf.tts_long_stream(text, 7, _value_render, **kw))
    whole = inf.tts_long(text, 7, _value_render, **kw)
    np.testing.assert_array_equal(np.concatenate(pieces), whole)
    assert len(pieces) == len(chunks) + 1  # the last fade tail held back
    fade = int(16000 * 0.02)
    assert whole.shape == (len(chunks) * 32 * 1024 - (len(chunks) - 1) * fade,)
    for bs in (8, 2):  # one group of 3 (padded to 4), groups of 2 and 1
        np.testing.assert_array_equal(
            inf.tts_long_batched(text, 7, _value_render, batch_size=bs, **kw),
            whole)
    # each chunk is the solo synthesis with its chunk seed
    seeds = tinfer.chunk_seeds(7, len(chunks))
    wavs = [_value_render(*inf.tts(c, s, pad_to_grid=True, **ODE))
            for c, s in zip(chunks, seeds)]
    np.testing.assert_array_equal(tinfer.crossfade_concat(wavs), whole)
    # injected noise, one row per chunk, replaces the draws
    x0 = np.random.default_rng(3).standard_normal(
        (len(chunks), 32, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        inf.tts_long(text, 7, _value_render, x_init=x0, **kw),
        inf.tts_long_batched(text, 7, _value_render, x_init=x0, **kw))
    # a text of one chunk is its solo call with the seed itself
    np.testing.assert_array_equal(
        inf.tts_long("hi", 5, _value_render, **ODE),
        _value_render(*inf.tts("hi", 5, pad_to_grid=True, **ODE)))


def test_tts_long_batched_at_eight_rows(tmodel):
    """Five chunks in one group pad to 8 rows (16 with CFG): the CPU's GEMM
    then takes another kernel for the DiT's time MLP than at 2 rows (a
    2.4e-7 row difference in its fc1), the same row-count effect as
    cuBLAS's on the card, so the latents agree within 1e-5 there, not bit
    for bit."""
    inf = _tinf(tmodel)
    budget = len(TByteTokenizer().encode(tinfer.TTS_PROMPT.format(""))) + 16
    text = "The cat sat. The dog ran! A bird flew; fish swam. All done."
    assert len(inf.split_chunks(text, budget)) == 5
    kw = dict(max_chunk_tokens=budget, **ODE)
    np.testing.assert_allclose(
        inf.tts_long_batched(text, 7, _value_render, **kw),
        inf.tts_long(text, 7, _value_render, **kw), rtol=0, atol=1e-5)


def test_chunk_seeds():
    assert tinfer.chunk_seeds(42, 1) == [42]
    many = tinfer.chunk_seeds(42, 5)
    assert many == [tinfer.chunk_seed(42, i) for i in range(5)]
    assert many[:3] == tinfer.chunk_seeds(42, 3)  # no dependence on n
    assert len(set(many)) == 5 and all(0 <= s < 2 ** 63 for s in many)
    assert tinfer.chunk_seed(43, 0) != many[0]


# ---------------------------------------------------------------------------
# long-form and streaming ASR
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def frontend():
    vae_cfg = TVAEConfig(hidden_channels=32, latent_channels=8,
                         norm_num_groups=8)
    vae = build_random(lambda: TVAE(vae_cfg), "cpu", seed=1, scale=0.1)
    prep, batch = make_asr_frontend(vae, vae_cfg, TMelConfig(), [16, 32],
                                    device="cpu")
    return prep, batch, 32 * vae_cfg.total_stride * 256


def test_asr_long_equals_per_chunk_solo(tmodel, frontend):
    """asr_long == the per-chunk solo asr() calls with chunk_seeds, whatever
    the decode grouping; a wav that fits is its solo asr(seed)."""
    inf = _tinf(tmodel)
    prep, batch, max_wav = frontend

    def encode(chunks):
        return encode_chunks(prep, batch, chunks)

    wav = (np.random.default_rng(9).standard_normal(int(2.6 * max_wav))
           * 0.3).astype(np.float32)
    joined = inf.asr_long(wav, 21, encode, max_wav, steps=2)
    chunks = [c for c in tinfer.split_wav_for_asr(
        wav, max_wav, search_samples=24000) if len(c)]
    assert len(chunks) >= 3
    lats = encode(chunks)
    texts = [inf.asr(lat, s, steps=2)
             for lat, s in zip(lats, tinfer.chunk_seeds(21, len(chunks)))]
    assert joined == " ".join(t.strip() for t in texts if t.strip())
    assert joined.strip()
    assert joined == inf.asr_long(wav, 21, encode, max_wav, steps=2,
                                  max_decode_batch=2)
    short = wav[: max_wav - 2048]
    assert (inf.asr_long(short, 21, encode, max_wav, steps=2)
            == inf.asr(encode([short])[0], 21, steps=2).strip())


def test_asr_stream_equals_asr_long(tmodel, frontend):
    """" ".join(asr_stream(pieces)) == asr_long(concat(pieces)); the first
    transcript comes before the pieces run out."""
    inf = _tinf(tmodel)
    prep, batch, max_wav = frontend

    def encode(chunks):
        # per-chunk encodes on both paths: the frontend's grouped-vs-solo
        # tolerance is the frontend test's (tests/test_torch_asr_frontend.py)
        return [encode_chunks(prep, batch, [c])[0] for c in chunks]

    rng = np.random.default_rng(9)
    wav = (rng.standard_normal(int(2.6 * max_wav)) * 0.3).astype(np.float32)
    joined = inf.asr_long(wav, 21, encode, max_wav, steps=2)
    pieces = _random_pieces(rng, wav)
    consumed = {"n": 0}

    def feed():
        for p in pieces:
            consumed["n"] += 1
            yield p

    texts, at_yield = [], []
    for t in inf.asr_stream(feed(), 21, encode, max_wav, steps=2):
        at_yield.append(consumed["n"])
        texts.append(t)
    assert " ".join(t for t in texts if t) == joined
    assert len(texts) >= 3 and at_yield[0] < len(pieces)
    short = wav[: max_wav - 2048]
    stream = list(inf.asr_stream(iter([short[:5000], short[5000:]]), 21,
                                 encode, max_wav, steps=2))
    assert len(stream) == 1
    assert stream[0] == inf.asr_long(short, 21, encode, max_wav, steps=2)
    # injected noise, one row per chunk, replaces the draws on both paths
    x0 = rng.standard_normal((len(texts), 12, 64)).astype(np.float32)
    assert " ".join(t for t in inf.asr_stream(
        iter(pieces), 21, encode, max_wav, steps=2, x_init=x0) if t) == \
        inf.asr_long(wav, 21, encode, max_wav, steps=2, x_init=x0)

"""The port's parallel layer (audio_calm_torch/parallel/) vs the JAX
package's, on the CPU:

  - the TP rules: param_partition_spec and tp_shardings give, for every
    parameter of the tiny CALM model, the split JAX's rules give its path
    (flax kernels are [in, out], torch weights [out, in]), the indivisible
    fallback included, at model sizes 2 and 3;
  - zero_leaf_spec: JAX's dim for a set of shapes;
  - CALMInference on a (data 2, model 2) mesh of CPU devices, against the
    one-device port (TTS latents within 2e-4, the bound of
    tests/test_infer_shard.py; ASR ids equal) and against JAX's
    infer_shard engine on its own (2, 2) mesh of the 8 CPU devices with the
    same weights and the noise its keys draw (latents within 2e-4,
    transcripts equal), in fp32 and with int8 LLM weights; shard_batch_rows'
    placement;
  - the collator with process_count = 2: rank by rank the batches of JAX's
    iterator (plain TTS with a corrupt item's zero stub, packed TTS from
    header metadata, and a .pt store's fallback to plain batches with
    JAX's warning), array-equal.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.data import collator as tcol
from audio_calm_torch.data import datasets as tds
from audio_calm_torch.data import synth_corpus
from audio_calm_torch.data.tokenizer import ByteTokenizer as TByteTokenizer
from audio_calm_torch.eval.infer import CALMInference as TInference
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import jax_path, load_calm
from audio_calm_torch.models.quant import quantize_llm_int8 as t_int8
from audio_calm_torch.parallel import infer_shard as tshard
from audio_calm_torch.parallel import mesh as tmesh
from audio_calm_torch.parallel import tp as ttp
from audio_calm_tpu.config import CALMModelConfig, LoRAConfig, Qwen2Config
from audio_calm_tpu.data import collator as jcol
from audio_calm_tpu.data import datasets as jds
from audio_calm_tpu.data.tokenizer import ByteTokenizer
from audio_calm_tpu.eval.infer import CALMInference as JInference
from audio_calm_tpu.models.calm import QwenCALM, init_calm_params
from audio_calm_tpu.models.quant import quantize_llm_int8 as j_int8
from audio_calm_tpu.parallel import mesh as jmesh
from audio_calm_tpu.parallel import tp as jtp

KW = dict(audio_buckets=[16, 32], text_buckets=[64, 96])
ODE = dict(steps=2, cfg_scale=1.5)
TEXTS, SEEDS = ["hello world", "good day to you"], [1, 2]


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg():
    return CALMModelConfig(
        latent_dim=8, max_audio_len=32, max_text_len=12,
        tts_flow_hidden_dim=32, tts_flow_num_layers=1,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=Qwen2Config.tiny(vocab_size=256),
        lora=LoRAConfig(rank=2, alpha=4.0, dropout=0.0))


@pytest.fixture(scope="module")
def weights():
    """JAX's tiny CALM tree (shapes traced, values numpy: kernels N(0,
    1/fan_in), the rest N(0, 0.05^2) around 1 for norm scales) and the port
    model on it."""
    cfg = _cfg()
    model = QwenCALM(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: init_calm_params(model,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.05 * z if path[-1].key == "scale" else 0.05 * z

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    port = TQwenCALM(from_dict(TCALMConfig, dataclasses.asdict(cfg))).eval()
    load_calm(port, {"params": params})
    return model, params, port


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------
def _port_dim(jspec, jleaf, jpath):
    """JAX's PartitionSpec of a leaf -> the dim of the port's tensor."""
    if "model" not in tuple(jspec):
        return None
    axis = list(jspec).index("model")
    if jpath[-1] == "kernel" and len(jleaf.shape) == 2:
        return 1 - axis  # flax [in, out] -> torch [out, in]
    return axis


@pytest.mark.parametrize("tp", [2, 3])
def test_tp_rules_match_jax_on_every_path(weights, tp):
    _, params, port = weights
    flat = flatten_dict(params)
    jsh = jtp.tp_shardings(flat, jmesh.make_mesh(
        data=2, model=tp, devices=jax.devices()[:2 * tp]))
    named = dict(port.named_parameters())
    got = ttp.tp_shardings(named, tmesh.make_mesh(2, tp, ["cpu"] * 2 * tp))
    n_split = 0
    for name, p in named.items():
        jpath = jax_path(port, name)
        jleaf = flat[jpath]
        rule = ttp.param_partition_spec(tuple(name.split(".")))
        assert rule == _port_dim(jtp.param_partition_spec(jpath), jleaf,
                                 jpath), name
        assert got[name] == _port_dim(jsh[jpath].spec, jleaf, jpath), name
        n_split += got[name] is not None
    # tiny widths (heads 4 / 2, MLP 128, vocab 256) split by 2, not by 3
    assert n_split > 10 if tp == 2 else n_split == 0
    # the indivisible fallback (tests/test_tensor_parallel.py's shapes)
    jflat = {("llm", "l", "mlp", "gate_proj", "kernel"): jnp.zeros((8, 10)),
             ("llm", "l", "mlp", "down_proj", "kernel"): jnp.zeros((7, 8))}
    jfall = jtp.tp_shardings(jflat, jmesh.make_mesh(data=4, model=2))
    tfall = ttp.tp_shardings(
        {"llm.l.mlp.gate_proj.weight": torch.zeros(10, 8),
         "llm.l.mlp.down_proj.weight": torch.zeros(8, 7)},
        tmesh.make_mesh(4, 2, ["cpu"] * 8))
    for (jp, leaf), name in zip(jflat.items(), tfall):
        assert tfall[name] == _port_dim(jfall[jp].spec, leaf, jp), name
    assert tfall["llm.l.mlp.down_proj.weight"] is None


def test_zero_leaf_spec_matches_jax():
    jm = jmesh.make_mesh(data=4, devices=jax.devices()[:4])
    for shape in [(), (10,), (2 ** 14,), (2 ** 14 + 2,), (128, 128),
                  (130, 128), (64, 256), (3, 2 ** 14), (6, 4096),
                  (4096, 6), (7, 5, 1024)]:
        leaf = np.zeros(shape, np.float32)
        spec = jmesh.zero_leaf_spec(jm, leaf).spec
        want = list(spec).index("data") if "data" in tuple(spec) else None
        assert tmesh.zero_leaf_spec(4, torch.zeros(shape)) == want, shape
        assert tmesh.zero_leaf_spec(tmesh.make_mesh(4, 1, ["cpu"] * 4),
                                    leaf) == want, shape
    tree = tmesh.zero_sharding(4, {"a": torch.zeros(128, 128),
                                   "b": [torch.zeros(3)]})
    assert tree == {"a": 0, "b": [None]}


# ---------------------------------------------------------------------------
# inference on a mesh
# ---------------------------------------------------------------------------
def test_shard_batch_rows_places_rows():
    mesh = tmesh.make_mesh(2, 2, ["cpu"] * 4)
    a, b = torch.arange(8.).reshape(4, 2), torch.zeros(3, 2)
    parts = tshard.shard_batch_rows((a,), mesh)
    assert [d for d, _ in parts] == [0, 1]
    assert torch.equal(torch.cat([p[0] for _, p in parts]), a)
    (d, (whole,)), = tshard.shard_batch_rows((b,), mesh)
    assert d == 0 and whole.shape == (3, 2)  # 3 rows do not divide dp=2
    assert tshard.shard_batch_rows((a,), None) == [(0, (a,))]


@pytest.mark.parametrize("int8", [False, True])
def test_mesh_engine_matches_one_device_and_jax(weights, int8):
    model, params, port = weights
    jvars = {"params": params}
    if int8:
        port = copy.deepcopy(port)
        assert t_int8(port) == 7 * 2
        qp, qs = j_int8(params)
        jvars = {"params": qp, "qscale": qs}
    tok = TByteTokenizer()
    solo = TInference(port, tok, device="cpu", **KW)
    mesh = tmesh.make_mesh(2, 2, ["cpu"] * 4)
    sharded = TInference(port, tok, mesh=mesh, **KW)
    rep = sharded.replicas[1]
    assert isinstance(rep.llm.layers[0].self_attn, tshard.TPAttention)
    assert rep.llm.layers[0].self_attn.shards[0].cfg.num_attention_heads == 2
    assert isinstance(rep.embed, tshard.TPEmbed)
    if int8:
        w = rep.llm.layers[0].mlp.shards[1].down_proj.weight
        assert w.dtype == torch.int8 and w.is_contiguous()
    assert port.llm.layers[0].self_attn.q_proj.weight.shape[0] == 64

    jmesh_ = jmesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    ref = JInference(model, jvars, ByteTokenizer(), mesh=jmesh_, **KW)
    keys = [jax.random.PRNGKey(s) for s in SEEDS]
    noise = np.asarray(ref._noise_stack(jnp.stack(keys), 32, 32, 8,
                                        jnp.float32))
    rlat, rnf, rgrid = ref.tts_batch(TEXTS, keys, **ODE)
    a = solo.tts_batch(TEXTS, SEEDS, x_init=noise, **ODE)
    b = sharded.tts_batch(TEXTS, SEEDS, x_init=noise, **ODE)
    assert a[1:] == b[1:] == (rnf, rgrid)
    assert np.abs(rlat).max() > 0.1
    assert np.max(np.abs(b[0] - a[0])) < 2e-4
    assert np.max(np.abs(b[0] - rlat)) < 2e-4
    # a B = 1 request (rows replicated): the same row as in the pair
    one, n = sharded.tts(TEXTS[0], SEEDS[0], pad_to_grid=True,
                         x_init=noise[0], **ODE)
    assert n == b[1][0] and np.max(np.abs(one - b[0][0])) < 2e-4

    rng = np.random.default_rng(0)
    lats = [rng.standard_normal((t, 8)).astype(np.float32) for t in (10, 16)]
    akeys = [jax.random.PRNGKey(s) for s in (5, 6)]
    anoise = np.asarray(ref._noise_stack(jnp.stack(akeys), 12, 12, 64,
                                         jnp.float32))
    want = ref.asr_batch(lats, akeys, steps=2)
    ids_a, _ = solo._asr_ids(lats, [5, 6], steps=2, x_init=anoise)
    ids_b, _ = sharded._asr_ids(lats, [5, 6], steps=2, x_init=anoise)
    np.testing.assert_array_equal(ids_a, ids_b)
    assert sharded.asr_batch(lats, [5, 6], steps=2, x_init=anoise) == want


# ---------------------------------------------------------------------------
# multi-process batches
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A TTS store (npz, one corrupt file) and the same corpus written as
    .pt files only (an unconverted reference store)."""
    root = tmp_path_factory.mktemp("stores")
    argv = ["--asr-n", "0", "--tts-n", "24", "--dev-n", "2",
            "--latent-dim", "8", "--chunk", "12", "--seed", "3"]
    assert synth_corpus.main(["--out", str(root / "npz")] + argv) == 0
    assert synth_corpus.main(["--out", str(root / "pt"), "--format", "pt"]
                             + argv) == 0
    chunk = root / "npz" / "train" / "LibriTTS_R" / "train-clean-100" / "0000"
    (chunk / "tts-train-000003.npz").write_bytes(b"not an npz")
    return root


def _sets(root):
    kw = dict(tts_latent_dir=str(root / "train" / "LibriTTS_R"),
              tts_subsets="train-clean-100", max_text_len=96,
              max_audio_len=48, task_mode="tts", latent_dim=8)
    return (tds.CalmDataset(TByteTokenizer(), **kw),
            jds.CalmDataset(ByteTokenizer(), **kw))


def _rank_batches(col, ds, rank, **kw):
    return list(col.calm_batch_iterator(ds, 4, 0, 8, task_prob_tts=1.0,
                                        training=True, seed=11, epochs=1,
                                        process_index=rank, process_count=2,
                                        **kw))


@pytest.mark.parametrize("kind", ["plain", "packed", "pt_fallback"])
def test_collator_ranks_match_jax(stores, kind):
    root = stores / ("pt" if kind == "pt_fallback" else "npz")
    tset, jset = _sets(root)
    kw = dict(audio_buckets=[24, 48], length_group_window=2)
    if kind != "plain":
        kw.update(tts_pack_rows=4, tts_pack_len=128, tts_pack_segments=2)
    saw_stub = False
    for rank in range(2):
        if kind == "pt_fallback":
            with pytest.warns(UserWarning, match="packing DISABLED"):
                got = _rank_batches(tcol, tset, rank, **kw)
            with pytest.warns(UserWarning, match="packing DISABLED"):
                ref = _rank_batches(jcol, jset, rank, **kw)
        else:
            got = _rank_batches(tcol, tset, rank, **kw)
            ref = _rank_batches(jcol, jset, rank, **kw)
        assert len(got) == len(ref) >= 2
        for a, b in zip(got, ref):
            assert set(a) == set(b) and a["task"] == b["task"]
            assert a["task"] == ("tts_packed" if kind == "packed" else "tts")
            assert a.get("n_samples") == b.get("n_samples")
            for k in a:
                if k not in ("task", "n_samples"):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    assert a[k].dtype == b[k].dtype, k
            if kind == "plain":
                assert a["latents"].shape[0] == 2  # this rank's rows
                saw_stub |= bool(((a["audio_mask"].sum(1) == 1)
                                  & ~a["latents"].any(axis=(1, 2))).any())
    assert saw_stub or kind != "plain"


@pytest.mark.parametrize("task", ["tts", "asr"])
def test_converted_pt_store_packs_over_two_processes(tmp_path, task):
    """tests/test_convert_store.py's multi-host cases on the port: a .pt
    store converted by the port's convert_store keeps packing on at
    process_count = 2, and the two ranks' rows concatenate to the
    one-process packed batches exactly."""
    from audio_calm_torch.data import convert_store

    root = tmp_path / "pt"
    assert synth_corpus.main([
        "--out", str(root), "--format", "pt", "--asr-n", "24", "--tts-n",
        "24", "--dev-n", "0", "--latent-dim", "8", "--chunk", "12",
        "--seed", "4"]) == 0
    assert convert_store.main(["--root", str(root), "--dim", "8"]) == 0
    corpus = {"tts": "LibriTTS_R", "asr": "LibriSpeech"}[task]

    def dataset():
        return tds.CalmDataset(
            TByteTokenizer(), max_text_len=96, max_audio_len=48,
            task_mode=task, latent_dim=8,
            **{f"{task}_latent_dir": str(root / "train" / corpus),
               f"{task}_subsets": "train-clean-100"})

    kw = dict(batch_size=4, pad_token_id=0, latent_dim=8, training=False,
              seed=3, epochs=1, audio_buckets=[24, 48],
              length_group_window=2)
    kw.update(dict(task_prob_tts=1.0, tts_pack_rows=4, tts_pack_len=128,
                   tts_pack_segments=2) if task == "tts" else
              dict(task_prob_tts=0.0, asr_pack_rows=4, asr_pack_len=160,
                   asr_pack_segments=2))
    single = list(tcol.calm_batch_iterator(dataset(), **kw))
    ranks = [list(tcol.calm_batch_iterator(dataset(), **kw, process_index=r,
                                           process_count=2)) for r in (0, 1)]
    assert len(single) == len(ranks[0]) == len(ranks[1]) > 0
    for bs, b0, b1 in zip(single, *ranks):
        assert bs["task"] == b0["task"] == b1["task"] == f"{task}_packed"
        assert b0["n_samples"] + b1["n_samples"] == bs["n_samples"] > 0
        for k in bs:
            if k not in ("task", "n_samples"):
                np.testing.assert_array_equal(
                    np.concatenate([b0[k], b1[k]]), bs[k], err_msg=k)

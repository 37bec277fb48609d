"""The port's checkpoint layer vs the JAX package on the CPU: its copies of
the reference converters (models/convert.py) and exporters
(models/convert_export.py), `to_jax_params` as the inverse of
`from_jax_params`, the legacy dilated-ResNet `FlowMatchingHead`,
train/checkpoint.soft_restart and models/vae.load_vae, at a tiny geometry
(Qwen2Config.tiny(), heads 32 x 1-2 with 4 heads, LoRA r 2, a VAE of 32
channels).

Weights are numpy draws in the shapes JAX's init gives (traced, not run).
Bounds: converters, exporters, soft-restarted state dicts and the layout
round trip are exact (the same fp32 values moved and transposed); the
legacy head 2e-5 (fp32 convolutions and a GroupNorm summed in another
order); the soft-restarted model's TTS latents 1e-3, the slice bound of
tests/test_torch_tts_slice.py (2 LLM layers, then 8 evaluations of a
2-layer DiT under CFG 2.5)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import VAEModelConfig as TVAEConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.eval import infer as tinfer
from audio_calm_torch.models import convert as TC
from audio_calm_torch.models import convert_export as TE
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.calm_heads import FlowMatchingHead as THead
from audio_calm_torch.models.vae import load_vae as t_load_vae
from audio_calm_torch.train import checkpoint as TK
from audio_calm_tpu.config import (CALMModelConfig, LoRAConfig, Qwen2Config,
                                   VAEModelConfig)
from audio_calm_tpu.eval.infer import tts_decode, tts_encode
from audio_calm_tpu.models import convert as JC
from audio_calm_tpu.models import convert_export as JE
from audio_calm_tpu.models.calm import QwenCALM, init_calm_params
from audio_calm_tpu.models.calm_heads import FlowMatchingHead
from audio_calm_tpu.models.vae import AcousticVAE
from audio_calm_tpu.models.vocoder import HiFiGANConfig, HiFiGANGenerator
from audio_calm_tpu.train import checkpoint as JK

T_AUD = 16
STEPS, CFG, METHOD = 4, 2.5, "midpoint"
VAE_GEOM = dict(hidden_channels=32, latent_channels=8, norm_num_groups=4)
LEGACY = dict(input_dim=12, output_dim=6, hidden_dim=32, num_layers=3,
              time_dim=16)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _draw(shapes, seed):
    """numpy values in the shapes of a traced init: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.05^2), everything else N(0, 0.05^2) (LoRA B,
    zero-initialised out projections and gates included)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return (z / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (1.0 + 0.05 * z) if name == "scale" else 0.05 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def trees():
    cfg = CALMModelConfig(
        latent_dim=8, max_audio_len=T_AUD, max_text_len=8,
        tts_flow_hidden_dim=32, tts_flow_num_layers=2,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=Qwen2Config.tiny(vocab_size=256),
        lora=LoRAConfig(rank=2, alpha=4.0, dropout=0.0),
        latent_mean=0.1, latent_std=1.2,
    )
    model = QwenCALM(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: init_calm_params(model,
                                                     jax.random.PRNGKey(0)))
    vae_cfg = VAEModelConfig(**VAE_GEOM)
    vae_shapes = jax.eval_shape(lambda: AcousticVAE(vae_cfg).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, 80)), train=False))["params"]
    return {"cfg": cfg, "model": model,
            "trained": _draw(shapes, 1), "init": _draw(shapes, 2),
            "vae_cfg": vae_cfg, "vae": _draw(vae_shapes, 3)}


def _port_model(cfg, tree):
    tmodel = TQwenCALM(from_dict(TCALMConfig, dataclasses.asdict(cfg))).eval()
    TC.load_calm(tmodel, tree)
    return tmodel


def _assert_trees_equal(a, b, path=""):
    if not isinstance(a, dict):
        assert isinstance(b, np.ndarray) and b.dtype == np.float32, path
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=path)
        return
    assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
    for k in a:
        _assert_trees_equal(a[k], b[k], f"{path}/{k}")


def _legacy_head_tree(seed):
    x = jnp.zeros((1, 4, LEGACY["input_dim"]))
    y = jnp.zeros((1, 4, LEGACY["output_dim"]))
    shapes = jax.eval_shape(lambda: FlowMatchingHead(**LEGACY).init(
        jax.random.PRNGKey(0), x, y, jnp.zeros((1,))))["params"]
    return _draw(shapes, seed)


# ---------------------------------------------------------------------------
# the layout table: to_jax_params inverts from_jax_params
# ---------------------------------------------------------------------------
def test_to_jax_params_inverts_from_jax_params(trees):
    hcfg = HiFiGANConfig(upsample_initial_channel=32,
                         resblock_kernel_sizes=(3, 5),
                         resblock_dilations=((1, 2), (2, 6)))
    hifi = _draw(jax.eval_shape(lambda: HiFiGANGenerator(hcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 80))))["params"], 4)
    for tree in (trees["trained"], trees["vae"], hifi, _legacy_head_tree(5)):
        _assert_trees_equal(tree, TC.to_jax_params(TC.from_jax_params(tree)))
    # from a port model's own state dict, bf16 included; jax_path names
    # each parameter's leaf in the JAX tree, one to one
    tmodel = _port_model(trees["cfg"], trees["trained"])
    _assert_trees_equal(trees["trained"], TC.to_jax_params(
        tmodel.state_dict()))
    leaves = {tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(trees["trained"])[0]}
    assert sorted(TC.jax_path(tmodel, n) for n, _ in
                  tmodel.named_parameters()) == sorted(leaves)
    half = TC.to_jax_params(tmodel.to(torch.bfloat16).state_dict())
    want = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32),
        trees["trained"])
    _assert_trees_equal(want, half)


# ---------------------------------------------------------------------------
# converters and exporters, exactly JAX's
# ---------------------------------------------------------------------------
def _reference_sds(trees):
    """The reference's component state dicts (JAX's exporters) + vae."""
    sds = JE.export_components(trees["trained"])
    sds["vae"] = JE.export_vae(trees["vae"])
    return sds


def test_converters_match_jax(trees, tmp_path):
    sds = _reference_sds(trees)
    p = trees["trained"]
    for name, (jfn, tfn) in {
            "input_proj": (JC.convert_input_projector,
                           TC.convert_input_projector),
            "tts_len_predictor": (JC.convert_predictor, TC.convert_predictor),
            "asr_cross_attn": (JC.convert_torch_mha, TC.convert_torch_mha),
            "vae": (JC.convert_vae_params, TC.convert_vae_params),
            "adapter_model": (JC.convert_peft_adapter,
                              TC.convert_peft_adapter)}.items():
        got = tfn(sds[name])
        _assert_trees_equal(jfn(sds[name]), got)
    for name, n, ctx in (("tts_flow_head", 2, True),
                         ("asr_flow_head", 1, False)):
        _assert_trees_equal(JC.convert_flow_head(sds[name], n, ctx),
                            TC.convert_flow_head(sds[name], n, ctx))
        _assert_trees_equal(p[name], TC.convert_flow_head(sds[name], n, ctx))
    legacy = JE.export_legacy_flow_head(_legacy_head_tree(6))
    assert TC.is_legacy_flow_head(legacy) and not TC.is_legacy_flow_head(
        sds["tts_flow_head"])
    _assert_trees_equal(JC.convert_legacy_flow_head(legacy),
                        TC.convert_legacy_flow_head(legacy))
    w = np.random.default_rng(7).standard_normal((5, 3, 4))
    np.testing.assert_array_equal(JC.conv1d_w(w), TC.conv1d_w(w))
    np.testing.assert_array_equal(JC.conv_transpose1d_w(w),
                                  TC.conv_transpose1d_w(w))

    # peft keys with the `.default.` adapter name; no A/B at all raises
    peft = {k.replace(".lora_A.", ".lora_A.default.").replace(
        ".lora_B.", ".lora_B.default."): v
        for k, v in sds["adapter_model"].items()}
    peft["base_model.model.lm_head.weight"] = np.zeros((2, 2), np.float32)
    _assert_trees_equal(JC.convert_peft_adapter(peft),
                        TC.convert_peft_adapter(peft))
    with pytest.raises(ValueError, match="no lora_A"):
        TC.convert_peft_adapter({"x.weight": np.zeros(2)})

    # merge_params: overlays, keeps, adds; refuses a shape mismatch
    a = {"x": {"k": np.zeros((2, 3), np.float32)}, "y": np.ones(2, np.float32)}
    b = {"x": {"k": np.full((2, 3), 5.0, np.float32),
               "n": np.ones(1, np.float32)}}
    _assert_trees_equal(JC.merge_params(a, b), TC.merge_params(a, b))
    with pytest.raises(ValueError, match="shape"):
        TC.merge_params(a, {"y": np.ones(3)})

    # HF Qwen2 shard directories: .safetensors shards, or .bin shards
    # (optimizer state skipped), through each side's loader
    from safetensors.numpy import save_file

    qcfg = trees["cfg"].qwen
    rng = np.random.default_rng(8)
    hf = {"model.embed_tokens.weight": (qcfg.vocab_size, qcfg.hidden_size),
          "model.norm.weight": (qcfg.hidden_size,)}
    kv = qcfg.num_key_value_heads * qcfg.head_dim
    for i in range(qcfg.num_hidden_layers):
        a_ = f"model.layers.{i}."
        for proj, (o, b_) in {"q_proj": (qcfg.hidden_size, True),
                              "k_proj": (kv, True), "v_proj": (kv, True),
                              "o_proj": (qcfg.hidden_size, False)}.items():
            hf[a_ + f"self_attn.{proj}.weight"] = (o, qcfg.hidden_size)
            if b_:
                hf[a_ + f"self_attn.{proj}.bias"] = (o,)
        for proj, shape in {"gate_proj": (qcfg.intermediate_size,
                                          qcfg.hidden_size),
                            "up_proj": (qcfg.intermediate_size,
                                        qcfg.hidden_size),
                            "down_proj": (qcfg.hidden_size,
                                          qcfg.intermediate_size)}.items():
            hf[a_ + f"mlp.{proj}.weight"] = shape
        hf[a_ + "input_layernorm.weight"] = (qcfg.hidden_size,)
        hf[a_ + "post_attention_layernorm.weight"] = (qcfg.hidden_size,)
    hf = {k: rng.standard_normal(s).astype(np.float32) for k, s in hf.items()}
    names = sorted(hf)
    halves = [dict((k, hf[k]) for k in names[:len(names) // 2]),
              dict((k, hf[k]) for k in names[len(names) // 2:])]
    st, bn = tmp_path / "st", tmp_path / "bin"
    st.mkdir()
    bn.mkdir()
    for i, h in enumerate(halves):
        save_file(h, str(st / f"model-{i:05d}-of-00002.safetensors"))
        torch.save({k: torch.from_numpy(v) for k, v in h.items()},
                   bn / f"pytorch_model-{i:05d}-of-00002.bin")
    torch.save({"state": torch.zeros(3)}, bn / "optimizer.bin")
    for d in (st, bn):
        jsd, tsd = JC.load_hf_dir_state_dict(str(d)), TC.load_hf_dir_state_dict(
            str(d))
        assert set(jsd) == set(tsd) == set(hf)
        _assert_trees_equal(JC.convert_qwen2(jsd, qcfg),
                            TC.convert_qwen2(tsd, qcfg))
    q = TC.convert_qwen2(TC.load_hf_dir_state_dict(str(bn)), qcfg)
    np.testing.assert_array_equal(
        q["model"]["layers_1"]["self_attn"]["k_proj"]["kernel"],
        hf["model.layers.1.self_attn.k_proj.weight"].T)

    # a bf16-stored component .bin loads the values JAX's loader gives
    path = tmp_path / "tts_len_predictor.bin"
    torch.save({k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in sds["tts_len_predictor"].items()}, path)
    _assert_trees_equal(JK.load_torch_component(str(path),
                                                "tts_len_predictor"),
                        TK.load_torch_component(str(path),
                                                "tts_len_predictor"))


def test_exporters_match_jax(trees):
    p = trees["trained"]
    jsds, tsds = JE.export_components(p), TE.export_components(p)
    assert set(jsds) == set(tsds) == set(JK.COMPONENTS) | {"adapter_model"}
    for name in jsds:
        _assert_trees_equal(jsds[name], tsds[name])
    # the port model's own weights, through to_jax_params
    tmodel = _port_model(trees["cfg"], p)
    from_model = TE.export_components(TC.to_jax_params(tmodel.state_dict()))
    for name in jsds:
        _assert_trees_equal(jsds[name], from_model[name])
    _assert_trees_equal(JE.export_vae(trees["vae"]),
                        TE.export_vae(trees["vae"]))
    legacy = _legacy_head_tree(7)
    _assert_trees_equal(JE.export_legacy_flow_head(legacy),
                        TE.export_legacy_flow_head(legacy))
    sd = {}
    TE.export_conv_transpose1d(p["input_proj"]["conv1"]["conv"], "x", sd)
    jsd = {}
    JE.export_conv_transpose1d(p["input_proj"]["conv1"]["conv"], "x", jsd)
    _assert_trees_equal(jsd, sd)


def test_legacy_flow_head_matches_jax():
    tree = _legacy_head_tree(9)
    rng = np.random.default_rng(10)
    cond = rng.standard_normal((2, 11, LEGACY["input_dim"])).astype(
        np.float32)
    noisy = rng.standard_normal((2, 11, LEGACY["output_dim"])).astype(
        np.float32)
    head = FlowMatchingHead(**LEGACY)
    thead = THead(**LEGACY).eval()
    thead.load_state_dict(TC.from_jax_params(tree), strict=True)
    for t, cmask in ((np.array([0.3, 0.8], np.float32), None),
                     (rng.uniform(size=(2, 11)).astype(np.float32),
                      np.array([1.0, 0.0], np.float32))):
        ref = np.asarray(head.apply({"params": tree}, cond, noisy, t,
                                    condition_mask=cmask))
        with torch.no_grad():
            out = thead(torch.from_numpy(cond), torch.from_numpy(noisy),
                        torch.from_numpy(t), None if cmask is None
                        else torch.from_numpy(cmask)).numpy()
        assert out.shape == ref.shape == (2, 11, LEGACY["output_dim"])
        assert np.abs(ref).max() > 1e-2
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
    # the JAX head's zero-initialised out conv: an untouched port head too
    fresh = THead(**LEGACY)
    assert not fresh.out_proj.weight.any() and not fresh.out_proj.bias.any()


# ---------------------------------------------------------------------------
# soft restart and the VAE loader
# ---------------------------------------------------------------------------
def _inputs():
    ids = np.array([[11, 23, 5, 77, 41, 9], [3, 8, 130, 64, 0, 0]], np.int32)
    mask = np.array([[1] * 6, [1, 1, 1, 1, 0, 0]], np.int32)
    x0 = np.random.default_rng(5).standard_normal((2, T_AUD, 8)).astype(
        np.float32)
    return ids, mask, x0


def test_soft_restart_matches_jax(trees, tmp_path):
    """JAX's save_reference_checkpoint writes the directory; JAX's
    soft_restart loads it onto a fresh init, the port's onto the port
    model built from that init: equal state dicts, latents within the
    slice bound."""
    d = str(tmp_path / "ckpt")
    written = JE.save_reference_checkpoint(trees["trained"], d, trees["vae"])
    assert len(written) == 10  # 8 components, the adapter, the VAE
    paths = {c: d for c in JK.COMPONENTS + ("lora",)}
    jtree = JK.soft_restart(trees["init"], paths)
    tmodel = _port_model(trees["cfg"], trees["init"])
    TK.soft_restart(tmodel, paths)
    want = TC.from_jax_params(jtree)
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    # every component came from the files, the base from the init
    np.testing.assert_array_equal(got["soa_embed"].numpy(),
                                  trees["trained"]["soa_embed"])
    np.testing.assert_array_equal(
        got["llm.layers.1.mlp.up_proj.lora_b"].numpy(),
        trees["trained"]["llm"]["layers_1"]["mlp"]["up_proj"]["lora_b"])
    np.testing.assert_array_equal(
        got["llm.layers.1.mlp.up_proj.weight"].numpy(),
        trees["init"]["llm"]["layers_1"]["mlp"]["up_proj"]["kernel"].T)

    ids, mask, x0 = _inputs()
    model, params = trees["model"], {"params": jtree}
    cv, ctx, pad, nf = tts_encode(model, params, jnp.asarray(ids),
                                  jnp.asarray(mask))
    nf = jnp.full_like(nf, 12)
    lat = np.asarray(tts_decode(model, params, cv, ctx, pad, nf, None,
                                steps=STEPS, cfg_scale=CFG, t_aud=T_AUD,
                                method=METHOD, x_init=jnp.asarray(x0)))
    tlat, _ = tinfer.tts_generate_latents(
        tmodel, ids, mask, steps=STEPS, cfg_scale=CFG, t_aud=T_AUD,
        num_frames_override=12, method=METHOD, x_init=torch.from_numpy(x0),
        device="cpu")
    assert np.abs(lat).max() > 1e-2
    assert np.max(np.abs(tlat.numpy() - lat)) < 1e-3


def test_soft_restart_refuses_what_it_cannot_load(trees, tmp_path):
    """Absent components are skipped, leaving the model's own; an orbax
    item, a missing path, a shape mismatch or a legacy head onto the DiT
    raise; a .safetensors adapter with `.default.` names and a bf16 .bin
    load."""
    from safetensors.torch import save_file

    sds = _reference_sds(trees)
    tmodel = _port_model(trees["cfg"], trees["init"])
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    d = tmp_path / "part"
    d.mkdir()
    torch.save({k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in sds["soa_embed"].items()}, d / "soa_embed.bin")
    save_file({k.replace(".lora_A.", ".lora_A.default."):
               torch.from_numpy(np.ascontiguousarray(v))
               for k, v in sds["adapter_model"].items()},
              str(d / "adapter_model.safetensors"))
    TK.soft_restart(tmodel, {c: str(d) for c in TK.COMPONENTS + ("lora",)})
    after = tmodel.state_dict()
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    lora = {k for k in after if k.endswith(("lora_a", "lora_b"))}
    assert changed == {"soa_embed"} | lora
    np.testing.assert_array_equal(
        after["soa_embed"].numpy(),
        JK.load_torch_component(str(d / "soa_embed.bin"), "soa_embed"))
    jlora = JC.convert_peft_adapter({
        k.replace(".lora_A.", ".lora_A.default."): v
        for k, v in sds["adapter_model"].items()})
    np.testing.assert_array_equal(
        after["llm.layers.0.self_attn.v_proj.lora_a"].numpy(),
        jlora["layers_0"]["self_attn"]["v_proj"]["lora_a"])

    (d / "tts_flow_head").mkdir()  # an orbax item beside the .bin files
    with pytest.raises(ValueError, match="tts_flow_head is an orbax item"):
        TK.soft_restart(tmodel, {"tts_flow_head": str(d)})
    with pytest.raises(FileNotFoundError):
        TK.soft_restart(tmodel, {"input_proj": str(d / "nope.bin")})
    bad = d / "input_proj.bin"
    proj = dict(sds["input_proj"])
    proj["post_norm.weight"] = np.ones(7, np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in proj.items()}, bad)
    with pytest.raises(ValueError, match="shape"):
        TK.soft_restart(tmodel, {"input_proj": str(bad)})
    legacy = d / "legacy.bin"
    torch.save({k: torch.from_numpy(v) for k, v in
                JE.export_legacy_flow_head(_legacy_head_tree(11)).items()},
               legacy)
    # its in_proj is a conv where the DiT's is a Dense
    with pytest.raises(ValueError, match="^tts_flow_head: merge_params"):
        TK.soft_restart(tmodel, {"tts_flow_head": str(legacy)})
    tts = {k: torch.from_numpy(v) for k, v in sds["tts_flow_head"].items()}
    tts.update({k.replace("blocks.1.", "blocks.2."): v
                for k, v in tts.items() if k.startswith("blocks.1.")})
    torch.save(tts, d / "deep.bin")
    with pytest.raises(ValueError, match="tensors the model lacks"):
        TK.soft_restart(tmodel, {"tts_flow_head": str(d / "deep.bin")})


def test_load_vae_reads_a_bin_with_its_sidecar(trees, tmp_path):
    d = tmp_path / "vae"
    TE.save_reference_checkpoint({}, str(d), vae_params=trees["vae"])
    path = str(d / "vae.bin")
    (d / "vae_config.json").write_text(
        __import__("json").dumps(dataclasses.asdict(trees["vae_cfg"])))
    vae = t_load_vae(path, device="cpu")
    assert vae.cfg.hidden_channels == 32 and not vae.training
    want = TC.from_jax_params(JC.convert_vae_params(
        JC.load_torch_state_dict(path)))
    got = vae.state_dict()
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    # an explicit cfg wins over the sidecar; the default geometry does not
    # fit these weights
    with pytest.raises(ValueError, match="shape"):
        t_load_vae(path, TVAEConfig(latent_channels=8), device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        t_load_vae(str(d), device="cpu")
    with pytest.raises(FileNotFoundError):
        t_load_vae(os.path.join(str(d), "missing.bin"), device="cpu")

"""The port's measurement entry points (audio_calm_torch/tools/bench_tts,
bench_stages, bench_train, bench_serve, measure_quant_error and
data/build_manifest) against the JAX package's bench.py and scripts/, on
the CPU at tiny sizes.

Bounds: the TTS pipeline's waveform 5e-3, tests/test_torch_tts_slice.py's
bound (JAX's fused vocoder feeds bf16 operands to its stage kernels, as
the port's does); the stage functions chained equal the pipeline bit for
bit (the same operations in the same order on the same device); the
folds' fields that depend on no time exactly; the int8 projection errors
exactly and the stack's within 1e-2 (its bf16 roundings, see its test);
the manifests byte for byte. Each JAX entry point runs inside one test (the
suite spreads the tests of a file over its workers)."""

import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.config import HiFiGANConfig as THiFiGANConfig
from audio_calm_torch.config import LoRAConfig as TLoRAConfig
from audio_calm_torch.config import Qwen2Config as TQwen2Config
from audio_calm_torch.config import VAEModelConfig as TVAEConfig
from audio_calm_torch.config import from_dict
from audio_calm_torch.data import build_manifest as t_build_manifest
from audio_calm_torch.eval.infer import (tts_condition, tts_encode,
                                         tts_generate_latents)
from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
from audio_calm_torch.models.convert import (from_jax_params, load_calm,
                                             load_hifigan, load_vae)
from audio_calm_torch.models.flagship import random_normal_
from audio_calm_torch.models.vae import AcousticVAE as TVAE
from audio_calm_torch.models.vocoder import HiFiGANGenerator as TGenerator
from audio_calm_torch.ops import vocoder_kernel
from audio_calm_torch.tools import (bench_serve, bench_stages, bench_train,
                                    bench_tts, measure_quant_error)
from audio_calm_torch.utils.profiling import count_flops

ROOT = Path(__file__).resolve().parent.parent
T_AUD, NF = 16, 12
STEPS, CFG, METHOD = 4, 2.5, "midpoint"
VAE_GEOM = dict(hidden_channels=32, latent_channels=8, norm_num_groups=4)
HIFI_GEOM = dict(upsample_initial_channel=64, resblock_kernel_sizes=(3, 5),
                 resblock_dilations=((1, 2), (2, 6)))


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _script(path: Path):
    """A JAX-side script (bench.py's siblings in scripts/) as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text: str):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def _run(main, argv):
    """main(argv) -> (exit code, its stdout's JSON lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, _lines(out.getvalue())


# ---------------------------------------------------------------------------
# bench_tts
# ---------------------------------------------------------------------------
def _values(shapes, rng, scale=None):
    """Numpy weights of a JAX tree's shapes (no un-jitted flax init):
    N(0, scale), or where scale is None lecun-normal kernels (variance 1 /
    fan_in) and N(0, 0.1) vectors."""
    def draw(s):
        std = scale if scale is not None else (
            0.1 if len(s.shape) < 2 else np.prod(s.shape[:-1]) ** -0.5)
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def test_torch_bench_tts_pipeline_matches_jax():
    """bench_tts.run_pipeline == bench.py:180-201's composition of the JAX
    functions, jitted as bench.py jits it (encode, the pinned length, the
    CFG midpoint ODE from the same x_init, the masked VAE decode, the
    masked mel through the fused HiFi-GAN), on the same weights, at
    tests/test_torch_tts_slice.py's tiny geometry."""
    from audio_calm_tpu.config import (CALMModelConfig, LoRAConfig,
                                       Qwen2Config, VAEModelConfig)
    from audio_calm_tpu.eval.infer import tts_decode
    from audio_calm_tpu.eval.infer import tts_encode as j_tts_encode
    from audio_calm_tpu.models.calm import QwenCALM
    from audio_calm_tpu.models.vae import AcousticVAE, denormalize_mel
    from audio_calm_tpu.models.vocoder import (HiFiGANConfig,
                                               HiFiGANGenerator)
    from audio_calm_tpu.ops.pallas_vocoder import hifigan_apply_fused

    rng = np.random.default_rng(0)
    cfg = CALMModelConfig(
        latent_dim=8, max_audio_len=T_AUD, max_text_len=12,
        tts_flow_hidden_dim=32, tts_flow_num_layers=2, flow_num_heads=4,
        qwen=Qwen2Config.tiny(vocab_size=256),
        lora=LoRAConfig(rank=2, alpha=4.0, dropout=0.0),
        latent_mean=0.1, latent_std=1.2)
    model = QwenCALM(cfg, dtype=jnp.float32)
    ids0 = jnp.zeros((1, 6), jnp.int32)
    params = {"params": _values(jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "flow": jax.random.PRNGKey(1)},
        ids0, jnp.ones_like(ids0), jnp.zeros((1, T_AUD, 8)),
        jnp.ones((1, T_AUD), jnp.int32), train=False,
        method=QwenCALM.forward_tts))["params"], rng, 0.1)}
    vae = AcousticVAE(VAEModelConfig(**VAE_GEOM))
    vae_params = {"params": _values(jax.eval_shape(lambda: vae.init(
        {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)},
        jnp.zeros((1, 16, 80)), train=False))["params"], rng, 0.1)}
    hcfg = HiFiGANConfig(**HIFI_GEOM)
    gen_params = {"params": _values(jax.eval_shape(
        lambda: HiFiGANGenerator(hcfg).init(jax.random.PRNGKey(3), jnp.zeros(
            (1, 8, 80))))["params"], rng)}

    ids = np.array([[11, 23, 5, 77, 41, 9], [3, 8, 130, 64, 0, 0]], np.int32)
    mask = np.array([[1] * 6, [1, 1, 1, 1, 0, 0]], np.int32)
    x0 = np.random.default_rng(5).standard_normal((2, T_AUD, 8)).astype(
        np.float32)

    @jax.jit
    def pipeline(params, vae_params, gen_params, ids, mask, x0):
        cv, ctx, pad, nf = j_tts_encode(model, params, ids, mask)
        latents = tts_decode(model, params, cv, ctx, pad,
                             jnp.full_like(nf, NF), None, steps=STEPS,
                             cfg_scale=CFG, t_aud=T_AUD, method=METHOD,
                             x_init=x0)
        dec_mask = (jnp.arange(T_AUD)[None, :] < NF)[..., None].astype(
            jnp.float32)
        mel = denormalize_mel(vae.apply(
            vae_params, latents.astype(jnp.float32), dec_mask,
            method=AcousticVAE.decode), vae.cfg)
        mmask = (jnp.arange(mel.shape[1])[None, :]
                 < vae.cfg.total_stride * NF)[..., None]
        return hifigan_apply_fused(gen_params, mel * mmask.astype(mel.dtype),
                                   cfg=hcfg)

    wav = np.asarray(pipeline(params, vae_params, gen_params, ids, mask, x0))

    tmodel = TQwenCALM(from_dict(TCALMConfig, dataclasses.asdict(cfg))).eval()
    load_calm(tmodel, params)
    tvae = TVAE(TVAEConfig(**VAE_GEOM)).eval()
    load_vae(tvae, vae_params)
    tgen = TGenerator(THiFiGANConfig(**HIFI_GEOM)).eval()
    load_hifigan(tgen, gen_params["params"])
    with torch.inference_mode():
        twav = bench_tts.run_pipeline(
            tmodel, tvae, bench_tts.make_vocoder(tgen), torch.from_numpy(ids),
            torch.from_numpy(mask), T_AUD, NF, STEPS, CFG, METHOD,
            x_init=torch.from_numpy(x0)).numpy()
    assert twav.shape == wav.shape == (2, T_AUD * 1024)
    assert np.isfinite(twav).all()
    assert np.max(np.abs(twav - wav)) < 5e-3


@pytest.fixture(scope="module")
def tiny():
    """A tiny port model with the flagship's grids (384 audio frames, 96
    text tokens) and a vocabulary past bench_tts's text ids (< 5000), its
    VAE and a narrow HiFi-GAN V1 with one resblock a stage, seeded random
    weights, on the CPU."""
    torch.manual_seed(0)
    cfg = TCALMConfig(
        latent_dim=8, max_audio_len=384, max_text_len=96,
        tts_flow_hidden_dim=32, tts_flow_num_layers=1,
        asr_flow_hidden_dim=32, asr_flow_num_layers=1, flow_num_heads=4,
        qwen=TQwen2Config.tiny(vocab_size=5000),
        lora=TLoRAConfig(rank=2, alpha=4.0, dropout=0.0),
        latent_mean=0.1, latent_std=1.2)
    calm = random_normal_(TQwenCALM(cfg), seed=0, scale=0.1)
    vae = random_normal_(TVAE(TVAEConfig(**VAE_GEOM)), seed=1, scale=0.1)
    gen = random_normal_(TGenerator(THiFiGANConfig(
        upsample_initial_channel=32, resblock_kernel_sizes=(3,),
        resblock_dilations=((1,),))), seed=2, scale=0.1)
    return [m.eval().requires_grad_(False) for m in (calm, vae, gen)]


HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "rtf_wall_mean"}
# bench.py's measure() keys, with --chain
ROW_KEYS = {"label", "t_aud_grid", "audio_seconds", "wall_mean_s",
            "wall_min_s", "spread_pct", "rtf_mean", "rtf_min_wall",
            "wall_min_device_s", "rtf_device", "device_slope_s",
            "rtf_device_slope", "pipeline_tflops", "mfu_pct"}


def test_torch_bench_tts_cli_lines(tiny, capsys):
    """The benchmark's function on tiny models on the CPU: the headline
    line on stdout with bench.py's keys (rtf_tunnel_mean renamed
    rtf_wall_mean), every row on stderr with measure()'s keys and finite
    positive numbers, the ASR and streaming rows."""
    calm, vae, gen = tiny
    args = bench_tts.parse_args(["--device", "cpu", "--iters", "1",
                                 "--steps", "2", "--chain", "2", "--asr",
                                 "--stream", "--components", ""])
    assert (args.method, args.cfg, args.realistic) == ("midpoint", 2.5, True)
    head = bench_tts.bench(calm, vae, gen, args)
    out, err = capsys.readouterr()
    (line,) = _lines(out)
    assert line == head and set(line) == HEADLINE_KEYS
    assert line["metric"] == "tts_realtime_factor_device"
    assert line["vs_baseline"] == pytest.approx(line["value"] / 10)
    rows = {r["label"]: r for r in _lines(err)}
    assert set(rows) == {"full_grid_384", "realistic_8s_bucket_192",
                         "asr_transcribe_384f", "stream_long_tts"}
    for label in ("full_grid_384", "realistic_8s_bucket_192"):
        r = rows[label]
        assert set(r) == ROW_KEYS
        assert all(np.isfinite(v) and v > 0 for k, v in r.items()
                   if k not in ("label", "spread_pct")), r
    assert rows["full_grid_384"]["audio_seconds"] == pytest.approx(384 * .064)
    assert rows["realistic_8s_bucket_192"]["t_aud_grid"] == 192
    assert line["value"] == rows["full_grid_384"]["rtf_device"]
    assert rows["stream_long_tts"]["n_chunks"] >= 2


def test_torch_bench_tts_flops_count_every_ode_step(tiny):
    """count_flops over the whole pipeline runs every ODE step: 4 midpoint
    steps less 2 are 4 velocity evaluations of the CFG-fused 2B batch."""
    calm, vae, gen = tiny
    voc = bench_tts.make_vocoder(gen)
    ids = torch.as_tensor(np.random.default_rng(0).integers(10, 5000, (1, 24)),
                          dtype=torch.int32)
    attn = torch.ones_like(ids)
    with torch.inference_mode():
        flops = {steps: count_flops(lambda: bench_tts.run_pipeline(
            calm, vae, voc, ids, attn, 32, 20, steps, CFG, METHOD,
            torch.Generator().manual_seed(0))) for steps in (2, 4)}
        cv, ctx, pad, _ = tts_encode(calm, ids, attn)
        cond, valid, _ = tts_condition(
            calm, cv, ctx, pad, torch.full((1,), 20, dtype=torch.int32), 32)
        x = torch.zeros(2, 32, 8)
        one = count_flops(lambda: calm.tts_flow_fn(
            torch.cat([cond, cond]), x, torch.zeros(2), torch.cat([ctx, ctx]),
            torch.cat([pad, pad]), torch.cat([~valid, ~valid])))
    assert one > 0
    assert flops[4] - flops[2] == 4 * one


def test_torch_vocoder_kernels_count_their_plain_products():
    """The stage and resblock wrappers' FLOP tally (a launch is invisible
    to FlopCounterMode) equals the counter's count of their plain versions,
    so count_flops covers the vocoder on the card as on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    gen = random_normal_(TGenerator(THiFiGANConfig(**HIFI_GEOM)), seed=3)
    mel = torch.randn(2, 10, 80, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 50, 24, generator=g)
    block = (torch.randn(3, 7, 24, 24, generator=g), torch.randn(3, 24),
             torch.randn(3, 7, 24, 24, generator=g), torch.randn(3, 24), 7,
             (1, 3, 5))
    with torch.no_grad():
        for fused, plain in (
                (lambda: vocoder_kernel.hifigan_apply_fused(gen, mel),
                 lambda: gen(mel)),
                (lambda: vocoder_kernel.fused_resblock(x, block),
                 lambda: vocoder_kernel.fused_resblock_plain(x, block))):
            with FlopCounterMode(display=False) as counter:
                plain()
            assert count_flops(fused) == counter.get_total_flops() > 0


# ---------------------------------------------------------------------------
# bench_stages
# ---------------------------------------------------------------------------
def test_torch_bench_stages_chain_is_the_pipeline(tiny, capsys):
    """The five stage functions chained give bench_tts's pipeline latents
    and waveform bit for bit; each line carries scripts/bench_stages.py's
    keys."""
    calm, vae, gen = tiny
    args = bench_stages.parse_args(["--device", "cpu", "--t-aud", "32",
                                    "--steps", "4", "--method", "midpoint",
                                    "--cfg", "2.5", "--iters", "1",
                                    "--chain", "2"])
    device = torch.device("cpu")
    voc = bench_tts.make_vocoder(gen)
    with torch.inference_mode():
        s = bench_stages.stage_inputs(calm, vae, args, device)
        lat, _ = tts_generate_latents(
            calm, s["text_ids"], s["attn"], steps=4, cfg_scale=2.5, t_aud=32,
            num_frames_override=32, method="midpoint", x_init=s["x0"],
            device="cpu")
        wav = bench_tts.run_pipeline(calm, vae, voc, s["text_ids"], s["attn"],
                                     32, 32, 4, 2.5, "midpoint",
                                     x_init=s["x0"])
        fns = bench_stages.stage_fns(calm, vae, voc, args, s)
        assert torch.equal(fns["ode"](), lat)
        assert torch.equal(s["latents"], lat)
        assert torch.equal(fns["vocoder"](), wav)
    total = bench_stages.profile_stages(calm, vae, gen, args)
    lines = _lines(capsys.readouterr().out)
    assert [r["stage"] for r in lines] == [
        "encode", "condition", "ode", "vae_decode", "vocoder", "TOTAL(sum)"]
    for r in lines[:-1]:
        assert set(r) == {"stage", "ms", "t1_wall_ms", "tK_wall_ms", "chain"}
        assert r["ms"] > 0 and r["chain"] == 2
    assert lines[-1] == total
    assert set(total) == {"stage", "ms", "config", "audio_seconds",
                          "rtf_device_stage_sum"}
    assert set(total["config"]) == {"steps", "method", "cfg", "batch",
                                    "t_aud", "vocoder"}
    assert total["ms"] == pytest.approx(sum(r["ms"] for r in lines[:-1]))


# ---------------------------------------------------------------------------
# bench_train
# ---------------------------------------------------------------------------
ASR_PACKED = ["--tiny", "--task", "asr", "--pack", "8,448,2", "--microbatch",
              "1", "--remat", "none", "--llm-layers", "1", "--fold",
              "librispeech", "--fold-n", "200", "--steps", "1"]
VAE = ["--task", "vae", "--batch", "2", "--crop", "32", "--steps", "1"]
TIMED = ("fold_samples_per_s", "fold_total_s")


def test_torch_bench_train_cli_matches_jax():
    """Both CLIs with --tiny on the CPU, a packed ASR step folded over the
    LibriSpeech-like corpus and a VAE step: the same keys, and every fold
    field that depends on no time exactly equal."""
    jax_bt = _script(ROOT / "scripts" / "bench_train.py")
    for argv in (ASR_PACKED, VAE):
        rc, ref = _run(jax_bt.main, argv)
        assert rc == 0
        rc, got = _run(bench_train.main, argv + ["--device", "cpu"])
        assert rc == 0
        assert len(got) == len(ref) == 1
        (got,), (ref,) = got, ref
        assert set(got) == set(ref), (set(got) ^ set(ref))
        assert got["step_min_s"] > 0
        for key in ref:
            if key.startswith("fold") and key not in TIMED:
                assert got[key] == ref[key], key
    assert got["task"] == "vae" and got["samples_per_s"] > 0


def test_torch_bench_train_folds():
    """The fold functions on their own: the packed-TTS fold places every
    utterance, the bucketed fold counts whole batches."""
    lens = bench_train.fold_lengths("libritts", 500, 0.6)
    assert lens.min() >= 8 and lens.max() <= 384
    np.testing.assert_array_equal(
        lens, bench_train.fold_lengths("libritts", 500, 0.6))
    counts, n = bench_train.fold_bucketed(lens, 16, 16, [96, 192, 384])
    assert n == 16 * sum(counts.values()) == 496
    tok_of, tok0, per_s = bench_train.text_tokens("13,3.3", 96)
    steps_by, utts, *_ = bench_train.fold_packed_tts(
        lens, 16, 256, 8, [96, 192, 384], 16, tok_of)
    assert utts == 500 and set(steps_by) <= {96, 192, 384}
    assert (tok0, per_s) == (13.0, 3.3)


# ---------------------------------------------------------------------------
# bench_serve
# ---------------------------------------------------------------------------
# tests/test_serve.py's TINY_YAML
TINY_YAML = """
model:
  latent_dim: 8
  max_audio_len: 32
  max_text_len: 96
  tts_flow_hidden_dim: 32
  tts_flow_num_layers: 1
  asr_flow_hidden_dim: 32
  asr_flow_num_layers: 1
  flow_num_heads: 4
  qwen:
    vocab_size: 512
    hidden_size: 64
    intermediate_size: 128
    num_hidden_layers: 2
    num_attention_heads: 4
    num_key_value_heads: 2
    head_dim: 16
    rope_theta: 10000.0
evaluation:
  audio_buckets: [16, 32]
  text_buckets: [64, 96]
  compute_dtype: bfloat16
"""


def test_torch_bench_serve_percentile_is_jax():
    jax_bs = _script(ROOT / "scripts" / "bench_serve.py")
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 7, 50, 101):
        xs = sorted(rng.random(n).tolist())
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert bench_serve.percentile(xs, q) == jax_bs.percentile(xs, q)


def test_torch_bench_serve_cli(tmp_path, monkeypatch):
    """The port's CLI spawns the port's server (the CPU, TINY_YAML) and
    prints scripts/bench_serve.py's keys for 2 clients x 1 request, the
    requests coalesced at least once; the JAX script's client against the
    port's server prints the same keys."""
    from audio_calm_torch.serving import server as tserver

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    flags = ["--clients", "2", "--requests", "1", "--rounds", "1"]
    rc, (got,) = _run(bench_serve.main, [
        "--config", str(cfg), "--byte-tokenizer", "--device", "cpu",
        "--batch-window-ms", "200", *flags])
    assert rc == 0
    assert got["metric"] == "serving_tts_throughput"
    assert got["clients"] == 2 and got["requests"] == 2
    assert got["mean_batch"] >= 1
    assert all(got[k] > 0 for k in ("wall_s", "req_per_s", "rtf_aggregate",
                                    "audio_s_per_req", "latency_p50_s"))
    args = tserver.parse_args(["--config", str(cfg), "--byte-tokenizer",
                               "--port", "0", "--device", "cpu"])
    srv = tserver.make_server(tserver.build_engine(args), args).start()
    try:
        jax_bs = _script(ROOT / "scripts" / "bench_serve.py")
        rc, (ref,) = _run(jax_bs.main,
                          ["--base", f"http://localhost:{srv.port}", *flags])
    finally:
        srv.close()
    assert rc is None or rc == 0
    assert set(got) == set(ref)


# ---------------------------------------------------------------------------
# build_manifest, measure_quant_error
# ---------------------------------------------------------------------------
def test_torch_build_manifest_is_jax(tmp_path):
    rng = np.random.default_rng(0)
    for subset, spk, texts in (("dev-clean", "19", ["HELLO WORLD",
                                                     "ÇA VA BIEN"]),
                               ("dev-other", "7", ["ONE", "TWO", "THREE"])):
        folder = tmp_path / subset / spk / "1"
        folder.mkdir(parents=True)
        lines = []
        for i, text in enumerate(texts):
            fid = f"{spk}-1-{i:04d}"
            lines.append(f"{fid} {text}")
            if i != 1 or subset != "dev-other":  # one id without an array
                np.save(folder / f"{fid}.npy",
                        rng.standard_normal((5, 8)).astype(np.float32))
        (folder / f"{spk}-1.trans.txt").write_text(
            "\n".join(lines) + "\n", encoding="utf-8")
    jax_bm = _script(ROOT / "scripts" / "build_manifest.py")
    outs = []
    for name, main in (("jax", jax_bm.main), ("port", t_build_manifest.main)):
        out = tmp_path / f"{name}.jsonl"
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["--latent_dir", str(tmp_path), "--subsets",
                         "dev-clean,dev-other", "--out", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    assert len(outs[0].decode().splitlines()) == 4


def test_torch_measure_quant_error_is_jax(monkeypatch):
    """Both CLIs at one flagship-width layer. The projection errors come
    from the same numpy draws and the same int8 weights and scales: equal.
    The stack's weights are JAX's initial ones (flax's init from
    PRNGKey(0), which torch cannot draw) carried across; both stacks
    compute in bf16 (the JAX Qwen2Model's default dtype), whose last-bit
    roundings differ between XLA's and torch's CPU kernels, and the
    statistic is a difference of two bf16 hidden states: within 1e-2
    relative (measured 5e-3)."""
    from audio_calm_tpu.models.qwen2 import Qwen2Model

    init, inits = Qwen2Model.init, []

    def keep(self, *a, **kw):  # the script's own init, kept for the port
        inits.append(init(self, *a, **kw))
        return inits[-1]

    monkeypatch.setattr(Qwen2Model, "init", keep)
    argv = ["--layers", "1", "--seq", "8", "--batch", "1"]
    rc, (ref,) = _run(_script(ROOT / "scripts" / "measure_quant_error.py")
                      .main, argv)
    assert rc == 0
    (jparams,) = inits
    build = measure_quant_error.build_stack

    def jax_weights(layers, device):
        model = build(layers, device)
        model.load_state_dict(from_jax_params(jax.tree_util.tree_map(
            np.asarray, jparams["params"])), strict=True)
        return model

    monkeypatch.setattr(measure_quant_error, "build_stack", jax_weights)
    rc, (got,) = _run(measure_quant_error.main, argv + ["--device", "cpu"])
    assert rc == 0
    assert set(got) == set(ref)
    for key, value in ref.items():
        if key == "stack_rel_err":
            assert got[key] == pytest.approx(value, rel=1e-2), key
        else:
            assert got[key] == value, key

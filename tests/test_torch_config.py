"""The port's configuration loader (audio_calm_torch/config.py) vs the JAX
package's: every shipped configs/*.yaml and the tiny serving YAML give the
same dict through both `load_config`s, dotted overrides resolve as
yaml.safe_load resolves them, and the errors are the JAX package's
(tests/test_config.py). The port reads YAML with its own reader, so the
reader is held against PyYAML itself on the scalars and structures the
configs use, and must raise on what it does not cover."""

import math

import pytest
import yaml

from audio_calm_torch import config as tconfig
from audio_calm_tpu import config as jconfig

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
  # the shipped serving recipe (configs/calm.yaml)
  compute_dtype: bfloat16
"""


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    p.write_text(TINY_YAML)
    return str(p)


def _both(path, root="CALMConfig", overrides=None):
    return (tconfig.to_dict(tconfig.load_config(
                path, getattr(tconfig, root), overrides)),
            jconfig.to_dict(jconfig.load_config(
                path, getattr(jconfig, root), overrides)))


@pytest.mark.parametrize("path,root", [
    ("configs/calm.yaml", "CALMConfig"), ("configs/tts.yaml", "CALMConfig"),
    ("configs/asr.yaml", "CALMConfig"), ("configs/vae.yaml", "VAEConfig"),
])
def test_shipped_configs_match_jax(path, root):
    port, ref = _both(path, root)
    assert port == ref


def test_tiny_serving_yaml_matches_jax(tiny_yaml):
    port, ref = _both(tiny_yaml)
    assert port == ref
    assert port["evaluation"]["text_buckets"] == [64, 96]


@pytest.mark.parametrize("overrides", [
    ["training.learning_rate=5e-4"],  # YAML 1.1: a string, then a float
    ["training.learning_rate=1e-3", "training.max_steps=1_000"],
    ["model.vae_path=null", "model.qwen_path=~", "data.audio_buckets=null"],
    ["evaluation.audio_buckets=[96, 192]", "model.latent_mean=[0.1, 0.2]"],
    ["model.use_lora=no", "training.bf16=off", "evaluation.use_vocoder=On"],
    ["model.lora={rank: 8, alpha: 16}", "model.qwen.num_hidden_layers=2"],
    ["evaluation.vocoder_path='x # y'", 'data.eval_subsets="a,b"'],
    ["evaluation.cfg_scale=3", "training.num_train_epochs=.5"],
])
def test_overrides_match_jax(overrides):
    port, ref = _both("configs/calm.yaml", overrides=overrides)
    assert port == ref


def test_calm_yaml_for_serving():
    """The served product's config, as the port's server loads it."""
    cfg = tconfig.load_config("configs/calm.yaml",
                              overrides=["model.vae_path=null"])
    m, e = cfg.model, cfg.evaluation
    assert m.vae_path is None and m.lora.rank == 64
    assert (m.qwen.num_hidden_layers, m.qwen.hidden_size) == (28, 1536)
    assert (m.tts_flow_hidden_dim, m.asr_flow_hidden_dim,
            m.flow_num_heads) == (768, 768, 16)
    assert e.audio_buckets == [96, 192, 384] and e.text_buckets == [32, 64, 96]
    assert e.compute_dtype == "bfloat16" and e.vocoder_path is None
    assert cfg.training.learning_rate == pytest.approx(5e-5)


def test_errors_match_jax(tmp_path):
    """A misspelt key is a KeyError, an override without `=` a ValueError,
    a null for a non-Optional scalar a ValueError naming the field."""
    with pytest.raises(KeyError):
        tconfig.from_dict(tconfig.VAEModelConfig, {"ssim_wieght": 0.5})
    with pytest.raises(KeyError):
        tconfig.load_config("configs/calm.yaml",
                            overrides=["model.laten_dim=8"])
    with pytest.raises(ValueError, match="key=value"):
        tconfig.load_config("configs/calm.yaml", overrides=["model.vae_path"])
    p = tmp_path / "empty.yaml"
    p.write_text("{}\n")
    with pytest.raises(ValueError, match="length_group_window.*null"):
        tconfig.load_config(str(p), overrides=["data.length_group_window=null"])
    cfg = tconfig.load_config(str(p), overrides=["model.qwen_path=null"])
    assert cfg.model.qwen_path is None


def test_from_dict_carries_jax_configs():
    """`from_dict(asdict(jax config))`, the parity tests' bridge."""
    import dataclasses

    j = jconfig.CALMModelConfig(latent_dim=8, lora=jconfig.LoRAConfig(rank=2),
                                qwen=jconfig.Qwen2Config.tiny())
    t = tconfig.from_dict(tconfig.CALMModelConfig, dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert isinstance(t.qwen, tconfig.Qwen2Config)


SCALARS = ["5e-4", "5.0e-4", "5.e-4", "1.0e+5", "1e5", "1.5e5", "1_000",
           "017", "0x1F", "0b101", "0o17", "1:30", "1_0.5", "3.", ".5", "-.5",
           "+.5", "+1", "-0", ".inf", "-.INF", ".nan", "yes", "No", "on",
           "OFF", "y", "~", "null", "Null", "", "a:b", "text", "True",
           "'quoted # not a comment'", '"a\\tb\\u00e9"', "'it''s'"]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_scalars_resolve_as_pyyaml(text):
    got, want = tconfig.yaml_load(text), yaml.safe_load(text)
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert type(got) is type(want) and got == want


DOCUMENTS = [
    "a:\n  b:\n    c: 1\n  d: [1, 2.5, x]\ne: null\nf:\n",
    "- a\n- b", "k:\n- a\n- b", "k:\n  - a\n  - {x: 1}",
    "- k: 1\n  j: 2\n- 3", "- - a\n  - b\n- c", "on: 1",
    "k: it's # a comment", "k: a#b", "[1, 2, ]", "{}", "# only a comment\n",
    "k: [a, [b, {c: d}]]", "'q': {rank: 64, alpha: 128, dropout: 0.05}",
    "k: v w x   # trailing", "dup: 1\ndup: 2",
    "k: 'a''b # c' # real", 'k: "a\\"b # c" # real', 'k: "x\\\\" # c',
]


@pytest.mark.parametrize("text", DOCUMENTS)
def test_yaml_documents_parse_as_pyyaml(text):
    assert tconfig.yaml_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "k: [1,\n 2]", "k: |\n  x", "k: >\n  x", "k: &a 1", "k: *a",
    "--- \nk: 1", "k: 2001-01-01", "k: !!str 1", "k: - a",
    "a:\n    b: 1\n  c: 2", "k: 'open", "\tk: 1", "k: v\n  more",
])
def test_yaml_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        tconfig.yaml_load(text)

"""Configuration of the PyTorch port.

Field-for-field copies of the JAX package's configuration dataclasses
(audio_calm_tpu/config.py), so a configuration written for one package
builds the same geometry in the other, and its loader: `load_config` reads
a YAML file into a root dataclass with dotted overrides
("training.learning_rate=1e-4"), raising on unknown keys. The port keeps
its own copy: it imports nothing of the JAX package.

The card's machine has no PyYAML, so the port reads YAML with its own
reader (`yaml_load`). It covers the subset the configs use: block maps and
block lists, inline `[...]` lists and `{k: v}` maps on one line, comments,
quoted strings and nulls. It resolves plain scalars as `yaml.safe_load`
does (YAML 1.1): `5e-4` with no dot is a string (the dataclass coercion
makes it a number), `yes` / `no` / `on` / `off` are booleans, `1_000` is
an int. Anything else (anchors, tags, block scalars, multi-line flow
collections or quoted strings, documents markers, timestamps) raises
ValueError instead of being guessed.
"""

from __future__ import annotations

import dataclasses
import math
import re
import types
import typing
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional


@dataclass
class MelConfig:
    """The log-mel frontend (reference preprocess/core.py:33-61)."""

    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float = 8000.0
    power: float = 2.0
    log_clamp: float = 1e-5  # ln(clamp(mel, 1e-5)); floor ~= -11.5
    center: bool = True
    pad_mode: str = "reflect"


@dataclass
class VAEModelConfig:
    in_channels: int = 80
    hidden_channels: int = 512
    latent_channels: int = 128
    strides: List[int] = field(default_factory=lambda: [2, 2])
    kl_weight: float = 5e-5
    kl_clamp: float = 2.0
    latent_dropout: float = 0.05
    norm_num_groups: int = 32
    use_l1_loss: bool = True
    ssim_weight: float = 1.0
    stft_loss_weight: float = 0.25
    mel_mean: float = -6.589515
    mel_std: float = 3.860679

    @property
    def total_stride(self) -> int:
        t = 1
        for s in self.strides:
            t *= s
        return t


@dataclass
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    head_dim: int = 128
    max_position_embeddings: int = 32768
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    attention_dropout: float = 0.0

    @staticmethod
    def tiny(vocab_size: int = 512) -> "Qwen2Config":
        """A miniature geometry for tests (structure-identical)."""
        return Qwen2Config(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            rope_theta=10000.0,
        )


@dataclass
class LoRAConfig:
    enabled: bool = True
    rank: int = 64
    alpha: float = 128.0
    dropout: float = 0.05
    target_modules: List[str] = field(
        default_factory=lambda: [
            "q_proj", "k_proj", "v_proj", "o_proj",
            "gate_proj", "up_proj", "down_proj",
        ]
    )


@dataclass
class CALMModelConfig:
    qwen_path: Optional[str] = None
    tokenizer_path: Optional[str] = None
    vae_path: Optional[str] = None
    use_precomputed_latents: bool = True
    latent_dim: int = 128
    tts_loss_weight: float = 1.0
    asr_loss_weight: float = 1.0
    len_pred_loss_weight: float = 0.1
    dur_pred_loss_weight: float = 0.1
    downsample_rate: int = 1
    max_audio_len: int = 384
    max_text_len: int = 96
    tts_flow_hidden_dim: int = 1024
    tts_flow_num_layers: int = 4
    asr_flow_hidden_dim: int = 1024
    asr_flow_num_layers: int = 4
    flow_num_heads: int = 16
    cfg_dropout_prob: float = 0.1
    mel_mean: float = -6.589515
    mel_std: float = 3.860679
    latent_mean: Any = 0.0  # scalar or [latent_dim] list
    latent_std: Any = 1.0
    use_lora: bool = True
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    remat_policy: str = "full"
    freeze_projector: bool = False
    qwen: Qwen2Config = field(default_factory=Qwen2Config)
    pretrained_projector_path: Optional[str] = None
    pretrained_tts_head_path: Optional[str] = None
    pretrained_tts_len_pred_path: Optional[str] = None
    pretrained_asr_head_path: Optional[str] = None
    pretrained_asr_query_path: Optional[str] = None
    pretrained_lora_path: Optional[str] = None


@dataclass
class TrainingConfig:
    output_dir: str = "outputs/checkpoints/run"
    run_name: str = "run"
    resume_from_checkpoint: Optional[str] = None
    per_device_train_batch_size: int = 16
    per_device_eval_batch_size: int = 1
    # optax.MultiSteps: one optimizer update per k step calls, on the mean
    # of their gradients
    gradient_accumulation_steps: int = 1
    # slices of one step's batch whose gradients are averaged (1 = off)
    microbatch_steps: int = 1
    # per-task overrides of microbatch_steps (None = microbatch_steps)
    tts_microbatch_steps: Optional[int] = None
    asr_microbatch_steps: Optional[int] = None
    # storage dtype of the FROZEN params (the LLM base, the embedding)
    frozen_weights_dtype: str = "float32"
    learning_rate: float = 5e-5
    num_train_epochs: float = 3.0
    max_steps: int = -1
    bf16: bool = True
    gradient_checkpointing: bool = True
    lr_scheduler_type: str = "cosine"
    warmup_ratio: float = 0.1
    max_grad_norm: float = 1.0
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    logging_steps: int = 10
    save_steps: int = 500
    save_total_limit: int = 2
    eval_steps: int = 500
    load_best_model_at_end: bool = True
    metric_for_best_model: str = "loss"
    seed: int = 42
    # 5-group LR multipliers (reference: train_calm.py:249-291)
    soa_lr_mult: float = 5.0
    proj_lr_mult: float = 1.0
    head_lr_mult: float = 3.0
    # metrics are read back from the device every N steps at most
    metrics_drain_steps: int = 4
    shard_optimizer_state: bool = True
    dataloader_num_workers: int = 0
    report_to: str = "none"


@dataclass(frozen=True)
class HiFiGANConfig:
    """HiFi-GAN V1 at 16 kHz (audio_calm_tpu/models/vocoder.py:35-52)."""

    in_channels: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: tuple = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1

    @property
    def total_upsample(self) -> int:
        t = 1
        for r in self.upsample_rates:
            t *= r
        return t


@dataclass
class DatasetPaths:
    latent_dir: Optional[str] = None
    eval_latent_dir: Optional[str] = None
    subsets: str = ""


@dataclass
class DataConfig:
    task_mode: str = "mix"  # "tts" | "asr" | "mix"
    task_prob_tts: float = 0.5
    datasets: Dict[str, DatasetPaths] = field(default_factory=dict)
    train_subsets: str = ""
    eval_subsets: str = ""
    max_text_len: int = 96
    max_audio_len: int = 384
    latent_downsample: int = 1
    # ascending audio-length buckets of training batches (last ==
    # max_audio_len); None = one max-length grid
    audio_buckets: Optional[List[int]] = None
    length_group_window: int = 0
    # pad width of the constant ASR prompt inside [audio | SOA | prompt]
    asr_text_pad: Optional[int] = None
    # sequence packing (0 = off): rows per global batch, tokens a row,
    # utterances a row
    asr_pack_rows: int = 0
    asr_pack_len: int = 512
    asr_pack_segments: int = 4
    tts_pack_rows: int = 0
    tts_pack_len: int = 256
    tts_pack_segments: int = 8
    # VAE training data
    data_dir: Optional[str] = None
    eval_data_dir: Optional[str] = None
    crop_size: int = 256


@dataclass
class EvaluationConfig:
    task: str = "mix"
    checkpoint_path: Optional[str] = None
    output_dir: str = "outputs/eval_results"
    max_samples: int = 50
    use_vocoder: bool = True
    # HiFi-GAN checkpoint (torch file or SpeechBrain dir); None = Griffin-Lim
    vocoder_path: Optional[str] = None
    # inference ODE grids (ascending latent-frame counts) and prompt-token
    # buckets; None = the max grid / unpadded prompts
    audio_buckets: Optional[List[int]] = None
    text_buckets: Optional[List[int]] = None
    # long-form TTS: equal-power crossfade at chunk boundaries (ms)
    crossfade_ms: float = 20.0
    steps: int = 12
    cfg_scale: float = 2.5
    asr_steps: int = 10
    asr_cfg_scale: float = 1.0
    ode_method: str = "midpoint"  # "euler" (reference protocol) | "midpoint"
    time_schedule: str = "uniform"  # "uniform" (reference) | "sway"
    # dtype of the CALM inference graph (LLM encode + flow ODE): "float32"
    # is the reference eval protocol, "bfloat16" the serving recipe; the
    # mel frontend, VAE and vocoder stay fp32 either way
    compute_dtype: str = "float32"
    eval_asr_model: Optional[str] = None
    seed: int = 42
    datasets: Dict[str, DatasetPaths] = field(default_factory=dict)


@dataclass
class CALMConfig:
    """Root config for CALM training and inference (configs/{calm,tts,asr}.yaml)."""

    model: CALMModelConfig = field(default_factory=CALMModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    mel: MelConfig = field(default_factory=MelConfig)


@dataclass
class VAEConfig:
    """Root config for VAE training (configs/vae.yaml)."""

    model: VAEModelConfig = field(default_factory=VAEModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    mel: MelConfig = field(default_factory=MelConfig)


# ---------------------------------------------------------------------------
# dicts -> dataclasses (audio_calm_tpu/config.py:22-105)
# ---------------------------------------------------------------------------
def _coerce(value: Any, typ: Any) -> Any:
    """Coerce a parsed YAML value to a dataclass field's type."""
    if typ is Any:
        return value
    origin = getattr(typ, "__origin__", None)
    if origin is typing.Union or isinstance(typ, types.UnionType):
        if value is None:
            return None
        return _coerce(value, [a for a in typ.__args__
                               if a is not type(None)][0])
    if origin in (list, List):
        return [_coerce(v, typ.__args__[0]) for v in value]
    if origin in (dict, Dict):
        return {k: _coerce(v, typ.__args__[1]) for k, v in value.items()}
    if origin is not None:
        return value
    if dataclasses.is_dataclass(typ):
        return from_dict(typ, value)
    # a null for a non-Optional scalar would smuggle None into an int or
    # float field and fail far from the config
    if value is None and typ in (bool, int, float, str):
        raise ValueError(
            f"null is not allowed for this non-Optional {typ.__name__} field")
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if typ is float:
        return float(value)
    if typ is int:
        if isinstance(value, float) and value != int(value):
            raise ValueError(f"cannot coerce {value!r} to int")
        return int(value)
    if typ is str:
        return str(value)
    return value


def from_dict(cls, data: Optional[Dict[str, Any]]):
    """Build dataclass `cls` from a (possibly nested) dict of its fields,
    e.g. a parsed YAML section or `dataclasses.asdict` of the JAX package's
    config of the same name; unknown keys raise KeyError."""
    if data is None:
        return cls()
    if not isinstance(data, dict):
        raise TypeError(f"expected mapping for {cls.__name__}, got {type(data)}")
    known = {f.name for f in fields(cls)}
    unknown = set(data) - known
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: "
                       f"{sorted(unknown, key=str)}; known: {sorted(known)}")
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for name, value in data.items():
        try:
            kwargs[name] = _coerce(value, hints[name])
        except ValueError as e:
            raise ValueError(f"{cls.__name__}.{name}: {e}") from None
    return cls(**kwargs)


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------------------
# the YAML subset reader
# ---------------------------------------------------------------------------
# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py)
_BOOLS = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                           "On", "ON"), True),
          **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                           "Off", "OFF"), False)}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "b": "\b", "t": "\t", "n": "\n", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _YAMLError(ValueError):
    def __init__(self, line: int, msg: str):
        super().__init__(f"YAML line {line}: {msg} (outside the subset this "
                         "reader covers)")


def _sexagesimal(value: str, cast):
    total = 0
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def yaml_scalar(text: str, line: int = 1):
    """A plain (unquoted) scalar resolved as yaml.safe_load resolves it."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * _sexagesimal(v, int)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * _sexagesimal(v, float)
    if _TIMESTAMP.match(text) or text in ("=", "<<"):
        raise _YAMLError(line, f"scalar {text!r} (a timestamp, value or merge "
                               "key)")
    if text[0] in "&*!|>%@`":
        raise _YAMLError(line, f"{text!r} (anchor, alias, tag or block "
                               "scalar)")
    return text


def _strip_comment(raw: str) -> str:
    """The line without its comment: a `#` at the start or after
    whitespace, outside a quoted scalar (a quote opens a scalar only where
    a token starts)."""
    quote, i = None, 0
    while i < len(raw):
        c = raw[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1  # the escaped character
            elif c == quote:
                if quote == "'" and raw[i + 1:i + 2] == "'":
                    i += 1  # '' inside single quotes
                else:
                    quote = None
        elif c in "'\"" and (i == 0 or raw[i - 1] in " [{,"):
            quote = c
        elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i]
        i += 1
    return raw


class _Flow:
    """Recursive descent over one line: a flow collection, a quoted or a
    plain scalar."""

    def __init__(self, text: str, line: int):
        self.s, self.i, self.line = text, 0, line

    def error(self, msg):
        raise _YAMLError(self.line, f"{msg} in {self.s!r}")

    def skip(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def peek(self) -> str:
        self.skip()
        return self.s[self.i] if self.i < len(self.s) else ""

    def node(self, in_flow: bool):
        c = self.peek()
        if c == "[":
            self.i += 1
            out = []
            while self.peek() != "]":
                if not self.peek():
                    self.error("unclosed [")
                out.append(self.node(True))
                if self.peek() == ",":
                    self.i += 1
                elif self.peek() != "]":
                    self.error("expected , or ]")
            self.i += 1
            return out
        if c == "{":
            self.i += 1
            out = {}
            while self.peek() != "}":
                if not self.peek():
                    self.error("unclosed {")
                key = self.node(True)
                if self.peek() != ":":
                    self.error("expected key: value")
                self.i += 1
                value = None if self.peek() in ",}" else self.node(True)
                out[_hashable(key, self.line)] = value
                if self.peek() == ",":
                    self.i += 1
                elif self.peek() != "}":
                    self.error("expected , or }")
            self.i += 1
            return out
        if c in ("'", '"'):
            return self.quoted(c)
        return self.plain(in_flow)

    def quoted(self, q: str) -> str:
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                self.error("unclosed quote (multi-line scalars are not covered)")
            c = self.s[self.i]
            self.i += 1
            if c == q:
                if q == "'" and self.s[self.i:self.i + 1] == "'":
                    out.append("'")
                    self.i += 1
                    continue
                return "".join(out)
            if c == "\\" and q == '"':
                e = self.s[self.i:self.i + 1]
                self.i += 1
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    try:
                        out.append(chr(int(self.s[self.i:self.i + n], 16)))
                    except ValueError:
                        self.error(f"bad escape \\{e}")
                    self.i += n
                else:
                    self.error(f"escape \\{e}")
                continue
            out.append(c)

    def plain(self, in_flow: bool):
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if in_flow and c in ",[]{}":
                break
            if c == ":" and (self.i + 1 == len(self.s)
                             or self.s[self.i + 1] == " "
                             or (in_flow and self.s[self.i + 1] in ",]}")):
                break
            self.i += 1
        text = self.s[start:self.i].rstrip()
        if text.startswith("- ") or text == "-":
            self.error("a block list item where a value belongs")
        return yaml_scalar(text, self.line)

    def whole(self):
        """The line as one node; raise if anything is left after it."""
        value = self.node(False)
        if self.peek():
            self.error(f"unexpected {self.s[self.i:]!r}")
        return value


def _hashable(key, line):
    if isinstance(key, (list, dict)):
        raise _YAMLError(line, "a collection as a mapping key")
    return key


def _map_key(content: str, line: int):
    """`key: rest` -> (key, rest); None when the line is no mapping entry."""
    if content[0] in "[{" or content.startswith("- ") or content == "-":
        return None
    f = _Flow(content, line)
    if content[0] in "'\"":
        key = f.quoted(content[0])
    else:
        key = f.plain(False)
    if f.peek() != ":":
        return None
    return _hashable(key, line), content[f.i + 1:].strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines, pos: int, indent: int):
    """The block node whose lines start at `pos`, indented `indent`."""
    line, _, content = lines[pos]
    if _is_item(content):
        return _seq(lines, pos, indent)
    if _map_key(content, line) is not None:
        return _map(lines, pos, indent)
    return _Flow(content, line).whole(), pos + 1


def _child(lines, pos: int, indent: int, same_indent_list: bool):
    """The value of an entry with nothing after its `key:` or `-`: the
    block indented deeper on the next line (or a list at the same indent,
    under a mapping key), else null."""
    if pos < len(lines):
        nxt_indent, content = lines[pos][1], lines[pos][2]
        if nxt_indent > indent:
            return _block(lines, pos, nxt_indent)
        if same_indent_list and nxt_indent == indent and _is_item(content):
            return _seq(lines, pos, indent)
    return None, pos


def _seq(lines, pos: int, indent: int):
    out = []
    while pos < len(lines) and lines[pos][1] == indent and _is_item(
            lines[pos][2]):
        line, _, content = lines[pos]
        rest = content[1:].lstrip(" ")
        if not rest:
            value, pos = _child(lines, pos + 1, indent, False)
        else:
            # the item's content is a node starting at its own column
            col = indent + len(content) - len(rest)
            lines[pos] = (line, col, rest)
            value, pos = _block(lines, pos, col)
        out.append(value)
    _end_of_block(lines, pos, indent)
    return out, pos


def _map(lines, pos: int, indent: int):
    out = {}
    while pos < len(lines) and lines[pos][1] == indent:
        line, _, content = lines[pos]
        entry = _map_key(content, line)
        if entry is None:
            raise _YAMLError(line, f"{content!r} inside a mapping")
        key, rest = entry
        if rest:
            value, pos = _Flow(rest, line).whole(), pos + 1
        else:
            value, pos = _child(lines, pos + 1, indent, True)
        out[key] = value  # a repeated key keeps the last value, as PyYAML
    _end_of_block(lines, pos, indent)
    return out, pos


def _end_of_block(lines, pos: int, indent: int):
    if pos < len(lines) and lines[pos][1] > indent:
        raise _YAMLError(lines[pos][0], "unexpected indentation (multi-line "
                                        "values are not covered)")


def yaml_load(text: str):
    """Parse a YAML document of the covered subset, as yaml.safe_load
    would; an empty document is None."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        lead = raw[:len(raw) - len(raw.lstrip(" \t"))]
        if "\t" in lead:
            raise _YAMLError(n, "a tab in the indentation")
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        if body.startswith(("---", "...", "%")):
            raise _YAMLError(n, "document markers and directives")
        lines.append((n, len(lead), body.strip()))
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][1])
    if pos < len(lines):
        raise _YAMLError(lines[pos][0], "unexpected indentation")
    return value


# ---------------------------------------------------------------------------
# loading + CLI overrides (audio_calm_tpu/config.py:456-473)
# ---------------------------------------------------------------------------
def _apply_override(data: Dict[str, Any], dotted: str, raw: str) -> None:
    keys = dotted.split(".")
    node = data
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = yaml_load(raw)


def load_config(path: str, cls=CALMConfig, overrides: Optional[List[str]] = None):
    """Load a YAML config into dataclass `cls` with dotted CLI overrides
    ("section.field=value", the value read as a YAML scalar or inline
    collection)."""
    with open(path) as f:
        data = yaml_load(f.read()) or {}
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        _apply_override(data, k, v)
    return from_dict(cls, data)

"""Model configuration dataclasses of the PyTorch port.

Field-for-field copies of the JAX package's `Qwen2Config`, `LoRAConfig`,
`CALMModelConfig`, `VAEModelConfig` and `TrainingConfig`
(audio_calm_tpu/config.py), so a
configuration written for one package builds the same geometry in the other.
The port keeps its own copy: it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional


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


def from_dict(cls, data):
    """Build dataclass `cls` from a (possibly nested) dict of its fields,
    e.g. `dataclasses.asdict` of the JAX package's config of the same name."""
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in hints:
            raise KeyError(f"{cls.__name__} has no field {key!r}")
        sub = {"qwen": Qwen2Config, "lora": LoRAConfig}.get(key)
        if cls is CALMModelConfig and sub is not None and isinstance(value, dict):
            value = from_dict(sub, value)
        kwargs[key] = value
    return cls(**kwargs)

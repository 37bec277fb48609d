"""Plain PyTorch forward passes of the served TTS path, one request row at
a time, at its own length: float32 on the card with TF32 off, no kernel,
no cache, no batching, no padding. Weights come as a dict of tensors named
as in `spec.py`.

- Qwen2 (Qwen/Qwen2-1.5B-Instruct's layer equations): RMSNorm (eps 1e-6),
  rotate-half RoPE, grouped-query causal attention with q/k/v biases,
  SwiGLU; LoRA (scale alpha / r) on every target projection. The row is
  [prompt tokens | SOA], the SOA state is the condition vector.
- The length and duration predictors: Linear -> exact GELU -> Linear; the
  length clamped to [max(2 L, 10), min(12 L, max_audio_len)]; durations
  softplus + 1e-4 scaled to the frame count.
- The duration -> alignment repair and expansion.
- The DiT velocity field: sinusoidal time MLP, AdaLN (LayerNorm eps 1e-6,
  no affine, x (1 + scale) + shift), self-attention, gated cross-attention
  to the projected text states, GELU MLP, sinusoidal positions.
- The midpoint (or Euler) ODE from t = 0 to 1 with classifier-free
  guidance: v_u + cfg (v_c - v_u), the unconditional row with zero
  condition and zero context.
- The VAE decoder (GroupNorm 32 eps 1e-6, GELU ResBlocks, transposed
  convolutions) and HiFi-GAN's generator (LeakyReLU 0.1 everywhere, as the
  system defines it; see PERF.md for the departure from the published
  0.01 before conv_post).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F


class Weights(dict):
    """Tensors by name, with the rounding applied to every product's
    activation operand: none for the reference itself; `fp8_weights`
    builds the control, whose weights and operands are float8 (e4m3,
    scaled per tensor), the precision below the bf16 the configurations
    state."""

    def __init__(self, tensors, operand=None):
        super().__init__(tensors)
        self.operand = operand or (lambda x: x)


W_ = Weights


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude to 448), back in float32."""
    s = x.abs().amax().float().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def fp8_weights(tensors) -> Weights:
    """The products' weights (every tensor of two or more dimensions) in
    float8, every product's other operand rounded to float8 at use."""
    return Weights({k: fp8(v) if v.dim() >= 2 else v
                    for k, v in tensors.items()}, operand=fp8)


def exact_fp32() -> None:
    """Full float32 products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linear(W: W_, name: str, x: torch.Tensor) -> torch.Tensor:
    y = W.operand(x) @ W[f"{name}.weight"].t()
    b = W.get(f"{name}.bias")
    return y if b is None else y + b


def lora_linear(W: W_, name: str, x: torch.Tensor, scale: float
                ) -> torch.Tensor:
    y = linear(W, name, x)
    a = W.get(f"{name}.lora_a")
    if a is None:
        return y
    return y + scale * (W.operand(W.operand(x) @ a) @ W[f"{name}.lora_b"])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def softmax_attention(q, k, v, key_valid: Optional[torch.Tensor] = None,
                      causal: bool = False, rnd=lambda x: x) -> torch.Tensor:
    """q [B, Tq, H, d], k / v [B, Tk, H, d] -> [B, Tq, H, d]; key_valid
    [B, Tk] (True = attend); `rnd` rounds the products' operands."""
    s = torch.einsum("bqhd,bkhd->bhqk", rnd(q), rnd(k)) / math.sqrt(
        q.shape[-1])
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        keep = keep.tril()
    keep = keep[None, None]
    if key_valid is not None:
        keep = keep & key_valid[:, None, None, :]
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", rnd(torch.softmax(s, dim=-1)),
                        rnd(v))


def gelu(x):
    return F.gelu(x, approximate="none")


# ---------------------------------------------------------------------------
# Qwen2 + LoRA
# ---------------------------------------------------------------------------
def qwen2_encode(W: W_, model: dict, ids: List[int]) -> torch.Tensor:
    """[prompt ids | SOA] -> final-norm hidden states [L + 1, D]."""
    q = model["qwen"]
    dev = W["soa_embed"].device
    lora = model["lora"]
    scale = lora["alpha"] / lora["rank"]
    Hq, Hkv, hd = (q["num_attention_heads"], q["num_key_value_heads"],
                   q["head_dim"])
    eps = q["rms_norm_eps"]
    x = torch.cat([W["embed.embedding"][torch.as_tensor(ids, device=dev)],
                   W["soa_embed"][0]])
    T = x.shape[0]
    pos = torch.arange(T, device=dev, dtype=torch.float32)
    inv = 1.0 / (q["rope_theta"] ** (torch.arange(
        0, hd, 2, device=dev, dtype=torch.float32) / hd))
    ang = pos[:, None] * inv[None]
    cos = torch.cat([ang, ang], -1).cos()[:, None, :]
    sin = torch.cat([ang, ang], -1).sin()[:, None, :]

    def rope(t):
        half = hd // 2
        return t * cos + torch.cat([-t[..., half:], t[..., :half]], -1) * sin

    for i in range(q["num_hidden_layers"]):
        p = f"llm.layers.{i}"
        h = rms_norm(x, W[f"{p}.input_layernorm.weight"], eps)
        qh = rope(lora_linear(W, f"{p}.self_attn.q_proj", h, scale)
                  .view(T, Hq, hd))
        kh = rope(lora_linear(W, f"{p}.self_attn.k_proj", h, scale)
                  .view(T, Hkv, hd))
        vh = lora_linear(W, f"{p}.self_attn.v_proj", h, scale).view(T, Hkv,
                                                                  hd)
        g = Hq // Hkv
        a = softmax_attention(qh[None], kh.repeat_interleave(g, 1)[None],
                              vh.repeat_interleave(g, 1)[None], causal=True,
                              rnd=W.operand)
        x = x + lora_linear(W, f"{p}.self_attn.o_proj", a[0].reshape(T, -1),
                            scale)
        h = rms_norm(x, W[f"{p}.post_attention_layernorm.weight"], eps)
        m = F.silu(lora_linear(W, f"{p}.mlp.gate_proj", h, scale)) * \
            lora_linear(W, f"{p}.mlp.up_proj", h, scale)
        x = x + lora_linear(W, f"{p}.mlp.down_proj", m, scale)
    return rms_norm(x, W["llm.norm.weight"], eps)


def predictor(W: W_, name: str, x: torch.Tensor) -> torch.Tensor:
    return linear(W, f"{name}.fc2", gelu(linear(W, f"{name}.fc1", x)))[..., 0]


def predict_length(W: W_, model: dict, text_ctx: torch.Tensor) -> int:
    L = text_ctx.shape[0]
    pred = predictor(W, "tts_len_predictor", text_ctx.mean(0))
    lo = max(2.0 * L, 10.0)
    hi = min(12.0 * L, float(model["max_audio_len"]))
    return int(min(max(float(pred), lo), hi))


def predict_durations(W: W_, text_ctx: torch.Tensor, n_frames: int
                      ) -> torch.Tensor:
    """-> durations [L] scaled to sum to n_frames."""
    d = F.softplus(predictor(W, "tts_dur_predictor", text_ctx)) + 1e-4
    return d * (n_frames / d.sum().clamp_min(1e-4))


def durations_to_int(dur_scaled: torch.Tensor) -> List[int]:
    """floor, at least 1 a token."""
    return [max(1, int(math.floor(float(v)))) for v in dur_scaled]


def alignment(dur: List[int], n_frames: int) -> List[int]:
    """Integer durations -> the token of each of the n_frames frames:
    scaled down (floor) when over budget, each token at least 1 frame,
    the largest (first) shortened while still over, the remainder spread
    +1 over the first tokens in turn, expanded in order."""
    L = len(dur)
    total = sum(dur)
    if total > n_frames:
        s = torch.tensor(n_frames, dtype=torch.float32) / torch.tensor(
            max(total, 1), dtype=torch.float32)
        dur = [int(torch.floor(torch.tensor(d, dtype=torch.float32) * s))
               for d in dur]
    dur = [max(d, 1) for d in dur]
    while True:
        deficit = sum(dur) - n_frames
        mx = max(dur)
        if not (deficit > 0 and mx > 1):
            break
        i = dur.index(mx)
        dur[i] -= min(deficit, mx - 1)
    rem = max(n_frames - sum(dur), 0)
    while rem > 0:
        for i in range(min(rem, L)):
            dur[i] += 1
        rem = max(rem - L, 0)
    tok = []
    for i, d in enumerate(dur):
        tok.extend([i] * d)
    return tok[:n_frames]


# ---------------------------------------------------------------------------
# The DiT velocity field
# ---------------------------------------------------------------------------
def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    f = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                  * (-math.log(10000.0) / (half - 1)))
    a = t[:, None] * f[None]
    return torch.cat([a.sin(), a.cos()], -1)


def position_table(n: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(n, dim, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(torch.float32).to(device)


def ada_ln(W: W_, name: str, x, t_emb):
    scale, shift = linear(W, f"{name}.emb", F.silu(t_emb)).chunk(2, -1)
    x = F.layer_norm(x, (x.shape[-1],), eps=1e-6)
    return x * (1.0 + scale[:, None]) + shift[:, None]


def mha(W: W_, name: str, xq, xkv, heads: int, key_valid=None):
    B, Tq, E = xq.shape
    Tk = xkv.shape[1]
    q = linear(W, f"{name}.q_proj", xq).view(B, Tq, heads, E // heads)
    k = linear(W, f"{name}.k_proj", xkv).view(B, Tk, heads, E // heads)
    v = linear(W, f"{name}.v_proj", xkv).view(B, Tk, heads, E // heads)
    o = softmax_attention(q, k, v, key_valid, rnd=W.operand)
    return linear(W, f"{name}.out_proj", o.reshape(B, Tq, E))


def dit_velocity(W: W_, head: str, model: dict, condition, x, t, context,
                 heads: int, time_dim: int = 256):
    """condition / x [B, n, .], t [B], context [B, L, D] -> v [B, n, out]."""
    t_emb = linear(W, f"{head}.time_mlp.fc2", F.silu(linear(
        W, f"{head}.time_mlp.fc1", time_embedding(t, time_dim))))
    h = linear(W, f"{head}.in_proj", torch.cat([condition, x], -1))
    hidden = h.shape[-1]
    h = h + position_table(h.shape[1], hidden, h.device)[None]
    ctx = linear(W, f"{head}.context_proj", context)
    j = 0
    while f"{head}.blocks.{j}.adaLN1.emb.weight" in W:
        b = f"{head}.blocks.{j}"
        a = ada_ln(W, f"{b}.adaLN1", h, t_emb)
        h = h + mha(W, f"{b}.attn", a, a, heads)
        a = ada_ln(W, f"{b}.adaLN_ctx", h, t_emb)
        h = h + torch.sigmoid(W[f"{b}.ctx_gate"]) * mha(
            W, f"{b}.ctx_attn", a, ctx, heads)
        a = ada_ln(W, f"{b}.adaLN2", h, t_emb)
        h = h + linear(W, f"{b}.mlp_fc2", gelu(linear(W, f"{b}.mlp_fc1", a)))
        j += 1
    return linear(W, f"{head}.out_proj",
                  ada_ln(W, f"{head}.final_adaLN", h, t_emb))


def ode_cfg(W: W_, model: dict, ev: dict, condition, text_ctx, x0):
    """The guided flow ODE from noise x0 [n, latent] -> x at t = 1."""
    steps, cfg = ev["steps"], float(ev["cfg_scale"])
    heads = model["flow_num_heads"]
    grid = torch.linspace(0.0, 1.0, steps + 1, dtype=torch.float32,
                          device=x0.device)
    t0s = grid[:-1].tolist()
    dts = (grid[1:] - grid[:-1]).tolist()
    cond2 = torch.stack([condition, torch.zeros_like(condition)])
    ctx2 = torch.stack([text_ctx, torch.zeros_like(text_ctx)])
    guided = cfg != 1.0 and cfg > 0

    def vel(x, t):
        if not guided:
            tt = torch.full((1,), t, dtype=torch.float32, device=x.device)
            return dit_velocity(W, "tts_flow_head", model, condition[None],
                                x[None], tt, text_ctx[None], heads)[0]
        tt = torch.full((2,), t, dtype=torch.float32, device=x.device)
        v = dit_velocity(W, "tts_flow_head", model, cond2,
                         torch.stack([x, x]), tt, ctx2, heads)
        return v[1] + cfg * (v[0] - v[1])

    x = x0
    for t, dt in zip(t0s, dts):
        if ev["ode_method"] == "midpoint":
            v = vel(x + (dt / 2.0) * vel(x, t), t + dt / 2.0)
        else:
            v = vel(x, t)
        x = x + dt * v
    return x


# ---------------------------------------------------------------------------
# VAE decoder and HiFi-GAN
# ---------------------------------------------------------------------------
def conv1d(W: W_, name: str, x, pad: int, dilation: int = 1, stride: int = 1):
    """x [C, T] -> [C', T']."""
    return F.conv1d(W.operand(x)[None], W[f"{name}.weight"], W[f"{name}.bias"],
                    stride=stride, padding=pad, dilation=dilation)[0]


def conv_t1d(W: W_, name: str, x, stride: int, pad: int):
    return F.conv_transpose1d(W.operand(x)[None], W[f"{name}.weight"],
                              W[f"{name}.bias"],
                              stride=stride, padding=pad)[0]


def group_norm(W: W_, name: str, x, groups: int, eps: float = 1e-6):
    return F.group_norm(x[None], groups, W[f"{name}.weight"],
                        W[f"{name}.bias"], eps)[0]


def vae_decode(W: W_, vae: dict, z: torch.Tensor) -> torch.Tensor:
    """latents [n, latent] -> normalized mel [n * stride, mels]."""
    g = vae["norm_num_groups"]

    def res(name, x):
        h = gelu(group_norm(W, f"{name}.norm1", x, g))
        h = conv1d(W, f"{name}.conv1", h, 1)
        h = gelu(group_norm(W, f"{name}.norm2", h, g))
        return x + conv1d(W, f"{name}.conv2", h, 1)

    x = conv1d(W, "decoder.conv_in", z.t(), 1)
    x = res("decoder.res_in", x)
    for i, s in enumerate(reversed(vae["strides"])):
        x = conv_t1d(W, f"decoder.up_conv.{i}", x, s, s // 2)
        x = res(f"decoder.up_res.{i}", x)
    return conv1d(W, "decoder.conv_out", x, 1).t()


def hifigan(W: W_, h: dict, mel: torch.Tensor) -> torch.Tensor:
    """log-mel [T, mels] -> waveform [T * prod(upsample_rates)]."""
    slope = h["lrelu_slope"]
    n_k = len(h["resblock_kernel_sizes"])
    x = conv1d(W, "conv_pre", mel.t(), 3)
    for i, (r, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        x = conv_t1d(W, f"ups.{i}", F.leaky_relu(x, slope), r, (k - r) // 2)
        acc = None
        for j, (rk, rd) in enumerate(zip(h["resblock_kernel_sizes"],
                                         h["resblock_dilations"])):
            y = x
            for c, d in enumerate(rd):
                b = f"resblocks.{i * n_k + j}"
                t = conv1d(W, f"{b}.convs1.{c}", F.leaky_relu(y, slope),
                           d * (rk - 1) // 2, dilation=d)
                y = y + conv1d(W, f"{b}.convs2.{c}", F.leaky_relu(t, slope),
                               (rk - 1) // 2)
            acc = y if acc is None else acc + y
        x = acc / n_k
    x = conv1d(W, "conv_post", F.leaky_relu(x, slope), 3)
    return torch.tanh(x[0])

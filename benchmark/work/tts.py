"""The operations and bytes a served TTS row needs, from its shapes: its
prompt's L tokens and its n latent frames, not the padded batch, text
bucket or grid it ran on. A FLOP is one multiply or one add of a product
(2 x the multiply-accumulates); elementwise work, norms and softmax are
not counted. Bytes count each input read once and each output written
once.

A row of a configuration (the JSON of benchmark/configs/) is:
  - Qwen2 with LoRA over [prompt | SOA], L + 1 positions, causal;
  - the length predictor once and the duration predictor at L tokens;
  - the DiT velocity field at n frames with a context of L text states,
    evaluated `steps` (Euler) or 2 x `steps` (midpoint) times, each
    evaluation for both halves of classifier-free guidance;
  - the VAE decoder from n frames and HiFi-GAN from its 4 n mel frames.
"""

from __future__ import annotations

from typing import List, Tuple

BF16, F32, MASK = 2, 4, 1
TIME_DIM = 256


def evaluations(ev: dict) -> int:
    """Velocity evaluations of one ODE solve (each for both CFG halves)."""
    return ev["steps"] * (2 if ev["ode_method"] == "midpoint" else 1)


def guided(ev: dict) -> bool:
    c = float(ev["cfg_scale"])
    return c != 1.0 and c > 0


# ---- Qwen2 ------------------------------------------------------------------
def qwen2_attention(model: dict, T: int) -> Tuple[float, float]:
    """One layer's causal attention over T positions: (FLOP, bytes of q,
    k, v, o in bf16 and the key mask)."""
    q = model["qwen"]
    hd, Hq, Hkv = q["head_dim"], q["num_attention_heads"], \
        q["num_key_value_heads"]
    flops = 2.0 * hd * Hq * T * (T + 1)  # QK^T and PV over T(T+1)/2 pairs
    nbytes = BF16 * (2 * T * Hq * hd + 2 * T * Hkv * hd) + MASK * T
    return flops, nbytes


def qwen2_flops(model: dict, L: int) -> float:
    """[prompt | SOA] through every layer: projections, LoRA, attention."""
    q = model["qwen"]
    D, F_, hd = q["hidden_size"], q["intermediate_size"], q["head_dim"]
    Hq, Hkv = q["num_attention_heads"], q["num_key_value_heads"]
    T = L + 1
    shapes = {"q_proj": (D, Hq * hd), "k_proj": (D, Hkv * hd),
              "v_proj": (D, Hkv * hd), "o_proj": (Hq * hd, D),
              "gate_proj": (D, F_), "up_proj": (D, F_), "down_proj": (F_, D)}
    per_tok = sum(2.0 * i * o for i, o in shapes.values())
    if model.get("use_lora", True) and model["lora"]["rank"]:
        r = model["lora"]["rank"]
        per_tok += sum(2.0 * r * (i + o) for name, (i, o) in shapes.items()
                       if name in model["lora"]["target_modules"])
    layer = T * per_tok + qwen2_attention(model, T)[0]
    return q["num_hidden_layers"] * layer


def predictor_flops(model: dict, L: int) -> float:
    D = model["qwen"]["hidden_size"]
    one = 2.0 * (D * (D // 2) + D // 2)
    return one * (L + 1)  # the length predictor once, durations at L


# ---- the DiT ----------------------------------------------------------------
def dit_attention(model: dict, n: int, L: int) -> Tuple[Tuple[float, float],
                                                        Tuple[float, float]]:
    """One layer's self-attention over n frames and cross-attention from n
    frames to L text states, for one row of one half: ((FLOP, bytes),
    (FLOP, bytes)), q / k / v / o in bf16 and the key mask."""
    H = model["tts_flow_hidden_dim"]
    self_ = (4.0 * n * n * H, BF16 * 4 * n * H + MASK * n)
    cross = (4.0 * n * L * H, BF16 * (2 * n * H + 2 * L * H) + MASK * L)
    return self_, cross


def dit_flops(model: dict, n: int, L: int) -> float:
    """One evaluation of the velocity field for one row of one half."""
    H, D, lat = (model["tts_flow_hidden_dim"], model["qwen"]["hidden_size"],
                 model["latent_dim"])
    f = 2.0 * 2 * TIME_DIM * TIME_DIM  # time MLP
    f += 2.0 * n * (D + lat) * H  # in_proj
    f += 2.0 * L * D * H  # context_proj
    (fs, _), (fc, _) = dit_attention(model, n, L)
    block = (3 * 2.0 * TIME_DIM * 2 * H  # three AdaLN modulations
             + 2.0 * n * 4 * H * H + fs  # self: q, k, v, out + attention
             + 2.0 * n * 2 * H * H + 2.0 * L * 2 * H * H + fc  # cross
             + 2.0 * n * 8 * H * H)  # MLP, 4x
    f += model["tts_flow_num_layers"] * block
    f += 2.0 * TIME_DIM * 2 * H + 2.0 * n * H * lat  # final AdaLN, out_proj
    return f


def ode_flops(model: dict, ev: dict, n: int, L: int) -> float:
    halves = 2 if guided(ev) else 1
    return evaluations(ev) * halves * dit_flops(model, n, L)


# ---- VAE decoder and HiFi-GAN ----------------------------------------------
def vae_decode_flops(vae: dict, n: int) -> float:
    C, lat, mel = vae["hidden_channels"], vae["latent_channels"], \
        vae["in_channels"]
    res = 2 * 2.0 * C * C * 3  # a ResBlock's two k3 convolutions, a frame
    f = 2.0 * n * lat * C * 3 + n * res
    m = n
    for s in reversed(vae["strides"]):
        f += 2.0 * m * C * C * 2 * s  # transposed conv, k = 2 s
        m *= s
        f += m * res
    return f + 2.0 * m * C * mel * 3


def resblocks_flops(h: dict, C: int, T: int) -> float:
    """The MRF resblocks of a stage at C channels over T samples."""
    return sum(2 * len(d) * 2.0 * T * C * C * k
               for k, d in zip(h["resblock_kernel_sizes"],
                               h["resblock_dilations"]))


def resblocks_weight_bytes(h: dict, C: int) -> float:
    return sum(2 * len(d) * (BF16 * C * C * k + F32 * C)
               for k, d in zip(h["resblock_kernel_sizes"],
                               h["resblock_dilations"]))


def hifigan_flops(h: dict, frames: int) -> float:
    """The generator over `frames` mel frames."""
    C = h["upsample_initial_channel"]
    f = 2.0 * frames * h["in_channels"] * C * 7
    T = frames
    for r, k in zip(h["upsample_rates"], h["upsample_kernel_sizes"]):
        f += 2.0 * T * C * (C // 2) * k
        C //= 2
        T *= r
        f += resblocks_flops(h, C, T)
    return f + 2.0 * T * C * 7


KERNEL_MAX_CHANNELS = 128


def k1_stages(h: dict) -> List[Tuple[int, str]]:
    """The stages the vocoder stage kernel runs, as the served path routes
    them: (stage, "whole") for an r = 2 stage whose input width divides 128
    (its upsampling and resblocks), (stage, "resblocks") where only the
    output width divides 128."""
    out, C = [], h["upsample_initial_channel"]
    for i, (r, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        c_out = C // 2
        if (r == 2 and k % r == 0 and (k - r) % 2 == 0
                and C <= KERNEL_MAX_CHANNELS and KERNEL_MAX_CHANNELS % C == 0):
            out.append((i, "whole"))
        elif c_out <= KERNEL_MAX_CHANNELS and KERNEL_MAX_CHANNELS % c_out == 0:
            out.append((i, "resblocks"))
        C = c_out
    return out


def k1_calls(h: dict, frames: List[int]) -> List[Tuple[float, float]]:
    """One render's vocoder stage kernel calls over rows of the given mel
    frame counts: (FLOP, bytes) a call; fp32 activations in and out, bf16
    weights."""
    routes = dict(k1_stages(h))
    calls = []
    C, T = h["upsample_initial_channel"], list(frames)
    for i, (r, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        c_out = C // 2
        T_out = [t * r for t in T]
        how = routes.get(i)
        if how is not None:
            f = sum(resblocks_flops(h, c_out, t) for t in T_out)
            b = resblocks_weight_bytes(h, c_out) + F32 * c_out * sum(T_out)
            if how == "whole":
                f += sum(2.0 * t * C * c_out * k for t in T)
                b += F32 * C * sum(T) + BF16 * C * c_out * k + F32 * c_out
            else:
                b += F32 * c_out * sum(T_out)
            calls.append((f, b))
        C, T = c_out, T_out
    return calls


# ---- a row and a group ----------------------------------------------------
def row_flops(conf: dict, L: int, n: int) -> float:
    """Everything a served row needs, prompt to waveform."""
    m, ev = conf["model"], conf["evaluation"]
    mel = n * _vae_stride(conf["vae"])
    return (qwen2_flops(m, L) + predictor_flops(m, L) + ode_flops(m, ev, n, L)
            + vae_decode_flops(conf["vae"], n)
            + hifigan_flops(conf["hifigan"], mel))


def _vae_stride(vae: dict) -> int:
    s = 1
    for x in vae["strides"]:
        s *= x
    return s


def attention_calls(conf: dict, rows: List[Tuple[int, int]]
                    ) -> List[Tuple[float, float]]:
    """The attention calls of one group of rows [(L, n)]: one a Qwen2
    layer, then per velocity evaluation and DiT layer one self- and one
    cross-attention over both CFG halves. (FLOP, bytes) a call."""
    m, ev = conf["model"], conf["evaluation"]
    calls = []
    q = [qwen2_attention(m, L + 1) for L, _ in rows]
    qf, qb = sum(f for f, _ in q), sum(b for _, b in q)
    calls += [(qf, qb)] * m["qwen"]["num_hidden_layers"]
    halves = 2 if guided(ev) else 1
    d = [dit_attention(m, n, L) for L, n in rows]
    sf = halves * sum(x[0][0] for x in d)
    sb = halves * sum(x[0][1] for x in d)
    cf = halves * sum(x[1][0] for x in d)
    cb = halves * sum(x[1][1] for x in d)
    per_eval = [(sf, sb), (cf, cb)] * m["tts_flow_num_layers"]
    return calls + per_eval * evaluations(ev)


def group_vocoder_calls(conf: dict, rows: List[Tuple[int, int]]
                        ) -> List[Tuple[float, float]]:
    s = _vae_stride(conf["vae"])
    return k1_calls(conf["hifigan"], [n * s for _, n in rows])

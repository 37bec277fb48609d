"""benchmark/work/tts.py: the operations and bytes of a row, against
values worked by hand at one small shape, and against torch's FLOP counter
over the plain reference at the flagship's layer widths cut to a few
layers (causal attention aside, which the counter takes whole)."""

import copy
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import manifest
from benchmark.reference import model as R
from benchmark.reference import spec as S
from benchmark.work import tts as W

SMALL = {
    "qwen": {"hidden_size": 4, "intermediate_size": 8, "head_dim": 2,
             "num_attention_heads": 2, "num_key_value_heads": 1,
             "num_hidden_layers": 1},
    "use_lora": True,
    "lora": {"rank": 1, "target_modules": ["q_proj"]},
    "tts_flow_hidden_dim": 4, "tts_flow_num_layers": 1, "latent_dim": 2,
}


def test_qwen2_by_hand():
    # a token: q 32, k 16, v 16, o 32, gate 64, up 64, down 64, LoRA on q
    # 2 x 1 x (4 + 4) = 16 -> 304; T = 3 positions -> 912; causal attention
    # 2 x hd 2 x 2 heads x T(T + 1) = 96
    assert W.qwen2_flops(SMALL, 2) == 1008
    # q and o 3 x 2 x 2, k and v 3 x 1 x 2, bf16, and 3 mask bytes
    assert W.qwen2_attention(SMALL, 3) == (96, 75)


def test_dit_by_hand():
    # time MLP 262144, in_proj 144, context_proj 64, a block 14000 (AdaLN
    # 12288, self 384 + 144, cross 192 + 128 + 96, MLP 768), final AdaLN
    # 4096, out_proj 48
    assert W.dit_flops(SMALL, 3, 2) == 280496
    (fs, bs), (fc, bc) = W.dit_attention(SMALL, 3, 2)
    assert (fs, bs, fc, bc) == (144, 99, 96, 82)
    ev = {"steps": 2, "ode_method": "midpoint", "cfg_scale": 2.5}
    assert W.ode_flops(SMALL, ev, 3, 2) == 4 * 2 * 280496


def test_vae_and_hifigan_by_hand():
    vae = {"hidden_channels": 4, "latent_channels": 2, "in_channels": 3,
           "strides": [2]}
    # conv_in 144, ResBlock 3 x 192, up 384, ResBlock 6 x 192, conv_out 432
    assert W.vae_decode_flops(vae, 3) == 2688
    h = {"in_channels": 2, "upsample_initial_channel": 4,
         "upsample_rates": [2], "upsample_kernel_sizes": [4],
         "resblock_kernel_sizes": [3], "resblock_dilations": [[1]]}
    # conv_pre 560, up 320, resblock 480, conv_post 280
    assert W.hifigan_flops(h, 5) == 1640
    assert W.k1_stages(h) == [(0, "whole")]
    # resblock weights 2 x (bf16 2 x 2 x 3 + fp32 2) = 64, out 80, in 80,
    # up weights 64, up bias 8
    assert W.k1_calls(h, [5]) == [(800, 296)]


def _flagship(layers=1):
    conf = copy.deepcopy(manifest.cell(manifest.load(), "tts-flagship-batch")
                         ["config"])
    conf["model"]["qwen"].update(num_hidden_layers=layers, vocab_size=300)
    return conf


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_against_the_flop_counter():
    conf = _flagship()
    m = conf["model"]
    Wc = R.Weights(S.draw(S.calm_spec(m), 1, "cpu"))
    ids = list(range(2, 40))
    L = len(ids)
    T = L + 1
    q = m["qwen"]
    full = 4.0 * q["head_dim"] * q["num_attention_heads"] * T * T
    causal = W.qwen2_attention(m, T)[0]
    got = _counted(lambda: R.qwen2_encode(Wc, m, ids))
    assert got == W.qwen2_flops(m, L) - causal + full
    n = 24
    cond, x = torch.randn(2, n, 1536), torch.randn(2, n, 128)
    ctx, t = torch.randn(2, L, 1536), torch.rand(2)
    got = _counted(lambda: R.dit_velocity(Wc, "tts_flow_head", m, cond, x, t,
                                          ctx, m["flow_num_heads"]))
    assert got == 2 * W.dit_flops(m, n, L)
    Wv = R.Weights(S.draw(S.vae_spec(conf["vae"]), 2, "cpu"))
    got = _counted(lambda: R.vae_decode(Wv, conf["vae"], torch.randn(n, 128)))
    assert got == W.vae_decode_flops(conf["vae"], n)
    Wh = R.Weights(S.draw(S.hifigan_spec(conf["hifigan"]), 3, "cpu"))
    got = _counted(lambda: R.hifigan(Wh, conf["hifigan"],
                                     torch.randn(8, 80)))
    assert got == W.hifigan_flops(conf["hifigan"], 8)


def test_vocoder_kernel_work_is_a_part_of_hifigan():
    h = json.loads((manifest.BENCH / "configs" / "flagship-tts.json")
                   .read_text())["hifigan"]
    assert W.k1_stages(h) == [(1, "resblocks"), (2, "whole"), (3, "whole")]
    k1 = sum(f for f, _ in W.k1_calls(h, [100]))
    assert 0.7 * W.hifigan_flops(h, 100) < k1 < W.hifigan_flops(h, 100)

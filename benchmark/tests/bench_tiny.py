"""A cell cut to a size the CPU runs in seconds, for the benchmark's tests:
the flagship's configuration with a 2-layer, 64-wide Qwen2, a 32-wide DiT,
a 16-frame grid and a 64-channel VAE (HiFi-GAN stays V1: the served loader
builds V1), served to 2 clients."""

import copy

from benchmark.harness import manifest


def tiny_cell(workload="tts-flagship-batch", dtype="float32", limits=None):
    c = manifest.cell(manifest.load(), workload)
    conf = copy.deepcopy(c["config"])
    m = conf["model"]
    m["qwen"].update(vocab_size=512, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=16, rope_theta=10000.0)
    m["lora"]["rank"] = 8
    m.update(latent_dim=8, tts_flow_hidden_dim=32, asr_flow_hidden_dim=32,
             flow_num_heads=4, tts_flow_num_layers=1, asr_flow_num_layers=1,
             max_audio_len=16)
    conf["evaluation"].update(audio_buckets=[8, 16], steps=2,
                              compute_dtype=dtype)
    conf["vae"].update(hidden_channels=64, latent_channels=8)
    conf["check"]["sample"] = 3
    if limits is not None:
        conf["check"]["limits"] = dict(limits)
    mix = copy.deepcopy(c["mix"])
    mix.update(loop="closed", clients=2, pool=6)
    mix["server"]["max_batch"] = 2
    c.update(config=conf, mix=mix)
    return c

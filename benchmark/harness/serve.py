"""The system under test, built through the port's own serving path in
this process, and the spans the benchmark records around it.

The weights are drawn on the device from the seed (reference/spec.py) and
put into the port's modules; HiFi-GAN's are written once into a temporary
file in the official checkpoint layout, which the port's own loader reads
(`evaluation.vocoder_path`). The engine is `serving/server.make_engine`,
the server `make_server`, on a free port of 127.0.0.1's machine.

Spans wrap methods of the instances built here (the program is not
edited): the engine's `run_group` (one batcher group), its inference
wrapper's `tts_batch` (the texts, seeds, latents and frames of a group)
and its renderer's `batch`, and the model's `encode_text_for_tts` (its
states are copied to the host for the check) and `predict_durations` (the
durations are kept: the check follows the program's integer durations,
see check.py).
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from benchmark.reference import spec as S


@dataclass
class Span:
    name: str
    t0: float  # perf_counter
    t1: float
    ns0: int  # time_ns, the profiler's clock
    ns1: int
    group: int


@dataclass
class Row:
    """One served row (a request's chunk) of a tts group."""
    text: str
    seed: int
    group: int
    n_frames: int
    latents: object  # numpy [grid, latent], fp32
    durations: Optional[torch.Tensor] = None  # [text bucket], the program's
    hidden: Optional[torch.Tensor] = None  # [text bucket + 1, D] on the host


@dataclass
class GroupRec:
    index: int
    key: str
    rows: int
    seeds: List[int]
    t0: float = 0.0
    t1: float = 0.0


@dataclass
class Recorder:
    active: bool = False
    spans: List[Span] = field(default_factory=list)
    groups: List[GroupRec] = field(default_factory=list)
    rows: Dict[int, Row] = field(default_factory=dict)
    _current: Optional[GroupRec] = None
    _durations: List[torch.Tensor] = field(default_factory=list)
    _hidden: Optional[tuple] = None

    def timed(self, name, fn):
        def wrapped(*a, **k):
            if not self.active:
                return fn(*a, **k)
            t0, ns0 = time.perf_counter(), time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                g = self._current.index if self._current else -1
                self.spans.append(Span(name, t0, time.perf_counter(), ns0,
                                       time.time_ns(), g))
        return wrapped


def _assign(module: torch.nn.Module, drawn: Dict[str, torch.Tensor],
            what: str) -> None:
    """Put the drawn tensors into `module`'s parameters by name; the names
    and shapes must be exactly the spec's."""
    params = dict(module.named_parameters())
    want = {k: tuple(v.shape) for k, v in drawn.items()}
    have = {k: tuple(p.shape) for k, p in params.items()}
    if want != have:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        shapes = [k for k in set(want) & set(have) if want[k] != have[k]][:5]
        raise RuntimeError(f"the program's {what} differs from the "
                           f"benchmark's spec: missing {missing}, extra "
                           f"{extra}, other shapes {shapes}")
    for k, p in params.items():
        p.data = drawn[k]


def program_config(conf: dict, vocoder_path: str):
    from audio_calm_torch.config import CALMConfig, from_dict
    ev = dict(conf["evaluation"], vocoder_path=vocoder_path)
    return from_dict(CALMConfig, {"model": conf["model"], "evaluation": ev})


def write_hifigan(conf: dict, seed: int, device, path: str) -> None:
    """HiFi-GAN's generator drawn from the seed, saved in the official
    checkpoint layout (plain .weight / .bias names)."""
    drawn = S.draw(S.hifigan_spec(conf["hifigan"]), seed, device,
                   torch.float32)
    torch.save({k: v.cpu() for k, v in drawn.items()}, path)


def build(conf: dict, seed: int, device, tmpdir: str, llm_weights=None):
    """-> (engine, model) of the port, the weights drawn from the seed.
    llm_weights="int8": the port's weight-only int8 LLM projections (its
    AUDIO_CALM_LLM_WEIGHTS=int8 path), the control."""
    from audio_calm_torch.config import VAEModelConfig
    from audio_calm_torch.data.tokenizer import ByteTokenizer
    from audio_calm_torch.models.calm import QwenCALM
    from audio_calm_torch.models.flagship import resolve_compute_dtype
    from audio_calm_torch.models.quant import quantize_llm_int8
    from audio_calm_torch.models.vae import AcousticVAE
    from audio_calm_torch.serving.server import make_engine

    s_calm, s_vae, s_voc = S.component_seeds(seed)
    voc_path = os.path.join(tmpdir, "hifigan_v1.bin")
    write_hifigan(conf, s_voc, device, voc_path)
    cfg = program_config(conf, voc_path)
    dtype = resolve_compute_dtype(cfg.evaluation.compute_dtype)
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with torch.device(device):
            model = QwenCALM(cfg.model)
    finally:
        torch.set_default_dtype(saved)
    _assign(model, S.draw(S.calm_spec(conf["model"]), s_calm, device, dtype),
            "CALM model")
    model.eval().requires_grad_(False)
    if llm_weights == "int8":
        quantize_llm_int8(model)
    with torch.device(device):
        vae = AcousticVAE(VAEModelConfig(**conf["vae"]))
    _assign(vae, S.draw(S.vae_spec(conf["vae"]), s_vae, device,
                        torch.float32), "VAE")
    vae.eval().requires_grad_(False)
    tok = ByteTokenizer() if conf["tokenizer"] == "byte" else None
    engine = make_engine(cfg, model, vae, tok, device)
    return engine, model


def instrument(engine, model, rec: Recorder) -> None:
    """Wrap the served instances' methods with the recorder's spans and
    captures."""
    run_group = engine.run_group

    def group(key, items):
        if not rec.active:
            return run_group(key, items)
        g = GroupRec(len(rec.groups), key[0], len(items),
                     [s for _, s in items] if key[0] == "tts" else [])
        rec.groups.append(g)
        rec._current = g
        g.t0, ns0 = time.perf_counter(), time.time_ns()
        try:
            return run_group(key, items)
        finally:
            g.t1 = time.perf_counter()
            rec.spans.append(Span("group", g.t0, g.t1, ns0, time.time_ns(),
                                  g.index))
            rec._current = None

    engine.run_group = group

    tts_batch = rec.timed("tts_batch", engine.inf.tts_batch)

    def captured_tts_batch(texts, seeds, *a, **k):
        rec._durations.clear()
        rec._hidden = None
        latents, n_frames, grid = tts_batch(texts, seeds, *a, **k)
        g = rec._current
        if rec.active and g is not None:
            durs = rec._durations[-1] if rec._durations else None
            hid = rec._hidden
            for i, (t, s) in enumerate(zip(texts, seeds)):
                rec.rows[int(s)] = Row(
                    t, int(s), g.index, int(n_frames[i]),
                    latents[i], None if durs is None else durs[i],
                    None if hid is None else torch.cat([hid[1][i],
                                                        hid[0][i]]))
        return latents, n_frames, grid

    engine.inf.tts_batch = captured_tts_batch
    engine.render.batch = rec.timed("render", engine.render.batch)
    encode = rec.timed("encode", model.encode_text_for_tts)

    def kept_encode(*a, **k):
        out = encode(*a, **k)
        if rec.active:
            # (condition vectors [B, 1, D], text states [B, T, D]) to the
            # host: the check compares them with the reference's
            rec._hidden = (out[0].cpu(), out[1].cpu())
        return out

    model.encode_text_for_tts = kept_encode
    predict_durations = rec.timed("durations", model.predict_durations)

    def kept_durations(*a, **k):
        out = predict_durations(*a, **k)
        if rec.active:
            rec._durations.append(out)
        return out

    model.predict_durations = kept_durations


def serve(engine, mix: dict):
    from audio_calm_torch.serving.server import make_server
    s = mix["server"]
    args = argparse.Namespace(max_batch=int(s["max_batch"]),
                              batch_window_ms=float(s["batch_window_ms"]),
                              first_chunk_batch=0, port=0)
    return make_server(engine, args).start()


def warm_up(engine, conf: dict, mix: dict) -> List[tuple]:
    """Every (padded batch, text bucket) shape the mix's groups can take,
    through the engine's own group call, on the grid the byte prompts
    reach. -> the shapes run."""
    from benchmark.reference.text import prompt_ids
    ev = conf["evaluation"]
    key = ("tts", ev["steps"], float(ev["cfg_scale"]))
    max_b = int(mix["server"]["max_batch"])
    sizes, b = [], 1
    while b <= max_b:
        sizes.append(b if b <= 2 else b // 2 + 1)
        b *= 2
    short, full = "ab cd.", "abcd efghij klm nopqrst uvwxy z."
    buckets = {}
    for t in (short, full):
        L = len(prompt_ids(t))
        buckets.setdefault(next(x for x in ev["text_buckets"] if x >= L), t)
    done = []
    with torch.inference_mode():
        for bucket, t in sorted(buckets.items()):
            for n in sizes:
                engine.run_group(key, [(t, 1000 + i) for i in range(n)])
                done.append((1 << (n - 1).bit_length(), bucket))
    return done

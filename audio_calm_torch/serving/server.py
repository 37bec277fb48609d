"""HTTP inference server of the PyTorch port (counterpart of
scripts/serve.py), standard library only.

    python -m audio_calm_torch.serving.server --config configs/calm.yaml \
        --byte-tokenizer --components <dir> \
        --override model.vae_path=<dir>/vae.bin [--port 8080]
    (AUDIO_CALM_LLM_WEIGHTS=int8 in the environment: int8 LLM weights)

Endpoints:
  GET  /health              -> {"status": "ok"}
  GET  /stats               -> request counts, latency percentiles and
                               coalesced-batch histograms (ServingStats)
  POST /tts  {"text": ..., "steps"?, "cfg_scale"?, "seed"?, "stream"?}
                                                     -> audio/wav bytes
  POST /asr  (body: WAV bytes, ?seed=N)              -> {"text": ...}
  POST /asr?stream=1  (or a chunked Transfer-Encoding upload)
       -> NDJSON: {"chunk": i, "text": ...} per decode chunk as soon as
          its transcript exists, then {"done": true, "text": ..., "chunks": N}

Concurrent short /tts requests, and separately /asr requests, coalesce in
a RequestBatcher into one batched device call (--max-batch,
--batch-window-ms). Long-form requests (multi-chunk /tts text, /asr audio
past the largest latent bucket) submit each chunk to the same batcher
groups. A "seed" pins a request's noise, so its output is reproducible and
independent of what it was batched with.

The engine (scripts/serve.py's order): configs through the port's
load_config and the tokenizer policy; the CALM model built in fp32 from a
seed, the components of a reference checkpoint directory (`--components`:
the 8 component .bins and the peft adapter, train/checkpoint.soft_restart)
laid over it, cast to evaluation.compute_dtype, then int8 LLM projections
when AUDIO_CALM_LLM_WEIGHTS=int8 (models/quant.py); the VAE from
model.vae_path (a torch checkpoint file, models/vae.load_vae) or the seeded
random one when it is null; load_vocoder (Griffin-Lim when
evaluation.vocoder_path is null), the renderer and the bucketed ASR
frontend. Like scripts/serve.py it does not read model.qwen_path: the LLM
base is the seeded one under the checkpoint's LoRA. It runs on the card
unless `--device cpu` is given. Device work runs on the batcher's worker thread,
one group at a time behind a lock, in torch.inference_mode() (grad mode is
per thread).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import struct
import sys
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from audio_calm_torch import resolve_device
from audio_calm_torch.config import (CALMConfig, MelConfig, VAEModelConfig,
                                     load_config)
from audio_calm_torch.data.preprocess import resample_linear
from audio_calm_torch.data.tokenizer import load_tokenizer
from audio_calm_torch.eval.infer import (CALMInference, chunk_seed,
                                         chunk_seeds, crossfade_concat,
                                         crossfade_stream, split_wav_for_asr,
                                         split_wav_for_asr_stream)
from audio_calm_torch.eval.render import make_renderer
from audio_calm_torch.models.calm import QwenCALM
from audio_calm_torch.models.flagship import (build_random,
                                              resolve_compute_dtype)
from audio_calm_torch.models.layers import batch_invariant_
from audio_calm_torch.models.quant import maybe_quantize_from_env
from audio_calm_torch.models.vae import AcousticVAE, load_vae
from audio_calm_torch.models.vocoder import load_vocoder
from audio_calm_torch.serving.batcher import RequestBatcher
from audio_calm_torch.serving.frontend import make_asr_frontend
from audio_calm_torch.serving.stats import ServingStats
from audio_calm_torch.serving.wav_stream import WavStreamParser
from audio_calm_torch.train.checkpoint import COMPONENTS, soft_restart

# /tts steps and cfg_scale quantize to this ladder, at most MAX_ODE_KEYS
# distinct pairs a server; the effective values go back in the X-ODE-Steps
# and X-CFG-Scale headers
ODE_STEPS = (2, 4, 8, 12, 16, 25, 32, 50)
MAX_ODE_KEYS = 8
ASR_SEARCH_SAMPLES = 16000 * 3 // 2  # low-energy cut search window, 1.5 s


class PayloadTooLarge(ValueError):
    """A request past a size or duration cap: HTTP 413 on every /asr path."""


class Engine:
    """The model and everything around it that the handlers use; built by
    build_engine."""

    def __init__(self, cfg: CALMConfig, inf: CALMInference, render,
                 prep_asr, asr_frontend_batch, max_asr_samples: int):
        self.cfg = cfg
        self.inf = inf
        self.render = render
        self.prep_asr = prep_asr
        self.asr_frontend_batch = asr_frontend_batch
        self.max_asr_samples = max_asr_samples
        self._seeds = np.random.default_rng(cfg.evaluation.seed)
        self._seed_lock = threading.Lock()

    def next_seed(self, seed=None) -> int:
        """A request's seed: its own (modulo 2^63, the generator's range),
        else the next draw of the server's seeded stream."""
        if seed is not None:
            return int(seed) % (1 << 63)
        with self._seed_lock:
            return int(self._seeds.integers(1 << 63))

    def run_group(self, group_key, items) -> list:
        """One batcher group on the device. ("tts", steps, cfg_scale) with
        items [(text, seed)] -> one tts_batch and one render.batch;
        ("fe", wav_bucket) with items [(wav_padded, n_samples)] -> one
        batched mel + VAE encode; ("asr", steps) with items [(latents,
        seed)] -> one asr_batch."""
        e = self.cfg.evaluation
        if group_key[0] == "fe":
            return self.asr_frontend_batch(items)
        if group_key[0] == "asr":
            return self.inf.asr_batch(
                [lat for lat, _ in items], [s for _, s in items],
                steps=group_key[1], cfg_scale=e.asr_cfg_scale,
                method=e.ode_method, time_schedule=e.time_schedule)
        _, steps, cfg_scale = group_key
        latents, n_frames, _ = self.inf.tts_batch(
            [t for t, _ in items], [s for _, s in items], steps=steps,
            cfg_scale=cfg_scale, method=e.ode_method,
            time_schedule=e.time_schedule)
        return [np.clip(w, -1, 1) for w in self.render.batch(latents,
                                                             n_frames)]


def load_models(cfg: CALMConfig, device, components=None):
    """-> (CALM model, VAE) as the server serves them: the CALM built in
    fp32 from seed 0, `components` (a reference checkpoint directory, or
    None) laid over it for COMPONENTS and the LoRA adapter, cast to
    evaluation.compute_dtype, int8 LLM projections when the environment
    asks; the VAE from model.vae_path, or from seed 1 when it is null."""
    m = cfg.model
    model = build_random(lambda: QwenCALM(m), device, seed=0)
    if components:
        if not os.path.isdir(components):
            raise FileNotFoundError(f"--components {components} is not a "
                                    "directory")
        soft_restart(model, {c: components for c in COMPONENTS + ("lora",)})
    model = maybe_quantize_from_env(
        model.to(resolve_compute_dtype(cfg.evaluation.compute_dtype)))
    vae_cfg = VAEModelConfig(latent_channels=m.latent_dim)
    if m.vae_path:
        vae = load_vae(m.vae_path, vae_cfg, device=device)
    else:
        vae = build_random(lambda: AcousticVAE(vae_cfg), device, seed=1)
    return model, vae


def make_engine(cfg: CALMConfig, model: QwenCALM, vae: AcousticVAE,
                tokenizer, device) -> Engine:
    """The engine around a served model and VAE (on `device`): inference
    wrapper, vocoder, renderer and the bucketed ASR frontend. A bf16
    model's projections go through the batch-invariant product
    (models/layers.batch_invariant_), so a request's rows do not depend on
    what it is batched with."""
    m = cfg.model
    if model.dtype == torch.bfloat16:
        batch_invariant_(model)
    inf = CALMInference(model, tokenizer,
                        audio_buckets=cfg.evaluation.audio_buckets,
                        text_buckets=cfg.evaluation.text_buckets,
                        device=device)
    vae_cfg = VAEModelConfig(latent_channels=m.latent_dim)
    vocoder = load_vocoder(cfg.evaluation.vocoder_path, device=device)
    print(f"[serve] vocoder: {type(vocoder).__name__}", file=sys.stderr)
    render = make_renderer(vae, vae_cfg, vocoder, device=device)
    mel_cfg = MelConfig()
    # wav lengths quantize to the latent buckets so concurrent /asr
    # frontends coalesce; wavs past the largest take the long-form path
    lat_buckets = cfg.evaluation.audio_buckets or [m.max_audio_len]
    prep_asr, fe_batch = make_asr_frontend(vae, vae_cfg, mel_cfg, lat_buckets,
                                           device=device)
    max_asr = lat_buckets[-1] * vae_cfg.total_stride * mel_cfg.hop_length
    return Engine(cfg, inf, render, prep_asr, fe_batch, max_asr)


def build_engine(args) -> Engine:
    cfg = load_config(args.config, cls=CALMConfig, overrides=args.override)
    device = resolve_device(args.device)
    tokenizer = load_tokenizer(cfg.model, byte_fallback=args.byte_tokenizer)
    model, vae = load_models(cfg, device, args.components)
    return make_engine(cfg, model, vae, tokenizer, device)


def streaming_wav_header(sr: int = 16000) -> bytes:
    """44-byte PCM16 mono WAV header with the unknown-length sentinels
    (0xFFFFFFFF RIFF and data sizes) of a streamed response."""
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def wav_bytes(x: np.ndarray, sr: int = 16000) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((x * 32767).astype("int16").tobytes())
    return buf.getvalue()


def parse_wav(data: bytes) -> np.ndarray:
    """WAV bytes -> float32 mono at 16 kHz."""
    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        if w.getnchannels() > 1:
            x = x.reshape(-1, w.getnchannels()).mean(axis=1)
    return resample_linear(x, sr, 16000)


class CALMServer(ThreadingHTTPServer):
    """The HTTP server with its batcher and stats; `port` is the bound
    port (0 asks for a free one)."""

    daemon_threads = True

    def __init__(self, address, handler, engine: Engine,
                 batcher: RequestBatcher, stats: ServingStats):
        super().__init__(address, handler)
        self.engine, self.batcher, self.stats = engine, batcher, stats
        self.port = self.server_address[1]
        self._thread = None

    def start(self) -> "CALMServer":
        """Serve on a daemon thread (for in-process use); close() stops."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="calm-http", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self.shutdown()
            self._thread.join(timeout=30)
        self.server_close()
        self.batcher.close()


def make_server(engine: Engine, args) -> CALMServer:
    e = engine.cfg.evaluation
    stats = ServingStats()
    device_lock = threading.Lock()

    def run_group_locked(group_key, items):
        # the batcher's worker thread: grad mode is per thread, and the
        # kernel wrappers refuse to run where autograd could record
        with device_lock, torch.inference_mode():
            n = len(items)
            if n > 1:
                print(f"[serve] {group_key[0]} batch size={n} "
                      f"key={group_key}", file=sys.stderr)
            t0 = time.monotonic()
            out = engine.run_group(group_key, items)
            stats.record_group(group_key[0], n, time.monotonic() - t0)
            return out

    batcher = RequestBatcher(run_group_locked,
                             max_batch=max(1, args.max_batch),
                             window_ms=args.batch_window_ms,
                             priority_max_batch=args.first_chunk_batch)
    ode_keys_seen = set()
    ode_keys_lock = threading.Lock()

    def clamp_ode(steps, scale):
        """Quantize to the ladder and cap the distinct pairs: each pair is
        its own batcher group."""
        steps = min(ODE_STEPS, key=lambda s: abs(s - int(steps)))
        scale = max(0.0, min(4.0, round(float(scale) * 4) / 4))
        if (steps, scale) == (e.steps, e.cfg_scale):
            return steps, scale
        with ode_keys_lock:
            if ((steps, scale) not in ode_keys_seen
                    and len(ode_keys_seen) >= MAX_ODE_KEYS):
                return e.steps, e.cfg_scale
            ode_keys_seen.add((steps, scale))
        return steps, scale

    class Handler(BaseHTTPRequestHandler):
        # chunked responses need HTTP/1.1; every other response sets
        # Content-Length, so keep-alive stays correct
        protocol_version = "HTTP/1.1"
        # socket timeout of every read and write: a client that stalls
        # mid-upload times out instead of holding its thread forever
        timeout = 600
        MAX_BODY_BYTES = 64 * 1024 * 1024
        MAX_TTS_CHARS = 20_000
        MAX_ASR_SAMPLES = 600 * 16000  # 10 min of 16 kHz audio

        def log_message(self, fmt, *a):
            print(f"[serve] {fmt % a}", file=sys.stderr)

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json_close(self, code, obj):
            """An error before the request body was read: close the
            connection, or a keep-alive client's unread body would be
            parsed as its next request."""
            self.close_connection = True
            return self._json(code, obj)

        def _emit_chunk(self, data: bytes):
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        def _seed_param(self):
            seed = parse_qs(urlsplit(self.path).query).get("seed", [None])[0]
            return None if seed is None else int(seed)

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {"status": "ok"})
            if self.path == "/stats":
                return self._json(200, stats.snapshot())
            return self._json(404, {"error": "unknown path"})

        def do_POST(self):
            route = self.path.split("?", 1)[0]
            chunked = "chunked" in (
                self.headers.get("Transfer-Encoding") or "").lower()
            q = parse_qs(urlsplit(self.path).query)
            want_stream = q.get("stream", ["0"])[0] not in ("", "0", "false")
            try:
                if route == "/asr" and (chunked or want_stream):
                    return self._post_asr_stream(chunked)
                if chunked:
                    return self._json_close(411, {
                        "error": "chunked upload is only supported on "
                                 "streaming /asr"})
                n = int(self.headers.get("Content-Length", 0))
                if n > self.MAX_BODY_BYTES:
                    return self._json_close(413, {"error": "body too large"})
                body = self.rfile.read(n)
                if route == "/tts":
                    return self._post_tts(body)
                if route == "/asr":
                    return self._post_asr(body)
                return self._json(404, {"error": "unknown path"})
            except Exception as ex:  # report it, keep serving
                stats.record_request(route.lstrip("/"), 0.0, error=True)
                return self._json(500, {"error": str(ex)})

        def _post_tts(self, body):
            req = json.loads(body or b"{}")
            text = req.get("text", "")
            if not text:
                return self._json(400, {"error": "missing 'text'"})
            if len(text) > self.MAX_TTS_CHARS:
                return self._json(
                    400, {"error": f"text exceeds {self.MAX_TTS_CHARS} chars"})
            try:
                steps = int(req.get("steps", e.steps))
                scale = float(req.get("cfg_scale", e.cfg_scale))
                seed = req.get("seed")
                seed = None if seed is None else int(seed)
            except (TypeError, ValueError):
                return self._json(
                    400, {"error": "steps/cfg_scale/seed must be numeric"})
            steps, scale = clamp_ode(steps, scale)
            group = ("tts", steps, scale)
            seed = engine.next_seed(seed)
            t0 = time.monotonic()
            chunks = engine.inf.split_chunks(text)
            if req.get("stream"):
                return self._stream_tts(group, chunks, seed, t0)
            if len(chunks) == 1:
                wav = batcher.submit(group, (text, seed)).result()
            else:
                # every chunk rides the same group as short requests, so
                # a long text's chunks coalesce with each other and with
                # concurrent traffic
                futs = [batcher.submit(group, (c, s)) for c, s in zip(
                    chunks, chunk_seeds(seed, len(chunks)))]
                wav = np.clip(crossfade_concat(
                    [f.result() for f in futs],
                    crossfade_ms=e.crossfade_ms), -1, 1)
            data = wav_bytes(wav)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("X-ODE-Steps", str(steps))
            self.send_header("X-CFG-Scale", str(scale))
            self.end_headers()
            self.wfile.write(data)
            # after the body went out: a disconnect mid-write counts once,
            # as an error
            stats.record_request("tts", time.monotonic() - t0)

        def _stream_tts(self, group, chunks, seed, t0):
            """Chunked WAV: chunk 0 alone on the priority lane (the time to
            first audio is one small device call), then the remaining
            chunks together, crossfaded as they arrive."""
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-ODE-Steps", str(group[1]))
            self.send_header("X-CFG-Scale", str(group[2]))
            self.end_headers()
            seeds = chunk_seeds(seed, len(chunks))

            def chunk_wavs():
                yield batcher.submit(group, (chunks[0], seeds[0]),
                                     priority=True).result()
                futs = [batcher.submit(group, (c, s))
                        for c, s in zip(chunks[1:], seeds[1:])]
                for f in futs:
                    yield f.result()

            try:
                self._emit_chunk(streaming_wav_header())
                first = True
                for piece in crossfade_stream(chunk_wavs(),
                                              crossfade_ms=e.crossfade_ms):
                    if first:
                        # time to first audio: a latency, not a request
                        stats.record_latency("tts_stream_first_chunk",
                                             time.monotonic() - t0)
                        first = False
                    self._emit_chunk((np.clip(piece, -1, 1) * 32767)
                                     .astype("<i2").tobytes())
                self.wfile.write(b"0\r\n\r\n")
                stats.record_request("tts_stream", time.monotonic() - t0)
            except Exception as ex:
                # the headers are out: drop the connection (the client
                # sees a truncated stream) rather than corrupt the framing
                print(f"[serve] stream aborted: {ex!r}", file=sys.stderr)
                stats.record_request("tts_stream", 0.0, error=True)
                self.close_connection = True

        def _post_asr(self, body):
            t0 = time.monotonic()
            try:
                x = parse_wav(body)
            except (wave.Error, EOFError, ValueError, struct.error):
                return self._json(400, {"error": "body must be WAV"})
            try:
                seed = self._seed_param()
            except ValueError:
                return self._json(400, {"error": "seed must be an int"})
            if len(x) > self.MAX_ASR_SAMPLES:
                return self._json(413, {
                    "error": f"audio exceeds {self.MAX_ASR_SAMPLES // 16000} s"})
            seed = engine.next_seed(seed)
            if len(x) > engine.max_asr_samples:
                return self._post_asr_long(x, seed, t0)
            # both stages coalesce with concurrent /asr requests: the
            # frontend per wav bucket, the flow decode per steps group
            bucket, padded, n = engine.prep_asr(x)
            lat = batcher.submit(("fe", bucket), (padded, n)).result()
            text = batcher.submit(("asr", e.asr_steps), (lat, seed)).result()
            self._json(200, {"text": text})
            stats.record_request("asr", time.monotonic() - t0)

        def _post_asr_long(self, x, seed, t0):
            """Wavs past the largest bucket: split at low-energy points;
            every chunk's frontend and decode go through the same batcher
            groups as short requests. The chunk seeds are
            CALMInference.asr_long's, so the transcript is the library's."""
            chunks = [c for c in split_wav_for_asr(
                x, engine.max_asr_samples,
                search_samples=ASR_SEARCH_SAMPLES) if len(c)]
            fe = [batcher.submit(("fe", b), (p, n))
                  for b, p, n in map(engine.prep_asr, chunks)]
            dec = [batcher.submit(("asr", e.asr_steps), (f.result(), s))
                   for f, s in zip(fe, chunk_seeds(seed, len(chunks)))]
            texts = [d.result().strip() for d in dec]
            self._json(200, {"text": " ".join(t for t in texts if t),
                             "chunks": len(chunks)})
            stats.record_request("asr", time.monotonic() - t0)

        def _body_bytes(self, chunked):
            """The raw upload, piece by piece as it arrives."""
            if not chunked:
                n = int(self.headers.get("Content-Length", 0))
                if n > self.MAX_BODY_BYTES:
                    raise PayloadTooLarge("body too large")
                while n > 0:
                    d = self.rfile.read(min(n, 1 << 16))
                    if not d:
                        raise ValueError("truncated body")
                    n -= len(d)
                    yield d
                return
            total = 0
            while True:
                size_line = self.rfile.readline(66)
                if not size_line or not size_line.endswith(b"\n"):
                    raise ValueError("malformed chunked body")
                size = int(size_line.split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    # trailers, if any, end at the blank line
                    while self.rfile.readline(1026) not in (b"\r\n", b"\n",
                                                             b""):
                        pass
                    return
                total += size
                if total > self.MAX_BODY_BYTES:
                    raise PayloadTooLarge("body too large")
                left = size
                while left:
                    d = self.rfile.read(min(left, 1 << 16))
                    if not d:
                        raise ValueError("truncated chunked body")
                    left -= len(d)
                    yield d
                self.rfile.read(2)  # the chunk's closing CRLF

        def _post_asr_stream(self, chunked):
            """Transcribe as the upload arrives: the body decodes
            incrementally (WavStreamParser: strict 16 kHz PCM16), each
            low-energy cut fires as soon as its audio is in
            (split_wav_for_asr_stream, the offline splitter chunk for
            chunk), and every chunk's frontend and decode ride the same
            batcher groups as buffered /asr. Seeds as asr_stream: chunk i
            of many decodes with chunk_seed(seed, i), a single chunk with
            the seed itself, so the joined text is the buffered /asr's for
            the same seed. Finished transcripts go out when the next body
            piece arrives, and all of them at the end."""
            t0 = time.monotonic()
            try:
                seed = self._seed_param()
            except ValueError:
                return self._json_close(400, {"error": "seed must be an int"})
            seed = engine.next_seed(seed)
            parser = WavStreamParser()
            state = {"sent": False, "ttft": None, "samples": 0}
            pending = []  # [index, frontend future, seed, decode future]
            texts = []

            def emit(obj):
                if not state["sent"]:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    state["sent"] = True
                self._emit_chunk((json.dumps(obj) + "\n").encode())

            def pump(block):
                # submit the decode of every chunk whose frontend is done,
                # so in-flight chunks coalesce; emit in chunk order
                for ent in pending:
                    if ent[3] is None and ent[1].done():
                        ent[3] = batcher.submit(("asr", e.asr_steps),
                                                (ent[1].result(), ent[2]))
                while pending:
                    ent = pending[0]
                    if ent[3] is None:
                        if not block:
                            return
                        ent[3] = batcher.submit(("asr", e.asr_steps),
                                                (ent[1].result(), ent[2]))
                    if not (block or ent[3].done()):
                        return
                    text = ent[3].result().strip()
                    if state["ttft"] is None:
                        state["ttft"] = time.monotonic() - t0
                    texts.append(text)
                    emit({"chunk": ent[0], "text": text})
                    pending.pop(0)

            def pieces():
                for raw in self._body_bytes(chunked):
                    pump(block=False)
                    x = parser.feed(raw)
                    if len(x):
                        state["samples"] += len(x)
                        if state["samples"] > self.MAX_ASR_SAMPLES:
                            raise PayloadTooLarge(
                                f"audio exceeds "
                                f"{self.MAX_ASR_SAMPLES // 16000} s")
                        yield x

            i = 0
            try:
                for chunk, is_final in split_wav_for_asr_stream(
                        pieces(), engine.max_asr_samples,
                        search_samples=ASR_SEARCH_SAMPLES, tagged=True):
                    if len(chunk):
                        s = (seed if (is_final and i == 0)
                             else chunk_seed(seed, i))
                        b, p, n = engine.prep_asr(chunk)
                        pending.append([i, batcher.submit(("fe", b), (p, n)),
                                        s, None])
                        i += 1
                    pump(block=False)
                if i == 0 and not parser.in_data:
                    raise ValueError("body must be WAV")
                pump(block=True)
                emit({"done": True, "text": " ".join(t for t in texts if t),
                      "chunks": i})
                self.wfile.write(b"0\r\n\r\n")
            except Exception as ex:
                if not state["sent"]:
                    stats.record_request("asr_stream", 0.0, error=True)
                    # the body is part-read: close either way
                    code = 413 if isinstance(ex, PayloadTooLarge) else 400
                    return self._json_close(code, {"error": str(ex)})
                print(f"[serve] asr stream aborted: {ex!r}", file=sys.stderr)
                stats.record_request("asr_stream", 0.0, error=True)
                self.close_connection = True
                return
            if state["ttft"] is not None:
                # time to first transcript: a latency, not a request
                stats.record_latency("asr_stream_first_text", state["ttft"])
            stats.record_request("asr_stream", time.monotonic() - t0)

    return CALMServer(("0.0.0.0", args.port), Handler, engine, batcher,
                      stats)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Serve TTS and ASR over HTTP with the PyTorch port.")
    p.add_argument("--config", default="configs/calm.yaml")
    p.add_argument("--override", action="append", default=[],
                   help="dotted config override, e.g. model.vae_path=null")
    p.add_argument("--byte-tokenizer", action="store_true")
    p.add_argument("--components", default=None,
                   help="reference checkpoint directory: <component>.bin "
                        "files and the peft adapter_model.bin")
    p.add_argument("--port", type=int, default=8080,
                   help="0 binds a free port (printed on stdout)")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' only "
                        "when asked)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="coalesce up to N concurrent requests into one "
                        "batched device call (1 = no batching)")
    p.add_argument("--batch-window-ms", type=float, default=10.0,
                   help="how long an open batch waits for more requests")
    p.add_argument("--first-chunk-batch", type=int, default=0,
                   help="batch cap of the streaming first-chunk priority "
                        "lane; 0 = min(4, max-batch)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    srv = make_server(build_engine(args), args)
    e = srv.engine.cfg.evaluation
    # the line harnesses parse to find the port
    print(f"serving on :{srv.port} (tts steps={e.steps} cfg={e.cfg_scale})",
          flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

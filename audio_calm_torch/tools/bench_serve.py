"""Serving load benchmark: drive the port's HTTP server with concurrent
clients and report what users see (counterpart of scripts/bench_serve.py).

    python -m audio_calm_torch.tools.bench_serve --config configs/calm.yaml \\
        --byte-tokenizer [--device cpu] [--clients 8] [--requests 3] \\
        [--rounds 3] [--task tts|asr|stream|asr-stream] [--max-batch 8] \\
        [--batch-window-ms 10] [--components DIR] [--override K=V ...]
    python -m audio_calm_torch.tools.bench_serve --base http://localhost:8080

It spawns `python -m audio_calm_torch.serving.server --port 0` (on the
card unless --device says otherwise; the child imports only the port),
or reuses the server at --base, warms every batch size the clients can
coalesce into, then runs `--rounds` identical timed rounds of `--clients`
concurrent clients making `--requests` requests each and reports the
round with the least wall. The client is the standard library's HTTP
client, as in the JAX script. One JSON line on stdout per client count:
metric, clients, requests, wall_s, req_per_s, rtf_aggregate (seconds of
audio or of transcribed audio a wall second, over all clients),
audio_s_per_req, latency_p50_s / p95 / p99 (client-observed; a stream's
is the time to its first audio or transcript line) and mean_batch (the
round's coalesced batch size, from the server's /stats). The server's
cold start, the warm-up volleys, each round and /stats go to stderr.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave

import numpy as np


def percentile(sorted_xs, q):
    """The nearest-rank q-quantile of a sorted list."""
    i = min(len(sorted_xs) - 1, max(0, int(round(q * (len(sorted_xs) - 1)))))
    return sorted_xs[i]


def server_argv(args: argparse.Namespace) -> list:
    """The server's command-line arguments for this run."""
    argv = ["--config", args.config, "--port", "0",
            "--max-batch", str(args.max_batch),
            "--batch-window-ms", str(args.batch_window_ms)]
    if args.byte_tokenizer:
        argv.append("--byte-tokenizer")
    if args.device:
        argv += ["--device", args.device]
    if args.components:
        argv += ["--components", args.components]
    for ov in args.override:
        argv += ["--override", ov]
    return argv


def spawn_server(args: argparse.Namespace):
    """Start the port's server as a child process -> (base url, process,
    its log's path); the log is a file (an unread pipe would fill)."""
    cmd = [sys.executable, "-m", "audio_calm_torch.serving.server",
           *server_argv(args)]
    # the port's root on the child's path, whatever the working directory
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    fd, logpath = tempfile.mkstemp(prefix="bench_serve_", suffix=".log")
    log = os.fdopen(fd, "wb")
    t_spawn = time.monotonic()
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            env=env, start_new_session=True)
    log.close()
    deadline = time.monotonic() + args.startup_timeout
    port = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            sys.stderr.write(open(logpath).read())
            raise RuntimeError(f"the server exited rc={proc.returncode}")
        if port is None:
            m = re.search(rb"serving on :(\d+)", open(logpath, "rb").read())
            if m:
                port = int(m.group(1))
            else:
                time.sleep(0.5)
                continue
        try:
            with urllib.request.urlopen(
                    f"http://localhost:{port}/health", timeout=5) as r:
                if json.load(r)["status"] == "ok":
                    print(json.dumps({
                        "label": "server_cold_start",
                        "seconds": time.monotonic() - t_spawn,
                    }), file=sys.stderr, flush=True)
                    return f"http://localhost:{port}", proc, logpath
        except Exception:
            time.sleep(0.5)
    stop(proc)
    raise RuntimeError(f"server not healthy in {args.startup_timeout}s "
                       f"(log: {logpath})")


def stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def post_tts(base, text, seed, steps=None, timeout=1800):
    body = {"text": text, "seed": seed}
    if steps is not None:
        body["steps"] = steps
    req = urllib.request.Request(
        base + "/tts", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        data = r.read()
    dt = time.monotonic() - t0
    with wave.open(io.BytesIO(data)) as w:
        audio_s = w.getnframes() / w.getframerate()
    return dt, audio_s


def post_tts_stream(base, text, seed, steps=None, timeout=1800):
    """POST stream:true and read the chunked WAV as it arrives ->
    (ttfa_s, total_s, audio_s): the time to the first PCM byte after the
    44-byte header."""
    import http.client
    from urllib.parse import urlsplit

    u = urlsplit(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    body = {"text": text, "seed": seed, "stream": True}
    if steps is not None:
        body["steps"] = steps
    t0 = time.monotonic()
    conn.request("POST", "/tts", json.dumps(body),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    ttfa, n_bytes = None, 0
    while True:
        piece = r.read1(65536)  # what has arrived, without waiting for more
        if not piece:
            break
        n_bytes += len(piece)
        if ttfa is None and n_bytes > 44:
            ttfa = time.monotonic() - t0
    total = time.monotonic() - t0
    conn.close()
    return ttfa, total, max(0, n_bytes - 44) / 2 / 16000


def make_asr_wav(seconds=10.0, sr=16000):
    """A seeded sine + noise utterance as WAV bytes -> (bytes, seconds)."""
    t = np.arange(int(seconds * sr), dtype=np.float32) / sr
    x = 0.25 * np.sin(2 * np.pi * 440.0 * t)
    x += 0.05 * np.random.default_rng(0).standard_normal(x.shape
                                                         ).astype(np.float32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue(), seconds


def post_asr(base, wav_data, audio_s, seed, timeout=1800):
    req = urllib.request.Request(
        f"{base}/asr?seed={seed}", data=wav_data,
        headers={"Content-Type": "audio/wav"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        json.load(r)
    return time.monotonic() - t0, audio_s


def post_asr_stream(base, wav_data, audio_s, seed, timeout=1800):
    """A chunked upload to streaming /asr, the NDJSON transcript read as it
    arrives -> (ttft_s, audio_s): the time to the first transcript line."""
    import http.client
    from urllib.parse import urlsplit

    u = urlsplit(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    t0 = time.monotonic()
    conn.request(
        "POST", f"/asr?seed={seed}",
        body=(wav_data[i:i + 65536] for i in range(0, len(wav_data), 65536)),
        encode_chunked=True,
        headers={"Content-Type": "audio/wav",
                 "Transfer-Encoding": "chunked"})
    r = conn.getresponse()
    ttft, saw = None, b""
    while True:
        piece = r.read1(65536)
        if not piece:
            break
        saw += piece
        if ttft is None and b"\n" in saw:
            ttft = time.monotonic() - t0
    conn.close()
    if b'"done"' not in saw:
        raise RuntimeError("asr stream ended without a done line")
    return ttft, audio_s


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base", default=None,
                   help="reuse a running server instead of spawning one")
    p.add_argument("--config", default="configs/calm.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--components", default=None)
    p.add_argument("--byte-tokenizer", action="store_true")
    p.add_argument("--device", default=None,
                   help="the spawned server's device (default: the card)")
    p.add_argument("--clients", default="8",
                   help="concurrent clients; a comma list (e.g. 1,4,8,16) "
                        "sweeps counts against one warm server")
    p.add_argument("--requests", type=int, default=3,
                   help="timed requests per client")
    p.add_argument("--rounds", type=int, default=3,
                   help="identical timed rounds; the least wall is reported")
    p.add_argument("--task", choices=("tts", "asr", "stream", "asr-stream"),
                   default="tts",
                   help="stream: chunked /tts (latency = time to first "
                        "audio); asr-stream: chunked-upload /asr (latency = "
                        "time to first transcript; default 60 s of audio)")
    p.add_argument("--audio-seconds", type=float, default=None,
                   help="--task asr / asr-stream: the uploaded utterance's "
                        "length (default 10; asr-stream 60)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-window-ms", type=float, default=10.0)
    p.add_argument("--steps", type=int, default=None,
                   help="ODE steps per request (default: the config's)")
    p.add_argument("--text", default="The quick brown fox jumps over the "
                   "lazy dog near the riverbank at dawn.",
                   help="a short text (one chunk, through the batcher)")
    p.add_argument("--startup-timeout", type=float, default=1800)
    args = p.parse_args(argv)
    args.clients = [int(c) for c in str(args.clients).split(",")]
    return args


def request_fn(args: argparse.Namespace, base: str):
    """seed -> (latency s, audio s) of one request of the task."""
    if args.task == "asr":
        wav_data, wav_s = make_asr_wav(args.audio_seconds or 10.0)
        return lambda seed: post_asr(base, wav_data, wav_s, seed)
    if args.task == "asr-stream":
        wav_data, wav_s = make_asr_wav(args.audio_seconds or 60.0)
        return lambda seed: post_asr_stream(base, wav_data, wav_s, seed)
    if args.task == "stream":
        stream_text = (args.text + " ") * 6  # several chunks

        def do_req(seed):
            ttfa, _total, audio_s = post_tts_stream(base, stream_text, seed,
                                                    steps=args.steps)
            return ttfa, audio_s

        return do_req
    return lambda seed: post_tts(base, args.text, seed, steps=args.steps)


def log2(obj) -> None:
    print(json.dumps(obj), file=sys.stderr, flush=True)


def run_load(args: argparse.Namespace, base: str) -> list:
    """Warm-up volleys, then the timed rounds of every client count against
    the server at `base` -> the stdout lines."""
    do_req = request_fn(args, base)
    # warm-up: a volley of each power-of-two concurrency up to the largest
    # client count, so every batch size the rounds can coalesce into has
    # run once before them
    sizes = [1]
    while sizes[-1] < max(args.clients):
        sizes.append(min(sizes[-1] * 2, max(args.clients)))
    for size in sizes:
        t0 = time.monotonic()
        errs = []
        barrier = threading.Barrier(size)

        def warm(i):
            barrier.wait()
            try:
                do_req(seed=i)
            except Exception as ex:
                errs.append(str(ex))

        ths = [threading.Thread(target=warm, args=(i,)) for i in range(size)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        log2({"label": f"warmup_batch{size}_s",
              "seconds": time.monotonic() - t0, "errors": errs})

    def timed_round(n_clients):
        lat, audio, lock = [], [], threading.Lock()
        barrier = threading.Barrier(n_clients)
        errs = []

        def client(cid):
            barrier.wait()
            try:
                for r in range(args.requests):
                    dt, a_s = do_req(seed=1000 + cid * 97 + r)
                    with lock:
                        lat.append(dt)
                        audio.append(a_s)
            except Exception as ex:
                errs.append(ex)

        ths = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
        t0 = time.monotonic()
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        if errs:
            raise RuntimeError(f"{len(errs)} clients failed: {errs[0]!r}")
        return time.monotonic() - t0, lat, audio

    def get_stats():
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            return json.load(r)

    # batch groups are recorded under the engine's group kind: streamed
    # /tts chunks batch as "tts", streamed /asr decodes as "asr"
    hist_kind = {"stream": "tts", "asr-stream": "asr"}.get(args.task,
                                                           args.task)

    def task_hist(stats):
        return stats["batches"].get(hist_kind, {}).get("sizes", {})

    lines = []
    for n_clients in args.clients:
        best = None
        for rnd in range(args.rounds):
            # /stats is cumulative: the round's own histogram is the delta
            pre = task_hist(get_stats())
            wall, lat, audio = timed_round(n_clients)
            delta = {k: v - pre.get(k, 0)
                     for k, v in task_hist(get_stats()).items()
                     if v - pre.get(k, 0) > 0}
            log2({"label": f"clients{n_clients}_round{rnd}", "wall_s": wall,
                  "rtf_aggregate": sum(audio) / wall})
            if best is None or wall < best[0]:
                best = (wall, lat, audio, delta)
        wall, lat, audio, delta = best
        log2({"label": "server_stats", **get_stats()})
        calls = sum(delta.values())
        items = sum(int(k) * v for k, v in delta.items())
        s = sorted(lat)
        out = {
            "metric": f"serving_{args.task}_throughput",
            "clients": n_clients,
            "requests": len(lat),
            "wall_s": wall,
            "req_per_s": len(lat) / wall,
            "rtf_aggregate": sum(audio) / wall,
            "audio_s_per_req": sum(audio) / len(audio),
            "latency_p50_s": percentile(s, 0.5),
            "latency_p95_s": percentile(s, 0.95),
            "latency_p99_s": percentile(s, 0.99),
            "mean_batch": items / calls if calls else 0.0,
        }
        if args.task == "stream":
            out["latency_is_ttfa"] = True
        if args.task == "asr-stream":
            out["latency_is_ttft"] = True
        print(json.dumps(out), flush=True)
        lines.append(out)
    return lines


def main(argv=None) -> int:
    args = parse_args(argv)
    proc = None
    base = args.base
    if base is None:
        base, proc, logpath = spawn_server(args)
    try:
        run_load(args, base)
    finally:
        if proc is not None:
            stop(proc)
    if proc is not None:
        os.remove(logpath)  # kept only when the run fails
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's serving layer on the CPU: its copies of RequestBatcher,
ServingStats and WavStreamParser held to the cases of
tests/test_serving_batch.py and tests/test_asr_stream.py, and its HTTP
server (audio_calm_torch/serving/server.py) run in-process on port 0 with
one torch thread, the tiny YAML of tests/test_serve.py and fp32 compute,
held to the contracts of tests/test_serve.py: the endpoints, seed
determinism, concurrent requests coalescing into one batch, a stream
equal to its buffered request, the ODE ladder, 413 / 400 / 411. A served
response equals the library call (CALMInference + the renderer) with the
same seed and batch bit for bit. Across batch sizes the latents are equal
bit for bit (tests/test_torch_infer_long.py), but the CPU's convolutions of
the VAE decode sum in another order at B=1 than at B=2 or 4 (about 5e-7
in the mel), which the int16 wire format shows as 1 LSB on a fraction of
the samples: such audio is held within 1 LSB, the JAX package's own bound
for batched against solo rendering."""

import http.client
import io
import json
import os
import re
import selectors
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from audio_calm_torch.serving import server as tserver
from audio_calm_torch.serving.batcher import RequestBatcher
from audio_calm_torch.serving.frontend import encode_chunks
from audio_calm_torch.serving.stats import ServingStats
from audio_calm_torch.serving.wav_stream import WavStreamParser

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
  compute_dtype: bfloat16
"""
LONG_TEXT = ("The quick brown fox jumps over the lazy dog. " * 2
             + "Pack my box with five dozen jugs! The end.")
# three chunks: one group of 3 (padded to 4) buffered, 1 + 2 streamed
THREE_CHUNKS = ("The cat sat on the mat today. The dog ran far away from "
                "home! All done here now.")
WIN = 32 * 1024  # the largest wav bucket in samples


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# RequestBatcher (tests/test_serving_batch.py:44-181)
# ---------------------------------------------------------------------------
def _collecting_batcher(max_batch=8, window_ms=250.0, fail_key=None,
                        wrong_len_key=None):
    calls = []

    def run(key, items):
        calls.append((key, list(items)))
        if key == fail_key:
            raise RuntimeError("boom")
        if key == wrong_len_key:
            return items[:-1]
        return [f"{key}:{it}" for it in items]

    return RequestBatcher(run, max_batch=max_batch, window_ms=window_ms), calls


def test_batcher_coalesces_within_window():
    b, calls = _collecting_batcher()
    futs = [b.submit("k", i) for i in range(4)]
    assert [f.result(timeout=10) for f in futs] == [
        "k:0", "k:1", "k:2", "k:3"]
    b.close()
    assert len(calls) == 1 and len(calls[0][1]) == 4


def test_batcher_respects_max_batch():
    b, calls = _collecting_batcher(max_batch=2)
    futs = [b.submit("k", i) for i in range(5)]
    assert [f.result(timeout=10) for f in futs] == [f"k:{i}" for i in range(5)]
    b.close()
    assert [len(items) for _, items in calls] == [2, 2, 1]


def test_batcher_never_mixes_group_keys():
    b, calls = _collecting_batcher()
    futs = [b.submit(k, i) for i, k in enumerate("abab")]
    assert [f.result(timeout=10) for f in futs] == [
        "a:0", "b:1", "a:2", "b:3"]
    b.close()
    assert sorted((k, len(it)) for k, it in calls) == [("a", 2), ("b", 2)]


def test_batcher_error_fans_out_to_group_only():
    b, _ = _collecting_batcher(fail_key="bad")
    bad = [b.submit("bad", i) for i in range(2)]
    good = b.submit("good", 7)
    for f in bad:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=10)
    assert good.result(timeout=10) == "good:7"
    b.close()


def test_batcher_length_mismatch_fails_group():
    b, _ = _collecting_batcher(wrong_len_key="short")
    f = b.submit("short", 1)
    with pytest.raises(RuntimeError, match="results"):
        f.result(timeout=10)
    b.close()


def test_batcher_degenerates_to_serial_queue():
    b, calls = _collecting_batcher(max_batch=1, window_ms=0.0)
    futs = [b.submit("k", i) for i in range(3)]
    assert [f.result(timeout=10) for f in futs] == ["k:0", "k:1", "k:2"]
    b.close()
    assert [len(items) for _, items in calls] == [1, 1, 1]


def test_batcher_concurrent_submitters():
    b, calls = _collecting_batcher(window_ms=400.0)
    results = {}
    barrier = threading.Barrier(4)

    def client(i):
        barrier.wait()
        results[i] = b.submit("k", i).result(timeout=20)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert results == {i: f"k:{i}" for i in range(4)}
    b.close()
    assert len(calls) == 1


def test_batcher_close_rejects_new_work():
    b, _ = _collecting_batcher()
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("k", 1)


def test_batcher_priority_lane_caps_and_preempts():
    """A priority item submitted into a bulk backlog runs in a small batch
    ahead of the queued bulk work."""
    release = threading.Event()
    calls = []

    def run(key, items):
        calls.append((key, list(items)))
        if len(calls) == 1:
            release.wait(timeout=10)
        return [f"{key}:{it}" for it in items]

    b = RequestBatcher(run, max_batch=8, window_ms=5.0, priority_max_batch=2)
    first = b.submit("k", "warm")
    time.sleep(0.05)
    bulk = [b.submit("k", f"b{i}") for i in range(6)]
    prio = [b.submit("k", f"p{i}", priority=True) for i in range(3)]
    release.set()
    assert first.result(timeout=10) == "k:warm"
    for i, f in enumerate(prio):
        assert f.result(timeout=10) == f"k:p{i}"
    for i, f in enumerate(bulk):
        assert f.result(timeout=10) == f"k:b{i}"
    b.close()
    sizes = [(items[0][0], len(items)) for _, items in calls]
    assert sizes[0] == ("w", 1)
    assert sizes[1] == ("p", 2) and sizes[2] == ("p", 1), sizes
    assert all(kind == "b" for kind, _ in sizes[3:]), sizes


def test_batcher_priority_interrupts_open_window():
    order = []

    def run(key, items):
        order.append(list(items))
        return list(items)

    b = RequestBatcher(run, max_batch=8, window_ms=300.0)
    bulk = b.submit("k", "bulk")
    time.sleep(0.05)
    prio = b.submit("k", "prio", priority=True)
    assert prio.result(timeout=10) == "prio"
    assert bulk.result(timeout=10) == "bulk"
    b.close()
    assert order[0] == ["prio"], order


# ---------------------------------------------------------------------------
# ServingStats (tests/test_serving_batch.py:312-342, 503)
# ---------------------------------------------------------------------------
def test_serving_stats_snapshot():
    s = ServingStats(max_samples=16)
    for i in range(10):
        s.record_request("tts", 0.1 * (i + 1))
    s.record_request("tts", 0.0, error=True)
    s.record_group("tts", 4, 0.2)
    s.record_group("tts", 2, 0.1)
    s.record_group("asr", 1, 0.05)
    snap = s.snapshot()
    assert snap["requests"] == {"tts": 10}
    assert snap["errors"] == {"tts": 1}
    lat = snap["request_latency_s"]["tts"]
    assert lat["count"] == 10
    assert lat["p50"] == pytest.approx(0.5, abs=0.11)
    assert lat["p99"] == pytest.approx(1.0, abs=0.01)
    assert lat["mean"] == pytest.approx(0.55, abs=1e-6)
    b = snap["batches"]["tts"]
    assert b["sizes"] == {"2": 1, "4": 1}
    assert b["calls"] == 2 and b["mean_batch"] == 3.0
    assert snap["batches"]["asr"]["mean_batch"] == 1.0
    for i in range(100):
        s.record_request("asr", float(i))
    assert s.snapshot()["request_latency_s"]["asr"]["count"] == 16


def test_serving_stats_thread_safety():
    s = ServingStats()
    n_threads, per = 8, 200

    def worker(k):
        for i in range(per):
            s.record_request(f"kind{k % 2}", 0.01)
            s.record_group("tts", 1 + (i % 4), 0.01)

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    snap = s.snapshot()
    assert sum(snap["requests"].values()) == n_threads * per
    assert snap["batches"]["tts"]["calls"] == n_threads * per


def test_serving_stats_record_latency_counts_no_request():
    st = ServingStats()
    st.record_request("tts_stream", 1.0)
    st.record_latency("tts_stream_first_chunk", 0.25)
    snap = st.snapshot()
    assert snap["requests"] == {"tts_stream": 1}
    assert snap["request_latency_s"]["tts_stream_first_chunk"]["count"] == 1


# ---------------------------------------------------------------------------
# WavStreamParser (tests/test_asr_stream.py:173-268)
# ---------------------------------------------------------------------------
def _wav_bytes(x, sr=16000, channels=1):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.asarray(x) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _feed_in_slices(parser, data, rng):
    out, pos = [], 0
    while pos < len(data):
        n = int(rng.choice([1, 3, 7, 44, 100, 4096]))
        out.append(parser.feed(data[pos: pos + n]))
        pos += n
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def test_wav_stream_parser_roundtrip():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(12345) * 0.4).clip(-1, 1).astype(np.float32)
    data = _wav_bytes(x)
    got = _feed_in_slices(WavStreamParser(), data, rng)
    with wave.open(io.BytesIO(data), "rb") as w:
        stored = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    np.testing.assert_array_equal(got, stored.astype(np.float32) / 32768.0)
    assert got.shape == x.shape


def test_wav_stream_parser_unbounded_header_and_junk_chunk():
    rng = np.random.default_rng(4)
    pcm = (rng.standard_normal(5000) * 8000).astype(np.int16)
    hdr = (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
           + b"JUNK" + struct.pack("<I", 5) + b"abcde\x00"
           + b"data" + struct.pack("<I", 0xFFFFFFFF))
    p = WavStreamParser()
    got = _feed_in_slices(p, hdr + pcm.tobytes(), rng)
    assert p.in_data
    np.testing.assert_array_equal(got, pcm.astype(np.float32) / 32768.0)


def test_wav_stream_parser_stereo_mean_and_bounded_data():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((777, 2)).clip(-1, 1) * 0.3
    data = _wav_bytes(x.reshape(-1), channels=2) + b"LIST0000trailing"
    got = _feed_in_slices(WavStreamParser(), data, rng)
    want = ((x * 32767).astype(np.int16).astype(np.float32) / 32768.0
            ).mean(axis=1)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_wav_stream_parser_rejects_bad_streams():
    with pytest.raises(ValueError, match="RIFF"):
        WavStreamParser().feed(b"\x00" * 64)
    with pytest.raises(ValueError, match="16000 Hz"):
        WavStreamParser().feed(_wav_bytes(np.zeros(10), sr=22050))
    bad = (b"RIFF" + struct.pack("<I", 100) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 3, 1, 16000, 64000, 4, 32))
    with pytest.raises(ValueError, match="PCM"):
        WavStreamParser().feed(bad)
    bad8 = (b"RIFF" + struct.pack("<I", 100) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 16000, 1, 8))
    with pytest.raises(ValueError, match="16-bit"):
        WavStreamParser().feed(bad8)
    nofmt = b"RIFF" + struct.pack("<I", 100) + b"WAVEdata" + struct.pack(
        "<I", 4)
    with pytest.raises(ValueError, match="before fmt"):
        WavStreamParser().feed(nofmt + b"\x00" * 4)


# ---------------------------------------------------------------------------
# the HTTP server, in-process (tests/test_serve.py:98-565)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def server(tmp_path_factory):
    cfg = tmp_path_factory.mktemp("serve") / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    args = tserver.parse_args([
        "--config", str(cfg), "--byte-tokenizer", "--port", "0",
        "--device", "cpu", "--batch-window-ms", "100",
        # fp32: batched and solo rows are equal bit for bit
        "--override", "evaluation.compute_dtype=float32"])
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    srv = tserver.make_server(tserver.build_engine(args), args).start()
    yield srv
    srv.close()
    torch.set_num_threads(saved)


def _url(srv, path=""):
    return f"http://localhost:{srv.port}{path}"


def _post(srv, path, data, ctype="application/json", timeout=300):
    req = urllib.request.Request(_url(srv, path), data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read(), r.headers


def _tts(srv, payload):
    return _post(srv, "/tts", json.dumps(payload).encode())[0]


def _stats(srv):
    with urllib.request.urlopen(_url(srv, "/stats"), timeout=30) as r:
        return json.load(r)


def _multi_row(stats, kind):
    sizes = stats["batches"].get(kind, {}).get("sizes", {})
    return sum(n for s, n in sizes.items() if int(s) >= 2)


def _http_error(fn):
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn()
    return ei.value.code


def _noise_wav(n, seed, sr=16000):
    pcm = (np.clip(np.random.default_rng(seed).standard_normal(n) * 0.2, -1,
                   1) * 32767).astype(np.int16)
    return _wav_bytes(pcm.astype(np.float32) / 32767, sr)


def _tone_wav(freq, n=16000):
    t = np.arange(n, dtype=np.float32) / 16000
    return _wav_bytes(0.3 * np.sin(2 * np.pi * freq * t))


def test_health(server):
    with urllib.request.urlopen(_url(server, "/health"), timeout=10) as r:
        assert json.load(r) == {"status": "ok"}


def test_tts_roundtrip_long_text(server):
    data, headers = _post(server, "/tts", json.dumps(
        {"text": LONG_TEXT, "steps": 2, "cfg_scale": 1.5}).encode())
    assert headers["Content-Type"] == "audio/wav"
    with wave.open(io.BytesIO(data)) as w:
        assert w.getframerate() == 16000
        assert w.getnframes() > 32 * 1024  # more than one grid: chunks
    assert _http_error(lambda: _post(server, "/tts", b"{}")) == 400


def test_tts_long_form_chunks_coalesce_and_are_deterministic(server):
    before = _multi_row(_stats(server), "tts")
    p = {"text": THREE_CHUNKS, "steps": 2, "cfg_scale": 1.5, "seed": 31}
    a, b = _tts(server, p), _tts(server, p)
    assert a == b and len(a) > 44
    assert _multi_row(_stats(server), "tts") > before


def _pcm(data):
    with wave.open(io.BytesIO(data)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def test_tts_matches_the_library(server):
    """A served single-chunk /tts is CALMInference.tts + the renderer with
    the same seed; a long-form one is tts_long_batched's chunks, seeds and
    crossfade (one group of 3 in both; the server clips each chunk, a
    no-op at these amplitudes)."""
    eng = server.engine
    kw = dict(steps=2, cfg_scale=1.5, method=eng.cfg.evaluation.ode_method)
    served = _pcm(_tts(server, {"text": "hello there", "seed": 123,
                                "steps": 2, "cfg_scale": 1.5}))
    with torch.inference_mode():
        lat, n = eng.inf.tts("hello there", 123, pad_to_grid=True, **kw)
        wav = np.clip(eng.render(lat, n), -1, 1)
        long_wav = np.clip(eng.inf.tts_long_batched(
            THREE_CHUNKS, 9, eng.render, **kw), -1, 1)
    np.testing.assert_array_equal(served, _pcm(tserver.wav_bytes(wav)))
    served = _pcm(_tts(server, {"text": THREE_CHUNKS, "seed": 9, "steps": 2,
                                "cfg_scale": 1.5}))
    assert len(eng.inf.split_chunks(THREE_CHUNKS)) == 3
    assert np.abs(long_wav).max() < 1
    np.testing.assert_array_equal(served, _pcm(tserver.wav_bytes(long_wav)))


def _within_one_lsb(a, b):
    assert a.shape == b.shape
    assert np.abs(a.astype(np.int32) - b).max() <= 1


def test_tts_streaming_equals_buffered(server):
    """stream: true -> chunked audio/wav, the header first with the
    unknown-length sentinels; its PCM is the buffered response's (chunk 0
    rendered alone, then 2 together, against 3 together: within 1 LSB)."""
    payload = {"text": THREE_CHUNKS, "steps": 2, "cfg_scale": 1.5,
               "seed": 17}
    conn = http.client.HTTPConnection("localhost", server.port, timeout=300)
    conn.request("POST", "/tts", body=json.dumps(dict(payload, stream=True)),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.headers["Transfer-Encoding"] == "chunked"
    assert resp.headers["Content-Type"] == "audio/wav"
    data = resp.read()
    conn.close()
    assert data[:44] == tserver.streaming_wav_header()
    stream = np.frombuffer(data[44:], "<i2")
    buffered = _pcm(_tts(server, payload))
    assert len(buffered) > 32 * 1024
    _within_one_lsb(stream, buffered)


def test_tts_seed_is_deterministic(server):
    p = {"text": "hello there", "steps": 2, "cfg_scale": 1.5, "seed": 123}
    a, b = _tts(server, p), _tts(server, p)
    assert a == b and len(a) > 44
    assert _tts(server, dict(p, seed=124)) != a


def test_tts_concurrent_requests_batch_safely(server):
    """Concurrent short /tts requests coalesce into one batched device
    call and each returns its solo audio (within 1 LSB: rendered at B=4
    against B=1); the same three again, in the same group, return equal
    bytes."""
    texts = [("hello there", 123), ("good day", 7), ("cats and dogs", 9)]
    solo = {t: _tts(server, {"text": t[0], "steps": 2, "cfg_scale": 1.5,
                             "seed": t[1]}) for t in texts}

    def concurrently():
        out = {}
        barrier = threading.Barrier(len(texts))

        def client(text, seed):
            barrier.wait()
            out[(text, seed)] = _tts(server, {"text": text, "steps": 2,
                                              "cfg_scale": 1.5, "seed": seed})

        threads = [threading.Thread(target=client, args=t) for t in texts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        return out

    def groups_of_three():
        return _stats(server)["batches"]["tts"]["sizes"].get("3", 0)

    before = groups_of_three()
    first = concurrently()
    mid = groups_of_three()
    second = concurrently()
    assert set(first) == set(second) == set(solo)
    for t in texts:
        _within_one_lsb(_pcm(first[t]), _pcm(solo[t]))
        _within_one_lsb(_pcm(second[t]), _pcm(solo[t]))
    assert _multi_row(_stats(server), "tts") > 0  # they coalesced
    if mid - before == 1 and groups_of_three() - mid == 1:
        assert first == second  # one group of 3 both times


def test_asr_accepts_wav(server):
    out = json.loads(_post(server, "/asr", _tone_wav(440), "audio/wav")[0])
    assert isinstance(out["text"], str)


def test_asr_long_wav_matches_the_library(server):
    """A wav past the largest bucket takes the long-form path: several
    chunks, deterministic for a seed, and the library's asr_long with the
    server's frontend and the same seed."""
    body = _noise_wav(3 * WIN, 5)
    out1 = json.loads(_post(server, "/asr?seed=7", body, "audio/wav")[0])
    out2 = json.loads(_post(server, "/asr?seed=7", body, "audio/wav")[0])
    assert out1["chunks"] >= 2 and out1 == out2
    eng = server.engine
    e = eng.cfg.evaluation
    with torch.inference_mode():
        text = eng.inf.asr_long(
            tserver.parse_wav(body), 7,
            lambda c: encode_chunks(eng.prep_asr, eng.asr_frontend_batch, c),
            eng.max_asr_samples, steps=e.asr_steps, cfg_scale=e.asr_cfg_scale,
            method=e.ode_method)
    assert out1["text"] == text


def test_asr_concurrent_requests_batch_safely(server):
    freqs = (220, 440, 660)

    def asr(f):
        return json.loads(_post(server, f"/asr?seed={f}", _tone_wav(f),
                                "audio/wav")[0])["text"]

    solos = {f: asr(f) for f in freqs}
    out = {}
    barrier = threading.Barrier(len(freqs))

    def client(f):
        barrier.wait()
        out[f] = asr(f)

    threads = [threading.Thread(target=client, args=(f,)) for f in freqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert out == solos


def test_asr_streaming_upload_matches_buffered(server):
    """A chunked upload streams NDJSON, one line per decode chunk in
    order, then a done line whose text is the buffered /asr's."""
    body = _noise_wav(3 * WIN, 5)
    ref = json.loads(_post(server, "/asr?seed=7", body, "audio/wav")[0])
    conn = http.client.HTTPConnection("localhost", server.port, timeout=300)
    conn.request("POST", "/asr?seed=7",
                 body=(body[o:o + 9973] for o in range(0, len(body), 9973)),
                 encode_chunked=True,
                 headers={"Content-Type": "audio/wav",
                          "Transfer-Encoding": "chunked"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.headers["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(x) for x in resp.read().decode().splitlines()]
    conn.close()
    done = lines[-1]
    assert done["done"] is True and done["chunks"] == ref["chunks"] >= 2
    assert [x["chunk"] for x in lines[:-1]] == list(range(done["chunks"]))
    assert " ".join(t for t in (x["text"] for x in lines[:-1]) if t) == \
        done["text"] == ref["text"]


def test_asr_stream_flag_single_chunk_matches_buffered(server):
    body = _tone_wav(330)
    ref = json.loads(_post(server, "/asr?seed=3", body, "audio/wav")[0])
    data, headers = _post(server, "/asr?stream=1&seed=3", body, "audio/wav")
    assert headers["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(x) for x in data.decode().splitlines()]
    assert lines == [{"chunk": 0, "text": ref["text"]},
                     {"done": True, "text": ref["text"], "chunks": 1}]


def test_asr_streaming_emits_mid_upload(server):
    """A transcript line reaches the client before the upload ends."""
    body = _noise_wav(WIN + 8192, 11)
    s = socket.create_connection(("localhost", server.port), timeout=300)

    def send_chunk(data):
        s.sendall(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    s.sendall(b"POST /asr?seed=2 HTTP/1.1\r\nHost: localhost\r\n"
              b"Transfer-Encoding: chunked\r\nContent-Type: audio/wav\r\n\r\n")
    send_chunk(body)
    s.settimeout(0.25)
    silence = np.zeros(1600, np.int16).tobytes()
    got = b""
    deadline = time.time() + 120
    while b'"text"' not in got and time.time() < deadline:
        send_chunk(silence)
        try:
            got += s.recv(65536)
        except socket.timeout:
            pass
    assert b'"text"' in got, "no transcript arrived before the upload ended"
    s.sendall(b"0\r\n\r\n")
    s.settimeout(300)
    while b'"done"' not in got:
        d = s.recv(65536)
        assert d, "connection closed before the done line"
        got += d
    s.close()
    assert got.startswith(b"HTTP/1.1 200")


def test_asr_stream_rejects_bad_input(server):
    for body in (b"definitely not a RIFF stream",
                 _wav_bytes(np.zeros(8000), sr=8000)):
        assert _http_error(lambda: _post(server, "/asr?stream=1", body,
                                         "audio/wav")) == 400
    assert _http_error(lambda: _post(server, "/asr", b"not a wav",
                                     "audio/wav")) == 400
    assert _http_error(lambda: _post(server, "/asr?seed=x", _tone_wav(220),
                                     "audio/wav")) == 400


def test_stats_endpoint(server):
    _tts(server, {"text": "hi", "steps": 2, "cfg_scale": 1.5, "seed": 1})
    _post(server, "/asr?seed=1", _tone_wav(220), "audio/wav")
    conn = http.client.HTTPConnection("localhost", server.port, timeout=300)
    conn.request("POST", "/tts", body=json.dumps(
        {"text": "hi", "steps": 2, "cfg_scale": 1.5, "stream": True}),
        headers={"Content-Type": "application/json"})
    conn.getresponse().read()
    conn.close()
    s = _stats(server)
    assert s["uptime_s"] > 0
    for kind in ("tts", "asr", "tts_stream"):
        assert s["requests"].get(kind, 0) >= 1
    assert "tts_stream_first_chunk" in s["request_latency_s"]
    for kind in ("tts", "asr"):
        lat = s["request_latency_s"][kind]
        assert lat["count"] == s["requests"][kind]
        assert 0 < lat["p50"] <= lat["p99"]
    asr = s["batches"]["asr"]
    assert sum(int(k) * v for k, v in asr["sizes"].items()) >= \
        s["requests"]["asr"]
    assert asr["mean_batch"] >= 1.0


def test_tts_ode_params_quantize_to_ladder(server):
    _, headers = _post(server, "/tts", json.dumps(
        {"text": "hi", "steps": 3, "cfg_scale": 1.49, "seed": 5}).encode())
    assert headers["X-ODE-Steps"] in ("2", "4")
    assert headers["X-CFG-Scale"] == "1.5"


def test_tts_rejects_non_numeric_params(server):
    for payload in ({"text": "hi", "seed": "abc"},
                    {"text": "hi", "steps": "lots"}):
        assert _http_error(lambda: _tts(server, payload)) == 400


def test_request_guards(server):
    """An oversized body is refused on its Content-Length alone (413, or
    the connection drops while the body is not sent); oversized text is a
    400."""
    req = urllib.request.Request(
        _url(server, "/tts"), data=b"{}",
        headers={"Content-Type": "application/json",
                 "Content-Length": str(100 * 1024 * 1024)})
    try:
        urllib.request.urlopen(req, timeout=60)
        raise AssertionError("expected rejection")
    except urllib.error.HTTPError as ex:
        assert ex.code == 413
    except (urllib.error.URLError, ConnectionError, TimeoutError):
        pass
    assert _http_error(lambda: _tts(server, {"text": "a" * 30_000})) == 400


def test_early_error_closes_partial_body_connection(server):
    """An error sent before the body was read closes the connection, so
    the unread body is never parsed as a second request."""
    s = socket.create_connection(("localhost", server.port), timeout=60)
    body = b'{"text": "hello"}'
    s.sendall(b"POST /tts HTTP/1.1\r\nHost: localhost\r\n"
              b"Transfer-Encoding: chunked\r\n"
              b"Content-Type: application/json\r\n\r\n"
              + f"{len(body):x}\r\n".encode() + body + b"\r\n0\r\n\r\n")
    got = b""
    while b"\r\n\r\n" not in got:
        d = s.recv(65536)
        assert d, "no response"
        got += d
    assert got.startswith(b"HTTP/1.1 411"), got[:40]
    s.settimeout(10)
    while True:
        d = s.recv(65536)
        if not d:
            break
        got += d
    s.close()
    assert got.count(b"HTTP/1.1") == 1, got


def test_engine_refuses_what_it_cannot_build(tmp_path, monkeypatch):
    """A model.vae_path or --components that does not exist raises (no
    random weights in its place), so does an orbax VAE directory; no
    tokenizer raises, and with no card the default device raises."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    base = ["--config", str(cfg), "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="does not exist"):
        tserver.build_engine(tserver.parse_args(
            base + ["--byte-tokenizer", "--override", "model.vae_path=x"]))
    with pytest.raises(ValueError, match="orbax"):
        tserver.build_engine(tserver.parse_args(
            base + ["--byte-tokenizer", "--override",
                    f"model.vae_path={tmp_path}"]))
    with pytest.raises(FileNotFoundError, match="--components"):
        tserver.build_engine(tserver.parse_args(
            base + ["--byte-tokenizer", "--components",
                    str(tmp_path / "missing")]))
    with pytest.raises(ValueError, match="byte-tokenizer"):
        tserver.build_engine(tserver.parse_args(base))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserver.build_engine(tserver.parse_args(
            ["--config", str(cfg), "--byte-tokenizer"]))


def test_server_serves_checkpoint_weights_as_jax_loads_them(tmp_path):
    """The tiny-YAML server started with --components and a .bin
    model.vae_path (files JAX's save_reference_checkpoint wrote): its model
    equals, bit for bit, the one from_jax_params makes of JAX's
    soft_restart tree (on the server's own seeded base), and a seeded /tts
    returns the bytes that an engine built on that model and on JAX's
    conversion of vae.bin serves."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from audio_calm_torch.config import CALMConfig, VAEModelConfig, load_config
    from audio_calm_torch.data.tokenizer import load_tokenizer
    from audio_calm_torch.models import convert as TC
    from audio_calm_torch.models.calm import QwenCALM as TQwenCALM
    from audio_calm_torch.models.flagship import build_random
    from audio_calm_torch.models.vae import AcousticVAE as TVAE
    from audio_calm_tpu.config import CALMModelConfig, from_dict
    from audio_calm_tpu.config import VAEModelConfig as JVAEConfig
    from audio_calm_tpu.models import convert as JC
    from audio_calm_tpu.models.calm import QwenCALM, init_calm_params
    from audio_calm_tpu.models.convert_export import save_reference_checkpoint
    from audio_calm_tpu.models.vae import AcousticVAE
    from audio_calm_tpu.train.checkpoint import COMPONENTS, soft_restart

    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(TINY_YAML)
    overrides = ["evaluation.compute_dtype=float32"]
    cfg = load_config(str(yaml), cls=CALMConfig, overrides=overrides)
    jmodel = QwenCALM(from_dict(CALMModelConfig,
                                dataclasses.asdict(cfg.model)))
    rng = np.random.default_rng(0)

    def draw(shapes):
        return jax.tree_util.tree_map(
            lambda leaf: (0.05 * rng.standard_normal(leaf.shape)).astype(
                np.float32), shapes)

    trained = draw(jax.eval_shape(lambda: init_calm_params(
        jmodel, jax.random.PRNGKey(0))))
    vae_params = draw(jax.eval_shape(lambda: AcousticVAE(JVAEConfig(
        latent_channels=8)).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, 80)), train=False))["params"])
    ckpt = tmp_path / "ckpt"
    save_reference_checkpoint(trained, str(ckpt), vae_params)

    args = tserver.parse_args([
        "--config", str(yaml), "--byte-tokenizer", "--port", "0",
        "--device", "cpu", "--components", str(ckpt), "--override",
        f"model.vae_path={ckpt / 'vae.bin'}", "--override", overrides[0]])
    base = build_random(lambda: TQwenCALM(cfg.model), "cpu", seed=0)
    jtree = soft_restart(TC.to_jax_params(base.state_dict()),
                         {c: str(ckpt) for c in COMPONENTS + ("lora",)})
    ref_model = TQwenCALM(cfg.model)
    TC.load_calm(ref_model, jtree)
    ref_vae = TVAE(VAEModelConfig(latent_channels=8))
    TC.load_vae(ref_vae, JC.convert_vae_params(JC.load_torch_state_dict(
        str(ckpt / "vae.bin"))))
    ref_engine = tserver.make_engine(
        cfg, ref_model.eval().requires_grad_(False),
        ref_vae.eval().requires_grad_(False),
        load_tokenizer(cfg.model, byte_fallback=True), torch.device("cpu"))

    served = []
    for engine in (tserver.build_engine(args), ref_engine):
        srv = tserver.make_server(engine, args).start()
        try:
            served.append(_tts(srv, {"text": "from trained weights",
                                     "seed": 5, "steps": 2}))
        finally:
            srv.close()
        if engine is not ref_engine:
            got = engine.inf.model.state_dict()
            want = ref_model.state_dict()
            assert set(got) == set(want)
            for k in got:
                assert torch.equal(got[k], want[k]), k
            assert torch.equal(got["soa_embed"], torch.from_numpy(
                trained["soa_embed"]))
    assert served[0][:4] == b"RIFF" and len(served[0]) > 44
    assert served[0] == served[1]


def test_main_serves_on_the_printed_port(tmp_path):
    """`python -m audio_calm_torch.serving.server` prints `serving on
    :<port>` (the line harnesses parse) and answers there."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(tserver.__file__))))
    proc = subprocess.Popen(
        [sys.executable, "-m", "audio_calm_torch.serving.server", "--config",
         str(cfg), "--byte-tokenizer", "--device", "cpu", "--port", "0"],
        cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        assert sel.select(timeout=120), "no line on stdout"
        m = re.match(r"serving on :(\d+)", proc.stdout.readline())
        assert m
        with urllib.request.urlopen(f"http://localhost:{m[1]}/health",
                                    timeout=30) as r:
            assert json.load(r) == {"status": "ok"}
    finally:
        proc.terminate()
        proc.wait(timeout=30)

"""The traffic generator: the same seed gives the same requests, every
seed the same work in another order, and the end-to-end readers keep to
the window and to the due times."""

import json
import math

from benchmark.harness import client, manifest, traffic
from benchmark.harness.client import Sent
from benchmark.harness.record import RunRecord
from benchmark.harness.serve import Recorder
from benchmark.reference.tts import chunks


def _mix(name):
    return json.loads((manifest.BENCH / "traffic" / f"{name}.json")
                      .read_text())


def test_same_seed_same_requests():
    for mix in ("tts-closed-96", "tts-poisson-knee"):
        a = traffic.requests(_mix(mix), 4294967311, 20)
        b = traffic.requests(_mix(mix), 4294967311, 20)
        assert [(r.text, r.seed, r.due) for r in a] == \
            [(r.text, r.seed, r.due) for r in b]
        c = traffic.requests(_mix(mix), 4294967312, 20)
        assert [r.text for r in a] != [r.text for r in c]


def test_every_seed_the_same_work():
    conf = manifest.cell(manifest.load(), "tts-flagship-batch")["config"]
    for name in ("tts-closed-96", "tts-poisson-knee"):
        mix = _mix(name)
        runs = [traffic.requests(mix, s, 20) for s in (1, 2 ** 31 + 5)]
        lengths = [sorted(len(r.text) for r in rs) for rs in runs]
        assert lengths[0] == lengths[1]
        rows = [sorted(len(chunks(conf, r.text)) for r in rs) for rs in runs]
        assert rows[0] == rows[1]
        c = mix["text_chars"]
        assert all(c["min"] <= n <= c["max"] for n in lengths[0])


def test_open_loop_schedule():
    mix = dict(_mix("tts-poisson-knee"), rate_per_s=20.0)
    rs = traffic.requests(mix, 99, 10.0)
    due = [r.due for r in rs]
    assert due[0] == 0.0 and all(0 <= d < 10.0 for d in due)
    assert 190 <= len(rs) <= 200
    gaps = sorted(b - a for a, b in zip(due, due[1:]))
    assert abs(sum(gaps) / len(gaps) - 1 / 20.0) < 0.01


def test_text_lengths_are_quantiles():
    mix = _mix("tts-closed-96")
    ls = traffic.text_lengths(mix, 1001)
    assert ls == sorted(ls)
    assert ls[500] == mix["text_chars"]["median"]


def _run(sent, mix, seconds=10.0):
    return RunRecord({}, mix, "cpu", 100.0, 100.0 + seconds, sent,
                     Recorder())


def _sent(due, done, status=200, audio_s=1.0, sent=None):
    req = traffic.Request(0, "x.", 1)
    s = Sent(req, due=due, sent=due if sent is None else sent, done=done,
             status=status, body=b"\0" * (44 + int(audio_s * 32000)))
    return s


def test_latency_counts_from_due_time_and_failures():
    read = manifest.metric_module("latency_p95_s").read
    mix = {"drain_s": 60}
    # sent late by the generator: the wait before the send counts
    sent = [_sent(100.0 + i * 0.1, 100.0 + i * 0.1 + 0.5, sent=100.0 + i * 0.1
                  + 0.3) for i in range(99)]
    sent.append(_sent(109.95, 111.0))
    assert abs(read(_run(sent, mix)) - 0.5) < 1e-9
    # requests due outside the window are not counted
    extra = [_sent(95.0, 200.0), _sent(110.0, 200.0)]
    assert abs(read(_run(sent + extra, mix)) - 0.5) < 1e-9
    # more than 5% failed: the tail is a failure, reported as its bound
    bad = [_sent(100.0 + i * 0.1, 0.0, status=500) for i in range(10)]
    assert read(_run(sent[:90] + bad, mix)) == 10.0 + 60
    assert client.percentile([1.0, math.inf], 0.95) == math.inf


def test_audio_rate_keeps_to_the_window():
    read = manifest.metric_module("audio_s_per_s").read
    sent = [_sent(100.0, 105.0, audio_s=2.0), _sent(100.0, 110.0, audio_s=3.0),
            _sent(100.0, 110.5, audio_s=7.0), _sent(100.0, 101.0, 500, 5.0)]
    assert abs(read(_run(sent, {})) - 0.5) < 1e-9

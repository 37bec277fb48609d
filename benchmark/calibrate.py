#!/usr/bin/env python3
"""Readings that set the benchmark's numbers, several runs in one process
on the card (the kernels load once):

    python3 benchmark/calibrate.py --config calm-serve \
        --traffic tts-poisson-knee [--set rate_per_s=12] --seeds 1,2,3 \
        --seconds 6 [--control int8] [--no-check]

Each run is benchmark/run.py's run of the composed cell (the named
configuration under the named mix, mix keys overridden by --set); it
prints one JSON line: the seed, the check's numbers, the end-to-end
metrics, and the load's own counts (requests due and completed a second,
latency quantiles over the window and over each half of it, mean rows a
group). --control int8 serves the port's int8 LLM projections, the
control of the check's limits, and --control fp8 the reference in float8
in the served rows' place.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.harness import client, manifest  # noqa: E402


def compose(config: str, traffic: str, sets) -> dict:
    m = manifest.load()
    cell = manifest.cell(m, m["workloads"][0]["name"])
    conf = next(c for c in m["configs"] if c["name"] == config)
    cell["config"] = json.loads((manifest.ROOT / conf["file"]).read_text())
    mix = json.loads((manifest.BENCH / "traffic" / f"{traffic}.json")
                     .read_text())
    for kv in sets:
        k, v = kv.split("=", 1)
        mix[k] = json.loads(v)
    cell["mix"] = mix
    e2e = {"closed": ("audio_s_per_s", "audio_s/s"),
           "open": ("latency_p95_s", "s")}[mix["loop"]]
    cell["end_to_end"] = [{"name": e2e[0], "unit": e2e[1]},
                          {"name": "setup_s", "unit": "s"}]
    return cell


def load_stats(keep: dict, seconds: float) -> dict:
    sent, t0 = keep["sent"], keep["t0"]
    t1 = t0 + seconds
    due = [s for s in sent if t0 <= s.due < t1]
    ok = [s for s in due if s.ok]
    lat = [s.done - s.due for s in ok]
    half = t0 + seconds / 2
    first = [s.done - s.due for s in ok if s.due < half]
    second = [s.done - s.due for s in ok if s.due >= half]
    groups = [g for g in keep["groups"] if g.key == "tts"
              and t0 <= g.t1 <= t1]
    p = client.percentile
    return {
        "due_per_s": len(due) / seconds,
        "done_in_window_per_s": sum(1 for s in sent if s.ok
                                    and t0 <= s.done <= t1) / seconds,
        "failed": sum(1 for s in due if not s.ok),
        "lat_p50": p(lat, 0.5), "lat_p95": p(lat, 0.95),
        "lat_p99": p(lat, 0.99),
        "p50_first_half": p(first, 0.5), "p50_second_half": p(second, 0.5),
        "rows_per_group": (sum(g.rows for g in groups) / len(groups)
                           if groups else None),
        "groups": len(groups),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args(argv)
    cell = compose(args.config, args.traffic, args.set)
    for seed in (int(s) for s in args.seeds.split(",")):
        keep = {}
        out = run.run_cell("calibrate", seed, args.seconds, False, cell=cell,
                           control=args.control, check=not args.no_check,
                           keep=keep, log=lambda s: None)
        print(json.dumps({
            "seed": seed, "control": args.control, "set": args.set,
            "check": {k: v["value"] for k, v in out.get("check", {}).items()},
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "load": load_stats(keep, args.seconds),
            "memory_peak_bytes": out["device"]["memory_peak_bytes"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The benchmark of audio_calm_torch, the PyTorch / CUDA port, on one card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

One run: the cell's configuration (BENCHMARK.json -> benchmark/configs/)
built through the port's serving path in this process with weights drawn
on the card from --seed, every shape of the cell warmed, the cell's
traffic (benchmark/traffic/) driven over HTTP for --seconds, then the
served outputs checked against the plain reference (benchmark/reference/).
--trace 1 profiles a steady slice of the window (a slice that lost device
records is profiled again) and reports the per-layer metrics
(benchmark/metrics/) instead of the end-to-end ones.

The last line of stdout is one JSON object: correct, attempted, failed,
metrics, device (and with --trace 1 breakdown), and last `check`, each
compared number beside its limit; the same numbers are the last lines of
stderr. Without a CUDA card, or with fewer than the cell asks for, it
exits 2 and prints no result; if jax, jaxlib, flax or the JAX package is
loaded once the window has closed, it exits 3 and prints no result.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """Seconds on the boot clock at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.clock_gettime(time.CLOCK_BOOTTIME)


PROCESS_START = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the kernel caches at fixed paths inside the checkout (the port's own nvcc
# builds go to build/kernels/ beside its package)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "audio_calm_tpu")
TRACE_S = 6.0  # a profiled slice, from a fifth of the window on
TOP = 10


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _unclaimed(trace, modules) -> list:
    pats = [re.compile(k) for m in modules.values()
            for k in getattr(m, "KERNELS", ())]
    rows = {}
    for name, s, e in trace.kernels:
        if not any(p.search(name) for p in pats):
            rows[name] = rows.get(name, 0.0) + (
                min(e, trace.ns1) - max(s, trace.ns0)) * 1e-9
    return sorted(rows.items(), key=lambda kv: -kv[1])


def _breakdown(trace, spans) -> dict:
    ops = {}
    for name, s, e in trace.kernels:
        ops[name] = ops.get(name, 0.0) + (
            min(e, trace.ns1) - max(s, trace.ns0)) * 1e-9
    gaps = []
    for g0, g1 in trace.gaps():
        mid = (g0 + g1) // 2
        open_ = [sp for sp in spans if sp.ns0 <= mid <= sp.ns1]
        label = (min(open_, key=lambda sp: sp.ns1 - sp.ns0).name
                 if open_ else "no span (the worker waits)")
        gaps.append([label, (g1 - g0) * 1e-9])
    gaps.sort(key=lambda x: -x[1])
    return {"device_ops": sorted(([k[:200], v] for k, v in ops.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": gaps[:TOP]}


def _group_stats(record) -> dict:
    """The window's tts groups: how many, their host seconds (median and
    95th percentile) and the worker's mean idle between two of them."""
    from benchmark.harness.client import percentile
    gs = record.window_groups()
    secs = [g.t1 - g.t0 for g in gs]
    idle = [b.t0 - a.t1 for a, b in zip(gs, gs[1:])]
    return {"groups": len(gs), "group_s_p50": percentile(secs, 0.5),
            "group_s_p95": percentile(secs, 0.95),
            "idle_between_groups_s": sum(idle) / len(idle) if idle else None}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, cell=None, control=None, log=print,
             check: bool = True, keep=None) -> dict:
    """One run of a cell -> the result object. `device` None is the card;
    `cell` replaces the one BENCHMARK.json names. control="int8" serves
    the port's int8 LLM projections (its AUDIO_CALM_LLM_WEIGHTS=int8
    path), control="fp8" checks the reference in float8 in the served
    rows' place: the controls of the check's limits. check=False skips
    the reference, and `keep` (a dict) receives the requests and the
    recorded groups (benchmark/calibrate.py, the tests)."""
    import torch

    from benchmark.harness import client, manifest, serve
    from benchmark.harness.check import NAMES, run_check
    from benchmark.harness.record import RunRecord
    from benchmark.harness import trace as tracing
    from benchmark.harness.traffic import requests

    cell = cell or manifest.cell(manifest.load(), workload)
    conf, mix = cell["config"], cell["mix"]
    on_card = device is None
    device = torch.device("cuda" if on_card else device)
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    tmpdir = tempfile.mkdtemp(prefix="audio-calm-bench-")
    try:
        if on_card:
            from audio_calm_torch.ops import cuda_build
            cuda_build.build_all()
        engine, model = serve.build(conf, seed, device, tmpdir,
                                    "int8" if control == "int8" else None)
        rec = serve.Recorder()
        serve.instrument(engine, model, rec)
        shapes = serve.warm_up(engine, conf, mix)
        if trace and on_card:
            tracing.warm()
        srv = serve.serve(engine, mix)
        # the HTTP path once, outside the window
        client.drive(srv.port, {**mix, "loop": "open"},
                     [requests(mix, seed + 1, 1.0)[0]],
                     time.perf_counter(), 0.0, 600.0)
        reqs = requests(mix, seed, seconds)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        rec.active = True
        t0 = time.perf_counter() + 0.05
        setup_s = t0 - time.perf_counter() + \
            time.clock_gettime(time.CLOCK_BOOTTIME) - PROCESS_START
        load, box = client.drive_in_thread(srv.port, mix, reqs, t0, seconds,
                                           float(mix["drain_s"]))
        tr = None
        if trace and on_card:
            span = min(TRACE_S, seconds / 2.0)
            tr = tracing.whole_session(t0 + seconds / 5.0, t0 + seconds,
                                       span, log)
        load.join()
        sent = box[0]
        rec.active = False
        if keep is not None:
            keep.update(sent=sent, groups=rec.groups, t0=t0)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        srv.close()
        record = RunRecord(conf, mix, kind, t0, t0 + seconds, sent, rec, tr,
                           setup_s)
        log(json.dumps({"warmed_shapes": shapes, "setup_s": setup_s,
                        "requests": len(sent), **_group_stats(record)}))
        modules = manifest.all_metric_modules()
        wanted = cell["per_layer"] if trace else cell["end_to_end"]
        if trace and on_card and tr is None:
            log("no profiler session kept every device record: no metric "
                "is read from the trace")
        metrics = {}
        for m in wanted:
            v = modules[m["name"]].read(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
               "count": 1, "memory_peak_bytes": int(peak)}
        out = {"correct": False, "attempted": len(sent),
               "failed": sum(1 for s in sent if not s.ok),
               "metrics": metrics, "device": dev}
        if trace and record.trace is not None:
            dev["busy_s"] = record.trace.busy_s()
            dev["window_s"] = record.trace.window_s
            out["breakdown"] = _breakdown(record.trace, rec.spans)
            log(json.dumps({"unclaimed_kernel_s": _unclaimed(
                record.trace, modules)[:40]}))
        late = [s.sent - s.due for s in sent if s.sent]
        if mix["loop"] == "open" and late:
            log(json.dumps({"generator_late_s": {
                "mean": sum(late) / len(late), "max": max(late)}}))
        # the program's state goes before the reference runs
        rows = rec.rows
        del engine, model, srv, record, tr
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        limits = conf["check"]["limits"]
        if not check:
            return out
        got, notes = run_check(conf, sent, rows, seed, device,
                               int(conf["check"]["sample"]),
                               "fp8" if control == "fp8" else None)
        for n in notes:
            log(n)
        ok = out["failed"] == 0 and all(
            limits.get(k) is not None and got[k] <= limits[k] for k in NAMES)
        out["correct"] = bool(ok)
        out["check"] = {k: {"value": _finite(got[k]), "limit": limits.get(k)}
                        for k in NAMES}
        out["check"]["failed_requests"] = {"value": out["failed"],
                                           "limit": 0}
        return out
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _finite(x: float):
    return x if math.isfinite(x) else "inf"


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from benchmark.harness import manifest

    cell = manifest.cell(manifest.load(), args.workload)
    chips = int(cell["workload"]["chips"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"needs {chips} CUDA card(s); this machine has {cards}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   cell=cell, log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

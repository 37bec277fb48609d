"""BENCHMARK.json and the files it names, found by name:
benchmark/configs/<config>.json, benchmark/traffic/<traffic>.json and
benchmark/metrics/<metric>.py (a module with `read(run)` and `KERNELS`)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_module(name: str) -> ModuleType:
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def all_metric_modules() -> Dict[str, ModuleType]:
    return {p.stem: metric_module(p.stem)
            for p in sorted((BENCH / "metrics").glob("*.py"))}


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(manifest: dict, name: str) -> dict:
    """A workload's entry with its configuration, mix and metrics."""
    w = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in manifest["configs"] if c["name"] == w["config"])
    return {
        "workload": w,
        "config": _read_json(ROOT / c["file"]),
        "mix": _read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        "end_to_end": [m for m in manifest["end_to_end"]
                       if _reported(m, name)],
        "per_layer": [m for m in manifest["per_layer"]
                      if _reported(m, name)],
    }


def names(metrics: List[dict]) -> List[str]:
    return [m["name"] for m in metrics]

"""BENCHMARK.json keeps to the contract's names and shapes, and every cell
finds its configuration, mix and metric files by name."""

import json
import re

import pytest

from benchmark.harness import manifest
from benchmark.harness.check import NAMES

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.load()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51
    assert M["command"][:2] == ["python3", "benchmark/run.py"]
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            texts = [e[k] for k in ("why", "layer") if k in e]
            if group == "configs":
                texts.append(e["source"])
            for t in texts:
                assert 1 <= len(t) <= 200 and "\n" not in t
    assert len(set(n for _, n in names)) == len(names)
    metrics = [e["name"] for e in M["end_to_end"] + M["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_metric_fields():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in cells
            moved = next(x for x in M["end_to_end"] if x["name"] == m["moves"])
            assert w in moved.get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_resolves(cell):
    c = manifest.cell(M, cell)
    conf = c["config"]
    assert conf["name"] == c["workload"]["config"]
    assert c["mix"]["loop"] in ("open", "closed")
    assert c["workload"]["chips"] in (1, 4)
    names = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        mod = manifest.metric_module(m["name"])
        assert callable(mod.read)
        assert isinstance(mod.KERNELS, tuple)
    assert set(conf["check"]["limits"]) == set(NAMES)
    assert all(v is not None for v in conf["check"]["limits"].values())


def test_config_files_are_their_own():
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        assert c["file"].startswith("benchmark/")
        conf = json.loads((manifest.ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])

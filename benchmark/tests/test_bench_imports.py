"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program."""

import ast
import subprocess
import sys

from benchmark.harness import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "audio_calm_tpu"}
PROBE = r"""
import importlib.util, sys
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("bench_run", {run!r})
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
import benchmark.harness.check, benchmark.harness.client
import benchmark.harness.manifest as man, benchmark.harness.record
import benchmark.harness.serve, benchmark.harness.trace
import benchmark.harness.traffic, benchmark.work.tts, benchmark.work.peaks
man.all_metric_modules()
# what serve.build and run_cell import from the program
import audio_calm_torch.config, audio_calm_torch.data.tokenizer
import audio_calm_torch.models.calm, audio_calm_torch.models.flagship
import audio_calm_torch.models.quant, audio_calm_torch.models.vae
import audio_calm_torch.serving.server, audio_calm_torch.ops.cuda_build
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_no_jax_in_the_benchmark_process():
    root = str(manifest.ROOT)
    code = PROBE.format(root=root, run=str(manifest.BENCH / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "audio_calm_torch" in tops and "benchmark" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((manifest.BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & (FORBIDDEN | {"audio_calm_torch"}), (f, tops)

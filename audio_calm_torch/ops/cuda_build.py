"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for `sm_90a` into a shared library with a
plain C interface, at first use, into `build/kernels/` beside the package
(git-ignored), and loaded with ctypes. The library name carries a hash of
its source and of the shared headers (csrc/*.cuh), so an edited kernel is
rebuilt and a stale one never loads.
`build_all()` starts one nvcc per source at once and waits for all of them.
`load(name, defines)` builds a variant compiled with -D<define> (a probe
build, which no wrapper loads) under a name of its own.
`check` and `refuse_autograd` are the guards every kernel wrapper shares.
`counting_flops` / `tally` count the FLOPs of the kernel calls made while
a count is taken (utils/profiling.count_flops): a ctypes launch is
invisible to torch's FlopCounterMode, so each wrapper adds its plain
version's product count, worked out from the shapes, and runs that plain
version (the CPU route) hidden from the counter; the count is the same on
the card and on the CPU.

Nothing here runs at import: the CPU tests import every module, on machines
that have no CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import _disable_current_modes

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = ("vocoder_stage", "attention_fwd", "attention_bwd", "resblock",
           "gemm")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str, defines: Sequence[str] = ()) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    variant = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{variant}-{digest}.so"


def _start(name: str, defines: Sequence[str] = ()):
    out = _lib_path(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel -> {name: nvcc log}."""
    jobs = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (compiled with -D<d> for each of
    `defines`), built first if need be."""
    key = (name, tuple(defines))
    if key not in _loaded:
        _finish(name, _start(name, defines))
        _loaded[key] = ctypes.CDLL(str(_lib_path(name, defines)))
    return _loaded[key]


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def refuse_autograd(what: str, tensors: Iterable[Optional[torch.Tensor]],
                    route: Optional[str] = None) -> None:
    """A kernel fills its output through ctypes, which autograd cannot see:
    refuse inputs that would need a gradient while autograd records.
    `route` names the differentiable alternative, where there is one."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        alt = f", or use the differentiable route {route}" if route else ""
        raise RuntimeError(f"{what} on a CUDA tensor returns no gradient: "
                           f"call it under torch.no_grad(){alt}")


class FlopTally:
    """FLOPs of the kernel calls made while a count is taken."""
    active = False
    flops = 0.0


_TALLY = FlopTally()


@contextlib.contextmanager
def counting_flops():
    """Tally the kernel calls' FLOPs for the block (yields the tally);
    their plain versions run with the torch dispatch modes (a
    FlopCounterMode) disabled."""
    _TALLY.active, _TALLY.flops = True, 0.0
    try:
        yield _TALLY
    finally:
        _TALLY.active = False


def tally(flops: float):
    """Add a call's FLOPs to the tally while a count is taken -> the
    context its plain version runs in (hidden from the counter then)."""
    if not _TALLY.active:
        return contextlib.nullcontext()
    _TALLY.flops += flops
    return _disable_current_modes()

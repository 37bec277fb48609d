"""Where the bf16 stage kernel (K1, csrc/vocoder_stage.cu) waits, on one card.

    python -m audio_calm_torch.tools.vocoder_stage_probe [--out FILE]

At HiFi-GAN V1's three stages (B=2 on the 384-frame grid: C=128 grouped,
128 -> 64 and 64 -> 32 with the r=2 upsample; random weights from a seed)
it builds three variants of the kernel's library and times them under
torch.profiler, interleaved within one process (`ms`: the stage kernel's
own device time; `call_ms`: the device time of the whole wrapper call, the
weight packing included, as chip_smoke.py times it):
  - shipped: the library the wrapper loads;
  - probe (-DVOCODER_STAGE_PROBE): each warp also counts the clock cycles it
    waits for a ring stage to fill, against its cycles from the kernel's
    start to its end. The ratio is the ring's full-wait share, per warp index
    (summed over blocks) and over all warps;
  - no weights (-DVOCODER_STAGE_PROBE_NO_WEIGHTS): the ring completes each
    stage with no copy, so no weight byte is read (the output is wrong).
    Its time against the shipped time is the most that any cut of the
    weight traffic (a cluster multicast, for one) could save.
Prints the card's name and power limit, a line per stage and, last, one
JSON object, also written to FILE when given.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from audio_calm_torch.ops import vocoder_kernel as vk

V1_GEOM = ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5)))
# V1 stage index -> (C_in, C, T_in, upsample): the 384-frame grid's shapes
STAGES = {1: (128, 128, 98304, False), 2: (128, 64, 98304, True),
          3: (64, 32, 196608, True)}
VARIANTS = {"shipped": (), "probe": ("VOCODER_STAGE_PROBE",),
            "no_weights": ("VOCODER_STAGE_PROBE_NO_WEIGHTS",)}
MAX_WARPS = 12  # csrc/vocoder_stage.cu kMaxWarps


def stage_inputs(C_in, C, T_in, ups, device, seed):
    g = torch.Generator(device).manual_seed(seed)

    def w(*shape, scale):
        return scale * torch.randn(*shape, generator=g, device=device)

    x = torch.randn(2, T_in, C_in, generator=g, device=device)
    blocks = [(w(3, k, C, C, scale=0.01), w(3, C, scale=0.01),
               w(3, k, C, C, scale=0.01), w(3, C, scale=0.01), k, dils)
              for k, dils in V1_GEOM]
    if not ups:
        return x, None, None, blocks
    return x, w(4, C_in, C, scale=0.01), w(C, scale=0.01), blocks


@contextlib.contextmanager
def variant(defines):
    """vocoder_stage launches the library built with `defines` inside."""
    shipped = vk._stage_lib
    vk._stage_lib = lambda: shipped(defines)
    try:
        yield shipped(defines)
    finally:
        vk._stage_lib = shipped


def device_ms(fn):
    """fn() once under torch.profiler -> (ms of the stage kernel, ms of
    every kernel fn launched)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total * 1e-3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(t for key, t in rows if "stage_kernel" in key),
            sum(t for _, t in rows))


def probe_stage(args, libs, reps):
    """Median ms of each variant over `reps` interleaved launches, and the
    probe build's wait cycles / kernel cycles per warp index."""
    run = lambda: vk.vocoder_stage(*args, compute_dtype=torch.bfloat16)
    times = {name: [] for name in VARIANTS}
    for name in VARIANTS:  # warm-up
        with variant(VARIANTS[name]):
            out = run()
        if name == "shipped" and not torch.isfinite(out).all():
            raise SystemExit("vocoder_stage: a non-finite output")
    order = list(VARIANTS)
    for rep in range(reps):
        for name in order if rep % 2 == 0 else order[::-1]:
            with variant(VARIANTS[name]):
                times[name].append(device_ms(run))
    cycles = (ctypes.c_ulonglong * (2 * MAX_WARPS))()
    probe = libs["probe"]
    probe.vocoder_stage_probe.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                                          ctypes.c_int]
    probe.vocoder_stage_probe.restype = ctypes.c_int
    vk.cuda_build.check(probe, probe.vocoder_stage_probe(cycles, 1), "probe")
    with variant(VARIANTS["probe"]):
        run()
    torch.cuda.synchronize()
    vk.cuda_build.check(probe, probe.vocoder_stage_probe(cycles, 1), "probe")
    c = np.array(cycles, dtype=np.float64).reshape(MAX_WARPS, 2)
    c = c[c[:, 1] > 0]  # the warps this width launches
    share = c[:, 0] / c[:, 1]
    out = {}
    for name, t in times.items():
        out[f"{name}_ms"] = float(np.median([k for k, _ in t]))
        out[f"{name}_call_ms"] = float(np.median([a for _, a in t]))
    out.update(full_wait_share=float(c[:, 0].sum() / c[:, 1].sum()),
               full_wait_share_min=float(share.min()),
               full_wait_share_max=float(share.max()),
               warps=int(len(c)), reps=reps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    card = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc each, at once
        libs = dict(zip(VARIANTS, pool.map(vk._stage_lib, VARIANTS.values())))
    rows = {}
    with torch.no_grad():
        for index, (C_in, C, T_in, ups) in STAGES.items():
            args = stage_inputs(C_in, C, T_in, ups, card, opts.seed + index)
            rows[index] = probe_stage(args, libs, opts.reps)
            print(f"stage {index}: " + json.dumps(rows[index]), flush=True)
    result = {"card": smi, "stages": rows}
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

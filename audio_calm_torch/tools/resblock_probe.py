"""The resblock kernel (K6, csrc/resblock.cu) at phase 6's shapes, on one
card.

    python -m audio_calm_torch.tools.resblock_probe [--old-csrc DIR]
        [--plans] [--phases] [--reps N] [--out FILE]

For every shape of SHAPES (the odd-width render's resblocks, B = 2 on the
384-frame grid: C = 96, 48, 24 at k = 3, 7, 11, and V1's C = 128 and 256,
dilations 1/3/5, bf16 operands and fp32 activations as the render runs
them) it checks the shipped kernel against its plain version (the JAX
vocoder bound: 5e-3 of the output's largest magnitude above 1) and
measures, under torch.profiler, the device ms a launch of the kernel alone
(`ms`: its C entry on operands laid out once) and of a whole wrapper call
(`call_ms`: `fused_resblock`, the weight layout, padding and output
included), the plain version's device ms and the bound (the larger of the
products' operations over 989 TFLOP/s and x and the output once over
3.35 TB/s), beside the plan and its executed / useful products, reckoned
from the plan (`padding`: the channels' KP W / C^2 alone; `executed`: with
the halo's recompute and the 64-row groups).

--old-csrc DIR builds DIR/resblock.cu (an earlier design, with its
headers beside it) into a library of its own and times it in the same
process, interleaved with the shipped kernel (old, new, new, old), through
the earlier design's C entry `fused_resblock(x, w, bias, out, scratch,
io_bf16, ct_bf16, B, T, C, k, n_dil, dil, slope, Lp, stream)` on its
operand layout (`old_call`: mma.sync B fragments on 32-channel granules), kernel alone and with that layout made per
call. --plans also times the shipped kernel under every plan
`vocoder_kernel.candidate_plans` offers for the shape (smaller windows;
at C = 24 the width padded to 32) and prints the fastest. --phases
runs each shape once more on the probe build (-DRESBLOCK_PROBE), whose
warps count the clock cycles of each phase of the kernel, and prints each
phase's share of the warps' cycles (`phases`). Prints the
card's name and power limit, a line per shape and, last, one JSON object,
also written to FILE when given.

chip_smoke.py's phase 6 times the same shapes, on the render's own
weights, through `time_shape`.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from audio_calm_torch.ops import cuda_build
from audio_calm_torch.ops import vocoder_kernel as vk
from audio_calm_torch.tools.profiler_probe import bound_ms, device_ms

DILS = (1, 3, 5)
# (label, C, T): B = 2, each at k = 3, 7, 11
SHAPES = [("odd-width C=96", 96, 98304), ("odd-width C=48", 48, 196608),
          ("odd-width C=24", 24, 393216), ("V1 C=128", 128, 98304),
          ("V1 C=256", 256, 12288)]
_OLD_GRANULES = (32, 64, 96, 128, 192, 256)  # the earlier design's widths


def shape_inputs(C, k, T, device, seed=0):
    """x [2, T, C] and one resblock (dilations 1/3/5; weights N(0, 1/(k C)),
    biases N(0, 0.01)) made on `device` from a seed."""
    g = torch.Generator(device).manual_seed(seed)
    s = 1.0 / np.sqrt(k * C)

    def w(*shape, scale):
        return scale * torch.randn(*shape, generator=g, device=device)

    x = torch.randn(2, T, C, generator=g, device=device)
    return x, (w(3, k, C, C, scale=s), w(3, C, scale=0.1),
               w(3, k, C, C, scale=s), w(3, C, scale=0.1), k, DILS)


def resblock_cost(x, block):
    """(FLOP, bytes) a resblock needs: 2 convs a dilation of 2 k C^2
    operations a row; x and the output once, the bf16 weights and fp32
    biases once."""
    w1, _, _, _, k, dils = block
    B, T, C = x.shape
    flops = 2.0 * 2 * len(dils) * B * T * k * C * C
    nbytes = 2 * x.numel() * x.element_size() + 2 * len(dils) * (
        k * C * C * 2 + C * 4)
    return flops, nbytes


def load_old(csrc: Path) -> ctypes.CDLL:
    """DIR/resblock.cu built by nvcc as cuda_build builds the shipped one,
    into a library named by the hash of DIR's sources."""
    h = hashlib.sha1()
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.read_bytes())
    out = cuda_build.BUILD_DIR / f"libresblock_old-{h.hexdigest()[:12]}.so"
    if not out.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(out), str(csrc / "resblock.cu")], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fused_resblock.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P,
                                   ctypes.c_float, I, P]
    lib.fused_resblock.restype = I
    return lib


def _old_fragments(w: torch.Tensor) -> torch.Tensor:
    """The earlier design's bf16 weight order, [k, C_in, C_out] -> flat:
    per (tap, k16 slice, 32-channel group, half) the 32 lanes'
    mma.m16n8k16 B fragments, 4 words a lane."""
    k, c_in, c_out = w.shape
    w = w.to(torch.bfloat16).reshape(k, c_in // 16, 2, 4, 2, c_out // 32, 2,
                                     2, 8)
    return w.permute(0, 1, 5, 6, 8, 3, 7, 2, 4).reshape(-1)


def old_call(lib, x, block, slope=0.1):
    """The earlier design's bf16 launch as its wrapper made it -> (kernel
    alone, whole call, output [B, T, C]): C zero-padded to its 32-channel
    granule, the widest window its shared memory holds (the residual in a
    device-memory scratch above C = 64) and its B-fragment weight order."""
    w1, b1, w2, b2, k, dils = block
    B, T, C = x.shape
    n_d = len(dils)
    C_k = next(g for g in _OLD_GRANULES if g >= C)
    in_scratch = C_k > 64
    row = (C_k + 8) * 4 * (1 if in_scratch else 2)
    H = vk._halo(k, dils)
    Lp = min(vk._SMEM_BYTES // row // 16 * 16, -(-(T + 2 * H) // 16) * 16)
    tile = Lp - 2 * H
    dil = (ctypes.c_int * n_d)(*dils)

    def prepare():
        xp = vk._pad_to(x, (C_k,)).contiguous()
        w = torch.cat([_old_fragments(vk._pad_to(t, (C_k, C_k)))
                       for i in range(n_d) for t in (w1[i], w2[i])])
        bias = torch.cat([vk._pad_to(t, (C_k,)).float() for i in range(n_d)
                          for t in (b1[i], b2[i])])
        out = torch.empty(B, T, C_k, dtype=x.dtype, device=x.device)
        scratch = (torch.empty(-(-T // tile) * B * Lp * C_k,
                               dtype=torch.float32, device=x.device)
                   if in_scratch else None)
        return xp, w, bias, out, scratch

    def launch(ops):
        xp, w, bias, out, scratch = ops
        status = lib.fused_resblock(
            xp.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            int(x.dtype == torch.bfloat16), 1, B, T, C_k, k, n_d, dil,
            float(slope), Lp, torch.cuda.current_stream().cuda_stream)
        cuda_build.check(lib, status, "earlier fused_resblock")
        return out

    ops = prepare()
    return (lambda: launch(ops)), (lambda: launch(prepare())), \
        launch(ops)[..., :C]


PHASES = ("prologue", "ring_wait", "products", "epilogues", "barriers",
          "product_waits", "releases", "total")


def phase_shares(x, block):
    """One launch on the probe build: each phase's share of the warps'
    clock cycles from the kernel's start to its end (csrc/resblock.cu
    g_probe_cycles; `products` holds the ring waits, the waits for
    products to finish and the releases)."""
    call, _ = vk._resblock_call(x, block, 0.1, torch.bfloat16,
                                defines=("RESBLOCK_PROBE",))
    lib = vk._resblock_lib(("RESBLOCK_PROBE",))
    lib.resblock_probe.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                                   ctypes.c_int]
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    call()
    torch.cuda.synchronize()
    cuda_build.check(lib, lib.resblock_probe(cycles, 1), "resblock_probe")
    call()
    torch.cuda.synchronize()
    cuda_build.check(lib, lib.resblock_probe(cycles, 1), "resblock_probe")
    return {name: cycles[i] / cycles[7] for i, name in enumerate(PHASES)
            if name != "total"}


def time_shape(label, x, block, old=None, plans=False, reps=2,
               phases=False):
    """One shape: the shipped kernel held against its plain version
    (SystemExit past the bound); its device ms a launch alone and a whole
    wrapper call, interleaved over `reps` with the earlier design's (`old`,
    a library from load_old); the plain version's ms; the bound; the plan
    and its reckoned products; with `plans`, every candidate plan's ms;
    with `phases`, the probe build's phase shares."""
    k, dils = block[4], block[5]
    B, T, C = x.shape
    plan = vk.resblock_plan(C, k, dils, T)
    ref = vk.fused_resblock_plain(x, block).float()
    bound = 5e-3 * max(1.0, ref.abs().max().item())
    err = (vk.fused_resblock(x, block).float() - ref).abs().max().item()
    if not err <= bound:
        raise SystemExit(f"FAILED: fused_resblock {label} k={k}: bf16 "
                         f"max_abs_err {err:.3e} > {bound:.3e}")
    executed, useful = vk.resblock_products(plan, C, k, dils)
    out = {"shape": label, "x": list(x.shape), "k": k,
           "plan": {f: getattr(plan, f) for f in plan._fields},
           "padding": plan.kpad * plan.width / (C * C),
           "executed": executed / useful, "max_abs_err": err,
           "err_bound": bound}
    fns = {"": vk._resblock_call(x, block, 0.1, torch.bfloat16)[0],
           "call_": lambda: vk.fused_resblock(x, block)}
    if old is not None:
        fns["old_"], fns["old_call_"], old_out = old_call(old, x, block)
        out["old_max_abs_err"] = (old_out.float() - ref).abs().max().item()
    times = defaultdict(list)
    for rep in range(reps):
        for pre in (list(fns) if rep % 2 else list(fns)[::-1]):
            times[pre + "ms"].append(device_ms(fns[pre], 10))
    for key, values in times.items():
        out[key] = float(np.median(values))
        out[key + "_reps"] = values
    out["plain_ms"] = device_ms(lambda: vk.fused_resblock_plain(x, block), 3)
    out["bound_ms"], out["bound_by"] = bound_ms(*resblock_cost(x, block))
    if phases:
        out["phases"] = phase_shares(x, block)
    if plans:
        sweep = []
        for p in vk.candidate_plans(C, k, dils, T):
            call, res = vk._resblock_call(x, block, 0.1, torch.bfloat16, p)
            call()
            e = (res.float() - ref).abs().max().item()
            if not e <= bound:
                raise SystemExit(f"FAILED: fused_resblock {label} k={k} {p}: "
                                 f"error {e}")
            sweep.append({"width": p.width, "Lp": p.Lp, "tile": p.tile,
                          "stages": p.stages, "ms": device_ms(call, 10)})
        out["plans"] = sweep
        out["fastest_plan"] = min(sweep, key=lambda p: p["ms"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", default=None,
                    help="directory of an earlier resblock.cu")
    ap.add_argument("--plans", action="store_true",
                    help="also time every candidate plan of each shape")
    ap.add_argument("--phases", action="store_true",
                    help="also count each phase's cycles on a probe build")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    card = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda_build.load("resblock")
    if opts.phases:
        cuda_build.load("resblock", ("RESBLOCK_PROBE",))
    old = load_old(Path(opts.old_csrc)) if opts.old_csrc else None
    rows = []
    with torch.no_grad():
        for label, C, T in SHAPES:
            for k in (3, 7, 11):
                x, block = shape_inputs(C, k, T, card)
                rows.append(time_shape(label, x, block, old, opts.plans,
                                       opts.reps, opts.phases))
                print(json.dumps(rows[-1]), flush=True)
    odd = [r for r in rows if r["shape"].startswith("odd-width")]
    summary = {key: float(np.mean([r[key] for r in odd]))
               for key in ("ms", "call_ms", "old_ms", "old_call_ms",
                           "plain_ms", "bound_ms") if key in odd[0]}
    result = {"card": smi, "odd_width_mean": summary, "rows": rows}
    print("odd-width mean over 9 shapes: " + json.dumps(summary), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The batch-invariant product (csrc/gemm.cu) at the served engine's
shapes, on one card.

    python -m audio_calm_torch.tools.gemm_probe [--old-csrc DIR] [--plans]
        [--m M] [--reps N] [--repeats N] [--out FILE]

For every row of ROWS it checks the kernel against its plain version
(2^-7 of the largest output) and measures its device ms a launch under
torch.profiler, beside cuBLAS's (F.linear, or x @ w for w [K, N]: a
yardstick the served path never calls) and the bound (the larger of the
bytes of x, w, the bias and y once over 3.35 TB/s and 2 M N K over 989
TFLOP/s). Weights of up to 27.5 MB stay in the 50 MB L2 between
launches: warm reads, as cuBLAS's are.

--old-csrc DIR builds DIR/gemm.cu (the earlier mma.sync design, with its
headers beside it) into a library of its own and times it in the same
process, old, new, new, old, through its C entry `gemm_bf16(x, w, bias, y,
work, M, N, K, w_nk, splits, spread, stream)` under the earlier wrapper's
plan (`old_plan`). --plans also times the kernel under every plan
`gemm_kernel.candidate_plans` offers for the row (one to three
warpgroups a tile; the chunks spread over blocks or run in one block).
--m M times every row at M rows instead of its own. --repeats N times nothing: it counts, for every row
and every candidate plan, the launches of N (back to back) whose output
differs from the first, and the rows next to the ragged edges of M and N
against the same rows launched alone. Prints the card's name and power
limit, a line per row and, last, one JSON object, also written to FILE
when given.

chip_smoke.py runs the same ROWS: phase 3 through `repeat_row`, phase 6
times them.
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
from audio_calm_torch.ops import gemm_kernel as gk
from audio_calm_torch.tools.profiler_probe import bound_ms, device_ms

# the served engine's shapes (configs/calm.yaml, chip_smoke.py phase 5g):
# the /tts pair's Qwen2 encode (2 rows of 97 positions) with LoRA r 64,
# its DiT under CFG (4 rows on the 192 grid), the ASR encode's down_proj
# (2 rows of 461) -> (label, M, N, K, w [K, N])
ROWS = [
    ("Qwen2 q/o, /tts pair", 194, 1536, 1536, False),
    ("Qwen2 k/v, /tts pair", 194, 256, 1536, False),
    ("Qwen2 gate/up, /tts pair", 194, 8960, 1536, False),
    ("Qwen2 down, /tts pair", 194, 1536, 8960, False),
    ("LoRA A, /tts pair", 194, 64, 1536, True),
    ("LoRA B, /tts pair", 194, 1536, 64, True),
    ("DiT q/k/v/o, /tts pair", 768, 768, 768, False),
    ("DiT mlp_fc1, /tts pair", 768, 3072, 768, False),
    ("DiT mlp_fc2, /tts pair", 768, 768, 3072, False),
    ("Qwen2 down, /asr B=2", 922, 1536, 8960, False),
]

# every weight shape the served engine multiplies by, (N, K, w [K, N]):
# calm.yaml's Qwen2 projections, LoRA's A and B (r 64), the DiT at 768 and
# at the flagship's 1024, the ASR projector's causal convs
SHAPES = [(1536, 1536, False), (256, 1536, False), (8960, 1536, False),
          (1536, 8960, False), (64, 1536, True), (64, 8960, True),
          (1536, 64, True), (256, 64, True), (8960, 64, True),
          (768, 768, False), (3072, 768, False), (768, 3072, False),
          (1024, 1024, False), (4096, 1024, False), (1024, 4096, False),
          (1536, 256, False), (256, 256, False), (1, 384, False),
          (1536, 384, False), (1536, 4608, False)]


def inputs(M, N, K, kn, card, seed):
    """(x, w, bias) of one row, random from a seed; no bias for w [K, N]."""
    g = torch.Generator(card).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=card).bfloat16()
    w = (torch.randn((K, N) if kn else (N, K), generator=g, device=card)
         / K ** 0.5).bfloat16()
    b = None if kn else (0.1 * torch.randn(N, generator=g, device=card)
                         ).bfloat16()
    return x, w, b


def cost(M, N, K, kn):
    """(FLOP, bytes) of one product: 2 M N K; x, w, the bias and y once."""
    return 2.0 * M * N * K, 2 * (M * K + N * K + M * N + (0 if kn else N))


def old_plan(M, N, K, sms):
    """The earlier wrapper's (splits, spread): 64 x 128 tiles, K tiles of
    32, about 64 blocks a row tile, chunks spread where the tiles leave SMs
    idle and the partials stay within 4x the weight's bytes."""
    want = -(-64 // -(-N // 128))
    splits = max(1, min(want, 16, -(-K // 32) // 4))
    spread = (splits > 1 and -(-M // 64) * -(-N // 128) < sms
              and M * splits <= K)
    return splits, spread


def _build(csrc: Path, name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.read_bytes())
    out = cuda_build.BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"
    if not out.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(out), str(csrc / "gemm.cu")], check=True,
                       capture_output=True)
    return out


def load_old(csrc: Path) -> ctypes.CDLL:
    """DIR/gemm.cu, the earlier design, built as cuda_build builds the
    shipped one, into a library named by the hash of DIR's sources."""
    lib = ctypes.CDLL(str(_build(csrc, "gemm_old")))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gemm_bf16.argtypes = [P] * 5 + [I] * 6 + [P]
    lib.gemm_bf16.restype = I
    return lib


def old_call(lib, x, w, b, kn):
    """The earlier kernel on these tensors under old_plan, into a new
    output -> (call, output)."""
    M, K = x.shape
    N = w.shape[1] if kn else w.shape[0]
    splits, spread = old_plan(M, N, K, gk._sms(x.device))
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    work = (torch.empty(splits, M, N, dtype=torch.float32, device=x.device)
            if spread else None)
    args = [x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(), M, N,
            K, int(not kn), splits, int(spread),
            torch.cuda.current_stream().cuda_stream]
    call = lambda: lib.gemm_bf16(*args)
    cuda_build.check(lib, call(), "gemm (earlier design)")
    return call, out


def _err(out, ref):
    return (out.float() - ref).abs().max().item()


def time_row(row, card, old=None, plans=False, reps=2, seed=0):
    """One row of ROWS: the kernel held against its plain version
    (SystemExit past 2^-7 of the largest output); its device ms a launch
    interleaved over `reps` with the earlier design's (`old`, from
    load_old); cuBLAS's and the bound; with `plans` every candidate plan's
    ms."""
    label, M, N, K, kn = row
    x, w, b = inputs(M, N, K, kn, card, seed)
    ref = gk.linear_plain(x, w, b, kn=kn).float()
    bound = 2 ** -7 * ref.abs().max().item()
    new = lambda: gk.linear(x, w, b, kn=kn)
    err = _err(new(), ref)
    if not err <= bound:
        raise SystemExit(f"FAILED: gemm {label}: bf16 max_abs_err {err:.3e} "
                         f"> {bound:.3e}")
    plan = gk.gemm_plan(M, N, K, gk._sms(card))
    out = {"shape": label, "M": M, "N": N, "K": K, "kn": kn,
           "plan": plan._asdict(), "chunks": gk.chunk_bounds(N, K)[:2],
           "reduction": ("gemm_reduce" if plan.spread else "in the block"),
           "grid": plan.blocks, "max_abs_err": err, "err_bound": bound}
    calls = {"": new}
    if old is not None:
        calls["old_"], old_out = old_call(old, x, w, b, kn)
        out["old_max_abs_err"] = _err(old_out, ref)
        out["old_plan"] = dict(zip(("splits", "spread"),
                                   old_plan(M, N, K, gk._sms(card))))
    times = defaultdict(list)
    for rep in range(reps):
        for pre in (list(calls) if rep % 2 else list(calls)[::-1]):
            times[pre + "ms"].append(device_ms(calls[pre], 20))
    for key, values in times.items():
        out[key] = float(np.median(values))
        out[key + "_reps"] = values
    f = torch.nn.functional.linear
    out["library_ms"] = device_ms(lambda: x @ w if kn else f(x, w, b), 20)
    out["bound_ms"], out["bound_by"] = bound_ms(*cost(M, N, K, kn))
    if plans:
        sweep = []
        for p in gk.candidate_plans(M, N, K):
            fn = lambda: gk._linear(x, w, b, kn, p)
            e = _err(fn(), ref)
            if not e <= bound:
                raise SystemExit(f"FAILED: gemm {label} {p}: error {e}")
            sweep.append({**p._asdict(), "ms": device_ms(fn, 20)})
        out["plans"] = sweep
        out["fastest_plan"] = min(sweep, key=lambda p: p["ms"])
    return out


def repeat_mismatches(x, w, b, kn, plan, repeats: int) -> int:
    """`repeats` launches back to back under `plan` on the same inputs ->
    how many outputs differ from the first in any bit or hold a value that
    is not finite. The output depends on the inputs alone, so any count but
    0 is a fault: a consumer that reads a ring stage before its tile landed,
    or a stage the producer refills too early, does so only now and then."""
    first = gk._linear(x, w, b, kn, plan).clone()
    ref = first.view(torch.int16)
    bad = (~torch.isfinite(first)).any().long()
    for _ in range(repeats):
        out = gk._linear(x, w, b, kn, plan)
        bad += ((out.view(torch.int16) != ref).any()
                | (~torch.isfinite(out)).any())
    return int(bad)


def edge_rows_agree(x, w, b, kn) -> bool:
    """The rows next to the ragged edges of M (the last row tile's rows and
    the one before) and all N columns, at M and at M - 1 and M + 1 rows of
    the same x, against the same rows launched alone."""
    M = x.shape[0]
    full = gk.linear(x, w, b, kn=kn)
    ok = True
    for r in sorted({0, M - 1, M - 2, (M - 1) // 64 * 64, M // 2}):
        if 0 <= r < M:
            ok &= torch.equal(gk.linear(x[r:r + 1], w, b, kn=kn), full[r:r + 1])
    for m in (M - 1, M + 1):
        if m >= 1:
            xm = x[:m] if m <= M else torch.cat([x, x[:1]])
            ok &= torch.equal(gk.linear(xm, w, b, kn=kn)[:min(m, M)],
                              full[:min(m, M)])
    return bool(ok)


def repeat_row(row, card, repeats, seed=3):
    """A row of ROWS -> for every candidate plan the launches of `repeats`
    that differ from the first, and whether the ragged-edge rows agree."""
    label, M, N, K, kn = row
    x, w, b = inputs(M, N, K, kn, card, seed)
    out = {"shape": label, "M": M, "N": N, "K": K, "repeats": repeats,
           "edges_agree": edge_rows_agree(x, w, b, kn), "mismatched": {}}
    for p in gk.candidate_plans(M, N, K):
        key = f"nc={p.nc} {'spread' if p.spread else 'one block'}"
        out["mismatched"][key] = repeat_mismatches(x, w, b, kn, p, repeats)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", default=None,
                    help="directory of an earlier gemm.cu")
    ap.add_argument("--plans", action="store_true",
                    help="also time every candidate plan of each row")
    ap.add_argument("--m", type=int, default=0,
                    help="time every row at this M instead of its own")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=0,
                    help="count differing outputs over N repeated launches "
                         "under every plan instead of timing")
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
    cuda_build.load("gemm")
    old = load_old(Path(opts.old_csrc)) if opts.old_csrc else None
    rows = []
    with torch.no_grad():
        for i, row in enumerate(ROWS):
            if opts.m:
                row = (f"{row[0]} at M={opts.m}", opts.m) + row[2:]
            if opts.repeats:
                rows.append(repeat_row(row, card, opts.repeats))
            else:
                rows.append(time_row(row, card, old, opts.plans, opts.reps,
                                     seed=i))
            print(json.dumps(rows[-1]), flush=True)
    result = {"card": smi, "rows": rows}
    if not opts.repeats:
        result["mean_ms"] = float(np.mean([r["ms"] for r in rows]))
        result["mean_library_ms"] = float(np.mean([r["library_ms"]
                                                   for r in rows]))
        if old is not None:
            result["mean_old_ms"] = float(np.mean([r["old_ms"]
                                                   for r in rows]))
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

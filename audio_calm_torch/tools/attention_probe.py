"""The attention forward (K3/K4, csrc/attention_fwd.cu) at the served
shapes, on one card.

    python -m audio_calm_torch.tools.attention_probe [--old-csrc DIR]
        [--plans] [--reps N] [--repeats N] [--out FILE]

For every row of ROWS (the shapes the shipped configs launch, bf16, with
the masks they carry) it checks the shipped kernel against its plain
version (2^-7 of the largest output) and measures the kernel's device ms
per launch under torch.profiler, the host us a call of the wrapper
`attention_fwd` and of the library's C entry take to return, the plain
version's and PyTorch's scaled_dot_product_attention's device ms (a
yardstick the port never calls) and the bound (the larger of the bytes
over 3.35 TB/s and the attended pairs' products over 989 TFLOP/s).

--old-csrc DIR builds DIR/attention_fwd.cu (an earlier design, with the
headers beside it) into a library of its own and measures it in the same
process, interleaved with the shipped kernel (old, new, new, old),
through its C entry `attention_fwd(q, k, v, valid, out, is_bf16, B, T, S,
Hq, Hkv, D, causal, stream)`, or the shipped entry's signature (with the
plan's packing and warpgroups) where DIR's source takes them. --plans
also times the shipped kernel under every plan
`attention_kernel.candidate_plans` offers for the row, and prints the
fastest. --repeats N times nothing: for each row that takes the key
split, at B = 16, it counts the launches of N (`repeat_mismatches`) whose
output differs from the first, for the shipped kernel and, with
--old-csrc, the earlier one (old, new, new, old). Prints the card's name
and power limit, a line per row and, last, one JSON object, also written
to FILE when given.

chip_smoke.py's phase 6 measures the same ROWS through `time_row`.
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

from audio_calm_torch.ops import attention_kernel as ak
from audio_calm_torch.ops import cuda_build
from audio_calm_torch.tools.profiler_probe import bound_ms, device_ms, host_us

# (label, B, T, S, Hq, Hkv, d, causal, valid lengths per batch row or None
# for all valid, launches per request). The valid lengths are the ones the
# served requests carry: a text padded to its bucket ends in the valid SOA
# position ("pad": valid[:n] and the last key), an audio grid is valid up to
# its frame count ("len": valid[:n]).
ROWS = [
    # the flagship (models/flagship.py), 2 texts on the 384-frame grid
    ("flagship Qwen2 encode", 2, 25, 25, 12, 2, 128, True, ("pad", [25, 17]), 28),
    ("flagship DiT self", 4, 384, 384, 16, 16, 64, False, None, 96),
    ("flagship DiT cross", 4, 384, 24, 16, 16, 64, False,
     ("len", [24, 16, 24, 16]), 96),
    # configs/calm.yaml's TTS head (768 / 16 heads: d = 48), one request
    # under CFG (B = 2) and a pair (B = 4), on the 96 / 192 / 384 grids
    ("TTS DiT self d=48 T=96 B=2", 2, 96, 96, 16, 16, 48, False, ("len", [90, 90]), 128),
    ("TTS DiT self d=48 T=96 B=4", 4, 96, 96, 16, 16, 48, False, ("len", [90, 71, 90, 71]), 128),
    ("TTS DiT self d=48 T=192 B=2", 2, 192, 192, 16, 16, 48, False, ("len", [174, 174]), 128),
    ("TTS DiT self d=48 T=192 B=4", 4, 192, 192, 16, 16, 48, False, ("len", [174, 150, 174, 150]), 128),
    ("TTS DiT self d=48 T=384 B=2", 2, 384, 384, 16, 16, 48, False, ("len", [350, 350]), 128),
    ("TTS DiT self d=48 T=384 B=4", 4, 384, 384, 16, 16, 48, False, ("len", [350, 301, 350, 301]), 128),
    ("TTS DiT cross d=48 T=384 S=64 B=2", 2, 384, 64, 16, 16, 48, False, ("len", [49, 49]), 128),
    ("TTS DiT cross d=48 T=384 S=64 B=4", 4, 384, 64, 16, 16, 48, False, ("len", [49, 37, 49, 37]), 128),
    # configs/calm.yaml's Qwen2 encode over [text bucket | SOA], causal GQA
    ("Qwen2 encode 33 B=1", 1, 33, 33, 12, 2, 128, True, ("pad", [25]), 28),
    ("Qwen2 encode 65 B=1", 1, 65, 65, 12, 2, 128, True, ("pad", [50]), 28),
    ("Qwen2 encode 97 B=1", 1, 97, 97, 12, 2, 128, True, ("pad", [81]), 28),
    ("Qwen2 encode 65 B=2", 2, 65, 65, 12, 2, 128, True, ("pad", [50, 41]), 28),
    # configs/asr.yaml's request: [audio 384 | SOA | 76 prompt] (audio of
    # 385 and 235 latent frames), the query cross-attention (d = 96) and
    # the ASR head's self-attention over the query grid (d = 48)
    ("ASR Qwen2 encode L=461", 2, 461, 461, 12, 2, 128, True, ("asr", [384, 235]), 28),
    ("ASR cross d=96", 2, 96, 384, 16, 16, 96, False, ("len", [384, 235]), 1),
    ("ASR DiT self d=48", 2, 96, 96, 16, 16, 48, False, ("len", [96, 58]), 80),
    # past the TPU's 512 gate: no served shape, the lifted limit
    ("long causal 1024", 1, 1024, 1024, 12, 2, 128, True, None, 0),
    ("long causal 2048", 1, 2048, 2048, 12, 2, 128, True, None, 0),
]


def row_inputs(row, device, seed=0, dtype=torch.bfloat16):
    """(q, k, v, key_valid) of one row, random from a seed."""
    label, B, T, S, Hq, Hkv, d, causal, valid_spec, _ = row
    g = torch.Generator(device).manual_seed(seed)
    q = torch.randn(B, T, Hq, d, generator=g, device=device).to(dtype)
    k = torch.randn(B, S, Hkv, d, generator=g, device=device).to(dtype)
    v = torch.randn(B, S, Hkv, d, generator=g, device=device).to(dtype)
    valid = torch.ones(B, S, dtype=torch.bool, device=device)
    if valid_spec is not None:
        kind, ns = valid_spec
        for b, n in enumerate(ns):
            if kind == "asr":  # audio frames [0, n), then SOA and prompt
                valid[b, n:384] = False
            else:
                valid[b, n:] = False
                if kind == "pad":
                    valid[b, -1] = True
    return q, k, v, valid


def repeat_mismatches(q, k, v, valid, causal, repeats: int,
                      flush_bytes: int = 256 << 20, launch=None) -> int:
    """Launch `attention_fwd` (or `launch()`, which returns its output)
    `repeats` times on the same inputs, each after a write of
    `flush_bytes` (an L2 flush, so that a block's tile copies land in a
    varying order) -> how many outputs differ from the first launch's in
    any bit or hold a value that is not finite. The kernel's output
    depends on its inputs alone, so any count but 0 is a fault: a
    warpgroup that reads a ring stage before its tile landed does so only
    now and then."""
    if launch is None:
        launch = lambda: ak.attention_fwd(q, k, v, valid, causal)
    first = launch().clone()
    ref = first.view(torch.uint8)
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device=q.device)
    bad = (~torch.isfinite(first)).any().long()
    for _ in range(repeats):
        flush.fill_(1)
        out = launch()
        bad += ((out.view(torch.uint8) != ref).any()
                | (~torch.isfinite(out)).any())
    return int(bad)


def attn_cost(q, k, valid, causal):
    """(FLOP, bytes) attention needs on this data: 4*d per (query, head,
    attended key) pair; q, k, v, out and the key mask read/written once."""
    B, T, Hq, d = q.shape
    S = k.shape[1]
    m = valid.bool()[:, None, :].expand(B, T, S)
    if causal:
        m = m & torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
    flops = 4.0 * d * Hq * int(m.sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + valid.numel()
    return flops, nbytes


def sdpa(q, k, v, valid, causal):
    import torch.nn.functional as F

    B, T, Hq, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    mask = valid[:, None, None, :].expand(B, 1, T, S)
    if causal:
        mask = mask & torch.ones(T, S, dtype=torch.bool,
                                 device=q.device).tril(S - T)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv)


def load_old(csrc: Path) -> ctypes.CDLL:
    """DIR/attention_fwd.cu built by nvcc as cuda_build builds the shipped
    one, into a library named by the hash of DIR's sources."""
    h = hashlib.sha1()
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.read_bytes())
    out = cuda_build.BUILD_DIR / f"libattention_fwd_old-{h.hexdigest()[:12]}.so"
    if not out.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(out), str(csrc / "attention_fwd.cu")], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    # the shipped entry adds the plan's packing and warpgroups
    lib.takes_plan = "consumers" in (csrc / "attention_fwd.cu").read_text()
    lib.attention_fwd.argtypes = ([P] * 5 + [I] * (10 if lib.takes_plan
                                                   else 8) + [P])
    lib.attention_fwd.restype = I
    return lib


def c_entry(lib, q, k, v, valid, causal, plan=None):
    """lib's C entry `attention_fwd` on these tensors into a new output,
    checked once -> (call, output); `plan`: the shipped entry's packing and
    warpgroups (the earlier design takes neither)."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    vb = valid.contiguous().view(torch.uint8)
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), vb.data_ptr(),
            out.data_ptr(), int(q.dtype == torch.bfloat16), B, T, S, Hq, Hkv,
            d, int(causal)]
    if plan is not None:
        args += [int(plan.group > 1), plan.consumers]
    args.append(torch.cuda.current_stream().cuda_stream)
    call = lambda: lib.attention_fwd(*args)
    cuda_build.check(lib, call(), "attention_fwd C entry")
    return call, out


def time_row(row, card, old=None, plans=False, reps=2, seed=0):
    """One row of ROWS: the shipped kernel held against its plain version
    (SystemExit past 2^-7 of the largest output); its device ms a launch
    and the host us a call of its C entry, interleaved over `reps` with
    the earlier design's (`old`, a library from load_old; not past its
    512 gate); the host us of a wrapper call; the plain version's and
    SDPA's device ms; the bound; with `plans`, every candidate plan's
    device ms."""
    label, B, T, S, Hq, Hkv, d, causal, _, launches = row
    q, k, v, valid = row_inputs(row, card, seed)
    plan = ak.attention_plan(T, S, Hq, Hkv, d, causal)
    ref = ak.attention_fwd_plain(q, k, v, valid, causal).float()
    bound = 2 ** -7 * ref.abs().max().item()
    new = lambda: ak.attention_fwd(q, k, v, valid, causal)
    err = (new().float() - ref).abs().max().item()
    if not err <= bound:
        raise SystemExit(f"FAILED: attention_fwd {label}: bf16 max_abs_err "
                         f"{err:.3e} > {bound:.3e}")
    out = {"shape": label, "q": [B, T, Hq, d], "S": S, "Hkv": Hkv,
           "causal": causal, "plan": plan._asdict(),
           "launches_per_request": launches, "max_abs_err": err,
           "err_bound": bound}
    calls = {"": c_entry(ak._attn_lib(), q, k, v, valid, causal, plan)[0]}
    if old is not None and (old.takes_plan or max(T, S) <= 512):
        calls["old_"], old_out = c_entry(old, q, k, v, valid, causal,
                                         plan if old.takes_plan else None)
        out["old_max_abs_err"] = (old_out.float() - ref).abs().max().item()
    times = defaultdict(list)
    for rep in range(reps):
        for pre in (list(calls) if rep % 2 else list(calls)[::-1]):
            times[pre + "ms"].append(
                device_ms(new if pre == "" else calls[pre], 50))
    for key, values in times.items():
        out[key] = float(np.median(values))
        out[key + "_reps"] = values
    # host us a call: the wrapper's, and each C entry's, taking turns
    us = host_us([new, *calls.values()])
    out["host_us"] = us[0]
    out.update({pre + "c_host_us": u for pre, u in zip(calls, us[1:])})
    out["plain_ms"] = device_ms(
        lambda: ak.attention_fwd_plain(q, k, v, valid, causal), 10)
    out["library_ms"] = device_ms(sdpa(q, k, v, valid, causal), 50)
    flops, nbytes = attn_cost(q, k, valid, causal)
    out["bound_ms"], out["bound_by"] = bound_ms(flops, nbytes)
    if plans:
        sweep = []
        for p in ak.candidate_plans(T, S, Hq, Hkv, d, causal):
            fn = lambda: ak._attention_fwd(q, k, v, valid, causal, p)
            e = (fn().float() - ref).abs().max().item()
            if not e <= bound:
                raise SystemExit(f"FAILED: attention_fwd {label} {p}: "
                                 f"error {e}")
            sweep.append({**p._asdict(), "ms": device_ms(fn, 50)})
        out["plans"] = sweep
        out["fastest_plan"] = min(sweep, key=lambda p: p["ms"])
    return out


def repeat_row(row, card, old, repeats, seed=3):
    """A key-split row of ROWS at B = 16 -> the launches of `repeats` that
    differ from the first (`repeat_mismatches`), the shipped kernel's and,
    given, the earlier library's (old, new, new, old)."""
    label, _, T, S, Hq, Hkv, d, causal, _, _ = row
    q, k, v, valid = row_inputs((label, 16) + row[2:], card, seed)
    plan = ak.attention_plan(T, S, Hq, Hkv, d, causal)
    out = {"shape": label, "q": [16, T, Hq, d], "S": S, "Hkv": Hkv,
           "causal": causal, "plan": plan._asdict(), "repeats": repeats}
    runs = {"": None}
    if old is not None:
        call, old_out = c_entry(old, q, k, v, valid, causal,
                                plan if old.takes_plan else None)
        runs["old_"] = lambda: (call(), old_out)[1]
    for pre in (["old_", "", "", "old_"] if old is not None else [""] * 2):
        out.setdefault(pre + "mismatched", []).append(repeat_mismatches(
            q, k, v, valid, causal, repeats, launch=runs[pre]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", default=None,
                    help="directory of an earlier attention_fwd.cu")
    ap.add_argument("--plans", action="store_true",
                    help="also time every candidate plan of each row")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=0,
                    help="count differing outputs over N repeated launches "
                         "of the key-split rows instead of timing")
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
    cuda_build.load("attention_fwd")
    old = load_old(Path(opts.old_csrc)) if opts.old_csrc else None
    rows = []
    with torch.no_grad():
        for row in ROWS:
            if opts.repeats:
                if ak.attention_plan(*row[2:8]).consumers < 2:
                    continue
                print(f"repeating {row[0]}", flush=True)
                rows.append(repeat_row(row, card, old, opts.repeats))
            else:
                rows.append(time_row(row, card, old, opts.plans, opts.reps))
            print(json.dumps(rows[-1]), flush=True)
    result = {"card": smi, "rows": rows}
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

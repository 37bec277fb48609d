"""The attention backward (K5, csrc/attention_bwd.cu) at the training
shapes, on one card.

    python -m audio_calm_torch.tools.attention_bwd_probe [--old-csrc DIR]
        [--plans] [--reps N] [--repeats N] [--out FILE]

For every row of ROWS (the shapes the training paths launch K5 at, bf16,
with the key masks they carry) it checks the shipped kernel against its
plain version (within 2^-7 of the largest gradient in bf16, 2e-5 in fp32
with --fp32) and that two launches give the same bits, and measures under
torch.profiler the device ms of a call and of each of its launches (the
row statistics, dQ and dK/dV blocks and, under a split plan, the
partials' sum), the plain version's and the backward of PyTorch's
scaled_dot_product_attention (a yardstick the port never calls), and the
bound (the larger of the bytes over 3.35 TB/s and the five products of the
attended pairs over 989 TFLOP/s).

--old-csrc DIR builds DIR/attention_bwd.cu (an earlier design, with the
headers beside it) into a library of its own and measures it in the same
process, interleaved with the shipped kernel (old, new, new, old), through
its C entry `attention_bwd(q, k, v, o, dout, valid, dq, dk, dv, stats,
is_bf16, B, T, S, Hq, Hkv, D, causal, stream)`. --plans also times the
shipped kernel under every plan `attention_kernel.candidate_bwd_plans`
offers for the row, and names the fastest. --repeats N times nothing: for
the plain-ASR row, and every row whose plan splits, it counts the launches
of N (each after an L2 flush) whose gradients differ from the first's in
any bit. Prints the card's name and power limit, a line per row and,
last, one JSON object, also written to FILE when given.

chip_smoke.py's phases 3 and 6 check and time the same ROWS through
`check_row` and `time_row`.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from audio_calm_torch.ops import attention_kernel as ak
from audio_calm_torch.ops import cuda_build
from audio_calm_torch.tools.attention_probe import attn_cost
from audio_calm_torch.tools.profiler_probe import (bound_ms, device_ms,
                                                   device_profile)

# (label, B, T, S, Hq, Hkv, d, causal, key mask, fewest valid keys). Key
# masks: "text" the Qwen2 [text | pads | SOA] rows (the last key valid),
# "asr" the plain ASR rows [audio frames | pads | SOA | prompt] (keys 384 on
# valid), "len" valid up to a length.
ROWS = [
    # one Qwen2 layer of a tts.yaml microbatch slice (56 a plain step)
    ("Qwen2 training slice", 16, 97, 97, 12, 2, 128, True, "text", 4),
    # the same layer on one of 2 tensor-parallel shards (train/steps.
    # shard_step: 6 q / 1 kv heads a shard, 112 a plain step)
    ("Qwen2 TP-shard training slice", 16, 97, 97, 6, 1, 128, True, "text",
     4),
    # asr.yaml's plain rows: B = 16 in 8 slices, 384 + SOA + 76 prompt
    ("Qwen2 plain-ASR training slice", 2, 461, 461, 12, 2, 128, True, "asr",
     48),
    # the DiT self-attention of a dropout-off tts.yaml slice
    ("DiT self training slice", 16, 384, 384, 16, 16, 64, False, "len", 48),
    # the distillation students (tts.yaml B = 32, asr.yaml's head B = 16)
    ("DiT self distillation student", 32, 384, 384, 16, 16, 64, False,
     "len", 48),
    ("DiT cross distillation student", 32, 384, 96, 16, 16, 64, False, "len",
     4),
    ("ASR head self distillation student", 16, 96, 96, 16, 16, 48, False,
     "len", 10),
    # past the TPU's 512 gate: no shipped path yet
    ("causal past 512", 2, 1024, 1024, 12, 2, 128, True, "len", 64),
]
# the bf16 path's launches by kernel name (csrc/attention_bwd.cu, namespace
# tc: the row statistics, dQ and dK/dV blocks, the partials' sum); PyTorch's
# own reductions are named reduce_kernel too
PASSES = {"stats": r"\btc::stats_kernel<", "grads": r"\btc::grads_kernel<",
          "reduce": r"\btc::dkv_reduce_kernel\b"}


def row_inputs(row, dtype, card, seed=0):
    """(q, k, v, dout, key_valid) of one row, random from a seed."""
    _, B, T, S, Hq, Hkv, d, _, kind, lo = row
    g = torch.Generator(card).manual_seed(seed)
    q, dout = (torch.randn(B, T, Hq, d, generator=g, device=card).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, d, generator=g, device=card).to(dtype)
            for _ in range(2))
    hi = {"text": S - 1, "asr": 384}.get(kind, S)
    n = torch.randint(lo, hi + 1, (B,), generator=g, device=card)
    valid = torch.arange(S, device=card)[None, :] < n[:, None]
    if kind == "text":
        valid[:, -1] = True  # SOA
    elif kind == "asr":
        valid[:, 384:] = True  # SOA and the prompt
    return q, k, v, dout, valid


def bwd_cost(q, k, valid, causal):
    """(FLOP, bytes) the backward needs on this data: five products of 2 d
    per attended (query, key) pair and head; q, k, v, o, dO read once, dq,
    dk, dv written once, the key mask read once."""
    flops = 2.5 * attn_cost(q, k, valid, causal)[0]
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + \
        valid.numel()
    return flops, nbytes


def sdpa_backward(q, k, v, dout, valid, causal):
    """A call of autograd's backward through PyTorch's
    scaled_dot_product_attention on the same operands (the yardstick)."""
    import torch.nn.functional as F

    B, T, Hq, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    mask = valid[:, None, None, :]
    if causal:
        mask = mask & torch.ones(T, S, dtype=torch.bool,
                                 device=q.device).tril(S - T)
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             enable_gqa=Hq != Hkv)
    g = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def load_old(csrc: Path) -> ctypes.CDLL:
    """DIR/attention_bwd.cu built by nvcc as cuda_build builds the shipped
    one, into a library named by the hash of DIR's sources."""
    h = hashlib.sha1()
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.read_bytes())
    out = cuda_build.BUILD_DIR / f"libattention_bwd_old-{h.hexdigest()[:12]}.so"
    if not out.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(out), str(csrc / "attention_bwd.cu")], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.attention_bwd.argtypes = [P] * 10 + [I] * 8 + [P]
    lib.attention_bwd.restype = I
    return lib


def old_entry(lib, q, k, v, out, dout, valid, causal):
    """The earlier library's C entry on these tensors into new outputs,
    checked once -> (call, (dq, dk, dv))."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    vb = valid.contiguous().view(torch.uint8)
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    stats = torch.empty(B, Hq, T, 4, dtype=torch.float32, device=q.device)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), vb.data_ptr(), *(t.data_ptr() for t in grads),
            stats.data_ptr(), int(q.dtype == torch.bfloat16), B, T, S, Hq,
            Hkv, d, int(causal), torch.cuda.current_stream().cuda_stream]
    call = lambda: lib.attention_bwd(*args)
    cuda_build.check(lib, call(), "old attention_bwd C entry")
    return call, grads


def grad_errors(got, ref, dtype):
    """Max abs error of each of (dq, dk, dv) against the plain version,
    and its bound: 2e-5 of the largest gradient in fp32 (the sums run over
    up to 6 heads x S keys in another order), 2^-7 in bf16 (one rounding
    step)."""
    out = {}
    for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        bound = (2e-5 if dtype == torch.float32 else 2 ** -7) * \
            b.abs().max().item()
        out[name] = (err, bound, a.shape == b.shape)
    return out


def check_row(row, card, dtype=torch.bfloat16, plan=None, seed=0):
    """One row of ROWS: the kernel (under `plan`, None: the shipped plan's)
    against its plain version on the forward's output, and two launches'
    bits -> {grad: (err, bound, same shape)}, "same_bits"; SystemExit on a
    failure."""
    label, causal = row[0], row[7]
    q, k, v, dout, valid = row_inputs(row, dtype, card, seed)
    with torch.no_grad():
        out = ak.attention_fwd(q, k, v, valid, causal)
        got = ak._attention_bwd(q, k, v, out, dout, valid, causal, plan)
        again = ak._attention_bwd(q, k, v, out, dout, valid, causal, plan)
        ref = ak.attention_bwd_plain(q, k, v, out, dout, valid, causal)
    errs = grad_errors(got, ref, dtype)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    for name, (err, bound, shape_ok) in errs.items():
        if not (err <= bound and shape_ok):
            raise SystemExit(f"FAILED: attention_bwd {label} {name} {dtype} "
                             f"{plan}: max_abs_err {err:.3e} > {bound:.3e}")
    if not same:
        raise SystemExit(f"FAILED: attention_bwd {label} {dtype} {plan}: "
                         f"two launches differ")
    return {"errors": errs, "same_bits": same}


def pass_ms(fn, iters=50, attempts=3):
    """Device ms a call of fn, and of each K5 launch in it (PASSES). A
    session in which the profiler saw no device time at all is profiled
    again, `attempts` times at most, and then the run fails."""
    fn()
    for _ in range(attempts):
        _, prof = device_profile(fn, iters, lead=fn)
        total = 1e3 / iters * sum(r[1] for r in prof)
        if total > 0:
            return total, {f"pass_{name}_ms": 1e3 / iters * sum(
                r[1] for r in prof if re.search(pat, r[0]))
                for name, pat in PASSES.items()}
    raise SystemExit(f"FAILED: the profiler saw no device time in "
                     f"{attempts} sessions")


def time_row(row, card, old=None, plans=False, reps=2, seed=2):
    """One row of ROWS: checked (`check_row`), then the shipped kernel's
    device ms a call and per pass, interleaved over `reps` with the
    earlier design's (`old`, a library from load_old), the plain version's
    and SDPA's backward's device ms, the bound; with `plans`, every
    candidate plan's device ms."""
    label, B, T, S, Hq, Hkv, d, causal, _, _ = row
    checked = check_row(row, card)
    q, k, v, dout, valid = row_inputs(row, torch.bfloat16, card, seed)
    plan = ak.attention_bwd_plan(B, T, S, Hq, Hkv, d, causal,
                                 ak._sm_count(card.index or 0))
    res = {"shape": label, "q": [B, T, Hq, d], "kv": [B, S, Hkv, d],
           "causal": causal, "plan": plan._asdict(),
           "partial_bytes": ak.bwd_partial_bytes(plan, B, S, Hkv, d),
           "max_abs_err": max(e[0] for e in checked["errors"].values()),
           "errors": {n: e[:2] for n, e in checked["errors"].items()}}
    with torch.no_grad():
        out = ak.attention_fwd(q, k, v, valid, causal)
        calls = {"": lambda: ak.attention_bwd(q, k, v, out, dout, valid,
                                              causal)}
        if old is not None:
            call, grads = old_entry(old, q, k, v, out, dout, valid, causal)
            calls["old_"] = call
            ref = ak.attention_bwd_plain(q, k, v, out, dout, valid, causal)
            res["old_max_abs_err"] = max(
                e[0] for e in grad_errors(grads, ref, q.dtype).values())
        times = defaultdict(list)
        for rep in range(reps):
            for pre in (list(calls) if rep % 2 else list(calls)[::-1]):
                ms, passes = pass_ms(calls[pre])
                times[pre + "ms"].append(ms)
                if pre == "":
                    for key, val in passes.items():
                        times[key].append(val)
        for key, values in times.items():
            res[key] = float(np.median(values))
            if key.endswith("ms") and not key.startswith("pass"):
                res[key + "_reps"] = values
        res["plain_ms"] = device_ms(lambda: ak.attention_bwd_plain(
            q, k, v, out, dout, valid, causal), 5)
        res["library_ms"] = device_ms(
            sdpa_backward(q, k, v, dout, valid, causal), 50)
        flops, nbytes = bwd_cost(q, k, valid, causal)
        res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes)
        res["flop"], res["bytes"] = flops, nbytes
        if plans:
            sweep = []
            for p in ak.candidate_bwd_plans(B, T, S, Hq, Hkv, d, causal):
                check_row(row, card, plan=p)
                fn = lambda: ak._attention_bwd(q, k, v, out, dout, valid,
                                               causal, p)
                ms, passes = pass_ms(fn)
                sweep.append({**p._asdict(), "ms": ms, **passes,
                              "partial_bytes": ak.bwd_partial_bytes(
                                  p, B, S, Hkv, d)})
            res["plans"] = sweep
            res["fastest_plan"] = min(sweep, key=lambda p: p["ms"])
    return res


def repeat_mismatches(fn, repeats: int, device,
                      flush_bytes: int = 256 << 20) -> int:
    """fn() -> (dq, dk, dv), `repeats` times after a first call, each after
    a write of `flush_bytes` (an L2 flush, so that the blocks' copies land
    in a varying order) -> how many calls' gradients differ from the
    first's in any bit or hold a value that is not finite."""
    first = [t.clone() for t in fn()]
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device=device)
    bad = sum(int((~torch.isfinite(t)).any()) for t in first)
    for _ in range(repeats):
        flush.fill_(1)
        got = fn()
        bad += int(any(not torch.equal(a, b) or not torch.isfinite(a).all()
                       for a, b in zip(got, first)))
    return bad


def repeat_row(row, card, repeats, seed=3):
    """A row of ROWS under its shipped plan -> the calls of `repeats` whose
    gradients differ from the first's (`repeat_mismatches`)."""
    label, B, T, S, Hq, Hkv, d, causal, _, _ = row
    q, k, v, dout, valid = row_inputs(row, torch.bfloat16, card, seed)
    plan = ak.attention_bwd_plan(B, T, S, Hq, Hkv, d, causal,
                                 ak._sm_count(card.index or 0))
    with torch.no_grad():
        out = ak.attention_fwd(q, k, v, valid, causal)
        bad = repeat_mismatches(lambda: ak.attention_bwd(
            q, k, v, out, dout, valid, causal), repeats, card)
    return {"shape": label, "plan": plan._asdict(), "repeats": repeats,
            "mismatched": bad}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", default=None,
                    help="directory of an earlier attention_bwd.cu")
    ap.add_argument("--plans", action="store_true",
                    help="also time every candidate plan of each row")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=0,
                    help="count differing gradients over N repeated calls "
                         "instead of timing")
    ap.add_argument("--fp32", action="store_true",
                    help="also check each row in fp32 (the CUDA-core path)")
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
    cuda_build.load("attention_bwd")
    old = load_old(Path(opts.old_csrc)) if opts.old_csrc else None
    rows = []
    for row in ROWS:
        if opts.repeats:
            plan = ak.attention_bwd_plan(*row[1:8])
            if plan.splits == 1 and "ASR" not in row[0]:
                continue
            print(f"repeating {row[0]}", flush=True)
            rows.append(repeat_row(row, card, opts.repeats))
        else:
            rows.append(time_row(row, card, old, opts.plans, opts.reps))
            if opts.fp32:
                errs = check_row(row, card, torch.float32)["errors"]
                rows[-1]["fp32_errors"] = {n: e[:2] for n, e in errs.items()}
        print(json.dumps(rows[-1]), flush=True)
    result = {"card": smi, "rows": rows}
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

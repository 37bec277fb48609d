"""Device time from torch.profiler with a check that the trace is whole,
and a probe of how often it is not, on one card.

    python -m audio_calm_torch.tools.profiler_probe [--rounds N] [--out FILE]

The tracer (kineto over CUPTI) can lose device records at either end
of a session: those of the first launches, on which it attaches to the
card again, or those of the last, not yet delivered when the window
closes; at times every one, while the host side of each launch is there.
`traced_session` opens the window on a few marker kernels, a synchronize
and a host pause before the work and closes it a host pause after the
work's last synchronize, and `lost_launches` matches each launch call the
work made with its device record by correlation id, so a session that
lost one is known. `device_profile` profiles such a session again;
`device_ms` times work with it, `host_us` times the host's side of a
call, and `bound_ms` is the least time the card could take for a given
work (chip_smoke.py, attention_probe).

The probe runs sessions N rounds over three workloads: `small` (50 chained
512 x 512 fp32 products on the main thread), `threaded` (the same launched
from another Python thread) and, every tenth round, `big` (20,000
elementwise kernels), each `bare` (the work alone in the window) and
`warm` (as `traced_session` opens and closes it). Per workload and
window it counts the sessions with a lost launch record, those that lost
all of them, and the lost records. Prints the card's name and power
limit and last one JSON object, also written to FILE when given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import threading
import time

import torch

MARKER_CYCLES = 1000  # about 0.5 us a marker kernel
WARM_LAUNCHES = 4
PAUSE_S = 0.02  # host time between the window's edges and the work
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, NVIDIA H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3
# the share of a profiled session's launches whose device records may be
# missing from its trace (device_profile)
LOST_SHARE = 1e-3


def traced_session(fn, warm: bool = True, lead=None):
    """fn() under torch.profiler, device activity only -> (profile, host
    wall s of fn ending in a synchronize, host time in ns just before fn).
    `lead`, where given, runs once inside the window after the markers and
    before the opening pause, so that the work's own kernels have each
    been traced once before fn: its launches are not counted as fn's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if warm:
            for _ in range(WARM_LAUNCHES):
                torch.cuda._sleep(MARKER_CYCLES)
            if lead is not None:
                lead()
            torch.cuda.synchronize()
            time.sleep(PAUSE_S)
        torch.cuda.synchronize()
        t_ns = time.time_ns()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if warm:
            time.sleep(PAUSE_S)
    return prof, wall, t_ns


def lost_launches(prof, t_ns: int) -> tuple[int, list[int]]:
    """-> (kernel launch calls made from `t_ns` on, the indices in launch
    order of those without a device record). A launch call and the kernel
    it launched carry one correlation id. The bound sits half the opening
    pause before `t_ns`, wider than any gap between the trace's clock and
    the host's."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    recorded = {e.correlation_id() for e in events
                if e.device_type() == DeviceType.CUDA}
    since = t_ns - int(PAUSE_S / 2 * 1e9)
    calls = sorted((e.start_ns(), e.correlation_id()) for e in events
                   if e.device_type() == DeviceType.CPU
                   and "aunch" in e.name() and e.start_ns() >= since)
    return len(calls), [i for i, (_, c) in enumerate(calls)
                        if c not in recorded]


def device_rows(prof, t_ns: int) -> list:
    """[(kernel or copy, device s, records)] of the device records from
    `t_ns` on (the bound of lost_launches): the work's, not the window's
    markers' or a lead run's, which end a pause earlier."""
    from torch.autograd import DeviceType

    since = t_ns - int(PAUSE_S / 2 * 1e9)
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.start_ns() >= since:
            t, n = rows.get(e.name(), (0, 0))
            rows[e.name()] = (t + e.duration_ns() * 1e-9, n + 1)
    return [(name, t, n) for name, (t, n) in rows.items()]


def launch_offsets_ms(prof, t_ns: int, indices) -> list:
    """The host times (ms after `t_ns`) of the launch calls at `indices`
    in lost_launches' order: where in the session records went missing."""
    from torch.autograd import DeviceType

    since = t_ns - int(PAUSE_S / 2 * 1e9)
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CPU
                    and "aunch" in e.name() and e.start_ns() >= since)
    return [round((starts[i] - t_ns) * 1e-6, 3) for i in indices]


def _log(msg: str) -> None:
    print(msg, flush=True)


def device_profile(fn, iters: int = 1, attempts: int = 5, lead=None,
                   log=_log):
    """fn() `iters` times under torch.profiler, device activity only ->
    (host wall s, [(kernel, device s, calls)] by device time). The device
    time of every kernel and copy counts once (one stream: no overlap);
    host time between launches does not.

    The tracer can lose device records, a few or all of a session's: a
    session in which more than LOST_SHARE of fn's launch calls have no
    device record is logged and profiled again, `attempts` times at most,
    and then the run fails; a smaller loss is logged and kept. The
    window's opening markers are not in the rows; nor is `lead`, run once
    inside the window before the work (device_ms passes fn itself)."""
    for attempt in range(1, attempts + 1):
        prof, wall, t_ns = traced_session(
            lambda: [fn() for _ in range(iters)], lead=lead)
        n, lost = lost_launches(prof, t_ns)
        note = (f"{len(lost)} of {n} launches have no device record (the "
                f"first at launch {lost[0]}, "
                f"{launch_offsets_ms(prof, t_ns, lost[:1])[0]} ms into the "
                f"work)" if lost else "")
        if len(lost) <= LOST_SHARE * n:
            if lost:
                log(f"  profiler session {attempt}: {note}; kept")
            rows = [r for r in device_rows(prof, t_ns)
                    if r[1] > 0 and "spin_kernel" not in r[0]]
            return wall, sorted(rows, key=lambda r: -r[1])
        log(f"  profiler session {attempt} of {attempts}: {note}; "
            f"profiling again")
    raise SystemExit(f"FAILED: the profiler lost device records in "
                     f"{attempts} sessions in a row")


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` runs after one warm-up: the
    sum over the kernels it launches. A loop timed with CUDA events would
    count the host's time to launch them at small shapes."""
    fn()
    _, rows = device_profile(fn, iters, lead=fn)
    return 1e3 * sum(r[1] for r in rows) / iters


def host_us(fns, calls: int = 200, reps: int = 20) -> list:
    """Median host us a call of each of `fns` takes to return, over `reps`
    runs of `calls` calls each started on an idle card, the functions
    taking turns run by run (the host's speed drifts over seconds): the
    launches queue (200 stay well inside the queue's depth), so the card's
    time is not in it."""
    per = [[] for _ in fns]
    for fn in fns:
        fn()
    for _ in range(reps):
        for fn, times in zip(fns, per):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return [sorted(times)[reps // 2] for times in per]


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least device ms for `flops` dense bf16 products' operations and
    `nbytes` moved once, and which of the two sets it."""
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe: no CUDA card is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    x = torch.randn(512, 512, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))

    def small():
        y = x
        for _ in range(50):
            y = y @ x * 1e-3
        return y

    def big():
        y = x
        for _ in range(20000):
            y = y + 1e-6
        return y

    def threaded():
        t = threading.Thread(target=small)
        t.start()
        t.join()

    small(), big()  # warm-up: cuBLAS handle, allocator
    res = {f"{name} {opening}": {"sessions": 0, "with_loss": 0,
                                 "all_lost": 0, "lost_records": 0,
                                 "launches": 0}
           for name in ("small", "threaded", "big")
           for opening in ("bare", "warm")}
    losses = []
    t0 = time.perf_counter()
    for i in range(args.rounds):
        work = [("small", small), ("threaded", threaded)]
        if i % 10 == 0:
            work.append(("big", big))
        for name, fn in work:
            for opening in ("bare", "warm"):
                key = f"{name} {opening}"
                prof, _, t_ns = traced_session(fn, warm=opening == "warm")
                n, lost = lost_launches(prof, t_ns)
                r = res[key]
                r["sessions"] += 1
                r["launches"] += n
                if lost:
                    r["with_loss"] += 1
                    r["all_lost"] += len(lost) == n
                    r["lost_records"] += len(lost)
                    losses.append({"session": key, "round": i,
                                   "age_s": round(time.perf_counter() - t0,
                                                  1),
                                   "launches": n, "lost": len(lost),
                                   "first_lost_at": lost[:4]})
    for key, r in res.items():
        print(f"  {key}: {json.dumps(r)}", flush=True)
    out = {"card": smi, "torch": torch.__version__, "rounds": args.rounds,
           "sessions": res, "losses": losses[:40]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

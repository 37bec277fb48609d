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
lost one is known. `chip_smoke.device_profile` profiles such a session
again.

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


def traced_session(fn, warm: bool = True):
    """fn() under torch.profiler, device activity only -> (profile, host
    wall s of fn ending in a synchronize, host time in ns just before fn)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if warm:
            for _ in range(WARM_LAUNCHES):
                torch.cuda._sleep(MARKER_CYCLES)
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

"""What the run loop's operations cost on the card: the ring's time a hop
and ubench's time a tick under delivery="pallas_mega", and (with --ops)
ubench's tick with the stall watchdog and the metrics exporter on against
off, and the host time of one flight-recorder record and one metrics
refresh.

    python3 profiling/torch_ops.py [--root DIR] [--reps R] [--ops]

`--root DIR` imports ponyc_tpu_torch from another checkout (the parent
commit unpacked with `git archive`, say), so that the parent's run loop
and this one are compared in one call on one card: run parent, change,
change, parent. The ring is 1024 nodes and one token of 4096 hops, `reps`
runs, each from a fresh runtime (chip_smoke.py's ring phase); ubench is
2^20 pingers with 4 pings each, `reps` windows of 64 ticks after 8 warm
ticks (chip_smoke.py's ubench phase). Prints one line a measurement and
one JSON line with every number, the card's name and power limit first.
Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

UBENCH = (1 << 20, 4, 8, 64)     # pingers, pings, warm-up ticks, ticks
RING = (1024, 4096)              # nodes, hops


def _opts(**kw):
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(tuning_cache="off", delivery="pallas_mega", **kw)


def ubench_opts(**kw):
    return _opts(mailbox_cap=4, batch=4, max_sends=1, msg_words=1,
                 spill_cap=1024, inject_slots=8, quiesce_interval=UBENCH[3],
                 **kw)


def ring_opts():
    return _opts(mailbox_cap=8, batch=1, max_sends=1, msg_words=1)


def build_all():
    """Both worlds' window kernels in one parallel build."""
    from ponyc_tpu_torch.models import ring, ubench
    from ponyc_tpu_torch.ops import _build
    from ponyc_tpu_torch.program import Program
    from ponyc_tpu_torch.runtime import engine
    jobs = []
    for atype, rows, o in ((ubench.Pinger, UBENCH[0], ubench_opts()),
                           (ring.RingNode, RING[0], ring_opts())):
        prog = Program(o)
        prog.declare(atype, rows)
        prog.finalize()
        jobs.append(engine.build_multi_step_gated(prog, o).job())
    t0 = time.perf_counter()
    _build.build(jobs)
    print(f"built 2 window kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)


def ring_hops(reps):
    """Seconds a hop of each of `reps` ring runs."""
    import torch
    from ponyc_tpu_torch.models import ring
    ring.run(RING[0], 64, opts=ring_opts())             # warm-up
    out = []
    for _ in range(reps):
        rt, ids = ring.build(RING[0], ring_opts())
        rt.send(int(ids[0]), ring.RingNode.token, RING[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        code = rt.run()
        out.append((time.perf_counter() - t0) / RING[1])
        passes = int(rt.cohort_state(ring.RingNode)["passes"].sum())
        if code != 0 or passes != RING[1]:
            raise AssertionError(f"ring: code {code}, passes {passes}")
    return out


def ubench_ticks(reps, **kw):
    """Seconds a tick of each of `reps` timed windows of ubench, and the
    runtime (for the --ops host timings)."""
    import torch
    from ponyc_tpu_torch.models import ubench
    n, pings, warm, ticks = UBENCH
    rt, ids = ubench.build(n, ubench_opts(**kw), pings=pings)
    ubench.seed_all(rt, ids, hops=1 << 30, pings=pings)
    rt.run(max_steps=warm)
    out = []
    for _ in range(reps):
        p0 = rt.counter("n_processed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.run(max_steps=ticks)
        out.append((time.perf_counter() - t0) / ticks)
        if rt.counter("n_processed") - p0 != n * pings * ticks:
            raise AssertionError("ubench: processed count off")
    return out, rt


def host_costs(rt):
    """Host µs of one flight-recorder record and one metrics refresh."""
    from ponyc_tpu_torch.runtime import engine
    a = engine.StepAux(*([0] * len(engine.StepAux._fields)))
    reps = 20000
    t0 = time.perf_counter()
    for _ in range(reps):
        rt._flight.window(rt.steps_run, 64, 64, 0.0, True, a)
    rec = 1e6 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(20):
        rt._metrics.update_now(rt)
    return rec, 1e6 * (time.perf_counter() - t0) / 20


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ops", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_ops: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    import ponyc_tpu_torch
    root = os.path.dirname(os.path.dirname(ponyc_tpu_torch.__file__))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(f"{card}; ponyc_tpu_torch from {root}", flush=True)
    build_all()
    res = {"card": card, "root": root}
    hops = ring_hops(args.reps)
    res["ring_us_per_hop"] = [1e6 * h for h in hops]
    print(f"ring {RING[0]} nodes {RING[1]} hops pallas_mega: p50 "
          f"{1e6 * statistics.median(hops):.2f} us/hop (runs "
          f"{', '.join(f'{1e6 * h:.2f}' for h in hops)})", flush=True)
    variants = [("off", {})]
    if args.ops:
        on = {"watchdog_s": 5.0, "metrics_port": 0}
        variants = [("off", {}), ("on", on), ("on", on), ("off", {})]
    for label, kw in variants:
        ticks, rt = ubench_ticks(args.reps, **kw)
        res.setdefault(f"ubench_ms_per_tick_{label}", []).extend(
            1e3 * t for t in ticks)
        print(f"ubench 2^20x4 pallas_mega watchdog+metrics {label}: median "
              f"{1e3 * statistics.median(ticks):.4f} ms/tick (windows "
              f"{', '.join(f'{1e3 * t:.4f}' for t in ticks)})", flush=True)
        if label == "on" and "recorder_us" not in res:
            res["recorder_us"], res["refresh_us"] = host_costs(rt)
            print(f"host us: flight-recorder window() "
                  f"{res['recorder_us']:.2f}, metrics refresh "
                  f"{res['refresh_us']:.1f}", flush=True)
        rt.stop()
        del rt
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a sharded world's tick goes on the card: ubench 2^20 x 4 (cap 4,
batch 4) at 1 and at 4 shards, on the plain and the fused path, every
shard on one card (LocalComm).

    python3 profiling/torch_mesh.py [--root DIR] [--reps R] [--ticks T]

For each world: `reps` windows of `ticks` ticks after 4 warm-up ticks,
timed by the host's clock with the card synchronised (ms a tick), then 4
ticks under torch.profiler: the CUDA kernels launched a tick, their
device time a tick (busy), the host's wall a tick in that span, and the
device time of the kernels launched inside the route (`engine._route`'s
segments) and inside the collectives (the mesh's `comm.run`).

`--root DIR` imports ponyc_tpu_torch from another checkout (an earlier
tree unpacked with `git archive`), so that two trees are compared in one
call on one card: run parent, change, change, parent. Prints one line a
world and one JSON line with every number, the card's name and power
limit first. Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

UBENCH = (1 << 20, 4, 4)        # pingers, pings, warm-up ticks
PROFILED = 4                    # ticks under the profiler


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _ranged(name, gen):
    """Run a generator (a tick's route) with each of its segments inside
    a profiler range `name`."""
    from torch.profiler import record_function
    sent = None
    while True:
        with record_function(name):
            try:
                req = gen.send(sent)
            except StopIteration as e:
                return e.value
        sent = yield req


def profile_ticks(rt):
    """Kernels, device and host time a tick over PROFILED ticks, and the
    device time of the route's and the collectives' kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from ponyc_tpu_torch.runtime import engine
    route0 = engine._route
    comm = rt.mesh.comm if rt.mesh is not None else None
    run0 = comm.run if comm is not None else None

    def route(*a, **k):
        return (yield from _ranged("mesh_route", route0(*a, **k)))

    def run(op, xs, dim):
        with record_function("mesh_collective"):
            return run0(op, xs, dim)
    engine._route = route
    if comm is not None:
        comm.run = run
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rt.run(max_steps=PROFILED)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        engine._route = route0
        if comm is not None:
            comm.run = run0
    kernels = busy = 0.0
    ranges = {"mesh_route": 0.0, "mesh_collective": 0.0}
    for evt in prof.key_averages():
        if evt.key in ranges:
            # The host-side range: the device time of the kernels
            # launched inside it (its device-side annotation spans the
            # gaps between them as well, and is not read).
            if evt.device_type == torch.autograd.DeviceType.CPU:
                ranges[evt.key] += float(
                    getattr(evt, "device_time_total", None)
                    or getattr(evt, "cuda_time_total", 0) or 0)
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels += evt.count
            busy += _device_us(evt)
    return {"kernels_per_tick": kernels / PROFILED,
            "busy_ms_per_tick": busy / PROFILED / 1e3,
            "profiled_wall_ms_per_tick": 1e3 * wall / PROFILED,
            "route_device_ms_per_tick": ranges["mesh_route"] / PROFILED
            / 1e3,
            "collective_device_ms_per_tick":
                ranges["mesh_collective"] / PROFILED / 1e3}


def world(fused, shards, reps, ticks):
    import torch
    from ponyc_tpu_torch import RuntimeOptions
    from ponyc_tpu_torch.models import ubench
    n, pings, warm = UBENCH
    opts = RuntimeOptions(mailbox_cap=4, batch=4, max_sends=1, msg_words=1,
                          spill_cap=1024, inject_slots=8,
                          quiesce_interval=ticks, tuning_cache="off",
                          pallas_fused=fused, mesh_shards=shards)
    rt, ids = ubench.build(n, opts, pings=pings)
    ubench.seed_all(rt, ids, hops=1 << 30, pings=pings)
    rt.run(max_steps=warm)
    out = []
    for _ in range(reps):
        p0 = rt.counter("n_processed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.run(max_steps=ticks)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / ticks)
        if rt.counter("n_processed") - p0 != n * pings * ticks:
            raise AssertionError("ubench: processed count off")
    res = {"ms_per_tick": out}
    res.update(profile_ticks(rt))
    rt.stop()
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ticks", type=int, default=32)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_mesh: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    import ponyc_tpu_torch
    root = os.path.dirname(os.path.dirname(ponyc_tpu_torch.__file__))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(f"{card}; ponyc_tpu_torch from {root}", flush=True)
    res = {"card": card, "root": root}
    for fused in (False, True):
        for shards in (1, 4):
            label = f"{'fused' if fused else 'plain'} {shards}"
            r = res[label] = world(fused, shards, args.reps, args.ticks)
            print(f"ubench 2^20x4 {label} shard(s): median "
                  f"{statistics.median(r['ms_per_tick']):.3f} ms/tick "
                  f"(windows {', '.join(f'{t:.3f}' for t in r['ms_per_tick'])}"
                  f"); profiled: {r['kernels_per_tick']:.1f} kernels, "
                  f"busy {r['busy_ms_per_tick']:.3f} ms, wall "
                  f"{r['profiled_wall_ms_per_tick']:.3f} ms, route "
                  f"{r['route_device_ms_per_tick']:.3f} ms, collectives "
                  f"{r['collective_device_ms_per_tick']:.3f} ms a tick "
                  f"[{card}]", flush=True)
            torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Micro-benchmark harness of the PyTorch port — ≙ packages/ponybench
(the counterpart of ``ponyc_tpu/benching.py``; the standard library's
``pkg.use("ponybench")``).

The reference's ponybench runs `MicroBenchmark`s (name/before/apply/
after) with automatic iteration scaling until the measurement is stable,
then reports name, mean time and ops/s; `OverheadBenchmark` subtracts
harness overhead. This twin measures *device work*: it warms caches and
kernel builds out of the measurement, scales repetitions to a minimum
measured window, synchronises the card with torch.cuda.synchronize()
after each window (device work is async — wall-clocking an
unsynchronised launch measures nothing), and reports mean/p50/p95 per
call plus derived ops/s. A function whose results lie on the CPU needs
no synchronisation.

    b = BenchRunner()
    b.bench("tick", fn, *args, items_per_call=N)
    b.report()                                      # table + JSON rows
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._pytree import tree_flatten


def _sync(out, args) -> None:
    """Wait for the card when `out` or the arguments hold CUDA tensors
    (≙ jax.block_until_ready)."""
    for t in tree_flatten((out, args))[0]:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class BenchResult:
    __slots__ = ("name", "reps", "mean_s", "p50_s", "p95_s",
                 "items_per_call", "ops_per_s")

    def __init__(self, name, reps, times, items_per_call):
        self.name = name
        self.reps = reps
        self.mean_s = sum(times) / len(times)
        srt = sorted(times)
        self.p50_s = srt[len(srt) // 2]
        self.p95_s = srt[min(len(srt) - 1, int(len(srt) * 0.95))]
        self.items_per_call = items_per_call
        self.ops_per_s = (items_per_call / self.mean_s
                          if self.mean_s > 0 else float("inf"))

    def row(self) -> Dict[str, Any]:
        return {"name": self.name, "reps": self.reps,
                "mean_us": self.mean_s * 1e6, "p50_us": self.p50_s * 1e6,
                "p95_us": self.p95_s * 1e6, "ops_per_s": self.ops_per_s}


class BenchRunner:
    """≙ ponybench's PonyBench runner with auto-scaling iterations."""

    def __init__(self, *, min_window_s: float = 0.2, max_reps: int = 10000,
                 warmup: int = 3, out=None):
        self.min_window_s = min_window_s
        self.max_reps = max_reps
        self.warmup = warmup
        self.out = out or sys.stdout
        self.results: List[BenchResult] = []

    def bench(self, name: str, fn: Callable, *args,
              items_per_call: int = 1,
              setup: Optional[Callable] = None,
              teardown: Optional[Callable] = None) -> BenchResult:
        """Measure fn(*args). If setup is given it produces fresh args per
        measurement batch (≙ MicroBenchmark.before/after)."""
        if setup is not None:
            args = setup()
            if not isinstance(args, tuple):
                args = (args,)
        for _ in range(self.warmup):                 # builds + caches
            _sync(fn(*args), args)
        # Scale reps until one timing window is long enough to trust
        # (≙ ponybench's auto-scaling loop).
        reps = 1
        while True:
            t0 = time.perf_counter()
            out = None
            for _ in range(reps):
                out = fn(*args)
            _sync(out, args)
            dt = time.perf_counter() - t0
            if dt >= self.min_window_s or reps >= self.max_reps:
                break
            reps = min(self.max_reps,
                       max(reps * 2, int(reps * self.min_window_s
                                         / max(dt, 1e-9))))
        # Measurement: several windows for percentiles.
        times: List[float] = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = None
            for _ in range(reps):
                out = fn(*args)
            _sync(out, args)
            times.append((time.perf_counter() - t0) / reps)
        if teardown is not None:
            teardown(args)
        r = BenchResult(name, reps, times, items_per_call)
        self.results.append(r)
        return r

    def report(self, json_lines: bool = False) -> None:
        w = self.out
        if json_lines:
            for r in self.results:
                print(json.dumps(r.row()), file=w)
            return
        name_w = max((len(r.name) for r in self.results), default=4)
        print(f"{'Benchmark'.ljust(name_w)}  {'mean':>12} {'p50':>12} "
              f"{'p95':>12} {'ops/s':>14}  reps", file=w)
        for r in self.results:
            print(f"{r.name.ljust(name_w)}  {r.mean_s*1e6:>10.2f}us "
                  f"{r.p50_s*1e6:>10.2f}us {r.p95_s*1e6:>10.2f}us "
                  f"{r.ops_per_s:>14.0f}  {r.reps}", file=w)


def compare(base: BenchResult, new: BenchResult) -> float:
    """Speedup of new over base (≙ eyeballing two ponybench rows)."""
    return base.mean_s / new.mean_s if new.mean_s else float("inf")

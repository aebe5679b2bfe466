"""The port's micro-benchmark harness (ponyc_tpu_torch/benching.py ≙
packages/ponybench): the JAX package's tests/test_harnesses.py bench
case on the port, the warm-up kept out of the measurement, repetitions
scaled to the minimum window, mean/p50/p95 with ops/s, setup and
teardown, and `stdlib.pkg.use("ponybench")` / `use("benching")`
resolving to it. The card's synchronisation is tested in
tests/test_torch_cuda.py and chip_smoke.py's `costs` phase."""

import io
import json

import pytest
import torch

from ponyc_tpu_torch.benching import BenchResult, BenchRunner, compare
from ponyc_tpu_torch.stdlib import pkg


def test_bench_runner_scales_and_reports():
    out = io.StringIO()
    b = BenchRunner(min_window_s=0.02, out=out)
    x = torch.arange(4096, dtype=torch.float32)
    r = b.bench("double-sum", lambda v: (v * 2.0).sum(), x,
                items_per_call=x.numel())
    assert r.reps >= 1 and r.mean_s > 0
    assert r.ops_per_s > 0
    b.report()
    b.report(json_lines=True)
    text = out.getvalue()
    assert "double-sum" in text and "ops_per_s" in text


def test_warmup_runs_outside_the_measurement_and_reps_scale():
    calls = []

    def fn(v):
        calls.append(len(calls))
        return v + 1

    b = BenchRunner(min_window_s=0.01, warmup=3, out=io.StringIO())
    r = b.bench("inc", fn, torch.zeros(8))
    # warm-up, the scaling windows, then five measured windows of reps
    assert len(calls) >= 3 + 5 * r.reps
    assert r.reps > 1              # a microsecond call scales past one rep
    assert r.reps * r.mean_s * 5 >= 0.01 * 0.5


def test_stats_and_rows():
    r = BenchResult("x", 10, [4e-6, 1e-6, 2e-6, 3e-6, 5e-6], 100)
    assert r.mean_s == pytest.approx(3e-6)
    assert r.p50_s == 3e-6 and r.p95_s == 5e-6
    assert r.ops_per_s == pytest.approx(100 / 3e-6)
    row = r.row()
    assert set(row) == {"name", "reps", "mean_us", "p50_us", "p95_us",
                        "ops_per_s"}
    assert json.loads(json.dumps(row))["p50_us"] == pytest.approx(3.0)
    fast = BenchResult("y", 10, [1e-6] * 5, 100)
    assert compare(r, fast) == pytest.approx(3.0)


def test_setup_and_teardown_wrap_the_measurement():
    seen = {}

    def setup():
        return (torch.ones(4), 2)

    def teardown(args):
        seen["args"] = args

    b = BenchRunner(min_window_s=0.005, max_reps=64, out=io.StringIO())
    r = b.bench("mul", lambda v, k: v * k, setup=setup, teardown=teardown)
    assert r.reps <= 64
    assert seen["args"][1] == 2 and torch.equal(seen["args"][0],
                                                torch.ones(4))
    assert b.results == [r]


def test_pkg_use_resolves_ponybench():
    import ponyc_tpu_torch.benching as benching
    assert pkg.use("ponybench") is benching
    assert pkg.use("benching") is benching

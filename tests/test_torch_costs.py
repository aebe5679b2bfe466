"""The port's device-cost capture (ponyc_tpu_torch/costs.py): the JAX
package's tests/test_costs.py cases on the port, its six scoreboard
tests aside (the scoreboard waits for the port's bench):

1. measured capture — the byte census of the runtime's REAL step and
   one-tick window (capture / Runtime.measured_costs /
   opts.cost_capture), memoized, never advancing the world;
2. modelled vs measured — the record-move probe's bytes/msg land on
   megakernel.modelled_bytes_per_msg's unpacked bytes, and a seeded
   mismatch trips the loud model_divergence flag;
3. the operational surfaces — /metrics gauges, the flight-recorder
   postmortem's measured section and `doctor --postmortem`;

then the port held against the JAX package on the CPU: the probe is
exactly 4 * record_words bytes a message (the JAX package's within its
tolerance of the same model), divergence gives equal verdicts, and a
world after a capture and a run equals the JAX package's run without
one on the plain, fused and window-kernel paths.
"""

import json
import os
import sys

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu_torch import RuntimeOptions, costs
from ponyc_tpu_torch.models import ring

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_programs as tp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _opts(**kw):
    base = dict(mailbox_cap=8, batch=1, max_sends=1, msg_words=1,
                spill_cap=64, inject_slots=8)
    base.update(kw)
    return RuntimeOptions(**base)


def _ring(**kw):
    rt, ids = ring.build(8, _opts(tuning_cache="off", **kw), device="cpu")
    return rt, ids


@pytest.fixture(scope="module")
def plain_rt():
    """One started ring world shared by the capture-path tests below —
    each test stays independently runnable (capture compiles on demand)
    but a full-file run pays the build + AOT compiles once."""
    rt, ids = _ring()
    yield rt, ids
    rt.stop()


@pytest.fixture(scope="module")
def cc_rt():
    """One cost_capture=True world shared by the eager-capture /
    postmortem / doctor surface tests."""
    rt, ids = _ring(cost_capture=True)
    yield rt, ids
    rt.stop()


# ------------------------------------------------------ measured capture

def test_capture_reads_real_executables_and_memoizes(plain_rt):
    rt, _ = plain_rt
    steps0 = rt.steps_run
    cap = costs.capture(rt)
    # AOT lowering must not advance the world.
    assert rt.steps_run == steps0
    assert cap["version"] == costs.COST_VERSION
    assert set(cap["executables"]) == {"step", "window"}
    for rec in cap["executables"].values():
        assert "error" not in rec
        # Every field is present; what the CPU cannot report (the
        # allocator's peak) is None.
        assert {"flops", "bytes_accessed", "peak_bytes"} <= set(rec)
        assert rec["bytes_accessed"] and rec["bytes_accessed"] > 0
        assert rec["peak_bytes"] is None and rec["flops"] == 0.0
        assert rec["argument_bytes"] == rec["output_bytes"] > 0
        assert rec["kernels"] == {} and rec["ops"] > 0
    # Memoized: same object back, and measured_costs() is the accessor.
    assert costs.capture(rt) is cap
    assert rt.measured_costs() is cap
    assert rt.measured_costs(force=True) is not cap


def test_cost_capture_option_runs_at_start(cc_rt):
    rt, _ = cc_rt
    assert rt._costs is not None
    # start()'s eager capture goes all the way to the judged block.
    assert "model_divergence" in rt._costs


def test_capture_requires_started_runtime():
    from ponyc_tpu_torch import Runtime
    rt = Runtime(_opts(), device="cpu")
    rt.declare(ring.RingNode, 8)
    with pytest.raises(RuntimeError, match="start"):
        costs.capture(rt)


def test_profile_device_writes_trace(plain_rt, tmp_path):
    rt, ids = plain_rt
    rt.send(int(ids[0]), ring.RingNode.token, 500)
    path = rt.profile_device(windows=2, path=str(tmp_path / "xp"),
                             ticks=8)
    assert path == str(tmp_path / "xp")
    with open(path) as f:              # the port writes a Chrome trace
        assert "traceEvents" in json.load(f)
    # the traced windows really advanced the world
    assert rt.steps_run > 0


# -------------------------------------------------- modelled vs measured

def test_record_probe_agrees_with_model_on_cpu():
    """Acceptance: the measured bytes/msg of the canonical record move
    lands on the model's unpacked bytes within tolerance on CPU."""
    opts = _opts()
    probe = costs.record_move_probe(opts, device="cpu")
    from ponyc_tpu_torch.ops.megakernel import (modelled_bytes_per_msg,
                                          record_words)
    assert probe["record_words"] == record_words(opts)
    modelled = modelled_bytes_per_msg(opts, 0.0)["unpacked_bytes"]
    assert probe["bytes_per_msg"] is not None
    assert (abs(probe["bytes_per_msg"] - modelled) / modelled
            <= costs.DIVERGENCE_TOLERANCE)


def test_measured_block_clean_world_does_not_diverge(plain_rt, capsys):
    rt, _ = plain_rt
    blk = costs.measured_block(rt)
    div = blk["model_divergence"]
    assert div["diverged"] is False
    assert div["ratio"] == pytest.approx(1.0, rel=0.5)
    assert blk["modelled"]["unpacked_bytes"] > 0
    assert "MODEL DIVERGENCE" not in capsys.readouterr().err
    # the judged block replaces the bare capture memo
    assert rt._costs is blk


def test_seeded_divergence_trips_the_flag(plain_rt, capsys):
    """A model that prices the record at 10x reality must be called
    out — loudly (stderr) and in the block itself."""
    rt, _ = plain_rt
    fake = {"record_words": 2, "unpacked_bytes": 80.0,
            "packed_bytes": 40.0, "ratio": 2.0, "escape_rate": 0.0}
    blk = costs.measured_block(rt, modelled=fake)
    assert blk["model_divergence"]["diverged"] is True
    assert "MODEL DIVERGENCE" in capsys.readouterr().err


def test_divergence_verdict_edges():
    assert costs.divergence(8.0, 8.1)["diverged"] is False
    assert costs.divergence(8.0, 20.0)["diverged"] is True
    # absence of evidence is not divergence
    none = costs.divergence(8.0, None)
    assert none["diverged"] is False and none["ratio"] is None
    assert costs.divergence(0.0, 8.0)["diverged"] is False


# -------------------------------------------------- operational surfaces

def test_metrics_exports_phases_and_measured_gauges():
    from ponyc_tpu_torch import metrics
    rt, ids = _ring(analysis=1, cost_capture=True)
    rt.send(int(ids[0]), ring.RingNode.token, 20)
    rt.run()
    snap = metrics.snapshot(rt)
    assert snap["phases"]["dispatch"] == 20
    text = metrics.prometheus_text(snap)
    parsed = metrics.parse_prometheus(text)
    assert parsed[("pony_tpu_phase_work_total",
                   (("phase", "delivery"),))] == 20
    assert parsed[("pony_tpu_measured_bytes_accessed",
                   (("executable", "step"),))] > 0
    assert parsed[("pony_tpu_model_divergence", ())] == 0
    rt.stop()


def test_postmortem_carries_and_renders_measured(cc_rt):
    from ponyc_tpu_torch.flight import render_postmortem
    rt, _ = cc_rt
    pm = rt._flight.postmortem("manual")
    assert pm["measured"] is rt._costs
    text = render_postmortem(pm)
    assert "measured [step]" in text
    assert "model vs measured" in text
    # Pre-PR-19 postmortems have no "measured" key: render degrades.
    del pm["measured"]
    assert "measured [" not in render_postmortem(pm)


def test_doctor_renders_measured_from_postmortem_file(cc_rt, tmp_path,
                                                      capsys):
    from ponyc_tpu_torch.__main__ import cmd_doctor
    rt, _ = cc_rt
    path = str(tmp_path / "w.postmortem.json")
    rt._flight.dump("manual", path=path, out=open(os.devnull, "w"))
    assert cmd_doctor(["--postmortem", path]) == 0
    assert "measured [step]" in capsys.readouterr().out


# ---------------------------------------------- the port and the census

def test_capture_failure_is_recorded_per_executable(plain_rt):
    """A capture error is a record, {"error": ...}, not a raise."""
    rt, _ = plain_rt
    step = rt._multi_g.step
    try:
        def broken(*a):
            raise RuntimeError("boom")
        rt._multi_g.step = broken
        cap = costs.capture(rt, force=True)
    finally:
        rt._multi_g.step = step
    assert cap["executables"]["step"] == {"error": "RuntimeError: boom"}
    assert "error" not in cap["executables"]["window"]
    costs.capture(rt, force=True)


def test_a_kernel_launch_that_reports_nothing_fails_the_census():
    from ponyc_tpu_torch.ops import census, mailbox_kernel
    counters = {"drain": lambda: mailbox_kernel.drain_msgs.launches}
    with pytest.raises(census.CensusError, match="reported 0"):
        with census.Census(counters) as c:
            mailbox_kernel.drain_msgs.launches += 1   # a silent launch
        c.check()
    ins, outs = [np_t(4)], [np_t(2)]
    with census.Census(counters) as c:
        mailbox_kernel.drain_msgs.launches += 1
        census.report("drain", ins, outs, flops=0.0)
    c.check()
    assert c.kernels == {"drain": {"launches": 1, "bytes": 24}}
    assert c.bytes == 24 and c.flops == 0.0
    census.report("drain", [np_t(4)], [])    # no census open: a no-op


def np_t(n):
    import torch
    return torch.zeros((n,), dtype=torch.int32)


def test_census_rule_counts_operands_and_outputs():
    """XLA's rule: operand bytes plus output bytes of every op; views
    and allocations move nothing; a pointwise float op is a flop an
    element."""
    import torch
    from ponyc_tpu_torch.ops import census
    a = torch.zeros((4, 8), dtype=torch.float32)
    with census.Census() as c:
        v = a.view(32)[:16]            # views: nothing
        torch.empty((1024,))           # allocation: nothing
        b = v * 2.0                    # 64 + 64 bytes, 16 flops
        b.add_(1.0)                    # in place: 64 + 64, 16 flops
    assert c.bytes == 256 and c.flops == 32.0 and c.ops == 2


def test_record_probe_is_exactly_four_bytes_a_record_word():
    for kw in ({}, {"msg_words": 3}, {"msg_words": 2,
                                      "analysis": 3, "trace_sample": 1}):
        opts = _opts(**kw)
        probe = costs.record_move_probe(opts, device="cpu")
        from ponyc_tpu_torch.ops.megakernel import record_words
        assert probe["bytes_per_msg"] == 4.0 * record_words(opts)


def test_probe_and_divergence_against_the_jax_package():
    from ponyc_tpu import costs as jcosts
    from ponyc_tpu.ops.megakernel import modelled_bytes_per_msg
    opts = _opts()
    jopts = ponyc_tpu.RuntimeOptions(mailbox_cap=8, batch=1, max_sends=1,
                                     msg_words=1, spill_cap=64,
                                     inject_slots=8)
    modelled = modelled_bytes_per_msg(jopts, 0.0)["unpacked_bytes"]
    port = costs.record_move_probe(opts, device="cpu")["bytes_per_msg"]
    ref = jcosts.record_move_probe(jopts)["bytes_per_msg"]
    assert port == modelled
    assert abs(ref - modelled) / modelled <= jcosts.DIVERGENCE_TOLERANCE
    for args in ((8.0, 8.1), (8.0, 20.0), (8.0, None), (0.0, 8.0),
                 (modelled, port), (modelled, ref), (80.0, port),
                 (8.0, 4.0, 0.4)):
        assert costs.divergence(*args) == jcosts.divergence(*args)
    assert costs.COST_VERSION == jcosts.COST_VERSION
    assert costs.DIVERGENCE_TOLERANCE == jcosts.DIVERGENCE_TOLERANCE


PATHS = {"plain": {}, "fused": {"pallas_fused": True},
         "pallas_mega": {"delivery": "pallas_mega"}}


def _ubench_run(pkg, capture=None, **kw):
    mod = __import__(pkg.__name__ + ".models.ubench",
                     fromlist=["ubench"])
    opts = pkg.RuntimeOptions(mailbox_cap=4, batch=4, max_sends=1,
                              msg_words=1, spill_cap=256,
                              inject_slots=16, **kw)
    dev = {"device": "cpu"} if pkg is ponyc_tpu_torch else {}
    rt, ids = mod.build(64, opts, pings=4, **dev)
    mod.seed_all(rt, ids, hops=40, pings=4)
    if capture:
        rt.send(int(ids[0]), mod.Pinger.ping, 3)   # an injection pending
        before = rt.steps_run
        cap = capture(rt)
        assert rt.steps_run == before
        assert all("error" not in r for r in cap["executables"].values())
    else:
        rt.send(int(ids[0]), mod.Pinger.ping, 3)
    code = rt.run()
    st = rt.cohort_state(mod.Pinger)
    return (code, rt.steps_run, {k: np.asarray(v).tolist()
                                 for k, v in st.items()},
            rt.counter("n_processed"), rt.counter("n_delivered"))


@pytest.fixture(scope="module")
def jax_ubench():
    return _ubench_run(ponyc_tpu)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_capture_then_run_equals_the_jax_packages_run(jax_ubench, path):
    """The world a capture leaves behind runs as if it never happened:
    fields, counters and steps_run equal the JAX package's run without
    a capture, on every path (cost_capture=True at start as well)."""
    kw = {**PATHS[path], "tuning_cache": "off"}
    got = _ubench_run(ponyc_tpu_torch,
                      capture=lambda rt: rt.measured_costs(force=True),
                      **kw)
    assert got == jax_ubench
    got = _ubench_run(ponyc_tpu_torch, capture=lambda rt: rt._costs,
                      cost_capture=True, **kw)
    assert got == jax_ubench

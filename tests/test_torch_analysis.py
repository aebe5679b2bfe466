"""Analysis levels 1-3 of the PyTorch port against the JAX package: the
cases of tests/test_analysis.py and tests/test_profiler.py that need no
CLI, flight recorder or cost capture. The same program and seeds run in
both packages (the port on the CPU, its plain path and the fused
kernel's plain version), and Runtime.profile(), the event ring's leaves,
the events CSV's (step, event, actor) rows and the window CSV's
deterministic columns (every column but wall clock, rss and cpu) must be
equal: all integers, exact. Each JAX world runs once per module."""

import os
import signal

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu.models import ring as jring
from ponyc_tpu_torch import analysis as tanalysis
from ponyc_tpu_torch.models import ring as tring
from ponyc_tpu_torch.runtime import engine as tengine

from _torch_programs import (csv_rows, define_telemetry, new_runtime,
                             telemetry_of)

JT, TT = define_telemetry(ponyc_tpu), define_telemetry(ponyc_tpu_torch)
PKGS = {"jax": (ponyc_tpu, JT, jring), "torch": (ponyc_tpu_torch, TT, tring)}
BASE = dict(mailbox_cap=8, batch=1, max_sends=1, msg_words=1, spill_cap=64,
            inject_slots=8)
PATHS = {"plain": {}, "fused": {"pallas_fused": True}}


def _ring(pkg, rmod, n, hops, **kw):
    rt = new_runtime(pkg, dict(BASE, **kw))
    rt.declare(rmod.RingNode, n).start()
    ids = rt.spawn_many(rmod.RingNode, n)
    rt.set_fields(rmod.RingNode, ids, next_ref=np.roll(ids, -1))
    rt.send(int(ids[0]), rmod.RingNode.token, hops)
    return rt


def _drivers(pkg, T, **kw):
    rt = new_runtime(pkg, dict(BASE, max_sends=2, analysis=1,
                               spill_cap=256, inject_slots=32, **kw))
    rt.declare(T.Driver, 4).declare(T.Worker, 2).start()
    ws = rt.spawn_many(T.Worker, 2)
    ds = rt.spawn_many(T.Driver, 4, out=int(ws[0]), left=10)
    rt.set_fields(T.Driver, ds[2:], out=int(ws[1]))
    for w in ws:
        rt.send(int(w), T.Worker.reset, 0)
    for d in ds:
        rt.send(int(d), T.Driver.tick, 0)
    return rt


def _flood(pkg, T, **kw):
    """12 fast senders flooding one slow consumer (mute churn)."""
    rt = new_runtime(pkg, dict(mailbox_cap=2, batch=1, msg_words=1,
                               max_sends=2, spill_cap=512, inject_slots=16,
                               **kw))
    rt.declare(T.FastP, 12).declare(T.SlowP, 1).start()
    s = rt.spawn(T.SlowP)
    fs = rt.spawn_many(T.FastP, 12, out=s, left=30)
    rt.bulk_send(fs, T.FastP.go, np.zeros(12, np.int64))
    return rt


def _events(pkg, T, **kw):
    """Spawn, error and destroy (Boss/Child) beside overload, mute and
    release (the flood), at level 3."""
    rt = new_runtime(pkg, dict(mailbox_cap=4, batch=2, max_sends=2,
                               msg_words=2, spill_cap=256, inject_slots=64,
                               analysis=3, **kw))
    rt.declare(T.Boss, 1).declare(T.Child, 4).declare(T.SlowP, 1) \
      .declare(T.FastP, 8).start()
    boss = rt.spawn(T.Boss)
    sink = rt.spawn(T.SlowP)
    fs = rt.spawn_many(T.FastP, 8, out=int(sink), left=6)
    rt.send(boss, T.Boss.make, 1)
    for f in fs:
        rt.send(int(f), T.FastP.go, 0)
    return rt


def _host(pkg, T, **kw):
    rt = new_runtime(pkg, dict(BASE, msg_words=2, analysis=1, **kw))
    rt.declare(T.DevSrc, 2).declare(T.HostSink, 1).start()
    sink = rt.spawn(T.HostSink)
    for s in rt.spawn_many(T.DevSrc, 2, out=sink):
        rt.send(int(s), T.DevSrc.emit, 3)
    return rt


def _gc(pkg, T, **kw):
    rt = new_runtime(pkg, dict(BASE, msg_words=2, analysis=2, **kw))
    rt.declare(T.Boss, 1).declare(T.Child, 8).start()
    boss = rt.spawn(T.Boss)
    for v in (0, 2, 3):
        rt.send(boss, T.Boss.make, v)
    rt.run()
    assert rt.gc() == 3
    rt.send(boss, T.Boss.make, 9)
    return rt


def _run(kind, pkg, T, rmod, tmp, **kw):
    """One world of `kind` run to its end; returns (telemetry, window CSV
    rows, events CSV rows)."""
    path = os.path.join(tmp, f"{pkg.__name__}-{kind}.csv")
    kw = dict(kw, analysis_path=path)
    if kind == "ring":
        rt = _ring(pkg, rmod, 8, 100, analysis=2, **kw)
    elif kind == "drivers":
        rt = _drivers(pkg, T, **kw)
    elif kind == "flood":
        rt = _flood(pkg, T, analysis=3, analysis_events=8, **kw)
    elif kind == "events":
        rt = _events(pkg, T, **kw)
    elif kind == "host":
        rt = _host(pkg, T, **kw)
    else:
        rt = _gc(pkg, T, **kw)
    code = rt.run(max_steps=30_000)
    out = telemetry_of(rt)
    out["code"] = code
    rt.stop()
    rows = csv_rows(path) if os.path.exists(path) else None
    ev = path + ".events.csv"
    evs = csv_rows(ev, skip=("time_ms",)) if os.path.exists(ev) else None
    return out, rows, evs


KINDS = ("ring", "drivers", "flood", "events", "host", "gc")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("jax"))
    pkg, T, rmod = PKGS["jax"]
    return {k: _run(k, pkg, T, rmod, tmp) for k in KINDS}


@pytest.fixture(scope="module")
def torch_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch"))
    pkg, T, rmod = PKGS["torch"]
    return {(k, p): _run(k, pkg, T, rmod, tmp, **kw)
            for k in KINDS for p, kw in PATHS.items()}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", KINDS)
def test_telemetry_equals_jax(jax_runs, torch_runs, kind, path):
    """profile(), the event ring, the counters, ticks and exit code, and
    both CSVs' deterministic columns equal the JAX package's."""
    want, got = jax_runs[kind], torch_runs[(kind, path)]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]


def test_level2_csv_stream(torch_runs):
    (tel, rows, _), = [torch_runs[("ring", "plain")]]
    assert list(rows[0])[:len(tanalysis.CSV_COLUMNS) - 4] == [
        c for c in tanalysis.CSV_COLUMNS if c not in
        ("time_ms", "rss_kb", "cpu_ms", "host_gap_us")]
    assert "run:RingNode.token" in rows[0]
    assert "qw50:RingNode" in rows[0] and "qw99:RingNode" in rows[0]
    assert sum(int(r["processed"]) for r in rows) == 100
    assert sum(int(r["delivered"]) for r in rows) == 100
    assert sum(int(r["run:RingNode.token"]) for r in rows) == 100
    ph = tel["profile"]["phases"]
    assert ph["delivery"] == ph["drain"] == ph["dispatch"] == 100
    assert ph["gc_mark"] == 0
    c = tel["profile"]["cohorts"]["RingNode"]
    assert c["queue_wait_hist"][0] == 100 and c["queue_wait_p99"] == 1


def test_profile_sums_to_totals(torch_runs):
    prof = torch_runs[("drivers", "plain")][0]["profile"]
    beh = prof["behaviours"]
    assert beh["Driver.tick"]["runs"] == beh["Worker.work"]["runs"] == 40
    assert beh["Worker.reset"]["runs"] == 2
    assert sum(b["runs"] for b in beh.values()) \
        == prof["totals"]["processed"]
    assert sum(b["delivered"] for b in beh.values()) \
        == prof["totals"]["delivered"]
    assert sum(sum(c["queue_wait_hist"]) for c in
               prof["cohorts"].values()) == prof["totals"]["processed"]


def test_backpressure_and_event_ring_overflow(torch_runs):
    """The flooded consumer: rejections blame its behaviour, mute-ticks
    the senders' cohort, its waits pass bucket 0; the 8-entry event ring
    records what fits and counts the rest."""
    tel, _, evs = torch_runs[("flood", "plain")]
    prof = tel["profile"]
    assert prof["behaviours"]["SlowP.eat"]["rejected"] > 0
    assert prof["behaviours"]["FastP.go"]["rejected"] == 0
    assert prof["cohorts"]["FastP"]["mute_ticks"] > 0
    assert sum(prof["cohorts"]["SlowP"]["queue_wait_hist"][1:]) > 0
    assert sum(b["rejected"] for b in prof["behaviours"].values()) \
        == prof["totals"]["rejected"]
    assert evs and tel["events"]["ev_dropped"][0] > 0


def test_level3_per_event_rows(torch_runs):
    tel, _, evs = torch_runs[("events", "plain")]
    kinds = {r["event"] for r in evs}
    assert kinds == {"SPAWN", "DESTROY", "ERROR", "MUTE", "UNMUTE",
                     "OVERLOAD"}
    assert tel["events"]["ev_dropped"] == [0]


def test_host_runs_and_gc_stats(torch_runs):
    prof = torch_runs[("host", "plain")][0]["profile"]
    assert prof["behaviours"]["HostSink.take"]["runs"] == 2
    assert prof["behaviours"]["DevSrc.emit"]["runs"] == 2
    tel, rows, _ = torch_runs[("gc", "plain")]
    assert tel["profile"]["gc"]["passes"] >= 1
    assert tel["profile"]["gc"]["collected"] >= 3
    assert sum(int(r["gc_runs"]) for r in rows) >= 1
    assert sum(int(r["gc_collected"]) for r in rows) >= 3


def test_level0_state_writes_and_costs_nothing(tmp_path, monkeypatch):
    """At analysis 0 the state has no telemetry lanes, profile() raises,
    no file is written, and the step calls none of the telemetry
    functions (each trapped); at analysis 1 the step calls them."""
    def boom(*_a, **_k):
        raise AssertionError("telemetry called at analysis 0")
    for name in ("profile_lanes", "phase_cost_lanes", "trace_span_lanes",
                 "event_ring", "queue_wait_p99"):
        monkeypatch.setattr(tengine, name, boom)
    path = str(tmp_path / "an.csv")
    rt = _ring(ponyc_tpu_torch, tring, 8, 10, analysis=0,
               analysis_path=path)
    assert rt.run() == 0
    rt.stop()
    assert not os.path.exists(path) and rt._analysis is None
    for f in ("beh_runs", "beh_delivered", "beh_rejected",
              "coh_mute_ticks", "qwait_hist", "phase_cost"):
        assert getattr(rt.state, f).numel() == 0
    assert rt.state.qwait_enq == {} and rt.state.ev_data.numel() == 0
    with pytest.raises(RuntimeError, match="analysis >= 1"):
        rt.profile()
    rt = _ring(ponyc_tpu_torch, tring, 8, 10, analysis=1,
               analysis_path=path)
    with pytest.raises(AssertionError, match="telemetry called"):
        rt.run()


def test_dump_and_signal_handler(capfd):
    rt = _ring(ponyc_tpu_torch, tring, 8, 50, analysis=1)
    rt.run()
    a = tanalysis.attach(rt)
    text = a.dump(out=open(os.devnull, "w"))
    assert "actors_alive=8" in text and "n_processed=50" in text
    assert "cohort RingNode" in text and "qw_p99=1" in text
    os.kill(os.getpid(), signal.SIGUSR1)
    assert "ponyc_tpu analysis dump" in capfd.readouterr().err
    a.close()
    signal.signal(signal.SIGUSR1, signal.SIG_DFL)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_chrome_trace_and_top_frame(torch_runs, tmp_path):
    import json
    path = str(tmp_path / "an.csv")
    rt = _ring(ponyc_tpu_torch, tring, 8, 40, analysis=3,
               analysis_path=path)
    rt.run()
    rt.stop()
    out = tanalysis.chrome_trace(path, str(tmp_path / "t.json"))
    evs = json.load(open(out))["traceEvents"]
    assert any(e.get("name") == "behaviour RingNode.token" for e in evs)
    frame = tanalysis.top_frame(path)
    assert "RingNode.token" in frame and "phases" in frame


@pytest.mark.parametrize("kw", [dict(analysis=1), dict(analysis=2),
                                dict(analysis=3, trace_sample=1,
                                     trace_slots=32, analysis_events=16)],
                         ids=["a1", "a2", "traced"])
def test_state_layout_and_interop(kw):
    """The telemetry leaves take the JAX package's sizes, dtypes and
    initial values at every level, and a JAX world carries across
    (interop.state_from_numpy)."""
    import dataclasses

    import jax
    from ponyc_tpu.runtime import state as jstate
    from ponyc_tpu_torch import interop
    from ponyc_tpu_torch.runtime import state as tstate
    rts = []
    for pkg, T in ((ponyc_tpu, JT), (ponyc_tpu_torch, TT)):
        rt = new_runtime(pkg, dict(BASE, msg_words=2, **kw))
        rt.declare(T.DevSrc, 3).declare(T.HostSink, 1).declare(T.Sink, 2)
        rt.program.finalize()
        rts.append(rt)
    jst = jax.device_get(jstate.init_state(rts[0].program, rts[0].opts))
    want = {f.name: getattr(jst, f.name) for f in dataclasses.fields(jst)}
    got = interop.state_to_numpy(
        tstate.init_state(rts[1].program, rts[1].opts, "cpu"))

    def same(a, b, name):
        if isinstance(b, dict):
            assert set(a) == set(b), name
            for k in b:
                same(a[k], b[k], f"{name}.{k}")
        else:
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    same(got, want, "state")
    def copied(x):                    # writable numpy, as torch wants
        return ({k: copied(v) for k, v in x.items()}
                if isinstance(x, dict) else np.array(x))
    carried = interop.state_from_numpy(rts[1].program, rts[1].opts,
                                       copied(want))
    assert carried.span_data.shape == want["span_data"].shape

"""The port's flight recorder and stall watchdog (ponyc_tpu_torch/flight.py
and the run loop's phase stamps), held against the JAX package:

- tests/test_flight.py's cases that apply, on the port: the always-on
  bounded recorder, GC events and host mail, the stop-postmortem round
  trip, the crash dump, fatal error counts, the pure watchdog check and
  its cold grace, a quiet run that never trips, a wedged host behaviour
  and SIGQUIT (both in a subprocess), the doctor CLI;
- the same program on both packages leaves the same window records
  (every field but the clock's), and each package's doctor reads the
  other's postmortems to the same verdict;
- a SIGTERM sent from a host behaviour while a pipelined window is in
  flight, at analysis=1: the process dumps and dies of SIGTERM.

Everything runs on the CPU (device="cpu").
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu import flight as ref_flight
from ponyc_tpu_torch import flight
from ponyc_tpu_torch.errors import ERROR_CODES, PonyStallError
from ponyc_tpu_torch.runtime import engine

from _torch_programs import define, define_ops, new_runtime, ops_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = define(ponyc_tpu_torch)
O = define_ops(ponyc_tpu_torch)


def _ring(n, hops, pkg=ponyc_tpu_torch, T=T, **kw):
    """A ring of `n` RingNodes (tests/test_flight.py's opts) with a token
    of `hops` hops queued."""
    import numpy as np
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=1, max_sends=1,
                               msg_words=1, spill_cap=64, inject_slots=8,
                               **kw))
    rt.declare(T.RingNode, n).start()
    ids = rt.spawn_many(T.RingNode, n)
    rt.set_fields(T.RingNode, ids, next_ref=np.roll(ids, -1))
    if hops:
        rt.send(int(ids[0]), T.RingNode.token, hops)
    return rt


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


# ------------------------------------------------------ recorder basics

def test_recorder_always_on_and_bounded(tmp_path):
    rt = _ring(8, 200, flight_windows=4,
               analysis_path=str(tmp_path / "an.csv"))
    assert rt._flight is not None           # always on
    assert rt.run() == 0
    fr = rt._flight
    assert 1 <= len(fr.windows) <= 4        # bounded by flight_windows
    w = fr.windows[-1]
    assert set(w) >= {"t_ms", "step", "ticks", "budget", "gap_us",
                      "pipelined", "processed", "delivered", "occ_sum",
                      "occ_max", "qw_p99", "flags"}
    assert w["flags"]["exit"]               # the ring exits at hops == 1
    assert w["processed"] == 200
    rt.stop()


def test_recorder_gc_events_and_host_mail(tmp_path):
    rt = new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=8, batch=1, max_sends=1, msg_words=1,
        analysis_path=str(tmp_path / "an.csv")))
    rt.declare(O.HostEcho, 2).start()
    h = rt.spawn(O.HostEcho)
    rt.send(h, O.HostEcho.ping, 3)
    rt.run()
    rt.release([h])
    rt.gc()
    fr = rt._flight
    gc_events = [e for e in fr.events if e["kind"] == "gc"]
    assert gc_events and set(gc_events[0]) >= {
        "collected", "iters", "swept", "converged"}
    assert any(m["behaviour"] == "HostEcho.ping" for m in fr.host_mail)
    rt.stop()


def test_stop_postmortem_dump_roundtrip(tmp_path, capfd):
    path = str(tmp_path / "an.csv")
    rt = _ring(8, 30, analysis_path=path)
    rt.run()
    rt.stop(postmortem=True)
    pm_path = path + ".postmortem.json"
    assert rt._flight.last_dump == pm_path
    pm = flight.load_postmortem(pm_path)
    assert pm["version"] == flight.POSTMORTEM_VERSION
    assert pm["reason"].startswith("stop")
    assert pm["steps_run"] == rt.steps_run
    assert pm["windows"] and pm["options"]["mailbox_cap"] == 8
    assert pm["phase"]["name"] == "idle"
    # The environment block names the torch build and makes no CUDA call.
    assert pm["env"]["torch_version"] and "dev:/dev/nvidiactl" in pm["env"]
    err = capfd.readouterr().err
    assert "flight-recorder postmortem" in err
    line, detail = flight.diagnose_postmortem(pm)
    assert line.startswith("SNAPSHOT")
    assert "windows" in detail


def test_crash_dump_on_fatal_run_error(tmp_path):
    path = str(tmp_path / "an.csv")
    rt = new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=8, batch=1, max_sends=1, msg_words=1,
        analysis_path=path))
    rt.declare(O.Bad, 2).start()
    b = rt.spawn(O.Bad)
    rt.send(b, O.Bad.boom, 1)
    with pytest.raises(ValueError, match="kaboom"):
        rt.run()
    pm = flight.load_postmortem(path + ".postmortem.json")
    assert pm["reason"].startswith("crash: ValueError")
    assert pm["host_mail"][-1]["behaviour"] == "Bad.boom"
    line, _ = flight.diagnose_postmortem(pm)
    assert line.startswith("CRASHED")


def test_error_code_table_matches_reference():
    from ponyc_tpu.errors import ERROR_CODES as REF_CODES
    assert ERROR_CODES == REF_CODES
    assert PonyStallError.code == 7


def test_fatal_errors_count_for_metrics(tmp_path):
    from ponyc_tpu_torch.runtime.runtime import (BlobCapacityError,
                                                 SpawnCapacityError,
                                                 SpillOverflowError)
    rt = _ring(8, 0, analysis_path=str(tmp_path / "a.csv"))
    z = engine.zero_aux("cpu")
    for flag, cls in (("spill_overflow", SpillOverflowError),
                      ("spawn_fail", SpawnCapacityError),
                      ("blob_fail", BlobCapacityError),
                      ("blob_budget_fail", BlobCapacityError)):
        with pytest.raises(cls):
            rt._fatal_checks(z._replace(**{flag: True}))
    assert rt._error_counts == {("SpillOverflowError", 2): 1,
                                ("SpawnCapacityError", 3): 1,
                                ("BlobCapacityError", 4): 2}
    assert sum(e["kind"] == "error" for e in rt._flight.events) == 4
    rt.stop()


def test_host_pony_errors_count(tmp_path):
    rt = new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=8, batch=1, max_sends=1, msg_words=1,
        analysis_path=str(tmp_path / "a.csv")))

    @ponyc_tpu_torch.actor
    class Coded:
        n: ponyc_tpu_torch.I32
        HOST = True

        @ponyc_tpu_torch.behaviour
        def go(self, st, v: ponyc_tpu_torch.I32):
            from ponyc_tpu_torch.errors import PonyError
            raise PonyError(v)

    rt.declare(Coded, 2).start()
    c = rt.spawn(Coded)
    rt.send(c, Coded.go, 42)
    rt.send(c, Coded.go, 42)
    assert rt.run() == 0
    assert rt._error_counts[("PonyError", 42)] == 2
    assert rt.last_error(c) == 42
    rt.stop()


# ------------------------------------------------------------- watchdog

def test_watchdog_check_pure():
    rt = _ring(8, 0, watchdog_s=1.0)
    wd = rt._watchdog
    try:
        now = time.monotonic()
        rt._rl_windows = 5                      # past the cold grace
        rt._wd_stamp = ("host-work", 7, now - 0.5)
        assert wd.check(now) is None
        rt._wd_stamp = ("host-work", 8, now - 1.5)
        trip = wd.check(now)
        assert trip is not None and trip["phase"] == "host-work"
        assert trip["age_s"] >= 1.5 and trip["deadline_s"] == 1.0
        for phase in ("quiescent", "idle"):
            rt._wd_stamp = (phase, 9, now - 1e6)
            assert wd.check(now) is None
        rt._wd_stamp = ("in-flight", 10, now - 1.5)
        rt._controller.window = rt._qi_loaded * 4
        assert wd.check(now) is None            # 4x deadline now
        rt._wd_stamp = ("in-flight", 11, now - 4.5)
        assert wd.check(now) is not None
    finally:
        rt.stop()


def test_watchdog_cold_phase_grace():
    rt = _ring(8, 0, watchdog_s=1.0)
    wd = rt._watchdog
    try:
        now = time.monotonic()
        assert rt._rl_windows == 0
        rt._wd_stamp = ("dispatching", 1, now - 2.0)
        assert wd.check(now) is None            # < 10 s cold deadline
        rt._wd_stamp = ("dispatching", 2, now - 11.0)
        assert wd.check(now) is not None
        rt._wd_stamp = ("host-work", 3, now - 2.0)
        assert wd.check(now) is not None        # no grace for host work
    finally:
        rt.stop()


def test_watchdog_quiet_run_never_trips(tmp_path):
    rt = _ring(8, 50, watchdog_s=5.0, analysis_path=str(tmp_path / "a.csv"))
    assert rt.run() == 0
    assert rt._watchdog.tripped is None
    assert rt._wd_stamp[0] == "idle"
    rt.stop()
    assert rt._watchdog is None                 # stop() reaps the thread


def test_run_loop_stamps_every_phase(tmp_path):
    """The watchdog's evidence: a run stamps dispatching, in-flight,
    host-work and quiescent, and ends idle."""
    rt, _t, _h = ops_world(ponyc_tpu_torch, O,
                           analysis_path=str(tmp_path / "a.csv"))
    seen = []
    stamp = rt._stamp
    rt._stamp = lambda phase: (seen.append(phase), stamp(phase))
    assert rt.run() == 0
    assert {"dispatching", "in-flight", "host-work", "quiescent"} \
        <= set(seen)
    assert seen[-1] == "idle" and rt._wd_stamp[0] == "idle"
    rt.stop()


STALL_SCRIPT = """
import json, sys, time
sys.path.insert(0, {tests!r})
import ponyc_tpu_torch
from ponyc_tpu_torch import Runtime, RuntimeOptions
from ponyc_tpu_torch.errors import PonyStallError

@ponyc_tpu_torch.actor
class Wedge:
    n: ponyc_tpu_torch.I32
    HOST = True

    @ponyc_tpu_torch.behaviour
    def jam(self, st, v: ponyc_tpu_torch.I32):
        time.sleep(600)            # the deliberate stall
        return st

rt = Runtime(RuntimeOptions(
    mailbox_cap=8, batch=1, max_sends=1, msg_words=1, tuning_cache="off",
    watchdog_s=0.6, analysis_path={apath!r}), device="cpu")
rt.declare(Wedge, 2).start()
w = rt.spawn(Wedge)
rt.send(w, Wedge.jam, 1)
t0 = time.monotonic()
try:
    rt.run()
    print("NO-RAISE")
except PonyStallError as e:
    print(json.dumps({{"code": e.code, "phase": e.phase,
                      "postmortem": e.postmortem,
                      "elapsed_s": round(time.monotonic() - t0, 1)}}))
    sys.exit(42)
"""


def test_watchdog_trips_wedged_run_subprocess(tmp_path):
    apath = str(tmp_path / "stall.csv")
    code = STALL_SCRIPT.format(tests=os.path.join(ROOT, "tests"),
                               apath=apath)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT, env=_env())
    assert p.returncode == 42, (p.returncode, p.stdout, p.stderr)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["code"] == ERROR_CODES["PonyStallError"] == 7
    assert out["phase"] == "host-work"
    assert out["elapsed_s"] < 60
    pm = flight.load_postmortem(out["postmortem"])
    assert pm["reason"].startswith("watchdog")
    assert pm["watchdog"]["tripped"]["phase"] == "host-work"
    assert any(e["kind"] == "watchdog_trip" for e in pm["events"])
    line, _ = flight.diagnose_postmortem(pm)
    assert line.startswith("STALLED")
    assert "host behaviour" in line            # the phase hint
    assert "STALLED" in p.stderr


SIGQUIT_SCRIPT = """
import os, signal, sys
import ponyc_tpu_torch
from ponyc_tpu_torch import Runtime, RuntimeOptions

@ponyc_tpu_torch.actor
class Poker:
    n: ponyc_tpu_torch.I32
    HOST = True

    @ponyc_tpu_torch.behaviour
    def poke(self, st, v: ponyc_tpu_torch.I32):
        os.kill(os.getpid(), signal.SIGQUIT)   # the operator hits ^\\\\
        self.exit(0, when=v <= 0)
        self.send(self.actor_id, Poker.poke, v - 1, when=v > 0)
        return st

rt = Runtime(RuntimeOptions(
    mailbox_cap=8, batch=1, max_sends=2, msg_words=1, tuning_cache="off",
    analysis_path={apath!r}), device="cpu")
rt.declare(Poker, 2).start()
p = rt.spawn(Poker)
rt.send(p, Poker.poke, 2)
code = rt.run()
print("EXIT", code, "DUMPS", rt._flight.dumps)
sys.exit(code)
"""


def test_sigquit_dumps_and_continues(tmp_path):
    apath = str(tmp_path / "sq.csv")
    code = SIGQUIT_SCRIPT.format(apath=apath)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT, env=_env())
    assert p.returncode == 0, (p.returncode, p.stdout, p.stderr)
    assert "EXIT 0" in p.stdout
    assert "DUMPS 3" in p.stdout               # one per SIGQUIT
    pm = flight.load_postmortem(apath + ".postmortem.json")
    assert pm["reason"] == "SIGQUIT"
    assert "flight-recorder postmortem" in p.stderr


SIGTERM_SCRIPT = """
import os, signal, sys
sys.path.insert(0, {tests!r})
import ponyc_tpu_torch
from _torch_programs import define_ops, ops_world

O = define_ops(ponyc_tpu_torch)
rt, t, h = ops_world(ponyc_tpu_torch, O, ticks=40, analysis=1,
                     analysis_path={apath!r})
rt.run(max_steps=12)             # the API's ping is handled here
flying = [0]                     # windows dispatched and not retired
dispatch, retire, host = (rt._dispatch_window, rt._retire_window,
                          rt._dispatch_host_msg)

def counted_dispatch(*a, **k):
    flying[0] += 1
    return dispatch(*a, **k)

def counted_retire(*a, **k):
    flying[0] -= 1
    return retire(*a, **k)

def kill_on_mail(aid, *a, **k):
    # The Ticker's mail at its last tick, after pipelined windows.
    print("IN-FLIGHT", flying[0], "STEP", rt.steps_run, flush=True)
    os.kill(os.getpid(), signal.SIGTERM)
    return host(aid, *a, **k)

rt._dispatch_window, rt._retire_window = counted_dispatch, counted_retire
rt._dispatch_host_msg = kill_on_mail
rt.run()
print("SURVIVED-SIGTERM", flush=True)
"""


def test_sigterm_from_host_behaviour_dumps_and_terminates(tmp_path):
    """SIGTERM raised inside a host behaviour while a window is in flight
    (analysis=1): the analysis dump handler sees a consistent world and
    the process still dies of SIGTERM, with no traceback. The signal is
    sent from the program at a known boundary, not from a timer."""
    apath = str(tmp_path / "term.csv")
    code = SIGTERM_SCRIPT.format(tests=os.path.join(ROOT, "tests"),
                                 apath=apath)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT, env=_env())
    assert p.returncode == -signal.SIGTERM, (p.returncode, p.stdout,
                                             p.stderr)
    assert "SURVIVED" not in p.stdout
    assert p.stdout.split()[:2] == ["IN-FLIGHT", "1"], p.stdout
    assert "ponyc_tpu analysis dump" in p.stderr, p.stderr
    assert "Traceback" not in p.stderr, p.stderr


# -------------------------------------------------- probe postmortems

def test_probe_postmortem_and_diagnosis():
    tl = [{"attempt": 1, "timeout_s": 60.0, "t_s": 60.2,
           "error": "torch.cuda.init() did not return within 60s"},
          {"attempt": 2, "timeout_s": 120.0, "t_s": 12.0,
           "error": "probe exited rc=1"}]
    pm = flight.probe_postmortem(tl, {"env": {}, "torch_version": "x"})
    json.dumps(pm)
    assert pm["reason"] == "cuda_init_failed"
    assert pm["phase"]["name"] == "backend-init"
    line, detail = flight.diagnose_postmortem(pm)
    assert line.startswith("STALLED: CUDA backend init failed after 2")
    assert "probe exited rc=1" in line
    assert "attempt 1" in detail


def test_env_snapshot_reads_only_the_environment(monkeypatch):
    """The environment block filters secrets and makes no CUDA call."""
    import torch
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("NVIDIA_API_KEY", "secret")
    monkeypatch.setenv("TPU_NAME", "x")

    def no_cuda(*a, **k):
        raise AssertionError("env_snapshot made a CUDA call")
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr(torch.cuda, "device_count", no_cuda)
    env = flight.env_snapshot()
    assert env["env"] == {"CUDA_VISIBLE_DEVICES": "0"} | {
        k: v for k, v in os.environ.items()
        if k.startswith(("CUDA", "NVIDIA", "TORCH", "PYTORCH"))
        and "KEY" not in k and "TOKEN" not in k and "SECRET" not in k}
    assert env["torch_version"] == str(torch.__version__)


# ---------------------------------------------------------- doctor CLI

def test_doctor_cli_postmortem(tmp_path, capsys):
    from ponyc_tpu_torch.__main__ import main as cli_main
    path = str(tmp_path / "an.csv")
    rt = _ring(8, 20, analysis_path=path)
    rt.run()
    rt.stop(postmortem=True)
    capsys.readouterr()
    assert cli_main(["doctor", "--postmortem",
                     path + ".postmortem.json"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("SNAPSHOT")
    assert "flight-recorder postmortem" in out
    stall = rt._flight.postmortem(
        "watchdog: phase 'in-flight' made no progress for 9.0s "
        "(deadline 3.0s)", phase={"name": "in-flight", "epoch": 9,
                                  "age_s": 9.0})
    spath = str(tmp_path / "stall.json")
    with open(spath, "w") as f:
        json.dump(stall, f)
    assert cli_main(["doctor", "--postmortem", spath]) == 1
    out = capsys.readouterr().out
    assert out.startswith("STALLED") and "mega_window.cu" in out


def test_doctor_cli_usage_errors(tmp_path):
    from ponyc_tpu_torch.__main__ import main as cli_main
    assert cli_main(["doctor"]) == 2
    assert cli_main(["doctor", "--postmortem"]) == 2
    assert cli_main(["doctor", "--postmortem",
                     str(tmp_path / "absent.json")]) == 2
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{}")
    assert cli_main(["doctor", "--postmortem", bad]) == 2


def test_watchdog_option_validation():
    with pytest.raises(ValueError, match="watchdog_s"):
        ponyc_tpu_torch.RuntimeOptions(watchdog_s=0.0)
    with pytest.raises(ValueError, match="flight_windows"):
        ponyc_tpu_torch.RuntimeOptions(flight_windows=0)


# ------------------------------------------------------ cross-package

_WINDOW_KEYS = ("step", "ticks", "budget", "pipelined", "processed",
                "delivered", "occ_sum", "occ_max", "qw_p99", "muted_now",
                "flags")


@pytest.mark.parametrize("delivery", ["plan", "pallas_mega"])
def test_window_records_match_reference(tmp_path, delivery):
    """One program, both packages: the recorder's window records agree
    field for field (the clock's fields aside), and so do the run-loop
    statistics they summarise."""
    recs, stats = {}, {}
    for pkg in (ponyc_tpu, ponyc_tpu_torch):
        Ox = define_ops(pkg)
        rt, _t, _h = ops_world(pkg, Ox, delivery=delivery,
                               analysis_path=str(tmp_path / pkg.__name__))
        assert rt.run() == 0
        recs[pkg.__name__] = [{k: w[k] for k in _WINDOW_KEYS}
                              for w in rt._flight.windows]
        rl = rt.run_loop_stats()
        stats[pkg.__name__] = {k: rl[k] for k in (
            "windows", "pipelined_dispatches", "sync_dispatches",
            "injects_requeued", "window_hist", "controller")}
        rt.stop()
    assert len(recs["ponyc_tpu_torch"]) > 4
    assert any(w["pipelined"] for w in recs["ponyc_tpu_torch"])
    assert any(w["flags"]["host_pending"] for w in recs["ponyc_tpu_torch"])
    assert recs["ponyc_tpu_torch"] == recs["ponyc_tpu"]
    assert stats["ponyc_tpu_torch"] == stats["ponyc_tpu"]


def _verdict(line):
    """A doctor verdict without its phase hint (each package names its
    own phases) and its queue note."""
    line = line.split("; ")[0]
    return re.sub(r"(\(deadline [0-9.]+s\)) \(.*\)$", r"\1", line)


def _postmortems(pkg, T, tmp_path):
    """A stop snapshot, a crash dump and a watchdog-shaped dump written by
    `pkg`'s runtime."""
    Ox = define_ops(pkg)
    path = str(tmp_path / f"{pkg.__name__}.csv")
    rt = _ring(8, 30, pkg=pkg, T=T, analysis_path=path)
    rt.run()
    rt.stop(postmortem=True)
    snap = ref_flight.load_postmortem(path + ".postmortem.json")
    stall = rt._flight.postmortem(
        "watchdog: phase 'in-flight' made no progress for 9.0s "
        "(deadline 3.0s)", phase={"name": "in-flight", "epoch": 9,
                                  "age_s": 9.0})
    crt = new_runtime(pkg, dict(mailbox_cap=8, batch=1, max_sends=1,
                                msg_words=1, analysis_path=path + ".c"))
    crt.declare(Ox.Bad, 2).start()
    crt.send(crt.spawn(Ox.Bad), Ox.Bad.boom, 1)
    with pytest.raises(ValueError):
        crt.run()
    crash = ref_flight.load_postmortem(path + ".c.postmortem.json")
    return {"snapshot": snap, "stall": json.loads(json.dumps(stall)),
            "crash": crash}


def test_postmortems_read_across_packages(tmp_path):
    """A postmortem written by the port reads in the JAX package's
    load_postmortem/diagnose_postmortem to the verdict the port's doctor
    gives, and the other way round."""
    made = {"port": _postmortems(ponyc_tpu_torch, T, tmp_path),
            "ref": _postmortems(ponyc_tpu, define(ponyc_tpu), tmp_path)}
    for writer in ("port", "ref"):
        for kind, pm in made[writer].items():
            path = str(tmp_path / f"{writer}-{kind}.json")
            with open(path, "w") as f:
                json.dump(pm, f)
            a, _ = flight.diagnose_postmortem(flight.load_postmortem(path))
            b, _ = ref_flight.diagnose_postmortem(
                ref_flight.load_postmortem(path))
            assert a.split(":")[0] == b.split(":")[0] == {
                "snapshot": "SNAPSHOT", "stall": "STALLED",
                "crash": "CRASHED"}[kind], (writer, kind, a, b)
            assert _verdict(a) == _verdict(b), (writer, kind, a, b)
            if kind == "stall":       # each names its own phase hint
                assert "mega_window.cu" in a and "mega_window" not in b
    # Both packages write the same fields.
    for kind in ("snapshot", "stall", "crash"):
        assert set(made["port"][kind]) == set(made["ref"][kind])
        assert made["port"][kind]["steps_run"] == \
            made["ref"][kind]["steps_run"]

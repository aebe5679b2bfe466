"""The window kernel's telemetry and trace lanes on the CPU: the kernel's
own source (csrc/mega_window.cu with W::PROF, W::EV and W::TRACE), built
for the host CPU, against its plain version, the port's plain window, on
every window of each world's `Runtime.run()` under
delivery="pallas_mega": every state leaf (the profiler lanes, qwait_enq,
the event and span rings, trace_buf and their counts included), every
aux value (the aggregates and qw_p99 included) and ticks run must be
equal, all integers, exact. Worlds at analysis 1, 3 and traced, with a
span ring and an event ring too small for their run. Also: the JAX
package's window kernel (pallas_mega, interpret mode) against the port's
host build at analysis 1 (the port's counterpart of
tests/test_megakernel.py's phase-lane case), and the fused kernel's host
build tracing through a fused cohort against the JAX package. The worlds
are small and made from numpy seeds. The host-build cases skip where the
box has no host C++ compiler."""

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu_torch import RuntimeOptions
from ponyc_tpu_torch.models import ubench
from ponyc_tpu_torch.ops import _build
from ponyc_tpu_torch.ops import fused_dispatch as tfd

from _torch_programs import (build_walkers, churn, csv_rows, define,
                             define_telemetry, new_runtime, telemetry_of)
from test_torch_mega_host import host_checked  # noqa: F401 (fixture)

TT = define(ponyc_tpu_torch)
TL = define_telemetry(ponyc_tpu_torch)
MEGA = dict(delivery="pallas_mega")
LEVELS = {"a1": dict(analysis=1), "a3": dict(analysis=3),
          "traced": dict(analysis=3, trace_sample=1),
          "overflow": dict(analysis=3, trace_sample=1, analysis_events=16,
                           trace_slots=16)}


def _ran(seen):
    assert seen and sum(k for k, _ in seen) > 0


def _events(rt, path):
    """The (step, event, actor) rows the run's analysis wrote."""
    rt.stop()
    return csv_rows(path + ".events.csv", skip=("time_ms",))


@pytest.mark.parametrize("level", LEVELS)
def test_walkers(host_checked, level, tmp_path):  # noqa: F811
    """Spill, mute and release over a random functional graph."""
    rt = build_walkers(ponyc_tpu_torch, TT, 7, n_seeds=30, mailbox_cap=2,
                       batch=1, msg_words=1, max_sends=2, spill_cap=512,
                       inject_slots=16, quiesce_interval=8, **MEGA,
                       analysis_path=str(tmp_path / "an.csv"),
                       **LEVELS[level])
    rt.run(max_steps=120)
    _ran(host_checked)
    tel = telemetry_of(rt)
    assert tel["profile"]["totals"]["rejected"] > 0
    rt.stop()
    if level == "overflow":
        assert tel["events"]["ev_dropped"][0] > 0 and tel["span_dropped"] > 0


@pytest.mark.parametrize("level", ("a3", "traced"))
def test_churn_spawn_destroy(host_checked, level, tmp_path):  # noqa: F811
    """Device spawns and destroys (spawn and destroy events; the
    constructor messages carry the trace)."""
    path = str(tmp_path / "an.csv")
    rt, _sink, total, hits = churn(ponyc_tpu_torch, TT, 5,
                                   quiesce_interval=4, **MEGA,
                                   analysis_path=path, **LEVELS[level])
    assert rt.run(max_steps=400) == 0
    _ran(host_checked)
    tel = telemetry_of(rt)
    assert {"SPAWN", "DESTROY"} <= {r["event"] for r in _events(rt, path)}
    if level == "traced":
        assert all(n > 1 for n, _l, _p in tel["traces"].values())


def test_errors_and_host_rows(host_checked, tmp_path):  # noqa: F811
    """Error events (Child.init) beside a host cohort's rows: trace_buf of
    the host rows, odd host spans, a trace back onto the device."""
    path = str(tmp_path / "an.csv")
    rt = new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=4, batch=2, max_sends=2, msg_words=2, spill_cap=64,
        inject_slots=16, quiesce_interval=4, analysis_path=path, **MEGA,
        **LEVELS["traced"]))
    rt.declare(TL.Boss, 1).declare(TL.Child, 4).declare(TL.Sink, 1) \
      .declare(TL.HostRelay, 1).start()
    boss = rt.spawn(TL.Boss)
    sink = rt.spawn(TL.Sink)
    hr = rt.spawn(TL.HostRelay, out=sink)
    rt.send(boss, TL.Boss.make, 1)
    rt.send(hr, TL.HostRelay.relay, 5)
    assert rt.run(max_steps=200) == 0
    _ran(host_checked)
    tel = telemetry_of(rt)
    assert "ERROR" in {r["event"] for r in _events(rt, path)}
    paths = {p[-1] for _n, _l, p in tel["traces"].values()}
    assert "Sink.take" in paths and "Child.init" in paths
    assert rt.state_of(sink) == {"n": 5}


def test_ubench_analysis1(host_checked):  # noqa: F811
    opts = RuntimeOptions(mailbox_cap=4, batch=2, max_sends=1, msg_words=1,
                          spill_cap=64, inject_slots=8, quiesce_interval=4,
                          tuning_cache="off", analysis=1, **MEGA)
    rt, ids = ubench.build(16, opts, pings=2, device="cpu")
    ubench.seed_all(rt, ids, hops=1000, pings=2)
    rt.run(max_steps=12)
    _ran(host_checked)
    prof = rt.profile()
    assert sum(b["runs"] for b in prof["behaviours"].values()) \
        == rt.counter("n_processed") == 16 * 2 * 12


def test_jax_window_kernel_phase_lanes_equal_host_build():
    """tests/test_megakernel.py's phase-lane case on both kernels: 3
    windows of 4 ticks of 16 pingers at analysis 1, the JAX package's
    pallas_mega (interpret mode) against the port's host build: every
    state leaf (phase_cost counting) and the aux equal."""
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernel's source")
    import jax.numpy as jnp
    from ponyc_tpu.models import ubench as jubench
    from test_torch_megakernel import OKW, _same_state
    from ponyc_tpu_torch.runtime import engine as tengine
    jrt, jids = jubench.build(16, ponyc_tpu.RuntimeOptions(
        **OKW, delivery="pallas_mega", analysis=1), pings=2)
    jubench.seed_all(jrt, jids, hops=1000, pings=2)
    trt, tids = ubench.build(16, RuntimeOptions(
        **OKW, delivery="pallas_mega", analysis=1), pings=2, device="cpu")
    ubench.seed_all(trt, tids, hops=1000, pings=2)
    jst, tst = jrt.state, trt.state
    for w in range(3):
        jst, jaux, jk = jrt._multi(jst, *jrt._empty_inject, jnp.int32(4))
        tst, taux, tk = trt._multi_g.run_host(
            tst, *trt._empty_inject, 4, True, tengine.zero_aux("cpu"))
        assert int(jk) == int(tk) == 4
        for f in tengine.StepAux._fields:
            assert int(getattr(taux, f)) == int(getattr(jaux, f)), f
    _same_state(tst, jst)
    assert int(tst.phase_cost.sum()) > 0


def test_fused_kernel_host_build_traces_like_jax(monkeypatch, tmp_path):
    """Tracing through a fused cohort (tests/test_tracing.py:99): the
    fused kernel's own source, built for the host CPU, emits its outbox
    in the rows-minor [batch, ms, rows] order the trace words assume, so
    the spans equal the JAX package's."""
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernel's source")
    libs = {}

    def host(self, *args):
        if self.name not in libs:
            libs[self.name] = self.bind(
                _build.build([self.job(host=True)])[0])
        return self._launch(libs[self.name], *args, host=True)

    monkeypatch.setattr(tfd.FusedDispatch, "__call__", host)
    tels = []
    for pkg, T, kw in ((ponyc_tpu, define_telemetry(ponyc_tpu), {}),
                       (ponyc_tpu_torch, TL, dict(pallas_fused=True))):
        rt = new_runtime(pkg, dict(mailbox_cap=8, batch=2, max_sends=2,
                                   msg_words=1, spill_cap=64,
                                   inject_slots=8, **LEVELS["traced"],
                                   analysis_path=str(tmp_path / "an.csv"),
                                   **kw))
        rt.declare(T.Fan, 4).declare(T.Sink, 2).start()
        sinks = rt.spawn_many(T.Sink, 2)
        fans = rt.spawn_many(T.Fan, 4, a=int(sinks[0]), b=int(sinks[1]))
        for k, f in enumerate(fans):
            rt.send(int(f), T.Fan.go, 3 + k)
            rt.send(int(f), T.Fan.go, 10 + k)
        rt.run(max_steps=100)
        tels.append(telemetry_of(rt))
        rt.stop()
    assert [f.name for f in rt._multi_g.fused] == ["Fan", "Sink"]
    assert libs and tels[1] == tels[0]
    assert len(tels[0]["traces"]) == 8 and np.all(
        [n == 4 for n, _l, _p in tels[0]["traces"].values()])

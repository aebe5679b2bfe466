"""The port's metrics and health export (ponyc_tpu_torch/metrics.py), held
against the JAX package: tests/test_metrics.py's cases on the port
(Prometheus text that equals Runtime.profile(), scrapes while run() is
live, the /healthz ok → stalled and ok → degraded flips, the HTTP
surface, the level-0 snapshot, the parser, the doctor against a live
endpoint, option validation), the observability options leaving the
window kernel's source unchanged, and the same metric families with the
same values from both packages for one program at analysis=1.

Everything runs on the CPU (device="cpu"); the exporters listen on
127.0.0.1 only.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu_torch import metrics
from ponyc_tpu_torch.metrics import parse_prometheus, prometheus_text

from _torch_programs import define, define_ops, new_runtime, ops_world

T = define(ponyc_tpu_torch)


def _ring(n, hops, pkg=ponyc_tpu_torch, T=T, **kw):
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=1, max_sends=1,
                               msg_words=1, spill_cap=64, inject_slots=8,
                               **kw))
    rt.declare(T.RingNode, n).start()
    ids = rt.spawn_many(T.RingNode, n)
    rt.set_fields(T.RingNode, ids, next_ref=np.roll(ids, -1))
    if hops:
        rt.send(int(ids[0]), T.RingNode.token, hops)
    return rt


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5.0) as r:
        return r.read().decode(), r.headers.get("Content-Type", "")


def test_prometheus_counters_match_profile(tmp_path):
    rt = _ring(8, 120, analysis=1, metrics_port=0,
               analysis_path=str(tmp_path / "a.csv"))
    port = rt._metrics.port
    assert rt.run() == 0
    body, ctype = _get(port, "/metrics")
    assert ctype.startswith("text/plain")
    p = parse_prometheus(body)
    prof = rt.profile()
    t = prof["totals"]
    assert p[("pony_tpu_processed_total", ())] == t["processed"] == 120
    for key in ("delivered", "rejected", "badmsg", "deadletter", "mutes"):
        assert p[(f"pony_tpu_{key}_total", ())] == t[key]
    assert p[("pony_tpu_behaviour_runs_total",
              (("behaviour", "RingNode.token"),))] \
        == prof["behaviours"]["RingNode.token"]["runs"]
    c = prof["cohorts"]["RingNode"]
    assert p[("pony_tpu_queue_wait_ticks",
              (("cohort", "RingNode"), ("quantile", "0.5")))] \
        == c["queue_wait_p50"]
    assert p[("pony_tpu_queue_wait_ticks",
              (("cohort", "RingNode"), ("quantile", "0.99")))] \
        == c["queue_wait_p99"]
    for phase, v in prof["phases"].items():
        assert p[("pony_tpu_phase_work_total", (("phase", phase),))] == v
    rl = rt.run_loop_stats()
    assert p[("pony_tpu_windows_total", ())] == rl["windows"]
    assert p[("pony_tpu_pipelined_dispatches_total", ())] \
        == rl["pipelined_dispatches"]
    assert p[("pony_tpu_health", ())] == 1
    rt.stop()


def test_scrape_during_live_run(tmp_path):
    hops = 1000
    rt = _ring(8, hops, analysis=1, metrics_port=0, quiesce_interval=16,
               analysis_path=str(tmp_path / "a.csv"))
    port = rt._metrics.port
    got = []
    done = threading.Event()

    def scraper():
        while not done.is_set():
            try:
                hz = json.loads(_get(port, "/healthz")[0])
                mx = parse_prometheus(_get(port, "/metrics")[0])
                got.append((hz["status"], hz["phase"], mx))
            except (OSError, urllib.error.URLError):
                pass
            time.sleep(0.01)

    t = threading.Thread(target=scraper, daemon=True)
    t.start()
    assert rt.run() == 0
    done.set()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert got, "no successful scrape during the run"
    assert {s for s, _, _ in got} <= {"ok"}
    assert {ph for _, ph, _ in got} - {"idle"}, "no scrape saw run() live"
    final = parse_prometheus(_get(port, "/metrics")[0])
    assert final[("pony_tpu_processed_total", ())] \
        == rt.profile()["totals"]["processed"] == hops
    mid = [m.get(("pony_tpu_processed_total", ()), 0) for _, _, m in got]
    assert all(0 <= v <= hops for v in mid)
    assert mid == sorted(mid)                 # monotone prefixes
    rt.stop()


def test_healthz_flips_ok_to_stalled(tmp_path):
    rt = _ring(8, 10, analysis=1, metrics_port=0, watchdog_s=30.0,
               analysis_path=str(tmp_path / "a.csv"))
    port = rt._metrics.port
    rt.run()
    hz = json.loads(_get(port, "/healthz")[0])
    assert hz["status"] == "ok" and hz["watchdog"] is not None
    rt._wd_stamp = ("in-flight", 99, time.monotonic() - 120.0)
    trip = rt._watchdog.check()
    assert trip is not None
    rt._watchdog.tripped = trip
    hz2 = json.loads(_get(port, "/healthz")[0])
    assert hz2["status"] == "stalled"
    assert "in-flight" in hz2["reason"]
    assert parse_prometheus(_get(port, "/metrics")[0])[
        ("pony_tpu_health", ())] == 0
    rt._watchdog.tripped = None
    rt._wd_stamp = ("idle", 100, time.monotonic())
    assert json.loads(_get(port, "/healthz")[0])["status"] == "ok"
    rt.stop()


def test_healthz_degraded_on_coded_errors(tmp_path):
    rt = _ring(8, 10, analysis=1, metrics_port=0,
               analysis_path=str(tmp_path / "a.csv"))
    port = rt._metrics.port
    rt.run()
    rt._error_counts[("SpillOverflowError", 2)] += 1
    rt._metrics.update_now(rt)
    hz = json.loads(_get(port, "/healthz")[0])
    assert hz["status"] == "degraded"
    assert "SpillOverflowError" in hz["reason"]
    mx = parse_prometheus(_get(port, "/metrics")[0])
    assert mx[("pony_tpu_errors_total",
               (("class", "SpillOverflowError"), ("code", "2")))] == 1
    assert mx[("pony_tpu_health", ())] == 0.5
    rt.stop()


def test_http_surface_shapes(tmp_path):
    rt = _ring(8, 0, metrics_port=0, analysis_path=str(tmp_path / "a.csv"))
    port = rt._metrics.port
    body, ctype = _get(port, "/healthz")
    assert ctype.startswith("application/json")
    assert set(json.loads(body)) >= {"status", "reason", "phase", "steps"}
    assert "# TYPE pony_tpu_steps_total counter" in _get(port, "/")[0]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(port, "/nope")
    assert ei.value.code == 404
    rt.stop()
    with pytest.raises((OSError, urllib.error.URLError)):
        _get(port, "/healthz")
    assert rt._metrics is None


def test_snapshot_degrades_at_analysis0(tmp_path):
    rt = _ring(8, 40, analysis=0, metrics_port=0,
               analysis_path=str(tmp_path / "a.csv"))
    rt.run()
    p = parse_prometheus(_get(rt._metrics.port, "/metrics")[0])
    assert p[("pony_tpu_processed_total", ())] == 40
    assert ("pony_tpu_behaviour_runs_total",
            (("behaviour", "RingNode.token"),)) not in p
    snap = metrics.snapshot(rt)
    assert "net" not in snap and "serving" not in snap \
        and "measured" not in snap
    rt.stop()


def test_parse_prometheus_and_escaping():
    snap = {"totals": {"processed": 3}, "steps": 7,
            "behaviours": {'T"x\\y.beh': {"runs": 2, "rejected": 0}},
            "errors": [{"class": "PonyError", "code": 9, "count": 4}]}
    p = parse_prometheus(prometheus_text(snap, {"status": "degraded"}))
    assert p[("pony_tpu_processed_total", ())] == 3
    assert p[("pony_tpu_errors_total",
              (("class", "PonyError"), ("code", "9")))] == 4
    assert p[("pony_tpu_health", ())] == 0.5
    assert p[("pony_tpu_behaviour_runs_total",
              (("behaviour", 'T"x\\y.beh'),))] == 2


def test_observability_options_keep_the_kernels():
    """The whole layer is host-side: the window kernel's source and the
    plain step's outputs are the same with the options set."""
    def kernel(**kw):
        rt = _ring(8, 0, delivery="pallas_mega", **kw)
        src = rt._multi_g.source("cuda")
        rt.stop()
        return src

    assert kernel(flight_windows=4, watchdog_s=2.5, metrics_port=0) \
        == kernel()


def test_doctor_cli_live_endpoint(tmp_path, capsys):
    from ponyc_tpu_torch.__main__ import main as cli_main
    rt = _ring(8, 15, analysis=1, metrics_port=0,
               analysis_path=str(tmp_path / "a.csv"))
    port = rt._metrics.port
    rt.run()
    assert cli_main(["doctor", f"127.0.0.1:{port}"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("OK:")
    assert "pony_tpu_processed_total = 15" in out
    rt._error_counts[("SpillOverflowError", 2)] += 1
    rt._metrics.update_now(rt)
    assert cli_main(["doctor", f"http://127.0.0.1:{port}/metrics"]) == 1
    assert capsys.readouterr().out.startswith("DEGRADED:")
    rt.stop()
    assert cli_main(["doctor", f"127.0.0.1:{port}"]) == 2


def test_metrics_option_validation():
    with pytest.raises(ValueError, match="metrics_port"):
        ponyc_tpu_torch.RuntimeOptions(metrics_port=70000)
    with pytest.raises(ValueError, match="metrics_port"):
        ponyc_tpu_torch.RuntimeOptions(metrics_port=-1)


# Families whose values are the host's clock.
_WALL = ("pony_tpu_host_gap_us_total",)


def test_same_families_and_values_as_reference(tmp_path):
    """One program at analysis=1 on both packages: the scraped families
    and every value but the host's clock agree."""
    scraped = {}
    for pkg in (ponyc_tpu, ponyc_tpu_torch):
        O = define_ops(pkg)
        rt, _t, _h = ops_world(pkg, O, analysis=1, metrics_port=0,
                               analysis_path=str(tmp_path / pkg.__name__))
        assert rt.run() == 0
        scraped[pkg.__name__] = parse_prometheus(
            _get(rt._metrics.port, "/metrics")[0])
        rt.stop()
    port, ref = scraped["ponyc_tpu_torch"], scraped["ponyc_tpu"]
    assert set(port) == set(ref)
    assert {k[0] for k in port} >= {
        "pony_tpu_processed_total", "pony_tpu_behaviour_runs_total",
        "pony_tpu_queue_wait_ticks", "pony_tpu_windows_total",
        "pony_tpu_window_length", "pony_tpu_health"}
    assert port[("pony_tpu_host_processed_total", ())] == 2
    assert {k: v for k, v in port.items() if k[0] not in _WALL} \
        == {k: v for k, v in ref.items() if k[0] not in _WALL}

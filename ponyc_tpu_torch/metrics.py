"""Metrics / health export — a scrapeable operational surface for a
runtime that serves traffic (the port's own copy of
``ponyc_tpu/metrics.py``: same functions, metric families and health
verdicts).

``RuntimeOptions(metrics_port=N)`` starts a stdlib-only HTTP thread on
127.0.0.1:N (0 = ephemeral — read ``rt._metrics.port`` back) serving:

- ``/metrics`` — Prometheus text exposition of the runtime's counters:
  processed/delivered/rejected/badmsg/deadletter/mutes, per-behaviour
  runs, per-cohort queue-wait p50/p99 + mute ticks, per-phase work, GC
  passes, windows retired, window length, host gap, event-/span-ring
  drops, and coded errors by class
  (``pony_tpu_errors_total{class=...,code=...}``, errors.ERROR_CODES).
- ``/healthz`` — a JSON verdict: ``ok`` / ``degraded`` (drops or coded
  errors recorded) / ``stalled`` (the flight.py watchdog tripped, or an
  armed phase stamp has gone silent past the deadline), with the reason.

Scrapes NEVER touch the device: the run loop pushes a snapshot at
window boundaries (``MetricsServer.maybe_update``, at most every
REFRESH_S) and the HTTP thread renders the latest one. The health
verdict reads only host attributes (the phase stamp tuple, the watchdog
trip record), so ``/healthz`` keeps answering — and flips to
``stalled`` — while the card is wedged solid. With ``metrics_port=None``
nothing starts. The net and serving blocks are the front door's
(``rt.net``, ``rt._serve``: net/, serve.py), the measured block cost
capture's (``rt._costs``: costs.py). The snapshot reads all three
through getattr, so a runtime without them leaves them out.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from .flight import ARMED_PHASES

# Minimum seconds between full snapshot refreshes pushed by the run
# loop (a busy pipelined loop retires windows every few tens of µs;
# re-fetching the behaviour matrix per window would tax the boundary).
REFRESH_S = 0.5

# Consecutive snapshots over which monotonically-growing net egress
# backlog (Net.pending_total) flips /healthz to degraded: a consumer
# has stopped reading and the per-connection buffers only grow.
PENDING_WINDOW = 5


# ---- snapshotting (run-loop thread only: may fetch device counters) ----

def snapshot(rt) -> Dict[str, Any]:
    """One metrics snapshot from a runtime, taken at a host boundary.
    Uses Runtime.profile()'s device fetch when the profiler lanes exist
    (analysis >= 1); degrades to host-side totals at level 0."""
    snap: Dict[str, Any] = {
        "time": time.time(),
        "steps": int(rt.steps_run),
        "behaviours": {},
        "cohorts": {},
        "gc": {},
        "drops": {},
    }
    prof = None
    if rt.opts.analysis >= 1 and rt.state is not None \
            and rt.state.beh_runs.numel():
        try:
            prof = rt.profile()
        except Exception:        # noqa: BLE001 — mid-teardown: degrade
            prof = None
    if prof is not None:
        snap["totals"] = dict(prof["totals"])
        snap["behaviours"] = prof["behaviours"]
        snap["cohorts"] = prof["cohorts"]
        snap["gc"] = dict(prof["gc"])
        snap["phases"] = dict(prof.get("phases") or {})
    else:
        snap["totals"] = {
            "processed": int(rt.totals.get("processed", 0)),
            "delivered": int(rt.totals.get("delivered", 0)),
            "host_processed": int(rt.totals.get("host_processed", 0)),
        }
        snap["gc"] = {"passes": int(rt.totals.get("gc_runs", 0))}
    if rt.opts.analysis >= 3 and rt.state is not None:
        try:
            snap["drops"]["events"] = int(rt.state.ev_dropped.sum())
        except Exception:        # noqa: BLE001
            pass
    tracer = getattr(rt, "_tracer", None)
    if tracer is not None:
        snap["drops"]["spans"] = int(tracer.dropped)
    snap["run_loop"] = rt.run_loop_stats()
    snap["queues"] = {"inject": len(rt._inject_q),
                      "fast": len(rt._host_fast_q)}
    net = getattr(rt, "net", None)
    if net is not None:
        # Egress backpressure: unflushed bytes across every live
        # connection — host attribute walk, no device.
        snap["net"] = {"pending_bytes": int(net.pending_total()),
                       "conns": len(net._conns)}
    srv = getattr(rt, "_serve", None)
    if srv is not None:
        snap["serving"] = srv.stats()
    # Measured device costs (opts.cost_capture or
    # Runtime.measured_costs(); costs.py): a host attribute read here,
    # never a census run.
    costs = getattr(rt, "_costs", None)
    if costs is not None:
        snap["measured"] = costs
    snap["errors"] = [
        {"class": cls, "code": int(code), "count": int(n)}
        for (cls, code), n in sorted(rt._error_counts.items())]
    return snap


# ---- health verdict (any thread: host attributes only) ----

def health(rt) -> Dict[str, Any]:
    """The /healthz verdict. `stalled` when the watchdog tripped or an
    armed phase stamp is silent past 2x the effective deadline (belt
    and braces: the trip should land first); `degraded` when coded
    errors or ring drops are on record; else `ok`."""
    wd = getattr(rt, "_watchdog", None)
    phase, epoch, t = getattr(rt, "_wd_stamp", ("idle", 0, 0.0))
    age = max(0.0, time.monotonic() - t) if t else 0.0
    mx = getattr(rt, "_metrics", None)
    snap = mx._snap if mx is not None else {}
    status, reason = "ok", ""
    if wd is not None and wd.tripped is not None:
        status = "stalled"
        reason = (f"watchdog tripped: phase {wd.tripped['phase']!r} "
                  f"silent for {wd.tripped['age_s']}s")
    elif wd is not None and phase in ARMED_PHASES \
            and age > 2 * wd.effective_deadline():
        status = "stalled"
        reason = f"phase {phase!r} stamp silent for {age:.1f}s"
    else:
        errs = snap.get("errors") or [
            {"class": cls, "code": code, "count": n}
            for (cls, code), n in getattr(rt, "_error_counts",
                                          {}).items()]
        drops = snap.get("drops") or {}
        pend = list(mx._pending_hist) if mx is not None else []
        pend_growing = (len(pend) >= PENDING_WINDOW
                        and all(b > a for a, b in zip(pend, pend[1:]))
                        and pend[-1] > 0)
        if errs:
            e = errs[-1]
            status = "degraded"
            reason = (f"{sum(x['count'] for x in errs)} coded error(s) "
                      f"recorded (latest {e['class']}, code {e['code']})")
        elif pend_growing:
            status = "degraded"
            reason = (f"egress backpressure: net pending bytes grew "
                      f"monotonically across {len(pend)} snapshots "
                      f"(now {pend[-1]}) — a consumer stopped reading")
        elif any(int(v) for v in drops.values()):
            status = "degraded"
            reason = "telemetry ring drops: " + ", ".join(
                f"{k}={v}" for k, v in drops.items() if int(v))
    ck = getattr(rt, "_ckpt", None)
    ck_info = ck.info() if ck is not None else None
    return {
        "status": status,
        "reason": reason,
        "phase": phase,
        "phase_age_s": round(age, 3),
        "steps": int(getattr(rt, "steps_run", 0)),
        "snapshot_age_s": (round(time.time() - snap["time"], 3)
                           if snap.get("time") else None),
        # Durable worlds: how stale a crash-restore would be. None =
        # checkpointing off; alert on staleness > 2-3 cadences.
        "last_checkpoint_age_s": (ck_info.get("age_s")
                                  if ck_info is not None else None),
        "last_checkpoint_path": (ck_info.get("path")
                                 if ck_info is not None else None),
        "watchdog": wd.snapshot() if wd is not None else None,
    }


# ---- Prometheus text exposition ----

def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def prometheus_text(snap: Dict[str, Any],
                    hz: Optional[Dict[str, Any]] = None) -> str:
    """Render a snapshot (+ optional health verdict) as Prometheus
    text exposition (one metric family per HELP/TYPE pair)."""
    out = []

    def fam(name, kind, help_, rows):
        # rows: [(labels_dict_or_None, value)]
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {kind}")
        for labels, v in rows:
            lab = ""
            if labels:
                lab = "{" + ",".join(
                    f'{k}="{_esc(x)}"'
                    for k, x in sorted(labels.items())) + "}"
            out.append(f"{name}{lab} {int(v) if float(v).is_integer() else v}")

    t = snap.get("totals", {})
    for key, help_ in (
            ("processed", "Behaviours dispatched (device)"),
            ("delivered", "Messages delivered to mailboxes"),
            ("rejected", "Deliveries rejected (backpressure)"),
            ("badmsg", "Malformed messages dropped"),
            ("deadletter", "Messages to dead actors dropped"),
            ("mutes", "Sender mute transitions"),
            ("host_processed", "Host-cohort behaviours dispatched")):
        if key in t:
            fam(f"pony_tpu_{key}_total", "counter", help_,
                [(None, t[key])])
    fam("pony_tpu_steps_total", "counter", "Device ticks advanced",
        [(None, snap.get("steps", 0))])
    beh = snap.get("behaviours", {})
    if beh:
        fam("pony_tpu_behaviour_runs_total", "counter",
            "Dispatches per behaviour (profiler matrix)",
            [({"behaviour": n}, b["runs"]) for n, b in sorted(beh.items())])
        fam("pony_tpu_behaviour_rejected_total", "counter",
            "Rejected deliveries per behaviour",
            [({"behaviour": n}, b["rejected"])
             for n, b in sorted(beh.items())])
    coh = snap.get("cohorts", {})
    if coh:
        fam("pony_tpu_queue_wait_ticks", "gauge",
            "Queue-wait percentiles per cohort (2^k bucket low, ticks)",
            [({"cohort": c, "quantile": q}, v[key])
             for c, v in sorted(coh.items())
             for q, key in (("0.5", "queue_wait_p50"),
                            ("0.99", "queue_wait_p99"))])
        fam("pony_tpu_mute_ticks_total", "counter",
            "Muted actor-ticks per cohort",
            [({"cohort": c}, v["mute_ticks"])
             for c, v in sorted(coh.items())])
    phases = snap.get("phases") or {}
    if phases:
        fam("pony_tpu_phase_work_total", "counter",
            "Per-phase work units (delivery/drain/dispatch/gc_mark "
            "tick-cost lanes, state.PHASE_NAMES)",
            [({"phase": k}, v) for k, v in sorted(phases.items())])
    measured = snap.get("measured") or {}
    if measured:
        rows_b, rows_f, rows_p = [], [], []
        for exe, rec in sorted((measured.get("executables")
                                or {}).items()):
            if rec.get("bytes_accessed") is not None:
                rows_b.append(({"executable": exe},
                               rec["bytes_accessed"]))
            if rec.get("flops") is not None:
                rows_f.append(({"executable": exe}, rec["flops"]))
            if rec.get("peak_bytes") is not None:
                rows_p.append(({"executable": exe}, rec["peak_bytes"]))
        if rows_b:
            fam("pony_tpu_measured_bytes_accessed", "gauge",
                "Measured bytes accessed per compiled executable "
                "(cost capture)", rows_b)
        if rows_f:
            fam("pony_tpu_measured_flops", "gauge",
                "Measured flops per compiled executable",
                rows_f)
        if rows_p:
            fam("pony_tpu_measured_peak_bytes", "gauge",
                "Device working set per compiled executable",
                rows_p)
        div = measured.get("model_divergence") or {}
        if div.get("ratio") is not None:
            fam("pony_tpu_model_divergence_ratio", "gauge",
                "Measured/modelled bytes-per-message ratio "
                "(1.0 = the model holds)", [(None, div["ratio"])])
            fam("pony_tpu_model_divergence", "gauge",
                "1 when measured bytes/msg disagrees with the model "
                "past tolerance", [(None, 1 if div.get("diverged")
                                    else 0)])
    g = snap.get("gc", {})
    if g:
        fam("pony_tpu_gc_passes_total", "counter", "GC passes run",
            [(None, g.get("passes", 0))])
        if "collected" in g:
            fam("pony_tpu_gc_collected_total", "counter",
                "Actors collected", [(None, g["collected"])])
    rl = snap.get("run_loop") or {}
    if rl:
        fam("pony_tpu_windows_total", "counter", "Windows retired",
            [(None, rl.get("windows", 0))])
        fam("pony_tpu_pipelined_dispatches_total", "counter",
            "Windows dispatched behind an in-flight one",
            [(None, rl.get("pipelined_dispatches", 0))])
        fam("pony_tpu_injects_requeued_total", "counter",
            "Gated-out window injections re-queued",
            [(None, rl.get("injects_requeued", 0))])
        fam("pony_tpu_host_gap_us_total", "counter",
            "Cumulative host-imposed device idle (us)",
            [(None, round(rl.get("host_gap_us_total", 0.0), 1))])
        ctrl = rl.get("controller")
        if ctrl:
            fam("pony_tpu_window_length", "gauge",
                "Adaptive quiesce-window length (ticks)",
                [(None, ctrl["window"])])
    q = snap.get("queues") or {}
    if q:
        fam("pony_tpu_queue_depth", "gauge", "Host-side queue depths",
            [({"queue": k}, v) for k, v in sorted(q.items())])
    net = snap.get("net") or {}
    if net:
        fam("pony_tpu_net_pending_bytes", "gauge",
            "Unflushed egress bytes across all connections "
            "(Net.pending backpressure signal)",
            [(None, net.get("pending_bytes", 0))])
        fam("pony_tpu_net_conns", "gauge", "Live net-layer connections",
            [(None, net.get("conns", 0))])
    srv = snap.get("serving") or {}
    if srv:
        fam("pony_tpu_serve_frames_total", "counter",
            "Request frames received by the front door",
            [(None, srv.get("frames", 0))])
        fam("pony_tpu_serve_accepted_total", "counter",
            "Requests admitted past the edge",
            [(None, srv.get("accepted", 0))])
        fam("pony_tpu_serve_replied_total", "counter",
            "OK replies delivered", [(None, srv.get("replied", 0))])
        fam("pony_tpu_serve_shed_total", "counter",
            "Requests shed at the edge, by reason",
            [({"reason": k}, v)
             for k, v in sorted((srv.get("shed") or {}).items())])
        fam("pony_tpu_serve_badframe_total", "counter",
            "Malformed ingress frames",
            [(None, srv.get("badframe", 0))])
        fam("pony_tpu_serve_inflight", "gauge",
            "Requests on the device right now",
            [(None, srv.get("inflight", 0))])
        fam("pony_tpu_serve_queue_depth", "gauge",
            "Admitted requests awaiting a worker",
            [(None, srv.get("queue", 0))])
        adm = srv.get("admission") or {}
        if adm:
            fam("pony_tpu_serve_admit_limit", "gauge",
                "Admission controller concurrency limit",
                [(None, adm.get("limit", 0))])
        lat = srv.get("latency_us") or {}
        if lat.get("n"):
            fam("pony_tpu_serve_latency_us", "gauge",
                "End-to-end request latency percentiles (us, host "
                "clock, bounded reservoir)",
                [({"quantile": "0.5"}, lat["p50"]),
                 ({"quantile": "0.99"}, lat["p99"])])
    drops = snap.get("drops") or {}
    if drops:
        fam("pony_tpu_ring_drops_total", "counter",
            "Bounded telemetry ring drops (events/spans)",
            [({"ring": k}, v) for k, v in sorted(drops.items())])
    errs = snap.get("errors") or []
    if errs:
        fam("pony_tpu_errors_total", "counter",
            "Coded runtime errors (errors.ERROR_CODES)",
            [({"class": e["class"], "code": str(e["code"])}, e["count"])
             for e in errs])
    if hz is not None:
        fam("pony_tpu_health", "gauge",
            "Health verdict: 1 ok, 0.5 degraded, 0 stalled",
            [(None, {"ok": 1, "degraded": 0.5}.get(hz["status"], 0))])
    return "\n".join(out) + "\n"


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str],
                                                         ...]], float]:
    """Tiny exposition-format parser (tests, doctor, bench smoke):
    {(metric_name, sorted_label_items): value}. Ignores comments."""
    import re
    lab_re = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        labels: Tuple[Tuple[str, str], ...] = ()
        name = head
        if "{" in head:
            name, _, rest = head.partition("{")
            body = rest.rsplit("}", 1)[0]
            labels = tuple(sorted(
                (k, v.replace('\\"', '"').replace("\\n", "\n")
                    .replace("\\\\", "\\"))
                for k, v in lab_re.findall(body)))
        try:
            out[(name, labels)] = float(val)
        except ValueError:
            continue
    return out


# ---- the HTTP thread ----

class _Handler(BaseHTTPRequestHandler):
    server_version = "ponyc-torch-metrics/1"

    def do_GET(self):          # noqa: N802 — http.server API
        srv: MetricsServer = self.server.metrics   # type: ignore[attr-defined]
        if self.path.split("?")[0] in ("/metrics", "/"):
            hz = health(srv.rt)
            body = prometheus_text(srv._snap, hz).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path.split("?")[0] == "/healthz":
            hz = health(srv.rt)
            body = (json.dumps(hz) + "\n").encode()
            ctype = "application/json"
        else:
            self.send_error(404, "unknown path (try /metrics, /healthz)")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):     # scrapes must not spam stderr
        pass


class MetricsServer:
    """Per-runtime exporter. Constructed by Runtime.start() when
    opts.metrics_port is not None; `update*` is called from the
    run-loop thread only (it may fetch device counters), the HTTP
    thread only ever reads the last snapshot reference."""

    def __init__(self, rt, port: int):
        self.rt = rt
        self._snap: Dict[str, Any] = {}
        self._last_full = 0.0
        # Net egress-backlog trail: one reading per snapshot refresh;
        # health() flips to degraded when it grows monotonically
        # across the whole window (a consumer stopped reading).
        import collections as _c
        self._pending_hist: "_c.deque" = _c.deque(maxlen=PENDING_WINDOW)
        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._httpd.metrics = self    # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="ponyc-torch-metrics", daemon=True)
        self._thread.start()

    def update_now(self, rt) -> None:
        """Force a full snapshot refresh (run start/end, stop())."""
        try:
            self._snap = snapshot(rt)
            if "net" in self._snap:
                self._pending_hist.append(
                    int(self._snap["net"]["pending_bytes"]))
        except Exception:        # noqa: BLE001 — teardown must not raise
            pass
        self._last_full = time.monotonic()

    def maybe_update(self, rt) -> None:
        """Boundary hook: refresh at most every REFRESH_S — the scrape
        surface trails the run by <1s without taxing a pipelined loop
        that retires windows every few tens of µs."""
        now = time.monotonic()
        if now - self._last_full >= REFRESH_S:
            self.update_now(rt)

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:        # noqa: BLE001
            pass
        self._thread.join(timeout=2.0)


# ---- doctor's live-endpoint reading ----

def fetch_endpoint(url: str, timeout_s: float = 5.0
                   ) -> Tuple[Dict[str, Any], str]:
    """GET /healthz + /metrics from a live exporter. `url` may be
    'host:port', 'http://host:port' or either endpoint path. Returns
    (healthz_dict, metrics_text)."""
    import urllib.request
    base = url if "://" in url else "http://" + url
    for suffix in ("/healthz", "/metrics"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    with urllib.request.urlopen(base + "/healthz",
                                timeout=timeout_s) as r:
        hz = json.loads(r.read().decode())
    with urllib.request.urlopen(base + "/metrics",
                                timeout=timeout_s) as r:
        mx = r.read().decode()
    return hz, mx


def diagnose_endpoint(url: str, timeout_s: float = 5.0
                      ) -> Tuple[str, str, str]:
    """(status, one_line, detail) for a live exporter — the doctor's
    live half. Raises OSError when the endpoint is unreachable."""
    hz, mx = fetch_endpoint(url, timeout_s)
    parsed = parse_prometheus(mx)
    status = hz.get("status", "?")
    bits = [f"phase {hz.get('phase', '?')!r}",
            f"steps {hz.get('steps', '?')}"]
    if hz.get("reason"):
        bits.append(hz["reason"])
    line = f"{status.upper()}: " + "; ".join(bits)
    keys = ("pony_tpu_processed_total", "pony_tpu_delivered_total",
            "pony_tpu_windows_total", "pony_tpu_window_length",
            # Serving front door (serve.py), when attached.
            "pony_tpu_serve_frames_total",
            "pony_tpu_serve_accepted_total",
            "pony_tpu_serve_replied_total",
            "pony_tpu_serve_admit_limit",
            "pony_tpu_net_pending_bytes")
    detail_lines = [f"endpoint: {url}"]
    for k in keys:
        v = parsed.get((k, ()))
        if v is not None:
            detail_lines.append(f"{k} = {int(v)}")
    # Serving verdict colour: shed volume by reason + the shed rate —
    # the first thing an overload postmortem wants to know.
    sheds = {lab: v for (name, lab), v in parsed.items()
             if name == "pony_tpu_serve_shed_total"}
    if sheds:
        total_shed = int(sum(sheds.values()))
        frames = parsed.get(("pony_tpu_serve_frames_total", ()), 0)
        rate = total_shed / frames if frames else 0.0
        detail_lines.append(
            f"serve shed: {total_shed} ({rate:.1%} of frames; "
            + ", ".join(f"{dict(lab).get('reason', '?')}={int(v)}"
                        for lab, v in sorted(sheds.items())) + ")")
    for (name, labels), v in sorted(parsed.items()):
        if name == "pony_tpu_errors_total":
            lab = ", ".join(f"{k}={x}" for k, x in labels)
            detail_lines.append(f"{name}{{{lab}}} = {int(v)}")
    return status, line, "\n".join(detail_lines)

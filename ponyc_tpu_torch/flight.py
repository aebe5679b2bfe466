"""Flight recorder + stall watchdog — the runtime's always-on black box
(the port's own copy of ``ponyc_tpu/flight.py``: same classes, names and
postmortem format, with this card's environment and the port's phases).

Two host-side pieces make a wedged run diagnosable instead of silent:

- **FlightRecorder** — a bounded ring retaining the last
  ``RuntimeOptions(flight_windows)`` retired windows (the control
  scalars the run loop ALREADY fetched per retire: aux flags, counters,
  ticks/budget, host gap), plus bounded rings of runtime events (GC
  passes, coded errors, the watchdog's trip) and recent host-cohort
  mail. Recording is a deque append of host ints; nothing here feeds a
  window, so the kernels and the plain tick run the same code with the
  recorder as without. The ring dumps as a structured postmortem
  (``<analysis_path>.postmortem.json`` + human text on stderr) on a
  crash, on SIGQUIT, on a watchdog trip, and on
  ``Runtime.stop(postmortem=True)``.

- **Watchdog** — a monitor thread that knows the pipelined run loop's
  phases (backend-init / dispatching / in-flight / host-work /
  quiescent / idle) through the phase stamps runtime.py writes at every
  transition (one tuple assignment). A phase that makes no progress
  stamp within ``RuntimeOptions(watchdog_s)`` — scaled by the window
  controller's current/initial window ratio, so a legitimately grown
  window is not misread as a stall — trips: the flight recorder dumps,
  a one-line doctor diagnosis lands on stderr, and the main thread is
  interrupted so Runtime.run()/start() raise an int-coded
  ``errors.PonyStallError`` instead of hanging forever. The run loop
  waits for a window by polling its CUDA event from Python
  (Runtime._wait_event), so the interrupt lands while the card is
  still busy. Quiescent/idle phases never trip.

``python -m ponyc_tpu_torch doctor --postmortem FILE`` renders a dump
into a diagnosis (``diagnose_postmortem`` below). This module reads
host attributes only and makes no CUDA call: a postmortem of a wedged
card must not block on the card.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

POSTMORTEM_VERSION = 1

# Ring capacities for the non-window lanes: small fixed bounds — the
# recorder must never grow with run length.
EVENT_RING = 128
HOST_MAIL_RING = 32

# Phases the watchdog arms on. "quiescent" (waiting on external events)
# and "idle" (no run() in progress) are healthy steady states.
ARMED_PHASES = frozenset({"backend-init", "dispatching", "in-flight",
                          "host-work"})

# Deadline multiplier for COLD device phases (backend init and the
# first window before any retire): start() creates the CUDA context and
# builds the program's kernels with nvcc, and the first window pays the
# caching allocator's first allocations, which must not read as a stall
# under a deadline sized for steady-state windows.
COLD_FACTOR = 10.0

_ENV_PREFIXES = ("CUDA", "NVIDIA", "TORCH", "PYTORCH")
_DEVICE_NODES = ("/dev/nvidia0", "/dev/nvidiactl")


def env_snapshot() -> Dict[str, Any]:
    """The environment block of a postmortem: the CUDA_*, NVIDIA_*,
    TORCH_* and PYTORCH_* variables (secrets filtered), the torch build
    and whether the card's device nodes exist. It makes no CUDA call
    (the versions are constants of the torch build), so it is safe on a
    card that stopped answering."""
    env = {k: v for k, v in sorted(os.environ.items())
           if k.startswith(_ENV_PREFIXES)
           and "KEY" not in k and "TOKEN" not in k and "SECRET" not in k}
    details: Dict[str, Any] = {"env": env}
    try:
        import torch
        details["torch_version"] = str(torch.__version__)
        details["torch_cuda"] = torch.version.cuda
    except ImportError:
        details["torch_version"] = details["torch_cuda"] = None
    for dev in _DEVICE_NODES:
        details[f"dev:{dev}"] = os.path.exists(dev)
    return details


class FlightRecorder:
    """Per-runtime bounded black box. All writers run on the run-loop
    thread (window/gc/host-mail records) or the main thread; dump() may
    additionally run on the watchdog thread — deque appends and
    wholesale reads are safe under the GIL, and a postmortem taken
    mid-append only ever misses the newest record."""

    def __init__(self, rt, capacity: int = 64):
        self.rt = rt
        self.windows: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self.events: collections.deque = collections.deque(
            maxlen=EVENT_RING)
        self.host_mail: collections.deque = collections.deque(
            maxlen=HOST_MAIL_RING)
        self.t0 = time.time()
        self.last_dump: Optional[str] = None    # newest postmortem path
        self.dumps = 0

    # -- recording (hot-ish path: host ints only, one deque append) --
    def window(self, step: int, ticks: int, budget: int, gap_us: float,
               pipelined: bool, aux) -> None:
        """One retired window's facts. `aux` is the already-fetched
        host-side StepAux (Python scalars) — the run loop pays no extra
        device traffic."""
        self.windows.append({
            "t_ms": round((time.time() - self.t0) * 1e3, 3),
            "step": int(step), "ticks": int(ticks),
            "budget": int(budget), "gap_us": round(float(gap_us), 1),
            "pipelined": bool(pipelined),
            "processed": int(aux.n_processed) & 0xFFFFFFFF,
            "delivered": int(aux.n_delivered) & 0xFFFFFFFF,
            "occ_sum": int(aux.occ_sum), "occ_max": int(aux.occ_max),
            "qw_p99": int(aux.qw_p99),
            "muted_now": int(aux.n_muted_now),
            "flags": {
                "device_pending": bool(aux.device_pending),
                "host_pending": bool(aux.host_pending),
                "exit": bool(aux.exit_flag),
                "any_muted": bool(aux.any_muted),
                "spill_overflow": bool(aux.spill_overflow),
                "spawn_fail": bool(aux.spawn_fail),
                "blob_fail": bool(aux.blob_fail),
                "blob_budget_fail": bool(aux.blob_budget_fail),
            },
        })

    def event(self, kind: str, **fields) -> None:
        """A runtime event (gc pass, coded error, watchdog trip)."""
        self.events.append({
            "t_ms": round((time.time() - self.t0) * 1e3, 3),
            "step": int(getattr(self.rt, "steps_run", 0)),
            "kind": kind, **fields})

    def mail(self, actor_id: int, behaviour: str) -> None:
        """One host-cohort dispatch (the 'recent host mail' lane)."""
        self.host_mail.append({
            "t_ms": round((time.time() - self.t0) * 1e3, 3),
            "step": int(getattr(self.rt, "steps_run", 0)),
            "actor": int(actor_id), "behaviour": behaviour})

    # -- snapshotting / dumping --
    def postmortem(self, reason: str, **extra) -> Dict[str, Any]:
        """The structured dump: reason + the rings + runtime/host facts.
        Everything in it is JSON-serialisable host state — building it
        never touches the device. The checkpoint block is the ring's
        newest restorable snapshot (serialise.Checkpointer.info), the
        serving block the front door's stats (serve.Server.stats), the
        measured block cost capture's record (costs.py; None until a
        capture ran)."""
        rt = self.rt
        import dataclasses
        ctrl = getattr(rt, "_controller", None)
        wd = getattr(rt, "_watchdog", None)
        phase, epoch, t = getattr(rt, "_wd_stamp", ("?", 0, 0.0))
        ck = getattr(rt, "_ckpt", None)
        srv = getattr(rt, "_serve", None)
        pm: Dict[str, Any] = {
            "version": POSTMORTEM_VERSION,
            "reason": reason,
            "time": time.time(),
            "uptime_s": round(time.time() - self.t0, 3),
            "pid": os.getpid(),
            "steps_run": int(getattr(rt, "steps_run", 0)),
            "phase": {"name": phase, "epoch": int(epoch),
                      "age_s": round(max(0.0, time.monotonic() - t), 3)
                      if t else None},
            "windows": list(self.windows),
            "events": list(self.events),
            "host_mail": list(self.host_mail),
            "queues": {"inject": len(getattr(rt, "_inject_q", ())),
                       "fast": len(getattr(rt, "_host_fast_q", ()))},
            "totals": {k: int(v)
                       for k, v in getattr(rt, "totals", {}).items()},
            "errors": [{"class": cls, "code": int(code), "count": int(n)}
                       for (cls, code), n in sorted(
                           getattr(rt, "_error_counts", {}).items())],
            "checkpoint": ck.info() if ck is not None else None,
            "controller": (None if ctrl is None else {
                **ctrl.snapshot(),
                "recent": ctrl.recent_decisions()}),
            "serving": srv.stats() if srv is not None else None,
            "watchdog": (None if wd is None else wd.snapshot()),
            "measured": getattr(rt, "_costs", None),
            "options": dataclasses.asdict(rt.opts)
            if getattr(rt, "opts", None) is not None else {},
            "env": env_snapshot(),
        }
        pm.update(extra)
        return pm

    def dump(self, reason: str, path: Optional[str] = None,
             out=None, **extra) -> Tuple[str, str]:
        """Write ``<analysis_path>.postmortem.json`` (or `path`) and
        print the human rendering to stderr (or `out`). Returns
        (path, text). Never raises — a failing dump on the way down
        must not mask the original crash."""
        pm = self.postmortem(reason, **extra)
        if path is None:
            path = self.rt.opts.analysis_path + ".postmortem.json"
        text = render_postmortem(pm)
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(pm, f, indent=1)
            os.replace(tmp, path)    # readers never see a half dump
        except OSError as e:
            text += f"\n(postmortem file write failed: {e})"
            path = ""
        try:
            print(text, file=out or sys.stderr)
        except Exception:      # noqa: BLE001 — closed stderr on teardown
            pass
        self.last_dump = path or None
        self.dumps += 1
        return path, text


# ---- the stall watchdog ---------------------------------------------------

class Watchdog(threading.Thread):
    """Monitor thread converting a silent hang into evidence + an
    int-coded error. Reads only host attributes (the phase stamp tuple,
    the controller's window int) — it can observe a runtime whose card
    is wedged solid."""

    def __init__(self, rt, deadline_s: float):
        super().__init__(name="ponyc-torch-watchdog", daemon=True)
        self.rt = rt
        self.deadline_s = float(deadline_s)
        self.tripped: Optional[Dict[str, Any]] = None
        self._stop = threading.Event()
        self._main_ident = threading.main_thread().ident

    def effective_deadline(self, phase: Optional[str] = None) -> float:
        """The configured deadline scaled by (a) how far the adaptive
        controller has grown the window past its initial value — a
        1024-tick window legitimately takes longer than the 4-tick one
        the deadline was calibrated against — and (b) COLD_FACTOR for
        device phases before the first retire (context creation, kernel
        builds, first allocations)."""
        base = self.deadline_s
        ctrl = getattr(self.rt, "_controller", None)
        loaded = int(getattr(self.rt, "_qi_loaded", 0) or 0)
        if ctrl is not None and loaded > 0:
            base *= max(1.0, ctrl.window / loaded)
        if phase in ("backend-init", "dispatching", "in-flight") \
                and int(getattr(self.rt, "_rl_windows", 0)) == 0:
            base *= COLD_FACTOR
        return base

    def check(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """One deadline evaluation (pure in the stamp + clock): the trip
        record when the armed phase's stamp is older than the effective
        deadline, else None. Exposed for tests — the thread loop below
        is just this on a timer."""
        now = time.monotonic() if now is None else now
        phase, epoch, t = getattr(self.rt, "_wd_stamp", ("idle", 0, now))
        if phase not in ARMED_PHASES:
            return None
        deadline = self.effective_deadline(phase)
        age = now - t
        if age <= deadline:
            return None
        return {"phase": phase, "epoch": int(epoch),
                "age_s": round(age, 3),
                "deadline_s": round(deadline, 3),
                "configured_s": self.deadline_s}

    def snapshot(self) -> Dict[str, Any]:
        return {"deadline_s": self.deadline_s,
                "effective_deadline_s": round(self.effective_deadline(), 3),
                "tripped": self.tripped}

    def run(self) -> None:
        poll = max(0.01, min(0.25, self.deadline_s / 4.0))
        while not self._stop.wait(poll):
            trip = self.check()
            if trip is not None:
                self.trip(trip)
                return

    def trip(self, info: Dict[str, Any]) -> None:
        """Dump the postmortem, diagnose on stderr, interrupt the main
        thread so run()/start() convert the pending KeyboardInterrupt
        into PonyStallError. The run loop's waits for the card poll
        from Python, so the interrupt lands at once there; a call that
        blocks inside C (a launch into a full queue, nvcc) takes it when
        it returns — the dump on disk is the value then."""
        self.tripped = info
        fr = getattr(self.rt, "_flight", None)
        path = ""
        if fr is not None:
            fr.event("watchdog_trip", **info)
            path, _ = fr.dump(
                reason=f"watchdog: phase {info['phase']!r} made no "
                       f"progress for {info['age_s']}s "
                       f"(deadline {info['deadline_s']}s)")
            info["postmortem"] = path
        print("ponyc_tpu_torch doctor: STALLED — phase "
              f"{info['phase']!r} silent for {info['age_s']}s "
              f"(deadline {info['deadline_s']}s); postmortem: "
              f"{path or '(unwritten)'}", file=sys.stderr)
        try:
            import signal
            signal.pthread_kill(self._main_ident, signal.SIGINT)
        except (AttributeError, ValueError, OSError, TypeError):
            import _thread
            _thread.interrupt_main()

    def close(self) -> None:
        self._stop.set()


# ---- postmortem rendering / diagnosis -------------------------------------

def load_postmortem(path: str) -> Dict[str, Any]:
    with open(path) as f:
        pm = json.load(f)
    if not isinstance(pm, dict) or "reason" not in pm:
        raise ValueError(f"{path}: not a ponyc_tpu postmortem "
                         "(no 'reason' field)")
    return pm


def probe_postmortem(timeline: List[Dict[str, Any]],
                     env: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """A flight-recorder-shaped postmortem for a failure BEFORE any
    runtime exists: a probe of the CUDA backend that did not come up.
    `timeline` is the probe attempts — [{attempt, t_s, timeout_s,
    error}]."""
    last = timeline[-1]["error"] if timeline else None
    return {
        "version": POSTMORTEM_VERSION,
        "reason": "cuda_init_failed",
        "time": time.time(),
        "pid": os.getpid(),
        "phase": {"name": "backend-init", "epoch": 0,
                  "age_s": round(sum(a.get("t_s", 0.0)
                                     for a in timeline), 1)},
        "probe_timeline": timeline,
        "last_error": last,
        "env": env if env is not None else env_snapshot(),
    }


def _fmt_flags(flags: Dict[str, Any]) -> str:
    up = [k for k, v in (flags or {}).items() if v]
    return ",".join(up) if up else "-"


def render_postmortem(pm: Dict[str, Any]) -> str:
    """Human text of a postmortem dict — what dump() prints to stderr
    and `doctor --postmortem` shows under its one-line verdict."""
    lines = ["=== ponyc_tpu flight-recorder postmortem ==="]
    lines.append(f"reason: {pm.get('reason', '?')}")
    ph = pm.get("phase") or {}
    lines.append(f"phase: {ph.get('name', '?')} "
                 f"(age {ph.get('age_s', '?')}s, "
                 f"epoch {ph.get('epoch', '?')})  "
                 f"steps_run={pm.get('steps_run', '?')}  "
                 f"pid={pm.get('pid', '?')}")
    q = pm.get("queues") or {}
    if q:
        lines.append(f"queues: inject={q.get('inject', 0)} "
                     f"fast={q.get('fast', 0)}")
    for e in pm.get("errors") or []:
        lines.append(f"error: {e['class']} (code {e['code']}) "
                     f"x{e['count']}")
    ck = pm.get("checkpoint")
    if ck and ck.get("path"):
        lines.append(
            f"restorable from: {ck['path']} (age {ck.get('age_s', '?')}s,"
            f" seq {ck.get('seq', '?')}, checksum "
            f"{'ok' if ck.get('verified') else 'unverified'})")
    elif ck is not None:
        lines.append("restorable from: (no checkpoint written yet)")
    ctrl = pm.get("controller")
    if ctrl:
        lines.append(f"controller: window={ctrl.get('window')} "
                     f"state={ctrl.get('state')} "
                     f"grows={ctrl.get('grows')} "
                     f"shrinks={ctrl.get('shrinks')}")
    wins = pm.get("windows") or []
    if wins:
        lines.append(f"last {len(wins)} windows (newest last):")
        for w in wins[-8:]:
            lines.append(
                f"  step={w['step']} ticks={w['ticks']}/{w['budget']} "
                f"gap={w['gap_us']}us occ={w['occ_sum']} "
                f"qw_p99={w['qw_p99']} flags={_fmt_flags(w['flags'])}")
    srv = pm.get("serving")
    if srv:
        sh = srv.get("shed") or {}
        lines.append(
            f"serving: frames={srv.get('frames')} "
            f"accepted={srv.get('accepted')} "
            f"replied={srv.get('replied')} "
            f"shed={srv.get('shed_total')} "
            f"(rate {srv.get('shed_rate')}; "
            + ", ".join(f"{k}={v}" for k, v in sorted(sh.items()))
            + f") queue={srv.get('queue')} "
            f"inflight={srv.get('inflight')} "
            f"admit_limit={(srv.get('admission') or {}).get('limit')} "
            f"net_pending={srv.get('net_pending_bytes')}B"
            + (" DRAINING" if srv.get("draining") else ""))
    mail = pm.get("host_mail") or []
    if mail:
        lines.append("recent host mail: " + ", ".join(
            f"a{m['actor']}.{m['behaviour']}" for m in mail[-6:]))
    # Measured device costs (costs.py): absent without a capture, so
    # .get() everything and render nothing rather than crash the report.
    meas = pm.get("measured") or {}
    for exe, rec in sorted((meas.get("executables") or {}).items()):
        if not isinstance(rec, dict) or rec.get("error"):
            continue
        bits = []
        if rec.get("flops") is not None:
            bits.append(f"flops={rec['flops']:.3g}")
        if rec.get("bytes_accessed") is not None:
            bits.append(f"bytes={rec['bytes_accessed']:.3g}")
        if rec.get("peak_bytes") is not None:
            bits.append(f"peak={rec['peak_bytes']}B")
        if bits:
            lines.append(f"measured [{exe}] "
                         f"({meas.get('backend', '?')}): "
                         + " ".join(bits))
    div = meas.get("model_divergence") or {}
    if div.get("ratio") is not None:
        verdict = ("DIVERGED" if div.get("diverged") else "ok")
        lines.append(
            f"model vs measured: {div.get('modelled_bytes')} vs "
            f"{div.get('measured_bytes')} B/msg "
            f"(ratio {div['ratio']}, tol {div.get('tolerance')}) "
            f"-> {verdict}")
    tl = pm.get("probe_timeline")
    if tl:
        lines.append(f"backend probe attempts: {len(tl)}")
        for a in tl[-4:]:
            lines.append(f"  attempt {a.get('attempt')}: "
                         f"timeout={a.get('timeout_s')}s "
                         f"error={a.get('error')}")
    env = pm.get("env") or {}
    if env:
        nodes = " ".join(f"{k[4:]}={v}" for k, v in sorted(env.items())
                         if k.startswith("dev:"))
        lines.append(f"env: torch={env.get('torch_version')} "
                     f"cuda={env.get('torch_cuda')} {nodes} "
                     + " ".join(f"{k}={v}" for k, v in
                                sorted((env.get('env') or {}).items())))
    return "\n".join(lines)


# The doctor's reading of each armed phase of a stalled run.
_PHASE_HINTS = {
    "in-flight": " (the card never retired the window: a window of the "
                 "window kernel, csrc/mega_window.cu, or the plain "
                 "window's eager kernels did not finish — a wedged grid "
                 "sync, a runaway loop in a body, or a card that stopped "
                 "answering)",
    "dispatching": " (enqueuing the window did not return: the launch "
                   "queue is full behind a wedged kernel)",
    "host-work": " (a host behaviour or a GC pass is stuck)",
    "backend-init": " (start() did not return: CUDA context creation, "
                    "the kernels' nvcc builds or the first allocations "
                    "hung)",
}


def diagnose_postmortem(pm: Dict[str, Any]) -> Tuple[str, str]:
    """(one_line_verdict, detail_text) for a postmortem — the doctor's
    reading, whose one-liner the CLI leads with."""
    reason = str(pm.get("reason", "?"))
    ph = pm.get("phase") or {}
    wins = pm.get("windows") or []
    last = wins[-1] if wins else None
    if reason.endswith("_init_failed"):
        tl = pm.get("probe_timeline") or []
        backend = reason[:-len("_init_failed")].upper()
        line = (f"STALLED: {backend} backend init failed after "
                f"{len(tl)} probe attempt(s) over "
                f"{ph.get('age_s', '?')}s — last error: "
                f"{pm.get('last_error') or '?'}")
    elif reason.startswith("watchdog"):
        line = f"STALLED: {reason}{_PHASE_HINTS.get(ph.get('name'), '')}"
    elif pm.get("errors") or []:
        e = pm["errors"][-1]
        line = (f"CRASHED: {e['class']} (code {e['code']}) at step "
                f"{pm.get('steps_run', '?')}")
        if last is not None and last["flags"].get("spill_overflow"):
            line += " — spill overflow: raise spill_cap/mailbox_cap " \
                    "or lower overload_threshold"
    elif reason.startswith(("SIGQUIT", "manual", "stop")):
        line = (f"SNAPSHOT: {reason} at step {pm.get('steps_run', '?')} "
                f"(phase {ph.get('name', '?')}) — no failure recorded")
    else:
        line = f"CRASHED: {reason} at step {pm.get('steps_run', '?')}"
    if last is not None and int(last.get("occ_max", 0)) > 0 \
            and "STALLED" in line:
        line += (f"; {last['occ_sum']} message(s) still queued "
                 f"(deepest {last['occ_max']})")
    srv = pm.get("serving")
    if srv and line.startswith(("STALLED", "CRASHED")):
        # Serving-aware verdict: was the front door shedding (the edge
        # held) and how much reply backlog died with the world?
        line += (f"; serving: shed_rate={srv.get('shed_rate')} "
                 f"inflight={srv.get('inflight')} "
                 f"net_pending={srv.get('net_pending_bytes')}B")
    ck = pm.get("checkpoint")
    if ck and ck.get("path") and line.startswith(("STALLED", "CRASHED")):
        # The doctor's recovery pointer: what the supervisor would
        # restore from (`python -m ponyc_tpu_torch supervise`,
        # supervise.py).
        line += f" — restorable from {ck['path']}"
    return line, render_postmortem(pm)

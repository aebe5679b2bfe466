"""Runtime analysis/telemetry of the PyTorch port (the counterpart of
``ponyc_tpu/analysis.py``, its imports rewired to the port; numpy and the
standard library only, the device leaves read from the port's torch
state) — ≙ the fork's `--ponyanalysis` subsystem
(src/libponyrt/analysis/analysis.{c,h}).

The reference streams per-event records (mute/overload/pressure/run/gc/
msg-send, analysis.h:16-31) from every scheduler onto a dedicated
analysis thread that writes CSV to /tmp/pony.ponyrt_analytics, with
level 1 adding a SIGTERM live-world dump. The TPU re-design keeps the
same three levels and the same dedicated-writer-thread shape, but the
unit of record is a *step window*, not a message: per-event host
callbacks would serialise the device, while window aggregates
(counters + occupancy/mute/overload reductions computed in the jitted
step when analysis >= 1) cost nothing observable.

  level 0 — off (default; the aux telemetry lanes compile to constants)
  level 1 — summary on run() end + SIGTERM/SIGUSR1 live-world dump
            (≙ sigintHandler analysis.c:55 + cycle.c:874-954 dump_views)
            + the per-behaviour profiler matrix (Runtime.profile():
            runs/deliveries/rejects per behaviour, queue-wait latency
            histograms and mute-ticks per cohort, GC window stats —
            ≙ the fork's per-actor records, computed in the jitted step
            by engine.profile_lanes and fetched only at boundaries)
  level 2 — level 1 + one CSV row per quiesce window to
            RuntimeOptions.analysis_path via a writer thread
            (≙ analysis.c:41-167 thread + CSV format); the window CSV
            carries the static columns below PLUS dynamic per-behaviour
            `run:<Type.beh>` delta columns and per-cohort
            `qw50:<Type>`/`qw99:<Type>` queue-wait percentiles

Wire-up: ``analysis.attach(rt)`` (Runtime.run calls the hook
automatically when opts.analysis >= 1 and nothing is attached yet).
`top_frame` renders the window stream as one frame of a terminal view.
"""

from __future__ import annotations

import math
import os
import queue
import signal
import sys
import threading
import time
from typing import Optional

import numpy as np

CSV_COLUMNS = [
    "time_ms", "step", "processed", "delivered", "rejected", "badmsg",
    "deadletter", "mutes", "occ_sum", "occ_max", "muted_now",
    "overloaded_now", "host_processed", "inject_queue", "fast_queue",
    "ev_dropped", "gc_runs", "gc_collected", "gc_swept",
    "rss_kb", "cpu_ms",
    # Adaptive run loop (PROFILE.md §9): ticks this window actually ran,
    # the host-imposed device-idle gap before its dispatch (µs; 0 for
    # windows dispatched behind an in-flight one), and the controller's
    # next window length + state (grow/shrink/steady).
    "window_ticks", "host_gap_us", "ctrl_window", "ctrl_state",
    # Mailbox bandwidth diet (ops/megakernel.py): bytes per ring record
    # at this run's delivery formulation — 2 bytes/word inside the
    # pallas_mega packed kernel boundary, 4 bytes/word on the int32 XLA
    # paths. Static per run; rides every row so downstream tooling can
    # turn msgs/s into bytes/s without re-deriving the layout.
    "bytes_msg",
]


def _host_usage():
    """Current host RSS (KB) + cumulative CPU time (ms) of this process
    (≙ ponyint_update_memory_usage, sched/cpu.c — the reference samples
    /proc RSS for analysis; we add CPU time since the host loop IS a
    scheduler here)."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    cpu_ms = round((ru.ru_utime + ru.ru_stime) * 1e3, 1)
    try:
        with open("/proc/self/statm") as f:
            rss_kb = int(f.read().split()[1]) * (
                os.sysconf("SC_PAGE_SIZE") // 1024)
    except OSError:
        # Non-Linux fallback: ru_maxrss is the HIGH-WATER mark, and its
        # unit is bytes on macOS vs KB on Linux/BSD.
        rss_kb = int(ru.ru_maxrss // 1024) if sys.platform == "darwin" \
            else int(ru.ru_maxrss)
    return rss_kb, cpu_ms


def _host(t) -> np.ndarray:
    """A device leaf as a host numpy array (int32 leaves widened to
    int64, as the sums below want)."""
    a = t.detach().cpu().numpy()
    return a.astype(np.int64) if a.dtype == np.int32 else a


def hist_percentile(hist, q: float) -> int:
    """Lower-bound tick value (2^k) of the q-quantile bucket of a
    power-of-two queue-wait histogram (state.QW_BUCKETS buckets, bucket
    k ↔ [2^k, 2^(k+1)) ticks); 0 when the histogram is empty."""
    total = int(sum(int(v) for v in hist))
    if total <= 0:
        return 0
    need = max(1, int(math.ceil(q * total)))
    seen = 0
    for k, v in enumerate(hist):
        seen += int(v)
        if seen >= need:
            return 1 << k
    return 1 << (len(hist) - 1)


# Level-3 per-event lane (≙ analysis.h:16-31 event enum; the device
# records transition events in a bounded ring, engine.py §5b).
EVENT_NAMES = {1: "MUTE", 2: "UNMUTE", 3: "OVERLOAD", 4: "SPAWN",
               5: "DESTROY", 6: "ERROR"}
EVENT_COLUMNS = ["time_ms", "step", "event", "actor"]


class Analysis:
    """Per-runtime telemetry collector + writer thread (level 2)."""

    def __init__(self, rt):
        self.rt = rt
        self.level = rt.opts.analysis
        self.t0 = time.time()
        self._rows: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._prev = {}
        self._saved_handlers = {}   # signum → handler to restore on close
        self._warned_drops = False
        # Window CSV schema: the static columns + one `run:` delta
        # column per behaviour + per-device-cohort queue-wait
        # percentiles (the per-behaviour profiler's window stream).
        self.beh_names = [f"{b.actor_type.__name__}.{b.name}"
                          for b in rt.program.behaviour_table]
        self.dev_names = [c.atype.__name__
                          for c in rt.program.device_cohorts]
        from .runtime.state import PHASE_NAMES, QW_BUCKETS
        self.columns = (CSV_COLUMNS
                        + [f"run:{n}" for n in self.beh_names]
                        + [c for n in self.dev_names
                           for c in (f"qw50:{n}", f"qw99:{n}")]
                        # Per-phase window telemetry: one
                        # work-unit delta column per scheduler phase
                        # (engine.phase_cost_lanes).
                        + [f"ph:{n}" for n in PHASE_NAMES])
        self._prev_hist = np.zeros((len(self.dev_names), QW_BUCKETS),
                                   np.int64)
        # Packed-record width for the bytes_msg column (see
        # CSV_COLUMNS): int16 lanes inside the megakernel boundary,
        # int32 words everywhere else.
        from .ops.megakernel import record_words
        self.bytes_msg = record_words(rt.opts) * (
            2 if rt.opts.delivery == "pallas_mega" else 4)
        if self.level >= 2:
            self._writer = threading.Thread(target=self._write_loop,
                                            daemon=True)
            self._writer.start()

    def _telemetry(self):
        """One host read of the cumulative profiler matrix: returns
        (runs [NB] incl. host-dispatch counts, hist [ND, QW_BUCKETS],
        ev_dropped total, gc-collected total, phases [N_PHASES])."""
        rt = self.rt
        from .runtime.state import N_PHASES, QW_BUCKETS
        p = rt.program.shards
        nb = len(rt.program.behaviour_table)
        nd = len(rt.program.device_cohorts)
        st = rt.state
        runs = _host(st.beh_runs).reshape(p, nb).sum(0)
        for g, n in rt._beh_host_runs.items():
            runs[g] += n
        hist = _host(st.qwait_hist).reshape(p, nd, QW_BUCKETS).sum(0)
        dropped = int(_host(st.ev_dropped).sum())
        collected = int(_host(st.n_collected).sum())
        phases = _host(st.phase_cost).reshape(p, N_PHASES).sum(0)
        return runs, hist, dropped, collected, phases

    # -- window hook (called by Runtime.run after each window retire;
    # under the pipelined loop the writer runs while the next window is
    # already in flight on device) --
    def window(self, aux, ticks=None, gap_us=None) -> None:
        if self.level >= 3:
            self._drain_events()
            self._drain_spans()
        if self.level < 2:
            return
        rt = self.rt
        # Counters ride the StepAux the run loop already fetched; the
        # profiler matrix is one extra small host read per window
        # boundary (never per tick).
        runs, hist, dropped, collected, phases = self._telemetry()
        if dropped and not self._warned_drops:
            # One-time loudness: a too-small event ring
            # used to lose level-3 trace events silently unless someone
            # read dump().
            self._warned_drops = True
            print(f"ponyc_tpu analysis: device event ring dropped "
                  f"{dropped} event(s) so far — raise "
                  "RuntimeOptions.analysis_events", file=sys.stderr)
        row = [
            round((time.time() - self.t0) * 1e3, 3),
            rt.steps_run,
            self._delta("processed", rt.totals["processed"]),
            self._delta("delivered", rt.totals["delivered"]),
            self._delta("rejected", int(aux.n_rejected)),
            self._delta("badmsg", int(aux.n_badmsg)),
            self._delta("deadletter", int(aux.n_deadletter)),
            self._delta("mutes", int(aux.n_mutes)),
            int(aux.occ_sum), int(aux.occ_max),
            int(aux.n_muted_now), int(aux.n_overloaded_now),
            self._delta("host_processed",
                        rt.totals.get("host_processed", 0)),
            len(rt._inject_q),
            len(rt._host_fast_q),
            self._delta("ev_dropped", dropped),
            self._delta("gc_runs", rt.totals.get("gc_runs", 0)),
            self._delta("gc_collected", collected),
            self._delta("gc_swept", rt.totals.get("gc_swept_blobs", 0)),
        ]
        row.extend(_host_usage())
        ctrl = getattr(rt, "_controller", None)
        row.extend([
            0 if ticks is None else int(ticks),
            0 if gap_us is None else round(float(gap_us), 1),
            0 if ctrl is None else int(ctrl.window),
            "-" if ctrl is None else ctrl.state,
            self.bytes_msg,
        ])
        for g in range(runs.shape[0]):
            row.append(self._delta(f"run:{g}", int(runs[g])))
        for di in range(hist.shape[0]):
            dh = hist[di] - self._prev_hist[di]
            self._prev_hist[di] = hist[di]
            row.append(hist_percentile(dh, 0.50))
            row.append(hist_percentile(dh, 0.99))
        for i in range(phases.shape[0]):
            row.append(self._delta(f"ph:{i}", int(phases[i])))
        self._rows.put(row)

    def _delta(self, key, cur) -> int:
        prev = self._prev.get(key, 0)
        self._prev[key] = cur
        return int(cur - prev)

    def _drain_events(self) -> None:
        """Pull the device event ring (engine §5b) and reset it. Rows go
        through the same writer thread, tagged for the events CSV."""
        import dataclasses as _dc

        rt = self.rt
        st = rt.state
        counts = _host(st.ev_count)
        if counts.sum() == 0:
            return
        data = _host(st.ev_data)                 # [3, P*EV]
        ev_cap = rt.opts.analysis_events
        now = round((time.time() - self.t0) * 1e3, 3)
        for shard, cnt in enumerate(counts):
            seg = data[:, shard * ev_cap: shard * ev_cap + int(cnt)]
            for i in range(seg.shape[1]):
                self._rows.put(("ev", [
                    now, int(seg[2, i]),
                    EVENT_NAMES.get(int(seg[0, i]), "?"),
                    int(seg[1, i])]))
        fkey = rt._freelist_key
        rt.state = _dc.replace(
            st, ev_count=st.ev_count.new_zeros(st.ev_count.shape))
        rt._freelist_key = fkey       # count reset frees no slots

    def _drain_spans(self) -> None:
        """Pull the device span ring through the runtime's Tracer
        (causal tracing, PROFILE.md §10) and stream any fresh spans —
        device AND host — to `<analysis_path>.spans.jsonl` as one-line
        JSON records via the writer thread."""
        tracer = getattr(self.rt, "_tracer", None)
        if tracer is None:
            return
        tracer.drain(self.rt)
        if self.level < 2:
            return
        from .tracing import span_jsonl_line
        for rec in tracer.take_fresh():
            self._rows.put(("span", span_jsonl_line(rec)))

    def _write_loop(self) -> None:
        opts = self.rt.opts
        # Batched flushing: flush-per-row serialised the
        # writer under level-3 event bursts. Rows now flush when the
        # queue drains (a quiet stream stays promptly visible to `top`)
        # or every opts.analysis_flush_ms while a burst is in flight;
        # close() joins the thread and closing the files flushes the
        # tail.
        flush_s = max(0.0, getattr(opts, "analysis_flush_ms", 200) / 1e3)
        ev_f = open(opts.analysis_path + ".events.csv", "w") \
            if self.level >= 3 else None
        sp_f = open(opts.analysis_path + ".spans.jsonl", "w") \
            if getattr(self.rt, "_tracer", None) is not None else None
        dirty = []
        last_flush = time.monotonic()

        def _flush():
            nonlocal last_flush
            for fh in dirty:
                fh.flush()
            dirty.clear()
            last_flush = time.monotonic()

        try:
            if ev_f is not None:
                ev_f.write(",".join(EVENT_COLUMNS) + "\n")
            with open(opts.analysis_path, "w") as f:
                f.write(",".join(self.columns) + "\n")
                while not (self._stop.is_set() and self._rows.empty()):
                    try:
                        row = self._rows.get(timeout=0.1)
                    except queue.Empty:
                        if dirty:
                            _flush()
                        continue
                    if isinstance(row, tuple) and row[0] == "ev":
                        ev_f.write(",".join(str(x) for x in row[1])
                                   + "\n")
                        if ev_f not in dirty:
                            dirty.append(ev_f)
                    elif isinstance(row, tuple) and row[0] == "span":
                        sp_f.write(row[1] + "\n")
                        if sp_f not in dirty:
                            dirty.append(sp_f)
                    else:
                        f.write(",".join(str(x) for x in row) + "\n")
                        if f not in dirty:
                            dirty.append(f)
                    if (self._rows.empty()
                            or time.monotonic() - last_flush >= flush_s):
                        _flush()
        finally:
            if ev_f is not None:
                ev_f.close()
            if sp_f is not None:
                sp_f.close()

    # -- live-world dump (level >= 1; SIGTERM/SIGUSR1 and run() end) --
    def dump(self, out=None) -> str:
        rt = self.rt
        lines = ["=== ponyc_tpu analysis dump ==="]
        lines.append(f"steps_run={rt.steps_run} "
                     f"uptime_ms={round((time.time()-self.t0)*1e3, 1)}")
        for name in ("n_processed", "n_delivered", "n_rejected",
                     "n_badmsg", "n_deadletter", "n_mutes"):
            lines.append(f"{name}={rt.counter(name)}")
        lines.append(f"host_processed={rt.totals.get('host_processed', 0)} "
                     f"inject_queue={len(rt._inject_q)} "
                     f"fast_queue={len(rt._host_fast_q)}")
        rss_kb, cpu_ms = _host_usage()
        lines.append(f"host_rss_kb={rss_kb} host_cpu_ms={cpu_ms}")
        # Adaptive run loop: live window length, controller state and
        # cumulative host-gap exposure.
        rl = rt.run_loop_stats()
        if rl["controller"] is not None:
            c = rl["controller"]
            lines.append(
                f"run_loop window={c['window']} ctrl={c['state']} "
                f"[{c['lo']},{c['hi']}] grows={c['grows']} "
                f"shrinks={c['shrinks']} windows={rl['windows']} "
                f"pipelined={rl['pipelined_dispatches']}"
                f"/{rl['pipelined_dispatches'] + rl['sync_dispatches']} "
                f"host_gap_ms={rl['host_gap_us_total'] / 1e3:.2f}")
        if self.level >= 3 and rt.state is not None:
            lines.append(
                f"events_pending={int(_host(rt.state.ev_count).sum())} "
                f"events_dropped={int(_host(rt.state.ev_dropped).sum())}")
        # Causal tracing (PROFILE.md §10): the per-trace rows — how many
        # traces are live, their span counts, and the latest trace's
        # critical-path latency in device ticks.
        tracer = getattr(rt, "_tracer", None)
        if tracer is not None:
            try:
                trees = rt.traces()
            except Exception:           # mid-teardown: degrade
                trees = None
            if trees is not None:
                lines.append(
                    f"traces={len(trees)} "
                    f"spans={sum(t['n_spans'] for t in trees.values())} "
                    f"span_dropped={tracer.dropped}")
                for tid in sorted(trees)[-3:]:
                    t = trees[tid]
                    lines.append(
                        f"  trace {tid}: spans={t['n_spans']} "
                        f"latency={t['latency']} ticks  "
                        + " -> ".join(t["critical_path"][:6]))
        # Memory accounting (≙ USE_MEMTRACK counters, scheduler.h:52-66):
        # host-heap handles.
        heap = getattr(rt, "_heap", None)
        if heap is not None:
            s = heap.stats()
            lines.append(
                f"host_heap boxed={s['boxed']} unboxed={s['unboxed']} "
                f"live={s['live']} peak={s['peak_live']}")
        # The per-behaviour profiler (analysis >= 1): GC window stats,
        # the hottest behaviours, and per-cohort queue-wait percentiles
        # woven into the cohort rows below — the live-world analog of
        # the fork's per-actor dump_views rows (cycle.c:874-954).
        prof = None
        if (rt.opts.analysis >= 1 and rt.state is not None
                and rt.state.beh_runs.numel()):
            try:
                prof = rt.profile()
            except Exception:           # mid-teardown: degrade to basics
                prof = None
        if prof is not None:
            g = prof["gc"]
            lines.append(f"gc passes={g['passes']} "
                         f"collected={g['collected']} "
                         f"blob_swept={g['blob_slots_reclaimed']} "
                         f"aborted={g['aborted']}")
            ph = prof.get("phases")
            if ph:
                lines.append("phases " + " ".join(
                    f"{n}={v}" for n, v in ph.items()))
            hot = sorted(prof["behaviours"].items(),
                         key=lambda kv: -kv[1]["runs"])
            for name, b in hot[:8]:
                lines.append(f"  beh {name}: runs={b['runs']} "
                             f"delivered={b['delivered']} "
                             f"rejected={b['rejected']}")
        if rt.state is not None:
            occ = _host(rt.state.tail) - _host(rt.state.head)
            alive = _host(rt.state.alive)
            muted = _host(rt.state.muted)
            lines.append(f"actors_alive={int(alive.sum())} "
                         f"muted={int(muted.sum())} "
                         f"queued_msgs={int(occ.sum())} "
                         f"deepest_queue={int(occ.max())}")
            # Per-cohort queue depth summary (≙ per-actor tag rows in the
            # reference's dump; cohorts are the TPU grouping).
            for cohort in rt.program.cohorts:
                cols = np.asarray(cohort.slot_to_gid(
                    np.arange(cohort.capacity)), np.int64)
                co = occ[cols]
                extra = ""
                cinf = (prof or {}).get("cohorts", {}).get(
                    cohort.atype.__name__)
                if cinf is not None:
                    extra = (f" qw_p50={cinf['queue_wait_p50']}"
                             f" qw_p99={cinf['queue_wait_p99']}"
                             f" mute_ticks={cinf['mute_ticks']}")
                lines.append(
                    f"  cohort {cohort.atype.__name__}: "
                    f"cap={cohort.capacity} queued={int(co.sum())} "
                    f"max={int(co.max()) if co.size else 0} "
                    f"muted={int(muted[cols].sum())}" + extra)
        text = "\n".join(lines)
        print(text, file=out or sys.stderr)
        return text

    def install_signal_dump(self, signums=(signal.SIGTERM,
                                           signal.SIGUSR1)) -> None:
        """Install dump-on-signal handlers (main thread only; ≙ the
        reference installing its SIGTERM handler when analysis > 0).
        SIGUSR1 (and any other signal passed) is dump-and-continue;
        SIGTERM dumps, RESTORES the previous disposition and re-raises
        so the process still terminates — the handler must observe the
        world on the way out, not cancel the shutdown (the old lambda
        swallowed SIGTERM forever). Previous handlers are restored by
        close()."""
        def _handler(signum, _frame):
            self.dump()
            if signum == signal.SIGTERM:
                prev = self._saved_handlers.get(signum, signal.SIG_DFL)
                try:
                    signal.signal(signum, prev)
                except (TypeError, ValueError):
                    # prev came from outside Python (None) or we're off
                    # the main thread: fall back to the default action.
                    signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
        for s in signums:
            try:
                prev = signal.signal(s, _handler)
            except ValueError:   # not the main thread: skip
                return
            self._saved_handlers.setdefault(s, prev)

    def summary(self) -> None:
        if self.level >= 1:
            self.dump()

    def close(self) -> None:
        try:
            self._drain_spans()    # tail spans after the last window
        except Exception:          # teardown must never raise here
            pass
        self._stop.set()
        if self._writer is not None:
            self._writer.join(timeout=2.0)
            self._writer = None
        # Restore pre-attach signal dispositions so a torn-down runtime
        # neither swallows SIGTERM nor stays alive via handler closures.
        for s, prev in self._saved_handlers.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._saved_handlers.clear()


def attach(rt) -> Analysis:
    """Create and register the Analysis hook on a runtime."""
    a = Analysis(rt)
    rt._analysis = a
    if a.level >= 1:
        a.install_signal_dump()
    return a


# ---- tolerant CSV reading (shared by chrome_trace and top_frame) ----
#
# A run killed mid-flush (crash, watchdog trip, kill -9) leaves the
# window/event CSVs with a truncated final line; a run killed during
# warmup leaves them header-only. Every reader parses what is whole and
# warns ONCE per file per process instead of raising — crash artefacts
# exist precisely to be read after ungraceful exits.

_warned_truncated: set = set()


def _warn_truncated(path: str, n: int) -> None:
    if path in _warned_truncated:
        return
    _warned_truncated.add(path)
    print(f"ponyc_tpu analysis: {path}: skipped {n} incomplete row(s) "
          "(run killed mid-flush?)", file=sys.stderr)


def _int0(v) -> int:
    """Int of a CSV cell; 0 for missing/truncated/garbled cells."""
    try:
        return int(float(v)) if v not in (None, "") else 0
    except (TypeError, ValueError):
        return 0


def _whole_rows(rows):
    """Keep only whole rows: time_ms parses AND no trailing column is
    missing (csv.DictReader fills short — truncated — lines with None).
    Returns (rows, dropped)."""
    ok = []
    dropped = 0
    for r in rows:
        try:
            float(r.get("time_ms") or "")
        except (TypeError, ValueError):
            dropped += 1
            continue
        if any(v is None for v in r.values()):
            dropped += 1
            continue
        ok.append(r)
    return ok, dropped


def chrome_trace(csv_path: str, out_path: str,
                 events_path: Optional[str] = None,
                 spans_path: Optional[str] = None) -> str:
    """Convert the analysis CSVs into a Chrome-trace / Perfetto JSON.

    ≙ the reference's DTrace/SystemTap scripts turning USDT probes into
    a timeline (examples/dtrace/telemetry.d — SURVEY §5's third tracing
    mechanism): the step-window CSV becomes counter tracks (queued
    messages, deepest mailbox, muted/overloaded actors, throughput per
    window, anomalies), the dynamic per-behaviour `run:` columns become
    one counter track per HOT behaviour (any nonzero window — the
    per-op attribution timeline), the `qw50:`/`qw99:` columns one
    queue-wait track per cohort, the level-3 event CSV becomes instant
    events (MUTE/UNMUTE/OVERLOAD/SPAWN/DESTROY/ERROR, one thread lane
    per class), and the causal-trace span stream (PROFILE.md §10)
    becomes duration slices with sender→receiver FLOW ARROWS on a
    second, device-tick-timebased process — load the output in
    chrome://tracing or ui.perfetto.dev. Every process and thread lane
    carries name (and sort-index) metadata so Perfetto labels tracks
    instead of showing bare pids/tids; pre-profiler CSVs (no dynamic
    columns) still convert. `events_path` defaults to
    `<csv_path>.events.csv` and `spans_path` to
    `<csv_path>.spans.jsonl` when those files exist."""
    import csv as _csv
    import json
    import os

    pid = 1
    out = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": "ponyc_tpu runtime"}},
        {"ph": "M", "pid": pid, "name": "process_sort_index",
         "args": {"sort_index": 0}},
        {"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
         "args": {"name": "step windows"}},
    ]
    with open(csv_path) as f:
        rows = list(_csv.DictReader(f))
    # A run killed mid-flush leaves a truncated final row (and a
    # killed-at-open run an empty file): parse what is whole, warn
    # once, never raise (the postmortem workflow reads
    # exactly these files after a crash).
    rows, dropped = _whole_rows(rows)
    if dropped:
        _warn_truncated(csv_path, dropped)
    header = list(rows[0].keys()) if rows else []
    run_cols = [c for c in header if c and c.startswith("run:")
                and any(_int0(r.get(c)) for r in rows)]
    qw_cohorts = [c[5:] for c in header if c and c.startswith("qw50:")]
    ph_cols = [c for c in header if c and c.startswith("ph:")]
    for row in rows:
        ts = float(row["time_ms"]) * 1e3          # µs
        for track, cols in (
                ("queue", {"queued": "occ_sum",
                           "deepest": "occ_max"}),
                ("actors", {"muted": "muted_now",
                            "overloaded": "overloaded_now"}),
                ("window throughput", {"processed": "processed",
                                       "delivered": "delivered"}),
                ("anomalies", {"rejected": "rejected",
                               "badmsg": "badmsg",
                               "deadletter": "deadletter"})):
            out.append({"ph": "C", "pid": pid, "ts": ts,
                        "name": track,
                        "args": {k: _int0(row.get(c))
                                 for k, c in cols.items()}})
        for c in run_cols:
            out.append({"ph": "C", "pid": pid, "ts": ts,
                        "name": f"behaviour {c[4:]}",
                        "args": {"runs": _int0(row.get(c))}})
        for cn in qw_cohorts:
            out.append({"ph": "C", "pid": pid, "ts": ts,
                        "name": f"queue-wait {cn}",
                        "args": {"p50": _int0(row.get(f"qw50:{cn}")),
                                 "p99": _int0(row.get(f"qw99:{cn}"))}})
        # Per-phase window telemetry: one counter track per
        # scheduler phase — the per-window work-unit attribution lane.
        for c in ph_cols:
            out.append({"ph": "C", "pid": pid, "ts": ts,
                        "name": f"phase {c[3:]}",
                        "args": {"work": _int0(row.get(c))}})
    if events_path is None:
        cand = csv_path + ".events.csv"
        events_path = cand if os.path.exists(cand) else None
    if events_path is not None:
        tids = {}
        evs = []
        with open(events_path) as f:
            ev_rows, ev_dropped = _whole_rows(list(_csv.DictReader(f)))
        if ev_dropped:
            _warn_truncated(events_path, ev_dropped)
        for row in ev_rows:
            name = row.get("event") or "?"
            tid = tids.setdefault(name, len(tids) + 1)
            evs.append({"ph": "i", "pid": pid, "tid": tid, "s": "t",
                        "ts": float(row["time_ms"]) * 1e3,
                        "name": f"{name} a{row.get('actor', '?')}",
                        "args": {"actor": _int0(row.get("actor")),
                                 "step": _int0(row.get("step"))}})
        # Metadata BEFORE the events they label: Perfetto resolves
        # track names on first sight of a tid (bare-pid tracks come from
        # late or absent name records).
        for name, tid in tids.items():
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": f"events:{name}"}})
        out.extend(evs)
    if spans_path is None:
        cand = csv_path + ".spans.jsonl"
        spans_path = cand if os.path.exists(cand) else None
    if spans_path is not None:
        from .tracing import load_spans, perfetto_events
        out.extend(perfetto_events(load_spans(spans_path)))
    with open(out_path, "w") as f:
        json.dump({"traceEvents": out,
                   "displayTimeUnit": "ms"}, f)
    return out_path


def top_frame(csv_path: str) -> str:
    """Render one frame of the live `top` view from the window CSV
    stream (the writer thread's analysis_path file). Pure text — a
    terminal loop clears the screen and reprints it every interval (the
    JAX package's `python -m ponyc_tpu top`); tests call it directly. ≙ watching the fork's
    analytics CSV with `watch`, but pre-digested: window rates, queue
    pressure, GC, the per-behaviour run table and per-cohort
    queue-wait percentiles."""
    import csv as _csv
    import os as _os
    head = f"ponyc_tpu top — {csv_path}"
    try:
        with open(csv_path) as f:
            rows = list(_csv.DictReader(f))
    except OSError:
        rows = []
    # Satellite fix: a fresh run's CSV is empty or header-only until
    # the writer thread's first flush (analysis_flush_ms), and the
    # last row can be a half-written line mid-append — neither may
    # crash the live view. Keep only whole rows (shared tolerant
    # reader; `top` refreshes every interval, so no warning here);
    # with none left, render a calm waiting frame instead.
    rows, _dropped = _whole_rows(rows)
    if not rows:
        return (head + "\n(waiting for samples — no windows written "
                "yet; is a runtime with analysis>=2 running?)")

    def iv(row, k):
        v = row.get(k)
        try:
            return int(float(v)) if v not in (None, "") else 0
        except (TypeError, ValueError):
            return 0

    last = rows[-1]
    prev = rows[-2] if len(rows) > 1 else None
    dt_ms = (float(last["time_ms"]) - float(prev["time_ms"])) if prev \
        else float(last["time_ms"])
    dt_s = max(dt_ms, 1e-3) / 1e3
    lines = [head]
    lines.append(f"step {last['step']}   "
                 f"uptime {float(last['time_ms']) / 1e3:.1f}s   "
                 f"windows {len(rows)}")
    lines.append(f"window: processed {iv(last, 'processed')} "
                 f"({iv(last, 'processed') / dt_s:,.0f}/s)  "
                 f"delivered {iv(last, 'delivered')}  "
                 f"rejected {iv(last, 'rejected')}  "
                 f"deadletter {iv(last, 'deadletter')}"
                 + (f"  bytes/msg {iv(last, 'bytes_msg')}"
                    if iv(last, "bytes_msg") else ""))
    lines.append(f"queue:  occ_sum {iv(last, 'occ_sum')}  "
                 f"occ_max {iv(last, 'occ_max')}  "
                 f"muted {iv(last, 'muted_now')}  "
                 f"overloaded {iv(last, 'overloaded_now')}  "
                 f"inject {iv(last, 'inject_queue')}  "
                 f"fast {iv(last, 'fast_queue')}")
    if "gc_runs" in last:
        lines.append(
            f"gc:     passes {sum(iv(r, 'gc_runs') for r in rows)}  "
            f"collected {sum(iv(r, 'gc_collected') for r in rows)}  "
            f"blob_swept {sum(iv(r, 'gc_swept') for r in rows)}   "
            f"ev_dropped {sum(iv(r, 'ev_dropped') for r in rows)}")
    if "window_ticks" in last:
        gaps = [float(r.get("host_gap_us") or 0) for r in rows]
        lines.append(
            f"loop:   window {iv(last, 'window_ticks')} ticks  "
            f"ctrl {iv(last, 'ctrl_window')}"
            f" ({last.get('ctrl_state', '-')})  "
            f"host_gap {gaps[-1]:.0f}us "
            f"(mean {sum(gaps) / max(1, len(gaps)):.0f}us)")
    beh_cols = [c for c in (rows[0].keys() or [])
                if c and c.startswith("run:")]
    if beh_cols:
        totals = {c: sum(iv(r, c) for r in rows) for c in beh_cols}
        lines.append("")
        lines.append(f"{'behaviour':<36}{'win':>9}{'runs/s':>12}"
                     f"{'total':>12}")
        mx = max(iv(last, c) for c in beh_cols) or 1
        for c in sorted(beh_cols, key=lambda c: -totals[c]):
            win = iv(last, c)
            bar = "#" * int(round(10 * win / mx))
            lines.append(f"{c[4:]:<36}{win:>9}{win / dt_s:>12,.0f}"
                         f"{totals[c]:>12}  {bar}")
    qw_names = [c[5:] for c in (rows[0].keys() or [])
                if c and c.startswith("qw50:")]
    if qw_names:
        lines.append("")
        lines.append("queue-wait (ticks): " + "  ".join(
            f"{n} p50={iv(last, 'qw50:' + n)} "
            f"p99={iv(last, 'qw99:' + n)}" for n in qw_names))
    ph_cols = [c for c in (rows[0].keys() or [])
               if c and c.startswith("ph:")]
    if ph_cols:
        lines.append("phases (work/win):  " + "  ".join(
            f"{c[3:]}={iv(last, c)}" for c in ph_cols))
    # Causal traces (PROFILE.md §10): one row per recent trace from the
    # writer's .spans.jsonl stream, newest last.
    spans_path = csv_path + ".spans.jsonl"
    if _os.path.exists(spans_path):
        try:
            from .tracing import load_spans, reassemble
            trees = reassemble(load_spans(spans_path))
        except Exception:
            trees = {}
        if trees:
            lines.append("")
            lines.append(f"traces: {len(trees)}")
            for tid in sorted(trees)[-5:]:
                t = trees[tid]
                lines.append(
                    f"  trace {tid}: spans={t['n_spans']} "
                    f"latency={t['latency']} ticks  "
                    + " -> ".join(t["critical_path"][:5]))
    return "\n".join(lines)

"""Causal message tracing — the host half (the counterpart of
``ponyc_tpu/tracing.py``, numpy and the standard library only; the span
ring is read from the port's torch state).

≙ the reference's per-event analysis rows following ONE message from
send to dispatch (analysis.c:587-692) and the DTrace scripts stitching
USDT probes into causal timelines (SURVEY §5): here the device threads
a sampled (trace_id, parent_span) context through mailbox ring side
lanes (runtime/state.py), dispatch records one SPAN per traced message
in a bounded device ring (engine.trace_span_lanes), and every send or
spawn the behaviour performs inherits the context — so an injection's
whole causal fan-out (inject → behaviour → fan-out → quiescence) is
reconstructable after the fact, per message, not per aggregate.

This module owns everything that happens off-device:

  - `Tracer` — per-runtime host bookkeeping: deterministic sampling
    (a counter hash under `trace_seed` — identical runs trace identical
    messages), host root spans for injections, host spans for
    host-cohort dispatches, and the span-ring drain;
  - `reassemble` — span records → causal trees, with per-trace
    critical-path latency in device ticks;
  - `perfetto_events` — span slices + flow arrows (sender → receiver)
    in Chrome-trace JSON, merged into `analysis.chrome_trace` output;
  - one-line JSON span records (`span_jsonl_line` / `load_spans`) —
    the `<analysis_path>.spans.jsonl` stream the level-2 writer thread
    appends to;
  - `format_trace` — the text rendering `python -m ponyc_tpu trace
    --tree` prints in the JAX package.

Span record layout (the device ring's rows, state.span_data; host
spans use the same tuple shape): (trace_id, span_id, parent_span,
behaviour, actor, enqueue_tick, dispatch_tick, retire_tick). Device
span ids are EVEN (>= 2, allocated from a per-shard monotonic counter,
unique across shards); host span ids are ODD (>= 1); 0 = "no parent".
Tick invariants the tests pin: enqueue <= dispatch <= retire, and a
child span's enqueue tick is >= its parent's dispatch tick (the send
that created it happened inside the parent's dispatch).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

# Device span-ring rows (state.span_data's leading axis).
SPAN_ROWS = 8
(ROW_TRACE, ROW_SPAN, ROW_PARENT, ROW_BEH, ROW_ACTOR,
 ROW_ENQ, ROW_DISP, ROW_RETIRE) = range(SPAN_ROWS)

# Knuth multiplicative hash constant for the deterministic sampler.
_HASH_MUL = 2654435761


@dataclasses.dataclass
class Span:
    """One reassembled span (a behaviour dispatch, or the host-side
    injection/host-dispatch that rooted or continued the trace)."""
    trace_id: int
    span_id: int
    parent: int
    beh: str            # "Type.behaviour", "inject", or "gid:<n>"
    actor: int          # global actor id; -1 = host
    enq: int            # enqueue tick (delivery stamp / host step)
    disp: int           # dispatch tick
    retire: int         # retire tick (dispatch completed)
    children: List["Span"] = dataclasses.field(default_factory=list)


class Tracer:
    """Host-side trace bookkeeping for one Runtime (created at start()
    when opts.tracing). Collects HOST spans (injection roots and
    host-cohort dispatches) and drains the DEVICE span ring; `spans`
    accumulates both as plain tuples in span-record order."""

    def __init__(self, sample_n: int, seed: int = 0,
                 beh_names: Optional[List[str]] = None):
        self.sample_n = int(sample_n)
        self.seed = int(seed)
        self.beh_names = list(beh_names or [])
        self.spans: List[Tuple[int, ...]] = []   # SPAN_ROWS-tuples with
        #   the behaviour column RESOLVED to a name at append time
        self.dropped = 0          # device span-ring drops seen so far
        self._n_sends = 0         # sampling counter (deterministic)
        self._next_trace = 1
        self._next_host_span = 1  # odd ids: 1, 3, 5, ...
        self._roots: Dict[int, int] = {}   # trace_id -> root span id
        self._fresh: List[Tuple[int, ...]] = []  # spans since last flush

    # ---- sampling / span allocation (host side) ----
    def sample(self) -> bool:
        """Deterministic 1-in-N decision for the next injection: a
        counter hash under the seed, so a fixed (seed, send sequence)
        always traces the same messages — no wall clock, no RNG state
        shared with user code."""
        c = self._n_sends
        self._n_sends += 1
        if self.sample_n <= 0:
            return False
        h = (c * _HASH_MUL + self.seed) & 0x7FFFFFFF
        return h % self.sample_n == 0

    def _host_span_id(self) -> int:
        sid = self._next_host_span
        self._next_host_span += 2          # stay odd: device ids are even
        return sid

    def _record(self, rec: Tuple[int, ...]) -> None:
        self.spans.append(rec)
        self._fresh.append(rec)

    def begin(self, step: int, trace_id: Optional[int] = None
              ) -> Tuple[int, int]:
        """Open a trace with a host ROOT span (the injection itself):
        returns (trace_id, root_span_id). An explicit trace_id lets the
        caller (bridge/ingress tier) tie an external request id to the
        device spans; ids collide harmlessly (one merged tree)."""
        if trace_id is None:
            tid = self._next_trace
            self._next_trace += 1
        else:
            tid = int(trace_id)
            self._next_trace = max(self._next_trace, tid + 1)
        sid = self._roots.get(tid)
        if sid is None:
            sid = self._host_span_id()
            self._roots[tid] = sid
            self._record((tid, sid, 0, "inject", -1,
                          int(step), int(step), int(step)))
        return tid, sid

    def root_span(self, trace_id: int, step: int) -> int:
        """Get-or-create the root span of an explicit trace id."""
        return self.begin(step, trace_id)[1]

    def host_span(self, trace_id: int, parent: int, beh: Any,
                  actor: int, step: int) -> int:
        """Record a HOST-cohort dispatch span (the main-thread-scheduler
        analog of a device span) and return its id, for propagation
        into the sends the host behaviour performs."""
        sid = self._host_span_id()
        self._record((int(trace_id), sid, int(parent),
                      self._beh_name(beh), int(actor),
                      int(step), int(step), int(step)))
        return sid

    def _beh_name(self, beh: Any) -> str:
        if isinstance(beh, str):
            return beh
        g = int(beh)
        if 0 <= g < len(self.beh_names):
            return self.beh_names[g]
        return f"gid:{g}"

    # ---- device span ring ----
    def drain(self, rt) -> int:
        """Fetch and reset the device span ring (the Analysis window
        hook and Runtime.traces() both call this; ≙ the analysis thread
        draining the fork's event queue). Returns spans drained."""
        import dataclasses as _dc

        st = rt.state
        if st is None or st.span_data.numel() == 0:
            return 0
        counts = st.span_count.cpu().numpy()
        dropped = int(st.span_dropped.cpu().numpy().sum())
        if dropped > self.dropped:
            self.dropped = dropped
        if counts.sum() == 0:
            return 0
        data = st.span_data.cpu().numpy()              # [ROWS, P*TS]
        ts_cap = rt.opts.trace_slots
        n = 0
        for shard, cnt in enumerate(counts):
            seg = data[:, shard * ts_cap: shard * ts_cap + int(cnt)]
            for rec in seg.T.tolist():       # one record a column
                rec[ROW_BEH] = self._beh_name(rec[ROW_BEH])
                self._record(tuple(rec))
                n += 1
        fkey = rt._freelist_key
        rt.state = _dc.replace(
            st, span_count=st.span_count.new_zeros(st.span_count.shape))
        rt._freelist_key = fkey        # count reset frees no slots
        return n

    def take_fresh(self) -> List[Tuple[int, ...]]:
        """Spans recorded since the last call (the writer thread's
        feed for the .spans.jsonl stream)."""
        out, self._fresh = self._fresh, []
        return out


# ---- reassembly -----------------------------------------------------------

def reassemble(spans) -> Dict[int, Dict[str, Any]]:
    """Span records (tuples or dicts) → causal trees, one per trace id:

        {trace_id: {"roots": [Span...],        # parentless spans
                    "spans": {span_id: Span},
                    "n_spans": int,
                    "latency": int,            # critical-path ticks
                    "critical_path": [str]}}   # beh names root→leaf

    Latency = max retire tick − min enqueue tick over the trace (the
    end-to-end number ROADMAP item 4's ingress tier needs). The
    critical path follows children to the latest-retiring leaf. Orphan
    spans (parent not drained yet / ring overflow) become roots, so a
    partially-drained trace still renders."""
    traces: Dict[int, Dict[int, Span]] = {}
    for rec in spans:
        if isinstance(rec, dict):
            s = Span(rec["trace"], rec["span"], rec["parent"],
                     rec["beh"], rec["actor"], rec["enq"], rec["disp"],
                     rec["retire"])
        else:
            s = Span(*rec[:SPAN_ROWS])
        traces.setdefault(s.trace_id, {})[s.span_id] = s
    out: Dict[int, Dict[str, Any]] = {}
    for tid, by_id in traces.items():
        roots = []
        for s in by_id.values():
            p = by_id.get(s.parent)
            if p is not None and p is not s:
                p.children.append(s)
            else:
                roots.append(s)
        for s in by_id.values():
            s.children.sort(key=lambda c: (c.enq, c.span_id))
        roots.sort(key=lambda c: (c.enq, c.span_id))
        lat = (max(s.retire for s in by_id.values())
               - min(s.enq for s in by_id.values()))
        out[tid] = {"roots": roots, "spans": by_id,
                    "n_spans": len(by_id), "latency": int(lat),
                    "critical_path": _critical_path(roots)}
    return out


def _critical_path(roots: List[Span]) -> List[str]:
    """Behaviour names along the chain to the latest-retiring leaf.
    Iterative (explicit stack): a traced chain can be thousands of
    spans deep — one per hop — which would blow Python's recursion
    limit."""
    if not roots:
        return []
    best_ret, best_leaf = -(1 << 62), None
    parent: Dict[int, Optional[Span]] = {}
    stack = [(r, None) for r in roots]
    while stack:
        s, par = stack.pop()
        parent[id(s)] = par
        if s.retire > best_ret or best_leaf is None:
            best_ret, best_leaf = s.retire, s
        for c in s.children:
            stack.append((c, s))
    path: List[str] = []
    s = best_leaf
    while s is not None:
        path.append(s.beh)
        s = parent[id(s)]
    return path[::-1]


def consistent(tree: Dict[str, Any]) -> bool:
    """The consistency predicate: every span has enq <= disp <= retire
    and every child's enqueue tick >= its parent's dispatch tick (the
    send happened inside the parent's dispatch)."""
    for s in tree["spans"].values():
        if not (s.enq <= s.disp <= s.retire):
            return False
        for c in s.children:
            if c.enq < s.disp:
                return False
    return True


# ---- serialisation --------------------------------------------------------

def span_jsonl_line(rec) -> str:
    """One span record as a one-line JSON object (the .spans.jsonl
    format; also what `trace --tree` reads back)."""
    t, s, p, beh, actor, enq, disp, ret = rec[:SPAN_ROWS]
    return json.dumps({"trace": int(t), "span": int(s), "parent": int(p),
                       "beh": beh, "actor": int(actor), "enq": int(enq),
                       "disp": int(disp), "retire": int(ret)},
                      separators=(",", ":"))


def load_spans(path: str) -> List[Dict[str, Any]]:
    """Read a .spans.jsonl stream (blank/truncated tail lines skipped —
    the writer thread may be mid-append)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


# ---- Perfetto export ------------------------------------------------------

def perfetto_events(spans, pid: int = 2) -> List[Dict[str, Any]]:
    """Span slices + flow arrows as Chrome-trace events, on a DEVICE-
    TICK timebase (1 tick = 1 µs in the rendered timeline — spans are
    tick-stamped on device; the window CSV's wall-clock tracks live in
    their own process). One thread lane per actor, labelled via
    thread_name metadata (Perfetto must not show bare tids); flow
    's'/'f' pairs (id = child span id) draw the sender→receiver
    arrows."""
    trees = reassemble(spans)
    out: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": "ponyc_tpu traces (device ticks)"}},
        {"ph": "M", "pid": pid, "name": "process_sort_index",
         "args": {"sort_index": 10}},
    ]
    tids: Dict[int, int] = {}

    def tid_of(actor: int) -> int:
        t = tids.get(actor)
        if t is None:
            t = tids[actor] = len(tids) + 1
            out.append({"ph": "M", "pid": pid, "tid": t,
                        "name": "thread_name",
                        "args": {"name": ("host inject" if actor < 0
                                          else f"actor {actor}")}})
        return t

    for tree in trees.values():
        for s in tree["spans"].values():
            t = tid_of(s.actor)
            ts = float(s.disp)
            dur = float(max(s.retire - s.disp, 1))
            out.append({"ph": "X", "pid": pid, "tid": t, "ts": ts,
                        "dur": dur, "name": s.beh,
                        "args": {"trace": s.trace_id, "span": s.span_id,
                                 "parent": s.parent, "enq": s.enq}})
            if s.parent > 0 and s.parent in tree["spans"]:
                p = tree["spans"][s.parent]
                out.append({"ph": "s", "pid": pid,
                            "tid": tid_of(p.actor), "id": s.span_id,
                            "ts": float(p.disp),
                            "name": f"msg {p.beh}->{s.beh}"})
                out.append({"ph": "f", "pid": pid, "tid": t, "bp": "e",
                            "id": s.span_id, "ts": ts,
                            "name": f"msg {p.beh}->{s.beh}"})
    return out


# ---- text rendering -------------------------------------------------------

def format_trace(tid: int, tree: Dict[str, Any]) -> str:
    """One trace as an indented causal tree (the `trace --tree` view)."""
    lines = [f"trace {tid}: {tree['n_spans']} span(s), "
             f"latency {tree['latency']} tick(s), critical path "
             + " -> ".join(tree["critical_path"])]
    stack = [(r, 0) for r in reversed(tree["roots"])]
    while stack:                      # explicit stack: deep chains
        s, depth = stack.pop()
        who = "host" if s.actor < 0 else f"a{s.actor}"
        lines.append("  " * (depth + 1)
                     + f"{s.beh} [{who}] enq={s.enq} disp={s.disp} "
                       f"retire={s.retire} span={s.span_id}")
        for c in reversed(s.children):
            stack.append((c, depth + 1))
    return "\n".join(lines)

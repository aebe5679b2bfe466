"""Overload-resilient traffic front door on the PyTorch port — the same
service as ``ponyc_tpu/serve.py``: batched socket ingress,
telemetry-driven admission control, graceful drain (≙ running the
runtime as a *service*: the reference's stdlib TCP servers
built over packages/net, operated in the aggregation/coalescing posture
of the PGAS actor-runtime paper in PAPERS.md — survive high fan-in by
batching at the edge and shedding before the mailbox rings wedge).

The tier sits between the `net/` socket layer and the device world:

    TCP/TLS conns ──► FrontDoor (HOST actor: accept/frame)
        │ length-prefixed request frames (wire protocol below)
        ▼
    Server (runtime poller): admission control + deadline checks
        │ bulk_send batches sized by the window controller
        ▼
    device worker cohort ── replies ──► Egress (HOST actor)
        │                                   │
        └──── on-device compute ────────────┘
                                            ▼
                         per-connection `Net` writes honouring
                         `pending()` egress backpressure

Robustness is the headline:

- **Admission control** (`AdmissionController`, MIMD like the
  window controller, runtime/controller.py): a concurrency limit grown ×2 while the device
  telemetry is quiet and fully used, halved when the retired window aux
  votes pressure — qw_p99 past the window length, senders muted
  (mute/backpressure pressure), or spill occupancy climbing. Requests
  beyond the limit (or whose deadline the measured service rate cannot
  meet) are shed AT THE EDGE with a coded BUSY reply instead of being
  queued into a mailbox ring that would answer with a sticky
  SpillOverflow.
- **Deadlines**: every request carries deadline_ms (0 = none); a queued
  request whose deadline passes before submission is shed (DEADLINE
  status) without touching the device.
- **Egress backpressure**: replies ride `Net.send` per connection; a
  connection whose unflushed `pending()` bytes exceed `pending_limit`
  is *choked* — its further requests shed BUSY — and closed past 4×
  (a slow consumer pays, neighbours do not).
- **Causal tracing**: with tracing on, each admitted request's
  tag becomes its trace id (`send(..., trace=tag)`), so
  `Runtime.traces()` attributes end-to-end request latency span by
  span. (The traced path submits per-request via the inject lane;
  untraced batches ride `bulk_send`.)
- **Graceful drain**: SIGTERM/`begin_drain()` stops accepting new
  connections and sheds new frames with BUSY while every ADMITTED
  request completes and its reply flushes; connections then close and
  the run loop exits — zero lost replies (tests/test_serve.py).
- **Supervision**: a wedged world trips the watchdog (code 7)
  and `ponyc_tpu_torch supervise` restarts the service from the newest
  checkpoint; `main()` re-listens on the same port so clients
  reconnect (`supervise.maybe_restore`).

Wire protocol (v1, little-endian i32 words, 4-byte big-endian length
prefix — ≙ the reference stdlib's framed TCP notify pattern):

    frame   := u32_be body_len | body
    request := req_id:i32 | deadline_ms:i32 | payload words...
    reply   := req_id:i32 | status:i32 | value words...

Status codes are `errors.ERROR_CODES` values: 0 OK, 12 BADFRAME
(FrameError), 13 BUSY (ServeBusyError — admission shed, drain, or a
choked connection), 14 DEADLINE (ServeDeadlineError). An undecodable
frame (bad length, non-word body) gets a BADFRAME reply with
req_id=-1 and the connection closes (stream desync is unrecoverable);
a well-framed but wrong-arity request gets BADFRAME and keeps the
connection.

`python -m ponyc_tpu_torch serve` runs the default compute service
(`ServeWorker.handle(tag, x) → 2*x+1`) on the card (`--cpu` on the
CPU); `ponyc_tpu_torch/loadgen.py` is the matching load generator +
chaos/soak harness (p50/p99 end-to-end latency, shed rate, goodput).

The port's touchpoints: `Server._observe` reads the newest retired
window's aux from `rt._last_aux` (host ints the retire already fetched,
no device read) and the spill counters with one device→host read at a
0.25 s cadence; `build` takes `device=` as `Runtime` does.
"""

from __future__ import annotations

import collections
import signal as _signal
import struct
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

from . import I32, Ref, Runtime, RuntimeOptions, actor, behaviour
from .errors import ERROR_CODES

_HDR = struct.Struct(">I")

# Wire status codes (reply word 1) — the errors.ERROR_CODES values of
# the serve-tier error classes, so operators alert on ONE numbering.
ST_OK = 0
ST_BADFRAME = ERROR_CODES["FrameError"]
ST_BUSY = ERROR_CODES["ServeBusyError"]
ST_DEADLINE = ERROR_CODES["ServeDeadlineError"]

# A connection whose unflushed egress bytes exceed pending_limit is
# choked (requests shed BUSY); past CLOSE_FACTOR x it is closed.
CLOSE_FACTOR = 4

# Reply-latency reservoir (host wall clock, µs): bounded so a soak
# cannot grow it; quantiles come from the newest window.
LAT_RESERVOIR = 8192


class FrameError(RuntimeError):
    """Malformed ingress frame: bad length prefix, non-word body, or a
    body outside [2, 2 + payload] words. Wire status 12."""

    code = ERROR_CODES["FrameError"]


class ServeBusyError(RuntimeError):
    """Admission shed the request at the edge (overload, drain, or a
    choked slow-consumer connection). Wire status 13 — the BUSY reply;
    clients retry with backoff."""

    code = ERROR_CODES["ServeBusyError"]


class ServeDeadlineError(RuntimeError):
    """A request's deadline expired before it could be submitted to
    the device. Wire status 14."""

    code = ERROR_CODES["ServeDeadlineError"]


# ---- framing (shared with loadgen.py and tests) -------------------------

def encode_frame(words) -> bytes:
    """Length-prefix one frame of i32 words."""
    body = np.asarray(words, "<i4").tobytes()
    return _HDR.pack(len(body)) + body


def encode_request(req_id: int, deadline_ms: int, payload) -> bytes:
    return encode_frame([int(req_id), int(deadline_ms),
                         *[int(w) for w in payload]])


def encode_reply(req_id: int, status: int, values=()) -> bytes:
    return encode_frame([int(req_id), int(status),
                         *[int(w) for w in values]])


class Framer:
    """Incremental length-prefix decoder: feed() raw chunks (split or
    coalesced arbitrarily), take whole frames as i32 word arrays.
    Raises FrameError on an oversized or non-word frame — the stream
    is desynced and the connection must close."""

    def __init__(self, max_words: int = 64):
        self.max_bytes = 4 * int(max_words)
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[np.ndarray]:
        self._buf += data
        out: List[np.ndarray] = []
        while True:
            if len(self._buf) < _HDR.size:
                return out
            (n,) = _HDR.unpack_from(self._buf)
            if n > self.max_bytes or n % 4 or n < 4:
                raise FrameError(
                    f"frame body of {n} bytes (max {self.max_bytes}, "
                    "must be a positive multiple of 4)")
            if len(self._buf) < _HDR.size + n:
                return out
            body = bytes(self._buf[_HDR.size:_HDR.size + n])
            del self._buf[:_HDR.size + n]
            out.append(np.frombuffer(body, "<i4"))


# ---- admission control --------------------------------------------------

class AdmissionController:
    """MIMD concurrency limiter fed by on-device telemetry — the edge
    twin of runtime/controller.WindowController. `limit` is how many
    requests may be in flight (queued + on device) at once; observe()
    is deterministic in its arguments (tests replay pressure traces)."""

    def __init__(self, lo: int, hi: int,
                 initial: Optional[int] = None):
        if lo < 1 or hi < lo:
            raise ValueError(f"need 1 <= lo <= hi (got lo={lo}, hi={hi})")
        self.lo, self.hi = int(lo), int(hi)
        self.limit = min(self.hi, max(self.lo, int(initial or hi)))
        self.state = "steady"
        self.grows = self.shrinks = self.holds = 0
        self.recent: collections.deque = collections.deque(maxlen=32)

    def observe(self, *, qw_p99: int, window: int, muted: int,
                spill_frac: float, used: int) -> int:
        """Feed one boundary's facts: the newest retired aux's queue-
        wait p99 and muted-sender count, the spill occupancy fraction,
        and how much of the limit was actually in use. Returns the new
        limit."""
        pressure = (qw_p99 > max(1, window)) or muted > 0 \
            or spill_frac > 0.5
        if pressure:
            self.limit = max(self.lo, self.limit // 2)
            self.state = "shrink"
            self.shrinks += 1
        elif used >= self.limit and self.limit < self.hi:
            # The edge is limit-bound while the device is quiet: grow.
            self.limit = min(self.hi, self.limit * 2)
            self.state = "grow"
            self.grows += 1
        else:
            self.state = "steady"
            self.holds += 1
        self.recent.append((int(qw_p99), int(muted),
                            round(float(spill_frac), 3), int(used),
                            self.limit, self.state))
        return self.limit

    def snapshot(self) -> Dict[str, Any]:
        return {"limit": self.limit, "state": self.state,
                "lo": self.lo, "hi": self.hi, "grows": self.grows,
                "shrinks": self.shrinks, "holds": self.holds}


# ---- the actor types of the default service -----------------------------

@actor
class Egress:
    """HOST reply router: device workers send done(tag, value) here;
    the behaviour hands the reply to the Server, which frames it onto
    the owning connection (honouring Net pending() backpressure)."""

    HOST = True
    n_replies: I32

    @behaviour
    def done(self, st, tag: I32, value: I32):
        srv = getattr(self.rt, "_serve", None)
        if srv is not None:
            srv.complete(int(tag), int(value))
        return {**st, "n_replies": st["n_replies"] + 1}


@actor
class FrontDoor:
    """HOST ingress actor: the net layer's accept/data/close events
    land here and delegate to the Server (acceptor + framer worker)."""

    HOST = True
    n_conns: I32

    @behaviour
    def on_accept(self, st, conn: I32):
        srv = getattr(self.rt, "_serve", None)
        if srv is not None:
            srv._on_accept(int(conn))
        return {**st, "n_conns": st["n_conns"] + 1}

    @behaviour
    def on_data(self, st, conn: I32, data: I32, n: I32):
        srv = getattr(self.rt, "_serve", None)
        payload = self.rt.heap.unbox(data)
        if srv is not None:
            srv._on_data(int(conn), payload)
        return st

    @behaviour
    def on_closed(self, st, conn: I32):
        srv = getattr(self.rt, "_serve", None)
        if srv is not None:
            srv._on_closed(int(conn))
        return st


@actor
class ServeWorker:
    """Default device service: handle(tag, x) replies 2*x+1 (i32 wrap)
    to the egress actor — enough arithmetic that loadgen can verify
    every reply value end-to-end."""

    egress: Ref
    served: I32
    MAX_SENDS = 1

    @behaviour
    def handle(self, st, tag: I32, x: I32):
        self.send(st["egress"], Egress.done, tag, 2 * x + 1)
        return {**st, "served": st["served"] + 1}


class _Request:
    __slots__ = ("tag", "cid", "rid", "deadline_t", "words", "t_in")

    def __init__(self, tag, cid, rid, deadline_t, words, t_in):
        self.tag = tag
        self.cid = cid
        self.rid = rid
        self.deadline_t = deadline_t
        self.words = words
        self.t_in = t_in


class _ConnState:
    __slots__ = ("framer", "choked", "n_req", "n_replies")

    def __init__(self, framer):
        self.framer = framer
        self.choked = False
        self.n_req = 0
        self.n_replies = 0


class Server:
    """The front door: owns the listener, the per-connection framers,
    the request queue, the worker lease pool and the admission
    controller. Registered as a runtime poller — poll(rt) runs at every
    host boundary and is where batching/shedding/drain decisions land
    (the same cadence the bridge and analysis writer already use)."""

    def __init__(self, rt: Runtime, workers, request_beh, *,
                 front_door: int, max_frame_words: int = 64,
                 pending_limit: int = 256 * 1024,
                 admit_lo: int = 1, admit_hi: Optional[int] = None,
                 drain_grace_s: float = 0.5, reclaim_factor: float = 4.0,
                 drain_exit: bool = True):
        self.rt = rt
        self.net = rt.attach_net()
        self.workers = [int(w) for w in np.asarray(workers).reshape(-1)]
        if not self.workers:
            raise ValueError("Server needs at least one worker actor")
        self.request_beh = request_beh
        self.front_door = int(front_door)
        # Request arity: behaviour args are (tag, *payload).
        self.n_payload = len(request_beh.arg_specs) - 1
        self.max_frame_words = int(max_frame_words)
        self.pending_limit = int(pending_limit)
        self.drain_grace_s = float(drain_grace_s)
        self.reclaim_factor = float(reclaim_factor)
        self.drain_exit = bool(drain_exit)
        self.admission = AdmissionController(
            admit_lo, admit_hi or len(self.workers), len(self.workers))
        self._conns: Dict[int, _ConnState] = {}
        self._queue: collections.deque = collections.deque()
        self._inflight: Dict[int, _Request] = {}
        self._free: collections.deque = collections.deque(self.workers)
        self._lease: Dict[int, int] = {}      # tag → worker gid
        self._next_tag = 1
        self._lid: Optional[int] = None
        self.draining = False
        self._drain_t: Optional[float] = None
        self._drain_idle_t: Optional[float] = None   # admitted work done
        self.drained = False
        # Counters (stats() / metrics "serving" block / postmortems).
        self.c = collections.Counter()
        self._lat_us: collections.deque = collections.deque(
            maxlen=LAT_RESERVOIR)
        self._rate_ema = 0.0          # replies/s, EMA
        self._rate_t = time.monotonic()
        self._rate_n = 0
        self._spill_frac = 0.0
        self._spill_t = 0.0
        self._adm_t = 0.0             # last admission decision time
        self._occ_hwm = 0             # occupancy high-water mark since
        rt._serve = self
        rt.register_poller(self)

    # -- lifecycle --------------------------------------------------------
    def listen(self, host: str = "127.0.0.1", port: int = 0,
               tls=None) -> int:
        """Bind and start accepting; returns the bound port."""
        self._lid = self.net.listen_tcp(
            host, port, self.front_door,
            on_accept=FrontDoor.on_accept, on_data=FrontDoor.on_data,
            on_closed=FrontDoor.on_closed, tls=tls)
        return self.net.listen_port(self._lid)

    def install_signals(self) -> None:
        """SIGTERM → graceful drain (the flag is consumed at the next
        host boundary; admitted requests complete before exit). SIGINT
        is deliberately left alone: KeyboardInterrupt stays the
        operator's hard stop AND the stall watchdog's trip-delivery
        channel (flight.Watchdog signals the main thread with SIGINT —
        swallowing it here would turn a code-7 stall back into a
        silent hang)."""
        def _drain(_signum, _frame):
            self.begin_drain()
        try:
            _signal.signal(_signal.SIGTERM, _drain)
        except ValueError:            # not the main thread
            pass

    def begin_drain(self) -> None:
        """Stop accepting, shed new frames BUSY, complete admitted
        requests, flush replies, then close and (drain_exit) stop the
        run loop. Idempotent; callable from signal handlers."""
        if self.draining:
            return
        self.draining = True
        self._drain_t = time.monotonic()
        self.c["drains"] += 1

    # -- socket-event half (called from FrontDoor behaviours) -------------
    def _on_accept(self, cid: int) -> None:
        # A connection the kernel accepted during drain still gets a
        # framer: its frames are answered BUSY by the shed path below.
        self._conns[cid] = _ConnState(Framer(self.max_frame_words))
        self.c["conns_accepted"] += 1

    def _on_closed(self, cid: int) -> None:
        self._conns.pop(cid, None)
        self.c["conns_closed"] += 1
        # Abandon this connection's queued requests (nobody to reply
        # to); in-flight ones complete and drop at reply time.
        if self._queue:
            kept = [r for r in self._queue if r.cid != cid]
            dropped = len(self._queue) - len(kept)
            if dropped:
                self._queue = collections.deque(kept)
                self.c["abandoned"] += dropped

    def _on_data(self, cid: int, data: bytes) -> None:
        cs = self._conns.get(cid)
        if cs is None:
            return
        try:
            frames = cs.framer.feed(data)
        except FrameError as e:
            self.c["badframe"] += 1
            self.rt._error_counts[("FrameError", ST_BADFRAME)] += 1
            self._reply_raw(cid, -1, ST_BADFRAME)
            fl = getattr(self.rt, "_flight", None)
            if fl is not None:
                fl.event("badframe", conn=cid, message=str(e))
            self._close_conn(cid)
            return
        for words in frames:
            self._on_request(cid, cs, words)

    def _on_request(self, cid: int, cs: _ConnState,
                    words: np.ndarray) -> None:
        rid, deadline_ms = int(words[0]), int(words[1])
        cs.n_req += 1
        self.c["frames"] += 1
        if len(words) - 2 != self.n_payload:
            self.c["badframe"] += 1
            self.rt._error_counts[("FrameError", ST_BADFRAME)] += 1
            self._reply_raw(cid, rid, ST_BADFRAME)
            return
        now = time.monotonic()
        if self.draining:
            self.c["shed_drain"] += 1
            self._reply_raw(cid, rid, ST_BUSY)
            return
        if cs.choked:
            self.c["shed_choked"] += 1
            self._reply_raw(cid, rid, ST_BUSY)
            return
        occupancy = len(self._queue) + len(self._inflight)
        self._occ_hwm = max(self._occ_hwm, occupancy + 1)
        if occupancy >= self.admission.limit:
            self.c["shed_busy"] += 1
            self._reply_raw(cid, rid, ST_BUSY)
            return
        if deadline_ms > 0 and self._rate_ema > 0.0:
            est_wait_ms = 1e3 * occupancy / self._rate_ema
            if est_wait_ms > deadline_ms:
                # The measured service rate cannot meet the deadline:
                # shedding NOW costs the client less than a doomed wait.
                self.c["shed_deadline"] += 1
                self._reply_raw(cid, rid, ST_BUSY)
                return
        tag = self._next_tag
        self._next_tag = (self._next_tag + 1) & 0x7FFFFFFF or 1
        ddl = now + deadline_ms / 1e3 if deadline_ms > 0 else None
        self._queue.append(_Request(tag, cid, rid, ddl,
                                    [int(w) for w in words[2:]], now))
        self.c["accepted"] += 1

    # -- device half ------------------------------------------------------
    def complete(self, tag: int, value: int) -> None:
        """Egress.done lands here: route the reply to the owning
        connection and return the worker to the lease pool."""
        req = self._inflight.pop(tag, None)
        w = self._lease.pop(tag, None)
        if w is not None:
            self._free.append(w)
        if req is None:
            self.c["stale_replies"] += 1      # reclaimed or unknown tag
            return
        self.c["replied"] += 1
        self._rate_n += 1
        self._lat_us.append(int((time.monotonic() - req.t_in) * 1e6))
        self._reply_raw(req.cid, req.rid, ST_OK, (value,))

    def _reply_raw(self, cid: int, rid: int, status: int,
                   values=()) -> None:
        cs = self._conns.get(cid)
        if cs is None:
            self.c["replies_dropped"] += 1    # connection went away
            return
        try:
            self.net.send(cid, encode_reply(rid, status, values))
        except KeyError:
            self.c["replies_dropped"] += 1
            return
        except OSError:
            # The peer went away with replies owed (EPIPE, ECONNRESET: a
            # client that gave up and closed). The JAX package lets this
            # escape the Egress behaviour and end the run; here the reply
            # is dropped and the connection closed, as for a connection
            # already gone.
            self.c["replies_dropped"] += 1
            self._close_conn(cid)
            return
        cs.n_replies += 1
        # Egress backpressure (≙ throttled): a consumer that stops
        # reading accumulates pending() bytes — choke it (its requests
        # shed BUSY) and close it past CLOSE_FACTOR x.
        pend = self.net.pending(cid)
        if pend > self.pending_limit * CLOSE_FACTOR:
            self.c["conns_killed_slow"] += 1
            self._close_conn(cid)
        elif pend > self.pending_limit:
            if not cs.choked:
                self.c["choked"] += 1
            cs.choked = True
        elif cs.choked and pend <= self.pending_limit // 2:
            cs.choked = False                 # hysteresis release

    def _close_conn(self, cid: int) -> None:
        self._conns.pop(cid, None)
        try:
            self.net.close(cid)
        except KeyError:
            pass

    # -- the boundary hook ------------------------------------------------
    def poll(self, rt) -> int:
        """Runtime-poller hook: admission update, deadline expiry,
        lease reclaim, the bulk_send flush, drain completion."""
        now = time.monotonic()
        self._observe(rt, now)
        n = self._expire(now)
        n += self._flush(rt)
        self._finish_drain(now)
        return n

    def _observe(self, rt, now: float) -> None:
        # Reply-rate EMA (the deadline estimator's denominator).
        dt = now - self._rate_t
        if dt >= 0.1:
            inst = self._rate_n / dt
            self._rate_ema = inst if self._rate_ema == 0.0 \
                else 0.7 * self._rate_ema + 0.3 * inst
            self._rate_n = 0
            self._rate_t = now
        # Spill occupancy: two tiny per-shard counters, fetched at a
        # bounded cadence (0.25 s) — never per boundary.
        if rt.state is not None and now - self._spill_t >= 0.25:
            self._spill_t = now
            try:
                st = rt.state
                parked = int((st.dspill_count.sum()
                              + st.rspill_count.sum()).item())
                cap = max(1, 2 * rt.opts.spill_cap * rt.program.shards)
                self._spill_frac = parked / cap
            except Exception:        # noqa: BLE001 — mid-teardown
                pass
        # Admission decisions run at a bounded cadence (50 ms), not per
        # boundary — a pipelined loop retires windows every few tens of
        # µs and a per-boundary MIMD would slam between lo and hi.
        if now - self._adm_t < 0.05:
            return
        self._adm_t = now
        aux = getattr(rt, "_last_aux", None)
        ctrl = rt._controller
        self.admission.observe(
            qw_p99=int(aux.qw_p99) if aux is not None else 0,
            window=ctrl.window if ctrl is not None else 1,
            muted=int(aux.n_muted_now) if aux is not None else 0,
            spill_frac=self._spill_frac,
            used=self._occ_hwm)
        self._occ_hwm = len(self._queue) + len(self._inflight)

    def _expire(self, now: float) -> int:
        n = 0
        # Queued past deadline: shed without touching the device.
        while self._queue and self._queue[0].deadline_t is not None \
                and self._queue[0].deadline_t < now:
            req = self._queue.popleft()
            self.c["shed_deadline"] += 1
            self._reply_raw(req.cid, req.rid, ST_DEADLINE)
            n += 1
        # In-flight far past deadline: the worker is presumed wedged or
        # its reply lost — reclaim the lease (a late reply for the tag
        # is dropped as stale) so one bad request cannot leak a worker.
        if self._inflight:
            dead = [t for t, r in self._inflight.items()
                    if r.deadline_t is not None
                    and now > r.deadline_t + self.reclaim_factor
                    * max(0.05, r.deadline_t - r.t_in)]
            for t in dead:
                req = self._inflight.pop(t)
                w = self._lease.pop(t, None)
                if w is not None:
                    self._free.append(w)
                self.c["reclaimed"] += 1
                self._reply_raw(req.cid, req.rid, ST_DEADLINE)
                n += 1
        return n

    def _flush(self, rt) -> int:
        """Coalesce queued requests into ONE bulk_send batch per
        boundary — one message per free worker, batch size additionally
        capped by the window controller's current window (the
        device's own vote on how much uninterrupted work it wants)."""
        if not self._queue or not self._free:
            return 0
        ctrl = rt._controller
        cap = ctrl.window if ctrl is not None else len(self._free)
        k = min(len(self._queue), len(self._free), max(1, cap))
        reqs = [self._queue.popleft() for _ in range(k)]
        tgts = [self._free.popleft() for _ in range(k)]
        for req, w in zip(reqs, tgts):
            self._lease[req.tag] = w
            self._inflight[req.tag] = req
        self.c["submitted"] += k
        self.c["batches"] += 1
        if rt.opts.tracing:
            # Traced path: one inject-lane send per request so each
            # carries ITS OWN trace id (= the tag) end to end.
            for req, w in zip(reqs, tgts):
                rt.send(w, self.request_beh, req.tag, *req.words,
                        trace=req.tag)
            return k
        cols = [np.fromiter((r.tag for r in reqs), np.int64, k)]
        for j in range(self.n_payload):
            cols.append(np.fromiter((r.words[j] for r in reqs),
                                    np.int64, k))
        rt.bulk_send(np.asarray(tgts, np.int64), self.request_beh, *cols)
        return k

    def _finish_drain(self, now: float) -> None:
        if not self.draining or self.drained:
            return
        if self._lid is not None:
            self.net.close_listener(self._lid)
            self._lid = None
        if self._queue or self._inflight:
            return
        # Admitted work is done. Hold the door open for drain_grace_s
        # from that moment (the frames a client sends on reading the
        # last OK replies still get BUSY answers) and until every reply
        # byte is flushed, then close out. The JAX package counts the
        # grace from begin_drain, so a drain whose admitted work takes
        # longer than the grace closes on frames still in flight. Peers
        # all gone already = nothing left to answer: complete
        # immediately.
        if self._drain_idle_t is None:
            self._drain_idle_t = now
        if self._conns:
            if now - self._drain_idle_t < self.drain_grace_s:
                return
            if any(self.net.pending(cid) for cid in self._conns):
                return
        for cid in list(self._conns):
            self._close_conn(cid)
        self.drained = True
        if self.drain_exit:
            self.rt.request_exit(0)

    # -- observability ----------------------------------------------------
    def net_pending_bytes(self) -> int:
        return self.net.pending_total()

    def latency_us(self) -> Dict[str, int]:
        lat = sorted(self._lat_us)
        if not lat:
            return {"p50": 0, "p99": 0, "n": 0}
        return {"p50": lat[len(lat) // 2],
                "p99": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
                "n": len(lat)}

    def stats(self) -> Dict[str, Any]:
        """The `serving` block (metrics snapshot, flight postmortems)."""
        c = self.c
        shed = (c["shed_busy"] + c["shed_deadline"] + c["shed_drain"]
                + c["shed_choked"])
        return {
            "conns": len(self._conns),
            "conns_accepted": c["conns_accepted"],
            "frames": c["frames"],
            "accepted": c["accepted"],
            "submitted": c["submitted"],
            "batches": c["batches"],
            "replied": c["replied"],
            "shed": {"busy": c["shed_busy"],
                     "deadline": c["shed_deadline"],
                     "drain": c["shed_drain"],
                     "choked": c["shed_choked"]},
            "shed_total": shed,
            "shed_rate": round(shed / max(1, c["frames"]), 4),
            "badframe": c["badframe"],
            "choked_events": c["choked"],
            "conns_killed_slow": c["conns_killed_slow"],
            "reclaimed": c["reclaimed"],
            "abandoned": c["abandoned"],
            "replies_dropped": c["replies_dropped"],
            "queue": len(self._queue),
            "inflight": len(self._inflight),
            "free_workers": len(self._free),
            "admission": self.admission.snapshot(),
            "rate_rps": round(self._rate_ema, 1),
            "latency_us": self.latency_us(),
            "net_pending_bytes": self.net_pending_bytes(),
            "draining": self.draining,
            # A drain is complete once nothing admitted remains and no
            # peer is owed bytes — whether the run loop exited via the
            # server's own request_exit or via quiescence after the
            # last client hung up (the close events can land after the
            # final poll).
            "drained": bool(self.drained
                            or (self.draining and not self._conns
                                and not self._queue
                                and not self._inflight)),
        }


# ---- world builder + CLI ------------------------------------------------

def default_options(n_workers: int, **overrides) -> RuntimeOptions:
    from .config import options_from_env
    base = dict(mailbox_cap=16, batch=4, max_sends=1, msg_words=3,
                inject_slots=max(64, min(1024, 2 * n_workers)),
                host_out_slots=max(64, min(1024, 2 * n_workers)))
    base.update(overrides)
    return options_from_env(RuntimeOptions(**base))


def build(n_workers: int = 64, opts: Optional[RuntimeOptions] = None,
          device=None, **server_kw):
    """Construct the default service world: a ServeWorker device
    cohort wired to one Egress + one FrontDoor host actor, fronted by
    a Server. Returns (rt, server); call server.listen(...) then
    rt.run(). `device` as for Runtime (None = the CUDA device)."""
    rt = Runtime(opts or default_options(n_workers), device=device)
    rt.declare(ServeWorker, n_workers)
    rt.declare(Egress, 1)
    rt.declare(FrontDoor, 1)
    rt.start()
    workers = rt.spawn_many(ServeWorker, n_workers)
    eg = rt.spawn(Egress)
    fd = rt.spawn(FrontDoor)
    rt.set_fields(ServeWorker, workers, egress=int(eg))
    server = Server(rt, workers, ServeWorker.handle, front_door=fd,
                    **server_kw)
    return rt, server


def main(argv: Optional[List[str]] = None) -> int:
    """`python -m ponyc_tpu_torch serve [--host H] [--port P]
    [--workers N] [--cpu] [--tls-cert C --tls-key K] [--pending-limit B]
    [--drain-grace S] [--pony* runtime flags]` — run the default compute
    service until SIGTERM (graceful drain) or a coded failure (exit =
    error code, so `ponyc_tpu_torch supervise` restarts from the newest
    checkpoint). The world runs on the CUDA device unless `--cpu`."""
    import argparse

    from .config import strip_runtime_flags
    from .errors import error_code
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        opts_env, rest = strip_runtime_flags(["x"] + argv)
    except ValueError as e:
        print(f"ponyc_tpu_torch serve: {e}", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(prog="ponyc_tpu_torch serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--workers", type=int, default=64)
    ap.add_argument("--tls-cert")
    ap.add_argument("--tls-key")
    ap.add_argument("--pending-limit", type=int, default=256 * 1024)
    ap.add_argument("--drain-grace", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true",
                    help="run the world on the CPU (default: CUDA)")
    args = ap.parse_args(rest[1:])
    if bool(args.tls_cert) != bool(args.tls_key):
        print("ponyc_tpu_torch serve: --tls-cert and --tls-key go "
              "together", file=sys.stderr)
        return 2
    import dataclasses as _dc
    base = default_options(args.workers)
    opts = _dc.replace(base, **{
        f.name: getattr(opts_env, f.name)
        for f in _dc.fields(opts_env)
        if getattr(opts_env, f.name) != getattr(type(opts_env)(), f.name)})
    rt, server = build(args.workers, opts,
                       device="cpu" if args.cpu else None,
                       pending_limit=args.pending_limit,
                       drain_grace_s=args.drain_grace)
    from . import supervise
    restored = supervise.maybe_restore(rt)
    if restored:
        print(f"serve: restored world from {restored}", file=sys.stderr)
    tls = None
    if args.tls_cert:
        from .net.tls import TLSServerConfig
        tls = TLSServerConfig(certfile=args.tls_cert,
                              keyfile=args.tls_key)
    port = server.listen(args.host, args.port, tls=tls)
    server.install_signals()
    print(f"serving on {args.host}:{port} "
          f"({args.workers} workers{', tls' if tls else ''})",
          flush=True)
    code = 0
    try:
        code = rt.run()
    except Exception as e:                     # noqa: BLE001
        c = error_code(e)
        print(f"serve: FAILED {type(e).__name__} (code {c}): {e}",
              file=sys.stderr)
        rt.stop()
        return c or 1
    import json as _json
    print("serve: drained " + _json.dumps(server.stats()),
          file=sys.stderr)
    rt.stop()
    return code


if __name__ == "__main__":
    sys.exit(main())

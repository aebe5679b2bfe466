"""Load generator + chaos/soak harness for the serving front door
(serve.py).

Speaks the serve.py wire protocol (length-prefixed i32-word frames)
over plain sockets — no runtime, no device — so it can hammer a server
from a thread, a subprocess, or another machine. Two jobs:

- **Measurement** (`run_load`): N connections drive closed-loop
  pipelined request streams (depth outstanding per connection —
  offered load = conns × depth concurrent requests), match every
  reply to its request, verify the value (the default service's
  2*x+1), and record per-request end-to-end latency. The returned
  stats block is the raw material of a serving measurement: p50/p99
  latency of OK replies, shed counts by status, goodput.

- **Chaos** (knobs below, composable): connection churn
  (`churn_every`), bursty arrivals (`burst`/`burst_pause_s`), slow
  consumers (`slow_read_s` delays reads while writes continue,
  building egress backpressure), malformed frames (`malform_every`),
  and mid-request kill (`kill_after` closes the socket with requests
  outstanding). Every knob is client-side misbehaviour the front door
  must absorb without wedging the world (tests/test_torch_serve.py
  drives them).

CLI: ``python -m ponyc_tpu_torch.loadgen HOST PORT [--conns N] [--depth D]
[--requests K] [--deadline-ms MS] [--duration S] [...chaos flags]`` —
prints the stats block as one JSON object.
"""

from __future__ import annotations

import json
import socket
import struct
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .serve import (ST_BADFRAME, ST_BUSY, ST_DEADLINE, ST_OK, Framer,
                    encode_request)

_HDR = struct.Struct(">I")


def default_value(x: int) -> int:
    """The default ServeWorker.handle contract: value = 2*x+1, i32
    wraparound (device arithmetic is int32)."""
    return int(np.int32(2 * np.int32(x) + 1))


class _ConnStats:
    __slots__ = ("sent", "ok", "busy", "deadline", "badframe", "other",
                 "bad_value", "unanswered", "reconnects", "killed",
                 "lat_us", "malformed_sent")

    def __init__(self):
        self.sent = 0
        self.ok = 0
        self.busy = 0
        self.deadline = 0
        self.badframe = 0
        self.other = 0
        self.bad_value = 0
        self.unanswered = 0
        self.reconnects = 0
        self.killed = 0
        self.malformed_sent = 0
        self.lat_us: List[int] = []


def _connect(host: str, port: int, *, rcvbuf: Optional[int] = None,
             timeout_s: float = 10.0) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    if rcvbuf:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, int(rcvbuf))
    s.settimeout(timeout_s)
    s.connect((host, port))
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def _drive_conn(host: str, port: int, st: _ConnStats, *,
                requests: int, depth: int, deadline_ms: int,
                payload_of, value_of, duration_s: Optional[float],
                churn_every: Optional[int], burst: Optional[int],
                burst_pause_s: float, slow_read_s: float,
                malform_every: Optional[int],
                kill_after: Optional[int], retry_busy: bool,
                busy_backoff_s: float, stop_on_busy: bool,
                stop: threading.Event, timeout_s: float,
                tail_s: Optional[float] = None) -> None:
    """One connection's closed-loop driver: keep `depth` requests
    outstanding; read replies inline. Chaos knobs mutate the schedule.
    Requests left outstanding at EOF/timeout count as unanswered —
    the drain test's "zero lost replies" assertion reads exactly
    this."""
    t_end = time.monotonic() + duration_s if duration_s else None
    framer = Framer(max_words=64)
    outstanding: Dict[int, tuple] = {}      # rid → (x, t_sent, retries)
    rid = 1
    issued = 0          # distinct requests issued (retries don't count)
    sock: Optional[socket.socket] = None
    last_progress = time.monotonic()   # newest send or parsed reply: a
    #   server that stops replying (wedged world) must not spin the
    #   closed loop forever — timeout_s of zero progress ends the run

    def reconnect():
        nonlocal sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            st.reconnects += 1
        sock = _connect(host, port, timeout_s=timeout_s)

    def read_some() -> bool:
        """One recv; dispatch every whole reply frame. False on EOF."""
        try:
            data = sock.recv(65536)
        except socket.timeout:
            return True
        except OSError:
            return False
        if not data:
            return False
        if slow_read_s:
            time.sleep(slow_read_s)
        nonlocal last_progress
        for words in framer.feed(data):
            last_progress = time.monotonic()
            r, status = int(words[0]), int(words[1])
            ent = outstanding.pop(r, None)
            if status == ST_OK:
                st.ok += 1
                if ent is not None:
                    x, t0, _ = ent
                    st.lat_us.append(int((time.monotonic() - t0) * 1e6))
                    if value_of is not None \
                            and int(words[2]) != value_of(x):
                        st.bad_value += 1
            elif status == ST_BUSY:
                st.busy += 1
                if stop_on_busy:
                    # A BUSY is the server saying "back off" (drain or
                    # overload): treat it as the end of this run — the
                    # drain test's way of quiescing the offered load.
                    stop.set()
                if retry_busy and ent is not None and not stop.is_set():
                    x, _, n = ent
                    if n < 64:
                        time.sleep(0.002 * (1 << min(n, 5)))
                        send_one(x, retry_of=(r, n + 1))
                elif busy_backoff_s:
                    # Well-behaved overload client: back off instead
                    # of turning every shed into an instant resend.
                    time.sleep(busy_backoff_s)
            elif status == ST_DEADLINE:
                st.deadline += 1
            elif status == ST_BADFRAME:
                st.badframe += 1
            else:
                st.other += 1
        return True

    def send_one(x: int, retry_of=None) -> bool:
        nonlocal rid, issued, last_progress
        last_progress = time.monotonic()
        r = rid
        rid += 1
        n_retries = 0 if retry_of is None else retry_of[1]
        try:
            sock.sendall(encode_request(r, deadline_ms, payload_of(x)))
        except OSError:
            return False
        st.sent += 1
        if retry_of is None:
            issued += 1
        outstanding[r] = (x, time.monotonic(), n_retries)
        return True

    try:
        reconnect()
        x = 0
        while not stop.is_set():
            if t_end is not None and time.monotonic() > t_end:
                break
            if t_end is None and issued >= requests:
                # Everything issued: fall through to the BOUNDED tail
                # drain below (a server that stopped replying — e.g. a
                # wedged world — must not hang the client forever).
                break
            if outstanding \
                    and time.monotonic() - last_progress > timeout_s:
                break              # zero progress for timeout_s: bail
            # Chaos: abrupt mid-request kill.
            if kill_after is not None and issued >= kill_after:
                st.killed += 1
                st.unanswered += len(outstanding)
                outstanding.clear()
                try:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                    struct.pack("ii", 1, 0))  # RST
                except OSError:
                    pass
                sock.close()
                return
            # Chaos: connection churn — clean close + fresh connect.
            if churn_every and issued and issued % churn_every == 0 \
                    and not outstanding:
                reconnect()
                framer = Framer(max_words=64)
            # Fill the pipeline (bursty: send `burst` then pause).
            budget = depth - len(outstanding)
            if burst:
                budget = min(budget, burst)
            sent_now = 0
            while budget > 0 and (t_end is not None
                                  or issued < requests):
                if malform_every and st.sent \
                        and st.sent % malform_every == 0:
                    st.malformed_sent += 1
                    try:   # 3-byte body: not a word multiple
                        sock.sendall(_HDR.pack(3) + b"\x00\x00\x00")
                    except OSError:
                        break
                    # The server replies BADFRAME(-1) and CLOSES.
                    read_some()
                    reconnect()
                    framer = Framer(max_words=64)
                    st.unanswered += len(outstanding)
                    outstanding.clear()
                    continue
                if not send_one(x):
                    break
                x += 1
                budget -= 1
                sent_now += 1
            if burst and sent_now:
                time.sleep(burst_pause_s)
            if not read_some():
                # Server closed the connection (drain end, choke kill).
                st.unanswered += len(outstanding)
                outstanding.clear()
                if t_end is not None and not stop.is_set() \
                        and time.monotonic() < t_end:
                    try:
                        reconnect()
                        framer = Framer(max_words=64)
                        continue
                    except OSError:
                        break
                break
        # Drain the tail: collect replies for whatever is outstanding
        # (for `tail_s`, default the smaller of 5 s and timeout_s).
        t_tail = time.monotonic() + (min(5.0, timeout_s) if tail_s is None
                                     else tail_s)
        while outstanding and time.monotonic() < t_tail:
            if not read_some():
                break
        st.unanswered += len(outstanding)
    except OSError:
        st.unanswered += len(outstanding)
    finally:
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


def _percentile(sorted_vals: List[int], q: float) -> int:
    if not sorted_vals:
        return 0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(len(sorted_vals) * q))]


def run_load(host: str, port: int, *, conns: int = 4, depth: int = 8,
             requests: int = 100, deadline_ms: int = 0,
             duration_s: Optional[float] = None,
             payload_of=None, value_of=default_value,
             churn_every: Optional[int] = None,
             burst: Optional[int] = None, burst_pause_s: float = 0.05,
             slow_read_s: float = 0.0,
             malform_every: Optional[int] = None,
             kill_after: Optional[int] = None,
             retry_busy: bool = False, busy_backoff_s: float = 0.0,
             stop_on_busy: bool = False,
             stop: Optional[threading.Event] = None,
             timeout_s: float = 10.0,
             tail_s: Optional[float] = None) -> Dict[str, Any]:
    """Drive `conns` concurrent connections; returns the aggregated
    stats block. `requests` is per connection (ignored when
    `duration_s` runs the soak by wall clock). `payload_of(x)` builds
    the request payload words (default: the 1-word default service);
    `value_of(x)` verifies OK replies (None skips verification).
    `tail_s` bounds the wait for replies still outstanding when the
    sending ends (default: the smaller of 5 s and `timeout_s`, the JAX
    package's); a reply later than that counts as unanswered, so an
    overload run that must account for every request waits longer."""
    payload_of = payload_of or (lambda x: [x])
    stop = stop or threading.Event()
    stats = [_ConnStats() for _ in range(conns)]
    t0 = time.monotonic()
    threads = [threading.Thread(
        target=_drive_conn, args=(host, port, st),
        kwargs=dict(requests=requests, depth=depth,
                    deadline_ms=deadline_ms, payload_of=payload_of,
                    value_of=value_of, duration_s=duration_s,
                    churn_every=churn_every, burst=burst,
                    burst_pause_s=burst_pause_s,
                    slow_read_s=slow_read_s,
                    malform_every=malform_every,
                    kill_after=kill_after, retry_busy=retry_busy,
                    busy_backoff_s=busy_backoff_s,
                    stop_on_busy=stop_on_busy,
                    stop=stop, timeout_s=timeout_s, tail_s=tail_s),
        daemon=True) for st in stats]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = max(1e-9, time.monotonic() - t0)
    lat = sorted(u for st in stats for u in st.lat_us)
    agg = {k: sum(getattr(st, k) for st in stats)
           for k in ("sent", "ok", "busy", "deadline", "badframe",
                     "other", "bad_value", "unanswered", "reconnects",
                     "killed", "malformed_sent")}
    shed = agg["busy"] + agg["deadline"]
    return {
        **agg,
        "conns": conns,
        "depth": depth,
        "elapsed_s": round(elapsed, 3),
        "goodput_rps": round(agg["ok"] / elapsed, 1),
        "offered_rps": round(agg["sent"] / elapsed, 1),
        "shed_rate": round(shed / max(1, agg["sent"]), 4),
        "p50_us": _percentile(lat, 0.50),
        "p99_us": _percentile(lat, 0.99),
        "answered": agg["ok"] + agg["busy"] + agg["deadline"]
        + agg["badframe"] + agg["other"],
    }


def soak(host: str, port: int, *, duration_s: float = 10.0,
         conns: int = 8, depth: int = 16,
         deadline_ms: int = 0) -> Dict[str, Any]:
    """Chaos soak: a steady measured stream PLUS one churning client,
    one bursty client, one slow consumer, one malformed-frame sender
    and one mid-request killer, all riding the same server for
    `duration_s`. Returns {"steady": stats, "chaos": stats} — the
    steady half is the number that matters (the front door must keep
    serving it while the chaos half misbehaves)."""
    stop = threading.Event()
    out: Dict[str, Any] = {}

    def steady():
        out["steady"] = run_load(
            host, port, conns=conns, depth=depth,
            deadline_ms=deadline_ms, duration_s=duration_s, stop=stop)

    def chaos():
        out["chaos"] = run_load(
            host, port, conns=5, depth=4, requests=1 << 30,
            duration_s=duration_s, churn_every=20, burst=4,
            burst_pause_s=0.02, slow_read_s=0.002, malform_every=97,
            kill_after=None, value_of=None, stop=stop)

    ts = [threading.Thread(target=steady, daemon=True),
          threading.Thread(target=chaos, daemon=True)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(duration_s + 30.0)
    stop.set()
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="ponyc_tpu_torch.loadgen")
    ap.add_argument("host")
    ap.add_argument("port", type=int)
    ap.add_argument("--conns", type=int, default=4)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--deadline-ms", type=int, default=0)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--churn-every", type=int, default=None)
    ap.add_argument("--burst", type=int, default=None)
    ap.add_argument("--slow-read", type=float, default=0.0)
    ap.add_argument("--malform-every", type=int, default=None)
    ap.add_argument("--kill-after", type=int, default=None)
    ap.add_argument("--retry-busy", action="store_true")
    ap.add_argument("--busy-backoff", type=float, default=0.0)
    ap.add_argument("--soak", action="store_true",
                    help="run the composed chaos soak instead")
    args = ap.parse_args(argv)
    if args.soak:
        res = soak(args.host, args.port,
                   duration_s=args.duration or 10.0,
                   conns=args.conns, depth=args.depth,
                   deadline_ms=args.deadline_ms)
    else:
        res = run_load(args.host, args.port, conns=args.conns,
                       depth=args.depth, requests=args.requests,
                       deadline_ms=args.deadline_ms,
                       duration_s=args.duration,
                       churn_every=args.churn_every, burst=args.burst,
                       slow_read_s=args.slow_read,
                       malform_every=args.malform_every,
                       kill_after=args.kill_after,
                       retry_busy=args.retry_busy,
                       busy_backoff_s=args.busy_backoff)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

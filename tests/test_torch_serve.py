"""The port's serving front door (ponyc_tpu_torch/serve.py, loadgen.py)
on the CPU: the JAX package's serve tests (tests/test_serve.py), case
for case — framing round-trips incl. split reads and malformed frames,
admission shed under synthetic qw_p99 pressure, deadline shed,
graceful-drain-loses-nothing, a slow consumer (its timing is not held
as a parity target), the net-pending-bytes health flip, the postmortem's
serving block, a raising bridge callback — and what is the port's own:

- parity: the same seeded frames to the JAX package's `serve.build`
  world and the port's give each req_id the same reply values and
  statuses;
- the window's aux reaches the server through `rt._last_aux` (set where
  a window retires, read by `Server._observe`);
- a registered noisy source keeps `run()` from returning until it is
  removed.

The SIGTERM drain, the supervisor restart and the CLI run as
subprocesses in tests/test_torch_serve_procs.py."""

import dataclasses
import socket
import struct
import threading
import time

import numpy as np
import pytest

from ponyc_tpu_torch import loadgen, serve
from ponyc_tpu_torch.errors import ERROR_CODES
from ponyc_tpu_torch.serve import (ST_BADFRAME, ST_BUSY, ST_DEADLINE,
                                   ST_OK, AdmissionController, FrameError,
                                   Framer, encode_reply, encode_request)


# ---- framing ------------------------------------------------------------

def test_frame_roundtrip_and_split_reads():
    """Frames survive arbitrary chunking: byte-by-byte feeds and many
    frames coalesced into one chunk both decode to the same words."""
    frames = [encode_request(i, 50 * i, [i * 3, -i]) for i in range(9)]
    blob = b"".join(frames)
    # One-byte drip.
    f = Framer(max_words=8)
    got = []
    for i in range(len(blob)):
        got += [w.tolist() for w in f.feed(blob[i:i + 1])]
    assert got == [[i, 50 * i, i * 3, -i] for i in range(9)]
    # All at once.
    f2 = Framer(max_words=8)
    got2 = [w.tolist() for w in f2.feed(blob)]
    assert got2 == got
    # Replies too, incl. negative words (i32).
    f3 = Framer()
    (w,) = f3.feed(encode_reply(7, ST_OK, [-5]))
    assert w.tolist() == [7, 0, -5]


@pytest.mark.parametrize("body_len", [0, 3, 5, 4 * 100])
def test_framer_rejects_malformed(body_len):
    """Zero-length, non-word and oversized bodies raise FrameError
    (the stream is desynced; the server closes the connection)."""
    f = Framer(max_words=64)
    raw = struct.pack(">I", body_len) + b"\x00" * body_len
    with pytest.raises(FrameError):
        f.feed(raw)


def test_status_codes_are_error_codes():
    """Wire statuses ARE the append-only ERROR_CODES values — one
    numbering for alerts, postmortems and replies."""
    assert ST_BADFRAME == ERROR_CODES["FrameError"] == 12
    assert ST_BUSY == ERROR_CODES["ServeBusyError"] == 13
    assert ST_DEADLINE == ERROR_CODES["ServeDeadlineError"] == 14
    assert serve.FrameError.code == 12
    assert serve.ServeBusyError.code == 13
    assert serve.ServeDeadlineError.code == 14


# ---- admission controller (pure decision logic) -------------------------

def test_admission_controller_mimd():
    ac = AdmissionController(lo=2, hi=64, initial=16)
    # qw_p99 past the window: shrink x1/2 per observation, floored.
    for expect in (8, 4, 2, 2):
        ac.observe(qw_p99=100, window=8, muted=0, spill_frac=0.0,
                   used=16)
        assert ac.limit == expect and ac.state == "shrink"
    # Quiet + fully used: grow x2 toward hi.
    for expect in (4, 8, 16, 32, 64, 64):
        ac.observe(qw_p99=0, window=8, muted=0, spill_frac=0.0,
                   used=ac.limit)
        assert ac.limit == expect
    assert ac.state == "steady"       # at hi: hold
    # Mute pressure and spill occupancy shrink too.
    ac.observe(qw_p99=0, window=8, muted=3, spill_frac=0.0, used=1)
    assert ac.limit == 32 and ac.state == "shrink"
    ac.observe(qw_p99=0, window=8, muted=0, spill_frac=0.9, used=1)
    assert ac.limit == 16
    # Quiet but under-used: hold (no evidence the edge is the limit).
    ac.observe(qw_p99=0, window=8, muted=0, spill_frac=0.0, used=3)
    assert ac.limit == 16 and ac.state == "steady"
    snap = ac.snapshot()
    assert snap["shrinks"] == 6 and snap["grows"] == 5


def test_admission_controller_validates_bounds():
    with pytest.raises(ValueError):
        AdmissionController(lo=0, hi=4)
    with pytest.raises(ValueError):
        AdmissionController(lo=8, hi=4)


# ---- end-to-end over real sockets ---------------------------------------

def _run_with_client(rt, server, client_fn, timeout_s=60.0):
    """Run rt.run() on this thread while client_fn drives sockets from
    a worker thread; begin_drain() fires when the client finishes (so
    run() exits via the drain path)."""
    out = {}

    def body():
        try:
            out["result"] = client_fn()
        except Exception as e:              # noqa: BLE001
            out["error"] = e
        finally:
            server.begin_drain()

    t = threading.Thread(target=body, daemon=True)
    t.start()
    code = rt.run()
    t.join(timeout=timeout_s)
    assert not t.is_alive(), "client thread wedged"
    if "error" in out:
        raise out["error"]
    return code, out.get("result")


def _opts(n_workers):
    return dataclasses.replace(serve.default_options(n_workers),
                               tuning_cache="off")


def _build(n_workers=8, **server_kw):
    rt, server = serve.build(n_workers, _opts(n_workers), device="cpu",
                             **server_kw)
    port = server.listen("127.0.0.1", 0)
    return rt, server, port


def test_request_reply_roundtrip_and_values():
    """ACCEPTANCE: socket → frame → admission → bulk_send batch →
    device worker → egress → framed reply, values verified (2*x+1),
    every request answered, nothing shed at gentle load."""
    rt, server, port = _build(8)
    code, res = _run_with_client(
        rt, server, lambda: loadgen.run_load(
            "127.0.0.1", port, conns=2, depth=2, requests=40))
    assert code == 0
    assert res["ok"] == res["sent"] == 80
    assert res["bad_value"] == 0 and res["unanswered"] == 0
    st = server.stats()
    assert st["replied"] == 80 and st["shed_total"] == 0
    assert st["batches"] >= 1 and st["submitted"] == 80
    # Worker-side evidence: the device cohort really served them.
    served = int(rt.cohort_state(serve.ServeWorker)["served"].sum())
    assert served == 80
    rt.stop()


def test_malformed_frame_gets_badframe_and_close():
    """A non-word body draws a BADFRAME(-1) reply, counts in
    rt._error_counts under code 12, and the connection closes; a well-
    framed wrong-arity request draws BADFRAME and KEEPS the conn."""
    rt, server, port = _build(4)

    def client():
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(struct.pack(">I", 3) + b"\xff\xff\xff")
        f = Framer()
        words = None
        while words is None:
            data = s.recv(4096)
            if not data:
                break
            for w in f.feed(data):
                words = w
        eof = s.recv(4096) if words is not None else b""
        s.close()
        # Arity error on a fresh conn: reply carries the req id, conn
        # survives for a follow-up valid request.
        s2 = socket.create_connection(("127.0.0.1", port), timeout=10)
        s2.sendall(encode_request(5, 0, [1, 2, 3]))   # 3 words != 1
        f2 = Framer()
        got = []
        while len(got) < 1:
            got += [w.tolist() for w in f2.feed(s2.recv(4096))]
        s2.sendall(encode_request(6, 0, [10]))
        while len(got) < 2:
            got += [w.tolist() for w in f2.feed(s2.recv(4096))]
        s2.close()
        return words.tolist(), eof, got

    code, (bad, eof, got) = _run_with_client(rt, server, client)
    assert code == 0
    assert bad == [-1, ST_BADFRAME]
    assert eof == b""                      # server closed the stream
    assert got[0] == [5, ST_BADFRAME]
    assert got[1] == [6, ST_OK, 21]
    assert rt._error_counts[("FrameError", 12)] >= 2
    assert server.stats()["badframe"] == 2
    rt.stop()


def test_admission_shed_under_synthetic_qw_pressure():
    """Synthetic qw_p99 pressure (the device's vote, injected in place
    of the retired aux) collapses the admission limit to lo; offered
    concurrency past the limit sheds BUSY at the edge while admitted
    requests still complete — the rings never see the overload."""
    rt, server, port = _build(8, admit_lo=1)

    class FakeAux:
        qw_p99 = np.int32(1 << 20)        # astronomically past window
        n_muted_now = np.int32(0)

    orig_observe = server._observe

    def pressured_observe(rt_, now):
        rt_._last_aux = FakeAux()
        orig_observe(rt_, now)
    server._observe = pressured_observe

    code, res = _run_with_client(
        rt, server, lambda: loadgen.run_load(
            "127.0.0.1", port, conns=2, depth=16, requests=60,
            busy_backoff_s=0.002))
    assert code == 0
    assert server.admission.limit == 1            # collapsed to lo
    assert server.admission.shrinks >= 3
    assert res["busy"] > 0, "nothing shed under pressure"
    assert res["ok"] > 0, "admitted requests must still complete"
    assert res["bad_value"] == 0 and res["unanswered"] == 0
    st = server.stats()
    assert st["shed"]["busy"] == res["busy"]
    # The device never saw more than the collapsed limit at once.
    assert rt._error_counts.get(("SpillOverflowError", 2), 0) == 0
    rt.stop()


def test_deadline_shed_and_expiry():
    """A deadline the measured service rate cannot meet sheds at the
    edge; a queued request whose deadline lapses is answered DEADLINE
    without touching a worker."""
    rt, server, port = _build(2)
    # Pin the admission limit high but make the service look slow.
    server._rate_ema = 10.0                # 10 rps measured

    def client():
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        f = Framer()
        # A 1 ms deadline with ~0 queue: est wait 0 — admitted. Then
        # stack enough 1 ms-deadline requests that est_wait > deadline.
        for i in range(30):
            s.sendall(encode_request(100 + i, 1, [i]))
        got = []
        t0 = time.monotonic()
        while len(got) < 30 and time.monotonic() - t0 < 30:
            data = s.recv(65536)
            if not data:
                break
            got += [w.tolist() for w in f.feed(data)]
        s.close()
        return got

    code, got = _run_with_client(rt, server, client)
    assert code == 0
    statuses = {w[1] for w in got}
    assert len(got) == 30                  # every request answered
    # With a 10 rps estimate and 1 ms deadlines, the queue beyond the
    # first request sheds (BUSY at admission or DEADLINE at expiry).
    assert statuses <= {ST_OK, ST_BUSY, ST_DEADLINE}
    assert statuses & {ST_BUSY, ST_DEADLINE}
    st = server.stats()
    assert st["shed"]["deadline"] + st["shed"]["busy"] > 0
    rt.stop()


def test_graceful_drain_loses_nothing():
    """ACCEPTANCE: begin_drain() mid-load — every request sent before
    the drain answered (OK for admitted, BUSY for post-drain frames),
    zero unanswered, the world exits 0 and the server reports
    drained."""
    rt, server, port = _build(8, drain_grace_s=0.3)
    drain_at = threading.Event()

    def client():
        stats = {}

        def stream():
            # stop_on_busy: the first BUSY (= the drain announcing
            # itself) quiesces the offered load, so every frame the
            # client sent is answered before the server closes. The
            # offered concurrency (3x2) stays under the admission
            # limit (8 workers) so no BUSY fires BEFORE the drain.
            stats["r"] = loadgen.run_load(
                "127.0.0.1", port, conns=3, depth=2,
                requests=1 << 30, duration_s=30.0, stop_on_busy=True)
        t = threading.Thread(target=stream, daemon=True)
        t.start()
        # Wait until traffic is demonstrably flowing, then drain
        # mid-stream.
        deadline = time.monotonic() + 25.0
        while server.c["replied"] < 20 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.c["replied"] >= 20, "no traffic before drain"
        drain_at.set()
        server.begin_drain()
        t.join(timeout=30.0)
        assert not t.is_alive()
        return stats["r"]

    code, res = _run_with_client(rt, server, client)
    assert code == 0
    assert res["ok"] > 0, "no requests served before the drain"
    assert res["busy"] > 0, "post-drain frames must get BUSY replies"
    # Zero lost replies: every sent request was answered.
    assert res["unanswered"] == 0
    assert res["ok"] + res["busy"] + res["deadline"] == res["sent"]
    st = server.stats()
    assert st["drained"] and st["draining"]
    assert st["inflight"] == 0 and st["queue"] == 0
    assert st["accepted"] == st["replied"] + st["reclaimed"] \
        + st["abandoned"] + st["shed"]["deadline"]
    rt.stop()


def _read_reply(sock, framer):
    """The next reply frame's words from `sock`, or None at EOF."""
    while True:
        try:
            chunk = sock.recv(4096)
        except ConnectionResetError:
            return None
        if not chunk:
            return None
        got = framer.feed(chunk)
        if got:
            return got[0].tolist()


def test_drain_grace_counts_from_the_last_admitted_reply():
    """A drain whose admitted work outlasts drain_grace_s still answers
    the frame a client sends on reading its last OK: BUSY, not a closed
    connection. The grace runs from the moment no admitted request is
    left, not from begin_drain (the JAX package's count, under which
    the door closes as the last OK is flushed; ROADMAP, "Not
    faults")."""
    grace = 1.0
    rt, server, port = _build(8, drain_grace_s=grace)
    orig = server.complete
    drained_mid_request = threading.Event()

    def complete(tag, value):
        if not drained_mid_request.is_set():
            # The drain begins while this request is in flight, and the
            # request completes after the grace has run out.
            server.begin_drain()
            drained_mid_request.set()
            time.sleep(1.5 * grace)
        orig(tag, value)

    server.complete = complete

    def client():
        framer = Framer()
        with socket.create_connection(("127.0.0.1", port)) as sock:
            sock.settimeout(30.0)
            sock.sendall(encode_request(1, 0, [20]))
            first = _read_reply(sock, framer)
            time.sleep(0.1)                 # the client's think time
            sock.sendall(encode_request(2, 0, [21]))
            second = _read_reply(sock, framer)
        return first, second

    code, (first, second) = _run_with_client(rt, server, client)
    assert code == 0
    assert first == [1, ST_OK, 41]
    assert second is not None, "the connection closed on a frame in flight"
    assert second[:2] == [2, ST_BUSY]
    st = server.stats()
    assert st["drained"] and st["inflight"] == 0 and st["queue"] == 0
    assert st["replied"] == 1 and st["shed"]["drain"] == 1
    rt.stop()


def test_reply_to_a_reset_peer_is_dropped_and_the_run_drains():
    """A client sends requests and resets its connection (SO_LINGER 0)
    before their replies are written, so the first reply's writev meets
    ECONNRESET/EPIPE: the reply is dropped, the connection closed, the
    rest of its replies dropped, and the drain completes with exit 0.
    (The JAX package lets that OSError escape the Egress behaviour and
    end the run; ROADMAP, "Not faults".)"""
    rt, server, port = _build(8, drain_grace_s=0.1)
    n = 6
    sock = socket.create_connection(("127.0.0.1", port))
    reset = threading.Event()
    orig = server.complete

    def complete(tag, value):
        if not reset.is_set():
            # The first reply is owed and not yet written: reset the
            # peer, and give the RST time to reach the server's socket.
            # The run loop's thread is here, so the bridge cannot see
            # the hang-up before the reply's write does.
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
            sock.close()
            time.sleep(0.1)
            reset.set()
        orig(tag, value)

    server.complete = complete

    def client():
        sock.sendall(b"".join(encode_request(i, 0, [i]) for i in range(n)))
        assert reset.wait(30.0), "no reply was ever owed"

    code, _ = _run_with_client(rt, server, client)
    assert code == 0
    st = server.stats()
    assert st["drained"] and st["inflight"] == 0 and st["queue"] == 0
    assert st["replied"] == st["submitted"] == n
    assert st["replies_dropped"] == n
    assert server._conns == {}
    assert server.net._conns == {}
    rt.stop()


def test_slow_consumer_does_not_stall_neighbours():
    """One connection stops reading (tiny SO_RCVBUF + huge request
    burst) while another runs a normal closed loop: the normal client
    completes everything; the slow one is choked/backpressured, never
    the world. (The JAX package's test also bounds the wall time; its
    timing is not a parity target, so no bound here.)"""
    rt, server, port = _build(8, pending_limit=2048)

    def client():
        slow_done = threading.Event()

        def slow():
            try:
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 2048)
                s.settimeout(10.0)
                s.connect(("127.0.0.1", port))
                for i in range(800):
                    s.sendall(encode_request(i + 1, 0, [i]))
                time.sleep(2.0)            # never reads its replies
                s.close()
            except OSError:
                pass                       # server may kill the conn
            finally:
                slow_done.set()

        ts = threading.Thread(target=slow, daemon=True)
        ts.start()
        fast = loadgen.run_load("127.0.0.1", port, conns=1, depth=2,
                                requests=60, busy_backoff_s=0.002)
        slow_done.wait(timeout=30.0)
        return fast

    code, fast = _run_with_client(rt, server, client)
    assert code == 0
    assert fast["ok"] + fast["busy"] == fast["sent"] == 60
    assert fast["ok"] > 0 and fast["unanswered"] == 0
    st = server.stats()
    assert st["net_pending_bytes"] >= 0
    assert st["shed"]["choked"] > 0 or st["conns_killed_slow"] > 0 \
        or st["shed"]["busy"] > 0
    rt.stop()


# ---- metrics / health satellites ----------------------------------------

def test_net_pending_bytes_exported_and_degrades_health(tmp_path):
    """pony_tpu_net_pending_bytes rides /metrics; /healthz flips to
    degraded when the egress backlog grows monotonically across
    PENDING_WINDOW snapshots."""
    from ponyc_tpu_torch.metrics import (PENDING_WINDOW, health,
                                         parse_prometheus,
                                         prometheus_text)
    rt, server, port = _build(4)
    rt2 = rt                   # metrics server rides the same runtime
    from ponyc_tpu_torch.metrics import MetricsServer
    mx = MetricsServer(rt2, 0)
    rt2._metrics = mx
    mx.update_now(rt2)
    snap = mx._snap
    assert "net" in snap and snap["net"]["pending_bytes"] == 0
    assert "serving" in snap and snap["serving"]["conns"] == 0
    text = prometheus_text(snap, health(rt2))
    parsed = parse_prometheus(text)
    assert parsed[("pony_tpu_net_pending_bytes", ())] == 0
    assert parsed[("pony_tpu_serve_admit_limit", ())] \
        == server.admission.limit
    assert health(rt2)["status"] == "ok"
    # Fabricate a monotone backlog trail: degraded with the reason.
    mx._pending_hist.clear()
    for v in range(1, PENDING_WINDOW + 1):
        mx._pending_hist.append(v * 1024)
    hz = health(rt2)
    assert hz["status"] == "degraded"
    assert "egress backpressure" in hz["reason"]
    # A non-monotone trail recovers.
    mx._pending_hist.append(0)
    assert health(rt2)["status"] == "ok"
    mx.close()
    rt.stop()


def test_serving_block_in_postmortem():
    """Flight-recorder dumps carry the serving block and the doctor's
    verdict mentions shed rate for a crashed serving world."""
    from ponyc_tpu_torch.flight import diagnose_postmortem
    rt, server, port = _build(2)
    server.c["frames"] += 10
    server.c["shed_busy"] += 4
    pm = rt._flight.postmortem("crash: test")
    assert pm["serving"]["frames"] == 10
    assert pm["serving"]["shed"]["busy"] == 4
    line, detail = diagnose_postmortem(pm)
    assert "serving:" in line and "shed_rate" in line
    assert "serving: frames=10" in detail
    rt.stop()


# ---- bridge satellite ----------------------------------------------------

def test_bridge_poll_survives_raising_callback():
    """A raising fd/timer callback is counted per (class, code) and
    recorded in the flight recorder instead of killing the run loop
    (the ingress tier lives on these callbacks)."""
    from ponyc_tpu_torch import (I32, Runtime, RuntimeOptions, actor,
                                 behaviour)

    @actor
    class Quiet:
        HOST = True
        n: I32

        @behaviour
        def tick(self, st, kind: I32, arg: I32, flags: I32):
            return {**st, "n": st["n"] + 1}

    rt = Runtime(RuntimeOptions(mailbox_cap=8, batch=1, max_sends=1,
                                msg_words=3, inject_slots=8,
                                tuning_cache="off"), device="cpu")
    rt.declare(Quiet, 1).start()
    rt.spawn(Quiet)
    br = rt.attach_bridge()
    fired = []

    def boom(ev):
        fired.append(ev)
        raise ValueError("callback exploded")

    sid = br.timer_callback(boom, 0.01, noisy=True)
    deadline = time.monotonic() + 20.0
    while not fired and time.monotonic() < deadline:
        rt.run(max_steps=5)
    br.unsubscribe(sid)
    assert fired, "timer callback never fired"
    assert rt._error_counts[("ValueError", 0)] >= 1
    kinds = [e["kind"] for e in rt._flight.events]
    assert "bridge_callback_error" in kinds
    # The loop survived: further runs still work.
    assert rt.run(max_steps=5) == 0
    rt.stop()


# ---- the port's own ------------------------------------------------------

def _seeded_frames(seed=13, n=40):
    """Request batches of at most 6 frames (under the 8-worker admission
    limit, so no reply depends on timing): valid requests with int32
    payloads (boundaries included, so 2x+1 wraps), and wrong-arity
    frames, which draw BADFRAME and keep the connection."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([[0, -1, 2**31 - 1, -(2**31), 2**30],
                         rng.integers(-(2**31), 2**31 - 1, n - 5)])
    frames = []
    for i, x in enumerate(xs):
        rid = 1000 + i
        if rng.random() < 0.15:
            frames.append((rid, encode_request(rid, 0, [int(x), 7])))
        else:
            frames.append((rid, encode_request(rid, 0, [int(x)])))
    return [frames[k:k + 6] for k in range(0, len(frames), 6)]


def _send_batches(port, batches):
    """Send each batch on one connection and wait for all its replies;
    returns {req_id: reply words after the id}."""
    got = {}
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    f = Framer()
    for batch in batches:
        s.sendall(b"".join(fr for _, fr in batch))
        want = {rid for rid, _ in batch}
        while not want <= set(got):
            data = s.recv(65536)
            assert data, "server closed the connection"
            for w in f.feed(data):
                got[int(w[0])] = [int(v) for v in w[1:]]
    s.close()
    return got


def test_replies_equal_the_jax_packages_for_seeded_frames():
    """The same seeded frames to the JAX package's serve world and the
    port's: every req_id gets the same status and reply values."""
    from ponyc_tpu import serve as jserve
    batches = _seeded_frames()
    replies = {}
    for name, build in (
            ("jax", lambda: jserve.build(8, jserve.default_options(8))),
            ("port", lambda: serve.build(8, _opts(8), device="cpu"))):
        rt, server = build()
        port = server.listen("127.0.0.1", 0)
        code, got = _run_with_client(rt, server,
                                     lambda: _send_batches(port, batches))
        assert code == 0
        replies[name] = got
        rt.stop()
    assert replies["port"] == replies["jax"]
    sent = [rid for b in batches for rid, _ in b]
    assert sorted(replies["port"]) == sorted(sent)
    statuses = {v[0] for v in replies["port"].values()}
    assert statuses == {ST_OK, ST_BADFRAME}
    for b in batches:
        for rid, fr in b:
            words = np.frombuffer(fr[4:], "<i4")
            if len(words) == 3:
                assert replies["port"][rid] == [
                    ST_OK, loadgen.default_value(int(words[2]))]


def test_retired_window_aux_reaches_the_server():
    """`rt._last_aux` is the newest retired window's aux, in host ints
    (its cumulative processed count matches the run loop's total); the
    server's admission reads its queue-wait p99 from there."""
    rt, server, port = _build(8)
    code, res = _run_with_client(
        rt, server, lambda: loadgen.run_load(
            "127.0.0.1", port, conns=2, depth=2, requests=20))
    assert code == 0 and res["ok"] == 40
    a = rt._last_aux
    assert a is not None and isinstance(a.qw_p99, int)
    assert a.n_processed & 0xFFFFFFFF == \
        rt.totals["processed"] & 0xFFFFFFFF
    seen = []
    server._adm_t = 0.0
    orig = server.admission.observe

    def spy(**kw):
        seen.append(kw)
        return orig(**kw)
    server.admission.observe = spy
    server._observe(rt, time.monotonic())
    assert seen and seen[0]["qw_p99"] == int(a.qw_p99)
    assert seen[0]["muted"] == int(a.n_muted_now)
    rt.stop()


def test_noisy_source_keeps_run_alive():
    """A held outside source (add_noisy) keeps a quiescent run waiting;
    removing it lets run() return."""
    from ponyc_tpu_torch import I32, Runtime, RuntimeOptions, actor, \
        behaviour

    @actor
    class Once:
        n: I32

        @behaviour
        def go(self, st, v: I32):
            return {**st, "n": st["n"] + v}

    rt = Runtime(RuntimeOptions(msg_words=1, tuning_cache="off"),
                 device="cpu")
    rt.declare(Once, 2).start()
    a = rt.spawn(Once)
    rt.send(a, Once.go, 3)
    rt.add_noisy()
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("code", rt.run()),
                         daemon=True)
    t.start()
    time.sleep(0.5)
    assert t.is_alive(), "run() returned while a noisy source was held"
    assert rt.state_of(a)["n"] == 3
    rt.remove_noisy()
    t.join(timeout=10.0)
    assert not t.is_alive() and out["code"] == 0
    # Without a held source the same world quiesces at once.
    rt.send(a, Once.go, 1)
    assert rt.run() == 0 and rt.state_of(a)["n"] == 4
    rt.stop()

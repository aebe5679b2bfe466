"""The port's copy of the native host runtime (ponyc_tpu_torch/native,
built into ponyc_tpu_torch/_build/native/), under the JAX package's
tests (tests/test_native.py), case for case.

Native host-runtime layer tests (pool, MPSC queue, ASIO epoll loop).

≙ the reference's runtime unit tests (test/libponyrt/mem/pool.cc and the
asio paths exercised via stdlib socket/timer tests) — here driven through
the ctypes bindings, no device involved.
"""

import os
import signal
import threading
import time

import dataclasses

import numpy as np
import pytest

import ponyc_tpu_torch
from ponyc_tpu_torch import native


def Runtime(opts=None):
    """The port's Runtime on the CPU (the tests' device), with the tuning
    cache off."""
    if opts is not None:
        opts = dataclasses.replace(opts, tuning_cache="off")
    return ponyc_tpu_torch.Runtime(opts, device="cpu")


def test_pool_class_index():
    l = native.lib()
    assert l.ponyx_pool_index(1) == 0
    assert l.ponyx_pool_index(32) == 0
    assert l.ponyx_pool_index(33) == 1
    assert l.ponyx_pool_index(64) == 1
    assert l.ponyx_pool_index(1 << 20) == 15


def test_pool_alloc_recycles():
    l = native.lib()
    a = l.ponyx_pool_alloc(100)
    assert a
    l.ponyx_pool_free(100, a)
    b = l.ponyx_pool_alloc(100)   # same class → same block back
    assert b == a
    l.ponyx_pool_free(100, b)


def test_hostq_fifo_roundtrip():
    q = native.HostQueue()
    for i in range(100):
        q.push([i, i * 2, i * 3])
    assert len(q) == 100
    for i in range(100):
        m = q.pop()
        assert m is not None and list(m) == [i, i * 2, i * 3]
    assert q.pop() is None
    q.close()


def test_hostq_variable_width_and_regrow_pop():
    q = native.HostQueue()
    q.push(np.arange(80, dtype=np.int32))
    m = q.pop(max_words=16)   # too small → internally retried with 80
    assert m is not None and m.size == 80
    q.close()


def test_hostq_concurrent_producers():
    q = native.HostQueue()
    n_threads, per = 8, 500

    def produce(t):
        for i in range(per):
            q.push([t, i])

    ts = [threading.Thread(target=produce, args=(t,))
          for t in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    seen = {t: [] for t in range(n_threads)}
    while (m := q.pop()) is not None:
        seen[int(m[0])].append(int(m[1]))
    # MPSC guarantee: per-producer FIFO survives interleaving
    for t in range(n_threads):
        assert seen[t] == list(range(per))
    q.close()


def test_asio_timer_fires():
    loop = native.AsioLoop()
    loop.timer(2_000_000, 2_000_000, owner=7, behaviour=3)  # 2ms period
    deadline = time.time() + 2.0
    events = []
    while time.time() < deadline and len(events) < 3:
        events.extend(loop.drain())
        time.sleep(0.005)
    assert len(events) >= 3
    ev = events[0]
    assert (ev.owner, ev.behaviour, ev.kind) == (7, 3, native.TIMER)
    assert ev.arg >= 1          # expiration count
    assert loop.noisy >= 1      # periodic timer holds liveness
    loop.close()


def test_asio_oneshot_timer_unsubscribes_itself():
    loop = native.AsioLoop()
    loop.timer(1_000_000, 0, owner=1, behaviour=0, oneshot=True)
    time.sleep(0.1)
    evs = loop.drain()
    assert len(evs) == 1 and evs[0].kind == native.TIMER
    assert loop.noisy == 0      # oneshot released its noisy hold
    time.sleep(0.05)
    assert loop.drain() == []   # never fires again
    loop.close()


def test_asio_fd_readable_pipe():
    loop = native.AsioLoop()
    r, w = os.pipe()
    os.set_blocking(r, False)
    loop.fd(r, owner=42, behaviour=9)
    os.write(w, b"x")
    deadline = time.time() + 2.0
    events = []
    while time.time() < deadline and not events:
        events = loop.drain()
        time.sleep(0.005)
    assert events and events[0].kind == native.FD_READ
    assert events[0].arg == r and events[0].owner == 42
    os.read(r, 1)               # level-triggered: clear readability
    os.close(r)
    os.close(w)
    loop.close()


def test_asio_signal_delivery():
    loop = native.AsioLoop()
    loop.signal(signal.SIGUSR1, owner=5, behaviour=2)
    os.kill(os.getpid(), signal.SIGUSR1)
    deadline = time.time() + 2.0
    events = []
    while time.time() < deadline and not events:
        events = loop.drain()
        time.sleep(0.005)
    assert events and events[0].kind == native.SIGNAL
    assert events[0].arg == signal.SIGUSR1 and events[0].owner == 5
    loop.close()


def test_asio_unsubscribe_stops_events():
    loop = native.AsioLoop()
    sid = loop.timer(1_000_000, 1_000_000, owner=1, behaviour=1)
    time.sleep(0.05)
    assert loop.unsubscribe(sid)
    loop.drain(1024)
    time.sleep(0.05)
    assert loop.drain() == []
    assert loop.noisy == 0
    loop.close()


def test_asio_noisy_manual_holds():
    loop = native.AsioLoop()
    assert loop.noisy == 0
    loop.noisy_add()
    loop.noisy_add()
    assert loop.noisy == 2
    loop.noisy_remove()
    assert loop.noisy == 1
    loop.noisy_remove()
    assert loop.noisy == 0
    loop.close()


def test_socket_writev_scatter_gather():
    """One sendmsg carries a chunk list (≙ the reference's iovec writev
    path, lang/socket.c); short writes consume mid-chunk."""
    from ponyc_tpu_torch.native import sockets as S

    lfd = S.listen_tcp("127.0.0.1", 0)
    port = S.sockname_port(lfd)
    cfd = S.connect_tcp("127.0.0.1", port)
    for _ in range(200):
        afd = S.accept(lfd)
        if afd is not None:
            break
        time.sleep(0.005)
    assert afd is not None
    assert S.connect_result(cfd) == 0
    chunks = [b"alpha-", b"", b"beta-", b"gamma"]
    total = sum(len(c) for c in chunks)
    sent = 0
    for _ in range(100):
        sent += S.writev(cfd, _remaining(chunks, sent))
        if sent == total:
            break
        time.sleep(0.005)
    assert sent == total
    got = b""
    for _ in range(200):
        d = S.recv(afd)
        if d:
            got += d
        if got == b"alpha-beta-gamma":
            break
        time.sleep(0.005)
    assert got == b"alpha-beta-gamma"
    for fd in (cfd, afd, lfd):
        S.close(fd)


def _remaining(chunks, sent):
    out = []
    for c in chunks:
        if sent >= len(c):
            sent -= len(c)
        else:
            out.append(c[sent:])
            sent = 0
    return out


def test_socket_names_and_options():
    from ponyc_tpu_torch.native import sockets as S
    import socket as pysock

    lfd = S.listen_tcp("127.0.0.1", 0)
    addr, port = S.sockname(lfd)
    assert addr == "127.0.0.1" and port > 0
    cfd = S.connect_tcp("127.0.0.1", port)
    for _ in range(200):
        afd = S.accept(lfd)
        if afd is not None:
            break
        time.sleep(0.005)
    paddr, pport = S.peername(cfd)
    assert paddr == "127.0.0.1" and pport == port
    # Generic option surface (≙ the reference's pony_os_getsockopt):
    S.set_option(cfd, pysock.SOL_SOCKET, pysock.SO_RCVBUF, 65536)
    assert S.get_option(cfd, pysock.SOL_SOCKET, pysock.SO_RCVBUF) >= 65536
    assert S.get_option(cfd, pysock.SOL_SOCKET, pysock.SO_ERROR) == 0
    for fd in (cfd, afd, lfd):
        S.close(fd)


def test_udp_multicast_and_broadcast_options():
    from ponyc_tpu_torch.native import sockets as S

    fd = S.udp("0.0.0.0", 0)
    S.multicast_ttl(fd, 2)
    S.multicast_loopback(fd, True)
    S.broadcast(fd, True)
    try:
        S.multicast_join(fd, "239.255.12.34")
        S.multicast_leave(fd, "239.255.12.34")
    except OSError:
        pass   # containers without multicast routes: option path is the
        #        thing under test, join errno comes from the kernel
    import pytest
    with pytest.raises(OSError):
        S.multicast_join(fd, "not-an-address")
    S.close(fd)


def test_native_microbench_sane():
    """The in-C++ microbench suite (≙ benchmark/libponyrt) runs and
    returns plausible steady-state costs (pool hit path and MPSC
    round-trip are tens of ns, never µs-scale)."""
    from ponyc_tpu_torch import native
    res = native.microbench(scale=0.05)
    assert set(res) == {"pool_alloc_free_64B_ns", "pool_alloc_free_4KB_ns",
                        "pool_burst32_64B_ns", "mpscq_push_pop_4w_ns",
                        "mpscq_mt_4prod_4w_ns"}
    for k, v in res.items():
        assert 0.5 < v < 100_000, (k, v)


def test_affinity_pinning():
    """≙ --ponypin / --ponypinasio (start.c:75-94, cpu.c:278): the host
    driver thread and the native event-loop thread pin to cores."""
    import os

    from ponyc_tpu_torch import I32, RuntimeOptions, actor, behaviour

    @actor
    class P:
        n: I32

        @behaviour
        def tick(self, st, v: I32):
            return {**st, "n": st["n"] + v}

    before = os.sched_getaffinity(0)
    core = min(before)             # a core this cgroup actually allows
    try:
        rt = Runtime(RuntimeOptions(msg_words=1, pin=core,
                                    pin_asio=core))
        rt.declare(P, 1).start()
        assert os.sched_getaffinity(0) == {core}
        b = rt.attach_bridge()           # pins the asio thread (no raise)
        a = rt.spawn(P)
        rt.send(a, P.tick, 5)
        assert rt.run(max_steps=50) == 0
        assert rt.state_of(a)["n"] == 5
        b.close()
    finally:
        os.sched_setaffinity(0, before)


def test_affinity_bad_core_raises():
    from ponyc_tpu_torch import RuntimeOptions

    rt = Runtime(RuntimeOptions(msg_words=1, pin=4096))
    try:
        rt.start()
        raise AssertionError("pin to absurd core did not raise")
    except ValueError:
        pass

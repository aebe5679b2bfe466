"""The port's net layer (ponyc_tpu_torch/net), under the JAX package's
tests (tests/test_net.py), case for case, on the CPU.

TCP/UDP over real loopback sockets (≙ the reference's de-facto net
integration tests: packages/net/_test.pony runs listener+connection pairs
over 127.0.0.1 under ponytest)."""

import dataclasses

import numpy as np

import ponyc_tpu_torch
from ponyc_tpu_torch import I32, RuntimeOptions, actor, behaviour


def Runtime(opts=None):
    """The port's Runtime on the CPU (the tests' device), with the tuning
    cache off."""
    if opts is not None:
        opts = dataclasses.replace(opts, tuning_cache="off")
    return ponyc_tpu_torch.Runtime(opts, device="cpu")


@actor
class EchoServer:
    HOST = True
    n_conns: I32
    n_bytes: I32

    @behaviour
    def on_accept(self, st, conn: I32):
        return {**st, "n_conns": st["n_conns"] + 1}

    @behaviour
    def on_data(self, st, conn: I32, data: I32, n: I32):
        payload = self.rt.heap.unbox(data)
        self.rt.net.send(conn, payload.upper())
        return {**st, "n_bytes": st["n_bytes"] + n}

    @behaviour
    def on_closed(self, st, conn: I32):
        return st


@actor
class EchoClient:
    HOST = True
    conn: I32
    ok: I32

    @behaviour
    def on_connect(self, st, conn: I32, err: I32):
        assert err == 0, err
        self.rt.net.send(conn, b"hello actors")
        return {**st, "conn": conn}

    @behaviour
    def on_data(self, st, conn: I32, data: I32, n: I32):
        reply = self.rt.heap.unbox(data)
        ok = 1 if reply == b"HELLO ACTORS" else -1
        self.rt.net.close(conn)
        self.exit(0 if ok == 1 else 3)
        return {**st, "ok": ok}

    @behaviour
    def on_closed(self, st, conn: I32):
        return st


def _mk(*types):
    rt = Runtime(RuntimeOptions(mailbox_cap=16, batch=4, max_sends=2,
                                msg_words=4, inject_slots=32))
    for t in types:
        rt.declare(t, 2)
    return rt.start()


def test_tcp_echo_roundtrip():
    rt = _mk(EchoServer, EchoClient)
    net = rt.attach_net()
    srv = rt.spawn(EchoServer)
    cli = rt.spawn(EchoClient)
    lid = net.listen_tcp("127.0.0.1", 0, srv,
                         on_accept=EchoServer.on_accept,
                         on_data=EchoServer.on_data,
                         on_closed=EchoServer.on_closed)
    port = net.listen_port(lid)
    assert port > 0
    net.connect_tcp("127.0.0.1", port, cli,
                    on_connect=EchoClient.on_connect,
                    on_data=EchoClient.on_data,
                    on_closed=EchoClient.on_closed)
    code = rt.run(max_steps=4000)
    assert code == 0
    assert rt.state_of(cli)["ok"] == 1
    assert rt.state_of(srv)["n_conns"] == 1
    assert rt.state_of(srv)["n_bytes"] == len(b"hello actors")
    net.close_all()
    rt.stop()
    # All payload handles were consumed (move semantics, no leaks).
    assert rt.heap.live == 0


@actor
class Gram:
    HOST = True
    got: I32
    port_seen: I32

    @behaviour
    def on_datagram(self, st, sock: I32, data: I32, n: I32):
        payload, host, port = self.rt.heap.unbox(data)
        assert host in ("127.0.0.1", "::1", "::ffff:127.0.0.1")
        if payload == b"ping":
            # reply to the sender's ephemeral port
            self.rt.net.sendto(sock, b"pong", host, port)
            return {**st, "got": st["got"] + 1, "port_seen": port}
        self.exit(0)
        return {**st, "got": st["got"] + 1}


def test_udp_ping_pong():
    rt = _mk(Gram)
    net = rt.attach_net()
    a = rt.spawn(Gram)
    b = rt.spawn(Gram)
    ua = net.udp_bind("127.0.0.1", 0, a, on_datagram=Gram.on_datagram)
    ub = net.udp_bind("127.0.0.1", 0, b, on_datagram=Gram.on_datagram)
    pa = net.listen_port(ua)
    net.sendto(ub, b"ping", "127.0.0.1", pa)   # b → a, a replies pong → b
    code = rt.run(max_steps=4000)
    assert code == 0
    assert rt.state_of(a)["got"] == 1
    assert rt.state_of(b)["got"] == 1
    net.close_all()
    rt.stop()


def test_large_transfer_with_write_buffering():
    # Push well past the kernel buffer so the host-side outbuf + write
    # re-arming path actually engages (≙ pending writes in packages/net).
    blob = bytes(range(256)) * 4096   # 1 MiB

    @actor
    class Sink:
        HOST = True
        total: I32

        @behaviour
        def on_accept(self, st, conn: I32):
            return st

        @behaviour
        def on_data(self, st, conn: I32, data: I32, n: I32):
            self.rt.heap.drop(data)
            t = st["total"] + n
            self.exit(0, when=t >= len(blob))
            return {**st, "total": t}

        @behaviour
        def on_closed(self, st, conn: I32):
            return st

    @actor
    class Blaster:
        HOST = True

        @behaviour
        def on_connect(self, st, conn: I32, err: I32):
            assert err == 0
            self.rt.net.send(conn, blob)
            return st

        @behaviour
        def on_data(self, st, conn: I32, data: I32, n: I32):
            return st

        @behaviour
        def on_closed(self, st, conn: I32):
            return st

    rt = _mk(Sink, Blaster)
    net = rt.attach_net()
    sink = rt.spawn(Sink)
    blaster = rt.spawn(Blaster)
    lid = net.listen_tcp("127.0.0.1", 0, sink,
                         on_accept=Sink.on_accept, on_data=Sink.on_data,
                         on_closed=Sink.on_closed)
    net.connect_tcp("127.0.0.1", net.listen_port(lid), blaster,
                    on_connect=Blaster.on_connect,
                    on_data=Blaster.on_data, on_closed=Blaster.on_closed)
    code = rt.run(max_steps=20000)
    assert code == 0
    assert rt.state_of(sink)["total"] == len(blob)
    net.close_all()
    rt.stop()


def test_tcp_connection_churn_conserves_bytes():
    """Many concurrent loopback connections each echoing several chunks:
    byte-exact conservation, all accepts seen, no payload-handle leaks
    (≙ packages/net tests running listener+connection fleets under
    ponytest)."""
    import time

    CHUNKS, N = 3, 12
    MSG = b"x" * 700

    @actor
    class ChSrv:
        HOST = True
        n_conns: I32
        n_bytes: I32

        @behaviour
        def on_accept(self, st, conn: I32):
            return {**st, "n_conns": st["n_conns"] + 1}

        @behaviour
        def on_data(self, st, conn: I32, data: I32, n: I32):
            payload = self.rt.heap.unbox(data)
            self.rt.net.send(conn, payload)
            return {**st, "n_bytes": st["n_bytes"] + n}

        @behaviour
        def on_closed(self, st, conn: I32):
            return st

    @actor
    class ChCli:
        HOST = True
        conn: I32
        got: I32
        done: I32

        @behaviour
        def on_connect(self, st, conn: I32, err: I32):
            assert err == 0, err
            self.rt.net.send(conn, MSG)
            return {**st, "conn": conn, "got": 0}

        @behaviour
        def on_data(self, st, conn: I32, data: I32, n: I32):
            self.rt.heap.unbox(data)
            got = st["got"] + n
            if got >= len(MSG) * CHUNKS:
                self.rt.net.close(conn)
                return {**st, "got": got, "done": 1}
            if got % len(MSG) == 0:
                self.rt.net.send(conn, MSG)
            return {**st, "got": got}

        @behaviour
        def on_closed(self, st, conn: I32):
            return st

    rt = Runtime(RuntimeOptions(mailbox_cap=32, batch=8, max_sends=2,
                                msg_words=4, inject_slots=128))
    rt.declare(ChSrv, 1).declare(ChCli, N)
    rt.start()
    net = rt.attach_net()
    srv = rt.spawn(ChSrv)
    lid = net.listen_tcp("127.0.0.1", 0, srv, on_accept=ChSrv.on_accept,
                         on_data=ChSrv.on_data, on_closed=ChSrv.on_closed)
    port = net.listen_port(lid)
    clis = [rt.spawn(ChCli) for _ in range(N)]
    for c in clis:
        net.connect_tcp("127.0.0.1", port, c, on_connect=ChCli.on_connect,
                        on_data=ChCli.on_data, on_closed=ChCli.on_closed)
    deadline = time.time() + 60
    while time.time() < deadline:
        rt.run(max_steps=200)
        if sum(rt.state_of(c)["done"] for c in clis) == N:
            break
        time.sleep(0.01)
    assert sum(rt.state_of(c)["done"] for c in clis) == N
    assert rt.state_of(srv)["n_bytes"] == N * CHUNKS * len(MSG)
    assert rt.state_of(srv)["n_conns"] == N
    net.close_all()
    rt.stop()
    assert rt.heap.live == 0, rt.heap.live

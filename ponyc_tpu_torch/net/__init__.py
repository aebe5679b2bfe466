"""TCP/UDP networking as actor messages — ≙ packages/net over
lang/socket.c.

The reference splits networking into the native syscall layer
(src/libponyrt/lang/socket.c: pony_os_listen_tcp/accept/connect/recv/
send, all non-blocking and ASIO-subscribed) and the stdlib actors
(packages/net/tcp_listener.pony, tcp_connection.pony, udp_socket.pony)
that turn readiness events into notify callbacks. This package keeps the
same split: syscalls live in native/src/socket.cc; this layer owns the
fds, does the accept/recv/send loops at poll boundaries, and delivers
*actor messages* to the owning (host-cohort) actors:

    on_accept(conn: I32)                      ≙ TCPListenNotify.connected
    on_connect(conn: I32, err: I32)           ≙ ConnectionNotify.connected/
                                                connect_failed (err=errno)
    on_data(conn: I32, data: I32, n: I32)     ≙ TCPConnectionNotify.received
        `data` is a HostHeap handle — rt.heap.unbox(data) yields bytes
        (move semantics ≙ the Array[U8] iso the reference passes)
    on_closed(conn: I32)                      ≙ ...closed
    on_datagram(sock: I32, data: I32, n: I32) ≙ UDPNotify.received
        unbox → (bytes, host, port)

Writes buffer host-side when the kernel refuses; write-readiness is armed
only while the buffer is non-empty (≙ pony_os_writev + the reference's
resubscribe-on-EAGAIN dance) and `pending(conn)` exposes the backlog so
applications can throttle (≙ packages/net throttled/unthrottled).
"""

from __future__ import annotations

import collections

from typing import Dict, Tuple

from .. import native
from ..api import BehaviourDef
from ..native import sockets as S


class _Conn:
    __slots__ = ("fd", "sub", "owner", "on_connect", "on_data", "on_closed",
                 "outbuf", "outbuf_len", "connecting", "closed", "tls")

    def __init__(self, fd, owner, on_connect, on_data, on_closed,
                 connecting, tls=None):
        self.fd = fd
        self.sub = None
        self.owner = owner
        self.on_connect = on_connect
        self.on_data = on_data
        self.on_closed = on_closed
        self.outbuf = collections.deque()   # chunks (writev scatter-gather)
        self.outbuf_len = 0
        self.connecting = connecting
        self.closed = False
        self.tls = tls        # net.tls._TLSState or None (≙ ssl.c hooks)


class Net:
    """One runtime's network layer (create via rt.attach_net())."""

    RECV_CHUNK = 65536

    def __init__(self, rt):
        self.rt = rt
        self.bridge = rt.attach_bridge()
        self._listeners: Dict[int, Tuple[int, int, int,
                                         Tuple[BehaviourDef, BehaviourDef,
                                               BehaviourDef]]] = {}
        self._conns: Dict[int, _Conn] = {}
        self._udp: Dict[int, Tuple[int, int, BehaviourDef]] = {}
        self._next = 1

    def _check(self, bdef, n_args, what):
        if not isinstance(bdef, BehaviourDef) or bdef.global_id is None:
            raise TypeError(f"{what} must be a program-registered behaviour")
        if not bdef.actor_type.HOST:
            raise TypeError(
                f"{what} must live on a HOST=True actor type (network "
                "payload handles are host objects; forward parsed words "
                "to device actors from there)")
        if len(bdef.arg_specs) != n_args:
            raise TypeError(f"{what} must take {n_args} i32 args")

    # -- listeners (≙ TCPListener + pony_os_listen_tcp) --
    def listen_tcp(self, host: str, port: int, owner: int, *,
                   on_accept: BehaviourDef, on_data: BehaviourDef,
                   on_closed: BehaviourDef, backlog: int = 64,
                   tls=None) -> int:
        """`tls=TLSServerConfig(...)` upgrades every accepted connection
        to TLS (net/tls.py ≙ the ssl.c hook surface)."""
        self._check(on_accept, 1, "on_accept")
        self._check(on_data, 3, "on_data")
        self._check(on_closed, 1, "on_closed")
        fd = S.listen_tcp(host, port, backlog)
        lid = self._next
        self._next += 1
        sub = self.bridge.fd_callback(fd, lambda ev: self._accept_ready(lid),
                                      read=True, noisy=True)
        self._listeners[lid] = (fd, sub, owner,
                                (on_accept, on_data, on_closed), tls)
        return lid

    def listen_port(self, lid: int) -> int:
        """The bound port (for ephemeral listens; ≙ pony_os_sockname)."""
        if lid in self._listeners:
            return S.sockname_port(self._listeners[lid][0])
        if lid in self._udp:
            return S.sockname_port(self._udp[lid][0])
        raise KeyError(lid)

    def _accept_ready(self, lid: int) -> None:
        ent = self._listeners.get(lid)
        if ent is None:
            return
        fd, _sub, owner, (on_accept, on_data, on_closed), tls_cfg = ent
        while True:
            nfd = S.accept(fd)
            if nfd is None:
                break
            tls = tls_cfg.make() if tls_cfg is not None else None
            cid = self._register_conn(nfd, owner, None, on_data, on_closed,
                                      connecting=False, tls=tls)
            if tls is not None:
                tls.start()                     # await ClientHello
                self._tls_pump(cid, self._conns[cid])
            self.rt.send(owner, on_accept, cid)

    # -- connections (≙ TCPConnection + pony_os_connect_tcp) --
    def connect_tcp(self, host: str, port: int, owner: int, *,
                    on_connect: BehaviourDef, on_data: BehaviourDef,
                    on_closed: BehaviourDef, tls=None) -> int:
        """`tls=TLSClientConfig(...)`: on_connect fires AFTER the TLS
        handshake (err=0), or err=-1 on handshake failure."""
        self._check(on_connect, 2, "on_connect")
        self._check(on_data, 3, "on_data")
        self._check(on_closed, 1, "on_closed")
        fd = S.connect_tcp(host, port)
        return self._register_conn(fd, owner, on_connect, on_data,
                                   on_closed, connecting=True,
                                   tls=tls.make() if tls else None)

    def _register_conn(self, fd, owner, on_connect, on_data, on_closed,
                       *, connecting, tls=None) -> int:
        cid = self._next
        self._next += 1
        c = _Conn(fd, owner, on_connect, on_data, on_closed, connecting,
                  tls)
        # A connecting socket arms write interest to learn the outcome.
        c.sub = self.bridge.fd_callback(
            fd, lambda ev: self._conn_ready(cid, ev),
            read=True, write=connecting, noisy=True)
        self._conns[cid] = c
        return cid

    def _conn_ready(self, cid: int, ev) -> None:
        c = self._conns.get(cid)
        if c is None or c.closed:
            return
        if ev.kind == native.FD_WRITE:
            if c.connecting:
                c.connecting = False
                err = S.connect_result(c.fd)
                if err != 0:          # TCP failed (before TLS, if any)
                    if c.on_connect is not None:
                        self.rt.send(c.owner, c.on_connect, cid, err)
                    self._teardown(cid, notify=False)
                    return
                if c.tls is None:
                    if c.on_connect is not None:
                        self.rt.send(c.owner, c.on_connect, cid, err)
                else:
                    c.tls.start()     # ClientHello → outbuf
                    self._tls_pump(cid, c)
                self._arm(c)
            if c.outbuf:
                self._flush(cid, c)
            return
        if ev.kind == native.FD_READ:
            while True:
                data = S.recv(c.fd, self.RECV_CHUNK)
                if data is None:      # drained
                    break
                if data == b"":       # orderly EOF
                    self._teardown(cid, notify=True)
                    return
                if c.tls is not None:
                    c.tls.feed(data)
                    if not self._tls_pump(cid, c):
                        return        # handshake failure tore down
                    app = c.tls.read_app()
                    if app:
                        h = self.rt.heap.box(app)
                        self.rt.send(c.owner, c.on_data, cid, h, len(app))
                    if c.tls.failed and not self._tls_pump(cid, c):
                        return        # record failure (bad MAC …)
                    continue
                h = self.rt.heap.box(data)
                self.rt.send(c.owner, c.on_data, cid, h, len(data))
                # Edge-triggered subscription: always drain to EAGAIN.
            return
        if ev.kind == native.FD_HUP:
            self._teardown(cid, notify=True)

    def _tls_pump(self, cid: int, c: _Conn) -> bool:
        """Move the record layer forward: transmit pending ciphertext,
        complete the handshake (flush pre-handshake plaintext, deliver
        the deferred on_connect), surface failures. False = torn down."""
        tls = c.tls
        if tls.failed:
            if (not tls.done and c.on_connect is not None
                    and not tls.notified):
                # Handshake never completed: the client learns via
                # on_connect(-1); on_closed would be about a connection
                # it was never told is up.
                tls.notified = True
                self.rt.send(c.owner, c.on_connect, cid, -1)
                self._teardown(cid, notify=False)
            else:
                # Established connection died (record failure) — or a
                # server-side handshake failure on a conn the owner
                # already saw via on_accept: on_closed either way.
                self._teardown(cid, notify=True)
            return False
        if tls.done and tls.pending_app:
            tls.flush_pending()
        out = tls.take_out()
        if out:
            c.outbuf.append(out)
            c.outbuf_len += len(out)
            if not c.connecting:
                self._flush(cid, c)
        if tls.done and not tls.notified:
            tls.notified = True
            if c.on_connect is not None:
                self.rt.send(c.owner, c.on_connect, cid, 0)
        return True

    def _arm(self, c: _Conn) -> None:
        self.bridge.loop.fd_interest(c.sub, read=True,
                                     write=bool(c.outbuf))

    def _flush(self, cid: int, c: _Conn) -> None:
        # Scatter-gather flush: one writev per round sends the whole
        # chunk list without flattening (≙ the reference's iovec write
        # path, lang/socket.c pony_os_writev).
        while c.outbuf:
            n = S.writev(c.fd, list(c.outbuf))
            if n <= 0:
                break
            c.outbuf_len -= n
            while n > 0 and c.outbuf:
                head = c.outbuf[0]
                if n >= len(head):
                    n -= len(head)
                    c.outbuf.popleft()
                else:
                    c.outbuf[0] = head[n:]
                    n = 0
        self._arm(c)

    # -- user API on connections --
    def send(self, cid: int, data: bytes) -> None:
        """Queue bytes; the layer writes as the socket allows (≙
        TCPConnection.write with host-side pending buffer)."""
        self.sendv(cid, (data,))

    def sendv(self, cid: int, chunks) -> None:
        """Queue a chunk LIST (e.g. buffered.Writer.done()) — sent with
        scatter-gather writev, no flattening (≙ TCPConnection.writev)."""
        c = self._conns.get(cid)
        if c is None or c.closed:
            raise KeyError(f"connection {cid} is closed")
        if c.tls is not None:
            # Plaintext → record layer; ciphertext rides the outbuf.
            for ch in chunks:
                ch = bytes(ch)
                if ch:
                    c.tls.write_app(ch)
            self._tls_pump(cid, c)
            return
        for ch in chunks:
            ch = bytes(ch)
            if ch:
                c.outbuf.append(ch)
                c.outbuf_len += len(ch)
        if not c.connecting:
            self._flush(cid, c)

    def pending(self, cid: int) -> int:
        """Unflushed outgoing bytes (backpressure signal ≙ throttled)."""
        c = self._conns.get(cid)
        return c.outbuf_len if c is not None else 0

    def pending_total(self) -> int:
        """Unflushed outgoing bytes across ALL connections — the
        layer-wide egress-backpressure gauge (`/metrics` exports it as
        pony_tpu_net_pending_bytes; /healthz degrades when it grows
        monotonically across snapshots: a consumer has stopped
        reading)."""
        return sum(c.outbuf_len for c in self._conns.values())

    def set_conn_owner(self, cid: int, owner: int, *,
                       on_data: BehaviourDef,
                       on_closed: BehaviourDef) -> None:
        """Hand a connection to another actor (≙ the reference pattern of
        the listener's notify creating a fresh TCPConnectionNotify)."""
        self._check(on_data, 3, "on_data")
        self._check(on_closed, 1, "on_closed")
        c = self._conns[cid]
        c.owner, c.on_data, c.on_closed = owner, on_data, on_closed

    def nodelay(self, cid: int, on: bool = True) -> None:
        S.nodelay(self._conns[cid].fd, on)

    def close(self, cid: int) -> None:
        """Graceful local close (flush refused; pending data dropped —
        call after acks, like the reference's dispose)."""
        self._teardown(cid, notify=False)

    def _teardown(self, cid: int, *, notify: bool) -> None:
        c = self._conns.pop(cid, None)
        if c is None or c.closed:
            return
        c.closed = True
        self.bridge.unsubscribe(c.sub)
        S.close(c.fd)
        if notify and c.on_closed is not None:
            self.rt.send(c.owner, c.on_closed, cid)

    def close_listener(self, lid: int) -> None:
        ent = self._listeners.pop(lid, None)
        if ent is None:
            return
        fd, sub, _owner, _b, _tls = ent
        self.bridge.unsubscribe(sub)
        S.close(fd)

    # -- UDP (≙ packages/net UDPSocket + pony_os_listen_udp) --
    def udp_bind(self, host: str, port: int, owner: int, *,
                 on_datagram: BehaviourDef) -> int:
        self._check(on_datagram, 3, "on_datagram")
        fd = S.udp(host, port)
        uid = self._next
        self._next += 1
        sub = self.bridge.fd_callback(
            fd, lambda ev: self._udp_ready(uid), read=True, noisy=True)
        self._udp[uid] = (fd, sub, (owner, on_datagram))
        return uid

    def _udp_ready(self, uid: int) -> None:
        ent = self._udp.get(uid)
        if ent is None:
            return
        fd, _sub, (owner, on_datagram) = ent
        while True:
            r = S.recvfrom(fd, self.RECV_CHUNK)
            if r is None:
                break
            data, host, port = r
            h = self.rt.heap.box((data, host, port))
            self.rt.send(owner, on_datagram, uid, h, len(data))

    def sendto(self, uid: int, data: bytes, host: str, port: int) -> None:
        fd, _sub, _b = self._udp[uid]
        S.sendto(fd, bytes(data), host, port)

    def close_udp(self, uid: int) -> None:
        ent = self._udp.pop(uid, None)
        if ent is None:
            return
        fd, sub, _b = ent
        self.bridge.unsubscribe(sub)
        S.close(fd)

    def close_all(self) -> None:
        for cid in list(self._conns):
            self._teardown(cid, notify=False)
        for lid in list(self._listeners):
            self.close_listener(lid)
        for uid in list(self._udp):
            self.close_udp(uid)

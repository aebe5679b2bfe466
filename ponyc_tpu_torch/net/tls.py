"""TLS for net actors — ≙ the reference's SSL hooks
(src/libponyrt/lang/ssl.c:1, deliberately thin there too: the reference
keeps protocol logic out of the runtime and lets a stdlib layer drive
OpenSSL; here the host-side record layer is Python's ``ssl`` module
driven through memory BIOs, non-blocking end to end).

Usage — pass a config to the existing net entry points:

    tls = TLSClientConfig(server_hostname="example.com")     # verifying
    cid = net.connect_tcp(host, port, owner, ..., tls=tls)

    srv = TLSServerConfig(certfile="cert.pem", keyfile="key.pem")
    lid = net.listen_tcp(host, port, owner, ..., tls=srv)

Semantics (matching the reference stdlib's SSL-connection filter model):
``on_connect`` fires only after the HANDSHAKE completes (err=0), or with
err=-1 on handshake failure; ``on_data`` delivers DECRYPTED bytes;
``Net.send`` encrypts transparently; plaintext queued before the
handshake finishes is flushed right after it.
"""

from __future__ import annotations

import ssl as _ssl
from typing import Optional


class TLSError(RuntimeError):
    pass


class TLSClientConfig:
    """Client-side TLS parameters. `verify=False` (or no cafile +
    check_hostname off) degrades gracefully for self-signed peers."""

    def __init__(self, server_hostname: Optional[str] = None, *,
                 cafile: Optional[str] = None, verify: bool = True):
        self.server_hostname = server_hostname
        self.cafile = cafile
        self.verify = verify

    def context(self) -> _ssl.SSLContext:
        ctx = _ssl.create_default_context(cafile=self.cafile)
        if not self.verify:
            ctx.check_hostname = False
            ctx.verify_mode = _ssl.CERT_NONE
        return ctx

    def make(self):
        ctx = self.context()
        inc, out = _ssl.MemoryBIO(), _ssl.MemoryBIO()
        obj = ctx.wrap_bio(inc, out, server_side=False,
                           server_hostname=self.server_hostname)
        return _TLSState(obj, inc, out)


class TLSServerConfig:
    """Server-side TLS parameters (certificate + key required, exactly
    like any TLS server)."""

    def __init__(self, certfile: str, keyfile: Optional[str] = None):
        self.certfile = certfile
        self.keyfile = keyfile

    def context(self) -> _ssl.SSLContext:
        ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certfile, self.keyfile)
        return ctx

    def make(self):
        ctx = self.context()
        inc, out = _ssl.MemoryBIO(), _ssl.MemoryBIO()
        obj = ctx.wrap_bio(inc, out, server_side=True)
        return _TLSState(obj, inc, out)


class _TLSState:
    """Per-connection record layer: an SSLObject over a memory-BIO pair,
    pumped by the net layer at poll boundaries. Pure state machine — no
    fd, no blocking (the net layer owns the socket)."""

    __slots__ = ("obj", "inc", "out", "done", "failed",
                 "pending_app", "notified")

    def __init__(self, obj, inc, out):
        self.obj = obj
        self.inc = inc
        self.out = out
        self.done = False          # handshake complete
        self.failed = False
        self.pending_app = []      # plaintext queued pre-handshake
        self.notified = False      # client on_connect delivered

    # -- driving --
    def start(self):
        """Kick off the client hello (or server wait)."""
        self._step_handshake()

    def feed(self, data: bytes):
        """Raw ciphertext from the socket → BIO."""
        self.inc.write(data)
        if not self.done:
            self._step_handshake()

    def _step_handshake(self):
        if self.done or self.failed:
            return
        try:
            self.obj.do_handshake()
            self.done = True
        except _ssl.SSLWantReadError:
            pass                   # needs more peer bytes
        except _ssl.SSLError:
            self.failed = True

    def read_app(self) -> bytes:
        """Drain decrypted application bytes (b'' if none yet)."""
        if not self.done:
            return b""
        chunks = []
        while True:
            try:
                chunk = self.obj.read(65536)
            except (_ssl.SSLWantReadError, _ssl.SSLWantWriteError):
                break
            except _ssl.SSLZeroReturnError:    # close_notify
                break
            except _ssl.SSLError:
                self.failed = True
                break
            if not chunk:
                break
            chunks.append(chunk)
        return b"".join(chunks)

    def write_app(self, data: bytes):
        """Encrypt plaintext (buffered until the handshake is done)."""
        if not self.done:
            self.pending_app.append(data)
            return
        self.obj.write(data)

    def flush_pending(self):
        for d in self.pending_app:
            self.obj.write(d)
        self.pending_app.clear()

    def take_out(self) -> bytes:
        """Ciphertext the socket should transmit now."""
        return self.out.read() if self.out.pending else b""

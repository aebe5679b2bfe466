"""The port's TLS layer (ponyc_tpu_torch/net/tls.py), under the JAX
package's tests (tests/test_net_tls.py), case for case, on the CPU.

TLS over the net actor layer (net/tls.py ≙ lang/ssl.c hooks + the
SSL-connection filter the reference stdlib layers over them): a real
encrypted loopback echo between two actors in one runtime, deferred
on_connect-after-handshake semantics, pre-handshake write buffering,
and handshake failure surfacing."""

import dataclasses
import datetime
import os

import pytest

# The self-signed test certificates come from the optional `cryptography`
# package (README: optional extras). The TLS layer itself is stdlib-ssl
# only; without the cert generator these tests skip rather than error.
pytest.importorskip("cryptography")

import ponyc_tpu_torch  # noqa: E402
from ponyc_tpu_torch import I32, RuntimeOptions, actor, behaviour  # noqa: E402
from ponyc_tpu_torch.net.tls import TLSClientConfig, TLSServerConfig  # noqa: E402


def Runtime(opts=None):
    """The port's Runtime on the CPU (the tests' device), with the tuning
    cache off."""
    if opts is not None:
        opts = dataclasses.replace(opts, tuning_cache="off")
    return ponyc_tpu_torch.Runtime(opts, device="cpu")


@pytest.fixture(scope="module")
def certpair(tmp_path_factory):
    """Self-signed localhost cert via the cryptography package."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    d = tmp_path_factory.mktemp("tls")
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(
                x509.SubjectAlternativeName(
                    [x509.DNSName("localhost")]), critical=False)
            .sign(key, hashes.SHA256()))
    certfile = str(d / "cert.pem")
    keyfile = str(d / "key.pem")
    with open(certfile, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(keyfile, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    return certfile, keyfile


def _opts():
    return RuntimeOptions(mailbox_cap=16, batch=4, max_sends=0,
                          msg_words=3, inject_slots=64)


def test_tls_echo_roundtrip(certpair):
    certfile, keyfile = certpair
    state = {"server_got": [], "client_got": [], "connect_err": None}

    @actor
    class Server:
        HOST = True
        n: I32

        @behaviour
        def on_accept(self, st, cid: I32):
            return st

        @behaviour
        def on_data(self, st, cid: I32, h: I32, n: I32):
            data = self.rt.heap.unbox(int(h))
            state["server_got"].append(data)
            self.rt.net.send(int(cid), b"echo:" + data)   # encrypted
            return st

        @behaviour
        def on_closed(self, st, cid: I32):
            return st

    @actor
    class Client:
        HOST = True
        n: I32

        @behaviour
        def on_connect(self, st, cid: I32, err: I32):
            state["connect_err"] = int(err)
            return st

        @behaviour
        def on_data(self, st, cid: I32, h: I32, n: I32):
            state["client_got"].append(self.rt.heap.unbox(int(h)))
            self.rt.request_exit(0)
            return st

        @behaviour
        def on_closed(self, st, cid: I32):
            return st

    rt = Runtime(_opts())
    rt.declare(Server, 1).declare(Client, 1).start()
    srv = rt.spawn(Server)
    cli = rt.spawn(Client)
    net = rt.attach_net()
    lid = net.listen_tcp("127.0.0.1", 0, srv,
                         on_accept=Server.on_accept,
                         on_data=Server.on_data,
                         on_closed=Server.on_closed,
                         tls=TLSServerConfig(certfile, keyfile))
    port = net.listen_port(lid)
    cid = net.connect_tcp("127.0.0.1", port, cli,
                          on_connect=Client.on_connect,
                          on_data=Client.on_data,
                          on_closed=Client.on_closed,
                          tls=TLSClientConfig("localhost",
                                              cafile=certfile))
    # Pre-handshake write: buffered plaintext, flushed post-handshake.
    net.send(cid, b"hello-tls")
    rt.run(max_steps=100_000)
    assert state["connect_err"] == 0, "handshake did not complete"
    assert state["server_got"] == [b"hello-tls"]
    assert state["client_got"] == [b"echo:hello-tls"]
    net.close_all()


def test_tls_handshake_failure_surfaces(certpair):
    """A VERIFYING client against a self-signed server it does not
    trust: on_connect must deliver err=-1, not hang or deliver data."""
    certfile, keyfile = certpair
    state = {"err": None, "data": []}

    @actor
    class Srv2:
        HOST = True
        n: I32

        @behaviour
        def on_accept(self, st, cid: I32):
            return st

        @behaviour
        def on_data(self, st, cid: I32, h: I32, n: I32):
            self.rt.heap.drop(int(h))
            return st

        @behaviour
        def on_closed(self, st, cid: I32):
            return st

    @actor
    class Cli2:
        HOST = True
        n: I32

        @behaviour
        def on_connect(self, st, cid: I32, err: I32):
            state["err"] = int(err)
            self.rt.request_exit(0)
            return st

        @behaviour
        def on_data(self, st, cid: I32, h: I32, n: I32):
            state["data"].append(self.rt.heap.unbox(int(h)))
            return st

        @behaviour
        def on_closed(self, st, cid: I32):
            return st

    rt = Runtime(_opts())
    rt.declare(Srv2, 1).declare(Cli2, 1).start()
    srv = rt.spawn(Srv2)
    cli = rt.spawn(Cli2)
    net = rt.attach_net()
    lid = net.listen_tcp("127.0.0.1", 0, srv,
                         on_accept=Srv2.on_accept, on_data=Srv2.on_data,
                         on_closed=Srv2.on_closed,
                         tls=TLSServerConfig(certfile, keyfile))
    port = net.listen_port(lid)
    net.connect_tcp("127.0.0.1", port, cli,
                    on_connect=Cli2.on_connect, on_data=Cli2.on_data,
                    on_closed=Cli2.on_closed,
                    tls=TLSClientConfig("localhost"))   # system CAs: fails
    rt.run(max_steps=100_000)
    assert state["err"] == -1
    assert state["data"] == []
    net.close_all()


def test_plain_tcp_still_works_alongside():
    """tls=None path unchanged (regression guard for the integration)."""
    state = {"got": []}

    @actor
    class P:
        HOST = True
        n: I32

        @behaviour
        def on_accept(self, st, cid: I32):
            return st

        @behaviour
        def on_data(self, st, cid: I32, h: I32, n: I32):
            state["got"].append(self.rt.heap.unbox(int(h)))
            self.rt.request_exit(0)
            return st

        @behaviour
        def on_closed(self, st, cid: I32):
            return st

        @behaviour
        def on_connect(self, st, cid: I32, err: I32):
            self.rt.net.send(int(cid), b"plain")
            return st

    rt = Runtime(_opts())
    rt.declare(P, 2).start()
    a, b = rt.spawn_many(P, 2)
    net = rt.attach_net()
    lid = net.listen_tcp("127.0.0.1", 0, int(a),
                         on_accept=P.on_accept, on_data=P.on_data,
                         on_closed=P.on_closed)
    net.connect_tcp("127.0.0.1", net.listen_port(lid), int(b),
                    on_connect=P.on_connect, on_data=P.on_data,
                    on_closed=P.on_closed)
    rt.run(max_steps=100_000)
    assert state["got"] == [b"plain"]
    net.close_all()

"""ctypes bindings for the native host runtime (libponyx_host.so).

The native layer is the C++ counterpart of the reference's host-side
runtime services (SURVEY.md §2.1): the pool allocator (mem/pool.c), the
MPSC staging queue (actor/messageq.c) and the ASIO event loop
(asio/asio.c + asio/epoll.c). Device-side execution (mailbox table,
dispatch, routing) lives on the card; this library covers the pieces
that must stay on the host — OS events, timers, signals, sockets —
exactly where the reference keeps its ASIO thread.

The library builds at first use from `src/` with the host C++ compiler
(``$CXX``, else ``c++``/``g++``; the flags of `Makefile`) into
``ponyc_tpu_torch/_build/native/``, named by a hash of its sources, so a
changed source is a new library and concurrent first uses (test workers)
each write a temporary file and rename it into place. A failed build
raises NativeBuildError. ``make -C ponyc_tpu_torch/native`` builds the
same library by hand.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_OUT = os.path.join(os.path.dirname(_DIR), "_build", "native")
_CXXFLAGS = ["-O2", "-g", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
             "-pthread"]

_lib = None
_lib_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def _compiler() -> str:
    for cxx in (os.environ.get("CXX"), "c++", "g++"):
        if cxx and shutil.which(cxx):
            return cxx
    raise NativeBuildError("native build: no host C++ compiler ($CXX, c++ "
                           "or g++) on PATH")


def _sources() -> List[str]:
    return sorted(os.path.join(_SRC, f) for f in os.listdir(_SRC))


def library_path() -> str:
    """Where the library for the present sources lives (built or not)."""
    h = hashlib.sha256()
    for s in _sources():
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_CXXFLAGS).encode())
    return os.path.join(_OUT, f"libponyx_host-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(_OUT, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ([_compiler()] + _CXXFLAGS + ["-shared", "-o", tmp]
           + [s for s in _sources() if s.endswith(".cc")])
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise NativeBuildError(
            f"native build failed ({' '.join(cmd)}):\n{res.stdout}\n"
            f"{res.stderr}")
    os.replace(tmp, so)


def lib() -> ctypes.CDLL:
    """Load (building if necessary) the native library, once per process."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        l = ctypes.CDLL(so)
        c = ctypes
        l.ponyx_pool_alloc.restype = c.c_void_p
        l.ponyx_pool_alloc.argtypes = [c.c_size_t]
        l.ponyx_pool_free.argtypes = [c.c_size_t, c.c_void_p]
        l.ponyx_pool_allocated.restype = c.c_uint64
        l.ponyx_pool_recycled.restype = c.c_uint64
        l.ponyx_pool_index.restype = c.c_int
        l.ponyx_pool_index.argtypes = [c.c_size_t]

        l.ponyx_mpscq_create.restype = c.c_void_p
        l.ponyx_mpscq_destroy.argtypes = [c.c_void_p]
        l.ponyx_mpscq_push.argtypes = [c.c_void_p,
                                       c.POINTER(c.c_int32), c.c_int32]
        l.ponyx_mpscq_pop.restype = c.c_int32
        l.ponyx_mpscq_pop.argtypes = [c.c_void_p,
                                      c.POINTER(c.c_int32), c.c_int32]
        l.ponyx_mpscq_count.restype = c.c_int64
        l.ponyx_mpscq_count.argtypes = [c.c_void_p]

        l.ponyx_asio_create.restype = c.c_void_p
        l.ponyx_asio_destroy.argtypes = [c.c_void_p]
        l.ponyx_asio_setaffinity.restype = c.c_int32
        l.ponyx_asio_setaffinity.argtypes = [
            c.c_void_p, c.POINTER(c.c_int32), c.c_int32]
        l.ponyx_asio_timer.restype = c.c_int32
        l.ponyx_asio_timer.argtypes = [c.c_void_p, c.c_int64, c.c_int64,
                                       c.c_int32, c.c_int32, c.c_int32,
                                       c.c_int32]
        l.ponyx_bench_pool.restype = c.c_double
        l.ponyx_bench_pool.argtypes = [c.c_uint64, c.c_uint64]
        l.ponyx_bench_pool_burst.restype = c.c_double
        l.ponyx_bench_pool_burst.argtypes = [c.c_uint64, c.c_uint64,
                                             c.c_uint64]
        l.ponyx_bench_mpscq.restype = c.c_double
        l.ponyx_bench_mpscq.argtypes = [c.c_uint64, c.c_uint64]
        l.ponyx_bench_mpscq_mt.restype = c.c_double
        l.ponyx_bench_mpscq_mt.argtypes = [c.c_uint64, c.c_uint64,
                                           c.c_uint64]
        l.ponyx_asio_signal.restype = c.c_int32
        l.ponyx_asio_signal.argtypes = [c.c_void_p, c.c_int32, c.c_int32,
                                        c.c_int32, c.c_int32]
        l.ponyx_asio_fd.restype = c.c_int32
        l.ponyx_asio_fd.argtypes = [c.c_void_p, c.c_int32, c.c_int32,
                                    c.c_int32, c.c_int32, c.c_int32,
                                    c.c_int32]
        l.ponyx_asio_unsubscribe.restype = c.c_int32
        l.ponyx_asio_unsubscribe.argtypes = [c.c_void_p, c.c_int32]
        l.ponyx_asio_fd_interest.restype = c.c_int32
        l.ponyx_asio_fd_interest.argtypes = [c.c_void_p, c.c_int32,
                                             c.c_int32]
        l.ponyx_asio_drain.restype = c.c_int32
        l.ponyx_asio_drain.argtypes = [c.c_void_p,
                                       c.POINTER(c.c_int32), c.c_int32]
        l.ponyx_asio_pending.restype = c.c_int64
        l.ponyx_asio_pending.argtypes = [c.c_void_p]
        l.ponyx_asio_wait.restype = c.c_int32
        l.ponyx_asio_wait.argtypes = [c.c_void_p, c.c_int32]
        l.ponyx_asio_noisy_add.argtypes = [c.c_void_p]
        l.ponyx_asio_noisy_remove.argtypes = [c.c_void_p]
        l.ponyx_asio_noisy_count.restype = c.c_int64
        l.ponyx_asio_noisy_count.argtypes = [c.c_void_p]

        u8p = c.POINTER(c.c_uint8)
        l.ponyx_os_listen_tcp.restype = c.c_int32
        l.ponyx_os_listen_tcp.argtypes = [c.c_char_p, c.c_int32, c.c_int32]
        l.ponyx_os_connect_tcp.restype = c.c_int32
        l.ponyx_os_connect_tcp.argtypes = [c.c_char_p, c.c_int32]
        l.ponyx_os_accept.restype = c.c_int32
        l.ponyx_os_accept.argtypes = [c.c_int32]
        l.ponyx_os_connect_result.restype = c.c_int32
        l.ponyx_os_connect_result.argtypes = [c.c_int32]
        l.ponyx_os_recv.restype = c.c_int32
        l.ponyx_os_recv.argtypes = [c.c_int32, u8p, c.c_int32]
        l.ponyx_os_send.restype = c.c_int32
        l.ponyx_os_send.argtypes = [c.c_int32, u8p, c.c_int32]
        l.ponyx_os_udp.restype = c.c_int32
        l.ponyx_os_udp.argtypes = [c.c_char_p, c.c_int32]
        l.ponyx_os_sendto.restype = c.c_int32
        l.ponyx_os_sendto.argtypes = [c.c_int32, u8p, c.c_int32,
                                      c.c_char_p, c.c_int32]
        l.ponyx_os_recvfrom.restype = c.c_int32
        l.ponyx_os_recvfrom.argtypes = [c.c_int32, u8p, c.c_int32,
                                        c.c_char_p, c.c_int32,
                                        c.POINTER(c.c_int32)]
        l.ponyx_os_sockname_port.restype = c.c_int32
        l.ponyx_os_sockname_port.argtypes = [c.c_int32]
        l.ponyx_os_peername_port.restype = c.c_int32
        l.ponyx_os_peername_port.argtypes = [c.c_int32]
        l.ponyx_os_nodelay.restype = c.c_int32
        l.ponyx_os_nodelay.argtypes = [c.c_int32, c.c_int32]
        l.ponyx_os_keepalive.restype = c.c_int32
        l.ponyx_os_keepalive.argtypes = [c.c_int32, c.c_int32]
        l.ponyx_os_shutdown.restype = c.c_int32
        l.ponyx_os_shutdown.argtypes = [c.c_int32]
        l.ponyx_os_close.restype = c.c_int32
        l.ponyx_os_close.argtypes = [c.c_int32]
        l.ponyx_os_writev.restype = c.c_int32
        l.ponyx_os_writev.argtypes = [c.c_int32, c.POINTER(u8p),
                                      c.POINTER(c.c_int32), c.c_int32]
        l.ponyx_os_multicast_join.restype = c.c_int32
        l.ponyx_os_multicast_join.argtypes = [c.c_int32, c.c_char_p,
                                              c.c_char_p]
        l.ponyx_os_multicast_leave.restype = c.c_int32
        l.ponyx_os_multicast_leave.argtypes = [c.c_int32, c.c_char_p,
                                               c.c_char_p]
        l.ponyx_os_multicast_ttl.restype = c.c_int32
        l.ponyx_os_multicast_ttl.argtypes = [c.c_int32, c.c_int32]
        l.ponyx_os_multicast_loopback.restype = c.c_int32
        l.ponyx_os_multicast_loopback.argtypes = [c.c_int32, c.c_int32]
        l.ponyx_os_broadcast.restype = c.c_int32
        l.ponyx_os_broadcast.argtypes = [c.c_int32, c.c_int32]
        l.ponyx_os_setsockopt_int.restype = c.c_int32
        l.ponyx_os_setsockopt_int.argtypes = [c.c_int32, c.c_int32,
                                              c.c_int32, c.c_int32]
        l.ponyx_os_getsockopt_int.restype = c.c_int32
        l.ponyx_os_getsockopt_int.argtypes = [c.c_int32, c.c_int32,
                                              c.c_int32,
                                              c.POINTER(c.c_int32)]
        l.ponyx_os_sockname.restype = c.c_int32
        l.ponyx_os_sockname.argtypes = [c.c_int32, c.c_char_p, c.c_int32,
                                        c.POINTER(c.c_int32)]
        l.ponyx_os_peername.restype = c.c_int32
        l.ponyx_os_peername.argtypes = [c.c_int32, c.c_char_p, c.c_int32,
                                        c.POINTER(c.c_int32)]

        l.ponyx_os_process_spawn.restype = c.c_int64
        l.ponyx_os_process_spawn.argtypes = [
            c.c_char_p, c.POINTER(c.c_char_p), c.POINTER(c.c_char_p),
            c.POINTER(c.c_int32)]
        l.ponyx_os_process_check.restype = c.c_int32
        l.ponyx_os_process_check.argtypes = [c.c_int64]
        l.ponyx_os_process_kill.restype = c.c_int32
        l.ponyx_os_process_kill.argtypes = [c.c_int64, c.c_int32]
        _lib = l
        return _lib


def pool_stats() -> Tuple[int, int]:
    """(live blocks, parked blocks) from the native pool allocator."""
    l = lib()
    return int(l.ponyx_pool_allocated()), int(l.ponyx_pool_recycled())


class sockets:
    """Thin typed façade over the native socket ops (socket.cc ≙
    src/libponyrt/lang/socket.c). All fds are non-blocking; -errno return
    convention is translated to OSError except EAGAIN → None/b''."""

    EAGAIN = 11
    ESHUTDOWN = 108

    @staticmethod
    def _ck(r: int) -> int:
        if r < 0:
            raise OSError(-r, os.strerror(-r))
        return r

    @classmethod
    def listen_tcp(cls, host: str, port: int, backlog: int = 64) -> int:
        return cls._ck(lib().ponyx_os_listen_tcp(
            host.encode(), port, backlog))

    @classmethod
    def connect_tcp(cls, host: str, port: int) -> int:
        return cls._ck(lib().ponyx_os_connect_tcp(host.encode(), port))

    @classmethod
    def accept(cls, listen_fd: int) -> Optional[int]:
        r = lib().ponyx_os_accept(listen_fd)
        if r == -cls.EAGAIN:
            return None
        return cls._ck(r)

    @classmethod
    def connect_result(cls, fd: int) -> int:
        """0 = connected; else positive errno."""
        return -int(lib().ponyx_os_connect_result(fd))

    @classmethod
    def recv(cls, fd: int, max_bytes: int = 65536):
        """bytes (possibly empty=-EAGAIN → None) or b'' on orderly EOF."""
        buf = (ctypes.c_uint8 * max_bytes)()
        r = lib().ponyx_os_recv(fd, buf, max_bytes)
        if r == -cls.EAGAIN:
            return None
        if r == -cls.ESHUTDOWN:
            return b""
        cls._ck(r)
        return bytes(bytearray(buf[:r]))

    @classmethod
    def send(cls, fd: int, data: bytes) -> int:
        """Bytes accepted (may be short); 0 when the kernel buffer is
        full (wait for a write event)."""
        n = len(data)
        arr = (ctypes.c_uint8 * n).from_buffer_copy(data)
        r = lib().ponyx_os_send(fd, arr, n)
        if r == -cls.EAGAIN:
            return 0
        return cls._ck(r)

    @classmethod
    def udp(cls, host: str = "", port: int = 0) -> int:
        return cls._ck(lib().ponyx_os_udp(host.encode(), port))

    @classmethod
    def sendto(cls, fd: int, data: bytes, host: str, port: int) -> int:
        n = len(data)
        arr = (ctypes.c_uint8 * n).from_buffer_copy(data)
        r = lib().ponyx_os_sendto(fd, arr, n, host.encode(), port)
        if r == -cls.EAGAIN:
            return 0
        return cls._ck(r)

    @classmethod
    def recvfrom(cls, fd: int, max_bytes: int = 65536):
        """(data, host, port) or None when drained."""
        buf = (ctypes.c_uint8 * max_bytes)()
        addr = ctypes.create_string_buffer(64)
        port = ctypes.c_int32(0)
        r = lib().ponyx_os_recvfrom(fd, buf, max_bytes, addr, 64,
                                    ctypes.byref(port))
        if r == -cls.EAGAIN:
            return None
        cls._ck(r)
        return (bytes(bytearray(buf[:r])), addr.value.decode(),
                int(port.value))

    @classmethod
    def sockname_port(cls, fd: int) -> int:
        return cls._ck(lib().ponyx_os_sockname_port(fd))

    @classmethod
    def peername_port(cls, fd: int) -> int:
        return cls._ck(lib().ponyx_os_peername_port(fd))

    @classmethod
    def nodelay(cls, fd: int, on: bool = True) -> None:
        cls._ck(lib().ponyx_os_nodelay(fd, int(on)))

    @classmethod
    def keepalive(cls, fd: int, secs: int) -> None:
        cls._ck(lib().ponyx_os_keepalive(fd, secs))

    @classmethod
    def writev(cls, fd: int, chunks) -> int:
        """Scatter-gather send of a chunk list without flattening
        (≙ the reference's iovec writev path, lang/socket.c): one
        sendmsg carries up to 64 chunks straight out of the caller's
        buffers. Returns bytes accepted (may end mid-chunk); 0 when the
        kernel buffer is full."""
        chunks = [bytes(c) for c in chunks if c]
        if not chunks:
            return 0
        n = min(len(chunks), 64)
        c = ctypes
        # Zero-copy: bytes are immutable and kept alive by `chunks` for
        # the duration of the (read-only) sendmsg, so point straight at
        # their buffers instead of memcpy-ing every retry.
        ptrs = (c.POINTER(c.c_uint8) * n)(
            *[c.cast(c.c_char_p(ch), c.POINTER(c.c_uint8))
              for ch in chunks[:n]])
        lens = (c.c_int32 * n)(*[len(ch) for ch in chunks[:n]])
        r = lib().ponyx_os_writev(fd, ptrs, lens, n)
        if r == -cls.EAGAIN:
            return 0
        return cls._ck(r)

    @classmethod
    def multicast_join(cls, fd: int, group: str, iface: str = "") -> None:
        """Join a multicast group, IPv4 or IPv6 by the group address
        (≙ pony_os_multicast_join)."""
        cls._ck(lib().ponyx_os_multicast_join(fd, group.encode(),
                                              iface.encode()))

    @classmethod
    def multicast_leave(cls, fd: int, group: str, iface: str = "") -> None:
        cls._ck(lib().ponyx_os_multicast_leave(fd, group.encode(),
                                               iface.encode()))

    @classmethod
    def multicast_ttl(cls, fd: int, ttl: int) -> None:
        cls._ck(lib().ponyx_os_multicast_ttl(fd, ttl))

    @classmethod
    def multicast_loopback(cls, fd: int, on: bool = True) -> None:
        cls._ck(lib().ponyx_os_multicast_loopback(fd, int(on)))

    @classmethod
    def broadcast(cls, fd: int, on: bool = True) -> None:
        cls._ck(lib().ponyx_os_broadcast(fd, int(on)))

    @classmethod
    def set_option(cls, fd: int, level: int, name: int,
                   value: int) -> None:
        """Generic int socket option (≙ the reference's per-option
        pony_os_getsockopt surface collapsed to (level, name, int));
        levels/names are the OS constants (socket module)."""
        cls._ck(lib().ponyx_os_setsockopt_int(fd, level, name, value))

    @classmethod
    def get_option(cls, fd: int, level: int, name: int) -> int:
        out = ctypes.c_int32(0)
        cls._ck(lib().ponyx_os_getsockopt_int(fd, level, name,
                                              ctypes.byref(out)))
        return int(out.value)

    @classmethod
    def sockname(cls, fd: int):
        """(addr, port) of the local end — IPv4 dotted or IPv6 hex."""
        addr = ctypes.create_string_buffer(64)
        port = ctypes.c_int32(0)
        cls._ck(lib().ponyx_os_sockname(fd, addr, 64, ctypes.byref(port)))
        return addr.value.decode(), int(port.value)

    @classmethod
    def peername(cls, fd: int):
        """(addr, port) of the remote end."""
        addr = ctypes.create_string_buffer(64)
        port = ctypes.c_int32(0)
        cls._ck(lib().ponyx_os_peername(fd, addr, 64, ctypes.byref(port)))
        return addr.value.decode(), int(port.value)

    @classmethod
    def shutdown(cls, fd: int) -> None:
        lib().ponyx_os_shutdown(fd)

    @classmethod
    def close(cls, fd: int) -> None:
        lib().ponyx_os_close(fd)


class processes:
    """Native child-process ops (process.cc ≙ lang/process.c)."""

    @staticmethod
    def spawn(path: str, argv, env=None):
        """Returns (pid, stdin_w, stdout_r, stderr_r); fds non-blocking."""
        c = ctypes
        av = (c.c_char_p * (len(argv) + 1))(
            *[a.encode() if isinstance(a, str) else a for a in argv], None)
        ev = None
        if env is not None:
            pairs = [f"{k}={v}".encode() for k, v in env.items()]
            ev = (c.c_char_p * (len(pairs) + 1))(*pairs, None)
        fds = (c.c_int32 * 3)()
        pid = lib().ponyx_os_process_spawn(path.encode(), av, ev, fds)
        if pid < 0:
            raise OSError(-pid, os.strerror(-pid))
        return int(pid), int(fds[0]), int(fds[1]), int(fds[2])

    @staticmethod
    def check(pid: int):
        """None while running; exit code 0..255; 256+signum if killed."""
        r = lib().ponyx_os_process_check(pid)
        if r == -1:
            return None
        if r < -1:
            raise OSError(-r, os.strerror(-r))
        return int(r)

    @staticmethod
    def kill(pid: int, signum: int = 15) -> None:
        r = lib().ponyx_os_process_kill(pid, signum)
        if r < 0:
            raise OSError(-r, os.strerror(-r))


class HostQueue:
    """MPSC staging queue of int32-word messages (native-backed)."""

    def __init__(self):
        self._l = lib()
        self._q = self._l.ponyx_mpscq_create()

    def push(self, words) -> None:
        arr = np.ascontiguousarray(words, np.int32)
        self._l.ponyx_mpscq_push(
            self._q, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            arr.size)

    def pop(self, max_words: int = 64) -> Optional[np.ndarray]:
        out = np.empty((max_words,), np.int32)
        n = self._l.ponyx_mpscq_pop(
            self._q, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_words)
        if n == 0:
            return None
        if n < 0:
            return self.pop(-n)
        return out[:n].copy()

    def __len__(self) -> int:
        return int(self._l.ponyx_mpscq_count(self._q))

    def close(self) -> None:
        if self._q:
            self._l.ponyx_mpscq_destroy(self._q)
            self._q = None


# Event kinds in drained records (see asio.cc header comment).
TIMER, SIGNAL, FD_READ, FD_WRITE, FD_HUP = 1, 2, 3, 4, 5


class AsioEvent:
    """One drained event: (sub_id, owner, behaviour, kind, arg, flags)."""

    __slots__ = ("sub_id", "owner", "behaviour", "kind", "arg", "flags")

    def __init__(self, row):
        (self.sub_id, self.owner, self.behaviour,
         self.kind, self.arg, self.flags) = (int(x) for x in row)

    def __repr__(self):
        return (f"AsioEvent(sub={self.sub_id} owner={self.owner} "
                f"beh={self.behaviour} kind={self.kind} arg={self.arg})")


class AsioLoop:
    """The native epoll event loop (one dedicated thread).

    ≙ ponyint_asio_start / the backend dispatch thread
    (asio/asio.c:47-56, asio/epoll.c:207-230). Owned by the bridge
    package; applications use the stdlib actors (timers, net) instead.
    """

    def __init__(self):
        self._l = lib()
        self._h = self._l.ponyx_asio_create()

    def set_affinity(self, cores) -> None:
        """Set the event-loop thread's core set (≙ --ponypinasio,
        start.c:75-94 / ponyint_cpu_affinity, cpu.c:278); one core =
        a pin, the original full mask = an unpin."""
        cs = [int(x) for x in cores]
        arr = (ctypes.c_int32 * len(cs))(*cs)
        r = self._l.ponyx_asio_setaffinity(self._h, arr, len(cs))
        if r < 0:
            raise OSError(-r, os.strerror(-r))

    def pin(self, core: int) -> None:
        self.set_affinity([core])

    def timer(self, first_ns: int, interval_ns: int, owner: int,
              behaviour: int, *, oneshot: bool = False,
              noisy: bool = True) -> int:
        r = self._l.ponyx_asio_timer(self._h, first_ns, interval_ns,
                                     owner, behaviour, int(oneshot),
                                     int(noisy))
        if r < 0:
            raise OSError(-r, os.strerror(-r))
        return r

    def signal(self, signum: int, owner: int, behaviour: int,
               *, noisy: bool = False) -> int:
        r = self._l.ponyx_asio_signal(self._h, signum, owner, behaviour,
                                      int(noisy))
        if r < 0:
            raise OSError(-r, os.strerror(-r))
        return r

    def fd(self, fd: int, owner: int, behaviour: int, *,
           read: bool = True, write: bool = False, oneshot: bool = False,
           noisy: bool = True) -> int:
        interest = (1 if read else 0) | (2 if write else 0)
        r = self._l.ponyx_asio_fd(self._h, fd, interest, owner, behaviour,
                                  int(oneshot), int(noisy))
        if r < 0:
            raise OSError(-r, os.strerror(-r))
        return r

    def unsubscribe(self, sub_id: int) -> bool:
        return bool(self._l.ponyx_asio_unsubscribe(self._h, sub_id))

    def fd_interest(self, sub_id: int, *, read: bool = True,
                    write: bool = False) -> None:
        """Re-arm a live fd subscription's interest set (epoll MOD)."""
        interest = (1 if read else 0) | (2 if write else 0)
        r = self._l.ponyx_asio_fd_interest(self._h, sub_id, interest)
        if r < 0:
            raise OSError(-r, os.strerror(-r))

    def drain(self, max_events: int = 256) -> List[AsioEvent]:
        out = np.empty((max_events, 6), np.int32)
        n = self._l.ponyx_asio_drain(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_events)
        return [AsioEvent(out[i]) for i in range(n)]

    def pending(self) -> int:
        return int(self._l.ponyx_asio_pending(self._h))

    def wait(self, timeout_s: float) -> bool:
        """Block until the event queue is non-empty or the timeout
        passes (≙ a quiescing scheduler suspended until the ASIO thread
        wakes it, scheduler.c:1427-1476); True if events are pending.
        Releases the GIL for the duration (plain ctypes call)."""
        return bool(self._l.ponyx_asio_wait(
            self._h, max(0, int(timeout_s * 1e3))))

    def noisy_add(self) -> None:
        self._l.ponyx_asio_noisy_add(self._h)

    def noisy_remove(self) -> None:
        self._l.ponyx_asio_noisy_remove(self._h)

    @property
    def noisy(self) -> int:
        return int(self._l.ponyx_asio_noisy_count(self._h))

    def close(self) -> None:
        if self._h:
            self._l.ponyx_asio_destroy(self._h)
            self._h = None


def microbench(scale: float = 1.0) -> dict:
    """Native-runtime microbenchmarks, timed entirely in C++ (≙ the
    reference's Google-Benchmark suite over pool/queues,
    benchmark/libponyrt/mem/pool.cc, benchmark/README.md). Returns
    {name: ns_per_op}."""
    l = lib()
    it = max(1, int(200_000 * scale))
    return {
        "pool_alloc_free_64B_ns": l.ponyx_bench_pool(it, 64),
        "pool_alloc_free_4KB_ns": l.ponyx_bench_pool(it, 4096),
        "pool_burst32_64B_ns": l.ponyx_bench_pool_burst(
            max(1, it // 32), 64, 32),
        "mpscq_push_pop_4w_ns": l.ponyx_bench_mpscq(it, 4),
        "mpscq_mt_4prod_4w_ns": l.ponyx_bench_mpscq_mt(it, 4, 4),
    }

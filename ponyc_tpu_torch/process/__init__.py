"""Child processes as actor messages — ≙ packages/process over
lang/process.c.

The reference's ProcessMonitor actor (packages/process/process_monitor.
pony) spawns a child with piped stdio over the native layer
(lang/process.c) and turns pipe readiness into notify callbacks. Same
split here: native/src/process.cc owns posix_spawn + pipes; this layer
subscribes the pipes to the ASIO bridge and delivers to the owning
host actor:

    on_stdout(proc: I32, data: I32, n: I32)   ≙ ProcessNotify.stdout
    on_stderr(proc: I32, data: I32, n: I32)   ≙ ProcessNotify.stderr
    on_exit(proc: I32, code: I32)             ≙ ProcessNotify.dispose
        (code 0..255 = exit status; 256+signum = killed by signal)

`data` is a HostHeap handle (unbox → bytes). Exit is detected by a
waitpid(WNOHANG) sweep at poll boundaries, after both output pipes have
reported EOF — so no output is ever lost to a fast-exiting child.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from .. import native
from ..api import BehaviourDef
from ..native import processes as P
from ..native import sockets as S


class _Proc:
    __slots__ = ("pid", "owner", "on_stdout", "on_stderr", "on_exit",
                 "stdin_fd", "stdin_buf", "stdin_closing", "fds", "subs",
                 "eofs", "exit_code", "done")

    def __init__(self, pid, owner, on_stdout, on_stderr, on_exit,
                 stdin_fd, out_fd, err_fd):
        self.pid = pid
        self.owner = owner
        self.on_stdout = on_stdout
        self.on_stderr = on_stderr
        self.on_exit = on_exit
        self.stdin_fd = stdin_fd
        self.stdin_buf = bytearray()  # unwritten tail, flushed at polls
        self.stdin_closing = False  # close_stdin() called, buffer pending
        self.fds = {"out": out_fd, "err": err_fd}
        self.subs: Dict[str, int] = {}
        self.eofs = 0
        self.exit_code: Optional[int] = None
        self.done = False


class Processes:
    """One runtime's process monitor (create via rt.attach_processes())."""

    CHUNK = 65536

    def __init__(self, rt):
        self.rt = rt
        self.bridge = rt.attach_bridge()
        self._procs: Dict[int, _Proc] = {}
        self._next = 1
        rt.register_poller(self)

    def _check(self, bdef, n, what):
        if not isinstance(bdef, BehaviourDef) or bdef.global_id is None:
            raise TypeError(f"{what} must be a program-registered behaviour")
        if not bdef.actor_type.HOST:
            raise TypeError(f"{what} must live on a HOST=True actor type")
        if len(bdef.arg_specs) != n:
            raise TypeError(f"{what} must take {n} i32 args")

    def spawn(self, path: str, argv, owner: int, *,
              on_stdout: BehaviourDef, on_stderr: BehaviourDef,
              on_exit: BehaviourDef, env=None) -> int:
        """≙ ProcessMonitor.create. Returns the proc id used in events."""
        self._check(on_stdout, 3, "on_stdout")
        self._check(on_stderr, 3, "on_stderr")
        self._check(on_exit, 2, "on_exit")
        pid, stdin_w, stdout_r, stderr_r = P.spawn(path, argv, env)
        proc_id = self._next
        self._next += 1
        p = _Proc(pid, owner, on_stdout, on_stderr, on_exit,
                  stdin_w, stdout_r, stderr_r)
        for stream in ("out", "err"):
            p.subs[stream] = self.bridge.fd_callback(
                p.fds[stream],
                (lambda s: lambda ev: self._ready(proc_id, s, ev))(stream),
                read=True, noisy=True)
        self._procs[proc_id] = p
        return proc_id

    def _ready(self, proc_id: int, stream: str, ev) -> None:
        p = self._procs.get(proc_id)
        if p is None or p.done:
            return
        if ev.kind == native.FD_READ or ev.kind == native.FD_HUP:
            self._drain_stream(p, proc_id, stream)

    def _drain_stream(self, p: _Proc, proc_id: int, stream: str) -> None:
        fd = p.fds.get(stream)
        if fd is None:
            return
        bdef = p.on_stdout if stream == "out" else p.on_stderr
        while True:
            try:
                data = os.read(fd, self.CHUNK)   # pipes: read, not recv
            except BlockingIOError:
                return                     # drained, pipe still open
            except OSError:
                data = b""
            if data == b"":                # EOF
                self.bridge.unsubscribe(p.subs.pop(stream))
                S.close(fd)
                p.fds[stream] = None
                p.eofs += 1
                return
            h = self.rt.heap.box(data)
            self.rt.send(p.owner, bdef, proc_id, h, len(data))

    # -- stdin (≙ ProcessMonitor.write/done_writing) --
    def write(self, proc_id: int, data: bytes) -> None:
        """Queue bytes for the child's stdin. The whole buffer is always
        accepted: whatever the pipe can't take now is kept host-side and
        flushed at poll boundaries (as Net does for sockets), so a full
        pipe never loses or duplicates data."""
        p = self._procs[proc_id]
        if p.stdin_fd is None or p.stdin_closing:
            raise ValueError("stdin already closed")
        p.stdin_buf += data
        self._flush_stdin(p)

    def _flush_stdin(self, p: _Proc) -> None:
        written = 0
        view = memoryview(p.stdin_buf)
        try:
            while written < len(view) and p.stdin_fd is not None:
                try:
                    n = os.write(p.stdin_fd, view[written:])  # pipe: write
                except BlockingIOError:
                    return             # pipe full; retry at next poll
                except OSError:
                    # Child closed its end (EPIPE): drop the buffer and
                    # close our side so the next write() raises (≙
                    # ProcessMonitor's failed-write shutdown) instead of
                    # silently discarding.
                    written = len(view)
                    S.close(p.stdin_fd)
                    p.stdin_fd = None
                    return
                written += n
        finally:
            view.release()
            del p.stdin_buf[:written]
        if p.stdin_closing and not p.stdin_buf and p.stdin_fd is not None:
            S.close(p.stdin_fd)
            p.stdin_fd = None

    def close_stdin(self, proc_id: int) -> None:
        """≙ ProcessMonitor.done_writing: close once queued bytes flush."""
        p = self._procs[proc_id]
        if p.stdin_fd is None:
            return
        p.stdin_closing = True
        self._flush_stdin(p)

    def kill(self, proc_id: int, signum: int = 15) -> None:
        """≙ ProcessMonitor.dispose."""
        P.kill(self._procs[proc_id].pid, signum)

    # -- poller protocol: reap exits at host boundaries --
    def poll(self, rt) -> int:
        n = 0
        for proc_id, p in list(self._procs.items()):
            if p.done:
                continue
            if p.stdin_buf:
                self._flush_stdin(p)
            if p.exit_code is None:
                p.exit_code = P.check(p.pid)
            # Once the child has exited, sweep both streams: everything it
            # wrote is already buffered in the pipes, so the sweep drains
            # all of it. Then finish — without waiting for pipe EOF, which
            # a surviving grandchild holding the write end could postpone
            # indefinitely (its later output is dropped, matching the
            # reference closing fds at dispose).
            if p.exit_code is not None:
                for stream in ("out", "err"):
                    if p.fds.get(stream) is not None:
                        self._drain_stream(p, proc_id, stream)
                p.done = True
                for stream in ("out", "err"):
                    if p.fds.get(stream) is not None:
                        self.bridge.unsubscribe(p.subs.pop(stream))
                        S.close(p.fds[stream])
                        p.fds[stream] = None
                if p.stdin_fd is not None:
                    S.close(p.stdin_fd)
                    p.stdin_fd = None
                rt.send(p.owner, p.on_exit, proc_id, p.exit_code)
                del self._procs[proc_id]
                n += 1
        return n

    def close_all(self) -> None:
        for proc_id, p in list(self._procs.items()):
            for stream, sub in list(p.subs.items()):
                self.bridge.unsubscribe(sub)
                if p.fds.get(stream) is not None:
                    S.close(p.fds[stream])
            if p.stdin_fd is not None:
                S.close(p.stdin_fd)
            if p.exit_code is None:
                try:
                    P.kill(p.pid, 9)
                    P.check(p.pid)
                except OSError:
                    pass
            del self._procs[proc_id]

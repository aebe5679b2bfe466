"""Host↔runtime ASIO bridge: OS events become actor messages.

≙ the reference's ASIO wiring end to end (SURVEY.md §3.4): the epoll
backend thread turns fd/timer/signal readiness into `pony_asio_event_send`
→ a message in the owning actor's mailbox (src/libponyrt/asio/event.c,
asio/epoll.c:207-230). Here the native loop (ponyc_tpu_torch/native) stages
events on an MPSC queue and the Bridge — registered as a Runtime poller —
drains them at step boundaries into ordinary actor sends.

Subscribed behaviours use one uniform signature, mirroring Pony's
``_event_notify(event, flags, arg)`` (packages/builtin/asio_event.pony)::

    @behaviour
    def on_event(self, st, kind: I32, arg: I32, flags: I32): ...

kind: 1=timer 2=signal 3=fd-read 4=fd-write 5=fd-hup (native module
constants); arg: expiry count / signum / fd.

Liveness: while any noisy subscription exists the runtime will not
terminate on quiescence (≙ asio.c:80-91 noisy_count and the scheduler's
asio hooks at scheduler.c:448-471).
"""

from __future__ import annotations

import signal as _signal
import sys
from typing import Dict, Optional

from .. import native
from ..api import BehaviourDef


class Bridge:
    """One native event loop bound to one Runtime (register via
    ``rt.attach_bridge()``)."""

    def __init__(self, rt):
        self.rt = rt
        self.loop = native.AsioLoop()
        self._subs: Dict[int, BehaviourDef] = {}
        self._cbs: Dict[int, object] = {}   # internal callback subscribers
        self._noisy_given = 0     # noisy holds mirrored into the runtime
        try:
            if rt.opts.pin_asio >= 0:  # ≙ --ponypinasio (start.c:75-94)
                self.loop.pin(rt.opts.pin_asio)
            elif rt.opts.pin >= 0:
                # The driver thread is pinned but the I/O thread was
                # asked to stay free: new threads INHERIT the creator's
                # mask, so restore the pre-pin mask explicitly.
                mask = getattr(rt, "_pre_pin_affinity", None)
                if mask:
                    self.loop.set_affinity(sorted(mask))
        except OSError:
            self.loop.close()      # don't leak the epoll thread + fds
            raise

    # -- subscriptions (≙ pony_asio_event_create/subscribe) --
    def _check(self, owner: int, bdef: BehaviourDef) -> None:
        if not isinstance(bdef, BehaviourDef) or bdef.global_id is None:
            raise TypeError("subscribe with a program-registered behaviour")
        if len(bdef.arg_specs) != 3:
            raise TypeError(
                f"{bdef} must take (kind, arg, flags) — the uniform asio "
                "event signature")

    def timer(self, owner: int, bdef: BehaviourDef, interval_s: float,
              *, first_s: Optional[float] = None, oneshot: bool = False,
              noisy: bool = True) -> int:
        self._check(owner, bdef)
        first = interval_s if first_s is None else first_s
        sid = self.loop.timer(max(1, int(first * 1e9)),
                              max(1, int(interval_s * 1e9)),
                              int(owner), bdef.global_id,
                              oneshot=oneshot, noisy=noisy)
        self._subs[sid] = bdef
        return sid

    def signal(self, owner: int, bdef: BehaviourDef, signum: int,
               *, noisy: bool = False) -> int:
        self._check(owner, bdef)
        sid = self.loop.signal(int(signum), int(owner), bdef.global_id,
                               noisy=noisy)
        self._subs[sid] = bdef
        return sid

    def fd(self, owner: int, bdef: BehaviourDef, fd: int, *,
           read: bool = True, write: bool = False, oneshot: bool = False,
           noisy: bool = True) -> int:
        self._check(owner, bdef)
        sid = self.loop.fd(int(fd), int(owner), bdef.global_id,
                           read=read, write=write, oneshot=oneshot,
                           noisy=noisy)
        self._subs[sid] = bdef
        return sid

    def stdin(self, owner: int, bdef: BehaviourDef, *,
              noisy: bool = True) -> int:
        """Readiness events for standard input (≙ lang/stdfd.c +
        packages/builtin/std_stream.pony input wiring)."""
        return self.fd(owner, bdef, sys.stdin.fileno(), noisy=noisy)

    def sigterm_dump(self, owner: int, bdef: BehaviourDef) -> int:
        """Convenience: SIGTERM → a diagnostic behaviour (≙ the fork's
        SIGTERM live-actor dump, analysis.c:55, cycle.c:874-954)."""
        return self.signal(owner, bdef, _signal.SIGTERM)

    def timer_callback(self, fn, interval_s: float, *,
                       first_s: Optional[float] = None,
                       oneshot: bool = False, noisy: bool = True) -> int:
        """Timer whose expiries invoke a host-side callback `fn(event)` at
        poll boundaries (runtime-internal twin of timer(); the stdlib
        Timers hub uses it for count-limited timers)."""
        first = interval_s if first_s is None else first_s
        sid = self.loop.timer(max(1, int(first * 1e9)),
                              max(1, int(interval_s * 1e9)),
                              -1, -1, oneshot=oneshot, noisy=noisy)
        self._cbs[sid] = fn
        return sid

    def fd_callback(self, fd: int, fn, *, read: bool = True,
                    write: bool = False, noisy: bool = True) -> int:
        """Subscribe an fd whose events are handled by a host-side Python
        callback `fn(event)` at poll boundaries instead of an actor
        behaviour — used by runtime-internal subsystems (the net layer's
        accept/recv plumbing ≙ the reference doing the syscalls inside
        lang/socket.c before the stdlib actor sees data)."""
        sid = self.loop.fd(fd, -1, -1, read=read, write=write,
                           oneshot=False, noisy=noisy)
        self._cbs[sid] = fn
        return sid

    def unsubscribe(self, sub_id: int) -> bool:
        self._subs.pop(sub_id, None)
        self._cbs.pop(sub_id, None)
        return self.loop.unsubscribe(sub_id)

    # -- poller protocol (called by Runtime.run at host boundaries) --
    def poll(self, rt) -> int:
        n = 0
        for ev in self.loop.drain():
            cb = self._cbs.get(ev.sub_id)
            if cb is not None:
                # A raising fd/timer callback must not kill the run
                # loop's host-work phase (≙ the reference's ASIO thread
                # surviving a notify that traps): count it per
                # (class, code), leave flight-recorder evidence, and
                # keep draining — the subscription stays live, exactly
                # like a host behaviour's PonyError residue.
                try:
                    cb(ev)
                except Exception as e:            # noqa: BLE001
                    from ..errors import error_code
                    rt._error_counts[
                        (type(e).__name__, error_code(e))] += 1
                    fl = getattr(rt, "_flight", None)
                    if fl is not None:
                        fl.event("bridge_callback_error",
                                 cls=type(e).__name__,
                                 code=error_code(e), sub=ev.sub_id,
                                 message=str(e))
                n += 1
                continue
            bdef = self._subs.get(ev.sub_id)
            if bdef is None:      # unsubscribed with events still queued
                continue
            rt.send(ev.owner, bdef, ev.kind, ev.arg, ev.flags)
            n += 1
        # Mirror the loop's noisy count into the runtime's liveness hold.
        want = self.loop.noisy + (1 if self.loop.pending() else 0)
        while self._noisy_given < want:
            rt.add_noisy()
            self._noisy_given += 1
        while self._noisy_given > want:
            rt.remove_noisy()
            self._noisy_given -= 1
        return n

    def wait(self, timeout_s: float) -> bool:
        """Block until an asio event is queued or the timeout passes —
        the run loop calls this instead of backoff-sleeping when the
        only pending work is external I/O (≙ a suspended scheduler
        woken by the ASIO thread, scheduler.c:1427-1476)."""
        return self.loop.wait(timeout_s)

    def close(self) -> None:
        while self._noisy_given > 0:
            self.rt.remove_noisy()
            self._noisy_given -= 1
        self.loop.close()

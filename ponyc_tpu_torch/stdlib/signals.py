"""Signals — ≙ packages/signals (SignalHandler actor + SignalNotify +
Sig name table, over the runtime's ASIO signal events,
src/libponyrt/asio/epoll.c:54-133).

The reference's SignalHandler subscribes an ASIO signal event owned by
the handler actor; each delivery invokes the SignalNotify, and a `wait`
handler keeps the runtime alive (noisy subscription). The port
rides the native epoll loop's signalfd-style subscription (bridge +
native/src/asio.cc) and delivers the uniform `(kind, arg, flags)` asio
message to an owning actor:

    from ponyc_tpu_torch.stdlib import signals
    h = signals.SignalHandler(rt, owner_id, MyActor.on_event,
                              signals.Sig.term(), wait=True)
    h.raise_()            # ≙ SignalHandler.raise()
    h.dispose()

`wait=True` maps to a noisy subscription (≙ the reference's wait flag
keeping quiescence off until disposal).
"""

from __future__ import annotations

import os
import signal as _signal


class Sig:
    """Signal numbers by name (≙ packages/signals/sig.pony)."""

    @staticmethod
    def hup() -> int: return int(_signal.SIGHUP)

    @staticmethod
    def int_() -> int: return int(_signal.SIGINT)

    @staticmethod
    def quit() -> int: return int(_signal.SIGQUIT)

    @staticmethod
    def usr1() -> int: return int(_signal.SIGUSR1)

    @staticmethod
    def usr2() -> int: return int(_signal.SIGUSR2)

    @staticmethod
    def alrm() -> int: return int(_signal.SIGALRM)

    @staticmethod
    def term() -> int: return int(_signal.SIGTERM)

    @staticmethod
    def chld() -> int: return int(_signal.SIGCHLD)

    @staticmethod
    def cont() -> int: return int(_signal.SIGCONT)

    @staticmethod
    def winch() -> int: return int(_signal.SIGWINCH)


class SignalHandler:
    """Listen for one signal and deliver it to an owning actor as the
    uniform asio behaviour message (≙ signals/signal_handler.pony)."""

    def __init__(self, rt, owner: int, bdef, sig: int, *,
                 wait: bool = False):
        self._rt = rt
        self._sig = int(sig)
        self._bridge = rt.attach_bridge()
        self._sid = self._bridge.signal(int(owner), bdef, self._sig,
                                        noisy=wait)

    def raise_(self) -> None:
        """Raise the signal on this process (≙ SignalHandler.raise)."""
        os.kill(os.getpid(), self._sig)

    def dispose(self) -> None:
        """Unsubscribe (≙ SignalHandler.dispose); a waiting handler
        stops keeping the runtime alive."""
        if self._sid is not None:
            self._bridge.unsubscribe(self._sid)
            self._sid = None

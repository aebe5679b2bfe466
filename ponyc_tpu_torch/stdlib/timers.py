"""Timers — ≙ packages/time (Timers actor + Timer/TimerNotify).

The reference's Timers actor multiplexes Timer objects over one ASIO
timer subscription; notify objects get apply/cancel callbacks and a
Timer can limit its firing count. Here the native timerfd loop (bridge)
already multiplexes; this module provides the stdlib-shaped surface:

    timers = Timers(rt)
    t = timers.timer(owner, MyActor.tick, interval_s=0.05, count=10)
    timers.after(owner, MyActor.fire, 0.2)     # one-shot
    timers.cancel(t)

Each firing sends the behaviour `(kind=1, arg=n_expiries, flags=0)` —
the uniform asio event signature (bridge).
"""

from __future__ import annotations

from typing import Dict, Optional

from .. import native
from ..api import BehaviourDef


class Timers:
    """Timer hub (≙ time/Timers actor)."""

    def __init__(self, rt):
        self.rt = rt
        self.bridge = rt.attach_bridge()
        self._live: Dict[int, dict] = {}

    def timer(self, owner: int, bdef: BehaviourDef, interval_s: float, *,
              first_s: Optional[float] = None, count: int = 0,
              noisy: bool = True) -> int:
        """Fire `bdef(kind, arg, flags)` on `owner` every interval_s;
        count > 0 cancels after that many firings (≙ Timer._count)."""
        if not isinstance(bdef, BehaviourDef) or bdef.global_id is None:
            raise TypeError("timer needs a program-registered behaviour")
        if len(bdef.arg_specs) != 3:
            raise TypeError(
                f"{bdef} must take (kind, arg, flags) — the uniform asio "
                "event signature")
        rec = {"owner": int(owner), "bdef": bdef, "count": int(count),
               "fired": 0, "sid": None}

        def on_fire(ev, rec=rec):
            sid = rec["sid"]
            if sid not in self._live:
                return                       # cancelled, event in flight
            n = max(1, ev.arg)
            if rec["count"] > 0:
                n = min(n, rec["count"] - rec["fired"])
                rec["fired"] += n
            self.rt.send(rec["owner"], rec["bdef"], native.TIMER, n, 0)
            if rec["count"] > 0 and rec["fired"] >= rec["count"]:
                self.cancel(sid)

        sid = self.bridge.timer_callback(
            on_fire, interval_s, first_s=first_s,
            oneshot=count == 1, noisy=noisy)
        rec["sid"] = sid
        self._live[sid] = rec
        return sid

    def after(self, owner: int, bdef: BehaviourDef, delay_s: float,
              *, noisy: bool = True) -> int:
        """One-shot convenience (≙ a count-1 Timer)."""
        return self.timer(owner, bdef, delay_s, first_s=delay_s, count=1,
                          noisy=noisy)

    def cancel(self, timer_id: int) -> bool:
        """≙ Timers.cancel → TimerNotify.cancel."""
        self._live.pop(timer_id, None)
        return self.bridge.unsubscribe(timer_id)

    def dispose(self) -> None:
        for sid in list(self._live):
            self.cancel(sid)

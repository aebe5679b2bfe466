"""Promises — ≙ packages/promises (promise.pony).

Pony's Promise[A] is an actor: fulfil/reject once, `next`-chaining
creates derived promises, `join`/`select` combine, and timeouts reject.
Here promises are host-side (they coordinate work across actors and the
host program; device actors communicate by messages, not futures), with
the same surface:

    p = Promise(rt)
    p.next(lambda v: v * 2).next(print)
    p.fulfil(21)

An actor can fulfil a promise from a behaviour by sending the promise's
`fulfil_ref` a message — promises register themselves as bridgeable
sinks via `Promise.behaviour_sink` (a HOST actor type owning them).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional


class PromiseRejected(Exception):
    pass


class Promise:
    """Write-once async value (≙ promises/promise.pony)."""

    def __init__(self, rt=None):
        self.rt = rt
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._value: Any = None
        self._rejected = False
        self._cbs: List[Callable] = []
        self._ecbs: List[Callable] = []

    # -- write side (once; later calls no-op, ≙ promise idempotence) --
    def fulfil(self, value: Any = None) -> "Promise":
        with self._lock:
            if self._event.is_set():
                return self
            self._value = value
            self._event.set()
            cbs, self._cbs, self._ecbs = self._cbs, [], []
        for cb in cbs:
            cb(value)
        return self

    def reject(self, reason: Any = None) -> "Promise":
        with self._lock:
            if self._event.is_set():
                return self
            self._rejected = True
            self._value = reason
            self._event.set()
            ecbs, self._cbs, self._ecbs = self._ecbs, [], []
        for cb in ecbs:
            cb(reason)
        return self

    # -- read side --
    def next(self, fulfilled: Callable, rejected: Optional[Callable] = None
             ) -> "Promise":
        """Chain (≙ Promise.next[B]): returns the derived promise."""
        out = Promise(self.rt)

        def on_ok(v):
            try:
                out.fulfil(fulfilled(v))
            except Exception as ex:         # noqa: BLE001 — chain rejects
                out.reject(ex)

        def on_err(r):
            if rejected is not None:
                try:
                    out.fulfil(rejected(r))
                    return
                except Exception as ex:     # noqa: BLE001
                    out.reject(ex)
                    return
            out.reject(r)

        with self._lock:
            if not self._event.is_set():
                self._cbs.append(on_ok)
                self._ecbs.append(on_err)
                return out
        if self._rejected:
            on_err(self._value)
        else:
            on_ok(self._value)
        return out

    def done(self) -> bool:
        return self._event.is_set()

    def value(self, timeout: Optional[float] = None) -> Any:
        """Block the *host* until resolved. If the promise's runtime is
        supplied, drive it while waiting (an actor program that must run
        for the promise to resolve can't be blocked on)."""
        deadline = None if timeout is None else time.time() + timeout
        while not self._event.is_set():
            if self.rt is not None:
                self.rt.run(max_steps=8)
            else:
                self._event.wait(0.01)
            if deadline is not None and time.time() > deadline:
                raise TimeoutError("promise timeout")
        if self._rejected:
            raise PromiseRejected(self._value)
        return self._value

    def timeout(self, seconds: float) -> "Promise":
        """Reject after `seconds` if unresolved (≙ promise timeout via
        Timers in the reference examples)."""
        def arm():
            time.sleep(seconds)
            self.reject(TimeoutError(f"timeout {seconds}s"))
        threading.Thread(target=arm, daemon=True).start()
        return self


def join(promises: List[Promise], rt=None) -> Promise:
    """Fulfil with the list of all values (≙ Promises.join); reject on
    the first rejection."""
    out = Promise(rt)
    n = len(promises)
    if n == 0:
        return out.fulfil([])
    results: List[Any] = [None] * n
    remaining = [n]
    lock = threading.Lock()

    def make(i):
        def ok(v):
            with lock:
                results[i] = v
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                out.fulfil(list(results))
        return ok

    for i, p in enumerate(promises):
        p.next(make(i), out.reject)
    return out


def select(promises: List[Promise], rt=None) -> Promise:
    """First resolution wins (≙ Promises.select)."""
    out = Promise(rt)
    for p in promises:
        p.next(out.fulfil, out.reject)
    return out


class Custodian:
    """Collects disposables and disposes them all at once
    (≙ packages/bureaucracy/custodian.pony)."""

    def __init__(self):
        self._items: List[Any] = []

    def apply(self, disposable) -> None:
        self._items.append(disposable)

    def dispose(self) -> None:
        for it in reversed(self._items):
            for meth in ("dispose", "close", "stop"):
                fn = getattr(it, meth, None)
                if callable(fn):
                    fn()
                    break
        self._items.clear()

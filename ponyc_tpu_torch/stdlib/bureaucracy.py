"""Bureaucracy — ≙ packages/bureaucracy (Custodian + Registrar).

Custodian collects things to shut down together (custodian.pony);
Registrar is a name → value directory whose lookups return promises
(registrar.pony). Both are *bookkeeping* actors in the reference —
host-side state with asynchronous lookups — so the port keeps them
host-resident (the main-thread-actor pattern: engine.py module docs)
with stdlib.promises for the async lookup surface.

    cust = Custodian()
    cust.apply(conn)                      # anything with dispose()
    cust.apply_actor(rt, aid, T.dispose)  # device/host actor behaviour
    cust.dispose()

    reg = Registrar()
    reg.update("db", pool)
    reg.apply("db").next(lambda v: ...)   # promise, ≙ registrar lookup
    reg.remove("db", pool)
"""

from __future__ import annotations

from typing import Any, Dict, List

from .promises import Promise


class Custodian:
    """Dispose a set of things at once (≙ bureaucracy/custodian.pony:
    dispose() disposes every actor in the set, then clears it)."""

    def __init__(self):
        self._items: List[Any] = []

    def apply(self, disposable) -> "Custodian":
        """Add something with a dispose()/close()/stop() method."""
        self._items.append(("obj", disposable))
        return self

    def apply_actor(self, rt, actor_id: int, bdef, *args) -> "Custodian":
        """Add an actor: dispose() sends `bdef(*args)` to it (the
        reference's set holds `DisposableActor tag` refs and sends
        dispose() — here the behaviour is explicit)."""
        self._items.append(("actor", (rt, int(actor_id), bdef, args)))
        return self

    def dispose(self) -> None:
        for kind, it in reversed(self._items):
            if kind == "actor":
                rt, aid, bdef, args = it
                rt.send(aid, bdef, *args)
            else:
                for meth in ("dispose", "close", "stop"):
                    fn = getattr(it, meth, None)
                    if callable(fn):
                        fn()
                        break
        self._items.clear()


class Registrar:
    """Name → value directory with promise-based lookup
    (≙ bureaucracy/registrar.pony)."""

    def __init__(self, rt=None):
        self._rt = rt
        self._map: Dict[str, Any] = {}

    def update(self, key: str, value) -> None:
        """Add or change a mapping (≙ Registrar.update)."""
        self._map[key] = value

    def remove(self, key: str, value) -> None:
        """Remove only if `key` still maps to `value`
        (≙ Registrar.remove's guarded removal)."""
        if self._map.get(key) is value:
            del self._map[key]

    def apply(self, key: str) -> Promise:
        """Lookup by name: a promise fulfilled with the value, or
        rejected if absent (≙ Registrar.apply returning Promise[A])."""
        p = Promise(self._rt)
        if key in self._map:
            p.fulfil(self._map[key])
        else:
            p.reject()
        return p

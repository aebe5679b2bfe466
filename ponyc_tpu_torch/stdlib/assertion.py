"""Assert — ≙ packages/assert (Assert: debug-only, Fact: always-on).

Both raise a Pony `error` on failure after printing the message to
stderr (assert.pony); here that's errors.PonyError so `pony_try`
catches them like any behaviour error. Assert follows the same debug
configuration as stdlib.debug (`__debug__` / PONY_TPU_DEBUG).

    from ponyc_tpu_torch.stdlib.assertion import Assert, Fact
    Fact(x > 0, "x must be positive")     # always checked
    Assert(invariant(), "debug check")    # compiled away under -O
"""

from __future__ import annotations

import sys

from ..errors import PonyError
from .debug import _enabled


def Fact(test: bool, msg: str = "") -> None:
    """Always-enabled assertion (≙ assert.pony `primitive Fact`)."""
    if not test:
        if msg:
            print(msg, file=sys.stderr)
            sys.stderr.flush()
        raise PonyError(1, msg or "Fact failed")


def Assert(test: bool, msg: str = "") -> None:
    """Debug-only assertion (≙ assert.pony `primitive Assert`:
    `ifdef debug then Fact(...)`)."""
    if _enabled():
        Fact(test, msg)

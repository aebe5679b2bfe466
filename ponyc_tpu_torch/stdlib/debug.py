"""Debug — ≙ packages/debug (Debug.out/Debug.err, compiled away unless
the binary was built with `ponyc -d`).

The reference prints only in debug-configured builds (debug.pony
`ifdef debug`). The build-flag analog here is `python -O`: `Debug`
prints only when `__debug__` is true (no -O), or when forced on via
PONY_TPU_DEBUG=1 — mirroring how a Pony program's debug prints follow
the compile configuration, not a runtime log level (that's stdlib
logger's job).

    from ponyc_tpu_torch.stdlib.debug import Debug
    Debug("seen unless -O")
    Debug(["a", "b"], sep="/")
    Debug.err("to stderr")
"""

from __future__ import annotations

import os
import sys


def _enabled() -> bool:
    env = os.environ.get("PONY_TPU_DEBUG")
    if env is not None:
        return env not in ("", "0", "false")
    return __debug__


class _Debug:
    """Callable primitive (≙ debug/debug.pony `primitive Debug`)."""

    def __call__(self, msg, sep: str = ", ", stream=None) -> None:
        """Print a single value or a sequence joined by `sep`
        (≙ Debug.apply's Stringable | ReadSeq[Stringable])."""
        if not _enabled():
            return
        out = stream or sys.stdout
        if isinstance(msg, (list, tuple)):
            print(sep.join(str(m) for m in msg), file=out)
        else:
            print(msg, file=out)
        out.flush()

    def out(self, msg, sep: str = ", ") -> None:
        self(msg, sep, sys.stdout)

    def err(self, msg, sep: str = ", ") -> None:
        self(msg, sep, sys.stderr)


Debug = _Debug()

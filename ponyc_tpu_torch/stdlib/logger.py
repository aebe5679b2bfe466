"""Severity-gated logging — ≙ packages/logger.

The reference's Logger[A] evaluates its log-level guard *at the call
site* (so formatting work is skipped below threshold) and funnels
output through an OutStream actor. Same shape: a Logger with a level
gate whose `call`-style guard skips formatting, writing through a
host sink (stderr by default, or any file-like / File object).

    log = Logger(WARN)
    if log(INFO):                   # cheap guard, message not built
        log.log(f"expensive {x}")
    log.warn("something odd")       # guard + log in one
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Optional

FINE, INFO, WARN, ERROR = 0, 1, 2, 3
_NAMES = {FINE: "FINE", INFO: "INFO", WARN: "WARN", ERROR: "ERROR"}


def _default_formatter(level: int, msg: str, loc: Optional[str]) -> str:
    ts = time.strftime("%H:%M:%S")
    where = f" {loc}" if loc else ""
    return f"{ts} {_NAMES.get(level, '?')}{where}: {msg}"


class Logger:
    """≙ logger/logger.pony: level guard + formatter + out stream."""

    def __init__(self, level: int = WARN, *, out=None,
                 formatter: Callable = _default_formatter):
        self.level = level
        self.out = out if out is not None else sys.stderr
        self.formatter = formatter

    def __call__(self, level: int) -> bool:
        """The guard (≙ Logger.apply): true if `level` would emit."""
        return level >= self.level

    def log(self, msg: Any, level: int = INFO,
            loc: Optional[str] = None) -> bool:
        if not self(level):
            return False
        line = self.formatter(level, str(msg), loc)
        w = getattr(self.out, "print", None)
        if callable(w):                       # files.File sink
            w(line)
        else:
            print(line, file=self.out)
        return True

    def fine(self, msg: Any) -> bool:
        return self.log(msg, FINE)

    def info(self, msg: Any) -> bool:
        return self.log(msg, INFO)

    def warn(self, msg: Any) -> bool:
        return self.log(msg, WARN)

    def error(self, msg: Any) -> bool:
        return self.log(msg, ERROR)

"""Math package — ≙ the reference's `packages/math/` (fibonacci.pony:
an Iterator producing the Fibonacci sequence)."""

from __future__ import annotations

__all__ = ["Fibonacci"]


class Fibonacci:
    """Fibonacci iterator (≙ fibonacci.pony). Either iterate, or call
    Fibonacci.apply(n) for the n-th number."""

    def __init__(self):
        self._a, self._b = 0, 1

    def has_next(self) -> bool:
        return True

    def next(self) -> int:
        out = self._a
        self._a, self._b = self._b, self._a + self._b
        return out

    def __iter__(self):
        while True:
            yield self.next()

    @staticmethod
    def apply(n: int) -> int:
        a, b = 0, 1
        for _ in range(n):
            a, b = b, a + b
        return a

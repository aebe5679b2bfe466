"""Iterator combinators — ≙ the reference's `packages/itertools/`
(iter.pony's Iter class): a fluent, lazy pipeline over any iterator.

    Iter(range(10)).filter(lambda x: x % 2 == 0).map(str).collect()

Python generators make each combinator a few lines, but the *surface* is
the reference's: chain, repeat_value, all/any, collect, count, cycle,
dedup, enum, filter, filter_map, find, flat_map, fold, interleave, last,
map, nth, run, skip, skip_while, step_by, take, take_while, unique, zip.
"""

from __future__ import annotations

import itertools as _it
from typing import Any, Callable, Iterable, Iterator, Optional

__all__ = ["Iter"]


class Iter:
    """≙ iter.pony Iter[A]."""

    _NONE = object()        # sentinel: no peeked value buffered

    def __init__(self, it: Iterable):
        self._it = iter(it)
        self._peeked = Iter._NONE

    # -- constructors --
    @staticmethod
    def chain(iters: Iterable[Iterable]) -> "Iter":
        return Iter(_it.chain.from_iterable(iters))

    @staticmethod
    def repeat_value(value) -> "Iter":
        return Iter(_it.repeat(value))

    # -- protocol --
    def __iter__(self) -> Iterator:
        while True:
            try:
                yield self.next()
            except StopIteration:
                return

    def has_next(self) -> bool:
        if self._peeked is not Iter._NONE:
            return True
        try:
            self._peeked = next(self._it)
        except StopIteration:
            return False
        return True

    def next(self):
        if self._peeked is not Iter._NONE:
            v = self._peeked
            self._peeked = Iter._NONE
            return v
        return next(self._it)

    __next__ = next         # Iter is itself a Python iterator

    # -- terminal ops --
    def all(self, f: Callable[[Any], bool]) -> bool:
        return all(f(x) for x in self)

    def any(self, f: Callable[[Any], bool]) -> bool:
        return any(f(x) for x in self)

    def collect(self, coll: Optional[list] = None) -> list:
        coll = coll if coll is not None else []
        coll.extend(self)
        return coll

    def count(self) -> int:
        return sum(1 for _ in self)

    def find(self, f: Callable[[Any], bool], n: int = 1):
        """The n-th element satisfying f; raises IndexError (≙ error)."""
        seen = 0
        for x in self:
            if f(x):
                seen += 1
                if seen == n:
                    return x
        raise IndexError("find: no match")

    def fold(self, acc, f: Callable[[Any, Any], Any]):
        for x in self:
            acc = f(acc, x)
        return acc

    def last(self):
        out = _SENTINEL = object()
        for out in self:
            pass
        if out is _SENTINEL:
            raise IndexError("last of empty Iter")
        return out

    def nth(self, n: int):
        """1-based n-th element (≙ iter.pony nth); IndexError past end."""
        for i, x in enumerate(self, 1):
            if i == n:
                return x
        raise IndexError(n)

    def run(self, on_error: Optional[Callable[[], None]] = None) -> None:
        """Drain the iterator for its effects (≙ iter.pony run)."""
        try:
            for _ in self:
                pass
        except Exception:
            if on_error is not None:
                on_error()
            else:
                raise

    # -- combinators (all lazy) --
    def _wrap(self, gen) -> "Iter":
        return Iter(gen)

    def cycle(self) -> "Iter":
        return self._wrap(_it.cycle(self))

    def dedup(self) -> "Iter":
        """Drop *all* duplicates, keeping first occurrence
        (≙ iter.pony dedup — hash-set based, unlike unique)."""
        def gen():
            seen = set()
            for x in self:
                if x not in seen:
                    seen.add(x)
                    yield x
        return self._wrap(gen())

    def enum(self) -> "Iter":
        return self._wrap(((i, x) for i, x in enumerate(self)))

    def filter(self, f) -> "Iter":
        return self._wrap((x for x in self if f(x)))

    def filter_map(self, f) -> "Iter":
        return self._wrap((y for x in self
                           if (y := f(x)) is not None))

    def flat_map(self, f) -> "Iter":
        return self._wrap((y for x in self for y in f(x)))

    def interleave(self, other: Iterable) -> "Iter":
        def gen():
            a, b = self, iter(other)
            while True:
                stop = 0
                for src in (a, b):
                    try:
                        yield next(src)
                    except StopIteration:
                        stop += 1
                if stop == 2:
                    return
        return self._wrap(gen())

    def map(self, f) -> "Iter":
        return self._wrap((f(x) for x in self))

    def skip(self, n: int) -> "Iter":
        return self._wrap(_it.islice(self, n, None))

    def skip_while(self, f) -> "Iter":
        return self._wrap(_it.dropwhile(f, self))

    def step_by(self, n: int) -> "Iter":
        return self._wrap(_it.islice(self, 0, None, max(1, n)))

    def take(self, n: int) -> "Iter":
        return self._wrap(_it.islice(self, n))

    def take_while(self, f) -> "Iter":
        return self._wrap(_it.takewhile(f, self))

    def unique(self) -> "Iter":
        """Drop *consecutive* duplicates (≙ iter.pony unique)."""
        def gen():
            prev = object()
            for x in self:
                if x != prev:
                    yield x
                prev = x
        return self._wrap(gen())

    def zip(self, *others: Iterable) -> "Iter":
        return self._wrap(zip(self, *map(iter, others)))

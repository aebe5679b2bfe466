"""Mutable collections — ≙ the reference's `packages/collections/`
(flag.pony, range.pony, heap.pony, ring_buffer.pony, sort.pony,
reverse.pony, list.pony/list_node.pony, map.pony/set.pony).

Python's dict/list/set already cover Map/List/Set for host-side code, so
this module implements the pieces Python *lacks* with the reference's
semantics: typed bit-flag sets, Pony-style numeric ranges (including the
infinite-range rule), binary heaps with both polarities, a fixed-size
ring buffer whose indices keep counting up (exactly the mailbox
discipline the device runtime uses), in-place quicksort, and a reversing
iterator. Persistent (immutable) variants live in stdlib.persistent.
"""

from __future__ import annotations

import math as _math
from typing import Generic, Iterable, Iterator, List as _List, \
    Optional, Sequence, TypeVar

__all__ = ["Flags", "Range", "MinHeap", "MaxHeap", "BinaryHeap",
           "RingBuffer", "Sort", "Reverse", "ListNode", "List"]

T = TypeVar("T")


class Flags:
    """Typed bit-flag set (≙ flag.pony Flags[A, B]): values are single
    bits; set/unset/union/intersect keep a packed integer `value`."""

    def __init__(self, value: int = 0):
        self._value = int(value)

    def value(self) -> int:
        return self._value

    def __call__(self, flag: int) -> bool:
        return (self._value & flag) == flag

    def all_(self) -> "Flags":
        self._value = ~0
        return self

    def clear(self) -> "Flags":
        self._value = 0
        return self

    def set(self, flag: int) -> "Flags":
        self._value |= flag
        return self

    def unset(self, flag: int) -> "Flags":
        self._value &= ~flag
        return self

    def flip(self, flag: int) -> "Flags":
        self._value ^= flag
        return self

    def union(self, other: "Flags") -> "Flags":
        return Flags(self._value | other._value)

    __or__ = union

    def intersect(self, other: "Flags") -> "Flags":
        return Flags(self._value & other._value)

    __and__ = intersect

    def difference(self, other: "Flags") -> "Flags":
        return Flags(self._value ^ other._value)

    __xor__ = difference

    def remove(self, other: "Flags") -> "Flags":
        return Flags(self._value & ~other._value)

    def __eq__(self, other):
        return isinstance(other, Flags) and self._value == other._value

    def __lt__(self, other):      # proper subset (≙ flag.pony lt)
        return (self._value != other._value
                and (self._value & other._value) == self._value)

    def __le__(self, other):
        return (self._value & other._value) == self._value


class Range:
    """`[min, max)` with step `inc` (≙ range.pony, including its edge
    rule: a step of 0, a step moving away from max, or any non-finite
    float parameter makes the range INFINITE, not empty)."""

    def __init__(self, min_: float, max_: float, inc: float = 1):
        self._min = min_
        self._max = max_
        self._inc = inc
        self._idx = 0
        forward = (min_ < max_) and (inc > 0)
        backward = (min_ > max_) and (inc < 0)
        infinite = False
        for v in (min_, max_, inc):
            if isinstance(v, float) and not _math.isfinite(v):
                infinite = True
        if inc == 0 or (min_ != max_ and not (forward or backward)):
            infinite = True
        self._infinite = infinite
        self._empty = (min_ == max_) and not infinite

    def is_infinite(self) -> bool:
        return self._infinite

    def has_next(self) -> bool:
        if self._infinite:
            return True
        if self._empty:
            return False
        cur = self._min + self._idx * self._inc
        return cur < self._max if self._inc > 0 else cur > self._max

    def next(self):
        cur = self._min + self._idx * self._inc
        self._idx += 1
        return cur

    def __iter__(self) -> Iterator:
        while self.has_next():
            yield self.next()

    def rewind(self) -> None:
        self._idx = 0


class BinaryHeap(Generic[T]):
    """Array-backed binary heap (≙ heap.pony BinaryHeap with
    MinHeapPriority / MaxHeapPriority primitives)."""

    def __init__(self, greater: bool = False):
        self._data: _List[T] = []
        self._greater = greater

    def _before(self, a, b) -> bool:
        return a > b if self._greater else a < b

    def size(self) -> int:
        return len(self._data)

    __len__ = size

    def peek(self) -> T:
        if not self._data:
            raise IndexError("peek on empty heap")
        return self._data[0]

    def push(self, value: T) -> None:
        d = self._data
        d.append(value)
        i = len(d) - 1
        while i > 0:
            parent = (i - 1) >> 1
            if self._before(d[i], d[parent]):
                d[i], d[parent] = d[parent], d[i]
                i = parent
            else:
                break

    def append(self, values: Iterable[T]) -> None:
        for v in values:
            self.push(v)

    def pop(self) -> T:
        d = self._data
        if not d:
            raise IndexError("pop on empty heap")
        top = d[0]
        last = d.pop()
        if d:
            d[0] = last
            i = 0
            n = len(d)
            while True:
                lo = i
                for c in (2 * i + 1, 2 * i + 2):
                    if c < n and self._before(d[c], d[lo]):
                        lo = c
                if lo == i:
                    break
                d[i], d[lo] = d[lo], d[i]
                i = lo
        return top

    def clear(self) -> None:
        self._data = []

    def values(self) -> _List[T]:
        return list(self._data)


def MinHeap() -> BinaryHeap:
    return BinaryHeap(greater=False)


def MaxHeap() -> BinaryHeap:
    return BinaryHeap(greater=True)


class RingBuffer(Generic[T]):
    """Fixed-size ring whose indices keep counting up, so `apply(i)`
    fails for values that have fallen off (≙ ring_buffer.pony — and the
    same monotonic head/tail discipline as the device mailbox table,
    runtime/state.py)."""

    def __init__(self, length: int):
        self._cap = max(1, length)
        self._data: _List[Optional[T]] = [None] * self._cap
        self._tail = 0                 # next index to write (total pushed)

    def head(self) -> int:
        if self._tail == 0:
            raise IndexError("empty ring")
        return max(0, self._tail - self._cap)

    def size(self) -> int:
        return min(self._tail, self._cap)

    def space(self) -> int:
        return self._cap

    def __call__(self, i: int) -> T:
        if i >= self._tail or i < max(0, self._tail - self._cap):
            raise IndexError(i)
        return self._data[i % self._cap]

    apply = __call__

    def push(self, value: T) -> bool:
        """True if an old value was overwritten (≙ push returns Bool)."""
        overwrote = self._tail >= self._cap
        self._data[self._tail % self._cap] = value
        self._tail += 1
        return overwrote

    def clear(self) -> None:
        self._data = [None] * self._cap
        self._tail = 0


class Sort:
    """In-place quicksort (≙ sort.pony Sort / SortBy primitives)."""

    @staticmethod
    def apply(array: _List, lo: int = 0, hi: Optional[int] = None) -> _List:
        if hi is None:
            hi = len(array) - 1
        if lo < hi:
            p = Sort._partition(array, lo, hi, lambda x: x)
            Sort.apply(array, lo, p)
            Sort.apply(array, p + 1, hi)
        return array

    @staticmethod
    def by(array: _List, key, lo: int = 0,
           hi: Optional[int] = None) -> _List:
        if hi is None:
            hi = len(array) - 1
        if lo < hi:
            p = Sort._partition(array, lo, hi, key)
            Sort.by(array, key, lo, p)
            Sort.by(array, key, p + 1, hi)
        return array

    @staticmethod
    def _partition(a: _List, lo: int, hi: int, key) -> int:
        pivot = key(a[(lo + hi) // 2])
        i, j = lo - 1, hi + 1
        while True:
            i += 1
            while key(a[i]) < pivot:
                i += 1
            j -= 1
            while key(a[j]) > pivot:
                j -= 1
            if i >= j:
                return j
            a[i], a[j] = a[j], a[i]


class Reverse:
    """Reversed Range-style counter (≙ reverse.pony: Reverse(10, 2, 2)
    yields 10, 8, 6, 4, 2)."""

    def __init__(self, max_: float, min_: float, dec: float = 1):
        self._max = max_
        self._min = min_
        self._dec = abs(dec)
        self._idx = 0

    def has_next(self) -> bool:
        if self._dec == 0:
            return True          # mirror Range's infinite rule
        return self._max - self._idx * self._dec >= self._min

    def next(self):
        cur = self._max - self._idx * self._dec
        self._idx += 1
        return cur

    def __iter__(self):
        while self.has_next():
            yield self.next()


class ListNode(Generic[T]):
    """Doubly-linked-list node (≙ list_node.pony): nodes are first-class
    and can be unlinked/relinked without touching values."""

    def __init__(self, value: T = None):
        self.value = value
        self._list: Optional["List"] = None
        self._prev: Optional["ListNode"] = None
        self._next: Optional["ListNode"] = None

    def prev(self) -> Optional["ListNode[T]"]:
        return self._prev

    def next(self) -> Optional["ListNode[T]"]:
        return self._next

    def remove(self) -> None:
        lst = self._list
        if lst is None:
            return
        if self._prev is not None:
            self._prev._next = self._next
        else:
            lst._head = self._next
        if self._next is not None:
            self._next._prev = self._prev
        else:
            lst._tail = self._prev
        lst._size -= 1
        self._list = self._prev = self._next = None


class List(Generic[T]):
    """Doubly-linked list over ListNode (≙ list.pony)."""

    def __init__(self, items: Sequence[T] = ()):
        self._head: Optional[ListNode] = None
        self._tail: Optional[ListNode] = None
        self._size = 0
        for x in items:
            self.push(x)

    def size(self) -> int:
        return self._size

    __len__ = size

    def head(self) -> ListNode[T]:
        if self._head is None:
            raise IndexError("empty list")
        return self._head

    def tail(self) -> ListNode[T]:
        if self._tail is None:
            raise IndexError("empty list")
        return self._tail

    def push(self, value: T) -> ListNode[T]:        # append
        node = ListNode(value)
        node._list = self
        node._prev = self._tail
        if self._tail is not None:
            self._tail._next = node
        else:
            self._head = node
        self._tail = node
        self._size += 1
        return node

    def unshift(self, value: T) -> ListNode[T]:     # prepend
        node = ListNode(value)
        node._list = self
        node._next = self._head
        if self._head is not None:
            self._head._prev = node
        else:
            self._tail = node
        self._head = node
        self._size += 1
        return node

    def pop(self) -> T:
        node = self.tail()
        node.remove()
        return node.value

    def shift(self) -> T:
        node = self.head()
        node.remove()
        return node.value

    def __iter__(self) -> Iterator[T]:
        node = self._head
        while node is not None:
            yield node.value
            node = node._next

    def nodes(self) -> Iterator[ListNode[T]]:
        node = self._head
        while node is not None:
            nxt = node._next
            yield node
            node = nxt

    def __contains__(self, value: T) -> bool:
        return any(v == value for v in self)

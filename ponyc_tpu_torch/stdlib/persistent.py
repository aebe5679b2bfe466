"""Persistent (immutable, structurally-shared) collections.

≙ the reference's `packages/collections/persistent/`:
  Map  — 32-way hash-array-mapped trie (persistent/map.pony,
         persistent/_map_node.pony: Entries/bitmap nodes, 5-bit hash
         chunks, collision buckets at max depth)
  Vec  — 32-way radix-balanced trie with tail optimisation
         (persistent/vec.pony, persistent/_vec_node.pony)
  List — cons list (persistent/list.pony)
  Set  — membership Map (persistent/set.pony)

These are genuine structural-sharing implementations, not dict copies:
update cost is O(log32 n) nodes, and old versions stay valid — which is
exactly what host-side behaviours want when they return a new state from
an old one without copying the world.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

_BITS = 5
_WIDTH = 1 << _BITS          # 32-way nodes, as the reference (_bits.pony)
_MASK = _WIDTH - 1
_MAX_LEVEL = 12              # 64-bit hash / 5 bits, capped like map.pony


def _popcount(x: int) -> int:
    return bin(x).count("1")


class _MapNode:
    """Bitmap-compressed HAMT node (≙ _MapNode in _map_node.pony).

    `bitmap` marks which of the 32 slots are present; `slots` holds, per
    present slot, either a (key, value) leaf, a nested _MapNode, or a
    list of (key, value) pairs (collision bucket at max depth)."""

    __slots__ = ("bitmap", "slots")

    def __init__(self, bitmap: int = 0, slots: Tuple = ()):
        self.bitmap = bitmap
        self.slots = slots

    def _pos(self, bit: int) -> int:
        return _popcount(self.bitmap & (bit - 1))

    def get(self, h: int, level: int, key):
        bit = 1 << ((h >> (level * _BITS)) & _MASK)
        if not (self.bitmap & bit):
            raise KeyError(key)
        slot = self.slots[self._pos(bit)]
        if isinstance(slot, _MapNode):
            return slot.get(h, level + 1, key)
        if isinstance(slot, list):
            for k, v in slot:
                if k == key:
                    return v
            raise KeyError(key)
        k, v = slot
        if k == key:
            return v
        raise KeyError(key)

    def update(self, h: int, level: int, key, value) -> Tuple["_MapNode", int]:
        """Return (new node, size delta)."""
        idx = (h >> (level * _BITS)) & _MASK
        bit = 1 << idx
        pos = self._pos(bit)
        if not (self.bitmap & bit):
            slots = self.slots[:pos] + ((key, value),) + self.slots[pos:]
            return _MapNode(self.bitmap | bit, slots), 1
        slot = self.slots[pos]
        if isinstance(slot, _MapNode):
            child, d = slot.update(h, level + 1, key, value)
            return self._with(pos, child), d
        if isinstance(slot, list):
            for i, (k, _v) in enumerate(slot):
                if k == key:
                    bucket = slot[:i] + [(key, value)] + slot[i + 1:]
                    return self._with(pos, bucket), 0
            return self._with(pos, slot + [(key, value)]), 1
        k0, v0 = slot
        if k0 == key:
            return self._with(pos, (key, value)), 0
        # Leaf conflict: push both one level down (≙ _map_node.pony's
        # sub-node creation), or open a collision bucket at max depth.
        if level + 1 >= _MAX_LEVEL:
            return self._with(pos, [(k0, v0), (key, value)]), 1
        sub = _MapNode()
        h0 = _hash(k0)
        sub, _ = sub.update(h0, level + 1, k0, v0)
        sub, _ = sub.update(h, level + 1, key, value)
        return self._with(pos, sub), 1

    def remove(self, h: int, level: int, key) -> Optional["_MapNode"]:
        """Return the new node, or None if key absent (caller keeps self)."""
        bit = 1 << ((h >> (level * _BITS)) & _MASK)
        if not (self.bitmap & bit):
            return None
        pos = self._pos(bit)
        slot = self.slots[pos]
        if isinstance(slot, _MapNode):
            child = slot.remove(h, level + 1, key)
            if child is None:
                return None
            if child.bitmap == 0:
                return self._drop(pos, bit)
            return self._with(pos, child)
        if isinstance(slot, list):
            for i, (k, _v) in enumerate(slot):
                if k == key:
                    bucket = slot[:i] + slot[i + 1:]
                    if len(bucket) == 1:
                        return self._with(pos, bucket[0])
                    return self._with(pos, bucket)
            return None
        if slot[0] == key:
            return self._drop(pos, bit)
        return None

    def _with(self, pos: int, slot) -> "_MapNode":
        slots = self.slots[:pos] + (slot,) + self.slots[pos + 1:]
        return _MapNode(self.bitmap, slots)

    def _drop(self, pos: int, bit: int) -> "_MapNode":
        slots = self.slots[:pos] + self.slots[pos + 1:]
        return _MapNode(self.bitmap & ~bit, slots)

    def iter_items(self) -> Iterator[Tuple[Any, Any]]:
        for slot in self.slots:
            if isinstance(slot, _MapNode):
                yield from slot.iter_items()
            elif isinstance(slot, list):
                yield from slot
            else:
                yield slot


def _hash(key) -> int:
    return hash(key) & 0xFFFFFFFFFFFFFFFF


class Map:
    """Persistent hash map (≙ persistent/map.pony).

    map(k) → value (raises KeyError ≙ Pony `error`); update/remove return
    NEW maps; the old one is untouched."""

    __slots__ = ("_root", "_size")

    def __init__(self, _root: Optional[_MapNode] = None, _size: int = 0):
        self._root = _root or _MapNode()
        self._size = _size

    @classmethod
    def of(cls, pairs) -> "Map":
        m = cls()
        for k, v in (pairs.items() if isinstance(pairs, dict) else pairs):
            m = m.update(k, v)
        return m

    def __call__(self, key):
        return self._root.get(_hash(key), 0, key)

    __getitem__ = __call__

    def get_or_else(self, key, default=None):
        try:
            return self(key)
        except KeyError:
            return default

    def contains(self, key) -> bool:
        try:
            self(key)
            return True
        except KeyError:
            return False

    __contains__ = contains

    def update(self, key, value) -> "Map":
        root, d = self._root.update(_hash(key), 0, key, value)
        return Map(root, self._size + d)

    def remove(self, key) -> "Map":
        """≙ map.pony remove: error (KeyError) when absent."""
        root = self._root.remove(_hash(key), 0, key)
        if root is None:
            raise KeyError(key)
        return Map(root, self._size - 1)

    def size(self) -> int:
        return self._size

    __len__ = size

    def keys(self):
        for k, _v in self._root.iter_items():
            yield k

    def values(self):
        for _k, v in self._root.iter_items():
            yield v

    def pairs(self):
        yield from self._root.iter_items()

    items = pairs
    __iter__ = keys

    def concat(self, pairs) -> "Map":
        m = self
        for k, v in pairs:
            m = m.update(k, v)
        return m


class Set:
    """Persistent set over Map (≙ persistent/set.pony)."""

    __slots__ = ("_map",)

    def __init__(self, _map: Optional[Map] = None):
        self._map = _map or Map()

    @classmethod
    def of(cls, items) -> "Set":
        s = cls()
        for x in items:
            s = s.add(x)
        return s

    def add(self, value) -> "Set":
        return Set(self._map.update(value, True))

    def remove(self, value) -> "Set":
        return Set(self._map.remove(value))

    def contains(self, value) -> bool:
        return self._map.contains(value)

    __contains__ = contains

    def size(self) -> int:
        return self._map.size()

    __len__ = size

    def __iter__(self):
        return self._map.keys()

    def union(self, other: "Set") -> "Set":
        s = self
        for x in other:
            s = s.add(x)
        return s

    def intersect(self, other: "Set") -> "Set":
        s = Set()
        for x in self:
            if x in other:
                s = s.add(x)
        return s

    def difference(self, other: "Set") -> "Set":
        s = self
        for x in other:
            if x in s:
                s = s.remove(x)
        return s


class _VecNode:
    """Radix-trie node for Vec (≙ _vec_node.pony)."""

    __slots__ = ("children",)

    def __init__(self, children: Tuple = ()):
        self.children = children


class Vec:
    """Persistent vector: 32-way radix trie + tail (≙ persistent/vec.pony).

    push/pop/update return new vectors in O(log32 n); apply/`vec[i]` is
    O(log32 n) with the hot suffix served from the tail block."""

    __slots__ = ("_root", "_tail", "_size", "_depth")

    def __init__(self, _root=None, _tail: Tuple = (), _size: int = 0,
                 _depth: int = 0):
        self._root = _root or _VecNode()
        self._tail = _tail
        self._size = _size
        self._depth = _depth

    @classmethod
    def of(cls, items) -> "Vec":
        v = cls()
        for x in items:
            v = v.push(x)
        return v

    def size(self) -> int:
        return self._size

    __len__ = size

    def _tail_offset(self) -> int:
        return (self._size - len(self._tail))

    def __call__(self, i: int):
        if not (0 <= i < self._size):
            raise IndexError(i)
        if i >= self._tail_offset():
            return self._tail[i - self._tail_offset()]
        node = self._root
        for level in range(self._depth, 0, -1):
            node = node.children[(i >> (level * _BITS)) & _MASK]
        return node.children[i & _MASK]

    __getitem__ = __call__

    def update(self, i: int, value) -> "Vec":
        if not (0 <= i < self._size):
            raise IndexError(i)
        if i >= self._tail_offset():
            j = i - self._tail_offset()
            tail = self._tail[:j] + (value,) + self._tail[j + 1:]
            return Vec(self._root, tail, self._size, self._depth)

        def go(node: _VecNode, level: int) -> _VecNode:
            idx = (i >> (level * _BITS)) & _MASK
            if level == 0:
                ch = node.children[:idx] + (value,) + node.children[idx + 1:]
                return _VecNode(ch)
            sub = go(node.children[idx], level - 1)
            ch = node.children[:idx] + (sub,) + node.children[idx + 1:]
            return _VecNode(ch)

        return Vec(go(self._root, self._depth), self._tail, self._size,
                   self._depth)

    def push(self, value) -> "Vec":
        if len(self._tail) < _WIDTH:
            return Vec(self._root, self._tail + (value,), self._size + 1,
                       self._depth)
        # Tail full: sink it into the trie, start a fresh tail.
        root, depth = self._push_tail()
        return Vec(root, (value,), self._size + 1, depth)

    def _push_tail(self):
        leaf = _VecNode(self._tail)
        tail_idx = self._size - _WIDTH      # first index of the sunk tail
        if self._size == _WIDTH:            # trie empty so far
            return leaf, 0
        if tail_idx == _WIDTH << (self._depth * _BITS):
            # Root overflow: new root one level up.
            root = _VecNode((self._root,) + (self._new_path(
                self._depth, leaf),))
            return root, self._depth + 1

        def go(node: _VecNode, level: int) -> _VecNode:
            idx = (tail_idx >> (level * _BITS)) & _MASK
            if level == 1:
                ch = node.children[:idx] + (leaf,) + node.children[idx + 1:]
                return _VecNode(ch)
            if idx < len(node.children):
                sub = go(node.children[idx], level - 1)
                ch = (node.children[:idx] + (sub,)
                      + node.children[idx + 1:])
            else:
                sub = self._new_path(level - 1, leaf)
                ch = node.children + (sub,)
            return _VecNode(ch)

        return go(self._root, self._depth), self._depth

    @staticmethod
    def _new_path(levels: int, leaf: _VecNode) -> _VecNode:
        node = leaf
        for _ in range(levels):
            node = _VecNode((node,))
        return node

    def pop(self) -> Tuple["Vec", Any]:
        """≙ vec.pony pop: error (IndexError) on empty."""
        if self._size == 0:
            raise IndexError("pop from empty Vec")
        last = self(self._size - 1)
        if len(self._tail) > 1 or self._size == 1:
            return (Vec(self._root, self._tail[:-1], self._size - 1,
                        self._depth), last)
        # Tail exhausts: lift the last leaf back out as the tail.
        new_size = self._size - 1
        start = new_size - _WIDTH
        node = self._root
        for level in range(self._depth, 0, -1):
            node = node.children[(start >> (level * _BITS)) & _MASK]
        new_tail = node.children

        def strip(node: _VecNode, level: int) -> Optional[_VecNode]:
            idx = (start >> (level * _BITS)) & _MASK
            if level == 1:
                ch = node.children[:idx]
            else:
                sub = strip(node.children[idx], level - 1)
                ch = node.children[:idx] + ((sub,) if sub else ())
            return _VecNode(ch) if ch else None

        root = (strip(self._root, self._depth)
                if self._depth else None) or _VecNode()
        depth = self._depth
        if depth and len(root.children) == 1 \
                and isinstance(root.children[0], _VecNode):
            root = root.children[0]
            depth -= 1
        return Vec(root, new_tail, new_size, depth), last

    def __iter__(self):
        for i in range(self._size):
            yield self(i)

    def concat(self, items) -> "Vec":
        v = self
        for x in items:
            v = v.push(x)
        return v


class List:
    """Persistent cons list (≙ persistent/list.pony): prepend is O(1),
    old lists remain valid."""

    __slots__ = ("_head", "_tail", "_size")

    def __init__(self, _head=None, _tail: Optional["List"] = None,
                 _size: int = 0):
        self._head = _head
        self._tail = _tail
        self._size = _size

    @classmethod
    def of(cls, items) -> "List":
        lst = cls()
        for x in reversed(list(items)):
            lst = lst.prepend(x)
        return lst

    def is_empty(self) -> bool:
        return self._size == 0

    def size(self) -> int:
        return self._size

    __len__ = size

    def head(self):
        if self._size == 0:
            raise IndexError("head of empty List")
        return self._head

    def tail(self) -> "List":
        if self._size == 0:
            raise IndexError("tail of empty List")
        return self._tail

    def prepend(self, value) -> "List":
        return List(value, self, self._size + 1)

    def __iter__(self):
        node = self
        while node._size:
            yield node._head
            node = node._tail

    def reverse(self) -> "List":
        return List.of(reversed(list(self)))

    def map(self, fn) -> "List":
        return List.of(fn(x) for x in self)

    def filter(self, fn) -> "List":
        return List.of(x for x in self if fn(x))

    def fold(self, fn, acc):
        for x in self:
            acc = fn(acc, x)
        return acc

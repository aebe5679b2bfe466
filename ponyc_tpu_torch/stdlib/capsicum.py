"""Capsicum — ≙ packages/capsicum (Cap + CapRights0).

The reference models FreeBSD capsicum rights as a bit set built from a
FileCaps set and applied to a file descriptor (cap_rights.pony:
create/from/set/unset/merge/remove/contains/limit). Linux hosts
have no capsicum syscall, so `limit()` degrades to a no-op success the
same way the reference's does on non-FreeBSD (`ifdef "capsicum"` —
cap_rights.pony:70-78 compiles to `true` elsewhere). The rights
algebra — the part programs actually branch on — is fully implemented.

    from ponyc_tpu_torch.stdlib.capsicum import Cap, CapRights
    r = CapRights.from_caps({"read", "seek"})
    r.set(Cap.write())
    r.contains(other)
    r.limit(fd)          # no-op True on Linux, as on non-FreeBSD Pony
"""

from __future__ import annotations


class Cap:
    """Individual capsicum right bits (≙ capsicum/cap.pony primitives;
    values are symbolic — the algebra, not the FreeBSD ABI)."""
    _next = [0]
    _names = {}

    @classmethod
    def _bit(cls, name: str) -> int:
        if name not in cls._names:
            cls._names[name] = 1 << cls._next[0]
            cls._next[0] += 1
        return cls._names[name]

    @classmethod
    def read(cls): return cls._bit("read")
    @classmethod
    def write(cls): return cls._bit("write")
    @classmethod
    def seek(cls): return cls._bit("seek")
    @classmethod
    def mmap(cls): return cls._bit("mmap")
    @classmethod
    def creat(cls): return cls._bit("creat")
    @classmethod
    def event(cls): return cls._bit("event")
    @classmethod
    def fchmod(cls): return cls._bit("fchmod")
    @classmethod
    def fchown(cls): return cls._bit("fchown")
    @classmethod
    def fstat(cls): return cls._bit("fstat")
    @classmethod
    def fsync(cls): return cls._bit("fsync")
    @classmethod
    def ftruncate(cls): return cls._bit("ftruncate")
    @classmethod
    def linkat(cls): return cls._bit("linkat")
    @classmethod
    def symlinkat(cls): return cls._bit("symlinkat")
    @classmethod
    def lookup(cls): return cls._bit("lookup")
    @classmethod
    def mkdirat(cls): return cls._bit("mkdirat")
    @classmethod
    def unlinkat(cls): return cls._bit("unlinkat")
    @classmethod
    def renameat(cls): return cls._bit("renameat")


# FileCaps-name → Cap bits (≙ CapRights0.from's FileCaps mapping).
_FILECAPS = {
    "create": ("creat",),
    "chmod": ("fchmod",),
    "chown": ("fchown",),
    "link": ("linkat", "symlinkat"),
    "lookup": ("lookup",),
    "mkdir": ("mkdirat",),
    "read": ("read",),
    "remove": ("unlinkat",),
    "rename": ("renameat",),
    "seek": ("seek", "mmap"),
    "stat": ("fstat",),
    "sync": ("fsync",),
    "truncate": ("ftruncate",),
    "write": ("write",),
}


class CapRights:
    """A mutable rights set (≙ capsicum/cap_rights.pony CapRights0)."""

    def __init__(self):
        self._bits = 0

    @classmethod
    def from_caps(cls, caps) -> "CapRights":
        """Build from FileCaps-style names (≙ CapRights0.from)."""
        r = cls()
        for name in caps:
            for capname in _FILECAPS.get(name, ()):
                r._bits |= Cap._bit(capname)
        return r

    def set(self, cap: int) -> "CapRights":
        self._bits |= cap
        return self

    def unset(self, cap: int) -> "CapRights":
        self._bits &= ~cap
        return self

    def merge(self, that: "CapRights") -> "CapRights":
        self._bits |= that._bits
        return self

    def remove(self, that: "CapRights") -> "CapRights":
        self._bits &= ~that._bits
        return self

    def clear(self) -> "CapRights":
        self._bits = 0
        return self

    def contains(self, that: "CapRights") -> bool:
        """True when every right in `that` is in this set
        (≙ CapRights0.contains)."""
        return (that._bits & ~self._bits) == 0

    def limit(self, fd: int) -> bool:
        """Apply to a descriptor. No capsicum on Linux → success no-op,
        exactly the reference's non-FreeBSD compile (cap_rights.pony:
        70-78)."""
        return True

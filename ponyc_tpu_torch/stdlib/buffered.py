"""Buffered byte-stream reading/writing — ≙ the reference's
`packages/buffered/` (reader.pony, writer.pony).

Reader accumulates incoming chunks (e.g. TCP segments) without copying
until a read spans chunks; reads raise IncompleteError (≙ Pony `error`)
when not enough data has arrived, leaving the buffer intact so the
caller can retry after the next append — the exact protocol-decoder
workflow packages/net code uses.

Writer accumulates typed big/little-endian writes and hands back the
chunk list (`done()`), ready for a writev-style scatter send.
"""

from __future__ import annotations

import struct
from typing import List, Union

__all__ = ["Reader", "Writer", "IncompleteError"]


class IncompleteError(Exception):
    """Not enough buffered data (≙ Pony `error` from Reader.read_*)."""


class Reader:
    """≙ buffered/reader.pony."""

    def __init__(self):
        self._chunks: List[bytes] = []
        self._size = 0
        self._offset = 0          # consumed prefix of _chunks[0]

    def size(self) -> int:
        return self._size

    def clear(self) -> None:
        self._chunks = []
        self._size = 0
        self._offset = 0

    def append(self, data: Union[bytes, bytearray, str]) -> None:
        if isinstance(data, str):
            data = data.encode()
        if data:
            self._chunks.append(bytes(data))
            self._size += len(data)

    def skip(self, n: int) -> None:
        if n > self._size:
            raise IncompleteError(n)
        self._take(n)

    def block(self, n: int) -> bytes:
        """Read exactly n bytes (≙ reader.pony block)."""
        if n > self._size:
            raise IncompleteError(n)
        return self._take(n)

    def read_until(self, sep: int) -> bytes:
        """Bytes up to (excluding) separator byte; separator consumed."""
        idx = self._find(sep)
        if idx < 0:
            raise IncompleteError(sep)
        out = self._take(idx)
        self._take(1)
        return out

    def line(self) -> str:
        r"""One text line, \n or \r\n terminated (≙ reader.pony line)."""
        idx = self._find(0x0A)
        if idx < 0:
            raise IncompleteError("line")
        raw = self._take(idx)
        self._take(1)
        if raw.endswith(b"\r"):
            raw = raw[:-1]
        return raw.decode()

    def peek_u8(self, offset: int = 0) -> int:
        if offset >= self._size:
            raise IncompleteError(offset)
        pos = self._offset + offset
        for ch in self._chunks:
            if pos < len(ch):
                return ch[pos]
            pos -= len(ch)
        raise IncompleteError(offset)

    # -- typed reads: u8..u64 / i8..i64 / f32 / f64, be + le --
    def _take(self, n: int) -> bytes:
        out = bytearray()
        need = n
        while need:
            ch = self._chunks[0]
            avail = len(ch) - self._offset
            take = min(avail, need)
            out += ch[self._offset:self._offset + take]
            need -= take
            self._offset += take
            if self._offset == len(ch):
                self._chunks.pop(0)
                self._offset = 0
        self._size -= n
        return bytes(out)

    def _find(self, byte: int) -> int:
        pos = 0
        off = self._offset
        for ch in self._chunks:
            idx = ch.find(byte, off)
            if idx >= 0:
                return pos + idx - off
            pos += len(ch) - off
            off = 0
        return -1


class Writer:
    """≙ buffered/writer.pony: typed appends, chunk-list output."""

    def __init__(self):
        self._chunks: List[bytes] = []
        self._size = 0

    def size(self) -> int:
        return self._size

    def write(self, data: Union[bytes, bytearray, str]) -> "Writer":
        if isinstance(data, str):
            data = data.encode()
        if data:
            self._chunks.append(bytes(data))
            self._size += len(data)
        return self

    def writev(self, chunks) -> "Writer":
        for c in chunks:
            self.write(c)
        return self

    def done(self) -> List[bytes]:
        """Hand back the accumulated chunks and reset (≙ writer done)."""
        out = self._chunks
        self._chunks = []
        self._size = 0
        return out


def _add_numeric(fmt: str, name: str, size: int):
    def read_be(self: Reader) -> Union[int, float]:
        return struct.unpack(">" + fmt, self.block(size))[0]

    def read_le(self: Reader) -> Union[int, float]:
        return struct.unpack("<" + fmt, self.block(size))[0]

    def peek_be(self: Reader, offset: int = 0):
        if offset + size > self.size():
            raise IncompleteError(name)
        b = bytes(self.peek_u8(offset + i) for i in range(size))
        return struct.unpack(">" + fmt, b)[0]

    def write_be(self: Writer, v) -> Writer:
        return self.write(struct.pack(">" + fmt, v))

    def write_le(self: Writer, v) -> Writer:
        return self.write(struct.pack("<" + fmt, v))

    setattr(Reader, name + "_be", read_be)
    setattr(Reader, name + "_le", read_le)
    setattr(Reader, "peek_" + name + "_be", peek_be)
    setattr(Writer, name + "_be", write_be)
    setattr(Writer, name + "_le", write_le)
    if size == 1:
        setattr(Reader, name, read_be)
        setattr(Writer, name, write_be)


for _fmt, _name, _size in [("B", "u8", 1), ("b", "i8", 1),
                           ("H", "u16", 2), ("h", "i16", 2),
                           ("I", "u32", 4), ("i", "i32", 4),
                           ("Q", "u64", 8), ("q", "i64", 8),
                           ("f", "f32", 4), ("d", "f64", 8)]:
    _add_numeric(_fmt, _name, _size)

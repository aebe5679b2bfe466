"""Base64 encode/decode — ≙ the reference's `packages/encode/base64/`
(base64.pony: encode/decode with configurable 62nd/63rd characters,
optional padding and line breaks; encode_url/decode_url; encode_pem /
encode_mime presets).

A from-scratch implementation (6-bit chunking over a configurable
alphabet), not a re-export of the host base64 module, so the at62/at63/
pad/linelen knobs match the reference exactly.
"""

from __future__ import annotations

from typing import Union

__all__ = ["Base64"]

_STD = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"


def _as_bytes(data: Union[bytes, bytearray, str]) -> bytes:
    return data.encode() if isinstance(data, str) else bytes(data)


class Base64:
    """≙ base64.pony Base64 primitive."""

    @staticmethod
    def encode(data, at62: str = "+", at63: str = "/", pad: str = "=",
               linelen: int = 0, linesep: str = "\r\n") -> str:
        raw = _as_bytes(data)
        table = _STD + at62 + at63
        out = []
        for i in range(0, len(raw), 3):
            chunk = raw[i:i + 3]
            bits = int.from_bytes(chunk + b"\x00" * (3 - len(chunk)), "big")
            n_out = len(chunk) + 1
            for j in range(4):
                if j < n_out:
                    out.append(table[(bits >> (18 - 6 * j)) & 0x3F])
                elif pad:
                    out.append(pad)
        s = "".join(out)
        if linelen > 0:
            s = linesep.join(s[i:i + linelen]
                             for i in range(0, len(s), linelen))
            if s:
                s += linesep
        return s

    @staticmethod
    def encode_pem(data) -> str:
        """64-char lines (≙ base64.pony:27-32)."""
        return Base64.encode(data, linelen=64)

    @staticmethod
    def encode_mime(data) -> str:
        """76-char lines (≙ base64.pony:33-38)."""
        return Base64.encode(data, linelen=76)

    @staticmethod
    def encode_url(data, pad: bool = False) -> str:
        """URL-safe alphabet -_ with optional padding
        (≙ base64.pony:39-49)."""
        return Base64.encode(data, at62="-", at63="_",
                             pad="=" if pad else "")

    @staticmethod
    def decode(data: Union[str, bytes], at62: str = "+", at63: str = "/",
               pad_char: str = "=") -> bytes:
        """≙ base64.pony decode: whitespace tolerated, anything else
        raises ValueError (≙ Pony error)."""
        s = data.decode() if isinstance(data, (bytes, bytearray)) else data
        table = {c: i for i, c in enumerate(_STD + at62 + at63)}
        bits = 0
        nbits = 0
        out = bytearray()
        for ch in s:
            if ch in " \t\r\n" or ch == pad_char:
                continue
            if ch not in table:
                raise ValueError(f"invalid base64 character {ch!r}")
            bits = (bits << 6) | table[ch]
            nbits += 6
            if nbits >= 8:
                nbits -= 8
                out.append((bits >> nbits) & 0xFF)
        return bytes(out)

    @staticmethod
    def decode_url(data: Union[str, bytes]) -> bytes:
        return Base64.decode(data, at62="-", at63="_")

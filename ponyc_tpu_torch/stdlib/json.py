"""JSON document handling — ≙ the reference's `packages/json/`
(json_doc.pony, json_type.pony, _json_print.pony).

A hand-rolled recursive-descent parser (NOT a thin wrapper over the host
json module) so the API matches the reference's:

  doc = JsonDoc()
  doc.parse(src)          # raises JsonParseError; parse_report() has
                          # (line, message) like json_doc.pony:62-67
  doc.data                # None | bool | int | float | str |
                          # JsonArray | JsonObject
  doc.string(indent="  ", pretty_print=True)

JsonObject/JsonArray wrap a dict/list `data` field, as the Pony classes
do (json_type.pony:8-118). Integers stay ints and floats floats, the
reference's I64/F64 split.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

__all__ = ["JsonDoc", "JsonObject", "JsonArray", "JsonParseError"]


class JsonParseError(ValueError):
    """≙ Pony `error` raised from JsonDoc.parse; details via
    parse_report()."""

    def __init__(self, line: int, msg: str):
        super().__init__(f"line {line}: {msg}")
        self.line = line
        self.msg = msg


class JsonArray:
    """≙ json_type.pony JsonArray: a `data` list of json values."""

    def __init__(self, data: Optional[List[Any]] = None):
        self.data = data if data is not None else []

    def string(self, indent: str = "", pretty_print: bool = False) -> str:
        return _print_value(self, indent, pretty_print, 0)

    def __eq__(self, other):
        return isinstance(other, JsonArray) and self.data == other.data

    def __repr__(self):
        return f"JsonArray({self.data!r})"


class JsonObject:
    """≙ json_type.pony JsonObject: a `data` dict of json values."""

    def __init__(self, data: Optional[dict] = None):
        self.data = data if data is not None else {}

    def string(self, indent: str = "", pretty_print: bool = False) -> str:
        return _print_value(self, indent, pretty_print, 0)

    def __eq__(self, other):
        return isinstance(other, JsonObject) and self.data == other.data

    def __repr__(self):
        return f"JsonObject({self.data!r})"


def _escape(s: str) -> str:
    out = ['"']
    for ch in s:
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif ch == "\b":
            out.append("\\b")
        elif ch == "\f":
            out.append("\\f")
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\r":
            out.append("\\r")
        elif ch == "\t":
            out.append("\\t")
        elif ord(ch) < 0x20:
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(ch)
    out.append('"')
    return "".join(out)


def _print_value(v, indent: str, pretty: bool, level: int) -> str:
    """≙ _json_print.pony: compact by default, pretty with an indent
    string repeated per nesting level."""
    pad = indent * (level + 1) if pretty else ""
    end_pad = indent * level if pretty else ""
    nl = "\n" if pretty else ""
    sep = ", " if not pretty else ","
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            return "null"      # JSON has no NaN/Inf; match strictness
        s = repr(v)
        return s
    if isinstance(v, str):
        return _escape(v)
    if isinstance(v, JsonArray):
        if not v.data:
            return "[]"
        items = [_print_value(x, indent, pretty, level + 1) for x in v.data]
        if pretty:
            body = ("," + nl).join(pad + it for it in items)
            return "[" + nl + body + nl + end_pad + "]"
        return "[" + sep.join(items) + "]"
    if isinstance(v, JsonObject):
        if not v.data:
            return "{}"
        items = [
            _escape(k) + ": " + _print_value(x, indent, pretty, level + 1)
            for k, x in v.data.items()]
        if pretty:
            body = ("," + nl).join(pad + it for it in items)
            return "{" + nl + body + nl + end_pad + "}"
        return "{" + sep.join(items) + "}"
    raise TypeError(f"not a json value: {v!r}")


class JsonDoc:
    """≙ json_doc.pony JsonDoc: parse / string round-trip with error
    line reporting."""

    def __init__(self):
        self.data: Any = None
        self._src = ""
        self._pos = 0
        self._line = 1
        self._err: Tuple[int, str] = (0, "")

    # -- printing --
    def string(self, indent: str = "", pretty_print: bool = False) -> str:
        return _print_value(self.data, indent, pretty_print, 0)

    # -- parsing --
    def parse(self, source: str) -> None:
        self._src = source
        self._pos = 0
        self._line = 1
        self._err = (0, "")
        try:
            self.data = self._parse_value("top level")
            self._skip_ws()
            if self._pos < len(self._src):
                self._error("expected end of data, found junk")
        except JsonParseError:
            raise

    def parse_report(self) -> Tuple[int, str]:
        """(line, message) of the last parse error
        (≙ json_doc.pony:62-67)."""
        return self._err

    def _error(self, msg: str):
        self._err = (self._line, msg)
        raise JsonParseError(self._line, msg)

    def _skip_ws(self):
        src = self._src
        while self._pos < len(src) and src[self._pos] in " \t\r\n":
            if src[self._pos] == "\n":
                self._line += 1
            self._pos += 1

    def _peek(self, context: str) -> str:
        self._skip_ws()
        if self._pos >= len(self._src):
            self._error(f"unexpected end of data while parsing {context}")
        return self._src[self._pos]

    def _parse_value(self, context: str) -> Any:
        ch = self._peek(context)
        if ch == "{":
            return self._parse_object()
        if ch == "[":
            return self._parse_array()
        if ch == '"':
            return self._parse_string(context)
        if ch in "-0123456789":
            return self._parse_number()
        if ch.isalpha():
            return self._parse_keyword()
        self._error(f"invalid character {ch!r} while parsing {context}")

    def _parse_keyword(self) -> Any:
        src = self._src
        start = self._pos
        while self._pos < len(src) and src[self._pos].isalpha():
            self._pos += 1
        word = src[start:self._pos]
        if word == "true":
            return True
        if word == "false":
            return False
        if word == "null":
            return None
        self._error(f"invalid keyword {word!r}")

    def _parse_number(self) -> Any:
        src = self._src
        start = self._pos
        if src[self._pos] == "-":
            self._pos += 1
        digits0 = self._pos
        while self._pos < len(src) and src[self._pos].isdigit():
            self._pos += 1
        if self._pos == digits0:
            self._error("invalid number: no digits")
        is_float = False
        if self._pos < len(src) and src[self._pos] == ".":
            is_float = True
            self._pos += 1
            d = self._pos
            while self._pos < len(src) and src[self._pos].isdigit():
                self._pos += 1
            if self._pos == d:
                self._error("invalid number: no digits after decimal point")
        if self._pos < len(src) and src[self._pos] in "eE":
            is_float = True
            self._pos += 1
            if self._pos < len(src) and src[self._pos] in "+-":
                self._pos += 1
            d = self._pos
            while self._pos < len(src) and src[self._pos].isdigit():
                self._pos += 1
            if self._pos == d:
                self._error("invalid number: no digits in exponent")
        text = src[start:self._pos]
        return float(text) if is_float else int(text)

    def _parse_object(self) -> JsonObject:
        self._pos += 1                       # consume '{'
        obj = JsonObject()
        if self._peek("object") == "}":
            self._pos += 1
            return obj
        while True:
            if self._peek("object key") != '"':
                self._error("expected string object key")
            key = self._parse_string("object key")
            if self._peek("object") != ":":
                self._error("expected ':' after object key")
            self._pos += 1
            obj.data[key] = self._parse_value(f'object value for "{key}"')
            ch = self._peek("object")
            if ch == ",":
                self._pos += 1
                continue
            if ch == "}":
                self._pos += 1
                return obj
            self._error("expected ',' or '}' in object")

    def _parse_array(self) -> JsonArray:
        self._pos += 1                       # consume '['
        arr = JsonArray()
        if self._peek("array") == "]":
            self._pos += 1
            return arr
        while True:
            arr.data.append(self._parse_value("array element"))
            ch = self._peek("array")
            if ch == ",":
                self._pos += 1
                continue
            if ch == "]":
                self._pos += 1
                return arr
            self._error("expected ',' or ']' in array")

    def _parse_string(self, context: str) -> str:
        assert self._src[self._pos] == '"'
        self._pos += 1
        src = self._src
        out: List[str] = []
        while True:
            if self._pos >= len(src):
                self._error(f"unterminated string in {context}")
            ch = src[self._pos]
            if ch == '"':
                self._pos += 1
                return "".join(out)
            if ch == "\n":
                self._error(f"unterminated string in {context}")
            if ch == "\\":
                out.append(self._parse_escape(context))
                continue
            out.append(ch)
            self._pos += 1

    def _parse_escape(self, context: str) -> str:
        self._pos += 1                       # consume backslash
        src = self._src
        if self._pos >= len(src):
            self._error(f"unterminated escape in {context}")
        ch = src[self._pos]
        self._pos += 1
        simple = {'"': '"', "\\": "\\", "/": "/", "b": "\b", "f": "\f",
                  "n": "\n", "r": "\r", "t": "\t"}
        if ch in simple:
            return simple[ch]
        if ch == "u":
            code = self._parse_unicode_digits(context)
            if 0xD800 <= code <= 0xDBFF:
                # High surrogate: must pair (≙ json_doc.pony:311-342).
                if (self._pos + 1 < len(src) and src[self._pos] == "\\"
                        and src[self._pos + 1] == "u"):
                    self._pos += 2
                    low = self._parse_unicode_digits(context)
                    if not (0xDC00 <= low <= 0xDFFF):
                        self._error("invalid low surrogate in \\u escape")
                    code = (0x10000 + ((code - 0xD800) << 10)
                            + (low - 0xDC00))
                else:
                    self._error("lone high surrogate in \\u escape")
            elif 0xDC00 <= code <= 0xDFFF:
                self._error("lone low surrogate in \\u escape")
            return chr(code)
        self._error(f"invalid escape \\{ch}")

    def _parse_unicode_digits(self, context: str) -> int:
        src = self._src
        if self._pos + 4 > len(src):
            self._error(f"unterminated \\u escape in {context}")
        hexd = src[self._pos:self._pos + 4]
        try:
            code = int(hexd, 16)
        except ValueError:
            self._error(f"invalid \\u escape digits {hexd!r}")
        self._pos += 4
        return code

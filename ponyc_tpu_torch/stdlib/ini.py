"""INI parsing — ≙ the reference's `packages/ini/` (ini.pony streaming
parser + ini_map.pony convenience).

Streaming notify-style parser: `Ini.apply(lines, notify)` calls
notify.apply(section, key, value) / add_section(section) /
errors(lineno, err) and returns False if any error was reported —
matching the reference's error-as-return-value contract. IniMap builds
the {section: {key: value}} dict in one call.
"""

from __future__ import annotations

from typing import Dict, Iterable

__all__ = ["Ini", "IniMap", "IniNotify",
           "IniIncompleteSection", "IniNoDelimiter"]

# error kinds (≙ ini.pony primitives)
IniIncompleteSection = "incomplete section"
IniNoDelimiter = "no delimiter"


class IniNotify:
    """Callback surface (≙ ini.pony IniNotify interface). Return False
    from any hook to stop parsing."""

    def apply(self, section: str, key: str, value: str) -> bool:
        return True

    def add_section(self, section: str) -> bool:
        return True

    def errors(self, line: int, err: str) -> bool:
        return True


class Ini:
    """≙ ini.pony Ini primitive."""

    @staticmethod
    def apply(lines: Iterable[str], notify: IniNotify) -> bool:
        section = ""
        ok = True
        for lineno, raw in enumerate(lines, 1):
            line = raw.strip()
            if not line or line[0] in ";#":
                continue
            if line[0] == "[":
                end = line.find("]", 1)
                if end < 0:
                    ok = False
                    if not notify.errors(lineno, IniIncompleteSection):
                        return False
                    continue
                section = line[1:end]
                if not notify.add_section(section):
                    return ok
                continue
            delim = line.find("=")
            if delim < 0:
                delim = line.find(":")
            if delim < 0:
                ok = False
                if not notify.errors(lineno, IniNoDelimiter):
                    return False
                continue
            key = line[:delim].strip()
            value = line[delim + 1:].strip()
            # Strip a trailing comment from the value (≙ ini.pony's
            # value comment handling).
            for cchar in (";", "#"):
                ci = value.find(cchar)
                if ci >= 0:
                    value = value[:ci].rstrip()
            if not notify.apply(section, key, value):
                return ok
        return ok


class IniMap:
    """≙ ini_map.pony: parse into {section: {key: value}}; raises
    ValueError on malformed input (≙ Pony error)."""

    @staticmethod
    def apply(lines: Iterable[str]) -> Dict[str, Dict[str, str]]:
        out: Dict[str, Dict[str, str]] = {}
        errors = []

        class N(IniNotify):
            def apply(self, section, key, value):
                out.setdefault(section, {})[key] = value
                return True

            def add_section(self, section):
                out.setdefault(section, {})
                return True

            def errors(self, line, err):
                errors.append((line, err))
                return False

        if not Ini.apply(lines, N()):
            line, err = errors[0]
            raise ValueError(f"line {line}: {err}")
        return out

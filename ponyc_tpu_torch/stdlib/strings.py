"""String utilities — ≙ the reference's `packages/strings/`
(common_prefix.pony)."""

from __future__ import annotations

from typing import Iterable

__all__ = ["CommonPrefix"]


class CommonPrefix:
    """Longest common prefix of a sequence of strings
    (≙ common_prefix.pony: CommonPrefix(["doable"; "doing"]) == "do")."""

    def __new__(cls, data: Iterable) -> str:
        strs = [s if isinstance(s, str) else str(s) for s in data]
        if not strs:
            return ""
        prefix = strs[0]
        for s in strs[1:]:
            while not s.startswith(prefix):
                prefix = prefix[:-1]
                if not prefix:
                    return ""
        return prefix

"""Package resolution with safe-package capability control.

≙ the reference's `use` resolution + safe packages
(src/libponyc/pkg/package.c:615-630, 685-692: `--safe pkg1:pkg2`
records a safe list, and any package NOT on it gets `allow_ffi =
false` — i.e. unlisted packages lose the right to touch the OS).
Python imports subsume the *mechanics* of `use`; this module restores
the *capability control*: when a safe list is active, `use()` refuses
to hand out the FFI-reaching packages (the ones built on
ponyc_tpu_torch.native / OS syscalls) unless they are listed.

    from ponyc_tpu_torch.stdlib import pkg
    pkg.set_safe_packages(["files"])      # ≙ ponyc --safe files
    files = pkg.use("files")              # listed: ok
    json  = pkg.use("json")               # pure package: always ok
    net   = pkg.use("net")                # PermissionError

The list also comes from the environment (PONY_TPU_SAFE=files:net) and
from the CLI (`python -m ponyc_tpu_torch run --safe files:net app.py`),
mirroring how the reference's flag reaches package.c. Unrestricted by
default, exactly like ponyc without --safe.

This is voluntary-discipline capability control, like every ambient-auth
token in this stdlib (files.FilesAuth, AmbientAuth): Python can always
`import` around it, just as Pony code could link around a missing FFI
right only by recompiling — the gate is for the code you run, not the
code you wrote maliciously.
"""

from __future__ import annotations

import importlib
import os
from typing import Iterable, List, Optional

# Packages whose implementation reaches the OS/native layer (the
# moral equivalent of containing FFI; package.c's allow_ffi subjects).
FFI_PACKAGES = frozenset(
    {"net", "files", "process", "signals", "timers", "term"})

# Package name → import path (the `use` search path, collapsed to the
# stdlib map in stdlib/__init__.py's docstring).
_RESOLVE = {
    "assertion": "ponyc_tpu_torch.stdlib.assertion",
    "assert": "ponyc_tpu_torch.stdlib.assertion",
    "backpressure": "ponyc_tpu_torch.stdlib.backpressure",
    "buffered": "ponyc_tpu_torch.stdlib.buffered",
    "bureaucracy": "ponyc_tpu_torch.stdlib.bureaucracy",
    "capsicum": "ponyc_tpu_torch.stdlib.capsicum",
    "cli": "ponyc_tpu_torch.stdlib.cli",
    "collections": "ponyc_tpu_torch.stdlib.collections",
    "persistent": "ponyc_tpu_torch.stdlib.persistent",
    "debug": "ponyc_tpu_torch.stdlib.debug",
    "encode": "ponyc_tpu_torch.stdlib.encode",
    "base64": "ponyc_tpu_torch.stdlib.encode",
    "format": "ponyc_tpu_torch.stdlib.format",
    "ini": "ponyc_tpu_torch.stdlib.ini",
    "itertools": "ponyc_tpu_torch.stdlib.itertools",
    "json": "ponyc_tpu_torch.stdlib.json",
    "logger": "ponyc_tpu_torch.stdlib.logger",
    "math": "ponyc_tpu_torch.stdlib.math",
    "promises": "ponyc_tpu_torch.stdlib.promises",
    "random": "ponyc_tpu_torch.stdlib.random",
    "serialise": "ponyc_tpu_torch.stdlib.serialise",
    "strings": "ponyc_tpu_torch.stdlib.strings",
    "term": "ponyc_tpu_torch.stdlib.term",
    "timers": "ponyc_tpu_torch.stdlib.timers",
    "signals": "ponyc_tpu_torch.stdlib.signals",
    "net": "ponyc_tpu_torch.net",
    "files": "ponyc_tpu_torch.files",
    "process": "ponyc_tpu_torch.process",
    "ponytest": "ponyc_tpu_torch.testing",
    "testing": "ponyc_tpu_torch.testing",
    "ponybench": "ponyc_tpu_torch.benching",
    "benching": "ponyc_tpu_torch.benching",
}

_safe: Optional[frozenset] = None       # None = unrestricted


def set_safe_packages(names: Optional[Iterable[str]]) -> None:
    """Activate (or clear, with None) the safe list — ≙ --safe.
    An EMPTY list is maximal restriction: no FFI package resolves."""
    global _safe
    _safe = None if names is None else frozenset(names)


def _active_safe() -> Optional[frozenset]:
    if _safe is not None:
        return _safe
    env = os.environ.get("PONY_TPU_SAFE")
    if env is not None:
        return frozenset(p for p in env.split(":") if p)
    return None


def safe_packages() -> Optional[List[str]]:
    s = _active_safe()
    return sorted(s) if s is not None else None


def use(name: str):
    """Resolve a package by its reference name (≙ `use "name"`),
    enforcing the safe list for FFI-reaching packages."""
    target = _RESOLVE.get(name)
    if target is None:
        raise ImportError(
            f"unknown package {name!r} (≙ 'package not found' from use "
            f"resolution); known: {', '.join(sorted(_RESOLVE))}")
    safe = _active_safe()
    if safe is not None and name in FFI_PACKAGES and name not in safe:
        raise PermissionError(
            f"package {name!r} reaches the OS and is not on the safe "
            f"list {sorted(safe)} (≙ allow_ffi=false, "
            "package.c:624-629); add it via set_safe_packages / "
            "PONY_TPU_SAFE / --safe")
    return importlib.import_module(target)

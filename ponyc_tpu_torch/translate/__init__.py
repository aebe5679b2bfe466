"""Build-time transpilers — ≙ the fork's translate/ subsystem.

The reference compiler hooks non-`.pony` files found in a package into
codegen by extension (src/libponyc/translate/translate_source.c:13-21):
`.h` headers become Pony FFI wrapper classes (translate_c_header.c),
`.schema.json` becomes typed classes (translate_json_schema.c), and
md/txt/json become string constants (translate_text_resource.c).

Here the host language is Python, so the transpilers emit *Python
source*: ctypes FFI wrappers for C headers (c_header.py), typed
dataclasses with JSON (de)serialisation for schemas (json_schema.py),
and constants modules for text resources (text_resource.py).
`translate_dir` is the extension dispatcher: point it at a directory and
it writes a generated package next to it — the same workflow as dropping
resource files into a Pony package directory.
"""

from __future__ import annotations

import os
from typing import List

from .c_header import translate_c_header
from .c_header_export import export_header, write_header
from .json_schema import translate_json_schema
from .text_resource import translate_text_resource

__all__ = ["translate_c_header", "translate_json_schema",
           "export_header", "write_header",
           "translate_text_resource", "translate_dir"]

# Extension → translator (≙ the extension table translate_source.c:13-21).
_BY_EXT = {
    ".h": translate_c_header,
    ".schema.json": translate_json_schema,
    ".md": translate_text_resource,
    ".txt": translate_text_resource,
    ".json": translate_text_resource,
}


def _translator_for(fname: str):
    low = fname.lower()
    if low.endswith(".schema.json"):      # more specific than .json
        return translate_json_schema
    for ext, fn in _BY_EXT.items():
        if low.endswith(ext):
            return fn
    return None


def translate_dir(src_dir: str, out_dir: str) -> List[str]:
    """Translate every supported file in src_dir into Python modules under
    out_dir (creating __init__.py) — ≙ translate_source_package_file
    routing each non-.pony file through its transpiler. Returns the
    generated module paths."""
    os.makedirs(out_dir, exist_ok=True)
    generated: List[str] = []
    for fname in sorted(os.listdir(src_dir)):
        fn = _translator_for(fname)
        if fn is None:
            continue
        with open(os.path.join(src_dir, fname), "r") as f:
            text = f.read()
        src = fn(text, name=fname)
        mod = _module_name(fname)
        path = os.path.join(out_dir, mod + ".py")
        with open(path, "w") as f:
            f.write(src)
        generated.append(path)
    init = os.path.join(out_dir, "__init__.py")
    with open(init, "w") as f:
        f.write("# generated by ponyc_tpu_torch.translate — do not edit\n")
        for p in generated:
            m = os.path.splitext(os.path.basename(p))[0]
            f.write(f"from . import {m}  # noqa: F401\n")
    return generated


def _module_name(fname: str) -> str:
    base = fname.lower()
    for ext in (".schema.json", ".h", ".md", ".txt", ".json"):
        if base.endswith(ext):
            base = base[: -len(ext)]
            break
    out = "".join(c if c.isalnum() else "_" for c in base)
    if not out or out[0].isdigit():
        out = "r_" + out
    return out

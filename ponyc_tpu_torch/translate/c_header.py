"""C header → ctypes FFI wrapper module.

≙ translate_c_header.c (1055 LoC): the fork parses a C header dropped in
a Pony package and emits a Pony class whose methods wrap the `@`-FFI
calls with the right parameter/return types. The Python twin parses
function prototypes, enums and #define constants and emits a module that
binds the functions on a ctypes.CDLL with argtypes/restype filled in —
the host side of FFI, exactly where the reference's output sits.

Deliberately the same scope as the reference: a pragmatic recursive
regex-less scanner for declaration-level C (prototypes, enums, numeric
defines, typedefs to primitives). Function pointers, macros with
arguments and nested structs are skipped with a comment, as the fork
skips what it can't translate.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# C type → (ctypes expression, needs_import) — pointer types handled
# separately.
_PRIM = {
    "void": None,
    "char": "ctypes.c_char",
    "signed char": "ctypes.c_byte",
    "unsigned char": "ctypes.c_ubyte",
    "short": "ctypes.c_short",
    "unsigned short": "ctypes.c_ushort",
    "int": "ctypes.c_int",
    "unsigned": "ctypes.c_uint",
    "unsigned int": "ctypes.c_uint",
    "long": "ctypes.c_long",
    "unsigned long": "ctypes.c_ulong",
    "long long": "ctypes.c_longlong",
    "unsigned long long": "ctypes.c_ulonglong",
    "float": "ctypes.c_float",
    "double": "ctypes.c_double",
    "size_t": "ctypes.c_size_t",
    "ssize_t": "ctypes.c_ssize_t",
    "int8_t": "ctypes.c_int8",
    "uint8_t": "ctypes.c_uint8",
    "int16_t": "ctypes.c_int16",
    "uint16_t": "ctypes.c_uint16",
    "int32_t": "ctypes.c_int32",
    "uint32_t": "ctypes.c_uint32",
    "int64_t": "ctypes.c_int64",
    "uint64_t": "ctypes.c_uint64",
    "bool": "ctypes.c_bool",
    "_Bool": "ctypes.c_bool",
    "intptr_t": "ctypes.c_ssize_t",
    "uintptr_t": "ctypes.c_size_t",
}


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", " ", text)


def _ctype_of(decl: str, typedefs: Dict[str, str]) -> Optional[str]:
    d = " ".join(decl.replace("const", " ").replace("volatile", " ")
                 .replace("struct", " ").split())
    ptr = d.count("*")
    d = d.replace("*", " ").strip()
    d = typedefs.get(d, d)
    if ptr:
        base = _PRIM.get(d)
        if d in ("char",):
            return "ctypes.c_char_p" if ptr == 1 else "ctypes.c_void_p"
        if base is None or ptr > 1:
            return "ctypes.c_void_p"
        return f"ctypes.POINTER({base})"
    return _PRIM.get(d, "MISSING" if d else None)


_FUNC_RE = re.compile(
    r"(?:extern\s+)?([A-Za-z_][\w\s\*]*?)\s+\**\s*"
    r"([A-Za-z_]\w*)\s*\(([^()]*)\)\s*;", re.S)
_DEFINE_RE = re.compile(
    r"#define\s+([A-Za-z_]\w*)\s+"
    r"(-?(?:0[xX][0-9a-fA-F]+|\d+\.?\d*(?:[eE][+-]?\d+)?))\s*$",
    re.M)
_ENUM_RE = re.compile(
    r"enum\s*([A-Za-z_]\w*)?\s*\{([^}]*)\}", re.S)
_TYPEDEF_RE = re.compile(
    r"typedef\s+((?:unsigned\s+|signed\s+|long\s+|short\s+)*[A-Za-z_]\w*)"
    r"\s+([A-Za-z_]\w*)\s*;")


def parse_header(text: str):
    """Return (functions, constants, skipped). functions:
    [(name, ret_ctype|None, [(argname, ctype)])]."""
    text = _strip_comments(text)
    constants: List[Tuple[str, str]] = []
    for m in _DEFINE_RE.finditer(text):
        constants.append((m.group(1), m.group(2)))
    for m in _ENUM_RE.finditer(text):
        val = 0
        for item in m.group(2).split(","):
            item = item.strip()
            if not item:
                continue
            if "=" in item:
                k, v = (s.strip() for s in item.split("=", 1))
                try:
                    val = int(v, 0)
                except ValueError:
                    continue
            else:
                k = item
            constants.append((k, str(val)))
            val += 1
    typedefs: Dict[str, str] = {}
    for m in _TYPEDEF_RE.finditer(text):
        typedefs[m.group(2)] = m.group(1)

    functions = []
    skipped: List[str] = []
    body = re.sub(r"#[^\n]*", " ", text)          # drop remaining cpp
    for m in _FUNC_RE.finditer(body):
        rtype, name, argstr = m.group(1).strip(), m.group(2), m.group(3)
        if "(" in rtype or name in ("if", "while", "for", "return",
                                    "sizeof", "switch"):
            continue
        ret = _ctype_of(rtype, typedefs)
        if ret == "MISSING":
            skipped.append(f"{name}: unknown return type {rtype!r}")
            continue
        args: List[Tuple[str, str]] = []
        ok = True
        argstr = argstr.strip()
        if argstr not in ("", "void"):
            for i, a in enumerate(argstr.split(",")):
                a = a.strip()
                if a == "...":
                    ok = False
                    skipped.append(f"{name}: variadic")
                    break
                am = re.match(r"(.+?)([A-Za-z_]\w*)?\s*$", a)
                decl = am.group(1) if am else a
                aname = (am.group(2) if am and am.group(2) else f"a{i}")
                if am and am.group(2) and _ctype_of(
                        am.group(2), typedefs) not in (None, "MISSING"):
                    # trailing word was actually part of the type
                    decl, aname = a, f"a{i}"
                ct = _ctype_of(decl, typedefs)
                if ct in (None, "MISSING"):
                    ok = False
                    skipped.append(f"{name}: unsupported arg {a!r}")
                    break
                args.append((aname, ct))
        if ok:
            functions.append((name, ret, args))
    return functions, constants, skipped


def translate_c_header(text: str, *, name: str = "header.h") -> str:
    """Emit a Python module binding the header's functions over ctypes
    (≙ translate_c_header emitting the Pony wrapper class,
    translate_c_header.c:956)."""
    functions, constants, skipped = parse_header(text)
    lines = [
        f'"""FFI bindings generated from {name} by ponyc_tpu_torch.translate.',
        "",
        "Call bind(path_or_cdll) once, then use the module-level wrappers.",
        '"""',
        "",
        "import ctypes",
        "",
        "_lib = None",
        "",
        "",
        "def bind(lib):",
        '    """Attach a ctypes.CDLL (or path) and type every function."""',
        "    global _lib",
        "    _lib = (lib if isinstance(lib, ctypes.CDLL)",
        "            else ctypes.CDLL(lib))",
    ]
    for fname, ret, args in functions:
        ats = ", ".join(ct for _, ct in args)
        lines.append(f"    _lib.{fname}.argtypes = [{ats}]")
        lines.append(f"    _lib.{fname}.restype = "
                     f"{ret if ret else 'None'}")
    lines.append("    return _lib")
    lines.append("")
    for cname, cval in constants:
        lines.append(f"{cname} = {cval}")
    if constants:
        lines.append("")
    for fname, ret, args in functions:
        argnames = ", ".join(a for a, _ in args)
        lines.append("")
        lines.append(f"def {fname}({argnames}):")
        lines.append(f"    return _lib.{fname}({argnames})")
    if skipped:
        lines.append("")
        lines.append("# skipped declarations (≙ the fork skipping what it")
        lines.append("# cannot translate):")
        for s in skipped:
            lines.append(f"#   {s}")
    return "\n".join(lines) + "\n"

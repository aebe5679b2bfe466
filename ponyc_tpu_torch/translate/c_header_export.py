"""C header EXPORT: the outbound half of FFI.

≙ src/libponyc/codegen/genheader.c:256 (`genheader`): the reference
compiler emits a C header for a Pony library's public types so C code
can call in. This framework's compiled artifact is not a C ABI of
functions — it is a MESSAGE ABI: a finalized Program pins every
behaviour's global id, argument word layout, and every actor type's
global-id range (program.py ≙ reach/paint). This module exports that
ABI as a self-contained C header so native code (a C data source
feeding the native staging queue, a C test harness, another process
composing messages for the inject lane) can construct valid messages
without the Python runtime in the loop.

Emitted per program:
  - `#define` actor-id ranges and capacities per type;
  - an enum of behaviour global ids (word 0 of every message);
  - per-behaviour argument structs with int32 words in payload order
    (floats carried bit-cast, exactly like ops/pack.py) plus width
    macros, so `struct ponyc_tpu_msg` composition is mechanical;
  - the fixed wire facts (word0 = gid, msg_words, mailbox cap).

Like genheader.c, the output is deterministic and comment-annotated
with the source (type, behaviour, annotation) each line came from.

The message ABI is the JAX package's (the same ops/pack.py layout), so
this port emits a header byte-equal to ``ponyc_tpu``'s for the same
program: its ``ponyc_tpu_*``/``PONYC_TPU_*`` names and its generator
line are the ABI's names, shared by both packages.
"""

from __future__ import annotations

from typing import List

from ..ops import pack


# Every one-word spec occupies a FULL int32 wire word (pack.spec_width;
# narrow ints are widened into the word) — the struct fields must match
# that layout so memcpy into ponyc_tpu_msg.words is mechanical; value
# range rides as a comment, never as a narrower C type.
_C_BY_SPEC = {
    "I32": "int32_t", "U32": "uint32_t /* bit-pattern word */",
    "I16": "int32_t /* i16 value range */",
    "U16": "int32_t /* u16 value range */",
    "I8": "int32_t /* i8 value range */",
    "U8": "int32_t /* u8 value range */",
    "Bool": "int32_t /* bool word */", "F32": "float /* bit-cast */",
}


def _c_ident(name: str) -> str:
    return "".join(ch if ch.isalnum() else "_" for ch in name)


def _spec_c(spec) -> str:
    if pack.is_ref(spec):
        t = pack.ref_target(spec)
        return f"int32_t /* Ref[{t}] actor id */" if t \
            else "int32_t /* Ref actor id */"
    if pack.cap_mode(spec) is not None:
        return f"int32_t /* {spec.__name__} host-heap handle */"
    return _C_BY_SPEC.get(getattr(spec, "__name__", ""), "int32_t")


def export_header(program, opts, guard: str = "PONYC_TPU_PROGRAM_H"
                  ) -> str:
    """Render the finalized program's message ABI as a C header."""
    assert program.frozen, "finalize() the Program first"
    out: List[str] = []
    w = out.append
    w("/* Generated by ponyc_tpu.translate.c_header_export —")
    w("   the outbound half of FFI (≙ genheader.c:256).")
    w("   Message wire format: int32 words, word 0 = behaviour id")
    w("   (enum below), then the behaviour's payload words. */")
    w(f"#ifndef {guard}")
    w(f"#define {guard}")
    w("")
    w("#include <stdint.h>")
    w("")
    w(f"#define PONYC_TPU_MSG_WORDS {opts.msg_words}"
      "  /* payload words per message (program max) */")
    w(f"#define PONYC_TPU_MAILBOX_CAP {opts.mailbox_cap}")
    w(f"#define PONYC_TPU_TOTAL_ACTORS {program.total}")
    w("")
    for cohort in program.cohorts:
        n = _c_ident(cohort.atype.__name__).upper()
        w(f"/* actor type {cohort.atype.__name__}"
          f"{' (host cohort)' if cohort.host else ''} */")
        w(f"#define PONYC_TPU_{n}_CAPACITY {cohort.capacity}")
        w(f"#define PONYC_TPU_{n}_MSG_WORDS {cohort.msg_words}"
          "  /* this type's own mailbox width */")
        # Global ids are shard-major (Cohort.slot_to_gid); expose the
        # per-shard row window — enough to test membership and to map
        # slot 0 of shard 0.
        w(f"#define PONYC_TPU_{n}_ROW_START {cohort.local_start}")
        w(f"#define PONYC_TPU_{n}_ROW_STOP {cohort.local_stop}")
        w("")
    w("/* behaviour global ids — word 0 of every message")
    w("   (≙ the dispatch switch's message ids, genfun.c) */")
    w("enum ponyc_tpu_behaviour_id {")
    for bdef in program.behaviour_table:
        tname = _c_ident(bdef.actor_type.__name__)
        w(f"  PONYC_TPU_GID_{tname.upper()}_{bdef.name.upper()} = "
          f"{bdef.global_id},")
    w("};")
    w("")
    for bdef in program.behaviour_table:
        tname = _c_ident(bdef.actor_type.__name__)
        sname = f"ponyc_tpu_{tname}_{bdef.name}_args"
        total = sum(pack.spec_width(s) for s in bdef.arg_specs)
        w(f"/* {bdef.actor_type.__name__}.{bdef.name}"
          f"({', '.join(s.__name__ for s in bdef.arg_specs)}) */")
        w(f"#define PONYC_TPU_{tname.upper()}_{bdef.name.upper()}"
          f"_ARG_WORDS {total}")
        if not bdef.arg_specs:
            w(f"/* {sname}: no payload words */")
            w("")
            continue
        w(f"struct {sname} {{")
        for aname, spec in zip(bdef.arg_names, bdef.arg_specs):
            width = pack.spec_width(spec)
            if width == 1:
                w(f"  {_spec_c(spec)} {_c_ident(aname)};")
            else:
                base = "float" if isinstance(spec, pack._VecSpec) \
                    and spec.base is pack.F32 else "int32_t"
                w(f"  {base} {_c_ident(aname)}[{width}];"
                  f"  /* {spec.__name__} */")
        w("};")
        w("")
    w("/* one wire message: word0 = behaviour id, then the payload")
    w("   (zero-pad to the target type's MSG_WORDS) */")
    w("struct ponyc_tpu_msg {")
    w("  int32_t behaviour_id;")
    w(f"  int32_t words[PONYC_TPU_MSG_WORDS];")
    w("};")
    w("")
    w(f"#endif /* {guard} */")
    return "\n".join(out) + "\n"


def write_header(program, opts, path: str) -> str:
    text = export_header(program, opts)
    with open(path, "w") as f:
        f.write(text)
    return path

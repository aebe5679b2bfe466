"""The port's transpilers and C header export (≙ the fork's translate/
subsystem and genheader.c): the JAX package's tests/test_translate.py
and tests/test_c_header_export.py cases on the port, then the port held
against the JAX package: every generated source equal once the package
name is replaced, and the exported header of a program's message ABI
byte-equal for the same program (tests/_torch_programs.py,
define_abi)."""

import ctypes
import ctypes.util
import importlib
import os
import subprocess
import sys
import tempfile

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu_torch.translate import (export_header, translate_c_header,
                                       translate_dir,
                                       translate_json_schema,
                                       translate_text_resource,
                                       write_header)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_programs as tp  # noqa: E402

HDR = """
// demo header
#define MAX_THINGS 32
#define SCALE 2.5
enum Mode { MODE_OFF, MODE_ON = 5, MODE_AUTO };
typedef unsigned int u32;

int add_numbers(int a, int b);
double scale_value(double v);
size_t buf_len(const char *s);
void reset(void);
u32 mask_bits(u32 x, unsigned shift);
int printf(const char *fmt, ...);   // variadic → skipped
"""


def _load_generated(src: str, name: str, tmp_path):
    path = tmp_path / (name + ".py")
    path.write_text(src)
    sys.path.insert(0, str(tmp_path))
    try:
        import importlib
        mod = importlib.import_module(name)
        importlib.reload(mod)
        return mod
    finally:
        sys.path.pop(0)


def test_c_header_bindings_run_against_real_lib(tmp_path):
    src = translate_c_header(HDR, name="demo.h")
    mod = _load_generated(src, "demo_ffi", tmp_path)
    # constants from #define and enum
    assert mod.MAX_THINGS == 32
    assert mod.SCALE == 2.5
    assert mod.MODE_OFF == 0 and mod.MODE_ON == 5 and mod.MODE_AUTO == 6
    # variadic printf was skipped, not bound
    assert not hasattr(mod, "printf")
    # Compile the implementation and call through the bindings.
    c = tmp_path / "demo.c"
    c.write_text("""
#include <stddef.h>
#include <string.h>
int add_numbers(int a, int b) { return a + b; }
double scale_value(double v) { return v * 2.5; }
size_t buf_len(const char *s) { return strlen(s); }
void reset(void) {}
unsigned mask_bits(unsigned x, unsigned s) { return x >> s; }
""")
    so = tmp_path / "libdemo.so"
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(so), str(c)],
                   check=True)
    mod.bind(str(so))
    assert mod.add_numbers(2, 40) == 42
    assert abs(mod.scale_value(2.0) - 5.0) < 1e-9
    assert mod.buf_len(b"hello") == 5
    assert mod.mask_bits(0xF0, 4) == 0x0F
    mod.reset()


SCHEMA = """
{
  "title": "job",
  "description": "A queued job.",
  "type": "object",
  "required": ["id"],
  "properties": {
    "id": {"type": "integer"},
    "name": {"type": "string"},
    "weight": {"type": "number"},
    "urgent": {"type": "boolean"},
    "tags": {"type": "array", "items": {"type": "string"}},
    "owner": {
      "type": "object",
      "title": "owner",
      "properties": {
        "uid": {"type": "integer"},
        "email": {"type": "string"}
      }
    }
  }
}
"""


def test_json_schema_roundtrip(tmp_path):
    src = translate_json_schema(SCHEMA, name="job.schema.json")
    mod = _load_generated(src, "job_schema", tmp_path)
    j = mod.Job.from_json(
        '{"id": 7, "name": "x", "weight": 1.5, "urgent": true,'
        ' "tags": ["a","b"], "owner": {"uid": 3, "email": "e@x"}}')
    assert j.id == 7 and j.urgent is True and j.tags == ["a", "b"]
    assert j.owner.uid == 3
    back = mod.Job.from_json(j.to_json())
    assert back.to_dict() == j.to_dict()
    # defaults for non-required fields
    k = mod.Job.from_json('{"id": 1}')
    assert k.name == "" and k.weight == 0.0 and k.tags == []
    # device-actor field specs derived from flat scalars
    assert mod.Job.ACTOR_FIELDS == {"id": "I32", "weight": "F32",
                                    "urgent": "Bool"}


def test_text_resource_and_dir_dispatch(tmp_path):
    src_dir = tmp_path / "resources"
    out_dir = tmp_path / "generated"
    src_dir.mkdir()
    (src_dir / "notes.md").write_text("# Title\nBody ≥ stuff\n")
    (src_dir / "config.json").write_text('{"a": 1}')
    (src_dir / "job.schema.json").write_text(SCHEMA)
    (src_dir / "demo.h").write_text(HDR)
    (src_dir / "ignored.bin").write_text("xx")
    paths = translate_dir(str(src_dir), str(out_dir))
    names = sorted(os.path.basename(p) for p in paths)
    assert names == ["config.py", "demo.py", "job.py", "notes.py"]
    sys.path.insert(0, str(tmp_path))
    try:
        from generated import config, notes  # noqa
        assert notes.TEXT.startswith("# Title")
        assert config.DATA == {"a": 1}
    finally:
        sys.path.pop(0)
        for m in ("generated", "generated.config", "generated.notes",
                  "generated.demo", "generated.job"):
            sys.modules.pop(m, None)


def test_text_resource_unicode():
    out = translate_text_resource("héllo ≙ wörld", name="x.txt")
    ns = {}
    exec(out, ns)
    assert ns["TEXT"] == "héllo ≙ wörld"


# ---- the exported C header (tests/test_c_header_export.py) --------------

def _build(pkg=ponyc_tpu_torch, T=None):
    T = T or tp.define_abi(pkg)
    opts = pkg.RuntimeOptions(mailbox_cap=8, batch=1, max_sends=1,
                              msg_words=4, inject_slots=8)
    kw = {"device": "cpu"} if pkg is ponyc_tpu_torch else {}
    rt = pkg.Runtime(opts, **kw)
    rt.declare(T.Sensor, 4).declare(T.Hub, 2).start()
    return rt, opts


def test_header_reflects_program_abi():
    rt, opts = _build()
    text = export_header(rt.program, opts)
    gid = {b.actor_type.__name__ + "." + b.name: b.global_id
           for b in rt.program.behaviour_table}
    assert f"PONYC_TPU_GID_SENSOR_SAMPLE = {gid['Sensor.sample']}" in text
    assert f"PONYC_TPU_GID_HUB_COLLECT = {gid['Hub.collect']}" in text
    assert "#define PONYC_TPU_MSG_WORDS 4" in text
    assert "#define PONYC_TPU_HUB_MSG_WORDS 4" in text      # Vec3 + Iso
    assert "#define PONYC_TPU_SENSOR_MSG_WORDS 2" in text   # F32 + I32
    assert "float coeffs[3];" in text
    assert "Iso host-heap handle" in text
    assert "Ref[Hub] actor id" in text


def test_header_compiles_under_gpp():
    rt, opts = _build()
    with tempfile.TemporaryDirectory() as d:
        write_header(rt.program, opts, os.path.join(d, "prog.h"))
        main = os.path.join(d, "main.cc")
        gid = {b.actor_type.__name__ + "." + b.name: b.global_id
               for b in rt.program.behaviour_table}
        with open(main, "w") as f:
            f.write(f'''
#include "prog.h"
#include <cstdio>
int main() {{
  struct ponyc_tpu_Sensor_sample_args a;
  a.v = 1.5f; a.seq = 7;
  struct ponyc_tpu_msg m;
  m.behaviour_id = PONYC_TPU_GID_SENSOR_SAMPLE;
  static_assert(PONYC_TPU_GID_SENSOR_SAMPLE == {gid['Sensor.sample']},
                "gid");
  static_assert(PONYC_TPU_SENSOR_SAMPLE_ARG_WORDS == 2, "width");
  static_assert(PONYC_TPU_HUB_CALIBRATE_ARG_WORDS == 4, "vec+iso");
  std::printf("%d %d\\n", m.behaviour_id, a.seq);
  return 0;
}}
''')
        exe = os.path.join(d, "a.out")
        r = subprocess.run(["g++", "-std=c++17", "-Wall", "-Werror",
                            main, "-o", exe],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        out = subprocess.run([exe], capture_output=True, text=True)
        assert out.stdout.split() == [str(gid["Sensor.sample"]), "7"]


def test_narrow_ints_occupy_full_words():
    """Every one-word spec is a full int32 wire word (pack.spec_width
    widens narrow ints): the struct layout agrees, so memcpy into
    ponyc_tpu_msg.words is mechanical."""
    T = tp.define_abi(ponyc_tpu_torch)
    opts = ponyc_tpu_torch.RuntimeOptions(mailbox_cap=8, batch=1,
                                          max_sends=1, msg_words=2,
                                          inject_slots=8)
    rt = ponyc_tpu_torch.Runtime(opts, device="cpu")
    rt.declare(T.Narrowed, 1).start()
    text = export_header(rt.program, opts)
    assert "int32_t /* i16 value range */ a;" in text
    assert "int32_t /* u8 value range */ b;" in text
    assert "int16_t" not in text and "int8_t" not in text
    assert "#define PONYC_TPU_NARROWED_PUT_ARG_WORDS 2" in text


# ---- the port against the JAX package ------------------------------------

def _ref_translate():
    return importlib.import_module("ponyc_tpu.translate")


def _same(port: str, ref: str) -> None:
    assert port.replace("ponyc_tpu_torch", "ponyc_tpu") == ref
    assert "ponyc_tpu_torch" in port or "ponyc_tpu" not in ref


def test_generated_sources_equal_the_jax_package():
    ref = _ref_translate()
    _same(translate_c_header(HDR, name="demo.h"),
          ref.translate_c_header(HDR, name="demo.h"))
    _same(translate_json_schema(SCHEMA, name="job.schema.json"),
          ref.translate_json_schema(SCHEMA, name="job.schema.json"))
    for text, name in (("# Title\nBody\n", "notes.md"),
                       ('{"a": [1, 2]}', "config.json"),
                       ("héllo ≙ wörld", "x.txt")):
        _same(translate_text_resource(text, name=name),
              ref.translate_text_resource(text, name=name))


def test_translate_dir_equals_the_jax_package(tmp_path):
    src = tmp_path / "resources"
    src.mkdir()
    (src / "notes.md").write_text("# Title\nBody ≥ stuff\n")
    (src / "config.json").write_text('{"a": 1}')
    (src / "job.schema.json").write_text(SCHEMA)
    (src / "demo.h").write_text(HDR)
    port = translate_dir(str(src), str(tmp_path / "port"))
    ref = _ref_translate().translate_dir(str(src), str(tmp_path / "ref"))
    assert [os.path.basename(p) for p in port] == \
        [os.path.basename(p) for p in ref]
    for name in sorted(os.listdir(tmp_path / "ref")):
        _same((tmp_path / "port" / name).read_text(),
              (tmp_path / "ref" / name).read_text())


def test_exported_header_is_byte_equal_to_the_jax_packages(tmp_path):
    rt, opts = _build()
    jrt, jopts = _build(ponyc_tpu)
    ref = _ref_translate()
    assert export_header(rt.program, opts) == \
        ref.export_header(jrt.program, jopts)
    assert export_header(rt.program, opts, guard="X_H") == \
        ref.export_header(jrt.program, jopts, guard="X_H")
    a = write_header(rt.program, opts, str(tmp_path / "port.h"))
    b = ref.write_header(jrt.program, jopts, str(tmp_path / "ref.h"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for pkg in (ponyc_tpu_torch, ponyc_tpu):
        T = tp.define_abi(pkg)
        o = pkg.RuntimeOptions(mailbox_cap=8, batch=1, max_sends=1,
                               msg_words=2, inject_slots=8)
        kw = {"device": "cpu"} if pkg is ponyc_tpu_torch else {}
        r = pkg.Runtime(o, **kw)
        r.declare(T.Narrowed, 1).start()
        mod = importlib.import_module(pkg.__name__ + ".translate")
        if pkg is ponyc_tpu_torch:
            narrow = mod.export_header(r.program, o)
        else:
            assert mod.export_header(r.program, o) == narrow

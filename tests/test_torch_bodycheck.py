"""The port's behaviour-body source analyzer
(ponyc_tpu_torch/lint/bodycheck.py ≙ the reference's syntactic body
checks: safeto.c + verify/fun.c): the JAX package's
tests/test_bodycheck.py cases on the port (AST rules R6–R9 with
source-precise findings, the broken-fixture corpus, the three
suppression levels, path/dir CLI targets, the github output format,
the full-lint sweep over examples/ and the port's own modules), then
the port held against the JAX package: equal findings (rule, severity,
type, behaviour, file, line, column) on examples/*.py, the fixtures and
both packages' models, parsed and never imported, with the advice in
the port's idiom."""

import importlib
import json
import os
import sys
import time

import pytest

from ponyc_tpu_torch.lint import (check_path, check_paths, check_source,
                            lint_module, lint_types)
from ponyc_tpu_torch.lint.bodycheck import check_types, parse_module

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures", "bodycheck")
BROKEN = os.path.join(FIXDIR, "broken_bodies.py")
SUPPRESSED = os.path.join(FIXDIR, "suppressed_ok.py")


def marks_of(path):
    """{mark id: 1-based line} from `# MARK:<id>` fixture comments."""
    out = {}
    with open(path) as f:
        for i, line in enumerate(f, 1):
            if "MARK:" in line:
                out[line.split("MARK:")[1].strip()] = i
    return out


def by_rule(findings):
    out = {}
    for f in findings:
        out.setdefault(f.rule, []).append(f)
    return out


# ---- the broken-fixture corpus: exact rule ids + line numbers ------------

EXPECTED_MARKS = {
    "r6-if": "R6", "r6-and": "R6", "r6-ternary": "R6", "r6-not": "R6",
    "r6-chain": "R6", "r6-assert": "R6", "r6-for": "R6",
    "r6-while": "R6",
    "r7-for-send": "R7", "r7-while-exit": "R7", "r7-falloff": "R7",
    "r8-read-typo": "R8", "r8-write-typo": "R8", "r8-val-write": "R8",
    "r8-mut-dropped": "R8", "r8-missing": "R8", "r8-self-attr": "R8",
    "r9-print": "R9", "r9-nprandom": "R9", "r9-time": "R9",
    "r9-capture": "R9", "r9-move": "R9", "r9-free-use": "R9",
}


def test_fixture_corpus_flags_every_seeded_defect_at_exact_lines():
    marks = marks_of(BROKEN)
    assert set(EXPECTED_MARKS) <= set(marks), "fixture marks drifted"
    findings = check_path(BROKEN)
    got = {(f.rule, f.line) for f in findings}
    for mark, rule in EXPECTED_MARKS.items():
        assert (rule, marks[mark]) in got, (
            f"{mark}: expected {rule} at {BROKEN}:{marks[mark]}; got "
            + "\n".join(str(f) for f in findings))
    assert all(f.file == BROKEN for f in findings)
    assert all(f.col and f.col >= 1 for f in findings)


def test_fixture_corpus_is_pure_ast_no_import_no_torch():
    # The fixture imports a module that does not exist: importing it
    # can only raise — the analyzer must never try.
    with pytest.raises(ImportError):
        importlib.import_module("a_module_that_does_not_exist_anywhere")
    t0 = time.perf_counter()
    findings = check_path(BROKEN)
    dt = time.perf_counter() - t0
    assert findings, "corpus produced no findings"
    assert "broken_bodies" not in sys.modules
    assert dt < 0.1, f"pure-AST analysis took {dt * 1000:.1f} ms"


def test_severities_split_error_vs_warning():
    sev = {(f.rule, f.severity) for f in check_path(BROKEN)}
    assert ("R6", "error") in sev            # dies at trace
    assert ("R7", "error") in sev            # non-static send count
    assert ("R7", "warning") in sev          # while-loop effect
    assert ("R8", "error") in sev            # key typo
    assert ("R8", "warning") in sev          # val write / dropped mut
    assert ("R9", "error") in sev            # use-after-move
    assert ("R9", "warning") in sev          # host impurity


def test_unparseable_source_reports_r0_not_crash():
    fs = check_source("def broken(:\n", "bad.py")
    assert len(fs) == 1 and fs[0].rule == "R0"
    assert fs[0].severity == "error" and fs[0].line == 1


# ---- suppressions (all three levels, both fixture and API) ---------------

def test_suppressed_fixture_reports_zero_findings():
    assert check_path(SUPPRESSED) == []


def test_suppressions_visible_with_include_suppressed():
    with open(SUPPRESSED) as f:
        src = f.read()
    kept = check_source(src, SUPPRESSED, include_suppressed=True)
    assert any(f.rule == "R6" for f in kept)
    assert any(f.rule == "R9" for f in kept)     # the bare line ignore


def test_line_level_suppression_scopes_to_named_rules():
    src = (
        "from ponyc_tpu_torch import I32, actor, behaviour\n"
        "@actor\n"
        "class A:\n"
        "    n: I32\n"
        "    @behaviour\n"
        "    def go(self, st, v: I32):\n"
        "        if v > 0:              # lint: ignore[R8]\n"
        "            return st\n"
        "        return st\n")
    # The comment names R8 only: the R6 on that line survives.
    fs = check_source(src, "scoped.py")
    assert [f.rule for f in fs] == ["R6"]


# ---- R6 details ----------------------------------------------------------

def _one_type(body, fields="n: I32", host=False, extra=""):
    return (
        "from ponyc_tpu_torch import Blob, BlobVal, I32, Iso, Ref, Val, "
        "actor, behaviour\n"
        "@actor\n"
        "class T:\n"
        + (f"    HOST = True\n" if host else "")
        + f"    {fields}\n"
        + extra
        + "    @behaviour\n"
        + body)


def test_r6_host_behaviours_branch_freely():
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        if v > 0:\n"
        "            print('host actors run real python')\n"
        "        return st\n", host=True)
    assert check_source(src, "h.py") == []


def test_r6_untainted_python_control_flow_is_fine():
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        acc = st['n']\n"
        "        for i in range(4):\n"
        "            acc = acc + i\n"
        "        return {**st, 'n': acc}\n")
    assert check_source(src, "ok.py") == []


def test_r6_taint_flows_through_assignment():
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        derived = st['n'] * 2 + v\n"
        "        if derived:\n"
        "            return st\n"
        "        return st\n")
    fs = check_source(src, "t.py")
    assert [f.rule for f in fs] == ["R6"] and fs[0].line == 8


def test_r6_rebinding_clears_taint():
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        k = st['n']\n"
        "        k = 3\n"
        "        if k:\n"
        "            return st\n"
        "        return st\n")
    assert check_source(src, "t.py") == []


# ---- R7 details ----------------------------------------------------------

def test_r7_static_range_effects_are_fine():
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        for i in range(3):\n"
        "            self.send(st['n'], T.go, v, when=v > i)\n"
        "        return st\n")
    assert [f.rule for f in check_source(src, "t.py")] == []


def test_r7_effect_in_nested_function_warns():
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        def body(i, carry):\n"
        "            self.send(st['n'], T.go, carry)\n"
        "            return carry\n"
        "        return st\n")
    fs = check_source(src, "t.py")
    assert [f.rule for f in fs] == ["R7"]
    assert fs[0].severity == "warning" and "nested" in fs[0].message


def test_r7_bare_return_is_flagged():
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        return\n")
    fs = check_source(src, "t.py")
    assert [f.rule for f in fs] == ["R7"] and fs[0].severity == "error"


def test_r7_branchy_termination_analysis():
    # if/else with both arms returning: fine.
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        if True:\n"
        "            return st\n"
        "        else:\n"
        "            return st\n")
    assert check_source(src, "t.py") == []
    # if without else falling through: flagged.
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        if True:\n"
        "            return st\n")
    fs = check_source(src, "t.py")
    assert [f.rule for f in fs] == ["R7"]


# ---- R8 details ----------------------------------------------------------

def test_r8_did_you_mean_names_the_close_field():
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        return {**st, 'count': v}\n", fields="counter: I32")
    fs = check_source(src, "t.py")
    assert len(fs) == 1 and fs[0].rule == "R8"
    assert "did you mean 'counter'" in fs[0].message


def test_r8_st_get_reads_are_checked():
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        x = st.get('bogus')\n"
        "        return st\n")
    fs = check_source(src, "t.py")
    assert [f.rule for f in fs] == ["R8"] and "bogus" in fs[0].message


def test_r8_unknown_base_class_disables_key_checks():
    # Inherited fields are invisible to the AST: no false positives.
    src = ("from ponyc_tpu_torch import I32, actor, behaviour\n"
           "from somewhere import BaseActor\n"
           "class Sub(BaseActor):\n"
           "    @behaviour\n"
           "    def go(self, st, v: I32):\n"
           "        return {**st, 'inherited_field': v}\n")
    assert check_source(src, "t.py") == []


# ---- R9 details ----------------------------------------------------------

def test_r9_freeze_then_broadcast_is_legal():
    # The blob_pipeline idiom: alloc (iso), write, freeze to val, then
    # alias the SAME handle into two sends — legal, val aliases freely;
    # and freeing the consumed iso input is not a use-after-move.
    src = (
        "from ponyc_tpu_torch import Blob, BlobVal, I32, actor, behaviour\n"
        "@actor\n"
        "class T:\n"
        "    n: I32\n"
        "    @behaviour\n"
        "    def go(self, st, b: Blob):\n"
        "        h = self.blob_alloc(length=2)\n"
        "        self.blob_set(h, 0, 1)\n"
        "        s = self.blob_freeze(h)\n"
        "        self.send(st['n'], T.recv, s)\n"
        "        self.send(st['n'], T.recv, s)\n"
        "        self.blob_free(b)\n"
        "        return st\n"
        "    @behaviour\n"
        "    def recv(self, st, s: BlobVal):\n"
        "        return st\n")
    assert check_source(src, "t.py") == []


def test_r9_val_blob_write_flagged():
    src = _one_type(
        "    def go(self, st, b: BlobVal):\n"
        "        self.blob_set(b, 0, 1)\n"
        "        return st\n")
    fs = check_source(src, "t.py")
    assert [f.rule for f in fs] == ["R9"]
    assert "frozen (val)" in fs[0].message


def test_r9_conditional_exclusive_moves_do_not_poison():
    # A move on only ONE arm of a Python-level branch is not a
    # definite move (branch join intersects move sets).
    src = _one_type(
        "    def go(self, st, p: Iso, flag: I32):\n"
        "        cold = 1\n"
        "        if cold:\n"
        "            self.send(st['n'], T.go, p, 0)\n"
        "        else:\n"
        "            self.send(st['n'], T.go, p, 1)\n"
        "        return st\n")
    assert check_source(src, "t.py") == []


def test_r9_global_statement_flagged():
    src = _one_type(
        "    def go(self, st, v: I32):\n"
        "        global W\n"
        "        return st\n")
    fs = check_source(src, "t.py")
    assert [f.rule for f in fs] == ["R9"] and "global" in fs[0].message


# ---- live-type integration (lint_types / lint_module pick R6–R9 up) -----

def _write_mod(tmp_path, name, text):
    p = tmp_path / f"{name}.py"
    p.write_text(text)
    sys.path.insert(0, str(tmp_path))
    return p


def test_check_types_and_lint_types_agree(tmp_path):
    _write_mod(tmp_path, "livemod", _one_type(
        "    def go(self, st, v: I32):\n"
        "        if v > 0:\n"
        "            return st\n"
        "        return st\n"))
    try:
        mod = importlib.import_module("livemod")
        direct = check_types(mod.T)
        merged = lint_types(mod.T)
        assert [f.rule for f in direct] == ["R6"]
        assert direct[0].line == 7 and direct[0].file.endswith(
            "livemod.py")
        # lint_types folds the same finding in with the graph rules
        # (the probe also fails on the branch: R0 reports alongside).
        assert {("R6", 7)} <= {(f.rule, f.line) for f in merged}
        assert any(f.rule == "R0" and f.line for f in merged)
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("livemod", None)


def test_graph_rule_findings_carry_locations(tmp_path):
    _write_mod(tmp_path, "locmod", (
        "from ponyc_tpu_torch import I32, Ref, actor, behaviour\n"
        "@actor\n"
        "class Away:\n"
        "    x: I32\n"
        "    @behaviour\n"
        "    def put(self, st, v: I32):\n"
        "        return {**st, 'x': v}\n"
        "@actor\n"
        "class Alone:\n"
        "    out: Ref\n"
        "    MAX_SENDS = 1\n"
        "    @behaviour\n"
        "    def go(self, st, v: I32):\n"
        "        self.send(st['out'], Away.put, v)\n"
        "        return st\n"))
    try:
        mod = importlib.import_module("locmod")
        fs = lint_types(mod.Alone)          # Away outside the world: R2
        r2 = [f for f in fs if f.rule == "R2"]
        assert r2 and r2[0].file.endswith("locmod.py")
        assert r2[0].line == 12             # the @behaviour def site
        obj = json.loads(r2[0].json_line())
        assert obj["file"].endswith("locmod.py") and obj["line"] == 12
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("locmod", None)


def test_behaviour_level_ignore_on_live_types(tmp_path):
    _write_mod(tmp_path, "bmutedmod", (
        "from ponyc_tpu_torch import I32, actor, behaviour\n"
        "@actor\n"
        "class M:\n"
        "    n: I32\n"
        "    @behaviour(lint_ignore=('R6', 'R0'))\n"
        "    def go(self, st, v: I32):\n"
        "        if v > 0:\n"
        "            return st\n"
        "        return st\n"
        "    @behaviour\n"
        "    def loud(self, st, v: I32):\n"
        "        if v > 0:\n"
        "            return st\n"
        "        return st\n"))
    try:
        mod = importlib.import_module("bmutedmod")
        fs = lint_types(mod.M)
        # Suppression is per-behaviour: go quiet, loud still flagged.
        assert {f.behaviour for f in fs if f.rule == "R6"} == {"loud"}
        kept = lint_types(mod.M, include_suppressed=True)
        assert {f.behaviour for f in kept if f.rule == "R6"} == {
            "go", "loud"}
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("bmutedmod", None)


# ---- CLI: paths, directories, output formats ----------------------------

def _run_cli(args, cwd=ROOT):
    """`python -m ponyc_tpu_torch <args>` in `cwd`, run in this process
    (tests/test_torch_verify.py runs the module as a program)."""
    import contextlib
    import io
    import types

    from ponyc_tpu_torch.__main__ import main
    out, err = io.StringIO(), io.StringIO()
    here, path = os.getcwd(), list(sys.path)
    try:
        os.chdir(str(cwd))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = main(list(args))
    finally:
        os.chdir(here)
        sys.path[:] = path
    return types.SimpleNamespace(returncode=code, stdout=out.getvalue(),
                                 stderr=err.getvalue())


def test_cli_lint_accepts_files_dirs_and_formats(tmp_path):
    rel = os.path.relpath(BROKEN, ROOT)
    # A single broken file: findings, exit 1, file:line in the text.
    r = _run_cli(["lint", rel])
    assert r.returncode == 1, r.stderr[-500:]
    assert f"{rel}:" in r.stdout and "R6" in r.stdout
    assert "lint:" in r.stdout          # summary line
    # JSON: stable keys incl. file/line.
    r = _run_cli(["lint", rel, "--json"])
    objs = [json.loads(line) for line in r.stdout.splitlines()]
    assert all(o["file"] == rel for o in objs)
    assert any(o["rule"] == "R6" and o["line"] for o in objs)
    # GitHub annotations.
    r = _run_cli(["lint", rel, "--format", "github"])
    assert r.returncode == 1
    assert any(line.startswith(f"::error file={rel},line=")
               for line in r.stdout.splitlines()), r.stdout[:400]
    # A directory target sweeps the tree (suppressed fixture rides
    # along clean; the broken one keeps the exit code at 1).
    r = _run_cli(["lint", os.path.relpath(FIXDIR, ROOT)])
    assert r.returncode == 1 and "type(s)" in r.stdout
    # No actor types anywhere: exit 3.
    (tmp_path / "plain.py").write_text("x = 1\n")
    r = _run_cli(["lint", str(tmp_path)])
    assert r.returncode == 3, (r.returncode, r.stderr)
    # Clean actor file: exit 0.
    (tmp_path / "cleanmod.py").write_text(
        "from ponyc_tpu_torch import I32, actor, behaviour\n"
        "@actor\n"
        "class C:\n"
        "    n: I32\n"
        "    @behaviour\n"
        "    def go(self, st, v: I32):\n"
        "        return {**st, 'n': v}\n")
    r = _run_cli(["lint", str(tmp_path / "cleanmod.py")])
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr)
    assert "clean" in r.stdout


def test_cli_verify_json_carries_locations(tmp_path):
    (tmp_path / "vloc.py").write_text(
        "from ponyc_tpu_torch import I32, Ref, actor, behaviour\n"
        "@actor\n"
        "class S:\n"
        "    x: I32\n"
        "    @behaviour\n"
        "    def put(self, st, v: I32):\n"
        "        return {**st, 'x': v}\n"
        "@actor\n"
        "class Over:\n"
        "    out: Ref['S']\n"
        "    MAX_SENDS = 1\n"
        "    @behaviour\n"
        "    def go(self, st, v: I32):\n"
        "        self.send(st['out'], S.put, v)\n"
        "        self.send(st['out'], S.put, v + 1)\n"
        "        return st\n")
    r = _run_cli(["verify", "vloc", "--json"], cwd=tmp_path)
    assert r.returncode == 1, r.stderr[-500:]
    obj = json.loads(r.stdout.splitlines()[0])
    assert obj["file"].endswith("vloc.py") and obj["line"] == 12


# ---- the selftest sweep: R0–R9 over everything we ship (tier-1) ---------

MODEL_MODULES = ["ring", "ubench", "fanin", "gups", "nbody",
                 "mandelbrot", "records", "spawn_tree"]
PORT = os.path.join(ROOT, "ponyc_tpu_torch")


def test_shipped_trees_lint_clean_pure_ast():
    t0 = time.perf_counter()
    findings, n_types, n_beh = check_paths(
        [os.path.join(ROOT, "examples"),
         os.path.join(PORT, "models"),
         # host-side modules ride the sweep too: no behaviours (or the
         # serving tier's host actors), but the parse + rule walk must
         # stay clean as they grow
         os.path.join(PORT, "tracing.py"),
         os.path.join(PORT, "flight.py"),
         os.path.join(PORT, "metrics.py"),
         os.path.join(PORT, "serialise.py"),
         os.path.join(PORT, "supervise.py"),
         os.path.join(PORT, "testing.py"),
         os.path.join(PORT, "serve.py"),
         os.path.join(PORT, "loadgen.py"),
         os.path.join(PORT, "ops", "megakernel.py"),
         os.path.join(PORT, "costs.py"),
         os.path.join(PORT, "verify.py"),
         os.path.join(PORT, "docgen.py")])
    dt = time.perf_counter() - t0
    assert findings == [], "\n".join(str(f) for f in findings)
    assert n_types >= 25 and n_beh >= 35
    assert dt < 2.0, f"AST sweep took {dt:.2f}s"


@pytest.mark.parametrize("name", MODEL_MODULES)
def test_models_full_lint_r0_to_r9_clean(name):
    mod = importlib.import_module(f"ponyc_tpu_torch.models.{name}")
    findings = lint_module(mod)
    errors = [f for f in findings if f.severity == "error"]
    assert errors == [], "\n".join(str(f) for f in errors)
    assert findings == [], "\n".join(str(f) for f in findings)


# ---- the port against the JAX package ------------------------------------

def _located(findings):
    return [(f.rule, f.severity, f.type_name, f.behaviour, f.file, f.line,
             f.col) for f in findings]


@pytest.mark.parametrize("tree", ["examples", "tests/fixtures/bodycheck",
                                  "ponyc_tpu/models",
                                  "ponyc_tpu_torch/models"])
def test_body_rules_equal_the_jax_package(tree):
    """Files parsed, never imported: the same findings, counts and
    positions from both packages' analyzers."""
    from ponyc_tpu.lint import check_paths as jcheck
    got = check_paths([os.path.join(ROOT, tree)])
    want = jcheck([os.path.join(ROOT, tree)])
    assert _located(got[0]) == _located(want[0])
    assert got[1:] == want[1:]


def test_advice_names_the_ports_idiom():
    """Where the JAX package's advice names jnp.where or lax loops, the
    port's names torch.where and static loops; every other message is
    the JAX package's."""
    from ponyc_tpu.lint import check_path as jcheck
    got, want = check_path(BROKEN), jcheck(BROKEN)
    text = "\n".join(f.message for f in got)
    assert "jnp." not in text and "lax." not in text
    assert "torch.where" in text
    differ = [(g.rule, g.line) for g, w in zip(got, want)
              if g.message != w.message]
    assert {r for r, _ in differ} <= {"R6", "R7"}
    assert len(differ) < len(got)

"""The port's whole-program lint pass (ponyc_tpu_torch/lint ≙
reach/paint + type/safeto run program-wide): the JAX package's
tests/test_lint.py cases on the port (message-flow graph assembly from
probe facts, rule passes R1–R5, suppressions, Program.lint before and
after finalize, the CLI surfaces; its sweep of examples/, whose files
import the JAX package, becomes a sweep of the port's models), then the
port held against the JAX package: equal findings (rule, severity,
type, behaviour, file, line) for every world of the shared programs
(tests/_torch_programs.py), lint_ignore honoured, and docgen's lint
marks equal once the package name is replaced."""

import importlib
import json
import os
import sys
import time

import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu_torch import (Blob, BlobVal, I32, Iso, Program, Ref,
                             RuntimeOptions, actor, behaviour)
from ponyc_tpu_torch.lint import (Finding, findings_to_json,
                                  format_findings, lint_module,
                                  lint_program, lint_types)
from ponyc_tpu_torch.verify import (SendFact, VerifyError,
                                    behaviour_effects, probe_behaviour,
                                    verify_program, when_const)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_programs as tp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def Runtime(opts):
    return ponyc_tpu_torch.Runtime(opts, device="cpu")


# ---- shared fixture types ------------------------------------------------

@actor
class Sink:
    x: I32

    @behaviour
    def put(self, st, v: I32):
        return {**st, "x": v}


@actor
class Feeder:
    out: Ref["Sink"]
    MAX_SENDS = 2
    SPAWNS = {"Sink": 1}

    @behaviour
    def go(self, st, v: I32):
        self.send(st["out"], Sink.put, v)
        self.spawn(Sink.put, v, when=v > 0)
        return st


def rules_of(findings):
    return {f.rule for f in findings}


# ---- probe facts (the tentpole's raw material) ---------------------------

def test_when_const_classification():
    import torch
    assert when_const(True) is True
    assert when_const(False) is False
    assert when_const(1) is True
    assert when_const(torch.tensor(False)) is False   # concrete tensor


def test_probe_records_send_and_spawn_facts():
    ctx = probe_behaviour(Feeder.go)
    kinds = [(f.kind, f.dst_type, f.dst_behaviour, f.when)
             for f in ctx.send_facts]
    # Unconditional send to Sink.put; data-dependent spawn (when=v>0)
    # recorded as kind "spawn" with the USER's mask constness (None).
    assert ("send", "Sink", "put", True) in kinds
    assert ("spawn", "Sink", "put", None) in kinds
    fact = ctx.send_facts[0]
    assert isinstance(fact, SendFact) and fact.target_ref == "Sink"


def test_marks_show_budget_not_observed_count():
    eff = behaviour_effects(Feeder.go)
    assert "sends 2/2" in eff.marks()
    assert "sends≤" not in eff.marks()


# ---- R1 reachability -----------------------------------------------------

def test_r1_unreachable_type_and_behaviour():
    @actor
    class Lonely:
        y: I32

        @behaviour
        def idle(self, st, v: I32):
            return st

    # Un-rooted: any behaviour may be host-injected -> quiet.
    assert lint_types(Feeder, Sink, Lonely) == []
    # Rooted: Lonely is unreachable from Feeder.go.
    fs = lint_types(Feeder, Sink, Lonely, roots=[Feeder.go])
    r1 = [f for f in fs if f.rule == "R1"]
    assert len(r1) == 1 and r1[0].type_name == "Lonely"
    assert r1[0].behaviour is None and r1[0].severity == "warning"

    @actor
    class HalfDead:
        o: Ref["Sink"]
        MAX_SENDS = 1

        @behaviour
        def used(self, st, v: I32):
            self.send(st["o"], Sink.put, v)
            return st

        @behaviour
        def never(self, st, v: I32):
            return st

    fs = lint_types(HalfDead, Sink, roots=[HalfDead.used])
    r1 = [f for f in fs if f.rule == "R1"]
    assert [(f.type_name, f.behaviour) for f in r1] == [
        ("HalfDead", "never")]


def test_r1_quiet_when_cycle_reached_from_root():
    # spawn_tree shape: the root reaches a self-cycle; nothing flagged.
    @actor
    class Tree:
        parent: Ref
        SPAWNS = {"Tree": 2}
        MAX_SENDS = 3

        @behaviour
        def grow(self, st, d: I32, parent: Ref):
            leaf = d <= 0
            self.spawn(Tree.grow, d - 1, self.actor_id, when=~leaf)
            self.spawn(Tree.grow, d - 1, self.actor_id, when=~leaf)
            self.send(parent, Tree.up, when=leaf)
            return st

        @behaviour
        def up(self, st):
            return st

    assert lint_types(Tree, roots=[Tree.grow]) == []


# ---- R2 dead-letter ------------------------------------------------------

def test_r2_send_to_absent_type_is_error():
    fs = lint_types(Feeder)          # Sink NOT in the analysed world
    errs = [f for f in fs if f.rule == "R2" and f.severity == "error"]
    assert len(errs) >= 1
    assert errs[0].type_name == "Feeder" and errs[0].behaviour == "go"
    assert "Sink" in errs[0].message


def test_r2_constant_false_send_is_dead_site():
    @actor
    class DeadSend:
        o: Ref["Sink"]
        MAX_SENDS = 1

        @behaviour
        def go(self, st, v: I32):
            self.send(st["o"], Sink.put, v, when=False)
            return st

    fs = lint_types(DeadSend, Sink)
    assert any(f.rule == "R2" and "when=False" in f.message
               for f in fs)


def test_r2_never_spawned_only_in_rooted_mode():
    @actor
    class Orphaned:
        x: I32

        @behaviour
        def take(self, st, v: I32):
            return {**st, "x": v}

    @actor
    class Talker:
        o: Ref["Orphaned"]
        MAX_SENDS = 1

        @behaviour
        def go(self, st, v: I32):
            self.send(st["o"], Orphaned.take, v)
            return st

    assert lint_types(Talker, Orphaned) == []       # un-rooted: quiet
    fs = lint_types(Talker, Orphaned, roots=[Talker.go])
    r2 = [f for f in fs if f.rule == "R2" and f.type_name == "Orphaned"]
    assert len(r2) == 1 and "no spawn site" in r2[0].message
    assert "Talker.go" in r2[0].message


# ---- R3 capability/race --------------------------------------------------

def test_r3_iso_aliased_into_two_sends():
    @actor
    class Taker:
        x: I32

        @behaviour
        def take(self, st, p: Iso):
            return st

    @actor
    class Aliaser:
        a: Ref["Taker"]
        b: Ref["Taker"]
        MAX_SENDS = 2

        @behaviour
        def go(self, st, p: Iso):
            self.send(st["a"], Taker.take, p)
            self.send(st["b"], Taker.take, p)      # aliased move
            return st

    fs = lint_types(Taker, Aliaser)
    r3 = [f for f in fs if f.rule == "R3"]
    assert len(r3) == 1 and r3[0].severity == "error"
    assert (r3[0].type_name, r3[0].behaviour) == ("Aliaser", "go")
    assert "use-after-move" in r3[0].message


def test_r3_write_to_val_frozen_blob_downstream():
    @actor
    class Scribbler:
        x: I32

        @behaviour
        def scribble(self, st, b: BlobVal):
            self.blob_set(b, 0, 1)        # write to shared-immutable
            return st

    fs = lint_types(Scribbler)
    r3 = [f for f in fs if f.rule == "R3"]
    assert len(r3) == 1 and "frozen (val) blob" in r3[0].message


def test_r3_host_cohort_declares_blob():
    @actor
    class HostReader:
        HOST = True
        n: I32

        @behaviour
        def read(self, st, b: Blob):
            return st

    fs = lint_types(HostReader)
    r3 = [f for f in fs if f.rule == "R3"]
    assert len(r3) == 1 and r3[0].severity == "error"
    assert "HOST" in r3[0].message and r3[0].behaviour == "read"


# ---- R4 amplification ----------------------------------------------------

def _pingpong(yields):
    @actor
    class Ping:
        o: Ref["Pong"]
        MAX_SENDS = 2

        @behaviour
        def ping(self, st, v: I32):
            self.send(st["o"], Pong.pong, v)
            self.send(st["o"], Pong.pong, v)
            return st

    @actor
    class Pong:
        o: Ref["Ping"]
        MAX_SENDS = 1

        @behaviour
        def pong(self, st, v: I32):
            if yields:
                self.yield_(when=v > 7)
            self.send(st["o"], Ping.ping, v)
            return st

    return Ping, Pong


def test_r4_amplifying_cycle_flagged():
    Ping, Pong = _pingpong(yields=False)
    fs = lint_types(Ping, Pong)
    r4 = [f for f in fs if f.rule == "R4"]
    assert len(r4) == 1
    assert (r4[0].type_name, r4[0].behaviour) == ("Ping", "ping")
    assert "2 unconditional messages" in r4[0].message


def test_r4_yield_on_cycle_is_pressure_point():
    Ping, Pong = _pingpong(yields=True)
    assert [f for f in lint_types(Ping, Pong) if f.rule == "R4"] == []


def test_r4_conditional_cycle_not_flagged():
    @actor
    class Careful:
        o: Ref["Careful"]
        MAX_SENDS = 2

        @behaviour
        def go(self, st, v: I32):
            self.send(st["o"], Careful.go, v - 1, when=v > 0)
            self.send(st["o"], Careful.go, v - 2, when=v > 1)
            return st

    assert [f for f in lint_types(Careful) if f.rule == "R4"] == []


# ---- R5 budget feasibility ----------------------------------------------

def test_r5_unconditional_spawn_on_cycle():
    @actor
    class Fork:
        x: I32
        SPAWNS = {"Fork": 1}
        MAX_SENDS = 2

        @behaviour
        def boom(self, st, v: I32):
            self.spawn(Fork.boom, v)
            self.send(self.actor_id, Fork.boom, v)
            return st

    fs = lint_types(Fork)
    r5 = [f for f in fs if f.rule == "R5" and f.severity == "warning"]
    assert len(r5) == 1 and "unconditional spawn" in r5[0].message


def test_r5_blob_leak_on_cycle():
    @actor
    class Leaker:
        x: I32
        MAX_BLOBS = 1
        MAX_SENDS = 1

        @behaviour
        def churn(self, st, v: I32):
            self.blob_alloc(length=1)          # never freed, not frozen
            self.send(self.actor_id, Leaker.churn, v)
            return st

    fs = lint_types(Leaker)
    r5 = [f for f in fs if f.rule == "R5" and f.severity == "warning"]
    assert len(r5) == 1 and "blob" in r5[0].message


def test_r5_unused_budgets_are_info():
    @actor
    class Hoarder:
        x: I32
        SPAWNS = {"Sink": 2}
        MAX_BLOBS = 3

        @behaviour
        def idle(self, st, v: I32):
            return st

    fs = lint_types(Hoarder, Sink)
    infos = [f for f in fs if f.rule == "R5" and f.severity == "info"]
    assert len(infos) == 2          # unused SPAWNS + unused MAX_BLOBS
    # info-severity findings are advisory: the CLI still exits 0.
    assert all(f.severity == "info" for f in fs)


# ---- suppressions --------------------------------------------------------

def test_lint_ignore_suppresses_by_rule():
    @actor
    class Muted:
        x: I32
        SPAWNS = {"Muted": 1}
        MAX_SENDS = 2
        LINT_IGNORE = ("R5",)

        @behaviour
        def boom(self, st, v: I32):
            self.spawn(Muted.boom, v)
            self.send(self.actor_id, Muted.boom, v)
            return st

    assert lint_types(Muted) == []
    kept = lint_types(Muted, include_suppressed=True)
    assert any(f.rule == "R5" for f in kept)


# ---- program-level surfaces ---------------------------------------------

def test_lint_program_and_verify_program_report_host_nodes():
    @actor
    class HostEnd:
        HOST = True
        seen: I32

        @behaviour
        def result(self, st, v: I32):
            return {**st, "seen": st["seen"] + v}

    @actor
    class Dev:
        out: Ref["HostEnd"]
        MAX_SENDS = 1

        @behaviour
        def fin(self, st, v: I32):
            self.send(st["out"], HostEnd.result, v)
            return st

    rt = Runtime(RuntimeOptions(mailbox_cap=8, batch=1, msg_words=2,
                                inject_slots=8))
    rt.declare(Dev, 1).declare(HostEnd, 1).start()
    assert lint_program(rt.program) == []
    report = verify_program(rt.program)
    # Host cohorts are reported (zero-effect entries), not skipped.
    assert "HostEnd" in report and "result" in report["HostEnd"]
    assert report["HostEnd"]["result"].sends == 0
    assert report["Dev"]["fin"].sends == 1


def test_verify_program_raises_on_lint_error_findings():
    @actor
    class MisWired:
        out: Ref                     # untyped: build cannot catch it
        MAX_SENDS = 1

        @behaviour
        def go(self, st, v: I32):
            self.send(st["out"], Sink.put, v)    # Sink never declared
            return st

    p = Program(RuntimeOptions(msg_words=2)).declare(MisWired, 1)
    p.finalize()
    with pytest.raises(VerifyError, match="R2"):
        verify_program(p)
    # ... and lint=False restores the per-behaviour-only pass.
    assert "MisWired" in verify_program(p, lint=False)


def test_program_lint_method_pre_and_post_finalize():
    @actor
    class Bad:
        out: Ref
        MAX_SENDS = 1

        @behaviour
        def go(self, st, v: I32):
            self.send(st["out"], Sink.put, v)    # Sink not declared
            return st

    p = Program(RuntimeOptions(msg_words=2)).declare(Bad, 1)
    assert any(f.rule == "R2" for f in p.lint())     # before finalize
    p.finalize()
    assert any(f.rule == "R2" for f in p.lint())     # and after


def test_docgen_marks_dead_letter_behaviours():
    @actor
    class Wrong:
        out: Ref
        MAX_SENDS = 1

        @behaviour
        def go(self, st, v: I32):
            self.send(st["out"], Sink.put, v)
            return st

    from ponyc_tpu_torch.docgen import document
    p = Program(RuntimeOptions(msg_words=2)).declare(Wrong, 1)
    p.finalize()
    md = document(p)
    assert "> **lint:** R2" in md and "dead-letter" in md
    assert "lint:" not in document(p, lint=False)


# ---- output formats ------------------------------------------------------

def test_finding_formats_are_stable():
    f = Finding("R2", "error", "A", "go", "boom")
    assert str(f).startswith("R2 error")
    obj = json.loads(f.json_line())
    # The stable schema: file/line are null when unknown (col stays
    # internal — the github format uses it).
    assert obj == {"rule": "R2", "severity": "error", "type": "A",
                   "behaviour": "go", "message": "boom",
                   "file": None, "line": None}
    assert format_findings([f]).count("\n") == 0
    assert json.loads(findings_to_json([f, f]).splitlines()[1])
    # Located findings render compiler-style and annotate for GitHub.
    g = Finding("R6", "warning", "A", "go", "boo%m", file="a/b.py",
                line=7, col=3)
    assert str(g).startswith("a/b.py:7: R6 warning")
    assert json.loads(g.json_line())["line"] == 7
    gh = g.github_line()
    assert gh.startswith("::warning file=a/b.py,line=7,col=3,")
    assert gh.endswith("::R6 A.go: boo%25m")


# ---- the models sweep (the port's programs lint clean) ------------------

MODELS_WITHOUT_MODULE_TYPES = {"mixed"}   # built per call (mixed.build)
EXPECTED_MODEL_FINDINGS: dict = {}    # none today; pin regressions here


def _model_names():
    mdir = os.path.join(ROOT, "ponyc_tpu_torch", "models")
    return sorted(f[:-3] for f in os.listdir(mdir)
                  if f.endswith(".py") and not f.startswith("_"))


@pytest.mark.parametrize("name", _model_names())
def test_models_lint_clean(name):
    mod = importlib.import_module(f"ponyc_tpu_torch.models.{name}")
    if name in MODELS_WITHOUT_MODULE_TYPES:
        with pytest.raises(ValueError, match="no concrete actor types"):
            lint_module(mod)
        return
    t0 = time.monotonic()
    findings = lint_module(mod)     # honours the module's LINT_ROOTS
    dt = time.monotonic() - t0
    expected = EXPECTED_MODEL_FINDINGS.get(name, [])
    got = [(f.rule, f.type_name, f.behaviour) for f in findings]
    assert got == expected, format_findings(findings)
    assert dt < 2.0, f"lint of models/{name}.py took {dt:.2f}s"


# ---- CLI -----------------------------------------------------------------

def _run_cli(args, cwd):
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


def test_cli_lint_json_findings_and_exit_codes(tmp_path):
    (tmp_path / "away_mod.py").write_text(
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
        "        return st\n")
    # Linting a module that only re-exports Alone: Away is outside the
    # analysed world, so Alone.go's send is a guaranteed dead letter.
    (tmp_path / "lmod.py").write_text("from away_mod import Alone\n")
    r = _run_cli(["lint", "lmod", "--json"], tmp_path)
    assert r.returncode == 1, r.stderr[-500:]
    objs = [json.loads(line) for line in r.stdout.splitlines()]
    assert any(o["rule"] == "R2" and o["severity"] == "error"
               and o["type"] == "Alone" for o in objs)
    # Human mode prints the summary line and the same exit code.
    r2 = _run_cli(["lint", "lmod"], tmp_path)
    assert r2.returncode == 1 and "lint:" in r2.stdout
    assert "R2" in r2.stdout


def test_cli_verify_distinct_exit_codes_and_json(tmp_path):
    (tmp_path / "empty_mod.py").write_text("X = 1\n")
    (tmp_path / "over_mod.py").write_text(
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
    r = _run_cli(["verify", "empty_mod"], tmp_path)
    assert r.returncode == 3, (r.returncode, r.stderr[-300:])
    assert "no concrete actor types" in r.stderr
    r = _run_cli(["verify", "over_mod", "--json"], tmp_path)
    assert r.returncode == 1, r.stderr[-500:]
    objs = [json.loads(line) for line in r.stdout.splitlines()]
    assert len(objs) == 1 and objs[0]["rule"] == "VERIFY"
    assert objs[0]["type"] == "Over" and objs[0]["severity"] == "error"


# ---- the port against the JAX package ------------------------------------

def _key(findings):
    return [(f.rule, f.severity, f.type_name, f.behaviour, f.file, f.line)
            for f in findings]


def _world(pkg, T, names):
    return [getattr(T, n) for n in names]


@pytest.fixture(scope="module")
def static_pair():
    return tp.define_static(ponyc_tpu_torch), tp.define_static(ponyc_tpu)


@pytest.mark.parametrize("world", sorted(tp.define_static(
    ponyc_tpu_torch).WORLDS))
def test_findings_equal_the_jax_package(static_pair, world):
    from ponyc_tpu.lint import lint_types as jlint
    P, J = static_pair
    names, roots = P.WORLDS[world]
    for inc in (False, True):
        got = lint_types(*_world(ponyc_tpu_torch, P, names), roots=roots,
                         include_suppressed=inc)
        want = jlint(*_world(ponyc_tpu, J, names), roots=roots,
                     include_suppressed=inc)
        assert _key(got) == _key(want), format_findings(got)


@pytest.mark.parametrize("program", ["define", "define_blobs",
                                     "define_telemetry", "define_ops"])
def test_shared_programs_lint_as_the_jax_package(program):
    from ponyc_tpu.lint import lint_types as jlint
    P = getattr(tp, program)(ponyc_tpu_torch)
    J = getattr(tp, program)(ponyc_tpu)
    names = [k for k, v in vars(P).items()
             if isinstance(v, ponyc_tpu_torch.api.ActorTypeMeta)]
    got = lint_types(*(getattr(P, n) for n in names),
                     include_suppressed=True)
    want = jlint(*(getattr(J, n) for n in names), include_suppressed=True)
    assert _key(got) == _key(want)


def test_behaviour_lint_ignore_is_honoured(static_pair):
    """@behaviour(lint_ignore=("R6",)) mutes the body rule R6 on that
    behaviour; the probe's R0 for the same body stays."""
    P, _ = static_pair
    assert P.NeedsValue.branch.lint_ignore == ("R6",)
    fs = lint_types(P.NeedsValue)
    assert ("R6", "branch") not in {(f.rule, f.behaviour) for f in fs}
    kept = lint_types(P.NeedsValue, include_suppressed=True)
    assert ("R6", "branch") in {(f.rule, f.behaviour) for f in kept}
    assert ("R0", "branch") in {(f.rule, f.behaviour) for f in fs}


def test_program_lint_equals_the_jax_package(static_pair):
    P, J = static_pair
    out = []
    for pkg, T in ((ponyc_tpu_torch, P), (ponyc_tpu, J)):
        p = pkg.Program(pkg.RuntimeOptions(msg_words=2))
        p.declare(T.MisWired, 1).declare(T.Quiet, 2)
        before = _key(p.lint())
        p.finalize()
        out.append((before, _key(p.lint()),
                    _key(importlib.import_module(pkg.__name__ + ".lint")
                         .lint_program(p))))
    assert out[0] == out[1]
    assert any(k[0] == "R2" and k[1] == "error" for k in out[0][0])


def test_docgen_lint_marks_equal_the_jax_package(static_pair):
    P, J = static_pair
    docs = []
    for pkg, T in ((ponyc_tpu_torch, P), (ponyc_tpu, J)):
        p = pkg.Program(pkg.RuntimeOptions(msg_words=2))
        p.declare(T.MisWired, 1).declare(T.Fork, 4).declare(T.Quiet, 2)
        p.finalize()
        dg = importlib.import_module(pkg.__name__ + ".docgen")
        docs.append(dg.document(p, title="Static").replace(
            pkg.__name__, "PKG"))
    assert docs[0] == docs[1]
    assert "> **lint:** R2" in docs[0] and "R5 [warning]" in docs[0]

"""The port's verify pass (ponyc_tpu_torch/verify.py ≙ verify/fun.c):
the JAX package's tests/test_verify.py cases on the port (effect
signatures by probe tracing over meta tensors, budget enforcement,
docgen marks, the CLI command), then the port held against the JAX
package: equal Effects and marks() for every behaviour of the shared
programs (tests/_torch_programs.py) and of the ring, ubench and
spawn-tree models, when= masks classified alike, bodies that need a
traced value failing verify in both packages without crashing the
sweep, and a body drawing from stdlib.random probing cleanly."""

import dataclasses
import importlib.util
import os
import sys
import types

import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu_torch import (I32, Ref, RuntimeOptions, actor,
                             behaviour)
from ponyc_tpu_torch.verify import (VerifyError, behaviour_effects,
                                    verify_behaviour, verify_program)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_programs as tp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def Runtime(opts):
    return ponyc_tpu_torch.Runtime(opts, device="cpu")


@actor
class Quiet:
    x: I32

    @behaviour
    def set(self, st, v: I32):
        return {**st, "x": v}


@actor
class Busy:
    out: Ref["Quiet"]
    MAX_SENDS = 2
    SPAWNS = {"Quiet": 1}

    @behaviour
    def go(self, st, v: I32):
        self.send(st["out"], Quiet.set, v)
        self.spawn(Quiet.set, v, when=v > 0)
        self.error_int(7, when=v < 0)
        self.exit(0, when=v == 0)
        return st

    @behaviour
    def lazy(self, st, v: I32):
        self.yield_(when=v > 3)
        self.destroy(when=v > 9)
        return st


def test_effect_signatures():
    eff = behaviour_effects(Quiet.set)
    assert eff.sends == 0 and not eff.can_error and not eff.can_exit
    assert eff.marks() == ""

    eff = behaviour_effects(Busy.go)
    assert eff.sends == 2          # explicit send + the spawn's ctor msg
    assert eff.can_error and eff.can_exit
    assert eff.spawns == (("Quiet", 1),)
    assert "may error" in eff.marks() and "spawns Quiet×1" in eff.marks()

    eff = behaviour_effects(Busy.lazy)
    assert eff.can_yield and eff.can_destroy and eff.sends == 0


def test_budget_violation_fails_verify():
    @actor
    class OverBudget:
        out: Ref["Quiet"]
        MAX_SENDS = 1

        @behaviour
        def go(self, st, v: I32):
            self.send(st["out"], Quiet.set, v)
            self.send(st["out"], Quiet.set, v + 1)
            return st

    with pytest.raises(VerifyError, match="MAX_SENDS=1"):
        verify_behaviour(OverBudget.go)


def test_verify_program_reports_all_device_cohorts():
    rt = Runtime(RuntimeOptions(mailbox_cap=8, batch=1, max_sends=2,
                                msg_words=2, inject_slots=8))
    rt.declare(Busy, 1).declare(Quiet, 4).start()
    report = verify_program(rt.program)
    assert set(report) == {"Busy", "Quiet"}
    assert report["Busy"]["go"].can_error
    assert not report["Quiet"]["set"].can_error


def test_docgen_carries_effect_marks():
    from ponyc_tpu_torch.docgen import document_type
    md = document_type(Busy)
    assert "may error" in md and "spawns Quiet×1" in md


def test_host_behaviours_report_no_device_effects():
    @actor
    class H:
        HOST = True
        n: I32

        @behaviour
        def tick(self, st, v: I32):
            return {**st, "n": st["n"] + 1}

    eff = behaviour_effects(H.tick)
    assert eff.marks() == ""


def test_budget_matches_engine_resolution():
    """Budgets resolve exactly as program build does (review finding):
    opts.max_sends is the fallback, MAX_SENDS=0 is falsy -> fallback."""
    @actor
    class ThreeSends:
        out: Ref["Quiet"]

        @behaviour
        def go(self, st, v: I32):
            self.send(st["out"], Quiet.set, v)
            self.send(st["out"], Quiet.set, v)
            self.send(st["out"], Quiet.set, v)
            return st

    # opts.max_sends=3 -> fine, exactly like the engine
    rt = Runtime(RuntimeOptions(mailbox_cap=8, batch=1, max_sends=3,
                                msg_words=2, inject_slots=8))
    rt.declare(ThreeSends, 1).declare(Quiet, 1).start()
    report = verify_program(rt.program)
    assert report["ThreeSends"]["go"].sends == 3
    # standalone default (2) rejects the same behaviour
    with pytest.raises(VerifyError):
        verify_behaviour(ThreeSends.go)
    # ... unless told the real default
    assert verify_behaviour(ThreeSends.go, default_max_sends=3).sends == 3


def test_string_spawns_target_probes_clean():
    """String-form SPAWNS targets with spawn_sync must probe without a
    bogus state-dict error (review finding: the ctor is claim-only in
    the probe)."""
    @actor
    class SKid:
        x: I32

        @behaviour
        def init(self, st, v: I32):
            return {**st, "x": v}

    @actor
    class SParent:
        MAX_SENDS = 1
        SPAWNS = {"SKid": 1}

        @behaviour
        def make(self, st, v: I32):
            self.spawn_sync(SKid.init, v)
            return st

    eff = behaviour_effects(SParent.make)
    assert eff.sync_spawns == ("SKid",)


def test_cli_verify_reports_fail_lines(tmp_path):
    import subprocess
    mod = tmp_path / "vmod.py"
    mod.write_text(
        "from ponyc_tpu_torch import I32, Ref, actor, behaviour\n"
        "@actor\n"
        "class Sink:\n"
        "    x: I32\n"
        "    @behaviour\n"
        "    def put(self, st, v: I32):\n"
        "        return {**st, 'x': v}\n"
        "@actor\n"
        "class Bad:\n"
        "    out: Ref['Sink']\n"
        "    MAX_SENDS = 1\n"
        "    @behaviour\n"
        "    def go(self, st, v: I32):\n"
        "        self.send(st['out'], Sink.put, v)\n"
        "        self.send(st['out'], Sink.put, v)\n"
        "        return st\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-m", "ponyc_tpu_torch", "verify",
                        "vmod"], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 1, r.stderr[-500:]
    assert "FAIL Bad.go" in r.stdout and "ok   Sink.put" in r.stdout


# ---- the port against the JAX package ------------------------------------

def _effects(bdef, **kw):
    """(Effects as a tuple, marks) of one behaviour, or the failure."""
    mod = ponyc_tpu_torch if isinstance(
        bdef, ponyc_tpu_torch.api.BehaviourDef) else ponyc_tpu
    try:
        eff = importlib.import_module(mod.__name__ + ".verify") \
            .behaviour_effects(bdef, **kw)
    except (TypeError, RuntimeError) as e:
        return ("fails", "capability:" in str(e), "sendability:" in str(e))
    return dataclasses.astuple(eff), eff.marks()


def _types(ns):
    return {k: v for k, v in vars(ns).items()
            if isinstance(v, (ponyc_tpu.api.ActorTypeMeta,
                              ponyc_tpu_torch.api.ActorTypeMeta))}


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_pairs():
    out = []
    for name in ("ring", "ubench"):
        out.append((importlib.import_module(f"ponyc_tpu_torch.models.{name}"),
                    importlib.import_module(f"ponyc_tpu.models.{name}")))
    out.append((importlib.import_module("ponyc_tpu_torch.models.spawn_tree"),
                _load_example("spawn_tree")))
    return [(getattr(p, k), getattr(j, k)) for p, j in out
            for k in dir(p)
            if isinstance(getattr(p, k), ponyc_tpu_torch.api.ActorTypeMeta)
            and getattr(p, k).behaviour_defs]


PROGRAMS = {
    "define": tp.define,
    "define_blobs": tp.define_blobs,
    "define_telemetry": tp.define_telemetry,
    "define_ops": tp.define_ops,
    "define_static": tp.define_static,
    "define_random": lambda pkg: types.SimpleNamespace(
        RandPinger=tp.define_random(pkg, 16)),
}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_effects_and_marks_equal_the_jax_package(program):
    port = _types(PROGRAMS[program](ponyc_tpu_torch))
    ref = _types(PROGRAMS[program](ponyc_tpu))
    assert sorted(port) == sorted(ref)
    n = 0
    for name, T in port.items():
        for bp, bj in zip(T.behaviour_defs, ref[name].behaviour_defs):
            assert bp.name == bj.name
            for kw in ({}, {"default_max_sends": 3}):
                assert _effects(bp, **kw) == _effects(bj, **kw), \
                    f"{name}.{bp.name} {kw}"
            n += 1
    assert n >= 1


def test_models_effects_equal_the_jax_package():
    pairs = _model_pairs()
    assert {p.__name__ for p, _ in pairs} == {"RingNode", "Pinger", "Node"}
    for P, J in pairs:
        for bp, bj in zip(P.behaviour_defs, J.behaviour_defs):
            assert _effects(bp) == _effects(bj), f"{P.__name__}.{bp.name}"


def test_when_masks_classify_as_the_jax_package():
    """Python and NumPy values are constant; a mask from a field or an
    argument, and a 0-dim constant built inside the body, are not."""
    from ponyc_tpu.verify import probe_behaviour as jprobe
    from ponyc_tpu_torch.verify import probe_behaviour, when_const
    P, J = tp.define_static(ponyc_tpu_torch), tp.define_static(ponyc_tpu)
    got = [f.when for f in probe_behaviour(P.Masks.go).send_facts]
    assert got == [f.when for f in jprobe(J.Masks.go).send_facts]
    assert got == [True, True, None, None, None, False]
    import torch
    assert when_const(torch.tensor(False)) is False     # a concrete tensor
    assert when_const(torch.zeros((), device="meta").bool()) is None


def test_bodies_needing_a_value_fail_verify_in_both_packages(tmp_path):
    """.item() and `if` on a traced value fail the probe in both
    packages; the CLI reports each as a FAIL line and goes on."""
    for pkg in (ponyc_tpu_torch, ponyc_tpu):
        T = tp.define_static(pkg)
        v = importlib.import_module(pkg.__name__ + ".verify")
        for bdef in T.NeedsValue.behaviour_defs:
            with pytest.raises(TypeError):
                v.verify_behaviour(bdef)
    with pytest.raises(TypeError, match="needs a tensor's value"):
        verify_behaviour(tp.define_static(ponyc_tpu_torch)
                         .NeedsValue.branch)
    import subprocess
    (tmp_path / "nvmod.py").write_text(
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import ponyc_tpu_torch\n"
        "import _torch_programs as tp\n"
        "T = tp.define_static(ponyc_tpu_torch)\n"
        "NeedsValue, Quiet = T.NeedsValue, T.Quiet\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-m", "ponyc_tpu_torch", "verify",
                        "nvmod"], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 1, r.stderr[-500:]
    assert "FAIL NeedsValue.item" in r.stdout
    assert "FAIL NeedsValue.branch" in r.stdout
    assert "ok   Quiet.set" in r.stdout


def test_stdlib_random_body_probes_cleanly():
    P = tp.define_random(ponyc_tpu_torch, 16)
    eff = verify_behaviour(P.ping)
    assert eff.sends == 1 and eff.marks() == "sends 1/1"


def test_verify_program_budget_resolves_as_the_engine():
    """verify_program's budget is the cohort's, resolved as the engine
    resolves it (MAX_SENDS, else opts.max_sends), in both packages."""
    for pkg in (ponyc_tpu_torch, ponyc_tpu):
        T = tp.define_static(pkg)
        v = importlib.import_module(pkg.__name__ + ".verify")
        kw = {"device": "cpu"} if pkg is ponyc_tpu_torch else {}
        rt = pkg.Runtime(pkg.RuntimeOptions(
            mailbox_cap=8, batch=1, max_sends=3, msg_words=2,
            inject_slots=8), **kw)
        rt.declare(T.ThreeSends, 1).declare(T.Quiet, 1).start()
        rep = v.verify_program(rt.program)
        assert rep["ThreeSends"]["go"].sends == 3
        assert rep["ThreeSends"]["go"].max_sends == 3
        assert rt.program.cohorts[0].max_sends == 3

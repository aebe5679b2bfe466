"""The port's plugin hooks and docgen (≙ src/libponyc/plugin/plugin.c
hook protocol and pass/docgen.c output): the JAX package's
tests/test_plugin_docgen.py cases on the port, then the port held
against the JAX package: the hooks run in the same order, the two
packages' registries are apart, and the generated docs (verify's effect
marks and lint's notes included) equal the JAX package's once the
package name is replaced."""

import importlib
import os
import sys

import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu_torch import I32, Ref, RuntimeOptions, actor, behaviour
from ponyc_tpu_torch import docgen, plugin

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_programs as tp  # noqa: E402


def Runtime(opts):
    return ponyc_tpu_torch.Runtime(opts, device="cpu")


@actor
class Worker:
    """Crunches numbers for the supervisor."""
    boss: Ref
    done: I32

    @behaviour
    def init(self, st, boss: Ref, job: I32):
        """Constructor: remember the boss."""
        return {**st, "boss": boss}


@pytest.fixture(autouse=True)
def _clean_plugins():
    from ponyc_tpu import plugin as jplugin
    plugin.unregister_all()
    jplugin.unregister_all()
    yield
    plugin.unregister_all()
    jplugin.unregister_all()


def test_plugin_hooks_run_in_order():
    calls = []

    class P:
        name = "probe"

        def init(self, program):
            calls.append(("init", program.total))

        def visit_cohort(self, program, cohort):
            calls.append(("visit", cohort.atype.__name__))

        def finalize(self, program):
            calls.append(("finalize", len(program.behaviour_table)))

        def help(self):
            return "records build phases"

        def parse_options(self, argv):
            return [a for a in argv if a != "--probe"]

    plugin.register(P())
    rt = Runtime(RuntimeOptions(msg_words=2)).declare(Worker, 4)
    rt.start()
    assert calls == [("init", 4), ("visit", "Worker"), ("finalize", 1)]
    assert plugin.parse_options(["x", "--probe", "y"]) == ["x", "y"]
    assert "records build phases" in plugin.help_text()


def test_plugin_load_by_import_path(tmp_path, monkeypatch):
    # A module name of its own: the JAX package's test of the same case
    # imports a `fake_plug` that may already sit in sys.modules.
    monkeypatch.delitem(sys.modules, "fake_plug_torch", raising=False)
    (tmp_path / "fake_plug_torch.py").write_text(
        "class Plugin:\n"
        "    name = 'fake'\n"
        "    seen = []\n"
        "    def finalize(self, program):\n"
        "        Plugin.seen.append(program.total)\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    p = plugin.load("fake_plug_torch")
    Runtime(RuntimeOptions(msg_words=2)).declare(Worker, 2).start()
    assert type(p).seen == [2]


def test_docgen_program_and_tree(tmp_path):
    rt = Runtime(RuntimeOptions(msg_words=2)).declare(Worker, 4)
    rt.start()
    md = docgen.document(rt.program, title="Demo")
    assert "# Demo" in md
    assert "## actor Worker" in md
    assert "Crunches numbers" in md
    assert "be init(boss: Ref, job: I32)" in md
    assert "Constructor: remember the boss." in md
    assert "| boss | Ref |" in md
    files = docgen.write_tree(rt.program, str(tmp_path / "docs"))
    assert os.path.exists(tmp_path / "docs" / "Worker.md")
    assert os.path.exists(tmp_path / "docs" / "index.md")
    idx = (tmp_path / "docs" / "index.md").read_text()
    assert "[Worker](Worker.md)" in idx
    assert len(files) == 2


# ---- the port against the JAX package ------------------------------------

class _Recorder:
    name = "recorder"

    def __init__(self):
        self.calls = []

    def init(self, program):
        self.calls.append(("init", program.total))

    def visit_cohort(self, program, cohort):
        self.calls.append(("visit", cohort.atype.__name__))

    def finalize(self, program):
        self.calls.append(("finalize", len(program.behaviour_table)))


def _build(pkg, T):
    kw = {"device": "cpu"} if pkg is ponyc_tpu_torch else {}
    rt = pkg.Runtime(pkg.RuntimeOptions(msg_words=2, mailbox_cap=8,
                                        inject_slots=8), **kw)
    rt.declare(T.Busy, 2).declare(T.Quiet, 4).declare(T.Dev, 1)
    rt.declare(T.HostEnd, 1)
    return rt.start()


def test_hooks_run_in_the_jax_packages_order_and_registries_are_apart():
    from ponyc_tpu import plugin as jplugin
    P, J = tp.define_static(ponyc_tpu_torch), tp.define_static(ponyc_tpu)
    port, ref, other = _Recorder(), _Recorder(), _Recorder()
    plugin.register(port)
    jplugin.register(ref)
    _build(ponyc_tpu_torch, P)
    assert ref.calls == []            # a JAX plugin never runs in the port
    _build(ponyc_tpu, J)
    assert port.calls == ref.calls
    assert [c[0] for c in port.calls] == ["init", "visit", "visit",
                                          "visit", "visit", "finalize"]
    jplugin.register(other)
    _build(ponyc_tpu_torch, P)
    assert other.calls == []


def test_docgen_equals_the_jax_package(tmp_path):
    P, J = tp.define_static(ponyc_tpu_torch), tp.define_static(ponyc_tpu)
    rts = (_build(ponyc_tpu_torch, P), _build(ponyc_tpu, J))
    out = []
    for pkg, rt in zip((ponyc_tpu_torch, ponyc_tpu), rts):
        dg = importlib.import_module(pkg.__name__ + ".docgen")
        md = dg.document(rt.program, title="Static")
        one = dg.document_types(P.Busy if pkg is ponyc_tpu_torch
                                else J.Busy, P.Masks if pkg is
                                ponyc_tpu_torch else J.Masks)
        files = dg.write_tree(rt.program, str(tmp_path / pkg.__name__))
        tree = [open(f).read() for f in files]
        out.append([t.replace(pkg.__name__, "PKG")
                    for t in [md, one] + tree])
    assert out[0] == out[1]
    assert "*effects: sends 2/2, spawns Quiet×1, may error, may exit*" \
        in out[0][0]

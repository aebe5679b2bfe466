"""The PyTorch port stands alone: importing it (the window kernel's
module, the standard library, files, process and the `run` verb
included), running a ring with the plain window and with
delivery="pallas_mega", a body drawing from stdlib.random through
both kernels' lane code, and the program's account of itself (cost
capture, benching, verify, lint, docgen, plugins, translate and their
verbs) pulls in no JAX and nothing of the JAX package;
it runs on CUDA unless the caller asks for the CPU; and options this
slice does not serve raise NotImplementedError instead of falling
back."""

import json
import os
import subprocess
import sys

import pytest
import torch

import ponyc_tpu_torch
from ponyc_tpu_torch import Runtime, RuntimeOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import importlib, json, os, sys
sys.path.insert(0, "tests")
import ponyc_tpu_torch
from ponyc_tpu_torch import RuntimeOptions
from ponyc_tpu_torch.models import ring
import ponyc_tpu_torch.ops.megakernel
from ponyc_tpu_torch import files, process, stdlib
from ponyc_tpu_torch.__main__ import cmd_run
import _torch_programs as tp
for delivery in ("plan", "pallas_mega"):
    rt = ring.run(32, 40, opts=RuntimeOptions(mailbox_cap=4, batch=1,
                  max_sends=1, msg_words=1, spill_cap=32, inject_slots=4,
                  tuning_cache="off", delivery=delivery), device="cpu")
mods = sorted(f[:-3] for f in os.listdir("ponyc_tpu_torch/stdlib")
              if f.endswith(".py") and f != "__init__.py")
for m in mods:
    importlib.import_module("ponyc_tpu_torch.stdlib." + m)
visits = []       # stdlib.random in a body, through both kernels' lane code
for kw in ({"pallas_fused": True}, {"delivery": "pallas_mega"}):
    P = tp.define_random(ponyc_tpu_torch, 16)
    rp = tp.randping_build(ponyc_tpu_torch, P, 16, 4, **kw)
    rp.run()
    visits.append(int(rp.cohort_state(P)["visits"].sum()))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ponyc_tpu" or m.startswith("ponyc_tpu."))
print(json.dumps({"bad": bad, "code": rt.exit_code,
                  "passes": int(rt.cohort_state(ring.RingNode)
                                ["passes"].sum()),
                  "stdlib_modules": len(mods), "visits": visits}))
"""


_OPS_CHILD = """
import json, sys, tempfile
import ponyc_tpu_torch.flight, ponyc_tpu_torch.metrics
from ponyc_tpu_torch.__main__ import main
from ponyc_tpu_torch import RuntimeOptions
from ponyc_tpu_torch.models import ring
path = tempfile.mkdtemp() + "/an.csv"
rt = ring.run(8, 20, opts=RuntimeOptions(
    mailbox_cap=4, batch=1, max_sends=1, msg_words=1, spill_cap=32,
    inject_slots=4, tuning_cache="off", analysis=1, metrics_port=0,
    watchdog_s=5.0, analysis_path=path), device="cpu")
rt.stop(postmortem=True)
codes = [main(["doctor", "--postmortem", path + ".postmortem.json"]),
         main(["version"])]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ponyc_tpu" or m.startswith("ponyc_tpu."))
print(json.dumps({"bad": bad, "codes": codes}))
"""


_STATIC_CHILD = """
import contextlib, io, json, os, sys, tempfile
import ponyc_tpu_torch
from ponyc_tpu_torch import (RuntimeOptions, benching, costs, docgen,
                             plugin, verify)
from ponyc_tpu_torch import lint, translate
from ponyc_tpu_torch.lint import bodycheck, facts, graph, rules
from ponyc_tpu_torch.ops import census
from ponyc_tpu_torch.translate import (c_header, c_header_export,
                                       json_schema, text_resource)
from ponyc_tpu_torch.__main__ import main
from ponyc_tpu_torch.models import ring, ubench
from ponyc_tpu_torch.stdlib import pkg
d = tempfile.mkdtemp()
rt, ids = ring.build(8, RuntimeOptions(
    mailbox_cap=4, batch=1, max_sends=1, msg_words=1, spill_cap=32,
    inject_slots=4, tuning_cache="off", cost_capture=True), device="cpu")
rep = verify.verify_program(rt.program)
found = lint.lint_program(rt.program) + rt.program.lint()
md = docgen.document(rt.program)
hdr = translate.export_header(rt.program, rt.opts)
b = pkg.use("ponybench").BenchRunner(min_window_s=0.001, out=io.StringIO())
b.bench("add", lambda: 1 + 1)
with contextlib.redirect_stdout(io.StringIO()):
    codes = [main(["verify", "ponyc_tpu_torch.models.ubench"]),
             main(["lint", "ponyc_tpu_torch.models.ubench"]),
             main(["doc", "ponyc_tpu_torch.models.ubench", "-o", d]),
             main(["lint", "examples"])]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ponyc_tpu" or m.startswith("ponyc_tpu."))
print(json.dumps({"bad": bad, "codes": codes, "verified": sorted(rep),
                  "findings": len(found), "measured": sorted(
                      rt._costs["executables"]),
                  "doc": "## actor RingNode" in md,
                  "header": "PONYC_TPU_GID_RINGNODE_TOKEN" in hdr}))
"""


def test_static_checks_and_costs_import_no_jax_and_no_reference():
    """Slice 13's modules (costs, the census, benching, verify, lint,
    docgen, plugin, translate) and the verify, lint and doc verbs,
    driven through a ring with cost capture on, pull in no JAX and
    nothing of the JAX package."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _STATIC_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "codes": [0, 0, 0, 0],
                   "verified": ["RingNode"], "findings": 0,
                   "measured": ["step", "window"], "doc": True,
                   "header": True}


def test_observability_modules_import_no_jax_and_no_reference():
    """flight.py, metrics.py and __main__.py, driven through a run with
    the watchdog and the exporter on and the doctor, pull in no JAX and
    nothing of the JAX package."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _OPS_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "codes": [0, 0]}


_DURABLE_CHILD = """
import json, os, subprocess, sys, tempfile
import ponyc_tpu_torch.serialise, ponyc_tpu_torch.supervise
import ponyc_tpu_torch.testing
from ponyc_tpu_torch import RuntimeOptions, serialise, supervise
from ponyc_tpu_torch.models import ring
d = tempfile.mkdtemp()
opts = RuntimeOptions(mailbox_cap=4, batch=1, max_sends=1, msg_words=1,
                      spill_cap=32, inject_slots=4, tuning_cache="off",
                      checkpoint_every_s=0.01, checkpoint_path=d + "/ring",
                      analysis_path=d + "/an.csv")
rt, ids = ring.build(8, opts, device="cpu")
rt.send(int(ids[0]), ring.RingNode.token, 40)
rt.run(max_steps=9)
serialise.save(rt, d + "/w.npz")
rt2, _ = ring.build(8, opts, device="cpu")
serialise.restore(rt2, d + "/w.npz")
code = rt2.run()
rt2.stop()
child = d + "/child.py"
with open(child, "w") as f:
    f.write("import sys; sys.path.insert(0, %r)\\n" % os.getcwd()
            + "from ponyc_tpu_torch import RuntimeOptions, supervise\\n"
            + "from ponyc_tpu_torch.models import ring\\n"
            + "rt, ids = ring.build(8, RuntimeOptions(tuning_cache='off', "
            + "checkpoint_every_s=1.0, checkpoint_path=%r, "
            % (d + "/sup")
            + "analysis_path=%r), device='cpu')\\n" % (d + "/c.csv")
            + "if supervise.maybe_restore(rt) is None:\\n"
            + "    rt.send(int(ids[0]), ring.RingNode.token, 16)\\n"
            + "code = rt.run(); rt.stop()\\n"
            + "bad = [m for m in sys.modules if m == 'jax' or "
            + "m.startswith(('jax.', 'jaxlib')) or m == 'ponyc_tpu' or "
            + "m.startswith('ponyc_tpu.')]\\n"
            + "sys.exit(3 if bad else code)\\n")
sup = supervise.Supervisor(argv=[sys.executable, child],
                           prefix=d + "/sup", retries=0)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ponyc_tpu" or m.startswith("ponyc_tpu."))
print(json.dumps({"bad": bad, "code": code, "child": sup.run(),
                  "passes": int(rt2.cohort_state(ring.RingNode)
                                ["passes"].sum())}))
"""


def test_durability_modules_import_no_jax_and_no_reference():
    """serialise.py, supervise.py and testing.py, driven through a
    checkpointed run, a save/restore round trip and a supervised child
    on the CPU, pull in no JAX and nothing of the JAX package (in the
    parent and in the child)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _DURABLE_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "code": 0, "child": 0, "passes": 40}


_SERVE_CHILD = """
import json, sys, threading
import ponyc_tpu_torch.native, ponyc_tpu_torch.bridge, ponyc_tpu_torch.net
import ponyc_tpu_torch.net.dns, ponyc_tpu_torch.net.tls
from ponyc_tpu_torch import loadgen, serve
from ponyc_tpu_torch.models import mandelbrot
from ponyc_tpu_torch import RuntimeOptions
import dataclasses
img = mandelbrot.render(16, 8, dataclasses.replace(
    mandelbrot.default_options(), tuning_cache="off", pallas_fused=True),
    device="cpu")
opts = dataclasses.replace(serve.default_options(4), tuning_cache="off")
rt, server = serve.build(4, opts, device="cpu")
port = server.listen("127.0.0.1", 0)
out = {}
def client():
    out["r"] = loadgen.run_load("127.0.0.1", port, conns=1, depth=2,
                                requests=6)
    server.begin_drain()
t = threading.Thread(target=client, daemon=True)
t.start()
code = rt.run()
t.join(30)
rt.stop()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ponyc_tpu" or m.startswith("ponyc_tpu."))
print(json.dumps({"bad": bad, "code": code, "ok": out["r"]["ok"],
                  "img": bool((img == mandelbrot.reference_bytes(16, 8))
                              .all())}))
"""


def test_serving_modules_import_no_jax_and_no_reference():
    """native/, bridge/, net/ (dns, tls), serve.py, loadgen.py and the
    mandelbrot model, driven through a served request stream and a fused
    render, pull in no JAX and nothing of the JAX package."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _SERVE_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "code": 0, "ok": 6, "img": True}


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "code": 0, "passes": 40, "stdlib_modules": 24,
                   "visits": [256, 256]}


def test_default_device_is_cuda_and_never_silently_cpu():
    opts = RuntimeOptions(tuning_cache="off")
    if torch.cuda.is_available():
        assert Runtime(opts).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Runtime(opts)
    assert Runtime(opts, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw,slice_no", [
    (dict(mesh_shards=2), 10),
    (dict(cost_capture=True), 11),
    (dict(cost_capture=True, watchdog_s=1.0), 11),
])
def test_unported_options_raise(kw, slice_no):
    """An option of a slice still in PORT_SLICES raises naming it; slice
    11's cost capture is served since slice 13, so its options start."""
    from ponyc_tpu_torch.config import PORT_SLICES
    from ponyc_tpu_torch.models import ring
    if slice_no in {n for _, n in PORT_SLICES.values()}:
        with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
            Runtime(RuntimeOptions(**kw), device="cpu")
        return
    rt = Runtime(RuntimeOptions(tuning_cache="off", **kw), device="cpu")
    rt.declare(ring.RingNode, 4).start()
    try:
        assert set(rt._costs["executables"]) == {"step", "window"}
    finally:
        rt.stop()


def test_cost_capture_raises_by_name():
    """Only the mesh is left in PORT_SLICES, and its error names it;
    cost capture starts and measured_costs() returns its record."""
    from ponyc_tpu_torch.config import PORT_SLICES
    assert list(PORT_SLICES) == ["mesh"]
    with pytest.raises(NotImplementedError,
                       match=r"mesh sharding \(mesh_shards > 1\).*"
                             r"slice 10"):
        Runtime(RuntimeOptions(mesh_shards=2), device="cpu")
    from ponyc_tpu_torch.models import ring
    rt, _ = ring.build(4, RuntimeOptions(tuning_cache="off",
                                         cost_capture=True), device="cpu")
    assert rt.measured_costs() is rt._costs
    assert "model_divergence" in rt._costs


def test_observability_options_are_served(tmp_path):
    """watchdog_s, metrics_port and pin start (slice 11)."""
    import os
    cores = sorted(os.sched_getaffinity(0))
    rt = Runtime(RuntimeOptions(watchdog_s=5.0, metrics_port=0,
                                pin=cores[-1], tuning_cache="off",
                                analysis_path=str(tmp_path / "a.csv")),
                 device="cpu")
    try:
        from ponyc_tpu_torch.models import ring
        rt.declare(ring.RingNode, 4).start()
        assert os.sched_getaffinity(0) == {cores[-1]}
        assert rt._watchdog.is_alive() and rt._metrics.port > 0
    finally:
        if rt._pre_pin_affinity is not None:
            os.sched_setaffinity(0, rt._pre_pin_affinity)
        rt.stop()
    assert sorted(os.sched_getaffinity(0)) == cores
    with pytest.raises(ValueError, match="cannot pin"):
        Runtime(RuntimeOptions(pin=4096, tuning_cache="off"),
                device="cpu").start()


def test_unported_program_features_raise():
    @ponyc_tpu_torch.actor
    class HostSide:
        HOST = True
        x: ponyc_tpu_torch.I32

        @ponyc_tpu_torch.behaviour
        def go(self, st):
            return {**st, "x": st["x"] + 1}

    # Host cohorts are served since slice 5: such a program starts and
    # its host behaviour runs.
    rt = Runtime(RuntimeOptions(tuning_cache="off"), device="cpu")
    rt.declare(HostSide, 2)
    rt.start()
    h = rt.spawn(HostSide)
    rt.send(h, HostSide.go)
    assert rt.run() == 0 and rt.state_of(h) == {"x": 1}

    @ponyc_tpu_torch.actor
    class Pooled:
        x: ponyc_tpu_torch.I32

        @ponyc_tpu_torch.behaviour
        def go(self, st):
            self.blob_alloc(4)
            return st

    # The blob pool is served since slice 7, and a body that uses it
    # with the pool off raises at its first tick, naming the options.
    rt = Runtime(RuntimeOptions(tuning_cache="off"), device="cpu")
    rt.declare(Pooled, 2)
    rt.start()
    rt.send(rt.spawn(Pooled), Pooled.go)
    with pytest.raises(RuntimeError, match="blob pool is disabled"):
        rt.run()

    @ponyc_tpu_torch.actor
    class Spawner:
        x: ponyc_tpu_torch.I32
        SPAWNS = {"Spawner": 1}

        @ponyc_tpu_torch.behaviour
        def go(self, st):
            return st

    # Device spawns are served since slice 4: such a program starts.
    rt = Runtime(RuntimeOptions(tuning_cache="off"), device="cpu")
    rt.declare(Spawner, 2)
    rt.start()


def test_pallas_option_is_accepted():
    # The drain is always the CUDA kernel on the card and the plain
    # version on the CPU, whatever `pallas` says.
    for v in (False, True, "auto"):
        Runtime(RuntimeOptions(pallas=v), device="cpu")


def test_in_place_update_in_a_body_raises():
    @ponyc_tpu_torch.actor
    class Bumper:
        n: ponyc_tpu_torch.I32

        @ponyc_tpu_torch.behaviour
        def bump(self, st):
            st["n"] += 1           # in place: would leak into other lanes
            return st

    rt = Runtime(RuntimeOptions(tuning_cache="off"), device="cpu")
    rt.declare(Bumper, 4)
    rt.start()
    ids = rt.spawn_many(Bumper, 4)
    rt.send(int(ids[0]), Bumper.bump)
    with pytest.raises(TypeError, match="in place"):
        rt.run()


def test_no_module_of_the_port_imports_jax_or_the_reference():
    """Static check over every source of the port and the scripts that
    drive it on the card: no import of jax or of ponyc_tpu, at any
    depth (function-local imports included)."""
    import ast
    from pathlib import Path
    root = Path(REPO)
    files = sorted((root / "ponyc_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py", root / "profiling" / "torch_tick.py",
        root / "profiling" / "torch_mega_phases.py",
        root / "profiling" / "torch_ops.py",
        root / "profiling" / "serve_overload.py"]
    assert len(files) > 10
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "ponyc_tpu"):
                    bad.append(f"{f.relative_to(root)}: {n}")
    assert bad == []

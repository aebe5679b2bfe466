"""The PyTorch port stands alone: importing it (the window kernel's
module included) and running a ring, with the plain window and with
delivery="pallas_mega", pulls in no JAX and nothing of the JAX package; it runs on CUDA unless the
caller asks for the CPU; and options this slice does not serve raise
NotImplementedError instead of falling back."""

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
import json, sys
import ponyc_tpu_torch
from ponyc_tpu_torch import RuntimeOptions
from ponyc_tpu_torch.models import ring
import ponyc_tpu_torch.ops.megakernel
for delivery in ("plan", "pallas_mega"):
    rt = ring.run(32, 40, opts=RuntimeOptions(mailbox_cap=4, batch=1,
                  max_sends=1, msg_words=1, spill_cap=32, inject_slots=4,
                  tuning_cache="off", delivery=delivery), device="cpu")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ponyc_tpu" or m.startswith("ponyc_tpu."))
print(json.dumps({"bad": bad, "code": rt.exit_code,
                  "passes": int(rt.cohort_state(ring.RingNode)
                                ["passes"].sum())}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "code": 0, "passes": 40}


def test_default_device_is_cuda_and_never_silently_cpu():
    opts = RuntimeOptions(tuning_cache="off")
    if torch.cuda.is_available():
        assert Runtime(opts).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Runtime(opts)
    assert Runtime(opts, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw,slice_no", [
    (dict(checkpoint_every_s=1.0), 9), (dict(mesh_shards=2), 10),
    (dict(cost_capture=True), 11), (dict(watchdog_s=1.0), 11),
])
def test_unported_options_raise(kw, slice_no):
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        Runtime(RuntimeOptions(**kw), device="cpu")


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
        root / "profiling" / "torch_mega_phases.py"]
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

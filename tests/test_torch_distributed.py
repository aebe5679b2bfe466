"""The PyTorch port's mesh across OS processes (the counterpart of
tests/test_distributed.py): two processes join one torch.distributed job
over loopback with the gloo backend, one shard a rank
(ponyc_tpu_torch/parallel/distributed.py, DistComm), and run
tests/_torch_dist_worker.py: one collective of each kind, then the actor
engine itself (ubench traffic, a ring whose every hop crosses the process
boundary, and fan-in through a two-entry route bucket) and the
collector (a released ring, its marks crossing the boundary), with the
conservation counters asserted on both ranks. Each rank's numbers
(fields, counters, ticks) must equal the same program run in this
process over two shards and LocalComm.

The JAX package skips its engine case on XLA:CPU, whose gloo collectives
abort under the engine's mix (tests/test_distributed.py:60-81); the
port's collectives are torch.distributed's own, so the case runs here.
The children have a deadline of their own; no assertion is made on wall
time."""

import json
import os
import socket
import subprocess
import sys

import pytest

import _torch_dist_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _job(*stages, size=2, timeout=240):
    """Run the worker on `size` ranks; returns each rank's output lines
    keyed by stage, after checking that every rank finished."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-u", WORKER, init, str(r), str(size), *stages],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(size)]
    outs = []
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
            assert f"RANK{rank}_ALL_OK" in out, out[-4000:]
            got = {}
            for line in out.splitlines():
                tag, _, rest = line.partition(" ")
                if tag.startswith(f"RANK{rank}_") and rest:
                    got[tag[len(f"RANK{rank}_"):].lower()] = json.loads(rest)
            outs.append(got)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_collectives():
    """psum (int32, wrapping), pmax, all_gather of booleans and a tiled
    all_to_all across the process boundary."""
    outs = _job("comm")
    assert [o["comm"] for o in outs] == [{"psum": [-2, 3]}] * 2


@pytest.mark.parametrize("stages", [("ubench", "ring"), ("pressure",),
                                    ("gc",)],
                         ids=["ubench-ring", "pressure", "gc"])
def test_engine_across_two_processes(stages):
    outs = _job(*stages)
    for stage in stages:
        local = W.world(stage, 2)
        for rank, o in enumerate(outs):
            assert o[stage] == local, (stage, rank)

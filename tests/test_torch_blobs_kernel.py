"""The blob pool through the port's kernels, on the CPU: the window
kernel's own source (csrc/mega_window.cu with its blob phases), built for
the host CPU, against the plain window on every window of each blob
world's `Runtime.run()` under delivery="pallas_mega" (every state leaf,
the pool's included, every aux value and ticks run must be equal:
integers and bools, exact); and `pallas_fused=True`, under which a cohort
that uses the pool takes the plain dispatch, as in the JAX package, with
the same result as the plain path. The worlds are small and made from
numpy seeds. The host-build cases skip where the box has no host C++
compiler."""

import pytest

import ponyc_tpu_torch
from ponyc_tpu_torch import BlobCapacityError
from ponyc_tpu_torch.models import records
from ponyc_tpu_torch.ops import fused_dispatch as fdm

from _torch_programs import (blob_world, define_blobs, new_runtime,
                             run_blob_chain, run_blob_pipeline)
from test_torch_mega_host import host_checked  # noqa: F401 (fixture)

TB = define_blobs(ponyc_tpu_torch)
MEGA = dict(delivery="pallas_mega", quiesce_interval=4)
CHAIN = dict(mailbox_cap=2, batch=1, max_sends=1, spill_cap=1024,
             inject_slots=16)


def _ran(seen):
    assert seen and sum(k for k, _ in seen) > 0


@pytest.mark.parametrize("seed", [77, 2026])
def test_blob_chain_window_kernel(host_checked, seed):  # noqa: F811
    rt = run_blob_chain(ponyc_tpu_torch, TB, seed, {**CHAIN, **MEGA}, n=16)
    _ran(host_checked)
    assert rt.counter("n_blob_alloc") == rt.counter("n_blob_free") > 0


def test_records_window_kernel(host_checked):  # noqa: F811
    rt, st = records.run_records(
        n_sources=4, n_records=3,
        opts=records.options(4, tuning_cache="off", **MEGA), device="cpu")
    _ran(host_checked)
    assert st["n"] == 12 and rt.counter("n_blob_free") == 12


def test_blob_pipeline_window_kernel(host_checked):  # noqa: F811
    rt, (r1, r2), before = run_blob_pipeline(ponyc_tpu_torch, TB, **MEGA)
    _ran(host_checked)
    assert rt.state_of(r1) == rt.state_of(r2) and before == 3
    assert rt.blobs_in_use == 0


@pytest.mark.parametrize("kind", ["pool", "budget"])
def test_fail_flags_window_kernel(host_checked, kind):  # noqa: F811
    """The gate's sticky OB_BLOB and OB_BUDGET stop the window and raise
    the error that names the right knob."""
    if kind == "pool":
        rt = new_runtime(ponyc_tpu_torch, dict(
            mailbox_cap=4, batch=2, max_sends=1, msg_words=2,
            inject_slots=8, blob_slots=2, blob_words=8, **MEGA))
        rt.declare(TB.Leaker, 4).start()
        a = rt.spawn(TB.Leaker, n=0)
        for _ in range(3):
            rt.send(a, TB.Leaker.leak)
    else:
        rt = new_runtime(ponyc_tpu_torch, dict(
            mailbox_cap=4, batch=2, max_sends=1, msg_words=2,
            inject_slots=8, blob_slots=16, blob_words=8, **MEGA))
        rt.declare(TB.Hungry, 4).start()
        a = rt.spawn(TB.Hungry, n=0)
        rt.send(a, TB.Hungry.grab)
        rt.send(a, TB.Hungry.grab)
    with pytest.raises(BlobCapacityError,
                       match="blob_slots" if kind == "pool"
                       else "BLOB_DISPATCHES"):
        rt.run(max_steps=10)
    _ran(host_checked)


def test_blob_cohorts_take_the_plain_dispatch_when_fused():
    """Under pallas_fused=True the records cohorts that use the pool run
    the plain loop and the sink runs the fused kernel's plain version:
    the same world as the plain path."""
    worlds = []
    for fused in (False, True):
        rt, st = records.run_records(
            n_sources=4, n_records=3,
            opts=records.options(4, tuning_cache="off",
                                 pallas_fused=fused), device="cpu")
        worlds.append(blob_world(rt, records.RecSource, records.RecWorker,
                                 records.RecSink))
        if fused:
            assert [f.name for f in rt._multi_g.fused] == ["RecSink"]
            cohorts = rt.program.device_cohorts
            assert [fdm.eligible(ch, []) for ch in cohorts] == [
                False, False, True]
    assert worlds[0] == worlds[1]

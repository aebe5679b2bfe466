"""Snapshots that cross between the JAX package and the PyTorch port, in
both directions: a world saved by one package (serialise.save) restores
in the other (serialise.restore), into the same geometry and into a grown
one, and the run it finishes equals the saving package's own restore of
the same file (and, in the same geometry, the run the snapshot was cut
from). The structural fingerprint and the geometry descriptor, which a
restore checks, are equal across the packages.

Each world is defined once for both packages (`define(pkg)` in
tests/_torch_programs.py) and made from numpy seeds; the port runs on its
three paths on the CPU where a case runs a world in the port (the `path`
fixture of test_torch_host.py). The worlds are int32 and bool, so the
tolerance is exact: fields, counters, ticks and exit codes must be
equal, and the per-edge FIFO detector must count no violation.
"""

import functools
import tempfile
from pathlib import Path

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu import serialise as sj
from ponyc_tpu.runtime.state import geometry_descriptor as geo_j
from ponyc_tpu_torch import serialise as st
from ponyc_tpu_torch.runtime.state import geometry_descriptor as geo_t

import test_differential as td
from _torch_programs import build_fifo, build_walkers, counters, new_runtime
from test_torch_host import PATH_KW, TJ, TT, _runtime, path  # noqa: F401
from test_torch_serialise import GROWN, PRESSURE, RING, SER


# ---- snapshots across the packages ----------------------------------------

@pytest.mark.parametrize("okw", [
    dict(RING, msg_words=2), dict(RING, msg_words=2, analysis=1),
    dict(RING, msg_words=2, analysis=3, trace_sample=2),
    dict(RING, msg_words=3, blob_slots=16, blob_words=4),
])
def test_fingerprint_and_geometry_equal_across_packages(okw):
    for T_t, T_j, types in ((TT, TJ, ("Walker", "Splitter")),
                            (TT, TJ, ("WalkerH", "HostLog")),
                            (TT, TJ, ("Prod", "Cons"))):
        rt = new_runtime(ponyc_tpu_torch, okw)
        rj = new_runtime(ponyc_tpu, okw)
        for k, name in enumerate(types):
            rt.declare(getattr(T_t, name), 8 + 4 * k)
            rj.declare(getattr(T_j, name), 8 + 4 * k)
        rt.start()
        rj.start()
        for geo in (False, True):
            assert st.fingerprint(rt.program, geo) == \
                sj.fingerprint(rj.program, geo)
        assert geo_t(rt.program, rt.opts) == geo_j(rj.program, rj.opts)


def _jax_pressure_snapshot(tmp):
    rj = build_walkers(ponyc_tpu, TJ, 23, **PRESSURE)
    rj.run(max_steps=8)
    assert np.asarray(rj.state.muted).any()
    p = str(tmp / "jax-midp.npz")
    sj.save(rj, p)
    return p


def _restore_walkers(pkg, T, path, p, grow):
    okw, caps = (GROWN, (40, 16)) if grow else (PRESSURE, (24, 8))
    rt = _runtime(pkg, path, okw)
    rt.declare(T.Walker, caps[0]).declare(T.Splitter, caps[1]).start()
    SER[pkg].restore(rt, p)
    code = rt.run(max_steps=50_000)
    w, s = rt.cohort_state(T.Walker), rt.cohort_state(T.Splitter)
    return {"code": code, "steps": rt.steps_run, "counters": counters(rt),
            "walker": {k: v[:24].tolist() for k, v in w.items()
                       if k != "nxt"},
            "splitter": {k: v[:8].tolist() for k, v in s.items()
                         if k not in ("w_ref", "s_ref")}}


@functools.lru_cache(maxsize=None)
def _jax_side(grow):
    """The JAX package's snapshot under mute pressure, its own restore
    of it, and the run it was cut from finished without a snapshot."""
    p = _jax_pressure_snapshot(Path(tempfile.mkdtemp()))
    rj = build_walkers(ponyc_tpu, TJ, 23, **PRESSURE)
    # Its first run() ends where the snapshot was taken: injection is
    # paced by windows, so the cut is part of the run.
    rj.run(max_steps=8)
    rj.run(max_steps=50_000)
    return p, _restore_walkers(ponyc_tpu, TJ, "plain", p, grow), {
        "acc": rj.cohort_state(TJ.Walker)["acc"].tolist(),
        "counters": counters(rj), "steps": rj.steps_run}


@pytest.mark.parametrize("grow", [False, True], ids=["same", "grown"])
def test_jax_snapshot_finishes_in_the_port(path, grow):
    """The JAX package saves a world under mute pressure; the port
    restores it into the same geometry and into a grown one and runs to
    the end: the result equals the JAX package's own restore of the same
    file into the same geometry (and, unchanged geometry, its
    uninterrupted run) in fields, counters, ticks and exit code."""
    p, want, uncut = _jax_side(grow)
    got = _restore_walkers(ponyc_tpu_torch, TT, path, p, grow)
    assert got == want
    assert got["walker"]["acc"] == uncut["acc"]
    if not grow:
        assert got["counters"] == uncut["counters"]
        assert got["steps"] == uncut["steps"]


def _fifo_restored(pkg, T, path, p, grow):
    from _torch_programs import IN_SLOTS
    okw = dict(msg_words=2, mailbox_cap=8 if grow else 2, batch=2 if grow
               else 1, max_sends=3, spill_cap=512 if grow else 2048,
               inject_slots=32 if grow else 16)
    rt = _runtime(pkg, path, okw)
    n_prod, n_cons = 12, 6
    rt.declare(T.Prod, n_prod + (4 if grow else 0))
    rt.declare(T.Cons, n_cons + (2 if grow else 0)).start()
    SER[pkg].restore(rt, p)
    code = rt.run(max_steps=500_000)
    c = rt.cohort_state(T.Cons)
    return {"code": code, "steps": rt.steps_run, "counters": counters(rt),
            "cons": {k: v[:n_cons].tolist() for k, v in c.items()
                     if k in ("bad", "got") or k.startswith("last")},
            "in_slots": IN_SLOTS}


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_per_edge_fifo_crosses_packages(tmp_path, direction):
    """The per-edge FIFO world (tests/test_fifo.py's detector) saved
    mid-stream by one package, restored grown by the other: no
    violation, every stamp delivered, and the same result as the saving
    package's own grown restore."""
    src_pkg, src_T, dst_pkg, dst_T = (
        (ponyc_tpu, TJ, ponyc_tpu_torch, TT) if direction == "jax-to-port"
        else (ponyc_tpu_torch, TT, ponyc_tpu, TJ))
    items = 40
    kw = dict(mailbox_cap=2, batch=1, max_sends=3, spill_cap=2048,
              inject_slots=16)
    rt = build_fifo(src_pkg, src_T, 101, n_cons=6, items=items, **kw)
    rt.run(max_steps=40)
    assert (np.asarray(rt.state.tail) - np.asarray(rt.state.head)).any()
    p = str(tmp_path / "fifo.npz")
    SER[src_pkg].save(rt, p)
    got = _fifo_restored(dst_pkg, dst_T, "plain", p, True)
    want = _fifo_restored(src_pkg, src_T, "plain", p, True)
    assert got == want
    assert not any(got["cons"]["bad"])
    assert got["cons"]["got"] == [got["in_slots"] * items] * 6
    for s in range(got["in_slots"]):
        assert got["cons"][f"last{s}"] == [items - 1] * 6


@pytest.mark.parametrize("grow", [False, True], ids=["same", "grown"])
def test_port_snapshot_finishes_in_jax(tmp_path, path, grow):
    """The port saves (on each path) a world under mute pressure; the JAX
    package restores it and finishes, equal to the port's own restore."""
    rt = build_walkers(ponyc_tpu_torch, TT, 23,
                       **{**PRESSURE, **PATH_KW[path]})
    rt.run(max_steps=8)
    assert np.asarray(rt.state.muted).any()
    p = str(tmp_path / "port-midp.npz")
    st.save(rt, p)
    got = _restore_walkers(ponyc_tpu, TJ, "plain", p, grow)
    assert got == _restore_walkers(ponyc_tpu_torch, TT, path, p, grow)
    w_nxt, s_w, s_s, seeds = td._case(23, 24, 8)
    want = td.oracle(24, 8, w_nxt, s_w, s_s, seeds)
    assert got["walker"]["acc"] == want[0].tolist()

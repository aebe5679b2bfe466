"""Whole-world snapshots of the PyTorch port (serialise.py), held against
the JAX package: the cases of tests/test_serialise.py (the snapshots that
cross between the two packages are test_torch_snapshot_packages.py's).

Each world is defined once for both packages (`define(pkg)` in
tests/_torch_programs.py). Where a case runs a world it runs on the
port's three paths on the CPU (the `path` fixture of test_torch_host.py:
the plain tick, `pallas_fused=True`, and `delivery="pallas_mega"` with
every window also run as the host C++ build of csrc/mega_window.cu),
and the JAX package runs it once. The worlds are int32 and bool, so the
tolerance is exact: fields, counters, ticks and exit codes must be
equal.
"""

import functools
import sys

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu import serialise as sj
from ponyc_tpu_torch import serialise as st

import test_differential as td
from _torch_programs import build_walkers, counters, new_runtime
from test_torch_host import PATH_KW, TJ, TT, _runtime, path  # noqa: F401

RING = dict(mailbox_cap=8, batch=1, max_sends=1, msg_words=1, spill_cap=64,
            inject_slots=8)
PRESSURE = dict(mailbox_cap=2, batch=1, max_sends=2, msg_words=1,
                spill_cap=512, inject_slots=16)
GROWN = dict(mailbox_cap=4, batch=1, max_sends=2, msg_words=1,
             spill_cap=256, inject_slots=16)
SER = {ponyc_tpu: sj, ponyc_tpu_torch: st}


def _ring(pkg, T, path, n, **okw):
    rt = _runtime(pkg, path, {**RING, **okw})
    rt.declare(T.RingNode, n).start()
    ids = rt.spawn_many(T.RingNode, n)
    rt.set_fields(T.RingNode, ids, next_ref=np.roll(ids, -1))
    return rt, ids


def _passes(rt, T):
    return np.asarray(rt.cohort_state(T.RingNode)["passes"]).tolist()


def _mid_flight(pkg, T, path, tmp, okw_restore):
    """300 hops straight through; then the same walk snapshotted after 57
    ticks and finished in a fresh runtime of `okw_restore`."""
    rt_a, ids = _ring(pkg, T, path, 8)
    rt_a.send(int(ids[0]), T.RingNode.token, 300)
    rt_a.run()
    rt_b, ids = _ring(pkg, T, path, 8)
    rt_b.send(int(ids[0]), T.RingNode.token, 300)
    rt_b.run(max_steps=57)
    p = str(tmp / f"{pkg.__name__}.npz")
    SER[pkg].save(rt_b, p)
    rt_c, _ = _ring(pkg, T, path, 8, **dict(okw_restore))
    SER[pkg].restore(rt_c, p)
    resumed_at = rt_c.steps_run == rt_b.steps_run
    code = rt_c.run()
    return (_passes(rt_a, T), _passes(rt_c, T), code, rt_c.steps_run,
            resumed_at)


@functools.lru_cache(maxsize=None)
def _jax(name, *args):
    import tempfile
    from pathlib import Path
    return getattr(sys.modules[__name__], name)(
        ponyc_tpu, TJ, "plain", Path(tempfile.mkdtemp()), *args)


def test_snapshot_mid_flight_resume_matches(tmp_path, path):
    want, got, code, steps, resumed = _mid_flight(ponyc_tpu_torch, TT, path,
                                                  tmp_path, {})
    assert resumed and got == want and code == 0
    assert (want, got, code, steps) == _jax("_mid_flight", ())[:4]


def _queued(pkg, T, path, tmp):
    rt, ids = _ring(pkg, T, path, 4)
    rt.send(int(ids[0]), T.RingNode.token, 7)      # still in _inject_q
    p = str(tmp / "q.npz")
    SER[pkg].save(rt, p)
    rt2, _ = _ring(pkg, T, path, 4)
    SER[pkg].restore(rt2, p)
    queued = len(rt2._inject_q)
    rt2.run()
    return queued, _passes(rt2, T), rt2.steps_run


def test_snapshot_preserves_queued_host_sends(tmp_path):
    got = _queued(ponyc_tpu_torch, TT, "plain", tmp_path)
    assert got[0] == 1 and sum(got[1]) == 7
    assert got == _jax("_queued")


def test_fingerprint_rejects_different_program(tmp_path):
    rt, _ = _ring(ponyc_tpu_torch, TT, "plain", 4)
    st.save(rt, str(tmp_path / "w.npz"))

    @ponyc_tpu_torch.actor
    class Other:
        x: ponyc_tpu_torch.I32

        @ponyc_tpu_torch.behaviour
        def go(self, st_, v: ponyc_tpu_torch.I32):
            return st_

    rt2 = new_runtime(ponyc_tpu_torch, RING)
    rt2.declare(Other, 4).start()
    with pytest.raises(st.FingerprintMismatch):
        st.restore(rt2, str(tmp_path / "w.npz"))


def test_geometry_change_relayouts_since_v3(tmp_path, path):
    """A mid-flight token crosses a mailbox_cap and spill_cap change and
    still completes to the uninterrupted run's passes."""
    want, got, code, steps, resumed = _mid_flight(
        ponyc_tpu_torch, TT, path, tmp_path,
        dict(mailbox_cap=16, spill_cap=128))
    assert resumed and got == want and code == 0
    assert (want, got, code, steps) == _jax(
        "_mid_flight", (("mailbox_cap", 16), ("spill_cap", 128)))[:4]


def _keeper(pkg, T, path, tmp):
    okw = dict(RING, msg_words=2, batch=4)

    def build():
        rt = new_runtime(pkg, okw)
        return rt.declare(T.HostCounter, 1).start()

    rt = build()
    kid = rt.spawn(T.HostCounter)
    rt.send(kid, T.HostCounter.hit, 5)
    rt.run(max_steps=50)
    before = rt.state_of(kid)
    p = str(tmp / "k.npz")
    SER[pkg].save(rt, p)
    rt2 = build()
    rt2.spawn(T.HostCounter)
    SER[pkg].restore(rt2, p)
    restored = rt2.state_of(kid)
    rt2.send(kid, T.HostCounter.hit, 3)
    rt2.run(max_steps=50)
    return before, restored, rt2.state_of(kid), rt2.steps_run


def test_host_actor_state_round_trips(tmp_path):
    got = _keeper(ponyc_tpu_torch, TT, "plain", tmp_path)
    assert got[0] == got[1] == {"n": 1, "last": 5}
    assert got[2] == {"n": 2, "last": 3}
    assert got == _jax("_keeper")


def _pressure(pkg, T, path, tmp, grow=False):
    """tests/test_serialise.py's mid-deadlock-pressure world (the
    differential corpus' deadlock seed 23): snapshotted with muted
    senders, live spill and aged mute counters, restored into a fresh
    runtime (the same geometry, or grown) and run to the end."""
    n_w, n_s = 24, 8
    rt = build_walkers(pkg, T, 23, **PRESSURE,
                       **(PATH_KW[path] if pkg is ponyc_tpu_torch else {}))
    rt.run(max_steps=8)
    assert np.asarray(rt.state.muted).any(), "snapshot must land mid-pressure"
    p = str(tmp / "midp.npz")
    SER[pkg].save(rt, p)
    okw, caps = (GROWN, (n_w + 16, n_s + 8)) if grow else (PRESSURE,
                                                          (n_w, n_s))
    rt2 = _runtime(pkg, path, okw)
    rt2.declare(T.Walker, caps[0]).declare(T.Splitter, caps[1]).start()
    SER[pkg].restore(rt2, p)
    muted = bool(np.asarray(rt2.state.muted).any())
    code = rt2.run(max_steps=50_000)
    w, s = rt2.cohort_state(T.Walker), rt2.cohort_state(T.Splitter)
    return {"muted_at_restore": muted, "code": code,
            "acc": w["acc"][:n_w].tolist(), "hits": w["hits"][:n_w].tolist(),
            "sacc": s["acc"][:n_s].tolist(),
            "muted_at_end": bool(np.asarray(rt2.state.muted).any()),
            "counters": counters(rt2), "steps": rt2.steps_run}


def test_snapshot_under_mute_pressure_resumes_to_oracle(tmp_path, path):
    got = _pressure(ponyc_tpu_torch, TT, path, tmp_path)
    w_nxt, s_w, s_s, seeds = td._case(23, 24, 8)
    want = td.oracle(24, 8, w_nxt, s_w, s_s, seeds)
    assert got["muted_at_restore"] and not got["muted_at_end"]
    assert got["code"] == 0
    assert got["acc"] == want[0].tolist() and got["hits"] == want[1].tolist()
    assert got["sacc"] == want[2].tolist()
    assert got == _jax("_pressure")

"""Cross-shard pressure in the PyTorch port against the JAX package: the
five cases of tests/test_mesh_pressure.py on four shards. Route-bucket
overflow parks messages in the route spill and mutes their senders
until they recover; the receiver's delivery spill fills across shards;
a spill too small aborts the run; a snapshot taken mid-pressure restores
and finishes; programmatic backpressure on one receiver mutes senders
on other shards. Each case runs the same program in both packages (the
port's four shards in one process on the CPU) and compares, tick by
tick where the reference test steps, the counters, the pressure facts
and the end state: integers, exact equality."""

import numpy as np
import pytest
import torch

import ponyc_tpu
import ponyc_tpu.serialise
import ponyc_tpu_torch
import ponyc_tpu_torch.serialise
from ponyc_tpu.runtime.runtime import SpillOverflowError as JOverflow
from ponyc_tpu_torch.runtime import engine as tengine
from ponyc_tpu_torch.runtime.runtime import SpillOverflowError as TOverflow

from _torch_programs import _host, counters, new_runtime

@pytest.fixture(autouse=True)
def one_thread():
    """A shard's tick is a few hundred small eager ops: torch's intra-op
    threads only contend with the other test workers for the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)



def define_pressure(pkg):
    actor, behaviour, I32, Ref = (pkg.actor, pkg.behaviour, pkg.I32,
                                  pkg.Ref)

    @actor
    class Burst:
        """One message a tick to a fixed target, `left` times."""
        out: Ref
        left: I32
        MAX_SENDS = 2

        @behaviour
        def go(self, st, _: I32):
            alive = st["left"] > 0
            self.send(st["out"], Sink.recv, 1, when=alive)
            self.send(self.actor_id, Burst.go, 0, when=st["left"] > 1)
            return {**st, "left": st["left"] - 1}

    @actor
    class Sink:
        got: I32

        @behaviour
        def recv(self, st, v: I32):
            return {**st, "got": st["got"] + v}

    return Burst, Sink


PKGS = {"jax": (ponyc_tpu,) + define_pressure(ponyc_tpu),
        "torch": (ponyc_tpu_torch,) + define_pressure(ponyc_tpu_torch)}


def _run_pressure(which, okw, n_src=48, items=4):
    """n_src senders over all shards flood ONE sink on shard 0."""
    pkg, Burst, Sink = PKGS[which]
    rt = new_runtime(pkg, okw)
    rt.declare(Burst, n_src).declare(Sink, 4)
    rt.start()
    sink = rt.spawn(Sink)
    srcs = rt.spawn_many(Burst, n_src, out=int(sink), left=items)
    for s in srcs:
        rt.send(int(s), Burst.go, 0)
    return rt, sink, srcs


def _end(rt):
    st = rt.state
    return {"steps": rt.steps_run, "counters": counters(rt),
            "cols": {f: _host(getattr(st, f)).tolist() for f in (
                "head", "tail", "alive", "muted", "mute_refs",
                "rspill_count", "dspill_count", "world_bits")}}


def _stepwise(which, okw, n_src, items, spill, limit=400):
    """Tick by tick until the sink got everything: the per-tick facts."""
    rt, sink, _ = _run_pressure(which, okw, n_src, items)
    trail = []
    for _ in range(limit):
        rt.run(max_steps=1)
        trail.append((rt.counter(spill), bool(_host(rt.state.muted).any()),
                      rt.state_of(int(sink))["got"]))
        if trail[-1][2] == n_src * items:
            break
    return rt, sink, trail


def test_route_bucket_overflow_spills_mutes_and_recovers():
    """Every shard's senders target one shard and a tick's emissions
    exceed the route bucket: messages park in the route spill, their
    senders mute, everything arrives exactly once, and every sender is
    released again at quiescence."""
    okw = dict(mailbox_cap=4, batch=1, max_sends=2, msg_words=2,
               mesh_shards=4, spill_cap=256, inject_slots=64,
               quiesce_interval=1, route_bucket=8)
    got = {}
    for which in ("jax", "torch"):
        rt, sink, trail = _stepwise(which, okw, 48, 4, "rspill_count")
        mid = _end(rt)
        rt.run(max_steps=50)
        got[which] = (trail, mid, _end(rt))
    assert got["torch"] == got["jax"]
    trail, _mid, end = got["torch"]
    assert trail[-1][2] == 48 * 4
    assert any(r > 0 for r, _, _ in trail), "the route spill never engaged"
    assert any(m for _, m, _ in trail), "pressure never muted a sender"
    assert end["counters"]["n_mutes"] > 0
    assert not any(end["cols"]["muted"]) and sum(
        end["cols"]["rspill_count"]) == 0


def test_receiver_spill_crosses_shards_and_drains():
    """A large bucket passes everything through; the receiver's mailbox
    (cap 4) overflows into the delivery spill on a mesh instead."""
    okw = dict(mailbox_cap=4, batch=2, max_sends=2, msg_words=2,
               mesh_shards=4, spill_cap=2048, inject_slots=64)
    got = {}
    for which in ("jax", "torch"):
        rt, sink, trail = _stepwise(which, okw, 32, 4, "dspill_count")
        rt.run(max_steps=50)
        got[which] = (trail, _end(rt))
    assert got["torch"] == got["jax"]
    trail, end = got["torch"]
    assert trail[-1][2] == 32 * 4
    assert any(d > 0 for d, _, _ in trail), "no delivery spill"
    assert not any(end["cols"]["muted"]) and sum(
        end["cols"]["dspill_count"]) == 0


def test_spill_overflow_aborts_on_mesh():
    """A spill far below one tick's rejections: the run fails loudly
    (SpillOverflowError) at the same tick in both packages."""
    okw = dict(mailbox_cap=4, batch=1, max_sends=2, msg_words=2,
               mesh_shards=4, spill_cap=4, inject_slots=256,
               overload_threshold=10.0)      # mute never triggers
    steps = {}
    for which, err in (("jax", JOverflow), ("torch", TOverflow)):
        rt, _sink, _ = _run_pressure(which, okw, n_src=64, items=8)
        with pytest.raises(err):
            rt.run(max_steps=200)
        steps[which] = rt.steps_run
    assert steps["torch"] == steps["jax"]


def test_mesh_serialise_roundtrip_under_pressure(tmp_path):
    """Snapshot mid-pressure (spills full, senders muted), restore into a
    fresh runtime and finish: nothing lost, nothing doubled, and the
    port's snapshot file restores in the JAX package to the same end."""
    okw = dict(mailbox_cap=4, batch=1, max_sends=2, msg_words=2,
               mesh_shards=4, spill_cap=256, inject_slots=64)
    ends = {}
    for which in ("jax", "torch"):
        pkg, Burst, Sink = PKGS[which]
        rt, sink, _ = _run_pressure(which, okw)
        for _ in range(6):
            rt.run(max_steps=1)
        got_mid = rt.state_of(int(sink))["got"]
        assert got_mid < 48 * 4
        path = str(tmp_path / f"mesh_pressure_{which}.npz")
        pkg.serialise.save(rt, path)
        rt2 = new_runtime(pkg, okw)
        rt2.declare(Burst, 48).declare(Sink, 4)
        rt2.start()
        pkg.serialise.restore(rt2, path)
        assert rt2.state_of(int(sink))["got"] == got_mid
        rt2.run(max_steps=400)
        assert rt2.state_of(int(sink))["got"] == 48 * 4
        ends[which] = (got_mid, _end(rt2))
    assert ends["torch"] == ends["jax"]
    assert not any(ends["torch"][1]["cols"]["muted"])


def _backpressure(which):
    pkg, _Burst, _Sink = PKGS[which]
    okw = dict(mailbox_cap=64, batch=4, max_sends=2, msg_words=2,
               mesh_shards=4, spill_cap=512, inject_slots=64,
               quiesce_interval=1)
    rt, sink, _ = _run_pressure(which, okw, n_src=16, items=40)
    if which == "jax":
        inj, empty = rt._drain_inject(), rt._empty_inject
        step = rt._step
    else:
        inj, empty = rt._drain_inject_tracked()[:2], rt._empty_inject
        step = tengine.build_step(rt.program, rt.opts)
    st, _aux = step(rt.state, *inj)
    st, _aux = step(st, *empty)
    rt.state = st
    assert not _host(st.muted).any(), "no pressure yet"
    rt.apply_backpressure([int(sink)])
    st = rt.state
    for _ in range(3):
        st, _aux = step(st, *empty)
    rt.state = st
    muted = _host(st.muted)
    occ = int(_host(st.tail - st.head)[int(sink)])
    n_local = rt.program.n_local
    muted_shards = sorted({int(i) // n_local for i in np.nonzero(muted)[0]})
    rt.release_backpressure([int(sink)])
    code = rt.run(max_steps=4000)
    return {"muted": muted.tolist(), "occ": occ, "sink_shard":
            int(sink) // n_local, "muted_shards": muted_shards,
            "code": code, "got": rt.state_of(int(sink))["got"],
            "overload_occ": rt.opts.overload_occ, "end": _end(rt)}


def test_programmatic_backpressure_on_mesh():
    """apply_backpressure on one receiver: senders on every shard mute
    when they send to it (the pressured column crosses the mesh), and
    release after release_backpressure."""
    t = _backpressure("torch")
    assert t == _backpressure("jax")
    assert any(t["muted"]), "a pressured receiver must mute senders"
    assert t["occ"] <= t["overload_occ"]
    assert set(t["muted_shards"]) - {t["sink_shard"]}
    assert t["code"] == 0 and t["got"] == 16 * 40
    assert not any(t["end"]["cols"]["muted"])

"""Sharded worlds in the PyTorch port against the JAX package: the four
cases of tests/test_mesh.py (a ring whose every hop crosses shards,
fan-out across shards with the counters, host rows drained at each
shard's tail, GUPS over four shards). The port runs its four shards in
one process on the CPU (parallel/comm.py's LocalComm), the JAX package
on its virtual CPU mesh (tests/conftest.py). Fields, counters, ticks,
exit codes and the per-actor columns must be equal: all integers, exact
equality. Also the collective layer itself: its results in shard order
and its int32 wrap."""

import numpy as np
import pytest
import torch

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu.models import gups as jgups, ring as jring
from ponyc_tpu_torch.models import gups as tgups, ring as tring
from ponyc_tpu_torch.parallel import Sharded, comm

from _torch_programs import _host, counters, new_runtime

OKW = dict(mailbox_cap=8, batch=1, max_sends=1, msg_words=1, mesh_shards=4,
           spill_cap=64)

@pytest.fixture(autouse=True)
def one_thread():
    """A shard's tick is a few hundred small eager ops: torch's intra-op
    threads only contend with the other test workers for the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)



def define_mesh(pkg):
    """The actor types of tests/test_mesh.py, built with `pkg`."""
    actor, behaviour, I32, Ref = (pkg.actor, pkg.behaviour, pkg.I32,
                                  pkg.Ref)

    @actor
    class Bcast:
        a: Ref
        b: Ref
        MAX_SENDS = 2

        @behaviour
        def go(self, st, n: I32):
            self.send(st["a"], Sink.recv, n)
            self.send(st["b"], Sink.recv, n + 1)
            return st

    @actor
    class Sink:
        total: I32

        @behaviour
        def recv(self, st, v: I32):
            return {**st, "total": st["total"] + v}

    @actor
    class DevSrc:
        out: Ref
        MAX_SENDS = 1

        @behaviour
        def go(self, st, n: I32):
            self.send(st["out"], HostSink.recv, n)
            return st

    @actor
    class HostSink:
        HOST = True

        @behaviour
        def recv(self, st, v: I32):
            st = dict(st)
            st["got"] = st.get("got", 0) + int(v)
            return st

    return dict(Bcast=Bcast, Sink=Sink, DevSrc=DevSrc, HostSink=HostSink)


JM, TM = define_mesh(ponyc_tpu), define_mesh(ponyc_tpu_torch)


def numbers(rt, types):
    """What a sharded run of either package must agree on."""
    st = rt.state
    return {"steps": rt.steps_run, "counters": counters(rt),
            "totals": {k: rt.totals.get(k, 0) for k in (
                "processed", "delivered", "host_processed", "badmsg")},
            "fields": {t.__name__: {f: np.asarray(v).tolist() for f, v in
                                    rt.cohort_state(t).items()}
                       for t in types},
            "cols": {f: _host(getattr(st, f)).tolist() for f in (
                "head", "tail", "alive", "muted", "n_processed",
                "n_delivered", "step_no", "world_bits")}}


def test_ring_across_shards():
    """Node i+1 lives on shard (i+1) % 4: every hop crosses the mesh."""
    n, hops = 16, 64
    opts = dict(OKW, tuning_cache="off")
    jrt = jring.run(n_nodes=n, hops=hops,
                    opts=ponyc_tpu.RuntimeOptions(**opts))
    trt = tring.run(n_nodes=n, hops=hops,
                    opts=ponyc_tpu_torch.RuntimeOptions(**opts),
                    device="cpu")
    assert trt.mesh is not None and trt.mesh.n_shards == 4
    t = numbers(trt, [tring.RingNode])
    assert t == numbers(jrt, [jring.RingNode])
    passes = np.asarray(t["fields"]["RingNode"]["passes"])
    assert passes.sum() == hops and (passes == hops // n).all()


def _fanout(pkg, T):
    rt = new_runtime(pkg, OKW)
    rt.declare(T["Bcast"], 4).declare(T["Sink"], 8)
    rt.start()
    sinks = rt.spawn_many(T["Sink"], 8)
    srcs = rt.spawn_many(T["Bcast"], 4, a=sinks[:4], b=sinks[4:])
    for i, s in enumerate(srcs):
        rt.send(int(s), T["Bcast"].go, 10 * (i + 1))
    rt.run(max_steps=50)
    return numbers(rt, [T["Bcast"], T["Sink"]])


def test_fanout_across_shards_and_counters():
    t = _fanout(ponyc_tpu_torch, TM)
    assert t == _fanout(ponyc_tpu, JM)
    assert sum(t["fields"]["Sink"]["total"]) == 100 * 2 + 4
    assert t["totals"]["processed"] == t["totals"]["delivered"] == 12


def _fanout_paused(read):
    """The fan-out world run in two parts with a host write between
    them; `read` also reads the world (a counter, then the state) after
    the first part."""
    T = TM
    rt = new_runtime(ponyc_tpu_torch, OKW)
    rt.declare(T["Bcast"], 4).declare(T["Sink"], 8)
    rt.start()
    sinks = rt.spawn_many(T["Sink"], 8)
    srcs = rt.spawn_many(T["Bcast"], 4, a=sinks[:4], b=sinks[4:])
    for i, s in enumerate(srcs):
        rt.send(int(s), T["Bcast"].go, 10 * (i + 1))
    rt.run(max_steps=2)
    seen = None
    if read:
        # A window leaves the world on its shards; a counter sums them
        # without joining it, and reading rt.state joins it.
        assert isinstance(rt._state, Sharded) and rt._state._world is None
        seen = rt.counter("n_processed")
        assert rt._state._world is None
        assert int(rt.state.n_processed.sum()) == seen
        assert rt._state._world is not None
    rt.set_fields(T["Sink"], np.asarray(sinks[:2]), total=np.asarray([7, 9]))
    rt.run(max_steps=50)
    return numbers(rt, [T["Bcast"], T["Sink"]]), seen


def test_world_stays_on_its_shards_between_windows():
    """Host reads between windows join the world without changing it,
    and a host write lands in the shards the next window runs on: the
    run equals one with no reads."""
    got, seen = _fanout_paused(True)
    want, _ = _fanout_paused(False)
    assert seen > 0 and got == want
    assert sum(got["fields"]["Sink"]["total"]) == 100 * 2 + 4 + 7 + 9


def _host_drain(pkg, T):
    rt = new_runtime(pkg, dict(OKW, msg_words=2))
    rt.declare(T["DevSrc"], 8).declare(T["HostSink"], 8)
    rt.start()
    sinks = rt.spawn_many(T["HostSink"], 8)
    srcs = rt.spawn_many(T["DevSrc"], 8, out=sinks)
    for _rnd in range(3):     # repeated drains: stale heads double-deliver
        for i, s in enumerate(srcs):
            rt.send(int(s), T["DevSrc"].go, 10 * (i + 1))
        rt.run(max_steps=40)
    out = numbers(rt, [T["DevSrc"]])
    out["got"] = [rt.state_of(int(h)).get("got", 0) for h in sinks]
    return out


def test_host_drain_across_shards():
    """Host rows live at each shard's tail range, not at the end of the
    global columns: three rounds of drains, equal to the JAX package."""
    t = _host_drain(ponyc_tpu_torch, TM)
    assert t == _host_drain(ponyc_tpu, JM)
    assert sum(t["got"]) == 3 * sum(10 * (i + 1) for i in range(8))
    assert t["totals"]["badmsg"] == 0


def test_gups_across_shards():
    """Updates land on cells over four shards; the xor of the table is
    the xor of every update sent, and both packages end equal."""
    kw = dict(mailbox_cap=16, batch=2, max_sends=2, msg_words=1,
              mesh_shards=4, spill_cap=256, tuning_cache="off")
    jrt = jgups.run(table_size=64, n_updaters=8, updates_each=16,
                    opts=ponyc_tpu.RuntimeOptions(**kw))
    trt = tgups.run(table_size=64, n_updaters=8, updates_each=16,
                    opts=ponyc_tpu_torch.RuntimeOptions(**kw),
                    device="cpu")
    t = numbers(trt, [tgups.TableCell, tgups.Updater])
    assert t == numbers(jrt, [jgups.TableCell, jgups.Updater])
    assert sum(t["fields"]["Updater"]["done"]) == 8 * 16
    rng0 = np.random.default_rng(7).integers(1, 2**31 - 1, 8).astype(
        np.int64)
    expect = 0
    for x in rng0:
        for _ in range(16):
            x = np.int32(x ^ (x << 13))
            x = np.int32(x ^ ((x >> 17) & 0x7FFF))
            x = np.int32(x ^ (x << 5))
            expect ^= int(np.uint32(x))
    got = 0
    for v in t["fields"]["TableCell"]["value"]:
        got ^= int(v) & 0xFFFFFFFF
    assert got == expect


def test_local_comm_semantics():
    """all_to_all, all_gather, psum (int32 wrap) and pmax over three
    shards, in shard order; a shard that reaches another collective than
    its peers raises instead of hanging."""
    c = comm.LocalComm(3)
    xs = [torch.arange(6, dtype=torch.int32) + 10 * r for r in range(3)]
    a2a = c.run("all_to_all", xs, 0)
    for r in range(3):
        assert a2a[r].tolist() == [v for s in range(3)
                                   for v in xs[s][2 * r:2 * r + 2].tolist()]
    w = [torch.arange(6, dtype=torch.int32).reshape(2, 3) + 10 * r
         for r in range(3)]
    a2a = c.run("all_to_all", w, 1)
    assert a2a[1].tolist() == [[1, 11, 21], [4, 14, 24]]
    assert c.run("all_gather", [torch.tensor([r]) for r in range(3)],
                 0)[2].tolist() == [0, 1, 2]
    big = torch.tensor([2**31 - 1], dtype=torch.int32)
    s = c.run("psum", [big, big, torch.tensor([3], dtype=torch.int32)], 0)
    wrapped = ((2**31 - 1) * 2 + 3 + 2**31) % 2**32 - 2**31
    assert s[0].dtype == torch.int32 and s[0].item() == wrapped == 1
    assert c.run("pmax", [torch.tensor([r - 5]) for r in range(3)],
                 0)[0].item() == -3

    def tick(r):
        got = yield comm.psum(torch.ones((), dtype=torch.int32))
        if r == 0:
            got = yield comm.psum(got)
        return int(got)
    with pytest.raises(comm.MeshDivergence):
        comm.drive(comm.LocalComm(2), [tick(0), tick(1)])

    def agree(r):
        a = yield comm.psum(torch.tensor(r + 1, dtype=torch.int32))
        b = yield comm.all_gather(torch.tensor([r]))
        return int(a), b.tolist()
    assert comm.drive(comm.LocalComm(2), [agree(0), agree(1)]) == [
        (3, [0, 1]), (3, [0, 1])]

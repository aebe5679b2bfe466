"""Device spawns (`ctx.spawn`) and sync construction (`ctx.spawn_sync`)
in the port against the JAX package, on the plain tick: the spawn tree
of examples/spawn_tree.py (the port's `models/spawn_tree.py`) and the
lifecycle cases of tests/test_lifecycle.py (spawn and construct, a
masked spawn, reuse of a destroyed slot, exhaustion, host spawns after
device claims and destroys, `spawn_sync` and its refusal of an
effectful constructor, the spawn/destroy churn against its oracle).
One program definition serves both packages (tests/_torch_programs.py);
the port runs on the CPU. Every compared value is an integer except
Kid.frac, a float32 copied unchanged: the tolerance is exact equality."""

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu.runtime.runtime import SpawnCapacityError as JSpawnErr
from ponyc_tpu_torch import SpawnCapacityError
from ponyc_tpu_torch.models import spawn_tree

from _torch_programs import _host, churn, counters, define, new_runtime

JT, TT = define(ponyc_tpu), define(ponyc_tpu_torch)
PKGS = ((ponyc_tpu, JT), (ponyc_tpu_torch, TT))


def _world(rt, *types):
    """Everything a run leaves behind that the packages must agree on."""
    return {"counters": counters(rt), "n_spawned": rt.counter("n_spawned"),
            "steps": rt.steps_run, "alive": _host(rt.state.alive).tolist(),
            "fields": {t.__name__: {f: np.asarray(v).tolist() for f, v in
                                    rt.cohort_state(t).items()}
                       for t in types}}


def test_spawn_tree_matches_jax():
    """Depth 6 (64 leaves, 127 nodes, 256 rows): the port's model against
    the example's program in the JAX package."""
    depth = 6
    jrt = new_runtime(ponyc_tpu, dict(
        mailbox_cap=8, batch=4, max_sends=3, msg_words=2, inject_slots=8,
        spill_cap=512))
    jrt.declare(JT.Node, 4 << depth).start()
    jroot = jrt.spawn(JT.Node)
    jrt.send(jroot, JT.Node.grow, depth, -1)
    jcode = jrt.run(max_steps=10_000)
    trt = spawn_tree.run(depth, spawn_tree.options(tuning_cache="off"),
                         device="cpu")
    assert jcode == trt.exit_code == 2 ** depth
    assert trt.counter("n_spawned") == 2 ** (depth + 1) - 2
    assert int(_host(trt.state.alive).sum()) == 2 ** (depth + 1) - 1
    j, t = _world(jrt, JT.Node), _world(trt, spawn_tree.Node)
    t["fields"] = {"Node": t["fields"].pop("Node")}
    assert t == j


def _mk(pkg, T, worker_cap=8, boss_cap=2, **kw):
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=1, max_sends=2,
                               msg_words=2, spill_cap=64, inject_slots=8,
                               **kw))
    rt.declare(T.Worker, worker_cap).declare(T.Boss, boss_cap)
    return rt.start()


def _both(scenario):
    """Run `scenario(pkg, T) -> value` on both packages; they must agree."""
    j, t = (scenario(pkg, T) for pkg, T in PKGS)
    assert t == j
    return t


def test_spawn_creates_and_constructs():
    def go(pkg, T):
        rt = _mk(pkg, T)
        boss = rt.spawn(T.Boss)
        rt.send(boss, T.Boss.go, 2)
        rt.run(max_steps=20)
        return boss, _world(rt, T.Worker, T.Boss)
    boss, w = _both(go)
    assert w["n_spawned"] == 2 and sum(w["alive"]) == 3
    assert w["fields"]["Boss"]["n_started"][0] == 2
    assert sorted(v for v in w["fields"]["Worker"]["value"] if v) == [11, 22]
    assert w["fields"]["Boss"]["last_child"][0] >= 0


def test_masked_spawn_does_not_claim():
    def go(pkg, T):
        rt = _mk(pkg, T)
        boss = rt.spawn(T.Boss)
        rt.send(boss, T.Boss.go, 1)       # the second site masked out
        rt.run(max_steps=20)
        return _world(rt, T.Worker, T.Boss)
    w = _both(go)
    assert w["n_spawned"] == 1 and w["fields"]["Boss"]["n_started"][0] == 1


def test_destroyed_slot_is_reused():
    def go(pkg, T):
        rt = _mk(pkg, T, worker_cap=2, boss_cap=1)
        boss = rt.spawn(T.Boss)
        rt.send(boss, T.Boss.go, 2)       # fills both worker slots
        rt.run(max_steps=20)
        rt.send(rt.state_of(boss)["last_child"], T.Worker.stop)
        rt.run(max_steps=20)
        rt.send(boss, T.Boss.go, 1)       # must reuse the freed slot
        rt.run(max_steps=20)
        return _world(rt, T.Worker, T.Boss)
    w = _both(go)
    assert w["n_spawned"] == 3 and sum(w["alive"]) == 3
    assert w["fields"]["Boss"]["n_started"][0] == 3


def test_spawn_capacity_exhaustion_raises():
    for (pkg, T), err in zip(PKGS, (JSpawnErr, SpawnCapacityError)):
        rt = _mk(pkg, T, worker_cap=1, boss_cap=1)
        boss = rt.spawn(T.Boss)
        rt.send(boss, T.Boss.go, 2)       # wants 2 slots, only 1 exists
        with pytest.raises(err):
            rt.run(max_steps=20)


def test_host_spawn_sees_device_claims():
    def go(pkg, T):
        rt = _mk(pkg, T, worker_cap=3, boss_cap=1)
        boss = rt.spawn(T.Boss)
        rt.send(boss, T.Boss.go, 2)
        rt.run(max_steps=20)
        # The host must not hand out the two device-claimed slots.
        w = rt.spawn(T.Worker, value=99)
        assert rt.state_of(w)["value"] == 99
        with pytest.raises(RuntimeError):
            rt.spawn(T.Worker)            # the cohort is full now
        return w, _world(rt, T.Worker, T.Boss)
    w, world = _both(go)
    assert sum(world["alive"]) == 4


def test_host_spawn_after_device_destroy_reclaims():
    def go(pkg, T):
        rt = _mk(pkg, T, worker_cap=2, boss_cap=1)
        ws = rt.spawn_many(T.Worker, 2)
        for w in ws:
            rt.send(int(w), T.Worker.stop)
        rt.run(max_steps=20)
        # The freelist is rebuilt from the device state: both slots are
        # free again though host spawns had popped them.
        w = rt.spawn(T.Worker, value=7)
        return w, rt.state_of(w), _world(rt, T.Worker)
    w, st, world = _both(go)
    assert st["value"] == 7 and world["counters"]["n_destroyed"] == 2


def test_host_spawn_skips_a_row_with_a_spilled_message():
    """A dead row that a spilled message still addresses is not free:
    the host's freelist applies the device's own condition. Worker 0
    destroys itself in the tick in which seven others send to it (two
    land in its ring, five spill); after that one tick the host spawn
    must pass over its row."""
    def go(pkg, T):
        rt = new_runtime(pkg, dict(mailbox_cap=2, batch=1, max_sends=2,
                                   msg_words=2, spill_cap=64,
                                   inject_slots=8))
        rt.declare(T.Worker, 10).declare(T.Boss, 1).start()
        ws = rt.spawn_many(T.Worker, 8)
        rt.bulk_send(ws[:1], T.Worker.stop)
        rt.bulk_send(ws[1:], T.Worker.init, np.full(7, ws[0]),
                     np.arange(7))
        rt.run(max_steps=1)
        pending = _host(rt.state.dspill_tgt).tolist().count(int(ws[0]))
        return int(ws[0]), pending, rt.spawn(T.Worker, value=5)
    w0, pending, got = _both(go)
    assert pending == 5 and got != w0


def test_spawn_sync_constructs_fields_synchronously():
    def go(pkg, T):
        rt = new_runtime(pkg, dict(mailbox_cap=8, batch=2, max_sends=1,
                                   msg_words=3, inject_slots=8))
        rt.declare(T.Maker, 1).declare(T.Kid, 2).start()
        m = rt.spawn(T.Maker)
        rt.send(m, T.Maker.make, 7)
        code = rt.run(max_steps=10)
        kid = rt.state_of(m)["made"]
        return code, kid, rt.state_of(int(kid)), _world(rt, T.Maker, T.Kid)
    code, kid, st, _w = _both(go)
    assert code == 0 and kid >= 0
    assert st == {"tag": 107, "frac": 0.5, "boss": -1}


def test_spawn_sync_rejects_effectful_constructor():
    for pkg in (ponyc_tpu, ponyc_tpu_torch):
        @pkg.actor
        class Kid3:
            x: pkg.I32

            @pkg.behaviour
            def init(self, st, v: pkg.I32):
                self.exit(1)              # an effect: not a constructor
                return {**st, "x": v}

        @pkg.actor
        class Maker3:
            MAX_SENDS = 1
            SPAWNS = {"Kid3": 1}

            @pkg.behaviour
            def make(self, st, v: pkg.I32):
                self.spawn_sync(Kid3.init, v)
                return st

        rt = new_runtime(pkg, dict(mailbox_cap=8, batch=1, max_sends=1,
                                   msg_words=2, inject_slots=8))
        rt.declare(Maker3, 1).declare(Kid3, 1)
        with pytest.raises(TypeError, match="effects"):
            rt.start()
            m = rt.spawn(Maker3)
            rt.send(m, Maker3.make, 1)
            rt.run(max_steps=4)


@pytest.mark.parametrize("seed", [301, 307])
def test_spawn_destroy_churn_against_oracle(seed):
    def go(pkg, T):
        rt, sink, total, hits = churn(pkg, T, seed)
        code = rt.run(max_steps=100_000)
        st = rt.state_of(sink)
        assert (st["total"], st["hits"]) == (total, hits)
        assert rt.counter("n_destroyed") == hits
        return code, _world(rt, T.Relay, T.Temp, T.Collector)
    code, _w = _both(go)
    assert code == 0


def _two_spawners(pkg):
    """Two spawner cohorts sharing one target: Boss and Hirer both spawn
    Workers, so the target's free list is split between them."""
    T = JT if pkg is ponyc_tpu else TT

    @pkg.actor
    class Hirer:
        hired: pkg.Ref

        SPAWNS = {"Worker": 3}
        SPAWN_DISPATCHES = 1
        MAX_SENDS = 3

        @pkg.behaviour
        def hire(self, st, v: pkg.I32):
            a = self.spawn(T.Worker.init, self.actor_id, v, when=v > 0)
            self.spawn(T.Worker.init, self.actor_id, v + 1, when=v > 1)
            self.spawn(T.Worker.init, self.actor_id, v + 2, when=v > 2)
            return {**st, "hired": a}

        @pkg.behaviour
        def started(self, st, child: pkg.Ref):
            return st

    return Hirer


def test_spawn_offsets_of_two_spawner_cohorts():
    """Program._resolve_spawns partitions a target's free rows between its
    spawner cohorts as the JAX package does, and a world in which both
    spawn in the same ticks gives the same claims."""
    out = {}
    for pkg, T in PKGS:
        Hirer = _two_spawners(pkg)
        rt = new_runtime(pkg, dict(mailbox_cap=8, batch=2, max_sends=3,
                                   msg_words=2, spill_cap=64,
                                   inject_slots=16))
        rt.declare(T.Boss, 3).declare(Hirer, 2).declare(T.Worker, 40)
        rt.start()
        offsets = {c.atype.__name__: dict(c.spawn_offsets)
                   for c in rt.program.cohorts}
        bosses = rt.spawn_many(T.Boss, 3)
        hirers = rt.spawn_many(Hirer, 2)
        for i, b in enumerate(bosses):
            rt.send(int(b), T.Boss.go, 1 + i % 2)
        for i, h in enumerate(hirers):
            rt.send(int(h), Hirer.hire, 1 + 2 * i)
        rt.run(max_steps=50)
        out[pkg.__name__] = (offsets, _world(rt, T.Worker, T.Boss),
                             {f: np.asarray(v).tolist() for f, v in
                              rt.cohort_state(Hirer).items()})
    assert out["ponyc_tpu_torch"] == out["ponyc_tpu"]
    offsets, world, _ = out["ponyc_tpu_torch"]
    assert offsets["Boss"] == {"Worker": 0}
    assert offsets["Hirer"] == {"Worker": 3 * 2 * 2}
    assert world["n_spawned"] == 2 + 2 + 1 + 3

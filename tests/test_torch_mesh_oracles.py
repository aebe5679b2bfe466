"""The mesh configurations of the reference's oracle tests, run by the
PyTorch port on the CPU (every shard in one process, parallel/comm.py's
LocalComm):

- tests/test_differential.py: `mesh4` and `mesh4-tiny-bucket` (also
  under pallas_fused=True) against the sequential oracle, cohorts that
  do not divide the shard count, and the blob chain on two shards with
  buckets 0 and 2 (blobs migrate with their messages);
- tests/test_fifo.py: `mesh4-route-spill` and the blob FIFO's
  `mesh4-bucket` against the per-edge FIFO oracle;
- tests/test_blobs.py: `blob_store(near=)`, migration with a routed
  message, a val blob copied to the other shard;
- tests/test_gc.py: a chain whose every link crosses shards;
- tests/test_mute.py: the cross-shard mute cycle with and without aging,
  and the cross-shard aging veto;
- tests/test_lifecycle.py: spawns stay on their parent's shard, and the
  spawn/destroy churn over four shards;
- tests/test_megakernel.py: a mesh world under delivery="pallas_mega" is
  ineligible for the window kernel and runs the plain window;
- the tuner on a mesh, and the watchdog tripping a wedged sharded run.

Where the reference checks a sequential oracle, the port is held to that
oracle; elsewhere to the JAX package's run of the same program (on its
virtual CPU mesh, tests/conftest.py) and to the reference test's own
assertions. All values are integers: exact equality."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ponyc_tpu
import ponyc_tpu_torch
import test_differential as td
import test_torch_flight as TF
from ponyc_tpu_torch import flight
from ponyc_tpu_torch.ops import megakernel
from ponyc_tpu_torch.runtime import engine as tengine

from _torch_programs import (IN_SLOTS, _host, blob_world, build_fifo,
                             build_walkers, churn, counters, define,
                             define_blobs, new_runtime, run_blob_chain,
                             run_blob_fifo)

JT, TT = define(ponyc_tpu), define(ponyc_tpu_torch)
JB, TB = define_blobs(ponyc_tpu), define_blobs(ponyc_tpu_torch)
PKGS = {"jax": (ponyc_tpu, JT, JB), "torch": (ponyc_tpu_torch, TT, TB)}

@pytest.fixture(autouse=True)
def one_thread():
    """A shard's tick is a few hundred small eager ops: torch's intra-op
    threads only contend with the other test workers for the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)



# --- tests/test_differential.py ------------------------------------------

MESH4 = dict(mailbox_cap=4, batch=2, msg_words=1, max_sends=2,
             spill_cap=1024, inject_slots=32, mesh_shards=4,
             quiesce_interval=2)
DIFF = {
    "mesh4": MESH4,
    "mesh4-tiny-bucket": dict(mailbox_cap=2, batch=1, msg_words=1,
                              max_sends=2, spill_cap=2048, inject_slots=32,
                              mesh_shards=4, route_bucket=8,
                              quiesce_interval=1),
    "mesh4-fused": dict(MESH4, pallas_fused=True),
}


def _walkers_vs_oracle(seed, n_w, n_s, okw):
    w_nxt, s_w, s_s, seeds = td._case(seed, n_w, n_s)
    want = td.oracle(n_w, n_s, w_nxt, s_w, s_s, seeds)
    rt = build_walkers(ponyc_tpu_torch, TT, seed, n_w=n_w, n_s=n_s, **okw)
    assert rt.mesh is not None and rt.mesh.n_shards == okw["mesh_shards"]
    assert rt.run(max_steps=100_000) == 0
    w, s = rt.cohort_state(TT.Walker), rt.cohort_state(TT.Splitter)
    got = (w["acc"][:n_w], w["hits"][:n_w], s["acc"][:n_s])
    for g, x, what in zip(got, want, ("w_acc", "w_hits", "s_acc")):
        np.testing.assert_array_equal(g.astype(np.int64), x, err_msg=what)
    return rt


@pytest.mark.parametrize("name", DIFF)
@pytest.mark.parametrize("seed", [7, 23])
def test_walkers_on_mesh_match_oracle(name, seed):
    rt = _walkers_vs_oracle(seed, 24, 8, DIFF[name])
    assert not _host(rt.state.muted).any()
    if name == "mesh4-fused":
        assert rt._multi_g.fused, "no cohort took the fused dispatch"


def test_walkers_on_mesh_under_auto_match_oracle():
    """delivery="auto" and pallas_fused="auto" on a mesh: the tuner times
    plan and cosort, with and without the fused kernel, never the window
    kernel (a mesh is not eligible), on its workload spread over every
    shard's rows; the chosen formulation gives the oracle."""
    rt = _walkers_vs_oracle(7, 24, 8, dict(
        MESH4, delivery="auto", pallas_fused="auto", tuning_ticks=2,
        tuning_repeats=1))
    rec = rt.tuning_record
    assert rec["source"] == "calibrated"
    assert set(rec["variants"]) == {"plan", "cosort", "plan+fused",
                                    "cosort+fused"}
    assert all(v is not None for v in rec["table"].values())


def test_uneven_cohorts_on_mesh_match_oracle():
    """Cohorts of 37 and 11 over 4 shards: the padded rows stay inert."""
    _walkers_vs_oracle(51, 37, 11, dict(
        mailbox_cap=2, batch=1, msg_words=1, max_sends=2, spill_cap=2048,
        inject_slots=32, mesh_shards=4, quiesce_interval=2))


@pytest.mark.parametrize("bucket", [0, 2])
def test_blob_chain_on_two_shards_matches_oracle(bucket):
    """Bucket 2: blob-carrying messages park in the route spill and
    migrate only when the retry ships (run_blob_chain checks the oracle,
    that every blob was freed and that none arrived dead)."""
    rt = run_blob_chain(ponyc_tpu_torch, TB, 77, dict(
        mailbox_cap=2, batch=1, max_sends=1, spill_cap=1024,
        inject_slots=16, mesh_shards=2, route_bucket=bucket), n=16)
    assert rt.counter("n_blob_moved") > 0, "no chain crossed shards"
    assert rt.counter("n_blob_remote") == 0


# --- tests/test_fifo.py --------------------------------------------------

def test_per_edge_fifo_mesh4_route_spill():
    items = 60
    rt = build_fifo(ponyc_tpu_torch, TT, 101, n_cons=6, items=items,
                    mailbox_cap=2, batch=1, max_sends=3, spill_cap=4096,
                    inject_slots=32, mesh_shards=4, route_bucket=8,
                    quiesce_interval=2)
    assert rt.run(max_steps=500_000) == 0
    # Six consumers over four shards: the cohort pads to eight slots.
    st = {k: v[:6] for k, v in rt.cohort_state(TT.Cons).items()}
    assert not st["bad"].any(), "FIFO violation"
    for s in range(IN_SLOTS):
        assert (st[f"last{s}"] == items - 1).all()
    assert (st["got"] == IN_SLOTS * items).all()
    assert (rt.cohort_state(TT.Prod)["seq"] == items).all()


def test_blob_payload_binding_fifo_mesh4_bucket():
    rt = run_blob_fifo(ponyc_tpu_torch, TB, 11, dict(
        mailbox_cap=2, batch=1, max_sends=2, spill_cap=4096,
        inject_slots=32, mesh_shards=4, route_bucket=4, quiesce_interval=2))
    assert rt.counter("n_blob_moved") > 0


# --- tests/test_blobs.py -------------------------------------------------

BLOB_OPTS = dict(mailbox_cap=4, batch=2, max_sends=1, msg_words=2,
                 inject_slots=8, blob_slots=16, blob_words=8, mesh_shards=2)


def _near(which):
    pkg, _T, B = PKGS[which]
    rt = new_runtime(pkg, BLOB_OPTS)
    rt.declare(B.Consumer, 4).start()
    c0 = rt.spawn(B.Consumer, total=0, seen=0)    # slot 0 → shard 0
    c1 = rt.spawn(B.Consumer, total=0, seen=0)    # slot 1 → shard 1
    h0 = rt.blob_store([7, 7, 7, 7], near=int(c0))
    h1 = rt.blob_store([9, 9, 9, 9], near=int(c1))
    rt.send(int(c0), B.Consumer.take, h0)
    rt.send(int(c1), B.Consumer.take, h1)
    rt.run(max_steps=10)
    return (int(h0), int(h1), rt.state_of(int(c0))["total"],
            rt.state_of(int(c1))["total"], blob_world(rt, B.Consumer))


def test_blob_store_near_targets_receiver_shard():
    from ponyc_tpu_torch.ops import pack
    t = _near("torch")
    assert t == _near("jax")
    h0, h1, tot0, tot1, world = t
    assert pack.blob_slot(h0) // BLOB_OPTS["blob_slots"] == 0
    assert pack.blob_slot(h1) // BLOB_OPTS["blob_slots"] == 1
    assert (tot0, tot1) == (28, 36)
    assert world["counters"]["n_blob_remote"] == 0


def _migrate(which):
    pkg, _T, B = PKGS[which]
    rt = new_runtime(pkg, BLOB_OPTS)
    rt.declare(B.Producer, 4).declare(B.Consumer, 4).start()
    rt.spawn(B.Consumer, total=0, seen=0)          # slot 0 → shard 0
    c2 = rt.spawn(B.Consumer, total=0, seen=0)     # slot 1 → shard 1
    p1 = rt.spawn(B.Producer, out=c2)              # shard 0: routes
    rt.send(p1, B.Producer.go, 3)
    rt.run(max_steps=10)
    first = (rt.state_of(int(c2)), rt.counter("n_blob_moved"),
             rt.counter("n_blob_remote"), rt.blobs_in_use)
    p2 = rt.spawn(B.Producer, out=c2)              # shard 1: local
    rt.send(p2, B.Producer.go, 5)
    rt.run(max_steps=10)
    return first, (rt.state_of(int(c2)), rt.counter("n_blob_moved"),
                   rt.blobs_in_use), blob_world(rt, B.Producer, B.Consumer)


def test_mesh_blob_migrates_with_routed_message():
    t = _migrate("torch")
    assert t == _migrate("jax")
    (st1, moved1, remote1, used1), (st2, moved2, used2), _w = t
    assert st1 == {"total": 30 + 31 + 32 + 33, "seen": 4}
    assert (moved1, remote1, used1) == (1, 0, 0)
    assert st2["total"] == 126 + 50 + 51 + 52 + 53
    assert (moved2, used2) == (1, 0)      # same-shard: nothing migrates


def _val_copy(which):
    pkg, _T, B = PKGS[which]
    rt = new_runtime(pkg, BLOB_OPTS)
    rt.declare(B.Caster, 2).declare(B.ValReader, 4).start()
    r_local = rt.spawn(B.ValReader, got=0)    # slot 0 → shard 0
    r_remote = rt.spawn(B.ValReader, got=0)   # slot 1 → shard 1
    c = rt.spawn(B.Caster, a=r_local, b=r_remote)
    rt.send(c, B.Caster.cast, 41)
    rt.run(max_steps=10)
    out = (rt.state_of(int(r_local))["got"], rt.state_of(int(r_remote))[
        "got"], rt.counter("n_blob_moved"), rt.blobs_in_use)
    return out, rt.gc(), rt.blobs_in_use, blob_world(rt, B.Caster,
                                                     B.ValReader)


def test_mesh_val_blob_copies_not_moves():
    """A frozen blob sent to readers on both shards: the off-shard one
    gets a copy, the source stays; the collector reclaims both."""
    t = _val_copy("torch")
    assert t == _val_copy("jax")
    (got_l, got_r, moved, used), _n, used_after, _w = t
    assert got_l == got_r == 41 + 82
    assert (moved, used, used_after) == (1, 2, 0)


# --- tests/test_gc.py ----------------------------------------------------

def _gc_chain(which):
    pkg, _T, B = PKGS[which]
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=1, max_sends=1,
                               msg_words=2, inject_slots=8, spill_cap=64,
                               mesh_shards=4))
    rt.declare(B.GNode, 16).start()
    ids = rt.spawn_many(B.GNode, 16)
    nl = rt.program.n_local
    order = sorted(range(16), key=lambda s: int(ids[s]) // nl)
    for i in range(15):          # each node links one on the next shard
        rt.send(int(ids[order[i]]), B.GNode.link, int(ids[order[i + 1]]))
    rt.run(max_steps=10)
    rt.release(ids)
    rt.pin([ids[order[0]]])
    first = rt.gc()
    rt.release([ids[order[0]]])
    return first, rt.gc(), int(_host(rt.state.alive).sum()), counters(rt)


def test_gc_on_mesh_crosses_shards():
    t = _gc_chain("torch")
    assert t == _gc_chain("jax")
    assert t[:3] == (0, 16, 0)     # pinned root: all reachable; then none


# --- tests/test_mute.py --------------------------------------------------

def define_mute(pkg):
    """tests/test_mute.py's Flooder, Pusher, Slow and Fast."""
    actor, behaviour, I32, Ref = (pkg.actor, pkg.behaviour, pkg.I32,
                                  pkg.Ref)

    @actor
    class Flooder:
        peer: Ref
        got: I32
        BATCH = 1
        MAX_SENDS = 2

        @behaviour
        def ping(self, st, v: I32):
            self.send(st["peer"], Flooder.ping, v - 1, when=v > 0)
            self.send(st["peer"], Flooder.ping, v - 1, when=v > 0)
            return {**st, "got": st["got"] + 1}

    @actor
    class Slow:
        total: I32
        BATCH = 1

        @behaviour
        def consume(self, st, v: I32):
            return {**st, "total": st["total"] + v}

    @actor
    class Fast:
        total: I32
        BATCH = 4

        @behaviour
        def consume(self, st, v: I32):
            return {**st, "total": st["total"] + v}

    @actor
    class Pusher:
        slow: Ref
        fast: Ref
        left: I32
        MAX_SENDS = 3

        @behaviour
        def produce(self, st, n: I32):
            self.send(st["slow"], Slow.consume, 1, when=n > 0)
            self.send(st["fast"], Fast.consume, 1, when=n > 0)
            self.send(self.actor_id, Pusher.produce, n - 1, when=n > 0)
            return {**st, "left": n - 1}

    return Flooder, Slow, Fast, Pusher


TM = define_mute(ponyc_tpu_torch)


def _flood_pair_mesh(mute_age_limit):
    """Two Flooders on two shards, route-muted against each other by a
    one-entry route bucket within ten ticks (the reference's
    _flood_pair_mesh, its ticks stepped through engine.build_step)."""
    Flooder = TM[0]
    rt = new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=4, batch=1, msg_words=1, max_sends=2, spill_cap=2048,
        inject_slots=8, mute_age_limit=mute_age_limit, mesh_shards=2,
        route_bucket=1, quiesce_interval=1))
    rt.declare(Flooder, 2).start()
    a = rt.spawn(Flooder)
    b = rt.spawn(Flooder, peer=a)
    rt.set_fields(Flooder, np.asarray([a]), peer=np.asarray([b]))
    rt.bulk_send(np.asarray([a, b]), Flooder.ping, np.asarray([8, 8]))
    step = tengine.build_step(rt.program, rt.opts)
    st, _aux = step(rt.state, *rt._drain_inject_tracked()[:2])
    for _ in range(9):
        st, _aux = step(st, *rt._empty_inject)
    muted, refs = _host(st.muted), _host(st.mute_refs)
    assert muted.all(), f"pair not mutually route-muted: {muted}"
    assert b in refs[:, a] and a in refs[:, b], refs
    occ = _host(st.tail) - _host(st.head)
    assert (occ > rt.opts.unmute_occ).all(), occ
    rt.state = st
    return rt


@pytest.mark.parametrize("age", [4, 0], ids=["aging", "no-aging"])
def test_cross_shard_mute_cycle_drains(age):
    """With aging the cycle is broken; without it the remote-ref release
    (once the local route spill drains) frees each side in turn. Either
    way all 2 × (2^9 - 1) dispatches run and nobody stays muted."""
    rt = _flood_pair_mesh(age)
    rt.run(max_steps=8000 if age else 20_000)
    st = rt.state
    assert not _host(st.muted).any()
    assert int(_host(st.type_state["Flooder"]["got"]).sum()) == 2 * 511
    if age:
        assert ((_host(st.tail) - _host(st.head)) == 0).all()
        assert int(_host(st.rspill_count).sum()) == 0


def test_aged_release_waits_cross_shard():
    """The cross-shard aging veto (tests/test_mute.py:326): with
    aggressive aging, no sender is released past a live-congested local
    muter, nor past a remote one while its shard's route spill holds
    messages; the fan-in finishes and nobody stays muted."""
    Flooder, Slow, Fast, Pusher = TM
    n_pushers, items = 32, 40
    rt = new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=8, batch=2, msg_words=1, max_sends=3, spill_cap=4096,
        inject_slots=64, mute_age_limit=2, mesh_shards=4,
        quiesce_interval=1, route_bucket=8))
    rt.declare(Pusher, n_pushers).declare(Slow, 1).declare(Fast, 1).start()
    slow, fast = rt.spawn(Slow), rt.spawn(Fast)
    ids = rt.spawn_many(Pusher, n_pushers, slow=slow, fast=fast)
    rt.bulk_send(ids, Pusher.produce, [items] * n_pushers)
    p, nl = rt.program.shards, rt.program.n_local
    unmute_occ = rt.opts.unmute_occ
    prev, max_age, cross = None, 0, 0
    for _ in range(4000):
        st = rt.state
        muted = _host(st.muted)
        occ = _host(st.tail) - _host(st.head)
        refs, alive, ovf = (_host(st.mute_refs), _host(st.alive),
                            _host(st.mute_ovf))
        dsp = _host(st.dspill_tgt).reshape(p, -1)
        pending = np.zeros(rt.program.total, bool)
        for s in range(p):
            pending[s * nl + dsp[s][dsp[s] >= 0]] = True
        if prev is not None:
            for g in np.nonzero(prev["muted"] & ~muted)[0]:
                if prev["ovf"][g]:
                    continue
                rs = prev["refs"][:, g]
                rs = rs[rs >= 0]
                local, remote = rs[rs // nl == g // nl], rs[rs // nl != g // nl]
                live = [r for r in rs
                        if (prev["occ"][r] > unmute_occ or prev["pending"][r])
                        and prev["alive"][r] and not prev["muted"][r]]
                assert not [r for r in live if r in local], (
                    f"sender {g} released past a live local muter")
                assert not (len(remote) and prev["rspill"][g // nl] > 0), (
                    f"sender {g} released while its shard's route spill "
                    "held messages")
        cross += sum(any(r >= 0 and r // nl != g // nl for r in refs[:, g])
                     for g in np.nonzero(muted)[0])
        max_age = max(max_age, int(_host(st.mute_age).max()))
        prev = dict(muted=muted, occ=occ, refs=refs, alive=alive,
                    pending=pending, ovf=ovf, rspill=_host(st.rspill_count))
        rt.run(max_steps=1)
        if (rt.state_of(slow)["total"] == n_pushers * items
                and rt.state_of(fast)["total"] == n_pushers * items):
            break
    assert rt.state_of(slow)["total"] == n_pushers * items
    assert rt.state_of(fast)["total"] == n_pushers * items
    assert cross > 0, "never saw a cross-shard mute ref"
    assert max_age >= 2 * rt.opts.mute_age_limit, max_age
    rt.run(max_steps=100)
    assert not _host(rt.state.muted).any()


# --- tests/test_lifecycle.py ---------------------------------------------

def _bosses(which):
    pkg, T, _B = PKGS[which]
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=1, max_sends=2,
                               msg_words=2, spill_cap=64, inject_slots=8,
                               mesh_shards=4))
    rt.declare(T.Worker, 16).declare(T.Boss, 4).start()
    bosses = rt.spawn_many(T.Boss, 4)
    for b in bosses:
        rt.send(int(b), T.Boss.go, 2)
    rt.run(max_steps=30)
    return ([int(b) for b in bosses], [rt.state_of(int(b)) for b in bosses],
            rt.counter("n_spawned"), counters(rt), rt.steps_run,
            _host(rt.state.alive).tolist())


def test_spawn_on_mesh_stays_shard_local():
    t = _bosses("torch")
    assert t == _bosses("jax")
    bosses, states, n_spawned = t[:3]
    assert n_spawned == 8
    nl = 4 + 1      # Worker 16 / 4 shards + Boss 4 / 4 shards
    for b, s in zip(bosses, states):
        assert s["last_child"] // nl == b // nl   # the parent's shard
        assert s["n_started"] == 2


def test_spawn_destroy_churn_on_mesh():
    """Same-shard spawn slots, cross-shard constructor and report
    messages, exact conservation against the chain's oracle, and equal
    to the JAX package's run of the same program."""
    out = {}
    for which in ("jax", "torch"):
        pkg, T, _B = PKGS[which]
        rt, sink, total, hits = churn(pkg, T, 5, mesh_shards=4,
                                      quiesce_interval=2, cd_interval=16)
        assert rt.run(max_steps=100_000) == 0
        st = rt.state_of(int(sink))
        assert (st["total"], st["hits"]) == (total, hits)
        assert rt.counter("n_spawned") == rt.counter("n_destroyed") == hits
        out[which] = (counters(rt), rt.steps_run, st)
    assert out["torch"] == out["jax"]


# --- tests/test_megakernel.py --------------------------------------------

def test_mesh_world_is_not_window_kernel_eligible():
    """mesh_shards > 1 is outside the window kernel's one-shard contract:
    under delivery="pallas_mega" the runtime builds the plain window over
    the mesh and its answers equal the plain delivery's."""
    from ponyc_tpu_torch.models import ubench
    okw = dict(mailbox_cap=4, batch=2, max_sends=1, msg_words=1,
               spill_cap=256, inject_slots=16, mesh_shards=4,
               quiesce_interval=2, tuning_cache="off")
    out = []
    for delivery in ("pallas_mega", "plan"):
        rt, ids = ubench.build(16, ponyc_tpu_torch.RuntimeOptions(
            delivery=delivery, **okw), pings=2, device="cpu")
        assert not megakernel.eligible(rt.program, rt.opts)
        assert not isinstance(rt._multi_g, megakernel.MegaWindow)
        ubench.seed_all(rt, ids, hops=40, pings=2)
        assert rt.run() == 0
        out.append((counters(rt), rt.steps_run,
                    rt.cohort_state(ubench.Pinger)["pings"].tolist()))
    assert out[0] == out[1] and out[0][0]["n_processed"] > 0


# --- the watchdog over a mesh (flight.py) ----------------------------------

def test_watchdog_trips_wedged_mesh_run_subprocess(tmp_path):
    """A host behaviour wedged on a 2-shard world: the run still ends in
    PonyStallError (code 7) from the watchdog, with a postmortem, as on
    one shard (tests/test_torch_flight.py's stall script, sharded)."""
    code = TF.STALL_SCRIPT.format(
        tests=os.path.join(TF.ROOT, "tests"),
        apath=str(tmp_path / "stall.csv")).replace(
            "watchdog_s=0.6,", "watchdog_s=0.6, mesh_shards=2,")
    assert "mesh_shards=2" in code
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=TF.ROOT, env=TF._env())
    assert p.returncode == 42, (p.returncode, p.stdout, p.stderr)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["code"] == 7 and out["phase"] == "host-work"
    pm = flight.load_postmortem(out["postmortem"])
    assert pm["watchdog"]["tripped"]["phase"] == "host-work"

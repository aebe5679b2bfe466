"""The window kernel's own source (csrc/mega_window.cu), built for the
host CPU, against its plain version, the port's plain window, on every
program of the slice: each window a program's `Runtime.run()` dispatches
with delivery="pallas_mega" runs both ways from the same input, and every
state leaf, every aux value and `ticks_run` must be equal. Integers
(and bools) are compared exactly; the float fields of mixed and nbody
within rtol 1e-6 with an absolute floor of 1e-6 of the largest value, the
tolerance tests/test_torch_models.py states (the host build and torch's CPU
kernels may round a float32 body differently). The worlds are small and
made from numpy seeds. Skips where the box has no host C++ compiler."""

import dataclasses

import numpy as np
import pytest
import torch

import ponyc_tpu_torch
from ponyc_tpu_torch import RuntimeOptions
from ponyc_tpu_torch.models import mixed, nbody, ring, ubench
from ponyc_tpu_torch.ops import _build
from ponyc_tpu_torch.ops.megakernel import (GRID_MAX, MegaWindow,
                                            grid_blocks, radix_plan,
                                            tick_sort)
from ponyc_tpu_torch.runtime import engine

from _torch_programs import (CORPUS, build_fifo, build_mixers,
                             build_walkers, define, run_corpus)

TT = define(ponyc_tpu_torch)
MEGA = dict(delivery="pallas_mega")         # for the shared builders
OPTS = dict(MEGA, tuning_cache="off")       # for RuntimeOptions


def _leaves(x, name):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{name}.{k}")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{name}.{f.name}")
    elif isinstance(x, tuple):
        names = getattr(x, "_fields", None) or range(len(x))
        for k, v in zip(names, x):
            yield from _leaves(v, f"{name}.{k}")
    else:
        yield name, x


def assert_same_window(got, want, where):
    for (name, x), (_, y) in zip(_leaves(got, "out"), _leaves(want, "out")):
        assert x.dtype == y.dtype and x.shape == y.shape, (where, name)
        if x.dtype == torch.float32:
            scale = float(y.abs().max()) if y.numel() else 0.0
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                       atol=1e-6 * scale,
                                       err_msg=f"{where} {name}")
        else:
            assert torch.equal(x, y), (where, name, x, y)


@pytest.fixture
def host_checked(monkeypatch):
    """Every window the run dispatches also runs as the host build, and
    the two must agree; returns the list of (ticks, forced) checked."""
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernel's source")
    seen = []
    plain = MegaWindow._dispatch

    def checked(self, st, it, iw, limit, force, prev_aux, probe, forced):
        want = plain(self, st, it, iw, limit, force, prev_aux, None, forced)
        got = self.run_host(st, it, iw, limit, force,
                            engine.zero_aux("cpu") if forced else prev_aux,
                            forced=forced)
        assert_same_window(got, want, f"window {len(seen)}")
        seen.append((int(want[2]), forced))
        return want

    monkeypatch.setattr(MegaWindow, "_dispatch", checked)
    return seen


def _ran(seen):
    assert seen and sum(k for k, _ in seen) > 0
    return sum(k for k, _ in seen)


@pytest.mark.parametrize("hops", [1000, 1 << 20])
def test_ubench(host_checked, hops):
    """16 pingers (cap 4, batch 2); hops 2^20 keeps every payload in the
    escape plane."""
    opts = RuntimeOptions(mailbox_cap=4, batch=2, max_sends=1, msg_words=1,
                          spill_cap=64, inject_slots=8, quiesce_interval=4,
                          **OPTS)
    rt, ids = ubench.build(16, opts, pings=2, device="cpu")
    ubench.seed_all(rt, ids, hops=hops, pings=2)
    rt.run(max_steps=12)
    assert _ran(host_checked) >= 12
    assert rt.counter("n_processed") == 16 * 2 * 12


def test_ring(host_checked):
    rt = ring.run(32, 100, opts=RuntimeOptions(
        mailbox_cap=8, batch=1, max_sends=1, msg_words=1, spill_cap=128,
        inject_slots=8, quiesce_interval=16, **OPTS), device="cpu")
    _ran(host_checked)
    assert int(rt.cohort_state(ring.RingNode)["passes"].sum()) == 100


@pytest.mark.parametrize("age", [0, 4])
def test_walkers_spill_mute_unmute(host_checked, age):
    rt = build_walkers(ponyc_tpu_torch, TT, 7, n_seeds=30, mailbox_cap=2,
                       batch=1, msg_words=1, max_sends=2, spill_cap=512,
                       inject_slots=16, mute_age_limit=age,
                       quiesce_interval=8, **MEGA)
    rt.run(max_steps=400)
    _ran(host_checked)
    assert rt.counter("n_mutes") > 0 and rt.counter("n_rejected") > 0


def test_fifo(host_checked):
    rt = build_fifo(ponyc_tpu_torch, TT, 3, mailbox_cap=4, batch=2,
                    spill_cap=512, inject_slots=16, quiesce_interval=8,
                    **MEGA)
    rt.run(max_steps=400)
    _ran(host_checked)
    assert int(rt.cohort_state(TT.Cons)["bad"].sum()) == 0


@pytest.mark.parametrize("name", CORPUS)
def test_corpus(host_checked, name):
    out = run_corpus(ponyc_tpu_torch, TT, name, device="cpu",
                     quiesce_interval=4, **MEGA)
    _ran(host_checked)
    assert out["steps"] > 0


def test_mixers_every_effect(host_checked):
    rt = build_mixers(ponyc_tpu_torch, TT, 5, mailbox_cap=4, spill_cap=256,
                      inject_slots=32, quiesce_interval=8, **MEGA)
    rt.run(max_steps=300)
    _ran(host_checked)
    assert rt.counter("n_destroyed") + rt.counter("n_errors") > 0


def test_mixed(host_checked):
    rt, ids, wt = mixed.build(64, 4, RuntimeOptions(
        mailbox_cap=4, batch=1, max_sends=1, msg_words=1, spill_cap=256,
        inject_slots=8, quiesce_interval=3, **OPTS), work=4, device="cpu")
    mixed.seed_all(rt, ids, wt, hops=1 << 30, mix=True)
    rt.run(max_steps=6)
    assert _ran(host_checked) >= 6
    assert rt.counter("n_processed") == 64 * 6


def test_nbody(host_checked):
    rt = nbody.run_round(24, RuntimeOptions(
        mailbox_cap=16, batch=4, max_sends=1, msg_words=4, spill_cap=1024,
        quiesce_interval=16, **OPTS), device="cpu")
    _ran(host_checked)
    assert (rt.cohort_state(nbody.Body)["seen"] == 23).all()


def test_forced_spelling(host_checked):
    opts = RuntimeOptions(mailbox_cap=4, batch=2, max_sends=1, msg_words=1,
                          spill_cap=64, inject_slots=8, **OPTS)
    rt, ids = ubench.build(16, opts, pings=2, device="cpu")
    ubench.seed_all(rt, ids, hops=1000, pings=2)
    forced = engine.build_forced_window(rt.program, rt.opts, rt._multi_g)
    it, iw, _ = rt._drain_inject_tracked()
    st, _aux, k = forced(rt.state, it, iw, 5)
    assert int(k) == 5 and host_checked == [(5, True)]
    # Injections land every tick: 16 pingers x 2 pings, five times over.
    assert int(st.n_delivered[0]) > 32


def test_gated_out_window(host_checked):
    """force=False with a quiet previous aux: no tick runs, and the
    previous aux comes back unchanged."""
    opts = RuntimeOptions(mailbox_cap=4, batch=2, max_sends=1, msg_words=1,
                          spill_cap=64, inject_slots=8, **OPTS)
    rt, ids = ubench.build(16, opts, pings=1, device="cpu")
    quiet = engine.aux_to_device(
        engine.aux_from_vector([0] * 9 + [7, 9] + [0] * 10)[1], "cpu")
    st, aux, k = rt._multi_g(rt.state, *rt._empty_inject, 4, False, quiet)
    assert int(k) == 0 and host_checked == [(0, False)]
    assert all(torch.equal(a, b) for a, b in zip(aux, quiet))
    got = rt._multi_g.run_host(rt.state, *rt._empty_inject, 4, False, quiet)
    assert int(got[2]) == 0
    assert all(torch.equal(a, b) for a, b in zip(got[1], quiet))


# ---- the redesign's branches: radix passes, sorts, ticks within and
# beyond one tile, grid ----------------------------------------------------

H100_RESIDENT = 4 * 132      # a grid of 4 blocks an SM on 132 SMs
TILE = 4096                  # entries of one tile of the kernel's sort


@pytest.mark.parametrize("key_max,plan", [
    (1, (1, 1)), (64 * 3, (1, 8)), (512 * 3, (1, 11)), (2047, (1, 11)),
    (2048, (2, 6)), (1024 * 3, (2, 6)), ((1 << 20) * 3, (2, 11)),
    ((1 << 22) - 1, (2, 11)), (1 << 22, (3, 8)), ((1 << 31) - 1, (3, 11))])
def test_radix_plan(key_max, plan):
    """The fewest passes of at most 11-bit digits: two for any key range
    under 2^22 (ubench's and mixed's 2^20 x 3), one up to 11 bits."""
    assert radix_plan(key_max) == plan
    npass, dbits = plan
    assert npass * dbits >= key_max.bit_length() and dbits <= 11


@pytest.mark.parametrize("nl,e,grid", [
    (1024, 9352, 37),                    # the ring: entries are widest
    (1 << 20, 4196360, H100_RESIDENT),   # ubench: capped by residency
    (32, 296, 2), (1, 1, 1), (70000, 100, 274)])
def test_grid_blocks(nl, e, grid):
    """The grid is the smaller of what is resident and what the widest
    phase (one thread a lane or an entry) can use."""
    assert grid_blocks(H100_RESIDENT, nl, e) == grid
    assert grid_blocks(1, nl, e) == 1
    # Never more blocks than the kernel's table of per-block digit counts.
    assert grid_blocks(4096, nl, e) == min(max(grid, -(-max(nl, e) // 256)),
                                           GRID_MAX)


# World overrides that choose a tick's sort: the segment tick's largest
# segment (-1: never, so every tick takes the radix sort).
SORTS = {"segment": {}, "radix": dict(SEG=-1)}


def _passes(w, npass):
    """World `w`'s radix sort in `npass` passes of equal digits."""
    bits = (w["NL"] * w["NLEV"]).bit_length()
    w["NPASS"], w["DBITS"] = npass, -(-bits // npass)


def test_constants_match_the_kernel_source():
    """The wrapper's copies of the kernel's limits agree with
    csrc/mega_window.cu: the block-count table, the tile the tests'
    worlds fit or exceed and the widest digit."""
    import re
    from ponyc_tpu_torch.ops import megakernel as mk
    src = open(mk.SRC).read()
    threads = int(re.search(r"int THREADS = (\d+);", src).group(1))
    items = int(re.search(r"int ITEMS = (\d+);", src).group(1))
    assert int(re.search(r"GMAX = (\d+);", src).group(1)) == GRID_MAX
    assert TILE == threads * items
    assert re.search(r"RADIX <= %d" % (1 << mk.DIGIT_BITS_MAX), src)


def _pingers(n, pings, cap, sort=None, plan=None, hops=1 << 20):
    opts = RuntimeOptions(mailbox_cap=cap, batch=pings, max_sends=1,
                          msg_words=1, spill_cap=64, inject_slots=8,
                          quiesce_interval=3, **OPTS)
    rt, ids = ubench.build(n, opts, pings=pings, device="cpu")
    w = rt._multi_g.world
    w.update(SORTS[sort] if sort else {})
    if plan is not None:
        w["NPASS"], w["DBITS"] = plan
    ubench.seed_all(rt, ids, hops=hops, pings=pings)
    return rt


@pytest.mark.parametrize("n,pings,cap,plan,npass", [
    (512, 16, 16, None, 1),          # keys under 2^11: one pass
    (4096, 2, 4, None, 2),           # 14-bit keys: two passes of 7 bits
    (4096, 2, 4, (3, 5), 3)])        # the same keys in three passes
def test_radix_passes(host_checked, n, pings, cap, plan, npass):
    """Ticks of 8192 live entries (more than one tile), with the segment
    tick ruled out, take the radix sort; the number of passes follows the
    key range."""
    rt = _pingers(n, pings, cap, sort="radix", plan=plan)
    assert rt._multi_g.world["NPASS"] == npass
    rt.run(max_steps=6)
    assert tick_sort(rt._multi_g.world, rt.state.plan_key) == "radix"
    assert _ran(host_checked) >= 6
    assert int(rt.state.plan_bounds[-1]) == n * pings > TILE
    assert rt.counter("n_processed") == n * pings * 6


@pytest.mark.parametrize("sort,npass", [
    ("segment", None), ("radix", 1), ("radix", 2)])
def test_small_and_wide_tick(host_checked, sort, npass):
    """64 pingers' ticks hold 128 live entries, within one tile: at the
    default thresholds they take the segment sort (per-target slots, then
    each segment sorted); with it ruled out, the radix sort (in one pass
    or two), which is what a fan-in tick within one tile takes. All equal
    the plain window."""
    rt = _pingers(64, 2, 4, sort=sort)
    if npass:
        _passes(rt._multi_g.world, npass)
    rt.run(max_steps=6)
    assert _ran(host_checked) >= 6
    assert 0 < int(rt.state.plan_bounds[-1]) <= TILE
    assert tick_sort(rt._multi_g.world, rt.state.plan_key) == sort


def test_segment_tick_at_width(host_checked):
    """4096 pingers: 8192 live entries a tick, more than one tile, and no
    target gets more than SEGMENT_MAX of them, so the ticks take the
    segment sort at the default thresholds."""
    rt = _pingers(4096, 2, 4)
    rt.run(max_steps=6)
    assert _ran(host_checked) >= 6
    assert tick_sort(rt._multi_g.world, rt.state.plan_key) == "segment"
    assert int(rt.state.plan_bounds[-1]) == 8192 > TILE


@pytest.mark.parametrize("npass", [1, 2])
@pytest.mark.parametrize("world", ["walkers", "mixers"])
def test_wide_sort_spill_mute_and_effects(host_checked, world, npass):
    """Every tick through the radix sort, in one pass or two, on the
    spill/mute and effect worlds: rejections, the spill in sorted order
    and mute triggers (the other tests' defaults take the segment
    sort)."""
    if world == "walkers":
        rt = build_walkers(ponyc_tpu_torch, TT, 7, n_seeds=30,
                           mailbox_cap=2, batch=1, msg_words=1, max_sends=2,
                           spill_cap=512, inject_slots=16, quiesce_interval=8,
                           **MEGA)
    else:
        rt = build_mixers(ponyc_tpu_torch, TT, 5, mailbox_cap=4,
                          spill_cap=256, inject_slots=32, quiesce_interval=8,
                          **MEGA)
    rt._multi_g.world.update(SORTS["radix"])
    _passes(rt._multi_g.world, npass)
    rt.run(max_steps=300)
    _ran(host_checked)
    if world == "walkers":
        assert rt.counter("n_mutes") > 0 and rt.counter("n_rejected") > 0


def test_small_world_grid_below_residency(host_checked):
    """The ring of 32 nodes: its grid is 2 blocks, well below a full
    H100's 528, and its windows equal the plain window."""
    rt = ring.run(32, 60, opts=RuntimeOptions(
        mailbox_cap=8, batch=1, max_sends=1, msg_words=1, spill_cap=128,
        inject_slots=8, quiesce_interval=16, **OPTS), device="cpu")
    w = rt._multi_g.world
    assert grid_blocks(H100_RESIDENT, w["NL"], w["E"]) < H100_RESIDENT
    _ran(host_checked)
    assert int(rt.cohort_state(ring.RingNode)["passes"].sum()) == 60


# ---- device spawns: the window kernel's census and reserve phases, the
# claims in keys, deliver and commit ----------------------------------------

def test_spawn_world_has_the_spawn_phases_others_do_not():
    """SPAWN is a constant of the generated world: only a program with
    device spawns gets the census and reserve phases."""
    from ponyc_tpu_torch.models import spawn_tree
    rt = spawn_tree.build(3, spawn_tree.options(**OPTS), device="cpu")[0]
    assert rt._multi_g.world["SPAWN"] == 1
    rt2, _ = ubench.build(16, RuntimeOptions(mailbox_cap=4, batch=2,
                                             max_sends=1, msg_words=1,
                                             **OPTS), device="cpu")
    assert rt2._multi_g.world["SPAWN"] == 0
    assert {"census", "reserve"} <= set(
        __import__("ponyc_tpu_torch.ops.megakernel", fromlist=["x"])
        .clock_phases().values())


@pytest.mark.parametrize("sort", ["segment", "radix"])
def test_spawn_tree(host_checked, sort):
    """The spawn tree at depth 6: 126 device spawns over 14 ticks, every
    window equal to the plain window."""
    from ponyc_tpu_torch.models import spawn_tree
    rt, _root = spawn_tree.build(6, spawn_tree.options(
        quiesce_interval=4, **OPTS), device="cpu")
    rt._multi_g.world.update(SORTS[sort])
    rt.run(max_steps=1000)
    assert _ran(host_checked) == rt.steps_run
    assert rt.exit_code == 64 and rt.counter("n_spawned") == 126


@pytest.mark.parametrize("seed", [301, 307])
def test_spawn_destroy_churn(host_checked, seed):
    """tests/test_lifecycle.py's churn: spawns, destroys and reuse of the
    freed rows, against its closed-form oracle."""
    from _torch_programs import churn
    rt, sink, total, hits = churn(ponyc_tpu_torch, TT, seed,
                                  quiesce_interval=8, **MEGA)
    rt.run(max_steps=100_000)
    _ran(host_checked)
    st = rt.state_of(sink)
    assert (st["total"], st["hits"]) == (total, hits)
    assert rt.counter("n_destroyed") == hits


def test_spawn_sync_world(host_checked):
    """spawn_sync: the constructor's field values (a float among them)
    land with the claim, before the same tick's probe."""
    from _torch_programs import new_runtime
    rt = new_runtime(ponyc_tpu_torch, dict(mailbox_cap=8, batch=2,
                                           max_sends=1, msg_words=3,
                                           inject_slots=8,
                                           quiesce_interval=2, **MEGA))
    # Each runnable Maker reserves batch (2) Kid rows a tick.
    rt.declare(TT.Maker, 3).declare(TT.Kid, 6).start()
    assert rt._multi_g.world["NI"] == 3
    ms = rt.spawn_many(TT.Maker, 3)
    for m in ms:
        rt.send(int(m), TT.Maker.make, int(m) + 5)
    rt.run(max_steps=20)
    _ran(host_checked)
    kids = rt.cohort_state(TT.Kid)
    assert sorted(kids["tag"].tolist()) == [0, 0, 0, 105, 106, 107]
    assert sorted(kids["frac"].tolist()) == [0.0] * 3 + [0.5] * 3
    assert rt.counter("n_spawned") == 3


def test_spawn_exhaustion_stops_the_window(host_checked):
    """A wanted spawn past the free rows: the sticky spawn fail ends the
    window on the device, and the host raises."""
    from _torch_programs import new_runtime
    rt = new_runtime(ponyc_tpu_torch, dict(mailbox_cap=8, batch=2,
                                           max_sends=1, msg_words=2,
                                           spill_cap=256, inject_slots=8,
                                           quiesce_interval=8, **MEGA))
    rt.declare(TT.Spawner, 4).declare(TT.SpawnChild, 2).start()
    for s in rt.spawn_many(TT.Spawner, 4):
        rt.send(int(s), TT.Spawner.make, 1)
    with pytest.raises(ponyc_tpu_torch.SpawnCapacityError):
        rt.run(max_steps=16)
    assert bool(rt.state.spawn_fail[0])
    _ran(host_checked)


# ---- host cohorts: host rows take delivery, and an occupied one ends the
# window on the device (host_pending) ------------------------------------

def _host_world(cap=2, n_w=16, spill=256):
    from _torch_programs import new_runtime
    rt = new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=cap, batch=1, msg_words=2, max_sends=2,
        spill_cap=spill, inject_slots=16, quiesce_interval=16, **MEGA))
    rt.declare(TT.WalkerH, n_w).declare(TT.HostLog, 1).start()
    ids = rt.spawn_many(TT.WalkerH, n_w)
    log = rt.spawn(TT.HostLog)
    rt.set_fields(TT.WalkerH, ids, nxt=np.roll(ids, -1),
                  log=np.full(n_w, log))
    return rt, ids, log


def test_host_world_has_host_rows_others_do_not():
    """HOST is a constant of the generated world: only a program with host
    cohorts gets their rings (PONY_HOSTS) and the host-row code."""
    rt, _ids, _log = _host_world()
    mw = rt._multi_g
    assert mw.world["HOST"] == 1
    assert mw.world["FH"] == rt.program.first_host_row == 16
    assert "struct PonyH0" in mw.header
    rt2, _ = ubench.build(16, RuntimeOptions(mailbox_cap=4, batch=2,
                                             max_sends=1, msg_words=1,
                                             **OPTS), device="cpu")
    mw2 = rt2._multi_g
    assert mw2.world["HOST"] == 0 and "struct PonyH" not in mw2.header
    assert "#define PONY_HOSTS(X) \n" in mw2.header


def test_host_pending_stops_the_window(host_checked):
    """An injection lands in tick 0 and a chain of 5 hops more reaches the
    host actor in tick 6: the window (force, limit 16) stops after 7
    ticks with host_pending, the host row holding the report, which the
    host's drain then runs."""
    rt, ids, log = _host_world()
    rt.send(int(ids[3]), TT.WalkerH.step, 5)
    it, iw, _ = rt._drain_inject_tracked()
    st, aux, ticks = rt._multi_g(rt.state, it, iw, 16, True,
                                 engine.zero_aux("cpu"))
    assert host_checked == [(7, False)]
    assert int(ticks) == 7 and bool(aux.host_pending)
    assert not bool(aux.device_pending)
    assert int(st.tail[log] - st.head[log]) == 1
    rt.state = st
    assert rt._drain_host() and rt.state_of(log)["ends"] == 1


def test_host_ring_fills_and_mutes_its_senders(host_checked):
    """16 walkers report to the host in one tick (tick 1, after their
    injections landed in tick 0): its ring of 2 takes two, the other 14
    spill, and the overloaded host row mutes its senders; every window of
    the run equals the plain window, and every report arrives."""
    rt, ids, log = _host_world()
    for i in ids:
        rt.send(int(i), TT.WalkerH.step, 0)
    it, iw, _ = rt._drain_inject_tracked()
    st, aux, ticks = rt._multi_g(rt.state, it, iw, 16, True,
                                 engine.zero_aux("cpu"))
    assert int(ticks) == 2 and bool(aux.host_pending)
    assert int(st.dspill_count[0]) == 14
    assert (st.dspill_tgt[:14] == log).all()
    assert int(st.muted.sum()) == int(st.n_mutes[0]) >= 14
    rt.state = st
    assert rt.run(max_steps=1000) == 0
    assert rt.state_of(log)["ends"] == 16
    assert rt.counter("n_rejected") >= 14
    assert len(host_checked) > 2

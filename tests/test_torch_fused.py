"""The port's fused dispatch (`pallas_fused=True`) against the JAX
package's fused Pallas kernel, which runs in interpret mode on the CPU as
tests/test_fused_dispatch.py runs it. One program definition serves both
packages (tests/_torch_programs.py); the port runs on the CPU, where the
fused dispatch takes its plain version (the kernel itself is held against
that on the card by chip_smoke.py and tests/test_torch_cuda.py).

Programs: message-ubench 256 x 4, the yield/exit, destroy, error_int and
three-behaviour TriF worlds of tests/test_fused_dispatch.py, and the Mixer
world that uses every effect plane. Compared: every cohort field, the
runtime counters, exit codes, ticks run, liveness and last error codes.
All compared values are integers: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import ponyc_tpu
import ponyc_tpu_torch

from _torch_programs import (CORPUS, build_mixers, counters, define,
                             new_runtime, run_corpus)

JT, TT = define(ponyc_tpu), define(ponyc_tpu_torch)


def _ubench(pkg, T, n=256, pings=4, ticks=12):
    rt = new_runtime(pkg, dict(mailbox_cap=4, batch=4, max_sends=1,
                               msg_words=1, spill_cap=256, inject_slots=8,
                               pallas_fused=True))
    rt.declare(T.Pinger, n)
    rt.start()
    ids = rt.spawn_many(T.Pinger, n)
    order = np.random.default_rng(0).permutation(n)
    nxt = np.empty(n, np.int64)
    nxt[order] = ids[np.roll(order, -1)]
    rt.set_fields(T.Pinger, ids, next_ref=nxt)
    for _ in range(pings):
        rt.bulk_send(ids, T.Pinger.ping, np.full(n, 1 << 30, np.int64))
    code = rt.run(max_steps=ticks)
    return rt, code


def test_ubench_fused_matches_jax():
    jrt, jc = _ubench(ponyc_tpu, JT)
    trt, tc = _ubench(ponyc_tpu_torch, TT)
    assert tc == jc and trt.steps_run == jrt.steps_run
    assert counters(trt) == counters(jrt)
    assert trt.counter("n_processed") == 256 * 4 * 12
    js, ts = jrt.cohort_state(JT.Pinger), trt.cohort_state(TT.Pinger)
    for f in js:
        np.testing.assert_array_equal(ts[f], np.asarray(js[f]), err_msg=f)


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_fused_matches_jax(name):
    j = run_corpus(ponyc_tpu, JT, name, pallas_fused=True)
    t = run_corpus(ponyc_tpu_torch, TT, name, pallas_fused=True)
    assert t == j


def test_corpus_outcomes():
    """The corpus worlds end as tests/test_fused_dispatch.py expects."""
    r = run_corpus(ponyc_tpu_torch, TT, "yield_exit", pallas_fused=True)
    assert r["codes"] == [0, 7] and r["fields"]["Yielder"]["n"][0] == 6
    r = run_corpus(ponyc_tpu_torch, TT, "trif", pallas_fused=True)
    assert r["fields"]["TriF"]["count"] == [4, 4, 2]
    r = run_corpus(ponyc_tpu_torch, TT, "destroy", pallas_fused=True)
    assert sum(r["alive"][:4]) == 2
    r = run_corpus(ponyc_tpu_torch, TT, "errors", pallas_fused=True)
    assert r["last_error"][:2] == [42, 0]


def test_mixers_fused_match_jax():
    res = {}
    for pkg, T in ((ponyc_tpu, JT), (ponyc_tpu_torch, TT)):
        rt = build_mixers(pkg, T, 5, pallas_fused=True)
        code = rt.run(max_steps=100_000)
        res[pkg.__name__] = (code, rt.steps_run, counters(rt),
                             {f: np.asarray(v).tolist() for f, v in
                              rt.cohort_state(T.Mixer).items()},
                             np.asarray(rt.state.last_error).tolist())
    assert res["ponyc_tpu_torch"] == res["ponyc_tpu"]


# ---- device spawns under the fused kernel: the reservation planes in,
# the claim planes and the sticky spawn fail out -------------------------

def _spawners(pkg, T, child_cap=64, n=8, ticks=32):
    """tests/test_fused_dispatch.py's spawner world: each Spawner makes
    two children, in two dispatches."""
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=2, max_sends=1,
                               msg_words=2, spill_cap=256, inject_slots=8,
                               pallas_fused=True))
    rt.declare(T.Spawner, n).declare(T.SpawnChild, child_cap).start()
    sp = rt.spawn_many(T.Spawner, n)
    for k, s in enumerate(sp):
        rt.send(int(s), T.Spawner.make, 10 + k)
        rt.send(int(s), T.Spawner.make, 50 + k)
    return rt


def test_spawning_cohort_fused_matches_jax():
    """tests/test_fused_dispatch.py:246: a spawning cohort runs the fused
    dispatch, with the JAX fused kernel's lifecycle results."""
    res = {}
    for pkg, T in ((ponyc_tpu, JT), (ponyc_tpu_torch, TT)):
        rt = _spawners(pkg, T)
        rt.run(max_steps=32)
        if pkg is ponyc_tpu_torch:
            assert [fd.name for fd in rt._multi_g.fused] == [
                "Spawner", "SpawnChild"]
        res[pkg.__name__] = (
            rt.counter("n_spawned"), rt.steps_run, counters(rt),
            {t.__name__: {f: np.asarray(v).tolist() for f, v in
                          rt.cohort_state(t).items()}
             for t in (T.Spawner, T.SpawnChild)},
            np.asarray(rt.state.alive).tolist())
    assert res["ponyc_tpu_torch"] == res["ponyc_tpu"]
    spawned, _, _, fields, _ = res["ponyc_tpu_torch"]
    assert spawned == 16 and sum(fields["Spawner"]["made"]) == 16
    assert sorted(v for v in fields["SpawnChild"]["val"] if v) == sorted(
        [10 + k for k in range(8)] + [50 + k for k in range(8)])


def test_spawn_budget_exhaustion_fused_raises():
    """tests/test_fused_dispatch.py:275: past the free rows the sticky
    spawn fail raises SpawnCapacityError under the fused dispatch in both
    packages."""
    for pkg, T in ((ponyc_tpu, JT), (ponyc_tpu_torch, TT)):
        rt = new_runtime(pkg, dict(mailbox_cap=8, batch=2, max_sends=1,
                                   msg_words=2, spill_cap=256,
                                   inject_slots=8, pallas_fused=True))
        rt.declare(T.Spawner, 4).declare(T.SpawnChild, 2).start()
        for s in rt.spawn_many(T.Spawner, 4):
            rt.send(int(s), T.Spawner.make, 1)
        with pytest.raises(pkg.SpawnCapacityError):
            rt.run(max_steps=16)


def test_spawn_tree_fused_matches_jax():
    """The spawn tree at depth 5 under pallas_fused in both packages."""
    res = {}
    for pkg, T in ((ponyc_tpu, JT), (ponyc_tpu_torch, TT)):
        rt = new_runtime(pkg, dict(mailbox_cap=8, batch=4, max_sends=3,
                                   msg_words=2, inject_slots=8,
                                   spill_cap=512, pallas_fused=True))
        rt.declare(T.Node, 4 << 5).start()
        rt.send(rt.spawn(T.Node), T.Node.grow, 5, -1)
        code = rt.run(max_steps=10_000)
        res[pkg.__name__] = (code, rt.counter("n_spawned"), rt.steps_run,
                             {f: np.asarray(v).tolist() for f, v in
                              rt.cohort_state(T.Node).items()},
                             np.asarray(rt.state.alive).tolist())
    assert res["ponyc_tpu_torch"] == res["ponyc_tpu"]
    assert res["ponyc_tpu_torch"][:2] == (32, 62)


def test_sync_constructing_cohort_takes_the_plain_dispatch():
    """A cohort that sync-constructs is not eligible for the fused kernel
    (as in the JAX package); its target still is."""
    res = {}
    for pkg, T in ((ponyc_tpu, JT), (ponyc_tpu_torch, TT)):
        rt = new_runtime(pkg, dict(mailbox_cap=8, batch=2, max_sends=1,
                                   msg_words=3, inject_slots=8,
                                   pallas_fused=True))
        rt.declare(T.Maker, 2).declare(T.Kid, 4).start()
        if pkg is ponyc_tpu_torch:
            assert [fd.name for fd in rt._multi_g.fused] == ["Kid"]
        for m in rt.spawn_many(T.Maker, 2):
            rt.send(int(m), T.Maker.make, int(m) + 3)
        code = rt.run(max_steps=10)
        res[pkg.__name__] = (code, rt.counter("n_spawned"),
                             {t.__name__: {f: np.asarray(v).tolist()
                                           for f, v in
                                           rt.cohort_state(t).items()}
                              for t in (T.Maker, T.Kid)})
    assert res["ponyc_tpu_torch"] == res["ponyc_tpu"]
    assert res["ponyc_tpu_torch"][2]["Kid"]["frac"].count(0.5) == 2


SPAWN_COHORTS = [
    (("Node",), dict(mailbox_cap=8, batch=4, max_sends=3, msg_words=2)),
    (("Boss", "Worker"), dict(mailbox_cap=8, batch=2, max_sends=2,
                              msg_words=2)),
    (("Spawner", "SpawnChild"), dict(mailbox_cap=8, batch=2, max_sends=1,
                                     msg_words=2))]


def _flat(x, name="out"):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _flat(x[k], f"{name}.{k}")
    elif isinstance(x, tuple):
        for k, v in enumerate(x):
            yield from _flat(v, f"{name}.{k}")
    else:
        yield name, x


@pytest.mark.parametrize("names,okw", SPAWN_COHORTS,
                         ids=["tree", "boss", "spawner"])
def test_host_build_with_spawn_planes_equals_plain(names, okw):
    """The fused kernel's source, built for the host CPU, against its
    plain version on seeded inputs with reservation planes (about one ref
    in five -1): every output, the claim planes and the spawn fail
    included, equal."""
    from ponyc_tpu_torch import RuntimeOptions
    from ponyc_tpu_torch.ops import _build
    from ponyc_tpu_torch.ops import fused_dispatch as fdm
    from ponyc_tpu_torch.program import Program
    from ponyc_tpu_torch.runtime.engine import spawn_meta_of
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernel's source")
    opts = RuntimeOptions(tuning_cache="off", pallas_fused=True, **okw)
    prog = Program(opts)
    for n in names:
        prog.declare(getattr(TT, n), 257)
    prog.finalize()
    ch = prog.by_type[getattr(TT, names[0])]
    fd = fdm.build_fused_dispatch(ch, opts, spawn_meta_of(prog, ch))
    for seed in range(2):
        inputs = fd.sample_inputs(seed)
        got, want = fd.run_host(*inputs), fd.plain(*inputs)
        for (name, x), (_, y) in zip(_flat(got), _flat(want)):
            if y is None:
                assert x is None, name
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(x, y), (seed, name)
        claims = torch.cat(want[9])
        assert (claims >= 0).any() and (claims < 0).any()
        assert claims.shape == (ch.batch * sum(ch.spawns.values()) * 257,)

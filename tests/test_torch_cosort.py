"""Cosort delivery (`delivery="cosort"`) in the PyTorch port against the
JAX package: ubench under sustained traffic from
tests/test_delivery_modes.py (its fan-in case is in test_torch_models.py)
and the cosort cases of tests/test_differential.py (the Walker/Splitter
corpus world and the three-behaviour world of seed 506, with its
sequential oracle).

Each world runs once in the JAX package (under cosort) and on the port
on the CPU: ubench on the plain tick under plan and cosort, the
differential worlds on the plain tick and under `pallas_fused=True` (the
fused kernel's plain version). Fields, counters, exit code, ticks and
the carried delivery state (`plan_key`, `plan_perm`, `plan_bounds`:
under cosort the reference's placeholders) must be equal: all integers,
exact. A delivery-level case holds one cosort `deliver` call against the
JAX package's on overfull random entries.
"""

from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu.models import ubench as jubench
from ponyc_tpu.runtime import delivery as jdel
from ponyc_tpu_torch.models import ubench as tubench
from ponyc_tpu_torch.runtime import delivery as tdel
from ponyc_tpu_torch.runtime import engine as tengine

from _torch_programs import build_walkers, counters, define, new_runtime
from test_torch_delivery import _eq, _world

JT, TT = define(ponyc_tpu), define(ponyc_tpu_torch)
PATHS = {"plain": {}, "fused": {"pallas_fused": True}}
PLAN = ("plan_key", "plan_perm", "plan_bounds")


def _numbers(rt, types, code):
    return {"code": code, "steps": rt.steps_run, "counters": counters(rt),
            "fields": {t.__name__: {f: np.asarray(v).tolist() for f, v in
                                    rt.cohort_state(t).items()}
                       for t in types},
            "plan": {f: np.asarray(getattr(rt.state, f)).tolist()
                     for f in PLAN}}


def _same(got, want):
    assert got["code"] == want["code"]
    assert got["steps"] == want["steps"]
    assert got["counters"] == want["counters"]
    assert got["fields"] == want["fields"]
    for f in PLAN:
        assert got["plan"][f] == want["plan"][f], f


# ---------------------------------------------------------------------------
# delivery


@pytest.mark.parametrize("seed,with_pressure", [(0, False), (1, True)])
def test_cosort_deliver_matches_jax(seed, with_pressure):
    """One cosort `deliver` on overfull random entries (spill, dead and
    out-of-range targets, priority levels): every output equals the JAX
    package's cosort, and the payload outputs equal the plan path's."""
    w = _world(seed)
    kw = dict(n_local=w["n"], mailbox_cap=w["cap"],
              spill_cap=w["spill_cap"], overload_occ=2, shard_base=0,
              cohort_layout=w["layout"], mute_slots=4, n_levels=4)
    pr = w["pressured"]
    j = jdel.deliver(
        {k: jnp.asarray(v) for k, v in w["buf"].items()},
        jnp.asarray(w["head"]), jnp.asarray(w["tail"]),
        jnp.asarray(w["alive"]),
        jdel.Entries(jnp.asarray(w["tgt"]), jnp.asarray(w["sender"]),
                     jnp.asarray(w["words"])),
        level=jnp.asarray(w["level"]), cosort=True,
        pressured=jnp.asarray(pr) if with_pressure else None, **kw)
    res = {}
    for cosort in (False, True):
        res[cosort] = tdel.deliver(
            {k: torch.from_numpy(v) for k, v in w["buf"].items()},
            torch.from_numpy(w["head"]), torch.from_numpy(w["tail"]),
            torch.from_numpy(w["alive"]),
            tdel.Entries(torch.from_numpy(w["tgt"]),
                         torch.from_numpy(w["sender"]),
                         torch.from_numpy(w["words"])),
            level=torch.from_numpy(w["level"]), cosort=cosort,
            pressured=torch.from_numpy(pr) if with_pressure else None,
            **kw)
    t, p = res[True], res[False]
    for name in w["buf"]:
        _eq(t.buf[name], j.buf[name], f"buf[{name}]")
        assert torch.equal(t.buf[name], p.buf[name])
    for f in ("tail", "spill_count", "spill_overflow", "newly_muted",
              "new_mute_refs", "new_mute_ovf", "n_delivered",
              "n_rejected", "n_deadletter") + PLAN:
        _eq(getattr(t, f), getattr(j, f), f)
    for f in ("tgt", "sender", "words"):
        _eq(getattr(t.spill, f), getattr(j.spill, f), f"spill.{f}")
        assert torch.equal(getattr(t.spill, f), getattr(p.spill, f))
    assert torch.equal(t.plan_perm, torch.arange(len(w["tgt"]),
                                                 dtype=torch.int32))
    assert not bool(t.plan_bounds.any())
    assert int(t.n_rejected) > 0


# ---------------------------------------------------------------------------
# tests/test_delivery_modes.py


UB = dict(mailbox_cap=4, batch=4, max_sends=1, msg_words=1, spill_cap=256,
          inject_slots=8, tuning_cache="off")


def _ubench(pkg, mode, fused=False):
    if pkg is ponyc_tpu:
        rt, ids = jubench.build(256, pkg.RuntimeOptions(
            delivery=mode, compile_cache="off", **UB), pings=4)
        step = rt._step
        jubench.seed_all(rt, ids, hops=1 << 30, pings=4)
        T = jubench.Pinger
    else:
        rt, ids = tubench.build(256, pkg.RuntimeOptions(
            delivery=mode, pallas_fused=fused, **UB), pings=4,
            device="cpu")
        step = tengine.build_step(rt.program, rt.opts)
        tubench.seed_all(rt, ids, hops=1 << 30, pings=4)
        T = tubench.Pinger
    st, inj = rt.state, rt._empty_inject
    for _ in range(6):
        st, aux = step(st, *inj)
    rt.state = st
    assert rt.counter("n_processed") == 6 * 256 * 4
    assert not bool(aux.spill_overflow)
    return _numbers(rt, [T], 0)


@pytest.fixture(scope="module")
def jax_ubench():
    return _ubench(ponyc_tpu, "cosort")


@pytest.mark.parametrize("mode", ["plan", "cosort"])
def test_ubench_sustained_matches_jax(jax_ubench, mode):
    """Both modes give the JAX package's cosort fields and counters; the
    port's cosort also its carried plan state (the placeholders)."""
    got = _ubench(ponyc_tpu_torch, mode)
    want = jax_ubench
    assert got["fields"] == want["fields"]
    assert got["counters"] == want["counters"]
    if mode == "cosort":
        _same(got, want)


# ---------------------------------------------------------------------------
# tests/test_differential.py's cosort cases


WALKERS = dict(mailbox_cap=4, batch=2, msg_words=1, max_sends=2,
               spill_cap=512, inject_slots=16, delivery="cosort")
TRI = dict(mailbox_cap=2, batch=1, msg_words=2, max_sends=2,
           spill_cap=1024, inject_slots=16, delivery="cosort")


def _walkers(pkg, T, **kw):
    rt = build_walkers(pkg, T, 41, n_seeds=10, vmax=10, **WALKERS, **kw)
    code = rt.run(max_steps=100_000)
    return _numbers(rt, [T.Walker, T.Splitter], code)


def _tri_plan(seed=506):
    """The seed-506 world of test_differential.py: (n, nxt, seeds)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 40))
    nxt = rng.integers(0, n, n)
    seeds = []
    for _ in range(10):
        r = rng.random()
        i = int(rng.integers(0, n))
        if r < 0.5:
            seeds.append(("add", i, (int(rng.integers(1, 12)),)))
        elif r < 0.85:
            seeds.append(("mul", i, (int(rng.integers(0, 5)),
                                     int(rng.integers(0, 2)))))
        else:
            seeds.append(("ping", i, ()))
    return n, nxt, seeds


def _tri_oracle(n, nxt, seeds):
    acc = np.zeros(n, np.int64)
    cnt = np.zeros(n, np.int64)
    q = deque(seeds)
    while q:
        op, i, args = q.popleft()
        cnt[i] += 1
        if op == "add":
            acc[i] += args[0]
            if args[0] > 2:
                q.append(("add", int(nxt[i]), (args[0] - 2,)))
        elif op == "mul":
            acc[i] = acc[i] * 2 + args[0]
            if args[1] > 0:
                q.append(("ping", int(nxt[i]), ()))
    return acc, cnt


def _tri(pkg, T, **kw):
    n, nxt, seeds = _tri_plan()
    rt = new_runtime(pkg, dict(TRI, **kw))
    rt.declare(T.Tri, n).start()
    ids = rt.spawn_many(T.Tri, n)
    rt.set_fields(T.Tri, ids, nxt=ids[np.asarray(nxt)])
    for op, i, args in seeds:
        b = {"add": T.Tri.add, "mul": T.Tri.mul2_then_ping,
             "ping": T.Tri.ping}[op]
        rt.send(int(ids[i]), b, *args)
    code = rt.run(max_steps=100_000)
    return _numbers(rt, [T.Tri], code)


@pytest.fixture(scope="module")
def jax_worlds():
    return {"walkers": _walkers(ponyc_tpu, JT), "tri": _tri(ponyc_tpu, JT)}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("world", ["walkers", "tri"])
def test_differential_cosort_matches_jax(jax_worlds, world, path):
    f = {"walkers": _walkers, "tri": _tri}[world]
    got = f(ponyc_tpu_torch, TT, **PATHS[path])
    _same(got, jax_worlds[world])
    assert got["code"] == 0
    if world == "walkers":
        # The tiny mailboxes drove spill and mute under cosort too.
        assert got["counters"]["n_rejected"] > 0
        assert got["counters"]["n_mutes"] > 0
    else:
        n, nxt, seeds = _tri_plan()
        want_acc, want_cnt = _tri_oracle(n, nxt, seeds)
        assert got["fields"]["Tri"]["count"] == want_cnt.tolist()
        # acc of a mul target depends on arrival order across senders
        # (as in the reference's test): compare the others.
        mul = {i for op, i, _ in seeds if op == "mul"}
        acc = got["fields"]["Tri"]["acc"]
        assert all(acc[i] == want_acc[i] for i in range(n) if i not in mul)

"""The collector (`Runtime.gc`, `release`, `pin`, the run loop's cadence
and heap-pressure trigger; runtime/gc.py) in the port against the JAX
package: the one-shard cases of tests/test_gc.py (unreachable actors
collected, field and message-argument edges, transitive chains, garbage
cycles, queued messages as roots, the periodic collection in the run
loop, the early collection under host-heap pressure) and the hop cap
(`gc_max_iters`). Each world runs on both packages from the same inputs;
what each gc() returns, liveness, counters, ticks and the trace's
iteration count and convergence must be equal (integers and bools: exact
equality). The port runs on the CPU."""

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch

from _torch_programs import _host, blob_world, define_blobs, new_runtime

JB, TB = define_blobs(ponyc_tpu), define_blobs(ponyc_tpu_torch)
PKGS = ((ponyc_tpu, JB), (ponyc_tpu_torch, TB))


def _mk(pkg, T, cap=8, **kw):
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=1, max_sends=1,
                               msg_words=2, inject_slots=8, spill_cap=64,
                               **kw))
    return rt.declare(T.GNode, cap).start()


def _both(scenario):
    j, t = (scenario(pkg, T) for pkg, T in PKGS)
    assert t == j
    return t


def _end(rt, T):
    w = blob_world(rt, T.GNode)
    w["gc"] = {k: rt.totals[k] for k in ("gc_runs", "gc_iters",
                                         "gc_aborted")}
    return w


def test_released_unreachable_actor_is_collected():
    def go(pkg, T):
        rt = _mk(pkg, T)
        ids = rt.spawn_many(T.GNode, 4)
        rt.release(ids[2:])
        return rt.gc(), _end(rt, T)
    n, w = _both(go)
    assert n == 2 and sum(w["alive"]) == 2


def test_state_field_ref_keeps_actor_alive():
    def go(pkg, T):
        rt = _mk(pkg, T)
        a, b, c = rt.spawn_many(T.GNode, 3)
        rt.send(int(a), T.GNode.link, int(b))
        rt.run(max_steps=5)
        rt.release([b, c])
        return rt.gc(), _end(rt, T)
    assert _both(go)[0] == 1


@pytest.mark.parametrize("cycle", [False, True])
def test_chains_and_cycles(cycle):
    """A chain 0 → 1 → ... → 5 hangs off its pinned head and goes once
    the head is released; a released ring of four is collected whole
    (≙ the cycle detector, gc/cycle.c)."""
    def go(pkg, T):
        rt = _mk(pkg, T)
        n = 4 if cycle else 6
        ids = rt.spawn_many(T.GNode, n)
        for i in range(n if cycle else n - 1):
            rt.send(int(ids[i]), T.GNode.link, int(ids[(i + 1) % n]))
        rt.run(max_steps=5)
        got = []
        if not cycle:
            rt.release(ids[1:])
            got.append(rt.gc())
            rt.release(ids[:1])
        else:
            rt.release(ids)
        got.append(rt.gc())
        return got, _end(rt, T)
    got, w = _both(go)
    assert got == ([4] if cycle else [0, 6]) and sum(w["alive"]) == 0


def test_pending_message_is_a_root():
    def go(pkg, T):
        rt = _mk(pkg, T)
        a, b = rt.spawn_many(T.GNode, 2)
        rt.release([a, b])
        rt.send(int(a), T.GNode.poke)
        got = [rt.gc()]
        rt.run(max_steps=5)
        got += [rt.state_of(int(a))["hits"], rt.gc()]
        return got, _end(rt, T)
    assert _both(go)[0] == [1, 1, 1]


def test_message_ref_arg_is_an_edge():
    def go(pkg, T):
        rt = _mk(pkg, T)
        a, b = rt.spawn_many(T.GNode, 2)
        rt.bulk_send([int(a)], T.GNode.link, [int(b)])
        rt.release([b])
        got = [rt.gc()]
        rt.run(max_steps=5)
        got.append(rt.gc())
        rt.send(int(a), T.GNode.link, -1)
        rt.run(max_steps=5)
        got.append(rt.gc())
        return got, _end(rt, T)
    assert _both(go)[0] == [0, 0, 1]


def test_auto_gc_in_run_loop():
    def go(pkg, T):
        rt = _mk(pkg, T, cd_interval=4)
        ids = rt.spawn_many(T.GNode, 4)
        rt.release(ids[2:])
        for _ in range(12):
            rt.send(int(ids[0]), T.GNode.poke)
            rt.run(max_steps=2)
        got = [rt.counter("n_collected")]
        rt.spawn(T.GNode)                  # a collected slot is reused
        got.append(int(_host(rt.state.alive).sum()))
        return got, _end(rt, T)
    assert _both(go)[0] == [2, 3]


def test_heap_pressure_triggers_early_collection():
    def go(pkg, T):
        rt = _mk(pkg, T, cap=4, cd_interval=10_000, gc_initial=1 << 12)
        a = rt.spawn(T.GNode)
        garbage = rt.spawn(T.GNode)
        rt.release(garbage)
        for _ in range(8):
            rt.heap.box(b"x" * 1024)
        for _ in range(3):
            rt.send(a, T.GNode.poke)
            rt.run(max_steps=4)
            if rt.counter("n_collected"):
                break
        return (rt.counter("n_collected"), rt.heap.bytes_since_gc,
                rt.heap.stats()["bytes_live"] > 8 * 1024, _end(rt, T))
    assert _both(go)[:3] == (1, 0, True)


@pytest.mark.parametrize("max_iters", [0, 3, 7])
def test_hop_cap_and_iterations(max_iters):
    """A chain of 12 hanging off a pinned head needs 12 hops, and a trace
    capped below that collects nothing; `gc_iters` and `gc_aborted`
    count as the JAX package's do."""
    def go(pkg, T):
        rt = _mk(pkg, T, cap=16, gc_max_iters=max_iters)
        ids = rt.spawn_many(T.GNode, 14)
        for i in range(11):
            rt.send(int(ids[i]), T.GNode.link, int(ids[i + 1]))
        rt.run(max_steps=5)
        rt.release(ids[1:])
        return rt.gc(), _end(rt, T)
    n, w = _both(go)
    assert n == (2 if max_iters == 0 else 0)
    assert w["gc"]["gc_aborted"] == (0 if max_iters == 0 else 1)

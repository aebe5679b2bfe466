"""The host fast lane (RuntimeOptions.host_fastpath) in the PyTorch port,
held against the JAX package: the cases of tests/test_host_fastpath.py
(all but its checkpoint case, which waits for the port's durable
snapshots). Host → host messages bypass the device mailbox table with
the same semantics: per-sender-pair FIFO, quiescence, yield, dead letters
to unspawned targets; and the dispatch both lanes share: a host
PonyError's code and site recorded, a bad message counted. Each world
runs once in the JAX package and on the port's three paths (the `path`
fixture of test_torch_host.py); the worlds are integer, so the
comparison is exact.
"""

import numpy as np
import pytest

import ponyc_tpu_torch

from test_torch_host import FAST, TT, _jax as _jax_of, _mega_ran, \
    _numbers, _runtime, path  # noqa: F401  (path is the fixture)


def _jax(name, *args):
    return _jax_of(name, *args, module=__name__)


def _fast_order(pkg, T, path):
    rt = _runtime(pkg, path, FAST)
    rt.declare(T.HostCounter, 2).start()
    a = rt.spawn(T.HostCounter)
    for v in range(50):
        rt.send(a, T.HostCounter.hit, v)
    queued = len(rt._host_fast_q)
    rt.run(max_steps=50)
    return queued, _numbers(rt, [], [a])


def test_fast_lane_preserves_order_and_count(path):
    queued, got = _fast_order(ponyc_tpu_torch, TT, path)
    assert queued == 50                        # took the fast lane
    assert list(got["host"].values()) == [{"n": 50, "last": 49}]
    assert (queued, got) == _jax("_fast_order")


def _fast_chain(pkg, T, path):
    rt = _runtime(pkg, path, FAST)
    rt.declare(T.HostChain, 2).start()
    a = rt.spawn(T.HostChain)
    b = rt.spawn(T.HostChain, nxt=a)
    rt.set_fields(T.HostChain, np.asarray([a]), nxt=b)
    rt.send(a, T.HostChain.pass_, 100)
    rt.run(max_steps=20)
    return _numbers(rt, [], [a, b])


def test_host_chain_completes_within_few_boundaries(path):
    got = _fast_chain(ponyc_tpu_torch, TT, path)
    assert sum(s["hops"] for s in got["host"].values()) == 101
    assert got["steps"] < 20                   # not one window a hop
    assert got == _jax("_fast_chain")


def _dev_to_host(pkg, T, path):
    rt = _runtime(pkg, path, FAST)
    rt.declare(T.DevPing, 1).declare(T.HostCounter, 1).start()
    h = rt.spawn(T.HostCounter)
    d = rt.spawn(T.DevPing, out=h)
    rt.send(d, T.DevPing.go, 7)                # a device target: inject
    rt.run(max_steps=16)
    return _numbers(rt, [T.DevPing], [h])


def test_device_to_host_still_rides_the_device_lane(path):
    got = _dev_to_host(ponyc_tpu_torch, TT, path)
    assert list(got["host"].values()) == [{"n": 1, "last": 7}]
    assert got == _jax("_dev_to_host")
    _mega_ran(path)


def _fast_opt(pkg, T, path, fast):
    rt = _runtime(pkg, path, dict(FAST, host_fastpath=fast))
    rt.declare(T.HostCounter, 1).start()
    a = rt.spawn(T.HostCounter)
    for v in range(20):
        rt.send(a, T.HostCounter.hit, v)
    queued = len(rt._host_fast_q)
    rt.run(max_steps=64)
    return queued, _numbers(rt, [], [a])


@pytest.mark.parametrize("fast", [True, False])
def test_fastpath_opt_out_matches(path, fast):
    queued, got = _fast_opt(ponyc_tpu_torch, TT, path, fast)
    assert queued == (20 if fast else 0)
    assert list(got["host"].values()) == [{"n": 20, "last": 19}]
    assert (queued, got) == _jax("_fast_opt", fast)


def _ghost(pkg, T, path):
    rt = _runtime(pkg, path, FAST)
    rt.declare(T.HostCounter, 2).start()
    a = rt.spawn(T.HostCounter)
    ghost = a + 1 if rt.program.cohort_of(a + 1).host else a - 1
    rt.send(int(ghost), T.HostCounter.hit, 1)
    rt.run(max_steps=8)
    return _numbers(rt, [], [a])


def test_unspawned_host_target_dead_letters(path):
    got = _ghost(ponyc_tpu_torch, TT, path)
    assert got["totals"]["deadletter_host"] == 1
    assert list(got["host"].values()) == [{"n": 0, "last": 0}]
    assert got == _jax("_ghost")


def _yielding(pkg, T, path):
    rt = _runtime(pkg, path, FAST)
    rt.declare(T.Yielding, 1).start()
    a = rt.spawn(T.Yielding)
    for v in range(4):
        rt.send(a, T.Yielding.hit, v)
    per_boundary = []
    orig = rt._drain_host_fast

    def counted(budget):
        before = rt.totals["host_processed"]
        r = orig(budget)
        if rt.totals["host_processed"] - before:
            per_boundary.append(rt.totals["host_processed"] - before)
        return r

    rt._drain_host_fast = counted
    rt.run(max_steps=64)
    return per_boundary, _numbers(rt, [], [a])


def test_yield_stops_fast_lane_batch(path):
    per_boundary, got = _yielding(ponyc_tpu_torch, TT, path)
    assert per_boundary == [1, 1, 1, 1]        # one a boundary
    assert list(got["host"].values()) == [{"n": 4}]
    assert (per_boundary, got) == _jax("_yielding")


def _kick(pkg, T, path):
    rt = _runtime(pkg, path, FAST)
    rt.declare(T.DevCounter, 1).declare(T.HostKick, 1).start()
    d = rt.spawn(T.DevCounter)
    h = rt.spawn(T.HostKick)
    first = rt.run(max_steps=8)                # the device quiesces empty
    rt.send(h, T.HostKick.kick, d)             # fast lane → bulk_send
    return first, rt.run(max_steps=32), _numbers(rt, [T.DevCounter], [h])


def test_bulk_send_from_host_behaviour_is_not_stranded(path):
    first, code, got = _kick(ponyc_tpu_torch, TT, path)
    assert (first, code) == (0, 0)
    assert got["fields"]["DevCounter"]["n"] == [5]
    assert list(got["host"].values()) == [{"done": 1}]
    assert (first, code, got) == _jax("_kick")


def _errors(pkg, T, path):
    """Host PonyErrors (the code and its site recorded, the actor goes
    on) and a message its type has no behaviour for (a device sender's
    untyped ref at a host actor of another type: a bad message)."""
    rt = _runtime(pkg, path, FAST)
    rt.declare(T.DevPing, 1).declare(T.HostErr, 1)
    rt.declare(T.HostCounter, 1).start()     # so HostCounter.hit has an id
    e = rt.spawn(T.HostErr)
    d = rt.spawn(T.DevPing, out=e)
    for v in (1, 2, 5, 4):
        rt.send(e, T.HostErr.hit, v)
    rt.send(d, T.DevPing.go, 7)                # HostCounter.hit at a HostErr
    code = rt.run(max_steps=32)
    return (code, rt.last_error(e), rt.last_error_loc(e),
            _numbers(rt, [T.DevPing], [e]))


def test_host_errors_and_bad_messages(path):
    code, err, loc, got = _errors(ponyc_tpu_torch, TT, path)
    assert (code, err) == (0, 105)             # the latest code
    assert "_torch_programs.py:" in loc        # the raise site
    assert list(got["host"].values()) == [{"n": 2}]
    assert got["totals"] == {"host_processed": 4, "host_errors": 2,
                             "badmsg": 1}
    assert (code, err, loc, got) == _jax("_errors")

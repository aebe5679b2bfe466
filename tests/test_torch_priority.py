"""Actor priorities under delivery contention in the PyTorch port, held
against the JAX package: the plan cases of tests/test_priority.py. When a
mailbox cannot take everything in a tick, higher-PRIORITY senders win the
slots and lower-priority traffic spills behind them; senders of one
priority keep their arrival order. The delivery levels (0 the receiver's
spill, 1 host injections, 2 and up the sender cohorts by priority) are
what host sends ride on. Each world runs once in the JAX package and on
the port's three paths (the `path` fixture of test_torch_host.py); the
comparison is exact.
"""

import ponyc_tpu_torch

from test_torch_host import TT, _jax as _jax_of, _numbers, _runtime, \
    path  # noqa: F401  (path is the fixture)

OPTS = dict(mailbox_cap=4, batch=4, max_sends=4, msg_words=2, spill_cap=64,
            inject_slots=8)


def _jax(name):
    return _jax_of(name, module=__name__)


def _contended(pkg, T, path):
    rt = _runtime(pkg, path, OPTS)
    rt.declare(T.HiSender, 1).declare(T.LoSender, 1).declare(T.Rx, 1)
    rt.start()
    rx = rt.spawn(T.Rx)
    hi = rt.spawn(T.HiSender, sink=int(rx))
    lo = rt.spawn(T.LoSender, sink=int(rx))
    # Both bursts dispatch in the same tick: 8 messages race for 4 slots.
    rt.send(lo, T.LoSender.burst, 100)     # enqueued first ...
    rt.send(hi, T.HiSender.burst, 1)       # ... but of higher priority
    rt.run(max_steps=50)
    return _numbers(rt, [T.Rx, T.HiSender, T.LoSender])


def test_higher_priority_wins_contended_slots(path):
    got = _contended(ponyc_tpu_torch, TT, path)
    assert got["fields"]["Rx"]["seen"] == [8]     # nothing lost
    assert got["fields"]["Rx"]["first4"] == [4]   # hi's messages first
    assert got["counters"]["n_rejected"] == 4     # lo's burst spilled
    assert got == _jax("_contended")
    if path == "mega":
        assert sum(k for k, _ in path.seen) == got["steps"]


def _equal(pkg, T, path):
    rt = _runtime(pkg, path, dict(OPTS, mailbox_cap=8, batch=8))
    rt.declare(T.HiSender, 2).declare(T.Rx, 1)
    rt.start()
    rx = rt.spawn(T.Rx)
    a = rt.spawn(T.HiSender, sink=int(rx))
    b = rt.spawn(T.HiSender, sink=int(rx))
    rt.send(a, T.HiSender.burst, 1)
    rt.send(b, T.HiSender.burst, 1)
    rt.run(max_steps=50)
    return _numbers(rt, [T.Rx, T.HiSender])


def test_equal_priority_keeps_arrival_order(path):
    got = _equal(ponyc_tpu_torch, TT, path)
    assert got["fields"]["Rx"]["seen"] == [8]
    assert got["counters"]["n_rejected"] == 0
    assert got == _jax("_equal")
    if path == "mega":
        assert sum(k for k, _ in path.seen) == got["steps"]

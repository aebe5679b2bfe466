"""Host cohorts (HOST = True actor types) in the PyTorch port, held against
the JAX package: the device→host drain, host behaviours and the run
loop's host boundary (the host→host fast lane: test_torch_host_fastpath.py).

Each world is defined once for both packages (`define(pkg)` in
tests/_torch_programs.py), runs once in the JAX package and on three paths
of the port on the CPU: the plain tick, `pallas_fused=True` (the fused
kernel's plain version) and `delivery="pallas_mega"`, where every window
the run dispatches also runs as the host C++ build of csrc/mega_window.cu
and must equal the plain window leaf for leaf. The worlds are integer, so
the tolerance is exact: fields, host state, counters, host counters
(`totals`), ticks run, exit codes and arrival order must be equal.
"""

import functools
import sys

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu_torch.ops import _build
from ponyc_tpu_torch.ops.megakernel import MegaWindow
from ponyc_tpu_torch.runtime import engine

from _torch_programs import define, new_runtime
from test_torch_mega_host import assert_same_window

TJ = define(ponyc_tpu)
TT = define(ponyc_tpu_torch)
PATHS = ("plain", "fused", "mega")
PATH_KW = {"plain": {}, "fused": dict(pallas_fused=True),
           "mega": dict(delivery="pallas_mega")}
# tests/test_host_fastpath.py's options
FAST = dict(mailbox_cap=8, batch=2, max_sends=2, msg_words=2,
            inject_slots=16)


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """A path of the port. On "mega" every window also runs as the host
    build of the window kernel, which must equal the plain window; the
    windows checked are in `path.seen` as (ticks run, host_pending)."""
    seen = []
    if request.param == "mega":
        if _build.host_cxx() is None:
            pytest.skip("no host C++ compiler to build the kernel's source")
        plain = MegaWindow._dispatch

        def checked(self, st, it, iw, limit, force, prev_aux, probe,
                    forced):
            # The run's own stop probe: the plain window stops enqueuing
            # once the device voted to stop (every later tick is a
            # no-op), as in an unchecked run, instead of running the
            # window's every tick predicated off.
            want = plain(self, st, it, iw, limit, force, prev_aux, probe,
                         forced)
            got = self.run_host(st, it, iw, limit, force,
                                engine.zero_aux("cpu") if forced
                                else prev_aux, forced=forced)
            assert_same_window(got, want, f"window {len(seen)}")
            seen.append((int(want[2]), bool(want[1].host_pending)))
            return want

        monkeypatch.setattr(MegaWindow, "_dispatch", checked)
    return _Path(request.param, seen)


class _Path(str):
    """A path's name, with the windows its run checked."""

    def __new__(cls, name, seen):
        p = super().__new__(cls, name)
        p.seen = seen
        return p


def _runtime(pkg, path, opts_kw):
    return new_runtime(pkg, {**opts_kw, **(PATH_KW[path] if pkg is
                                            ponyc_tpu_torch else {})})


def _numbers(rt, types, hosts=()):
    """What both packages must agree on after a run."""
    return {"fields": {t.__name__: {f: np.asarray(v).tolist() for f, v in
                                    rt.cohort_state(t).items()}
                       for t in types},
            "host": {int(a): rt.state_of(int(a)) for a in hosts},
            "counters": {c: rt.counter(c) for c in (
                "n_processed", "n_delivered", "n_rejected", "n_badmsg",
                "n_deadletter", "n_mutes")},
            "totals": {k: int(v) for k, v in rt.totals.items()
                       if k in ("host_processed", "host_errors", "badmsg",
                                "deadletter_host")},
            "steps": rt.steps_run, "code": rt.exit_code}


def _mega_ran(path, at_least=1):
    if path == "mega":
        assert sum(k for k, _ in path.seen) >= at_least
        assert any(h for _, h in path.seen), "no window stopped for the host"


# ---- the device→host drain ------------------------------------------------

def _reporting(pkg, T, path):
    """tests/test_differential.py::test_host_reporting_matches_oracle:
    chains over a random functional graph end into a host actor."""
    rng = np.random.default_rng(31)
    n_w = 20
    w_nxt = rng.integers(0, n_w, n_w)
    starts = [(int(rng.integers(0, n_w)), int(rng.integers(1, 12)))
              for _ in range(8)]
    rt = _runtime(pkg, path, dict(mailbox_cap=2, batch=1, msg_words=2,
                                  max_sends=2, spill_cap=512,
                                  inject_slots=16))
    rt.declare(T.WalkerH, n_w).declare(T.HostLog, 1).start()
    wids = rt.spawn_many(T.WalkerH, n_w)
    log = rt.spawn(T.HostLog)
    rt.set_fields(T.WalkerH, wids, nxt=wids[w_nxt], log=np.full(n_w, log))
    for i, v in starts:
        rt.send(int(wids[i]), T.WalkerH.step, v)
    code = rt.run(max_steps=100_000)
    return code, _numbers(rt, [T.WalkerH], [log]), (w_nxt, starts, log)


@functools.lru_cache(maxsize=None)
def _jax(name, *args, module=__name__):
    """The JAX package's run of world `name` (a function of `module`),
    once for all the port's paths."""
    return getattr(sys.modules[module], name)(ponyc_tpu, TJ, "plain", *args)


def test_host_reporting_matches_oracle(path):
    code, got, (w_nxt, starts, log) = _reporting(ponyc_tpu_torch, TT, path)
    acc = np.zeros(len(w_nxt), np.int64)
    ends = 0
    q = list(starts)
    while q:                        # the sequential oracle
        i, v = q.pop(0)
        acc[i] += v
        if v > 0:
            q.append((int(w_nxt[i]), v - 1))
        else:
            ends += 1
    assert code == 0
    assert got["fields"]["WalkerH"]["acc"] == acc.tolist()
    assert got["host"][int(log)]["ends"] == ends == len(starts)
    assert got["counters"]["n_mutes"] > 0      # the host row pushed back
    assert got == _jax("_reporting")[1]
    _mega_ran(path)


# Stamps a producer sends: 20 (tests/test_fifo.py sends 40) keep every
# path of the world at half the ticks, a rejected and muting host ring
# included.
HOST_FIFO_ITEMS = 20


def _host_fifo(pkg, T, path):
    """tests/test_fifo.py::test_host_consumer_fifo: per-edge stamps into
    one host consumer; returns its arrival log."""
    T.host_logs.clear()
    n_prod, items = 6, HOST_FIFO_ITEMS
    rt = _runtime(pkg, path, dict(mailbox_cap=2, batch=1, msg_words=2,
                                  max_sends=2, spill_cap=2048,
                                  inject_slots=16, host_out_slots=8))
    rt.declare(T.HProd, n_prod).declare(T.HCons, 1)
    rt.start()
    sink = rt.spawn(T.HCons)
    pids = rt.spawn_many(T.HProd, n_prod, sink=np.full(n_prod, sink),
                         edge=np.arange(n_prod, dtype=np.int32))
    rt.bulk_send(pids, T.HProd.produce, np.full(n_prod, items, np.int32))
    code = rt.run(max_steps=200_000)
    return (code, _numbers(rt, [T.HProd], [sink]),
            {e: list(v) for e, v in T.host_logs.items()}, sink)


def test_host_consumer_fifo(path):
    code, got, logs, sink = _host_fifo(ponyc_tpu_torch, TT, path)
    assert code == 0
    assert got["host"][int(sink)]["got"] == 6 * HOST_FIFO_ITEMS
    assert logs == {e: list(range(HOST_FIFO_ITEMS)) for e in range(6)}
    # The host ring (cap 2) overflowed: the stamps crossed the spill and
    # muted their producers, the paths FIFO order must survive.
    assert got["counters"]["n_rejected"] > 0
    assert got["counters"]["n_mutes"] > 0
    j = _jax("_host_fifo")
    assert (got, logs) == (j[1], j[2])
    _mega_ran(path)


def _walker_world(pkg, T, path, seed, pipelined):
    """tests/test_run_loop.py::_run_walker_world: the reporting walk under
    the pipelined adaptive loop or the synchronous fixed window."""
    rng = np.random.default_rng(seed)
    n, chains = 12, 6
    loop = (dict(pipeline=True, quiesce_interval="auto",
                 quiesce_interval_min=4, quiesce_interval_max=64)
            if pipelined else dict(pipeline=False, quiesce_interval=16))
    rt = _runtime(pkg, path, dict(mailbox_cap=4, batch=1, max_sends=2,
                                  msg_words=1, spill_cap=256,
                                  inject_slots=8, **loop))
    rt.declare(T.WalkerH, n).declare(T.HostLog, 1)
    rt.start()
    log = rt.spawn(T.HostLog, ends=0, total=0)
    ids = rt.spawn_many(T.WalkerH, n, log=log)
    rt.set_fields(T.WalkerH, ids, nxt=ids[rng.integers(0, n, n)])
    starts = rng.choice(n, chains, replace=False)
    vals = rng.integers(1, 40, chains)
    for s, v in zip(starts, vals):
        rt.send(int(ids[s]), T.WalkerH.step, int(v))
    rt.run(max_steps=200_000)
    return _numbers(rt, [T.WalkerH], [log])


@pytest.mark.parametrize("seed", [7])
def test_differential_pipelined_matches_synchronous(path, seed):
    """Windows cut by host attention: the pipelined loop and the
    synchronous one agree column for column, and the pipelined one with
    the JAX package's (ticks run included)."""
    sync = _walker_world(ponyc_tpu_torch, TT, path, seed, False)
    pipe = _walker_world(ponyc_tpu_torch, TT, path, seed, True)
    got = {k: v for k, v in sync.items() if k != "steps"}
    assert got == {k: v for k, v in pipe.items() if k != "steps"}
    assert pipe == _jax("_walker_world", seed, True)
    _mega_ran(path)


# ---- the examples: a host-only program, a host exit -------------------------

def _hello(pkg, T, path):
    """examples/helloworld.py: one host actor, one message, exit(0)."""
    rt = _runtime(pkg, path, dict(msg_words=1))
    rt.declare(T.Hello, 1).start()
    h = rt.spawn(T.Hello)
    rt.send(h, T.Hello.create, 0)
    return rt.run(), _numbers(rt, [], [h])


def test_host_only_program(path):
    code, got = _hello(ponyc_tpu_torch, TT, path)
    assert code == 0 and list(got["host"].values()) == [{"said": 1}]
    assert (code, got) == _jax("_hello")


def _counter(pkg, T, path):
    """examples/counter.py: device counters report into a host actor,
    which calls exit(0) once it has seen every increment."""
    n, incs = 8, 100
    rt = _runtime(pkg, path, dict(msg_words=2, inject_slots=256, batch=16))
    rt.declare(T.Counter, n).declare(T.Reporter, 1).start()
    counters = rt.spawn_many(T.Counter, n)
    rep = rt.spawn(T.Reporter, expected=n * incs)
    for c in counters:
        for _ in range(incs // 4):
            rt.send(int(c), T.Counter.increment, 4)
    first = rt.run()
    for c in counters:
        rt.send(int(c), T.Counter.report, rep)
    return first, rt.run(), _numbers(rt, [T.Counter], [rep])


def test_host_exit(path):
    first, code, got = _counter(ponyc_tpu_torch, TT, path)
    assert (first, code) == (0, 0)
    assert list(got["host"].values()) == [{"seen": 800, "expected": 800}]
    assert got["fields"]["Counter"]["count"] == [100] * 8
    assert (first, code, got) == _jax("_counter")
    _mega_ran(path)


def test_host_program_builds_a_step_with_no_device_cohort():
    rt = new_runtime(ponyc_tpu_torch, dict(msg_words=1))
    rt.declare(TT.Hello, 1).start()
    assert rt.program.device_cohorts == [] and rt._multi_g.fused == []

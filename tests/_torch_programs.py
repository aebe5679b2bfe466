"""Programs shared by the PyTorch-port differential tests.

`define(pkg)` applies `pkg.actor` / `pkg.behaviour` to one set of class
bodies, so the JAX package and the port run the very same behaviour
source. This module deliberately has no ``from __future__ import
annotations``: the field and argument annotations must be the packages'
marker objects, evaluated when the classes are built.
"""

import collections
import importlib
import types

import numpy as np

IN_SLOTS = 4          # in-edges tracked per FIFO consumer


def define(pkg):
    """Actor types of the shared test programs, built with `pkg`
    (``ponyc_tpu`` or ``ponyc_tpu_torch``)."""
    I32, Ref = pkg.I32, pkg.Ref

    @pkg.actor
    class Pinger:
        next_ref: Ref
        pings: I32

        MAX_SENDS = 1

        @pkg.behaviour
        def ping(self, st, n: I32):
            self.send(st["next_ref"], Pinger.ping, n - 1, when=n > 0)
            return {**st, "pings": st["pings"] + 1}

    @pkg.actor
    class RingNode:
        next_ref: Ref["RingNode"]
        passes: I32

        @pkg.behaviour
        def token(self, st, hops: I32):
            self.send(st["next_ref"], RingNode.token, hops - 1,
                      when=hops > 1)
            self.exit(0, when=hops <= 1)
            return {**st, "passes": st["passes"] + 1}

    @pkg.actor
    class Walker:
        """Token walk over a random functional graph."""
        acc: I32
        hits: I32
        nxt: Ref["Walker"]

        MAX_SENDS = 1

        @pkg.behaviour
        def step(self, st, v: I32):
            self.send(st["nxt"], Walker.step, v - 1, when=v > 0)
            return {**st, "acc": st["acc"] + v, "hits": st["hits"] + 1}

    @pkg.actor
    class Splitter:
        """Bounded binary fan-out into Walkers and Splitters."""
        acc: I32
        w_ref: Ref["Walker"]
        s_ref: Ref["Splitter"]

        MAX_SENDS = 2

        @pkg.behaviour
        def burst(self, st, v: I32):
            self.send(st["w_ref"], Walker.step, v - 1, when=v > 0)
            self.send(st["s_ref"], Splitter.burst, v - 2, when=v > 1)
            return {**st, "acc": st["acc"] + v}

    @pkg.actor
    class Cons:
        """FIFO consumer: counts every per-edge stamp that does not
        arrive contiguous (tests/test_fifo.py)."""
        last0: I32
        last1: I32
        last2: I32
        last3: I32
        bad: I32
        got: I32

        BATCH = 1

        @pkg.behaviour
        def consume(self, st, slot: I32, seq: I32):
            upd = {"bad": st["bad"], "got": st["got"] + 1}
            for s in range(IN_SLOTS):
                is_s = slot == s
                last = st[f"last{s}"]
                viol = is_s & (seq != last + 1)
                upd["bad"] = upd["bad"] + np.int32(1) * viol
                upd[f"last{s}"] = last + (seq - last) * is_s
            return {**st, **upd}

    @pkg.actor
    class Prod:
        """FIFO producer: streams stamps to two (consumer, slot) edges
        through a self-send chain."""
        c1: Ref["Cons"]
        c2: Ref["Cons"]
        slot1: I32
        slot2: I32
        seq: I32

        MAX_SENDS = 3

        @pkg.behaviour
        def produce(self, st, n: I32):
            self.send(st["c1"], Cons.consume, st["slot1"], st["seq"],
                      when=n > 0)
            self.send(st["c2"], Cons.consume, st["slot2"], st["seq"],
                      when=n > 0)
            self.send(self.actor_id, Prod.produce, n - 1, when=n > 0)
            return {**st, "seq": st["seq"] + (n > 0) * np.int32(1)}

    @pkg.actor
    class Tri:
        """Three behaviours over a random functional graph
        (tests/test_differential.py's cosort oracle world)."""
        acc: I32
        count: I32
        nxt: Ref["Tri"]

        MAX_SENDS = 2

        @pkg.behaviour
        def add(self, st, v: I32):
            self.send(st["nxt"], Tri.add, v - 2, when=v > 2)
            return {**st, "acc": st["acc"] + v,
                    "count": st["count"] + 1}

        @pkg.behaviour
        def mul2_then_ping(self, st, v: I32, flag: I32):
            self.send(st["nxt"], Tri.ping, when=flag > 0)
            return {**st, "acc": st["acc"] * 2 + v,
                    "count": st["count"] + 1}

        @pkg.behaviour
        def ping(self, st):
            return {**st, "count": st["count"] + 1}

    @pkg.actor
    class Mixer:
        """Two behaviours of different arities exercising every effect
        plane: sends, yield, int-coded errors, destroy and exit."""
        acc: I32
        cnt: I32
        nxt: Ref["Mixer"]

        MAX_SENDS = 2
        BATCH = 3

        @pkg.behaviour
        def add(self, st, v: I32):
            self.send(st["nxt"], Mixer.add, v - 1, when=v > 0)
            self.send(st["nxt"], Mixer.poke, v, v * 3, when=v % 5 == 0)
            self.yield_(when=v % 7 == 3)
            self.error_int(v + 100, when=v % 11 == 4)
            return {**st, "acc": st["acc"] + v, "cnt": st["cnt"] + 1}

        @pkg.behaviour
        def poke(self, st, a: I32, b: I32):
            self.destroy(when=a == 25)
            self.exit(a, when=b == 45)
            return {**st, "acc": st["acc"] * 2 + b}

    # The fused-kernel corpus of tests/test_fused_dispatch.py: yield
    # mid-batch, exit codes, destroy, int-coded errors, and a cohort of
    # three behaviours where only one sends.
    @pkg.actor
    class Yielder:
        n: I32

        BATCH = 4
        MAX_SENDS = 0

        @pkg.behaviour
        def tick(self, st, v: I32):
            self.yield_(when=st["n"] % 2 == 0)
            return {**st, "n": st["n"] + 1}

    @pkg.actor
    class Exiter:
        n: I32

        MAX_SENDS = 0

        @pkg.behaviour
        def go(self, st, code: I32):
            self.exit(code, when=code > 0)
            return {**st, "n": st["n"] + 1}

    @pkg.actor
    class Ephemeral:
        n: I32

        MAX_SENDS = 0

        @pkg.behaviour
        def die(self, st, v: I32):
            self.destroy(when=v > 0)
            return {**st, "n": st["n"] + 1}

    @pkg.actor
    class Errs:
        n: I32

        MAX_SENDS = 0

        @pkg.behaviour
        def go(self, st, v: I32):
            self.error_int(v, when=v > 0)
            return {**st, "n": st["n"] + 1}

    @pkg.actor
    class TriF:
        acc: I32
        count: I32
        buddy: Ref["TriF"]

        MAX_SENDS = 1

        @pkg.behaviour
        def add(self, st, v: I32):
            self.send(st["buddy"], TriF.ping, when=v % 2 == 1)
            return {**st, "acc": st["acc"] + v, "count": st["count"] + 1}

        @pkg.behaviour
        def scale(self, st, v: I32):
            return {**st, "acc": st["acc"] * 2 + v,
                    "count": st["count"] + 1}

        @pkg.behaviour
        def ping(self, st):
            return {**st, "count": st["count"] + 1}

    @pkg.actor
    class Arith:
        """Operators whose torch semantics a plain C expression does not
        give: floor division, the remainder's sign, shifts by the width
        or more, wrapping products, integer powers, a float divided by a
        Python scalar, pow's special exponents."""
        a: I32
        b: I32
        f: pkg.F32
        g: pkg.F32

        MAX_SENDS = 1

        @pkg.behaviour
        def ints(self, st, x: I32, y: I32):
            d = y | 1                       # odd, so never zero
            s = y & 63                      # shifts past the width too
            self.send(self.actor_id, Arith.floats, x * 3, when=(x ^ y) > 0)
            return {**st, "a": x // d + (x % d) * 1000 + (x << s),
                    "b": ((x >> s) + x * 1000003 * 4099 + (-x) + abs(y)
                          + x ** 2 + (~x))}

        @pkg.behaviour
        def floats(self, st, h: pkg.F32):
            f = st["f"]
            return {**st,
                    "f": (f / 3.0 + 1.0 / (h * h + 1.0) + abs(f) ** 0.5
                          + f ** 2 + f ** 3),
                    "g": st["g"] * 0.5 - h / (f * f + 0.25) + (h > f) * 1.0}

    @pkg.actor
    class Div:
        """Integer `//` and `%` by a divisor that may be zero, both ways
        round (the reflected forms too): the JAX package's results on the
        CPU are the ones the port gives."""
        q: I32
        r: I32
        s: I32

        @pkg.behaviour
        def go(self, st, x: I32, y: I32):
            return {**st, "q": x // y, "r": x % y, "s": 5 // y + 3 % y}

    # Device spawns: the spawn tree of examples/spawn_tree.py (its
    # `jnp.where(done, 0, acc)` spelt `acc * ~done`, which both packages
    # run), the lifecycle programs of tests/test_lifecycle.py and the
    # spawner of tests/test_fused_dispatch.py.
    @pkg.actor
    class Node:
        parent: Ref
        acc: I32
        pending: I32

        SPAWNS = {"Node": 2}
        SPAWN_DISPATCHES = 1
        MAX_SENDS = 3

        @pkg.behaviour
        def grow(self, st, depth: I32, parent: Ref):
            leaf = depth <= 0
            self.spawn(Node.grow, depth - 1, self.actor_id, when=~leaf)
            self.spawn(Node.grow, depth - 1, self.actor_id, when=~leaf)
            self.send(parent, Node.leaf_up, 1, when=leaf)
            return {**st, "parent": parent, "pending": 2}

        @pkg.behaviour
        def leaf_up(self, st, n: I32):
            acc = st["acc"] + n
            pending = st["pending"] - 1
            done = pending == 0
            root = st["parent"] < 0
            self.send(st["parent"], Node.leaf_up, acc, when=done & ~root)
            self.exit(acc, when=done & root)
            return {**st, "acc": acc * ~done, "pending": pending}

    @pkg.actor
    class Worker:
        boss: Ref
        value: I32

        @pkg.behaviour
        def init(self, st, boss: Ref, value: I32):
            self.send(boss, Boss.started, self.actor_id)
            return {**st, "boss": boss, "value": value}

        @pkg.behaviour
        def stop(self, st):
            self.destroy()
            return st

    @pkg.actor
    class Boss:
        n_started: I32
        last_child: Ref

        SPAWNS = {"Worker": 2}
        MAX_SENDS = 2

        @pkg.behaviour
        def go(self, st, count: I32):
            a = self.spawn(Worker.init, self.actor_id, 11, when=count >= 1)
            self.spawn(Worker.init, self.actor_id, 22, when=count >= 2)
            return {**st, "last_child": a}

        @pkg.behaviour
        def started(self, st, child: Ref):
            return {**st, "n_started": st["n_started"] + 1}

    @pkg.actor
    class Kid:
        tag: I32
        frac: pkg.F32
        boss: Ref

        @pkg.behaviour
        def init(self, st, tag: I32, frac: pkg.F32):
            return {**st, "tag": tag, "frac": frac,
                    "boss": self.actor_id * 0 - 1}

        @pkg.behaviour
        def probe(self, st, bump: I32):
            return {**st, "tag": st["tag"] + bump}

    @pkg.actor
    class Maker:
        made: Ref

        MAX_SENDS = 1
        SPAWNS = {"Kid": 1}

        @pkg.behaviour
        def make(self, st, v: I32):
            ref = self.spawn_sync(Kid.init, v, 0.5)
            self.send(ref, Kid.probe, 100, when=ref >= 0)
            return {**st, "made": ref}

    @pkg.actor
    class Relay:
        nxt: Ref["Relay"]
        sink: Ref["Collector"]
        forwarded: I32

        MAX_SENDS = 2
        SPAWNS = {"Temp": 1}

        @pkg.behaviour
        def chain(self, st, v: I32):
            w = self.spawn(Temp.init, v, st["sink"], when=v > 0)
            self.send(st["nxt"], Relay.chain, v - 1, when=v > 0)
            return {**st, "forwarded": st["forwarded"] + (w >= 0)}

    @pkg.actor
    class Temp:
        MAX_SENDS = 1

        @pkg.behaviour
        def init(self, st, v: I32, sink: I32):
            self.send(sink, Collector.log, v)
            self.destroy()
            return st

    @pkg.actor
    class Collector:
        total: I32
        hits: I32

        BATCH = 8

        @pkg.behaviour
        def log(self, st, v: I32):
            return {**st, "total": st["total"] + v,
                    "hits": st["hits"] + 1}

    @pkg.actor
    class SpawnChild:
        boss: Ref
        val: I32

        @pkg.behaviour
        def init(self, st, boss: Ref, v: I32):
            return {**st, "boss": boss, "val": v}

    @pkg.actor
    class Spawner:
        made: I32

        SPAWNS = {"SpawnChild": 1}
        MAX_SENDS = 1

        @pkg.behaviour
        def make(self, st, v: I32):
            self.spawn(SpawnChild.init, self.actor_id, v)
            return {**st, "made": st["made"] + 1}

    # Host cohorts (HOST = True): the reporting walk of
    # tests/test_differential.py and tests/test_run_loop.py, the host
    # FIFO consumer of tests/test_fifo.py (its arrival log in
    # `host_logs`), the fast-lane programs of tests/test_host_fastpath.py,
    # the examples' helloworld, counter and spreader (with its promise),
    # and the priority senders of tests/test_priority.py (Rx's
    # `jnp.where(first, v, 0)` spelt `v * first`, which both packages
    # run).
    host_logs = {}

    @pkg.actor
    class HostLog:
        HOST = True
        ends: I32
        total: I32

        @pkg.behaviour
        def done(self, st, tail: I32):
            return {**st, "ends": st["ends"] + 1,
                    "total": st["total"] + tail}

    @pkg.actor
    class WalkerH:
        acc: I32
        nxt: Ref["WalkerH"]
        log: Ref["HostLog"]

        MAX_SENDS = 2

        @pkg.behaviour
        def step(self, st, v: I32):
            self.send(st["nxt"], WalkerH.step, v - 1, when=v > 0)
            self.send(st["log"], HostLog.done, st["acc"] + v, when=v == 0)
            return {**st, "acc": st["acc"] + v}

    @pkg.actor
    class HCons:
        HOST = True
        got: I32

        @pkg.behaviour
        def consume(self, st, edge: I32, seq: I32):
            host_logs.setdefault(int(edge), []).append(int(seq))
            return {**st, "got": st["got"] + 1}

    @pkg.actor
    class HProd:
        sink: Ref["HCons"]
        edge: I32
        seq: I32

        MAX_SENDS = 2

        @pkg.behaviour
        def produce(self, st, n: I32):
            self.send(st["sink"], HCons.consume, st["edge"], st["seq"],
                      when=n > 0)
            self.send(self.actor_id, HProd.produce, n - 1, when=n > 0)
            return {**st, "seq": st["seq"] + (n > 0) * np.int32(1)}

    @pkg.actor
    class HostCounter:
        HOST = True
        n: I32
        last: I32

        @pkg.behaviour
        def hit(self, st, v: I32):
            return {"n": st["n"] + 1, "last": v}

    @pkg.actor
    class HostChain:
        HOST = True
        nxt: Ref
        hops: I32

        @pkg.behaviour
        def pass_(self, st, k: I32):
            if k > 0:
                self.send(st["nxt"], HostChain.pass_, k - 1)
            return {**st, "hops": st["hops"] + 1}

    @pkg.actor
    class DevPing:
        out: Ref
        fired: I32
        MAX_SENDS = 1

        @pkg.behaviour
        def go(self, st, v: I32):
            self.send(st["out"], HostCounter.hit, v)
            return {**st, "fired": st["fired"] + 1}

    @pkg.actor
    class Yielding:
        HOST = True
        n: I32

        @pkg.behaviour
        def hit(self, st, v: I32):
            self.yield_()                 # one message a boundary
            return {**st, "n": st["n"] + 1}

    @pkg.actor
    class DevCounter:
        n: I32
        MAX_SENDS = 0

        @pkg.behaviour
        def bump(self, st, v: I32):
            return {**st, "n": st["n"] + v}

    @pkg.actor
    class HostKick:
        HOST = True
        done: I32

        @pkg.behaviour
        def kick(self, st, tgt: I32):
            self.rt.bulk_send(np.asarray([tgt]), DevCounter.bump,
                              np.asarray([5]))
            return {**st, "done": 1}

    PonyError = importlib.import_module(pkg.__name__ + ".errors").PonyError

    @pkg.actor
    class HostErr:
        """A host actor whose odd arguments raise an int-coded error (the
        actor records it and goes on)."""
        HOST = True
        n: I32

        @pkg.behaviour
        def hit(self, st, v: I32):
            if v % 2:
                raise PonyError(100 + v)
            return {**st, "n": st["n"] + 1}

    @pkg.actor
    class Hello:
        HOST = True
        said: I32

        @pkg.behaviour
        def create(self, st, _: I32):
            self.exit(0)
            return {**st, "said": st["said"] + 1}

    @pkg.actor
    class Counter:
        count: I32

        @pkg.behaviour
        def increment(self, st, by: I32):
            return {**st, "count": st["count"] + by}

        @pkg.behaviour
        def report(self, st, to: Ref):
            self.send(to, Reporter.result, st["count"])
            return st

    @pkg.actor
    class Reporter:
        HOST = True
        seen: I32
        expected: I32

        @pkg.behaviour
        def result(self, st, count: I32):
            total = st["seen"] + count
            self.exit(0, when=total >= st["expected"])
            return {**st, "seen": total}

    # The spreader's completion promise, as examples/spreader.py keeps
    # it: (a stdlib Promise, the leaf count that fulfils it).
    spread_done = {}

    @pkg.actor
    class Collect:
        HOST = True
        got: I32

        @pkg.behaviour
        def leaf(self, st, n: I32):
            total = st["got"] + n
            done = spread_done.get("promise")
            if done is not None and total >= done[1]:
                done[0].fulfil(int(total))
            return {**st, "got": total}

    @pkg.actor
    class Spread:
        col: Ref["Collect"]

        SPAWNS = {"Spread": 2}
        SPAWN_DISPATCHES = 1
        MAX_SENDS = 5

        @pkg.behaviour
        def go(self, st, level: I32):
            leaf = level <= 0
            a = self.spawn(Spread.init, st["col"], when=~leaf)
            b = self.spawn(Spread.init, st["col"], when=~leaf)
            self.send(a, Spread.go, level - 1, when=~leaf)
            self.send(b, Spread.go, level - 1, when=~leaf)
            self.send(st["col"], Collect.leaf, 1, when=leaf)
            return st

        @pkg.behaviour
        def init(self, st, c: Ref["Collect"]):
            return {**st, "col": c}

    @pkg.actor
    class HiSender:
        PRIORITY = 1
        MAX_SENDS = 4
        sink: Ref

        @pkg.behaviour
        def burst(self, st, v: I32):
            for _ in range(4):
                self.send(st["sink"], Rx.item, v)
            return st

    @pkg.actor
    class LoSender:
        PRIORITY = 0
        MAX_SENDS = 4
        sink: Ref

        @pkg.behaviour
        def burst(self, st, v: I32):
            for _ in range(4):
                self.send(st["sink"], Rx.item, v)
            return st

    @pkg.actor
    class Rx:
        BATCH = 4
        seen: I32
        first4: I32

        @pkg.behaviour
        def item(self, st, v: I32):
            first = st["seen"] < 4
            return {**st, "seen": st["seen"] + 1,
                    "first4": st["first4"] + v * first}

    return types.SimpleNamespace(
        HostLog=HostLog, WalkerH=WalkerH, HCons=HCons, HProd=HProd,
        host_logs=host_logs, HostCounter=HostCounter, HostChain=HostChain,
        DevPing=DevPing, Yielding=Yielding, DevCounter=DevCounter,
        HostKick=HostKick, HostErr=HostErr, Hello=Hello, Counter=Counter,
        Reporter=Reporter, Collect=Collect, Spread=Spread,
        spread_done=spread_done, HiSender=HiSender, LoSender=LoSender,
        Rx=Rx,
        Pinger=Pinger, RingNode=RingNode, Walker=Walker,
        Splitter=Splitter, Cons=Cons, Prod=Prod, Mixer=Mixer, Tri=Tri,
        Div=Div,
        Yielder=Yielder, Exiter=Exiter, Ephemeral=Ephemeral, Errs=Errs,
        TriF=TriF, Arith=Arith, Node=Node, Worker=Worker, Boss=Boss,
        Kid=Kid, Maker=Maker, Relay=Relay, Temp=Temp,
        Collector=Collector, SpawnChild=SpawnChild, Spawner=Spawner)


def new_runtime(pkg, opts_kw, device="cpu"):
    """A Runtime of `pkg` with the tuning cache off (both packages then
    start from the same default window); the port runs on `device`."""
    opts = pkg.RuntimeOptions(tuning_cache="off", **opts_kw)
    if pkg.__name__ == "ponyc_tpu_torch":
        return pkg.Runtime(opts, device=device)
    return pkg.Runtime(opts)


def build_walkers(pkg, T, seed, n_w=24, n_s=8, n_seeds=10, vmax=14,
                  device="cpu", **okw):
    """The randomized Walker/Splitter world of tests/test_differential.py
    (seeded with numpy), ready to run()."""
    rng = np.random.default_rng(seed)
    w_nxt = rng.integers(0, n_w, n_w)
    s_w = rng.integers(0, n_w, n_s)
    s_s = rng.integers(0, n_s, n_s)
    seeds = []
    for _ in range(n_seeds):
        if rng.random() < 0.6:
            seeds.append(("w", int(rng.integers(0, n_w)),
                          int(rng.integers(1, vmax))))
        else:
            seeds.append(("s", int(rng.integers(0, n_s)),
                          int(rng.integers(2, vmax))))
    rt = new_runtime(pkg, okw, device)
    rt.declare(T.Walker, n_w).declare(T.Splitter, n_s)
    rt.start()
    wids = rt.spawn_many(T.Walker, n_w)
    sids = rt.spawn_many(T.Splitter, n_s)
    rt.set_fields(T.Walker, wids, nxt=wids[w_nxt])
    rt.set_fields(T.Splitter, sids, w_ref=wids[s_w], s_ref=sids[s_s])
    for kind, i, v in seeds:
        if kind == "w":
            rt.send(int(wids[i]), T.Walker.step, v)
        else:
            rt.send(int(sids[i]), T.Splitter.burst, v)
    return rt


def churn(pkg, T, seed, device="cpu", **kw):
    """Chain relays spawn Temps that log to a collector and destroy
    themselves (tests/test_lifecycle.py's churn). Returns (runtime,
    sink id, oracle total, oracle hits)."""
    rng = np.random.default_rng(seed)
    n_r = int(rng.integers(6, 16))
    starts = [(int(rng.integers(0, n_r)), int(rng.integers(1, 10)))
              for _ in range(5)]
    nxt = rng.integers(0, n_r, n_r)
    total = sum(v - k for _, v in starts for k in range(v))
    hits = sum(v for _, v in starts)
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=2, msg_words=2,
                               max_sends=2, spill_cap=2048, inject_slots=32,
                               **kw), device)
    rt.declare(T.Relay, n_r).declare(T.Temp, 4 * (hits + 8)).declare(
        T.Collector, 1)
    rt.start()
    sink = rt.spawn(T.Collector)
    rids = rt.spawn_many(T.Relay, n_r)
    rt.set_fields(T.Relay, rids, nxt=rids[np.asarray(nxt)],
                  sink=np.full(n_r, sink))
    for i, v in starts:
        rt.send(int(rids[i]), T.Relay.chain, v)
    return rt, sink, total, hits


def build_fifo(pkg, T, seed, n_cons=6, items=40, device="cpu", **okw):
    """The per-edge FIFO world of tests/test_fifo.py, ready to run()."""
    rng = np.random.default_rng(seed)
    pairs = [(c, s) for c in range(n_cons) for s in range(IN_SLOTS)]
    rng.shuffle(pairs)
    n_prod = len(pairs) // 2
    e1, e2 = pairs[:n_prod], pairs[n_prod:]
    rt = new_runtime(pkg, {"msg_words": 2, **okw}, device)
    rt.declare(T.Prod, n_prod).declare(T.Cons, n_cons)
    rt.start()
    cids = rt.spawn_many(T.Cons, n_cons,
                         last0=np.full(n_cons, -1, np.int32),
                         last1=np.full(n_cons, -1, np.int32),
                         last2=np.full(n_cons, -1, np.int32),
                         last3=np.full(n_cons, -1, np.int32))
    pids = rt.spawn_many(T.Prod, n_prod,
                         c1=cids[np.asarray([c for c, _ in e1])],
                         c2=cids[np.asarray([c for c, _ in e2])],
                         slot1=np.asarray([s for _, s in e1], np.int32),
                         slot2=np.asarray([s for _, s in e2], np.int32))
    rt.bulk_send(pids, T.Prod.produce, np.full(n_prod, items, np.int32))
    return rt


def build_mixers(pkg, T, seed, n=48, n_seeds=24, device="cpu", **okw):
    """A Mixer world with random wiring and seeds (every effect plane)."""
    rng = np.random.default_rng(seed)
    nxt = rng.integers(0, n, n)
    rt = new_runtime(pkg, {"msg_words": 2, **okw}, device)
    rt.declare(T.Mixer, n)
    rt.start()
    ids = rt.spawn_many(T.Mixer, n)
    rt.set_fields(T.Mixer, ids, nxt=ids[nxt])
    for _ in range(n_seeds):
        i = int(rng.integers(0, n))
        if rng.random() < 0.7:
            rt.send(int(ids[i]), T.Mixer.add, int(rng.integers(1, 40)))
        else:
            rt.send(int(ids[i]), T.Mixer.poke, int(rng.integers(0, 30)),
                    int(rng.integers(0, 50)))
    return rt


def counters(rt):
    """The run-level numbers both packages must agree on."""
    return {name: rt.counter(name) for name in (
        "n_processed", "n_delivered", "n_rejected", "n_badmsg",
        "n_deadletter", "n_mutes", "n_destroyed", "n_errors")}


def _host(x):
    """A device array of either package as numpy."""
    if hasattr(x, "detach"):                  # torch
        return x.detach().cpu().numpy()
    return np.asarray(x)


_BASE = dict(mailbox_cap=8, msg_words=1, spill_cap=64, inject_slots=32)
# The fused-kernel corpus worlds: actor types and options of each.
CORPUS_WORLDS = {
    "yield_exit": (("Yielder", "Exiter"), dict(_BASE, batch=4, max_sends=0)),
    "trif": (("TriF",), dict(_BASE, batch=4, max_sends=1)),
    "destroy": (("Ephemeral",), dict(_BASE, batch=2, max_sends=0)),
    "errors": (("Errs",), dict(_BASE, batch=2, max_sends=0)),
}
CORPUS = tuple(CORPUS_WORLDS)
# Actors each corpus world declares (type name, capacity).
CORPUS_DECLARE = {"yield_exit": (("Yielder", 2), ("Exiter", 1)),
                  "trif": (("TriF", 3),), "destroy": (("Ephemeral", 4),),
                  "errors": (("Errs", 2),)}


def corpus_runtime(pkg, T, name, device="cpu", **okw):
    """The started Runtime of one corpus world, nothing spawned yet."""
    rt = new_runtime(pkg, {**CORPUS_WORLDS[name][1], **okw}, device)
    for tname, n in CORPUS_DECLARE[name]:
        rt.declare(getattr(T, tname), n)
    return rt.start()


def run_corpus(pkg, T, name, device="cpu", rt=None, **okw):
    """Run one world of the fused-kernel corpus (the programs of
    tests/test_fused_dispatch.py; on `rt` from corpus_runtime, if given)
    and return the numbers the packages, or the card and the CPU, must
    agree on: exit codes, counters, ticks, every field, liveness and last
    error codes."""
    rt = rt or corpus_runtime(pkg, T, name, device, **okw)
    codes = []
    if name == "yield_exit":
        y = rt.spawn_many(T.Yielder, 1)[0]
        for _ in range(6):
            rt.send(int(y), T.Yielder.tick, 1)
        codes.append(rt.run())
        ex = rt.spawn_many(T.Exiter, 1)[0]
        rt.send(int(ex), T.Exiter.go, 7)
        codes.append(rt.run())
        types = (T.Yielder, T.Exiter)
    elif name == "trif":
        ids = rt.spawn_many(T.TriF, 3)
        rt.set_fields(T.TriF, ids, buddy=np.roll(ids, -1))
        seq = [(0, T.TriF.add, (5,)), (1, T.TriF.scale, (3,)),
               (0, T.TriF.ping, ()), (2, T.TriF.add, (7,)),
               (1, T.TriF.add, (2,)), (0, T.TriF.scale, (1,)),
               (2, T.TriF.ping, ()), (1, T.TriF.ping, ())]
        for i, b, args in seq:
            rt.send(int(ids[i]), b, *args)
        codes.append(rt.run())
        types = (T.TriF,)
    elif name == "destroy":
        for i in rt.spawn_many(T.Ephemeral, 4):
            rt.send(int(i), T.Ephemeral.die, 1 if int(i) % 2 == 0 else 0)
        codes.append(rt.run())
        types = (T.Ephemeral,)
    elif name == "errors":
        a, b = rt.spawn_many(T.Errs, 2)
        rt.send(int(a), T.Errs.go, 41)
        rt.send(int(a), T.Errs.go, 42)     # the latest error wins
        rt.send(int(b), T.Errs.go, 0)      # no error
        codes.append(rt.run())
        types = (T.Errs,)
    return {"codes": codes, "counters": counters(rt),
            "steps": rt.steps_run,
            "fields": {t.__name__: {f: v.tolist() for f, v in
                                    rt.cohort_state(t).items()}
                       for t in types},
            "alive": _host(rt.state.alive).tolist(),
            "last_error": _host(rt.state.last_error).tolist()}


def define_blobs(pkg):
    """Actor types of the blob-pool and collector tests (tests/
    test_blobs.py, tests/test_gc.py, the blob chain of
    tests/test_differential.py and examples/blob_pipeline.py), built with
    `pkg`. Bodies use only Python operators: `jnp.int32(0)` is spelt 0
    and `jnp.where(m, x, 0)` as `x * m`, which both packages evaluate
    alike."""
    I32, Ref, Blob, BlobVal = pkg.I32, pkg.Ref, pkg.Blob, pkg.BlobVal

    @pkg.actor
    class Producer:
        out: Ref["Consumer"]
        MAX_BLOBS = 1
        MAX_SENDS = 1

        @pkg.behaviour
        def go(self, st, n: I32):
            h = self.blob_alloc(length=4)
            for i in range(4):
                self.blob_set(h, i, n * 10 + i)
            self.send(st["out"], Consumer.take, h)
            return st

    @pkg.actor
    class Consumer:
        total: I32
        seen: I32

        @pkg.behaviour
        def take(self, st, h: Blob):
            s = 0
            for i in range(4):
                s = s + self.blob_get(h, i)
            st = {**st, "total": st["total"] + s,
                  "seen": st["seen"] + self.blob_length(h)}
            self.blob_free(h)
            return st

    @pkg.actor
    class Leaker:
        n: I32
        MAX_BLOBS = 1

        @pkg.behaviour
        def leak(self, st):
            self.blob_alloc()                   # never freed
            return st

    @pkg.actor
    class Hungry:
        n: I32
        MAX_BLOBS = 1
        BLOB_DISPATCHES = 1

        @pkg.behaviour
        def grab(self, st):
            self.blob_alloc(length=1)
            return st

    @pkg.actor
    class Summer:
        total: I32

        @pkg.behaviour
        def add(self, st, h: Blob):
            s = 0
            for i in range(3):
                s = s + self.blob_get(h, i)
            st = {**st, "total": st["total"] + s}
            self.blob_free(h)
            return st

    @pkg.actor
    class Reader:
        got: I32

        @pkg.behaviour
        def probe(self, st, h: Blob):
            return {**st, "got": st["got"] + self.blob_get(h, 0)}

    @pkg.actor
    class Holder:
        stash: Blob
        MAX_BLOBS = 1

        @pkg.behaviour
        def keep(self, st):
            h = self.blob_alloc(length=2)
            self.blob_set(h, 0, 9)
            return {**st, "stash": h}

    @pkg.actor
    class Lean:
        stash: Blob
        MAX_BLOBS = 1
        BLOB_DISPATCHES = 1

        @pkg.behaviour
        def fill(self, st, v: I32):
            h = self.blob_alloc(length=1)
            self.blob_set(h, 0, v)
            return {**st, "stash": h}

    @pkg.actor
    class Caster:
        a: Ref["ValReader"]
        b: Ref["ValReader"]
        MAX_BLOBS = 1
        MAX_SENDS = 2

        @pkg.behaviour
        def cast(self, st, x: I32):
            h = self.blob_alloc(length=2)
            self.blob_set(h, 0, x)
            self.blob_set(h, 1, x * 2)
            v = self.blob_freeze(h)
            self.send(st["a"], ValReader.read, v)
            self.send(st["b"], ValReader.read, v)   # alias: legal for val
            return st

    @pkg.actor
    class ValReader:
        got: I32

        @pkg.behaviour
        def read(self, st, v: BlobVal):
            return {**st, "got": st["got"] + self.blob_get(v, 0)
                    + self.blob_get(v, 1)}

    @pkg.actor
    class Fwd:
        sink: Ref["Keeper"]
        MAX_SENDS = 1

        @pkg.behaviour
        def fwd(self, st, h: Blob):
            self.send(st["sink"], Keeper.keep, h)
            return st

    @pkg.actor
    class Keeper:
        held: Blob

        @pkg.behaviour
        def keep(self, st, h: Blob):
            return {**st, "held": h}

    @pkg.actor
    class BlobWalker:
        """tests/test_differential.py's BlobWalker: each hop reads the
        token blob's word, frees it, and (while v > 0) allocates a fresh
        blob carrying word + 1 for the successor."""
        acc: I32
        nxt: Ref["BlobWalker"]

        MAX_SENDS = 1
        MAX_BLOBS = 1
        BLOB_DISPATCHES = 1
        BATCH = 1

        @pkg.behaviour
        def step(self, st, v: I32, h: Blob):
            w0 = self.blob_get(h, 0)
            self.blob_free(h)
            go = v > 0
            h2 = self.blob_alloc(length=1, when=go)
            self.blob_set(h2, 0, w0 + 1, when=go)
            self.send(st["nxt"], BlobWalker.step, v - 1, h2, when=go)
            return {**st, "acc": st["acc"] + w0}

    @pkg.actor
    class Tokenizer:
        """examples/blob_pipeline.py: checksum a line, free it, and
        broadcast one frozen summary to both reviewers."""
        a: Ref["Reviewer"]
        b: Ref["Reviewer"]
        MAX_BLOBS = 1
        BATCH = 2
        MAX_SENDS = 2

        @pkg.behaviour
        def take(self, st, line: Blob):
            ln = self.blob_length(line)
            s = 0
            for i in range(PIPE_W):
                s = s + self.blob_get(line, i) * (i < ln)
            self.blob_free(line)
            out = self.blob_alloc(length=2)
            self.blob_set(out, 0, s)
            self.blob_set(out, 1, ln)
            summary = self.blob_freeze(out)
            self.send(st["a"], Reviewer.review, summary)
            self.send(st["b"], Reviewer.review, summary)
            return st

    @pkg.actor
    class Reviewer:
        checks: I32
        words: I32
        n: I32

        @pkg.behaviour
        def review(self, st, summary: BlobVal):
            return {"checks": st["checks"] + self.blob_get(summary, 0),
                    "words": st["words"] + self.blob_get(summary, 1),
                    "n": st["n"] + 1}

    @pkg.actor
    class GNode:
        """tests/test_gc.py's Node."""
        next_ref: Ref
        hits: I32

        @pkg.behaviour
        def link(self, st, to: Ref):
            return {**st, "next_ref": to}

        @pkg.behaviour
        def poke(self, st):
            return {**st, "hits": st["hits"] + 1}

    @pkg.actor
    class BlobProd:
        """tests/test_fifo.py's blob producer: every message carries its
        stamp in a payload word and inside its blob."""
        c1: Ref["BlobCons"]
        slot1: I32
        seq: I32

        MAX_SENDS = 2
        MAX_BLOBS = 1
        BLOB_DISPATCHES = 1
        BATCH = 1

        @pkg.behaviour
        def produce(self, st, n: I32):
            go = n > 0
            h = self.blob_alloc(length=2, when=go)
            self.blob_set(h, 0, st["seq"], when=go)
            self.blob_set(h, 1, self.actor_id, when=go)
            self.send(st["c1"], BlobCons.consume, st["slot1"], st["seq"], h,
                      when=go)
            self.send(self.actor_id, BlobProd.produce, n - 1, when=n > 1)
            return {**st, "seq": st["seq"] + (n > 0) * np.int32(1)}

    @pkg.actor
    class BlobCons:
        """Counts per-edge FIFO violations (`bad`) and payload/message
        binding violations (`badbind`)."""
        last0: I32
        last1: I32
        got: I32
        bad: I32
        badbind: I32

        @pkg.behaviour
        def consume(self, st, slot: I32, seq: I32, h: Blob):
            bseq = self.blob_get(h, 0)
            self.blob_free(h)
            upd = dict(st)
            upd["badbind"] = st["badbind"] + (bseq != seq)
            for s in range(2):
                is_s = slot == s
                last = st[f"last{s}"]
                upd[f"last{s}"] = last + (seq - last) * is_s
            viol = sum((slot == s) & (seq != st[f"last{s}"] + 1)
                       for s in range(2))
            upd["bad"] = st["bad"] + viol
            upd["got"] = st["got"] + 1
            return upd

    return types.SimpleNamespace(
        BlobProd=BlobProd, BlobCons=BlobCons,
        Producer=Producer, Consumer=Consumer, Leaker=Leaker, Hungry=Hungry,
        Summer=Summer, Reader=Reader, Holder=Holder, Lean=Lean,
        Caster=Caster, ValReader=ValReader, Fwd=Fwd, Keeper=Keeper,
        BlobWalker=BlobWalker, Tokenizer=Tokenizer, Reviewer=Reviewer,
        GNode=GNode)


PIPE_W = 16       # examples/blob_pipeline.py's pool width
PIPE_LINES = ("hello pony", "actors all the way down",
              "payloads live on the device now")


def blob_world(rt, *atypes):
    """What a blob run leaves behind that the packages (and the window
    kernel's host build) must agree on: counters, ticks, every field,
    liveness and the pool arrays."""
    names = ("n_blob_alloc", "n_blob_free", "n_blob_remote", "n_collected")
    st = rt.state
    return {"counters": {**counters(rt),
                         **{n: rt.counter(n) for n in names}},
            "steps": rt.steps_run, "exit": rt.exit_code,
            "alive": _host(st.alive).tolist(),
            "fields": {t.__name__: {f: np.asarray(v).tolist() for f, v in
                                    rt.cohort_state(t).items()}
                       for t in atypes},
            "pool": {f: _host(getattr(st, f)).tolist() for f in (
                "blob_data", "blob_used", "blob_len", "blob_gen",
                "blob_fail", "blob_budget_fail")}}


def run_blob_chain(pkg, T, seed, opts_kw, n=None, n_starts=6, vmax=10,
                   device="cpu"):
    """tests/test_differential.py's run_blob_chain on one shard: a random
    functional graph of BlobWalkers, chains seeded by host-stored blobs,
    checked against the sequential oracle. Returns the runtime."""
    rng = np.random.default_rng(seed)
    n = n or int(rng.integers(8, 40))
    nxt = rng.integers(0, n, n)
    seeds = [(int(rng.integers(0, n)), int(rng.integers(1, vmax)),
              int(rng.integers(0, 50))) for _ in range(n_starts)]
    want = np.zeros(n, np.int64)
    q = collections.deque(seeds)
    while q:
        i, v, w = q.popleft()
        want[i] += w
        if v > 0:
            q.append((int(nxt[i]), v - 1, w + 1))
    rt = new_runtime(pkg, dict(msg_words=3, blob_slots=256, blob_words=2,
                               **opts_kw), device)
    rt.declare(T.BlobWalker, n).start()
    ids = rt.spawn_many(T.BlobWalker, n, acc=0)
    rt.set_fields(T.BlobWalker, ids, nxt=ids[np.asarray(nxt)])
    for i, v, w in seeds:
        h = rt.blob_store([w], near=int(ids[i]))
        rt.send(int(ids[i]), T.BlobWalker.step, v, h)
    assert rt.run(max_steps=100_000) == 0
    st = rt.cohort_state(T.BlobWalker)
    assert (st["acc"][:n].astype(np.int64) == want).all()
    assert rt.blobs_in_use == 0
    assert rt.counter("n_blob_remote") == 0
    return rt


def run_blob_fifo(pkg, T, seed, okw, n_cons=4, items=30, device="cpu"):
    """tests/test_fifo.py's run_blob_fifo: two edges per consumer, every
    stamp in a word and in its blob; checks FIFO, binding and that every
    blob was freed. Returns the runtime."""
    rng = np.random.default_rng(seed)
    n_prod = 2 * n_cons
    perm = rng.permutation(n_prod)
    cons_of = np.repeat(np.arange(n_cons), 2)[perm]
    slot_of = np.tile(np.arange(2), n_cons)[perm]
    rt = new_runtime(pkg, dict(msg_words=3, blob_slots=max(256, n_prod *
                                                            items),
                               blob_words=2, **okw), device)
    rt.declare(T.BlobProd, n_prod).declare(T.BlobCons, n_cons).start()
    cids = rt.spawn_many(T.BlobCons, n_cons,
                         last0=np.full(n_cons, -1, np.int32),
                         last1=np.full(n_cons, -1, np.int32))
    pids = rt.spawn_many(T.BlobProd, n_prod, c1=cids[cons_of],
                         slot1=slot_of.astype(np.int32))
    rt.bulk_send(pids, T.BlobProd.produce, np.full(n_prod, items, np.int32))
    assert rt.run(max_steps=500_000) == 0
    st = rt.cohort_state(T.BlobCons)
    assert not st["badbind"].any() and not st["bad"].any()
    for s in range(2):
        assert (st[f"last{s}"] == items - 1).all()
    assert (st["got"] == 2 * items).all()
    assert rt.blobs_in_use == 0
    return rt


def run_blob_pipeline(pkg, T, device="cpu", **okw):
    """examples/blob_pipeline.py's program at its own size: lines stored
    as blobs, tokenized, one frozen summary broadcast to two reviewers,
    the summaries swept by gc(). Returns (runtime, reviewers, blobs in
    use before the gc)."""
    rt = new_runtime(pkg, dict(blob_slots=32, blob_words=PIPE_W,
                               msg_words=2, max_sends=2, **okw), device)
    rt.declare(T.Tokenizer, 4).declare(T.Reviewer, 4).start()
    r1 = rt.spawn(T.Reviewer, checks=0, words=0, n=0)
    r2 = rt.spawn(T.Reviewer, checks=0, words=0, n=0)
    tok = rt.spawn(T.Tokenizer, a=r1, b=r2)
    for text in PIPE_LINES:
        rt.send(tok, T.Tokenizer.take, rt.blob_store_str(text))
    rt.run()
    before = rt.blobs_in_use
    rt.gc()
    return rt, (r1, r2), before


def define_telemetry(pkg):
    """Actor types of the analysis and tracing tests
    (tests/test_analysis.py, test_profiler.py, test_tracing.py), built
    with `pkg`."""
    I32, Ref = pkg.I32, pkg.Ref

    @pkg.actor
    class Worker:
        done: I32

        @pkg.behaviour
        def work(self, st, v: I32):
            return {**st, "done": st["done"] + v}

        @pkg.behaviour
        def reset(self, st, v: I32):
            return {**st, "done": v}

    @pkg.actor
    class Driver:
        out: Ref["Worker"]
        left: I32
        MAX_SENDS = 2

        @pkg.behaviour
        def tick(self, st, _: I32):
            self.send(st["out"], Worker.work, 1, when=st["left"] > 0)
            self.send(self.actor_id, Driver.tick, 0, when=st["left"] > 1)
            return {**st, "left": st["left"] - 1}

    @pkg.actor
    class SlowP:
        n: I32
        BATCH = 1

        @pkg.behaviour
        def eat(self, st, v: I32):
            return {**st, "n": st["n"] + 1}

    @pkg.actor
    class FastP:
        out: Ref["SlowP"]
        left: I32
        MAX_SENDS = 2

        @pkg.behaviour
        def go(self, st, _: I32):
            self.send(st["out"], SlowP.eat, 1, when=st["left"] > 0)
            self.send(self.actor_id, FastP.go, 0, when=st["left"] > 1)
            return {**st, "left": st["left"] - 1}

    @pkg.actor
    class Child:
        x: I32

        @pkg.behaviour
        def init(self, st, v: I32):
            self.error_int(7, when=v == 1)
            self.destroy(when=v == 1)
            return {**st, "x": v}

    @pkg.actor
    class Boss:
        SPAWNS = {"Child": 1}
        made: I32

        @pkg.behaviour
        def make(self, st, v: I32):
            self.spawn(Child.init, v)
            return {**st, "made": st["made"] + 1}

    @pkg.actor
    class DevSrc:
        out: Ref
        MAX_SENDS = 1

        @pkg.behaviour
        def emit(self, st, v: I32):
            self.send(st["out"], HostSink.take, v)
            return st

    @pkg.actor
    class HostSink:
        HOST = True
        seen: I32

        @pkg.behaviour
        def take(self, st, v: I32):
            return {**st, "seen": st["seen"] + v}

    @pkg.actor
    class Sink:
        n: I32

        @pkg.behaviour
        def take(self, st, v: I32):
            return {**st, "n": st["n"] + v}

    @pkg.actor
    class Mid:
        out: Ref["Sink"]

        @pkg.behaviour
        def relay(self, st, v: I32):
            self.send(st["out"], Sink.take, v)
            return st

    @pkg.actor
    class Src:
        out: Ref["Mid"]

        @pkg.behaviour
        def go(self, st, v: I32):
            self.send(st["out"], Mid.relay, v)
            return st

    @pkg.actor
    class Fan:
        a: Ref["Sink"]
        b: Ref["Sink"]
        MAX_SENDS = 2

        @pkg.behaviour
        def go(self, st, v: I32):
            self.send(st["a"], Sink.take, v)
            self.send(st["b"], Sink.take, v)
            return st

    @pkg.actor
    class HostRelay:
        HOST = True
        out: Ref["Sink"]

        @pkg.behaviour
        def relay(self, st, v: I32):
            self.send(st["out"], Sink.take, v)
            return st

    return types.SimpleNamespace(
        Worker=Worker, Driver=Driver, SlowP=SlowP, FastP=FastP,
        Child=Child, Boss=Boss, DevSrc=DevSrc, HostSink=HostSink,
        Sink=Sink, Mid=Mid, Src=Src, Fan=Fan, HostRelay=HostRelay)


def telemetry_of(rt):
    """What the telemetry of a finished run must agree on across the
    packages and paths: the profile (analysis >= 1), the event ring's
    leaves and the recorded spans (tracing), ticks and counters."""
    out = {"steps": rt.steps_run, "counters": counters(rt)}
    if rt.opts.analysis >= 1:
        out["profile"] = rt.profile()
    st = rt.state
    if rt.opts.analysis >= 3:
        out["events"] = {f: _host(getattr(st, f)).tolist()
                         for f in ("ev_data", "ev_count", "ev_dropped")}
    if rt.opts.tracing:
        trees = rt.traces()
        out["spans"] = sorted(rt._tracer.spans)
        out["span_dropped"] = rt._tracer.dropped
        out["traces"] = {t: (v["n_spans"], v["latency"],
                             tuple(v["critical_path"]))
                         for t, v in trees.items()}
    return out


# Columns of the analysis CSV that hold wall-clock or host-process
# readings (everything else is a function of the program and its seed).
WALL_COLUMNS = ("time_ms", "rss_kb", "cpu_ms", "host_gap_us")


def csv_rows(path, skip=WALL_COLUMNS):
    """The deterministic columns of an analysis CSV, row by row."""
    import csv
    with open(path) as f:
        return [{k: v for k, v in r.items() if k not in skip}
                for r in csv.DictReader(f)]


def define_ops(pkg):
    """Actor types of the flight-recorder, metrics and host-API tests
    (tests/test_flight.py, test_metrics.py, test_stdlib_extra.py), built
    with `pkg`."""
    I32, Ref = pkg.I32, pkg.Ref

    @pkg.actor
    class HostEcho:
        n: I32
        HOST = True

        @pkg.behaviour
        def ping(self, st, v: I32):
            return {**st, "n": st["n"] + v}

    @pkg.actor
    class Bad:
        n: I32
        HOST = True

        @pkg.behaviour
        def boom(self, st, v: I32):
            raise ValueError("kaboom")

    @pkg.actor
    class Sink:
        total: I32

        @pkg.behaviour
        def consume(self, st, v: I32):
            return {**st, "total": st["total"] + v}

    @pkg.actor
    class Producer:
        sink: Ref["Sink"]
        left: I32
        MAX_SENDS = 2

        @pkg.behaviour
        def produce(self, st, n: I32):
            self.send(st["sink"], Sink.consume, 1, when=n > 0)
            self.send(self.actor_id, Producer.produce, n - 1, when=n > 0)
            return {**st, "left": n - 1}

    @pkg.actor
    class Ticker:
        """Counts down on the device; at `n == 1` it mails the host."""
        host: Ref["HostEcho"]
        MAX_SENDS = 2

        @pkg.behaviour
        def tick(self, st, n: I32):
            self.send(self.actor_id, Ticker.tick, n - 1, when=n > 1)
            self.send(st["host"], HostEcho.ping, n, when=n == 1)
            return st

    return types.SimpleNamespace(HostEcho=HostEcho, Bad=Bad, Sink=Sink,
                                 Producer=Producer, Ticker=Ticker)


def ops_world(pkg, O, ticks=24, device="cpu", **okw):
    """A device Ticker counting down `ticks` ticks beside a host
    HostEcho it mails at the end, and a HostEcho pinged from the API:
    windows with and without host attention, pipelined dispatches, and
    one exit-free quiescence."""
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=1, max_sends=2,
                               msg_words=1, spill_cap=64, inject_slots=8,
                               quiesce_interval=4, **okw), device)
    rt.declare(O.Ticker, 2).declare(O.HostEcho, 2)
    rt.start()
    h = rt.spawn(O.HostEcho)
    t = rt.spawn(O.Ticker, host=h)
    rt.send(int(t), O.Ticker.tick, ticks)
    rt.send(int(h), O.HostEcho.ping, 5)
    return rt, int(t), int(h)


# randping: the reference message-ubench's random-peer traffic, which the
# JAX package's ubench model replaces with a fixed permutation. Every
# pinger is seeded with RP_TOKENS tokens ping(n, k), k = 0..RP_TOKENS-1;
# ping(n, k) at actor a counts a visit and a hit when uniform(a, n, k) <
# 0.5, and while n > 1 passes ping(n - 1, k) to randint(a, n, 0, N, k).
# A token's walk depends on (actor, n, k) alone, not on timing, so
# `randping_oracle` replays every walk in uint32 NumPy arithmetic.
RP_TOKENS = 4
RP_OPTS = dict(mailbox_cap=16, batch=8, msg_words=2, max_sends=1)


def define_random(pkg, n):
    """The randping program for `n` pingers (ids 0..n-1: the world
    declares this type alone), built with `pkg`; its body draws from
    `pkg`'s stdlib.random."""
    rnd = importlib.import_module(pkg.__name__ + ".stdlib.random")
    I32 = pkg.I32

    @pkg.actor
    class RandPinger:
        visits: I32
        hits: I32

        MAX_SENDS = 1

        @pkg.behaviour
        def ping(self, st, n_left: I32, k: I32):
            peer = rnd.randint(self.actor_id, n_left, 0, n, draw=k)
            self.send(peer, RandPinger.ping, n_left - 1, k,
                      when=n_left > 1)
            u = rnd.uniform(self.actor_id, n_left, draw=k)
            return {**st, "visits": st["visits"] + 1,
                    "hits": st["hits"] + (u < 0.5) * np.int32(1)}

    return RandPinger


def randping_opts(n, **okw):
    """The options of a randping world of `n` pingers: the spill holds
    every token."""
    return {**RP_OPTS, "spill_cap": RP_TOKENS * n, "inject_slots": 8,
            **okw}


def randping_build(pkg, P, n, hops, device="cpu", **okw):
    """A started randping world of `n` pingers, every one seeded with
    RP_TOKENS tokens of `hops` visits each; ready to run()."""
    rt = new_runtime(pkg, randping_opts(n, **okw), device)
    rt.declare(P, n).start()
    ids = rt.spawn_many(P, n)
    assert (np.asarray(ids) == np.arange(n)).all()
    for k in range(RP_TOKENS):
        rt.bulk_send(ids, P.ping, np.full(n, hops, np.int32),
                     np.full(n, k, np.int32))
    return rt


def _np_mix(a, b):
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    x = a * np.uint32(0x9E3779B9) + b
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def np_bits(actor, step, draw, seed=0x5DEECE66):
    """stdlib.random.bits in uint32 NumPy: the oracle's own arithmetic."""
    with np.errstate(over="ignore"):
        h = _np_mix(np.uint32(seed), np.asarray(actor).astype(np.uint32))
        h = _np_mix(h, np.asarray(step).astype(np.uint32))
        return _np_mix(h, np.asarray(draw).astype(np.uint32))


def randping_oracle(n, hops, tokens=range(RP_TOKENS)):
    """(visits, hits) per actor of randping with `n` pingers and `hops`
    visits a token: every walk of the `tokens` replayed in uint32
    NumPy (the sums over disjoint token sets add up)."""
    tokens = list(tokens)
    visits = np.zeros(n, np.int64)
    hits = np.zeros(n, np.int64)
    at = np.tile(np.arange(n, dtype=np.int64), len(tokens))
    k = np.repeat(np.asarray(tokens, dtype=np.int64), n)
    for left in range(hops, 0, -1):
        b = np_bits(at, left, k)
        visits += np.bincount(at, minlength=n)
        u = (b >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
        hits += np.bincount(at, weights=u < np.float32(0.5),
                            minlength=n).astype(np.int64)
        at = (b % np.uint32(n)).astype(np.int64)
    return visits, hits


HEART_BEATS = 5     # examples/heartbeat.py's


def define_stdlib(pkg):
    """The host-services program: examples/heartbeat.py's Heart (a
    device actor a stdlib timer beats, exiting after HEART_BEATS) beside
    a host actor that logs a child process's output and exit code
    (tests/test_process_files.py's Collector); the bytes each ProcLog
    received are in `ProcLog.chunks`."""
    I32 = pkg.I32

    @pkg.actor
    class Heart:
        beats: I32

        @pkg.behaviour
        def beat(self, st, kind: I32, n: I32, flags: I32):
            total = st["beats"] + n
            self.exit(0, when=total >= HEART_BEATS)
            return {**st, "beats": total}

    chunks = {}

    @pkg.actor
    class ProcLog:
        HOST = True
        n_out: I32
        n_err: I32
        code: I32
        done: I32

        @pkg.behaviour
        def on_stdout(self, st, proc: I32, data: I32, n: I32):
            chunks.setdefault(int(self.actor_id), []).append(
                self.rt.heap.unbox(data))
            return {**st, "n_out": st["n_out"] + n}

        @pkg.behaviour
        def on_stderr(self, st, proc: I32, data: I32, n: I32):
            self.rt.heap.drop(data)
            return {**st, "n_err": st["n_err"] + n}

        @pkg.behaviour
        def on_exit(self, st, proc: I32, code: I32):
            return {**st, "code": code, "done": 1}

    ProcLog.chunks = chunks
    return types.SimpleNamespace(Heart=Heart, ProcLog=ProcLog)


STDLIB_OPTS = dict(mailbox_cap=8, batch=2, msg_words=3, max_sends=1,
                   inject_slots=8)


def stdlib_world(pkg, S, device="cpu", child=("sh", "-c",
                                              "echo child-says-hi; exit 3"),
                 **okw):
    """A heartbeat and a child process in one runtime of `pkg`: the child
    runs to its exit through attach_processes(), then a count-limited
    timer beats the Heart until it exits the run. Returns (runtime,
    what the run observed)."""
    timers = importlib.import_module(pkg.__name__ + ".stdlib.timers")
    S.ProcLog.chunks.clear()            # an earlier world's, same row ids
    rt = new_runtime(pkg, {**STDLIB_OPTS, **okw}, device)
    rt.declare(S.Heart, 1).declare(S.ProcLog, 1).start()
    h = rt.spawn(S.Heart, beats=0)
    log = rt.spawn(S.ProcLog)
    procs = rt.attach_processes()
    procs.spawn("/bin/sh", list(child), int(log),
                on_stdout=S.ProcLog.on_stdout, on_stderr=S.ProcLog.on_stderr,
                on_exit=S.ProcLog.on_exit)
    code_proc = rt.run()
    got = {k: int(v) for k, v in rt.state_of(log).items()}
    got["stdout"] = b"".join(S.ProcLog.chunks.get(int(log), []))
    hub = timers.Timers(rt)
    hub.timer(int(h), S.Heart.beat, interval_s=0.05, count=HEART_BEATS)
    code = rt.run()
    out = {"proc": got, "proc_run_code": code_proc, "code": code,
           "beats": int(rt.state_of(h)["beats"]), "live_timers":
           len(hub._live)}
    return rt, out


# ---- the static checks' programs (verify, lint, docgen, translate) -----

def const_mask(pkg, value):
    """A 0-dim boolean built inside a body with `pkg`'s array library
    (jnp under the JAX package's abstract trace, torch on the port's
    meta-device probe)."""
    if pkg.__name__ == "ponyc_tpu":
        return importlib.import_module("jax.numpy").asarray(value)
    return importlib.import_module("torch").tensor(value)


def define_static(pkg):
    """The verify and lint tests' actor types, built with `pkg`: the JAX
    package's tests/test_verify.py and tests/test_lint.py fixtures plus
    bodies that need a value at trace time and masks of every kind.
    `WORLDS` names the type sets the lint tests analyse together, with
    their roots (None: un-rooted)."""
    I32, Ref, Iso = pkg.I32, pkg.Ref, pkg.Iso
    Blob, BlobVal = pkg.Blob, pkg.BlobVal

    @pkg.actor
    class Quiet:
        x: I32

        @pkg.behaviour
        def set(self, st, v: I32):
            return {**st, "x": v}

    @pkg.actor
    class Busy:
        out: Ref["Quiet"]
        MAX_SENDS = 2
        SPAWNS = {"Quiet": 1}

        @pkg.behaviour
        def go(self, st, v: I32):
            self.send(st["out"], Quiet.set, v)
            self.spawn(Quiet.set, v, when=v > 0)
            self.error_int(7, when=v < 0)
            self.exit(0, when=v == 0)
            return st

        @pkg.behaviour
        def lazy(self, st, v: I32):
            self.yield_(when=v > 3)
            self.destroy(when=v > 9)
            return st

    @pkg.actor
    class Sink:
        x: I32

        @pkg.behaviour
        def put(self, st, v: I32):
            return {**st, "x": v}

    @pkg.actor
    class Feeder:
        out: Ref["Sink"]
        MAX_SENDS = 2
        SPAWNS = {"Sink": 1}

        @pkg.behaviour
        def go(self, st, v: I32):
            self.send(st["out"], Sink.put, v)
            self.spawn(Sink.put, v, when=v > 0)
            return st

    @pkg.actor
    class Masks:
        """One send a kind of mask: Python, NumPy, a field, an argument,
        a 0-dim constant built in the body, constant False."""
        out: Ref["Sink"]
        n: I32
        MAX_SENDS = 6

        @pkg.behaviour
        def go(self, st, v: I32):
            self.send(st["out"], Sink.put, v, when=True)
            self.send(st["out"], Sink.put, v, when=np.bool_(True))
            self.send(st["out"], Sink.put, v, when=st["n"] > 0)
            self.send(st["out"], Sink.put, v, when=v > 1)
            self.send(st["out"], Sink.put, v, when=const_mask(pkg, True))
            self.send(st["out"], Sink.put, v, when=False)
            return st

    @pkg.actor
    class Lonely:
        y: I32

        @pkg.behaviour
        def idle(self, st, v: I32):
            return st

    @pkg.actor
    class HalfDead:
        o: Ref["Sink"]
        MAX_SENDS = 1

        @pkg.behaviour
        def used(self, st, v: I32):
            self.send(st["o"], Sink.put, v)
            return st

        @pkg.behaviour
        def never(self, st, v: I32):
            return st

    @pkg.actor
    class Tree:
        parent: Ref
        SPAWNS = {"Tree": 2}
        MAX_SENDS = 3

        @pkg.behaviour
        def grow(self, st, d: I32, parent: Ref):
            leaf = d <= 0
            self.spawn(Tree.grow, d - 1, self.actor_id, when=~leaf)
            self.spawn(Tree.grow, d - 1, self.actor_id, when=~leaf)
            self.send(parent, Tree.up, when=leaf)
            return st

        @pkg.behaviour
        def up(self, st):
            return st

    @pkg.actor
    class Orphaned:
        x: I32

        @pkg.behaviour
        def take(self, st, v: I32):
            return {**st, "x": v}

    @pkg.actor
    class Talker:
        o: Ref["Orphaned"]
        MAX_SENDS = 1

        @pkg.behaviour
        def go(self, st, v: I32):
            self.send(st["o"], Orphaned.take, v)
            return st

    @pkg.actor
    class Taker:
        x: I32

        @pkg.behaviour
        def take(self, st, p: Iso):
            return st

    @pkg.actor
    class Aliaser:
        a: Ref["Taker"]
        b: Ref["Taker"]
        MAX_SENDS = 2

        @pkg.behaviour
        def go(self, st, p: Iso):
            self.send(st["a"], Taker.take, p)
            self.send(st["b"], Taker.take, p)      # aliased move
            return st

    @pkg.actor
    class Scribbler:
        x: I32

        @pkg.behaviour
        def scribble(self, st, b: BlobVal):
            self.blob_set(b, 0, 1)        # write to shared-immutable
            return st

    @pkg.actor
    class HostReader:
        HOST = True
        n: I32

        @pkg.behaviour
        def read(self, st, b: Blob):
            return st

    @pkg.actor
    class Ping:
        o: Ref["Pong"]
        MAX_SENDS = 2

        @pkg.behaviour
        def ping(self, st, v: I32):
            self.send(st["o"], Pong.pong, v)
            self.send(st["o"], Pong.pong, v)
            return st

    @pkg.actor
    class Pong:
        o: Ref["Ping"]
        MAX_SENDS = 1

        @pkg.behaviour
        def pong(self, st, v: I32):
            self.send(st["o"], Ping.ping, v)
            return st

    @pkg.actor
    class Careful:
        o: Ref["Careful"]
        MAX_SENDS = 2

        @pkg.behaviour
        def go(self, st, v: I32):
            self.send(st["o"], Careful.go, v - 1, when=v > 0)
            self.send(st["o"], Careful.go, v - 2, when=v > 1)
            return st

    @pkg.actor
    class Fork:
        x: I32
        SPAWNS = {"Fork": 1}
        MAX_SENDS = 2

        @pkg.behaviour
        def boom(self, st, v: I32):
            self.spawn(Fork.boom, v)
            self.send(self.actor_id, Fork.boom, v)
            return st

    @pkg.actor
    class Leaker:
        x: I32
        MAX_BLOBS = 1
        MAX_SENDS = 1

        @pkg.behaviour
        def churn(self, st, v: I32):
            self.blob_alloc(length=1)          # never freed, not frozen
            self.send(self.actor_id, Leaker.churn, v)
            return st

    @pkg.actor
    class Hoarder:
        x: I32
        SPAWNS = {"Sink": 2}
        MAX_BLOBS = 3

        @pkg.behaviour
        def idle(self, st, v: I32):
            return st

    @pkg.actor
    class Muted:
        x: I32
        SPAWNS = {"Muted": 1}
        MAX_SENDS = 2
        LINT_IGNORE = ("R5",)

        @pkg.behaviour
        def boom(self, st, v: I32):
            self.spawn(Muted.boom, v)
            self.send(self.actor_id, Muted.boom, v)
            return st

    @pkg.actor
    class HostEnd:
        HOST = True
        seen: I32

        @pkg.behaviour
        def result(self, st, v: I32):
            return {**st, "seen": st["seen"] + v}

    @pkg.actor
    class Dev:
        out: Ref["HostEnd"]
        MAX_SENDS = 1

        @pkg.behaviour
        def fin(self, st, v: I32):
            self.send(st["out"], HostEnd.result, v)
            return st

    @pkg.actor
    class MisWired:
        out: Ref                     # untyped: build cannot catch it
        MAX_SENDS = 1

        @pkg.behaviour
        def go(self, st, v: I32):
            self.send(st["out"], Sink.put, v)    # Sink left out
            return st

    @pkg.actor
    class ThreeSends:
        out: Ref["Quiet"]

        @pkg.behaviour
        def go(self, st, v: I32):
            self.send(st["out"], Quiet.set, v)
            self.send(st["out"], Quiet.set, v)
            self.send(st["out"], Quiet.set, v)
            return st

    @pkg.actor
    class SKid:
        x: I32

        @pkg.behaviour
        def init(self, st, v: I32):
            return {**st, "x": v}

    @pkg.actor
    class SParent:
        MAX_SENDS = 1
        SPAWNS = {"SKid": 1}

        @pkg.behaviour
        def make(self, st, v: I32):
            self.spawn_sync(SKid.init, v)
            return st

    @pkg.actor
    class NeedsValue:
        """Bodies that need a traced value: both fail the probe."""
        x: I32

        @pkg.behaviour
        def item(self, st, v: I32):
            return {**st, "x": st["x"] + int(v.item())}

        @pkg.behaviour(lint_ignore=("R6",))
        def branch(self, st, v: I32):
            if v > 0:
                return {**st, "x": v}
            return st

    ns = types.SimpleNamespace(**{
        k: v for k, v in locals().items()
        if isinstance(v, pkg.api.ActorTypeMeta)})
    ns.WORLDS = {
        "feeder": (("Feeder", "Sink"), None),
        "masks": (("Masks", "Sink"), None),
        "lonely": (("Feeder", "Sink", "Lonely"), ("Feeder.go",)),
        "half_dead": (("HalfDead", "Sink"), ("HalfDead.used",)),
        "tree": (("Tree",), ("Tree.grow",)),
        "absent": (("Feeder",), None),
        "orphaned": (("Talker", "Orphaned"), ("Talker.go",)),
        "alias": (("Taker", "Aliaser"), None),
        "scribble": (("Scribbler",), None),
        "host_blob": (("HostReader",), None),
        "pingpong": (("Ping", "Pong"), None),
        "careful": (("Careful",), None),
        "fork": (("Fork",), None),
        "leaker": (("Leaker",), None),
        "hoarder": (("Hoarder", "Sink"), None),
        "muted": (("Muted",), None),
        "host_end": (("Dev", "HostEnd"), None),
        "miswired": (("MisWired",), None),
        "needs_value": (("NeedsValue",), None),
        "spawn_sync": (("SParent", "SKid"), None),
        "busy": (("Busy", "Quiet"), None),
    }
    return ns


def define_abi(pkg):
    """The exported C header's program (the JAX package's
    tests/test_c_header_export.py): a sensor feeding a hub with float,
    vector and Iso payloads, and a type with narrow integer arguments."""
    I32, F32, Ref = pkg.I32, pkg.F32, pkg.Ref

    @pkg.actor
    class Sensor:
        hub: Ref["Hub"]
        reading: F32

        @pkg.behaviour
        def sample(self, st, v: F32, seq: I32):
            self.send(st["hub"], Hub.collect, v, when=seq >= 0)
            return {**st, "reading": v}

        @pkg.behaviour
        def rewire(self, st, h: Ref["Hub"]):
            return {**st, "hub": h}

    @pkg.actor
    class Hub:
        total: F32
        MAX_SENDS = 0

        @pkg.behaviour
        def collect(self, st, v: F32):
            return {**st, "total": st["total"] + v}

        @pkg.behaviour
        def calibrate(self, st, coeffs: pkg.VecF32[3], blob: pkg.Iso):
            return st

    @pkg.actor
    class Narrowed:
        x: I32

        @pkg.behaviour
        def put(self, st, a: pkg.I16, b: pkg.U8):
            return st

    return types.SimpleNamespace(Sensor=Sensor, Hub=Hub, Narrowed=Narrowed)

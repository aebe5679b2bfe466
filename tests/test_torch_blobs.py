"""The device blob pool (`blob_slots`, `ctx.blob_*`, the host's
`blob_store`/`blob_fetch`/...) in the port against the JAX package, on the
plain tick: the cases of tests/test_blobs.py that need no mesh, snapshot
or verify pass (the blob chain, `records` and the blob pipeline are in
tests/test_torch_blob_worlds.py). Each world runs on both packages from
the same seeded inputs, and fields, handles, the pool arrays (data, used,
len, gen and the sticky flags), counters, exit code and ticks must be
equal: every compared value is an integer, so the tolerance is exact
equality. A program the packages refuse must be refused by both, with
the same error naming the same knob, and the same stable error code. One
program definition serves both packages (tests/_torch_programs.py); the
port runs on the CPU."""

import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu.hostmem import CapabilityError as JCapErr
from ponyc_tpu.errors import error_code as jax_error_code
from ponyc_tpu_torch import BlobCapacityError, SpawnCapacityError
from ponyc_tpu_torch.errors import error_code
from ponyc_tpu_torch.hostmem import CapabilityError

from _torch_programs import blob_world, define_blobs, new_runtime

JB, TB = define_blobs(ponyc_tpu), define_blobs(ponyc_tpu_torch)
PKGS = ((ponyc_tpu, JB), (ponyc_tpu_torch, TB))
OPTS = dict(mailbox_cap=4, batch=2, max_sends=1, msg_words=2,
            inject_slots=8, blob_slots=16, blob_words=8)


def _both(scenario):
    """Run `scenario(pkg, T) -> value` on both packages; they must agree."""
    j, t = (scenario(pkg, T) for pkg, T in PKGS)
    assert t == j
    return t


def _raises_both(scenario, match, errors=(RuntimeError,)):
    """Both packages raise one of `errors`, of the same class name, with a
    message matching `match`. Returns the two exceptions, the JAX
    package's first."""
    excs = []
    for pkg, T in PKGS:
        with pytest.raises(errors, match=match) as ei:
            scenario(pkg, T)
        excs.append(ei.value)
    assert type(excs[0]).__name__ == type(excs[1]).__name__
    return excs


def _pc(pkg, T, **kw):
    rt = new_runtime(pkg, {**OPTS, **kw})
    rt.declare(T.Producer, 4).declare(T.Consumer, 4).start()
    c = rt.spawn(T.Consumer, total=0, seen=0)
    p = rt.spawn(T.Producer, out=c)
    return rt, p, c


def test_alloc_write_move_read_free_roundtrip():
    def go(pkg, T):
        rt, p, c = _pc(pkg, T)
        rt.send(p, T.Producer.go, 7)
        rt.run(max_steps=10)
        return rt.blobs_in_use, blob_world(rt, T.Producer, T.Consumer)
    used, w = _both(go)
    assert used == 0 and w["counters"]["n_blob_alloc"] == 1
    assert w["fields"]["Consumer"]["total"][0] == 70 + 71 + 72 + 73


def test_slots_recycle_through_free():
    def go(pkg, T):
        rt, p, c = _pc(pkg, T)
        for k in range(8):
            rt.send(p, T.Producer.go, k)
            rt.run(max_steps=6)
        return rt.blobs_in_use, blob_world(rt, T.Producer, T.Consumer)
    used, w = _both(go)
    assert used == 0 and w["counters"]["n_blob_free"] == 8


@pytest.mark.parametrize("kind", ["pool", "budget"])
def test_exhaustion_names_the_right_knob(kind):
    """A leaker through a 2-slot pool blames blob_slots; two allocating
    dispatches in one tick against BLOB_DISPATCHES=1 (16 free slots)
    blame BLOB_DISPATCHES."""
    def go(pkg, T):
        if kind == "pool":
            rt = new_runtime(pkg, {**OPTS, "blob_slots": 2})
            rt.declare(T.Leaker, 4).start()
            a = rt.spawn(T.Leaker, n=0)
            for _ in range(3):
                rt.send(a, T.Leaker.leak)
        else:
            rt = new_runtime(pkg, OPTS)
            rt.declare(T.Hungry, 4).start()
            a = rt.spawn(T.Hungry, n=0)
            rt.send(a, T.Hungry.grab)
            rt.send(a, T.Hungry.grab)
        rt.run(max_steps=10)
    j, t = _raises_both(go, "blob_slots" if kind == "pool"
                        else "BLOB_DISPATCHES",
                        (BlobCapacityError, ponyc_tpu.BlobCapacityError))
    # the stable error code is the JAX package's, not a spawn failure's
    assert error_code(t) == jax_error_code(j) == jax_error_code(
        ponyc_tpu.BlobCapacityError())
    assert error_code(BlobCapacityError()) != error_code(SpawnCapacityError())


def test_host_iso_blob_double_send_raises():
    def go(pkg, T):
        rt = new_runtime(pkg, OPTS)
        rt.declare(T.Consumer, 2).start()
        c = rt.spawn(T.Consumer, total=0, seen=0)
        h = rt.blob_store([5])
        rt.send(c, T.Consumer.take, h)             # a legal move
        for bad in (h, 12345):                     # re-send, forged
            with pytest.raises((CapabilityError, JCapErr),
                               match="aliased move"):
                rt.send(c, T.Consumer.take, bad)
        rt.run(max_steps=6)
        return blob_world(rt, T.Consumer)
    assert _both(go)["fields"]["Consumer"]["seen"][0] == 1


def _bad_program(body_kind):
    """A program each package must refuse when its body is traced."""
    def make(pkg):
        I32, Ref, Blob = pkg.I32, pkg.Ref, pkg.Blob

        @pkg.actor
        class Sink:
            n: I32

            @pkg.behaviour
            def take(self, st, h: Blob):
                return st

        @pkg.actor
        class Bad:
            out: Ref["Sink"]
            MAX_BLOBS = 1
            MAX_SENDS = 1

            @pkg.behaviour
            def go(self, st):
                if body_kind == "two_allocs":
                    self.blob_alloc()
                    self.blob_alloc()
                elif body_kind == "use_after_send":
                    h = self.blob_alloc()
                    self.send(st["out"], Sink.take, h)
                    self.blob_set(h, 0, 1)
                elif body_kind == "use_after_free":
                    h = self.blob_alloc()
                    self.blob_free(h)
                    st = {**st, "out": st["out"] + self.blob_get(h, 0)}
                elif body_kind == "write_frozen":
                    h = self.blob_freeze(self.blob_alloc(length=1))
                    self.blob_set(h, 0, 1)
                elif body_kind == "free_frozen":
                    h = self.blob_freeze(self.blob_alloc(length=1))
                    self.blob_free(h)
                elif body_kind == "val_to_iso":
                    v = self.blob_freeze(self.blob_alloc(length=1))
                    self.send(st["out"], Sink.take, v)
                return st
        return Bad, Sink

    def go(pkg, T):
        bad, sink = make(pkg)
        rt = new_runtime(pkg, OPTS)
        rt.declare(bad, 2).declare(sink, 2).start()
        rt.run(max_steps=1)
    return go


@pytest.mark.parametrize("kind,err,match", [
    ("two_allocs", RuntimeError, "MAX_BLOBS"),
    ("use_after_send", TypeError, "use-after-move"),
    ("use_after_free", TypeError, "use-after-move"),
    ("write_frozen", TypeError, "frozen"),
    ("free_frozen", TypeError, "val"),
    ("val_to_iso", TypeError, "val"),
])
def test_bad_bodies_rejected_at_build(kind, err, match):
    _raises_both(_bad_program(kind), match, (err,))


def test_pool_options_and_host_actors_checked_at_start():
    def no_pool(pkg, T):
        rt = new_runtime(pkg, dict(mailbox_cap=4, batch=2, max_sends=1,
                                   msg_words=2))
        rt.declare(T.Producer, 4).declare(T.Consumer, 4)
        rt.start()
    _raises_both(no_pool, "blob", (TypeError,))

    def host_eater(pkg, T):
        @pkg.actor
        class HostEater:
            HOST = True
            n: pkg.I32

            @pkg.behaviour
            def eat(self, st, h: pkg.Blob):
                return st
        rt = new_runtime(pkg, OPTS)
        rt.declare(HostEater, 2)
        rt.start()
    _raises_both(host_eater, "host", (TypeError,))


def test_host_store_device_reads_and_frees():
    def go(pkg, T):
        rt = new_runtime(pkg, OPTS)
        rt.declare(T.Summer, 4).start()
        a = rt.spawn(T.Summer, total=0)
        h = rt.blob_store([5, 6, 7])
        got = [rt.blobs_in_use, rt.blob_fetch(h).tolist()]
        rt.send(a, T.Summer.add, h)
        rt.run(max_steps=10)
        with pytest.raises(KeyError):
            rt.blob_fetch(h)                   # freed on the device
        return got, blob_world(rt, T.Summer)
    got, w = _both(go)
    assert got == [1, [5, 6, 7]] and w["fields"]["Summer"]["total"][0] == 18


def test_blob_send_coexists_with_host_heap():
    def go(pkg, T):
        rt = new_runtime(pkg, OPTS)
        rt.declare(T.Summer, 4).start()
        a = rt.spawn(T.Summer, total=0)
        rt.heap.box([1, 2, 3])                 # materialise the heap
        h = rt.blob_store([41, 1])             # slot 0: not a heap handle
        rt.send(a, T.Summer.add, h)
        rt.run(max_steps=8)
        return blob_world(rt, T.Summer)
    assert _both(go)["fields"]["Summer"]["total"][0] == 42


def test_generic_actor_keeps_max_blobs():
    def go(pkg, T):
        tp = pkg.TypeParam("T")

        @pkg.actor
        class Box_:
            n: pkg.I32
            MAX_BLOBS = 1

            @pkg.behaviour
            def put(self, st, v: tp):
                h = self.blob_alloc(length=1)
                self.blob_set(h, 0, 1)
                self.blob_free(h)
                return st
        box_i = Box_[pkg.I32]
        rt = new_runtime(pkg, OPTS)
        rt.declare(box_i, 2).start()
        rt.send(rt.spawn(box_i, n=0), box_i.put, 5)
        rt.run(max_steps=6)
        return box_i.MAX_BLOBS, blob_world(rt)
    mb, w = _both(go)
    assert mb == 1 and w["counters"]["n_blob_free"] == 1


def test_host_free_rejects_double_free_and_bad_length():
    def go(pkg, T):
        rt = new_runtime(pkg, OPTS)
        rt.declare(T.Consumer, 2).start()
        h = rt.blob_store([1, 2])
        rt.blob_free_host(h)
        with pytest.raises(KeyError):
            rt.blob_free_host(h)
        with pytest.raises(ValueError):
            rt.blob_store([1], length=100)
        return blob_world(rt)
    _both(go)


@pytest.mark.parametrize("recycled", [False, True])
def test_stale_handle_reads_zero(recycled):
    """A handle freed before its message dispatches reads 0, not the
    words left in the slot; with a one-slot pool whose slot is handed out
    again, the generation mismatch reads 0 and the host rejects it."""
    def go(pkg, T):
        rt = new_runtime(pkg, {**OPTS, "blob_slots": 1 if recycled else 16})
        rt.declare(T.Reader, 2).start()
        a = rt.spawn(T.Reader, got=0)
        h_old = rt.blob_store([111])
        rt.send(a, T.Reader.probe, h_old)
        rt.blob_free_host(h_old)
        extra = []
        if recycled:
            h_new = rt.blob_store([222])
            extra = [h_old, h_new]
        rt.run(max_steps=6)
        if recycled:
            with pytest.raises(KeyError, match="STALE"):
                rt.blob_fetch(h_old)
            extra.append(rt.blob_fetch(h_new).tolist())
        return extra, blob_world(rt, T.Reader)
    extra, w = _both(go)
    assert w["fields"]["Reader"]["got"][0] == 0
    if recycled:
        assert extra[0] != extra[1] and extra[2] == [222]


def test_gc_sweeps_dead_actor_field_blobs():
    def go(pkg, T):
        rt = new_runtime(pkg, OPTS)
        rt.declare(T.Holder, 4).start()
        a = rt.spawn(T.Holder)
        b = rt.spawn(T.Holder)
        rt.send(a, T.Holder.keep)
        rt.send(b, T.Holder.keep)
        rt.run(max_steps=6)
        got = [rt.blobs_in_use, rt.gc(), rt.blobs_in_use]
        rt.release(b)
        got += [rt.gc(), rt.blobs_in_use]
        return got, blob_world(rt, T.Holder)
    got, w = _both(go)
    assert got == [2, 0, 2, 1, 1] and w["counters"]["n_blob_free"] == 1


def test_blob_dispatches_bounds_reservation_footprint():
    def go(pkg, T):
        rt = new_runtime(pkg, {**OPTS, "blob_slots": 4})
        rt.declare(T.Lean, 4).start()
        ids = [rt.spawn(T.Lean) for _ in range(4)]
        for i, a in enumerate(ids):
            rt.send(a, T.Lean.fill, i)
        rt.run(max_steps=8)
        return sorted(int(rt.blob_fetch(int(rt.state_of(a)["stash"]))[0])
                      for a in ids), blob_world(rt, T.Lean)
    assert _both(go)[0] == [0, 1, 2, 3]


def test_gc_keeps_host_held_and_inflight_blobs():
    def go(pkg, T):
        rt = new_runtime(pkg, OPTS)
        rt.declare(T.Consumer, 2).start()
        c = rt.spawn(T.Consumer, total=0, seen=0)
        h_held = rt.blob_store([1])
        h_sent = rt.blob_store([2, 3, 4, 5])
        rt.send(c, T.Consumer.take, h_sent)    # in flight (inject queue)
        rt.gc()
        got = [rt.blobs_in_use]
        rt.run(max_steps=8)
        got.append(rt.blobs_in_use)
        rt.blob_free_host(h_held)
        got.append(rt.blobs_in_use)
        return got, blob_world(rt, T.Consumer)
    assert _both(go)[0] == [2, 1, 0]


def test_freeze_shares_one_payload_with_many_readers():
    def go(pkg, T):
        rt = new_runtime(pkg, OPTS)
        rt.declare(T.Caster, 2).declare(T.ValReader, 4).start()
        r1 = rt.spawn(T.ValReader, got=0)
        r2 = rt.spawn(T.ValReader, got=0)
        c = rt.spawn(T.Caster, a=r1, b=r2)
        rt.send(c, T.Caster.cast, 7)
        rt.run(max_steps=10)
        got = [rt.blobs_in_use]
        rt.gc()
        got.append(rt.blobs_in_use)
        return got, blob_world(rt, T.Caster, T.ValReader)
    got, w = _both(go)
    assert got == [1, 0] and w["fields"]["ValReader"]["got"][:2] == [21, 21]


def test_string_payload_roundtrip():
    def go(pkg, T):
        rt = new_runtime(pkg, OPTS)
        rt.declare(T.Fwd, 2).declare(T.Keeper, 2).start()
        k = rt.spawn(T.Keeper, held=-1)
        f = rt.spawn(T.Fwd, sink=k)
        h = rt.blob_store_str("héllo, pony→tpu")
        rt.send(f, T.Fwd.fwd, h)
        rt.run(max_steps=8)
        h2 = int(rt.state_of(k)["held"])
        return h2 == h, rt.blob_fetch_str(h2), blob_world(rt, T.Keeper)
    same, text, _ = _both(go)
    assert same and text == "héllo, pony→tpu"

"""Durable worlds in the PyTorch port: the checkpoint ring, corruption
detection, geometry-changing restore, the supervisor under fault
injection and the CLI's snapshot verbs — tests/test_durability.py's
cases, case for case, on the port (serialise.py, supervise.py,
testing.py, the run loop's Checkpointer).

Where a case runs a world it runs on the port's three paths on the CPU
(the `path` fixture of test_torch_host.py: the plain tick,
`pallas_fused=True`, and `delivery="pallas_mega"` with every window also
run as the host C++ build of csrc/mega_window.cu); the supervisor's and
the chaos harness's cases are host-side and run on the plain path. The
mesh crossing restores onto two shards in one process. The timed acceptance cases keep their
assertions; their watchdog deadline is 2 s, not the reference's 0.6 s,
so that a loaded test machine's slow window is not taken for the wedge. Subprocess children import ponyc_tpu_torch and run
with device="cpu". The worlds are integer, so comparisons are exact.
"""

import functools
import json
import os
import sys
import time

import numpy as np
import pytest

import ponyc_tpu_torch
from ponyc_tpu_torch import (I32, Ref, Runtime, RuntimeOptions, actor,
                             behaviour, serialise, supervise, testing)
from ponyc_tpu_torch.errors import ERROR_CODES, PonyError

import test_differential as td
from _torch_programs import build_fifo, build_walkers, new_runtime
from test_torch_host import PATH_KW, TT, _runtime, path  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(mailbox_cap=8, batch=1, max_sends=1, msg_words=1,
            spill_cap=64, inject_slots=8)


def _opts(**kw):
    return RuntimeOptions(tuning_cache="off", **{**BASE, **kw})


def _ring(n, path="plain", cap=None, **kw):
    """define(pkg)'s RingNode ring of `n` wired actors (declared `cap`)."""
    rt = _runtime(ponyc_tpu_torch, path, {**BASE, **kw})
    rt.declare(TT.RingNode, cap or n).start()
    ids = rt.spawn_many(TT.RingNode, n)
    rt.set_fields(TT.RingNode, ids, next_ref=np.roll(ids, -1))
    return rt, ids


def _passes(rt):
    return np.asarray(rt.cohort_state(TT.RingNode)["passes"])


# ======================================================= checkpoint ring

@functools.lru_cache(maxsize=None)
def _ring_unarmed(hops):
    """The ring's run with checkpointing off, on the plain tick, once for
    every path (the paths' worlds are equal, which the slice tests hold):
    (passes, ticks run)."""
    rt_off, ids_off = _ring(16)
    rt_off.send(int(ids_off[0]), TT.RingNode.token, hops)
    assert rt_off.run() == 0
    return _passes(rt_off), rt_off.steps_run


def test_periodic_checkpoint_ring_bounded_and_restorable(tmp_path, path):
    """The run loop writes cadence checkpoints without changing the run's
    outcome; the ring stays bounded by checkpoint_keep; the newest
    restores into a fresh runtime with the exact final world."""
    hops = 400
    want, steps_off = _ring_unarmed(hops)      # checkpointing off

    prefix = str(tmp_path / "ring")
    kw = dict(checkpoint_every_s=0.005, checkpoint_path=prefix,
              checkpoint_keep=3, quiesce_interval=16)
    rt, ids = _ring(16, path, **kw)
    rt.send(int(ids[0]), TT.RingNode.token, hops)
    assert rt.run() == 0
    stats = rt.checkpoint_stats()
    assert stats["checkpoints"] >= 2          # the cadence fired mid-run
    assert stats["failures"] == 0
    # capture only reads the world: the outcome equals the unarmed run
    np.testing.assert_array_equal(_passes(rt), want)
    assert rt.steps_run == steps_off
    rt.stop()                                  # + the final checkpoint
    files = serialise.list_checkpoints(prefix)
    assert files and len(files) <= 3           # the ring rotated
    seqs = [s for s, _ in files]
    assert seqs == sorted(seqs)
    newest = serialise.newest_intact(prefix)
    assert newest == files[-1][1]

    rt2, _ = _ring(16, path, **kw)
    serialise.restore(rt2, newest)
    np.testing.assert_array_equal(_passes(rt2), want)
    assert rt2.steps_run == rt.steps_run
    rt2.stop()


def test_forced_checkpoint_waits_for_a_busy_writer(tmp_path, monkeypatch):
    """A forced checkpoint (stop()'s final one, rt.checkpoint()) that
    meets a writer still busy with a large world and a full queue waits
    for the writer and lands: no deadlock between the waiting capture and
    the writer recording its write (the JAX package's Checkpointer waits
    holding the lock the writer needs)."""
    import threading
    real = serialise.write_snapshot
    slow = threading.Event()

    def slow_write(*a, **k):
        slow.wait(0.3)
        return real(*a, **k)

    monkeypatch.setattr(serialise, "write_snapshot", slow_write)
    prefix = str(tmp_path / "busy")
    rt, ids = _ring(8, checkpoint_every_s=60.0, checkpoint_path=prefix,
                    checkpoint_keep=5)
    rt.send(int(ids[0]), TT.RingNode.token, 40)
    rt.run()
    done = threading.Event()

    def forced():
        for _ in range(3):           # the writer busy, then the queue full
            rt.checkpoint()
        rt.stop()
        done.set()

    th = threading.Thread(target=forced, daemon=True)
    th.start()
    assert done.wait(20), "a forced checkpoint deadlocked with the writer"
    files = serialise.list_checkpoints(prefix)
    assert [s for s, _ in files] == [0, 1, 2, 3]
    for _seq, f in files:
        serialise.verify_snapshot(f)


def test_cadence_skips_without_capturing_while_the_writer_is_busy(
        tmp_path, monkeypatch):
    """With the writer busy and one snapshot queued, a due cadence
    checkpoint is skipped (counted in `skipped`) without copying the
    world; the ring still gets the queued one."""
    import threading
    real_write, real_capture = serialise.write_snapshot, serialise.capture
    gate = threading.Event()
    captures = []

    def slow_write(*a, **k):
        gate.wait(10)
        return real_write(*a, **k)

    def counted(rt_):
        captures.append(1)
        return real_capture(rt_)

    monkeypatch.setattr(serialise, "write_snapshot", slow_write)
    monkeypatch.setattr(serialise, "capture", counted)
    prefix = str(tmp_path / "skip")
    rt, _ids = _ring(8, checkpoint_every_s=60.0, checkpoint_path=prefix)
    ck = rt._ckpt
    assert ck.checkpoint(rt) == 0            # the writer takes it
    deadline = time.monotonic() + 5
    while not ck._q.empty() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ck.checkpoint(rt) == 1            # queued behind it
    assert ck.checkpoint(rt) is None         # full: skipped
    assert len(captures) == 2
    assert ck.stats()["skipped"] == 1
    gate.set()
    rt.stop()
    assert [s for s, _ in serialise.list_checkpoints(prefix)] == [0, 1, 2]


def test_due_is_false_while_the_writer_queue_is_full(tmp_path,
                                                    monkeypatch):
    """A cadence that comes round while the writer is busy and one
    snapshot waits for it is skipped in `due()`, before the run loop
    gives up its next speculative window for it: counted once, nothing
    captured, the cadence started again; once the writer has caught up
    the next due cadence captures."""
    import threading
    real_write, real_capture = serialise.write_snapshot, serialise.capture
    gate = threading.Event()
    captures = []

    def slow_write(*a, **k):
        gate.wait(10)
        return real_write(*a, **k)

    def counted(rt_):
        captures.append(1)
        return real_capture(rt_)

    monkeypatch.setattr(serialise, "write_snapshot", slow_write)
    monkeypatch.setattr(serialise, "capture", counted)
    rt, _ids = _ring(8, checkpoint_every_s=60.0,
                     checkpoint_path=str(tmp_path / "due"))
    ck = rt._ckpt
    assert not ck.due()                      # the cadence has not come
    assert ck.checkpoint(rt) == 0            # the writer takes it
    deadline = time.monotonic() + 5
    while not ck._q.empty() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ck.checkpoint(rt) == 1            # queued behind it
    ck._last_t -= 61.0                       # the cadence comes round
    assert not ck.due()                      # ... at a full queue
    assert not ck.tick(rt, in_flight=False)
    assert ck.stats()["skipped"] == 1        # counted once
    assert len(captures) == 2
    gate.set()
    ck.flush()
    ck._last_t -= 61.0
    assert ck.due()
    assert ck.tick(rt, in_flight=False)
    assert len(captures) == 3
    rt.stop()


@actor
class _InPlaceReporter:
    HOST = True
    n: I32

    @behaviour
    def report(self, st, v: I32):
        st["n"] = st["n"] + v          # changes its state in place


@actor
class _InPlaceNode:
    nxt: Ref["_InPlaceNode"]
    rep: Ref["_InPlaceReporter"]
    passes: I32

    MAX_SENDS = 2

    @behaviour
    def token(self, st, hops: I32):
        self.send(st["nxt"], _InPlaceNode.token, hops - 1, when=hops > 1)
        self.send(st["rep"], _InPlaceReporter.report, 1,
                  when=(hops % 64) == 0)
        self.exit(0, when=hops <= 1)
        return {**st, "passes": st["passes"] + 1}


def _inplace_build(path="plain", **kw):
    rt = Runtime(RuntimeOptions(
        mailbox_cap=8, batch=1, max_sends=2, msg_words=1, spill_cap=64,
        inject_slots=8, quiesce_interval=64, tuning_cache="off",
        **PATH_KW[path], **kw), device="cpu")
    rt.declare(_InPlaceNode, 16).declare(_InPlaceReporter, 3)
    rt.start()
    return rt


def _inplace_seed(rt, hops):
    ids = rt.spawn_many(_InPlaceNode, 16)
    rep = rt.spawn(_InPlaceReporter)
    rt.set_fields(_InPlaceNode, ids, nxt=np.roll(ids, -1), rep=rep)
    rt.send(int(ids[0]), _InPlaceNode.token, hops)


def _inplace_result(rt):
    return ([int(x) for x in rt.cohort_state(_InPlaceNode)["passes"]],
            sum(int(st.get("n", 0)) for st in rt._host_state.values()),
            rt.steps_run)


@functools.lru_cache(maxsize=None)
def _inplace_uninterrupted(hops):
    """The in-place world's run without a snapshot, on the plain tick,
    once for every path (the paths' worlds are equal)."""
    base = _inplace_build()
    _inplace_seed(base, hops)
    assert base.run() == 0
    return _inplace_result(base)


def test_queued_snapshot_owns_its_host_state(tmp_path, path, monkeypatch):
    """A snapshot waiting for a busy writer holds the host side of its
    capture, not what the run did meanwhile: a host behaviour that
    changes its state in place and a spawn that takes a free slot after
    the capture do not reach the file. Restored and run to the end it
    equals the uninterrupted run."""
    import copy
    import threading
    hops, cut = 600, 250
    result = _inplace_result
    want = _inplace_uninterrupted(hops)
    assert want[1] == hops // 64

    gate = threading.Event()
    real = serialise.write_snapshot

    def slow_write(*a, **k):
        gate.wait(10)
        return real(*a, **k)

    monkeypatch.setattr(serialise, "write_snapshot", slow_write)
    rt = _inplace_build(path, checkpoint_every_s=60.0,
                        checkpoint_path=str(tmp_path / "own"))
    _inplace_seed(rt, hops)
    rt.run(max_steps=cut)
    reported = result(rt)[1]
    free = copy.deepcopy(rt._free["_InPlaceReporter"])
    snap = rt.checkpoint()                   # queued behind the gate
    rt.spawn(_InPlaceReporter)               # takes a free slot in place
    assert rt.run() == 0                     # reports change st in place
    assert result(rt)[1] == want[1] > reported
    gate.set()
    rt.stop()

    rt2 = _inplace_build(path)
    serialise.restore(rt2, snap)
    assert rt2._free["_InPlaceReporter"] == free
    assert sum(int(st.get("n", 0))
               for st in rt2._host_state.values()) == reported
    assert rt2.run() == 0
    assert result(rt2) == want


def test_checkpoint_options_keep_kernel_identity():
    """The durability layer is host-side: with checkpointing configured
    the window kernel's and the fused kernel's generated sources (what
    nvcc compiles) are identical to the default build's."""
    from ponyc_tpu_torch.program import Program
    from ponyc_tpu_torch.runtime import engine

    def sources(**kw):
        out = []
        for pk in (dict(delivery="pallas_mega"), dict(pallas_fused=True)):
            opts = _opts(**pk, **kw)
            prog = Program(opts)
            prog.declare(TT.RingNode, 8)
            prog.finalize()
            w = engine.build_multi_step_gated(prog, opts)
            if hasattr(w, "source"):
                out.append(w.source("cuda"))
            out += [fd.source("cuda") for fd in w.fused]
        return out

    baseline = sources()
    assert len(baseline) == 2
    assert sources(checkpoint_every_s=0.5, checkpoint_path="/tmp/x",
                   checkpoint_keep=7) == baseline


def test_checkpoint_option_validation():
    with pytest.raises(ValueError, match="checkpoint_every_s"):
        RuntimeOptions(checkpoint_every_s=0.0)
    with pytest.raises(ValueError, match="checkpoint_keep"):
        RuntimeOptions(checkpoint_keep=0)


# =============================================== corruption detection

def test_corruption_detected_and_fallen_back_past(tmp_path):
    """Truncation and bit flips surface as the coded SnapshotCorruptError
    (code 8), never a raw numpy/zlib traceback; newest_intact() walks the
    ring past them."""
    path_ = str(tmp_path / "w.npz")
    rt, ids = _ring(8)
    rt.send(int(ids[0]), TT.RingNode.token, 50)
    rt.run()
    serialise.save(rt, path_)
    serialise.verify_snapshot(path_)           # intact baseline

    rt2, _ = _ring(8)
    for mode in ("truncate", "bitflip"):
        dmg = str(tmp_path / f"{mode}.npz")
        serialise.save(rt, dmg)
        testing.corrupt_snapshot(dmg, mode)
        with pytest.raises(serialise.SnapshotCorruptError):
            serialise.restore(rt2, dmg)
        assert serialise.SnapshotCorruptError.code \
            == ERROR_CODES["SnapshotCorruptError"] == 8

    prefix = str(tmp_path / "r")
    for seq in range(3):
        serialise.save(rt, serialise.checkpoint_file(prefix, seq))
    files = serialise.list_checkpoints(prefix)
    assert [s for s, _ in files] == [0, 1, 2]
    testing.corrupt_snapshot(files[-1][1], "truncate")
    assert serialise.newest_intact(prefix) == files[1][1]
    testing.corrupt_snapshot(files[1][1], "bitflip")
    assert serialise.newest_intact(prefix) == files[0][1]
    testing.corrupt_snapshot(files[0][1], "truncate")
    assert serialise.newest_intact(prefix) is None
    serialise.restore(rt2, path_)              # the intact one still does


# ================================================== format version gate

def test_unknown_future_format_is_loud(tmp_path):
    p = str(tmp_path / "future.npz")
    serialise.write_snapshot({"format": 99}, {}, p)
    with pytest.raises(serialise.SnapshotFormatError):
        serialise.verify_snapshot(p)
    assert serialise.SnapshotFormatError.code == 9
    assert issubclass(serialise.SnapshotFormatError,
                      serialise.FingerprintMismatch)


def test_v2_snapshot_still_restores_same_geometry(tmp_path):
    """A v2 snapshot (index-named leaves, the geometry-full fingerprint,
    no checksums) written by the JAX package's own v2 writer restores in
    the port into the same geometry and finishes as the JAX run does; a
    geometry change on it stays a loud mismatch."""
    import ponyc_tpu
    from test_durability import _save_legacy_v2
    from test_torch_host import TJ
    p = str(tmp_path / "v2.npz")
    rj = new_runtime(ponyc_tpu, BASE)
    rj.declare(TJ.RingNode, 8).start()
    ids = rj.spawn_many(TJ.RingNode, 8)
    rj.set_fields(TJ.RingNode, ids, next_ref=np.roll(ids, -1))
    rj.send(int(ids[0]), TJ.RingNode.token, 120)
    rj.run(max_steps=37)
    _save_legacy_v2(rj, p)
    rj.run()
    want = np.asarray(rj.cohort_state(TJ.RingNode)["passes"])

    rt2, _ = _ring(8)
    serialise.restore(rt2, p)
    assert rt2.steps_run == 37
    rt2.run()
    np.testing.assert_array_equal(_passes(rt2), want)
    assert rt2.steps_run == rj.steps_run

    rt3, _ = _ring(8, mailbox_cap=16)
    with pytest.raises(serialise.FingerprintMismatch):
        serialise.restore(rt3, p)


def test_v3_restore_keeps_telemetry(tmp_path):
    p = str(tmp_path / "t.npz")
    rt, ids = _ring(8, analysis=1, analysis_path=str(tmp_path / "a.csv"))
    rt.send(int(ids[0]), TT.RingNode.token, 300)
    rt.run()
    rt._error_counts[("PonyError", 1)] += 2
    prof = rt.profile()
    serialise.save(rt, p)
    rt.stop()

    rt2, _ = _ring(8, analysis=1, analysis_path=str(tmp_path / "b.csv"))
    serialise.restore(rt2, p)
    prof2 = rt2.profile()
    assert prof2["behaviours"] == prof["behaviours"]
    assert prof2["totals"] == prof["totals"]
    assert rt2._error_counts[("PonyError", 1)] == 2
    rt2.stop()


def test_packed_snapshot_cross_dtype_restore(tmp_path):
    """save(packed=True) stores the word tables as int16 lanes + an int32
    escape plane (ops/megakernel.py's codec); a mid-flight world whose
    payloads do not fit int16 restores bit-identically to the plain
    snapshot of the same instant, and a packed snapshot missing its
    escape plane is a coded corruption."""
    from ponyc_tpu_torch.models import ubench
    okw = dict(mailbox_cap=4, batch=2, max_sends=1, spill_cap=64,
               inject_slots=8)

    def build():
        return ubench.build(8, _opts(**okw), pings=2, device="cpu")

    rt, ids = build()
    ubench.seed_all(rt, ids, hops=70_000, pings=2)
    rt.run(max_steps=6)
    p_packed, p_plain = str(tmp_path / "packed.npz"), str(
        tmp_path / "plain.npz")
    serialise.save(rt, p_packed, packed=True)
    serialise.save(rt, p_plain)

    with np.load(p_packed, allow_pickle=False) as z:
        lo = [n for n in z.files if n.endswith(".lo16")]
        assert lo, "packed snapshot stored no narrow planes"
        assert all(z[n].dtype == np.int16 for n in lo)
        esc = [n[:-len(".lo16")] + ".esc32" for n in lo]
        assert all(n in z.files and z[n].dtype == np.int32 for n in esc)
        assert any(np.any(np.asarray(z[n]) != 0) for n in esc)

    restored = {}
    for p in (p_packed, p_plain):
        rt2, _ = build()
        serialise.restore(rt2, p)
        restored[p] = {k: v.numpy() for k, v in
                       serialise._named_state_arrays(rt2.state).items()}
    for k, v in restored[p_plain].items():
        np.testing.assert_array_equal(restored[p_packed][k], v, err_msg=k)

    header, arrays = serialise.capture(rt)
    packed = serialise.pack_snapshot_arrays(arrays)
    victim = next(n for n in packed if n.endswith(".esc32"))
    del packed[victim]
    p_torn = str(tmp_path / "torn.npz")
    serialise.write_snapshot(header, packed, p_torn)
    rt3, _ = build()
    with pytest.raises(serialise.SnapshotCorruptError):
        serialise.restore(rt3, p_torn)


# ============================================= geometry-changing restore

def test_grown_capacity_restore_spawns_into_new_room(tmp_path, path):
    p = str(tmp_path / "w.npz")
    rt, ids = _ring(8, path)
    rt.send(int(ids[0]), TT.RingNode.token, 100)
    rt.run(max_steps=17)
    serialise.save(rt, p)

    rt2 = _runtime(ponyc_tpu_torch, path, BASE)
    rt2.declare(TT.RingNode, 16).start()
    serialise.restore(rt2, p)
    fresh = rt2.spawn_many(TT.RingNode, 8)       # the grown room
    assert len(fresh) == 8
    rt2.run()
    passes = _passes(rt2)
    assert passes[:8].sum() == 100 and passes[8:].sum() == 0


def test_shrunk_capacity_live_rejects_dead_tail_accepts(tmp_path):
    live8 = str(tmp_path / "live8.npz")
    rt, _ids = _ring(8)                           # 8 live actors
    serialise.save(rt, live8)
    dead_tail = str(tmp_path / "dead_tail.npz")
    rt_b, ids = _ring(4, cap=16)                  # slots 4..15 never live
    rt_b.send(int(ids[0]), TT.RingNode.token, 60)
    rt_b.run(max_steps=11)
    serialise.save(rt_b, dead_tail)

    rt2, _ = _ring(4)
    with pytest.raises(serialise.SnapshotGeometryError):
        serialise.restore(rt2, live8)
    assert serialise.SnapshotGeometryError.code == 10
    serialise.restore(rt2, dead_tail)
    rt2.run()
    assert _passes(rt2).sum() == 60


def test_mailbox_too_deep_for_new_ring_rejected(tmp_path):
    p = str(tmp_path / "w.npz")
    rt, ids = _ring(8)
    for _ in range(4):                 # occupancy 4 on one mailbox
        rt.bulk_send(ids[:1], TT.RingNode.token, np.asarray([0]))
    serialise.save(rt, p)
    rt2, _ = _ring(8, mailbox_cap=2)
    with pytest.raises(serialise.SnapshotGeometryError, match="mailbox"):
        serialise.restore(rt2, p)
    rt3, _ = _ring(8, mailbox_cap=4)   # exactly fits
    with pytest.raises(ValueError, match="different geometry"):
        serialise.restore(rt3, p, opts=_opts())
    serialise.restore(rt3, p, opts=_opts(mailbox_cap=4))


def test_blob_pool_relayout(tmp_path):
    """Host-owned blobs cross a blob_slots change: handles re-encode,
    contents and ownership survive; live blobs into a pool-less target
    reject."""
    p = str(tmp_path / "w.npz")
    rt, _ids = _ring(8, blob_slots=8, blob_words=4)
    rt.blob_store([1, 2, 3])
    rt.blob_store_str("hi")
    serialise.save(rt, p)

    rt2, _ = _ring(8, blob_slots=16, blob_words=8)
    serialise.restore(rt2, p)
    assert len(rt2._host_blobs) == 2
    fetched = {tuple(rt2.blob_fetch(h).tolist()) for h in rt2._host_blobs}
    assert (1, 2, 3) in fetched
    hs = [h for h in rt2._host_blobs
          if tuple(rt2.blob_fetch(h).tolist()) != (1, 2, 3)]
    assert rt2.blob_fetch_str(hs[0]) == "hi"
    assert rt2.blobs_in_use == 2

    rt3, _ = _ring(8)                              # blob_slots=0
    with pytest.raises(serialise.SnapshotGeometryError, match="blob"):
        serialise.restore(rt3, p)


def _mid_pressure_snapshot(tmp_path, path="plain"):
    """The Walker/Splitter deadlock seed run into live backpressure mutes,
    snapshotted. Returns (path, oracle, n_w, n_s)."""
    n_w, n_s = 24, 8
    w_nxt, s_w, s_s, seeds = td._case(23, n_w, n_s)
    want = td.oracle(n_w, n_s, w_nxt, s_w, s_s, seeds)
    rt = build_walkers(ponyc_tpu_torch, TT, 23, mailbox_cap=2, batch=1,
                       msg_words=1, max_sends=2, spill_cap=512,
                       inject_slots=16, **PATH_KW[path])
    rt.run(max_steps=8)
    assert np.asarray(rt.state.muted).any(), "snapshot must land mid-pressure"
    p = str(tmp_path / "midp.npz")
    serialise.save(rt, p)
    return p, want, n_w, n_s


def test_differential_corpus_crosses_grown_restore(tmp_path, path):
    """The differential corpus crossing a snapshot/restore boundary
    mid-workload into a grown geometry: the fields and quiescence equal
    the sequential oracle."""
    p, want, n_w, n_s = _mid_pressure_snapshot(tmp_path, path)
    rt2 = _runtime(ponyc_tpu_torch, path, dict(
        msg_words=1, mailbox_cap=4, batch=1, max_sends=2, spill_cap=256,
        inject_slots=16))
    rt2.declare(TT.Walker, n_w + 16).declare(TT.Splitter, n_s + 8).start()
    serialise.restore(rt2, p)
    assert rt2.run(max_steps=50_000) == 0
    wst = rt2.cohort_state(TT.Walker)
    sst = rt2.cohort_state(TT.Splitter)
    assert (wst["acc"][:n_w].astype(np.int64) == want[0]).all()
    assert (wst["hits"][:n_w].astype(np.int64) == want[1]).all()
    assert (sst["acc"][:n_s].astype(np.int64) == want[2]).all()
    assert not np.asarray(rt2.state.muted).any()


def test_differential_corpus_crosses_mesh_restore(tmp_path):
    """The same mid-pressure world restored onto a 2-shard mesh (its
    spills re-laid out shard by shard, the routing and the collectives
    under it) and finished: the fields equal the sequential oracle."""
    p, want, n_w, n_s = _mid_pressure_snapshot(tmp_path)
    rt2 = Runtime(_opts(msg_words=1, mailbox_cap=4, batch=1, max_sends=2,
                        spill_cap=1024, inject_slots=32, mesh_shards=2,
                        quiesce_interval=2), device="cpu")
    rt2.declare(TT.Walker, n_w).declare(TT.Splitter, n_s).start()
    serialise.restore(rt2, p)
    assert rt2.program.shards == 2
    assert rt2.run(max_steps=50_000) == 0
    wst = rt2.cohort_state(TT.Walker)
    sst = rt2.cohort_state(TT.Splitter)
    assert (wst["acc"][:n_w].astype(np.int64) == want[0]).all()
    assert (wst["hits"][:n_w].astype(np.int64) == want[1]).all()
    assert (sst["acc"][:n_s].astype(np.int64) == want[2]).all()
    assert not np.asarray(rt2.state.muted).any()


def test_per_edge_fifo_crosses_restore_boundary(tmp_path, path):
    """Order-sensitive crossing: the per-edge FIFO detector runs a
    tiny-cap world into mid-stream spill pressure, snapshots, restores
    into a grown geometry and finishes with zero violations."""
    from _torch_programs import IN_SLOTS
    n_cons, items = 4, 40
    rt = build_fifo(ponyc_tpu_torch, TT, 101, n_cons=n_cons, items=items,
                    mailbox_cap=2, batch=1, max_sends=3, spill_cap=2048,
                    inject_slots=16, **PATH_KW[path])
    n_prod = rt.program.by_type[TT.Prod].capacity
    rt.run(max_steps=40)                      # mid-stream
    assert (np.asarray(rt.state.tail) - np.asarray(rt.state.head)).any()
    p = str(tmp_path / "fifo.npz")
    serialise.save(rt, p)

    rt2 = _runtime(ponyc_tpu_torch, path, dict(
        msg_words=2, mailbox_cap=8, batch=2, max_sends=3, spill_cap=512,
        inject_slots=32))
    rt2.declare(TT.Prod, n_prod + 4).declare(TT.Cons, n_cons + 2).start()
    serialise.restore(rt2, p)
    assert rt2.run(max_steps=500_000) == 0
    st = rt2.cohort_state(TT.Cons)
    bad = st["bad"][:n_cons]
    assert not bad.any(), f"FIFO violations after restore: {bad}"
    for s in range(IN_SLOTS):
        assert (np.asarray(st[f"last{s}"][:n_cons]) == items - 1).all()
    assert (np.asarray(st["got"][:n_cons]) == IN_SLOTS * items).all()
    pst = rt2.cohort_state(TT.Prod)
    assert (np.asarray(pst["seq"][:n_prod]) == items).all()


# ======================================================= the supervisor

def test_supervisor_inprocess_recovers_coded_fatal(tmp_path):
    """A chaos-injected coded fatal mid-run: the supervisor restores the
    newest intact checkpoint into a fresh runtime and the workload
    completes with the unfaulted outcome."""
    prefix = str(tmp_path / "sup")
    attempt = {"n": 0}
    kw = dict(checkpoint_every_s=60.0, checkpoint_path=prefix,
              quiesce_interval=8)

    def build():
        attempt["n"] += 1
        rt, ids = _ring(8, **kw)
        build.ids = ids
        if attempt["n"] == 1:
            testing.fatal_at_boundary(rt, boundary=3, code=42)
        return rt

    def seed(rt):
        rt.send(int(build.ids[0]), TT.RingNode.token, 400)
        rt.checkpoint()                 # the recovery floor

    sup = supervise.Supervisor(build, prefix=prefix, seed=seed,
                               retries=3, backoff_s=0.01)
    assert sup.run() == 0
    assert sup.restarts == 1
    assert sup.failures[0]["code"] == 42
    assert sup.restored_from is not None
    # a clean 400-hop walk over 8 nodes lands exactly 50 passes a node;
    # read the recovered terminal world back from its final checkpoint
    rt_chk, _ = _ring(8, **kw)
    serialise.restore(rt_chk, serialise.newest_intact(prefix))
    np.testing.assert_array_equal(_passes(rt_chk), np.full(8, 50, np.int32))
    rt_chk.stop()


def test_supervisor_refuses_deterministic_poison(tmp_path):
    prefix = str(tmp_path / "poison")

    def build():
        rt, ids = _ring(8, quiesce_interval=4, pipeline=False)
        build.ids = ids
        testing.fatal_at_boundary(rt, boundary=1, code=13, every=True)
        return rt

    def seed(rt):
        rt.send(int(build.ids[0]), TT.RingNode.token, 400)

    sup = supervise.Supervisor(build, prefix=prefix, seed=seed,
                               retries=10, backoff_s=0.0)
    with pytest.raises(supervise.PoisonError) as ei:
        sup.run()
    assert ei.value.code == ERROR_CODES["PoisonError"] == 11
    assert len(sup.failures) == 2              # refused on the repeat
    assert sup.failures[0]["code"] == 13


def test_supervisor_noncoded_errors_are_not_swallowed(tmp_path):
    def build():
        _ring(8)
        raise RuntimeError("build() exploded")

    sup = supervise.Supervisor(build, prefix=str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match=r"build\(\) exploded"):
        sup.run()
    with pytest.raises(ValueError):
        supervise.Supervisor(prefix="x")       # neither build nor argv


# ------------------------- subprocess acceptance (kill -> restore -> =)

ACCEPT_SCRIPT = """
import json, os, sys
sys.path.insert(0, {root!r})
import numpy as np
from ponyc_tpu_torch import I32, Ref, Runtime, RuntimeOptions, actor, behaviour
from ponyc_tpu_torch import supervise, testing
from ponyc_tpu_torch.errors import error_code

@actor
class Reporter:
    HOST = True
    n: I32

    @behaviour
    def report(self, st, v: I32):
        return {{**st, "n": st["n"] + v}}

@actor
class Node:
    nxt: Ref["Node"]
    rep: Ref["Reporter"]
    passes: I32

    MAX_SENDS = 2

    @behaviour
    def token(self, st, hops: I32):
        self.send(st["nxt"], Node.token, hops - 1, when=hops > 1)
        self.send(st["rep"], Reporter.report, 1, when=(hops % 128) == 0)
        self.exit(0, when=hops <= 1)
        return {{**st, "passes": st["passes"] + 1}}

MODE = {mode!r}
rt = Runtime(RuntimeOptions(
    mailbox_cap=8, batch=1, max_sends=2, msg_words=1, spill_cap=64,
    inject_slots=8, quiesce_interval=64, tuning_cache="off",
    checkpoint_every_s=0.01, checkpoint_path={prefix!r},
    checkpoint_keep=4,
    watchdog_s=(2.0 if MODE == "wedge" else None),
    analysis_path={apath!r}), device="cpu")
rt.declare(Node, 16).declare(Reporter, 2)
rt.start()
restored = supervise.maybe_restore(rt)
if restored is None:
    ids = rt.spawn_many(Node, 16)
    rep = rt.spawn(Reporter)
    rt.set_fields(Node, ids, nxt=np.roll(ids, -1), rep=rep)
    rt.send(int(ids[0]), Node.token, {hops})
    rt.checkpoint()                    # deterministic recovery floor
    if MODE == "wedge":
        testing.wedge_behaviour(Reporter.report, at_dispatch=3,
                                sleep_s=600.0)
else:
    # faults are one-shot: the recovered child runs clean
    os.environ.pop("PONY_TPU_CHAOS", None)
    testing.chaos.reset()
try:
    code = rt.run()
except Exception as e:
    c = error_code(e)
    if c:
        sys.exit(c)                    # the coded-failure exit contract
    raise
passes = [int(x) for x in rt.cohort_state(Node)["passes"]]
reporter = int(sum(st.get("n", 0) for st in rt._host_state.values()))
rt.stop()
json.dump({{"exit": code, "passes": passes, "reporter": reporter,
           "restored": restored is not None}}, open({out!r}, "w"))
sys.exit(code)
"""


ACCEPT_HOPS = 1000


def _accept_script(tmp_path, mode):
    prefix = str(tmp_path / f"{mode}-ring")
    out = str(tmp_path / f"{mode}-out.json")
    code = ACCEPT_SCRIPT.format(
        root=ROOT, mode=mode, prefix=prefix, out=out, hops=ACCEPT_HOPS,
        apath=str(tmp_path / f"{mode}-an.csv"))
    p = str(tmp_path / f"{mode}.py")
    with open(p, "w") as f:
        f.write(code)
    return p, prefix, out


@actor
class _Reporter:
    HOST = True
    n: I32

    @behaviour
    def report(self, st, v: I32):
        return {**st, "n": st["n"] + v}


@actor
class _Node:
    nxt: Ref["_Node"]
    rep: Ref["_Reporter"]
    passes: I32

    MAX_SENDS = 2

    @behaviour
    def token(self, st, hops: I32):
        self.send(st["nxt"], _Node.token, hops - 1, when=hops > 1)
        self.send(st["rep"], _Reporter.report, 1, when=(hops % 128) == 0)
        self.exit(0, when=hops <= 1)
        return {**st, "passes": st["passes"] + 1}


@pytest.fixture(scope="module")
def clean_baseline():
    """The unfaulted run, in-process (the subprocess scripts run the
    structurally identical program)."""
    rt = Runtime(RuntimeOptions(
        mailbox_cap=8, batch=1, max_sends=2, msg_words=1, spill_cap=64,
        inject_slots=8, quiesce_interval=64, tuning_cache="off"),
        device="cpu")
    rt.declare(_Node, 16).declare(_Reporter, 2)
    rt.start()
    ids = rt.spawn_many(_Node, 16)
    rep = rt.spawn(_Reporter)
    rt.set_fields(_Node, ids, nxt=np.roll(ids, -1), rep=rep)
    rt.send(int(ids[0]), _Node.token, ACCEPT_HOPS)
    code = rt.run()
    return {"exit": code,
            "passes": [int(x) for x in rt.cohort_state(_Node)["passes"]],
            "reporter": int(sum(st.get("n", 0)
                                for st in rt._host_state.values()))}


def _child_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_acceptance_wedged_run_supervised_to_completion(
        tmp_path, clean_baseline, monkeypatch):
    """A wedged host behaviour (the watchdog's code-7 stall) is restarted
    by the supervisor from the last intact checkpoint and completes the
    workload with the unfaulted results, in seconds, not the 600 s
    sleep."""
    monkeypatch.delenv("PYTHONPATH", raising=False)
    script, prefix, out = _accept_script(tmp_path, "wedge")
    sup = supervise.Supervisor(
        argv=[sys.executable, script], prefix=prefix, retries=3,
        backoff_s=0.05)
    t0 = time.monotonic()
    code = sup.run()
    elapsed = time.monotonic() - t0
    assert code == 0, sup.failures
    assert sup.restarts >= 1
    assert sup.failures[0]["code"] == ERROR_CODES["PonyStallError"] == 7
    assert sup.restored_from is not None
    assert elapsed < 120
    with open(out) as f:
        got = json.load(f)
    assert got["restored"] is True
    assert got["exit"] == clean_baseline["exit"] == 0
    assert got["passes"] == clean_baseline["passes"]
    assert got["reporter"] == clean_baseline["reporter"]


def test_acceptance_sigkill_mid_flush_supervised_to_completion(
        tmp_path, clean_baseline, monkeypatch):
    """The process is SIGKILLed mid-flush inside a checkpoint write (the
    serialise.py chaos point): the torn write never surfaces, the
    supervisor restores the newest intact ring snapshot, and the workload
    completes with the unfaulted outcome."""
    monkeypatch.delenv("PYTHONPATH", raising=False)
    script, prefix, out = _accept_script(tmp_path, "kill")
    monkeypatch.setenv("PONY_TPU_CHAOS", "snapshot-mid-flush@3")
    sup = supervise.Supervisor(
        argv=[sys.executable, script], prefix=prefix, retries=5,
        backoff_s=0.05)
    code = sup.run()
    assert code == 0, sup.failures
    assert sup.restarts >= 1
    assert sup.failures[0]["code"] == -9       # SIGKILL
    for _seq, f in serialise.list_checkpoints(prefix):
        serialise.verify_snapshot(f)
    with open(out) as f:
        got = json.load(f)
    assert got["restored"] is True
    assert got["passes"] == clean_baseline["passes"]
    assert got["reporter"] == clean_baseline["reporter"]


# =========================================== observability integration

def test_postmortem_doctor_and_healthz_show_restore_point(tmp_path):
    from ponyc_tpu_torch import flight, metrics
    prefix = str(tmp_path / "pm")
    rt, ids = _ring(8, checkpoint_every_s=30.0, checkpoint_path=prefix,
                    analysis_path=str(tmp_path / "an.csv"))
    hz = metrics.health(rt)
    assert hz["last_checkpoint_age_s"] is None   # nothing written yet
    rt.send(int(ids[0]), TT.RingNode.token, 50)
    rt.run()
    rt.checkpoint()
    rt._ckpt.flush()
    hz = metrics.health(rt)
    assert hz["last_checkpoint_age_s"] is not None
    assert hz["last_checkpoint_age_s"] < 60
    assert hz["last_checkpoint_path"].startswith(prefix)
    pm = rt._flight.postmortem("manual")
    assert pm["checkpoint"]["path"]
    assert pm["checkpoint"]["verified"] is True
    assert "restorable from:" in flight.render_postmortem(pm)
    pm["errors"] = [{"class": "SpillOverflowError", "code": 2,
                     "count": 1}]
    line, _detail = flight.diagnose_postmortem(pm)
    assert line.startswith("CRASHED")
    assert "restorable from " + pm["checkpoint"]["path"] in line
    rt.stop()
    rt2, _ = _ring(8)
    hz2 = metrics.health(rt2)
    assert "last_checkpoint_age_s" in hz2
    assert hz2["last_checkpoint_age_s"] is None


# ========================================================== CLI surface

def test_cli_snapshot_and_restore_verdicts(tmp_path, capsys):
    from ponyc_tpu_torch.__main__ import main as cli_main
    p = str(tmp_path / "w.npz")
    rt, ids = _ring(8)
    rt.send(int(ids[0]), TT.RingNode.token, 40)
    rt.run()
    serialise.save(rt, p)

    assert cli_main(["snapshot", p]) == 0
    out = capsys.readouterr().out
    assert "INTACT" in out and "RingNode[8]" in out
    assert cli_main(["snapshot", p, "--json"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["intact"] and info["format"] == 3
    assert info["steps_run"] == rt.steps_run

    assert cli_main(["restore", p]) == 0
    assert "RESTORABLE" in capsys.readouterr().out

    testing.corrupt_snapshot(p, "bitflip")
    assert cli_main(["snapshot", p]) == 1
    assert cli_main(["restore", p]) == 1
    capsys.readouterr()

    prefix = str(tmp_path / "r")
    for seq in range(2):
        serialise.save(rt, serialise.checkpoint_file(prefix, seq))
    testing.corrupt_snapshot(serialise.checkpoint_file(prefix, 1),
                             "truncate")
    assert cli_main(["snapshot", prefix]) == 0   # falls back to seq 0
    assert "00000000.ckpt" in capsys.readouterr().out


def test_cli_usage_error_exit_codes(tmp_path, capsys):
    from ponyc_tpu_torch.__main__ import main as cli_main
    assert cli_main(["snapshot"]) == 2                    # no target
    assert cli_main(["snapshot", "a", "b"]) == 2          # two targets
    assert cli_main(["restore"]) == 2
    assert cli_main(["snapshot", str(tmp_path / "nope")]) == 2
    assert cli_main(["supervise"]) == 2                   # no prefix
    assert cli_main(["supervise", "--prefix"]) == 2       # no value
    assert cli_main(["supervise", "--prefix", "p"]) == 2  # no script
    assert cli_main(["supervise", "--retries", "x", "--prefix", "p",
                     "s.py"]) == 2                        # bad int
    assert cli_main(["supervise", "--prefix", "p",
                     str(tmp_path / "nope.py")]) == 2     # no script
    capsys.readouterr()


# =============================================== chaos harness selftest

def test_chaos_hooks_arm_and_disarm():
    c = testing.ChaosHooks()
    fired = []
    c.arm("p", action=lambda: fired.append(1), after=2)
    c.fire("p")
    assert not fired
    c.fire("p")
    assert fired == [1]
    c.fire("p")                       # one-shot: disarmed after firing
    assert fired == [1]
    with pytest.raises(ValueError):
        c.arm("p", after=0)
    with pytest.raises(ValueError):
        c.arm("p", action="explode")
    c.arm("q", action=lambda: fired.append(2))
    c.reset()
    c.fire("q")
    assert fired == [1]


def test_chaos_fatal_poller_fires_once():
    rt, ids = _ring(8, quiesce_interval=8)
    hook = testing.fatal_at_boundary(rt, boundary=2, code=77)
    rt.send(int(ids[0]), TT.RingNode.token, 500)
    with pytest.raises(PonyError) as ei:
        rt.run()
    assert ei.value.code == 77
    assert hook.fired == 1

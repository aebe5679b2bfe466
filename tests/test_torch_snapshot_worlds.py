"""Snapshots of the worlds of earlier slices in the PyTorch port, held
against the JAX package: the host fast lane's queued messages
(tests/test_host_fastpath.py's checkpoint case), the blob pool with the
host's blob roots and blobs in flight (tests/test_blobs.py's snapshot
cases), and a traced world whose trace lanes and span numbering cross a
restore.

Each world is defined once for both packages (`define(pkg)` and
`define_blobs(pkg)` in tests/_torch_programs.py), runs on the port's
three paths on the CPU (the `path` fixture of test_torch_host.py; under
"mega" every window also runs as the host C++ build of
csrc/mega_window.cu) and once in the JAX package. The worlds are
integer, so the tolerance is exact.
"""

import functools
import sys
import tempfile
from pathlib import Path

import numpy as np

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu import serialise as sj
from ponyc_tpu_torch import serialise as st

from _torch_programs import define_blobs
from test_torch_host import FAST, TJ, TT, _runtime, path  # noqa: F401

SER = {ponyc_tpu: sj, ponyc_tpu_torch: st}
BJ, BT = define_blobs(ponyc_tpu), define_blobs(ponyc_tpu_torch)
BLOBS = dict(mailbox_cap=4, batch=2, max_sends=1, msg_words=2,
             inject_slots=8, blob_slots=16, blob_words=8)


@functools.lru_cache(maxsize=None)
def _jax(name):
    return getattr(sys.modules[__name__], name)(
        ponyc_tpu, "plain", Path(tempfile.mkdtemp()))


def _fast_lane(pkg, path, tmp):
    T = TJ if pkg is ponyc_tpu else TT
    rt = _runtime(pkg, path, FAST)
    rt.declare(T.HostCounter, 1).start()
    a = rt.spawn(T.HostCounter)
    for v in range(5):
        rt.send(a, T.HostCounter.hit, v)
    p = str(tmp / "fast.npz")
    SER[pkg].save(rt, p)
    rt2 = _runtime(pkg, path, FAST)
    rt2.declare(T.HostCounter, 1).start()
    SER[pkg].restore(rt2, p)
    queued = len(rt2._host_fast_q)
    rt2.run(max_steps=16)
    return queued, rt2.state_of(a), rt2.steps_run


def test_checkpoint_carries_queued_fast_messages(tmp_path, path):
    got = _fast_lane(ponyc_tpu_torch, path, tmp_path)
    assert got[:2] == (5, {"n": 5, "last": 4})
    assert got == _jax("_fast_lane")


def _blob_roots(pkg, path, tmp):
    B = BJ if pkg is ponyc_tpu else BT
    rt = _runtime(pkg, path, BLOBS)
    rt.declare(B.Consumer, 2).start()
    h = rt.blob_store([5])
    p = str(tmp / "roots.npz")
    SER[pkg].save(rt, p)
    rt2 = _runtime(pkg, path, BLOBS)
    rt2.declare(B.Consumer, 2).start()
    SER[pkg].restore(rt2, p)
    rt2.gc()                            # must not sweep the host's blob
    return (h, sorted(rt2._host_blobs), rt2.blobs_in_use,
            np.asarray(rt2.blob_fetch(h)).tolist())


def test_snapshot_preserves_host_blob_roots(tmp_path, path):
    h, roots, in_use, words = _blob_roots(ponyc_tpu_torch, path, tmp_path)
    assert roots == [h] and in_use == 1 and words == [5]
    assert (h, roots, in_use, words) == _jax("_blob_roots")


def _records(pkg, path, tmp):
    """tests/test_blobs.py::test_snapshot_resumes_midflight_blob_pipeline:
    the records model checkpointed while its blob messages are queued
    (allocated, unread), restored into a fresh runtime, run to the end."""
    if pkg is ponyc_tpu:
        from ponyc_tpu.models import records
    else:
        from ponyc_tpu_torch.models import records
    okw = dict(mailbox_cap=8, batch=2, max_sends=2, msg_words=2,
               inject_slots=8, blob_slots=128, blob_words=records.W)

    def build():
        rt = _runtime(pkg, path, okw)
        rt.declare(records.RecSource, 8).declare(records.RecWorker, 8)
        rt.declare(records.RecSink, 1).start()
        sink = rt.spawn(records.RecSink, total=0, n=0)
        workers = [rt.spawn(records.RecWorker, sink=int(sink),
                            mult=k % 3 + 1) for k in range(8)]
        sources = [rt.spawn(records.RecSource, out=int(workers[k]),
                            seed=k + 1, left=6) for k in range(8)]
        return rt, sink, sources

    rt, sink, sources = build()
    for s in sources:
        rt.send(int(s), records.RecSource.emit, 0)
    rt.run(max_steps=3)                     # mid-flight: blobs queued
    in_flight = rt.blobs_in_use
    p = str(tmp / "rec.npz")
    SER[pkg].save(rt, p)
    rt2, sink2, _ = build()
    SER[pkg].restore(rt2, p)
    code = rt2.run()
    stt = rt2.state_of(int(sink2))
    return (in_flight, code, stt["n"], int(np.int32(stt["total"])),
            rt2.blobs_in_use, rt2.steps_run, records.oracle(8, 6))


def test_snapshot_resumes_midflight_blob_pipeline(tmp_path, path):
    got = _records(ponyc_tpu_torch, path, tmp_path)
    in_flight, code, n, total, in_use, _steps, (want_n, want_total) = got
    assert in_flight > 0 and code == 0 and in_use == 0
    assert n == want_n and total == int(np.int32(want_total))
    assert got == _jax("_records")


def _traced(pkg, path, tmp):
    """A traced ring (analysis=3, every message traced): the token is in a
    mailbox, its trace lane beside it, when the world is snapshotted. The
    restored world's spans continue the trace: equal to the spans the
    uninterrupted run recorded after the cut, span ids and parents
    included."""
    T = TJ if pkg is ponyc_tpu else TT
    okw = dict(mailbox_cap=8, batch=1, max_sends=1, msg_words=1,
               spill_cap=64, inject_slots=8, analysis=3, trace_sample=1,
               quiesce_interval=4)

    def build(name):
        rt = _runtime(pkg, path, dict(okw,
                                      analysis_path=str(tmp / name)))
        rt.declare(T.RingNode, 8).start()
        ids = rt.spawn_many(T.RingNode, 8)
        rt.set_fields(T.RingNode, ids, next_ref=np.roll(ids, -1))
        return rt, ids

    def spans(rt):
        rt.traces()                       # drain the device ring
        return list(rt._tracer.spans)

    whole, ids = build("whole.csv")
    whole.send(int(ids[0]), T.RingNode.token, 40)
    whole.run(max_steps=15)
    cut = len(spans(whole))
    whole.run()
    after_cut = sorted(spans(whole)[cut:])
    whole_end = {"passes": whole.cohort_state(T.RingNode)["passes"].tolist(),
                 "steps": whole.steps_run}
    whole.stop()

    rt, ids = build("a.csv")
    rt.send(int(ids[0]), T.RingNode.token, 40)
    rt.run(max_steps=15)
    lanes = {k: np.asarray(v.tolist() if hasattr(v, "tolist") else v)
             for k, v in rt.state.trace_buf.items()}
    p = str(tmp / "traced.npz")
    SER[pkg].save(rt, p)
    rt.stop()
    rt2, _ = build("b.csv")
    SER[pkg].restore(rt2, p)
    lanes2 = {k: np.asarray(v.tolist() if hasattr(v, "tolist") else v)
              for k, v in rt2.state.trace_buf.items()}
    span_next = np.asarray(rt2.state.span_next.tolist()).tolist()
    rt2.run()
    got = sorted(spans(rt2))
    end = {"passes": rt2.cohort_state(T.RingNode)["passes"].tolist(),
           "steps": rt2.steps_run}
    rt2.stop()
    same_lanes = all(np.array_equal(lanes[k], lanes2[k]) for k in lanes)
    live = bool((lanes[T.RingNode.__name__][:, 0] >= 0).any())
    return {"lanes_survive": same_lanes, "traced_in_flight": live,
            "span_next": span_next, "spans": got,
            "spans_equal_whole": got == after_cut, "end": end,
            "end_equal_whole": end == whole_end}


def test_traced_world_survives_restore(tmp_path, path):
    got = _traced(ponyc_tpu_torch, path, tmp_path)
    assert got["lanes_survive"] and got["traced_in_flight"]
    assert got["spans"] and got["span_next"][0] > 0
    assert got["spans_equal_whole"] and got["end_equal_whole"]
    assert got == _jax("_traced")

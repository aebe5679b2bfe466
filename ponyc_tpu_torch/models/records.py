"""records on the PyTorch port — the same program as
``ponyc_tpu/models/records.py``: a variable-length-payload pipeline over
the device blob pool (sources build records as blobs, workers reduce
them, a sink accumulates), with the same NumPy oracle.

≙ the reference's rich-message workloads: a Pony behaviour ships
`String iso` / `Array[U32] iso` payloads (pony_alloc_msg object graphs,
pony.h:332-360). Payloads bigger than a mailbox word travel
device-resident end to end:

  RecSource.emit   allocates a blob of data-dependent logical length
                   (1..W words), fills it, and moves it to its worker
                   (when-masked alloc, writes and send on the last record);
  RecWorker.work   reads blob_length and every word, frees the input, and
                   forwards the reduced value;
  RecSink.collect  accumulates count and checksum.

Every blob is freed by its consumer, so a run leaves blobs_in_use == 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import Blob, I32, Ref, Runtime, RuntimeOptions, actor, behaviour

W = 8                 # pool word width; logical lengths are 1..W


@actor
class RecSource:
    out: Ref["RecWorker"]
    seed: I32
    left: I32

    BATCH = 1
    MAX_SENDS = 2
    MAX_BLOBS = 1
    BLOB_DISPATCHES = 1

    @behaviour
    def emit(self, st, _: I32):
        r = st["left"]
        go = r > 0
        ln = 1 + (st["seed"] + r) % W
        h = self.blob_alloc(length=ln, when=go)
        for i in range(W):
            self.blob_set(h, i, st["seed"] * (i + 1) + r,
                          when=go & (i < ln))
        self.send(st["out"], RecWorker.work, h, when=go)
        self.send(self.actor_id, RecSource.emit, 0, when=r > 1)
        return {**st, "left": r - 1}


@actor
class RecWorker:
    sink: Ref["RecSink"]
    mult: I32

    MAX_SENDS = 1

    @behaviour
    def work(self, st, h: Blob):
        ln = self.blob_length(h)
        s = 0
        for i in range(W):
            s = s + torch.where(i < ln, self.blob_get(h, i), 0)
        self.blob_free(h)
        self.send(st["sink"], RecSink.collect, s * st["mult"])
        return st


@actor
class RecSink:
    total: I32
    n: I32

    @behaviour
    def collect(self, st, v: I32):
        return {"total": st["total"] + v, "n": st["n"] + 1}


def oracle(n_sources: int, n_records: int) -> tuple[int, int]:
    """(expected record count, expected i32-wrapped checksum)."""
    total = np.int32(0)
    for k in range(n_sources):
        seed, mult = k + 1, k % 3 + 1
        for r in range(1, n_records + 1):
            ln = (seed + r) % W + 1
            words = np.int32(seed) * np.arange(1, ln + 1, dtype=np.int32) \
                + np.int32(r)
            with np.errstate(over="ignore"):
                total = np.int32(total + np.int32(words.sum()) * mult)
    return n_sources * n_records, int(total)


def options(n_sources: int, **kw) -> RuntimeOptions:
    """The model's own options. Pool sizing: a blob is live from alloc
    until its consumer frees it, so the in-flight depth is bounded by the
    consumers' queue depth (the single fan-in sink throttles the workers
    by mute backpressure, and every parked worker message holds a live
    handle): up to n_sources × (mailbox_cap + spillage). Undersizing
    raises BlobCapacityError."""
    return RuntimeOptions(**{**dict(
        mailbox_cap=8, batch=2, max_sends=2, msg_words=2,
        inject_slots=max(8, n_sources),
        blob_slots=max(64, 16 * n_sources), blob_words=W), **kw})


def build(n_sources: int = 32, n_records: int = 8,
          opts: RuntimeOptions | None = None, device=None):
    rt = Runtime(opts or options(n_sources), device=device)
    rt.declare(RecSource, n_sources)
    rt.declare(RecWorker, n_sources)
    rt.declare(RecSink, 1)
    rt.start()
    sink = rt.spawn(RecSink, total=0, n=0)
    workers = [rt.spawn(RecWorker, sink=int(sink), mult=k % 3 + 1)
               for k in range(n_sources)]
    sources = [rt.spawn(RecSource, out=int(workers[k]), seed=k + 1,
                        left=n_records)
               for k in range(n_sources)]
    return rt, sink, sources


def run_records(n_sources: int = 32, n_records: int = 8,
                opts: RuntimeOptions | None = None, device=None):
    """Build, run to quiescence, assert against the oracle; returns
    (rt, sink_state)."""
    rt, sink, sources = build(n_sources, n_records, opts, device)
    for s in sources:
        rt.send(int(s), RecSource.emit, 0)
    rt.run()
    st = rt.state_of(int(sink))
    want_n, want_total = oracle(n_sources, n_records)
    assert st["n"] == want_n, (st["n"], want_n)
    assert np.int32(st["total"]) == np.int32(want_total), (
        st["total"], want_total)
    assert rt.blobs_in_use == 0, rt.blobs_in_use
    return rt, st

"""Tests of the PyTorch port that need the card: the hand-written CUDA
kernels (the drain and the fused dispatch) against their plain versions,
and worlds run on the card against the same worlds on the CPU, with the
fused dispatch off and on and with the window kernel
(delivery="pallas_mega"). Every test carries the `cuda` marker and
skips without a CUDA device. This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

All compared values are int32/bool, or float32 compared as bits: the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import ponyc_tpu_torch
from ponyc_tpu_torch import RuntimeOptions
from ponyc_tpu_torch.models import mixed, nbody
from ponyc_tpu_torch.ops import fused_dispatch as fdm
from ponyc_tpu_torch.ops import mailbox_kernel as mk
from ponyc_tpu_torch.program import Program

from _torch_programs import (CORPUS, build_walkers, counters, define,
                             run_corpus)

TT = define(ponyc_tpu_torch)

SHAPES = [  # (cap, w1, N, batch): ubench's and the ring's shape, then edges
    (4, 2, 1 << 20, 4), (8, 2, 1024, 1), (64, 2, 1000, 8), (4, 2, 100, 1), (8, 3, 2048, 8),
    (2, 1, 257, 4), (8, 3, 1, 8),
]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _drain_inputs(cap, w1, n, batch, seed):
    rng = np.random.default_rng(seed)
    buf = rng.integers(-2**31, 2**31 - 1, (cap, w1, n), dtype=np.int64)
    head = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
    q = n // 4          # heads that wrap in this drain / wrapped before
    head[:q] = 2**31 - 1 - rng.integers(0, 2 * batch + 1, q)
    head[q:2 * q] = -2**31 + rng.integers(0, 2 * batch + 1, q)
    n_run = rng.integers(0, batch + 1, n)
    return [torch.from_numpy(a.astype(np.int32)).cuda()
            for a in (buf, head, n_run)]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,w1,n,batch", SHAPES)
def test_drain_kernel_matches_plain(cap, w1, n, batch):
    _need_cuda()
    args = _drain_inputs(cap, w1, n, batch, seed=cap + n + batch)
    before = mk.drain_msgs.launches
    km, kv = mk.drain_msgs(*args, batch)
    torch.cuda.synchronize()
    assert mk.drain_msgs.launches == before + 1
    pm, pv = mk.drain_msgs_plain(*args, batch)
    assert km.dtype == torch.int32 and kv.dtype == torch.bool
    assert torch.equal(km, pm) and torch.equal(kv, pv)


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(0, 2), (64, 0)])
def test_drain_kernel_empty_launches_nothing(n, batch):
    """An empty drain returns empty outputs and counts no launch."""
    _need_cuda()
    buf, head, n_run = _drain_inputs(4, 2, n, max(batch, 1), seed=3)
    before = mk.drain_msgs.launches
    msgs, valid = mk.drain_msgs(buf, head, n_run, batch)
    assert msgs.shape == (batch, 2, n) and valid.shape == (batch, n)
    assert valid.dtype == torch.bool and msgs.is_cuda
    assert mk.drain_msgs.launches == before


@pytest.mark.cuda
def test_drain_kernel_refuses_strided_input():
    _need_cuda()
    buf, head, n_run = _drain_inputs(4, 2, 64, 2, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        mk.drain_msgs(buf.transpose(0, 1).contiguous().transpose(0, 1),
                      head, n_run, 2)


@pytest.mark.cuda
def test_card_matches_cpu():
    """The same world on the card (drain kernel) and on the CPU (plain
    drain): equal fields, counters and ticks."""
    _need_cuda()
    okw = dict(mailbox_cap=4, batch=1, msg_words=1, max_sends=2,
               spill_cap=512, inject_slots=16)
    cpu = build_walkers(ponyc_tpu_torch, TT, 7, n_seeds=30, **okw)
    card = build_walkers(ponyc_tpu_torch, TT, 7, n_seeds=30,
                         device="cuda", **okw)
    before = mk.drain_msgs.launches
    assert card.run(max_steps=100_000) == cpu.run(max_steps=100_000)
    assert mk.drain_msgs.launches > before
    assert counters(card) == counters(cpu)
    assert card.steps_run == cpu.steps_run
    for t in (TT.Walker, TT.Splitter):
        a, b = card.cohort_state(t), cpu.cohort_state(t)
        for f in a:
            np.testing.assert_array_equal(a[f], b[f])


MIXED_OPTS = dict(mailbox_cap=4, batch=1, max_sends=1, msg_words=1)
# (actor types, options, lanes, build_fused_dispatch/sample_inputs
# keywords): the main shapes (mixed at its full width, all-hot and
# one-hot, where its lanes are regrouped by message id), then edges, and
# cohorts built regrouped whatever the compile-time rule chooses.
FUSED = [
    ((TT.Pinger,), dict(mailbox_cap=4, batch=4, max_sends=1, msg_words=1),
     1 << 20, {}),
    ((mixed.make_worker_type(8, work=64),), MIXED_OPTS, 1 << 16, {}),
    ((mixed.make_worker_type(8, work=64),), MIXED_OPTS, 1 << 20, {}),
    ((mixed.make_worker_type(8, hot=1, work=64),), MIXED_OPTS, 1 << 20,
     dict(pattern="same")),
    ((nbody.Body,), dict(mailbox_cap=16, batch=4, max_sends=1,
                         msg_words=4), 1024, {}),
    ((TT.Mixer, TT.TriF, TT.Yielder, TT.Exiter, TT.Ephemeral, TT.Errs,
      TT.Arith), dict(mailbox_cap=8, batch=4, max_sends=2, msg_words=2),
     257, {}),
    ((TT.Mixer, TT.Arith), dict(mailbox_cap=8, batch=4, max_sends=2,
                                msg_words=2), 1, {}),
    # Spawning cohorts: reservation planes in, claim planes out.
    ((TT.Node,), dict(mailbox_cap=8, batch=4, max_sends=3, msg_words=2),
     1 << 16, {}),
    ((TT.Boss, TT.Worker), dict(mailbox_cap=8, batch=2, max_sends=2,
                                msg_words=2), 257, {}),
    ((TT.Mixer, TT.TriF, TT.Yielder, TT.Exiter, TT.Ephemeral, TT.Errs,
      TT.Arith), dict(mailbox_cap=8, batch=4, max_sends=2, msg_words=2),
     5000, dict(regroup=True)),
    ((TT.Node,), dict(mailbox_cap=8, batch=4, max_sends=3, msg_words=2),
     1 << 16, dict(regroup=True)),
    ((TT.Boss, TT.Worker), dict(mailbox_cap=8, batch=2, max_sends=2,
                                msg_words=2), 257, dict(regroup=True)),
]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _flat(x):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _flat(x[k])
    elif isinstance(x, tuple):
        for v in x:
            yield from _flat(v)
    else:
        yield x


@pytest.mark.cuda
@pytest.mark.parametrize("types,okw,lanes,kw", FUSED,
                         ids=["ubench", "mixed", "mixed_full",
                              "mixed_onehot", "nbody", "corpus", "one",
                              "spawn_tree", "boss", "corpus_regrouped",
                              "spawn_tree_regrouped", "boss_regrouped"])
def test_fused_kernel_matches_plain(types, okw, lanes, kw):
    _need_cuda()
    from ponyc_tpu_torch.runtime.engine import spawn_meta_of
    opts = RuntimeOptions(tuning_cache="off", pallas_fused=True, **okw)
    prog = Program(opts)
    for t in types:
        prog.declare(t, lanes)
    prog.finalize()
    for t in types:
        ch = prog.by_type[t]
        fd = fdm.build_fused_dispatch(ch, opts, spawn_meta_of(prog, ch),
                                      regroup=kw.get("regroup"))
        inputs = fd.sample_inputs(seed=lanes % 97, device="cuda",
                                  pattern=kw.get("pattern"))
        before = fdm.FusedDispatch.launches
        got = fd(*inputs)
        torch.cuda.synchronize()
        assert fdm.FusedDispatch.launches == before + 1
        want = fd.plain(*inputs)
        for x, y in zip(_flat(got), _flat(want)):
            if y is None:
                assert x is None
                continue
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(_bits(x), _bits(y)), t.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", fdm.ID_PATTERNS)
def test_fused_regroup_id_patterns_match_plain(pattern):
    """Mixed's regrouped kernel at its full width on id layouts that
    stress the regroup, against the plain version bit for bit."""
    _need_cuda()
    opts = RuntimeOptions(tuning_cache="off", pallas_fused=True,
                          **MIXED_OPTS)
    wt = mixed.make_worker_type(8, work=64)
    prog = Program(opts)
    prog.declare(wt, 1 << 20)
    prog.finalize()
    fd = fdm.build_fused_dispatch(prog.by_type[wt], opts)
    assert fd.regroup
    inputs = fd.sample_inputs(seed=5, device="cuda", pattern=pattern)
    got = fd(*inputs)
    torch.cuda.synchronize()
    for x, y in zip(_flat(got), _flat(fd.plain(*inputs))):
        if y is None:
            assert x is None
            continue
        assert torch.equal(_bits(x), _bits(y)), pattern


@pytest.mark.cuda
@pytest.mark.parametrize("name", CORPUS)
def test_fused_card_matches_cpu(name):
    _need_cuda()
    before = fdm.FusedDispatch.launches
    card = run_corpus(ponyc_tpu_torch, TT, name, device="cuda",
                      pallas_fused=True)
    assert fdm.FusedDispatch.launches > before
    assert card == run_corpus(ponyc_tpu_torch, TT, name, device="cpu",
                              pallas_fused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CORPUS)
def test_mega_card_matches_cpu(name):
    """delivery="pallas_mega": the window kernel on the card against the
    plain window on the CPU, through Runtime.run()."""
    _need_cuda()
    from ponyc_tpu_torch.ops.megakernel import MegaWindow
    before = MegaWindow.launches
    g = run_corpus(ponyc_tpu_torch, TT, name, device="cuda",
                   delivery="pallas_mega")
    assert MegaWindow.launches > before
    assert g == run_corpus(ponyc_tpu_torch, TT, name, device="cpu",
                           delivery="pallas_mega")


@pytest.mark.cuda
def test_mega_walkers_card_matches_cpu():
    _need_cuda()
    kw = dict(mailbox_cap=2, batch=1, msg_words=1, max_sends=2,
              spill_cap=512, inject_slots=16, mute_age_limit=4,
              delivery="pallas_mega")
    out = []
    for device in ("cuda", "cpu"):
        rt = build_walkers(ponyc_tpu_torch, TT, 7, n_seeds=30,
                           device=device, **kw)
        rt.run(max_steps=2000)
        out.append((counters(rt), rt.steps_run,
                    {k: v.tolist() for k, v in
                     rt.cohort_state(TT.Walker).items()}))
    assert out[0] == out[1] and out[0][0]["n_mutes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sort", ["segment", "radix", "radix2"])
def test_mega_sort_branches_card_matches_cpu(sort):
    """The window kernel's two sorts on the card, on the spill/mute
    world: at the default thresholds (the segment sort where its targets'
    segments are short) and rebuilt with the segment sort ruled out (the
    radix sort, in one pass and in two); each against the CPU."""
    _need_cuda()
    kw = dict(mailbox_cap=2, batch=1, msg_words=1, max_sends=2,
              spill_cap=512, inject_slots=16, delivery="pallas_mega")
    world = {"segment": {}, "radix": dict(SEG=-1),
             "radix2": dict(SEG=-1, NPASS=2, DBITS=8)}[sort]
    out = []
    for device in ("cuda", "cpu"):
        rt = build_walkers(ponyc_tpu_torch, TT, 7, n_seeds=30,
                           device=device, **kw)
        mw = rt._multi_g
        if device == "cuda" and world:
            mw.world.update(world)
            mw.header = mw.source("cuda")
            mw.build()
        rt.run(max_steps=2000)
        out.append((counters(rt), rt.steps_run,
                    {k: v.tolist() for k, v in
                     rt.cohort_state(TT.Walker).items()}))
    assert out[0] == out[1] and out[0][0]["n_rejected"] > 0


PATHS = {"plain": dict(pallas_fused=False),
         "fused": dict(pallas_fused=True),
         "mega": dict(delivery="pallas_mega")}


def _launched():
    from ponyc_tpu_torch.ops.megakernel import MegaWindow
    return (mk.drain_msgs.launches, fdm.FusedDispatch.launches,
            MegaWindow.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_spawn_tree_card_matches_cpu(path):
    """The spawn tree at depth 8 on the card and on the CPU, on each
    path: exit code 256, 510 device spawns, equal columns and liveness;
    the path's kernel launched."""
    _need_cuda()
    from ponyc_tpu_torch.models import spawn_tree
    out = []
    for device in ("cuda", "cpu"):
        before = _launched()
        rt = spawn_tree.run(8, spawn_tree.options(tuning_cache="off",
                                                  **PATHS[path]),
                            device=device)
        moved = [b - a for a, b in zip(before, _launched())]
        out.append((rt.exit_code, rt.counter("n_spawned"), rt.steps_run,
                    {k: v.tolist() for k, v in
                     rt.cohort_state(spawn_tree.Node).items()},
                    rt.state.alive.cpu().tolist()))
        if device == "cuda":
            assert moved[list(PATHS).index(path)] > 0, moved
    assert out[0] == out[1]
    assert out[0][:2] == (256, 510)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "mega"])
@pytest.mark.parametrize("world", ["churn", "sync"])
def test_spawn_worlds_card_match_cpu(world, path):
    """The spawn/destroy churn and the spawn_sync world on the card
    against the CPU, under the fused and the window kernel."""
    _need_cuda()
    from _torch_programs import new_runtime
    from _torch_programs import churn
    out = []
    for device in ("cuda", "cpu"):
        if world == "churn":
            rt = churn(ponyc_tpu_torch, TT, 301, device=device,
                       **PATHS[path])[0]
            types = (TT.Relay, TT.Temp, TT.Collector)
        else:
            rt = new_runtime(ponyc_tpu_torch, dict(
                mailbox_cap=8, batch=2, max_sends=1, msg_words=3,
                inject_slots=8, **PATHS[path]), device)
            rt.declare(TT.Maker, 3).declare(TT.Kid, 6).start()
            for m in rt.spawn_many(TT.Maker, 3):
                rt.send(int(m), TT.Maker.make, int(m) + 5)
            types = (TT.Maker, TT.Kid)
        code = rt.run(max_steps=100_000)
        out.append((code, counters(rt), rt.counter("n_spawned"),
                    rt.steps_run, {t.__name__: {
                        k: _bits(torch.from_numpy(np.ascontiguousarray(v)))
                        .tolist() for k, v in rt.cohort_state(t).items()}
                        for t in types}))
    assert out[0] == out[1] and out[0][2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_spawn_exhaustion_raises_on_card(path):
    """Past the free rows the sticky spawn fail raises
    SpawnCapacityError on the card, on every path."""
    _need_cuda()
    from _torch_programs import new_runtime
    rt = new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=8, batch=2, max_sends=1, msg_words=2, spill_cap=256,
        inject_slots=8, **PATHS[path]), "cuda")
    rt.declare(TT.Spawner, 4).declare(TT.SpawnChild, 2).start()
    for s in rt.spawn_many(TT.Spawner, 4):
        rt.send(int(s), TT.Spawner.make, 1)
    with pytest.raises(ponyc_tpu_torch.SpawnCapacityError):
        rt.run(max_steps=16)


def _host_world(world, path, device):
    """A host world of tests/test_torch_host.py on `device`: the reporting
    walk (a host ring of 2, spill and mutes), the FIFO into a host
    consumer, and helloworld (host actors only)."""
    from _torch_programs import new_runtime
    if world == "hello":
        rt = new_runtime(ponyc_tpu_torch, dict(msg_words=1, **PATHS[path]),
                         device)
        rt.declare(TT.Hello, 1).start()
        h = rt.spawn(TT.Hello)
        rt.send(h, TT.Hello.create, 0)
        return rt.run(), (), [h], rt
    if world == "fifo":
        TT.host_logs.clear()
        rt = new_runtime(ponyc_tpu_torch, dict(
            mailbox_cap=2, batch=1, msg_words=2, max_sends=2,
            spill_cap=2048, inject_slots=16, **PATHS[path]), device)
        rt.declare(TT.HProd, 6).declare(TT.HCons, 1).start()
        sink = rt.spawn(TT.HCons)
        pids = rt.spawn_many(TT.HProd, 6, sink=np.full(6, sink),
                             edge=np.arange(6, dtype=np.int32))
        rt.bulk_send(pids, TT.HProd.produce, np.full(6, 40, np.int32))
        code = rt.run(max_steps=200_000)
        return code, (TT.HProd,), [sink], rt
    rng = np.random.default_rng(31)
    w_nxt = rng.integers(0, 20, 20)
    rt = new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=2, batch=1, msg_words=2, max_sends=2, spill_cap=512,
        inject_slots=16, **PATHS[path]), device)
    rt.declare(TT.WalkerH, 20).declare(TT.HostLog, 1).start()
    wids = rt.spawn_many(TT.WalkerH, 20)
    log = rt.spawn(TT.HostLog)
    rt.set_fields(TT.WalkerH, wids, nxt=wids[w_nxt], log=np.full(20, log))
    for _ in range(8):
        rt.send(int(wids[rng.integers(0, 20)]), TT.WalkerH.step,
                int(rng.integers(1, 12)))
    return rt.run(max_steps=100_000), (TT.WalkerH,), [log], rt


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("world", ["reporting", "fifo", "hello"])
def test_host_worlds_card_match_cpu(world, path):
    """Host cohorts on the card against the CPU, on each path: exit code,
    counters, ticks, device fields, host state, host counters and (the
    FIFO world) the host's arrival order."""
    _need_cuda()
    out = []
    for device in ("cuda", "cpu"):
        code, types, hosts, rt = _host_world(world, path, device)
        out.append((code, counters(rt), rt.steps_run, dict(rt.totals),
                    [rt.state_of(int(h)) for h in hosts],
                    {t.__name__: {k: v.tolist() for k, v in
                                  rt.cohort_state(t).items()}
                     for t in types},
                    {e: list(v) for e, v in TT.host_logs.items()}))
    assert out[0] == out[1]
    assert out[0][3]["host_processed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("world", ["chain", "records", "pipeline"])
def test_blob_worlds_card_match_cpu(world, path):
    """The blob pool on the card against the CPU, on each path: the blob
    chain (its oracle checked by run_blob_chain), the records model (its
    oracle checked by run_records) and the blob pipeline; fields,
    counters, ticks and the pool's arrays equal; the path's kernel
    launched (the drain under pallas_fused: the blob cohorts take the
    plain dispatch)."""
    _need_cuda()
    from ponyc_tpu_torch.models import records
    from _torch_programs import (blob_world, define_blobs, run_blob_chain,
                                 run_blob_pipeline)
    tb = define_blobs(ponyc_tpu_torch)
    out = []
    for device in ("cuda", "cpu"):
        before = _launched()
        if world == "chain":
            rt = run_blob_chain(ponyc_tpu_torch, tb, 77, dict(
                mailbox_cap=2, batch=1, max_sends=1, spill_cap=1024,
                inject_slots=16, **PATHS[path]), n=64, n_starts=12,
                device=device)
            types = (tb.BlobWalker,)
        elif world == "records":
            rt, _st = records.run_records(
                8, 6, opts=records.options(8, tuning_cache="off",
                                           **PATHS[path]), device=device)
            types = (records.RecSource, records.RecWorker, records.RecSink)
        else:
            rt, _r, _b = run_blob_pipeline(ponyc_tpu_torch, tb,
                                           device=device, **PATHS[path])
            types = (tb.Tokenizer, tb.Reviewer)
        moved = [b - a for a, b in zip(before, _launched())]
        out.append(blob_world(rt, *types))
        if device == "cuda":
            k = 0 if path == "fused" and world != "records" \
                else list(PATHS).index(path)
            assert moved[k] > 0, moved
    assert out[0] == out[1]
    assert out[0]["counters"]["n_blob_alloc"] > 0


def _telemetry_world(world, path, device, csv):
    """A telemetry world of tests/test_torch_telemetry_kernel.py on
    `device`: the walkers at analysis 1, and traced with both rings too
    small; the spawn/destroy churn traced; errors beside a host relay,
    traced."""
    from _torch_programs import churn, define_telemetry, new_runtime
    tl = define_telemetry(ponyc_tpu_torch)
    traced = dict(analysis=3, trace_sample=1, analysis_path=csv)
    if world.startswith("walkers"):
        kw = dict(analysis=1) if world == "walkers-a1" else dict(
            traced, analysis_events=16, trace_slots=16)
        rt = build_walkers(ponyc_tpu_torch, TT, 7, n_seeds=30, mailbox_cap=2,
                           batch=1, msg_words=1, max_sends=2, spill_cap=512,
                           inject_slots=16, quiesce_interval=8,
                           device=device, **PATHS[path], **kw)
        rt.run(max_steps=120)
        return rt, (TT.Walker, TT.Splitter)
    if world == "churn":
        rt = churn(ponyc_tpu_torch, TT, 5, device=device,
                   quiesce_interval=4, **PATHS[path], **traced)[0]
        rt.run(max_steps=400)
        return rt, (TT.Relay,)
    rt = new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=4, batch=2, max_sends=2, msg_words=2, spill_cap=64,
        inject_slots=16, quiesce_interval=4, **PATHS[path], **traced),
        device)
    rt.declare(tl.Boss, 1).declare(tl.Child, 4).declare(tl.Sink, 1) \
      .declare(tl.HostRelay, 1).start()
    boss = rt.spawn(tl.Boss)
    hr = rt.spawn(tl.HostRelay, out=rt.spawn(tl.Sink))
    rt.send(boss, tl.Boss.make, 1)
    rt.send(hr, tl.HostRelay.relay, 5)
    rt.run(max_steps=200)
    return rt, (tl.Child, tl.Sink)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("world", ["walkers-a1", "walkers-overflow", "churn",
                                   "errors-host"])
def test_telemetry_worlds_card_match_cpu(world, path, tmp_path):
    """Analysis and tracing on the card against the CPU, on each path:
    profile(), the event ring, spans and traces (their drops), counters,
    ticks and fields equal; the path's kernel launched."""
    _need_cuda()
    from _torch_programs import telemetry_of
    out = []
    for device in ("cuda", "cpu"):
        before = _launched()
        rt, types = _telemetry_world(world, path, device,
                                     str(tmp_path / f"{device}.csv"))
        moved = [b - a for a, b in zip(before, _launched())]
        out.append((telemetry_of(rt), {
            t.__name__: {k: v.tolist() for k, v in rt.cohort_state(t).items()}
            for t in types}))
        rt.stop()
        if device == "cuda":
            assert moved[list(PATHS).index(path)] > 0, moved
    assert out[0] == out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["plain", "fused"])
def test_cosort_walkers_card_matches_cpu(path):
    """delivery="cosort" on the card (the drain or the fused kernel) on
    the spill/mute world against the CPU: fields, counters, ticks and the
    carried plan state (cosort's placeholders) equal."""
    _need_cuda()
    kw = dict(mailbox_cap=4, batch=2, msg_words=1, max_sends=2,
              spill_cap=512, inject_slots=16, delivery="cosort",
              **PATHS[path])
    out = []
    for device in ("cuda", "cpu"):
        rt = build_walkers(ponyc_tpu_torch, TT, 41, n_seeds=30,
                           device=device, **kw)
        rt.run(max_steps=2000)
        out.append((counters(rt), rt.steps_run,
                    {k: v.tolist() for k, v in
                     rt.cohort_state(TT.Walker).items()},
                    [getattr(rt.state, f).tolist() for f in (
                        "plan_key", "plan_perm", "plan_bounds")]))
    assert out[0] == out[1] and out[0][0]["n_rejected"] > 0


@pytest.mark.cuda
def test_tuner_calibrates_then_starts_from_cache(tmp_path):
    """delivery="auto", pallas_fused="auto" on ubench at 2^14 pingers:
    the first start races every variant on the card (the window kernel
    among them), each with a number; the decision is `decide`'s; the
    state is untouched; a second start on the same layout reads the
    cache and launches no kernel; the run equals one fixed to the
    winner."""
    from ponyc_tpu_torch import tuning
    from ponyc_tpu_torch.models import ubench
    _need_cuda()
    kw = dict(mailbox_cap=4, batch=4, max_sends=1, msg_words=1,
              spill_cap=256, inject_slots=8, tuning_cache=str(tmp_path))
    auto = RuntimeOptions(delivery="auto", pallas_fused="auto", **kw)
    rt = ponyc_tpu_torch.Runtime(auto)
    rt.declare(ubench.Pinger, 1 << 14).start()
    assert not bool(rt.state.alive.any())
    assert int(rt.state.tail.abs().sum()) == 0
    assert int(rt.state.dspill_count.sum()) == 0
    assert rt.counter("n_processed") == 0
    assert not any(bool(b.any()) for b in rt.state.buf.values())
    rec = rt.tuning_record
    assert rec["source"] == "calibrated"
    assert rec["variants"] == ["plan", "cosort", "pallas_mega",
                               "plan+fused", "cosort+fused"]
    assert all(isinstance(rec["table"][v], float) for v in rec["variants"])
    assert rec["detail"]["errors"] == {}
    assert rec["winner"] == tuning.decide(rec["table"],
                                          order=rec["variants"])
    before = _launched()
    rt2, ids2 = ubench.build(1 << 14, auto, pings=4)
    assert _launched() == before
    assert rt2.tuning_record["source"] == "cache"
    assert rt2.opts.delivery == rt.opts.delivery
    fixed = RuntimeOptions(**{**kw, **rec["chosen"], "tuning_cache": "off"})
    rt3, ids3 = ubench.build(1 << 14, fixed, pings=4)
    nums = []
    for r, i in ((rt2, ids2), (rt3, ids3)):
        ubench.seed_all(r, i, hops=40, pings=4)
        code = r.run(max_steps=64)
        nums.append((code, r.steps_run, counters(r),
                     r.cohort_state(ubench.Pinger)["pings"].tolist()))
    assert nums[0] == nums[1]

"""The host API that metrics, `top` and the stdlib read, on the port and
against the JAX package: apply_backpressure/release_backpressure on the
plain tick, pallas_fused and delivery="pallas_mega" (on the CPU the last
two run their plain versions; tests/test_stdlib_extra.py's case),
queue_depth, request_exit, total_memory's keys, and run_loop_stats'
counts for one program.

Everything runs on the CPU (device="cpu").
"""

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch

from _torch_programs import (build_walkers, define, define_ops,
                             new_runtime)

PKGS = (ponyc_tpu, ponyc_tpu_torch)
MODES = {"plain": {}, "fused": {"pallas_fused": True},
         "mega": {"delivery": "pallas_mega"}}


def _bp_build(pkg, O, items=64, **kw):
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=2, msg_words=1,
                               max_sends=2, spill_cap=128, inject_slots=8,
                               quiesce_interval=1, **kw))
    rt.declare(O.Producer, 1).declare(O.Sink, 1)
    rt.start()
    sink = rt.spawn(O.Sink)
    prod = rt.spawn(O.Producer, sink=sink)
    rt.send(prod, O.Producer.produce, items)
    return rt, prod, sink


def _muted(rt, i):
    m = rt.state.muted
    return bool(np.asarray(m.cpu() if hasattr(m, "cpu") else m)[i])


def _bp_trace(pkg, mode):
    """tests/test_stdlib_extra.py's sequence: three quiet ticks, pressure
    on the sink, three ticks, release, three ticks, then run to the end.
    Returns what each stage shows and the final total."""
    O = define_ops(pkg)
    rt, prod, sink = _bp_build(pkg, O, **MODES[mode])
    out = []
    rt.run(max_steps=4)
    out.append(("quiet", _muted(rt, prod)))
    rt.apply_backpressure([sink])
    rt.run(max_steps=3)
    occ = int(rt.queue_depth(sink))
    out.append(("pressured", _muted(rt, prod), occ <= rt.opts.overload_occ,
                rt.steps_run))
    rt.release_backpressure([sink])
    rt.run(max_steps=3)
    out.append(("released", _muted(rt, prod)))
    assert rt.run() == 0
    out.append(("total", rt.state_of(sink)["total"], rt.steps_run))
    rt.stop()
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_apply_backpressure_mutes_sender_and_release_recovers(mode):
    port = _bp_trace(ponyc_tpu_torch, mode)
    assert port[0] == ("quiet", False)
    assert port[1][:3] == ("pressured", True, True), \
        "the sender must mute on a send to a pressured receiver, " \
        "with the receiver's mailbox under the occupancy threshold"
    assert port[2] == ("released", False)
    assert port[3][:2] == ("total", 64)
    assert port == _bp_trace(ponyc_tpu, "plain")


def test_backpressure_raises_the_pressure_bit():
    O = define_ops(ponyc_tpu_torch)
    rt, _prod, sink = _bp_build(ponyc_tpu_torch, O)
    fkey = rt._freelist_key
    rt.apply_backpressure([sink])
    assert int(rt.state.world_bits[0]) & 1
    assert bool(rt.state.pressured[sink])
    assert rt._freelist_key == fkey         # a flag frees no slot
    rt.release_backpressure([sink])
    assert not bool(rt.state.pressured[sink])
    rt.stop()


def _depths(pkg):
    O = define_ops(pkg)
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=1, msg_words=1,
                               max_sends=2, inject_slots=8))
    rt.declare(O.Sink, 4).start()
    ids = rt.spawn_many(O.Sink, 4)
    rt.bulk_send(ids[:3], O.Sink.consume, np.array([1, 2, 3]))
    rt.bulk_send(ids[1:3], O.Sink.consume, np.array([4, 5]))
    rt.send(int(ids[3]), O.Sink.consume, 6)  # queued on the host
    before = [rt.queue_depth(int(i)) for i in ids]
    rt.run()
    after = [rt.queue_depth(int(i)) for i in ids]
    totals = [rt.state_of(int(i))["total"] for i in ids]
    rt.stop()
    return before, after, totals


def test_queue_depth_matches_reference():
    port = _depths(ponyc_tpu_torch)
    assert port == ([1, 2, 2, 0], [0, 0, 0, 0], [1, 6, 8, 6])
    assert port == _depths(ponyc_tpu)


def _exit_early(pkg):
    T = define(pkg)
    rt = new_runtime(pkg, dict(mailbox_cap=8, batch=1, msg_words=1,
                               max_sends=1, inject_slots=8,
                               quiesce_interval=4))
    rt.declare(T.RingNode, 4).start()
    ids = rt.spawn_many(T.RingNode, 4)
    rt.set_fields(T.RingNode, ids, next_ref=np.roll(ids, -1))
    rt.send(int(ids[0]), T.RingNode.token, 100)
    rt.request_exit(7)                      # honoured by the next run()
    code = rt.run()
    first = (code, rt.steps_run)
    rt.request_exit(0)
    code2 = rt.run()
    return first, (code2, rt.steps_run), rt.total_memory()


def test_request_exit_matches_reference():
    (c1, s1), (c2, s2), mem = _exit_early(ponyc_tpu_torch)
    assert c1 == 7 and 0 < s1 <= 4           # one window, then the exit
    assert c2 == 0 and s2 == s1 + 4
    (r1, r2, ref_mem) = _exit_early(ponyc_tpu)
    assert ((c1, s1), (c2, s2)) == (r1, r2)
    assert set(mem) == set(ref_mem) == {
        "host_rss_bytes", "device_state_bytes", "pool_live_blocks",
        "pool_recycled_blocks"}
    assert mem["host_rss_bytes"] > 0 and mem["device_state_bytes"] > 0
    assert mem["pool_live_blocks"] == mem["pool_recycled_blocks"] == 0


def test_total_memory_counts_the_state():
    T = define(ponyc_tpu_torch)
    rt = new_runtime(ponyc_tpu_torch, dict(msg_words=1, mailbox_cap=8))
    rt.declare(T.RingNode, 64).start()
    st = rt.state
    want = sum(t.nbytes for t in (st.head, st.tail, st.alive))
    want += st.buf["RingNode"].nbytes + sum(
        t.nbytes for t in st.type_state["RingNode"].values())
    got = rt.total_memory()["device_state_bytes"]
    assert got > want                        # those and every other leaf
    rt.stop()


@pytest.mark.parametrize("mode", ["plain", "mega"])
def test_run_loop_stats_match_reference(mode):
    stats = {}
    for pkg in PKGS:
        T = define(pkg)
        rt = build_walkers(pkg, T, seed=5, quiesce_interval=4,
                           **MODES[mode])
        rt.run()
        rl = rt.run_loop_stats()
        stats[pkg.__name__] = {k: rl[k] for k in (
            "windows", "pipelined_dispatches", "sync_dispatches",
            "injects_requeued", "window_hist")}
        assert rl["host_gap_us_total"] >= 0 and rl["controller"]
        rt.stop()
    port = stats["ponyc_tpu_torch"]
    assert port["windows"] > 2 and port["pipelined_dispatches"] > 0
    assert sum(port["window_hist"]) == port["windows"]
    assert port == stats["ponyc_tpu"]

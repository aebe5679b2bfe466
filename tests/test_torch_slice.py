"""The PyTorch port's main path end to end against the JAX package, from
one program definition (tests/_torch_programs.py): message-ubench, the
token ring, the randomized Walker graph with a tiny mailbox that forces
spill → mute → unmute, the Mixer program that uses every effect plane,
and the per-edge FIFO stamps of tests/test_fifo.py (also under
delivery="cosort"). Each case compares
every cohort field, the runtime counters, the exit code and the ticks
run. All compared values are integers: the tolerance is exact equality.
The port runs on the CPU here (`device="cpu"`)."""

import functools

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch

from _torch_programs import (IN_SLOTS, build_fifo, build_mixers,
                             build_walkers, counters, define, new_runtime)

JT, TT = define(ponyc_tpu), define(ponyc_tpu_torch)


def _same_world(jrt, trt, types, jcode, tcode):
    assert tcode == jcode
    assert trt.steps_run == jrt.steps_run
    assert counters(trt) == counters(jrt)
    for jtype, ttype in types:
        js, ts = jrt.cohort_state(jtype), trt.cohort_state(ttype)
        assert sorted(js) == sorted(ts)
        for f in js:
            np.testing.assert_array_equal(ts[f], np.asarray(js[f]),
                                          err_msg=f"{jtype.__name__}.{f}")
    np.testing.assert_array_equal(trt.state.muted.numpy(),
                                  np.asarray(jrt.state.muted))
    # Every table stays in its planar, contiguous layout (the CUDA drain
    # kernel refuses anything else).
    for name, buf in trt.state.buf.items():
        assert buf.is_contiguous(), name
    assert trt.state.head.is_contiguous()


def _ubench(pkg, T, n, pings, ticks):
    rt = new_runtime(pkg, dict(mailbox_cap=4, batch=4, max_sends=1,
                               msg_words=1, spill_cap=64, inject_slots=8))
    rt.declare(T.Pinger, n)
    rt.start()
    ids = rt.spawn_many(T.Pinger, n)
    order = np.random.default_rng(0).permutation(n)
    nxt = np.empty(n, np.int64)
    nxt[order] = ids[np.roll(order, -1)]
    rt.set_fields(T.Pinger, ids, next_ref=nxt)
    for _ in range(pings):
        rt.bulk_send(ids, T.Pinger.ping, np.full(n, 1 << 30, np.int64))
    code = rt.run(max_steps=ticks)
    return rt, code


@pytest.mark.parametrize("n,pings", [(64, 1), (64, 4), (256, 1), (256, 4)])
def test_ubench_matches_jax(n, pings):
    ticks = 40
    jrt, jc = _ubench(ponyc_tpu, JT, n, pings, ticks)
    trt, tc = _ubench(ponyc_tpu_torch, TT, n, pings, ticks)
    _same_world(jrt, trt, [(JT.Pinger, TT.Pinger)], jc, tc)
    assert trt.counter("n_processed") == n * pings * ticks


@pytest.mark.parametrize("jax_pallas", [False, True])
def test_ring_matches_jax(jax_pallas):
    okw = dict(mailbox_cap=8, batch=1, max_sends=1, msg_words=1,
               spill_cap=128, inject_slots=8)
    res = {}
    for pkg, T in ((ponyc_tpu, JT), (ponyc_tpu_torch, TT)):
        rt = new_runtime(pkg, dict(okw, pallas=jax_pallas))
        rt.declare(T.RingNode, 128)
        rt.start()
        ids = rt.spawn_many(T.RingNode, 128)
        rt.set_fields(T.RingNode, ids, next_ref=np.roll(ids, -1))
        rt.send(int(ids[0]), T.RingNode.token, 300)
        res[pkg.__name__] = (rt, rt.run())
    (jrt, jc), (trt, tc) = res["ponyc_tpu"], res["ponyc_tpu_torch"]
    _same_world(jrt, trt, [(JT.RingNode, TT.RingNode)], jc, tc)
    assert tc == 0 and trt.cohort_state(TT.RingNode)["passes"].sum() == 300


def test_ring_enqueues_only_ticks_that_run():
    """On the CPU the window reads each tick's predicate directly, so no
    tick is enqueued that does not run: ticks_enqueued == steps_run, and
    each enqueued tick drains the one cohort once."""
    from ponyc_tpu_torch.models import ring
    opts = ponyc_tpu_torch.RuntimeOptions(
        mailbox_cap=8, batch=1, max_sends=1, msg_words=1, spill_cap=128,
        inject_slots=8, tuning_cache="off")
    rt, ids = ring.build(64, opts, device="cpu")
    rt.send(int(ids[0]), ring.RingNode.token, 100)
    assert rt.run() == 0
    assert rt.ticks_enqueued == rt.steps_run == 101


@pytest.mark.parametrize("seed", [7, 23])
def test_walker_spill_mute_matches_jax(seed):
    okw = dict(mailbox_cap=4, batch=1, msg_words=1, max_sends=2,
               spill_cap=512, inject_slots=16)
    jrt = build_walkers(ponyc_tpu, JT, seed, n_seeds=30, **okw)
    trt = build_walkers(ponyc_tpu_torch, TT, seed, n_seeds=30, **okw)
    jc, tc = jrt.run(max_steps=100_000), trt.run(max_steps=100_000)
    _same_world(jrt, trt, [(JT.Walker, TT.Walker),
                           (JT.Splitter, TT.Splitter)], jc, tc)
    # The tiny mailboxes really drove the pressure machinery, and the
    # world ended quiescent and unmuted.
    assert trt.counter("n_rejected") > 0 and trt.counter("n_mutes") > 0
    assert not trt.state.muted.any()


def test_mixer_effect_planes_match_jax():
    okw = dict(mailbox_cap=4, spill_cap=256, inject_slots=32)
    jrt = build_mixers(ponyc_tpu, JT, 11, **okw)
    trt = build_mixers(ponyc_tpu_torch, TT, 11, **okw)
    jc, tc = jrt.run(max_steps=5000), trt.run(max_steps=5000)
    _same_world(jrt, trt, [(JT.Mixer, TT.Mixer)], jc, tc)
    np.testing.assert_array_equal(trt.state.last_error.numpy(),
                                  np.asarray(jrt.state.last_error))
    np.testing.assert_array_equal(trt.state.alive.numpy(),
                                  np.asarray(jrt.state.alive))


@pytest.mark.parametrize("okw", [
    dict(mailbox_cap=2, batch=1, spill_cap=1024, inject_slots=64,
         debug_checks=True),
    dict(mailbox_cap=4, batch=2, spill_cap=1024, inject_slots=64,
         mute_age_limit=2),
], ids=["tiny-cap", "aggressive-aging"])
def test_fifo_stamps_match_jax(okw):
    items, n_cons = 40, 6
    jrt = build_fifo(ponyc_tpu, JT, 3, n_cons=n_cons, items=items, **okw)
    trt = build_fifo(ponyc_tpu_torch, TT, 3, n_cons=n_cons, items=items,
                     **okw)
    jc, tc = jrt.run(max_steps=100_000), trt.run(max_steps=100_000)
    _same_world(jrt, trt, [(JT.Prod, TT.Prod), (JT.Cons, TT.Cons)], jc,
                tc)
    st = trt.cohort_state(TT.Cons)
    assert not st["bad"].any(), "FIFO violation"
    for s in range(IN_SLOTS):
        assert (st[f"last{s}"] == items - 1).all()
    assert (st["got"] == IN_SLOTS * items).all()




@functools.lru_cache(maxsize=None)
def _jax_fifo_cosort():
    """The JAX package's cosort FIFO run (and its exit code), once for
    both of the port's paths."""
    jrt = build_fifo(ponyc_tpu, JT, 5, n_cons=6, items=40, mailbox_cap=4,
                     batch=2, max_sends=3, spill_cap=2048, inject_slots=16,
                     delivery="cosort")
    return jrt, jrt.run(max_steps=100_000)


@pytest.mark.parametrize("path", [{}, dict(pallas_fused=True)],
                         ids=["plain", "fused"])
def test_fifo_stamps_under_cosort_match_jax(path):
    """tests/test_fifo.py's cosort configuration: per-edge FIFO stamps,
    fields, counters, ticks and the carried plan state (cosort's
    placeholders) equal to the JAX package's cosort run."""
    okw = dict(mailbox_cap=4, batch=2, max_sends=3, spill_cap=2048,
               inject_slots=16, delivery="cosort")
    items, n_cons = 40, 6
    jrt, jc = _jax_fifo_cosort()
    trt = build_fifo(ponyc_tpu_torch, TT, 5, n_cons=n_cons, items=items,
                     **okw, **path)
    tc = trt.run(max_steps=100_000)
    _same_world(jrt, trt, [(JT.Prod, TT.Prod), (JT.Cons, TT.Cons)], jc,
                tc)
    for f in ("plan_key", "plan_perm", "plan_bounds"):
        np.testing.assert_array_equal(getattr(trt.state, f).numpy(),
                                      np.asarray(getattr(jrt.state, f)))
    st = trt.cohort_state(TT.Cons)
    assert not st["bad"].any(), "FIFO violation"
    for s in range(IN_SLOTS):
        assert (st[f"last{s}"] == items - 1).all()
    assert (st["got"] == IN_SLOTS * items).all()


def test_fifo_stamps_under_auto_match_jax():
    """Every "auto" field (delivery, pallas, pallas_fused) resolved by the
    tuner at start(): per-edge FIFO stamps, fields, counters and ticks
    equal the JAX package's plan run (whichever formulation won)."""
    okw = dict(mailbox_cap=4, batch=2, max_sends=3, spill_cap=2048,
               inject_slots=16, tuning_ticks=2, tuning_repeats=1)
    items, n_cons = 40, 6
    jrt = build_fifo(ponyc_tpu, JT, 5, n_cons=n_cons, items=items, **okw)
    trt = build_fifo(ponyc_tpu_torch, TT, 5, n_cons=n_cons, items=items,
                     delivery="auto", pallas="auto", pallas_fused="auto",
                     **okw)
    assert trt.tuning_record["source"] == "calibrated"
    assert set(trt.tuning_record["variants"]) == {
        "plan", "cosort", "plan+fused", "cosort+fused"}
    jc, tc = jrt.run(max_steps=100_000), trt.run(max_steps=100_000)
    _same_world(jrt, trt, [(JT.Prod, TT.Prod), (JT.Cons, TT.Cons)], jc,
                tc)
    assert not trt.cohort_state(TT.Cons)["bad"].any()


def test_quiesce_window_cache_round_trip(tmp_path):
    """quiesce_interval="auto": a run that converges writes its window to
    the tuning cache and the next start of the same layout begins there
    (ponyc_tpu_torch/tuning.py)."""
    okw = dict(mailbox_cap=4, batch=4, max_sends=1, msg_words=1,
               spill_cap=64, inject_slots=8, quiesce_interval_max=128)

    def start():
        rt = ponyc_tpu_torch.Runtime(ponyc_tpu_torch.RuntimeOptions(
            tuning_cache=str(tmp_path), **okw), device="cpu")
        rt.declare(TT.Pinger, 64)
        rt.start()
        return rt

    rt = start()
    assert rt._controller.window == 64              # the cold default
    ids = rt.spawn_many(TT.Pinger, 64)
    rt.set_fields(TT.Pinger, ids, next_ref=np.roll(ids, -1))
    rt.bulk_send(ids, TT.Pinger.ping, np.full(64, 1 << 30, np.int64))
    rt.run(max_steps=1000)      # windows 64, 128, 128, ...: steady at 128
    assert rt._controller.state == "steady"
    assert start()._controller.window == rt._controller.window == 128

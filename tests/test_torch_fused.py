"""The port's fused dispatch (`pallas_fused=True`) against the JAX
package's fused Pallas kernel, which runs in interpret mode on the CPU as
tests/test_fused_dispatch.py runs it. One program definition serves both
packages (tests/_torch_programs.py); the port runs on the CPU, where the
fused dispatch takes its plain version (the kernel itself is held against
that on the card by chip_smoke.py and tests/test_torch_cuda.py).

Programs: message-ubench 256 x 4, the yield/exit, destroy, error_int and
three-behaviour TriF worlds of tests/test_fused_dispatch.py, and the Mixer
world that uses every effect plane. Compared: every cohort field, the
runtime counters, exit codes, ticks run, liveness and last error codes.
All compared values are integers: the tolerance is exact equality.
"""

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch

from _torch_programs import (CORPUS, build_mixers, counters, define,
                             new_runtime, run_corpus)

JT, TT = define(ponyc_tpu), define(ponyc_tpu_torch)


def _ubench(pkg, T, n=256, pings=4, ticks=12):
    rt = new_runtime(pkg, dict(mailbox_cap=4, batch=4, max_sends=1,
                               msg_words=1, spill_cap=256, inject_slots=8,
                               pallas_fused=True))
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


def test_ubench_fused_matches_jax():
    jrt, jc = _ubench(ponyc_tpu, JT)
    trt, tc = _ubench(ponyc_tpu_torch, TT)
    assert tc == jc and trt.steps_run == jrt.steps_run
    assert counters(trt) == counters(jrt)
    assert trt.counter("n_processed") == 256 * 4 * 12
    js, ts = jrt.cohort_state(JT.Pinger), trt.cohort_state(TT.Pinger)
    for f in js:
        np.testing.assert_array_equal(ts[f], np.asarray(js[f]), err_msg=f)


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_fused_matches_jax(name):
    j = run_corpus(ponyc_tpu, JT, name, pallas_fused=True)
    t = run_corpus(ponyc_tpu_torch, TT, name, pallas_fused=True)
    assert t == j


def test_corpus_outcomes():
    """The corpus worlds end as tests/test_fused_dispatch.py expects."""
    r = run_corpus(ponyc_tpu_torch, TT, "yield_exit", pallas_fused=True)
    assert r["codes"] == [0, 7] and r["fields"]["Yielder"]["n"][0] == 6
    r = run_corpus(ponyc_tpu_torch, TT, "trif", pallas_fused=True)
    assert r["fields"]["TriF"]["count"] == [4, 4, 2]
    r = run_corpus(ponyc_tpu_torch, TT, "destroy", pallas_fused=True)
    assert sum(r["alive"][:4]) == 2
    r = run_corpus(ponyc_tpu_torch, TT, "errors", pallas_fused=True)
    assert r["last_error"][:2] == [42, 0]


def test_mixers_fused_match_jax():
    res = {}
    for pkg, T in ((ponyc_tpu, JT), (ponyc_tpu_torch, TT)):
        rt = build_mixers(pkg, T, 5, pallas_fused=True)
        code = rt.run(max_steps=100_000)
        res[pkg.__name__] = (code, rt.steps_run, counters(rt),
                             {f: np.asarray(v).tolist() for f, v in
                              rt.cohort_state(T.Mixer).items()},
                             np.asarray(rt.state.last_error).tolist())
    assert res["ponyc_tpu_torch"] == res["ponyc_tpu"]

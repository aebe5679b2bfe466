"""The mixed and nbody models of the port against the JAX package's, both
with the fused dispatch (`pallas_fused=True`; the JAX kernel in interpret
mode, the port's plain version on the CPU), from the same seeds.

- mixed: 256 workers, 4 behaviours, 4 dependent float rounds a body, both
  seedings (every token on step0, and every behaviour id every tick).
  `done` and the counters are integers, compared exactly; the F32 `acc`
  within rtol 1e-6, as tests/test_fused_dispatch.py compares floats.
- nbody: one all-pairs round at 96 bodies. `seen` exactly; `ax`/`ay`
  within rtol 1e-6 of the JAX package, with an absolute floor of 1e-6 of
  the largest acceleration: XLA:CPU and torch round the float32 body and
  its 95-term sums differently, so a component that cancels to near zero
  differs by up to 2.4e-7 on accelerations up to 1.6 (1.5e-7 of the
  largest). And within the JAX package's own oracle tolerance
  (tests/test_models.py: rtol 2e-4, atol 2e-5) of `reference_accels`.
"""

import numpy as np
import pytest

import torch

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu import RuntimeOptions as JOpts
from ponyc_tpu.models import fanin as jfanin
from ponyc_tpu.models import gups as jgups
from ponyc_tpu.models import mixed as jmixed
from ponyc_tpu.models import nbody as jnbody
from ponyc_tpu_torch import RuntimeOptions as TOpts
from ponyc_tpu_torch.models import fanin as tfanin
from ponyc_tpu_torch.models import gups as tgups
from ponyc_tpu_torch.models import mixed as tmixed
from ponyc_tpu_torch.models import nbody as tnbody

from _torch_programs import counters

MIXED_KW = dict(mailbox_cap=4, batch=1, max_sends=1, msg_words=1,
                spill_cap=256, inject_slots=8, pallas_fused=True,
                tuning_cache="off")


@pytest.mark.parametrize("mix", [False, True])
def test_mixed_fused_matches_jax(mix):
    n, b, ticks = 256, 4, 10
    jrt, jids, jwt = jmixed.build(n, b, JOpts(**MIXED_KW), work=4)
    jmixed.seed_all(jrt, jids, jwt, hops=1 << 30, mix=mix)
    jrt.run(max_steps=ticks)
    trt, tids, twt = tmixed.build(n, b, TOpts(**MIXED_KW), work=4,
                                  device="cpu")
    tmixed.seed_all(trt, tids, twt, hops=1 << 30, mix=mix)
    trt.run(max_steps=ticks)
    assert trt.steps_run == jrt.steps_run == ticks
    assert counters(trt) == counters(jrt)
    assert trt.counter("n_processed") == n * ticks
    js, ts = jrt.cohort_state(jwt), trt.cohort_state(twt)
    np.testing.assert_array_equal(ts["done"], js["done"])
    np.testing.assert_array_equal(ts["next_ref"], js["next_ref"])
    np.testing.assert_allclose(ts["acc"], js["acc"], rtol=1e-6)


def test_nbody_fused_matches_jax_and_oracle():
    n = 96
    kw = dict(mailbox_cap=16, batch=4, max_sends=1, msg_words=4,
              spill_cap=1024, pallas_fused=True, tuning_cache="off")
    jrt = jnbody.run_round(n, JOpts(**kw))
    trt = tnbody.run_round(n, TOpts(**kw), device="cpu")
    js, ts = jrt.cohort_state(jnbody.Body), trt.cohort_state(tnbody.Body)
    assert (ts["seen"] == n - 1).all()
    np.testing.assert_array_equal(ts["seen"], js["seen"])
    assert trt.steps_run == jrt.steps_run
    for k in ("ax", "ay"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(js[k]).max())
    ax, ay = tnbody.reference_accels(ts["x"], ts["y"], ts["m"])
    np.testing.assert_allclose(ts["ax"], ax, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ts["ay"], ay, rtol=2e-4, atol=2e-5)


# ---- fan-in and GUPS (tests/test_models.py, tests/test_delivery_modes.py)

FANIN = {
    # tests/test_models.py: fanin.run's own options, and a tight mailbox
    "default": (16, 32, dict(mailbox_cap=8, batch=2, msg_words=1,
                             spill_cap=256)),
    "tight": (16, 16, dict(mailbox_cap=4, batch=1, msg_words=1,
                           spill_cap=128)),
    # tests/test_delivery_modes.py's fan-in under backpressure
    "pressure": (24, 30, dict(mailbox_cap=8, batch=2, msg_words=1,
                              max_sends=2, spill_cap=512, inject_slots=16)),
}


def _fanin(pkg, case, **kw):
    n, items, okw = FANIN[case]
    opts = pkg.RuntimeOptions(tuning_cache="off", **okw, **kw)
    if pkg is ponyc_tpu_torch:
        rt = tfanin.run(n, items, opts, device="cpu")
    else:
        rt = jfanin.run(n, items, opts)
    mod = tfanin if pkg is ponyc_tpu_torch else jfanin
    return {"code": rt.exit_code, "steps": rt.steps_run,
            "counters": counters(rt),
            "fields": {t.__name__: {f: np.asarray(v).tolist() for f, v in
                                    rt.cohort_state(t).items()}
                       for t in (mod.Producer, mod.Aggregator)}}


@pytest.fixture(scope="module")
def jax_fanin():
    return {case: _fanin(ponyc_tpu, case) for case in FANIN}


@pytest.mark.parametrize("case,delivery", [
    ("default", "plan"), ("tight", "plan"), ("pressure", "plan"),
    ("pressure", "cosort")])
def test_fanin_matches_jax_and_conserves(jax_fanin, case, delivery):
    """The aggregator's total is n * items (nothing lost, nothing
    duplicated), backpressure fired (mutes and rejections), and fields,
    counters, ticks and exit code equal the JAX package's (its plan run:
    cosort gives plan's fields and counters)."""
    n, items, _ = FANIN[case]
    got = _fanin(ponyc_tpu_torch, case, delivery=delivery)
    assert got == jax_fanin[case]
    assert got["fields"]["Aggregator"]["total"] == [n * items]
    assert got["counters"]["n_mutes"] > 0
    assert got["counters"]["n_rejected"] > 0
    assert got["code"] == 0
    if case == "tight":
        assert got["counters"]["n_mutes"] >= 8


def _xor_oracle(seed, n_upd, updates):
    """Replay of the updaters' xorshift32 streams (tests/test_models.py):
    the xor of every value sent."""
    x = np.asarray(np.random.default_rng(seed).integers(1, 2**31 - 1,
                                                        n_upd), np.int32)
    expect = np.int32(0)
    for _ in range(updates):
        x = (x ^ (x << 13)).astype(np.int32)
        x = (x ^ ((x >> 17) & 0x7FFF)).astype(np.int32)
        x = (x ^ (x << 5)).astype(np.int32)
        expect ^= np.bitwise_xor.reduce(x)
    return expect


def _gups(pkg, opt, **kw):
    mod = tgups if pkg is ponyc_tpu_torch else jgups
    dev = dict(device="cpu") if pkg is ponyc_tpu_torch else {}
    if opt:
        opts = pkg.RuntimeOptions(mailbox_cap=16, batch=2, msg_words=1,
                                  spill_cap=4096, tuning_cache="off", **kw)
        rt = mod.run_opt(table_size=512, n_updaters=8, ticks_each=4,
                         opts=opts, **dev)
        upd = mod.OptUpdater
    else:
        opts = pkg.RuntimeOptions(mailbox_cap=16, batch=2, msg_words=1,
                                  spill_cap=1024, tuning_cache="off", **kw)
        rt = mod.run(table_size=512, n_updaters=16, updates_each=16,
                     opts=opts, **dev)
        upd = mod.Updater
    return {"code": rt.exit_code, "steps": rt.steps_run,
            "counters": counters(rt),
            "fields": {t.__name__: {f: np.asarray(v).tolist() for f, v in
                                    rt.cohort_state(t).items()}
                       for t in (mod.TableCell, upd)}}


@pytest.fixture(scope="module")
def jax_gups():
    return {opt: _gups(ponyc_tpu, opt) for opt in (False, True)}


@pytest.mark.parametrize("delivery", ["plan", "cosort"])
@pytest.mark.parametrize("opt", [False, True], ids=["basic", "opt"])
def test_gups_matches_jax_and_xor_oracle(jax_gups, opt, delivery):
    """Random single-word xor scatter: the xor of the table equals the
    host replay of the PRNG streams, every updater finished, and the
    table, the updaters' state, counters and ticks equal the JAX
    package's (the lane arithmetic: `<<` wrapping, an arithmetic `>>`, a
    floor remainder and division by a field, a bool added to an I32)."""
    got = _gups(ponyc_tpu_torch, opt, delivery=delivery)
    assert got == jax_gups[opt]
    cells = np.asarray(got["fields"]["TableCell"]["value"], np.int32)
    if opt:
        k = tgups.OptUpdater.K
        assert (np.asarray(got["fields"]["OptUpdater"]["done"])
                == 4 * k).all()
        want = _xor_oracle(11, 8, 4 * k)
    else:
        assert (np.asarray(got["fields"]["Updater"]["done"]) == 16).all()
        want = _xor_oracle(7, 16, 16)
    assert np.bitwise_xor.reduce(cells) == want


def test_gups_opt_host_builds_equal_plain(monkeypatch):
    """GUPS's OptUpdater (8 updates a dispatch) through the host builds
    of both kernels: every fused dispatch of the run (csrc/
    fused_dispatch.cu, each cohort) and every window (csrc/
    mega_window.cu) also runs as the host build and must equal the plain
    version bit for bit; the runs end at the xor oracle."""
    from ponyc_tpu_torch.ops import _build
    from ponyc_tpu_torch.ops.fused_dispatch import FusedDispatch
    from ponyc_tpu_torch.ops.megakernel import MegaWindow
    from ponyc_tpu_torch.runtime import engine
    from test_torch_mega_host import _leaves, assert_same_window
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernels' sources")
    seen = {"fused": 0, "mega": 0}
    plain_fd, plain_mw = FusedDispatch.__call__, MegaWindow._dispatch

    def fd_checked(self, fields, buf, head, n_run, ids, resv=()):
        want = plain_fd(self, fields, buf, head, n_run, ids, resv)
        got = self.run_host(fields, buf, head, n_run, ids, resv)
        for (name, x), (_, y) in zip(_leaves(got, "out"),
                                     _leaves(want, "out")):
            assert (x is None) == (y is None), name
            assert x is None or torch.equal(x, y), (self.name, name)
        seen["fused"] += 1
        return want

    def mw_checked(self, st, it, iw, limit, force, prev_aux, probe,
                   forced):
        want = plain_mw(self, st, it, iw, limit, force, prev_aux, None,
                        forced)
        got = self.run_host(st, it, iw, limit, force,
                            engine.zero_aux("cpu") if forced else prev_aux,
                            forced=forced)
        assert_same_window(got, want, f"window {seen['mega']}")
        seen["mega"] += 1
        return want

    monkeypatch.setattr(FusedDispatch, "__call__", fd_checked)
    monkeypatch.setattr(MegaWindow, "_dispatch", mw_checked)
    k = tgups.OptUpdater.K
    for kw in (dict(pallas_fused=True), dict(delivery="pallas_mega")):
        got = _gups(ponyc_tpu_torch, True, **kw)
        cells = np.asarray(got["fields"]["TableCell"]["value"], np.int32)
        assert np.bitwise_xor.reduce(cells) == _xor_oracle(11, 8, 4 * k)
    assert seen["fused"] > 0 and seen["mega"] > 0

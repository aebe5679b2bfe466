"""The window kernel's slice of the port against the JAX package on the
CPU: the int16 + escape record codec, the `delivery="pallas_mega"` window
(the JAX package's Pallas megakernel in interpret mode, as its own tests
run it; the port's plain window, which is what the kernel holds itself to
on the card and in tests/test_torch_mega_host.py), the forced spelling,
`Runtime.run()` to quiescence, and eligibility. Worlds come from numpy
seeds; every compared value is an integer or a bool, compared exactly
(error sites by the source location they resolve to)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu import errors as jerrors
from ponyc_tpu.models import ubench as jubench
from ponyc_tpu.ops import megakernel as jmk
from ponyc_tpu.runtime import engine as jengine
from ponyc_tpu_torch import Runtime, RuntimeOptions
from ponyc_tpu_torch import errors as terrors
from ponyc_tpu_torch import interop
from ponyc_tpu_torch.models import ubench as tubench
from ponyc_tpu_torch.ops import megakernel as tmk
from ponyc_tpu_torch.runtime import engine as tengine

from _torch_programs import counters, define

TT = define(ponyc_tpu_torch)

BOUNDARY = np.array(
    [0, 1, -1, 32767, -32767, -32768, 32768, -32769, 65535, -65536,
     2**31 - 1, -(2**31), 12345, -12345], np.int32)
OKW = dict(mailbox_cap=4, batch=2, max_sends=1, msg_words=1, spill_cap=64,
           inject_slots=8, tuning_cache="off")


def _words():
    rng = np.random.default_rng(7)
    return np.concatenate([
        BOUNDARY, rng.integers(-(2**31), 2**31 - 1, 512).astype(np.int32),
        rng.integers(-1000, 1000, 512).astype(np.int32)])


# ============================================================ the codec

@pytest.mark.parametrize("words", ["boundary", "random"])
def test_codec_equals_jax_and_is_lossless(words):
    w = BOUNDARY if words == "boundary" else _words()
    jlo, jesc = (np.asarray(a) for a in jmk.pack_words(jnp.asarray(w)))
    tlo, tesc = tmk.pack_words(torch.from_numpy(w))
    nlo, nesc = tmk.pack_words_np(w)
    assert tlo.dtype == torch.int16 and tesc.dtype == torch.int32
    for lo, esc in ((tlo.numpy(), tesc.numpy()), (nlo, nesc)):
        np.testing.assert_array_equal(lo, jlo)
        np.testing.assert_array_equal(esc, jesc)
    np.testing.assert_array_equal(jmk.pack_words_np(w)[0], nlo)
    np.testing.assert_array_equal(tmk.unpack_words(tlo, tesc).numpy(), w)
    np.testing.assert_array_equal(tmk.unpack_words_np(nlo, nesc), w)
    # -32768 fits int16 but is the sentinel: it rides the escape plane.
    i = int(np.where(w == -32768)[0][0])
    assert nlo[i] == tmk.ESC and nesc[i] == -32768


def test_escape_rate_and_bytes_model_equal_jax():
    for rate in (0.0, 0.05, 0.25, 1.0):
        assert tmk.modelled_bytes_per_msg(RuntimeOptions(**OKW), rate) == \
            jmk.modelled_bytes_per_msg(ponyc_tpu.RuntimeOptions(**OKW), rate)
    w = _words()
    assert tmk.escape_rate([w, w[:7]]) == jmk.escape_rate([w, w[:7]])
    for hops in (100, 1 << 20):
        jrt, jids = jubench.build(8, ponyc_tpu.RuntimeOptions(**OKW),
                                  pings=1)
        jubench.seed_all(jrt, jids, hops=hops, pings=1)
        jrt.run(max_steps=3)
        trt, tids = tubench.build(8, RuntimeOptions(**OKW), pings=1,
                                  device="cpu")
        tubench.seed_all(trt, tids, hops=hops, pings=1)
        trt.run(max_steps=3)
        jr = jmk.escape_rate_state(jrt.state)
        assert tmk.escape_rate_state(trt.state) == jr
        assert (jr > 0) == (hops > 32767)


# ================================ the window against the JAX package's

def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return np.asarray(x)


def _same_state(tst, jst):
    got = interop.state_to_numpy(tst)
    want = _tree(dataclasses.asdict(jax.device_get(jst)))
    for name, w in want.items():
        g = got[name]
        if name == "last_error_loc":
            g = np.vectorize(terrors.error_site)(g)
            w = np.vectorize(jerrors.error_site)(w)
        if isinstance(w, dict):
            for k in w:
                for f, wv in (w[k].items() if isinstance(w[k], dict)
                              else [(None, w[k])]):
                    gv = g[k][f] if f is not None else g[k]
                    np.testing.assert_array_equal(gv, wv,
                                                  err_msg=f"{name}[{k}][{f}]")
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _pingers(hops, **kw):
    jrt, jids = jubench.build(16, ponyc_tpu.RuntimeOptions(**OKW, **kw),
                              pings=2)
    jubench.seed_all(jrt, jids, hops=hops, pings=2)
    trt, tids = tubench.build(16, RuntimeOptions(**OKW, **kw), pings=2,
                              device="cpu")
    tubench.seed_all(trt, tids, hops=hops, pings=2)
    return jrt, trt


@pytest.mark.parametrize("hops", [1000, 32800, 1 << 20])
def test_mega_window_equals_jax_mega_window(hops):
    """3 windows of 4 ticks of the 16-pinger world of
    tests/test_megakernel.py; hops >= 2^15 keep every payload in the
    escape plane."""
    jrt, trt = _pingers(hops, delivery="pallas_mega")
    window = trt._multi_g
    assert isinstance(window, tmk.MegaWindow)
    jst, tst = jrt.state, trt.state
    jk = tk = 0
    for w in range(3):
        ji, jw = jrt._drain_inject() if w == 0 else jrt._empty_inject
        ti, tw, _ = (trt._drain_inject_tracked() if w == 0
                     else (*trt._empty_inject, None))
        jst, jaux, k1 = jrt._multi(jst, ji, jw, jnp.int32(4))
        tst, taux, k2 = window(tst, ti, tw, 4, True,
                               tengine.zero_aux("cpu"))
        jk, tk = jk + int(k1), tk + int(k2)
        for f in tengine.StepAux._fields:
            assert int(getattr(taux, f)) == int(getattr(jaux, f)), f
    assert tk == jk == 12
    _same_state(tst, jst)
    if hops > 32767:
        assert tmk.escape_rate_state(tst) > 0


def test_forced_window_equals_jax():
    jrt, trt = _pingers(1000, delivery="pallas_mega")
    jst, jaux, jk = jax.jit(jengine.build_forced_window(
        jrt.program, jrt.opts))(jrt.state, *jrt._empty_inject,
                                jnp.int32(5))
    tst, taux, tk = tengine.build_forced_window(
        trt.program, trt.opts, trt._multi_g)(trt.state, *trt._empty_inject,
                                             5)
    assert int(tk) == int(jk) == 5
    _same_state(tst, jst)
    for f in tengine.StepAux._fields:
        assert int(getattr(taux, f)) == int(getattr(jaux, f)), f


def test_run_to_quiescence_equals_jax():
    res = {}
    for pkg, ub in ((ponyc_tpu, jubench), (ponyc_tpu_torch, tubench)):
        kw = dict(device="cpu") if pkg is ponyc_tpu_torch else {}
        rt, ids = ub.build(8, pkg.RuntimeOptions(**OKW,
                                                 delivery="pallas_mega"),
                           pings=1, **kw)
        ub.seed_all(rt, ids, hops=50, pings=1)
        res[pkg.__name__] = (rt.run(), rt.steps_run, counters(rt),
                             rt.cohort_state(ub.Pinger)["pings"].tolist())
    assert res["ponyc_tpu"] == res["ponyc_tpu_torch"]
    assert res["ponyc_tpu_torch"][2]["n_processed"] > 0


# ============================================================ eligibility

@pytest.mark.parametrize("kw", [dict(pallas_fused=True), dict(pallas=True)])
def test_nested_kernel_options_take_the_plain_window(kw):
    """The reference's rule (megakernel.eligible): with the drain or the
    fused kernel forced on, pallas_mega runs the plain window."""
    before = tmk.MegaWindow.launches
    rt, ids = tubench.build(16, RuntimeOptions(**OKW, delivery="pallas_mega",
                                               **kw), pings=1, device="cpu")
    assert not isinstance(rt._multi_g, tmk.MegaWindow)
    assert not tmk.eligible(rt.program, rt.opts)
    tubench.seed_all(rt, ids, hops=30, pings=1)
    assert rt.run() == 0
    assert tmk.MegaWindow.launches == before
    assert rt.counter("n_processed") == 16 * 31


def test_body_without_an_emitter_raises_at_start():
    @ponyc_tpu_torch.actor
    class Summer:
        n: ponyc_tpu_torch.I32

        @ponyc_tpu_torch.behaviour
        def go(self, st, v: ponyc_tpu_torch.I32):
            return {**st, "n": st["n"] + v.sum()}    # crosses lanes

    rt = Runtime(RuntimeOptions(tuning_cache="off", delivery="pallas_mega",
                                max_sends=1, msg_words=1), device="cpu")
    rt.declare(Summer, 4)
    with pytest.raises(NotImplementedError, match=r"Summer\.go"):
        rt.start()


def test_cpu_window_counts_no_launch():
    """On the CPU the window takes its plain version: no kernel launch
    is counted, and `enqueued` counts the plain loop's ticks."""
    before = tmk.MegaWindow.launches
    rt, ids = tubench.build(16, RuntimeOptions(**OKW, delivery="pallas_mega",
                                               quiesce_interval=4),
                            pings=1, device="cpu")
    tubench.seed_all(rt, ids, hops=1 << 30, pings=1)
    rt.run(max_steps=8)
    assert tmk.MegaWindow.launches == before
    assert rt._multi_g.windows == 0 and rt.ticks_enqueued >= 8


def test_forced_window_takes_the_runtimes_kernel():
    """Under pallas_mega the forced spelling is the window the Runtime
    built at start() (built once), and asking without it raises; other
    deliveries get the plain forced loop."""
    rt, _ids = tubench.build(16, RuntimeOptions(**OKW,
                                                delivery="pallas_mega"),
                             pings=1, device="cpu")
    assert tengine.build_forced_window(rt.program, rt.opts, rt._multi_g) \
        == rt._multi_g.forced
    with pytest.raises(ValueError, match="window=rt._multi_g"):
        tengine.build_forced_window(rt.program, rt.opts)
    rt, _ids = tubench.build(16, RuntimeOptions(**OKW), pings=1,
                             device="cpu")
    assert not isinstance(tengine.build_forced_window(rt.program, rt.opts),
                          tmk.MegaWindow)


def test_kernel_aux_layout_matches_step_aux():
    """The host build of csrc/mega_window.cu reports the aux layout its
    enums give, and it equals engine.StepAux's (MegaWindow.bind checks
    the same on the card)."""
    import ctypes
    from ponyc_tpu_torch.ops import _build
    rt, _ids = tubench.build(16, RuntimeOptions(**OKW,
                                                delivery="pallas_mega"),
                             pings=1, device="cpu")
    lib = _build.build([rt._multi_g.job(host=True)])[0]
    out = (ctypes.c_int * 64)()
    n = lib.pony_mega_aux_layout(out)
    assert list(out)[:n] == tmk.aux_layout()
    assert tmk.aux_layout()[0] == len(tengine.StepAux._fields)

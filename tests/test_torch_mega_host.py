"""The window kernel's own source (csrc/mega_window.cu), built for the
host CPU, against its plain version, the port's plain window, on every
program of the slice: each window a program's `Runtime.run()` dispatches
with delivery="pallas_mega" runs both ways from the same input, and every
state leaf, every aux value and `ticks_run` must be equal. Integers
(and bools) are compared exactly; the float fields of mixed and nbody
within rtol 1e-6 with an absolute floor of 1e-6 of the largest value, the
tolerance tests/test_torch_models.py states (the host build and torch's CPU
kernels may round a float32 body differently). The worlds are small and
made from numpy seeds. Skips where the box has no host C++ compiler."""

import dataclasses

import numpy as np
import pytest
import torch

import ponyc_tpu_torch
from ponyc_tpu_torch import RuntimeOptions
from ponyc_tpu_torch.models import mixed, nbody, ring, ubench
from ponyc_tpu_torch.ops import _build
from ponyc_tpu_torch.ops.megakernel import MegaWindow
from ponyc_tpu_torch.runtime import engine

from _torch_programs import (CORPUS, build_fifo, build_mixers,
                             build_walkers, define, run_corpus)

TT = define(ponyc_tpu_torch)
MEGA = dict(delivery="pallas_mega")         # for the shared builders
OPTS = dict(MEGA, tuning_cache="off")       # for RuntimeOptions


def _leaves(x, name):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{name}.{k}")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{name}.{f.name}")
    elif isinstance(x, tuple):
        names = getattr(x, "_fields", None) or range(len(x))
        for k, v in zip(names, x):
            yield from _leaves(v, f"{name}.{k}")
    else:
        yield name, x


def assert_same_window(got, want, where):
    for (name, x), (_, y) in zip(_leaves(got, "out"), _leaves(want, "out")):
        assert x.dtype == y.dtype and x.shape == y.shape, (where, name)
        if x.dtype == torch.float32:
            scale = float(y.abs().max()) if y.numel() else 0.0
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                       atol=1e-6 * scale,
                                       err_msg=f"{where} {name}")
        else:
            assert torch.equal(x, y), (where, name, x, y)


@pytest.fixture
def host_checked(monkeypatch):
    """Every window the run dispatches also runs as the host build, and
    the two must agree; returns the list of (ticks, forced) checked."""
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernel's source")
    seen = []
    plain = MegaWindow._dispatch

    def checked(self, st, it, iw, limit, force, prev_aux, probe, forced):
        want = plain(self, st, it, iw, limit, force, prev_aux, None, forced)
        got = self.run_host(st, it, iw, limit, force,
                            engine.zero_aux("cpu") if forced else prev_aux,
                            forced=forced)
        assert_same_window(got, want, f"window {len(seen)}")
        seen.append((int(want[2]), forced))
        return want

    monkeypatch.setattr(MegaWindow, "_dispatch", checked)
    return seen


def _ran(seen):
    assert seen and sum(k for k, _ in seen) > 0
    return sum(k for k, _ in seen)


@pytest.mark.parametrize("hops", [1000, 1 << 20])
def test_ubench(host_checked, hops):
    """16 pingers (cap 4, batch 2); hops 2^20 keeps every payload in the
    escape plane."""
    opts = RuntimeOptions(mailbox_cap=4, batch=2, max_sends=1, msg_words=1,
                          spill_cap=64, inject_slots=8, quiesce_interval=4,
                          **OPTS)
    rt, ids = ubench.build(16, opts, pings=2, device="cpu")
    ubench.seed_all(rt, ids, hops=hops, pings=2)
    rt.run(max_steps=12)
    assert _ran(host_checked) >= 12
    assert rt.counter("n_processed") == 16 * 2 * 12


def test_ring(host_checked):
    rt = ring.run(32, 100, opts=RuntimeOptions(
        mailbox_cap=8, batch=1, max_sends=1, msg_words=1, spill_cap=128,
        inject_slots=8, quiesce_interval=16, **OPTS), device="cpu")
    _ran(host_checked)
    assert int(rt.cohort_state(ring.RingNode)["passes"].sum()) == 100


@pytest.mark.parametrize("age", [0, 4])
def test_walkers_spill_mute_unmute(host_checked, age):
    rt = build_walkers(ponyc_tpu_torch, TT, 7, n_seeds=30, mailbox_cap=2,
                       batch=1, msg_words=1, max_sends=2, spill_cap=512,
                       inject_slots=16, mute_age_limit=age,
                       quiesce_interval=8, **MEGA)
    rt.run(max_steps=400)
    _ran(host_checked)
    assert rt.counter("n_mutes") > 0 and rt.counter("n_rejected") > 0


def test_fifo(host_checked):
    rt = build_fifo(ponyc_tpu_torch, TT, 3, mailbox_cap=4, batch=2,
                    spill_cap=512, inject_slots=16, quiesce_interval=8,
                    **MEGA)
    rt.run(max_steps=400)
    _ran(host_checked)
    assert int(rt.cohort_state(TT.Cons)["bad"].sum()) == 0


@pytest.mark.parametrize("name", CORPUS)
def test_corpus(host_checked, name):
    out = run_corpus(ponyc_tpu_torch, TT, name, device="cpu",
                     quiesce_interval=4, **MEGA)
    _ran(host_checked)
    assert out["steps"] > 0


def test_mixers_every_effect(host_checked):
    rt = build_mixers(ponyc_tpu_torch, TT, 5, mailbox_cap=4, spill_cap=256,
                      inject_slots=32, quiesce_interval=8, **MEGA)
    rt.run(max_steps=300)
    _ran(host_checked)
    assert rt.counter("n_destroyed") + rt.counter("n_errors") > 0


def test_mixed(host_checked):
    rt, ids, wt = mixed.build(64, 4, RuntimeOptions(
        mailbox_cap=4, batch=1, max_sends=1, msg_words=1, spill_cap=256,
        inject_slots=8, quiesce_interval=3, **OPTS), work=4, device="cpu")
    mixed.seed_all(rt, ids, wt, hops=1 << 30, mix=True)
    rt.run(max_steps=6)
    assert _ran(host_checked) >= 6
    assert rt.counter("n_processed") == 64 * 6


def test_nbody(host_checked):
    rt = nbody.run_round(24, RuntimeOptions(
        mailbox_cap=16, batch=4, max_sends=1, msg_words=4, spill_cap=1024,
        quiesce_interval=16, **OPTS), device="cpu")
    _ran(host_checked)
    assert (rt.cohort_state(nbody.Body)["seen"] == 23).all()


def test_forced_spelling(host_checked):
    opts = RuntimeOptions(mailbox_cap=4, batch=2, max_sends=1, msg_words=1,
                          spill_cap=64, inject_slots=8, **OPTS)
    rt, ids = ubench.build(16, opts, pings=2, device="cpu")
    ubench.seed_all(rt, ids, hops=1000, pings=2)
    forced = engine.build_forced_window(rt.program, rt.opts, rt._multi_g)
    it, iw, _ = rt._drain_inject_tracked()
    st, _aux, k = forced(rt.state, it, iw, 5)
    assert int(k) == 5 and host_checked == [(5, True)]
    # Injections land every tick: 16 pingers x 2 pings, five times over.
    assert int(st.n_delivered[0]) > 32


def test_gated_out_window(host_checked):
    """force=False with a quiet previous aux: no tick runs, and the
    previous aux comes back unchanged."""
    opts = RuntimeOptions(mailbox_cap=4, batch=2, max_sends=1, msg_words=1,
                          spill_cap=64, inject_slots=8, **OPTS)
    rt, ids = ubench.build(16, opts, pings=1, device="cpu")
    quiet = engine.aux_to_device(
        engine.aux_from_vector([0] * 9 + [7, 9] + [0] * 10)[1], "cpu")
    st, aux, k = rt._multi_g(rt.state, *rt._empty_inject, 4, False, quiet)
    assert int(k) == 0 and host_checked == [(0, False)]
    assert all(torch.equal(a, b) for a, b in zip(aux, quiet))
    got = rt._multi_g.run_host(rt.state, *rt._empty_inject, 4, False, quiet)
    assert int(got[2]) == 0
    assert all(torch.equal(a, b) for a, b in zip(got[1], quiet))

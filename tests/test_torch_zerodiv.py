"""Integer `//` and `%` by zero in the port: the JAX package's results on
the CPU (remainder 0; floor quotient -1 for a zero dividend, -2 otherwise)
on the plain path, through both kernels' host builds, and from
csrc/lane.cuh's helpers themselves; and GUPS, whose updater divides by its
fields, starting under delivery="auto" (the calibration workload's fields
are zero)."""

import os
import subprocess

import numpy as np
import pytest
import torch

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu.models import gups as jgups
from ponyc_tpu_torch.models import gups as tgups
from ponyc_tpu_torch.ops import _build
from ponyc_tpu_torch.ops.fused_dispatch import FusedDispatch

from _torch_programs import define
from test_torch_lanecode import FUSED_OUT, _leaves
from test_torch_mega_host import host_checked  # noqa: F401 (fixture)

JT, TT = define(ponyc_tpu), define(ponyc_tpu_torch)
XS = [-7, -1, 0, 1, 7, 2**31 - 1]
YS = [-3, -1, 0, 1, 3]
PAIRS = [(x, y) for x in XS for y in YS]


def _div_world(pkg, T, **kw):
    n = len(PAIRS)
    opts = pkg.RuntimeOptions(mailbox_cap=4, batch=1, msg_words=2,
                              tuning_cache="off", **kw)
    dev = dict(device="cpu") if pkg is ponyc_tpu_torch else {}
    rt = pkg.Runtime(opts, **dev)
    rt.declare(T.Div, n).start()
    ids = rt.spawn_many(T.Div, n)
    xs, ys = (np.asarray(c, np.int32) for c in zip(*PAIRS))
    rt.bulk_send(ids, T.Div.go, xs, ys)
    code = rt.run(max_steps=8)
    return code, {f: np.asarray(v).tolist()
                  for f, v in rt.cohort_state(T.Div).items()}


@pytest.fixture(scope="module")
def jax_div():
    return _div_world(ponyc_tpu, JT)


@pytest.fixture
def fused_checked(monkeypatch):
    """Every fused dispatch also runs as the host build of csrc/
    fused_dispatch.cu, which must equal the plain version bit for bit;
    returns the list of cohorts checked."""
    seen = []
    plain = FusedDispatch.__call__

    def checked(self, fields, buf, head, n_run, ids, resv=()):
        want = plain(self, fields, buf, head, n_run, ids, resv)
        got = self.run_host(fields, buf, head, n_run, ids, resv)
        for (name, x), (_, y) in zip(_leaves(dict(zip(FUSED_OUT, got)), "o"),
                                     _leaves(dict(zip(FUSED_OUT, want)),
                                             "o")):
            assert (x is None) == (y is None), name
            assert x is None or torch.equal(x, y), (self.name, name)
        seen.append(self.name)
        return want

    monkeypatch.setattr(FusedDispatch, "__call__", checked)
    return seen


@pytest.mark.parametrize("kw", [
    {}, dict(delivery="cosort"), dict(pallas_fused=True),
    dict(delivery="pallas_mega"),
    dict(delivery="auto", pallas_fused="auto")],
    ids=["plain", "cosort", "fused", "mega", "auto"])
def test_zero_divisor_matches_jax(jax_div, kw):
    """x // y, x % y, 5 // y and 3 % y for every (x, y) of a grid whose
    divisors include 0 equal the JAX package's, on every path."""
    code, got = _div_world(ponyc_tpu_torch, TT, **kw)
    assert (code, got) == jax_div
    zero = [i for i, (_x, y) in enumerate(PAIRS) if y == 0]
    assert {got["r"][i] for i in zero} == {0}
    assert {got["q"][i] for i in zero} == {-1, -2}


@pytest.mark.parametrize("path", ["fused", "mega"])
def test_zero_divisor_host_builds_equal_plain(request, jax_div, path):
    """The kernels' host builds (the emitted lane code and csrc/lane.cuh)
    give the plain version's results on the zero divisors."""
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernels' sources")
    if path == "fused":
        seen = request.getfixturevalue("fused_checked")
        kw = dict(pallas_fused=True)
    else:
        seen = request.getfixturevalue("host_checked")
        kw = dict(delivery="pallas_mega")
    assert _div_world(ponyc_tpu_torch, TT, **kw) == jax_div
    assert seen


LANE_CHECK = r"""
#include "lane.cuh"
extern "C" void pony_div_check(const int32_t* a, const int32_t* b,
                               int32_t* q, int32_t* r, int n) {
  for (int i = 0; i < n; ++i) {
    q[i] = pony_floordiv<int32_t>(a[i], b[i]);
    r[i] = pony_rem<int32_t>(a[i], b[i]);
  }
}
"""


def test_lane_helpers_match_jax(tmp_path):
    """csrc/lane.cuh's pony_floordiv and pony_rem on the grid, a zero
    divisor among them, equal jnp's // and % on the CPU."""
    import ctypes

    import jax.numpy as jnp
    cxx = _build.host_cxx()
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = tmp_path / "div_check.cc"
    src.write_text(LANE_CHECK)
    lib = tmp_path / "libdiv_check.so"
    subprocess.run([cxx, *_build.HOST_FLAGS, "-I", _build.CSRC_DIR, "-o",
                    str(lib), str(src)], check=True)
    a, b = (np.ascontiguousarray(c, np.int32) for c in zip(*PAIRS))
    q, r = np.zeros_like(a), np.zeros_like(a)
    p = np.ctypeslib.as_ctypes
    ctypes.CDLL(os.fspath(lib)).pony_div_check(p(a), p(b), p(q), p(r),
                                               len(a))
    np.testing.assert_array_equal(q, np.asarray(jnp.asarray(a) //
                                                jnp.asarray(b)))
    np.testing.assert_array_equal(r, np.asarray(jnp.asarray(a) %
                                                jnp.asarray(b)))


def _gups(pkg, **kw):
    mod = tgups if pkg is ponyc_tpu_torch else jgups
    dev = dict(device="cpu") if pkg is ponyc_tpu_torch else {}
    opts = pkg.RuntimeOptions(mailbox_cap=16, batch=2, msg_words=1,
                              spill_cap=1024, tuning_cache="off", **kw)
    rt = mod.run(table_size=256, n_updaters=8, updates_each=8, opts=opts,
                 **dev)
    return rt.exit_code, rt.steps_run, {
        t.__name__: {f: np.asarray(v).tolist()
                     for f, v in rt.cohort_state(t).items()}
        for t in (mod.TableCell, mod.Updater)}


@pytest.mark.parametrize("mega_auto", ["0", "1"])
def test_gups_starts_under_auto_and_matches_jax(monkeypatch, mega_auto):
    """GUPS under delivery="auto", pallas_fused="auto": calibration runs
    the updater on zero fields (table_size and n_shards 0) on every
    variant, the window kernel's too where it is enumerated, and the run
    equals the JAX package's."""
    monkeypatch.setenv("PONY_TPU_MEGA_AUTO", mega_auto)
    want = _gups(ponyc_tpu)
    rt_kw = dict(delivery="auto", pallas_fused="auto")
    assert _gups(ponyc_tpu_torch, **rt_kw) == want

"""stdlib.random on both packages, and drawn inside behaviours on the
port's three paths.

- `bits`, `uniform` and `randint` of ponyc_tpu_torch.stdlib.random equal
  the JAX package's bit for bit (exact: integers equal, floats equal as
  bits) over ids that include 0 and 2^31-1, negative steps, seeds at and
  past 2^31, draws 0..7, tensor draws and bounds, and several spans, one
  of them empty (hi == lo gives lo on both).
- randping (tests/_torch_programs.py: every pinger passes each of its 4
  tokens to a peer drawn by `randint`, and counts a hit when `uniform` <
  0.5) at 256 pingers x 4 tokens x 32 visits on the plain tick, under
  pallas_fused=True and under delivery="pallas_mega" gives the JAX
  package's fields, counters and ticks, and the NumPy oracle's visits
  and hits (exact).
- The kernels' own sources built for the host CPU run the randping body:
  the fused dispatch kernel against its plain version on seeded inputs
  (skips where the box has no host C++ compiler), and the window kernel
  against the plain window on every window of the "mega" run (exact).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu.stdlib import random as JR
from ponyc_tpu_torch import RuntimeOptions
from ponyc_tpu_torch.ops import _build, lanecode
from ponyc_tpu_torch.ops import fused_dispatch as fdm
from ponyc_tpu_torch.ops.megakernel import MegaWindow
from ponyc_tpu_torch.program import Program
from ponyc_tpu_torch.runtime import engine
from ponyc_tpu_torch.stdlib import random as TR

from _torch_programs import (RP_OPTS, RP_TOKENS, counters, define_random,
                             randping_build, randping_oracle)

N, HOPS = 256, 32
SEEDS = [0x5DEECE66, 0, 1 << 31, (1 << 31) + 12345, 0xFFFFFFFF]
SPANS = [(0, 1), (0, 2), (0, 1 << 20), (-5, 5), (7, 7), (0, (1 << 31) + 5),
         (-(1 << 31), (1 << 31) - 1), (100, 1000)]


def _inputs(rng, n=300):
    ids = np.concatenate([[0, (1 << 31) - 1, 1, 2],
                          rng.integers(0, 1 << 31, n)]).astype(np.int32)
    steps = np.concatenate([[-1, -(1 << 31), 0, (1 << 31) - 1],
                            rng.integers(-(1 << 31), 1 << 31, n)]
                           ).astype(np.int32)
    return ids, steps


def _both(fn, *args, **kw):
    """`fn` of each package on the same int32 inputs, as NumPy."""
    def conv(f):
        return ([f(a) if isinstance(a, np.ndarray) else a for a in args],
                {k: f(a) if isinstance(a, np.ndarray) else a
                 for k, a in kw.items()})
    ja, jk = conv(jnp.asarray)
    ta, tk = conv(torch.from_numpy)
    return np.asarray(getattr(JR, fn)(*ja, **jk)), getattr(TR, fn)(
        *ta, **tk).numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_randint_equal_jax(seed):
    ids, steps = _inputs(np.random.default_rng(seed & 0xFFFF))
    for draw in range(8):
        j, t = _both("bits", ids, steps, draw=draw, seed=seed)
        assert t.dtype == np.int64
        assert (j.astype(np.int64) == t).all(), draw
        j, t = _both("uniform", ids, steps, draw=draw, seed=seed)
        assert j.dtype == t.dtype == np.float32
        assert (j.view(np.uint32) == t.view(np.uint32)).all(), draw
        assert 0.0 <= t.min() and t.max() < 1.0
        for lo, hi in SPANS:
            j, t = _both("randint", ids, steps, lo, hi, draw=draw,
                         seed=seed)
            assert j.dtype == t.dtype == np.int32
            assert (j == t).all(), (draw, lo, hi)


def test_tensor_draws_and_bounds_equal_jax():
    rng = np.random.default_rng(3)
    ids, steps = _inputs(rng)
    n = ids.shape[0]
    draw = rng.integers(0, 8, n).astype(np.int32)
    lo = rng.integers(-1000, 1000, n).astype(np.int32)
    hi = lo + rng.integers(0, 64, n).astype(np.int32)
    hi[:8] = lo[:8]                                  # empty spans
    j, t = _both("randint", ids, steps, lo, hi, draw=draw)
    assert (j == t).all()
    assert (t[:8] == lo[:8]).all()
    j, t = _both("uniform", ids, steps, draw=draw)
    assert (j.view(np.uint32) == t.view(np.uint32)).all()
    j, t = _both("bits", 5, 9, draw=3)              # Python ints
    assert int(j) == int(t)


def test_host_rand_equals_jax():
    a, b = JR.Rand(seed=77), TR.Rand(seed=77)
    assert [a.next() for _ in range(20)] == [b.next() for _ in range(20)]
    assert [a.int(97) for _ in range(20)] == [b.int(97) for _ in range(20)]
    assert a.real() == b.real()
    xs, ys = list(range(30)), list(range(30))
    JR.Rand(seed=5).shuffle(xs)
    TR.Rand(seed=5).shuffle(ys)
    assert xs == ys


# ---- randping on the three paths ----------------------------------------

@pytest.fixture(autouse=True)
def one_thread():
    """A 256-lane tick is a few hundred small eager ops: torch's intra-op
    threads only contend with the other test workers for the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _world(rt, P):
    st = rt.cohort_state(P)
    return {"fields": {f: np.asarray(v).tolist() for f, v in st.items()},
            "counters": counters(rt), "steps": rt.steps_run,
            "exit": rt.exit_code}


@pytest.fixture(scope="module")
def jax_randping():
    P = define_random(ponyc_tpu, N)
    rt = randping_build(ponyc_tpu, P, N, HOPS)
    rt.run(max_steps=100_000)
    return _world(rt, P)


PATHS = {"plain": {}, "fused": dict(pallas_fused=True),
         "mega": dict(delivery="pallas_mega")}


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


@pytest.mark.parametrize("path", sorted(PATHS))
def test_randping_equals_jax_and_oracle(jax_randping, path, monkeypatch):
    """On "mega" every window of the run also runs as the window kernel's
    host build, bit-equal to the plain window (where the box has a host
    C++ compiler)."""
    seen = []
    if path == "mega" and _build.host_cxx() is not None:
        plain = MegaWindow._dispatch

        def checked(self, st, it, iw, limit, force, prev_aux, probe,
                    forced):
            want = plain(self, st, it, iw, limit, force, prev_aux, probe,
                         forced)
            got = self.run_host(st, it, iw, limit, force,
                                engine.zero_aux("cpu") if forced
                                else prev_aux, forced=forced)
            for (name, x), (_, y) in zip(_leaves(got, "out"),
                                         _leaves(want, "out")):
                assert x.dtype == y.dtype and torch.equal(x, y), (
                    len(seen), name)
            seen.append(int(want[2]))
            return want

        monkeypatch.setattr(MegaWindow, "_dispatch", checked)
    P = define_random(ponyc_tpu_torch, N)
    rt = randping_build(ponyc_tpu_torch, P, N, HOPS, **PATHS[path])
    rt.run(max_steps=100_000)
    got = _world(rt, P)
    assert got == jax_randping
    visits, hits = randping_oracle(N, HOPS)
    assert got["fields"]["visits"] == visits.tolist()
    assert got["fields"]["hits"] == hits.tolist()
    assert got["counters"]["n_processed"] == N * RP_TOKENS * HOPS
    # Backpressure took part: some deliveries spilled, some senders muted.
    assert got["counters"]["n_rejected"] > 0
    assert got["counters"]["n_mutes"] > 0
    if seen:
        assert sum(seen) == got["steps"]


def test_randping_body_replays_and_emits():
    """The body's lane program replays bit-equal to the eager body and
    emits for both targets."""
    P = define_random(ponyc_tpu_torch, N)
    opts = RuntimeOptions(tuning_cache="off", **RP_OPTS)
    prog = Program(opts)
    prog.declare(P, 64)
    prog.finalize()
    ch = prog.by_type[P]
    (bdef,) = ch.behaviours
    specs = ch.atype.field_specs
    dtypes = {f: engine._dtype_of(s) for f, s in specs.items()}
    lp = lanecode.trace_behaviour(bdef, field_specs=specs,
                                  msg_words=opts.msg_words,
                                  msg_words_in=ch.msg_words,
                                  max_sends=ch.max_sends)
    rng = np.random.default_rng(5)
    lanes = 61
    st = {f: torch.from_numpy(rng.integers(0, 100, lanes).astype(np.int32))
          for f in specs}
    payload = torch.from_numpy(np.stack([
        rng.integers(-(1 << 31), 1 << 31, lanes),
        rng.integers(0, 8, lanes)]).astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, N, lanes).astype(np.int32))
    _ctx, st2, tgts, words = engine.eval_behaviour(
        bdef, st, payload, ids, msg_words=opts.msg_words,
        field_specs=specs, field_dtypes=dtypes, lanes=lanes,
        max_sends=ch.max_sends)
    r_st, r_tgts, r_words, _ = lanecode.replay(lp, st, payload, ids)
    for f in specs:
        assert torch.equal(r_st[f], st2[f]), f
    assert torch.equal(r_tgts[0], tgts[0])
    assert torch.equal(r_words[0], words[0])
    for target in ("cuda", "host"):
        src = lanecode.emit_behaviour(lp, 0, list(specs), target)
        assert "pony_rem<int64_t>" in src and "pony_shr<int64_t>" in src


def test_fused_host_build_equals_plain():
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernel's source")
    P = define_random(ponyc_tpu_torch, N)
    opts = RuntimeOptions(tuning_cache="off", **RP_OPTS)
    prog = Program(opts)
    prog.declare(P, 257)
    prog.finalize()
    fd = fdm.build_fused_dispatch(prog.by_type[P], opts)
    for seed in range(2):
        inputs = fd.sample_inputs(seed)
        for (name, x), (_, y) in zip(_leaves(fd.run_host(*inputs), "out"),
                                     _leaves(fd.plain(*inputs), "out")):
            if y is None:
                assert x is None, name
                continue
            assert x.dtype == y.dtype and torch.equal(x, y), (seed, name)

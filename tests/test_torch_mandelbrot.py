"""mandelbrot on the port, and what its body needed of the lane code
(ponyc_tpu_torch/ops/lanecode.py): constant vectors and reductions over a
body's own leading axes.

- The port's `render` at 32x32 equals the NumPy oracle on the plain
  path, through the fused kernel's host build (`pallas_fused=True`) and
  through the window kernel's host build (`delivery="pallas_mega"`); the
  JAX package's `render` (plain, and its Pallas window kernel in
  interpret mode) gives the same bytes. Exact: bytes.
- `replay` of a lane program equals eager evaluation bit for bit for each
  new reduction and for constant vectors, on int, bool and float inputs;
  the fused kernel's host build equals its plain version on such a body
  (integers exactly, floats within the 8 ulp tests/test_torch_lanecode.py
  states for the host's sqrtf; this body takes no sqrt, so the floats
  are compared exactly).
- A reduction over the lane axis, a float sum, the indices of max and a
  constant with a lane axis are still refused, by name.
- Every earlier world's generated kernel header (the fused kernel's
  pony_cohort.h per cohort, the window kernel's pony_world.h per
  program) hashes as it did before constant vectors and reductions came:
  the snapshot below was taken on the tree before them.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ponyc_tpu_torch
from ponyc_tpu_torch import (F32, I32, Runtime, RuntimeOptions, VecF32,
                             VecI32, actor, behaviour)
from ponyc_tpu_torch.models import mandelbrot, mixed, nbody, ring, ubench
from ponyc_tpu_torch.models import spawn_tree
from ponyc_tpu_torch.ops import _build, lanecode
from ponyc_tpu_torch.ops import fused_dispatch as fdm
from ponyc_tpu_torch.ops.megakernel import MegaWindow
from ponyc_tpu_torch.program import Program
from ponyc_tpu_torch.runtime import engine
from ponyc_tpu_torch.runtime.engine import _dtype_of, eval_behaviour

from _torch_programs import build_fifo, build_walkers, define

TT = define(ponyc_tpu_torch)
PATHS = {"plain": {}, "fused": dict(pallas_fused=True),
         "mega": dict(delivery="pallas_mega")}


def _host_builds(monkeypatch, path):
    """Route the path's kernel through its host C++ build."""
    if path == "plain":
        return
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernel's source")
    if path == "fused":
        monkeypatch.setattr(fdm.FusedDispatch, "__call__",
                            fdm.FusedDispatch.run_host)
        return

    def hosted(self, st, it, iw, limit, force, prev_aux, probe, forced):
        return self.run_host(st, it, iw, limit, force,
                             engine.zero_aux("cpu") if forced else prev_aux,
                             forced=forced)
    monkeypatch.setattr(MegaWindow, "_dispatch", hosted)


@pytest.mark.parametrize("path", list(PATHS))
def test_render_equals_oracle_on_each_path(monkeypatch, path):
    _host_builds(monkeypatch, path)
    opts = dataclasses.replace(mandelbrot.default_options(),
                               tuning_cache="off", **PATHS[path])
    got = mandelbrot.render(32, 32, opts, device="cpu")
    want = mandelbrot.reference_bytes(32, 32)
    assert got.shape == want.shape == (32, 4)
    assert 0 < int(want.sum())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mandelbrot.f32_bytes(32, 32), want)


@pytest.mark.parametrize("delivery", ["plan", "pallas_mega"])
def test_jax_render_gives_the_ports_bytes(delivery):
    import ponyc_tpu
    from ponyc_tpu.models import mandelbrot as jm
    opts = ponyc_tpu.RuntimeOptions(mailbox_cap=4, batch=1, max_sends=0,
                                    msg_words=9, spill_cap=64,
                                    inject_slots=64, delivery=delivery,
                                    tuning_cache="off")
    got = jm.render(32, 32, opts)
    port = mandelbrot.render(32, 32, dataclasses.replace(
        mandelbrot.default_options(), tuning_cache="off"), device="cpu")
    np.testing.assert_array_equal(got, port)
    np.testing.assert_array_equal(jm.reference_bytes(32, 32),
                                  mandelbrot.reference_bytes(32, 32))


def test_oracle_rows_and_f32_replay():
    """A band of rows of the oracle equals those rows of the whole
    image; the float32 replay of the body's arithmetic agrees there."""
    rows = np.array([0, 5, 17, 31])
    whole = mandelbrot.reference_bytes(64, 32)
    np.testing.assert_array_equal(
        mandelbrot.reference_bytes(64, 32, rows), whole[rows])
    np.testing.assert_array_equal(mandelbrot.f32_bytes(64, 32, rows),
                                  whole[rows])


# ---------------------------------------------------------- lane code

W8 = torch.tensor([3, -1, 7, 0, 2, 2, -5, 1], dtype=torch.int32)
WF = torch.tensor([0.5, -1.25, 3.0, 2.0], dtype=torch.float32)


@actor
class Reducer:
    a: I32
    b: I32
    c: F32
    d: I32

    MAX_SENDS = 1

    @behaviour
    def ints(self, st, v: VecI32[8], k: I32):
        w = W8.reshape(8, 1)
        s = (v * w).sum(0)                               # int64
        p = (v[:4] % 5 + 1).prod(0)                      # int64, wraps
        mx = (v + w).amax(0)
        mn, _ = (v - w).min(0)
        t = v.reshape(2, 4, -1).sum((0, 1), dtype=torch.int32)
        kd = v.sum(0, keepdim=True)[0]
        self.send(self.actor_id, Reducer.ints, v, k - 1, when=k > 0)
        return {**st, "a": s + p + kd, "b": mx * 3 + mn + t,
                "d": st["d"] + k}

    @behaviour
    def bools(self, st, v: VecI32[8], k: I32):
        pos = v > 0
        w = W8.reshape(8, 1) > 0
        n = (pos & w).sum(0)                             # bool -> int64
        anyp = (pos | (v == k)).any(0)
        allp = pos.all(0)
        m8 = (v.to(torch.uint8)).any(0)                  # uint8 -> uint8
        mb = torch.amax(pos, 0)
        return {**st, "a": n + anyp * 100 + allp * 1000 + m8 * 7,
                "b": mb * 2 + st["b"], "d": st["d"]}

    @behaviour
    def floats(self, st, x: VecF32[4], y: F32):
        w = WF.reshape(4, 1)
        z = x * w + y
        hi = z.amax(0)
        lo, _ = z.min(dim=0)
        m2 = torch.amin(z.reshape(2, 2, -1), (0, 1))
        return {**st, "c": hi - lo * 0.5 + m2,
                "a": (z > 0).sum(0) + st["a"], "d": st["d"]}


OKW = dict(mailbox_cap=4, batch=2, max_sends=1, msg_words=9)


def _cohort(atype, lanes):
    opts = RuntimeOptions(tuning_cache="off", **OKW)
    prog = Program(opts)
    prog.declare(atype, lanes)
    prog.finalize()
    return opts, prog.by_type[atype]


def _payload(bdef, width, lanes, rng):
    words = rng.integers(-9, 10, (width, lanes)).astype(np.int32)
    if bdef.name == "floats":
        words[:5] = rng.uniform(-4, 4, (5, lanes)).astype(
            np.float32).view(np.int32)
    return torch.from_numpy(words)


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("beh", ["ints", "bools", "floats"])
def test_reductions_replay_equals_eager(beh):
    lanes = 41
    opts, ch = _cohort(Reducer, lanes)
    bdef = getattr(Reducer, beh)
    specs = ch.atype.field_specs
    dtypes = {f: _dtype_of(s) for f, s in specs.items()}
    prog = lanecode.trace_behaviour(
        bdef, field_specs=specs, msg_words=opts.msg_words,
        msg_words_in=ch.msg_words, max_sends=ch.max_sends)
    kinds = {n.func.overloadpacket.__name__ for n in prog.nodes
             if n.kind == "op"}
    assert not kinds & {"sum", "prod", "amax", "amin", "max", "min",
                        "any", "all"}, kinds
    rng = np.random.default_rng(5)
    for _ in range(3):
        st = {f: (torch.from_numpy(rng.standard_normal(lanes).astype(
            np.float32)) if dt == torch.float32 else torch.from_numpy(
                rng.integers(-40, 41, lanes).astype(np.int32)))
            for f, dt in dtypes.items()}
        payload = _payload(bdef, ch.msg_words, lanes, rng)
        ids = torch.arange(lanes, dtype=torch.int32) + 3
        ctx, st2, tgts, words = eval_behaviour(
            bdef, st, payload, ids, msg_words=opts.msg_words,
            field_specs=specs, field_dtypes=dtypes, lanes=lanes,
            max_sends=ch.max_sends)
        r_st, r_tgts, r_words, _ = lanecode.replay(prog, st, payload, ids)
        for f in specs:
            assert torch.equal(_bits(r_st[f]), _bits(st2[f])), (beh, f)
        for m in range(len(ctx.sends)):
            assert torch.equal(r_tgts[m], tgts[m])
            assert torch.equal(r_words[m], words[m])


def test_reductions_host_build_equals_plain_dispatch():
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernel's source")
    opts, ch = _cohort(Reducer, 193)
    fd = fdm.build_fused_dispatch(ch, opts)
    names = ("fields", "outbox", "head", "any_exit", "exit_code", "nproc",
             "nbad", "destroy", "errors")
    for seed in range(2):
        inputs = fd.sample_inputs(seed)
        got = dict(zip(names, fd.run_host(*inputs)))
        want = dict(zip(names, fd.plain(*inputs)))
        for k in names:
            g, w = got[k], want[k]
            if isinstance(w, dict):
                for f in w:
                    assert torch.equal(_bits(g[f]), _bits(w[f])), (seed, f)
            elif isinstance(w, tuple):
                for x, y in zip(g, w):
                    assert torch.equal(x, y), (seed, k)
            elif w is not None:
                assert torch.equal(g, w), (seed, k)


def _start(atype):
    rt = Runtime(RuntimeOptions(tuning_cache="off", pallas_fused=True,
                                **OKW), device="cpu")
    rt.declare(atype, 4)
    return rt.start()


@actor
class LaneSummer:
    n: I32

    @behaviour
    def go(self, st, v: VecI32[8]):
        return {**st, "n": v.sum(1)[0]}


@actor
class FloatSummer:
    c: F32

    @behaviour
    def go(self, st, v: VecF32[8]):
        return {**st, "c": v.sum(0)}


@actor
class Indexer:
    n: I32

    @behaviour
    def go(self, st, v: VecI32[8]):
        _, where = v.max(0)
        return {**st, "n": where}


@actor
class Tabled:
    n: I32

    @behaviour
    def go(self, st, v: I32):
        table = torch.arange(v.shape[-1], dtype=torch.int32)
        return {**st, "n": v + table}


@pytest.mark.parametrize("atype,match", [
    (LaneSummer, r"LaneSummer\.go.*aten\.sum.*reads across actors"),
    (FloatSummer, r"FloatSummer\.go.*aten\.sum.*reduces floats"),
    (Indexer, r"Indexer\.go.*indices of aten\.max"),
    (Tabled, r"Tabled\.go.*lane count"),
], ids=["lane-axis", "float-sum", "max-indices", "lane-table"])
def test_refused_by_name(atype, match):
    with pytest.raises(NotImplementedError, match=match):
        _start(atype)
    # The plain dispatch does not trace, so start() succeeds there.
    rt = Runtime(RuntimeOptions(tuning_cache="off", **OKW), device="cpu")
    rt.declare(atype, 4)
    rt.start()


# ------------------------------------------- earlier worlds' headers

MEGA = dict(delivery="pallas_mega")


def _fused_headers():
    out = {}
    progs = [
        ("ubench", (TT.Pinger,), dict(mailbox_cap=4, batch=4, max_sends=1,
                                      msg_words=1)),
        ("walkers", (TT.Walker, TT.Splitter), dict(
            mailbox_cap=4, batch=2, max_sends=2, msg_words=1)),
        ("fifo", (TT.Cons, TT.Prod), dict(mailbox_cap=8, batch=2,
                                          max_sends=3, msg_words=2)),
        ("corpus", (TT.Mixer, TT.TriF, TT.Yielder, TT.Exiter, TT.Ephemeral,
                    TT.Errs, TT.Arith, TT.Div), dict(
            mailbox_cap=8, batch=4, max_sends=2, msg_words=2)),
        ("mixed", (mixed.make_worker_type(8, work=64),), dict(
            mailbox_cap=4, batch=1, max_sends=1, msg_words=1)),
        ("nbody", (nbody.Body,), dict(mailbox_cap=16, batch=4, max_sends=1,
                                      msg_words=4)),
        ("tree", (spawn_tree.Node,), dict(mailbox_cap=8, batch=4,
                                          max_sends=3, msg_words=2)),
    ]
    for name, types, okw in progs:
        opts = RuntimeOptions(tuning_cache="off", **okw)
        prog = Program(opts)
        for t in types:
            prog.declare(t, 64)
        prog.finalize()
        for t in types:
            fd = fdm.build_fused_dispatch(prog.by_type[t], opts)
            out[f"fused/{name}/{t.__name__}"] = fd.source("cuda")
    return out


def _mega_headers():
    opts = dict(tuning_cache="off", **MEGA)
    rts = {
        "ubench": ubench.build(16, RuntimeOptions(
            mailbox_cap=4, batch=2, max_sends=1, msg_words=1, spill_cap=64,
            inject_slots=8, **opts), pings=2, device="cpu")[0],
        "ubench-analysis1": ubench.build(16, RuntimeOptions(
            mailbox_cap=4, batch=2, max_sends=1, msg_words=1, spill_cap=64,
            inject_slots=8, analysis=1, **opts), pings=2, device="cpu")[0],
        "ring": ring.build(32, RuntimeOptions(
            mailbox_cap=8, batch=1, max_sends=1, msg_words=1, spill_cap=128,
            inject_slots=8, **opts), device="cpu")[0],
        "mixed": mixed.build(64, 8, RuntimeOptions(
            mailbox_cap=4, batch=1, max_sends=1, msg_words=1, spill_cap=256,
            inject_slots=8, **opts), work=64, device="cpu")[0],
        "nbody": nbody.build(24, RuntimeOptions(
            mailbox_cap=16, batch=4, max_sends=1, msg_words=4,
            spill_cap=1024, **opts), device="cpu")[0],
        "tree": spawn_tree.build(4, spawn_tree.options(**opts),
                                 device="cpu")[0],
        "walkers": build_walkers(ponyc_tpu_torch, TT, 7, mailbox_cap=2,
                                 batch=1, msg_words=1, max_sends=2,
                                 spill_cap=512, inject_slots=16, **MEGA),
        "fifo": build_fifo(ponyc_tpu_torch, TT, 3, mailbox_cap=4, batch=2,
                           spill_cap=512, inject_slots=16, **MEGA),
    }
    hl = Runtime(RuntimeOptions(mailbox_cap=4, batch=2, max_sends=2,
                                msg_words=1, spill_cap=512, **opts),
                 device="cpu")
    hl.declare(TT.WalkerH, 32).declare(TT.HostLog, 1)
    rts["hostlog"] = hl.start()
    return {f"mega/{k}": rt._multi_g.source("cuda") for k, rt in rts.items()}


def world_header_hashes():
    """sha256 (first 16 hex digits) of each earlier world's generated
    CUDA header."""
    srcs = {**_fused_headers(), **_mega_headers()}
    return {k: hashlib.sha256(v.encode()).hexdigest()[:16]
            for k, v in sorted(srcs.items())}


# Taken on the tree before constant vectors and lane-local reductions.
HEADER_HASHES = {
    'fused/corpus/Arith': '8ca9d1785065fe07',
    'fused/corpus/Div': '5abc7043a3ec40cf',
    'fused/corpus/Ephemeral': 'c4ace07604bc7cda',
    'fused/corpus/Errs': '9dbdc9869eb84c6a',
    'fused/corpus/Exiter': 'af115d5b5715bfb1',
    'fused/corpus/Mixer': 'f0c13c5835dc591c',
    'fused/corpus/TriF': '29b1222b0bbbf0f1',
    'fused/corpus/Yielder': '93d7532f7b5b504d',
    'fused/fifo/Cons': 'b759b7cf9bbfd76c',
    'fused/fifo/Prod': '700f955097dfbd2a',
    'fused/mixed/Worker8': 'a6d7e573343d126e',
    'fused/nbody/Body': '8206f0519f4dd2b8',
    'fused/tree/Node': '066333d0e689a54b',
    'fused/ubench/Pinger': '894a57238e3581a8',
    'fused/walkers/Splitter': '1aed03c7249f2553',
    'fused/walkers/Walker': '3b29094005536791',
    'mega/fifo': '9338ddd58e0519f4',
    'mega/hostlog': 'd2d1e6c2062b6cd3',
    'mega/mixed': '8a1d6ebd559d3774',
    'mega/nbody': '2c6578a9390dca23',
    'mega/ring': 'ef216ac78f7b3267',
    'mega/tree': 'b0a16035037d4f68',
    'mega/ubench': 'bddc38b8cdd978b0',
    'mega/ubench-analysis1': '6846e2c5434be784',
    'mega/walkers': '6c978589dba29071',
}


def test_earlier_worlds_keep_their_headers():
    """In a fresh interpreter: an error site's id (a constant of the
    emitted body) is its rank among the sites registered in the process,
    so the hashes are those of a process that traces these worlds
    first."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--json"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == HEADER_HASHES


if __name__ == "__main__":
    hashes = world_header_hashes()
    if "--json" in sys.argv:
        print(json.dumps(hashes))
    else:
        for k, v in hashes.items():
            print(f"    {k!r}: {v!r},")

"""The lane code of the fused dispatch kernel (ponyc_tpu_torch/ops/
lanecode.py): behaviour bodies recorded at the ATen level.

- Replaying a body's lane program equals evaluating the body eagerly
  (engine.eval_behaviour), bit for bit, for every body of the shared
  corpus (tests/_torch_programs.py) and the mixed and nbody models.
- The kernel's source (csrc/fused_dispatch.cu plus the emitted bodies)
  built for the host CPU equals the plain dispatch loop. Integer outputs
  are bit-equal. Float outputs are within 8 ulp: torch's CPU sqrt
  (vector code) is not correctly rounded and the host build's sqrtf is;
  every other float op matches bit for bit. (On the card both sides use
  IEEE sqrt, and chip_smoke.py requires every bit.) Skips where there is
  no host C++ compiler.
- A body the kernel cannot run raises NotImplementedError at
  Runtime.start(), naming the behaviour and the ATen op.

This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import ponyc_tpu_torch
from ponyc_tpu_torch import I32, Runtime, RuntimeOptions, actor, behaviour
from ponyc_tpu_torch.models import mixed, nbody
from ponyc_tpu_torch.ops import _build, lanecode, pack
from ponyc_tpu_torch.ops import fused_dispatch as fdm
from ponyc_tpu_torch.program import Program
from ponyc_tpu_torch.runtime.engine import _dtype_of, eval_behaviour

from _torch_programs import define

TT = define(ponyc_tpu_torch)
MIXED = mixed.make_worker_type(4, work=4)

# (actor types of one program, options)
PROGRAMS = [
    ((TT.Pinger,), dict(mailbox_cap=4, batch=4, max_sends=1, msg_words=1)),
    ((TT.RingNode,), dict(mailbox_cap=8, batch=1, max_sends=1,
                          msg_words=1)),
    ((TT.Walker, TT.Splitter), dict(mailbox_cap=4, batch=2, max_sends=2,
                                    msg_words=1)),
    ((TT.Cons, TT.Prod), dict(mailbox_cap=8, batch=2, max_sends=3,
                              msg_words=2)),
    ((TT.Mixer, TT.TriF, TT.Yielder, TT.Exiter, TT.Ephemeral, TT.Errs,
      TT.Arith), dict(mailbox_cap=8, batch=4, max_sends=2, msg_words=2)),
    ((TT.Yielder, TT.Exiter), dict(mailbox_cap=8, batch=4, max_sends=0,
                                   msg_words=1, noyield=True)),
    ((MIXED,), dict(mailbox_cap=4, batch=1, max_sends=1, msg_words=1)),
    ((nbody.Body,), dict(mailbox_cap=16, batch=4, max_sends=1,
                         msg_words=4)),
]
IDS = ["ubench", "ring", "walkers", "fifo", "corpus", "sendless-noyield",
       "mixed", "nbody"]


def _cohorts(types, okw, lanes):
    opts = RuntimeOptions(tuning_cache="off", **okw)
    prog = Program(opts)
    for t in types:
        prog.declare(t, lanes)
    prog.finalize()
    return opts, [prog.by_type[t] for t in types]


def _payload(bdef, width, lanes, rng):
    """Argument words typed by the behaviour's specs."""
    words = rng.integers(-40, 41, (width, lanes)).astype(np.int32)
    off = 0
    for spec in bdef.arg_specs:
        w = pack.spec_width(spec)
        if getattr(spec, "base", spec) is pack.F32:
            words[off:off + w] = rng.uniform(-4, 4, (w, lanes)).astype(
                np.float32).view(np.int32)
        off += w
    return torch.from_numpy(words)


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("types,okw", PROGRAMS, ids=IDS)
def test_replay_equals_eager(types, okw):
    """Every body's lane program, replayed with its recorded ATen ops,
    gives the eager body's fields, sends and effects bit for bit."""
    lanes = 53
    opts, cohorts = _cohorts(types, okw, lanes)
    rng = np.random.default_rng(11)
    for ch in cohorts:
        specs = ch.atype.field_specs
        dtypes = {f: _dtype_of(s) for f, s in specs.items()}
        for bdef in ch.behaviours:
            prog = lanecode.trace_behaviour(
                bdef, field_specs=specs, msg_words=opts.msg_words,
                msg_words_in=ch.msg_words, max_sends=ch.max_sends)
            st = {f: (torch.from_numpy(rng.standard_normal(lanes).astype(
                np.float32)) if dt == torch.float32 else
                torch.from_numpy(rng.integers(-40, 41, lanes).astype(
                    np.int32))) for f, dt in dtypes.items()}
            payload = _payload(bdef, ch.msg_words, lanes, rng)
            ids = torch.arange(lanes, dtype=torch.int32) + 5
            ctx, st2, tgts, words = eval_behaviour(
                bdef, st, payload, ids, msg_words=opts.msg_words,
                field_specs=specs, field_dtypes=dtypes, lanes=lanes,
                max_sends=ch.max_sends)
            r_st, r_tgts, r_words, r_eff = lanecode.replay(
                prog, st, payload, ids)
            where = f"{ch.atype.__name__}.{bdef.name}"
            for f in specs:
                assert torch.equal(_bits(r_st[f]), _bits(st2[f])), where
            assert len(r_tgts) == len(ctx.sends)
            for m in range(len(ctx.sends)):
                assert torch.equal(r_tgts[m], tgts[m]), where
                assert torch.equal(r_words[m], words[m]), where
            for e in lanecode.EFFECTS:
                v = getattr(ctx, e)
                if not isinstance(v, torch.Tensor):
                    assert r_eff[e] is None, (where, e)
                else:
                    assert torch.equal(r_eff[e], v.expand(lanes)), (where, e)


FUSED_OUT = ("fields", "outbox", "head", "any_exit", "exit_code", "nproc",
             "nbad", "destroy", "errors")


def _leaves(x, name):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{name}.{k}")
    elif isinstance(x, tuple):
        names = getattr(x, "_fields", None) or range(len(x))
        for k, v in zip(names, x):
            yield from _leaves(v, f"{name}.{k}")
    else:
        yield name, x


def _ulps(a, b):
    ai, bi = a.view(torch.int32).long(), b.view(torch.int32).long()
    ao = torch.where(ai < 0, -(ai & 0x7fffffff), ai)
    bo = torch.where(bi < 0, -(bi & 0x7fffffff), bi)
    return int((ao - bo).abs().max()) if a.numel() else 0


@pytest.mark.parametrize("types,okw", PROGRAMS, ids=IDS)
def test_host_build_equals_plain_dispatch(types, okw):
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernel's source")
    opts, cohorts = _cohorts(types, okw, 257)
    for ch in cohorts:
        fd = fdm.build_fused_dispatch(ch, opts)
        for seed in range(2):
            inputs = fd.sample_inputs(seed)
            got = dict(zip(FUSED_OUT, fd.run_host(*inputs)))
            want = dict(zip(FUSED_OUT, fd.plain(*inputs)))
            for (name, x), (_, y) in zip(_leaves(got, "out"),
                                         _leaves(want, "out")):
                where = f"{fd.name} seed {seed} {name}"
                if y is None:
                    assert x is None, where
                    continue
                assert x.dtype == y.dtype and x.shape == y.shape, where
                if x.dtype == torch.float32:
                    assert _ulps(x, y) <= 8, where
                else:
                    assert torch.equal(x, y), where


def test_fused_launch_counts_only_kernel_launches():
    """On the CPU the fused dispatch takes its plain version and counts
    no launch; the host build counts none either."""
    opts, (ch,) = _cohorts((TT.Pinger,), PROGRAMS[0][1], 64)
    fd = fdm.build_fused_dispatch(ch, opts)
    before = fdm.FusedDispatch.launches
    out = fd(*fd.sample_inputs(3))
    if _build.host_cxx() is not None:
        fd.run_host(*fd.sample_inputs(3))
    assert fdm.FusedDispatch.launches == before
    assert out[1].tgt.shape == (4 * 64,)
    assert out[1].words.shape == (2, 4 * 64)


def _start(atype):
    rt = Runtime(RuntimeOptions(tuning_cache="off", pallas_fused=True,
                                max_sends=1, msg_words=1), device="cpu")
    rt.declare(atype, 4)
    rt.start()
    return rt


def test_lane_crossing_body_raises_at_start():
    @actor
    class Summer:
        n: I32

        @behaviour
        def go(self, st, v: I32):
            return {**st, "n": st["n"] + v.sum()}

    with pytest.raises(NotImplementedError, match=r"Summer\.go.*aten\.sum"):
        _start(Summer)
    # The plain dispatch does not trace, so start() succeeds there.
    rt = Runtime(RuntimeOptions(tuning_cache="off", max_sends=1,
                                msg_words=1), device="cpu")
    rt.declare(Summer, 4)
    rt.start()


def test_op_without_emitter_raises_at_start():
    @actor
    class Exper:
        x: ponyc_tpu_torch.F32

        @behaviour
        def go(self, st, v: I32):
            return {**st, "x": torch.exp(st["x"])}

    with pytest.raises(NotImplementedError, match=r"Exper\.go.*aten\.exp"):
        _start(Exper)


def test_non_scalar_constant_raises_at_start():
    table = torch.arange(4, dtype=torch.int32)

    @actor
    class Looker:
        n: I32

        @behaviour
        def go(self, st, v: I32):
            return {**st, "n": st["n"] + (table * 2).max()}

    with pytest.raises(NotImplementedError, match=r"Looker\.go"):
        _start(Looker)


def test_host_read_of_a_lane_value_raises_at_start():
    @actor
    class Brancher:
        n: I32

        @behaviour
        def go(self, st, v: I32):
            if (v > 0).any():          # Python control flow on actor data
                return {**st, "n": st["n"] + 1}
            return st

    with pytest.raises(NotImplementedError, match=r"Brancher\.go"):
        _start(Brancher)


def test_emitted_body_mirrors_cuda_spellings():
    """A float divided by a Python scalar is a multiply by the scalar's
    float reciprocal in torch's CUDA kernel (and a division on the CPU);
    pow's exponent 0.5 is sqrt."""
    opts, cohorts = _cohorts((TT.Arith,), PROGRAMS[IDS.index("corpus")][1],
                             8)
    fd = fdm.build_fused_dispatch(cohorts[0], opts)
    cuda, host = fd.source("cuda"), fd.source("host")
    third = "pony_f32(0x3eaaaaabu)"            # float32(1) / float32(3)
    assert f"* {third}" in cuda and "/ pony_f32(0x40400000u)" in host
    assert "sqrtf(" in cuda and "pow" not in cuda.replace("pony_powi", "")

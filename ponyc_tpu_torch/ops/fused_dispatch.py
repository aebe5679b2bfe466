"""The fused dispatch: drain + behaviour + outbox of one cohort in one
kernel (the counterpart of ``ponyc_tpu/ops/fused_dispatch.py``).

≙ the whole of ponyint_actor_run's hot loop (src/libponyrt/actor/
actor.c:383-549) for one cohort: message pop, dispatch into the
behaviour body, and the send path's message construction. The JAX
package runs it as a Pallas TPU kernel over lane blocks that evaluates
every behaviour and selects by message id; here it is the hand-written
CUDA kernel ``csrc/fused_dispatch.cu``, one thread per actor, which runs
only the behaviour its message names. The behaviour bodies reach the
kernel as lane programs (``ops/lanecode.py``): each body is recorded once
at the ATen level and emitted as a C++ function into a per-cohort header
the template includes.

`build_fused_dispatch(cohort, opts, spawn_meta)` traces and emits at
once, so a body the kernel cannot run raises NotImplementedError when the
runtime starts (on the CPU as on the card); `compile_all` builds the
libraries with nvcc (Runtime.start does, on the card). The returned
function takes (fields, buf, head, n_run, ids, resv) and returns what the
plain loop (`fused_dispatch_plain`, the engine's own loop) returns. It
chooses by where its tensors lie and by nothing else: CUDA tensors launch
the kernel (or raise), CPU tensors take the plain version.
`FusedDispatch.launches` counts kernel launches and nothing else.

Device spawns ride through as planes, as in the JAX kernel: the
reservation planes [SPAWN_DISPATCHES * sites, rows] of each target in,
the claim planes [batch * sites, rows] and the sticky spawn fail out.
Eligibility mirrors the JAX package's (ponyc_tpu/ops/fused_dispatch.py:51
and the engine's `not use_blob`, ponyc_tpu/runtime/engine.py:684): a
cohort with at least one behaviour, none of which sync-constructs
(ctx.spawn_sync), that does not use the blob pool; any other cohort takes
the plain loop under `pallas_fused` too.

Regrouping. A warp's 32 threads run one body at a time, so where a
warp's lanes name several behaviours it runs each named body in turn;
and the bodies' machine code is shared by the multiprocessor's warps.
For a cohort whose bodies are costly enough (`regroup_rule`, decided when
the kernel is built, never a runtime option) the kernel orders each
tile's lanes by message id before the bodies run, so that most warps
run one body; a tile whose messages all name one behaviour runs in place
(csrc/fused_dispatch.cu, "The regroup"). The results are the same either
way.
"""

from __future__ import annotations

import ctypes
import re
from typing import List

import numpy as np
import torch

from . import _build, lanecode, pack

# The regroup's tile: TILE lanes a block of TILE_THREADS threads,
# BLOCKS_PER_SM blocks a multiprocessor (csrc/fused_dispatch.cu,
# PONY_TILE, PONY_RT and PONY_BPS; chosen by measurement, PERF.md
# section 6).
TILE, TILE_THREADS, BLOCKS_PER_SM = 2048, 1024, 2
# A cohort is regrouped where a warp holding every behaviour id would run
# at least REGROUP_OPS more ATen ops a lane than one holding the costliest
# alone. At mixed's shape the regroup costs 0.017–0.023 ms more than one
# thread a lane whatever the bodies (0.048 against 0.031 ms with empty
# bodies); it paid from between 364 such ops (8 bodies of 52) and 700 (of
# 100), about 420 by interpolation (PERF.md section 6).
REGROUP_OPS = 448
SMEM_BYTES = 227 * 1024      # shared memory a block may take (H100)


def stage_bytes(fd) -> int:
    """Shared memory of the regroup's tile for the fused dispatch `fd`
    (csrc/fused_dispatch.cu, PonyStage): per lane the state struct (C
    layout), the exit code, error code and site, place, bucket, flags and
    spawn count; and the block's bucket counts."""
    off = align = 1 if not fd.field_names else 0
    for f in fd.field_names:
        n = torch.empty((), dtype=fd.field_dtypes[f]).element_size()
        off = -(-off // n) * n + n           # each field at its alignment
        align = max(align, n)
    lane = (-(-off // align) * align + 4 + 8 * fd.error + 2 + 1 + 1
            + (fd.ns > 0))
    return (TILE * lane + 2 * (len(fd.progs) + 1) * TILE_THREADS
            + 4 * (TILE_THREADS // 32) + 64)


def regroup_rule(fd) -> bool:
    """Whether the fused dispatch `fd` regroups its lanes by message id:
    more than one behaviour, bodies whose ops a warp holding every id
    would run beyond the costliest's reach REGROUP_OPS, and the stages
    of BLOCKS_PER_SM tiles within a multiprocessor's shared memory."""
    if not 1 < len(fd.progs) < 255:
        return False
    ops = sorted(lanecode.op_count(p) for p in fd.progs)
    return (sum(ops) - ops[-1] >= REGROUP_OPS
            and stage_bytes(fd) <= SMEM_BYTES // BLOCKS_PER_SM)


ID_PATTERNS = ("same", "alternate", "odd_one", "descending")


def id_pattern(name: str, nb: int, cap: int, rows: int) -> np.ndarray:
    """Behaviour ids [cap, rows] (local, 0..nb-1) that stress the regroup:
    "same" every message names behaviour 0; "alternate" neighbours
    name 0 and 1; "odd_one" 0 but for one lane a tile; "descending" the
    ids fall along the lanes, nb-1 down to 0, over and over."""
    lane = np.broadcast_to(np.arange(rows), (cap, rows))
    if name == "same":
        return np.zeros((cap, rows), np.int64)
    if name == "alternate":
        return lane % min(2, nb)
    if name == "odd_one":
        return np.where(lane % TILE == TILE // 2 + 1, nb - 1, 0)
    if name == "descending":
        return nb - 1 - lane % nb
    raise ValueError(f"unknown id pattern {name!r}")


def trace_cohort(cohort, opts, spawn_meta=None) -> List:
    """Every behaviour of the cohort as a lane program (ops/lanecode.py),
    spawn sites included; raises NotImplementedError for a body the
    kernels cannot run."""
    from ..runtime.engine import spawn_sites_of
    return [lanecode.trace_behaviour(
        b, field_specs=cohort.atype.field_specs, msg_words=opts.msg_words,
        msg_words_in=cohort.msg_words, max_sends=cohort.max_sends,
        spawn_sites=spawn_sites_of(cohort), spawn_meta=spawn_meta or {})
        for b in cohort.behaviours]


def eligible(cohort, progs) -> bool:
    """The fused kernel serves a cohort with a behaviour, none of whose
    behaviours (`progs`, from `trace_cohort`) sync-constructs, that does
    not use the blob pool."""
    return (len(cohort.behaviours) >= 1 and not cohort.uses_blobs
            and not any(p.sync for p in progs))


def fused_dispatch_plain(cohort, opts, spawn_meta=None):
    """The plain version: the engine's per-cohort drain loop
    (engine._plain_dispatch), with the same signature and results."""
    from ..runtime.engine import _plain_dispatch
    return _plain_dispatch(cohort, opts, spawn_meta)


class FusedDispatch:
    """One cohort's fused dispatch (see the module docstring)."""

    launches = 0          # kernel launches, all cohorts

    def __init__(self, cohort, opts, spawn_meta=None, progs=None,
                 regroup=None):
        from ..runtime.engine import _dtype_of, spawn_sites_of
        self.cohort = cohort
        self.name = cohort.atype.__name__
        specs = cohort.atype.field_specs
        self.field_names: List[str] = list(specs)
        self.field_dtypes = {f: _dtype_of(s) for f, s in specs.items()}
        self.batch = cohort.batch
        self.ms = cohort.max_sends
        self.rows = cohort.local_capacity
        self.w1 = 1 + opts.msg_words
        self.w1_in = 1 + cohort.msg_words
        self.cap = opts.mailbox_cap
        self.noyield = bool(opts.noyield)
        behaviours = list(cohort.behaviours)
        self.base = behaviours[0].global_id
        self.progs = progs if progs is not None else trace_cohort(
            cohort, opts, spawn_meta)
        if not eligible(cohort, self.progs):
            raise ValueError(f"cohort {self.name} sync-constructs or uses "
                             "the blob pool: the fused kernel does not "
                             "serve it")
        self.sites = spawn_sites_of(cohort)
        self.ns = sum(n for _, n in self.sites)
        self.sd = cohort.spawn_dispatches
        self.destroy = any(p.destroy_called for p in self.progs)
        self.error = any(p.error_called for p in self.progs)
        # `regroup`: None = the rule; True/False to build one design or
        # the other (the tests and the profiling scripts).
        self.regroup = regroup_rule(self) if regroup is None \
            else bool(regroup)
        if self.regroup and stage_bytes(self) > SMEM_BYTES:
            raise ValueError(f"cohort {self.name}: the regroup's tile "
                             f"needs {stage_bytes(self)} bytes of shared "
                             f"memory, more than a block's {SMEM_BYTES}")
        self.entry = "pony_fused_" + re.sub(r"\W", "_", self.name)
        self.header = self.source("cuda")      # refusals surface here
        self.plain = fused_dispatch_plain(cohort, opts, spawn_meta)
        self._fn = None

    def source(self, target: str = "cuda") -> str:
        """The generated header for `target` ("cuda" or "host")."""
        return (lanecode.emit_cohort(
            self.progs, name="PonyCohort", field_names=self.field_names,
            field_dtypes=self.field_dtypes, base=self.base,
            batch=self.batch, cap=self.cap, ms=self.ms, w1=self.w1,
            w1_in=self.w1_in, noyield=self.noyield, destroy=self.destroy,
            error=self.error, target=target, spawn_sites=self.sites,
            sd=self.sd)
            + f"#define PONY_ENTRY {self.entry}\n"
            + f"#define PONY_REGROUP {int(self.regroup)}\n"
            + f"#define PONY_TILE {TILE}\n#define PONY_RT {TILE_THREADS}\n"
            + f"#define PONY_BPS {BLOCKS_PER_SM}\n")

    def job(self, host: bool = False) -> _build.Job:
        return _build.Job("fused_dispatch",
                          header=self.source("host") if host else self.header,
                          tag=self.entry, host=host)

    def bind(self, lib: ctypes.CDLL):
        fn = getattr(lib, self.entry)
        fn.argtypes = ([ctypes.c_void_p] * (4 + 2 + 10)
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, fields, buf, head, n_run, ids, resv=()):
        if buf.device.type == "cuda":
            if self._fn is None:
                compile_all([self])
            return self._launch(self._fn, fields, buf, head, n_run, ids,
                                resv)
        if buf.device.type != "cpu":
            raise ValueError(f"fused dispatch: unsupported device "
                             f"{buf.device}")
        return self.plain(fields, buf, head, n_run, ids, resv)

    def run_host(self, fields, buf, head, n_run, ids, resv=()):
        """The kernel's source built for the host CPU and run on CPU
        tensors (the lanes in order, or regrouped tile by tile as the
        kernel runs them). For tests: it holds the generated bodies and
        the regroup against the plain version where there is no card."""
        fn = self.bind(_build.build([self.job(host=True)])[0])
        return self._launch(fn, fields, buf, head, n_run, ids, resv,
                            host=True)

    def sample_inputs(self, seed: int, device="cpu", steady=False,
                      pattern=None):
        """A seeded input (fields, buf, head, n_run, ids, resv) for
        holding the kernel against its plain version: every behaviour id
        plus ids just out of range, argument words typed by the behaviour
        each message names (finite floats for F32 words, small ints else),
        heads next to the int32 wrap, any n_run up to `batch`, and for a
        spawning cohort reservation planes with about one ref in five -1
        (no free slot). `steady`: every lane has `batch` messages, all
        with valid ids (a busy main path). `pattern` (ID_PATTERNS): the
        messages' behaviour ids laid out by `id_pattern` instead."""
        rng = np.random.default_rng(seed)
        rows, nb = self.rows, len(self.progs)
        fields = {}
        for f in self.field_names:
            if self.field_dtypes[f] == torch.float32:
                fields[f] = rng.standard_normal(rows).astype(np.float32)
            else:
                fields[f] = rng.integers(-40, 41, rows).astype(np.int32)
        local = rng.integers(0, nb, (self.cap, rows)) if steady else \
            rng.integers(-1, nb + 1, (self.cap, rows))
        if pattern is not None:
            local = id_pattern(pattern, nb, self.cap, rows)
        buf = rng.integers(-40, 41, (self.cap, self.w1_in, rows)).astype(
            np.int32)
        buf[:, 0, :] = self.base + local
        floats = rng.uniform(-4, 4, buf.shape).astype(np.float32).view(
            np.int32)
        for j, bdef in enumerate(self.cohort.behaviours):
            off = 1
            for spec in bdef.arg_specs:
                width = pack.spec_width(spec)
                base = getattr(spec, "base", spec)
                if base is pack.F32:
                    sel = local == j
                    for w in range(off, off + width):
                        buf[:, w, :][sel] = floats[:, w, :][sel]
                off += width
        head = rng.integers(-2**31, 2**31, rows, dtype=np.int64)
        q = rows // 4
        head[:q] = 2**31 - 1 - rng.integers(0, 2 * self.batch + 1, q)
        head = head.astype(np.int64).astype(np.int32)
        n_run = (np.full(rows, self.batch, np.int32) if steady else
                 rng.integers(0, self.batch + 1, rows).astype(np.int32))
        ids = (self.cohort.local_start + np.arange(rows)).astype(np.int32)

        resv = []
        for _, n in self.sites:
            r = rng.integers(0, 1 << 20, (self.sd * n, rows))
            resv.append(np.where(rng.random(r.shape) < 0.2, -1, r)
                        .astype(np.int32))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return ({f: dev(v) for f, v in fields.items()}, dev(buf),
                dev(head), dev(n_run), dev(ids), tuple(dev(r) for r in resv))

    def _check(self, fields, buf, head, n_run, ids, resv):
        rows = self.rows
        want = [(buf, torch.int32, (self.cap, self.w1_in, rows)),
                (head, torch.int32, (rows,)), (n_run, torch.int32, (rows,)),
                (ids, torch.int32, (rows,))]
        if len(resv) != len(self.sites):
            raise ValueError(f"fused dispatch {self.name}: {len(resv)} "
                             f"reservation planes for {len(self.sites)} "
                             "spawn targets")
        want += [(r, torch.int32, (self.sd * n, rows))
                 for r, (_, n) in zip(resv, self.sites)]
        want += [(fields[f], self.field_dtypes[f], (rows,))
                 for f in self.field_names]
        for t, dt, shape in want:
            if t.dtype != dt or tuple(t.shape) != shape:
                raise ValueError(
                    f"fused dispatch {self.name}: got {t.dtype} "
                    f"{tuple(t.shape)}, expected {dt} {shape}")
            if not t.is_contiguous():
                raise ValueError(f"fused dispatch {self.name} takes "
                                 "contiguous tensors")
            if t.device != buf.device:
                raise ValueError("fused dispatch tensors must share one "
                                 "device")

    def _launch(self, fn, fields, buf, head, n_run, ids, resv=(),
                host=False):
        from ..runtime.delivery import Entries
        self._check(fields, buf, head, n_run, ids, resv)
        dev = buf.device
        rows = self.rows
        e = self.batch * self.ms * rows
        i32 = torch.int32

        def empty(shape, dtype=i32):
            return torch.empty(shape, dtype=dtype, device=dev)

        out_fields = {f: torch.empty_like(fields[f])
                      for f in self.field_names}
        out_tgt, out_words = empty((e,)), empty((self.w1, e))
        new_head = torch.empty_like(head)
        ds = empty((rows,), torch.uint8) if self.destroy else None
        erf = empty((rows,), torch.uint8) if self.error else None
        erc = empty((rows,)) if self.error else None
        erl = empty((rows,)) if self.error else None
        # Reservations of all targets as one [SD * NS, rows] plane, claims
        # as one [BATCH * NS * rows], target by target.
        rv = (resv[0] if len(resv) == 1 else torch.cat(resv)) \
            if resv else None
        clm = empty((self.batch * self.ns * rows,)) if self.ns else None
        red = empty((8,))

        def ptr(t):
            return None if t is None or t.numel() == 0 else t.data_ptr()

        fin = _build.pointers([fields[f] for f in self.field_names])
        fout = _build.pointers([out_fields[f] for f in self.field_names])
        args = ([ptr(buf), ptr(head), ptr(n_run), ptr(ids), fin, fout]
                + [ptr(out_tgt), ptr(out_words), ptr(new_head), ptr(ds),
                   ptr(erf), ptr(erc), ptr(erl), ptr(rv), ptr(clm),
                   ptr(red), rows])
        if host:
            err = fn(*args, None)
        else:
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"fused dispatch kernel {self.name} launch "
                               f"failed: CUDA error {err}")
        if not host:
            FusedDispatch.launches += 1
        out = Entries(tgt=out_tgt, sender=ids.repeat(self.batch * self.ms),
                      words=out_words)
        bytes_ = red.view(torch.uint8)
        any_exit = bytes_[12].view(torch.bool)
        claims, at = [], 0
        for _, n in self.sites:
            claims.append(clm[at:at + self.batch * n * rows])
            at += self.batch * n * rows
        return (out_fields, out, new_head, any_exit, red[2], red[0],
                red[1], None if ds is None else ds.view(torch.bool),
                None if erf is None else (erf.view(torch.bool), erc, erl),
                tuple(claims), (None,) * len(self.sites),
                bytes_[28].view(torch.bool) if self.sites else None)


def build_fused_dispatch(cohort, opts, spawn_meta=None, progs=None,
                         regroup=None) -> FusedDispatch:
    """The fused dispatch of one eligible cohort: fn(fields, buf, head,
    n_run, ids, resv) with the plain loop's results. Traces and emits
    every behaviour now (raising NotImplementedError for a body the
    kernel cannot run; `progs` from `trace_cohort` saves the trace); the
    kernel itself builds at `compile_all` or first use. `regroup`: None
    for `regroup_rule`'s choice, True or False to force one design."""
    if not cohort.behaviours:
        raise ValueError(f"cohort {cohort.atype.__name__} has no "
                         "behaviour to fuse")
    return FusedDispatch(cohort, opts, spawn_meta, progs, regroup)


def compile_all(fds: List[FusedDispatch], log=None) -> None:
    """Build every cohort's kernel at once (one nvcc each) and bind it."""
    todo = [fd for fd in fds if fd._fn is None]
    libs = _build.build([fd.job() for fd in todo], log)
    for fd, lib in zip(todo, libs):
        fd._fn = fd.bind(lib)

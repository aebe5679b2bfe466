"""Smoke run of the PyTorch port (ponyc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--only PHASE,PHASE,...]

Phases, each of which must pass (the exit code is non-zero otherwise).
Three paths run: the plain tick (drain kernel), the fused dispatch kernel
(pallas_fused) and the window kernel (delivery="pallas_mega").

  1. build    — compile every CUDA kernel the run uses from csrc/ (the
                drain, the fused dispatch kernel of every cohort and the
                window kernel of every program below, one nvcc each, all
                started together) and load them; prints each build's
                time, ptxas's registers and spills, and each window
                kernel's occupancy and cooperative grid;
  2. kernels  — each kernel against its plain PyTorch version on the
                card, at the shapes the main paths give it and at edge
                shapes: the drain bit for bit; the fused kernel on a
                seeded input at ubench's, mixed's and nbody's shapes and
                on the small-world corpus at 1, 257 and 1000 lanes with
                heads wrapping past 2**31-1, every output bit for bit
                (floats compared as bits). Times of each kernel, its
                plain version and (for the drain) one library call
                computing the same function (a yardstick the port never
                calls): the device time a call (torch.profiler; for the
                kernels, their own kernel only) and the wall a call
                (CUDA events, the host's enqueue included), beside the
                least time the card could take (its bound, from this
                run's data);
     kernels-mega — the window kernel against the plain window, every
                state leaf, aux value and ticks_run bit for bit: the
                four main paths at full width (ubench with and without
                payloads past int16; ubench at 2**20 lanes with 2048
                pingers seeded; with the radix sort forced, all seeded
                and 256 seeded, whose ticks' live entries fit one tile:
                ubench's own ticks take the segment sort), two 16-tick
                windows each,
                the gated-out window and the forced spelling; and every
                window of Runtime.run() on the agree phase's worlds with
                heads and tails moved next to 2**31-1. Device and wall
                time a window, the plain window's, one CUDA-graph replay
                of the plain forced window (a yardstick) and the bound;
                and the kernel's per-phase clock, one `phases` line per
                world (device us a tick of each phase). `--only
                kernels-mega` runs this phase alone;
  3. agree    — small worlds run on the card and on the CPU give equal
                fields and counters on all three paths (the CPU path is
                the one the test suite holds against the JAX package);
  4. ubench   — message-ubench through Runtime at 2**20 pingers,
                pings=4 (bench.py's defaults): three timed windows of a
                fixed number of ticks after warm-up, on each path; every
                pinger processes `pings` messages a tick and the path's
                kernel launches once a tick (once a window for the
                window kernel);
  5. ring     — the token ring, 1024 nodes, 4096 hops (2048 on the
                plain and fused paths, whose hops take milliseconds), through
                Runtime.run(), on each path: the pass count, the exit
                code, and one launch of the path's kernel per enqueued
                tick (ticks run plus the ticks enqueued but predicated
                off on the device), or one window kernel per window;
  6. mixed    — the mixed model at 2**20 workers, 8 behaviours, 64
                dependent float rounds a body, every tick carrying every
                behaviour id: 16 ticks on each path; the processed count
                exact and `done`/`acc` equal bit for bit across paths;
  7. nbody    — one all-pairs round at 1024 bodies with the fused and
                the window kernel, against the NumPy oracle
                (`reference_accels`);
  8. spawn    — the spawn tree (models/spawn_tree.py) at depth 20: 2**20
                leaves, 2**21 - 1 actors created on the device, Node
                declared at 2**22 rows, through Runtime.run() on each
                path: exit code 2**20, n_spawned 2**21 - 2, the parent,
                acc and pending columns and the alive mask equal across
                the paths, one launch of the path's kernel per tick
                enqueued (a window kernel per window), ms a tick;
  9. host     — host cohorts (HOST = True actors): the `hostlog` world,
                2**20 walkers (`nxt` a random permutation from the seed)
                reporting 2**12 chains (lengths uniform in 1..256) into
                one host actor (tests/_torch_programs.py's WalkerH and
                HostLog, the reference's program; cap 4, batch 1, 2
                words, 2 sends, spill 8192, inject 16), through
                Runtime.run() on each path: every walker's acc equal to
                a NumPy oracle of the chains (exact int64 sums),
                HostLog.ends = 2**12, exit code 0; fields, counters,
                host_processed, ticks run and windows equal across the
                paths; one launch of the path's kernel per tick enqueued
                (a window kernel per window), the windows the device
                ended for the host (host_pending), wall a run; under
                pallas_mega a second run whose first windows and every
                128th run the host C++ build of the window kernel on the
                same input too, bit-equal to the card, and the kernel's
                per-phase clock on this world (a forced window). Then
                examples/spreader.py's program at depth 12 (device
                spawns and a host collector, no promise) on each path:
                got = 2**12;
 10. profile  — kernels launched a tick and the device's busy share
                (torch.profiler; the window kernel by CUDA events around
                its launches) for ubench and mixed on each path.

Device spawns run through all three kernels: the fused kernel's spawn
planes are checked in `kernels` on the spawning cohorts (the tree's Node
at 2**22 lanes, timed there too), the window kernel's spawn phases in
`kernels-mega` on the tree at depth 20 (a world whose per-phase line
shows the census and reserve phases; the other worlds have none), and
`agree` runs the tree, the spawn/destroy churn and a spawn_sync world on
the card and the CPU. Each run prints, per cohort, whether the fused
kernel or the plain dispatch ran it (a cohort that sync-constructs takes
the plain dispatch, as in the JAX package).

Host cohorts take delivery on every path; the window kernel's host rows
are checked in `kernels-mega` on the hostlog world at full width (the
gated windows, which stop for the host, and a forced window, timed), and
`agree` runs a small host reporting world on the card and the CPU.
`--only host` runs the build and the host phase.

Output: the card's name and power limit (nvidia-smi) first, one line per
phase, one JSON line listing every kernel, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device it prints no result
and exits 1. The script imports nothing of JAX or of the JAX package.
`--only` runs a subset (the build always runs); the run is then not a
full smoke run and prints no final line.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # H100 SXM data sheet (HBM3)
H100_F32_OPS_PER_S = 67e12      # H100 SXM, float32 outside tensor cores
FAILED = []
ROOT = os.path.dirname(os.path.abspath(__file__))


def phase(name):
    def deco(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
            except Exception as e:                    # noqa: BLE001
                import traceback
                traceback.print_exc()
                FAILED.append(name)
                print(f"[{name}] FAILED: {type(e).__name__}: {e}",
                      flush=True)
                return None
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return out
        return run
    return deco


def cuda_ms(fn, reps, inputs, warm=3):
    """Mean ms per call over `reps` calls, cycling through `inputs`
    (sets whose total exceeds the 50 MB L2, so each call reads its
    operands from device memory), timed with CUDA events after `warm`
    calls."""
    import torch
    for i in range(warm):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(reps):
        fn(*inputs[i % len(inputs)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps, inputs, match=None, warm=3):
    """Device time per call (ms): the summed time, from torch.profiler, of
    what the calls ran on the card (kernels, memsets), over `reps` calls
    after `warm` calls; `match` keeps only kernels whose name contains
    it. Unlike cuda_ms it leaves out the host's enqueue time, which for a
    call that launches little can exceed the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprof
    for i in range(warm):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and (
                match is None or match in evt.key):
            us += _device_us(evt)
    if us <= 0:
        raise AssertionError(f"the profiler saw no device time"
                             f"{f' for {match}' if match else ''}")
    return us / reps / 1e3


def gpu_warm(seconds=1.0):
    """Keep the card busy for a moment, so that timings start at its
    working clocks and not at idle ones."""
    import torch
    x = torch.ones((4096, 4096), device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        x = x * 1.0001
        torch.cuda.synchronize()


def drain_inputs(torch, cap, w1, n, batch, seed, wrap=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randint(-2**31, 2**31 - 1, (cap, w1, n), dtype=torch.int32,
                        device="cuda", generator=g)
    head = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                         device="cuda", generator=g)
    if wrap:     # heads next to 2**31-1 (wrap now) and below 0 (wrapped)
        q = n // 3
        head[:q] = 2**31 - 1 - torch.arange(q, device="cuda",
                                            dtype=torch.int32) % (2 * batch)
        head[q:2 * q] = -2**31 + torch.arange(
            q, device="cuda", dtype=torch.int32) % (2 * batch)
    n_run = torch.randint(0, batch + 1, (n,), dtype=torch.int32,
                          device="cuda", generator=g)
    return buf, head, n_run


# ---- the programs and options the run uses ------------------------------

MIXED_B, MIXED_WORK = 8, 64
_CACHE = {}


def programs():
    """The shared small-world programs (tests/_torch_programs.py, which
    imports numpy and the package it is given, nothing else)."""
    if "tp" not in _CACHE:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import _torch_programs as tp
        import ponyc_tpu_torch
        _CACHE["tp"] = (tp, tp.define(ponyc_tpu_torch))
    return _CACHE["tp"]


def _mode_kw(mode):
    """Options of a path: False = the plain tick (drain kernel), True =
    the fused dispatch kernel (pallas_fused), "mega" = the window kernel
    (delivery="pallas_mega")."""
    if mode == "mega":
        return dict(pallas_fused=False, delivery="pallas_mega")
    return dict(pallas_fused=bool(mode), delivery="plan")


def _mode_name(mode):
    return "pallas_mega" if mode == "mega" else f"pallas_fused={mode}"


def ubench_opts(fused, ticks=64):
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=4, batch=4, max_sends=1, msg_words=1,
                          spill_cap=1024, inject_slots=8,
                          quiesce_interval=ticks, tuning_cache="off",
                          **_mode_kw(fused))


def ring_opts(fused):
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=8, batch=1, max_sends=1, msg_words=1,
                          tuning_cache="off", **_mode_kw(fused))


def mixed_opts(fused, ticks=16):
    # profiling/_hetero.py's options (cap 4, batch 1, one send of one word)
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=4, batch=1, max_sends=1, msg_words=1,
                          spill_cap=256, inject_slots=8,
                          quiesce_interval=ticks, tuning_cache="off",
                          **_mode_kw(fused))


def nbody_opts(fused):
    # ponyc_tpu/models/nbody.py's defaults
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=16, batch=4, max_sends=1, msg_words=4,
                          spill_cap=1024, tuning_cache="off",
                          **_mode_kw(fused))


SPAWN_DEPTH = 20         # the spawn tree on the card: 2^21 - 1 nodes


def spawn_opts(mode, ticks=16):
    # examples/spawn_tree.py's options
    from ponyc_tpu_torch.models import spawn_tree
    return spawn_tree.options(quiesce_interval=ticks, tuning_cache="off",
                              **_mode_kw(mode))


def corpus_opts():
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=8, batch=4, max_sends=2, msg_words=2,
                          tuning_cache="off", pallas_fused=True)


HOST_WALKERS = 1 << 20    # the hostlog world on the card
HOST_CHAINS = 1 << 12
HOST_SEED = 2026
SPREAD_DEPTH = 12         # examples/spreader.py's program on the card


def hostlog_kw(mode):
    # tests/test_differential.py's host reporting options, the spill
    # raised for 2^12 chains
    return dict(mailbox_cap=4, batch=1, msg_words=2, max_sends=2,
                spill_cap=8192, inject_slots=16, **_mode_kw(mode))


def hostlog_plan(n=HOST_WALKERS, chains=HOST_CHAINS, seed=HOST_SEED,
                 max_len=256):
    """The hostlog world's wiring and traffic from the seed: (nxt, a
    permutation of the walkers; the chains' start walkers, distinct; their
    lengths, uniform in 1..max_len), and the NumPy oracle of every walker's acc
    (exact int64 sums: a chain of length L visits its start with L, the
    next walker with L - 1, ..., and the last with 0, which reports)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    nxt = rng.permutation(n)
    starts = rng.choice(n, chains, replace=False)
    lens = rng.integers(1, max_len + 1, chains)
    acc = np.zeros(n, np.int64)
    pos, v = starts.copy(), lens.copy()
    while (v >= 0).any():
        live = v >= 0
        np.add.at(acc, pos[live], v[live])
        pos, v = nxt[pos], v - 1
    return nxt, starts, lens, acc


def hostlog_build(mode, plan, device="cuda"):
    """The hostlog world, started and seeded (the chains' first messages
    straight into their start walkers' mailboxes): (runtime, the host
    actor's id)."""
    import numpy as np
    import ponyc_tpu_torch
    tp, T = programs()
    nxt, starts, lens, _acc = plan
    n = len(nxt)
    rt = tp.new_runtime(ponyc_tpu_torch, hostlog_kw(mode), device)
    rt.declare(T.WalkerH, n).declare(T.HostLog, 1).start()
    ids = rt.spawn_many(T.WalkerH, n)
    log = rt.spawn(T.HostLog)
    rt.set_fields(T.WalkerH, ids, nxt=ids[nxt], log=np.full(n, log))
    rt.bulk_send(ids[starts], T.WalkerH.step, lens.astype(np.int32))
    return rt, log


def spread_build(mode, depth=SPREAD_DEPTH, device="cuda"):
    """examples/spreader.py's world (its options; Spread declared at 4 x
    2^depth rows) without the promise: (runtime, the collector's id)."""
    import ponyc_tpu_torch
    tp, T = programs()
    rt = tp.new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=8, batch=2, max_sends=5, msg_words=2, spill_cap=4096,
        inject_slots=8, **_mode_kw(mode)), device)
    rt.declare(T.Spread, 4 << depth).declare(T.Collect, 1).start()
    col = rt.spawn(T.Collect, got=0)
    root = rt.spawn(T.Spread, col=int(col))
    rt.send(root, T.Spread.go, depth)
    return rt, col


def mixed_type():
    if "mixed" not in _CACHE:
        from ponyc_tpu_torch.models import mixed
        _CACHE["mixed"] = mixed.make_worker_type(MIXED_B, work=MIXED_WORK)
    return _CACHE["mixed"]


# The small worlds of the agree phase (tests/_torch_programs.py).
WALKERS_KW = dict(mailbox_cap=4, batch=1, msg_words=1, max_sends=2,
                  spill_cap=512, inject_slots=16)
MIXERS_KW = dict(msg_words=2)


def fused_cases():
    """(label, actor types, options, lanes) of every fused kernel the run
    builds and checks: the main shapes, the corpus at ragged widths, and
    the cohorts of the agree phase's small worlds."""
    import ponyc_tpu_torch
    from ponyc_tpu_torch import RuntimeOptions
    from ponyc_tpu_torch.models import nbody, ring, spawn_tree, ubench
    tp, _T = programs()
    cases = [("ubench", [ubench.Pinger], ubench_opts(True), 1 << 20),
             ("mixed", [mixed_type()], mixed_opts(True), 1 << 20),
             ("nbody", [nbody.Body], nbody_opts(True), 1024),
             ("ring", [ring.RingNode], ring_opts(True), 1024),
             ("spawn_tree", [spawn_tree.Node], spawn_opts(True),
              4 << SPAWN_DEPTH)]
    # Each program below gets actor types of its own: a behaviour's
    # global id belongs to its definition and is set by the last program
    # that declared it, and the plain version reads it when it runs.
    for n in (1, 257, 1000):
        T = tp.define(ponyc_tpu_torch)
        cases.append((f"corpus N={n}", [T.Mixer, T.TriF, T.Yielder,
                                         T.Exiter, T.Ephemeral, T.Errs,
                                         T.Arith], corpus_opts(), n))
    T = tp.define(ponyc_tpu_torch)
    cases.append(("hostlog", [T.WalkerH, T.HostLog],
                  RuntimeOptions(tuning_cache="off", **hostlog_kw(True)),
                  HOST_WALKERS))
    T = tp.define(ponyc_tpu_torch)
    cases.append((f"spreader depth {SPREAD_DEPTH}", [T.Spread, T.Collect],
                  RuntimeOptions(
                      mailbox_cap=8, batch=2, max_sends=5, msg_words=2,
                      spill_cap=4096, inject_slots=8, tuning_cache="off",
                      pallas_fused=True), 4 << SPREAD_DEPTH))
    T = tp.define(ponyc_tpu_torch)
    cases.append(("spawn corpus N=257", [T.Boss, T.Worker, T.Spawner,
                                         T.SpawnChild, T.Relay, T.Temp,
                                         T.Collector], corpus_opts(), 257))
    worlds = [("walkers", ("Walker", "Splitter"), WALKERS_KW),
              ("mixers", ("Mixer",), MIXERS_KW)]
    worlds += [(n, names, kw) for n, (names, kw) in tp.CORPUS_WORLDS.items()]
    for n, names, kw in worlds:
        T = tp.define(ponyc_tpu_torch)
        cases.append((f"agree {n}", [getattr(T, t) for t in names],
                      RuntimeOptions(tuning_cache="off", pallas_fused=True,
                                     **kw), 64))
    return cases


def fused_dispatches(types, opts, lanes):
    """The fused dispatch of every eligible device cohort of a program
    declaring `types` at `lanes` rows each (a cohort that sync-constructs
    has none: it takes the plain dispatch)."""
    from ponyc_tpu_torch.ops import fused_dispatch as fdm
    from ponyc_tpu_torch.program import Program
    from ponyc_tpu_torch.runtime.engine import spawn_meta_of
    prog = Program(opts)
    for t in types:
        prog.declare(t, lanes)
    prog.finalize()
    out = []
    for t in types:
        ch = prog.by_type[t]
        if ch.host:            # host cohorts run on the host
            continue
        meta = spawn_meta_of(prog, ch)
        progs = fdm.trace_cohort(ch, opts, meta)
        if fdm.eligible(ch, progs):
            out.append(fdm.build_fused_dispatch(ch, opts, meta, progs))
    return out


def dispatch_paths(rt):
    """Per cohort of a started Runtime, the dispatch its ticks take:
    "fused kernel" or "plain dispatch" (the window kernel runs every
    cohort itself)."""
    from ponyc_tpu_torch.ops.megakernel import MegaWindow
    mw = rt._multi_g
    if isinstance(mw, MegaWindow):
        return {ch.atype.__name__: "window kernel"
                for ch in rt.program.device_cohorts}
    fused = {fd.name for fd in mw.fused}
    return {ch.atype.__name__: "fused kernel" if ch.atype.__name__ in fused
            else "plain dispatch" for ch in rt.program.device_cohorts}


@phase("build")
def build_kernels():
    from ponyc_tpu_torch.ops import _build
    from ponyc_tpu_torch.ops import fused_dispatch as fdm
    t0 = time.perf_counter()
    fused = _CACHE["fused"] = {}
    for label, types, opts, lanes in fused_cases():
        fused[label] = fused_dispatches(types, opts, lanes)
    every = [fd for fds in fused.values() for fd in fds]
    unique = list({fd.header: fd for fd in every}.values())
    print(f"traced and emitted {len(every)} cohorts' bodies "
          f"({len(unique)} distinct kernels) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    logs = []
    t0 = time.perf_counter()
    megas = _CACHE["mega"] = mega_windows()
    mega_unique = list({mw.header: mw for mw in megas.values()}.values())
    print(f"traced and emitted {len(megas)} programs' window kernels "
          f"({len(mega_unique)} distinct)", flush=True)
    _build.build([_build.Job("drain")] + [fd.job() for fd in unique]
                 + [mw.job() for mw in mega_unique], log=logs.append)
    for text in logs:
        head, _, body = text.partition("\n")
        print(head, flush=True)
        for line in body.splitlines():
            if re.search(r"registers|spill", line):
                print("   ", line.strip(), flush=True)
    fdm.compile_all(every)
    for label, mw in megas.items():
        mw.build()
        print(f"window kernel {label} ({mw.tag}): {mw.info}", flush=True)
    print(f"built drain + {len(unique)} fused + {len(mega_unique)} window "
          f"kernels in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(_build.FUSED_FLAGS)}; the drain without -fmad=false)",
          flush=True)
    return True


def force_radix(mw):
    """The window kernel `mw` with the segment sort ruled out, so that
    every tick takes the radix sort (its source regenerated; build() then
    builds it)."""
    mw.world.update(SEG=-1)
    mw.header = mw.source("cuda")
    return mw


def mega_windows():
    """The window kernel of every program the run drives with
    delivery="pallas_mega": the main paths, the hostlog world and the
    spreader at full width (from their Programs) and the agree phase's
    small worlds (started on the CPU, which traces and emits without
    building)."""
    import ponyc_tpu_torch
    from ponyc_tpu_torch import RuntimeOptions
    from ponyc_tpu_torch.models import nbody, ring, spawn_tree, ubench
    from ponyc_tpu_torch.program import Program
    from ponyc_tpu_torch.runtime import engine
    tp, _T = programs()

    def window(atype, n, opts, more=()):
        prog = Program(opts)
        prog.declare(atype, n)
        for t, m in more:
            prog.declare(t, m)
        prog.finalize()
        return engine.build_multi_step_gated(prog, opts)

    host_t, spread_t = tp.define(ponyc_tpu_torch), tp.define(ponyc_tpu_torch)

    out = {"ubench": window(ubench.Pinger, 1 << 20, ubench_opts("mega")),
           "ubench, radix sort": force_radix(window(
               ubench.Pinger, 1 << 20, ubench_opts("mega", MEGA_TICKS))),
           "mixed": window(mixed_type(), 1 << 20, mixed_opts("mega")),
           "ring": window(ring.RingNode, 1024, ring_opts("mega")),
           "nbody": window(nbody.Body, 1024, nbody_opts("mega")),
           "spawn tree": window(spawn_tree.Node, 4 << SPAWN_DEPTH,
                                spawn_opts("mega")),
           "hostlog": window(host_t.WalkerH, HOST_WALKERS, RuntimeOptions(
               tuning_cache="off", **hostlog_kw("mega")),
               [(host_t.HostLog, 1)]),
           "spreader": window(spread_t.Spread, 4 << SPREAD_DEPTH,
                              RuntimeOptions(
                                  mailbox_cap=8, batch=2, max_sends=5,
                                  msg_words=2, spill_cap=4096,
                                  inject_slots=8, tuning_cache="off",
                                  **_mode_kw("mega")),
                              [(spread_t.Collect, 1)])}
    for name, build, _finish in agree_worlds():
        out[f"agree {name}"] = build("cpu", "mega")._multi_g
    return out


def _leaves(x, name="out"):
    import dataclasses
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


FUSED_OUT = ("fields", "outbox", "head", "any_exit", "exit_code", "nproc",
             "nbad", "destroy", "errors", "claims", "inits", "spawn_fail")


def compare_fused(a, b, label):
    """Every output of the fused kernel (a) against its plain version
    (b), bit for bit (floats compared as their bits). Returns (max abs
    error, max ulp distance, outputs compared); raises on a difference."""
    return compare_pairs(zip(_leaves(dict(zip(FUSED_OUT, a))),
                             _leaves(dict(zip(FUSED_OUT, b)))), label,
                         "fused kernel")


def compare_window(a, b, label):
    """A window kernel's (state, aux, ticks_run) against the plain
    window's, every leaf bit for bit (floats as their bits)."""
    return compare_pairs(zip(_leaves(a), _leaves(b)), label,
                         "window kernel")


def compare_pairs(pairs, label, what):
    """Each (name, x), (name, y) pair bit for bit. Returns (max abs
    error, max ulp distance, outputs compared); raises on a difference."""
    import torch
    max_err, max_ulp, n = 0.0, 0, 0
    for (name, x), (_, y) in pairs:
        if x is None or y is None:
            if not (x is None and y is None):
                raise AssertionError(f"{label}: {name} is None on one side")
            continue
        n += 1
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{label}: {name} {x.dtype}{tuple(x.shape)}"
                                 f" vs {y.dtype}{tuple(y.shape)}")
        if x.dtype == torch.float32:
            xi, yi = x.view(torch.int32).long(), y.view(torch.int32).long()
            # ulp distance on the ordered integer line of float bits
            xo = torch.where(xi < 0, -(xi & 0x7fffffff), xi)
            yo = torch.where(yi < 0, -(yi & 0x7fffffff), yi)
            if x.numel():
                max_ulp = max(max_ulp, int((xo - yo).abs().max()))
                d = (x.double() - y.double()).abs().nan_to_num(0.0)
                max_err = max(max_err, float(d.max()))
            same = torch.equal(xi, yi)
        else:
            if x.numel():
                max_err = max(max_err, float(
                    (x.long() - y.long()).abs().max()))
            same = torch.equal(x, y)
        if not same:
            bad = int((x != y).sum()) if x.dtype != torch.float32 else \
                int((x.view(torch.int32) != y.view(torch.int32)).sum())
            raise AssertionError(f"{label}: {what} differs from its "
                                 f"plain version in {name} ({bad} of "
                                 f"{x.numel()} values; max abs err "
                                 f"{max_err}, max ulp {max_ulp})")
    return max_err, max_ulp, n


def fused_bound(fd, inputs, out):
    """The least time the card could take for this call (ms), and which
    term bounds it: bytes it must move (each input read once, each output
    written once, mailbox words only of the slots this data consumes)
    over 3.35 TB/s, and the ATen ops of the one body each consumed
    message runs over the float32 peak."""
    import torch
    from ponyc_tpu_torch.ops import lanecode
    fields, buf, head, n_run, ids, resv = inputs
    rows = fd.rows
    consumed = ((out[2].long() - head.long()) & 0xffffffff)
    fbytes = sum(t.numel() * t.element_size() for t in fields.values())
    read = (fbytes + 3 * 4 * rows + int(consumed.sum()) * fd.w1_in * 4
            + sum(4 * r.numel() for r in resv))
    e = fd.batch * fd.ms * rows
    write = (fbytes + 4 * e + 4 * fd.w1 * e + 4 * rows
             + (rows if fd.destroy else 0) + (9 * rows if fd.error else 0)
             + 4 * fd.batch * fd.ns * rows)
    ops = 0
    lanes = torch.arange(rows, device=buf.device)
    for k in range(fd.batch):
        act = consumed > k
        slot = ((head.long() + k) & (fd.cap - 1))
        local = buf[slot, 0, lanes].long() - fd.base
        for j, prog in enumerate(fd.progs):
            ops += int(((local == j) & act).sum()) * lanecode.op_count(
                prog)
    t_bytes = (read + write) / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", read + write, ops, t_bytes, t_ops)


@phase("kernels")
def check_kernels(rec, frec):
    import torch
    from ponyc_tpu_torch.ops import mailbox_kernel as mk
    shapes = [  # (cap, w1, N, batch, wrapped heads)
        (4, 2, 1 << 20, 4, False),       # ubench's shape
        (4, 2, 1 << 20, 1, False),       # the hostlog world's walkers
        (8, 2, 1024, 1, False),          # the ring's shape
        (8, 2, 1024, 1, True),           # ... with wrapped heads
        (64, 2, 1000, 8, True),          # edge: ragged N, big cap
        (4, 2, 1000, 4, True), (8, 3, 1, 8, True), (2, 1, 257, 1, True),
    ]
    before = mk.drain_msgs.launches
    max_err = 0
    for i, (cap, w1, n, batch, wrap) in enumerate(shapes):
        buf, head, n_run = drain_inputs(torch, cap, w1, n, batch, 10 + i,
                                        wrap)
        km, kv = mk.drain_msgs(buf, head, n_run, batch)
        torch.cuda.synchronize()
        pm, pv = mk.drain_msgs_plain(buf, head, n_run, batch)
        err = int((km.long() - pm.long()).abs().max()) if km.numel() else 0
        max_err = max(max_err, err, int((kv != pv).sum()))
        if not (torch.equal(km, pm) and torch.equal(kv, pv)):
            raise AssertionError(f"drain kernel differs from its plain "
                                 f"version at cap={cap} w1={w1} N={n} "
                                 f"batch={batch}")
        print(f"drain cap={cap} w1={w1} N={n} batch={batch} "
              f"wrapped_heads={wrap}: bit-equal", flush=True)
    # Times at the main path's shape.
    gpu_warm()
    cap, w1, n, batch = 4, 2, 1 << 20, 4
    sets = [drain_inputs(torch, cap, w1, n, batch, 40 + s)
            for s in range(3)]
    lib_sets = []
    for buf, head, n_run in sets:
        ks = torch.arange(batch, dtype=torch.int32, device="cuda")
        idx = ((head[None, :] + ks[:, None]) & (cap - 1)).long()
        lib_sets.append((buf, idx[:, None, :].expand(batch, w1, n)
                         .contiguous()))
    def kern(b, h, r):
        return mk.drain_msgs(b, h, r, batch)

    def plain(b, h, r):
        return mk.drain_msgs_plain(b, h, r, batch)

    def lib(b, idx):
        return torch.gather(b, 0, idx)

    t = dict(ms=device_ms(kern, 50, sets, "drain_kernel"),
             plain_ms=device_ms(plain, 50, sets),
             library_ms=device_ms(lib, 50, lib_sets),
             call_ms=cuda_ms(kern, 50, sets),
             plain_call_ms=cuda_ms(plain, 50, sets),
             library_call_ms=cuda_ms(lib, 50, lib_sets))
    launched = mk.drain_msgs.launches - before
    nbytes = 2 * batch * w1 * n * 4 + 8 * n + batch * n
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"drain at cap={cap} w1={w1} N={n} batch={batch}, device time "
          f"a call: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
          f"ms, torch.gather {t['library_ms']:.4f} ms; wall a call "
          f"(host enqueue included): {t['call_ms']:.4f}, "
          f"{t['plain_call_ms']:.4f}, {t['library_call_ms']:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s); "
          f"kernel at {100 * bound_ms / t['ms']:.1f}% of the bound "
          f"({launched} comparison/timing launches, not counted below)",
          flush=True)
    rec.update(name="mailbox_drain", route="cuda",
               source="ponyc_tpu_torch/csrc/drain.cu",
               replaces="ponyc_tpu/ops/mailbox_kernel.py:49",
               max_abs_err=max_err, bit_equal=max_err == 0,
               bound_ms=bound_ms, bound_by="bytes", **t)

    # The fused kernel: every output against its plain version.
    checked, f_err, f_ulp = [], 0.0, 0
    for label, fds in _CACHE["fused"].items():
        for fd in fds:
            inputs = fd.sample_inputs(seed=len(checked) + 1, device="cuda")
            got = fd(*inputs)
            torch.cuda.synchronize()
            want = fd.plain(*inputs)
            err, ulp, nout = compare_fused(got, want, f"{label} {fd.name}")
            f_err, f_ulp = max(f_err, err), max(f_ulp, ulp)
            checked.append(f"{label}:{fd.name}")
            spawns = ""
            if fd.sites:
                clm = torch.cat(want[9])
                spawns = (f", {fd.ns} spawn sites: {int((clm >= 0).sum())} "
                          f"claims, spawn fail {bool(want[11])}")
            print(f"fused {label} {fd.name} ({fd.rows} lanes, cap "
                  f"{fd.cap}, w1_in {fd.w1_in}, w1 {fd.w1}, batch "
                  f"{fd.batch}, ms {fd.ms}, {len(fd.progs)} behaviours): "
                  f"{nout} outputs bit-equal (nproc {int(want[5])}, nbad "
                  f"{int(want[6])}, exit {bool(want[3])}{spawns})",
                  flush=True)
    times = {}
    for label in ("ubench", "mixed", "spawn_tree"):
        fd = _CACHE["fused"][label][0]
        sets = [fd.sample_inputs(seed=100 + s, device="cuda", steady=True)
                for s in range(3)]
        reps = 10 if label == "ubench" else 3
        t = dict(ms=device_ms(fd, 20, sets, "pony_fused_kernel"),
                 plain_ms=device_ms(fd.plain, reps, sets),
                 call_ms=cuda_ms(fd, 20, sets),
                 plain_call_ms=cuda_ms(fd.plain, reps, sets))
        out = fd(*sets[0])
        compare_fused(out, fd.plain(*sets[0]), f"{label} steady")
        b_ms, b_by, nbytes, ops, t_b, t_o = fused_bound(fd, sets[0], out)
        times[label] = dict(bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                            ops=ops, bytes_ms=t_b, ops_ms=t_o, **t)
        print(f"fused at {label}'s shape ({fd.rows} lanes, every lane "
              f"full), device time a call: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms; wall a call (host enqueue "
              f"included): {t['call_ms']:.4f}, {t['plain_call_ms']:.4f} "
              f"ms; bound {b_ms:.4f} ms by {b_by} (bytes "
              f"{nbytes / 1e6:.1f} MB -> {t_b:.4f} ms at 3.35 TB/s; "
              f"{ops:.4g} ATen ops -> {t_o:.4f} ms at 67 TFLOP/s); kernel "
              f"at {100 * b_ms / t['ms']:.1f}% of the bound", flush=True)
    frec.update(name="fused_dispatch", route="cuda",
                source="ponyc_tpu_torch/csrc/fused_dispatch.cu",
                replaces="ponyc_tpu/ops/fused_dispatch.py:97",
                max_abs_err=f_err, max_ulp=f_ulp, bit_equal=f_ulp == 0
                and f_err == 0, shapes=checked, library_ms=None,
                **times["ubench"], mixed=times["mixed"],
                spawn_tree=times["spawn_tree"])
    return True


MEGA_TICKS = 16          # ticks a window in the window kernel's checks


def mega_bound(mw, ticks, processed, live, branch):
    """The least time (ms) the card could take for `ticks` ticks of this
    program's window, and which term bounds it, from the bytes the window
    has to move whatever the design: the per-lane state (head, tail,
    flags, mute tables, error columns, fields) and every mailbox ring (4
    bytes a word) read once and written once a tick, and the last tick's
    `plan_key`, `plan_perm` and `plan_bounds` written once; at 3.35 TB/s.
    Operations: the ATen ops of the bodies the `processed` messages ran,
    at the float32 peak (67 TFLOP/s).

    Also returns `design_bytes`, what this kernel's own design moves over
    the window, at `live` live entries a tick that take the sort `branch`
    (megakernel.tick_sort): the state and rings read and written, the
    entry list (target and words) written and read, the keys written and
    read, the plan written, and the sort. A segment tick writes each live
    entry's slot in the keys phase and reads it to place the entry, writes
    the packed (level, entry) there and reads it in the deliver phase (16
    bytes a live entry), and reads the keys once more to place the dead
    entries (4 bytes an entry). A radix tick runs NPASS passes over every
    entry: each reads the keys to count its digit, then reads each key
    again and writes key and value to move it (16 bytes an entry), and a
    pass after the first also reads the value (4 bytes). It is not a
    bound and only reported."""
    from ponyc_tpu_torch.ops import lanecode
    w = mw.world
    nl, e, w1 = w["NL"], w["E"], w["W1"]
    lane = nl * (4 + 4 + 1 + 1 + 4 + 1 + 1 + 1 + 4 + 4) + w["K"] * nl * 4
    ring_words = ops_per_msg = 0
    for sp in mw.specs:
        ch = sp["cohort"]
        lane += ch.local_capacity * sum(
            t.itemsize for t in sp["dtypes"].values())
        ring_words += w["CAP"] * (1 + ch.msg_words) * ch.local_capacity
        if sp["progs"]:
            ops_per_msg = max(ops_per_msg, sum(
                lanecode.op_count(p) for p in sp["progs"]) / len(sp["progs"]))
    for sp in mw.host_specs:       # host cohorts' rings (their state is
        ch = sp["cohort"]          # on the host)
        ring_words += w["CAP"] * (1 + ch.msg_words) * ch.local_capacity
    plan = 2 * e * 4 + (nl + 1) * 4
    nbytes = ticks * (2 * lane + 2 * ring_words * 4) + plan
    if branch == "segment":
        sort = 16 * live + 4 * e
    else:
        sort = w["NPASS"] * e * 16 + (w["NPASS"] - 1) * e * 4
    design = ticks * (2 * lane + 2 * ring_words * 4 + 2 * e * 4 * (1 + w1)
                      + 2 * e * 4 + plan + sort)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = processed * ops_per_msg / H100_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, t_bytes, t_ops, design)


def mega_phases(mw, kern, label, reps=3):
    """The window kernel's per-phase clock over `reps` windows of `kern()`
    (each one launch with MegaWindow.clock set): mean device µs a tick of
    each phase, from %globaltimer stamps after every grid sync. Printed
    on a line of its own; these launches are checks, not the main path."""
    import torch
    from ponyc_tpu_torch.ops import megakernel
    sums, ticks = {}, 0
    for _ in range(reps):
        clock = torch.zeros((MEGA_TICKS, megakernel.clock_slots(), 2),
                            dtype=torch.int64, device="cuda")
        mw.clock = clock
        try:
            out = kern()
        finally:
            mw.clock = None
        torch.cuda.synchronize()
        n = int(out[2])
        for k, v in megakernel.phase_table(clock, n).items():
            sums[k] = sums.get(k, 0.0) + v * n
        ticks += n
    tab = {k: v / ticks for k, v in sums.items()}
    parts = ", ".join(f"{k} {v:.2f}" for k, v in tab.items() if k != "tick")
    print(f"phases {label} (window kernel, device us a tick, mean of "
          f"{ticks} ticks in {reps} windows, %globaltimer): tick "
          f"{tab['tick']:.2f} = {parts}", flush=True)
    return tab


def wrap_counts(st, cap):
    """The same world with every head and tail moved by 2^31 - 2*cap (a
    multiple of cap, so each ring slot keeps its message): the counters
    wrap past 2^31-1 within a few ticks."""
    import dataclasses
    off = 2**31 - 2 * cap
    return dataclasses.replace(st, head=st.head + off, tail=st.tail + off)


def full_worlds():
    """(label, build() → a started Runtime, seeded) of the four main paths
    at full width, delivery="pallas_mega", for the window kernel's
    checks."""
    import numpy as np
    from ponyc_tpu_torch.models import mixed, nbody, ring, ubench

    def pingers(hops, seeded=1 << 20, radix=False):
        def build():
            rt, ids = ubench.build(1 << 20, ubench_opts("mega", MEGA_TICKS),
                                   pings=4)
            if radix:
                force_radix(rt._multi_g).build()
            ubench.seed_all(rt, ids[:seeded], hops=hops, pings=4)
            return rt
        return build

    def workers():
        rt, ids, wt = mixed.build(1 << 20, MIXED_B,
                                  mixed_opts("mega", MEGA_TICKS),
                                  work=MIXED_WORK)
        mixed.seed_all(rt, ids, wt, hops=1 << 30, mix=True)
        return rt

    def nodes():
        rt, ids = ring.build(1024, ring_opts("mega"))
        rt.send(int(ids[0]), ring.RingNode.token, 4096)
        return rt

    def bodies():
        rt, ids = nbody.build(1024, nbody_opts("mega"))
        st = rt.cohort_state(nbody.Body)
        rt.bulk_send(np.roll(ids, -1), nbody.Body.token, np.full(1024, 1023),
                     np.stack([st["x"], st["y"]], axis=1), st["m"])
        return rt

    def tree():
        from ponyc_tpu_torch.models import spawn_tree
        return spawn_tree.build(SPAWN_DEPTH, spawn_opts("mega"))[0]

    def hostlog():
        return hostlog_build("mega", hostlog_plan())[0]

    return [("ubench 2^20 hops=2^30 (every payload escaped)",
             pingers(1 << 30)),
            ("ubench 2^20 hops=30000 (no payload escaped)", pingers(30000)),
            ("ubench 2^20, 256 pingers seeded, radix sort forced",
             pingers(1 << 30, 256, radix=True)),
            ("ubench 2^20, 2048 pingers seeded", pingers(1 << 30, 2048)),
            ("ubench 2^20 hops=2^30, radix sort forced",
             pingers(1 << 30, radix=True)),
            ("mixed 2^20", workers), ("ring 1024", nodes),
            ("nbody 1024", bodies),
            (f"spawn tree depth {SPAWN_DEPTH} (2^22 rows)", tree),
            ("hostlog 2^20 walkers, 2^12 chains into a host actor",
             hostlog)]


def graph_yardstick(mw, st, it, iw, ticks):
    """One CUDA graph of the plain forced window (`ticks` ticks), captured
    once: returns (replay, its output) or raises why it cannot be
    captured. A yardstick only: the port never replays it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            mw.plain_forced(st, it, iw, ticks)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mw.plain_forced(st, it, iw, ticks)
    return graph.replay, out


@phase("kernels-mega")
def check_mega(mrec):
    import torch
    from ponyc_tpu_torch.ops import megakernel
    from ponyc_tpu_torch.ops.megakernel import MegaWindow
    from ponyc_tpu_torch.runtime import engine
    T = MEGA_TICKS
    zero = engine.zero_aux("cuda")
    worst = 0.0
    worlds = {}
    gpu_warm()
    for label, build in full_worlds():
        t0 = time.perf_counter()
        rt = build()
        mw = rt._multi_g
        it, iw, _ = rt._drain_inject_tracked()
        e_it, e_iw = rt._empty_inject
        st0 = rt.state
        got = mw(st0, it, iw, T, True, zero)
        want = mw.plain(st0, it, iw, T, True, zero, None)
        torch.cuda.synchronize()
        err, _, nout = compare_window(got, want, f"{label} window 1")
        st1, aux1 = want[0], want[1]
        # A gated window from there (force off): the kernel's own gate.
        got = mw(st1, e_it, e_iw, T, False, aux1)
        want = mw.plain(st1, e_it, e_iw, T, False, aux1, None)
        torch.cuda.synchronize()
        err2, _, _ = compare_window(got, want, f"{label} window 2")
        worst = max(worst, err, err2)
        ticks = int(want[2])
        processed = int(want[0].n_processed[0]) - int(st1.n_processed[0])
        esc = megakernel.escape_rate_state(st1)
        live = int(want[0].plan_bounds[-1])       # the last tick's
        branch = megakernel.tick_sort(mw.world, want[0].plan_key)
        print(f"window kernel {label}: 2 windows of up to {T} ticks "
              f"({int(got[2])} ran in the second, "
              f"{int(want[0].n_spawned[0])} device spawns in both), {nout} "
              f"leaves bit-equal "
              f"to the plain window; {live} live entries in the last tick "
              f"({branch} sort); escape rate {esc:.6f} "
              f"(build+seed+check {time.perf_counter() - t0:.1f} s)",
              flush=True)
        rec = dict(escape_rate=esc, ticks=ticks, processed=processed,
                   live=live, branch=branch, info=mw.info)
        forced_world = label.startswith("hostlog")
        if forced_world:
            # The gated windows stop at the tick after which the host row
            # is occupied (host_pending): the first after its first
            # reports, the second at once. The forced spelling runs on,
            # the host row full and spilling: that is the window timed.
            pending = bool(want[1].host_pending)
            if not (pending and ticks == 0
                    and 0 < int(st1.step_no[0]) < T):
                raise AssertionError(f"{label}: the gated windows did not "
                                     f"stop for the host ({ticks} ticks, "
                                     f"host_pending {pending})")
            got = mw.forced(st1, e_it, e_iw, T)
            want = mw.plain_forced(st1, e_it, e_iw, T)
            torch.cuda.synchronize()
            err3, _, _ = compare_window(got, want, f"{label} forced")
            worst = max(worst, err3)
            ticks = T
            processed = (int(want[0].n_processed[0])
                         - int(st1.n_processed[0]))
            live = int(want[0].plan_bounds[-1])
            branch = megakernel.tick_sort(mw.world, want[0].plan_key)
            rec.update(ticks=ticks, processed=processed, live=live,
                       branch=branch, gated_ticks=int(st1.step_no[0]),
                       spill=int(want[0].dspill_count[0]),
                       muted=int(want[0].muted.sum()))
            print(f"window kernel {label}: the first gated window stopped "
                  f"for the host after {int(st1.step_no[0])} ticks, the "
                  f"second ran 0; a forced window of {T} ticks bit-equal "
                  f"({processed} processed, host ring full, spill "
                  f"{rec['spill']}, {rec['muted']} walkers muted; {live} "
                  f"live entries in the last tick, {branch} sort)",
                  flush=True)
        if label.startswith("ubench") and "no payload" in label:
            # The gated-out window and the forced spelling.
            quiet = engine.aux_to_device(engine.aux_from_vector(
                [0] * 9 + [1, 2] + [0] * 10)[1], "cuda")
            got = mw(st1, e_it, e_iw, T, False, quiet)
            torch.cuda.synchronize()
            compare_window(got, mw.plain(st1, e_it, e_iw, T, False, quiet,
                                         None), f"{label} gated out")
            compare_window(got, (st1, quiet, torch.zeros(
                (), dtype=torch.int32, device="cuda")), f"{label} gated "
                "out == its input")
            got = mw.forced(st0, it, iw, 5)
            torch.cuda.synchronize()
            compare_window(got, mw.plain_forced(st0, it, iw, 5),
                           f"{label} forced")
            print(f"window kernel {label}: gated-out window runs 0 ticks "
                  "and returns its input; forced spelling (5 ticks, "
                  "injections every tick) bit-equal", flush=True)
        if ticks == T:       # times from the steady state after window 1
            def kern():
                if forced_world:
                    return mw.forced(st1, e_it, e_iw, T)
                return mw(st1, e_it, e_iw, T, True, zero)

            def plain():
                if forced_world:
                    return mw.plain_forced(st1, e_it, e_iw, T)
                return mw.plain(st1, e_it, e_iw, T, True, zero, None)
            # The plain window launches thousands of kernels a call (tens
            # of thousands for mixed): one profiled call after one warm-up
            # keeps the profiler's bookkeeping to seconds.
            t = dict(ms=device_ms(kern, 5, [()], "pony_mega_kernel"),
                     call_ms=cuda_ms(kern, 5, [()]),
                     plain_ms=device_ms(plain, 1, [()], warm=1),
                     plain_call_ms=cuda_ms(plain, 2, [()], warm=1))
            try:
                if label.startswith("spawn"):
                    # 16 plain ticks at 2^22 rows hold tens of GB in one
                    # graph's pool: no yardstick for this world.
                    raise RuntimeError("not captured at 2^22 rows")
                replay, gout = graph_yardstick(mw, st1, e_it, e_iw, T)
                replay()
                compare_window(mw.forced(st1, e_it, e_iw, T), gout,
                               f"{label} graph replay")
                t.update(library_ms=device_ms(replay, 1, [()], warm=1),
                         library_call_ms=cuda_ms(replay, 2, [()], warm=1))
                del replay, gout
            except Exception as ex:                 # noqa: BLE001
                t.update(library_ms=None, library_call_ms=None,
                         graph_error=f"{type(ex).__name__}: {ex}"[:300])
            b_ms, b_by, nbytes, t_b, t_o, design = mega_bound(
                mw, T, processed, live, branch)
            t.update(phases=mega_phases(mw, kern, label))
            t.update(seconds=time.perf_counter() - t0)
            t.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                     bytes_ms=t_b, ops_ms=t_o, design_bytes=design,
                     design_ms=design / H100_BYTES_PER_S * 1e3,
                     ms_tick=t["ms"] / T,
                     plain_ms_tick=t["plain_ms"] / T,
                     bound_ms_tick=b_ms / T)
            rec.update(t)
            lib = ("not captured: " + t["graph_error"]
                   if t.get("library_ms") is None else
                   f"{t['library_ms']:.3f} ms device, "
                   f"{t['library_call_ms']:.3f} ms wall")
            print(f"window kernel {label}, a window of {T} ticks: kernel "
                  f"{t['ms']:.3f} ms device ({t['ms_tick']:.4f} ms a "
                  f"tick), {t['call_ms']:.3f} ms wall a call; plain window "
                  f"{t['plain_ms']:.3f} ms device, {t['plain_call_ms']:.3f}"
                  f" ms wall; CUDA graph of the plain forced window {lib}; "
                  f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB -> "
                  f"{t_b:.4f} ms at 3.35 TB/s; ops -> {t_o:.4f} ms); kernel "
                  f"at {100 * b_ms / t['ms']:.1f}% of the bound; the "
                  f"design's own traffic {design / 1e6:.1f} MB -> "
                  f"{t['design_ms']:.4f} ms", flush=True)
        worlds[label] = rec
        del rt, got, want, st0, st1
        torch.cuda.empty_cache()
    # The small worlds through Runtime.run(), every window the run
    # dispatches checked against the plain window, heads and tails moved
    # next to the int32 wrap at the first window.
    checked = []
    orig = MegaWindow._dispatch

    def both(self, st, it, iw, limit, force, prev_aux, probe, forced):
        if not getattr(self, "_wrapped", False):
            st = wrap_counts(st, self.opts.mailbox_cap)
            self._wrapped = True
        want = (self.plain_forced(st, it, iw, limit) if forced else
                self.plain(st, it, iw, limit, force, prev_aux, None))
        got = orig(self, st, it, iw, limit, force, prev_aux, probe, forced)
        torch.cuda.synchronize()
        compare_window(got, want, f"window {len(checked)}")
        checked.append(int(want[2]))
        return got

    MegaWindow._dispatch = both
    try:
        for name, build, finish in agree_worlds():
            n0, t0 = len(checked), time.perf_counter()
            rt = build("cuda", "mega")
            finish(rt)
            wrapped = int((rt.state.head < 0).sum())
            print(f"window kernel {name} ({time.perf_counter() - t0:.1f} "
                  f"s): {len(checked) - n0} windows "
                  f"({sum(checked[n0:])} ticks) of Runtime.run() bit-equal "
                  f"to the plain window, counters moved next to 2^31-1 "
                  f"({wrapped} heads past the wrap at the end)", flush=True)
            worlds[f"agree {name}"] = dict(windows=len(checked) - n0,
                                           ticks=sum(checked[n0:]))
    finally:
        MegaWindow._dispatch = orig
    ub = worlds["ubench 2^20 hops=2^30 (every payload escaped)"]
    mrec.update(name="mega_window", route="cuda",
                source="ponyc_tpu_torch/csrc/mega_window.cu",
                replaces="ponyc_tpu/ops/megakernel.py:347",
                max_abs_err=worst, bit_equal=worst == 0,
                **{k: ub.get(k) for k in (
                    "ms", "ms_tick", "call_ms", "plain_ms", "plain_ms_tick",
                    "plain_call_ms", "bound_ms", "bound_ms_tick", "bound_by",
                    "design_bytes", "design_ms", "library_ms", "phases",
                    "library_call_ms", "info")},
                ticks_a_window=T, worlds=worlds)
    return True


def _world_numbers(rt, atype):
    cs = rt.cohort_state(atype)
    return ({k: v.tolist() for k, v in cs.items()},
            {c: rt.counter(c) for c in ("n_processed", "n_delivered",
                                        "n_rejected", "n_mutes",
                                        "n_deadletter")},
            rt.exit_code, rt.steps_run)


def agree_worlds():
    """The small worlds of the agree phase: (name, build(device, mode) →
    a started Runtime ready to run, finish(rt) → the numbers the card and
    the CPU must agree on)."""
    from ponyc_tpu_torch import RuntimeOptions
    from ponyc_tpu_torch.models import ring, ubench
    import ponyc_tpu_torch
    tp, T = programs()

    def walkers(device, mode):
        return tp.build_walkers(ponyc_tpu_torch, T, 7, n_seeds=30,
                                device=device, **_mode_kw(mode),
                                **WALKERS_KW)

    def walkers_done(rt):
        rt.run(max_steps=100_000)
        return (_world_numbers(rt, T.Walker)
                + _world_numbers(rt, T.Splitter)[:1])

    def rings(device, mode):
        rt, ids = ring.build(128, RuntimeOptions(
            mailbox_cap=8, batch=1, max_sends=1, msg_words=1,
            spill_cap=128, inject_slots=8, tuning_cache="off",
            **_mode_kw(mode)), device=device)
        rt.send(int(ids[0]), ring.RingNode.token, 300)
        return rt

    def rings_done(rt):
        rt.run()
        return _world_numbers(rt, ring.RingNode)

    def pingers(device, mode):
        rt, ids = ubench.build(256, RuntimeOptions(
            mailbox_cap=4, batch=4, max_sends=1, msg_words=1,
            spill_cap=64, inject_slots=8, tuning_cache="off",
            **_mode_kw(mode)), pings=4, device=device)
        ubench.seed_all(rt, ids, hops=25, pings=4)
        return rt

    def pingers_done(rt):
        rt.run()
        return _world_numbers(rt, ubench.Pinger)

    def mixers(device, mode):
        return tp.build_mixers(ponyc_tpu_torch, T, 5, device=device,
                               **_mode_kw(mode), **MIXERS_KW)

    def mixers_done(rt):
        rt.run(max_steps=100_000)
        return (_world_numbers(rt, T.Mixer)
                + (rt.state.last_error.tolist(),))

    def corpus(name):
        return (lambda device, mode: tp.corpus_runtime(
                    ponyc_tpu_torch, T, name, device=device,
                    **_mode_kw(mode)),
                lambda rt: tp.run_corpus(ponyc_tpu_torch, T, name, rt=rt))

    def tree(device, mode):
        from ponyc_tpu_torch.models import spawn_tree
        return spawn_tree.build(8, spawn_opts(mode), device=device)[0]

    def tree_done(rt):
        from ponyc_tpu_torch.models import spawn_tree
        rt.run(max_steps=10_000)
        if rt.exit_code != 256 or rt.counter("n_spawned") != 510:
            raise AssertionError(f"spawn tree depth 8: exit code "
                                 f"{rt.exit_code}, n_spawned "
                                 f"{rt.counter('n_spawned')}")
        return (_world_numbers(rt, spawn_tree.Node)
                + (rt.state.alive.tolist(), rt.counter("n_spawned")))

    def churn(device, mode):
        return tp.churn(ponyc_tpu_torch, T, 301, device=device,
                        **_mode_kw(mode))[0]

    def churn_done(rt):
        rt.run(max_steps=100_000)
        return (_world_numbers(rt, T.Temp) + _world_numbers(rt, T.Collector)
                + (rt.counter("n_spawned"), rt.counter("n_destroyed")))

    def sync(device, mode):
        rt = tp.new_runtime(ponyc_tpu_torch, dict(
            mailbox_cap=8, batch=2, max_sends=1, msg_words=3,
            inject_slots=8, **_mode_kw(mode)), device)
        rt.declare(T.Maker, 3).declare(T.Kid, 6).start()
        for m in rt.spawn_many(T.Maker, 3):
            rt.send(int(m), T.Maker.make, int(m) + 5)
        return rt

    def sync_done(rt):
        import numpy as np
        rt.run(max_steps=100)
        kid = rt.cohort_state(T.Kid)
        return (_world_numbers(rt, T.Maker)[0], kid["tag"].tolist(),
                np.asarray(kid["frac"]).view(np.int32).tolist(),
                kid["boss"].tolist(), rt.counter("n_spawned"))

    def hostrep(device, mode):
        # A small hostlog: 64 walkers, 24 chains of 1..40 hops.
        return hostlog_build(mode, hostlog_plan(64, 24, 31, 40), device)[0]

    def hostrep_done(rt):
        rt.run(max_steps=100_000)
        log = rt.program.first_host_row
        acc = hostlog_plan(64, 24, 31, 40)[3]
        if rt.state_of(log)["ends"] != 24 or not (
                rt.cohort_state(T.WalkerH)["acc"] == acc).all():
            raise AssertionError(f"host reporting: {rt.state_of(log)} "
                                 "(want 24 ends), or acc differs from the "
                                 "oracle")
        return (_world_numbers(rt, T.WalkerH)
                + (rt.state_of(log), rt.totals["host_processed"]))

    worlds = [("walkers (spill/mute)", walkers, walkers_done),
              ("ring", rings, rings_done), ("ubench", pingers, pingers_done),
              ("mixers (every effect)", mixers, mixers_done),
              ("spawn tree depth 8", tree, tree_done),
              ("spawn/destroy churn", churn, churn_done),
              ("spawn_sync", sync, sync_done),
              ("host reporting", hostrep, hostrep_done)]
    worlds += [(f"corpus {n}", *corpus(n)) for n in tp.CORPUS]
    return worlds


@phase("agree")
def agree_small_worlds():
    for mode in (False, True, "mega"):
        for name, build, finish in agree_worlds():
            rt = build("cuda", mode)
            paths = dispatch_paths(rt)
            g, c = finish(rt), finish(build("cpu", mode))
            if g != c:
                raise AssertionError(f"{name} ({_mode_name(mode)}): the "
                                     f"card and the CPU disagree: {g} vs "
                                     f"{c}")
            print(f"{name} {_mode_name(mode)}: card == CPU ({paths})",
                  flush=True)


def count_windows(rt):
    """Count the windows the run loop dispatches (a list holding one
    number)."""
    n = [0]
    orig = rt._dispatch_window

    def counted(*a, **k):
        n[0] += 1
        return orig(*a, **k)
    rt._dispatch_window = counted
    return n


def reset_launches():
    from ponyc_tpu_torch.ops import mailbox_kernel as mk
    from ponyc_tpu_torch.ops.fused_dispatch import FusedDispatch
    from ponyc_tpu_torch.ops.megakernel import MegaWindow
    mk.drain_msgs.launches = 0
    FusedDispatch.launches = 0
    MegaWindow.launches = 0


def launches():
    """(drain, fused, window kernel) launches since reset_launches()."""
    from ponyc_tpu_torch.ops import mailbox_kernel as mk
    from ponyc_tpu_torch.ops.fused_dispatch import FusedDispatch
    from ponyc_tpu_torch.ops.megakernel import MegaWindow
    return (mk.drain_msgs.launches, FusedDispatch.launches,
            MegaWindow.launches)


def expected_launches(mode, ticks, windows):
    """What one cohort's path launches: a drain or a fused kernel a tick
    enqueued, or one window kernel a window dispatched."""
    if mode == "mega":
        return (0, 0, windows)
    return (0, ticks, 0) if mode else (ticks, 0, 0)


def ubench_windows(mode, n, pings, warm, ticks):
    """Three timed windows of `ticks` ticks of ubench; checks the
    processed count and the path's launches."""
    import torch
    from ponyc_tpu_torch.models import ubench
    t0 = time.perf_counter()
    rt, ids = ubench.build(n, ubench_opts(mode, ticks), pings=pings)
    ubench.seed_all(rt, ids, hops=1 << 30, pings=pings)
    torch.cuda.synchronize()
    print(f"ubench {_mode_name(mode)} build+seed "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rt.run(max_steps=warm)
    windows = count_windows(rt)
    per_tick = []
    for _ in range(3):
        p0, s0 = rt.counter("n_processed"), rt.steps_run
        q0, w0 = rt.ticks_enqueued, windows[0]
        torch.cuda.synchronize()
        reset_launches()                # the main path's run starts here
        t0 = time.perf_counter()
        rt.run(max_steps=ticks)
        elapsed = time.perf_counter() - t0
        got = launches()                # ... and ends here
        done = rt.counter("n_processed") - p0
        ran, enqueued = rt.steps_run - s0, rt.ticks_enqueued - q0
        wins = windows[0] - w0
        if done != n * pings * ticks or ran != ticks:
            raise AssertionError(f"processed {done} in {ran} ticks, "
                                 f"expected {n * pings * ticks} in {ticks}")
        want = expected_launches(mode, enqueued, wins)
        if got != want or enqueued < ticks or (
                mode != "mega" and enqueued != ticks):
            raise AssertionError(f"launches (drain, fused, window) {got} "
                                 f"for {enqueued} ticks enqueued, {wins} "
                                 f"windows, {ticks} run (one cohort: "
                                 f"expected {want})")
        if rt.counter("n_rejected") or rt.exit_code:
            raise AssertionError("ubench rejected messages or exited")
        per_tick.append(elapsed / ticks)
        print(f"ubench N={n} pings={pings} {_mode_name(mode)}: {ticks} "
              f"ticks in {elapsed:.3f} s = {1e3 * elapsed / ticks:.3f} "
              f"ms/tick, {n * pings / (elapsed / ticks):.4g} msgs/s; "
              f"processed counter ok; {wins} windows; launches (drain, "
              f"fused, window) {got}", flush=True)
    p50 = statistics.median(per_tick)
    print(f"ubench {_mode_name(mode)} median of {len(per_tick)} windows: "
          f"{1e3 * p50:.3f} ms/tick, {n * pings / p50:.4g} msgs/s (spread "
          f"{1e3 * min(per_tick):.3f}-{1e3 * max(per_tick):.3f} ms/tick)",
          flush=True)
    del rt
    torch.cuda.empty_cache()
    return max(got), {"msgs_per_s": n * pings / p50, "s_per_tick": p50,
                      "s_per_tick_each": per_tick}


@phase("ubench")
def run_ubench(rec, frec, mrec):
    n, pings, warm, ticks = 1 << 20, 4, 8, 64
    rec["launches"], plain = ubench_windows(False, n, pings, warm, ticks)
    frec["launches"], fused = ubench_windows(True, n, pings, warm, ticks)
    mrec["launches"], mega = ubench_windows("mega", n, pings, warm, ticks)
    return {"plain": plain, "fused": fused, "mega": mega}


@phase("ring")
def run_ring(rec, frec, mrec, hops=4096):
    import torch
    from ponyc_tpu_torch.models import ring
    nodes = 1024
    out = {}
    for mode in (False, True, "mega"):
        opts = ring_opts(mode)
        ring.run(nodes, 64, opts=opts)                    # warm-up
        per_hop = []
        # The plain and fused ticks take about 8 ms a hop: they run half
        # the hops, which keeps the whole script near half its time limit
        # (the time a hop is what this phase reports).
        n_hops = hops if mode == "mega" else hops // 2
        for _ in range(3):
            rt, ids = ring.build(nodes, opts)
            rt.send(int(ids[0]), ring.RingNode.token, n_hops)
            windows = count_windows(rt)
            torch.cuda.synchronize()
            q0 = rt.ticks_enqueued
            reset_launches()            # the main path's run starts here
            t0 = time.perf_counter()
            code = rt.run()
            elapsed = time.perf_counter() - t0
            got = launches()            # ... and ends here
            enqueued = rt.ticks_enqueued - q0
            passes = int(rt.cohort_state(ring.RingNode)["passes"].sum())
            if passes != n_hops or code != 0:
                raise AssertionError(f"ring: passes {passes} (want "
                                     f"{n_hops}), exit code {code}")
            # One cohort: one launch of the path's kernel per enqueued
            # tick, run or not (a tick predicated off on the device still
            # launches its kernels; the host enqueues such ticks until its
            # non-blocking StopProbe sees the device's stop vote), or one
            # window kernel a window.
            want = expected_launches(mode, enqueued, windows[0])
            if got != want or rt.steps_run > enqueued:
                raise AssertionError(f"ring {_mode_name(mode)}: launches "
                                     f"(drain, fused, window) {got} for "
                                     f"{enqueued} ticks enqueued, "
                                     f"{windows[0]} windows, {rt.steps_run} "
                                     f"run (expected {want})")
            per_hop.append(elapsed / n_hops)
            print(f"ring {nodes} nodes {n_hops} hops {_mode_name(mode)}: "
                  f"{elapsed:.3f} s, {1e6 * elapsed / n_hops:.1f} us/hop, "
                  f"{rt.steps_run} ticks run, {enqueued} enqueued, "
                  f"{windows[0]} windows; launches (drain, fused, window) "
                  f"{got}", flush=True)
            {False: rec, True: frec, "mega": mrec}[mode]["launches_ring"] = \
                max(got)
        p50 = statistics.median(per_hop)
        print(f"ring {_mode_name(mode)} p50 per-hop time {1e6 * p50:.1f} us"
              f" over {len(per_hop)} runs", flush=True)
        out[{False: "plain", True: "fused", "mega": "mega"}[mode]] = p50
    return out


@phase("mixed")
def run_mixed(frec, mrec, ticks=16):
    import numpy as np
    import torch
    from ponyc_tpu_torch.models import mixed
    n = 1 << 20
    res, out = {}, {}
    for mode in (True, "mega", False):
        t0 = time.perf_counter()
        rt, ids, wt = mixed.build(n, MIXED_B, mixed_opts(mode, ticks),
                                  work=MIXED_WORK)
        mixed.seed_all(rt, ids, wt, hops=1 << 30, mix=True)
        rt.run(max_steps=1)                               # warm-up
        windows = count_windows(rt)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        p0, q0 = rt.counter("n_processed"), rt.ticks_enqueued
        reset_launches()                # the main path's run starts here
        t0 = time.perf_counter()
        rt.run(max_steps=ticks)
        elapsed = time.perf_counter() - t0
        got = launches()                # ... and ends here
        done = rt.counter("n_processed") - p0
        if done != n * ticks or rt.steps_run != ticks + 1:
            raise AssertionError(f"mixed {_mode_name(mode)}: processed "
                                 f"{done} in {rt.steps_run - 1} ticks, "
                                 f"expected {n * ticks} in {ticks}")
        want = expected_launches(mode, rt.ticks_enqueued - q0, windows[0])
        if got != want or (mode != "mega"
                           and rt.ticks_enqueued - q0 != ticks):
            raise AssertionError(f"mixed {_mode_name(mode)}: launches "
                                 f"(drain, fused, window) {got} for {ticks} "
                                 f"ticks, {windows[0]} windows (expected "
                                 f"{want})")
        st = rt.cohort_state(wt)
        res[mode] = (st["done"], st["acc"])
        out[{False: "plain", True: "fused", "mega": "mega"}[mode]] = \
            elapsed / ticks
        print(f"mixed N={n} B={MIXED_B} work={MIXED_WORK} "
              f"{_mode_name(mode)}: {ticks} ticks in {elapsed:.3f} s = "
              f"{1e3 * elapsed / ticks:.3f} ms/tick (setup {setup:.1f} s); "
              f"processed counter ok; {windows[0]} windows; launches "
              f"(drain, fused, window) {got}", flush=True)
        if mode:
            (frec if mode is True else mrec)["launches_mixed"] = max(got)
        del rt
        torch.cuda.empty_cache()
    for mode in (True, "mega"):
        if not (np.array_equal(res[mode][0], res[False][0])
                and np.array_equal(res[mode][1].view(np.int32),
                                   res[False][1].view(np.int32))):
            raise AssertionError(f"mixed: done/acc differ between "
                                 f"{_mode_name(mode)} and the plain tick")
    print("mixed: done and acc bit-equal between the fused kernel, the "
          "window kernel and the plain tick "
          f"(acc mean {float(res[True][1].mean()):.6g})", flush=True)
    return out


@phase("nbody")
def run_nbody(frec, mrec, bodies=1024):
    import numpy as np
    import torch
    from ponyc_tpu_torch.models import nbody
    out = {}
    for mode in (True, "mega"):
        reset_launches()                # the main path's run starts here
        t0 = time.perf_counter()
        rt = nbody.run_round(bodies, nbody_opts(mode))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = launches()                # ... and ends here
        if got[0] or got[1 if mode == "mega" else 2]:
            raise AssertionError(f"nbody {_mode_name(mode)}: launches "
                                 f"(drain, fused, window) {got}")
        (frec if mode is True else mrec)["launches_nbody"] = max(got)
        st = rt.cohort_state(nbody.Body)
        if not (st["seen"] == bodies - 1).all():
            raise AssertionError(f"nbody: seen {st['seen'].min()}.."
                                 f"{st['seen'].max()}, want {bodies - 1}")
        f64 = [st[k].astype(np.float64) for k in ("x", "y", "m")]
        ax, ay = nbody.reference_accels(*f64)
        # float32 sums of 1023 terms against a float64 oracle: the
        # tolerance scales with the largest acceleration.
        tol = 1e-4 * max(np.abs(ax).max(), np.abs(ay).max())
        err = max(np.abs(st["ax"] - ax).max(), np.abs(st["ay"] - ay).max())
        if not err <= tol:
            raise AssertionError(f"nbody {_mode_name(mode)}: max |a - "
                                 f"oracle| {err:.3g} > {tol:.3g}")
        print(f"nbody {bodies} bodies {_mode_name(mode)}, one round in "
              f"{rt.steps_run} ticks, {elapsed:.2f} s with setup; launches "
              f"(drain, fused, window) {got}; max |a - oracle| {err:.3g} "
              f"<= {tol:.3g} (1e-4 of the largest |a|, float64 oracle)",
              flush=True)
        out[_mode_name(mode)] = {"max_abs_err": float(err),
                                 "tol": float(tol), "ticks": rt.steps_run}
    return out


@phase("spawn")
def run_spawn(rec, frec, mrec, depth=SPAWN_DEPTH):
    """The spawn tree through Runtime.run() on each path (see the module
    docstring): correctness, launches and ms a tick."""
    import numpy as np
    import torch
    from ponyc_tpu_torch.models import spawn_tree
    leaves = 1 << depth
    cols, out = {}, {}
    for mode in (False, True, "mega"):
        t0 = time.perf_counter()
        rt, _root = spawn_tree.build(depth, spawn_opts(mode))
        windows = count_windows(rt)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        q0 = rt.ticks_enqueued
        reset_launches()                # the main path's run starts here
        t0 = time.perf_counter()
        code = rt.run(max_steps=10_000)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = launches()                # ... and ends here
        enqueued = rt.ticks_enqueued - q0
        spawned = rt.counter("n_spawned")
        if code != leaves or spawned != 2 * leaves - 2:
            raise AssertionError(f"spawn tree {_mode_name(mode)}: exit "
                                 f"code {code} (want {leaves}), n_spawned "
                                 f"{spawned} (want {2 * leaves - 2})")
        if rt.counter("n_rejected") or rt.counter("n_deadletter"):
            raise AssertionError("spawn tree rejected or dead-lettered "
                                 "messages")
        want = expected_launches(mode, enqueued, windows[0])
        if got != want or rt.steps_run > enqueued:
            raise AssertionError(f"spawn tree {_mode_name(mode)}: launches "
                                 f"(drain, fused, window) {got} for "
                                 f"{enqueued} ticks enqueued, {windows[0]} "
                                 f"windows (expected {want})")
        st = rt.cohort_state(spawn_tree.Node)
        cols[mode] = {k: st[k] for k in ("parent", "acc", "pending")}
        cols[mode]["alive"] = rt.state.alive.cpu().numpy()
        ticks = rt.steps_run
        out[{False: "plain", True: "fused", "mega": "mega"}[mode]] = dict(
            ms_per_tick=1e3 * elapsed / ticks, ticks=ticks,
            enqueued=enqueued, windows=windows[0], seconds=elapsed)
        {False: rec, True: frec, "mega": mrec}[mode]["launches_spawn"] = \
            max(got)
        print(f"spawn tree depth {depth} ({4 * leaves} rows) "
              f"{_mode_name(mode)}: exit code {code}, n_spawned {spawned}, "
              f"{ticks} ticks in {elapsed:.3f} s = "
              f"{1e3 * elapsed / ticks:.3f} ms/tick (setup {setup:.1f} s);"
              f" {enqueued} enqueued, {windows[0]} windows; launches "
              f"(drain, fused, window) {got}; dispatch {dispatch_paths(rt)}",
              flush=True)
        del rt
        torch.cuda.empty_cache()
    for mode in (True, "mega"):
        for k, v in cols[mode].items():
            if not np.array_equal(v, cols[False][k]):
                raise AssertionError(f"spawn tree: column {k} differs "
                                     f"between {_mode_name(mode)} and the "
                                     "plain tick")
    print(f"spawn tree: parent, acc, pending and alive bit-equal across the "
          f"plain tick, the fused kernel and the window kernel "
          f"({int(cols[False]['alive'].sum())} actors alive)", flush=True)
    return out


def host_stops(rt):
    """Record every window the run loop retires as (ticks run, its
    budget, host_pending at its end) in the list returned."""
    out = []
    orig = rt._retire_window

    def retire(win):
        k, a = orig(win)
        out.append((k, win["budget"], bool(a.host_pending)))
        return k, a
    rt._retire_window = retire
    return out


def state_to(x, dev):
    """A state, aux or window output (nests of tensors) on device `dev`."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: state_to(v, dev) for k, v in x.items()}
    if hasattr(x, "_fields"):                        # StepAux
        return type(x)(*(state_to(v, dev) for v in x))
    if isinstance(x, tuple):
        return tuple(state_to(v, dev) for v in x)
    return dataclasses.replace(x, **{
        f.name: state_to(getattr(x, f.name), dev)
        for f in dataclasses.fields(x)})


def host_numbers(rt, log):
    """The numbers the paths must agree on after a host world's run."""
    return {"counters": {c: rt.counter(c) for c in (
                "n_processed", "n_delivered", "n_rejected", "n_mutes",
                "n_deadletter", "n_spawned")},
            "host": rt.state_of(log),
            "host_processed": rt.totals["host_processed"],
            "code": rt.exit_code, "steps": rt.steps_run}


def card_vs_host_build(plan, every=128):
    """A second pallas_mega run of the hostlog world whose first three
    windows and every `every`-th also run as the host C++ build of the
    window kernel on a CPU copy of the same input, each bit-equal to the
    card. Returns (windows checked, ticks in them, the run's numbers)."""
    import torch
    from ponyc_tpu_torch.ops.megakernel import MegaWindow
    rt, log = hostlog_build("mega", plan)
    checked, n = [], [0]
    orig = MegaWindow._dispatch

    def both(self, st, it, iw, limit, force, prev_aux, probe, forced):
        k = n[0]
        n[0] += 1
        if k >= 3 and k % every:
            return orig(self, st, it, iw, limit, force, prev_aux, probe,
                        forced)
        cst, cit, ciw, caux = state_to((st, it, iw, prev_aux), "cpu")
        got = orig(self, st, it, iw, limit, force, prev_aux, probe, forced)
        torch.cuda.synchronize()
        want = self.run_host(cst, cit, ciw, limit, force, caux,
                             forced=forced)
        compare_window(state_to(got, "cpu"), want, f"hostlog window {k}, "
                       "card against the host build")
        checked.append(int(want[2]))
        return got

    MegaWindow._dispatch = both
    try:
        rt.run()
    finally:
        MegaWindow._dispatch = orig
    return len(checked), sum(checked), host_numbers(rt, log), rt


@phase("host")
def run_host(rec, frec, mrec):
    """Host cohorts on each path (see the module docstring): the hostlog
    world at 2^20 walkers, then the spreader at depth 12."""
    import numpy as np
    import torch
    tp, T = programs()
    plan = hostlog_plan()
    acc = plan[3]
    card = _CACHE["card"]
    res, out = {}, {}
    for mode in (False, True, "mega"):
        t0 = time.perf_counter()
        rt, log = hostlog_build(mode, plan)
        windows = count_windows(rt)
        stops = host_stops(rt)
        # The window kernel's device time over the run (CUDA events
        # around each launch), for the device's busy share.
        timed = None
        if mode == "mega":
            timed = rt._multi_g._fn = EventTimed(rt._multi_g._fn)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        q0 = rt.ticks_enqueued
        reset_launches()                # the main path's run starts here
        t0 = time.perf_counter()
        code = rt.run()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = launches()                # ... and ends here
        enqueued = rt.ticks_enqueued - q0
        nums = host_numbers(rt, log)
        walk = rt.cohort_state(T.WalkerH)["acc"]
        if code != 0 or nums["host"]["ends"] != HOST_CHAINS \
                or not np.array_equal(walk.astype(np.int64), acc):
            raise AssertionError(
                f"hostlog {_mode_name(mode)}: exit code {code}, host "
                f"{nums['host']} (want {HOST_CHAINS} ends), acc equal to "
                f"the oracle: {np.array_equal(walk.astype(np.int64), acc)}")
        want = expected_launches(mode, enqueued, windows[0])
        if got != want or rt.steps_run > enqueued:
            raise AssertionError(f"hostlog {_mode_name(mode)}: launches "
                                 f"(drain, fused, window) {got} for "
                                 f"{enqueued} ticks enqueued, {windows[0]} "
                                 f"windows (expected {want})")
        # Windows that ran and ended with a host row occupied; under the
        # window kernel, those that stopped before their budget did so on
        # the device (the gate's host_pending).
        for_host = sum(1 for k, _b, h in stops if k and h)
        early = sum(1 for k, b, h in stops if h and 0 < k < b)
        busy = ""
        if timed is not None:
            dev_us = timed.take_us()
            busy = (f"; window kernel device time {dev_us / 1e3:.3f} ms "
                    f"a run (CUDA events) = {dev_us / rt.steps_run:.2f} us "
                    f"a tick, device busy {100 * dev_us / 1e6 / elapsed:.1f}"
                    f"% of the wall")
        if mode == "mega" and not early:
            raise AssertionError("hostlog pallas_mega: no window ended "
                                 "early for the host")
        res[mode] = dict(nums, acc=walk, windows=windows[0])
        out[_mode_name(mode)] = dict(
            seconds=elapsed, setup_s=setup, ticks=rt.steps_run,
            enqueued=enqueued, windows=windows[0], host_windows=for_host,
            early_host_windows=early, ms_per_tick=1e3 * elapsed
            / max(1, rt.steps_run), launches=got,
            host_processed=nums["host_processed"], **nums["counters"])
        if timed is not None:
            out[_mode_name(mode)].update(device_ms=dev_us / 1e3,
                                         busy_share=dev_us / 1e6 / elapsed)
        {False: rec, True: frec, "mega": mrec}[mode]["launches_host"] = \
            max(got)
        print(f"hostlog {HOST_WALKERS} walkers {HOST_CHAINS} chains "
              f"{_mode_name(mode)} [{card}]: exit code {code}, ends "
              f"{nums['host']['ends']}, acc equal to the oracle; wall "
              f"{elapsed:.3f} s a run (setup {setup:.1f} s), "
              f"{rt.steps_run} ticks run = {1e3 * elapsed / rt.steps_run:.3f}"
              f" ms/tick, {enqueued} enqueued, {windows[0]} windows "
              f"({for_host} ended with the host ring occupied, {early} "
              f"before their budget); host_processed "
              f"{nums['host_processed']}, counters {nums['counters']}; "
              f"launches (drain, fused, window) {got}{busy}; dispatch "
              f"{dispatch_paths(rt)}", flush=True)
        del rt
        torch.cuda.empty_cache()
    for mode in (True, "mega"):
        a, b = res[mode], res[False]
        na = {k: v for k, v in a.items() if k != "acc"}
        nb = {k: v for k, v in b.items() if k != "acc"}
        if not np.array_equal(a["acc"], b["acc"]) or na != nb:
            raise AssertionError(f"hostlog: {_mode_name(mode)} differs from "
                                 f"the plain tick: {na} vs {nb}")
    print("hostlog: acc, the host actor's state, counters, host_processed, "
          "ticks run and windows equal across the plain tick, the fused "
          "kernel and the window kernel", flush=True)
    # The window kernel's per-phase clock on this world: a forced window
    # from the seeded start (the host ring fills and spills).
    rt, _log = hostlog_build("mega", plan)
    mw, st0 = rt._multi_g, rt.state
    e_it, e_iw = rt._empty_inject
    out["phases"] = mega_phases(
        mw, lambda: mw.forced(st0, e_it, e_iw, MEGA_TICKS),
        f"hostlog 2^20 walkers, forced window of {MEGA_TICKS} ticks "
        f"[{card}]")
    del rt, st0
    t0 = time.perf_counter()
    n_chk, t_chk, nums, rt = card_vs_host_build(plan)
    ref = {k: v for k, v in res["mega"].items()
           if k not in ("acc", "windows")}
    if nums != ref or not np.array_equal(
            rt.cohort_state(T.WalkerH)["acc"], res["mega"]["acc"]):
        raise AssertionError(f"hostlog: the checked run differs: {nums} vs "
                             f"{ref}")
    print(f"hostlog pallas_mega: {n_chk} windows ({t_chk} ticks) of a "
          f"second run bit-equal to the host C++ build of the window "
          f"kernel on the same input, and that run equal to the first "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    out["host_build_windows"] = n_chk
    del rt
    torch.cuda.empty_cache()
    # examples/spreader.py's program: device spawns and a host collector.
    leaves, sp = 1 << SPREAD_DEPTH, {}
    for mode in (False, True, "mega"):
        rt, col = spread_build(mode)
        windows = count_windows(rt)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        code = rt.run(max_steps=100_000)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = launches()
        nums = host_numbers(rt, col)
        if code != 0 or nums["host"]["got"] != leaves or \
                nums["counters"]["n_spawned"] != 2 * leaves - 2:
            raise AssertionError(f"spreader {_mode_name(mode)}: exit code "
                                 f"{code}, {nums}")
        sp[mode] = dict(nums, windows=windows[0],
                        alive=rt.state.alive.cpu().numpy())
        out[f"spreader {_mode_name(mode)}"] = dict(
            seconds=elapsed, ticks=rt.steps_run, windows=windows[0],
            launches=got)
        print(f"spreader depth {SPREAD_DEPTH} {_mode_name(mode)} [{card}]: "
              f"got {nums['host']['got']}, n_spawned "
              f"{nums['counters']['n_spawned']}, {rt.steps_run} ticks in "
              f"{elapsed:.3f} s, {windows[0]} windows, host_processed "
              f"{nums['host_processed']}; launches (drain, fused, window) "
              f"{got}; dispatch {dispatch_paths(rt)}", flush=True)
        del rt
    for mode in (True, "mega"):
        a, b = sp[mode], sp[False]
        if not np.array_equal(a["alive"], b["alive"]) or \
                {k: v for k, v in a.items() if k != "alive"} != \
                {k: v for k, v in b.items() if k != "alive"}:
            raise AssertionError(f"spreader: {_mode_name(mode)} differs "
                                 "from the plain tick")
    print("spreader: got, counters, host state, ticks, windows and the "
          "alive mask equal across the three paths", flush=True)
    return out


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


PORT_KERNELS = ("drain_kernel", "pony_fused_kernel", "pony_mega_kernel")


class EventTimed:
    """A window kernel's bound launch function with a CUDA event recorded
    on the launch stream just before and just after each launch: the
    device time of each window kernel, read without the profiler."""

    def __init__(self, fn):
        self.fn, self.ws_words, self.events = fn, fn.ws_words, []

    def __call__(self, *args):
        import torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        err = self.fn(*args)
        b.record()
        self.events.append((a, b))
        return err

    def take_us(self):
        """Microseconds of the launches recorded since the last call (the
        stream must have been synchronised)."""
        us = sum(a.elapsed_time(b) for a, b in self.events) * 1e3
        self.events = []
        return us


def profile_ticks(label, rt, ticks, attempts=2):
    """Kernels launched a tick and the device's busy share over `ticks`
    ticks under torch.profiler (its wall is inflated by the profiler; the
    device times and counts are what this reads). The window kernel's
    device time comes from CUDA events around each of its launches in the
    same run (`EventTimed`; the profiler has missed that launch in long
    runs), the other kernels' from the profiler. Where the profiler did
    not record a launch of the drain or the fused kernel, the ticks are
    profiled again, and after `attempts` the phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprof
    from ponyc_tpu_torch.ops.megakernel import MegaWindow
    mw = getattr(rt, "_multi_g", None)
    timed = None
    if isinstance(mw, MegaWindow) and mw._fn is not None:
        timed = mw._fn = EventTimed(mw._fn)
    try:
        for _ in range(attempts):
            torch.cuda.synchronize()
            if timed:
                timed.events = []
            before = launches()
            with tprof(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                rt.run(max_steps=ticks)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            launched = [b - a for a, b in zip(before, launches())]
            busy = nkern = 0
            seen = [0, 0, 0]
            mega_prof_us = 0.0
            for evt in prof.key_averages():
                us = _device_us(evt)
                if us <= 0 or \
                        evt.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                if PORT_KERNELS[2] in evt.key:
                    seen[2] += evt.count
                    mega_prof_us += us
                    continue                  # timed by the events
                busy += us
                nkern += evt.count
                for k in range(2):
                    if PORT_KERNELS[k] in evt.key:
                        seen[k] += evt.count
            missed = [k for k in range(2) if launched[k] and not seen[k]]
            if not missed:
                break
    finally:
        if timed:
            mw._fn = timed.fn
    if missed:
        raise AssertionError(
            f"profile {label}: in {attempts} profiled runs the profiler "
            f"recorded none of the launches of "
            f"{[PORT_KERNELS[k] for k in missed]}; (drain, fused, window) "
            f"launched {tuple(launched)}")
    mega_us = timed.take_us() if timed else 0.0
    if launched[2] and mega_us <= 0:
        raise AssertionError(f"profile {label}: {launched[2]} window "
                             "kernel launches but no event time")
    busy += mega_us
    nkern += launched[2]
    out = {"kernels_per_tick": nkern / ticks,
           "device_busy_ms_per_tick": busy / ticks / 1e3,
           "busy_share": busy / wall_us,
           "profiled_wall_ms_per_tick": wall_us / ticks / 1e3,
           "launched": launched,
           "window_event_ms_per_tick": mega_us / ticks / 1e3,
           "window_profiler_ms_per_tick":
               mega_prof_us / ticks / 1e3 if seen[2] else None}
    mega = ""
    if launched[2]:
        prof_txt = (f"{out['window_profiler_ms_per_tick']:.3f} ms"
                    if seen[2] else "not recorded")
        mega = (f"; window kernel {out['window_event_ms_per_tick']:.3f} ms "
                f"a tick by CUDA events (profiler: {prof_txt})")
    print(f"profile {label}: {nkern / ticks:.0f} kernels a tick, device "
          f"busy {busy / ticks / 1e3:.3f} ms a tick = "
          f"{100 * busy / wall_us:.1f}% of the profiled wall "
          f"({wall_us / ticks / 1e3:.3f} ms a tick){mega}; the port's "
          f"kernels launched in it (drain, fused, window) "
          f"{tuple(launched)}", flush=True)
    return out


@phase("profile")
def run_profile(ticks=4, mega_ticks=MEGA_TICKS):
    """Per path: ubench and mixed over `ticks` ticks (the plain and fused
    ticks) or one window of `mega_ticks` ticks (the window kernel, whose
    launch is per window)."""
    import torch
    from ponyc_tpu_torch.models import mixed, ubench
    out = {}
    for mode in (False, True, "mega"):
        n = mega_ticks if mode == "mega" else ticks
        rt, ids = ubench.build(1 << 20, ubench_opts(mode, n), pings=4)
        ubench.seed_all(rt, ids, hops=1 << 30, pings=4)
        rt.run(max_steps=n)                               # warm-up
        out[f"ubench {_mode_name(mode)}"] = profile_ticks(
            f"ubench 2^20x4 {_mode_name(mode)}", rt, n)
        del rt
        rt, ids, wt = mixed.build(1 << 20, MIXED_B, mixed_opts(mode, n),
                                  work=MIXED_WORK)
        mixed.seed_all(rt, ids, wt, hops=1 << 30, mix=True)
        rt.run(max_steps=2)                               # warm-up
        out[f"mixed {_mode_name(mode)}"] = profile_ticks(
            f"mixed 2^20 B{MIXED_B} work{MIXED_WORK} {_mode_name(mode)}",
            rt, n)
        del rt
        torch.cuda.empty_cache()
    return out


KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def main():
    only = None
    if "--only" in sys.argv:
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    try:
        import ponyc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the ponyc_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr}",
              file=sys.stderr)
        return 1
    card = smi.stdout.strip().splitlines()[0]
    _CACHE["card"] = card
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()
    rec, frec, mrec, summary = {}, {}, {}, {"card": card}

    def want(name):
        return only is None or name in only

    if build_kernels() is not None:
        if want("kernels"):
            check_kernels(rec, frec)
        if want("kernels") or want("kernels-mega"):
            check_mega(mrec)
            summary["mega_worlds"] = mrec.get("worlds")
        if want("agree"):
            agree_small_worlds()
        if want("ubench"):
            summary["ubench"] = run_ubench(rec, frec, mrec)
        if want("ring"):
            summary["ring_p50_s_per_hop"] = run_ring(rec, frec, mrec)
        if want("mixed"):
            summary["mixed_s_per_tick"] = run_mixed(frec, mrec)
        if want("nbody"):
            summary["nbody"] = run_nbody(frec, mrec)
        if want("spawn"):
            summary["spawn"] = run_spawn(rec, frec, mrec)
        if want("host"):
            summary["host"] = run_host(rec, frec, mrec)
        if want("profile"):
            summary["profile"] = run_profile()
    summary["seconds"] = time.perf_counter() - t_start
    if FAILED:
        print(f"chip_smoke: FAILED phases: {FAILED}", flush=True)
        return 1
    print(json.dumps(summary), flush=True)
    if only is not None:
        print(f"chip_smoke: ran only {sorted(only)}; no result line",
              flush=True)
        return 0
    extra = ("call_ms", "plain_call_ms", "library_call_ms",
             "launches_ring", "launches_mixed", "launches_nbody",
             "launches_spawn", "launches_host", "spawn_tree",
             "bit_equal", "max_ulp", "shapes", "mixed", "ticks_a_window",
             "ms_tick", "plain_ms_tick", "bound_ms_tick", "design_bytes",
             "design_ms", "info")
    kernels = [{k: r[k] for k in KEYS + extra if k in r}
               for r in (rec, frec, mrec)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

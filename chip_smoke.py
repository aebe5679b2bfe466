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
                seeded input at ubench's, mixed's (all-hot and one-hot)
                and nbody's shapes and on the small-world corpus at 1,
                257 and 1000 lanes with heads wrapping past 2**31-1, some
                cohorts also built regrouped (REGROUPED), and mixed's
                regrouped kernel on id layouts that stress the regroup
                (fused_dispatch.ID_PATTERNS), every output bit for bit
                (floats compared as bits). Times of each kernel (the
                fused kernel also at mixed's shape one-hot, with one
                thread a lane as before the regroup, and at the spawn
                tree's regrouped), its
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
                ubench's own ticks take the segment sort), the spawn
                tree, the hostlog world and the blob chain, and the
                telemetry worlds (ubench at analysis=1, the spawn tree at
                analysis=3, the hostlog world traced, and traced with a
                span ring of 1024 and an event ring of 64, both
                overflowing), two 16-tick windows each,
                the gated-out window and the forced spelling; and every
                window of Runtime.run() on the agree phase's worlds with
                heads and tails moved next to 2**31-1. Device and wall
                time a window, the plain window's, the bound, and on
                ubench alone one CUDA-graph replay of the plain forced
                window (a yardstick);
                and the kernel's per-phase clock, one `phases` line per
                world (device us a tick of each phase). The plain
                window's device time (torch.profiler) is taken on ubench
                alone in the whole run and on every world in a `--only`
                run (about 60 s more). `--only kernels-mega` runs this
                phase alone;
  3. agree    — small worlds run on the card and on the CPU give equal
                fields and counters on all three paths, and five of them
                (COSORT_AGREE) under delivery="cosort" on the plain and
                fused paths (there the carried plan state too; the CPU
                path is the one the test suite holds against the JAX
                package);
  4. ubench   — message-ubench through Runtime at 2**20 pingers,
                pings=4 (bench.py's defaults): three timed windows of a
                fixed number of ticks after warm-up, on each path, and
                under delivery="cosort" on the plain and fused paths
                (whose final world must equal plan's); every
                pinger processes `pings` messages a tick and the path's
                kernel launches once a tick (once a window for the
                window kernel);
  5. ring     — the token ring, 1024 nodes, 4096 hops (64 on the
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
                ended for the host (host_pending), wall a run (the plain
                and fused paths at 2**15 walkers and 2**9 chains of
                1..32 hops, held against the window kernel there; the window
                kernel at full width too); under
                pallas_mega a second run whose first windows and every
                128th run the host C++ build of the window kernel on the
                same input too, bit-equal to the card, and the kernel's
                per-phase clock on this world (a forced window). Then
                examples/spreader.py's program at depth 9 (device
                spawns and a host collector that fulfils the stdlib
                Promise the host waits on) on each path: the promise's
                value and got = 2**9;
 10. blobs    — the device blob pool and the collector: the blob chain
                of tests/test_differential.py (the reference's
                BlobWalker, tests/_torch_programs.py's define_blobs) at
                2**19 walkers (`nxt` a random functional graph from the
                seed), 2**14 chains (lengths uniform in 1..256) seeded by
                Runtime.blob_store into a pool of 2**20 - 1 slots of 2
                words (cap 2, batch 1, 3 words, 1 send, inject 16; the
                spill raised to 2**14, one a chain),
                through Runtime.run() on each path (the plain and fused
                paths at 2**17 walkers and 2**11 chains of 1..64 hops,
                held against the
                window kernel there; the window kernel at full width
                too): every walker's acc
                equal to a NumPy oracle, blobs_in_use 0, n_blob_remote 0;
                fields, the pool's arrays (handles' generations
                included), counters, ticks and windows equal across the
                paths; one launch of the path's kernel per tick enqueued
                (the blob cohort takes the plain dispatch, so the drain,
                under pallas_fused too) or a window kernel per window;
                wall a run, ms a tick and the window kernel's device time
                a tick (CUDA events). Then Runtime.gc() on the finished
                world with every walker but 1,024 released: the collected
                count, the alive mask, `iters` and `converged` against a
                NumPy reachability oracle over `nxt`, and the GC's wall.
                Then the `records` model at 64 sources x 2 records (the
                window kernel also at 256 x 2) and
                examples/blob_pipeline.py's program on each path, each
                against its oracle with blobs_in_use 0;
 11. telemetry — analysis levels 1-3 and causal tracing on each path
                at full width: ubench at analysis=1 (beh_runs and
                beh_delivered sum to the counters, fields and counters
                equal the analysis=0 run's, every telemetry leaf equal
                across the paths; ms a tick beside analysis=0's, and the
                window kernel's `phases` line with its profiler lanes);
                the spawn tree at analysis=3 (exit code 2**20, its spawns
                overflowing the 4,096-entry event ring: the event ring's
                leaves, the events CSV and every telemetry leaf equal
                across the paths); the hostlog world at analysis=3 with
                every chain traced (bulk_send(..., trace=)): acc equal
                to the oracle, Runtime.traces() one consistent tree of
                one branch a chain, each its chain's dispatches then one
                odd host span (HostLog.done), no span dropped; the spans,
                events, the level-2 CSV's deterministic columns, ticks
                and windows equal across the paths at HOST_CUT, and the
                window kernel's at 2**20 walkers equal to the untraced
                run's;
 12. tune     — the formulation tuner (delivery="auto",
                pallas_fused="auto", the tuning cache in a fresh
                temporary directory) on ubench 2**20 x 4, GUPS at full
                width, the spawn tree at TUNE_SPAWN_DEPTH and the blob
                chain at 2**17 walkers: every variant timed (ms a tick)
                with no error, the winner equal to `decide`'s, the
                runtime's state untouched by calibration, a second start
                read from the cache with no kernel launched, the auto
                runs equal to runs fixed to the winner, and the lower
                of two auto runs' ticks (the calibrated start's, a
                cached start's) within TUNE_SLACK of the lower of two
                pallas_mega runs', timed fixed, auto, auto, fixed;
 13. gups     — GUPS (models/gups.py): 2**22 table cells (cap 16, batch
                2: 512 MiB of rings) and 2**20 updaters x 16 updates on
                each path: the xor of the table equal to the NumPy replay
                of the updaters' PRNG, fields, counters and ticks equal
                across the paths, updates a second;
 14. fanin    — fan-in (models/fanin.py): 2**12 producers x 1 item into
                one aggregator under the window kernel (the aggregator's
                total n*items, mutes and rejections, and the radix sort
                taken unforced on the first ticks, one a window), then
                2**6 x 4 on each path, fields, counters and ticks equal;
 15. mandelbrot — models/mandelbrot.py at 8,192^2 pixels (2^23 Workers
                of 8 pixels, one message each; the Benchmarks Game's
                16,000^2 is cut for the time limit, MANDEL_N) on each
                path: the image bit-equal across
                the paths, a band of 256 rows spread over it equal to
                the float32 NumPy replay of the body (`f32_bytes`; the
                bytes that differ from the reference's `reference_bytes`
                are counted), ms a tick, launches; kernel 3's window on
                the seeded world bit-equal to the plain window, its
                device time against its bound;
 16. serve    — serve.py's world at 16,384 workers on each path: a
                loadgen thread runs calibration (2 x 2 x 30) and 2x
                overload (64 connections x depth 512 for 3 s, a 1 s
                deadline, BUSY backoff 5 ms), then the drain: every OK
                reply 2x+1, every request answered, no sticky capacity
                error, the drain complete; p50/p99 of OK replies,
                goodput, shed rate, windows, launches (under pallas_mega
                the window kernel's device time a window); then
                `python -m ponyc_tpu_torch serve --workers 64` as a child,
                driven by the loadgen CLI and stopped by SIGTERM;
 17. ops      — the flight recorder, the watchdog, /metrics and
                backpressure on each path (run_ops says what it checks);
 18. durable  — durable snapshots: (a) ubench 2**20 x 4 with a 0.05 s
                checkpoint cadence (keep 3) beside the same run without,
                on each path, timed in spans that alternate between the
                two (off, on, on, off twice; pallas_mega 448 ticks a
                span, the plain and fused paths 16): the ring bounded,
                every file verified, fields, counters and ticks equal
                the run without; bytes a snapshot, capture ms, writer s,
                ms a tick on against off (medians of four spans each,
                spread); (b)
                the newest snapshot restored into each path and run 32
                more ticks, bit-equal (fields, counters, ticks, plan
                state) to the run without; (c) the blob chain at full
                width and the hostlog world at 2**20 (256 chains still
                queued as host sends) snapshotted at tick 64 under
                pallas_mega and restored into walkers x1.5, spill x2 (the
                blob pool 3 * 2**18 - 1 grown to 2**20 - 1), finished
                against their NumPy oracles (blobs_in_use 0;
                HostLog.ends 2**12); (d)
                the agree phase's walkers snapshotted on the card,
                finished on the card and on the CPU, equal; (e) the
                hostlog world at 2**15 under pallas_mega, watchdog 1 s, a
                window queued behind a 15 s torch.cuda._sleep in a child
                process (this script with --durable-child) supervised to
                completion (code 7, a restart, the unfaulted result);
                (f) the same child SIGKILLed mid-flush
                (PONY_TPU_CHAOS=snapshot-mid-flush@3), every ring file
                intact, the unfaulted result (a --only run's; a whole
                run skips it for the time limit);
 19. stdlib   — the standard library: randping (tests/_torch_programs.py,
                define_random: 2**20 pingers x 4 tokens x 32 visits, each
                hop to a peer drawn by stdlib.random.randint, a hit when
                stdlib.random.uniform < 0.5; cap 16, batch 8, 2 words) on
                each path: 2**27 processed, visits and hits equal to a
                NumPy replay of every walk (in worker processes while
                the card runs), fields, counters and ticks equal across
                the paths, launches, ms a tick; then on each path a child
                process's stdout and exit code through attach_processes()
                and examples/heartbeat.py's Heart beaten 5 times by a
                stdlib timer (exit 0); a FilePath written and read back
                under TMPDIR. Kernels 2 and 3 are held against their
                plain versions at randping's shape in `kernels` and
                `kernels-mega`;
 20. costs    — cost capture (costs.py, ops/census.py) on ubench 2**20 x
                4 on each path: start() with cost_capture=True censuses
                the step and the one-tick window (bytes, the allocator's
                peak, seconds; no error; the plain and fused steps count
                the drain's or the fused kernel's launch, the window
                kernel's window at least mega_bound's design bytes); a
                capture of the seeded world, then 64 ticks equal to a
                world without capture; the record-move probe exactly
                4 * record_words bytes a message, no divergence, a model
                seeded at 10x diverging; the /metrics gauge and the
                postmortem's `measured [step]`; ponybench (BenchRunner)
                timing kernel 1 at ubench's drain shape (run_costs);
 21. static   — verify_program and lint_program over every program the
                script builds (no verify failure, no finding), and the
                verify, lint and doc verbs on ponyc_tpu_torch.models.ubench
                (exit 0) (run_static);
 22. profile  — kernels launched a tick and the device's busy share
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

The blob pool runs on every path; the window kernel's blob phases
(`census` counts, `bfree` ranks and compacts) are checked in
`kernels-mega` on the blob chain at full width (a `phases` line with
`census` and `bfree`), and `agree` runs a small blob chain on the card
and the CPU. `--only blobs` runs the build and the blobs phase.

Host cohorts take delivery on every path; the window kernel's host rows
are checked in `kernels-mega` on the hostlog world at full width (the
gated windows, which stop for the host, and a forced window, timed), and
`agree` runs a small host reporting world on the card and the CPU.
`--only host` runs the build and the host phase; `--only telemetry` the
build and the telemetry phase (its analysis=0 references then run too);
`--only tune,gups,fanin` the build and those phases; `--only
mandelbrot,serve` the build and slice 12's phases; `--only durable` the
build and the durable phase, whose snapshots go to _chipwork/smoke_durable/
(git-ignored, removed after the phase).
The analysis CSVs go to _chipwork/smoke_analysis/ (git-ignored, removed
after the phase).

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
H100_F32_INSTR_PER_S = H100_F32_OPS_PER_S / 2   # float32 instructions
#   a second: the peak above counts an FMA as two operations
FAILED = []
FAILURES = []   # (phase, its exception's line, the traceback's last frame)
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
                tb = traceback.extract_tb(e.__traceback__)
                mine = [f for f in tb if f.filename == __file__]
                where = dict.fromkeys(
                    f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"
                    for f in mine[-1:] + tb[-1:])
                FAILURES.append((name, f"{type(e).__name__}: {e}",
                                 ", ".join(where)))
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


def device_ms(fn, reps, inputs, match=None, warm=3, host=True):
    """Device time per call (ms): the summed time, from torch.profiler, of
    what the calls ran on the card (kernels, memsets), over `reps` calls
    after `warm` calls; `match` keeps only kernels whose name contains
    it. Unlike cuda_ms it leaves out the host's enqueue time, which for a
    call that launches little can exceed the device's. `host=False`
    records the card's activity alone, not the host's operators: the
    same device time, with less for the profiler to process after a call
    that launches tens of thousands of kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprof
    for i in range(warm):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if host:
        acts.insert(0, ProfilerActivity.CPU)
    with tprof(activities=acts) as prof:
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


def blob_programs():
    """The blob pool's and collector's programs of
    tests/_torch_programs.py (define_blobs)."""
    if "tb" not in _CACHE:
        import ponyc_tpu_torch
        tp, _T = programs()
        _CACHE["tb"] = tp.define_blobs(ponyc_tpu_torch)
    return programs()[0], _CACHE["tb"]


def _mode_kw(mode):
    """Options of a path: False = the plain tick (drain kernel), True =
    the fused dispatch kernel (pallas_fused), "mega" = the window kernel
    (delivery="pallas_mega"); "cosort" and "cosort+fused" = the plain
    tick and the fused kernel under delivery="cosort"; "auto" = the
    tuner's choice (delivery="auto", pallas_fused="auto")."""
    if mode == "mega":
        return dict(pallas_fused=False, delivery="pallas_mega")
    if mode == "auto":
        return dict(pallas_fused="auto", delivery="auto")
    if mode in ("cosort", "cosort+fused"):
        return dict(pallas_fused=mode == "cosort+fused", delivery="cosort")
    return dict(pallas_fused=bool(mode), delivery="plan")


def _mode_name(mode):
    if mode == "mega":
        return "pallas_mega"
    if mode == "auto":
        return "delivery=auto pallas_fused=auto"
    if mode in ("cosort", "cosort+fused"):
        return f"cosort pallas_fused={mode == 'cosort+fused'}"
    return f"pallas_fused={mode}"


def _fused(mode):
    """Whether the path's cohorts run the fused dispatch kernel."""
    return mode is True or mode == "cosort+fused"


def ubench_opts(fused, ticks=64, **kw):
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=4, batch=4, max_sends=1, msg_words=1,
                          spill_cap=1024, inject_slots=8,
                          quiesce_interval=ticks, tuning_cache="off",
                          **_mode_kw(fused), **kw)


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


def spawn_opts(mode, ticks=16, **kw):
    # examples/spawn_tree.py's options
    from ponyc_tpu_torch.models import spawn_tree
    return spawn_tree.options(quiesce_interval=ticks, tuning_cache="off",
                              **_mode_kw(mode), **kw)


def corpus_opts():
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=8, batch=4, max_sends=2, msg_words=2,
                          tuning_cache="off", pallas_fused=True)


HOST_WALKERS = 1 << 20    # the hostlog world on the card
HOST_CHAINS = 1 << 12
HOST_SEED = 2026
HOST_CUT = (1 << 15, 1 << 9, 32)  # walkers, chains, longest chain of its
#   plain and fused runs, untraced and traced (their ticks take tens of ms
#   on the host's clock, and the host actor's ring of 4 takes a window a
#   tick: about one a chain's report, so the ticks follow the chains, not
#   their length: 1..16 hops ran 133 ticks against 141); 2^10 chains of
#   1..64 hops until the stdlib phase needed the time
HOST_CHILD = (1 << 15, 1 << 10, 64)  # the ops and durable phases' hostlog
#   world: walkers, chains, seed (chains of 1..256 hops)
SPREAD_DEPTH = 9          # examples/spreader.py's program on the card
#   (cut from 12: a window a tick on the plain and fused paths; from 10
#   for the stdlib phase)


def hostlog_kw(mode, **kw):
    # tests/test_differential.py's host reporting options, the spill
    # raised for 2^12 chains
    return dict(mailbox_cap=4, batch=1, msg_words=2, max_sends=2,
                spill_cap=8192, inject_slots=16, **_mode_kw(mode), **kw)


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


def hostlog_build(mode, plan, device="cuda", trace=None, **kw):
    """The hostlog world, started and seeded (the chains' first messages
    straight into their start walkers' mailboxes, joining trace `trace`
    where given): (runtime, the host actor's id). `kw`: more options (the
    telemetry's)."""
    import numpy as np
    import ponyc_tpu_torch
    tp, T = programs()
    nxt, starts, lens, _acc = plan
    n = len(nxt)
    rt = tp.new_runtime(ponyc_tpu_torch, hostlog_kw(mode, **kw), device)
    rt.declare(T.WalkerH, n).declare(T.HostLog, 1).start()
    ids = rt.spawn_many(T.WalkerH, n)
    log = rt.spawn(T.HostLog)
    rt.set_fields(T.WalkerH, ids, nxt=ids[nxt], log=np.full(n, log))
    rt.bulk_send(ids[starts], T.WalkerH.step, lens.astype(np.int32),
                 **({} if trace is None else {"trace": trace}))
    return rt, log


def spread_build(mode, depth=SPREAD_DEPTH, device="cuda"):
    """examples/spreader.py's world (its options; Spread declared at 4 x
    2^depth rows) with its promise, which the host collector fulfils at
    the last leaf: (runtime, the collector's id, the promise)."""
    import ponyc_tpu_torch
    from ponyc_tpu_torch.stdlib.promises import Promise
    tp, T = programs()
    rt = tp.new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=8, batch=2, max_sends=5, msg_words=2, spill_cap=4096,
        inject_slots=8, **_mode_kw(mode)), device)
    rt.declare(T.Spread, 4 << depth).declare(T.Collect, 1).start()
    done = Promise(rt)
    T.spread_done["promise"] = (done, 1 << depth)
    col = rt.spawn(T.Collect, got=0)
    root = rt.spawn(T.Spread, col=int(col))
    rt.send(root, T.Spread.go, depth)
    return rt, col, done


RANDPING = (1 << 20, 32)  # randping on the card: pingers, visits a token
#   (each pinger seeded with 4 tokens: 2^22 walks, 2^27 messages; 64
#   visits until the costs and static phases needed the time: the mute
#   cascade's ticks scale with the visits, 1,286 at 64)
RANDPING_WINDOW = 64      # ticks a window (quiesce_interval)
RANDPING_ORACLE_PROCS = 4  # processes replaying the walks in NumPy while
#   the card runs the paths (one a token)


def randping_type():
    """randping's RandPinger for RANDPING[0] pingers
    (tests/_torch_programs.py, define_random)."""
    if "randping" not in _CACHE:
        import ponyc_tpu_torch
        tp, _T = programs()
        _CACHE["randping"] = tp.define_random(ponyc_tpu_torch, RANDPING[0])
    return _CACHE["randping"]


def randping_opts(mode):
    from ponyc_tpu_torch import RuntimeOptions
    tp, _T = programs()
    return RuntimeOptions(tuning_cache="off", **tp.randping_opts(
        RANDPING[0], quiesce_interval=RANDPING_WINDOW, **_mode_kw(mode)))


def randping_build(mode, device="cuda"):
    """A started randping world at full width on `mode`'s path, every
    pinger seeded with its 4 tokens."""
    import ponyc_tpu_torch
    tp, _T = programs()
    return tp.randping_build(ponyc_tpu_torch, randping_type(), RANDPING[0],
                             RANDPING[1], device=device,
                             quiesce_interval=RANDPING_WINDOW,
                             **_mode_kw(mode))


def randping_oracle_part(n, hops, token):
    """One token's walks of randping replayed in NumPy (in a worker
    process): (visits, hits) per actor."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_programs as tp
    return tp.randping_oracle(n, hops, tokens=[token])


def stdlib_types():
    """The host-services program (tests/_torch_programs.py,
    define_stdlib): examples/heartbeat.py's Heart and a host ProcLog."""
    if "stdlib" not in _CACHE:
        import ponyc_tpu_torch
        tp, _T = programs()
        _CACHE["stdlib"] = tp.define_stdlib(ponyc_tpu_torch)
    return _CACHE["stdlib"]


def stdlib_opts(mode):
    from ponyc_tpu_torch import RuntimeOptions
    tp, _T = programs()
    return RuntimeOptions(tuning_cache="off", **tp.STDLIB_OPTS,
                          **_mode_kw(mode))


BLOB_WALKERS = 1 << 19    # the blob chain on the card
BLOB_CHAINS = 1 << 14
BLOB_SEED = 2026
BLOB_CUT = (1 << 17, 1 << 11, 32)  # walkers, chains, longest chain of its
#   plain and fused runs (their ticks take tens of ms on the host's clock;
#   the longest chain cut from 128 to 64 for the stdlib phase, to 32 for
#   the costs and static phases)
BLOB_SLOTS = (1 << 20) - 1    # the most one shard addresses (ops/pack.py)
BLOB_SPILL = 1 << 14          # one a chain: a chain has one token in
#   flight, so the spill cannot overflow (1,024 overflowed at tick 309)
BLOB_KEEP = 1024              # walkers the GC check keeps pinned
RECORDS = (256, 2)            # the records model: sources x records
RECORDS_CUT = (32, 2)         # ... on the plain and fused paths, held
#   against the window kernel there (their ticks, about one a record,
#   take tens of ms on the host's clock; cut to 64 for the stdlib phase,
#   to 32 for the costs and static phases)


def blob_kw(mode):
    # tests/test_differential.py's blob-chain options, the pool at the
    # largest one shard addresses and the spill raised to one a chain
    return dict(mailbox_cap=2, batch=1, max_sends=1, msg_words=3,
                spill_cap=BLOB_SPILL, inject_slots=16,
                blob_slots=BLOB_SLOTS, blob_words=2, **_mode_kw(mode))


def blob_plan(n=BLOB_WALKERS, chains=BLOB_CHAINS, seed=BLOB_SEED,
              max_len=256):
    """The blob chain's wiring and traffic from the seed: (nxt, a random
    functional graph; the chains' start walkers, distinct; their lengths,
    uniform in 1..max_len; their first words, uniform in 0..49), and the
    NumPy oracle of every walker's acc (exact int64 sums: a chain of
    length L and word w visits its start with w, the next walker with
    w + 1, ..., L + 1 walkers in all)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    nxt = rng.integers(0, n, n)
    starts = rng.choice(n, chains, replace=False)
    lens = rng.integers(1, max_len + 1, chains)
    words = rng.integers(0, 50, chains)
    acc = np.zeros(n, np.int64)
    pos, v, w = starts.copy(), lens.copy(), words.astype(np.int64)
    while (v >= 0).any():
        live = v >= 0
        np.add.at(acc, pos[live], w[live])
        pos, v, w = nxt[pos], v - 1, w + 1
    return nxt, starts, lens, words, acc


def blob_build(mode, plan, device="cuda"):
    """The blob chain world, started and seeded: each chain's token blob
    stored by the host (Runtime.blob_store) and moved into its start
    walker's mailbox (bulk_send)."""
    import numpy as np
    import ponyc_tpu_torch
    tp, T = blob_programs()
    nxt, starts, lens, words, _acc = plan
    n = len(nxt)
    rt = tp.new_runtime(ponyc_tpu_torch, blob_kw(mode), device)
    rt.declare(T.BlobWalker, n).start()
    ids = rt.spawn_many(T.BlobWalker, n, acc=0)
    rt.set_fields(T.BlobWalker, ids, nxt=ids[nxt])
    hs = np.array([rt.blob_store([int(w)]) for w in words], np.int32)
    rt.bulk_send(ids[starts], T.BlobWalker.step, lens.astype(np.int32), hs)
    return rt


def records_opts(mode, sources=RECORDS[0]):
    # the records model's own options at `sources` sources
    from ponyc_tpu_torch.models import records
    return records.options(sources, tuning_cache="off", **_mode_kw(mode))


def reach_oracle(nxt, roots):
    """The collector's trace in NumPy: the walkers reachable from `roots`
    over `nxt`, and the hops the trace takes to its fixpoint (the hop that
    finds nothing new included, as gc.py counts them)."""
    import numpy as np
    live = np.zeros(len(nxt), bool)
    live[roots] = True
    iters = 0
    while True:
        new = live.copy()
        new[nxt[live]] = True
        iters += 1
        if (new == live).all():
            return live, iters
        live = new


def mixed_type(hot=None):
    """The mixed model's worker type; hot=1: every message names step0."""
    if ("mixed", hot) not in _CACHE:
        from ponyc_tpu_torch.models import mixed
        _CACHE["mixed", hot] = mixed.make_worker_type(MIXED_B, hot=hot,
                                                      work=MIXED_WORK)
    return _CACHE["mixed", hot]


# The small worlds of the agree phase (tests/_torch_programs.py).
WALKERS_KW = dict(mailbox_cap=4, batch=1, msg_words=1, max_sends=2,
                  spill_cap=512, inject_slots=16)
MIXERS_KW = dict(msg_words=2)


def fused_cases():
    """(label, actor types, options, lanes) of every fused kernel the run
    builds and checks: the main shapes (mixed also one-hot), the corpus at
    ragged widths, and the cohorts of the agree phase's small worlds."""
    import ponyc_tpu_torch
    from ponyc_tpu_torch import RuntimeOptions
    from ponyc_tpu_torch.models import (fanin, gups, nbody, ring,
                                        spawn_tree, ubench)
    tp, _T = programs()
    cases = [("ubench", [ubench.Pinger], ubench_opts(True), 1 << 20),
             ("mixed", [mixed_type()], mixed_opts(True), 1 << 20),
             ("mixed one-hot", [mixed_type(hot=1)], mixed_opts(True),
              1 << 20),
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
    # The GUPS and fan-in cohorts (a fused kernel's source does not
    # depend on the cohort's rows).
    cases.append(("gups", [gups.TableCell, gups.Updater],
                  RuntimeOptions(**gups_kw(True)), 1024))
    cases.append(("fanin", [fanin.Producer, fanin.Aggregator],
                  RuntimeOptions(**fanin_kw(True, *FANIN_SMALL)), 256))
    # The ops phase's live world at analysis 1 and its backpressure world.
    cases.append(("ops ubench analysis=1", [ubench.Pinger],
                  ubench_opts(True, **ops_kw(True)), 1 << 20))
    O = tp.define_ops(ponyc_tpu_torch)
    cases.append(("ops backpressure", [O.Producer, O.Sink],
                  ops_bp_build_opts(True), 1))
    # The mandelbrot Worker (its 64 rounds unrolled, the byte a lane-local
    # sum) and the serve world's device cohort.
    from ponyc_tpu_torch import serve
    from ponyc_tpu_torch.models import mandelbrot
    cases.append(("mandelbrot", [mandelbrot.Worker], mandel_opts(True),
                  1 << 16))
    cases.append(("serve", [serve.ServeWorker, serve.Egress,
                            serve.FrontDoor], serve_opts(True),
                  SERVE_WORKERS))
    # The stdlib phase's randping (bodies drawing from stdlib.random) and
    # its heartbeat world.
    cases.append(("randping", [randping_type()], randping_opts(True),
                  RANDPING[0]))
    S = stdlib_types()
    cases.append(("heartbeat", [S.Heart, S.ProcLog], stdlib_opts(True), 1))
    worlds = [("walkers", ("Walker", "Splitter"), WALKERS_KW),
              ("mixers", ("Mixer",), MIXERS_KW)]
    worlds += [(n, names, kw) for n, (names, kw) in tp.CORPUS_WORLDS.items()]
    for n, names, kw in worlds:
        T = tp.define(ponyc_tpu_torch)
        cases.append((f"agree {n}", [getattr(T, t) for t in names],
                      RuntimeOptions(tuning_cache="off", pallas_fused=True,
                                     **kw), 64))
    return cases


# Fused cases also built with their lanes regrouped by message id
# whatever the compile-time rule chooses (it regroups mixed alone), so that
# the regroup is checked on the card with yields, exits, destroys, errors
# and spawn planes, at ragged widths and at the spawn tree's 2^22 lanes.
REGROUPED = ("corpus N=1000", "spawn corpus N=257", "spawn_tree")


def fused_dispatches(types, opts, lanes, regroup=None):
    """The fused dispatch of every eligible device cohort of a program
    declaring `types` at `lanes` rows each (a cohort that sync-constructs
    has none: it takes the plain dispatch); `regroup` as for
    build_fused_dispatch."""
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
            out.append(fdm.build_fused_dispatch(ch, opts, meta, progs,
                                                regroup))
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
        if label in REGROUPED:
            fused[f"{label} regrouped"] = fused_dispatches(
                types, opts, lanes, regroup=True)
    # Mixed with one thread a lane: the parent commit's kernel, timed
    # beside the regrouped one.
    fused["mixed one thread a lane"] = fused_dispatches(
        [mixed_type()], mixed_opts(True), 1 << 20, regroup=False)
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
    from ponyc_tpu_torch.models import (fanin, gups, nbody, ring,
                                        spawn_tree, ubench)
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
    _tb, blob_t = blob_programs()
    from ponyc_tpu_torch.models import records

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
                              [(spread_t.Collect, 1)]),
           "blob chain": window(blob_t.BlobWalker, BLOB_WALKERS,
                                RuntimeOptions(tuning_cache="off",
                                               **blob_kw("mega"))),
           "records": window(records.RecSource, RECORDS[0],
                             records_opts("mega"),
                             [(records.RecWorker, RECORDS[0]),
                              (records.RecSink, 1)]),
           "records cut": window(records.RecSource, RECORDS_CUT[0],
                                 records_opts("mega", RECORDS_CUT[0]),
                                 [(records.RecWorker, RECORDS_CUT[0]),
                                  (records.RecSink, 1)]),
           "blob pipeline": window(blob_t.Tokenizer, 4, RuntimeOptions(
               blob_slots=32, blob_words=tp.PIPE_W, msg_words=2,
               max_sends=2, tuning_cache="off", **_mode_kw("mega")),
               [(blob_t.Reviewer, 4)])}
    # The telemetry worlds (one kernel each: the levels and ring sizes are
    # constants of pony_world.h).
    for label, kw in TEL_WORLDS.items():
        if label.startswith("ubench"):
            out[label] = window(ubench.Pinger, 1 << 20,
                                ubench_opts("mega", MEGA_TICKS, **kw))
        elif label.startswith("spawn"):
            out[label] = window(spawn_tree.Node, 4 << SPAWN_DEPTH,
                                spawn_opts("mega", **kw))
        else:
            out[label] = window(host_t.WalkerH, HOST_WALKERS, RuntimeOptions(
                tuning_cache="off", **hostlog_kw("mega", **kw)),
                [(host_t.HostLog, 1)])
    for name, build, _finish in agree_worlds():
        out[f"agree {name}"] = build("cpu", "mega")._multi_g
    # The cut plain-and-fused worlds' window kernel counterparts, and the
    # tune, gups and fanin phases' worlds.
    out["hostlog cut"] = window(host_t.WalkerH, HOST_CUT[0], RuntimeOptions(
        tuning_cache="off", **hostlog_kw("mega")), [(host_t.HostLog, 1)])
    out["hostlog cut traced"] = window(
        host_t.WalkerH, HOST_CUT[0], RuntimeOptions(
            tuning_cache="off", **hostlog_kw(
                "mega", analysis=3, trace_sample=1,
                trace_slots=TEL_TRACE_SLOTS)), [(host_t.HostLog, 1)])
    out["blob chain cut"] = window(blob_t.BlobWalker, BLOB_CUT[0],
                                   RuntimeOptions(tuning_cache="off",
                                                  **blob_kw("mega")))
    out["tune spawn tree"] = window(spawn_tree.Node,
                                    4 << TUNE_SPAWN_DEPTH, spawn_opts("mega"))
    out["gups"] = window(gups.TableCell, GUPS[0],
                         RuntimeOptions(**gups_kw("mega")),
                         [(gups.Updater, GUPS[1])])
    for n, items in (FANIN_BIG, FANIN_SMALL):
        out[f"fanin {n}"] = window(fanin.Producer, n, RuntimeOptions(
            **fanin_kw("mega", n, items)), [(fanin.Aggregator, 1)])
    # The durable phase's relayout worlds: the blob chain's snapshot pool
    # and grown geometry, the hostlog world's grown geometry.
    out["durable blob chain"] = window(
        blob_t.BlobWalker, BLOB_WALKERS,
        RuntimeOptions(tuning_cache="off", **durable_blob_kw("mega")))
    out["durable blob chain grown"] = window(
        blob_t.BlobWalker, int(BLOB_WALKERS * DURABLE_GROW),
        RuntimeOptions(tuning_cache="off", **durable_blob_kw("mega", True)))
    out["durable hostlog grown"] = window(
        host_t.WalkerH, int(HOST_WALKERS * DURABLE_GROW), RuntimeOptions(
            tuning_cache="off", **durable_hostlog_kw("mega", True)),
        [(host_t.HostLog, 1)])
    out["ops ubench analysis=1"] = window(
        ubench.Pinger, OPS_LIVE[0], ubench_opts("mega", **ops_kw("mega")))
    O = tp.define_ops(ponyc_tpu_torch)
    out["ops backpressure"] = window(O.Producer, 1, ops_bp_build_opts("mega"),
                                     [(O.Sink, 1)])
    from ponyc_tpu_torch import serve
    from ponyc_tpu_torch.models import mandelbrot
    out["mandelbrot"] = window(mandelbrot.Worker, mandel_groups(),
                               mandel_opts("mega"))
    out["serve"] = window(serve.ServeWorker, SERVE_WORKERS,
                          serve_opts("mega"),
                          [(serve.Egress, 1), (serve.FrontDoor, 1)])
    out["randping"] = window(randping_type(), RANDPING[0],
                             randping_opts("mega"))
    S = stdlib_types()
    out["heartbeat"] = window(S.Heart, 1, stdlib_opts("mega"),
                              [(S.ProcLog, 1)])
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
    from ponyc_tpu_torch.ops import fused_dispatch as fdm
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
                  f"{fd.batch}, ms {fd.ms}, {len(fd.progs)} behaviours, "
                  f"{'regrouped' if fd.regroup else 'one thread a lane'}):"
                  f" {nout} outputs bit-equal (nproc {int(want[5])}, nbad "
                  f"{int(want[6])}, exit {bool(want[3])}{spawns})",
                  flush=True)
    # The regroup on id layouts that stress it, at mixed's shape.
    for label, pattern in ([("mixed", p) for p in fdm.ID_PATTERNS]
                           + [("mixed one-hot", "same")]):
        fd = _CACHE["fused"][label][0]
        inputs = fd.sample_inputs(seed=len(checked) + 1, device="cuda",
                                  pattern=pattern)
        got = fd(*inputs)
        torch.cuda.synchronize()
        want = fd.plain(*inputs)
        err, ulp, nout = compare_fused(got, want, f"{label} {pattern}")
        f_err, f_ulp = max(f_err, err), max(f_ulp, ulp)
        checked.append(f"{label}:{fd.name}:{pattern}")
        design = "regrouped" if fd.regroup else "one thread a lane"
        print(f"fused {label} {fd.name} ({fd.rows} lanes, ids "
              f"{pattern!r}, {design}): {nout} outputs bit-equal (nproc "
              f"{int(want[5])}, nbad {int(want[6])}, exit "
              f"{bool(want[3])})", flush=True)
    times = {}
    for label in ("ubench", "mixed", "mixed one-hot",
                  "mixed one thread a lane", "spawn_tree",
                  "spawn_tree regrouped", "randping"):
        fd = _CACHE["fused"][label][0]
        pattern = "same" if label == "mixed one-hot" else None
        sets = [fd.sample_inputs(seed=100 + s, device="cuda", steady=True,
                                 pattern=pattern) for s in range(3)]
        t = dict(ms=device_ms(fd, 20, sets, "pony_fused_kernel"),
                 call_ms=cuda_ms(fd, 20, sets))
        if label in ("ubench", "mixed", "spawn_tree", "randping"):
            reps = 10 if label == "ubench" else 3
            t.update(plain_ms=device_ms(fd.plain, reps, sets),
                     plain_call_ms=cuda_ms(fd.plain, reps, sets))
        out = fd(*sets[0])
        compare_fused(out, fd.plain(*sets[0]), f"{label} steady")
        b_ms, b_by, nbytes, ops, t_b, t_o = fused_bound(fd, sets[0], out)
        times[label] = dict(bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                            ops=ops, bytes_ms=t_b, ops_ms=t_o,
                            regrouped=fd.regroup, **t)
        plain = (f", plain {t['plain_ms']:.4f} ms; wall a call (host "
                 f"enqueue included): {t['call_ms']:.4f}, "
                 f"{t['plain_call_ms']:.4f} ms" if "plain_ms" in t else
                 f"; wall a call {t['call_ms']:.4f} ms")
        print(f"fused at {label}'s shape ({fd.rows} lanes, every lane "
              f"full{', every id step0' if pattern else ''}, "
              f"{'regrouped' if fd.regroup else 'one thread a lane'}), "
              f"device time a call: kernel {t['ms']:.4f} ms{plain}; bound "
              f"{b_ms:.4f} ms by {b_by} (bytes {nbytes / 1e6:.1f} MB -> "
              f"{t_b:.4f} ms at 3.35 TB/s; {ops:.4g} ATen ops -> "
              f"{t_o:.4f} ms at 67 TFLOP/s); kernel at "
              f"{100 * b_ms / t['ms']:.1f}% of the bound", flush=True)
    frec.update(name="fused_dispatch", route="cuda",
                source="ponyc_tpu_torch/csrc/fused_dispatch.cu",
                replaces="ponyc_tpu/ops/fused_dispatch.py:97",
                max_abs_err=f_err, max_ulp=f_ulp, bit_equal=f_ulp == 0
                and f_err == 0, shapes=checked, library_ms=None,
                **times["ubench"], mixed=times["mixed"],
                mixed_onehot=times["mixed one-hot"],
                mixed_before_ms=times["mixed one thread a lane"]["ms"],
                spawn_tree=times["spawn_tree"],
                spawn_tree_regrouped_ms=times["spawn_tree regrouped"]["ms"],
                randping=times["randping"])
    return True


MEGA_TICKS = 16          # ticks a window in the window kernel's checks
# The telemetry worlds of the window kernel's checks (their options
# beside the world's own): ubench at analysis 1, the spawn tree at
# analysis 3 (its spawns overflow the event ring), the hostlog world
# traced, and traced with both rings too small for a window (the span
# ring 1,024 for 2^12 chains in flight, the event ring 64).
# Worlds of the window kernel's checks that are checked and not timed
# (their times add nothing PERF.md records; they keep the script within
# its limit).
UNTIMED = ("ubench 2^20 hops=30000 (no payload escaped)",
           "ubench 2^20, 2048 pingers seeded",
           "hostlog 2^20 walkers, 2^12 chains, traced, span ring 1024, event "
           "ring 64 (both overflow)",
           # untimed since the stdlib phase needed the time (their times
           # in PERF.md are earlier calls')
           "ubench 2^20, 256 pingers seeded, radix sort forced",
           "ubench 2^20 hops=2^30, radix sort forced",
           f"spawn tree depth {SPAWN_DEPTH} (2^22 rows), analysis=3",
           "hostlog 2^20 walkers, 2^12 chains, analysis=3, traced")
TEL_WORLDS = {
    "ubench 2^20 hops=2^30, analysis=1": dict(analysis=1),
    f"spawn tree depth {SPAWN_DEPTH} (2^22 rows), analysis=3":
        dict(analysis=3),
    "hostlog 2^20 walkers, 2^12 chains, analysis=3, traced":
        dict(analysis=3, trace_sample=1, trace_slots=1 << 16),
    "hostlog 2^20 walkers, 2^12 chains, traced, span ring 1024, event "
    "ring 64 (both overflow)": dict(analysis=3, trace_sample=1,
                                    trace_slots=1024, analysis_events=64)}


def mega_bound(mw, ticks, processed, live, branch, allocs=0, frees=0,
               tel=None):
    """The least time (ms) the card could take for `ticks` ticks of this
    program's window, and which term bounds it, from the bytes the window
    has to move whatever the design: the per-lane state (head, tail,
    flags, mute tables, error columns, fields) and every mailbox ring (4
    bytes a word) read once and written once a tick, and the last tick's
    `plan_key`, `plan_perm` and `plan_bounds` written once; at 3.35 TB/s.
    Operations: the ATen ops of the bodies the `processed` messages ran,
    at the float32 peak (67 TFLOP/s). Where the program uses the blob
    pool: its `used` array (1 byte a slot) once a tick, from which the
    free list is built; for each of the `allocs` allocations and `frees`
    frees, its slot's gen, used and len (9 bytes); the words an
    allocation writes (blob_words of them); and the word each blob_get
    reads (4 bytes; the gets are those the bodies of the `processed`
    messages run). A get's own generation and `used` check is left out,
    so the count stays at or below what the window must move. Telemetry
    (`tel`, the window's counts: slots drained and delivered, spans and
    events written): the enqueue stamp (4 bytes) read for each drained
    slot and written for each delivered one (analysis >= 1), each slot's
    two trace words (8 bytes) likewise with tracing on (the outbox is
    workspace: an entry's trace words are counted as the slot it is
    delivered to), 32 bytes a span and 12 bytes an event written to
    their rings.

    Also returns `design_bytes`, what this kernel's own design moves over
    the window, at `live` live entries a tick that take the sort `branch`
    (megakernel.tick_sort): the state and rings read and written, the
    entry list (target and words) written and read, the keys written and
    read, the plan written, the sort, and in a blob world `used` read twice
    a tick (census and bfree) and each free slot's index written to the
    free list (at most 4 bytes a slot). A segment tick writes each live
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
    ring_words = ops_per_msg = gets_per_msg = 0
    for sp in mw.specs:
        ch = sp["cohort"]
        lane += ch.local_capacity * sum(
            t.itemsize for t in sp["dtypes"].values())
        ring_words += w["CAP"] * (1 + ch.msg_words) * ch.local_capacity
        if sp["progs"]:
            ops_per_msg = max(ops_per_msg, sum(
                lanecode.op_count(p) for p in sp["progs"]) / len(sp["progs"]))
            gets_per_msg = max(gets_per_msg, sum(
                sum(1 for n in p.nodes
                    if n.kind == "blob" and n.key[0] == "get")
                for p in sp["progs"]) / len(sp["progs"]))
    for sp in mw.host_specs:       # host cohorts' rings (their state is
        ch = sp["cohort"]          # on the host)
        ring_words += w["CAP"] * (1 + ch.msg_words) * ch.local_capacity
    plan = 2 * e * 4 + (nl + 1) * 4
    touched = ((allocs + frees) * (1 + 4 + 4) + allocs * w["BW"] * 4
               + processed * gets_per_msg * 4)
    pool = ticks * w["BSL"] + touched if w["BLOB"] else 0
    design_pool = (ticks * w["BSL"] * (1 + 1 + 4) + touched
                   if w["BLOB"] else 0)
    nbytes = ticks * (2 * lane + 2 * ring_words * 4) + plan + pool
    if tel is not None and w["PROF"]:
        slots = tel["drained"] + tel["delivered"]
        nbytes += 4 * slots + 12 * tel["events"]
        if w["TRACE"]:
            nbytes += 8 * slots + 32 * tel["spans"]
    if branch == "segment":
        sort = 16 * live + 4 * e
    else:
        sort = w["NPASS"] * e * 16 + (w["NPASS"] - 1) * e * 4
    design = ticks * (2 * lane + 2 * ring_words * 4 + 2 * e * 4 * (1 + w1)
                      + 2 * e * 4 + plan + sort) + design_pool
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

    def blobs():
        return blob_build("mega", blob_plan())

    def randping():
        return randping_build("mega")

    def tel(label, kw):
        def build():
            from ponyc_tpu_torch.models import spawn_tree
            if label.startswith("ubench"):
                rt, ids = ubench.build(1 << 20, ubench_opts(
                    "mega", MEGA_TICKS, **kw), pings=4)
                ubench.seed_all(rt, ids, hops=1 << 30, pings=4)
                return rt
            if label.startswith("spawn"):
                return spawn_tree.build(SPAWN_DEPTH, spawn_opts("mega",
                                                                **kw))[0]
            return hostlog_build("mega", hostlog_plan(), trace=TEL_TRACE_ID,
                                 **kw)[0]
        return build

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
             hostlog),
            ("blob chain 2^19 walkers, 2^14 chains, pool 2^20 - 1", blobs),
            (RANDPING_WORLD, randping)
            ] + [(label, tel(label, kw)) for label, kw in TEL_WORLDS.items()]


RANDPING_WORLD = "randping 2^20 x 4 x 32 (stdlib.random in the body)"


YARDSTICK_WORLD = "ubench 2^20 hops=2^30 (every payload escaped)"


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
        if ticks == T and label not in UNTIMED:
            # times from the steady state after window 1
            def kern():
                if forced_world:
                    return mw.forced(st1, e_it, e_iw, T)
                return mw(st1, e_it, e_iw, T, True, zero)

            def plain():
                if forced_world:
                    return mw.plain_forced(st1, e_it, e_iw, T)
                return mw.plain(st1, e_it, e_iw, T, True, zero, None)
            # The plain window launches thousands of kernels a call (tens
            # of thousands for mixed), and the profiler's bookkeeping for
            # one such call takes seconds (about 60 s over these worlds):
            # its device time (one call, after the wall's calls have
            # warmed it, the card's activity alone recorded) is taken on
            # ubench, the kernel's main entry, and on every world in a
            # --only run.
            t = dict(ms=device_ms(kern, 5, [()], "pony_mega_kernel"),
                     call_ms=cuda_ms(kern, 5, [()]),
                     plain_call_ms=cuda_ms(plain, 1, [()], warm=0))
            t.update(plain_ms=(
                device_ms(plain, 1, [()], warm=0, host=False)
                if PLAIN_EVERY_WORLD[0] or label == YARDSTICK_WORLD
                else None))
            try:
                if label != YARDSTICK_WORLD:
                    # The yardstick feeds only the "Library" column of
                    # PERF.md's kernel table; it is taken on ubench alone
                    # to keep the script inside its time limit.
                    raise RuntimeError("not captured: the yardstick runs "
                                       "on ubench alone")
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
            allocs, frees = (int(getattr(want[0], f)[0])
                             - int(getattr(st1, f)[0])
                             for f in ("n_blob_alloc", "n_blob_free"))
            tel = None
            if mw.world["PROF"]:
                def delta(f, k=0):
                    v = getattr(want[0], f)
                    return int(v[k]) - int(getattr(st1, f)[k]) \
                        if v.numel() else 0
                tel = dict(drained=delta("phase_cost", 1),
                           delivered=delta("n_delivered"),
                           spans=delta("span_count"),
                           events=delta("ev_count"))
                rec.update(tel=tel)
            b_ms, b_by, nbytes, t_b, t_o, design = mega_bound(
                mw, T, processed, live, branch, allocs, frees, tel)
            t.update(phases=mega_phases(mw, kern, label))
            t.update(seconds=time.perf_counter() - t0)
            t.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                     bytes_ms=t_b, ops_ms=t_o, design_bytes=design,
                     design_ms=design / H100_BYTES_PER_S * 1e3,
                     ms_tick=t["ms"] / T,
                     plain_ms_tick=(t["plain_ms"] / T
                                    if t["plain_ms"] is not None else None),
                     bound_ms_tick=b_ms / T)
            rec.update(t)
            lib = ("not captured: " + t["graph_error"]
                   if t.get("library_ms") is None else
                   f"{t['library_ms']:.3f} ms device, "
                   f"{t['library_call_ms']:.3f} ms wall")
            pdev = ("device not profiled" if t["plain_ms"] is None
                    else f"{t['plain_ms']:.3f} ms device")
            print(f"window kernel {label}, a window of {T} ticks: kernel "
                  f"{t['ms']:.3f} ms device ({t['ms_tick']:.4f} ms a "
                  f"tick), {t['call_ms']:.3f} ms wall a call; plain window "
                  f"{pdev}, {t['plain_call_ms']:.3f} ms wall; CUDA graph of the plain forced window {lib}; "
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
                shapes=list(worlds),
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

    def blobchain(device, mode):
        # A small blob chain: 256 walkers, 16 chains of 1..40 hops.
        return blob_build(mode, blob_plan(256, 16, 31, 40), device)

    def blobchain_done(rt):
        _tb, TB = blob_programs()
        rt.run(max_steps=100_000)
        acc = blob_plan(256, 16, 31, 40)[4]
        if rt.blobs_in_use or not (
                rt.cohort_state(TB.BlobWalker)["acc"] == acc).all():
            raise AssertionError("blob chain: acc differs from the oracle "
                                 f"or {rt.blobs_in_use} blobs in use")
        return (_world_numbers(rt, TB.BlobWalker)
                + (rt.state.blob_gen.tolist(),
                   rt.counter("n_blob_alloc"), rt.counter("n_blob_free")))

    worlds = [("walkers (spill/mute)", walkers, walkers_done),
              ("ring", rings, rings_done), ("ubench", pingers, pingers_done),
              ("mixers (every effect)", mixers, mixers_done),
              ("spawn tree depth 8", tree, tree_done),
              ("spawn/destroy churn", churn, churn_done),
              ("spawn_sync", sync, sync_done),
              ("host reporting", hostrep, hostrep_done),
              ("blob chain", blobchain, blobchain_done)]
    worlds += [(f"corpus {n}", *corpus(n)) for n in tp.CORPUS]
    return worlds


def plan_state(rt):
    """The carried delivery state (under cosort: the placeholders)."""
    return [getattr(rt.state, f).tolist()
            for f in ("plan_key", "plan_perm", "plan_bounds")]


# The agree worlds also run under cosort: those whose delivery sees
# spill, mutes, spawns, host rows or blobs (the corpus adds nothing there).
COSORT_AGREE = ("walkers (spill/mute)", "ubench", "spawn tree depth 8",
                "host reporting", "blob chain")


AGREE_MODES = (False, True, "mega", "cosort", "cosort+fused")
AGREE_PROCS = 3   # processes that run the agree worlds on the CPU while
#   this one runs them on the card (the CPU runs took about half the
#   phase when they ran in turn with the card's)


def agree_cpu(mode, name):
    """One agree world on the CPU (in a worker process): its numbers."""
    import torch
    torch.set_num_threads(2)
    for n, build, finish in agree_worlds():
        if n == name:
            cpu = build("cpu", mode)
            c = finish(cpu)
            if mode in ("cosort", "cosort+fused"):
                c = (c, plan_state(cpu))
            return c
    raise KeyError(name)


@phase("agree")
def agree_small_worlds():
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    jobs = [(mode, name) for mode in AGREE_MODES
            for name, _b, _f in agree_worlds()
            if mode not in ("cosort", "cosort+fused")
            or name in COSORT_AGREE]
    with ProcessPoolExecutor(
            AGREE_PROCS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = {job: pool.submit(agree_cpu, *job) for job in jobs}
        worlds = {name: (build, finish)
                  for name, build, finish in agree_worlds()}
        waited = 0.0
        for mode, name in jobs:
            build, finish = worlds[name]
            rt = build("cuda", mode)
            paths = dispatch_paths(rt)
            g = finish(rt)
            if mode in ("cosort", "cosort+fused"):
                g = (g, plan_state(rt))
            t0 = time.perf_counter()
            c = cpu[(mode, name)].result()
            waited += time.perf_counter() - t0
            if g != c:
                raise AssertionError(f"{name} ({_mode_name(mode)}): the "
                                     f"card and the CPU disagree: {g} vs "
                                     f"{c}")
            print(f"{name} {_mode_name(mode)}: card == CPU ({paths})",
                  flush=True)
    print(f"agree: {len(jobs)} worlds on the card and the CPU; the card's "
          f"side waited {waited:.1f} s for the CPU's {AGREE_PROCS} "
          "processes", flush=True)


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


def expected_launches(mode, ticks, windows, cohorts=1):
    """What a path launches: a drain or a fused kernel a cohort and a
    tick enqueued, or one window kernel a window dispatched."""
    if mode == "mega":
        return (0, 0, windows)
    k = cohorts * ticks
    return (0, k, 0) if _fused(mode) else (k, 0, 0)


# The telemetry leaves a run's paths must agree on (each where its level
# has it; qwait_enq and trace_buf too).
TEL_LEAVES = ("beh_runs", "beh_delivered", "beh_rejected", "coh_mute_ticks",
              "qwait_hist", "phase_cost", "ev_data", "ev_count", "ev_dropped",
              "span_data", "span_count", "span_dropped", "span_next")


def world_numbers(rt, atype):
    """A finished run's fields of `atype`, counters, ticks and telemetry
    leaves (numpy), for comparing runs."""
    st = rt.state
    tel = {f: getattr(st, f).cpu().numpy() for f in TEL_LEAVES
           if getattr(st, f).numel()}
    for f in ("qwait_enq", "trace_buf"):
        tel.update({f"{f}.{k}": v.cpu().numpy()
                    for k, v in getattr(st, f).items()})
    return {"fields": {k: v for k, v in rt.cohort_state(atype).items()},
            "counters": {c: rt.counter(c) for c in (
                "n_processed", "n_delivered", "n_rejected", "n_mutes",
                "n_deadletter", "n_spawned", "n_destroyed", "n_errors")},
            "steps": rt.steps_run, "tel": tel}


def same_arrays(a, b):
    """Two dicts of numpy arrays (or numbers) equal, key by key."""
    import numpy as np
    if set(a) != set(b):
        return False
    return all(np.array_equal(a[k], b[k]) if hasattr(a[k], "shape")
               else a[k] == b[k] for k in a)


def ubench_windows(mode, n, pings, warm, ticks, **kw):
    """Three timed windows of `ticks` ticks of ubench; checks the
    processed count and the path's launches. `kw`: more options (the
    telemetry's). Returns (the launches of the last window, the times,
    the final world's numbers: fields, counters and telemetry leaves)."""
    import torch
    from ponyc_tpu_torch.models import ubench
    t0 = time.perf_counter()
    rt, ids = ubench.build(n, ubench_opts(mode, ticks, **kw), pings=pings)
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
    tel = "".join(f" {k}={v}" for k, v in kw.items())
    print(f"ubench{tel} {_mode_name(mode)} median of {len(per_tick)} "
          f"windows: {1e3 * p50:.3f} ms/tick, {n * pings / p50:.4g} msgs/s "
          f"(spread {1e3 * min(per_tick):.3f}-{1e3 * max(per_tick):.3f} "
          f"ms/tick)", flush=True)
    final = world_numbers(rt, ubench.Pinger)
    del rt
    torch.cuda.empty_cache()
    return max(got), {"msgs_per_s": n * pings / p50, "s_per_tick": p50,
                      "s_per_tick_each": per_tick}, final


UBENCH = (1 << 20, 4, 8, 64)     # pingers, pings, warm-up ticks, ticks


@phase("ubench")
def run_ubench(rec, frec, mrec):
    out, finals = {}, _CACHE.setdefault("ubench", {})
    for mode, r, key in ((False, rec, "plain"), (True, frec, "fused"),
                         ("mega", mrec, "mega")):
        r["launches"], out[key], final = ubench_windows(mode, *UBENCH)
        finals[mode] = (out[key], final)
    # Cosort delivery on the plain tick and the fused kernel, beside plan:
    # the same ticks from the same seeds end in the same world.
    for mode, r, key, plan in (("cosort", rec, "cosort", False),
                               ("cosort+fused", frec, "cosort fused", True)):
        r["launches_cosort"], out[key], final = ubench_windows(mode, *UBENCH)
        base = finals[plan][1]
        if not same_arrays(final["fields"], base["fields"]) or \
                final["counters"] != base["counters"] or \
                final["steps"] != base["steps"]:
            raise AssertionError(f"ubench {_mode_name(mode)}: fields, "
                                 "counters or ticks differ from plan's")
        print(f"ubench {_mode_name(mode)}: fields, counters and ticks equal "
              f"plan's; {1e3 * out[key]['s_per_tick']:.3f} ms/tick against "
              f"plan's {1e3 * finals[plan][0]['s_per_tick']:.3f} "
              f"({100 * (out[key]['s_per_tick'] / finals[plan][0]['s_per_tick'] - 1):+.1f} %) "
              f"[{_CACHE['card']}]", flush=True)
    return out


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
        # The plain and fused ticks take 7-20 ms a hop on the host's
        # clock: they run a 64th of the hops (three runs of 64; 128 until
        # the stdlib phase needed the time), which keeps the whole script
        # within its time limit (the time a hop is what this phase
        # reports).
        n_hops = hops if mode == "mega" else hops // 64
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
    world at 2^20 walkers, then the spreader at SPREAD_DEPTH."""
    import numpy as np
    import torch
    tp, T = programs()
    plans = {HOST_CUT[0]: hostlog_plan(*HOST_CUT[:2], max_len=HOST_CUT[2]),
             HOST_WALKERS: hostlog_plan()}
    card = _CACHE["card"]
    res, out = {}, {}
    # The plain and fused paths at HOST_CUT (walkers, chains, longest
    # chain), held against the window kernel there; the window kernel at
    # full width too.
    cut = HOST_CUT[0]
    for mode, n in ((False, cut), (True, cut), ("mega", cut),
                    ("mega", HOST_WALKERS)):
        plan = plans[n]
        acc = plan[3]
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
        chains = HOST_CHAINS if n == HOST_WALKERS else HOST_CUT[1]
        if code != 0 or nums["host"]["ends"] != chains \
                or not np.array_equal(walk.astype(np.int64), acc):
            raise AssertionError(
                f"hostlog {_mode_name(mode)}: exit code {code}, host "
                f"{nums['host']} (want {chains} ends), acc equal to "
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
        res[(mode, n)] = dict(nums, acc=walk, windows=windows[0])
        out[f"{_mode_name(mode)} {n} walkers"] = dict(
            seconds=elapsed, setup_s=setup, ticks=rt.steps_run,
            enqueued=enqueued, windows=windows[0], host_windows=for_host,
            early_host_windows=early, ms_per_tick=1e3 * elapsed
            / max(1, rt.steps_run), launches=got,
            host_processed=nums["host_processed"], **nums["counters"])
        if timed is not None:
            out[f"{_mode_name(mode)} {n} walkers"].update(
                device_ms=dev_us / 1e3, busy_share=dev_us / 1e6 / elapsed)
        {False: rec, True: frec, "mega": mrec}[mode]["launches_host"] = \
            max(got)
        if mode == "mega" and n == HOST_WALKERS:
            _CACHE["hostlog_untraced"] = dict(ticks=rt.steps_run,
                                              windows=windows[0],
                                              seconds=elapsed)
        print(f"hostlog {n} walkers "
              f"{HOST_CHAINS if n == HOST_WALKERS else HOST_CUT[1]} chains "
              f"of 1..{256 if n == HOST_WALKERS else HOST_CUT[2]} hops "
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
        a, b = res[(mode, cut)], res[(False, cut)]
        na = {k: v for k, v in a.items() if k != "acc"}
        nb = {k: v for k, v in b.items() if k != "acc"}
        if not np.array_equal(a["acc"], b["acc"]) or na != nb:
            raise AssertionError(f"hostlog: {_mode_name(mode)} differs from "
                                 f"the plain tick: {na} vs {nb}")
    print(f"hostlog at {HOST_CUT} (walkers, chains, longest chain): acc, "
          "the host actor's state, "
          "counters, host_processed, ticks run and windows equal across the "
          "plain tick, the fused kernel and the window kernel", flush=True)
    plan = plans[HOST_WALKERS]
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
    full = res[("mega", HOST_WALKERS)]
    ref = {k: v for k, v in full.items() if k not in ("acc", "windows")}
    if nums != ref or not np.array_equal(
            rt.cohort_state(T.WalkerH)["acc"], full["acc"]):
        raise AssertionError(f"hostlog: the checked run differs: {nums} vs "
                             f"{ref}")
    print(f"hostlog pallas_mega: {n_chk} windows ({t_chk} ticks) of a "
          f"second run bit-equal to the host C++ build of the window "
          f"kernel on the same input, and that run equal to the first "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    out["host_build_windows"] = n_chk
    del rt
    torch.cuda.empty_cache()
    # examples/spreader.py's program: device spawns and a host collector
    # that fulfils the promise the host waits on (the promise drives the
    # runtime while it waits).
    leaves, sp = 1 << SPREAD_DEPTH, {}
    for mode in (False, True, "mega"):
        rt, col, done = spread_build(mode)
        windows = count_windows(rt)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        total = done.value(timeout=600)
        code = rt.run(max_steps=100_000)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = launches()
        nums = host_numbers(rt, col)
        if code != 0 or total != leaves or nums["host"]["got"] != leaves or \
                nums["counters"]["n_spawned"] != 2 * leaves - 2:
            raise AssertionError(f"spreader {_mode_name(mode)}: exit code "
                                 f"{code}, {nums}")
        sp[mode] = dict(nums, windows=windows[0],
                        alive=rt.state.alive.cpu().numpy())
        out[f"spreader {_mode_name(mode)}"] = dict(
            seconds=elapsed, ticks=rt.steps_run, windows=windows[0],
            launches=got)
        print(f"spreader depth {SPREAD_DEPTH} {_mode_name(mode)} [{card}]: "
              f"promise fulfilled with {total}, got {nums['host']['got']}, "
              f"n_spawned "
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


def blob_numbers(rt, atype):
    """The numbers the paths must agree on after a blob world's run: the
    fields, the counters (the pool's included), ticks, exit code and the
    pool's arrays."""
    names = ("n_processed", "n_delivered", "n_rejected", "n_mutes",
             "n_deadletter", "n_blob_alloc", "n_blob_free", "n_blob_remote")
    st = rt.state
    return {"fields": {k: v for k, v in rt.cohort_state(atype).items()},
            "counters": {c: rt.counter(c) for c in names},
            "steps": rt.steps_run, "code": rt.exit_code,
            "pool": {f: getattr(st, f).cpu().numpy() for f in (
                "blob_data", "blob_used", "blob_len", "blob_gen")}}


def same_numbers(a, b):
    """Equality of two blob_numbers (numpy arrays compared whole)."""
    import numpy as np
    if a.keys() != b.keys():
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            if not same_numbers(x, y):
                return False
        elif isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


@phase("blobs")
def run_blobs(rec, frec, mrec):
    """The device blob pool and the collector on each path (see the
    module docstring): the blob chain at 2^19 walkers, the GC at full
    width, the records model and the blob pipeline."""
    import numpy as np
    import torch
    import ponyc_tpu_torch
    from ponyc_tpu_torch.models import records
    tp, T = blob_programs()
    full = (BLOB_WALKERS, BLOB_CHAINS, 256)
    plans = {BLOB_CUT: blob_plan(BLOB_CUT[0], BLOB_CUT[1],
                                 max_len=BLOB_CUT[2]),
             full: blob_plan()}
    card = _CACHE["card"]
    res, out = {}, {}
    rt = None
    # The plain and fused paths at BLOB_CUT (walkers, chains, longest
    # chain), held against the window kernel there; the window kernel at
    # full width too, whose finished world the GC takes.
    for mode, size in ((False, BLOB_CUT), (True, BLOB_CUT), ("mega", BLOB_CUT),
                       ("mega", full)):
        plan = plans[size]
        nxt, acc = plan[0], plan[4]
        del rt
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rt = blob_build(mode, plan)
        windows = count_windows(rt)
        peak = spill_peak(rt)
        timed = None
        if mode == "mega":
            timed = rt._multi_g._fn = EventTimed(rt._multi_g._fn)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        q0 = rt.ticks_enqueued
        reset_launches()                # the main path's run starts here
        t0 = time.perf_counter()
        code = rt.run(max_steps=1_000_000)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = launches()                # ... and ends here
        enqueued = rt.ticks_enqueued - q0
        nums = blob_numbers(rt, T.BlobWalker)
        walk = nums["fields"]["acc"].astype(np.int64)
        if code != 0 or not np.array_equal(walk, acc) \
                or rt.blobs_in_use != 0 \
                or nums["counters"]["n_blob_remote"] != 0:
            raise AssertionError(
                f"blob chain {_mode_name(mode)}: exit code {code}, acc "
                f"equal to the oracle: {np.array_equal(walk, acc)}, "
                f"blobs in use {rt.blobs_in_use}, counters "
                f"{nums['counters']}")
        # The blob cohort takes the plain dispatch under pallas_fused
        # (as in the JAX package): a drain a tick there too.
        want = ((0, 0, windows[0]) if mode == "mega"
                else (enqueued, 0, 0))
        if got != want or rt.steps_run > enqueued:
            raise AssertionError(f"blob chain {_mode_name(mode)}: launches "
                                 f"(drain, fused, window) {got} for "
                                 f"{enqueued} ticks enqueued, {windows[0]} "
                                 f"windows (expected {want})")
        dev = ""
        row = dict(seconds=elapsed, setup_s=setup, ticks=rt.steps_run,
                   enqueued=enqueued, windows=windows[0],
                   ms_per_tick=1e3 * elapsed / rt.steps_run, launches=got,
                   spill_peak=peak[0], **nums["counters"])
        if timed is not None:
            dev_us = timed.take_us()
            row.update(device_ms=dev_us / 1e3,
                       device_us_tick=dev_us / rt.steps_run,
                       busy_share=dev_us / 1e6 / elapsed)
            dev = (f"; window kernel device time {dev_us / 1e3:.3f} ms a "
                   f"run (CUDA events) = {dev_us / rt.steps_run:.2f} us a "
                   f"tick, device busy {100 * dev_us / 1e6 / elapsed:.1f}% "
                   "of the wall")
            mrec["launches_blobs"] = got[2]
        else:
            rec.setdefault("launches_blobs", {})[_mode_name(mode)] = got[0]
        out[f"{_mode_name(mode)} {size[0]} walkers"] = row
        res[(mode, size)] = dict(nums, windows=windows[0])
        print(f"blob chain {size[0]} walkers {size[1]} chains of "
              f"1..{size[2]} hops "
              f"{_mode_name(mode)} [{card}]: exit code {code}, acc equal "
              f"to the oracle, blobs in use 0; wall {elapsed:.3f} s a run "
              f"(setup {setup:.1f} s), {rt.steps_run} ticks run = "
              f"{row['ms_per_tick']:.3f} ms/tick, {enqueued} enqueued, "
              f"{windows[0]} windows, spill peak {peak[0]} of {BLOB_SPILL}"
              f"; counters {nums['counters']}; launches (drain, fused, "
              f"window) {got}{dev}; dispatch {dispatch_paths(rt)}",
              flush=True)
    for mode in (True, "mega"):
        if not same_numbers(res[(mode, BLOB_CUT)], res[(False, BLOB_CUT)]):
            raise AssertionError(f"blob chain: {_mode_name(mode)} differs "
                                 "from the plain tick")
    print(f"blob chain at {BLOB_CUT[0]} walkers, {BLOB_CUT[1]} chains of "
          f"1..{BLOB_CUT[2]} hops: acc, "
          "the pool's arrays (data, used, len, gen: the handles' slots and "
          "generations), counters, ticks and windows equal across the plain "
          "tick, the fused path and the window kernel", flush=True)
    # The collector at full width, from the finished world (the window
    # kernel's run): every walker but BLOB_KEEP released, then one gc().
    n = len(nxt)
    ids = np.arange(n)
    rt.release(ids[BLOB_KEEP:])
    torch.cuda.synchronize()
    before = rt.counter("n_collected")
    t0 = time.perf_counter()
    collected = rt.gc()
    torch.cuda.synchronize()
    gc_s = time.perf_counter() - t0
    live, iters = reach_oracle(nxt, ids[:BLOB_KEEP])
    alive = rt.state.alive.cpu().numpy()
    gc = dict(seconds=gc_s, collected=collected, iters=rt.totals["gc_iters"],
              aborted=rt.totals["gc_aborted"], alive=int(alive.sum()),
              oracle_alive=int(live.sum()), oracle_iters=iters)
    if (collected != n - int(live.sum()) or not np.array_equal(alive, live)
            or rt.totals["gc_iters"] != iters or rt.totals["gc_aborted"]
            or rt.counter("n_collected") - before != collected):
        raise AssertionError(f"gc at full width: {gc}")
    print(f"gc at full width [{card}]: {BLOB_KEEP} walkers kept pinned of "
          f"{n}; collected {collected}, {int(alive.sum())} alive = the "
          f"NumPy reachability oracle over nxt; {iters} hops to the "
          f"fixpoint (converged) as the oracle counts; wall {gc_s:.3f} s",
          flush=True)
    out["gc"] = gc
    del rt
    torch.cuda.empty_cache()
    # The records model on each path at RECORDS_CUT, the window kernel at
    # RECORDS too, and the blob pipeline on each path.
    rr, pp = {}, {}
    for mode, size in ((False, RECORDS_CUT), (True, RECORDS_CUT),
                       ("mega", RECORDS_CUT), ("mega", RECORDS)):
        reset_launches()
        t0 = time.perf_counter()
        rt, st = records.run_records(*size, opts=records_opts(mode,
                                                              size[0]),
                                     device="cuda")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = launches()
        rr[mode, size] = dict(sink=st, counters={c: rt.counter(c) for c in (
            "n_processed", "n_blob_alloc", "n_blob_free", "n_mutes")},
            steps=rt.steps_run, gen=rt.state.blob_gen.cpu().numpy())
        out[f"records {size} {_mode_name(mode)}"] = dict(
            seconds=elapsed, ticks=rt.steps_run, launches=got)
        print(f"records {size[0]} sources x {size[1]} records "
              f"{_mode_name(mode)} [{card}]: the model's oracle holds "
              f"({st['n']} records, checksum {st['total']}), blobs in use "
              f"0; {rt.steps_run} ticks in {elapsed:.3f} s; launches "
              f"(drain, fused, window) {got}; dispatch {dispatch_paths(rt)}",
              flush=True)
        del rt
        if mode in pp:
            continue
        rt, (r1, r2), before = tp.run_blob_pipeline(
            ponyc_tpu_torch, T, device="cuda", **_mode_kw(mode))
        s1, s2 = rt.state_of(r1), rt.state_of(r2)
        if s1 != s2 or s1["n"] != len(tp.PIPE_LINES) \
                or before != len(tp.PIPE_LINES) or rt.blobs_in_use:
            raise AssertionError(f"blob pipeline {_mode_name(mode)}: {s1} "
                                 f"{s2}, {before} summaries before the gc, "
                                 f"{rt.blobs_in_use} after")
        pp[mode] = (s1, rt.steps_run)
        print(f"blob pipeline {_mode_name(mode)}: both reviewers {s1}, "
              f"{before} frozen summaries swept by gc()", flush=True)
        del rt
    for mode in (True, "mega"):
        a, b = rr[mode, RECORDS_CUT], rr[False, RECORDS_CUT]
        if not np.array_equal(a["gen"], b["gen"]) or \
                {k: v for k, v in a.items() if k != "gen"} != \
                {k: v for k, v in b.items() if k != "gen"} \
                or pp[mode] != pp[False]:
            raise AssertionError(f"records or pipeline: {_mode_name(mode)} "
                                 "differs from the plain tick")
    print(f"records at {RECORDS_CUT} and the blob pipeline: results, "
          "counters, ticks and the pool's generations equal across the "
          "three paths",
          flush=True)
    return out


TEL_DIR = os.path.join(ROOT, "_chipwork", "smoke_analysis")   # git-ignored
TEL_TRACE_ID = 4242          # the hostlog chains' trace id (bulk_send)
TEL_TRACE_SLOTS = 1 << 16    # span-ring entries (the run drops none)


def tel_csv(path, skip=("time_ms", "rss_kb", "cpu_ms", "host_gap_us",
                        "bytes_msg")):
    """An analysis CSV's deterministic columns, row by row: the wall
    clock, rss and cpu columns left out, and bytes_msg, the record width
    of the run's delivery formulation (2 bytes a word under pallas_mega,
    4 elsewhere: a label of the path, not a measurement)."""
    import csv
    with open(path) as f:
        return [{k: v for k, v in r.items() if k not in skip}
                for r in csv.DictReader(f)]


def tel_run(label, mode, rt, windows, run, cohorts=1):
    """Run `rt` as the main path (launch counts reset just before and
    read just after; one kernel of the path a cohort and a tick
    enqueued, or one window kernel per window), stop it, and return
    (exit code, seconds, launches)."""
    import torch
    torch.cuda.synchronize()
    q0 = rt.ticks_enqueued
    reset_launches()                # the main path's run starts here
    t0 = time.perf_counter()
    code = run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    got = launches()                # ... and ends here
    enqueued = rt.ticks_enqueued - q0
    want = expected_launches(mode, enqueued, windows[0], cohorts)
    if got != want or rt.steps_run > enqueued:
        raise AssertionError(f"{label} {_mode_name(mode)}: launches (drain, "
                             f"fused, window) {got} for {enqueued} ticks "
                             f"enqueued, {windows[0]} windows (expected "
                             f"{want})")
    return code, elapsed, got


@phase("telemetry")
def run_telemetry(rec, frec, mrec):
    """Analysis levels 1-3 and causal tracing on each path at full width
    (see the module docstring)."""
    import hashlib
    import shutil
    import numpy as np
    import torch
    from ponyc_tpu_torch import tracing
    from ponyc_tpu_torch.models import spawn_tree, ubench
    card = _CACHE["card"]
    recs = {False: rec, True: frec, "mega": mrec}
    shutil.rmtree(TEL_DIR, ignore_errors=True)
    os.makedirs(TEL_DIR)
    out = {}
    # -- ubench 2^20 x 4 at analysis 1: the telemetry's cost a tick.
    finals = _CACHE.setdefault("ubench", {})
    tel = {}
    for mode in (False, True, "mega"):
        if mode not in finals:        # the ubench phase did not run
            _l, t0_, f0 = ubench_windows(mode, *UBENCH)
            finals[mode] = (t0_, f0)
        base_t, base = finals[mode]
        recs[mode]["launches_telemetry"], t1, fin = ubench_windows(
            mode, *UBENCH, analysis=1)
        tr = fin["tel"]
        if int(tr["beh_runs"].sum()) != fin["counters"]["n_processed"] or \
                int(tr["beh_delivered"].sum()) != \
                fin["counters"]["n_delivered"]:
            raise AssertionError(f"ubench analysis=1 {_mode_name(mode)}: "
                                 "beh_runs or beh_delivered do not sum to "
                                 f"the counters: {fin['counters']}")
        if not same_arrays(fin["fields"], base["fields"]) or \
                fin["counters"] != base["counters"] or \
                fin["steps"] != base["steps"]:
            raise AssertionError(f"ubench analysis=1 {_mode_name(mode)}: "
                                 "fields, counters or ticks differ from the "
                                 "analysis=0 run's")
        tel[mode] = tr
        a0, a1 = base_t["s_per_tick"], t1["s_per_tick"]
        out[f"ubench analysis=1 {_mode_name(mode)}"] = dict(
            ms_tick=1e3 * a1, ms_tick_analysis0=1e3 * a0,
            cost=a1 / a0 - 1, each=t1["s_per_tick_each"])
        print(f"ubench analysis=1 {_mode_name(mode)} [{card}]: "
              f"{1e3 * a1:.3f} ms/tick against {1e3 * a0:.3f} at analysis=0 "
              f"({100 * (a1 / a0 - 1):+.1f} %); sum beh_runs = n_processed "
              f"= {fin['counters']['n_processed']}; fields and counters "
              f"equal the analysis=0 run's", flush=True)
    for mode in (True, "mega"):
        if not same_arrays(tel[mode], tel[False]):
            raise AssertionError(f"ubench analysis=1: telemetry leaves of "
                                 f"{_mode_name(mode)} differ from the plain "
                                 "tick's")
    print(f"ubench analysis=1: every telemetry leaf ({', '.join(tel[False])}"
          ") bit-equal across the three paths", flush=True)
    rt, ids = ubench.build(UBENCH[0], ubench_opts("mega", MEGA_TICKS,
                                                  analysis=1), pings=4)
    ubench.seed_all(rt, ids, hops=1 << 30, pings=4)
    rt.run(max_steps=MEGA_TICKS)
    mw, st, (e_it, e_iw) = rt._multi_g, rt.state, rt._empty_inject
    out["ubench analysis=1 phases"] = mega_phases(
        mw, lambda: mw.forced(st, e_it, e_iw, MEGA_TICKS),
        f"ubench 2^20 analysis=1 (PROF) [{card}]")
    del rt, mw, st
    torch.cuda.empty_cache()
    # -- the spawn tree at analysis 3: its 2^21 - 2 spawns overflow the
    # 4,096-entry event ring every window.
    leaves, ev = 1 << SPAWN_DEPTH, {}
    for mode in (False, True, "mega"):
        path = os.path.join(TEL_DIR, f"spawn-{_mode_name(mode)}.csv")
        rt, _root = spawn_tree.build(SPAWN_DEPTH, spawn_opts(
            mode, analysis=3, analysis_path=path))
        windows = count_windows(rt)
        code, elapsed, got = tel_run("spawn tree analysis=3", mode, rt,
                                     windows, lambda: rt.run(max_steps=10_000))
        nums = world_numbers(rt, spawn_tree.Node)
        rt.stop()
        if code != leaves or nums["counters"]["n_spawned"] != 2 * leaves - 2:
            raise AssertionError(f"spawn tree analysis=3 {_mode_name(mode)}: "
                                 f"exit code {code}, {nums['counters']}")
        rows = tel_csv(path + ".events.csv", skip=("time_ms",))
        ev[mode] = (nums, rows, windows[0])
        dropped = int(nums["tel"]["ev_dropped"][0])
        recs[mode]["launches_telemetry_spawn"] = max(got)
        out[f"spawn tree analysis=3 {_mode_name(mode)}"] = dict(
            seconds=elapsed, ticks=rt.steps_run, windows=windows[0],
            events=len(rows), ev_dropped=dropped, launches=got)
        print(f"spawn tree depth {SPAWN_DEPTH} analysis=3 {_mode_name(mode)} "
              f"[{card}]: exit code {code}, n_spawned "
              f"{nums['counters']['n_spawned']}; {len(rows)} events "
              f"recorded, {dropped} dropped (ring of 4096 a window); "
              f"{rt.steps_run} ticks in {elapsed:.3f} s = "
              f"{1e3 * elapsed / rt.steps_run:.3f} ms/tick, {windows[0]} "
              f"windows; launches (drain, fused, window) {got}", flush=True)
        del rt
        torch.cuda.empty_cache()
    for mode in (True, "mega"):
        (a, ra, wa), (b, rb, wb) = ev[mode], ev[False]
        if not (same_arrays(a["tel"], b["tel"]) and ra == rb and wa == wb
                and same_arrays(a["fields"], b["fields"])
                and a["counters"] == b["counters"]):
            raise AssertionError(f"spawn tree analysis=3: {_mode_name(mode)} "
                                 "differs from the plain tick")
    if not int(ev[False][0]["tel"]["ev_dropped"][0]) > 0:
        raise AssertionError("spawn tree analysis=3: the event ring did not "
                             "overflow")
    print("spawn tree analysis=3: ev_count, ev_dropped, ev_data, every "
          "telemetry leaf, the events CSV, fields and counters equal across "
          "the three paths", flush=True)
    # -- the hostlog world at analysis 3, every chain traced: the three
    # paths at HOST_CUT (their spans, events, CSV and leaves compared),
    # the window kernel at full width too (its ticks and windows equal
    # the untraced run's).
    plans = {"cut": hostlog_plan(*HOST_CUT[:2], max_len=HOST_CUT[2]),
             "full": hostlog_plan()}
    runs = {}
    for mode, size in ((False, "cut"), (True, "cut"), ("mega", "cut"),
                       ("mega", "full")):
        plan = plans[size]
        nxt, starts, lens, acc = plan
        chains = len(starts)
        path = os.path.join(TEL_DIR, f"hostlog-{_mode_name(mode)}-{size}.csv")
        rt, log = hostlog_build(mode, plan, trace=TEL_TRACE_ID, analysis=3,
                                trace_sample=1, trace_slots=TEL_TRACE_SLOTS,
                                analysis_path=path)
        windows = count_windows(rt)
        code, elapsed, got = tel_run("hostlog traced", mode, rt, windows,
                                     rt.run)
        nums = world_numbers(rt, programs()[1].WalkerH)
        host = rt.state_of(log)
        walk = nums["fields"]["acc"].astype(np.int64)
        if code != 0 or host["ends"] != chains or \
                not np.array_equal(walk, acc):
            raise AssertionError(f"hostlog traced {_mode_name(mode)}: exit "
                                 f"code {code}, host {host}, acc equal to the "
                                 f"oracle {np.array_equal(walk, acc)}")
        t0 = time.perf_counter()
        rt._tracer.drain(rt)
        spans = sorted(rt._tracer.spans)
        digest = hashlib.sha256(repr(spans).encode()).hexdigest()
        ok = True
        tree_checked = mode is False or size == "full"
        if tree_checked:      # the other paths' spans equal the plain's
            trees = tracing.reassemble(spans)
            if set(trees) != {TEL_TRACE_ID}:
                raise AssertionError(f"hostlog traced: traces "
                                     f"{sorted(trees)}")
            tree = trees[TEL_TRACE_ID]
            (root,) = tree["roots"]
            want_len = dict(zip(starts.tolist(), (lens + 1).tolist()))
            ok = tracing.consistent(tree) and len(root.children) == chains
            for first in root.children:
                s, n_dev = first, 0
                while s.actor >= 0 and s.span_id % 2 == 0:
                    n_dev += 1
                    if len(s.children) != 1:
                        break
                    s = s.children[0]
                ok = ok and n_dev == want_len.get(first.actor) and \
                    s.span_id % 2 == 1 and s.beh == "HostLog.done" and \
                    not s.children
        if not ok or rt._tracer.dropped:
            raise AssertionError(f"hostlog traced {_mode_name(mode)}: the "
                                 f"trace is not one consistent tree of "
                                 f"{chains} chains, each its oracle's "
                                 f"dispatches then one host span (dropped "
                                 f"{rt._tracer.dropped})")
        check_s = time.perf_counter() - t0
        rt.stop()
        runs[(mode, size)] = dict(
            nums=nums, host=host, digest=digest, n_spans=len(spans),
            windows=windows[0], csv=tel_csv(path),
            events=tel_csv(path + ".events.csv", skip=("time_ms",)))
        recs[mode]["launches_telemetry_host"] = max(got)
        out[f"hostlog traced {_mode_name(mode)} {len(nxt)} walkers"] = dict(
            seconds=elapsed, ticks=rt.steps_run, windows=windows[0],
            spans=len(spans), launches=got, ms_per_tick=1e3 * elapsed /
            rt.steps_run, trace_check_s=check_s)
        what = ("one consistent trace of {} spans, {} branches each of "
                "its chain's dispatches then one host span".format(
                    len(spans), chains) if tree_checked else
                f"{len(spans)} spans")
        print(f"hostlog {len(nxt)} walkers, {chains} chains of "
              f"1..{int(lens.max())} hops, traced (analysis=3, "
              f"trace_sample=1, trace_slots {TEL_TRACE_SLOTS}) "
              f"{_mode_name(mode)} [{card}]: acc equal to the oracle, ends "
              f"{host['ends']}; {what}, none dropped (checked in "
              f"{check_s:.1f} s); "
              f"wall {elapsed:.3f} s a run, {rt.steps_run} ticks = "
              f"{1e3 * elapsed / rt.steps_run:.3f} ms/tick, {windows[0]} "
              f"windows; launches (drain, fused, window) {got}", flush=True)
        del rt
        torch.cuda.empty_cache()
    for mode in (True, "mega"):
        a, b = runs[(mode, "cut")], runs[(False, "cut")]
        same = dict(spans=a["digest"] == b["digest"],
                    events=a["events"] == b["events"],
                    csv=a["csv"] == b["csv"], host=a["host"] == b["host"],
                    windows=a["windows"] == b["windows"],
                    telemetry=same_arrays(a["nums"]["tel"], b["nums"]["tel"]),
                    counters=a["nums"]["counters"] == b["nums"]["counters"],
                    ticks=a["nums"]["steps"] == b["nums"]["steps"])
        if not all(same.values()):
            raise AssertionError(f"hostlog traced: {_mode_name(mode)} differs "
                                 f"from the plain tick: {same}")
    untraced = _CACHE.get("hostlog_untraced")
    if untraced is None:              # the host phase did not run
        rt, _log = hostlog_build("mega", plans["full"])
        windows = count_windows(rt)
        rt.run()
        untraced = dict(ticks=rt.steps_run, windows=windows[0])
        del rt
    b = runs[("mega", "full")]
    if (b["nums"]["steps"], b["windows"]) != (untraced["ticks"],
                                             untraced["windows"]):
        raise AssertionError(f"hostlog traced: {b['nums']['steps']} ticks, "
                             f"{b['windows']} windows; untraced "
                             f"{untraced}")
    print(f"hostlog traced at {HOST_CUT} (walkers, chains, longest chain): "
          f"spans (sha256 {runs[(False, 'cut')]['digest'][:16]}), "
          f"events, the level-2 CSV's deterministic columns, every "
          f"telemetry leaf, counters, ticks and windows equal across the "
          f"three paths; at {HOST_WALKERS} walkers the window kernel's ticks "
          f"and windows equal the untraced run's "
          f"({untraced['ticks']}, {untraced['windows']})", flush=True)
    shutil.rmtree(TEL_DIR, ignore_errors=True)
    return out


def spill_peak(rt):
    """The largest receiver spill at the end of any window of the run (a
    list holding one number)."""
    out = [0]
    orig = rt._retire_window

    def retire(win):
        k, a = orig(win)
        out[0] = max(out[0], int(rt.state.dspill_count[0]))
        return k, a
    rt._retire_window = retire
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


# ---- the tuner, GUPS and fan-in -----------------------------------------

GUPS = (1 << 22, 1 << 20, 16)     # table cells, updaters, updates each
FANIN_BIG = (1 << 16, 1)          # producers, items each (window kernel)
FANIN_SMALL = (1 << 6, 4)         # producers, items each (every path;
#   2**8 until the serve phase needed the time, 2**7 until the stdlib
#   phase did: its plain and fused runs are about n * items ticks)
FANIN_PROBED = 16                 # first ticks of the big run, one a window
TUNE_SPAWN_DEPTH = 16             # the spawn tree of the tune phase
TUNE_BLOB = BLOB_CUT              # the blob chain of the tune phase
TUNE_TICKS = 32                   # ticks of the auto run against the fixed
TUNE_SLACK = 2.0                  # the auto run's tick against pallas_mega's


def gups_kw(mode):
    # models/gups.py's build options: cap 16, batch 2, one word a message
    return dict(mailbox_cap=16, batch=2, msg_words=1, spill_cap=1024,
                tuning_cache="off", **_mode_kw(mode))


def gups_declare(rt, cells=GUPS[0], n_upd=GUPS[1]):
    from ponyc_tpu_torch.models import gups
    rt.declare(gups.TableCell, cells).declare(gups.Updater, n_upd)


def gups_seed(rt, each=GUPS[2]):
    """models/gups.py's build and run, on a started runtime: the cells,
    the updaters with their PRNG seeds (numpy seed 7), and every
    updater's `tick(each)`."""
    import numpy as np
    from ponyc_tpu_torch.models import gups
    cells = rt.program.by_type[gups.TableCell]
    n_upd = rt.program.by_type[gups.Updater].capacity
    rt.spawn_many(gups.TableCell, cells.capacity)
    rng = np.random.default_rng(7)
    upd = rt.spawn_many(
        gups.Updater, n_upd, rng=rng.integers(1, 2**31 - 1, n_upd),
        cell_start=cells.local_start, n_shards=rt.program.shards,
        n_local=rt.program.n_local, table_size=cells.capacity)
    rt.bulk_send(upd, gups.Updater.tick, np.full(n_upd, each, np.int32))


def gups_oracle(n_upd=GUPS[1], each=GUPS[2], seed=7):
    """The xor of every value the updaters send: a replay of their
    xorshift32 streams in NumPy (tests/test_models.py)."""
    import numpy as np
    x = np.asarray(np.random.default_rng(seed).integers(1, 2**31 - 1,
                                                        n_upd), np.int32)
    expect = np.int32(0)
    for _ in range(each):
        x = (x ^ (x << 13)).astype(np.int32)
        x = (x ^ ((x >> 17) & 0x7FFF)).astype(np.int32)
        x = (x ^ (x << 5)).astype(np.int32)
        expect ^= np.bitwise_xor.reduce(x)
    return int(expect)


def fanin_kw(mode, n, items):
    # models/fanin.py's options (cap 8, batch 2, one word), two sends,
    # the spill raised to hold every item in flight
    return dict(mailbox_cap=8, batch=2, msg_words=1, max_sends=2,
                spill_cap=max(512, 2 * n * items), inject_slots=16,
                tuning_cache="off", **_mode_kw(mode))


def tune_worlds():
    """(label, options(mode) → RuntimeOptions, declare(rt), seed(rt),
    finish(rt) → numbers) of the tune phase's worlds."""
    import numpy as np
    from ponyc_tpu_torch import RuntimeOptions
    from ponyc_tpu_torch.models import gups, spawn_tree, ubench
    _tb, TB = blob_programs()
    n_ub, pings = UBENCH[0], UBENCH[1]

    def ub_seed(rt):
        ids = rt.spawn_many(ubench.Pinger, n_ub)
        order = np.random.default_rng(0).permutation(n_ub)
        nxt = np.empty(n_ub, np.int64)
        nxt[order] = ids[np.roll(order, -1)]
        rt.set_fields(ubench.Pinger, ids, next_ref=nxt)
        ubench.seed_all(rt, ids, hops=1 << 30, pings=pings)

    def tree_seed(rt):
        root = rt.spawn(spawn_tree.Node)
        rt.send(root, spawn_tree.Node.grow, TUNE_SPAWN_DEPTH, -1)

    blob = blob_plan(*TUNE_BLOB[:2], max_len=TUNE_BLOB[2])

    def blob_seed(rt):
        nxt, starts, lens, words, _acc = blob
        ids = rt.spawn_many(TB.BlobWalker, len(nxt), acc=0)
        rt.set_fields(TB.BlobWalker, ids, nxt=ids[nxt])
        hs = np.array([rt.blob_store([int(w)]) for w in words], np.int32)
        rt.bulk_send(ids[starts], TB.BlobWalker.step, lens.astype(np.int32),
                     hs)

    def done(types, steps):
        def finish(rt):
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            code = rt.run(max_steps=steps)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            return dict(code=code, run_s=run_s,
                        **{t.__name__: world_numbers(rt, t) for t in types})
        return finish

    return [
        (f"ubench 2^20 x {pings}",
         lambda m: ubench_opts(m, TUNE_TICKS),
         lambda rt: rt.declare(ubench.Pinger, n_ub), ub_seed,
         done([ubench.Pinger], TUNE_TICKS)),
        ("gups 2^22 cells, 2^20 updaters",
         lambda m: RuntimeOptions(**gups_kw(m)), gups_declare, gups_seed,
         done([gups.TableCell, gups.Updater], GUPS[2] * 4 + 200)),
        (f"spawn tree depth {TUNE_SPAWN_DEPTH}",
         lambda m: spawn_opts(m),
         lambda rt: rt.declare(spawn_tree.Node, 4 << TUNE_SPAWN_DEPTH),
         tree_seed, done([spawn_tree.Node], 10_000)),
        ("blob chain 2^17 walkers, 2^11 chains",
         lambda m: RuntimeOptions(tuning_cache="off", **blob_kw(m)),
         lambda rt: rt.declare(TB.BlobWalker, TUNE_BLOB[0]), blob_seed,
         done([TB.BlobWalker], 256)),
    ]


@phase("tune")
def run_tune(rec, frec, mrec):
    """delivery="auto", pallas_fused="auto" on each tune world (see the
    module docstring)."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from ponyc_tpu_torch import Runtime, tuning
    card = _CACHE["card"]
    out = {}
    for label, options, declare, seed, finish in tune_worlds():
        cdir = tempfile.mkdtemp(prefix="pony_tune_")
        try:
            auto = dataclasses.replace(options("auto"), tuning_cache=cdir)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            rt = Runtime(auto)
            declare(rt)
            rt.start()
            torch.cuda.synchronize()
            start_s = time.perf_counter() - t0
            calib = launches()
            rec_ = rt.tuning_record
            table, detail = rec_["table"], rec_["detail"]
            if rec_["source"] != "calibrated" or \
                    set(table) != set(rec_["variants"]) or \
                    any(not isinstance(table[v], float)
                        for v in rec_["variants"]) or detail["errors"]:
                raise AssertionError(f"tune {label}: {rec_}")
            if rec_["winner"] != tuning.decide(table,
                                               order=rec_["variants"]):
                raise AssertionError(f"tune {label}: winner "
                                     f"{rec_['winner']} is not decide's")
            st = rt.state
            untouched = (not bool(st.alive.any())
                         and not bool(st.tail.any())
                         and not bool(st.head.any())
                         and not bool(st.dspill_count.any())
                         and rt.counter("n_processed") == 0
                         and rt.counter("n_delivered") == 0
                         and not any(bool(b.any())
                                     for b in st.buf.values()))
            if not untouched:
                raise AssertionError(f"tune {label}: calibration wrote the "
                                     "runtime's state")
            # A second runtime on the same layout: the cached winner,
            # with no kernel launched during its start.
            rt2, cached_s = _cached_start(auto, declare, rt, label)
            del rt2
            # Each run lasts tens of ms of wall time, so one stall of the
            # host doubles it: every formulation is timed twice, in the
            # order fixed, auto, auto, fixed (the second auto run is a
            # start from the cache), and each keeps the lower tick. The
            # caching allocator is emptied only after the world: a run
            # on an emptied allocator times its windows' cudaMallocs
            # (up to 0.4 s for GUPS). The auto runs' launches are the
            # winner's kernels'; every run's numbers equal the others'.
            mode = _chosen_mode(rec_["chosen"])
            fixed = dataclasses.replace(options(False), **rec_["chosen"])
            mega_opts = options("mega") if mode != "mega" else None

            def fixed_runs():
                runs = [tune_run(_started(Runtime(fixed), declare), seed,
                                 finish, mode, label)]
                if mega_opts is not None and "pallas_mega" in \
                        rec_["variants"]:
                    runs.append(tune_run(_started(Runtime(mega_opts),
                                                  declare),
                                         seed, finish, "mega", label))
                return runs

            first = fixed_runs()
            got_auto, auto_ms, got = tune_run(rt, seed, finish, mode,
                                              label)
            del rt
            rt3, _s = _cached_start(auto, declare, None, label)
            got_auto2, auto_ms2, _l = tune_run(rt3, seed, finish, mode,
                                               label)
            del rt3
            last = fixed_runs()
            for g in [got_auto2] + [r[0] for r in first + last]:
                if not same_numbers(got_auto, g):
                    raise AssertionError(f"tune {label}: the auto run "
                                         f"differs from the run fixed to "
                                         f"{rec_['winner']} or from "
                                         f"pallas_mega's")
            auto_runs = [auto_ms, auto_ms2]
            fixed_runs_ms = [first[0][1], last[0][1]]
            mega_runs = (fixed_runs_ms if mode == "mega"
                         else [r[1] for r in first[1:] + last[1:]])
            # The winner's tick is not far above the window kernel's.
            mega_ms = min(mega_runs) if mega_runs else None
            if mega_ms is not None and min(auto_runs) > TUNE_SLACK * mega_ms:
                raise AssertionError(
                    f"tune {label}: the winner {rec_['winner']} runs "
                    f"{min(auto_runs):.4f} ms a tick (runs "
                    f"{_ms_list(auto_runs)}), pallas_mega {mega_ms:.4f} "
                    f"(runs {_ms_list(mega_runs)})")
        finally:
            shutil.rmtree(cdir, ignore_errors=True)
            torch.cuda.empty_cache()
        code = got_auto.pop("code")
        nums = next(iter(got_auto.values()))
        out[label] = dict(table=table, compile_s=detail["compile_s"],
                          winner=rec_["winner"], chosen=rec_["chosen"],
                          ticks_per_window=detail["ticks_per_window"],
                          repeats=detail["repeats"], start_s=start_s,
                          cached_start_s=cached_s,
                          calibration_launches=calib, launches=got,
                          ms_per_tick=min(auto_runs),
                          fixed_ms_per_tick=min(fixed_runs_ms),
                          mega_ms_per_tick=mega_ms,
                          auto_ms_runs=auto_runs,
                          fixed_ms_runs=fixed_runs_ms,
                          mega_ms_runs=mega_runs, ticks=nums["steps"])
        cells = ", ".join(f"{v} {table[v]:.4f}" for v in rec_["variants"])
        comp = ", ".join(f"{v} {t:.2f}" for v, t in
                         detail["compile_s"].items())
        print(f"tune {label} [{card}]: ms a tick ({detail['ticks_per_window']}"
              f"-tick forced windows, median of {detail['repeats']}): "
              f"{cells}; compile_s (build + first window): {comp}; winner "
              f"{rec_['winner']} (decide's); source calibrated, start "
              f"{start_s:.2f} s, launches during it (drain, fused, window) "
              f"{calib}; state untouched; second start: source cache in "
              f"{cached_s:.2f} s, no launch; auto run = run fixed to the "
              f"winner ({nums['steps']} ticks, exit code {code}), "
              f"{min(auto_runs):.4f} ms a tick, the lower of "
              f"{_ms_list(auto_runs)} (calibrated, cached; fixed "
              f"{_ms_list(fixed_runs_ms)}, pallas_mega "
              f"{'-' if mega_ms is None else _ms_list(mega_runs)}), launches "
              f"(drain, fused, window) {got}", flush=True)
        for i, r in enumerate((rec, frec, mrec)):
            r.setdefault("launches_tune", {})[label] = got[i]
            r.setdefault("launches_tune_calibration", {})[label] = calib[i]
    return out


def _ms_list(ms):
    return "[" + ", ".join(f"{t:.4f}" for t in ms) + "]"


def _cached_start(auto, declare, rt, label):
    """A runtime started with `auto`'s options after a calibrated
    start: the winner read from the cache, no kernel launched during
    the start, the same options as `rt`'s (when given). Returns (the
    started runtime, seconds of its start)."""
    import torch
    from ponyc_tpu_torch import Runtime
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rt2 = Runtime(auto)
    declare(rt2)
    rt2.start()
    torch.cuda.synchronize()
    start_s = time.perf_counter() - t0
    got = launches()
    if rt2.tuning_record["source"] != "cache" or got != (0, 0, 0) or (
            rt is not None
            and (rt2.opts.delivery != rt.opts.delivery
                 or rt2.opts.pallas_fused != rt.opts.pallas_fused)):
        raise AssertionError(f"tune {label}: the second start read "
                             f"{rt2.tuning_record['source']}, "
                             f"launched {got}")
    return rt2, start_s


def _chosen_mode(chosen):
    """The smoke's path name (False, True or "mega") of a tuner's
    chosen options."""
    if chosen["delivery"] == "pallas_mega":
        return "mega"
    return bool(chosen["pallas_fused"])


def _started(rt, declare):
    declare(rt)
    rt.start()
    return rt


def tune_run(rt, seed, finish, mode, label):
    """Seed and finish a started runtime of the tune phase, its launch
    counts reset just before the run and held against what `mode`
    launches. Returns (numbers, ms a tick of the run, launches)."""
    import torch
    seed(rt)
    windows = count_windows(rt)
    q0 = rt.ticks_enqueued
    torch.cuda.synchronize()
    reset_launches()                    # the main path's run starts here
    got_nums = finish(rt)
    got = launches()                    # ... and ends here
    elapsed = got_nums.pop("run_s")     # the run, not the read-back
    enqueued = rt.ticks_enqueued - q0
    want = expected_launches(mode, enqueued, windows[0],
                             cohorts=len(rt.program.device_cohorts))
    if got != want or rt.steps_run > enqueued:
        raise AssertionError(f"tune {label} {_mode_name(mode)}: launches "
                             f"(drain, fused, window) {got} for {enqueued} "
                             f"ticks enqueued, {windows[0]} windows "
                             f"(expected {want})")
    return got_nums, 1e3 * elapsed / max(1, rt.steps_run), got


@phase("gups")
def run_gups(rec, frec, mrec):
    """GUPS at 2^22 cells and 2^20 updaters x 16 updates on each path:
    the xor of the table equals the oracle, fields, counters and ticks
    equal across the paths, updates a second."""
    import numpy as np
    import torch
    from ponyc_tpu_torch import Runtime, RuntimeOptions
    from ponyc_tpu_torch.models import gups
    card = _CACHE["card"]
    cells, n_upd, each = GUPS
    want = gups_oracle()
    res, out = {}, {}
    for mode in (False, True, "mega"):
        t0 = time.perf_counter()
        rt = Runtime(RuntimeOptions(**gups_kw(mode)))
        gups_declare(rt)
        rt.start()
        gups_seed(rt)
        windows = count_windows(rt)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        q0 = rt.ticks_enqueued
        reset_launches()                # the main path's run starts here
        t0 = time.perf_counter()
        code = rt.run(max_steps=each * 4 + 200)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = launches()                # ... and ends here
        enqueued = rt.ticks_enqueued - q0
        table = rt.cohort_state(gups.TableCell)["value"]
        xor = int(np.bitwise_xor.reduce(table.astype(np.int32)))
        done = rt.cohort_state(gups.Updater)["done"]
        if code != 0 or xor != want or not (done == each).all():
            raise AssertionError(f"gups {_mode_name(mode)}: exit code {code},"
                                 f" xor {xor} (oracle {want}), done "
                                 f"{np.unique(done)}")
        want_l = expected_launches(mode, enqueued, windows[0], cohorts=2)
        if got != want_l or rt.steps_run > enqueued:
            raise AssertionError(f"gups {_mode_name(mode)}: launches (drain, "
                                 f"fused, window) {got} for {enqueued} ticks "
                                 f"enqueued, {windows[0]} windows (expected "
                                 f"{want_l})")
        res[mode] = {t.__name__: world_numbers(rt, t)
                     for t in (gups.TableCell, gups.Updater)}
        ups = n_upd * each / elapsed
        {False: rec, True: frec, "mega": mrec}[mode]["launches_gups"] = \
            max(got)
        out[_mode_name(mode)] = dict(
            seconds=elapsed, setup_s=setup, ticks=rt.steps_run,
            enqueued=enqueued, windows=windows[0], updates_per_s=ups,
            ms_per_tick=1e3 * elapsed / rt.steps_run, launches=got,
            **{c: rt.counter(c) for c in ("n_processed", "n_delivered",
                                          "n_rejected", "n_mutes")})
        print(f"gups {cells} cells, {n_upd} updaters x {each} "
              f"{_mode_name(mode)} [{card}]: xor {xor} = the oracle's, every "
              f"updater done; {rt.steps_run} ticks in {elapsed:.3f} s = "
              f"{1e3 * elapsed / rt.steps_run:.3f} ms/tick, {ups:.4g} "
              f"updates/s ({ups / 1e9:.4f} GUPS); setup {setup:.1f} s, "
              f"{windows[0]} windows; launches (drain, fused, window) {got};"
              f" counters {out[_mode_name(mode)]}", flush=True)
        del rt
        torch.cuda.empty_cache()
    for mode in (True, "mega"):
        if not same_numbers(res[mode], res[False]):
            raise AssertionError(f"gups: {_mode_name(mode)} differs from the "
                                 "plain tick")
    print("gups: the table, the updaters' fields, counters and ticks equal "
          "across the three paths", flush=True)
    return out


@phase("fanin")
def run_fanin(rec, frec, mrec):
    """Fan-in: FANIN_BIG producers x items into one aggregator under the
    window kernel (the radix sort taken unforced), then FANIN_SMALL on
    each path."""
    import torch
    from ponyc_tpu_torch import RuntimeOptions
    from ponyc_tpu_torch.models import fanin
    from ponyc_tpu_torch.ops.megakernel import tick_sort
    card = _CACHE["card"]
    out = {}
    n, items = FANIN_BIG
    rt = fanin.build(n, items, RuntimeOptions(**fanin_kw("mega", n, items)))
    mw = rt._multi_g
    windows = count_windows(rt)
    torch.cuda.synchronize()
    reset_launches()                    # the main path's run starts here
    t0 = time.perf_counter()
    sorts = []
    for _ in range(FANIN_PROBED):       # one tick a window: each tick's sort
        rt.run(max_steps=1)
        sorts.append(tick_sort(mw.world, rt.state.plan_key))
    code = rt.run(max_steps=n * items * 4 + 100)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    got = launches()                    # ... and ends here
    total = int(rt.cohort_state(fanin.Aggregator)["total"].sum())
    radix = sorts.count("radix")
    if code != 0 or total != n * items or not rt.counter("n_mutes") or \
            not rt.counter("n_rejected") or not radix or \
            got != (0, 0, windows[0]):
        raise AssertionError(f"fanin {n} x {items}: exit code {code}, total "
                             f"{total} (want {n * items}), mutes "
                             f"{rt.counter('n_mutes')}, rejected "
                             f"{rt.counter('n_rejected')}, sorts {sorts}, "
                             f"launches {got}, windows {windows[0]}")
    mrec["launches_fanin"] = got[2]
    out[f"{n} x {items} pallas_mega"] = dict(
        seconds=elapsed, ticks=rt.steps_run, windows=windows[0],
        radix_ticks_probed=radix, probed=FANIN_PROBED,
        us_per_tick=1e6 * elapsed / rt.steps_run, launches=got,
        **{c: rt.counter(c) for c in ("n_processed", "n_rejected",
                                      "n_mutes")})
    out[f"{n} x {items} pallas_mega"]["us_per_rejected"] = \
        1e6 * elapsed / rt.counter("n_rejected")
    print(f"fanin {n} producers x {items} pallas_mega [{card}]: total "
          f"{total} = n*items, {rt.counter('n_mutes')} mutes, "
          f"{rt.counter('n_rejected')} rejected "
          f"({1e6 * elapsed / rt.counter('n_rejected'):.4f} us of wall a "
          f"rejection); of the first "
          f"{FANIN_PROBED} ticks {radix} took the radix sort unforced "
          f"({sorts[:4]}...); {rt.steps_run} ticks in {elapsed:.3f} s = "
          f"{1e6 * elapsed / rt.steps_run:.1f} us/tick, {windows[0]} windows;"
          f" launches (drain, fused, window) {got}", flush=True)
    del rt, mw
    torch.cuda.empty_cache()
    n, items = FANIN_SMALL
    res = {}
    for mode in (False, True, "mega"):
        rt = fanin.build(n, items,
                         RuntimeOptions(**fanin_kw(mode, n, items)))
        windows = count_windows(rt)
        code, elapsed, got = tel_run(f"fanin {n} x {items}", mode, rt,
                                     windows, lambda: rt.run(
                                         max_steps=n * items * 4 + 100),
                                     cohorts=2)
        total = int(rt.cohort_state(fanin.Aggregator)["total"].sum())
        if code != 0 or total != n * items or not rt.counter("n_mutes"):
            raise AssertionError(f"fanin {n} x {items} {_mode_name(mode)}: "
                                 f"exit code {code}, total {total}")
        res[mode] = {t.__name__: world_numbers(rt, t)
                     for t in (fanin.Producer, fanin.Aggregator)}
        out[f"{n} x {items} {_mode_name(mode)}"] = dict(
            seconds=elapsed, ticks=rt.steps_run, windows=windows[0],
            ms_per_tick=1e3 * elapsed / rt.steps_run, launches=got)
        print(f"fanin {n} producers x {items} {_mode_name(mode)} [{card}]: "
              f"total {total}; {rt.steps_run} ticks in {elapsed:.3f} s = "
              f"{1e3 * elapsed / rt.steps_run:.3f} ms/tick, {windows[0]} "
              f"windows; launches (drain, fused, window) {got}", flush=True)
        del rt
    for mode in (True, "mega"):
        if not same_numbers(res[mode], res[False]):
            raise AssertionError(f"fanin {n} x {items}: {_mode_name(mode)} "
                                 "differs from the plain tick")
    print(f"fanin {n} x {items}: fields, counters and ticks equal across the "
          "three paths", flush=True)
    return out


MANDEL_N = 8192           # 8,192^2 pixels, 2^23 Workers of 8 pixels (the
#   reference's layout). The Benchmarks Game's N, 16,000^2 (32,000,000
#   Workers), runs on every path (PERF.md §6) but its phase takes 86 s,
#   more than the script's time limit leaves beside the other phases
MANDEL_BAND = 256         # rows held against the NumPy oracles, spread
#   evenly over the image (the whole image at 64 rounds is too slow for
#   NumPy)
MANDEL_WINDOW = 4         # ticks a window of kernel 3's timed window
SERVE_WORKERS = 1 << 14   # the serve world's device worker pool (2^16
#   until the stdlib phase needed the time: each path's run answers every
#   request of the overload, at the host's 120-220 us a frame)
SERVE_CALIB = (2, 2, 30)  # calibration: conns, depth, requests a conn
SERVE_LOAD = (64, 512, 3.0, 0.005, 1000)   # overload: conns, depth
#   (64 x 512 = 32,768 outstanding, 2x the pool), seconds, busy
#   backoff, deadline ms. The server submits at most the window
#   controller's window a boundary (4 under host traffic: about 100
#   requests a second on the plain path at this pool), so without a
#   deadline the 65,536 it admits would take minutes to answer; with one
#   it sheds what it cannot serve in time (BUSY at admission from its
#   measured rate, DEADLINE at expiry)
SERVE_TAIL_S = 120.0      # the overload client's wait for the replies it
#   is owed when its sending ends (every request must be accounted for)
SERVE_CHILD_WORKERS = 64  # `python -m ponyc_tpu_torch serve --workers`
# The two load stages run in processes of their own, driven from a
# thread: loadgen's 64 client threads in the server's interpreter held
# its lock from the run loop (66 s a path for 131,072 frames, where the
# server's own work is seconds), and in one process of their own they
# paced a slow host's run (1,616 frames offered a second against 4,868
# on a faster one). SERVE_PROCS processes share the overload's
# connections; they serve the three paths, started with the phase so
# that their imports overlap the first world's set-up. Each reads
# "calib PORT" or "load PORT" a line and answers with its connections'
# counts, OK latencies and clock as one JSON line (serve_load merges
# them as loadgen.run_load aggregates its connections).
SERVE_PROCS = 4
SERVE_CLIENT = """
import json, sys, threading, time
from ponyc_tpu_torch import loadgen
(c, d, r), (lc, ld, secs, backoff, ddl), tail, procs = json.loads(sys.argv[1])
KEYS = ("sent", "ok", "busy", "deadline", "badframe", "other", "bad_value",
        "unanswered", "reconnects", "killed", "malformed_sent")
for line in sys.stdin:
    stage, port = line.split()
    if stage == "calib":
        conns, kw = c, dict(requests=r, depth=d, deadline_ms=0,
                            duration_s=None, busy_backoff_s=0.0, tail_s=None)
    else:
        conns, kw = lc // procs, dict(requests=1 << 30, depth=ld,
                                      deadline_ms=ddl, duration_s=secs,
                                      busy_backoff_s=backoff, tail_s=tail)
    stats = [loadgen._ConnStats() for _ in range(conns)]
    stop = threading.Event()
    threads = [threading.Thread(target=loadgen._drive_conn, args=(
        "127.0.0.1", int(port), st), kwargs=dict(
        payload_of=lambda x: [x], value_of=loadgen.default_value,
        churn_every=None, burst=None, burst_pause_s=0.05, slow_read_s=0.0,
        malform_every=None, kill_after=None, retry_busy=False,
        stop_on_busy=False, stop=stop, timeout_s=60.0, **kw), daemon=True)
        for st in stats]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {k: sum(getattr(st, k) for st in stats) for k in KEYS}
    out.update(t0=t0, t1=time.monotonic(),
               lat_us=[u for st in stats for u in st.lat_us])
    print(json.dumps(out), flush=True)
"""


def mandel_groups(n=MANDEL_N):
    return (n // 8) * n


def mandel_opts(mode):
    import dataclasses
    from ponyc_tpu_torch.models import mandelbrot
    return dataclasses.replace(mandelbrot.default_options(),
                               tuning_cache="off", **_mode_kw(mode))


def serve_opts(mode):
    from ponyc_tpu_torch import serve
    return serve.default_options(SERVE_WORKERS, tuning_cache="off",
                                 **_mode_kw(mode))


def window_events(mw):
    """Record a CUDA event pair around every launch of the window kernel
    `mw` dispatches (a list of (start, end)); the caller sums their
    elapsed times once the run has ended."""
    import torch
    pairs = []
    orig = mw._dispatch

    def timed(*a, **k):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = orig(*a, **k)
        t1.record()
        pairs.append((t0, t1))
        return out
    mw._dispatch = timed
    return pairs


@phase("mandelbrot")
def run_mandelbrot(rec, frec, mrec):
    """The mandelbrot model at MANDEL_N^2 pixels on each path: one
    message a Worker, run to quiescence; the byte image equal across the
    paths, a spread band of MANDEL_BAND rows equal to the float32 NumPy
    replay of the body (`f32_bytes`) and compared with the reference's
    oracle (`reference_bytes`, which mixes in complex128); ms a tick,
    launches; kernel 3 held against the plain window on the seeded world
    and timed against its bound."""
    import numpy as np
    import torch
    from ponyc_tpu_torch.models import mandelbrot
    from ponyc_tpu_torch.ops import megakernel
    from ponyc_tpu_torch.runtime import engine
    card = _CACHE["card"]
    n = MANDEL_N
    groups = mandel_groups(n)
    recs = {False: rec, True: frec, "mega": mrec}
    rows = np.unique(np.linspace(0, n - 1, MANDEL_BAND).round()
                     .astype(np.int64))
    t0 = time.perf_counter()
    want32 = mandelbrot.f32_bytes(n, n, rows)
    want = mandelbrot.reference_bytes(n, n, rows)
    oracle_s = time.perf_counter() - t0
    mixed = int((want32 != want).sum())
    print(f"mandelbrot {n}x{n}: oracles for {len(rows)} rows in "
          f"{oracle_s:.1f} s; the float32 replay and the reference's "
          f"oracle differ in {mixed} of {want.size} bytes", flush=True)
    t0 = time.perf_counter()
    cr, ci = mandelbrot.coordinates(n, n)
    print(f"mandelbrot: coordinates of {groups} groups in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    images, out = {}, {}
    for mode in (False, True, "mega"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rt, ids = mandelbrot.build(n, n, mandel_opts(mode))
        rt.bulk_send(ids, mandelbrot.Worker.compute, cr, ci)
        windows = count_windows(rt)
        st0 = rt.state if mode == "mega" else None   # kernel 3's input
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        q0 = rt.ticks_enqueued
        reset_launches()                # the main path's run starts here
        t0 = time.perf_counter()
        code = rt.run(max_steps=200)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = launches()                # ... and ends here
        enqueued = rt.ticks_enqueued - q0
        cs = rt.cohort_state(mandelbrot.Worker)
        img = cs["byte"].astype(np.uint8).reshape(n, n // 8)
        done = int(cs["done"].sum())
        bad32 = int((img[rows] != want32).sum())
        badref = int((img[rows] != want).sum())
        want_l = expected_launches(mode, enqueued, windows[0])
        if code != 0 or done != groups or bad32:
            raise AssertionError(
                f"mandelbrot {_mode_name(mode)}: exit {code}, {done} of "
                f"{groups} groups done, {bad32} band bytes differ from "
                "the float32 replay")
        if got != want_l:
            raise AssertionError(
                f"mandelbrot {_mode_name(mode)}: launches (drain, fused, "
                f"window) {got} for {enqueued} ticks enqueued, "
                f"{windows[0]} windows (expected {want_l})")
        recs[mode]["launches_mandelbrot"] = max(got)
        peak = torch.cuda.max_memory_allocated()
        ms_tick = 1e3 * elapsed / max(1, rt.steps_run)
        res = dict(seconds=elapsed, setup_s=setup, ticks=rt.steps_run,
                   enqueued=enqueued, windows=windows[0], launches=got,
                   ms_per_tick=ms_tick, peak_bytes=peak,
                   band_bytes_differing_from_reference_oracle=badref)
        print(f"mandelbrot {n}x{n} ({groups} Workers) {_mode_name(mode)} "
              f"[{card}]: {rt.steps_run} ticks ({enqueued} enqueued, "
              f"{windows[0]} windows) in {elapsed:.3f} s = {ms_tick:.3f} "
              f"ms a tick; setup {setup:.1f} s; peak {peak / 2**30:.2f} "
              f"GiB on the card; launches (drain, fused, window) {got}; "
              f"the band equals the float32 replay, {badref} of its "
              f"bytes differ from the reference's oracle", flush=True)
        if mode == "mega":
            mw = rt._multi_g
            zero = engine.zero_aux("cuda")
            e_it, e_iw = rt._empty_inject

            def kern():
                return mw(st0, e_it, e_iw, MANDEL_WINDOW, True, zero)
            kout = kern()
            pout = mw.plain(st0, e_it, e_iw, MANDEL_WINDOW, True, zero,
                            None)
            torch.cuda.synchronize()
            err, _, nout = compare_window(kout, pout, "mandelbrot window")
            ticks = int(pout[2])
            processed = (int(pout[0].n_processed[0])
                         - int(st0.n_processed[0]))
            live = (int(pout[0].plan_bounds[-1])
                    if pout[0].plan_bounds.numel() else 0)
            branch = megakernel.tick_sort(mw.world, pout[0].plan_key)
            del kout, pout
            torch.cuda.empty_cache()
            gpu_warm()
            k_ms = device_ms(kern, 10, [()], "pony_mega_kernel", warm=2)
            p_ms = device_ms(lambda: mw.plain(st0, e_it, e_iw,
                                              MANDEL_WINDOW, True, zero,
                                              None), 1, [()], warm=1)
            _b, _by, nbytes, _t_b, _t_o, _d = mega_bound(
                mw, ticks, processed, live, branch)
            # mega_bound counts every ring slot read and written a tick;
            # this run's data fills one slot a Worker and the bodies
            # send nothing, so count the message each Worker reads in
            # place of its ring.
            ring = 4 * sum(mw.world["CAP"] * (1 + sp["cohort"].msg_words)
                           * sp["cohort"].local_capacity for sp in mw.specs)
            w1_in = 1 + mw.specs[0]["cohort"].msg_words
            nbytes = nbytes - ticks * 2 * ring + processed * w1_in * 4
            t_b = nbytes / H100_BYTES_PER_S * 1e3
            ops = mandelbrot.ITERATIONS * 8 * 10 * processed
            t_o = ops / H100_F32_OPS_PER_S * 1e3
            bound = max(t_b, t_o)
            by = "bytes" if t_b >= t_o else "operations"
            # The peak counts a fused multiply-add as two operations; the
            # body is built with -fmad=false (its float results are the
            # oracle's), so each of its operations is an instruction of
            # its own, at most half that rate.
            t_i = ops / H100_F32_INSTR_PER_S * 1e3
            res.update(kernel_ms=k_ms, plain_window_ms=p_ms,
                       window_ticks=ticks, bound_ms=bound, bound_by=by,
                       bytes=nbytes, bytes_ms=t_b, ops=ops, ops_ms=t_o,
                       instr_ms=t_i, leaves_bit_equal=nout, max_abs_err=err)
            mrec["mandelbrot"] = res
            print(f"mandelbrot window kernel [{card}]: a window of "
                  f"{ticks} ticks ({processed} groups computed) {nout} "
                  f"leaves bit-equal to the plain window; kernel {k_ms:.3f}"
                  f" ms device, plain window {p_ms:.3f} ms; bound "
                  f"{bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB -> "
                  f"{t_b:.4f} ms at 3.35 TB/s; {ops:.4g} float32 ops "
                  f"(64 rounds x 8 pixels x 10) -> {t_o:.4f} ms at 67 "
                  f"TFLOP/s); kernel at {100 * bound / k_ms:.1f}% of the "
                  f"bound; without FMA (-fmad=false) the same ops are as "
                  f"many instructions, {t_i:.4f} ms at 33.5 T a second, "
                  f"{100 * max(t_b, t_i) / k_ms:.1f}% of that bound",
                  flush=True)
        images[mode] = img
        out[_mode_name(mode)] = res
        del rt, ids, st0, cs
        torch.cuda.empty_cache()
    for mode in (True, "mega"):
        if not np.array_equal(images[mode], images[False]):
            raise AssertionError(f"mandelbrot: {_mode_name(mode)}'s image "
                                 "differs from the plain tick's")
    print(f"mandelbrot: the {n}x{n} image is bit-equal across the three "
          f"paths ({int(np.unpackbits(images[False]).sum())} pixels in "
          "the set)", flush=True)
    out.update(rows=len(rows), oracles_differ=mixed)
    return out


@phase("serve")
def run_serve(rec, frec, mrec):
    """The serving front door on each path: serve.build at SERVE_WORKERS
    workers, a loadgen thread running calibration (SERVE_CALIB) then 2x
    overload with a deadline (SERVE_LOAD), then begin_drain; every OK
    reply 2x+1, every request answered (ok + busy + deadline + badframe
    = sent), no sticky capacity error, the drain complete, the device
    cohort's served count the server's submissions; p50/p99 of OK
    replies, goodput, shed rate, windows, launches (under pallas_mega the
    window kernel's device time a window). Then `python -m
    ponyc_tpu_torch serve` as a child, driven by the loadgen CLI and
    stopped by SIGTERM: exit 0, nothing lost."""
    import tempfile
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    # The serve verb as a process, started first so that its start-up
    # (torch, the CUDA context, its world) overlaps the in-process paths;
    # it waits for its clients until they are done. Its stderr goes to a
    # file, which nothing has to drain meanwhile.
    t_child = time.perf_counter()
    with tempfile.TemporaryFile("w+") as err, \
            tempfile.TemporaryFile("w+") as cerr:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ponyc_tpu_torch", "serve",
             "--workers", str(SERVE_CHILD_WORKERS)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=err, text=True)
        clients = [subprocess.Popen(
            [sys.executable, "-c", SERVE_CLIENT,
             json.dumps([SERVE_CALIB, SERVE_LOAD, SERVE_TAIL_S,
                         SERVE_PROCS])],
            cwd=ROOT, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=cerr, text=True)
            for _ in range(SERVE_PROCS)]
        try:
            out = serve_paths(rec, frec, mrec, clients, cerr)
            for c in clients:
                c.stdin.close()
                c.wait(timeout=60)
            out["child"] = serve_child(proc, env, err)
        finally:
            for p in [proc] + clients:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out["child"]["seconds"] = time.perf_counter() - t_child
    return out


def serve_stage(clients, cerr, stage, port):
    """Have the load processes `clients` (their stderr in `cerr`) run
    `stage` ("calib" on the first alone, "load" on all) against `port`;
    their merged stats, as loadgen.run_load reports them."""
    import select
    for c in clients:
        c.stdin.write(f"{stage} {port}\n")
        c.stdin.flush()
    parts = []
    for c in clients:
        ready, _w, _x = select.select([c.stdout], [], [], 600)
        line = c.stdout.readline() if ready else ""
        if not line.strip():
            cerr.seek(0)
            raise RuntimeError(f"load client (exit {c.poll()}): "
                               f"{cerr.read()[-2000:]}")
        parts.append(json.loads(line))
    out = {k: sum(p[k] for p in parts) for k in parts[0]
           if k not in ("t0", "t1", "lat_us")}
    elapsed = max(1e-9, max(p["t1"] for p in parts)
                  - min(p["t0"] for p in parts))
    lat = sorted(u for p in parts for u in p["lat_us"])

    def pct(q):
        return lat[min(len(lat) - 1, int(len(lat) * q))] if lat else 0
    out.update(elapsed_s=round(elapsed, 3),
               goodput_rps=round(out["ok"] / elapsed, 1),
               offered_rps=round(out["sent"] / elapsed, 1),
               shed_rate=round((out["busy"] + out["deadline"])
                               / max(1, out["sent"]), 4),
               p50_us=pct(0.50), p99_us=pct(0.99))
    return out


def serve_load(clients, cerr, port):
    """The calibration stage on one load process, then the overload on
    all of them."""
    return {"calib": serve_stage(clients[:1], cerr, "calib", port),
            "load": serve_stage(clients, cerr, "load", port)}


def serve_paths(rec, frec, mrec, clients, cerr):
    """The serve phase's in-process worlds, one a path, each driven by
    the load processes `clients`."""
    import threading
    import torch
    from ponyc_tpu_torch import serve
    card = _CACHE["card"]
    recs = {False: rec, True: frec, "mega": mrec}
    out = {}
    for mode in (False, True, "mega"):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rt, server = serve.build(SERVE_WORKERS, serve_opts(mode))
        port = server.listen("127.0.0.1", 0)
        windows = count_windows(rt)
        events = window_events(rt._multi_g) if mode == "mega" else None
        setup = time.perf_counter() - t0
        res = {}

        def drive():
            try:
                res.update(serve_load(clients, cerr, port))
            except Exception as e:                 # noqa: BLE001
                res["error"] = e
            finally:
                server.begin_drain()

        q0 = rt.ticks_enqueued
        th = threading.Thread(target=drive, daemon=True)
        reset_launches()                # the main path's run starts here
        t0 = time.perf_counter()
        th.start()
        code = rt.run()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = launches()                # ... and ends here
        th.join(timeout=120.0)
        enqueued = rt.ticks_enqueued - q0
        if th.is_alive():
            raise AssertionError(f"serve {_mode_name(mode)}: the client "
                                 "thread did not finish")
        if "error" in res:
            raise res["error"]
        calib, load = res["calib"], res["load"]
        st = server.stats()
        sticky = {f"{cls}:{c}": int(k) for (cls, c), k in
                  rt._error_counts.items()
                  if cls in ("SpillOverflowError", "SpawnCapacityError",
                             "BlobCapacityError")}
        served = int(rt.cohort_state(serve.ServeWorker)["served"].sum())
        answered = (load["ok"] + load["busy"] + load["deadline"]
                    + load["badframe"])
        problems = []
        if code != 0:
            problems.append(f"exit code {code}")
        if calib["ok"] != calib["sent"] or calib["unanswered"]:
            problems.append(f"calibration {calib}")
        if load["bad_value"] or calib["bad_value"]:
            problems.append("an OK reply is not 2x+1")
        if answered != load["sent"] or load["unanswered"]:
            problems.append(f"overload: {load['sent']} sent, {answered} "
                            f"answered, {load['unanswered']} unanswered")
        if sticky:
            problems.append(f"sticky capacity errors {sticky}")
        if not st["drained"]:
            problems.append("the drain did not complete")
        if served != st["submitted"]:
            problems.append(f"workers served {served}, the server "
                            f"submitted {st['submitted']}")
        want_l = expected_launches(mode, enqueued, windows[0])
        if got != want_l:
            problems.append(f"launches (drain, fused, window) {got} for "
                            f"{enqueued} ticks enqueued, {windows[0]} "
                            f"windows (expected {want_l})")
        if problems:
            raise AssertionError(f"serve {_mode_name(mode)}: "
                                 + "; ".join(problems))
        recs[mode]["launches_serve"] = max(got)
        loop = rt.run_loop_stats()
        dev = None
        if events:
            dev = sum(a.elapsed_time(b) for a, b in events)
        r = dict(seconds=elapsed, setup_s=setup, ticks=rt.steps_run,
                 enqueued=enqueued, windows=windows[0], launches=got,
                 calib_goodput_rps=calib["goodput_rps"],
                 calib_p50_us=calib["p50_us"], calib_p99_us=calib["p99_us"],
                 sent=load["sent"], ok=load["ok"], busy=load["busy"],
                 deadline=load["deadline"], p50_us=load["p50_us"],
                 p99_us=load["p99_us"], goodput_rps=load["goodput_rps"],
                 offered_rps=load["offered_rps"],
                 shed_rate=load["shed_rate"], load_s=load["elapsed_s"],
                 submitted=st["submitted"], batches=st["batches"],
                 admission=st["admission"], shed=st["shed"],
                 reclaimed=st["reclaimed"], frames=st["frames"],
                 host_gap_s=loop["host_gap_us_total"] / 1e6,
                 window_kernel_ms=dev,
                 window_kernel_ms_a_window=(dev / max(1, windows[0])
                                            if dev is not None else None))
        out[_mode_name(mode)] = r
        extra = ("" if dev is None else
                 f"; window kernel {dev:.1f} ms device over "
                 f"{windows[0]} windows = {dev / max(1, windows[0]):.4f} "
                 "ms a window (CUDA events)")
        print(f"serve {SERVE_WORKERS} workers {_mode_name(mode)} [{card}]:"
              f" calibration {calib['ok']} OK, p50 {calib['p50_us']} us, "
              f"p99 {calib['p99_us']} us, {calib['goodput_rps']} rps; "
              f"overload {SERVE_LOAD[0]}x{SERVE_LOAD[1]} for "
              f"{SERVE_LOAD[2]} s, deadline {SERVE_LOAD[4]} ms: "
              f"{load['sent']} sent, {load['ok']} OK, "
              f"{load['busy']} BUSY, {load['deadline']} DEADLINE, 0 lost; "
              f"OK p50 {load['p50_us']} us, p99 {load['p99_us']} us; "
              f"goodput {load['goodput_rps']} rps of "
              f"{load['offered_rps']} offered, shed rate "
              f"{load['shed_rate']}; {st['submitted']} submitted in "
              f"{st['batches']} batches, {st['frames']} frames; run "
              f"{elapsed:.1f} s (the card idle for the host "
              f"{loop['host_gap_us_total'] / 1e6:.1f} s of it), "
              f"{rt.steps_run} ticks, {windows[0]} windows, launches "
              f"(drain, fused, window) {got}{extra}; drained", flush=True)
        rt.stop()
        del rt, server
        torch.cuda.empty_cache()
    return out


def serve_child(proc, env, errfile):
    """Drive the serve verb's process `proc` (its stderr in `errfile`)
    with the loadgen CLI, then SIGTERM it: exit 0, every request OK, the
    drain complete."""
    import select
    import signal
    t0 = time.perf_counter()
    ready, _w, _x = select.select([proc.stdout], [], [], 300)
    line = proc.stdout.readline() if ready else ""
    if not line.startswith("serving on"):
        proc.kill()
        proc.wait()
        errfile.seek(0)
        raise AssertionError(f"serve child: {line!r} "
                             f"{errfile.read()[-2000:]}")
    port = int(line.strip().rsplit(":", 1)[1].split()[0])
    lg = subprocess.run(
        [sys.executable, "-m", "ponyc_tpu_torch.loadgen", "127.0.0.1",
         str(port), "--conns", "4", "--depth", "8", "--requests", "100"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if lg.returncode != 0:
        raise AssertionError(f"loadgen CLI exit {lg.returncode}: "
                             f"{lg.stderr[-2000:]}")
    res = json.loads(lg.stdout.strip().splitlines()[-1])
    proc.send_signal(signal.SIGTERM)
    proc.communicate(timeout=120)
    errfile.seek(0)
    err = errfile.read()
    drained = [ln for ln in err.splitlines()
               if ln.startswith("serve: drained ")]
    stats = json.loads(drained[-1][len("serve: drained "):]) \
        if drained else {}
    if (proc.returncode != 0 or res["ok"] != res["sent"]
            or res["unanswered"] or res["bad_value"]
            or not stats.get("drained")
            or stats.get("replied") != res["ok"]):
        raise AssertionError(f"serve child: exit {proc.returncode}, "
                             f"loadgen {res}, drained {stats}, "
                             f"stderr {err[-2000:]}")
    print(f"serve child (python -m ponyc_tpu_torch serve --workers "
          f"{SERVE_CHILD_WORKERS}) [{_CACHE['card']}]: the loadgen CLI's "
          f"{res['sent']} requests all OK (p50 {res['p50_us']} us, p99 "
          f"{res['p99_us']} us, {res['goodput_rps']} rps); SIGTERM: exit "
          f"0, drained, {stats['replied']} replied; driven in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {k: res[k] for k in ("sent", "ok", "p50_us", "p99_us",
                                "goodput_rps")}


OPS_DIR = os.path.join(ROOT, "_chipwork", "smoke_ops")      # git-ignored
OPS_LIVE = (1 << 20, 4, 16, 448)  # pingers, pings, window, ticks: the live
#   world's run; 2^20 x 4 x 448 messages stay under 2^31, so the device's
#   int32 counters do not wrap
OPS_CUT = 32                      # ticks of the plain and fused live runs
OPS_WEDGE_S = 5.0                 # the wedged window's sleep on the card
#   (15 s until the stdlib phase needed the time; the watchdog trips at
#   OPS_DEADLINE_S, and the run waits the sleep out)
OPS_DEADLINE_S = 1.0              # the watchdog's deadline for (c), (d)


def ops_kw(mode, **kw):
    """The live world's options on a path (analysis 1, the watchdog at
    5 s, the exporter on an ephemeral port), `kw` on top."""
    return dict(analysis=1, watchdog_s=5.0, metrics_port=0,
                analysis_path=os.path.join(OPS_DIR, f"live-{_mode_name(mode)}"
                                           ".csv"), **kw)


def ops_bp_kw(mode):
    return dict(mailbox_cap=8, batch=2, msg_words=1, max_sends=2,
                spill_cap=128, inject_slots=8, quiesce_interval=1,
                **_mode_kw(mode))


def ops_bp_build_opts(mode):
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(tuning_cache="off", **ops_bp_kw(mode))


def ops_bp_build(mode, device="cuda"):
    """tests/test_stdlib_extra.py's backpressure world (define_ops'
    Producer and Sink), started, the producer's 64 items queued."""
    import ponyc_tpu_torch
    tp, _T = programs()
    O = tp.define_ops(ponyc_tpu_torch)
    rt = tp.new_runtime(ponyc_tpu_torch, ops_bp_kw(mode), device)
    rt.declare(O.Producer, 1).declare(O.Sink, 1).start()
    sink = rt.spawn(O.Sink)
    prod = rt.spawn(O.Producer, sink=sink)
    rt.send(prod, O.Producer.produce, 64)
    return rt, O, prod, sink


def _scrape(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5.0) as r:
        return r.read().decode()


def ops_live(mode, ticks):
    """(a) on one path: ubench 2^20 x 4 at analysis 1 with the watchdog
    and the exporter on, scraped by a thread while run() is live. Returns
    (launches, seconds a tick, the recorder's and the refresh's host µs,
    the number of live scrapes)."""
    import threading
    import torch
    from ponyc_tpu_torch import metrics
    from ponyc_tpu_torch.models import ubench
    from ponyc_tpu_torch.runtime import engine
    n, pings, window, _ = OPS_LIVE
    rt, ids = ubench.build(n, ubench_opts(mode, window, **ops_kw(mode)),
                           pings=pings)
    ubench.seed_all(rt, ids, hops=1 << 30, pings=pings)
    rt.run(max_steps=2 * window)                     # warm
    port = rt._metrics.port
    fr = rt._flight
    w0, p0, s0 = rt._rl_windows, rt.counter("n_processed"), rt.steps_run
    last = fr.windows[-1]["processed"]
    windows = count_windows(rt)
    got, done = [], threading.Event()

    def scraper():
        while not done.is_set():
            try:
                hz = json.loads(_scrape(port, "/healthz"))
                mx = metrics.parse_prometheus(_scrape(port, "/metrics"))
            except OSError:
                continue
            got.append((hz["status"], hz["phase"],
                        mx.get(("pony_tpu_processed_total", ()), 0)))
            time.sleep(0.002)

    th = threading.Thread(target=scraper, daemon=True)
    th.start()
    time.sleep(0.05)
    torch.cuda.synchronize()
    reset_launches()                    # the main path's run starts here
    t0 = time.perf_counter()
    rt.run(max_steps=ticks)
    elapsed = time.perf_counter() - t0
    launched = launches()               # ... and ends here
    done.set()
    th.join(timeout=10)
    if th.is_alive():
        raise AssertionError("ops: the scraper did not stop")
    prof = rt.profile()
    final = metrics.parse_prometheus(_scrape(port, "/metrics"))
    hz = json.loads(_scrape(port, "/healthz"))
    done_n = rt.counter("n_processed") - p0
    wins = rt._rl_windows - w0
    if done_n != n * pings * ticks or rt.steps_run - s0 != ticks:
        raise AssertionError(f"ops {_mode_name(mode)}: processed {done_n} "
                             f"in {rt.steps_run - s0} ticks, expected "
                             f"{n * pings * ticks} in {ticks}")
    for key in ("processed", "delivered", "rejected", "mutes"):
        if final[(f"pony_tpu_{key}_total", ())] != prof["totals"][key]:
            raise AssertionError(f"ops {_mode_name(mode)}: scraped {key} "
                                 f"{final[(f'pony_tpu_{key}_total', ())]}"
                                 f" != profile()'s {prof['totals'][key]}")
    if final[("pony_tpu_behaviour_runs_total",
              (("behaviour", "Pinger.ping"),))] \
            != prof["behaviours"]["Pinger.ping"]["runs"]:
        raise AssertionError("ops: scraped behaviour runs != profile()'s")
    if final[("pony_tpu_windows_total", ())] != rt._rl_windows:
        raise AssertionError("ops: scraped windows != run_loop_stats'")
    if hz["status"] != "ok":
        raise AssertionError(f"ops: /healthz says {hz}")
    live = [g for g in got if g[1] != "idle"]
    if not live or any(s != "ok" for s, _, _ in got) or \
            [v for _, _, v in got] != sorted(v for _, _, v in got):
        raise AssertionError(f"ops {_mode_name(mode)}: scrapes during the "
                             f"run: {len(live)} live of {len(got)}, "
                             f"statuses {set(s for s, _, _ in got)}")
    recs = list(fr.windows)
    if len(recs) != min(rt._rl_windows, fr.windows.maxlen):
        raise AssertionError(f"ops: the recorder holds {len(recs)} windows "
                             f"of {rt._rl_windows}")
    mine = recs[-wins:] if wins <= len(recs) else None
    if mine is not None:
        deltas = sum((b["processed"] - a) & 0xFFFFFFFF for a, b in zip(
            [last] + [w["processed"] for w in mine[:-1]], mine))
        if deltas != done_n:
            raise AssertionError(f"ops: the recorder's processed deltas "
                                 f"add to {deltas}, the run to {done_n}")
    want = expected_launches(mode, ticks, windows[0])
    if mode == "mega" and launched != want or \
            mode != "mega" and (launched[2] or not max(launched)):
        raise AssertionError(f"ops {_mode_name(mode)}: launches (drain, "
                             f"fused, window) {launched}, {windows[0]} "
                             f"windows (expected {want})")
    # The host cost of the recorder's record and of a metrics refresh.
    a = engine.StepAux(*([0] * len(engine.StepAux._fields)))
    reps = 20000
    t0 = time.perf_counter()
    for _ in range(reps):
        fr.window(rt.steps_run, window, window, 0.0, True, a)
    rec_us = 1e6 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(20):
        rt._metrics.update_now(rt)
    ref_us = 1e6 * (time.perf_counter() - t0) / 20
    print(f"ops live ubench 2^20x4 {_mode_name(mode)} analysis=1 "
          f"watchdog 5 s + /metrics: {ticks} ticks in {wins} windows, "
          f"{1e3 * elapsed / ticks:.3f} ms/tick; processed {done_n} = "
          f"N*pings*ticks; scraped == profile(); {len(live)} of {len(got)} "
          f"scrapes while run() was live; recorder {len(recs)} windows, "
          f"deltas add up; /healthz ok; launches (drain, fused, window) "
          f"{launched}; host us: recorder window() {rec_us:.2f}, metrics "
          f"refresh {ref_us:.1f} (at most one a {metrics.REFRESH_S} s) "
          f"[{_CACHE['card']}]", flush=True)
    rt.stop()
    del rt
    torch.cuda.empty_cache()
    return max(launched), elapsed / ticks, rec_us, ref_us, len(live)


def sleep_cycles(seconds):
    """torch.cuda._sleep's argument for about `seconds` on this card, from
    its rate measured here."""
    import torch
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    t0.record()
    torch.cuda._sleep(100_000_000)
    t1.record()
    torch.cuda.synchronize()
    rate = 100_000_000 / (t0.elapsed_time(t1) / 1e3)
    return int(rate * seconds), rate


def stall_seconds(rt, raised_at):
    """Seconds from the watchdog's trip (its event in the recorder) to the
    PonyStallError reaching the caller."""
    fr = rt._flight
    trip = [e for e in fr.events if e["kind"] == "watchdog_trip"][-1]
    return raised_at - (fr.t0 + trip["t_ms"] / 1e3)


def doctor_says(path):
    """(exit code, first line) of `python -m ponyc_tpu_torch doctor
    --postmortem path`, run in this process."""
    import contextlib
    import io
    from ponyc_tpu_torch.__main__ import main as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli(["doctor", "--postmortem", path])
    return code, buf.getvalue().splitlines()[0]


@phase("ops")
def run_ops(rec, frec, mrec):
    """The flight recorder, the watchdog, /metrics and the host API on the
    card: (a) the live world on the three paths, (b) backpressure on the
    three paths, (c) a window wedged behind a sleeping kernel, (d) a host
    behaviour that sleeps, (e) SIGQUIT from host behaviours."""
    import shutil
    import signal
    import numpy as np
    import torch
    import ponyc_tpu_torch
    from ponyc_tpu_torch.errors import PonyStallError
    from ponyc_tpu_torch.models import ubench
    card = _CACHE["card"]
    recs = {False: rec, True: frec, "mega": mrec}
    shutil.rmtree(OPS_DIR, ignore_errors=True)
    os.makedirs(OPS_DIR)
    out = {}
    # (a) the live world: the window kernel at full length, the plain and
    # fused ticks at a cut.
    for mode, ticks in (("mega", OPS_LIVE[3]), (False, OPS_CUT),
                        (True, OPS_CUT)):
        got = ops_live(mode, ticks)
        recs[mode]["launches_ops"] = got[0]
        out[f"live {_mode_name(mode)}"] = {
            "s_per_tick": got[1], "recorder_us": got[2],
            "refresh_us": got[3], "live_scrapes": got[4]}
    # (b) backpressure mutes the sender and release recovers, each path.
    for mode in (False, True, "mega"):
        rt, O, prod, sink = ops_bp_build(mode)
        seen = []
        reset_launches()
        for action, steps in ((None, 4), ("apply", 3), ("release", 3)):
            if action == "apply":
                rt.apply_backpressure([sink])
            elif action == "release":
                rt.release_backpressure([sink])
            rt.run(max_steps=steps)
            seen.append((bool(rt.state.muted[prod]),
                         rt.queue_depth(sink) <= rt.opts.overload_occ))
        code = rt.run()
        launched = launches()
        total = rt.state_of(sink)["total"]
        cpu, _O, cprod, csink = ops_bp_build(mode, "cpu")
        cseen = []
        for action, steps in ((None, 4), ("apply", 3), ("release", 3)):
            if action == "apply":
                cpu.apply_backpressure([csink])
            elif action == "release":
                cpu.release_backpressure([csink])
            cpu.run(max_steps=steps)
            cseen.append((bool(cpu.state.muted[cprod]),
                          cpu.queue_depth(csink) <= cpu.opts.overload_occ))
        cpu.run()
        if seen != [(False, True), (True, True), (False, True)] or \
                code != 0 or total != 64 or seen != cseen or \
                rt.steps_run != cpu.steps_run or not max(launched):
            raise AssertionError(f"ops backpressure {_mode_name(mode)}: "
                                 f"muted/under-threshold {seen} (CPU "
                                 f"{cseen}), total {total}, code {code}, "
                                 f"ticks {rt.steps_run} (CPU "
                                 f"{cpu.steps_run}), launches {launched}")
        print(f"ops backpressure {_mode_name(mode)}: the sender mutes under "
              f"pressure with the sink's mailbox under the threshold and "
              f"releases after release_backpressure; total 64 in "
              f"{rt.steps_run} ticks, as on the CPU; launches (drain, "
              f"fused, window) {launched}", flush=True)
        rt.stop()
        cpu.stop()
    # (c) a window wedged behind a kernel that sleeps about OPS_WEDGE_S.
    n, pings, window, _ = OPS_LIVE
    cycles, rate = sleep_cycles(OPS_WEDGE_S)
    wedge_kw = {**ops_kw("mega"), "watchdog_s": OPS_DEADLINE_S,
                "metrics_port": None,
                "analysis_path": os.path.join(OPS_DIR, "wedge.csv")}
    rt, ids = ubench.build(n, ubench_opts("mega", window, **wedge_kw),
                           pings=pings)
    ubench.seed_all(rt, ids, hops=1 << 30, pings=pings)
    rt.run(max_steps=2 * window)                     # warm
    torch.cuda.synchronize()
    t_sleep = time.perf_counter()
    torch.cuda._sleep(cycles)
    try:
        rt.run(max_steps=window)
        raise AssertionError("ops: the wedged window did not raise")
    except PonyStallError as e:
        raised = time.time()
        t_raise = time.perf_counter() - t_sleep
        stall = (e.code, e.phase, e.postmortem)
    trip_to_raise = stall_seconds(rt, raised)
    code, line = doctor_says(stall[2])
    if stall[:2] != (7, "in-flight") or not os.path.exists(stall[2]) or \
            code != 1 or not line.startswith("STALLED") or \
            t_raise > OPS_WEDGE_S / 2:
        raise AssertionError(f"ops wedge: {stall}, raised after {t_raise:.2f}"
                             f" s of a {OPS_WEDGE_S} s sleep; doctor {code}: "
                             f"{line}")
    torch.cuda.synchronize()                         # wait out the sleep
    t_left = time.perf_counter() - t_sleep
    rt.stop()
    del rt
    torch.cuda.empty_cache()
    print(f"ops wedge: a {OPS_WEDGE_S} s sleep ({cycles} cycles at "
          f"{rate / 1e9:.3f} GHz) ahead of a window-kernel window, watchdog "
          f"{OPS_DEADLINE_S} s: PonyStallError code 7 in phase in-flight "
          f"{t_raise:.2f} s after the sleep was queued, {trip_to_raise:.3f} s"
          f" after the trip; postmortem on disk, doctor: {line[:60]}...; "
          f"the card was free again after {t_left:.1f} s [{card}]",
          flush=True)
    out["wedge"] = {"raise_s": t_raise, "trip_to_raise_s": trip_to_raise}
    # (d) a host behaviour that sleeps (tests/test_flight.py's world).
    @ponyc_tpu_torch.actor
    class Wedge:
        n: ponyc_tpu_torch.I32
        HOST = True

        @ponyc_tpu_torch.behaviour
        def jam(self, st, v: ponyc_tpu_torch.I32):
            time.sleep(600)            # the deliberate stall
            return st

    rt = ponyc_tpu_torch.Runtime(ponyc_tpu_torch.RuntimeOptions(
        mailbox_cap=8, batch=1, max_sends=1, msg_words=1, tuning_cache="off",
        watchdog_s=OPS_DEADLINE_S,
        analysis_path=os.path.join(OPS_DIR, "host.csv")))
    rt.declare(Wedge, 2).start()
    rt.send(rt.spawn(Wedge), Wedge.jam, 1)
    t0 = time.perf_counter()
    try:
        rt.run()
        raise AssertionError("ops: the sleeping host behaviour did not "
                             "raise")
    except PonyStallError as e:
        raised = time.time()
        t_raise = time.perf_counter() - t0
        stall = (e.code, e.phase, e.postmortem)
    trip_to_raise = stall_seconds(rt, raised)
    code, line = doctor_says(stall[2])
    if stall[:2] != (7, "host-work") or code != 1 or \
            "host behaviour" not in line or t_raise > 30:
        raise AssertionError(f"ops host stall: {stall} after {t_raise:.2f} "
                             f"s; doctor {code}: {line}")
    rt.stop()
    print(f"ops host stall: PonyStallError code 7 in phase host-work "
          f"{t_raise:.2f} s into the run, {trip_to_raise:.3f} s after the "
          f"trip; doctor: {line[:60]}... [{card}]", flush=True)
    out["host stall"] = {"raise_s": t_raise,
                         "trip_to_raise_s": trip_to_raise}
    # (e) SIGQUIT from host behaviours under the window kernel: the run
    # dumps and ends as an undisturbed one does.
    plan = hostlog_plan(*HOST_CHILD)
    runs = []
    for quit_ in (False, True):
        rt, log = hostlog_build("mega", plan, analysis_path=os.path.join(
            OPS_DIR, f"sigquit-{quit_}.csv"))
        if quit_:
            real = rt._dispatch_host_msg
            sent = [0]

            def quitting(*a, **k):
                if sent[0] < 3:
                    sent[0] += 1
                    os.kill(os.getpid(), signal.SIGQUIT)
                return real(*a, **k)
            rt._dispatch_host_msg = quitting
        reset_launches()
        code = rt.run()
        launched = launches()
        runs.append((host_numbers(rt, log),
                     {k: v.tolist() for k, v in
                      rt.cohort_state(programs()[1].WalkerH).items()},
                     rt._flight.dumps, launched))
        rt.stop()
    (num0, f0, d0, l0), (num1, f1, d1, l1) = runs
    if num0 != num1 or f0 != f1 or d0 != 0 or d1 != 3 or not l1[2]:
        raise AssertionError(f"ops SIGQUIT: dumps {d0}/{d1}, launches "
                             f"{l0}/{l1}, numbers equal {num0 == num1}, "
                             f"fields equal {f0 == f1}")
    print(f"ops SIGQUIT: 3 dumps from host behaviours under the window "
          f"kernel; fields, counters and ticks ({num1['steps']}) equal "
          f"the undisturbed run's; launches (drain, fused, window) {l1}",
          flush=True)
    shutil.rmtree(OPS_DIR, ignore_errors=True)
    return out


DURABLE_DIR = os.path.join(ROOT, "_chipwork", "smoke_durable")  # git-ignored
DURABLE_CADENCE = 0.05            # checkpoint_every_s of (a)
DURABLE_KEEP = 3                  # checkpoint_keep of (a)
DURABLE_TICKS = {"mega": 448, False: 16, True: 16}   # (a): ticks a
#   timed span: about one write of the writer (0.3-0.4 s) under
#   pallas_mega (64-tick windows); the plain and fused spans, cut to 32
#   ticks as the ops phase cuts them, halved again to 16 for the time
#   limit (their on-against-off results were unresolved at 32)
DURABLE_ORDER = (False, True, True, False, False, True, True, False)
#   (a): the timed spans, cadence off and on alternated ABBA, so that a
#   drift of the host's clock falls on both alike
DURABLE_WARM = {"mega": 2, False: 2, True: 2}   # (a): untimed spans
#   first, about 0.6 s on each path: the run's first captures, which
#   allocate their pinned buffers, are out of the timed spans
DURABLE_MORE = 32                 # ticks (b) runs after each restore
DURABLE_BLOB_POOL = ((3 << 18) - 1, (1 << 20) - 1)  # (c): the snapshot's
#   pool and the grown one. A handle addresses at most 2^20 - 1 slots
#   (ops/pack.py), so the grown pool is the largest there is; the
#   snapshot's must still hold a reservation for every walker beside the
#   live blobs (2^19 - 1 slots fail at the first tick)
DURABLE_GROW = 1.5                # (c): walker capacity x 1.5, spill x 2
DURABLE_CUT_TICKS = 64            # (c): ticks before the snapshot
DURABLE_QUEUED = 256              # (c): hostlog chains still queued as host
#   sends (Runtime.send) when the snapshot is taken
DURABLE_CHILD_CADENCE = 0.02      # (e), (f): the child's checkpoint cadence
DURABLE_WEDGE_S = 5.0             # (e): the sleep a window queues behind
#   (15 s until the mesh phase needed the time; the watchdog trips at
#   OPS_DEADLINE_S and the child's exit waits the sleep out)


def durable_blob_kw(mode, grown=False):
    kw = blob_kw(mode)
    kw["blob_slots"] = DURABLE_BLOB_POOL[int(grown)]
    if grown:
        kw["spill_cap"] *= 2
    return kw


def durable_hostlog_kw(mode, grown=False):
    kw = hostlog_kw(mode)
    if grown:
        kw["spill_cap"] *= 2
    return kw


def durable_cadence(mode, prefix):
    """(a) on one path: ubench 2^20 x 4 in two runtimes from the same
    seeds, one with the checkpoint cadence and one without, timed in
    spans that alternate between them (DURABLE_ORDER). Before each span
    without, the other's writer is waited for, so that no write falls in
    it. Returns (the cadence-off runtime, its numbers, the times a tick
    of each span by cadence, the checkpointer's stats, launches of the
    cadence-on spans)."""
    import torch
    from ponyc_tpu_torch import serialise
    from ponyc_tpu_torch.models import ubench
    n, pings, warm, window = UBENCH
    ticks = DURABLE_TICKS[mode]
    rts = {}
    for on in (False, True):
        kw = dict(analysis_path=os.path.join(DURABLE_DIR, "a.csv"))
        if on:
            kw.update(checkpoint_every_s=DURABLE_CADENCE,
                      checkpoint_keep=DURABLE_KEEP, checkpoint_path=prefix)
        rt, ids = ubench.build(n, ubench_opts(
            mode, window if mode == "mega" else ticks, **kw), pings=pings)
        ubench.seed_all(rt, ids, hops=1 << 30, pings=pings)
        rt.run(max_steps=warm)
        for _ in range(DURABLE_WARM[mode]):
            rt.run(max_steps=ticks)
        rts[on] = rt
    ck = rts[True]._ckpt
    per_tick = {False: [], True: []}
    launched = (0, 0, 0)
    timed = {"checkpoints": 0, "capture_ms_total": 0.0}
    for on in DURABLE_ORDER:
        rt = rts[on]
        if not on:
            ck.flush()
        s0 = ck.stats()
        # The run loop's total, not the state's int32 counter, which
        # wraps every 512 ticks of this world.
        p0 = rt.totals["processed"]
        torch.cuda.synchronize()
        reset_launches()                # the main path's run starts here
        t0 = time.perf_counter()
        rt.run(max_steps=ticks)
        elapsed = time.perf_counter() - t0
        got = launches()                # ... and ends here
        done_n = rt.totals["processed"] - p0
        if done_n != n * pings * ticks:
            raise AssertionError(f"durable {_mode_name(mode)}: processed "
                                 f"{done_n}, expected {n * pings * ticks}")
        per_tick[on].append(elapsed / ticks)
        if on:
            launched = tuple(max(a, b) for a, b in zip(launched, got))
            s1 = ck.stats()
            for k in timed:
                timed[k] += s1[k] - s0[k]
    base = world_numbers(rts[False], ubench.Pinger)
    numbers = world_numbers(rts[True], ubench.Pinger)
    rts[True].stop()                    # the final checkpoint, all written
    stats = ck.stats()
    stats["timed_captures"] = timed["checkpoints"]
    stats["timed_capture_ms"] = (timed["capture_ms_total"]
                                 / max(1, timed["checkpoints"]))
    files = serialise.list_checkpoints(prefix)
    for _seq, f in files:
        serialise.verify_snapshot(f)
    if not files or len(files) > DURABLE_KEEP or stats["failures"] \
            or not stats["checkpoints"] or not timed["checkpoints"]:
        raise AssertionError(f"durable {_mode_name(mode)}: ring "
                             f"{len(files)} files, stats {stats}")
    if not same_arrays(numbers["fields"], base["fields"]) or \
            numbers["counters"] != base["counters"] or \
            numbers["steps"] != base["steps"]:
        raise AssertionError(f"durable {_mode_name(mode)}: the "
                             "checkpointed run's fields, counters or "
                             "ticks differ from the run without")
    kern = {False: 0, True: 1, "mega": 2}[mode]
    if not launched[kern] or sum(launched) != launched[kern]:
        raise AssertionError(f"durable {_mode_name(mode)}: launches "
                             f"(drain, fused, window) {launched}")
    rts.pop(True)
    med = {on: statistics.median(v) for on, v in per_tick.items()}
    return rts[False], base, per_tick, med, stats, launched, len(files)


def durable_restore_paths(ref, prefix):
    """(b): the newest snapshot of (a)'s pallas_mega ring restored into a
    fresh runtime on each path and run DURABLE_MORE ticks, against the
    cadence-off runtime run as far."""
    import torch
    from ponyc_tpu_torch import serialise
    from ponyc_tpu_torch.models import ubench
    n, pings, _warm, _ = UBENCH
    newest = serialise.newest_intact(prefix)
    if newest is None:
        raise AssertionError("durable: no intact snapshot in the ring")
    ref.run(max_steps=DURABLE_MORE)
    want = world_numbers(ref, ubench.Pinger)
    want_plan = plan_state(ref)
    del ref
    torch.cuda.empty_cache()
    out = {}
    for mode in ("mega", False, True):
        rt, _ids = ubench.build(n, ubench_opts(mode, DURABLE_MORE),
                                pings=pings)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serialise.restore(rt, newest)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        reset_launches()
        rt.run(max_steps=DURABLE_MORE)
        got = launches()
        num = world_numbers(rt, ubench.Pinger)
        if not same_arrays(num["fields"], want["fields"]) or \
                num["counters"] != want["counters"] or \
                num["steps"] != want["steps"] or \
                not same_arrays(num["tel"], want["tel"]) or \
                plan_state(rt) != want_plan:
            raise AssertionError(f"durable restore into "
                                 f"{_mode_name(mode)}: the world differs "
                                 "from the uninterrupted run's")
        print(f"durable (b) {os.path.basename(newest)} restored into "
              f"{_mode_name(mode)} in {restore_s:.3f} s, {DURABLE_MORE} "
              f"more ticks: fields, counters, ticks ({num['steps']}) and "
              f"plan state equal the uninterrupted run's; launches "
              f"(drain, fused, window) {got} [{_CACHE['card']}]",
              flush=True)
        out[_mode_name(mode)] = restore_s
        del rt
        torch.cuda.empty_cache()
    return out


def durable_relayout():
    """(c): the blob chain and the hostlog world at full width,
    snapshotted mid-run under pallas_mega and restored into a grown
    geometry, run to the end against their oracles."""
    import numpy as np
    import torch
    import ponyc_tpu_torch
    from ponyc_tpu_torch import serialise
    out = {}
    tp, B = blob_programs()
    nxt, starts, lens, words, acc = plan = blob_plan()
    n = len(nxt)
    rt = tp.new_runtime(ponyc_tpu_torch, durable_blob_kw("mega"), "cuda")
    rt.declare(B.BlobWalker, n).start()
    ids = rt.spawn_many(B.BlobWalker, n, acc=0)
    rt.set_fields(B.BlobWalker, ids, nxt=ids[nxt])
    hs = np.array([rt.blob_store([int(w)]) for w in words], np.int32)
    rt.bulk_send(ids[starts], B.BlobWalker.step, lens.astype(np.int32), hs)
    rt.run(max_steps=DURABLE_CUT_TICKS)
    live = rt.blobs_in_use
    p = os.path.join(DURABLE_DIR, "blob.npz")
    t0 = time.perf_counter()
    serialise.save(rt, p)
    save_s = time.perf_counter() - t0
    del rt
    torch.cuda.empty_cache()
    grown = tp.new_runtime(ponyc_tpu_torch, durable_blob_kw("mega", True),
                           "cuda")
    grown.declare(B.BlobWalker, int(n * DURABLE_GROW)).start()
    t0 = time.perf_counter()
    serialise.restore(grown, p)
    restore_s = time.perf_counter() - t0
    reset_launches()
    code = grown.run(max_steps=100_000)
    got = launches()
    st = grown.cohort_state(B.BlobWalker)
    if code != 0 or not (st["acc"][:n].astype(np.int64) == acc).all() or \
            grown.blobs_in_use != 0 or grown.counter("n_blob_remote") or \
            not got[2] or not live:
        raise AssertionError(f"durable (c) blob chain: code {code}, acc "
                             f"ok {(st['acc'][:n] == acc).all()}, "
                             f"blobs_in_use {grown.blobs_in_use}, "
                             f"launches {got}, live at the cut {live}")
    print(f"durable (c) blob chain 2^19 x 2^14: snapshot at tick "
          f"{DURABLE_CUT_TICKS} ({live} live blobs) saved in {save_s:.2f} s "
          f"({os.path.getsize(p)} bytes, compressed), restored into walkers "
          f"x{DURABLE_GROW}, pool {DURABLE_BLOB_POOL[1]}, spill x2 in "
          f"{restore_s:.2f} s; acc = the NumPy oracle, blobs_in_use 0 "
          f"after {grown.steps_run} ticks; launches {got} "
          f"[{_CACHE['card']}]", flush=True)
    out["blob"] = {"save_s": save_s, "restore_s": restore_s,
                   "bytes": os.path.getsize(p)}
    del grown
    torch.cuda.empty_cache()
    os.remove(p)

    tp, T = programs()
    nxt, starts, lens, acc = hostlog_plan()
    n = len(nxt)
    q = DURABLE_QUEUED
    rt = tp.new_runtime(ponyc_tpu_torch, durable_hostlog_kw("mega"), "cuda")
    rt.declare(T.WalkerH, n).declare(T.HostLog, 1).start()
    ids = rt.spawn_many(T.WalkerH, n)
    log = rt.spawn(T.HostLog)
    rt.set_fields(T.WalkerH, ids, nxt=ids[nxt], log=np.full(n, log))
    rt.bulk_send(ids[starts[q:]], T.WalkerH.step, lens[q:].astype(np.int32))
    rt.run(max_steps=DURABLE_CUT_TICKS)
    for s, v in zip(starts[:q], lens[:q]):
        rt.send(int(ids[s]), T.WalkerH.step, int(v))
    queued, ends0 = len(rt._inject_q), rt.state_of(log)["ends"]
    p = os.path.join(DURABLE_DIR, "hostlog.npz")
    t0 = time.perf_counter()
    serialise.save(rt, p)
    save_s = time.perf_counter() - t0
    del rt
    torch.cuda.empty_cache()
    grown = tp.new_runtime(ponyc_tpu_torch, durable_hostlog_kw("mega", True),
                           "cuda")
    grown.declare(T.WalkerH, int(n * DURABLE_GROW)).declare(
        T.HostLog, 1).start()
    t0 = time.perf_counter()
    serialise.restore(grown, p)
    restore_s = time.perf_counter() - t0
    reset_launches()
    code = grown.run(max_steps=1_000_000)
    got = launches()
    st = grown.cohort_state(T.WalkerH)
    glog = int(grown.program.by_type[T.HostLog].slot_to_gid(0))
    ends = grown.state_of(glog)["ends"]
    if code != 0 or not (st["acc"][:n].astype(np.int64) == acc).all() or \
            ends != HOST_CHAINS or not got[2] or queued != q or \
            not 0 < ends0 < HOST_CHAINS:
        raise AssertionError(f"durable (c) hostlog: code {code}, acc ok "
                             f"{(st['acc'][:n] == acc).all()}, ends {ends} "
                             f"({ends0} at the cut), queued {queued}, "
                             f"launches {got}")
    print(f"durable (c) hostlog 2^20 x 2^12: snapshot at tick "
          f"{DURABLE_CUT_TICKS} with {queued} host sends queued and "
          f"HostLog.ends {ends0}, saved in {save_s:.2f} s "
          f"({os.path.getsize(p)} bytes), restored into walkers "
          f"x{DURABLE_GROW}, spill x2 in {restore_s:.2f} s; acc = the "
          f"NumPy oracle, ends {ends}, exit 0 after {grown.steps_run} "
          f"ticks; launches {got} [{_CACHE['card']}]", flush=True)
    out["hostlog"] = {"save_s": save_s, "restore_s": restore_s,
                      "bytes": os.path.getsize(p)}
    del grown
    torch.cuda.empty_cache()
    os.remove(p)
    return out


def durable_card_cpu():
    """(d): the agree phase's walkers world snapshotted on the card on each
    path, finished on the card and, restored, on the CPU: equal."""
    from ponyc_tpu_torch import serialise
    for name, build, finish in agree_worlds():
        if name == "walkers (spill/mute)":
            break
    for mode in ("mega", False, True):
        rt = build("cuda", mode)
        rt.run(max_steps=6)
        p = os.path.join(DURABLE_DIR, "small.npz")
        serialise.save(rt, p)
        cpu = build("cpu", mode)
        serialise.restore(cpu, p)
        g, c = finish(rt), finish(cpu)
        if g != c:
            raise AssertionError(f"durable (d) {_mode_name(mode)}: the card "
                                 f"and the CPU disagree after a restore")
        print(f"durable (d) {name} {_mode_name(mode)}: snapshot on the card "
              f"at tick 6, finished on the card and restored on the CPU: "
              f"fields, counters, exit code and ticks ({g[3]}) equal",
              flush=True)
        os.remove(p)


def durable_world(mode, **kw):
    """The supervised child's world: the hostlog world at HOST_CHILD under
    pallas_mega (tests/_torch_programs.py's WalkerH and HostLog)."""
    return hostlog_build("mega", hostlog_plan(*HOST_CHILD), **kw)


def durable_numbers(rt, log):
    tp, T = programs()
    return {"code": rt.exit_code, "steps": rt.steps_run,
            "ends": rt.state_of(log)["ends"],
            "acc": rt.cohort_state(T.WalkerH)["acc"].tolist()}


def durable_child(argv):
    """`chip_smoke.py --durable-child MODE PREFIX OUT EVENTS CYCLES`: one
    life of the supervised world ((e), (f)). MODE "wedge" queues a window
    behind a CYCLES-long torch.cuda._sleep on its first life. Exits with
    the coded error's code on a coded failure; writes its numbers to OUT
    when it finishes, and its events (JSON lines) to EVENTS."""
    import torch
    from ponyc_tpu_torch import supervise, testing
    from ponyc_tpu_torch.errors import error_code
    mode, prefix, out, events, cycles = argv[:5]

    def event(kind):
        with open(events, "a") as f:
            f.write(json.dumps({"event": kind, "t": time.time()}) + "\n")

    event("start")
    # The window kernel loads from the build's cache (the parent built
    # it) before the watchdog is armed.
    durable_world("mega")
    rt, log = durable_world(
        "mega", watchdog_s=OPS_DEADLINE_S,
        checkpoint_every_s=DURABLE_CHILD_CADENCE, checkpoint_path=prefix,
        checkpoint_keep=DURABLE_KEEP,
        analysis_path=os.path.join(os.path.dirname(prefix), "child.csv"))
    restored = supervise.maybe_restore(rt)
    if restored is None:
        rt.checkpoint()                          # the recovery floor
        if mode == "wedge":
            rt.run(max_steps=32)
            torch.cuda.synchronize()
            event("wedge")
            torch.cuda._sleep(int(cycles))
    else:
        event("restored")
        os.environ.pop("PONY_TPU_CHAOS", None)   # faults are one-shot
        testing.chaos.reset()
    try:
        rt.run()
    except Exception as e:                       # noqa: BLE001
        code = error_code(e)
        if code:
            event(f"failed {code}")
            os._exit(code)
        raise
    nums = durable_numbers(rt, log)
    rt.stop()
    event("done")
    nums["restored"] = restored is not None
    with open(out, "w") as f:
        json.dump(nums, f)
    return 0


def durable_supervised(label, want, cycles, chaos=None):
    """(e)/(f): the child under the subprocess supervisor; its result
    against the unfaulted run's `want`."""
    from ponyc_tpu_torch import serialise, supervise
    d = os.path.join(DURABLE_DIR, label)
    os.makedirs(d)
    prefix, out = os.path.join(d, "ring"), os.path.join(d, "out.json")
    events = os.path.join(d, "events.jsonl")
    argv = [sys.executable, os.path.abspath(__file__), "--durable-child",
            "wedge" if chaos is None else "clean", prefix, out, events,
            str(cycles)]
    if chaos is not None:
        os.environ["PONY_TPU_CHAOS"] = chaos
    try:
        sup = supervise.Supervisor(argv=argv, prefix=prefix, retries=3,
                                   backoff_s=0.1)
        code = sup.run()
    finally:
        os.environ.pop("PONY_TPU_CHAOS", None)
    with open(events) as f:
        ev = [json.loads(line) for line in f]
    with open(out) as f:
        got = json.load(f)
    ring = serialise.list_checkpoints(prefix)
    for _seq, f in ring:
        serialise.verify_snapshot(f)
    first = -9 if chaos is not None else 7
    same = {k: got[k] == want[k] for k in ("code", "ends", "acc")}
    if code != 0 or sup.restarts < 1 or sup.failures[0]["code"] != first \
            or not got["restored"] or not all(same.values()):
        raise AssertionError(f"durable {label}: exit {code}, restarts "
                             f"{sup.restarts}, failures {sup.failures}, "
                             f"equal {same}")
    return sup, ev, got, len(ring)


@phase("durable")
def run_durable(rec, frec, mrec):
    """Durable snapshots, the checkpoint ring and the supervisor on the
    card: (a) the cadence on ubench 2^20 x 4 on each path, (b) its newest
    snapshot restored into each path, (c) a grown relayout of the blob
    chain and the hostlog world at full width, (d) the card against the
    CPU, (e) a wedged window supervised to completion, (f) SIGKILL
    mid-flush supervised to completion."""
    import shutil
    import torch
    card = _CACHE["card"]
    recs = {False: rec, True: frec, "mega": mrec}
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    os.makedirs(DURABLE_DIR)
    out = {}
    ref = None
    for mode in ("mega", False, True):
        prefix = os.path.join(DURABLE_DIR, f"ring-{_mode_name(mode)}")
        keep, _base, per, med, stats, launched, nfiles = durable_cadence(
            mode, prefix)
        recs[mode]["launches_durable"] = max(launched)
        if mode == "mega":
            ref, ring_prefix = keep, prefix
        else:
            del keep
        torch.cuda.empty_cache()
        lo = {on: (1e3 * min(v), 1e3 * max(v)) for on, v in per.items()}
        it = {on: iter(v) for on, v in per.items()}
        spans = [next(it[on]) for on in DURABLE_ORDER]
        print(f"durable (a) ubench 2^20x4 {_mode_name(mode)}, "
              f"{DURABLE_TICKS[mode]}-tick spans alternated: cadence "
              f"{DURABLE_CADENCE} s on {1e3 * med[True]:.4f} ms/tick "
              f"({lo[True][0]:.4f}-{lo[True][1]:.4f}) against off "
              f"{1e3 * med[False]:.4f} ({lo[False][0]:.4f}-"
              f"{lo[False][1]:.4f}), {100 * (med[True] / med[False] - 1):+.1f}"
              f" %; {stats['checkpoints']} captured, {stats['written']} "
              f"written, {stats['skipped']} skipped (writer busy), "
              f"{stats['bytes_last']} bytes a snapshot, capture "
              f"{stats['timed_capture_ms']:.1f} ms mean over the "
              f"{stats['timed_captures']} of the timed spans ("
              f"{stats['capture_ms_total'] / max(1, stats['checkpoints']):.1f}"
              f" over all, the first allocating pinned memory), write "
              f"{stats['write_ms_total'] / max(1, stats['written']) / 1e3:.3f}"
              f" s mean; ring {nfiles} files, all verified; fields, "
              f"counters and ticks equal the run without; launches (drain, "
              f"fused, window) {launched}; spans in order, ms/tick: "
              f"{[round(1e3 * x, 4) for x in spans]} [{card}]", flush=True)
        out[f"cadence {_mode_name(mode)}"] = {
            "ms_tick_on": 1e3 * med[True], "ms_tick_off": 1e3 * med[False],
            "on_each": [1e3 * x for x in per[True]],
            "off_each": [1e3 * x for x in per[False]],
            "bytes": stats["bytes_last"],
            "capture_ms_timed": stats["timed_capture_ms"],
            "captures_timed": stats["timed_captures"],
            "capture_ms_mean": stats["capture_ms_total"]
            / max(1, stats["checkpoints"]),
            "write_s_mean": stats["write_ms_total"]
            / max(1, stats["written"]) / 1e3,
            "captured": stats["checkpoints"], "written": stats["written"],
            "skipped": stats["skipped"]}
    out["restore_s"] = durable_restore_paths(ref, ring_prefix)
    del ref
    torch.cuda.empty_cache()
    out["relayout"] = durable_relayout()
    durable_card_cpu()
    # (e) and (f): the unfaulted run in this process, then the children.
    rt, log = durable_world("mega")
    rt.run()
    want = durable_numbers(rt, log)
    rt.stop()
    del rt
    cycles, rate = sleep_cycles(DURABLE_WEDGE_S)
    t0 = time.time()
    sup, ev, got, nring = durable_supervised("wedge", want, cycles)
    t_end = time.time()
    wedge = next(e["t"] for e in ev if e["event"] == "wedge")
    back = next(e["t"] for e in ev if e["event"] == "restored")
    done = next(e["t"] for e in ev if e["event"] == "done")
    print(f"durable (e) hostlog 2^15 x 2^10 under pallas_mega, watchdog "
          f"{OPS_DEADLINE_S} s, a window behind a {DURABLE_WEDGE_S} s sleep: "
          f"first failure code {sup.failures[0]['code']}, {sup.restarts} "
          f"restart(s) from {os.path.basename(sup.restored_from)}; "
          f"{back - wedge:.2f} s from the wedge to the restored child, "
          f"{done - wedge:.2f} s to completion ({t_end - t0:.1f} s "
          f"supervised); acc, ends ({got['ends']}) and exit code equal the "
          f"unfaulted run's, ticks {got['steps']} (unfaulted "
          f"{want['steps']}); ring {nring} files verified [{card}]",
          flush=True)
    out["wedge"] = {"to_restart_s": back - wedge,
                    "to_completion_s": done - wedge}
    if not DURABLE_KILL[0]:
        print("durable (f) not run: a whole run leaves it to "
              "`--only durable` (tests/test_torch_durability.py runs it "
              "on the CPU)", flush=True)
        shutil.rmtree(DURABLE_DIR, ignore_errors=True)
        return out
    t0 = time.time()
    sup, ev, got, nring = durable_supervised(
        "kill", want, 0, chaos="snapshot-mid-flush@3")
    print(f"durable (f) the same child with PONY_TPU_CHAOS="
          f"snapshot-mid-flush@3: first failure {sup.failures[0]['code']} "
          f"(SIGKILL mid-flush), {sup.restarts} restart(s) from "
          f"{os.path.basename(sup.restored_from)}, every ring file left "
          f"({nring}) verifies; acc, ends and exit code equal the "
          f"unfaulted run's ({time.time() - t0:.1f} s supervised)",
          flush=True)
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    return out


@phase("stdlib")
def run_stdlib(rec, frec, mrec):
    """The standard library on the card: (a) randping at full width on
    each path (bodies drawing from stdlib.random), against a NumPy replay
    of every walk and across the paths; (b) examples/heartbeat.py's Heart
    beaten by a stdlib timer, after (c) a child process's output and exit
    code reach a host actor through attach_processes(), on each path,
    and a FilePath written and read back under TMPDIR."""
    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    import numpy as np
    import torch
    import ponyc_tpu_torch
    card = _CACHE["card"]
    tp, _T = programs()
    n, hops = RANDPING
    P = randping_type()
    recs = {False: rec, True: frec, "mega": mrec}
    out, worlds = {}, {}
    with ProcessPoolExecutor(
            RANDPING_ORACLE_PROCS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = [pool.submit(randping_oracle_part, n, hops, k)
                 for k in range(tp.RP_TOKENS)]
        for mode in (False, True, "mega"):
            t0 = time.perf_counter()
            rt = randping_build(mode)
            windows = count_windows(rt)
            torch.cuda.synchronize()
            setup = time.perf_counter() - t0
            q0 = rt.ticks_enqueued
            reset_launches()                # the main path's run starts here
            t0 = time.perf_counter()
            code = rt.run(max_steps=1 << 20)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            got = launches()                # ... and ends here
            enqueued = rt.ticks_enqueued - q0
            nums = world_numbers(rt, P)
            processed = rt.totals["processed"]
            want = expected_launches(mode, enqueued, windows[0])
            if code != 0 or processed != n * tp.RP_TOKENS * hops or \
                    nums["counters"]["n_processed"] != processed:
                raise AssertionError(
                    f"randping {_mode_name(mode)}: exit code {code}, "
                    f"processed {processed} (counter "
                    f"{nums['counters']['n_processed']}), expected "
                    f"{n * tp.RP_TOKENS * hops}")
            if got != want:
                raise AssertionError(
                    f"randping {_mode_name(mode)}: launches (drain, fused, "
                    f"window) {got} for {enqueued} ticks enqueued and "
                    f"{windows[0]} windows, expected {want}")
            recs[mode]["launches_stdlib"] = max(got)
            worlds[mode] = nums
            ms = 1e3 * elapsed / max(1, rt.steps_run)
            out[f"randping {_mode_name(mode)}"] = dict(
                seconds=elapsed, ticks=rt.steps_run, ms_tick=ms,
                windows=windows[0], launches=got, setup_s=setup,
                counters=nums["counters"])
            print(f"randping {n} x {tp.RP_TOKENS} x {hops} "
                  f"{_mode_name(mode)} [{card}]: {processed} processed in "
                  f"{rt.steps_run} ticks, {elapsed:.3f} s = {ms:.4f} ms a "
                  f"tick; {windows[0]} windows; counters {nums['counters']}; "
                  f"launches (drain, fused, window) {got}; dispatch "
                  f"{dispatch_paths(rt)} (build+seed {setup:.1f} s)",
                  flush=True)
            del rt
            torch.cuda.empty_cache()
        visits = sum(f.result()[0] for f in parts)
        hits = sum(f.result()[1] for f in parts)
    base = worlds[False]
    for mode in (True, "mega"):
        w = worlds[mode]
        if not same_arrays(w["fields"], base["fields"]) or \
                w["counters"] != base["counters"] or \
                w["steps"] != base["steps"]:
            raise AssertionError(f"randping: {_mode_name(mode)}'s fields, "
                                 "counters or ticks differ from the plain "
                                 "tick's")
    if not (np.array_equal(base["fields"]["visits"].astype(np.int64),
                           visits)
            and np.array_equal(base["fields"]["hits"].astype(np.int64),
                               hits)):
        raise AssertionError("randping: visits or hits differ from the "
                             "NumPy replay of the walks")
    print(f"randping: visits and hits equal the NumPy replay of the "
          f"{tp.RP_TOKENS * n} walks ({int(hits.sum())} hits of "
          f"{int(visits.sum())} visits); fields, counters and ticks "
          f"({base['steps']}) equal across the three paths; "
          f"{base['counters']['n_mutes']} mutes, "
          f"{base['counters']['n_rejected']} rejections", flush=True)
    # (b), (c): a child process, then the heartbeat, on each path.
    S = stdlib_types()
    for mode in (False, True, "mega"):
        t0 = time.perf_counter()
        rt, got = tp.stdlib_world(ponyc_tpu_torch, S, device="cuda",
                                  **_mode_kw(mode))
        if got["code"] != 0 or got["beats"] != tp.HEART_BEATS or \
                got["live_timers"] or got["proc"]["code"] != 3 or \
                got["proc"]["stdout"] != b"child-says-hi\n":
            raise AssertionError(f"heartbeat/child {_mode_name(mode)}: "
                                 f"{got}")
        rt.stop()
        del rt
        print(f"heartbeat {_mode_name(mode)}: a child's stdout "
              f"{got['proc']['stdout']!r} and exit code 3 through "
              f"attach_processes(); {got['beats']} timer beats, exit code "
              f"0 ({time.perf_counter() - t0:.2f} s)", flush=True)
    from ponyc_tpu_torch import Runtime, RuntimeOptions
    from ponyc_tpu_torch.files import File, FilePath
    d = tempfile.mkdtemp(prefix="pony_files_")
    try:
        rt = Runtime(RuntimeOptions(tuning_cache="off"))
        notes = FilePath(rt.files_auth(), d).join("notes")
        notes.mkdir()
        fp = notes.join("log.txt")
        with File(fp, "w+b") as f:
            f.print("line one").print("line two").flush()
        with File(fp, "rb") as f:
            lines = f.lines()
        if lines[:2] != [b"line one", b"line two"] or \
                fp.info().st_size != 18:
            raise AssertionError(f"files: read back {lines}")
        print(f"files: a FilePath under TMPDIR written and read back "
              f"({fp.info().st_size} bytes)", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


COSTS_N = 1 << 20          # the costs phase's ubench: 2^20 pingers x 4
COSTS_TICKS = 64           # (bench.py:897-907's shape), 64 ticks a path


@phase("costs")
def run_costs(rec):
    """Cost capture on each path (costs.py, ops/census.py): (a) start()
    with cost_capture=True censuses the step and the one-tick window
    (no record an error; the plain and fused steps count the drain's or
    the fused kernel's launch, the window kernel's window at least
    mega_bound's design bytes); (b) a capture of the seeded world, then
    64 ticks: fields, counters and steps_run equal 64 ticks of a world
    started without capture; (c) the record-move probe on the card is
    exactly 4 * record_words bytes a message, measured_block does not
    diverge, a model seeded at 10x does (MODEL DIVERGENCE on stderr);
    (d) the /metrics gauge of the step above 0, a postmortem rendering
    `measured [step]`; (e) BenchRunner (ponybench) times kernel 1 at the
    kernels phase's ubench drain shape: its p50 beside that phase's
    CUDA-event wall a call, not below 0.9x the device time."""
    import contextlib
    import io
    import torch
    from ponyc_tpu_torch import costs, metrics
    from ponyc_tpu_torch.benching import BenchRunner
    from ponyc_tpu_torch.flight import render_postmortem
    from ponyc_tpu_torch.models import ubench
    from ponyc_tpu_torch.ops import mailbox_kernel as mk
    from ponyc_tpu_torch.ops.megakernel import record_words
    out = {}
    for mode in (False, True, "mega"):
        name = _mode_name(mode)
        opts = ubench_opts(mode, COSTS_TICKS)
        t0 = time.perf_counter()
        rt, ids = ubench.build(COSTS_N, ubench_opts(
            mode, COSTS_TICKS, cost_capture=True), pings=4)
        start_s = time.perf_counter() - t0
        res = {"start_s": start_s}
        for when in ("start", "seeded"):
            ex = rt._costs["executables"]
            for exe in ("step", "window"):
                r = ex[exe]
                if "error" in r:
                    raise AssertionError(f"costs {name} [{exe}] at {when}: "
                                         f"{r['error']}")
                print(f"costs {name} [{exe}] at {when}: bytes_accessed "
                      f"{r['bytes_accessed']:.0f}, peak_bytes "
                      f"{r['peak_bytes']}, flops {r['flops']}, ATen ops "
                      f"{r['ops']}, kernels {r['kernels']}, capture "
                      f"{r['capture_s']:.3f} s", flush=True)
                res[f"{when} {exe}"] = {k: r[k] for k in (
                    "bytes_accessed", "peak_bytes", "ops", "kernels",
                    "capture_s")}
            if mode == "mega":
                k = ex["window"]["kernels"].get("mega")
                if not k or k["launches"] != 1 or k["bytes"] <= 0:
                    raise AssertionError(f"costs {name}: the window's "
                                         f"census missed kernel 3: {k}")
                if when == "start":
                    design = mega_bound(rt._multi_g, 1, 0, 0, "segment")[5]
                    got = ex["window"]["bytes_accessed"]
                    print(f"costs {name}: window census {got:.0f} B "
                          f"against mega_bound's design bytes {design:.0f} "
                          f"for a one-tick window ({got / design:.2f}x)",
                          flush=True)
                    if got < design:
                        raise AssertionError("the window's census is "
                                             "below the design bytes")
                    res["design_bytes"] = design
            else:
                kname = "fused" if mode is True else "drain"
                k = ex["step"]["kernels"].get(kname)
                if not k or k["launches"] < 1 or k["bytes"] <= 0:
                    raise AssertionError(f"costs {name}: the step's census "
                                         f"missed the {kname} kernel: {k}")
            if when == "start":
                ubench.seed_all(rt, ids, hops=1 << 30, pings=4)
                rt.measured_costs(force=True)   # a world with messages
        # (b) the capture left the world where it was
        rt.run(max_steps=COSTS_TICKS)
        got = world_numbers(rt, ubench.Pinger)
        ref, rids = ubench.build(COSTS_N, opts, pings=4)
        ubench.seed_all(ref, rids, hops=1 << 30, pings=4)
        ref.run(max_steps=COSTS_TICKS)
        want = world_numbers(ref, ubench.Pinger)
        del ref
        if not (got["steps"] == want["steps"] > 0
                and got["counters"] == want["counters"]
                and same_arrays(got["fields"], want["fields"])
                and same_arrays(got["tel"], want["tel"])):
            raise AssertionError(f"costs {name}: 64 ticks after the capture "
                                 "differ from the world without it")
        print(f"costs {name}: 64 ticks after two captures equal the world "
              f"without (steps {got['steps']}, processed "
              f"{got['counters']['n_processed']})", flush=True)
        # (c) the probe, the verdict, a seeded divergence
        probe = costs.record_move_probe(rt.opts, device="cuda")
        w1 = record_words(rt.opts)
        if probe["bytes_per_msg"] != 4.0 * w1:
            raise AssertionError(f"record-move probe {probe}")
        blk = costs.measured_block(rt)
        if blk["model_divergence"]["diverged"]:
            raise AssertionError(f"costs {name}: {blk['model_divergence']}")
        fake = dict(blk["modelled"],
                    unpacked_bytes=10 * blk["modelled"]["unpacked_bytes"])
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            bad = costs.measured_block(rt, modelled=fake)
        if not bad["model_divergence"]["diverged"] \
                or "MODEL DIVERGENCE" not in err.getvalue():
            raise AssertionError("a model seeded at 10x did not diverge")
        costs.measured_block(rt)
        print(f"costs {name}: probe {probe['bytes_per_msg']} B/msg = 4 x "
              f"{w1} record words; model ratio "
              f"{blk['model_divergence']['ratio']}; seeded 10x: ratio "
              f"{bad['model_divergence']['ratio']}, MODEL DIVERGENCE on "
              "stderr", flush=True)
        # (d) /metrics and the postmortem
        parsed = metrics.parse_prometheus(metrics.prometheus_text(
            metrics.snapshot(rt)))
        gauge = parsed.get(("pony_tpu_measured_bytes_accessed",
                            (("executable", "step"),)), 0)
        text = render_postmortem(rt._flight.postmortem("manual"))
        if not gauge > 0 or "measured [step]" not in text \
                or "model vs measured" not in text:
            raise AssertionError(f"costs {name}: gauge {gauge}, postmortem "
                                 f"{text[-400:]}")
        print(f"costs {name}: /metrics pony_tpu_measured_bytes_accessed"
              f"{{executable=step}} {gauge:.0f}; postmortem: "
              + " | ".join(line for line in text.splitlines()
                           if line.startswith(("measured [",
                                               "model vs"))), flush=True)
        rt.stop()
        del rt
        torch.cuda.empty_cache()
        out[name] = res
    # (e) ponybench on kernel 1 at ubench's drain shape
    cap, w1, n, batch = 4, 2, 1 << 20, 4
    sets = [drain_inputs(torch, cap, w1, n, batch, 40 + s)
            for s in range(3)]
    turn = [0]

    def kern():
        turn[0] += 1
        b, h, r = sets[turn[0] % 3]
        return mk.drain_msgs(b, h, r, batch)
    dev_ms = rec.get("ms")
    if dev_ms is None:          # a --only run without the kernels phase
        dev_ms = device_ms(lambda *a: kern(), 50, [()], "drain_kernel")
    bench = BenchRunner(min_window_s=0.2, out=io.StringIO())
    r = bench.bench("drain 2^20x4", kern, items_per_call=n)
    p50_ms = r.p50_s * 1e3
    print(f"costs ponybench: kernel 1 at cap={cap} w1={w1} N={n} "
          f"batch={batch}: p50 {p50_ms:.4f} ms a call (mean "
          f"{r.mean_s * 1e3:.4f}, p95 {r.p95_s * 1e3:.4f}, {r.reps} reps a "
          f"window) beside the kernels phase's CUDA-event wall "
          f"{rec.get('call_ms', float('nan')):.4f} ms and device time "
          f"{dev_ms:.4f} ms", flush=True)
    if p50_ms < 0.9 * dev_ms:
        raise AssertionError("ponybench's p50 is below 0.9x the device time")
    out["ponybench_p50_ms"] = p50_ms
    return out


def static_programs():
    """Every program the script builds, by label: its actor types."""
    import ponyc_tpu_torch
    from ponyc_tpu_torch import serve
    from ponyc_tpu_torch.models import (fanin, gups, mandelbrot, nbody,
                                        records, ring, spawn_tree, ubench)

    def types_of(ns):
        return [v for v in vars(ns).values()
                if isinstance(v, ponyc_tpu_torch.api.ActorTypeMeta)
                and v.behaviour_defs]
    tp, T = programs()
    out = {"programs()": types_of(T), "blob_programs()":
           types_of(blob_programs()[1]),
           "telemetry": types_of(tp.define_telemetry(ponyc_tpu_torch)),
           "ops": types_of(tp.define_ops(ponyc_tpu_torch)),
           "randping": [randping_type()], "stdlib": types_of(stdlib_types()),
           "mixed": [mixed_type()],
           "serve": [serve.ServeWorker, serve.Egress, serve.FrontDoor]}
    for m in (ring, ubench, gups, fanin, records, nbody, spawn_tree,
              mandelbrot):
        out["models." + m.__name__.rsplit(".", 1)[1]] = types_of(m)
    return out


@phase("static")
def run_static():
    """verify_program and lint_program over every program the script
    builds, in this environment (no JAX): zero verify failures and zero
    findings (what the CPU tests give); then `python -m ponyc_tpu_torch
    verify|lint|doc ponyc_tpu_torch.models.ubench` each exit 0."""
    import tempfile
    from ponyc_tpu_torch import Program, RuntimeOptions
    from ponyc_tpu_torch.lint import lint_program
    from ponyc_tpu_torch.verify import verify_program
    t0 = time.perf_counter()
    n_types = n_beh = 0
    findings = {}
    for label, types in static_programs().items():
        p = Program(RuntimeOptions(msg_words=16, blob_slots=64,
                                   blob_words=8))
        for t in types:
            p.declare(t, 8)
        p.finalize()
        rep = verify_program(p, lint=False)     # raises on a violation
        found = lint_program(p)
        n_types += len(rep)
        n_beh += sum(len(v) for v in rep.values())
        if found:
            findings[label] = [str(f) for f in found]
    sweep_s = time.perf_counter() - t0
    print(f"static: {n_types} types, {n_beh} behaviours verified and "
          f"linted in {sweep_s:.2f} s: 0 verify failures, "
          f"{sum(len(v) for v in findings.values())} findings", flush=True)
    if findings:
        raise AssertionError(f"lint findings: {findings}")
    codes = {}
    os.makedirs(os.path.join(ROOT, "_chipwork"), exist_ok=True)
    d = tempfile.mkdtemp(dir=os.path.join(ROOT, "_chipwork"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    try:
        t1 = time.perf_counter()
        procs = {}
        for verb in ("verify", "lint", "doc"):       # the three at once
            argv = [sys.executable, "-m", "ponyc_tpu_torch", verb,
                    "ponyc_tpu_torch.models.ubench"]
            if verb == "doc":
                argv += ["-o", d]
            procs[verb] = subprocess.Popen(
                argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for verb, proc in procs.items():
            try:
                so, se = proc.communicate(timeout=300)
            finally:
                proc.kill()
            codes[verb] = proc.returncode
            print(f"static: python -m ponyc_tpu_torch {verb} "
                  f"ponyc_tpu_torch.models.ubench: exit {proc.returncode} "
                  f"({time.perf_counter() - t1:.1f} s for the three): "
                  f"{so.strip().splitlines()[-1:]}", flush=True)
            if proc.returncode != 0:
                raise AssertionError(f"{verb}: {se[-800:]}")
    finally:
        import shutil
        shutil.rmtree(d, ignore_errors=True)
    return {"types": n_types, "behaviours": n_beh, "sweep_s": sweep_s,
            "codes": codes, "seconds": time.perf_counter() - t0}


MESH_SHARDS = 4
MESH_UBENCH = (1 << 20, 4, 4, 64)   # pingers, pings, warm-up ticks, timed
#   ticks (bench.py:897-907's world: cap 4, batch 4, a 64-tick window)
MESH_MORE = 16                      # ticks after the snapshot
MESH_DIR = os.path.join(ROOT, "_chipwork", "smoke_mesh")   # git-ignored
MESH_FIFO = dict(mailbox_cap=2, batch=1, max_sends=3, spill_cap=4096,
                 inject_slots=32, mesh_shards=4, route_bucket=8,
                 quiesce_interval=2)  # tests/test_fifo.py's mesh4-route-spill
MESH_FIFO_ITEMS = 40      # items an edge (the reference's test runs 60:
#   302 ticks, 16.6 s on the card; 40 is the port's build_fifo default)
MESH_BLOB = dict(mailbox_cap=2, batch=1, max_sends=1, spill_cap=1024,
                 inject_slots=16, mesh_shards=2)  # test_differential.py:407
MESH_PROCS = 2    # processes that run the small worlds on the CPU while
#   this one runs them on the card


def ref_slots(cohort, gids):
    """Global actor ids of `cohort` → its slots (the same actor whatever
    the shard count)."""
    import numpy as np
    g = np.asarray(gids, np.int64)
    nl = cohort.n_local_total
    return (g % nl - cohort.local_start) * cohort.shards + g // nl


def mesh_numbers(rt, slots=True):
    """What a ubench world must agree on whatever its shard count:
    `pings` and the ring's successor (as a slot; as the id stored with
    `slots=False`) in slot order, the counters and the tick counter."""
    from ponyc_tpu_torch.models import ubench
    cs = rt.cohort_state(ubench.Pinger)
    cohort = rt.program.by_type[ubench.Pinger]
    return {"pings": cs["pings"],
            "next": (ref_slots(cohort, cs["next_ref"]) if slots
                     else cs["next_ref"]),
            "counters": {c: rt.counter(c) for c in (
                "n_processed", "n_delivered", "n_rejected", "n_mutes",
                "n_deadletter", "n_badmsg")},
            "ticks": int(rt.state.step_no.max())}


def mesh_ubench(mode, shards):
    """ubench at `shards` shards: warm-up ticks, then the timed ticks in
    one window (the main path's run, its launches counted). Checks the
    processed count and that the path's kernel launched once a shard and
    a tick enqueued (a mesh never launches the window kernel: it is not
    eligible, and pallas_mega runs the plain window). Returns (runtime,
    launches, seconds a tick)."""
    import torch
    from ponyc_tpu_torch.models import ubench
    n, pings, warm, ticks = MESH_UBENCH
    rt, ids = ubench.build(n, ubench_opts(mode, ticks, mesh_shards=shards),
                           pings=pings)
    ubench.seed_all(rt, ids, hops=1 << 30, pings=pings)
    rt.run(max_steps=warm)
    torch.cuda.synchronize()
    p0, s0, q0 = rt.counter("n_processed"), rt.steps_run, rt.ticks_enqueued
    reset_launches()                    # the main path's run starts here
    t0 = time.perf_counter()
    rt.run(max_steps=ticks)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    got = launches()                    # ... and ends here
    done, ran = rt.counter("n_processed") - p0, rt.steps_run - s0
    enq = rt.ticks_enqueued - q0
    label = f"{shards} shard(s) {_mode_name(mode)}"
    if done != n * pings * ticks or ran != ticks or enq != ticks:
        raise AssertionError(f"{label}: processed {done} in {ran} ticks "
                             f"({enq} enqueued), expected "
                             f"{n * pings * ticks} in {ticks}")
    k = shards * enq
    want = (0, k, 0) if _fused(mode) else (k, 0, 0)
    if got != want:
        raise AssertionError(f"{label}: launches (drain, fused, window) "
                             f"{got} for {enq} ticks, expected {want}")
    if rt.counter("n_rejected") or rt.exit_code:
        raise AssertionError(f"{label}: rejected messages or exited")
    return rt, got, elapsed / ticks


def route_device_share(rt, ticks=4):
    """The route's share of a mesh tick's device time: torch.profiler's
    device time of the kernels launched inside a `record_function` range
    around each of `_route`'s segments, over the device time of every
    kernel, for `ticks` ticks of `rt`. None where the profiler gives no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprof, \
        record_function
    from ponyc_tpu_torch.runtime import engine
    orig = engine._route

    def route(*a, **k):
        gen, sent = orig(*a, **k), None
        while True:
            with record_function("mesh_route"):
                try:
                    req = gen.send(sent)
                except StopIteration as e:
                    return e.value
            sent = yield req
    engine._route = route
    try:
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            rt.run(max_steps=ticks)
            torch.cuda.synchronize()
    finally:
        engine._route = orig
    busy = route_us = 0.0
    for evt in prof.key_averages():
        if evt.key == "mesh_route":
            # The host-side range: the device time of the kernels launched
            # inside it (its device-side annotation spans the gaps between
            # them as well, and is not read).
            if evt.device_type == torch.autograd.DeviceType.CPU:
                route_us += float(getattr(evt, "device_time_total", None)
                                  or getattr(evt, "cuda_time_total", 0)
                                  or 0)
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            busy += _device_us(evt)
    return (route_us / busy, busy / ticks / 1e3) if route_us and busy \
        else None


def mesh_small_worlds():
    """(name, run(device) → the numbers the card and the CPU must agree
    on) of the routing-pressure and blob-migration worlds:
    tests/test_fifo.py's mesh4-route-spill (each per-edge stream checked
    on the device, the oracle its stamps) and the blob chain of
    tests/test_differential.py on two shards (run_blob_chain holds each
    walker's acc to the NumPy oracle, every blob freed, none dead)."""
    import ponyc_tpu_torch
    tp, T = programs()
    _tp, B = blob_programs()

    def fifo(device):
        items = MESH_FIFO_ITEMS
        rt = tp.build_fifo(ponyc_tpu_torch, T, 101, n_cons=6, items=items,
                           device=device, **MESH_FIFO)
        rt.run(max_steps=500_000)
        cons = {k: v[:6] for k, v in rt.cohort_state(T.Cons).items()}
        ok = ((cons["got"] == 4 * items).all()
              and all((cons[f"last{s}"] == items - 1).all()
                      for s in range(4)))
        return {"world": (_world_numbers(rt, T.Prod),
                          _world_numbers(rt, T.Cons)),
                "violations": int(cons["bad"].sum()), "oracle": bool(ok),
                "ticks": rt.steps_run}

    def chain(device):
        rt = tp.run_blob_chain(ponyc_tpu_torch, B, 77, MESH_BLOB, n=16,
                               device=device)
        return {"world": _world_numbers(rt, B.BlobWalker),
                "moved": rt.counter("n_blob_moved"),
                "remote": rt.counter("n_blob_remote"),
                "in_use": rt.blobs_in_use, "oracle": True,
                "ticks": rt.steps_run}

    return [("fifo mesh4-route-spill", fifo), ("blob chain 2 shards", chain)]


def mesh_cpu(name):
    """One small mesh world on the CPU (in a worker process)."""
    import torch
    torch.set_num_threads(2)
    return dict(mesh_small_worlds())[name]("cpu")


def mesh_checks(rec, frec, mrec, pool):
    """The mesh phase's checks (run_mesh), the CPU's runs of the small
    worlds in `pool`."""
    import numpy as np
    import torch
    from ponyc_tpu_torch import Runtime, serialise
    from ponyc_tpu_torch.models import ubench
    from ponyc_tpu_torch.runtime import engine
    card = _CACHE.get("card", "cuda")
    n, pings, warm, ticks = MESH_UBENCH
    out = {}
    cpu = {name: pool.submit(mesh_cpu, name)
           for name, _run in mesh_small_worlds()}
    # (a) 1 and 4 shards on each path; pallas_mega over the mesh runs the
    # plain window.
    base, keep = {}, None
    for mode, r in ((False, rec), (True, frec), ("mega", mrec)):
        for shards in ((MESH_SHARDS,) if mode == "mega"
                       else (1, MESH_SHARDS)):
            rt, got, s_tick = mesh_ubench(mode, shards)
            nums = mesh_numbers(rt)
            out[f"{_mode_name(mode)} {shards}"] = {
                "ms_tick": 1e3 * s_tick, "launches": got}
            print(f"mesh ubench 2^{n.bit_length() - 1}x{pings} {shards} "
                  f"shard(s) {_mode_name(mode)}: {1e3 * s_tick:.3f} "
                  f"ms/tick ({ticks} ticks after {warm}); launches "
                  f"(drain, fused, window) {got} [{card}]", flush=True)
            if shards == 1:
                base[mode] = nums
                continue
            r["launches_mesh"] = got[2] if mode == "mega" else got[
                1 if mode else 0]
            for other in ((False,) if mode == "mega" else (mode, False)):
                if not same_numbers(nums, base[other]):
                    raise AssertionError(
                        f"4 shards {_mode_name(mode)} differ from 1 shard "
                        f"{_mode_name(other)} (pings, successors, "
                        "counters or ticks)")
            print(f"mesh {_mode_name(mode)}: 4 shards == 1 shard (pings, "
                  "successors, counters, ticks)", flush=True)
            if mode is False:
                keep = rt
        del rt
    # (b) the route's share of a 4-shard plain tick's host wall (its code
    # and its three all_to_alls), then of its device time.
    rt, keep = keep, None
    spent = {"route": 0.0, "a2a": 0.0}
    orig_route, orig_run = engine._route, rt.mesh.comm.run

    def route(*a, **k):
        gen, sent = orig_route(*a, **k), None
        while True:
            t0 = time.perf_counter()
            try:
                req = gen.send(sent)
            except StopIteration as e:
                spent["route"] += time.perf_counter() - t0
                return e.value
            spent["route"] += time.perf_counter() - t0
            sent = yield req

    def run(op, xs, dim):
        t0 = time.perf_counter()
        res = orig_run(op, xs, dim)
        if op == "all_to_all":
            spent["a2a"] += time.perf_counter() - t0
        return res
    engine._route, rt.mesh.comm.run = route, run
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.run(max_steps=MESH_MORE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine._route, rt.mesh.comm.run = orig_route, orig_run
    out["route_host_share"] = (spent["route"] + spent["a2a"]) / wall
    dev = route_device_share(rt)
    out["route_device_share"] = dev and dev[0]
    dev_txt = ("its device share not measured (no device time)" if not dev
               else f"{100 * dev[0]:.1f} % of the kernels' device time "
               f"({dev[1]:.3f} ms a tick over 4 profiled ticks)")
    print(f"mesh route: {100 * out['route_host_share']:.1f} % of a 4-shard "
          f"plain tick's host wall ({1e3 * spent['route'] / MESH_MORE:.3f} "
          f"ms its code, {1e3 * spent['a2a'] / MESH_MORE:.3f} ms its "
          f"all_to_alls, of {1e3 * wall / MESH_MORE:.3f} ms a tick over "
          f"{MESH_MORE} ticks); {dev_txt} [{card}]", flush=True)
    # (c) the 4-shard world snapshotted, restored onto 1 shard and run
    # on: equal to the unbroken 4-shard run. Pinger.next_ref is an
    # untyped Ref, which a relayout carries as the id it holds (typed
    # refs are remapped), in the JAX package's serialise as here.
    os.makedirs(MESH_DIR, exist_ok=True)
    path = os.path.join(MESH_DIR, "ubench4.npz")
    t0 = time.perf_counter()
    header, arrays = serialise.capture(rt)
    # Stored, not deflated: serialise.save's compression took 10.7 s of
    # the phase for this world (chip call 1).
    serialise.write_snapshot(header, arrays, path, compress=False)
    save_s = time.perf_counter() - t0
    rt.run(max_steps=MESH_MORE)
    unbroken = mesh_numbers(rt, slots=False)
    del rt
    one = Runtime(ubench_opts(False, MESH_MORE))
    one.declare(ubench.Pinger, n).start()
    t0 = time.perf_counter()
    serialise.restore(one, path)
    restore_s = time.perf_counter() - t0
    one.run(max_steps=MESH_MORE)
    if one.program.shards != 1 or not same_numbers(
            mesh_numbers(one, slots=False), unbroken):
        raise AssertionError("the 4-shard snapshot restored onto 1 shard "
                             "differs from the unbroken run")
    print(f"mesh snapshot: 4 shards -> 1 shard, {MESH_MORE} ticks on equal "
          f"the unbroken run (save {save_s:.2f} s, "
          f"{os.path.getsize(path) / 2**20:.1f} MiB, restore "
          f"{restore_s:.2f} s)", flush=True)
    del one
    os.remove(path)
    torch.cuda.empty_cache()
    # (d) the route-spill FIFO world and the 2-shard blob chain on the
    # device, against their CPU runs.
    for name, run_world in mesh_small_worlds():
        t0 = time.perf_counter()
        g = run_world("cuda")
        dev_s = time.perf_counter() - t0
        c = cpu[name].result()
        if not (g["oracle"] and same_numbers(g, c)):
            raise AssertionError(f"mesh {name}: the card and the CPU "
                                 f"disagree or the oracle failed: {g} vs "
                                 f"{c}")
        if g.get("violations") or (name.startswith("blob") and not (
                g["moved"] > 0 and g["remote"] == 0)):
            raise AssertionError(f"mesh {name}: FIFO violated, no blob "
                                 f"migrated or one arrived dead: {g}")
        facts = {k: v for k, v in g.items() if k != "world"}
        print(f"mesh {name}: card == CPU, oracle ok, {facts} "
              f"(card {dev_s:.1f} s)", flush=True)
    return out


@phase("mesh")
def run_mesh(rec, frec, mrec):
    """Sharded worlds (parallel/) on the card, every shard on it through
    LocalComm: mesh_checks, the CPU's side in worker processes."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(
        MESH_PROCS, mp_context=multiprocessing.get_context("spawn"))
    try:
        out = mesh_checks(rec, frec, mrec, pool)
    finally:
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"mesh phase: {out['seconds']:.1f} s [{_CACHE['card']}]",
          flush=True)
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
PLAIN_EVERY_WORLD = [False]   # kernels-mega profiles the plain window's
#   device time on every timed world: set by a --only run, which has no
#   time limit to keep; the whole run profiles ubench's alone
DURABLE_KILL = [False]        # durable (f), the supervised SIGKILL
#   mid-flush: set by a --only run; a whole run skips it for the time
#   limit (36-55 s)


def main():
    if "--durable-child" in sys.argv:
        i = sys.argv.index("--durable-child")
        return durable_child(sys.argv[i + 1:])
    only = None
    if "--only" in sys.argv:
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))
        PLAIN_EVERY_WORLD[0] = True
        DURABLE_KILL[0] = True
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
        if want("blobs"):
            summary["blobs"] = run_blobs(rec, frec, mrec)
        if want("telemetry"):
            summary["telemetry"] = run_telemetry(rec, frec, mrec)
        if want("tune"):
            summary["tune"] = run_tune(rec, frec, mrec)
        if want("gups"):
            summary["gups"] = run_gups(rec, frec, mrec)
        if want("fanin"):
            summary["fanin"] = run_fanin(rec, frec, mrec)
        if want("mandelbrot"):
            summary["mandelbrot"] = run_mandelbrot(rec, frec, mrec)
        if want("serve"):
            summary["serve"] = run_serve(rec, frec, mrec)
        if want("ops"):
            summary["ops"] = run_ops(rec, frec, mrec)
        if want("durable"):
            summary["durable"] = run_durable(rec, frec, mrec)
        if want("stdlib"):
            summary["stdlib"] = run_stdlib(rec, frec, mrec)
        if want("mesh"):
            summary["mesh"] = run_mesh(rec, frec, mrec)
        if want("costs"):
            summary["costs"] = run_costs(rec)
        if want("static"):
            summary["static"] = run_static()
        if want("profile"):
            summary["profile"] = run_profile()
    summary["seconds"] = time.perf_counter() - t_start
    if FAILED:
        # Repeated last on both streams: later phases' output (children's
        # postmortems on stderr) must not bury why an early phase failed.
        for stream in (sys.stdout, sys.stderr):
            print(f"chip_smoke: FAILED phases: {FAILED}", file=stream)
            for name, err, where in FAILURES:
                print(f"chip_smoke: [{name}] {err[:2000]} (at {where})",
                      file=stream, flush=True)
        return 1
    print(json.dumps(summary), flush=True)
    if only is not None:
        print(f"chip_smoke: ran only {sorted(only)}; no result line",
              flush=True)
        return 0
    extra = ("call_ms", "plain_call_ms", "library_call_ms",
             "launches_ring", "launches_mixed", "launches_nbody",
             "launches_spawn", "launches_host", "launches_blobs",
             "launches_telemetry", "launches_telemetry_spawn",
             "launches_telemetry_host", "launches_cosort", "launches_tune",
             "launches_tune_calibration", "launches_gups", "launches_fanin",
             "launches_ops", "launches_durable", "launches_mandelbrot",
             "launches_serve", "launches_stdlib", "launches_mesh",
             "mandelbrot", "randping",
             "spawn_tree", "mixed_onehot", "mixed_before_ms",
             "spawn_tree_regrouped_ms",
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

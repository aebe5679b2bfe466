"""Smoke run of the PyTorch port (ponyc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--only PHASE,PHASE,...]

Phases, each of which must pass (the exit code is non-zero otherwise):

  1. build    — compile every CUDA kernel the run uses from csrc/ (the
                drain, and the fused dispatch kernel of every cohort
                below, one nvcc each, all started together) and load
                them; prints each build's time and ptxas's registers and
                spills;
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
  3. agree    — small worlds run on the card and on the CPU give equal
                fields and counters, with the fused kernel off and on
                (the CPU path is the one the test suite holds against
                the JAX package);
  4. ubench   — message-ubench through Runtime at 2**20 pingers,
                pings=4 (bench.py's defaults): three timed windows of a
                fixed number of ticks after warm-up, with the drain
                kernel and then with the fused kernel (pallas_fused);
                every pinger processes `pings` messages a tick and the
                path's kernel launches once a tick;
  5. ring     — the token ring, 1024 nodes, 4096 hops, through
                Runtime.run(), plain then fused: the pass count, the exit
                code, and one launch of the path's kernel per enqueued
                tick (ticks run plus the ticks enqueued but predicated
                off on the device); under pallas_fused no drain launch;
  6. mixed    — the mixed model at 2**20 workers, 8 behaviours, 64
                dependent float rounds a body, every tick carrying every
                behaviour id: 16 ticks fused and 16 plain; the processed
                count exact and `done`/`acc` equal bit for bit;
  7. nbody    — one all-pairs round at 1024 bodies with the fused kernel,
                against the NumPy oracle (`reference_accels`);
  8. profile  — kernels launched a tick and the device's busy share
                (torch.profiler) for ubench and mixed, fused off and on.

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


def cuda_ms(fn, reps, inputs):
    """Mean ms per call over `reps` calls, cycling through `inputs`
    (sets whose total exceeds the 50 MB L2, so each call reads its
    operands from device memory), timed with CUDA events after warm-up."""
    import torch
    for i in range(3):
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


def device_ms(fn, reps, inputs, match=None):
    """Device time per call (ms): the summed time, from torch.profiler, of
    what the calls ran on the card (kernels, memsets), over `reps` calls
    after warm-up; `match` keeps only kernels whose name contains it.
    Unlike cuda_ms it leaves out the host's enqueue time, which for a
    call that launches little can exceed the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprof
    for i in range(3):
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


def ubench_opts(fused, ticks=64):
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=4, batch=4, max_sends=1, msg_words=1,
                          spill_cap=1024, inject_slots=8,
                          quiesce_interval=ticks, tuning_cache="off",
                          pallas_fused=fused)


def ring_opts(fused):
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=8, batch=1, max_sends=1, msg_words=1,
                          tuning_cache="off", pallas_fused=fused)


def mixed_opts(fused, ticks=16):
    # profiling/_hetero.py's options (cap 4, batch 1, one send of one word)
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=4, batch=1, max_sends=1, msg_words=1,
                          spill_cap=256, inject_slots=8,
                          quiesce_interval=ticks, tuning_cache="off",
                          pallas_fused=fused)


def nbody_opts(fused):
    # ponyc_tpu/models/nbody.py's defaults
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=16, batch=4, max_sends=1, msg_words=4,
                          spill_cap=1024, tuning_cache="off",
                          pallas_fused=fused)


def corpus_opts():
    from ponyc_tpu_torch import RuntimeOptions
    return RuntimeOptions(mailbox_cap=8, batch=4, max_sends=2, msg_words=2,
                          tuning_cache="off", pallas_fused=True)


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
    from ponyc_tpu_torch.models import nbody, ring, ubench
    tp, _T = programs()
    cases = [("ubench", [ubench.Pinger], ubench_opts(True), 1 << 20),
             ("mixed", [mixed_type()], mixed_opts(True), 1 << 20),
             ("nbody", [nbody.Body], nbody_opts(True), 1024),
             ("ring", [ring.RingNode], ring_opts(True), 1024)]
    # Each program below gets actor types of its own: a behaviour's
    # global id belongs to its definition and is set by the last program
    # that declared it, and the plain version reads it when it runs.
    for n in (1, 257, 1000):
        T = tp.define(ponyc_tpu_torch)
        cases.append((f"corpus N={n}", [T.Mixer, T.TriF, T.Yielder,
                                         T.Exiter, T.Ephemeral, T.Errs,
                                         T.Arith], corpus_opts(), n))
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
    from ponyc_tpu_torch.ops import fused_dispatch as fdm
    from ponyc_tpu_torch.program import Program
    prog = Program(opts)
    for t in types:
        prog.declare(t, lanes)
    prog.finalize()
    return [fdm.build_fused_dispatch(prog.by_type[t], opts) for t in types]


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
    _build.build([_build.Job("drain")] + [fd.job() for fd in unique],
                 log=logs.append)
    for text in logs:
        head, _, body = text.partition("\n")
        print(head, flush=True)
        for line in body.splitlines():
            if re.search(r"registers|spill", line):
                print("   ", line.strip(), flush=True)
    fdm.compile_all(every)
    print(f"built drain + {len(unique)} fused kernels in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(_build.FUSED_FLAGS)}; the drain without -fmad=false)",
          flush=True)
    return True


def _leaves(x, name="out"):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{name}.{k}")
    elif isinstance(x, tuple):
        names = getattr(x, "_fields", None) or range(len(x))
        for k, v in zip(names, x):
            yield from _leaves(v, f"{name}.{k}")
    else:
        yield name, x


FUSED_OUT = ("fields", "outbox", "head", "any_exit", "exit_code", "nproc",
             "nbad", "destroy", "errors")


def compare_fused(a, b, label):
    """Every output of the fused kernel (a) against its plain version
    (b), bit for bit (floats compared as their bits). Returns (max abs
    error, max ulp distance, outputs compared); raises on a difference."""
    import torch
    max_err, max_ulp, n = 0.0, 0, 0
    a = dict(zip(FUSED_OUT, a))
    b = dict(zip(FUSED_OUT, b))
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
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
            raise AssertionError(f"{label}: fused kernel differs from its "
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
    fields, buf, head, n_run, ids = inputs
    rows = fd.rows
    consumed = ((out[2].long() - head.long()) & 0xffffffff)
    fbytes = sum(t.numel() * t.element_size() for t in fields.values())
    read = fbytes + 3 * 4 * rows + int(consumed.sum()) * fd.w1_in * 4
    e = fd.batch * fd.ms * rows
    write = (fbytes + 4 * e + 4 * fd.w1 * e + 4 * rows
             + (rows if fd.destroy else 0) + (9 * rows if fd.error else 0))
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
            print(f"fused {label} {fd.name} ({fd.rows} lanes, cap "
                  f"{fd.cap}, w1_in {fd.w1_in}, w1 {fd.w1}, batch "
                  f"{fd.batch}, ms {fd.ms}, {len(fd.progs)} behaviours): "
                  f"{nout} outputs bit-equal (nproc {int(want[5])}, nbad "
                  f"{int(want[6])}, exit {bool(want[3])})", flush=True)
    times = {}
    for label in ("ubench", "mixed"):
        fd = _CACHE["fused"][label][0]
        sets = [fd.sample_inputs(seed=100 + s, device="cuda", steady=True)
                for s in range(3)]
        reps = 3 if label == "mixed" else 10
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
                **times["ubench"], mixed=times["mixed"])
    return True


def _world_numbers(rt, atype):
    cs = rt.cohort_state(atype)
    return ({k: v.tolist() for k, v in cs.items()},
            {c: rt.counter(c) for c in ("n_processed", "n_delivered",
                                        "n_rejected", "n_mutes",
                                        "n_deadletter")},
            rt.exit_code, rt.steps_run)


@phase("agree")
def agree_small_worlds():
    from ponyc_tpu_torch import RuntimeOptions
    from ponyc_tpu_torch.models import ring, ubench
    import ponyc_tpu_torch
    tp, T = programs()

    def walkers(device, fused):
        rt = tp.build_walkers(ponyc_tpu_torch, T, 7, n_seeds=30,
                              device=device, pallas_fused=fused,
                              **WALKERS_KW)
        rt.run(max_steps=100_000)
        return (_world_numbers(rt, T.Walker)
                + _world_numbers(rt, T.Splitter)[:1])

    def rings(device, fused):
        rt = ring.run(128, 300, opts=RuntimeOptions(
            mailbox_cap=8, batch=1, max_sends=1, msg_words=1,
            spill_cap=128, inject_slots=8, tuning_cache="off",
            pallas_fused=fused), device=device)
        return _world_numbers(rt, ring.RingNode)

    def pingers(device, fused):
        rt, ids = ubench.build(256, RuntimeOptions(
            mailbox_cap=4, batch=4, max_sends=1, msg_words=1,
            spill_cap=64, inject_slots=8, tuning_cache="off",
            pallas_fused=fused), pings=4, device=device)
        ubench.seed_all(rt, ids, hops=25, pings=4)
        rt.run()
        return _world_numbers(rt, ubench.Pinger)

    def mixers(device, fused):
        rt = tp.build_mixers(ponyc_tpu_torch, T, 5, device=device,
                             pallas_fused=fused, **MIXERS_KW)
        rt.run(max_steps=100_000)
        return (_world_numbers(rt, T.Mixer)
                + (rt.state.last_error.tolist(),))

    def corpus(name):
        return lambda device, fused: tp.run_corpus(
            ponyc_tpu_torch, T, name, device=device, pallas_fused=fused)

    worlds = [("walkers (spill/mute)", walkers), ("ring", rings),
              ("ubench", pingers), ("mixers (every effect)", mixers)]
    worlds += [(f"corpus {n}", corpus(n)) for n in tp.CORPUS]
    for fused in (False, True):
        for name, fn in worlds:
            g, c = fn("cuda", fused), fn("cpu", fused)
            if g != c:
                raise AssertionError(f"{name} (pallas_fused={fused}): the "
                                     f"card and the CPU disagree: {g} vs "
                                     f"{c}")
            print(f"{name} pallas_fused={fused}: card == CPU", flush=True)


def ubench_windows(fused, n, pings, warm, ticks):
    """Three timed windows of `ticks` ticks of ubench; checks the
    processed count and that the path's kernel launched once a tick."""
    import torch
    from ponyc_tpu_torch.models import ubench
    from ponyc_tpu_torch.ops import mailbox_kernel as mk
    from ponyc_tpu_torch.ops.fused_dispatch import FusedDispatch
    t0 = time.perf_counter()
    rt, ids = ubench.build(n, ubench_opts(fused, ticks), pings=pings)
    ubench.seed_all(rt, ids, hops=1 << 30, pings=pings)
    torch.cuda.synchronize()
    print(f"ubench pallas_fused={fused} build+seed "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rt.run(max_steps=warm)
    per_tick = []
    for _ in range(3):
        p0, s0 = rt.counter("n_processed"), rt.steps_run
        q0 = rt.ticks_enqueued
        torch.cuda.synchronize()
        mk.drain_msgs.launches = 0      # the main path's run starts here
        FusedDispatch.launches = 0
        t0 = time.perf_counter()
        rt.run(max_steps=ticks)
        elapsed = time.perf_counter() - t0
        drains = mk.drain_msgs.launches     # ... and ends here
        fuseds = FusedDispatch.launches
        done = rt.counter("n_processed") - p0
        ran, enqueued = rt.steps_run - s0, rt.ticks_enqueued - q0
        if done != n * pings * ticks or ran != ticks:
            raise AssertionError(f"processed {done} in {ran} ticks, "
                                 f"expected {n * pings * ticks} in {ticks}")
        want = (0, ticks) if fused else (ticks, 0)
        if (drains, fuseds) != want or enqueued != ticks:
            raise AssertionError(f"drain launched {drains}, fused "
                                 f"{fuseds} times for {enqueued} ticks "
                                 f"enqueued, {ticks} run (one cohort: "
                                 f"expected {want})")
        if rt.counter("n_rejected") or rt.exit_code:
            raise AssertionError("ubench rejected messages or exited")
        per_tick.append(elapsed / ticks)
        print(f"ubench N={n} pings={pings} pallas_fused={fused}: {ticks} "
              f"ticks in {elapsed:.3f} s = {1e3 * elapsed / ticks:.3f} "
              f"ms/tick, {n * pings / (elapsed / ticks):.4g} msgs/s; "
              f"processed counter ok; launches: drain {drains}, fused "
              f"{fuseds}", flush=True)
    p50 = statistics.median(per_tick)
    print(f"ubench pallas_fused={fused} median of {len(per_tick)} windows: "
          f"{1e3 * p50:.3f} ms/tick, {n * pings / p50:.4g} msgs/s (spread "
          f"{1e3 * min(per_tick):.3f}-{1e3 * max(per_tick):.3f} ms/tick)",
          flush=True)
    del rt
    torch.cuda.empty_cache()
    return (drains if not fused else fuseds), {
        "msgs_per_s": n * pings / p50, "s_per_tick": p50,
        "s_per_tick_each": per_tick}


@phase("ubench")
def run_ubench(rec, frec):
    n, pings, warm, ticks = 1 << 20, 4, 8, 64
    rec["launches"], plain = ubench_windows(False, n, pings, warm, ticks)
    frec["launches"], fused = ubench_windows(True, n, pings, warm, ticks)
    return {"plain": plain, "fused": fused}


@phase("ring")
def run_ring(rec, frec, hops=4096):
    import torch
    from ponyc_tpu_torch.models import ring
    from ponyc_tpu_torch.ops import mailbox_kernel as mk
    from ponyc_tpu_torch.ops.fused_dispatch import FusedDispatch
    nodes = 1024
    out = {}
    for fused in (False, True):
        opts = ring_opts(fused)
        ring.run(nodes, 64, opts=opts)                    # warm-up
        per_hop = []
        for _ in range(3):
            rt, ids = ring.build(nodes, opts)
            rt.send(int(ids[0]), ring.RingNode.token, hops)
            torch.cuda.synchronize()
            q0 = rt.ticks_enqueued
            mk.drain_msgs.launches = 0      # the main path's run starts
            FusedDispatch.launches = 0
            t0 = time.perf_counter()
            code = rt.run()
            elapsed = time.perf_counter() - t0
            drains = mk.drain_msgs.launches     # ... and ends here
            fuseds = FusedDispatch.launches
            enqueued = rt.ticks_enqueued - q0
            passes = int(rt.cohort_state(ring.RingNode)["passes"].sum())
            if passes != hops or code != 0:
                raise AssertionError(f"ring: passes {passes} (want {hops}),"
                                     f" exit code {code}")
            # One cohort: one launch of the path's kernel per enqueued
            # tick, run or not. A tick predicated off on the device still
            # launches its kernels; the host enqueues such ticks until its
            # non-blocking StopProbe sees the device's stop vote.
            want = (0, enqueued) if fused else (enqueued, 0)
            if (drains, fuseds) != want or rt.steps_run > enqueued:
                raise AssertionError(f"ring pallas_fused={fused}: drain "
                                     f"{drains}, fused {fuseds} launches "
                                     f"for {enqueued} ticks enqueued, "
                                     f"{rt.steps_run} run")
            per_hop.append(elapsed / hops)
            print(f"ring {nodes} nodes {hops} hops pallas_fused={fused}: "
                  f"{elapsed:.3f} s, {1e6 * elapsed / hops:.1f} us/hop, "
                  f"{rt.steps_run} ticks run, {enqueued} enqueued "
                  f"({enqueued - rt.steps_run} predicated off), launches: "
                  f"drain {drains}, fused {fuseds}", flush=True)
            (frec if fused else rec)["launches_ring"] = (
                fuseds if fused else drains)
        p50 = statistics.median(per_hop)
        print(f"ring pallas_fused={fused} p50 per-hop time "
              f"{1e6 * p50:.1f} us over {len(per_hop)} runs", flush=True)
        out["fused" if fused else "plain"] = p50
    return out


@phase("mixed")
def run_mixed(frec, ticks=16):
    import torch
    from ponyc_tpu_torch.models import mixed
    from ponyc_tpu_torch.ops import mailbox_kernel as mk
    from ponyc_tpu_torch.ops.fused_dispatch import FusedDispatch
    n = 1 << 20
    res, out = {}, {}
    for fused in (True, False):
        t0 = time.perf_counter()
        rt, ids, wt = mixed.build(n, MIXED_B, mixed_opts(fused, ticks),
                                  work=MIXED_WORK)
        mixed.seed_all(rt, ids, wt, hops=1 << 30, mix=True)
        rt.run(max_steps=1)                               # warm-up
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        p0 = rt.counter("n_processed")
        mk.drain_msgs.launches = 0          # the main path's run starts
        FusedDispatch.launches = 0
        t0 = time.perf_counter()
        rt.run(max_steps=ticks)
        elapsed = time.perf_counter() - t0
        drains, fuseds = mk.drain_msgs.launches, FusedDispatch.launches
        done = rt.counter("n_processed") - p0
        if done != n * ticks or rt.steps_run != ticks + 1:
            raise AssertionError(f"mixed pallas_fused={fused}: processed "
                                 f"{done} in {rt.steps_run - 1} ticks, "
                                 f"expected {n * ticks} in {ticks}")
        want = (0, ticks) if fused else (ticks, 0)
        if (drains, fuseds) != want:
            raise AssertionError(f"mixed pallas_fused={fused}: drain "
                                 f"{drains}, fused {fuseds} launches for "
                                 f"{ticks} ticks")
        st = rt.cohort_state(wt)
        res[fused] = (st["done"], st["acc"])
        out["fused" if fused else "plain"] = elapsed / ticks
        print(f"mixed N={n} B={MIXED_B} work={MIXED_WORK} pallas_fused="
              f"{fused}: {ticks} ticks in {elapsed:.3f} s = "
              f"{1e3 * elapsed / ticks:.3f} ms/tick (setup {setup:.1f} s); "
              f"processed counter ok; launches: drain {drains}, fused "
              f"{fuseds}", flush=True)
        if fused:
            frec["launches_mixed"] = fuseds
        del rt
        torch.cuda.empty_cache()
    import numpy as np
    if not (np.array_equal(res[True][0], res[False][0])
            and np.array_equal(res[True][1].view(np.int32),
                               res[False][1].view(np.int32))):
        raise AssertionError("mixed: done/acc differ between the fused "
                             "kernel and the plain dispatch")
    print("mixed: done and acc bit-equal between fused and plain "
          f"(acc mean {float(res[True][1].mean()):.6g})", flush=True)
    return out


@phase("nbody")
def run_nbody(frec, bodies=1024):
    import numpy as np
    import torch
    from ponyc_tpu_torch.models import nbody
    from ponyc_tpu_torch.ops.fused_dispatch import FusedDispatch
    FusedDispatch.launches = 0              # the main path's run starts
    t0 = time.perf_counter()
    rt = nbody.run_round(bodies, nbody_opts(True))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    frec["launches_nbody"] = FusedDispatch.launches     # ... and ends
    st = rt.cohort_state(nbody.Body)
    if not (st["seen"] == bodies - 1).all():
        raise AssertionError(f"nbody: seen {st['seen'].min()}.."
                             f"{st['seen'].max()}, want {bodies - 1}")
    f64 = [st[k].astype(np.float64) for k in ("x", "y", "m")]
    ax, ay = nbody.reference_accels(*f64)
    # float32 sums of 1023 terms against a float64 oracle: the tolerance
    # scales with the largest acceleration.
    tol = 1e-4 * max(np.abs(ax).max(), np.abs(ay).max())
    err = max(np.abs(st["ax"] - ax).max(), np.abs(st["ay"] - ay).max())
    if not err <= tol:
        raise AssertionError(f"nbody: max |a - oracle| {err:.3g} > {tol:.3g}")
    print(f"nbody {bodies} bodies, one round in {rt.steps_run} ticks, "
          f"{elapsed:.2f} s with setup; fused launches "
          f"{frec['launches_nbody']}; max |a - oracle| {err:.3g} <= "
          f"{tol:.3g} (1e-4 of the largest |a|, float64 oracle)",
          flush=True)
    return {"max_abs_err": float(err), "tol": float(tol),
            "ticks": rt.steps_run}


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_ticks(label, rt, ticks):
    """Kernels launched a tick and the device's busy share over `ticks`
    ticks under torch.profiler (its wall is inflated by the profiler; the
    device times and counts are what this reads)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprof
    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.run(max_steps=ticks)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = launches = 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            busy += us
            launches += evt.count
    out = {"kernels_per_tick": launches / ticks,
           "device_busy_ms_per_tick": busy / ticks / 1e3,
           "busy_share": busy / wall_us,
           "profiled_wall_ms_per_tick": wall_us / ticks / 1e3}
    print(f"profile {label}: {launches / ticks:.0f} kernels a tick, device "
          f"busy {busy / ticks / 1e3:.3f} ms a tick = "
          f"{100 * busy / wall_us:.1f}% of the profiled wall "
          f"({wall_us / ticks / 1e3:.3f} ms a tick)", flush=True)
    return out


@phase("profile")
def run_profile(ticks=4):
    import torch
    from ponyc_tpu_torch.models import mixed, ubench
    out = {}
    for fused in (False, True):
        rt, ids = ubench.build(1 << 20, ubench_opts(fused, ticks), pings=4)
        ubench.seed_all(rt, ids, hops=1 << 30, pings=4)
        rt.run(max_steps=ticks)                           # warm-up
        out[f"ubench fused={fused}"] = profile_ticks(
            f"ubench 2^20x4 pallas_fused={fused}", rt, ticks)
        del rt
        rt, ids, wt = mixed.build(1 << 20, MIXED_B, mixed_opts(fused, ticks),
                                  work=MIXED_WORK)
        mixed.seed_all(rt, ids, wt, hops=1 << 30, mix=True)
        rt.run(max_steps=2)                               # warm-up
        out[f"mixed fused={fused}"] = profile_ticks(
            f"mixed 2^20 B{MIXED_B} work{MIXED_WORK} pallas_fused={fused}",
            rt, ticks)
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
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()
    rec, frec, summary = {}, {}, {"card": card}

    def want(name):
        return only is None or name in only

    if build_kernels() is not None:
        if want("kernels"):
            check_kernels(rec, frec)
        if want("agree"):
            agree_small_worlds()
        if want("ubench"):
            summary["ubench"] = run_ubench(rec, frec)
        if want("ring"):
            summary["ring_p50_s_per_hop"] = run_ring(rec, frec)
        if want("mixed"):
            summary["mixed_s_per_tick"] = run_mixed(frec)
        if want("nbody"):
            summary["nbody"] = run_nbody(frec)
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
             "bit_equal", "max_ulp", "shapes", "mixed")
    kernels = [{k: r[k] for k in KEYS + extra if k in r}
               for r in (rec, frec)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

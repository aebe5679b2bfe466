"""The fused dispatch kernel (csrc/fused_dispatch.cu) on the card, cohort
by cohort: ptxas's resources, the machine code's hash and size, and the
kernel's device time at the main paths' shapes.

    python3 profiling/torch_fused.py [--root DIR] [--sass] [--sweep]
                                     [--tiles] [--dump DIR] [--reps R]

Builds the fused kernel of each cohort below (all nvcc builds started
together) and prints ptxas's registers, stack and spills for each:
ubench's Pinger (2^20 lanes, batch 4), the mixed model's Worker8 (2^20
lanes, 8 behaviours, 64 dependent float rounds a body) all-hot (message
ids uniform over the 8 behaviours) and one-hot (`hot=1`: every message
step0, so no warp holds two ids), the ring's RingNode (1,024), nbody's
Body (1,024) and the spawn tree's Node (2^22 lanes). Then it times each
at its shape on three seeded inputs whose every lane has a full batch
(torch.profiler's device time of the kernel alone, mean of `reps`
calls), beside the least time the card could take
(chip_smoke.fused_bound), and prints one JSON line with every number.

`--sweep` adds the mixed cohort at 0, 1, 2, 4, 8 and 16 float rounds a body
(all-hot), each built with and without the regrouping of a block's lanes
by message id (`build_fused_dispatch(..., regroup=)`; where the package
has no such argument, as before the regroup existed, only its own
build): the data behind the compile-time rule that chooses it.

`--tiles` adds mixed (all-hot and one-hot at 64 rounds, and all-hot at
0) regrouped at other tilings of the regroup (lanes a tile, threads a
block, blocks a multiprocessor: `fused_dispatch.TILE`, `TILE_THREADS`,
`BLOCKS_PER_SM`), the data behind the tiling chosen.

`--root DIR` imports ponyc_tpu_torch from another checkout (the parent
commit unpacked with `git archive`), so that two versions of the kernel
are compared in one call on one card: run parent, change, change,
parent. `--sass` prints, after the builds, the sha256 and the number of
lines of each cohort's kernel as `cuobjdump -sass` disassembles it (two
lines an instruction; equal hashes in two checkouts: the same machine
code), writes each disassembly into `--dump DIR` if given, and measures
nothing. Needs a CUDA device.
"""

import argparse
import hashlib
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


TILINGS = ((8192, 1024, 1), (4096, 1024, 1), (2048, 1024, 1),
           (2048, 512, 2), (1024, 256, 4), (4096, 1024, 2), (2048, 1024, 2))


def cohorts(cs, fdm, sweep, regroup_arg, tiles=False):
    """{label: FusedDispatch} of the cohorts above (and the sweep's)."""
    from ponyc_tpu_torch.models import mixed, ring, nbody, spawn_tree, ubench
    from ponyc_tpu_torch.program import Program
    from ponyc_tpu_torch.runtime.engine import spawn_meta_of

    def fused(atype, opts, rows, **kw):
        prog = Program(opts)
        prog.declare(atype, rows)
        prog.finalize()
        ch = prog.by_type[atype]
        return fdm.build_fused_dispatch(ch, opts, spawn_meta_of(prog, ch),
                                        **kw)

    mx = cs.mixed_opts(True)
    out = {"ubench": fused(ubench.Pinger, cs.ubench_opts(True), 1 << 20),
           "mixed": fused(mixed.make_worker_type(8, work=64), mx, 1 << 20),
           "mixed_onehot": fused(mixed.make_worker_type(8, hot=1, work=64),
                                 mx, 1 << 20),
           "ring": fused(ring.RingNode, cs.ring_opts(True), 1024),
           "nbody": fused(nbody.Body, cs.nbody_opts(True), 1024),
           "spawn_tree": fused(spawn_tree.Node, cs.spawn_opts(True),
                               4 << cs.SPAWN_DEPTH)}
    if regroup_arg:
        # Both spellings of the multi-behaviour cohorts, whatever the
        # compile-time rule chose.
        for label, atype, opts, rows in (
                ("mixed", mixed.make_worker_type(8, work=64), mx, 1 << 20),
                ("spawn_tree", spawn_tree.Node, cs.spawn_opts(True),
                 4 << cs.SPAWN_DEPTH)):
            for on in (True, False):
                out[f"{label} regroup={on}"] = fused(atype, opts, rows,
                                                     regroup=on)
    if sweep:
        for work in (0, 1, 2, 4, 8, 16):
            wt = mixed.make_worker_type(8, work=work)
            if regroup_arg:
                for on in (True, False):
                    out[f"mixed work={work} regroup={on}"] = fused(
                        wt, mx, 1 << 20, regroup=on)
            else:
                out[f"mixed work={work}"] = fused(wt, mx, 1 << 20)
    if tiles:
        chosen = fdm.TILE, fdm.TILE_THREADS, fdm.BLOCKS_PER_SM
        for tiling in TILINGS:
            fdm.TILE, fdm.TILE_THREADS, fdm.BLOCKS_PER_SM = tiling
            tag = "tile {} x {} threads x {} a multiprocessor".format(*tiling)
            for label, wt in (
                    ("mixed", mixed.make_worker_type(8, work=64)),
                    ("mixed_onehot",
                     mixed.make_worker_type(8, hot=1, work=64)),
                    ("mixed work=0", mixed.make_worker_type(8, work=0))):
                out[f"{label} {tag}"] = fused(wt, mx, 1 << 20,
                                              regroup=True)
        fdm.TILE, fdm.TILE_THREADS, fdm.BLOCKS_PER_SM = chosen
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_fused: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    import ponyc_tpu_torch
    from ponyc_tpu_torch.ops import _build
    from ponyc_tpu_torch.ops import fused_dispatch as fdm
    root = os.path.dirname(os.path.dirname(ponyc_tpu_torch.__file__))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"{smi.stdout.strip()}; ponyc_tpu_torch from {root}", flush=True)
    regroup_arg = "regroup" in inspect.signature(
        fdm.build_fused_dispatch).parameters
    fds = cohorts(cs, fdm, args.sweep, regroup_arg, args.tiles)
    logs = []
    jobs = [fd.job() for fd in fds.values()]
    built = [j.stem for j in {j.path: j for j in jobs}.values()
             if not os.path.exists(j.path)]             # one log each
    libs = _build.build(jobs, log=logs.append)
    for stem, text in zip(built, logs):
        head, _, body = text.partition("\n")
        print(f"{head} {stem}", flush=True)
        for line in body.splitlines():
            if re.search(r"registers|spill|stack", line):
                print("   ", line.strip(), flush=True)
    for label, fd in fds.items():
        print(f"{label}: {fd.name}, library {fd.job().stem}, "
              f"{len(fd.progs)} behaviours"
              + (f", regroup {fd.regroup}" if hasattr(fd, "regroup") else ""),
              flush=True)
    if args.sass:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
        for label, lib in zip(fds, libs):
            sass = subprocess.run([tool, "-sass", lib._name],
                                  capture_output=True, text=True,
                                  check=True).stdout
            code = [ln for ln in sass.splitlines() if "/*" in ln]
            if args.dump:
                name = re.sub(r"[^\w=]+", "_", label) + ".sass"
                with open(os.path.join(args.dump, name), "w") as f:
                    f.write(sass)
            print(f"sass {label}: sha256 "
                  f"{hashlib.sha256(chr(10).join(code).encode()).hexdigest()}"
                  f" ({len(code)} instruction lines)", flush=True)
        return 0
    fdm.compile_all(list(fds.values()))
    cs.gpu_warm()
    out = {}
    for label, fd in fds.items():
        sets = [fd.sample_inputs(seed=100 + s, device="cuda", steady=True)
                for s in range(3)]
        if "onehot" in label:         # every message names step0
            for s in sets:
                s[1][:, 0, :] = fd.base
        ms = cs.device_ms(fd, args.reps, sets, "pony_fused_kernel")
        got = fd(*sets[0])
        cs.compare_fused(got, fd.plain(*sets[0]), label)
        b_ms, b_by, nbytes, ops, t_b, t_o = cs.fused_bound(fd, sets[0], got)
        out[label] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                          bytes=nbytes, ops=ops)
        print(f"fused {label} ({fd.rows} lanes): kernel {ms:.4f} ms device "
              f"a call; bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} "
              f"MB, {ops:.4g} ATen ops); {100 * b_ms / ms:.1f}% of the "
              f"bound; bit-equal to the plain version", flush=True)
        del sets, got
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi.stdout.strip(), "root": root,
                      "fused": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The window kernel's per-phase clock on the card, world by world.

    python3 profiling/torch_mega_phases.py [--root DIR] [--worlds W,W,...]
                                           [--reps R]

Builds the window kernel (delivery="pallas_mega") of each world at the
full width chip_smoke.py uses, all nvcc builds started together, and
prints ptxas's registers, stack and spills for each; then per world runs
one 16-tick window to leave the seeded start, and `reps` more from that
state with `MegaWindow.clock` set, and prints one line of device µs a
tick by phase (`megakernel.phase_table`, %globaltimer stamps after each
grid sync), then one JSON line with every world's table. Worlds: ubench
(2^20 pingers, pings 4), mixed (2^20 workers, 8 behaviours, 64 float
rounds), ring (1024 nodes), nbody (1024 bodies) and spawn (the spawn tree
at depth 20, 2^22 rows; only where the package has models/spawn_tree.py).

`--root DIR` imports ponyc_tpu_torch from another checkout (for example
the parent commit unpacked with `git archive`), so two versions of the
kernel can be compared in one call on one card: run parent, change,
change, parent. `--sass` prints, after the builds, the sha256 of each
world's kernel as `cuobjdump -sass` disassembles it (equal hashes in two
checkouts: the same machine code) and measures nothing. Needs a CUDA
device.
"""

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

T = 16                   # ticks a window


def worlds(names):
    """{name: (actor type, rows, options, build() → a started, seeded
    Runtime)}."""
    import numpy as np
    from ponyc_tpu_torch import RuntimeOptions
    from ponyc_tpu_torch.models import mixed, nbody, ring, ubench

    def opts(**kw):
        return RuntimeOptions(tuning_cache="off", delivery="pallas_mega",
                              pallas_fused=False, quiesce_interval=T, **kw)

    o_ub = opts(mailbox_cap=4, batch=4, max_sends=1, msg_words=1,
                spill_cap=1024, inject_slots=8)
    o_mx = opts(mailbox_cap=4, batch=1, max_sends=1, msg_words=1,
                spill_cap=256, inject_slots=8)
    o_rg = opts(mailbox_cap=8, batch=1, max_sends=1, msg_words=1)
    o_nb = opts(mailbox_cap=16, batch=4, max_sends=1, msg_words=4,
                spill_cap=1024)
    wt = mixed.make_worker_type(8, work=64)

    def pingers():
        rt, ids = ubench.build(1 << 20, o_ub, pings=4)
        ubench.seed_all(rt, ids, hops=1 << 30, pings=4)
        return rt

    def workers():
        rt, ids, w = mixed.build(1 << 20, 8, o_mx, work=64)
        mixed.seed_all(rt, ids, w, hops=1 << 30, mix=True)
        return rt

    def nodes():
        rt, ids = ring.build(1024, o_rg)
        rt.send(int(ids[0]), ring.RingNode.token, 4096)
        return rt

    def bodies():
        rt, ids = nbody.build(1024, o_nb)
        st = rt.cohort_state(nbody.Body)
        rt.bulk_send(np.roll(ids, -1), nbody.Body.token,
                     np.full(1024, 1023),
                     np.stack([st["x"], st["y"]], axis=1), st["m"])
        return rt

    table = {"ubench": (ubench.Pinger, 1 << 20, o_ub, pingers),
             "mixed": (wt, 1 << 20, o_mx, workers),
             "ring": (ring.RingNode, 1024, o_rg, nodes),
             "nbody": (nbody.Body, 1024, o_nb, bodies)}
    if "spawn" in names:
        from ponyc_tpu_torch.models import spawn_tree
        o_sp = spawn_tree.options(tuning_cache="off", delivery="pallas_mega",
                                  quiesce_interval=T)
        table["spawn"] = (spawn_tree.Node, 4 << 20, o_sp,
                          lambda: spawn_tree.build(20, o_sp)[0])
    return {n: table[n] for n in names}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--worlds", default="ubench,mixed,ring,nbody,spawn")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_mega_phases: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    import ponyc_tpu_torch
    from ponyc_tpu_torch.ops import _build, megakernel
    from ponyc_tpu_torch.runtime import engine
    root = os.path.dirname(os.path.dirname(ponyc_tpu_torch.__file__))
    names = [n for n in args.worlds.split(",")
             if n != "spawn" or os.path.exists(os.path.join(
                 root, "ponyc_tpu_torch", "models", "spawn_tree.py"))]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"{smi.stdout.strip()}; ponyc_tpu_torch from {root}", flush=True)
    specs = worlds(names)
    # Every world's kernel in one parallel build (the runtimes below then
    # find them built).
    from ponyc_tpu_torch.program import Program
    jobs = []
    for atype, rows, o, _ in specs.values():
        prog = Program(o)
        prog.declare(atype, rows)
        prog.finalize()
        jobs.append(engine.build_multi_step_gated(prog, o).job())
    logs = []
    libs = _build.build(jobs, log=logs.append)
    for text in logs:
        head, _, body = text.partition("\n")
        print(head, flush=True)
        for line in body.splitlines():
            if re.search(r"registers|spill|stack", line):
                print("   ", line.strip(), flush=True)
    if args.sass:
        import hashlib
        import shutil
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        for n, lib in zip(specs, libs):
            sass = subprocess.run([tool, "-sass", lib._name],
                                  capture_output=True, text=True,
                                  check=True).stdout
            code = [ln for ln in sass.splitlines() if "/*" in ln]
            print(f"sass {n}: sha256 "
                  f"{hashlib.sha256(chr(10).join(code).encode()).hexdigest()}"
                  f" ({len(code)} instruction lines)", flush=True)
        return 0
    out = {}
    zero = engine.zero_aux("cuda")
    for n in names:
        rt = specs[n][3]()
        mw = rt._multi_g
        it, iw, _ = rt._drain_inject_tracked()
        e_it, e_iw = rt._empty_inject
        st1 = mw(rt.state, it, iw, T, True, zero)[0]
        sums, ticks = {}, 0
        for _ in range(args.reps):
            clock = torch.zeros((T, megakernel.clock_slots(), 2),
                                dtype=torch.int64, device="cuda")
            mw.clock = clock
            res = mw(st1, e_it, e_iw, T, True, zero)
            mw.clock = None
            torch.cuda.synchronize()
            k = int(res[2])
            for name, v in megakernel.phase_table(clock, k).items():
                sums[name] = sums.get(name, 0.0) + v * k
            ticks += k
        tab = {name: v / ticks for name, v in sums.items()}
        out[n] = tab
        parts = ", ".join(f"{k} {v:.2f}" for k, v in tab.items()
                          if k != "tick")
        print(f"phases {n} (device us a tick, mean of {ticks} ticks in "
              f"{args.reps} windows): tick {tab['tick']:.2f} = {parts}; "
              f"grid {mw.info['grid']}", flush=True)
        del rt, st1, res
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi.stdout.strip(), "root": root,
                      "phases": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

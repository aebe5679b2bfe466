"""Wall time of the host's blob_store seeding of the blob chain world, on
the card.

    python3 profiling/torch_blob_seed.py [--root DIR] [--reps R]

Builds chip_smoke.py's blob chain world (2^19 walkers, a pool of 2^20 - 1
slots of 2 words, the plain path) `reps` times, and in each times the
2^14 `Runtime.blob_store` calls that seed its chains, one a chain, the
stream synchronised after the last. Prints the card, then one JSON line
with the seconds of each rep and their mean.

`--root DIR` imports ponyc_tpu_torch and chip_smoke.py from another
checkout (for example an earlier version unpacked with `git archive`),
so two versions of the host blob API can be compared in one call on one
card: run A, B, B, A. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_blob_seed: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    import numpy as np
    import ponyc_tpu_torch
    import chip_smoke as cs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"{smi.stdout.strip()}; ponyc_tpu_torch from "
          f"{os.path.dirname(os.path.dirname(ponyc_tpu_torch.__file__))}",
          flush=True)
    tp, T = cs.blob_programs()
    nxt, _starts, _lens, words, _acc = cs.blob_plan()
    n = len(nxt)
    secs = []
    for _ in range(args.reps):
        rt = tp.new_runtime(ponyc_tpu_torch, cs.blob_kw(False), "cuda")
        rt.declare(T.BlobWalker, n).start()
        ids = rt.spawn_many(T.BlobWalker, n, acc=0)
        rt.set_fields(T.BlobWalker, ids, nxt=ids[nxt])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [rt.blob_store([int(w)]) for w in words]
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        assert len(set(hs)) == len(words) and rt.blobs_in_use == len(words)
        print(f"seeded {len(words)} blobs in {secs[-1]:.3f} s", flush=True)
        del rt, ids, hs
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi.stdout.strip(), "root": root,
                      "blobs": len(words), "seconds": secs,
                      "mean_s": float(np.mean(secs))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

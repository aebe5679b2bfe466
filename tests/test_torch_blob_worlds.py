"""Whole blob worlds in the port against the JAX package, on the plain
tick: the blob chain of tests/test_differential.py (`run_blob_chain`,
("plan", 1, 0)) over a few seeds, where every hop reads, frees and
re-allocates its token blob; the `records` model against the JAX
package's model and its NumPy oracle; examples/blob_pipeline.py's
program (a frozen summary broadcast to two readers, the replicas swept
by gc()). Fields, counters, ticks and the pool's arrays must be equal:
integers, exact equality. The port runs on the CPU."""

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu_torch.models import records

from _torch_programs import (blob_world, define_blobs, run_blob_chain,
                             run_blob_pipeline)

JB, TB = define_blobs(ponyc_tpu), define_blobs(ponyc_tpu_torch)
PKGS = ((ponyc_tpu, JB), (ponyc_tpu_torch, TB))


def _both(scenario):
    """Run `scenario(pkg, T) -> value` on both packages; they must agree."""
    j, t = (scenario(pkg, T) for pkg, T in PKGS)
    assert t == j
    return t


@pytest.mark.parametrize("seed", [77, 5, 2026])
def test_blob_chain_matches_oracle(seed):
    """tests/test_differential.py's blob chain, ("plan", 1, 0): every hop
    reads, frees and re-allocates its token blob."""
    def go(pkg, T):
        rt = run_blob_chain(pkg, T, seed, dict(
            mailbox_cap=2, batch=1, max_sends=1, spill_cap=1024,
            inject_slots=16), n=16)
        return blob_world(rt, T.BlobWalker)
    assert _both(go)["counters"]["n_blob_alloc"] > 0


def test_records_model_oracle():
    """The port's models/records.py (its own oracle inside run_records)
    against the JAX package's model on the same options."""
    from ponyc_tpu.models import records as jrecords
    jrt, jst = jrecords.run_records(n_sources=8, n_records=6)
    trt, tst = records.run_records(n_sources=8, n_records=6, device="cpu")
    assert tst == jst and tst["n"] == 48
    for name in ("n_blob_alloc", "n_blob_free", "n_processed"):
        assert trt.counter(name) == jrt.counter(name)
    assert trt.steps_run == jrt.steps_run and trt.blobs_in_use == 0
    for f in ("blob_data", "blob_used", "blob_len", "blob_gen"):
        assert np.array_equal(getattr(trt.state, f).numpy(),
                              np.asarray(getattr(jrt.state, f)))


def test_blob_pipeline_program():
    """examples/blob_pipeline.py's program: a val broadcast to two
    readers, the replicas swept by gc()."""
    def go(pkg, T):
        rt, (r1, r2), before = run_blob_pipeline(pkg, T)
        return (rt.state_of(r1), rt.state_of(r2), before, rt.blobs_in_use,
                blob_world(rt, T.Tokenizer, T.Reviewer))
    s1, s2, before, after, _ = _both(go)
    assert s1 == s2 and s1["n"] == 3 and before == 3 and after == 0

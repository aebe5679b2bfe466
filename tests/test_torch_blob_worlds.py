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
                             run_blob_fifo, run_blob_pipeline)

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


PLAN = ("plan_key", "plan_perm", "plan_bounds")


def _cosort_world(rt, *atypes):
    out = blob_world(rt, *atypes)
    out["plan"] = {f: np.asarray(getattr(rt.state, f)).tolist()
                   for f in PLAN}
    return out


@pytest.mark.parametrize("path", [{}, dict(pallas_fused=True)],
                         ids=["plain", "fused"])
@pytest.mark.parametrize("world", ["chain", "fifo"])
def test_blob_worlds_under_cosort_match_jax(world, path):
    """tests/test_differential.py's blob chain ("cosort", 1, 0) and
    tests/test_fifo.py's blob payload binding ("cosort"): every hop's
    blob and every stamp's binding, fields, counters, ticks, the pool
    and the carried plan state (cosort's placeholders) equal to the JAX
    package's cosort run, on the plain tick and under pallas_fused (a
    blob cohort takes the plain dispatch there)."""
    def go(pkg, T):
        kw = path if pkg is ponyc_tpu_torch else {}
        if world == "chain":
            rt = run_blob_chain(pkg, T, 77, dict(
                mailbox_cap=2, batch=1, max_sends=1, spill_cap=1024,
                inject_slots=16, delivery="cosort", **kw), n=16)
            return _cosort_world(rt, T.BlobWalker)
        rt = run_blob_fifo(pkg, T, 11, dict(
            mailbox_cap=4, batch=2, max_sends=2, spill_cap=2048,
            inject_slots=16, delivery="cosort", **kw))
        return _cosort_world(rt, T.BlobProd, T.BlobCons)
    got = _both(go)
    assert got["counters"]["n_blob_alloc"] > 0
    assert got["plan"]["plan_perm"] == list(range(len(
        got["plan"]["plan_perm"])))


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

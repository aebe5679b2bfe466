"""The formulation tuner of the PyTorch port (ponyc_tpu_torch/tuning.py),
the cases of tests/test_tuning.py held against the JAX package's tuner.

- "auto" never changes semantics, only speed: a seeded ubench run under
  delivery="auto" (and pallas_fused="auto") gives exactly the totals and
  per-actor columns of the fixed formulations, and of the JAX package;
- the decision is a deterministic function of the timing table (minimum
  ms a tick, ties to the earlier variant, failed variants never win), the
  same function as the JAX package's;
- the variants are the JAX package's, less the "+pallas" ones: the port
  has one drain, so pallas="auto" resolves to False unmeasured;
- the on-disk cache hits on an identical key, misses on a different one,
  and a corrupt file recalibrates; a cached start calibrates nothing;
- calibration never writes the runtime's state, and a variant that fails
  to build or run fails start(), naming it.

The port runs on the CPU (`device="cpu"`); every compared value is an
integer or a variant name: the tolerance is exact equality. Every test
keeps the cache off or in `tmp_path`.
"""

import json

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu import tuning as jtuning
from ponyc_tpu.models import ubench as jubench
from ponyc_tpu_torch import tuning as ttuning
from ponyc_tpu_torch.models import ubench as tubench
from ponyc_tpu_torch.runtime import engine as tengine

UB = dict(mailbox_cap=4, batch=4, max_sends=1, msg_words=1, spill_cap=64,
          inject_slots=8, tuning_cache="off", tuning_ticks=2,
          tuning_repeats=1)


def _opts(pkg, **kw):
    return pkg.RuntimeOptions(**{**UB, **kw})


def _runtime(pkg, **kw):
    if pkg is ponyc_tpu_torch:
        return pkg.Runtime(_opts(pkg, **kw), device="cpu")
    return pkg.Runtime(_opts(pkg, compile_cache="off", **kw))


def _program(pkg, atype, n=8, **kw):
    rt = _runtime(pkg, **kw)
    rt.declare(atype, n)
    rt.program.finalize()
    return rt


def _run_ubench(delivery, n=64, pings=2, ticks=5, **kw):
    """The port's ubench, `ticks` ticks of its real step."""
    rt, ids = tubench.build(n, _opts(ponyc_tpu_torch, delivery=delivery,
                                     **kw), pings=pings, device="cpu")
    tubench.seed_all(rt, ids, hops=1 << 30, pings=pings)
    step = tengine.build_step(rt.program, rt.opts)
    st, inj = rt.state, rt._empty_inject
    for _ in range(ticks):
        st, _aux = step(st, *inj)
    rt.state = st
    return rt, {"processed": rt.counter("n_processed"),
                "delivered": rt.counter("n_delivered"),
                "pings": rt.cohort_state(tubench.Pinger)["pings"]}


@pytest.fixture(scope="module")
def jax_plan():
    """The JAX package's ubench under delivery="plan" (its tests prove
    "auto" and "cosort" equal to it)."""
    rt, ids = jubench.build(64, _opts(ponyc_tpu, delivery="plan",
                                      compile_cache="off"), pings=2)
    jubench.seed_all(rt, ids, hops=1 << 30, pings=2)
    st, inj = rt.state, rt._empty_inject
    for _ in range(5):
        st, _aux = rt._step(st, *inj)
    rt.state = st
    return {"processed": rt.counter("n_processed"),
            "delivered": rt.counter("n_delivered"),
            "pings": np.asarray(rt.cohort_state(jubench.Pinger)["pings"])}


# ---------------------------------------------------------------------------
# decision function


DECIDE_CASES = [
    ({"plan": 2.0, "cosort": 1.0}, None, "cosort"),
    ({"plan": 0.5, "cosort": 1.0}, None, "plan"),
    ({"plan": 1.0, "cosort": 1.0}, None, "plan"),
    ({"plan": 1.0, "plan+fused": 1.0, "cosort": 1.0}, None, "plan"),
    ({"plan": 3.0, "cosort": None}, None, "plan"),
    ({"plan": None, "cosort": 2.0}, None, "cosort"),
    ({"plan": None, "cosort": None}, None, None),
    ({"plan": 2.0, "cosort": 1.0, "pallas_mega": 1.0},
     ["pallas_mega", "plan", "cosort"], "pallas_mega"),
]


@pytest.mark.parametrize("table,order,want", DECIDE_CASES)
def test_decide_picks_minimum_ties_to_baseline(table, order, want):
    """Minimum wins; a dead heat goes to the earlier (baseline) entry;
    a failed (None) variant never wins; as in the JAX package."""
    assert ttuning.decide(table, order) == want
    assert jtuning.decide(table, order) == want


def test_decide_is_deterministic_given_injected_timings():
    table = {"plan": 1.7, "cosort": 1.1, "plan+pallas": None,
             "cosort+pallas": 1.1000001}
    for _ in range(5):
        assert ttuning.decide(table) == "cosort" == jtuning.decide(table)


# ---------------------------------------------------------------------------
# variant enumeration


def _variants_both(atype_of, n=8, mega=False, monkeypatch=None, **kw):
    """(port variants, JAX variants less "+pallas") of one program."""
    if mega:
        monkeypatch.setenv("PONY_TPU_MEGA_AUTO", "1")
    trt = _program(ponyc_tpu_torch, atype_of(ponyc_tpu_torch), n, **kw)
    jrt = _program(ponyc_tpu, atype_of(ponyc_tpu), n, **kw)
    tv = ttuning.variants(trt.program, trt.opts, "cpu")
    jv = [(name, ov) for name, ov in jtuning.variants(jrt.program, jrt.opts)
          if "+pallas" not in name]
    return tv, jv


def _pinger(pkg):
    return (tubench if pkg is ponyc_tpu_torch else jubench).Pinger


def test_variants_fixed_delivery_is_single():
    tv, jv = _variants_both(_pinger, delivery="plan")
    assert tv == jv == [("plan", {"delivery": "plan", "pallas": False,
                                  "pallas_fused": False})]


def test_variants_auto_delivery_baseline_first():
    tv, jv = _variants_both(_pinger, delivery="auto")
    assert [n for n, _ in tv] == [n for n, _ in jv] == ["plan", "cosort"]


def test_variants_auto_enumerates_megakernel_when_gated_on(monkeypatch):
    """With PONY_TPU_MEGA_AUTO=1 (on CUDA always) delivery="auto" races
    the window kernel too, as a pure delivery variant."""
    tv, jv = _variants_both(_pinger, mega=True, monkeypatch=monkeypatch,
                            delivery="auto")
    assert tv == jv
    assert [n for n, _ in tv] == ["plan", "cosort", "pallas_mega"]
    assert dict(tv)["pallas_mega"] == {"delivery": "pallas_mega",
                                      "pallas": False,
                                      "pallas_fused": False}


def test_variants_all_auto_are_the_reference_less_pallas(monkeypatch):
    """Every field "auto": the JAX package races plan/cosort x pallas x
    fused (+ pallas_mega); the port's list is that list with the
    "+pallas" variants removed, in the same order."""
    tv, jv = _variants_both(_pinger, mega=True, monkeypatch=monkeypatch,
                            delivery="auto", pallas="auto",
                            pallas_fused="auto")
    assert tv == jv
    assert [n for n, _ in tv] == ["plan", "cosort", "pallas_mega",
                                  "plan+fused", "cosort+fused"]


def test_tuning_key_version_pinned_v1():
    """The port's formulation key has its own version (v1), apart from
    the quiesce window's key; bump it when the variant space changes."""
    rt = _program(ponyc_tpu_torch, tubench.Pinger, delivery="auto")
    key = ttuning.tuning_key(rt.program, rt.opts, "cpu")
    assert key["v"] == 1 and key["field"] == "formulation"
    assert key["platform"] == "cpu" and key["csrc"] == ttuning.csrc_hash()
    qkey = ttuning.quiesce_key(rt.program, rt.opts, "cpu")
    assert qkey["field"] == "quiesce_interval"
    assert ttuning.cache_path("d", key) != ttuning.cache_path("d", qkey)


def _blob_user(pkg):
    @pkg.actor
    class BlobUser:
        n: pkg.I32
        MAX_BLOBS = 1

        @pkg.behaviour
        def grab(self, st):
            self.blob_alloc(length=1)
            return st

    return BlobUser


def test_variants_fused_auto_skips_ineligible_programs():
    # A blob-pool cohort is ineligible for the fused kernel; with every
    # cohort ineligible, pallas_fused="auto" enumerates no variant that
    # would run the plain dispatch anyway.
    tv, jv = _variants_both(_blob_user, delivery="plan",
                            pallas_fused="auto", msg_words=2, blob_slots=8,
                            blob_words=4)
    assert [n for n, _ in tv] == [n for n, _ in jv] == ["plan"]


# ---------------------------------------------------------------------------
# "auto" never changes semantics


def test_auto_matches_forced_variants_and_jax(jax_plan):
    _, plan = _run_ubench("plan")
    _, cosort = _run_ubench("cosort")
    _, auto = _run_ubench("auto", pallas_fused="auto")
    for got in (plan, cosort, auto):
        assert got["processed"] == jax_plan["processed"]
        assert got["delivered"] == jax_plan["delivered"]
        np.testing.assert_array_equal(got["pings"], jax_plan["pings"])


def test_auto_resolves_to_concrete_opts():
    rt, _ = _run_ubench("auto")
    assert rt.opts.delivery in ("plan", "cosort")
    rec = rt.tuning_record
    assert rec["source"] == "calibrated"           # cache is off here
    assert set(rec["table"]) == {"plan", "cosort"}
    assert all(isinstance(v, float) for v in rec["table"].values())
    assert rec["winner"] == ttuning.decide(rec["table"],
                                           order=rec["variants"])
    assert rec["chosen"]["delivery"] == rt.opts.delivery
    assert rec["detail"]["errors"] == {}
    assert set(rec["detail"]["compile_s"]) == {"plan", "cosort"}
    assert rt.program.opts is rt.opts


def test_pallas_auto_resolves_to_false_unmeasured(monkeypatch):
    """pallas="auto" alone: no variant to race, nothing measured."""
    def no_calibration(*a, **k):
        raise AssertionError("calibrated")
    monkeypatch.setattr(ttuning, "calibrate", no_calibration)
    rt, _ = _run_ubench("plan", pallas="auto")
    assert rt.opts.pallas is False
    rec = rt.tuning_record
    assert rec["source"] == "default" and rec["variants"] == ["plan"]
    assert rec["chosen"] == {"delivery": "plan", "pallas": False,
                             "pallas_fused": False}
    assert "pallas" in rec and rec["table"] == {}


def test_calibration_leaves_runtime_state_untouched():
    # Calibration runs on throwaway clones: a freshly started world is
    # still empty (no live actors, no queued messages, zero counters).
    rt = _runtime(ponyc_tpu_torch, delivery="auto", pallas_fused="auto")
    rt.declare(tubench.Pinger, 32)
    rt.start()
    assert rt.tuning_record["source"] == "calibrated"
    assert rt.counter("n_processed") == 0
    assert rt.counter("n_delivered") == 0
    assert not bool(rt.state.alive.any())
    assert int(rt.state.tail.sum()) == 0
    assert int(rt.state.dspill_count.sum()) == 0
    assert not any(bool(b.any()) for b in rt.state.buf.values())


def test_failing_variant_fails_start_naming_it(monkeypatch):
    """No variant drops out quietly: one whose window raises fails
    start() with its name."""
    real = ttuning.forced_window

    def broken(program, opts, device):
        if opts.delivery == "cosort":
            raise RuntimeError("launch failed: CUDA error 719")
        return real(program, opts, device)
    monkeypatch.setattr(ttuning, "forced_window", broken)
    rt = _runtime(ponyc_tpu_torch, delivery="auto")
    rt.declare(tubench.Pinger, 8)
    with pytest.raises(RuntimeError, match="variant 'cosort'"):
        rt.start()


def test_fused_auto_with_a_body_the_kernel_cannot_run_fails_start():
    """pallas_fused="auto" on a cohort whose body has no emitter: the
    fused variant could not be built, so start() raises, naming the
    variant and the body (no quiet fall back to the plain dispatch)."""
    @ponyc_tpu_torch.actor
    class Summer:
        n: ponyc_tpu_torch.I32

        @ponyc_tpu_torch.behaviour
        def go(self, st, v: ponyc_tpu_torch.I32):
            return {**st, "n": st["n"] + v.sum()}    # crosses lanes

    rt = _runtime(ponyc_tpu_torch, pallas_fused="auto")
    rt.declare(Summer, 4)
    with pytest.raises(NotImplementedError,
                       match=r"fused variant.*Summer\.go"):
        rt.start()


# ---------------------------------------------------------------------------
# tuning cache


def _record(cdir, n=64):
    rt, _ = _run_ubench("auto", n=n, tuning_cache=cdir)
    return rt.tuning_record


def test_cache_miss_then_hit_then_corrupt(tmp_path, monkeypatch):
    cdir = str(tmp_path / "tuning")
    rec1 = _record(cdir)
    assert rec1["source"] == "calibrated"
    path = rec1["cache_path"]
    with open(path) as f:
        stored = json.load(f)
    assert stored["chosen"] == rec1["chosen"]

    # A cache hit starts without a calibration window.
    real = ttuning.calibrate
    monkeypatch.setattr(ttuning, "calibrate", lambda *a, **k: (_ for _ in
                        ()).throw(AssertionError("calibrated")))
    rec2 = _record(cdir)
    assert rec2["source"] == "cache"
    assert rec2["chosen"] == rec1["chosen"]
    assert rec2["table"] == rec1["table"]
    assert rec2["winner"] == rec1["winner"]
    monkeypatch.setattr(ttuning, "calibrate", real)

    with open(path, "w") as f:
        f.write("{corrupt json!")
    rec3 = _record(cdir)
    assert rec3["source"] == "calibrated"       # corruption recalibrates
    with open(path) as f:
        assert json.load(f)["chosen"] == rec3["chosen"]   # and rewrites


def test_cache_key_separates_layouts(tmp_path):
    cdir = str(tmp_path / "tuning")
    assert _record(cdir, n=64)["source"] == "calibrated"
    assert _record(cdir, n=128)["source"] == "calibrated"   # another key
    assert _record(cdir, n=64)["source"] == "cache"


def test_cache_off_never_writes(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    rec = _record("off")
    assert rec["source"] == "calibrated"
    assert "cache_path" not in rec
    assert not (tmp_path / ".cache").exists()


# ---------------------------------------------------------------------------
# workload construction


def test_workload_is_busy_on_real_shapes_and_equals_jax():
    trt = _runtime(ponyc_tpu_torch)
    trt.declare(tubench.Pinger, 32).start()
    jrt = _runtime(ponyc_tpu)
    jrt.declare(jubench.Pinger, 32).start()
    before = ttuning.clone_state(trt.state)
    twl, tsus = ttuning.make_workload(trt.program, trt.opts, trt.state)
    jwl, _jsus = jtuning.make_workload(jrt.program, jrt.opts, jrt.state)
    for f in ("alive", "tail", "head", "dspill_sender", "dspill_words",
              "dspill_count"):
        np.testing.assert_array_equal(getattr(twl, f).numpy(),
                                      np.asarray(getattr(jwl, f)), err_msg=f)
    # The JAX package parks the whole spill on the victim's row 0; the
    # port spreads it over the victim cohort's rows, entry q at row
    # q mod rows, and sustains the window while that spill lasts.
    ch = trt.program.by_type[tubench.Pinger]
    rows = ch.local_stop - ch.local_start
    spill = trt.opts.spill_cap
    assert (np.asarray(jwl.dspill_tgt) == ch.local_start).all()
    np.testing.assert_array_equal(
        twl.dspill_tgt.numpy(), ch.local_start + np.arange(spill) % rows)
    per_row = -(-spill // rows)
    assert tsus == max(trt.opts.mailbox_cap // trt.opts.batch,
                       -(-per_row // ch.batch)) >= 1
    np.testing.assert_array_equal(twl.buf["Pinger"].numpy(),
                                  np.asarray(jwl.buf["Pinger"]))
    occ = (twl.tail - twl.head).numpy()
    assert (occ[twl.alive.numpy()] == trt.opts.mailbox_cap).all()
    assert int(twl.dspill_count.sum()) == trt.opts.spill_cap
    # The runtime's own state is not written.
    for f in ("alive", "tail", "dspill_tgt", "dspill_words",
              "dspill_count"):
        assert bool((getattr(trt.state, f) == getattr(before, f)).all()), f
    assert bool((trt.state.buf["Pinger"] == before.buf["Pinger"]).all())


def test_host_only_program_skips_calibration():
    @ponyc_tpu_torch.actor
    class H:
        HOST = True
        n: ponyc_tpu_torch.I32

        @ponyc_tpu_torch.behaviour
        def tick(self, st):
            return {**st, "n": st["n"] + 1}

    rt = _runtime(ponyc_tpu_torch, delivery="auto")
    rt.declare(H, 4)
    rt.start()                      # must not raise, must resolve
    assert rt.opts.delivery in ("plan", "cosort")
    assert rt.tuning_record["detail"]["skipped"] == "no device cohorts"
    a = rt.spawn(H)
    rt.send(a, H.tick)
    assert rt.run() == 0 and rt.state_of(a)["n"] == 1

"""The formulation tuner and the tuning cache of the PyTorch port (the
counterpart of ``ponyc_tpu/tuning.py``).

The engine has formulation choices whose winner depends on the card and
the program's shapes: delivery as a stable sort plus permutation gathers
("plan"), the same sort with the payload gathered in sorted order and no
plan kept ("cosort"), or the whole window as one cooperative launch of
the window kernel ("pallas_mega", csrc/mega_window.cu); dispatch as the
plain drain loop or the fused dispatch kernel (`pallas_fused`,
csrc/fused_dispatch.cu). ``RuntimeOptions(delivery="auto")`` and
``pallas_fused="auto"`` defer the choice to ``Runtime.start()``:

1. enumerate the eligible concrete variants (`variants`);
2. time each on a synthetic busy workload built from the program's REAL
   cohort shapes (`make_workload`) with a forced window of the real step
   (`engine.build_forced_window`; the window kernel's `forced` spelling
   under pallas_mega): the median over `tuning_repeats` windows, each
   between two device synchronisations, divided by its ticks. The first
   window, with the variant's kernel builds, is recorded apart as
   `compile_s` (`calibrate`);
3. pick the minimum (`decide`) and record the whole table;
4. persist the decision in an on-disk cache keyed by `tuning_key`, so a
   later start on the same layout skips calibration (`load_cached`,
   `store_cached`).

The port has one mailbox drain (on CUDA the plain dispatch always
launches csrc/drain.cu), so `pallas` has one value: "auto" resolves to
False, the JAX package's baseline, without being measured, and no
variant carries "+pallas". "plan" and "cosort" stay two variants, as in
the JAX package, but are one computation here (runtime/delivery.py);
the record says so.

Semantics are untouched by construction: calibration runs on clones of
a throwaway state (the window kernel writes its inputs' clones in place,
so every timed window gets a fresh clone, made outside the timed
region), and "auto" only chooses which equivalence-tested formulation
runs. Unlike the JAX package's tuner, a variant that fails to build or
to launch fails `start()`, naming the variant: on the card that would
otherwise be a kernel quietly giving way to its plain version.

Also here: the adaptive quiesce window's initial value
(`resolve_quiesce_interval`, `store_quiesce_interval`), through the same
cache with its own key (`quiesce_key`, whose record has a `field`
marker).
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from .config import RuntimeOptions, auto_fields

# Option fields a variant may override: none of them changes the Program
# layout or the state's shapes (the calibration template and the
# runtime's real window share both).
VARIANT_FIELDS = ("delivery", "pallas", "pallas_fused")

# What the record says of pallas="auto" and of cosort (module docstring).
PALLAS_NOTE = ("pallas='auto' resolves to False unmeasured: the port has "
               "one drain (csrc/drain.cu on CUDA)")
COSORT_NOTE = ("cosort is plan's computation in the port (one stable sort "
               "of the key, the payload gathered by its order); only the "
               "carried plan differs, so their gap in the table is noise")

# Cold-start initial window when the cache has no converged value.
DEFAULT_QUIESCE_INTERVAL = 64


# ---------------------------------------------------------------------------
# cache location and records


def tuning_cache_dir(opts: RuntimeOptions) -> Optional[str]:
    """"off" disables; "auto"/"" = $PONY_TPU_TUNING_CACHE or
    ~/.cache/ponyc_tpu_torch/tuning; anything else is the directory."""
    setting = opts.tuning_cache
    if setting == "off":
        return None
    if setting in ("", "auto"):
        setting = os.environ.get("PONY_TPU_TUNING_CACHE", "")
        if setting.lower() in ("off", "0"):
            return None
        if not setting:
            setting = os.path.join(os.path.expanduser("~"), ".cache",
                                   "ponyc_tpu_torch", "tuning")
    return setting


def cache_path(cache_dir: str, key: Dict[str, Any]) -> str:
    blob = json.dumps(key, sort_keys=True).encode()
    return os.path.join(cache_dir,
                        hashlib.sha256(blob).hexdigest()[:24] + ".json")


def load_cached(cache_dir: Optional[str],
                key: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The cached record for `key`, or None on miss or corruption (a
    corrupt file recalibrates, and is then overwritten)."""
    if cache_dir is None:
        return None
    try:
        with open(cache_path(cache_dir, key)) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(rec, dict) or rec.get("key") != key \
            or not isinstance(rec.get("chosen"), dict):
        return None
    return rec


def store_cached(cache_dir: Optional[str], key: Dict[str, Any],
                 record: Dict[str, Any]) -> Optional[str]:
    """Best-effort persist (atomic rename; an unwritable directory never
    fails the start). Returns the path or None."""
    if cache_dir is None:
        return None
    path = cache_path(cache_dir, key)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        return None
    return path


def _device_facts(device) -> Dict[str, Any]:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "device_kind": dev.type}
    return {"platform": "cuda",
            "device_kind": torch.cuda.get_device_name(dev),
            "capability": list(torch.cuda.get_device_capability(dev))}


def _cohort_keys(program, blobs: bool) -> List[Dict[str, Any]]:
    out = []
    for ch in program.cohorts:
        k = {"type": ch.atype.__name__, "capacity": int(ch.capacity),
             "batch": int(ch.batch), "max_sends": int(ch.max_sends),
             "msg_words": int(ch.msg_words),
             "behaviours": len(ch.behaviours), "host": bool(ch.host)}
        if blobs:
            k["blobs"] = bool(ch.uses_blobs)
        out.append(k)
    return out


def csrc_hash() -> str:
    """sha256 of the kernels' sources (csrc/*): the compiled code a
    decision was measured with."""
    from .ops import _build
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# variant enumeration


def fused_eligible(program, opts: RuntimeOptions) -> bool:
    """Some device cohort would run the fused dispatch kernel under
    pallas_fused=True: the facts the engine's own probe uses
    (engine._cohort_dispatch, ops/fused_dispatch.py's `eligible`):
    behaviours, no blob pool, no synchronous construction. A body the
    kernel cannot emit raises, naming the variant: it would not build."""
    from .ops import fused_dispatch
    from .runtime.engine import spawn_meta_of
    for ch in program.device_cohorts:
        if not ch.behaviours or ch.uses_blobs:
            continue
        try:
            progs = fused_dispatch.trace_cohort(
                ch, opts, spawn_meta_of(program, ch))
        except NotImplementedError as e:
            raise NotImplementedError(
                f"pallas_fused='auto': the fused variant cannot be built "
                f"for cohort {ch.atype.__name__}: {e}") from e
        if fused_dispatch.eligible(ch, progs):
            return True
    return False


def mega_eligible(program, opts: RuntimeOptions, device) -> bool:
    """Whether delivery="auto" times the window kernel
    (megakernel.auto_enumerable)."""
    from .ops import megakernel
    return megakernel.auto_enumerable(program, opts, device)


def variants(program, opts: RuntimeOptions,
             device) -> List[Tuple[str, Dict]]:
    """Ordered (name, overrides) candidates for the opts' "auto" fields.
    The first entry is the baseline (plan, kernels off); `decide` breaks
    ties toward earlier entries, so noise never flips a dead heat away
    from it. `pallas` has one value here (module docstring)."""
    deliveries = (["plan", "cosort"]
                  + (["pallas_mega"] if mega_eligible(program, opts, device)
                     else [])
                  if opts.delivery == "auto" else [opts.delivery])
    p = False if opts.pallas == "auto" else opts.pallas
    fused_vals = ([False, True]
                  if (opts.pallas_fused == "auto"
                      and fused_eligible(program, opts))
                  else [False if opts.pallas_fused == "auto"
                        else opts.pallas_fused])
    out: List[Tuple[str, Dict]] = []
    for f in fused_vals:
        for d in deliveries:
            if opts.delivery == "auto" and d == "pallas_mega" and (p or f):
                # The window kernel is the fused form of both kernels:
                # auto never enumerates the combination.
                continue
            name = d + ("+pallas" if p else "") + ("+fused" if f else "")
            out.append((name, {"delivery": d, "pallas": p,
                               "pallas_fused": f}))
    return out


def decide(table: Dict[str, Optional[float]],
           order: Optional[List[str]] = None) -> Optional[str]:
    """The winning variant: minimum tick_ms, exact ties broken toward
    the earlier entry in `order` (insertion order by default: the
    baseline). None entries never win. Deterministic given the table."""
    order = list(table.keys()) if order is None else order
    best = None
    for name in order:
        t = table.get(name)
        if t is None:
            continue
        if best is None or t < table[best]:
            best = name
    return best


# ---------------------------------------------------------------------------
# the decision-table key


def tuning_key(program, opts: RuntimeOptions, device) -> Dict[str, Any]:
    """Everything the decision depends on on this card (platform, device
    and compute capability, torch and CUDA versions, the kernels'
    sources, cohort layout, geometry) and nothing it does not (actor
    field values change no shape). Same key => the cached winner
    transfers."""
    geometry = {f: getattr(opts, f) for f in (
        "mailbox_cap", "msg_words", "batch", "max_sends", "spill_cap",
        "inject_slots", "mesh_shards", "route_bucket", "mute_slots",
        "dispatch_gating", "blob_slots", "blob_words")}
    return {
        # v1: the port's first formulation key (plan, cosort,
        # pallas_mega, +fused); bump it whenever the variant space or
        # the key's meaning changes.
        "v": 1,
        "field": "formulation",
        **_device_facts(device),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "csrc": csrc_hash(),
        "auto": sorted(auto_fields(opts)),
        "fixed": {f: getattr(opts, f) for f in VARIANT_FIELDS
                  if getattr(opts, f) != "auto"},
        "geometry": geometry,
        "cohorts": _cohort_keys(program, blobs=True),
    }


# ---------------------------------------------------------------------------
# the synthetic calibration workload


def make_workload(program, opts: RuntimeOptions, state):
    """A throwaway busy state on the program's REAL cohort shapes, built
    from the fresh post-start state into new tensors (`state` is never
    written):

    - every device-cohort actor is alive with a FULL mailbox of its
      cohort's first behaviour (zero args): the dispatch runs its full
      cost while those drain (cap/batch ticks), and the outbox keeps
      delivery's sort at full width every tick;
    - the receiver spill is parked full, spread over the rows of one
      victim cohort (the first device cohort with behaviours), entry q
      aimed at its row q mod rows: each tick every victim drains `batch`
      and delivery re-accepts up to `batch` of its spill entries, so real
      accepted messages flow through the sort, rebuild and pressure
      paths while the spill lasts. The JAX package parks the whole spill
      on the cohort's row 0; spread, no target holds more entries than
      real traffic gives one, and the window kernel's ticks take the sort
      a real tick takes (one victim with the whole spill would put every
      calibration tick through the radix sort of a hot target).

    Returns (state, sustain ticks), or (None, 0) for a program without
    device cohorts. Values are garbage by design; the state is never
    installed."""
    if not program.device_cohorts:
        return None, 0
    cap = opts.mailbox_cap
    dev = state.head.device
    victim = None
    mask = torch.zeros((program.n_local,), dtype=torch.bool, device=dev)
    for ch in program.device_cohorts:
        mask[ch.local_start:ch.local_stop] = True
        if victim is None and ch.behaviours:
            victim = ch
    mask = mask.repeat(program.shards)      # every shard's rows alike
    buf = dict(state.buf)
    for ch in program.device_cohorts:
        gid0 = ch.behaviours[0].global_id if ch.behaviours else -7
        b = state.buf[ch.atype.__name__].clone()
        b[:, 0, :] = gid0
        buf[ch.atype.__name__] = b
    kw = dict(buf=buf, alive=state.alive | mask,
              tail=torch.where(mask, cap, state.tail).to(torch.int32))
    sustain = max(1, cap // max(1, opts.batch))
    if victim is not None:
        words = state.dspill_words.clone()
        words[0, :] = victim.behaviours[0].global_id
        rows = victim.local_stop - victim.local_start
        q = torch.arange(state.dspill_tgt.shape[0], dtype=torch.int32,
                         device=dev)
        kw.update(
            dspill_tgt=victim.local_start + q % rows,
            dspill_sender=torch.full_like(state.dspill_sender, -1),
            dspill_words=words,
            dspill_count=torch.full_like(state.dspill_count, opts.spill_cap))
        per_row = -(-opts.spill_cap // rows)
        sustain = max(sustain, -(-per_row // max(1, victim.batch)))
    return dataclasses.replace(state, **kw), sustain


def clone_state(st):
    """A deep copy of every tensor of a state (dicts of tensors, and
    dicts of those, included)."""
    def c(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, dict):
            return {k: c(v) for k, v in x.items()}
        return x
    return dataclasses.replace(st, **{
        f.name: c(getattr(st, f.name)) for f in dataclasses.fields(st)})


# ---------------------------------------------------------------------------
# calibration and resolution


def _window_ticks(opts: RuntimeOptions, sustain: int) -> int:
    if opts.tuning_ticks > 0:
        return opts.tuning_ticks
    return max(2, min(16, sustain))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forced_window(program, opts: RuntimeOptions, device):
    """A variant's forced window (engine.build_forced_window), its
    kernels built on CUDA: the window kernel under pallas_mega on an
    eligible program, else the plain step's (the fused kernels under
    pallas_fused). A kernel already built (ops/_build.py's cache, keyed by
    source hash) is loaded, not built again."""
    from .ops import fused_dispatch, megakernel
    from .runtime import engine
    cuda = torch.device(device).type == "cuda"
    if opts.delivery == "pallas_mega" and megakernel.eligible(program, opts):
        mw = engine.build_multi_step_gated(program, opts)
        if cuda:
            mw.build()
        return engine.build_forced_window(program, opts, window=mw)
    fn = engine.build_forced_window(program, opts)
    if cuda and fn.fused:
        fused_dispatch.compile_all(fn.fused)
    return fn


def calibrate(program, opts: RuntimeOptions, state,
              names_overrides: List[Tuple[str, Dict]],
              ) -> Tuple[Dict[str, Optional[float]], Dict[str, Any]]:
    """Time every candidate on the synthetic workload. Returns
    ({name: ms a tick}, detail). A variant that fails to build or to run
    raises RuntimeError naming it (no variant drops out quietly)."""
    template, sustain = make_workload(program, opts, state)
    detail: Dict[str, Any] = {"errors": {}}
    table: Dict[str, Optional[float]] = {}
    if template is None:          # host-only program: nothing to measure
        for name, _ov in names_overrides:
            table[name] = None
        detail["skipped"] = "no device cohorts"
        return table, detail

    dev = state.head.device
    k = _window_ticks(opts, sustain)
    repeats = opts.tuning_repeats
    w1 = 1 + opts.msg_words + opts.trace_lanes
    slots = opts.inject_slots
    empty_inject = (
        torch.full((slots,), -1, dtype=torch.int32, device=dev),
        torch.zeros((w1, slots), dtype=torch.int32, device=dev))
    detail.update(ticks_per_window=k, repeats=repeats,
                  sustain_ticks=int(sustain), clock=(
                      "cuda synchronize" if dev.type == "cuda"
                      else "host"), compile_s={})

    for name, overrides in names_overrides:
        vopts = dataclasses.replace(opts, **overrides)
        try:
            t0 = time.perf_counter()
            fn = forced_window(program, vopts, dev)
            out = fn(clone_state(template), *empty_inject, k)
            _sync(dev)
            detail["compile_s"][name] = round(time.perf_counter() - t0, 3)
            del out
            times = []
            for _ in range(repeats):
                st_in = clone_state(template)
                _sync(dev)
                t0 = time.perf_counter()
                out = fn(st_in, *empty_inject, k)
                _sync(dev)
                times.append(time.perf_counter() - t0)
                del out, st_in
        except Exception as e:
            raise RuntimeError(
                f"tuner: variant {name!r} failed to build or run: "
                f"{type(e).__name__}: {e}") from e
        table[name] = 1e3 * statistics.median(times) / k
    return table, detail


def resolve(program, opts: RuntimeOptions, state,
            ) -> Tuple[RuntimeOptions, Dict[str, Any]]:
    """Turn "auto" option values into concrete ones: cache hit -> the
    cached winner; miss -> calibrate, decide, persist. Returns (concrete
    opts, the decision record: source, variants, table, winner, chosen,
    detail, cache_path)."""
    autos = auto_fields(opts)
    if not autos:
        return opts, {"source": "none", "chosen": {}, "table": {}}
    device = state.head.device
    cands = variants(program, opts, device)
    baseline = cands[0]
    record: Dict[str, Any] = {
        "auto": autos,
        "variants": [n for n, _ in cands],
        "table": {},
        "detail": {},
    }
    if "pallas" in autos:
        record["pallas"] = PALLAS_NOTE
    if "cosort" in record["variants"]:
        record["cosort"] = COSORT_NOTE

    if len(cands) == 1:
        # Nothing eligible beyond the baseline: decide without measuring.
        name, overrides = baseline
        record.update(source="default", chosen=overrides, winner=name)
        return dataclasses.replace(opts, **overrides), record

    key = tuning_key(program, opts, device)
    cdir = tuning_cache_dir(opts)
    record["cache_dir"] = cdir
    cached = load_cached(cdir, key)
    if cached is not None:
        record.update(source="cache", chosen=cached["chosen"],
                      winner=cached.get("winner"),
                      table=cached.get("table", {}),
                      detail=cached.get("detail", {}),
                      cache_path=cache_path(cdir, key))
        return dataclasses.replace(opts, **cached["chosen"]), record

    table, detail = calibrate(program, opts, state, cands)
    winner = decide(table, order=[n for n, _ in cands])
    if winner is None:
        winner = baseline[0]
    overrides = dict(cands)[winner]
    record.update(source="calibrated", chosen=overrides, winner=winner,
                  table={n: (None if t is None else round(t, 4))
                         for n, t in table.items()},
                  detail=detail)
    stored = store_cached(cdir, key, {
        "key": key, "chosen": overrides, "winner": winner,
        "table": record["table"], "detail": detail,
        "written_unix": time.time()})
    if stored:
        record["cache_path"] = stored
    return dataclasses.replace(opts, **overrides), record


# ---------------------------------------------------------------------------
# the adaptive quiesce window's initial value (runtime/controller.py)


def quiesce_key(program, opts: RuntimeOptions, device) -> Dict[str, Any]:
    """Everything the converged window legitimately depends on."""
    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    geometry = {f: getattr(opts, f) for f in (
        "mailbox_cap", "msg_words", "batch", "max_sends", "spill_cap",
        "inject_slots", "mesh_shards", "mute_slots")}
    return {"v": 1, "platform": dev.type, "device_kind": kind,
            "torch": torch.__version__, "geometry": geometry,
            "cohorts": _cohort_keys(program, blobs=False),
            "field": "quiesce_interval",
            "bounds": [int(opts.quiesce_interval_min),
                       int(opts.quiesce_interval_max)]}


def resolve_quiesce_interval(program, opts: RuntimeOptions,
                             device) -> int:
    """Initial window for quiesce_interval="auto": the cached converged
    value for this layout, else the default, clamped to the bounds."""
    lo, hi = opts.quiesce_interval_min, opts.quiesce_interval_max
    cached = load_cached(tuning_cache_dir(opts),
                         quiesce_key(program, opts, device))
    v = DEFAULT_QUIESCE_INTERVAL
    if cached is not None and isinstance(
            cached["chosen"].get("quiesce_interval"), int):
        v = cached["chosen"]["quiesce_interval"]
    return min(hi, max(lo, v))


def store_quiesce_interval(program, opts: RuntimeOptions, window: int,
                           device) -> Optional[str]:
    """Persist a converged adaptive window for this layout."""
    cdir = tuning_cache_dir(opts)
    key = quiesce_key(program, opts, device)
    return store_cached(cdir, key, {
        "key": key, "chosen": {"quiesce_interval": int(window)},
        "winner": f"window={int(window)}", "written_unix": time.time()})

"""The dispatch step of the PyTorch port: one scheduler tick over the whole
actor world (the counterpart of ``ponyc_tpu/runtime/engine.py``, single
device).

≙ the reference's hot loop: scheduler `run` (src/libponyrt/sched/
scheduler.c:953-1090) popping actors and `ponyint_actor_run`
(src/libponyrt/actor/actor.c:383-549) draining up to `batch` messages per
actor. The whole world advances in lockstep:

  1. unmute senders whose muting receivers recovered;
  1b. reserve device spawns: each spawn target's free rows, compacted,
     in disjoint windows per runnable spawner (≙ pony_create's slot
     allocation, done ahead of dispatch);
  2. per device cohort, drain ≤batch messages per actor
     (ops/mailbox_kernel.py: the CUDA kernel on the card) and evaluate
     every behaviour of the type on all lanes, selecting per lane by
     message id (what a vmapped switch executes); under `pallas_fused`
     one kernel a cohort does the drain, the dispatch and the outbox
     (ops/fused_dispatch.py);
     Host-cohort rows (HOST = True, the rows from
     program.first_host_row on) take delivery but no dispatch here:
     their heads pass through, and the host drains them between windows
     (runtime.py), ending a window when one is occupied (host_pending);
  2b. apply the spawn claims: claimed rows become alive with an empty
     mailbox and their fields set (null words, or ctx.spawn_sync's
     values), before delivery;
  3. deliver spill, injections and the produced messages (delivery.py);
  4. apply destroys and errors, then mute bookkeeping, and vote the
     small aux scalars the host reads.

Telemetry (analysis >= 1: the profiler lanes, the phase costs, the
occupancy aggregates and qw_p99; analysis >= 3: the event ring; causal
tracing: the span ring and the (trace id, span id) words every outbox
entry carries) is recomputed from the ring head and tail advances
(`profile_lanes`, `phase_cost_lanes`, `trace_span_lanes`), so one
implementation serves the plain and the fused dispatch. The gates are
Python-level, as in the reference: at analysis 0 none of it runs.

Control flow. The reference is compiled by XLA, so its `lax.cond`s and
its window `lax.while_loop` cost no host round trip. In eager PyTorch a
branch on a device value is a synchronisation. This port therefore
evaluates predicates on the device and keeps them there: where the
reference would skip work on a quiet tick (idle cohort, nobody muted,
no spill, no new mute) the general computation runs and reduces exactly
to the skipped one, and the gated window runs each tick under a device
predicate (`build_multi_step_gated`). One tick launches a fixed
sequence of kernels whatever the data.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch.overrides import TorchFunctionMode

from ..api import BlobPoolView, Context
from ..config import (RuntimeOptions, auto_fields, check_supported,
                      unported)
from ..ops import fused_dispatch, megakernel, pack
from ..ops.mailbox_kernel import drain_msgs
from ..ops.segment import counts_by_key
from ..program import Cohort, Program
from ..ops.segment import DUMP_SLOTS, dump_index
from .delivery import Entries, _isum, deliver, empty_mute_slots
from .state import PHASE_NAMES, QW_BUCKETS, RtState


class StepAux(NamedTuple):
    """Small per-step scalars fetched by the host driver (≙ the
    scheduler's control-message reads + quiescence vote,
    scheduler.c:303-480). 0-dim tensors on the device; the host reads
    them all in one copy (`aux_vector`)."""
    device_pending: torch.Tensor  # bool — device mailbox/spill work left
    host_pending: torch.Tensor    # bool — host-cohort mailboxes non-empty
    exit_flag: torch.Tensor       # bool — some behaviour called ctx.exit
    exit_code: torch.Tensor       # int32
    spill_overflow: torch.Tensor  # bool — fatal: a spill buffer exceeded
    spawn_fail: torch.Tensor      # bool — fatal: ctx.spawn found no slot
    blob_fail: torch.Tensor       # bool
    blob_budget_fail: torch.Tensor  # bool
    any_muted: torch.Tensor       # bool — some actor still muted
    n_processed: torch.Tensor     # int32 — cumulative behaviours run
    n_delivered: torch.Tensor     # int32 — cumulative deliveries
    occ_sum: torch.Tensor         # int32 — telemetry (0 while analysis off)
    occ_max: torch.Tensor
    n_muted_now: torch.Tensor
    n_overloaded_now: torch.Tensor
    n_rejected: torch.Tensor
    n_badmsg: torch.Tensor
    n_deadletter: torch.Tensor
    n_mutes: torch.Tensor
    qw_p99: torch.Tensor


_AUX_BOOL = ("device_pending", "host_pending", "exit_flag",
             "spill_overflow", "spawn_fail", "blob_fail",
             "blob_budget_fail", "any_muted")


def aux_vector(aux: StepAux, ticks: torch.Tensor) -> torch.Tensor:
    """Pack an aux (and a window's tick count) into one int32 vector, so
    the host reads a window's control scalars with a single copy."""
    return torch.stack([v.to(torch.int32).reshape(()) for v in aux]
                       + [ticks.to(torch.int32).reshape(())])


def aux_from_vector(values) -> Tuple[int, StepAux]:
    """Host side of `aux_vector`: (ticks, StepAux of Python scalars)."""
    vals = [int(v) for v in values]
    fields = {f: (bool(v) if f in _AUX_BOOL else v)
              for f, v in zip(StepAux._fields, vals[:-1])}
    return vals[-1], StepAux(**fields)


def aux_to_device(a: StepAux, device) -> StepAux:
    """Host StepAux (Python scalars) → device 0-dim tensors, written by
    fill kernels: a copy from pageable host memory would synchronise the
    stream."""
    return StepAux(*(torch.full(
        (), v, dtype=torch.bool if f in _AUX_BOOL else torch.int32,
        device=device) for f, v in zip(StepAux._fields, a)))


def zero_aux(device) -> StepAux:
    """The pre-first-tick aux (device_pending=True so a window admits
    tick 0; everything else zero/false)."""
    a = StepAux(*([0] * len(StepAux._fields)))._replace(device_pending=1)
    return aux_to_device(a, device)


def aux_go(aux: StepAux) -> torch.Tensor:
    """The window-continue vote: device work remains and no fact that
    demands host attention (host mailboxes, exit, fatal flags) is up."""
    return (aux.device_pending & ~aux.host_pending & ~aux.exit_flag
            & ~aux.spill_overflow & ~aux.spawn_fail
            & ~aux.blob_fail & ~aux.blob_budget_fail)


def _bcast_lanes(v, dtype, lanes: int, device):
    """Canonicalise a behaviour output to a [lanes] tensor (user code may
    return Python scalars for some quantities). A tensor that already is
    one comes back as the same object, so callers can tell an untouched
    field by identity."""
    if isinstance(v, torch.Tensor) and v.dtype == dtype \
            and tuple(v.shape) == (lanes,) and v.device == device:
        return v
    return pack._tensor(v, dtype, device).expand(lanes)


def _dtype_of(spec):
    return torch.float32 if spec is pack.F32 else torch.int32


class _IntDivision(TorchFunctionMode):
    """Integer `%` and `//` (remainder, floor_divide, div with
    rounding_mode="floor") by a zero tensor divisor give the JAX package's
    results on the CPU: remainder 0, quotient -1 for a zero dividend and
    -2 otherwise. torch's CPU kernels raise there and its CUDA kernels
    leave the result undefined. The lane programs record the guarded form,
    so both kernels agree; csrc/lane.cuh's pony_rem and pony_floordiv give
    the same results for a zero divisor of their own."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = _INT_DIV.get(func)
        if op is not None and len(args) == 2 and (
                func not in (torch.div, torch.Tensor.div)
                or kwargs.get("rounding_mode") == "floor"):
            kind, reflected = op
            a, b = args[::-1] if reflected else args
            if (isinstance(b, torch.Tensor) and _is_int(a) and _is_int(b)):
                zero = b == 0
                b1 = torch.where(zero, 1, b)
                if kind == "rem":
                    return torch.where(zero, 0, torch.remainder(a, b1))
                q = torch.where(zero, -2, torch.floor_divide(a, b1))
                return torch.where(zero & (a == 0), -1, q)
        return func(*args, **kwargs)


def _is_int(v) -> bool:
    if isinstance(v, torch.Tensor):
        return not (v.dtype.is_floating_point or v.dtype.is_complex
                    or v.dtype == torch.bool)
    return isinstance(v, int) and not isinstance(v, bool)


# func -> (remainder or floor quotient, operands reflected)
_INT_DIV = {
    torch.remainder: ("rem", False), torch.Tensor.remainder: ("rem", False),
    torch.Tensor.__mod__: ("rem", False),
    torch.Tensor.__rmod__: ("rem", True),
    torch.floor_divide: ("floor", False),
    torch.Tensor.floor_divide: ("floor", False),
    torch.Tensor.__floordiv__: ("floor", False),
    torch.Tensor.__rfloordiv__: ("floor", True),
    torch.div: ("floor", False), torch.Tensor.div: ("floor", False),
}


def eval_behaviour(bdef, st, payload, ids_vec, *, msg_words: int,
                   field_specs, field_dtypes, lanes: int, max_sends: int,
                   spawn_resv=None, spawn_meta=None, blob=None):
    """Evaluate one behaviour on all lanes of a cohort: build the
    Context, tag typed refs and capabilities, run the body, validate and
    broadcast the state update, and collect the when-masked send planes
    padded to the send budget (an unused slot is None). `spawn_resv`
    ({target: [sites, lanes] reserved refs}) and `spawn_meta` ({target:
    field specs}) serve ctx.spawn and ctx.spawn_sync; `blob` (a pool
    view, api.BlobPoolView or the lane tracer's) the ctx.blob_* ops.
    Returns (ctx, st2, tgts, words)."""
    dev = ids_vec.device
    w1 = 1 + msg_words
    ctx = Context(ids_vec, msg_words, spawn_resv=spawn_resv,
                  spawn_meta=spawn_meta, blob=blob)
    args = pack.unpack_args(bdef.arg_specs, payload)
    if blob is not None:
        # A Blob argument is readable only from its own pool; one that
        # arrived from elsewhere (a forged or off-pool handle) reads as
        # null and counts in n_blob_remote: loud, never a wrong read.
        nulled = []
        for spec, a in zip(bdef.arg_specs, args):
            if pack.is_blob(spec):
                a = pack._tensor(a, torch.int32, dev)
                slot = pack.blob_slot(a)
                local_ok = ((a >= 0) & (slot >= blob.base)
                            & (slot < blob.base + blob.nslots))
                blob.note_remote((a >= 0) & ~local_ok)
                a = torch.where(local_ok, a, -1)
            nulled.append(a)
        args = nulled
    for k, v in st.items():
        ctx.ref_types.tag(v, pack.ref_target(field_specs[k]))
        ctx.cap_types.tag(v, pack.cap_mode(field_specs[k]))
    for spec, a in zip(bdef.arg_specs, args):
        ctx.ref_types.tag(a, pack.ref_target(spec))
        ctx.cap_types.tag(a, pack.cap_mode(spec))
    inputs = [v for v in list(st.values()) + list(args)
              if isinstance(v, torch.Tensor)]
    versions = [v._version for v in inputs]
    with _IntDivision():
        st2 = bdef.fn(ctx, dict(st), *args)
    if any(v._version != ver for v, ver in zip(inputs, versions)):
        # Tensors are shared across lanes and behaviours; an in-place
        # update (`st["x"] += 1`) would leak into lanes this behaviour
        # does not own. JAX arrays are immutable, so the reference never
        # meets this.
        raise TypeError(
            f"behaviour {bdef} updated a state field or argument in "
            "place; return new values instead (x = x + 1, not x += 1)")
    if st2 is None:
        raise TypeError(
            f"behaviour {bdef} must return the (possibly updated) state "
            "dict")
    if set(st2.keys()) != set(st.keys()):
        raise TypeError(
            f"behaviour {bdef} changed the state fields: "
            f"{sorted(st2)} vs {sorted(st)}")
    for k, v in st2.items():
        want = pack.ref_target(field_specs[k])
        got = ctx.ref_types.lookup(v)
        if want is not None and got is not None and got != want:
            raise TypeError(
                f"sendability: behaviour {bdef} stores a Ref[{got}] "
                f"into field {k!r} declared Ref[{want}]")
        moved = (None if pack.concrete_null_handle(v)
                 else ctx.cap_moves.was_moved(v))
        if moved is not None:
            raise TypeError(
                f"capability: behaviour {bdef} retains a moved iso "
                f"payload in field {k!r} (moved by {moved}); an iso is "
                "moved-unique — clear the field (e.g. -1) or use Val "
                "for shared-immutable payloads")
        src = (None if pack.concrete_null_handle(v)
               else ctx.cap_types.lookup(v))
        dst = pack.cap_mode(field_specs[k])
        if not pack.cap_store_ok(src, dst):
            raise TypeError(
                f"capability: behaviour {bdef} stores a {src} payload "
                f"into field {k!r} declared {dst.capitalize()} — a "
                f"{src} value cannot grant the rights {dst} requires "
                "(is_cap_sub_cap, type/cap.c)")
    iso_seen = {}
    for k, v in st2.items():
        if pack.concrete_null_handle(v):
            continue
        if ctx.cap_types.lookup(v) == "iso":
            first = iso_seen.get(id(v))
            if first is not None:
                raise TypeError(
                    f"capability: behaviour {bdef} stores one iso "
                    f"payload into BOTH fields {first!r} and {k!r} — "
                    "an iso has exactly one owner (alias.c)")
            iso_seen[id(v)] = k
    st2 = {k: _bcast_lanes(v, field_dtypes[k], lanes, dev)
           for k, v in st2.items()}
    if len(ctx.sends) > max_sends:
        raise RuntimeError(
            f"behaviour {bdef} performs {len(ctx.sends)} sends but the "
            f"type's send budget is {max_sends}; set MAX_SENDS = "
            f"{len(ctx.sends)} on the actor class")
    tgts, words = [], []
    for (t, w, when) in ctx.sends:
        t = _bcast_lanes(t, torch.int32, lanes, dev)
        when = _bcast_lanes(when, torch.bool, lanes, dev)
        tgts.append(torch.where(when, t, -1))
        words.append(w.reshape(w1, -1).expand(w1, lanes))
    # Unused send slots of the budget: None (no message from any lane).
    tgts += [None] * (max_sends - len(ctx.sends))
    words += [None] * (max_sends - len(ctx.sends))
    return ctx, st2, tgts, words


def spawn_sites_of(cohort: Cohort):
    """The cohort's spawn budget in the order every dispatch uses:
    ((target type name, sites a dispatch), ...) sorted by name."""
    return tuple(sorted(cohort.spawns.items()))


def spawn_outputs(ctx, spawn_sites, spawn_meta, lanes: int, device):
    """A behaviour's spawns as [lanes] planes, per target of
    `spawn_sites`: the claimed ref of every site (-1 where the body made
    no claim there or it failed; None for a site the body never reaches),
    and, where the body sync-constructs, per site the `has` mask and the
    constructor's field values (None where it does not). Also the spawn
    fail plane (None when no spawn can fail)."""
    claims, inits = [], []
    for tname, n in spawn_sites:
        got = [_bcast_lanes(g, torch.int32, lanes, device)
               for g in ctx.spawn_claims.get(tname, [])]
        claims.append(got + [None] * (n - len(got)))
        site_map = ctx.sync_inits.get(tname)
        if not site_map:
            inits.append(None)
            continue
        specs = spawn_meta[tname]
        has, vals = [], {f: [] for f in specs}
        for s in range(n):
            ent = site_map.get(s)
            if ent is None:
                has.append(None)
                for f in specs:
                    vals[f].append(None)
                continue
            ist, ok = ent
            has.append(_bcast_lanes(ok, torch.bool, lanes, device))
            for f, sp in specs.items():
                vals[f].append(_bcast_lanes(ist[f], _dtype_of(sp), lanes,
                                            device))
        inits.append((has, vals))
    sf = ctx.spawn_fail
    sf = None if sf is False else _bcast_lanes(sf, torch.bool, lanes, device)
    return claims, inits, sf


def reservation_slot(resv, used, spawn_sites, sd: int, rows: int):
    """This batch slot's reservations from the [sd * sites, rows] planes
    of each target: the `used` counter walks the SPAWN_DISPATCHES axis;
    past the budget every ref is -1. Returns {target: [sites, rows]}."""
    out = {}
    for (tname, n), plane in zip(spawn_sites, resv):
        sel = torch.full((n, rows), -1, dtype=torch.int32,
                         device=plane.device)
        for d in range(sd):
            sel = torch.where((used == d)[None, :],
                              plane[d * n:(d + 1) * n], sel)
        out[tname] = sel
    return out


def spawn_meta_of(program: Program, cohort: Cohort):
    """{target type name: field specs} of the cohort's spawn targets (for
    ctx.spawn_sync)."""
    return {t: program.by_type_name(t).atype.field_specs
            for t, _ in spawn_sites_of(cohort)}


def blob_slot_resv(resv, used, sites: int, bd: int, rows: int, dev):
    """This batch slot's blob reservations from the cohort's [bd, sites,
    rows] windows: the `used` counter (allocating dispatches so far)
    walks the BLOB_DISPATCHES axis. Returns ([sites, rows] global slot
    ids, -1 past the budget; the lanes past their budget)."""
    sel = torch.full((sites, rows), -1, dtype=torch.int32, device=dev)
    for d in range(bd):
        sel = torch.where((used == d)[None, :], resv[d], sel)
    return sel, used >= bd


def _plain_dispatch(cohort: Cohort, opts: RuntimeOptions, spawn_meta=None):
    """Build the planar per-cohort drain loop (≙ ponyint_actor_run,
    actor.c:383-549): pop ≤batch messages per actor, dispatch each,
    honour yield (fork: actor.c:675-679), count consumption — for every
    actor of the cohort at once. The reference's `lax.scan` over batch
    slots is a Python loop over the static batch here. Returns
    dispatch(fields, buf, head, n_run, ids, resv=()) → (fields, outbox
    Entries, new head, any exit, exit code, nproc, nbad, destroy plane or
    None, error planes or None, claims, inits, spawn fail or None).

    Spawns (≙ pony_create from a behaviour): `resv` holds, per target of
    `spawn_sites_of(cohort)`, the [sd * sites, rows] reserved refs; a
    per-lane `used` counter hands each batch slot one dispatch's worth,
    and advances on a slot that claimed or failed a wanted spawn. The
    claims come back per target as [batch * sites * rows] refs in (k,
    site, lane) order (-1: none), the inits per target as (has, {field:
    values}) in the same order where a behaviour sync-constructs, else
    None, and the spawn fail as one bool (None without spawn sites).
    ops/fused_dispatch.py computes the same in one kernel, and uses this
    as its plain version.

    The blob pool (a cohort that uses it): `blob` is a dict of the pool's
    working copies (data, used, len, gen, each with the dropping slot
    last; api.BlobPoolView), `base` and `resv` ([bd, sites, rows] global
    slot ids, None without alloc sites). The behaviours update the
    copies in place, batch slot by batch slot; a lane's used counter
    hands each dispatch that allocates the next of its BLOB_DISPATCHES
    windows. With `blob`, one more result: (fail, budget fail, allocs,
    frees, remote args)."""
    msg_words = opts.msg_words          # outbox width (program-wide max)
    ms = cohort.max_sends
    batch = cohort.batch
    rows = cohort.local_capacity
    w1 = 1 + msg_words
    field_specs = cohort.atype.field_specs
    field_dtypes = {f: _dtype_of(s) for f, s in field_specs.items()}
    behaviours = list(cohort.behaviours)
    nb = len(behaviours)
    base = behaviours[0].global_id if nb else 0
    noyield = opts.noyield
    sites = spawn_sites_of(cohort)
    sd = cohort.spawn_dispatches
    meta = spawn_meta or {}

    bsites, bd = cohort.blob_sites, cohort.blob_dispatches

    def dispatch(ts_rows, buf_rows, head_rows, n_run, ids, resv=(),
                 blob=None):
        dev = ids.device
        i32, b = torch.int32, torch.bool
        e = rows * batch * ms
        msgs, valids = drain_msgs(buf_rows, head_rows, n_run, batch)
        bacc = None
        if blob is not None:
            bused = torch.zeros((rows,), dtype=i32, device=dev)
            bacc = []                      # every view of the drain

        def z(dtype):
            return torch.zeros((rows,), dtype=dtype, device=dev)

        def sel(take, new, old, dtype):
            """Merge one behaviour's effect plane into the slot's.
            `None`/`old` stands for "no lane has it". An effect the body
            never touched is still its Python default (False/0); on this
            behaviour's lanes `old` holds that default too (take masks
            are disjoint), so the select would change nothing."""
            if not isinstance(new, torch.Tensor) and not new:
                return old
            return torch.where(take, _bcast_lanes(new, dtype, rows, dev),
                               z(dtype) if old is None else old)

        st = dict(ts_rows)
        # Effect planes over the whole drain; None until some behaviour
        # of the cohort sets the effect (a Pinger never pays for exit,
        # yield, destroy or error planes).
        stopped = ef = ec = dstr = errf = errc = errl = None
        nproc, nbad = z(i32), z(i32)
        effects = {"destroy": False, "error": False, "sync": False}
        used = z(i32)
        sfail = None
        stgt, swrd, consumed = [], [], []
        sclm = [[] for _ in sites]        # per target: [batch] of [n, rows]
        sini = [[] for _ in sites]        # per target: [batch] of inits
        for k in range(batch):
            msg, valid = msgs[k], valids[k]         # [w1_in, rows], [rows]
            local = msg[0] - base
            in_range = (local >= 0) & (local < nb)
            do = valid if stopped is None else valid & ~stopped
            resv_k = reservation_slot(resv, used, sites, sd, rows)
            st_n = dict(st)
            tgt_n = [torch.full((rows,), -1, dtype=i32, device=dev)
                     for _ in range(ms)]
            wrd_n = [torch.zeros((w1, rows), dtype=i32, device=dev)
                     for _ in range(ms)]
            clm_n = [[None] * n for _, n in sites]
            ini_n = [None for _ in sites]
            ef_n = ec_n = yf_n = ds_n = erf_n = erc_n = erl_n = None
            sf_n = None
            if blob is not None:
                rblob, rover = (blob_slot_resv(blob["resv"], bused, bsites,
                                               bd, rows, dev)
                                if bsites else (None, None))
                alloced = torch.zeros((rows,), dtype=b, device=dev)
            for j, bdef in enumerate(behaviours):
                take = do & in_range & (local == j)
                bv = None
                if blob is not None:
                    bv = BlobPoolView(blob["data"], blob["used"],
                                      blob["len"], blob["gen"],
                                      blob["base"], take, rblob,
                                      budget_over=rover)
                    bacc.append(bv)
                ctx, st2, btgt, bwrd = eval_behaviour(
                    bdef, st, msg[1:], ids, msg_words=msg_words,
                    field_specs=field_specs, field_dtypes=field_dtypes,
                    lanes=rows, max_sends=ms, spawn_resv=resv_k,
                    spawn_meta=meta, blob=bv)
                if bv is not None:
                    alloced = alloced | bv.alloced
                effects["destroy"] |= ctx.destroy_called
                effects["error"] |= ctx.error_called
                # Selects that cannot change anything are skipped: on
                # this behaviour's lanes the merged values still hold
                # the slot's inputs (take masks are disjoint), so an
                # untouched field or an unused send slot is a no-op.
                st_n = {f: (st_n[f] if st2[f] is st[f] else
                            torch.where(take, st2[f], st_n[f]))
                        for f in st_n}
                tgt_n = [tgt_n[m] if btgt[m] is None else
                         torch.where(take, btgt[m], tgt_n[m])
                         for m in range(ms)]
                wrd_n = [wrd_n[m] if bwrd[m] is None else
                         torch.where(take[None, :], bwrd[m], wrd_n[m])
                         for m in range(ms)]
                ef_n = sel(take, ctx.exit_flag, ef_n, b)
                ec_n = sel(take, ctx.exit_code, ec_n, i32)
                yf_n = sel(take, ctx.yield_flag, yf_n, b)
                ds_n = sel(take, ctx.destroy_flag, ds_n, b)
                erf_n = sel(take, ctx.error_flag, erf_n, b)
                erc_n = sel(take, ctx.error_code, erc_n, i32)
                erl_n = sel(take, ctx.error_loc, erl_n, i32)
                if sites:
                    bclm, bini, bsf = spawn_outputs(ctx, sites, meta, rows,
                                                    dev)
                    sf_n = sel(take, False if bsf is None else bsf, sf_n, b)
                    for t, (tname, n) in enumerate(sites):
                        clm_n[t] = [
                            c if g is None else torch.where(
                                take, g, -1 if c is None else c)
                            for c, g in zip(clm_n[t], bclm[t])]
                        if bini[t] is None:
                            continue
                        effects["sync"] = True
                        ini_n[t] = _merge_inits(take, bini[t], ini_n[t],
                                                meta[tname], n, rows, dev)
            if blob is not None:         # dispatches that allocated
                bused = bused + alloced.to(i32)
            if ef_n is not None:         # exit: the first code wins
                if ef is None:
                    ef, ec = z(b), z(i32)
                ec = torch.where(ef_n & ~ef,
                                 z(i32) if ec_n is None else ec_n, ec)
                ef = ef | ef_n
            if yf_n is not None and not noyield:
                stopped = yf_n if stopped is None else stopped | yf_n
            if ds_n is not None:
                dstr = ds_n if dstr is None else dstr | ds_n
            if erf_n is not None:        # errors: the latest code wins
                if errf is None:
                    errf, errc, errl = z(b), z(i32), z(i32)
                errf = errf | erf_n
                errc = torch.where(erf_n, z(i32) if erc_n is None
                                   else erc_n, errc)
                errl = torch.where(erf_n, z(i32) if erl_n is None
                                   else erl_n, errl)
            if sites:
                # A slot that claimed, or failed a wanted spawn, used up
                # one dispatch's reservations.
                spawned = z(b) if sf_n is None else sf_n
                for t in range(len(sites)):
                    clm_n[t] = [torch.full((rows,), -1, dtype=i32,
                                           device=dev) if c is None else c
                                for c in clm_n[t]]
                    for c in clm_n[t]:
                        spawned = spawned | (c >= 0)
                    sclm[t].append(torch.stack(clm_n[t]))
                    sini[t].append(ini_n[t])
                used = used + spawned.to(i32)
                if sf_n is not None:
                    sfail = sf_n if sfail is None else sfail | sf_n
            nproc = nproc + (do & in_range).to(i32)
            nbad = nbad + (do & ~in_range).to(i32)
            st = st_n
            if ms:
                stgt.append(torch.stack(tgt_n))      # [ms, rows]
                swrd.append(torch.stack(wrd_n))      # [ms, w1, rows]
            consumed.append(do)
        # Outbox: entry (k, m, r) flat with rows minor; words planar.
        if ms and batch:
            out_tgt = torch.stack(stgt).reshape(e)
            out_words = torch.stack(swrd).permute(2, 0, 1, 3).reshape(
                w1, e)
        else:
            out_tgt = torch.full((e,), -1, dtype=i32, device=dev)
            out_words = torch.zeros((w1, e), dtype=i32, device=dev)
        n_consumed = torch.stack(consumed).to(i32).sum(0, dtype=i32)
        if ef is None:
            ef, ec = z(b), z(i32)
        any_exit = ef.any()
        code = ec.index_select(0, torch.argmax(ef.to(i32)).reshape(1))[0]
        sender = ids.repeat(batch * ms)
        out = Entries(tgt=out_tgt, sender=sender, words=out_words)
        if effects["destroy"] and dstr is None:
            dstr = z(b)
        if effects["error"] and errf is None:
            errf, errc, errl = z(b), z(i32), z(i32)
        claims = tuple(torch.stack(c).reshape(-1) for c in sclm)
        inits = tuple(
            _stack_inits(ini, meta[tname], n, rows, dev)
            if effects["sync"] else None
            for ini, (tname, n) in zip(sini, sites))
        if sites:
            sfail = torch.zeros((), dtype=b, device=dev) if sfail is None \
                else sfail.any()
        res = (st, out, head_rows + n_consumed, any_exit, code,
               _isum(nproc), _isum(nbad),
               dstr if effects["destroy"] else None,
               (errf, errc, errl) if effects["error"] else None,
               claims, inits, sfail)
        if blob is None:
            return res
        zb = torch.zeros((), dtype=b, device=dev)
        zi = torch.zeros((), dtype=i32, device=dev)
        bout = (zb, zb, zi, zi, zi)
        for v in bacc:
            bout = (bout[0] | v.fail, bout[1] | v.budget_fail,
                    bout[2] + v.n_alloc, bout[3] + v.n_free,
                    bout[4] + v.n_remote)
        return res + (bout,)

    return dispatch


def _merge_inits(take, new, old, specs, n: int, rows: int, dev):
    """Select one behaviour's sync-construction planes (has, {field:
    values}, each a list over sites with None for a site it leaves
    alone) into the slot's where `take` holds."""
    has_new, vals_new = new
    if old is None:
        old = ([None] * n, {f: [None] * n for f in specs})
    has_old, vals_old = old

    def pick(x, y, fill, dtype):
        if x is None:
            return y
        return torch.where(take, x, torch.full((rows,), fill, dtype=dtype,
                                               device=dev)
                           if y is None else y)
    has = [pick(x, y, False, torch.bool) for x, y in zip(has_new, has_old)]
    vals = {f: [pick(x, y, pack.null_word(sp), _dtype_of(sp))
                for x, y in zip(vals_new[f], vals_old[f])]
            for f, sp in specs.items()}
    return has, vals


def _stack_inits(per_slot, specs, n: int, rows: int, dev):
    """The batch slots' sync-construction planes as one (has, {field:
    values}) of [batch * sites * rows], (k, site, lane) order; a value
    no behaviour wrote is the field's null word, under has = False."""
    has, vals = [], {f: [] for f in specs}
    for ini in per_slot:
        h, v = ini if ini is not None else (
            [None] * n, {f: [None] * n for f in specs})
        for s in range(n):
            has.append(torch.zeros((rows,), dtype=torch.bool, device=dev)
                       if h[s] is None else h[s])
            for f, sp in specs.items():
                vals[f].append(torch.full((rows,), pack.null_word(sp),
                                          dtype=_dtype_of(sp), device=dev)
                               if v[f][s] is None else v[f][s])
    return (torch.stack(has).reshape(-1),
            {f: torch.stack(x).reshape(-1) for f, x in vals.items()})


def _cohort_dispatch(cohort: Cohort, opts: RuntimeOptions,
                     program: Program):
    """The cohort's tick: the runnable actors' message counts, then the
    fused dispatch kernel (`pallas_fused`, ops/fused_dispatch.py) or the
    plain drain loop. A cohort whose behaviours sync-construct takes the
    plain loop under `pallas_fused` too, as in the JAX package. Returns
    (run_cohort, the FusedDispatch or None)."""
    batch = cohort.batch
    meta = spawn_meta_of(program, cohort)
    fused = None
    dispatch = None
    # A cohort that uses the blob pool takes the plain loop under
    # pallas_fused, as in the JAX package (its fused kernel has no pool).
    if opts.pallas_fused and cohort.behaviours and not cohort.uses_blobs:
        progs = fused_dispatch.trace_cohort(cohort, opts, meta)
        if fused_dispatch.eligible(cohort, progs):
            fused = dispatch = fused_dispatch.build_fused_dispatch(
                cohort, opts, meta, progs)
    if dispatch is None:
        dispatch = _plain_dispatch(cohort, opts, meta)

    def run_cohort(ts_rows, buf_rows, head_rows, occ_rows, runnable_rows,
                   ids, resv=(), blob=None):
        n_run = torch.where(runnable_rows, occ_rows.clamp(max=batch), 0)
        if blob is not None:
            return dispatch(ts_rows, buf_rows, head_rows, n_run, ids, resv,
                            blob)
        return dispatch(ts_rows, buf_rows, head_rows, n_run, ids,
                        resv) + (None,)

    return run_cohort, fused


def free_row_list(tc: Cohort, alive, occ0, dspill_pending):
    """Target cohort `tc`'s free rows this tick, in row order, padded
    with -1 to its capacity: dead, with an empty mailbox and no spilled
    message still addressed to the row (a previous life's message must
    not reach a newborn)."""
    s0, s1 = tc.local_start, tc.local_stop
    free_ok = (~alive[s0:s1] & (occ0[s0:s1] == 0)
               & (dspill_pending[s0:s1] == 0))
    n = tc.local_capacity
    pos = torch.where(free_ok, torch.cumsum(free_ok.to(torch.int32), 0)
                      - 1, n)
    out = torch.full((n + 1,), -1, dtype=torch.int32, device=alive.device)
    out[pos.long()] = s0 + torch.arange(n, dtype=torch.int32,
                                        device=alive.device)
    return out[:n]


def spawn_reservations(ch: Cohort, runnable, free_rows, base: int):
    """Spawner cohort `ch`'s reservations, per target of
    `spawn_sites_of(ch)`, as [sd * sites, rows] refs: the runnable actors,
    ranked by a prefix sum over the runnable mask, get disjoint windows of
    sd * sites free rows at the cohort's static offset
    (Program._resolve_spawns); an index past the free list, or an actor
    that cannot run, reserves -1."""
    out = []
    if not ch.spawns:
        return out
    run_c = runnable[ch.local_start:ch.local_stop]
    rank = torch.cumsum(run_c.to(torch.int32), 0) - 1
    sd = ch.spawn_dispatches
    dev = runnable.device
    for tname, sites in spawn_sites_of(ch):
        per = sd * sites
        widx = torch.where(run_c, rank * per, 0)
        idx = (ch.spawn_offsets[tname] + widx[None, None, :]
               + (torch.arange(sd, dtype=torch.int32, device=dev)
                  * sites)[:, None, None]
               + torch.arange(sites, dtype=torch.int32,
                              device=dev)[None, :, None])
        free = free_rows[tname]
        n = free.shape[0]
        pad = torch.cat([free, free.new_full((1,), -1)])
        rows = pad[torch.where(idx < n, idx, n).long()]
        refs = torch.where((rows >= 0) & run_c[None, None, :], base + rows,
                           -1)
        out.append(refs.reshape(per, -1))
    return out


def free_blob_list(used, base: int):
    """The blob pool's free slots in ascending order as global slot ids
    (≙ the JAX package's compact_mask(~blob_used)), then -1: [n + 1],
    so that the last entry is the fill of an index past the pool."""
    n = used.shape[0]
    free = ~used
    pos = torch.where(free, torch.cumsum(free.to(torch.int32), 0) - 1, n)
    out = torch.full((n + 1,), -1, dtype=torch.int32, device=used.device)
    out[pos.long()] = base + torch.arange(n, dtype=torch.int32,
                                          device=used.device)
    return out


def blob_reservations(ch: Cohort, runnable, free_blob):
    """Allocating cohort `ch`'s blob reservations, [bd, sites, rows]
    global slot ids (≙ pony_alloc on the owning actor's heap, done ahead
    of the dispatch): the runnable actors, ranked by a prefix sum over the
    runnable mask, get disjoint windows of bd * sites free slots at the
    cohort's static offset (Program._resolve_blobs); an index past the
    free list, or an actor that cannot run, reserves -1."""
    sites, bd = ch.blob_sites, ch.blob_dispatches
    dev = runnable.device
    n = free_blob.shape[0] - 1
    run_c = runnable[ch.local_start:ch.local_stop]
    rank = torch.cumsum(run_c.to(torch.int32), 0) - 1
    widx = torch.where(run_c, rank * (bd * sites), 0)
    idx = (ch.blob_offset + widx[None, None, :]
           + (torch.arange(bd, dtype=torch.int32, device=dev)
              * sites)[:, None, None]
           + torch.arange(sites, dtype=torch.int32, device=dev)[None, :,
                                                                 None])
    got = free_blob[torch.where(idx < n, idx, n).long()]
    return torch.where(run_c[None, None, :], got, -1)


def apply_claims(tc: Cohort, clist, alive, head, tail, ts, base: int,
                 nl: int):
    """Apply one target cohort's claims (`clist`: (refs, inits) of each
    spawner cohort): the claimed rows become alive with head and tail 0,
    and their fields take the null word or the sync constructor's value.
    Returns (alive, head, tail, fields, claims applied)."""
    refs = torch.cat([c for c, _ in clist])
    valid = refs >= 0
    rows = torch.where(valid, refs - base, nl).long()

    def put(col, val, at, n):
        pad = torch.cat([col, col.new_zeros((1,))])
        pad[at] = val
        return pad[:n]
    alive = put(alive, True, rows, nl)
    head = put(head, 0, rows, nl)
    tail = put(tail, 0, rows, nl)
    cols = torch.where(valid, rows - tc.local_start, tc.local_capacity)
    any_sync = any(ini is not None for _, ini in clist)
    if any_sync:
        has = torch.cat([ini[0] if ini is not None else
                         torch.zeros_like(c, dtype=torch.bool)
                         for c, ini in clist])
    ts = dict(ts)
    for fname, col in ts.items():
        null = pack.null_word(tc.atype.field_specs[fname])
        if any_sync:
            vals = torch.cat([ini[1][fname] if ini is not None else
                              torch.zeros_like(c, dtype=col.dtype)
                              for c, ini in clist])
            val = torch.where(has, vals, null)
        else:
            val = torch.full_like(refs, null, dtype=col.dtype)
        ts[fname] = put(col, val, cols, tc.local_capacity)
    return alive, head, tail, ts, _isum(valid)


def _scatter_into(dst, idx, keep, vals):
    """dst (a copy) with vals written at idx where keep; the other writes
    go to dump slots (a ``.at[idx].set(mode="drop")`` of the JAX
    package)."""
    n = dst.shape[0]
    out = torch.cat([dst, dst.new_zeros((DUMP_SLOTS,))])
    out.scatter_(0, dump_index(keep, idx.long(), n), vals.to(dst.dtype))
    return out[:n]


def _add_counts(acc, keys, n: int):
    """acc [n] int32 plus the count of each key in [0, n) of `keys`."""
    flat = keys.reshape(-1)
    return acc + counts_by_key(flat, torch.ones_like(flat), n)


def _qwait_bucket(delta):
    """Power-of-two bucket of a queue-wait delta in ticks: bucket k holds
    [2^k, 2^(k+1)), deltas clipped to >= 1, the last bucket open."""
    d = delta.clamp(min=1)
    b = torch.zeros_like(d)
    for k in range(1, QW_BUCKETS):
        b = b + (d >= (1 << k)).to(torch.int32)
    return b


def _drained(head0, head1, cap: int):
    """[cap, rows]: ring slot c of a lane held a message drained this
    tick (its count fell in [head0, head1))."""
    ci = torch.arange(cap, dtype=torch.int32, device=head0.device)[:, None]
    return torch.remainder(ci - head0[None, :], cap) < (head1 - head0)[None, :]


def profile_lanes(program: Program, opts: RuntimeOptions, st: RtState,
                  tail0, res, drain_facts, muted2):
    """The per-behaviour profiler lanes (≙ the fork's per-actor
    --ponyanalysis records, re-based on the cohort; the JAX package's
    engine.profile_lanes). Only called at analysis >= 1. From the ring
    head and tail advances: beh_runs (the drained slots of each of a
    cohort's own behaviours), the queue-wait histogram of each device
    cohort (step - the slot's enqueue stamp), coh_mute_ticks (actors
    muted at the end of the tick), beh_delivered (the fresh slots of
    every row, host rows included), beh_rejected (the compacted spill's
    behaviour ids) and the enqueue stamps of the fresh slots of device
    cohorts. `drain_facts` = [(cohort, head before, head after)] in
    device-cohort order. Returns the six updated leaves."""
    cap = opts.mailbox_cap
    nb = len(program.behaviour_table)
    s_now = st.step_no[0]
    beh_runs, beh_del = st.beh_runs, st.beh_delivered
    coh_mt, qw_hist = st.coh_mute_ticks, st.qwait_hist
    qw_enq = dict(st.qwait_enq)

    def own(ch, gid, mask):          # the cohort's own behaviour ids
        b0 = ch.behaviours[0].global_id if ch.behaviours else 0
        ok = mask & (gid >= b0) & (gid < b0 + len(ch.behaviours))
        return torch.where(ok, gid, -1)

    hist_add, mute_add = [], []
    for ch, head0, head1 in drain_facts:
        cname = ch.atype.__name__
        drained = _drained(head0, head1, cap)
        gid = st.buf[cname][:, 0, :]
        beh_runs = _add_counts(beh_runs, own(ch, gid, drained), nb)
        bidx = _qwait_bucket(s_now - qw_enq[cname])
        hist_add.append(counts_by_key(
            torch.where(drained, bidx, -1).reshape(-1),
            torch.ones((cap * ch.local_capacity,), dtype=torch.int32,
                       device=gid.device), QW_BUCKETS))
        mute_add.append(_isum(muted2[ch.local_start:ch.local_stop]))
    if hist_add:
        qw_hist = qw_hist + torch.cat(hist_add)
        coh_mt = coh_mt + torch.stack(mute_add)
    ci = torch.arange(cap, dtype=torch.int32, device=s_now.device)[:, None]
    for ch in program.cohorts:
        cname = ch.atype.__name__
        s0, s1 = ch.local_start, ch.local_stop
        n_new = res.tail[s0:s1] - tail0[s0:s1]
        fresh = torch.remainder(ci - tail0[None, s0:s1], cap) < n_new[None, :]
        gid = res.buf[cname][:, 0, :]
        beh_del = _add_counts(beh_del, own(ch, gid, fresh), nb)
        if cname in qw_enq:                          # device cohorts
            qw_enq[cname] = torch.where(fresh, s_now, qw_enq[cname])
    sp = res.spill
    beh_rej = _add_counts(st.beh_rejected,
                          torch.where(sp.tgt >= 0, sp.words[0], -1), nb)
    return beh_runs, beh_del, beh_rej, coh_mt, qw_hist, qw_enq


def phase_cost_lanes(st: RtState, all_e, drain_facts, nproc_total,
                     n_spawned, n_destroyed):
    """Per-phase work units of the tick (the JAX package's
    engine.phase_cost_lanes; analysis >= 1 only), in PHASE_NAMES order:
    valid delivery-list entries gathered, ring slots drained, behaviours
    run, and spawns plus destroys."""
    drained = torch.zeros((), dtype=torch.int32, device=nproc_total.device)
    for _ch, head0, head1 in drain_facts:
        drained = drained + (head1 - head0).sum(dtype=torch.int32)
    work = {"delivery": _isum(all_e.tgt >= 0), "drain": drained,
            "dispatch": nproc_total, "gc_mark": n_spawned + n_destroyed}
    return st.phase_cost + torch.stack(
        [work[n] for n in PHASE_NAMES]).to(torch.int32)


def trace_span_lanes(program: Program, opts: RuntimeOptions, st: RtState,
                     drain_facts, base: int):
    """The causal-tracing lanes (the JAX package's engine.trace_span_lanes;
    only called when opts.tracing). Every drained ring slot whose trace
    id is >= 0 becomes a span with a fresh even id, (span_next + rank) *
    2 + 2, its rank counted over the traced drained slots of the cohort
    in slot-major [cap, rows] order, cohorts in device order; the span
    ring takes (trace id, span id, parent span, behaviour, actor,
    enqueue tick, dispatch tick, retire tick) while it has room, and
    counts the rest as dropped (their ids are used up all the same).
    Each outbox entry (b, m, r) of a cohort inherits (trace id, span id)
    of the message in batch slot b of lane r, or (-1, 0): the two rows
    the caller appends to the cohort's outbox words (the rows-minor
    [batch, ms, rows] flatten of both dispatch paths). Returns
    (span_data, span_count, span_dropped, span_next, [[2, e_c] per
    cohort])."""
    cap = opts.mailbox_cap
    ts_cap = opts.trace_slots
    s_now = st.step_no[0]
    span_data = st.span_data
    count, dropped, nxt = st.span_count[0], st.span_dropped[0], \
        st.span_next[0]
    rows_out = []
    for ch, head0, head1 in drain_facts:
        cname = ch.atype.__name__
        rows = ch.local_capacity
        batch, ms = ch.batch, ch.max_sends
        dev = head0.device
        drained = _drained(head0, head1, cap)
        tid = st.trace_buf[cname][:, 0, :]               # [cap, rows]
        traced = (drained & (tid >= 0)).reshape(-1)      # slot-major
        rank = torch.cumsum(traced.to(torch.int32), 0,
                            dtype=torch.int32) - 1
        total = _isum(traced)
        sid = torch.where(traced, (nxt + rank) * 2 + 2, 0).to(torch.int32)
        pos = count + rank
        ok = traced & (pos < ts_cap)
        actor = (base + ch.local_start
                 + torch.arange(rows, dtype=torch.int32, device=dev))
        vals = (tid.reshape(-1), sid,
                st.trace_buf[cname][:, 1, :].reshape(-1),
                st.buf[cname][:, 0, :].reshape(-1),
                actor.expand(cap, rows).reshape(-1),
                st.qwait_enq[cname].reshape(-1),
                s_now.expand(cap * rows), (s_now + 1).expand(cap * rows))
        span_data = torch.stack([_scatter_into(span_data[k], pos, ok, v)
                                 for k, v in enumerate(vals)])
        dropped = dropped + (count + total - ts_cap).clamp(min=0)
        count = (count + total).clamp(max=ts_cap)
        nxt = nxt + total
        # Propagation rows: batch slot b of lane r is ring slot
        # (head0 + b) mod cap.
        sid2 = sid.reshape(cap, rows)
        tid_b, sid_b = [], []
        for b in range(batch):
            slot = torch.remainder(head0 + b, cap).long()[None, :]
            tb = tid.gather(0, slot)[0]
            sb = sid2.gather(0, slot)[0]
            okb = ((head1 - head0) > b) & (tb >= 0)
            tid_b.append(torch.where(okb, tb, -1))
            sid_b.append(torch.where(okb, sb, 0))
        if ms and batch:
            pair = torch.stack([torch.stack(tid_b), torch.stack(sid_b)])
            pair = pair[:, :, None, :].expand(2, batch, ms, rows)
            rows_out.append(pair.reshape(2, batch * ms * rows))
        else:
            rows_out.append(torch.zeros((2, 0), dtype=torch.int32,
                                        device=dev))
    return span_data, count, dropped, nxt, rows_out


def event_ring(opts: RuntimeOptions, st: RtState, classes, base: int):
    """The level-3 event ring (the JAX package's step 5b): the tick's
    transitions, `classes` = [(code, [nl] mask)] in code order, recorded
    class-major then by row as (code, actor, step + 1) while the ring has
    room; the rest count as dropped. Returns (ev_data, ev_count,
    ev_dropped)."""
    ev_cap = opts.analysis_events
    dev = st.head.device
    nl = classes[0][1].shape[0]
    masks = torch.cat([m for _, m in classes])
    codes = torch.cat([torch.full((nl,), c, dtype=torch.int32, device=dev)
                       for c, _ in classes])
    actors = base + torch.arange(nl, dtype=torch.int32,
                                 device=dev).repeat(len(classes))
    count = st.ev_count[0]
    rank = torch.cumsum(masks.to(torch.int32), 0, dtype=torch.int32) - 1
    total = _isum(masks)
    pos = count + rank
    ok = masks & (pos < ev_cap)
    step = (st.step_no[0] + 1).expand(masks.shape[0])
    ev = torch.stack([_scatter_into(st.ev_data[k], pos, ok, v)
                      for k, v in enumerate((codes, actors, step))])
    return (ev, (count + total).clamp(max=ev_cap),
            st.ev_dropped[0] + (count + total - ev_cap).clamp(min=0))


def queue_wait_p99(qw_hist, nd: int):
    """Worst-cohort queue-wait p99 of the cumulative histograms (the
    lower bound 2^k of the first bucket whose cumulative count reaches
    ceil(0.99 * total)), in the reference's int32 arithmetic; 0 without
    device cohorts."""
    if nd == 0:
        return torch.zeros((), dtype=torch.int32, device=qw_hist.device)
    h2 = qw_hist.reshape(nd, QW_BUCKETS)
    tot = h2.sum(1, dtype=torch.int32)
    need = torch.div(tot * 99 + 99, 100, rounding_mode="floor").clamp(min=1)
    reach = torch.cumsum(h2, 1, dtype=torch.int32) >= need[:, None]
    first = torch.argmax(reach.to(torch.int32), 1).to(torch.int32)
    one = torch.ones((), dtype=torch.int32, device=qw_hist.device)
    return torch.where(tot > 0, torch.bitwise_left_shift(one, first),
                       0).max().to(torch.int32)


def build_step(program: Program, opts: RuntimeOptions):
    """Build one whole-world scheduler tick: returns
    step(state, inject_tgt, inject_words) → (state, StepAux)."""
    if not program.frozen:
        raise RuntimeError("finalize() the Program first")
    check_supported(opts)
    if auto_fields(opts):
        raise ValueError(f"build_step: {auto_fields(opts)} still 'auto'; "
                         "Runtime.start() resolves them (tuning.resolve)")
    if program.shards > 1:
        raise unported("mesh")
    nl = program.n_local
    c = opts.mailbox_cap
    fh = program.first_host_row
    s_cap = opts.spill_cap
    dev_cohorts = program.device_cohorts
    dispatchers, fused = [], []
    for ch in dev_cohorts:
        run_cohort, fd = _cohort_dispatch(ch, opts, program)
        dispatchers.append((run_cohort, ch))
        if fd is not None:
            fused.append(fd)
    # Delivery priority levels: 0 = receiver spill, 1 = host inject,
    # 2+k = sender cohort with the k-th highest PRIORITY.
    pri_sorted = sorted({ch.priority for ch in dev_cohorts}, reverse=True)
    pri_rank = {pv: i for i, pv in enumerate(pri_sorted)}
    n_levels = 2 + max(1, len(pri_sorted))
    prio_rows = [0] * nl
    for ch in dev_cohorts:
        for r in range(ch.local_start, ch.local_stop):
            prio_rows[r] = pri_rank[ch.priority]
    cohort_layout = tuple(
        (ch.atype.__name__, ch.local_start, ch.local_stop,
         1 + ch.msg_words) for ch in program.cohorts)
    consts: Dict[Any, torch.Tensor] = {}   # device -> priority row table
    bsl = opts.blob_slots
    blob_users = any(ch.uses_blobs for ch in dev_cohorts)
    blob_allocs = any(ch.blob_sites for ch in dev_cohorts)
    tracing = opts.tracing

    def step(st: RtState, inject_tgt, inject_words
             ) -> Tuple[RtState, StepAux]:
        dev = st.head.device
        i32, b = torch.int32, torch.bool
        prio_row = consts.get(dev)
        if prio_row is None:
            prio_row = consts[dev] = torch.tensor(prio_rows, dtype=i32,
                                                  device=dev)
        base = 0
        occ0 = st.tail - st.head

        # --- 1. unmute pass (≙ ponyint_sched_unmute_senders,
        # scheduler.c:1552-1635): a sender releases only when EVERY
        # tracked muting receiver has recovered. Runs every tick; with
        # nobody muted it releases nothing.
        dspill_pending = counts_by_key(
            st.dspill_tgt.clamp(0, nl - 1),
            (st.dspill_tgt >= 0).to(i32), nl)
        can_recover = st.alive & ~st.muted
        live_cong = (((occ0 > opts.unmute_occ) | (dspill_pending > 0))
                     & can_recover)
        refs = st.mute_refs                               # [K, nl]
        has = refs >= 0
        lref = refs - base
        ref_local = (lref >= 0) & (lref < nl)
        mr = lref.clamp(0, nl - 1).long()
        local_ok = (has & ref_local & (occ0[mr] <= opts.unmute_occ)
                    & (dspill_pending[mr] == 0) & ~st.pressured[mr])
        ref_c = refs.clamp(0, nl - 1).long()
        remote_pr = st.pressured[ref_c] & has & ~ref_local
        remote_ok = (has & ~ref_local & (st.rspill_count[0] == 0)
                     & ~remote_pr)
        slot_ok = ~has | local_ok | remote_ok
        all_ok = torch.all(slot_ok, dim=0)
        shard_quiet = ((occ0.max() <= opts.unmute_occ)
                       & (st.dspill_count[0] == 0)
                       & (st.rspill_count[0] == 0)
                       & ~st.pressured.any())
        if opts.mute_age_limit > 0:
            # Aging deadlock-breaker, staggered by row (see the JAX
            # package's engine for the full argument).
            lim = opts.mute_age_limit
            threshold = lim + torch.arange(nl, dtype=i32, device=dev) % lim
            aged = st.mute_age >= threshold
            held_by_pressure = torch.any(has & st.pressured[ref_c], dim=0)
            held_by_live = torch.any(has & live_cong[ref_c], dim=0)
            aged_ok = (aged & ~held_by_pressure & ~held_by_live
                       & (~st.mute_ovf | ~st.pressured.any()))
        else:
            aged_ok = torch.zeros((nl,), dtype=b, device=dev)
        release = st.muted & ((all_ok & (~st.mute_ovf | shard_quiet))
                              | aged_ok)
        muted = st.muted & ~release
        mute_refs = torch.where(release[None, :], -1, refs)
        mute_ovf = st.mute_ovf & ~release

        # --- 1b. spawn reservations (≙ pony_create's slot allocation,
        # actor.c:688-734, done ahead of dispatch): per spawn target, this
        # tick's free rows (dead, drained, no spilled message still
        # addressed to them) compacted in row order; each runnable
        # spawner gets its disjoint window of them (`spawn_reservations`).
        runnable = st.alive & ~muted
        free_rows = {
            t: free_row_list(program.by_type_name(t), st.alive, occ0,
                             dspill_pending)
            for t in program.spawn_target_names}

        # --- 1c. the device blob pool (≙ the actor heap): working copies
        # the blob-using cohorts update in place (each with one more slot
        # that takes the writes of lanes that must not write), and this
        # tick's free slots, compacted in ascending order, from which each
        # allocating cohort hands its runnable actors disjoint windows
        # (`blob_reservations`). The JAX package skips the compaction when
        # no allocating cohort has queued work; its windows are then never
        # read, so computing it always gives the same result.
        pool = free_blob = None
        if blob_users:
            def wcopy(x):
                return torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], -1)
            pool = {"data": wcopy(st.blob_data), "used": wcopy(st.blob_used),
                    "len": wcopy(st.blob_len), "gen": wcopy(st.blob_gen),
                    "base": base}
            if blob_allocs:
                free_blob = free_blob_list(st.blob_used, base)
        blob_fail = st.blob_fail[0]
        blob_budget = st.blob_budget_fail[0]
        nb_alloc = nb_free = nb_remote = torch.zeros((), dtype=i32,
                                                     device=dev)

        # --- 2. drain + dispatch per cohort (≙ the actor run loop).
        new_type_state: Dict[str, Dict[str, torch.Tensor]] = dict(
            st.type_state)
        claim_lists: Dict[str, List[Any]] = {
            t: [] for t in program.spawn_target_names}
        spawn_fail = st.spawn_fail[0]
        head_segments: List[torch.Tensor] = []
        out_entries: List[Entries] = []
        destroy_rows: List[Tuple[int, Any]] = []
        error_rows: List[Tuple[int, Any]] = []
        exit_f = st.exit_flag[0]
        exit_c = st.exit_code[0]
        nproc_total = torch.zeros((), dtype=i32, device=dev)
        nbad_total = torch.zeros((), dtype=i32, device=dev)
        drain_facts = []   # (cohort, head before, head after): telemetry
        for run_cohort, ch in dispatchers:
            s0, s1 = ch.local_start, ch.local_stop
            ids = base + s0 + torch.arange(ch.local_capacity, dtype=i32,
                                           device=dev)
            blobd = None
            if pool is not None and ch.uses_blobs:
                blobd = dict(pool, resv=blob_reservations(
                    ch, runnable, free_blob) if ch.blob_sites else None)
            (stf, out, new_head_rows, ef, ec, nproc, nbad, dstr,
             errs, claims, inits, sfail, bout) = run_cohort(
                st.type_state[ch.atype.__name__],
                st.buf[ch.atype.__name__], st.head[s0:s1], occ0[s0:s1],
                runnable[s0:s1], ids,
                spawn_reservations(ch, runnable, free_rows, base),
                blob=blobd)
            if bout is not None:
                blob_fail = blob_fail | bout[0]
                blob_budget = blob_budget | bout[1]
                nb_alloc = nb_alloc + bout[2]
                nb_free = nb_free + bout[3]
                nb_remote = nb_remote + bout[4]
            new_type_state[ch.atype.__name__] = stf
            for (t, _), cl, ini in zip(spawn_sites_of(ch), claims, inits):
                claim_lists[t].append((cl, ini))
            if sfail is not None:
                spawn_fail = spawn_fail | sfail
            head_segments.append(new_head_rows)
            if opts.analysis >= 1:
                drain_facts.append((ch, st.head[s0:s1], new_head_rows))
            out_entries.append(out)
            destroy_rows.append((s0, dstr))
            error_rows.append((s0, errs))
            exit_c = torch.where(ef & ~exit_f, ec, exit_c)
            exit_f = exit_f | ef
            nproc_total = nproc_total + nproc
            nbad_total = nbad_total + nbad
        if fh < nl:   # host-cohort heads: the host drains those rows
            head_segments.append(st.head[fh:nl])
        new_head = (torch.cat(head_segments) if head_segments
                    else st.head)

        # --- 2b. apply the claims, before delivery, so that constructor
        # messages and same-tick sends to the newborn land: a claimed row
        # becomes alive with an empty mailbox (head and tail 0) and its
        # fields at their null words, or at the sync constructor's values
        # (ctx.spawn_sync).
        alive, tail0 = st.alive, st.tail
        n_spawned = torch.zeros((), dtype=i32, device=dev)
        for tname, clist in claim_lists.items():
            if not clist:
                continue
            tc = program.by_type_name(tname)
            (alive, new_head, tail0, new_type_state[tname],
             n_t) = apply_claims(tc, clist, alive, new_head, tail0,
                                 new_type_state[tname], base, nl)
            n_spawned = n_spawned + n_t

        # --- 2c. causal tracing (tracing on only): the spans of the
        # traced messages drained this tick, and two more word rows on
        # every outbox entry, (trace id, span id) of the dispatch that
        # emitted it; spill and delivery carry them with the payload.
        if tracing:
            (span_data2, span_count2, span_dropped2, span_next2,
             tr_rows) = trace_span_lanes(program, opts, st, drain_facts,
                                         base)
            out_entries = [o._replace(words=torch.cat([o.words, t]))
                           for o, t in zip(out_entries, tr_rows)]

        # --- 3. single device: produced messages pass straight through
        # (after the always-empty route spill, as in the reference's
        # entry order).
        out_cat = Entries(
            tgt=torch.cat([st.rspill_tgt] + [o.tgt for o in out_entries]),
            sender=torch.cat([st.rspill_sender]
                             + [o.sender for o in out_entries]),
            words=torch.cat([st.rspill_words]
                            + [o.words for o in out_entries], dim=1))
        incoming = out_cat._replace(
            tgt=torch.where(out_cat.tgt >= 0, out_cat.tgt - base, -1))

        # --- 4. delivery list: receiver spill first (oldest), then host
        # injections, then produced messages.
        inj_l = inject_tgt - base
        inj_local = torch.where((inj_l >= 0) & (inj_l < nl), inj_l, -1)
        all_e = Entries(
            tgt=torch.cat([st.dspill_tgt, inj_local, incoming.tgt]),
            sender=torch.cat([st.dspill_sender,
                              torch.full_like(inj_local, -1),
                              incoming.sender]),
            words=torch.cat([st.dspill_words, inject_words,
                             incoming.words], dim=1))
        snd_in = incoming.sender
        srow = (torch.where(snd_in >= 0, snd_in, 0) % nl).long()
        lvl_in = torch.where(snd_in >= 0, 2 + prio_row[srow], 2).to(i32)
        lvl_all = torch.cat([torch.zeros_like(st.dspill_tgt),
                             torch.ones_like(inj_local), lvl_in])
        res = deliver(st.buf, new_head, tail0, alive, all_e,
                      n_local=nl, mailbox_cap=c, spill_cap=s_cap,
                      overload_occ=opts.overload_occ, shard_base=base,
                      cohort_layout=cohort_layout,
                      mute_slots=opts.mute_slots,
                      level=lvl_all, n_levels=n_levels,
                      pressured=st.pressured,
                      cosort=opts.delivery == "cosort",
                      trace_buf=st.trace_buf if tracing else None)

        # --- 4b. destroys (≙ ponyint_actor_destroy, actor.c:570-664):
        # the slot dies at end of step, its queue is discarded (head :=
        # tail) and its flags clear. Errors: latest code per actor.
        new_tail = res.tail
        pinned, pressured = st.pinned, st.pressured
        last_error, last_error_loc = st.last_error, st.last_error_loc
        n_errors = torch.zeros((), dtype=i32, device=dev)
        for s0, errs in error_rows:
            if errs is None:
                continue
            errf, errc, errl = errs
            s1 = s0 + errf.shape[0]
            last_error = last_error.clone()
            last_error[s0:s1] = torch.where(errf, errc, last_error[s0:s1])
            last_error_loc = last_error_loc.clone()
            last_error_loc[s0:s1] = torch.where(errf, errl,
                                                last_error_loc[s0:s1])
            n_errors = n_errors + _isum(errf)
        n_destroyed = torch.zeros((), dtype=i32, device=dev)
        if any(d is not None for _, d in destroy_rows):
            dmask = torch.zeros((nl,), dtype=b, device=dev)
            for s0, dstr in destroy_rows:
                if dstr is not None:
                    dmask[s0:s0 + dstr.shape[0]] = dstr
                    n_destroyed = n_destroyed + _isum(dstr)
            alive = alive & ~dmask
            new_head = torch.where(dmask, new_tail, new_head)
            muted = muted & ~dmask
            mute_refs = torch.where(dmask[None, :], -1, mute_refs)
            mute_ovf = mute_ovf & ~dmask
            pinned = pinned & ~dmask
            pressured = pressured & ~dmask

        # --- 5. mute bookkeeping (≙ ponyint_mute_actor + mutemap insert,
        # actor.c:1171-1207): this tick's muting refs merge into each
        # newly muted sender's slot table.
        def _merge_slots(a, b_):
            both = (a >= 0) & (b_ >= 0)
            m = torch.where(a < 0, b_, torch.where(b_ < 0, a,
                                                   torch.maximum(a, b_)))
            return m, torch.any(both & (a != b_), dim=0)

        newly = res.newly_muted & alive
        became_muted = newly & ~muted
        muted2 = muted | newly
        mute_age2 = torch.where(
            muted2, torch.where(became_muted, 0, st.mute_age + 1),
            0).to(i32)
        route_refs, route_ovf = empty_mute_slots(nl, opts.mute_slots, dev)
        inc_refs, c1 = _merge_slots(res.new_mute_refs, route_refs)
        merged_refs, c2 = _merge_slots(mute_refs, inc_refs)
        mute_refs2 = torch.where(newly[None, :], merged_refs, mute_refs)
        mute_ovf2 = torch.where(
            newly, mute_ovf | res.new_mute_ovf | route_ovf | c1 | c2,
            mute_ovf)

        nrej_new = st.n_rejected[0] + res.n_rejected
        nbad_new = st.n_badmsg[0] + nbad_total
        ndl_new = st.n_deadletter[0] + res.n_deadletter
        nmut_new = st.n_mutes[0] + _isum(became_muted)
        occ_after = new_tail - new_head

        def vec(x, dtype=i32):      # per-shard "scalar" → [1]
            return x.to(dtype).reshape(1)

        # --- 5b. the event ring (analysis >= 3): the tick's transitions
        # (mute, release, overload-on, spawn, destroy, error).
        telemetry = {}
        if opts.analysis >= 3:
            err_ev = torch.zeros((nl,), dtype=b, device=dev)
            for s0, errs in error_rows:
                if errs is not None:
                    err_ev[s0:s0 + errs[0].shape[0]] = errs[0]
            over = opts.overload_occ
            classes = [(1, became_muted), (2, st.muted & ~muted & alive),
                       (3, (occ_after > over) & ~(occ0 > over)),
                       (4, alive & ~st.alive), (5, st.alive & ~alive),
                       (6, err_ev)]
            ev_data, ev_count, ev_dropped = event_ring(opts, st, classes,
                                                       base)
            telemetry.update(ev_data=ev_data, ev_count=vec(ev_count),
                             ev_dropped=vec(ev_dropped))
        # --- 5c. the profiler lanes and phase costs (analysis >= 1).
        if opts.analysis >= 1:
            (beh_runs2, beh_del2, beh_rej2, coh_mt2, qw_hist2,
             qw_enq2) = profile_lanes(program, opts, st, tail0, res,
                                      drain_facts, muted2)
            telemetry.update(
                beh_runs=beh_runs2, beh_delivered=beh_del2,
                beh_rejected=beh_rej2, coh_mute_ticks=coh_mt2,
                qwait_hist=qw_hist2, qwait_enq=qw_enq2,
                phase_cost=phase_cost_lanes(st, all_e, drain_facts,
                                            nproc_total, n_spawned,
                                            n_destroyed))
        if tracing:
            telemetry.update(trace_buf=res.trace_buf, span_data=span_data2,
                             span_count=vec(span_count2),
                             span_dropped=vec(span_dropped2),
                             span_next=vec(span_next2))
        device_pending = ((occ_after[:fh] > 0).any()
                          | (res.spill_count > 0)
                          | (st.rspill_count[0] > 0))
        false = torch.zeros((), dtype=b, device=dev)
        # Host-cohort mailboxes occupied: the window ends for the host's
        # drain (aux_go).
        host_pending = (occ_after[fh:] > 0).any() if fh < nl else false
        any_muted = muted2.any()
        overflow = st.spill_overflow[0] | res.spill_overflow
        any_pressured = pressured.any()
        any_rspill = st.rspill_count[0] > 0
        wb_new = (any_pressured.to(i32) | (any_muted.to(i32) << 1)
                  | (any_rspill.to(i32) << 2))
        nproc_cum = st.n_processed[0] + nproc_total
        ndel_cum = st.n_delivered[0] + res.n_delivered
        zero = torch.zeros((), dtype=i32, device=dev)
        if opts.analysis >= 1:
            # The occupancy aggregates, the cumulative counters and the
            # worst cohort's queue-wait p99 ride the aux (the CSV writer
            # and the window controller read them with no extra fetch).
            aggs = dict(
                occ_sum=_isum(occ_after), occ_max=occ_after.max(),
                n_muted_now=_isum(muted2),
                n_overloaded_now=_isum(occ_after > opts.overload_occ),
                n_rejected=nrej_new, n_badmsg=nbad_new,
                n_deadletter=ndl_new, n_mutes=nmut_new,
                qw_p99=queue_wait_p99(qw_hist2, len(dev_cohorts)))
        else:
            aggs = dict(occ_sum=zero, occ_max=zero, n_muted_now=zero,
                        n_overloaded_now=zero, n_rejected=zero,
                        n_badmsg=zero, n_deadletter=zero, n_mutes=zero,
                        qw_p99=zero)

        blob_leaves = {}
        if pool is not None:
            blob_leaves = dict(
                blob_data=pool["data"][:, :bsl].contiguous(),
                blob_used=pool["used"][:bsl].contiguous(),
                blob_len=pool["len"][:bsl].contiguous(),
                blob_gen=pool["gen"][:bsl].contiguous(),
                blob_fail=vec(blob_fail, b),
                blob_budget_fail=vec(blob_budget, b),
                n_blob_alloc=vec(st.n_blob_alloc[0] + nb_alloc),
                n_blob_free=vec(st.n_blob_free[0] + nb_free),
                n_blob_remote=vec(st.n_blob_remote[0] + nb_remote))

        st2 = dataclasses.replace(
            st,
            buf=res.buf, head=new_head, tail=new_tail,
            alive=alive, muted=muted2, mute_refs=mute_refs2,
            mute_age=mute_age2, mute_ovf=mute_ovf2, pinned=pinned,
            pressured=pressured,
            dspill_tgt=res.spill.tgt, dspill_sender=res.spill.sender,
            dspill_words=res.spill.words,
            dspill_count=vec(res.spill_count),
            spill_overflow=vec(overflow, b),
            exit_flag=vec(exit_f, b), exit_code=vec(exit_c),
            step_no=vec(st.step_no[0] + 1),
            n_processed=vec(nproc_cum), n_delivered=vec(ndel_cum),
            n_rejected=vec(nrej_new), n_badmsg=vec(nbad_new),
            n_deadletter=vec(ndl_new), n_mutes=vec(nmut_new),
            n_destroyed=vec(st.n_destroyed[0] + n_destroyed),
            n_spawned=vec(st.n_spawned[0] + n_spawned),
            spawn_fail=vec(spawn_fail, b),
            last_error=last_error, last_error_loc=last_error_loc,
            n_errors=vec(st.n_errors[0] + n_errors),
            plan_key=res.plan_key, plan_perm=res.plan_perm,
            plan_bounds=res.plan_bounds,
            world_bits=vec(wb_new),
            type_state=new_type_state,
            **blob_leaves, **telemetry,
        )
        aux = StepAux(
            device_pending=device_pending, host_pending=host_pending,
            exit_flag=exit_f, exit_code=exit_c,
            spill_overflow=overflow, spawn_fail=spawn_fail,
            blob_fail=blob_fail, blob_budget_fail=blob_budget,
            any_muted=any_muted,
            n_processed=nproc_cum, n_delivered=ndel_cum, **aggs)
        return st2, aux

    step.fused = fused      # the cohorts' fused kernels, built at start()
    return step


def _select(go: torch.Tensor, new, old):
    """Per-leaf torch.where(go, new, old) over a state or aux; a leaf the
    step passed through unchanged stays as it is."""
    if new is old:
        return old
    if isinstance(new, torch.Tensor):
        return torch.where(go, new, old)
    if isinstance(new, dict):
        return {k: _select(go, new[k], old[k]) for k in new}
    if isinstance(new, tuple):                       # StepAux
        return type(new)(*(_select(go, a, b) for a, b in zip(new, old)))
    return dataclasses.replace(old, **{
        f.name: _select(go, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(new)})


class StopProbe:
    """Lets the host stop enqueuing a window's ticks once the device has
    voted to stop, without synchronising. Each tick's `go` is copied to
    host memory asynchronously; a copy is read only after its CUDA event
    completed (a non-blocking query). Because a tick that does not run
    leaves the aux unchanged, `go` never turns true again once false, so
    stopping on any false reading skips only ticks that would do nothing.
    On the CPU the value is read directly (there is nothing to overlap).
    """

    SLOTS = 64

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.host = torch.zeros((self.SLOTS,), dtype=torch.bool,
                                    pin_memory=True)
            self.events = [torch.cuda.Event() for _ in range(self.SLOTS)]
        self.reset()

    def reset(self):
        """Start a window. Copies still in flight from the previous one
        may keep their slots: a new copy into a slot is ordered after the
        old one on the stream, and a slot is read only once the event of
        its latest copy completed."""
        self.stop = False
        self.pending: List[int] = []
        self.free = list(range(self.SLOTS)) if self.cuda else []

    def submit(self, go: torch.Tensor) -> bool:
        """Record this tick's predicate; True when the window has
        provably stopped (this tick and all later ones are no-ops)."""
        if not self.cuda:
            self.stop = self.stop or not bool(go)
            return self.stop
        while self.pending and self.events[self.pending[0]].query():
            i = self.pending.pop(0)
            self.stop = self.stop or not bool(self.host[i])
            self.free.append(i)
        if self.free and not self.stop:
            i = self.free.pop()
            self.host[i:i + 1].copy_(go.reshape(1), non_blocking=True)
            self.events[i].record()
            self.pending.append(i)
        return self.stop


def build_multi_step_gated(program: Program, opts: RuntimeOptions):
    """Up to `limit` scheduler ticks as one window, tick 0 gated ON
    DEVICE by the previous window's aux (≙ the reference's
    build_multi_step_gated, where a `lax.while_loop` runs
    `while (i==0 & (force|go)) | (i<limit & go)`).

    Here the window is a host loop of at most `limit` ticks, each run
    under the device predicate go = (i==0 & (force | aux_go(aux))) |
    (i>0 & aux_go(aux)): the tick is computed and its result kept only
    where go holds, and ticks_run counts the kept ticks on the device.
    This is exact: a tick that does not run leaves the aux unchanged, so
    go stays false for the rest of the window. `probe` (a StopProbe)
    lets the host stop enqueuing early without a synchronisation.
    Injections land on tick 0 only. Returns (state, last_aux,
    ticks_run) with ticks_run an int32 tensor. `multi.enqueued` counts
    the ticks enqueued on the host, run or predicated off: each one
    launches the tick's kernels once.

    delivery="pallas_mega" on an eligible program (ops/megakernel.py's
    `eligible`) returns the window kernel instead: on CUDA tensors the
    whole window is one launch of csrc/mega_window.cu, on CPU tensors it
    runs this loop, its plain version. There `enqueued` adds, for every
    launched window, the ticks it may run, and `windows` counts the
    launches. An ineligible program runs this loop, as the JAX package's
    does."""
    step = build_step(program, opts)

    def multi(st: RtState, inject_tgt, inject_words, limit: int, force,
              prev_aux: StepAux, probe: StopProbe = None):
        dev = st.head.device
        force = torch.full((), bool(force), dtype=torch.bool, device=dev)
        if probe is not None:
            probe.reset()
        aux = prev_aux
        ticks = torch.zeros((), dtype=torch.int32, device=dev)
        no_tgt = torch.full_like(inject_tgt, -1)
        no_words = torch.zeros_like(inject_words)
        for i in range(max(1, int(limit))):
            go = aux_go(aux)
            if i == 0:
                go = go | force
            if probe is not None and probe.submit(go):
                break
            it, iw = (inject_tgt, inject_words) if i == 0 else \
                (no_tgt, no_words)
            s2, a2 = step(st, it, iw)
            multi.enqueued += 1
            st = _select(go, s2, st)
            aux = _select(go, a2, aux)
            ticks = ticks + go.to(torch.int32)
        return st, aux, ticks

    multi.enqueued = 0
    multi.fused = step.fused
    multi.step = step             # one tick, for cost capture (costs.py)
    if opts.delivery == "pallas_mega" and megakernel.eligible(program, opts):
        return megakernel.MegaWindow(program, opts, multi,
                                     _plain_forced(step))
    return multi


def _plain_forced(step):
    def forced(st: RtState, inject_tgt, inject_words, limit: int):
        aux = zero_aux(st.head.device)
        for _ in range(int(limit)):
            st, aux = step(st, inject_tgt, inject_words)
        return st, aux, torch.full((), int(limit), dtype=torch.int32,
                                   device=st.head.device)
    forced.fused = step.fused     # the cohorts' fused kernels, to build
    return forced


def build_forced_window(program: Program, opts: RuntimeOptions,
                        window=None):
    """`limit` ticks of the real step, unconditionally (≙ the reference's
    build_forced_window, the tuner's calibration window): every early-exit
    fact (host_pending, exit, sticky failure flags) is ignored, so the trip
    count is exactly `limit`, and the injections are applied every tick.
    Returns forced(st, inject_tgt, inject_words, limit) → (state, aux,
    ticks) with ticks = limit as an int32 tensor, and the aux of the last
    tick (zero_aux when limit is 0).

    delivery="pallas_mega" on an eligible program takes the window
    kernel's forced spelling (the kernel on CUDA tensors): `window` is the
    MegaWindow the Runtime built at start() (`Runtime._multi_g`), so the
    kernel is traced and built once."""
    if opts.delivery == "pallas_mega" and megakernel.eligible(program, opts):
        if not isinstance(window, megakernel.MegaWindow):
            raise ValueError("build_forced_window: delivery='pallas_mega' "
                             "takes the Runtime's window kernel "
                             "(window=rt._multi_g)")
        return window.forced
    return _plain_forced(build_step(program, opts))

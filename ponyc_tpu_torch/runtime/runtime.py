"""Host driver of the PyTorch port: runtime construction, spawning,
host→device messaging and the run-to-quiescence loop (the counterpart of
``ponyc_tpu/runtime/runtime.py``).

≙ the reference's runtime bootstrap and lifecycle (src/libponyrt/sched/
start.c: pony_init sizes the world, pony_start runs until quiescence,
pony_get_exitcode returns the program's code) plus host-side actor
creation (pony_create, actor/actor.c:688-734) and external sends.

Host cohorts (actor types with HOST = True, ≙ actors on the main-thread
scheduler and `env.out`) keep their state in Python dicts and run their
behaviours here, between windows: the device delivers into their
mailbox rows like any other, a window ends when one of those rows is
occupied (`host_pending`), and the run loop drains them (`_drain_host`).
Messages from a host sender to a host target skip the device and queue
on the host fast lane (`opts.host_fastpath`).

Memory: the collector (`gc`, runtime/gc.py; `release` and `pin` move the
host's roots) runs at host boundaries every `cd_interval` ticks once the
host released an actor or the program spawns on the device, and early
under host-heap pressure (`heap`, hostmem.py). The host reads and writes
the device blob pool between windows (`blob_store`, `blob_fetch`, ...),
and owns the handles it stored until a send moves them.

The loop dispatches one window of up to `quiesce_interval` ticks per
iteration (engine.build_multi_step_gated) and reads back one small
vector of control scalars to decide termination — the analog of the
CNF/ACK quiescence vote (scheduler.c:303-480). With `pipeline=True` the
next window is enqueued behind the in-flight one before the host reads
the in-flight window's scalars; its tick 0 is gated on the device by
that window's aux, so it cancels itself when the host must act.

`Runtime(opts, device=None)` runs on the card ("cuda") unless the
caller asks for the CPU; with no CUDA device and no explicit
``device="cpu"`` it raises rather than running somewhere else.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..api import ActorTypeMeta, BehaviourDef
from ..config import (RuntimeOptions, auto_fields, check_supported,
                      unported)
from ..errors import ERROR_CODES, PonyError
from ..ops import fused_dispatch, megakernel, pack
from ..program import Program
from . import engine
from .controller import WindowController
from .state import RtState, init_state


class SpillOverflowError(RuntimeError):
    """The bounded overflow spill was exceeded — raise mailbox_cap or
    spill_cap, or let backpressure mute faster."""

    code = ERROR_CODES["SpillOverflowError"]


class SpawnCapacityError(RuntimeError):
    """A device-side spawn wanted a slot but found none."""

    code = ERROR_CODES["SpawnCapacityError"]


class BlobCapacityError(RuntimeError):
    """A device-side ctx.blob_alloc() wanted a pool slot but its window
    had none free — raise RuntimeOptions.blob_slots (or the class's
    BLOB_DISPATCHES, as the message says), or free blobs faster.
    ≙ pony_alloc exhausting the heap."""

    code = ERROR_CODES["BlobCapacityError"]


def resolve_device(device=None) -> torch.device:
    """The device a Runtime runs on: CUDA unless the caller names
    another. Asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ponyc_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class HostContext:
    """Effect collector of a host-resident behaviour (≙ running an actor
    on the main-thread scheduler, scheduler.c:1030-1035): `self` inside
    the body of a HOST = True actor type."""

    def __init__(self, rt: "Runtime", actor_id: int):
        self.rt = rt
        self.actor_id = actor_id
        self.exit_flag = False
        self.exit_code = 0
        self.yield_flag = False
        self.trace_ctx = None   # (trace id, span id) of this dispatch when
        #   causal tracing followed the message here: the sends below
        #   continue the chain

    def send(self, target, behaviour_def, *args, when=True):
        if when:
            self.rt.send(int(target), behaviour_def, *args,
                         trace=self.trace_ctx)

    def exit(self, code=0, when=True):
        if when:
            self.exit_flag = True
            self.exit_code = int(code)

    def yield_(self, when=True):
        if when:
            self.yield_flag = True


def _host_pack_args(specs, args, msg_words):
    words = np.zeros((msg_words,), np.int32)
    if len(args) != len(specs):
        raise TypeError(f"behaviour takes {len(specs)} args, got {len(args)}")
    off = 0
    for spec, v in zip(specs, args):
        if isinstance(spec, pack._VecSpec):
            dt = np.float32 if spec.base is pack.F32 else np.int32
            arr = np.asarray(v, dt).reshape(-1)
            if arr.shape[0] != spec.n:
                raise TypeError(f"argument for {spec.__name__} must have "
                                f"{spec.n} elements, got {arr.shape[0]}")
            words[off:off + spec.n] = arr.view(np.int32)
            off += spec.n
        elif spec is pack.F32:
            words[off] = np.float32(v).view(np.int32)
            off += 1
        elif spec is pack.Bool:
            words[off] = np.int32(bool(v))
            off += 1
        elif spec is pack.U32:
            words[off] = np.asarray(v, np.int64).astype(
                np.uint32).view(np.int32)
            off += 1
        elif spec in pack._NARROW:
            dt = pack.narrow_np_map()[spec]
            words[off] = np.asarray(v, np.int64).astype(dt).astype(np.int32)
            off += 1
        else:
            words[off] = np.int32(v)
            off += 1
    return words


def _host_unpack_args(specs, words):
    """A message's payload words as the behaviour's Python arguments (the
    inverse of `_host_pack_args`)."""
    out = []
    off = 0
    for spec in specs:
        if isinstance(spec, pack._VecSpec):
            blk = np.asarray(words[off:off + spec.n], np.int32)
            out.append(blk.view(np.float32) if spec.base is pack.F32
                       else blk)
            off += spec.n
            continue
        w = np.int32(words[off])
        off += 1
        if spec is pack.F32:
            out.append(float(w.view(np.float32)))
        elif spec is pack.Bool:
            out.append(bool(w))
        elif spec is pack.U32:
            out.append(int(w.view(np.uint32)))
        elif spec in pack._NARROW:
            out.append(int(w.astype(pack.narrow_np_map()[spec])))
        else:
            out.append(int(w))
    return tuple(out)


class Runtime:
    """A live actor world bound to one program layout.

    Typical use::

        rt = Runtime(opts)               # on the card; device="cpu" for CPU
        rt.declare(RingNode, 1024)
        rt.start()                       # ≙ pony_init: freeze + allocate
        refs = rt.spawn_many(RingNode, 1024)
        rt.set_fields(RingNode, refs, next_ref=np.roll(refs, -1))
        rt.send(int(refs[0]), RingNode.token, 1000)
        code = rt.run()                  # ≙ pony_start: run to quiescence
    """

    def __init__(self, opts: Optional[RuntimeOptions] = None, device=None):
        self._opts_defaulted = opts is None
        self.opts = opts or RuntimeOptions()
        check_supported(self.opts)
        self.device = resolve_device(device)
        self.program = Program(self.opts)
        self.state: Optional[RtState] = None
        self._inject_q: collections.deque = collections.deque()
        # Host fast lane (opts.host_fastpath): host-sender → host-target
        # messages, dispatched at host boundaries without touching the
        # device mailbox table (≙ inject_main, scheduler.c:179-190).
        self._host_fast_q: collections.deque = collections.deque()
        self._host_state: Dict[int, Dict[str, Any]] = {}
        self._host_errors: Dict[int, int] = {}
        self._host_error_locs: Dict[int, str] = {}
        self._exit_requested = False
        self.totals = collections.Counter()   # host-side counters
        self._free: Dict[str, List[int]] = {}
        self._freelist_key = None     # None: stale; "synced": valid
        self._exit_code = 0
        self._device_dirty = True     # force the first window of a run
        self.steps_run = 0
        self._controller: Optional[WindowController] = None
        self._qi_auto = False
        self._qi_loaded = 0
        self.tuning_record: Optional[Dict[str, Any]] = None   # set by
        #   start() when delivery, pallas or pallas_fused is "auto"
        #   (tuning.resolve): source, variants, table, winner, chosen,
        #   detail, cache_path
        self._state_epoch = 0
        self._rl_windows = 0          # retired windows (cache write-back)
        # The collector and the blob pool (host side).
        self._gc_fn = None
        self._ever_released = False
        self._last_gc_step = 0
        self._next_gc = self.opts.gc_initial   # ≙ heap.c next_gc
        self._idle_boundaries = 0     # skipped host-only boundaries; they
        #   count toward the cd_interval cadence
        self._heap = None
        self._host_blobs: set = set()  # handles the host owns (GC roots)
        self._blob_epoch = None       # state epoch of the pool cache below
        self._blob_cache = None       # host (used, gen), and the lowest
        #   slot that may be free
        self._pool_own = None         # state epoch whose pool leaves the
        #   host blob ops cloned, and may write in place
        # Telemetry: host behaviours' runs (the device lanes never see
        # them; profile() merges both), the tracer (causal tracing on)
        # and the analysis hook (attached by run() at analysis >= 1).
        self._beh_host_runs: collections.Counter = collections.Counter()
        self._tracer = None
        self._analysis = None
        self._last_retire_t = None    # host clock at the last retire
        self._last_counters: Dict[str, int] = {}   # cumulative aux
        #   counters at the last retire (totals["processed"], ...)

    @property
    def state(self) -> Optional[RtState]:
        return self._state

    @state.setter
    def state(self, v) -> None:
        # Any state write may have created device work the last window's
        # aux cannot know about: the quiescence skip must not trust it,
        # and a window in flight when the write landed is not
        # authoritative (its epoch no longer matches). It may also have
        # claimed or freed slots (device spawns and destroys): the host
        # freelists are stale until `_rebuild_freelists`.
        self._state = v
        self._freelist_key = None
        self._device_dirty = True
        self._state_epoch = getattr(self, "_state_epoch", 0) + 1

    # ---- construction (≙ pony_init) ----
    def declare(self, atype: ActorTypeMeta, capacity: int) -> "Runtime":
        self.program.declare(atype, capacity)
        return self

    def start(self) -> "Runtime":
        if self._opts_defaulted:
            overrides = {}
            for atype, _cap in self.program._declared:
                overrides.update(getattr(atype, "RUNTIME_DEFAULTS", {}))
            if overrides:
                self.opts = dataclasses.replace(self.opts, **overrides)
                check_supported(self.opts)
                self.program.opts = self.opts
        if self.opts.pin >= 0:
            raise unported("observability")     # pin: slice 11
        self.program.finalize()
        self.state = init_state(self.program, self.opts, self.device)
        from .. import tuning
        if auto_fields(self.opts):
            # Resolve "auto" formulation choices to measured winners
            # before the window is built: the engine only ever sees
            # concrete options. Calibration runs on throwaway clones of
            # the fresh state; only delivery, pallas and pallas_fused may
            # change, none of which changes the layout or the state.
            self.opts, self.tuning_record = tuning.resolve(
                self.program, self.opts, self.state)
            self.program.opts = self.opts
        # Building the window validates the program (under pallas_fused
        # or delivery="pallas_mega" every body is traced for the kernel,
        # and one the kernel cannot run raises here). A kernel that
        # calibration built is loaded from ops/_build.py's cache.
        self._multi_g = engine.build_multi_step_gated(self.program,
                                                      self.opts)
        if self.device.type == "cuda" and self._multi_g.fused:
            fused_dispatch.compile_all(self._multi_g.fused)
        if self.device.type == "cuda" and isinstance(
                self._multi_g, megakernel.MegaWindow):
            self._multi_g.build()
        qi = self.opts.quiesce_interval
        self._qi_auto = qi == "auto"
        if self._qi_auto:
            qi = tuning.resolve_quiesce_interval(self.program, self.opts,
                                                 self.device)
            lo = self.opts.quiesce_interval_min
            hi = self.opts.quiesce_interval_max
        else:
            qi = max(1, int(qi))
            lo = hi = qi
        self._qi_loaded = qi
        self._controller = WindowController(qi, lo, hi)
        self.opts = dataclasses.replace(self.opts, quiesce_interval=qi)
        self.program.opts = self.opts
        self._probe = engine.StopProbe(self.device)
        self._zero_aux = engine.zero_aux(self.device)
        # Inject buffers carry the trace rows when tracing is on.
        w1 = 1 + self.opts.msg_words + self.opts.trace_lanes
        k = self.opts.inject_slots
        if self.opts.tracing:
            from ..tracing import Tracer
            self._tracer = Tracer(
                self.opts.trace_sample, self.opts.trace_seed,
                beh_names=[f"{b.actor_type.__name__}.{b.name}"
                           for b in self.program.behaviour_table])
        self._empty_inject = (
            torch.full((k,), -1, dtype=torch.int32, device=self.device),
            torch.zeros((w1, k), dtype=torch.int32, device=self.device))
        if self.device.type == "cuda":
            # A small ring of pinned rows: at most two windows are in
            # flight, and a row is reused only after its window retired.
            self._aux_host = torch.zeros((4, len(engine.StepAux._fields)
                                          + 1), dtype=torch.int32,
                                         pin_memory=True)
            self._aux_slot = 0
        for cohort in self.program.cohorts:
            self._free[cohort.atype.__name__] = list(
                range(cohort.capacity - 1, -1, -1))
        return self

    def _replace(self, **kw) -> RtState:
        return dataclasses.replace(self.state, **kw)

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(device=self.device,
                                                 dtype=dtype)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host int32 array → device without synchronising the stream
        (a copy from pageable memory would): staged through pinned
        memory and copied asynchronously on CUDA."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.int32))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # ---- spawning (≙ pony_create, actor.c:688-734) ----
    def spawn(self, atype: ActorTypeMeta, **fields) -> int:
        """Allocate one actor (see `spawn_many`); returns its id."""
        return int(self.spawn_many(atype, 1, **{
            k: np.asarray([v]) for k, v in fields.items()})[0])

    def spawn_many(self, atype: ActorTypeMeta, count: int,
                   **fields) -> np.ndarray:
        """Allocate `count` slots of a cohort and set initial state
        columns (scalars broadcast, or [count] arrays). Returns the global
        actor ids. Once the device may have claimed or freed slots
        (device spawns, destroys), the freelists are first rebuilt from
        the device state, at most once per state write."""
        if self.state is None:
            raise RuntimeError("call start() before spawn()")
        cohort = self.program.by_type[atype]
        unknown = set(fields) - set(atype.field_specs)
        if unknown:
            raise TypeError(f"{atype.__name__} has no fields {unknown}")
        self._check_ref_fields(atype, fields)
        if not cohort.host and (self.program.has_device_spawns
                                or self.steps_run) \
                and self._freelist_key is None:
            self._rebuild_freelists()
        fkey = self._freelist_key
        free = self._free[atype.__name__]
        if len(free) < count:
            raise RuntimeError(
                f"cohort {atype.__name__} capacity exhausted "
                f"({cohort.capacity} declared)")
        slots = np.array([free.pop() for _ in range(count)], np.int64)
        ids = np.asarray(cohort.slot_to_gid(slots), np.int32)
        if cohort.host:
            # A host actor's state lives here, not in device columns.
            for i, gid in enumerate(ids):
                st = {}
                for fname, spec in atype.field_specs.items():
                    v = np.asarray(fields.get(
                        fname, -1 if pack.is_ref(spec) else 0))
                    st[fname] = v.reshape(-1)[i % max(v.size, 1)].item() \
                        if v.ndim else v.item()
                self._host_state[int(gid)] = st
            type_state = self.state.type_state
        else:
            cols = self._tensor(cohort.slot_to_col(slots), torch.int64)
            ts = dict(self.state.type_state[atype.__name__])
            for fname, spec in atype.field_specs.items():
                col = ts[fname].clone()
                if fname in fields:
                    val = self._tensor(fields[fname], col.dtype)
                    col[cols] = val.expand(count) if val.ndim == 0 else val
                else:
                    # Reused slots must not leak a previous life's state.
                    col[cols] = pack.null_word(spec)
                ts[fname] = col
            type_state = {**self.state.type_state, atype.__name__: ts}
        gids = self._tensor(ids, torch.int64)
        alive = self.state.alive.clone()
        alive[gids] = True
        pinned = self.state.pinned.clone()
        pinned[gids] = True
        self.state = self._replace(type_state=type_state, alive=alive,
                                   pinned=pinned)
        # Our own pops kept the freelists in step with the state.
        self._freelist_key = fkey
        return ids

    def _rebuild_freelists(self) -> None:
        """Every cohort's freelist from the device state. A slot is free
        only if it is dead, its mailbox is drained and no message
        addressed to it waits in the spill: the condition the device's
        own reservations use (engine.free_row_list), so a host spawn
        never takes a row the device claimed, nor one that a previous
        life's spilled message would reach."""
        st = self.state
        alive = st.alive.cpu().numpy()
        occ = (st.tail - st.head).cpu().numpy()
        dsp = st.dspill_tgt.cpu().numpy()
        rsp = st.rspill_tgt.cpu().numpy()
        n = self.program.total
        spill_hit = np.zeros((n,), bool)
        spill_hit[dsp[(dsp >= 0) & (dsp < n)]] = True
        spill_hit[rsp[(rsp >= 0) & (rsp < n)]] = True
        free_ok = ~alive & (occ == 0) & ~spill_hit
        for cohort in self.program.device_cohorts:
            # Highest slot first, as the initial freelist is ordered.
            slots = np.arange(cohort.capacity - 1, -1, -1)
            gids = np.asarray(cohort.slot_to_gid(slots))
            self._free[cohort.atype.__name__] = [
                int(x) for x in slots[free_ok[gids]]]
        self._freelist_key = "synced"

    def set_fields(self, atype: ActorTypeMeta, ids, **fields):
        """Overwrite state columns for existing actors (host-side poke,
        e.g. wiring refs once ids are known). ids are global actor ids."""
        cohort = self.program.by_type[atype]
        self._check_ref_fields(atype, fields)
        if cohort.host:
            for i, aid in enumerate(np.asarray(ids).reshape(-1)):
                st = self._host_state.setdefault(int(aid), {})
                for fname, v in fields.items():
                    v = np.asarray(v).reshape(-1)
                    st[fname] = v[i % v.size].item()
            return
        cols = self._tensor(cohort.gid_to_col(np.asarray(ids)), torch.int64)
        ts = dict(self.state.type_state[atype.__name__])
        for fname, v in fields.items():
            col = ts[fname].clone()
            col[cols] = self._tensor(v, col.dtype)
            ts[fname] = col
        self.state = self._replace(
            type_state={**self.state.type_state, atype.__name__: ts})

    # ---- sendability checks (≙ type/safeto.c + expr/call.c at the host
    # boundary; out-of-range ids dead-letter on the device) ----
    def _check_send_target(self, target: int, bdef: BehaviourDef) -> None:
        if 0 <= target < self.program.total:
            owner = self.program.cohort_of(int(target)).atype.__name__
            want = bdef.actor_type.__name__
            if owner != want:
                raise TypeError(
                    f"sendability: actor {target} is a {owner}; it cannot "
                    f"receive {want}.{bdef.name}")

    def _check_ids_in_cohort(self, v, want: str, what: str) -> None:
        v = np.asarray(v, np.int64).reshape(-1)
        nl = self.program.n_local
        c = self.program.by_type_name(want)
        lid = v % max(nl, 1)
        bad = ((v >= 0) & (v < self.program.total)
               & ((lid < c.local_start) | (lid >= c.local_stop)))
        if bad.any():
            x = int(v[bad][0])
            owner = self.program.cohort_of(x).atype.__name__
            raise TypeError(
                f"sendability: {what} expects Ref[{want}] but id {x} "
                f"is a {owner}")

    def _check_ref_args(self, specs, args, what: str) -> None:
        for spec, v in zip(specs, args):
            want = pack.ref_target(spec)
            if want is not None:
                self._check_ids_in_cohort(v, want, what)

    def _check_ref_fields(self, atype: ActorTypeMeta, fields) -> None:
        for fname, v in fields.items():
            want = pack.ref_target(atype.field_specs.get(fname))
            if want is not None:
                self._check_ids_in_cohort(
                    v, want, f"field {atype.__name__}.{fname}")

    # ---- external sends (≙ pony_sendv from outside the runtime) ----
    def _check_host_iso_blob(self, h: int) -> None:
        """An iso Blob handle leaving the host must be host-owned (in
        _host_blobs: blob_store mints ownership, host delivery of an iso
        Blob argument transfers it). Anything else — a second send, a
        stale handle, a forged int — is an aliased move, rejected as
        HostHeap.send_iso and the device trace's use-after-move are
        (null, -1, rides freely)."""
        if h >= 0 and h not in self._host_blobs:
            from ..hostmem import CapabilityError
            raise CapabilityError(
                f"capability: aliased move — iso blob handle {h} is not "
                "owned by the host (already sent, freed, or never "
                "obtained via blob_store/host delivery); an iso is "
                "moved-unique — use a BlobVal parameter for shared "
                "payloads")

    def _move_host_blobs(self, specs, cols) -> None:
        """Iso Blob arguments of a send leave the host: check each is
        host-owned, then drop the host's roots (the in-flight message
        keeps the blob alive until its receiver owns it). Val handles
        alias: the host keeps its root until blob_release."""
        if self.opts.blob_slots <= 0:
            return
        isos = [np.asarray(c).reshape(-1) for spec, c in zip(specs, cols)
                if pack.is_blob(spec) and not pack.is_blob_val(spec)]
        for col in isos:
            for a in col:
                self._check_host_iso_blob(int(a))
        for col in isos:
            for a in col:
                self._host_blobs.discard(int(a))

    def _trace_context(self, trace):
        """A send's causal-trace context as (trace id, parent span), or
        (-1, 0) untraced. `trace`: None, the deterministic sampler
        decides (1 in trace_sample); an int, an explicit trace id (always
        traced, its root span got or created); a (trace id, span id)
        tuple, the continuation of a span (a host behaviour's sends)."""
        tr = self._tracer
        if tr is None:
            return -1, 0
        step = self.steps_run
        if isinstance(trace, tuple):
            return int(trace[0]), int(trace[1])
        if trace is not None:
            tid = int(trace)
            return tid, tr.root_span(tid, step)
        if tr.sample():
            return tr.begin(step)
        return -1, 0

    def send(self, target: int, behaviour_def: BehaviourDef, *args,
             trace=None):
        """Queue one message for `target` (≙ pony_sendv from outside the
        runtime). `trace` (causal tracing on): see `_trace_context`."""
        if behaviour_def.global_id is None:
            raise RuntimeError(f"{behaviour_def} not part of this program")
        self._check_send_target(int(target), behaviour_def)
        self._check_ref_args(behaviour_def.arg_specs, args,
                             f"{behaviour_def.actor_type.__name__}."
                             f"{behaviour_def.name}")
        tlanes = self.opts.trace_lanes
        words = np.zeros((1 + self.opts.msg_words + tlanes,), np.int32)
        words[0] = behaviour_def.global_id
        words[1:1 + self.opts.msg_words] = _host_pack_args(
            behaviour_def.arg_specs, args, self.opts.msg_words)
        tctx = None
        if tlanes:
            tid, psid = self._trace_context(trace)
            words[-2], words[-1] = tid, psid
            if tid >= 0:
                tctx = (tid, psid)
        # Iso payloads move with the message (≙ the gc.c send handler),
        # after packing validated, so a failed send never poisons a
        # handle: a host-heap handle goes in flight (hostmem.HostHeap),
        # a blob handle stops being a host root.
        if self._heap is not None:
            for spec, a in zip(behaviour_def.arg_specs, args):
                if (pack.cap_mode(spec) == "iso"
                        and not pack.is_blob(spec) and int(a) > 0):
                    self._heap.send_iso(int(a))
        self._move_host_blobs(behaviour_def.arg_specs, args)
        # Host senders (the API and host behaviours both run here) to
        # host targets take the fast lane; everything else rides the
        # device inject path. A sender's messages to one receiver always
        # take one lane, so per-sender-pair FIFO holds.
        if (self.opts.host_fastpath
                and 0 <= int(target) < self.program.total
                and self.program.cohort_of(int(target)).host):
            # The fast lane never touches the device: the trace context
            # rides the queue entry.
            self._host_fast_q.append((int(target), words, tctx))
        else:
            self._inject_q.append((int(target), words))

    def bulk_send(self, targets, behaviour_def: BehaviourDef, *arg_cols,
                  trace=None):
        """Mass-enqueue one message per (distinct) target directly into
        the device mailboxes — the setup path for benchmark-scale
        seeding. Targets must be unique within one call.

        `trace` (causal tracing on): an explicit trace id every seeded
        message joins (one root, a branch each). None: untraced (the
        sampler never fires here)."""
        targets = np.asarray(targets, np.int64)
        if len(np.unique(targets)) != len(targets):
            raise ValueError("bulk_send targets must be distinct; use "
                             "send() for repeated targets")
        self._check_ids_in_cohort(
            targets, behaviour_def.actor_type.__name__,
            f"bulk_send target of {behaviour_def.actor_type.__name__}."
            f"{behaviour_def.name}")
        self._check_ref_args(behaviour_def.arg_specs, arg_cols,
                             f"{behaviour_def.actor_type.__name__}."
                             f"{behaviour_def.name}")
        self._move_host_blobs(behaviour_def.arg_specs, arg_cols)
        k = len(targets)
        words = np.zeros((k, 1 + self.opts.msg_words), np.int32)
        words[:, 0] = behaviour_def.global_id
        specs = behaviour_def.arg_specs
        if len(arg_cols) != len(specs):
            raise TypeError(
                f"behaviour takes {len(specs)} args, got {len(arg_cols)}")
        off = 1
        for spec, col in zip(specs, arg_cols):
            col = np.asarray(col)
            if isinstance(spec, pack._VecSpec):
                if col.shape != (k, spec.n):
                    raise TypeError(
                        f"bulk_send column for {spec.__name__} must have "
                        f"shape ({k}, {spec.n}), got {col.shape}")
                dt = np.float32 if spec.base is pack.F32 else np.int32
                blk = np.ascontiguousarray(col.astype(dt))
                words[:, off:off + spec.n] = blk.view(np.int32)
                off += spec.n
            elif spec is pack.F32:
                words[:, off] = col.astype(np.float32).view(np.int32)
                off += 1
            else:
                words[:, off] = col.astype(np.int32)
                off += 1
        tg = self._tensor(targets, torch.int64)
        t_at = self.state.tail[tg].cpu().numpy()
        occ = t_at - self.state.head[tg].cpu().numpy()
        if (occ >= self.opts.mailbox_cap).any():
            full = targets[occ >= self.opts.mailbox_cap]
            raise RuntimeError(
                f"bulk_send would overflow {len(full)} full mailbox(es) "
                f"(first target {int(full[0])}); drain with run() first or "
                "raise mailbox_cap")
        slot = self._tensor(t_at.astype(np.int64) % self.opts.mailbox_cap,
                            torch.int64)
        cname = behaviour_def.actor_type.__name__
        cohort = self.program.by_type_name(cname)
        cols = self._tensor(cohort.gid_to_col(targets), torch.int64)
        w1c = 1 + cohort.msg_words
        cbuf = self.state.buf[cname].clone()
        cbuf[slot, :, cols] = self._tensor(words[:, :w1c])
        tail = self.state.tail.clone()
        tail[tg] += 1
        extra = {}
        if self._tracer is not None:
            # Stamp (or clear: ring slots are reused, and a stale lane
            # would adopt an earlier message's trace) every written
            # slot's trace rows.
            lanes = np.full((k, 2), -1, np.int32)
            lanes[:, 1] = 0
            if trace is not None:
                tid = int(trace)
                lanes[:, 0] = tid
                lanes[:, 1] = self._tracer.root_span(tid, self.steps_run)
            tb = self.state.trace_buf[cname].clone()
            tb[slot, :, cols] = self._tensor(lanes)
            extra["trace_buf"] = {**self.state.trace_buf, cname: tb}
        if cname in self.state.qwait_enq:
            # The profiler's enqueue stamp (analysis >= 1): the seeding
            # bypasses the delivery that writes it, so the queue waits of
            # seeded messages count from this boundary.
            qe = self.state.qwait_enq[cname].clone()
            qe[slot, cols] = self.steps_run
            extra["qwait_enq"] = {**self.state.qwait_enq, cname: qe}
        self.state = self._replace(buf={**self.state.buf, cname: cbuf},
                                   tail=tail, **extra)

    def _drain_inject_tracked(self):
        """The next inject batch (targets [K], words [1+W, K]) and the
        consumed (target, words) pairs in order, so a gated-out window
        can re-queue them. At most one drain batch per target per window
        (host-side flow control, as in the reference)."""
        if not self._inject_q:
            return (*self._empty_inject, [])
        k = self.opts.inject_slots
        w1 = 1 + self.opts.msg_words + self.opts.trace_lanes
        tgt = np.full((k,), -1, np.int32)
        words = np.zeros((w1, k), np.int32)
        taken: Dict[int, int] = {}
        quota: Dict[int, int] = {}
        held: List[Any] = []
        consumed: List[Any] = []
        i = 0
        while i < k and self._inject_q:
            t, w = self._inject_q.popleft()
            q = quota.get(t)
            if q is None:
                q = quota[t] = (self.program.cohort_of(t).batch
                                if 0 <= t < self.program.total
                                else self.opts.batch)
            c = taken.get(t, 0)
            if c >= q:
                held.append((t, w))
                continue
            taken[t] = c + 1
            consumed.append((t, w))
            tgt[i] = t
            words[:, i] = w
            i += 1
        self._inject_q.extendleft(reversed(held))
        return self._upload(tgt), self._upload(words), consumed

    # ---- host-cohort dispatch (≙ the main-thread scheduler's path) ----
    def _drain_host(self) -> bool:
        """Run the host behaviours of every message waiting in a host
        cohort's mailbox rows, each actor's in FIFO order up to a yield,
        and write the rows' heads back. Returns whether any ran."""
        fh, nl = self.program.first_host_row, self.program.n_local
        if fh >= nl:
            return False
        st = self.state
        ht = torch.stack([st.head[fh:nl], st.tail[fh:nl]]).cpu().numpy()
        head, pending = ht[0], ht[1] - ht[0]
        if not pending.any():
            return False
        c = self.opts.mailbox_cap
        bufs: Dict[str, np.ndarray] = {}
        tbufs: Dict[str, np.ndarray] = {}     # the trace rows (tracing)
        new_head = head.astype(np.int64)
        for i in np.nonzero(pending)[0]:
            aid = fh + int(i)
            cohort = self.program.cohort_of(aid)
            cname = cohort.atype.__name__
            cbuf = bufs.get(cname)
            if cbuf is None:       # [cap, 1 + W_c, capacity], the ring
                cbuf = bufs[cname] = st.buf[cname].cpu().numpy()
                if self._tracer is not None:      # [cap, 2, capacity]
                    tbufs[cname] = st.trace_buf[cname].cpu().numpy()
            col = int(cohort.gid_to_col(aid))
            consumed = 0
            for k in range(int(pending[i])):
                slot = (int(head[i]) + k) % c
                msg = cbuf[slot, :, col]
                tctx = None
                if self._tracer is not None:
                    tlane = tbufs[cname][slot, :, col]
                    if int(tlane[0]) >= 0:
                        tctx = (int(tlane[0]), int(tlane[1]))
                consumed += 1
                ctx = self._dispatch_host_msg(aid, cohort, int(msg[0]),
                                              msg[1:], trace_ctx=tctx)
                if ctx is not None and ctx.yield_flag:
                    break
            new_head[i] = head[i] + consumed
        head_all = st.head.clone()
        head_all[fh:nl] = self._upload(         # heads wrap as int32
            (new_head & 0xffffffff).astype(np.uint32).view(np.int32))
        self.state = self._replace(head=head_all)
        return True

    def _dispatch_host_msg(self, aid: int, cohort, gid: int, payload,
                           trace_ctx=None):
        """Dispatch one message to a host-resident actor (shared by the
        mailbox drain and the fast lane). Returns the HostContext, or
        None for a message its type has no behaviour for. `trace_ctx`,
        the message's (trace id, parent span) where tracing followed it
        here: the dispatch becomes an odd host span, and the behaviour's
        sends continue the chain."""
        table = self.program.behaviour_table
        bdef = table[gid] if 0 <= gid < len(table) else None
        if bdef is None or bdef.actor_type is not cohort.atype:
            self.totals["badmsg"] += 1
            return None
        ctx = HostContext(self, aid)
        if trace_ctx is not None and self._tracer is not None:
            tid, psid = trace_ctx
            ctx.trace_ctx = (tid, self._tracer.host_span(
                tid, psid, gid, aid, self.steps_run))
        st = self._host_state.get(aid, {})
        args = _host_unpack_args(bdef.arg_specs, payload)
        if self._heap is not None:
            # Delivery completes an iso move: the receiver may peek or
            # unbox now (≙ the gc.c recv handler).
            for spec, a in zip(bdef.arg_specs, args):
                if pack.cap_mode(spec) == "iso" and int(a) > 0:
                    self._heap.receive(int(a))
        if self.opts.blob_slots > 0:
            # An iso Blob delivered to a host actor is the host's now (a
            # GC root, and legitimately sent on).
            for spec, a in zip(bdef.arg_specs, args):
                if (pack.is_blob(spec) and not pack.is_blob_val(spec)
                        and int(a) >= 0):
                    self._host_blobs.add(int(a))
        try:
            st2 = bdef.fn(ctx, st, *args)
        except PonyError as e:
            # ≙ a behaviour-local try ... else (int-coded errors): the
            # code is recorded and the actor goes on.
            self._host_errors[aid] = e.code
            self._host_error_locs[aid] = e.loc
            self.totals["host_errors"] += 1
            st2 = st
        self._host_state[aid] = st2 if st2 is not None else st
        self.totals["host_processed"] += 1
        if self.opts.analysis >= 1:
            self._beh_host_runs[int(gid)] += 1
        if ctx.exit_flag:
            self._exit_code = ctx.exit_code
            self._exit_requested = True
        return ctx

    def _drain_host_fast(self, budget: int) -> bool:
        """Dispatch queued fast-lane messages (host → host sends) up to
        `budget`; leftovers keep the run loop busy. A target with no host
        state was never spawned: the message dead-letters, as a send to a
        dead device actor does."""
        q = self._host_fast_q
        if not q:
            return False
        n = 0
        yielded = set()      # actors that yielded: their batch stops
        held = []            # their remaining messages, in order
        while q and n < budget:
            aid, w, tctx = q.popleft()
            if aid in yielded:
                held.append((aid, w, tctx))
                continue
            n += 1
            if aid not in self._host_state:
                self.totals["deadletter_host"] += 1
                continue
            ctx = self._dispatch_host_msg(
                aid, self.program.cohort_of(aid), int(w[0]),
                w[1:1 + self.opts.msg_words], trace_ctx=tctx)
            if ctx is not None and ctx.yield_flag:
                # ≙ the device drain honouring yield mid-batch
                # (actor.c:675-679); the actor's queue keeps its order.
                yielded.add(aid)
            if self._exit_requested:
                break
        q.extendleft(reversed(held))
        return True

    # ---- the run loop ----
    def _dispatch_window(self, budget: int, force: bool, prev_aux,
                         pipelined: bool = False) -> Dict[str, Any]:
        """Enqueue one gated window and start the non-blocking copy of
        its control scalars; returns the in-flight record. A window
        enqueued behind an unretired one (`pipelined`) leaves the device
        no gap; any other is charged the host's time since the last
        retire (the analysis CSV's host_gap_us)."""
        gap_ns = 0 if pipelined or self._last_retire_t is None else \
            max(0, int((time.perf_counter() - self._last_retire_t) * 1e9))
        inj_t, inj_w, consumed = self._drain_inject_tracked()
        st2, aux, kdev = self._multi_g(
            self.state, inj_t, inj_w, max(1, budget), force, prev_aux,
            self._probe)
        self.state = st2
        epoch = self._state_epoch
        vec = engine.aux_vector(aux, kdev)
        event = None
        if self.device.type == "cuda":
            host = self._aux_host[self._aux_slot]
            self._aux_slot = (self._aux_slot + 1) % 4
            host.copy_(vec, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            vec = host
        return {"aux": aux, "vec": vec, "event": event,
                "budget": int(budget), "consumed": consumed,
                "epoch": epoch, "gap_ns": gap_ns}

    def _retire_window(self, win: Dict[str, Any]):
        """Wait for an in-flight window's scalars and fold them into host
        accounting. A gated-out window (0 ticks) changed nothing: its
        injections go back to the front of the queue."""
        if win["event"] is not None:
            win["event"].synchronize()
        k, a = engine.aux_from_vector(win["vec"].tolist())
        self._last_retire_t = time.perf_counter()
        if k == 0:
            if win["consumed"]:
                self._inject_q.extendleft(reversed(win["consumed"]))
            return 0, a
        if self._state_epoch == win["epoch"]:
            self._device_dirty = False
        self.steps_run += k
        if self.opts.debug_checks:
            self.check_invariants()
        # The aux counters are cumulative int32: accumulate their mod 2^32
        # deltas, so the fetch cadence does not matter.
        for key, cur in (("processed", a.n_processed & 0xFFFFFFFF),
                         ("delivered", a.n_delivered & 0xFFFFFFFF)):
            last = self._last_counters.get(key, 0)
            self.totals[key] += (cur - last) & 0xFFFFFFFF
            self._last_counters[key] = cur
        self._rl_windows += 1
        attention = (a.host_pending or a.exit_flag or a.spill_overflow
                     or a.spawn_fail or a.blob_fail or a.blob_budget_fail)
        self._controller.observe(k, win["budget"], attention,
                                 qw_p99=a.qw_p99)
        if self._analysis is not None:
            self._analysis.window(a, ticks=k, gap_us=win["gap_ns"] / 1e3)
        return k, a

    def _fatal_checks(self, a) -> None:
        if a.spill_overflow:
            raise SpillOverflowError(
                f"spill overflow at step {self.steps_run}")
        if a.spawn_fail:
            raise SpawnCapacityError(
                f"device spawn found no free slot by step {self.steps_run}")
        if a.blob_fail:
            raise BlobCapacityError(
                f"device blob_alloc found no free pool slot by step "
                f"{self.steps_run} — the pool is exhausted: raise "
                "RuntimeOptions.blob_slots, or free blobs "
                "(ctx.blob_free) faster")
        if a.blob_budget_fail:
            raise BlobCapacityError(
                f"device blob_alloc exceeded its per-tick reservation "
                f"budget by step {self.steps_run} — more allocating "
                "dispatches than BLOB_DISPATCHES in one tick (free "
                "pool slots may remain): raise the actor class's "
                "BLOB_DISPATCHES (or lower its batch)")

    @staticmethod
    def _clean_busy(a) -> bool:
        """Host-side twin of engine.aux_go."""
        return (a.device_pending and not a.host_pending
                and not a.exit_flag and not a.spill_overflow
                and not a.spawn_fail and not a.blob_fail
                and not a.blob_budget_fail)

    def run(self, max_steps: Optional[int] = None) -> int:
        """Run windows until quiescence, exit, or `max_steps` ticks
        (≙ pony_start). Returns the exit code."""
        if self.state is None:
            raise RuntimeError("call start() first")
        if self.opts.analysis >= 1 and self._analysis is None:
            from .. import analysis as _analysis_mod
            _analysis_mod.attach(self)
        max_steps = max_steps or self.opts.max_steps
        ctrl = self._controller
        pipelining = bool(self.opts.pipeline)
        steps_this_run = 0
        skipped = 0
        a = None          # newest retired aux; None forces a first window
        win = None        # the one in-flight (unretired) window
        try:
            while True:
                if win is None:
                    # A boundary where the device is provably quiescent
                    # and nothing needs injecting is host-only: skip the
                    # device dispatch (counts against max_steps).
                    if (a is not None and not a.device_pending
                            and not a.host_pending and not self._inject_q
                            and not self._device_dirty):
                        skipped += 1
                        self._idle_boundaries += 1
                    else:
                        budget = ctrl.window
                        if max_steps is not None:
                            budget = min(budget, max_steps - steps_this_run
                                         - skipped)
                        prev = (engine.aux_to_device(a, self.device)
                                if a is not None else self._zero_aux)
                        win = self._dispatch_window(
                            max(1, budget), force=True, prev_aux=prev)
                        continue
                else:
                    # Pipeline refill: enqueue the next window behind the
                    # in-flight one before reading its scalars; its tick 0
                    # is gated on the device by the in-flight aux.
                    spec = None
                    if pipelining and a is not None and self._clean_busy(a):
                        budget = ctrl.window
                        if max_steps is not None:
                            budget = min(budget, max_steps - steps_this_run
                                         - skipped - win["budget"])
                        if budget >= 1:
                            spec = self._dispatch_window(
                                budget, force=False, prev_aux=win["aux"],
                                pipelined=True)
                    k, a = self._retire_window(win)
                    steps_this_run += k
                    win = spec
                # ---- host boundary for `a` ----
                self._fatal_checks(a)
                if a.exit_flag:
                    self._exit_code = int(a.exit_code)
                    break
                if a.host_pending:
                    self._drain_host()
                # Fast lane: host → host messages, including those the
                # drain just produced, dispatch now, without a device
                # window a hop.
                self._drain_host_fast(self.opts.host_fastpath_budget)
                self._maybe_gc()
                if self._exit_requested:
                    self._exit_requested = False    # consume the request
                    break
                busy = (a.device_pending or a.host_pending
                        or bool(self._inject_q) or bool(self._host_fast_q)
                        or self._device_dirty)
                if not busy:
                    if win is not None:
                        k2, a2 = self._retire_window(win)
                        steps_this_run += k2
                        win = None
                        if k2 or self._inject_q:
                            if k2:
                                a = a2
                            continue
                    # Quiescent: terminate (≙ the ACK'd CNF token), after
                    # at most 3 cleanup ticks — the unmute pass lags the
                    # drain that satisfies it by one tick. (Waiting on
                    # outside events, the reference's bridge pollers, is
                    # not served by this slice.)
                    cleanup = 0
                    while (a.any_muted and cleanup < 3
                           and (max_steps is None
                                or steps_this_run + skipped < max_steps)):
                        cw = self._dispatch_window(
                            1, force=True,
                            prev_aux=engine.aux_to_device(a, self.device))
                        k2, a = self._retire_window(cw)
                        steps_this_run += k2
                        cleanup += 1
                    break
                if max_steps is not None \
                        and steps_this_run + skipped >= max_steps:
                    break
        finally:
            # An in-flight window's output IS self.state: fold its
            # scalars in, and drain the host mail it surfaced, so the
            # runtime stays consistent for a restart.
            if win is not None:
                _k, a2 = self._retire_window(win)
                if a2.host_pending:
                    self._drain_host()
            if sys.exc_info()[0] is not None:
                # Interrupted between boundaries: deliver the host → host
                # messages already queued, which would otherwise wait for
                # the next run().
                self._drain_host_fast(self.opts.host_fastpath_budget)
        if (self._qi_auto and ctrl.state == "steady"
                and self._rl_windows >= 8
                and ctrl.window != self._qi_loaded):
            from .. import tuning
            tuning.store_quiesce_interval(self.program, self.opts,
                                          ctrl.window, self.device)
            self._qi_loaded = ctrl.window
        return self._exit_code

    def stop(self) -> int:
        """Tear down the auxiliaries (≙ pony_stop, start.c:332-351): emit
        the analysis summary and stop its writer thread. (The flight
        recorder, the bridge, checkpoints and the watchdog come with
        their own port slices.) Returns the exit code."""
        a = self._analysis
        if a is not None:
            a.summary()
            a.close()
            self._analysis = None
        return self._exit_code

    def profile(self) -> Dict[str, Any]:
        """The per-behaviour and per-cohort telemetry report, the host
        face of the device profiler lanes (engine.profile_lanes; the JAX
        package's Runtime.profile): cumulative runs, deliveries and
        rejections per behaviour (host behaviours report their host
        dispatches), queue-wait histograms, p50/p99 and mute-ticks per
        device cohort, work units by phase, the totals and the GC's
        window stats. Needs opts.analysis >= 1; one small device read,
        for window boundaries."""
        if self.opts.analysis < 1:
            raise RuntimeError(
                "Runtime.profile() needs RuntimeOptions.analysis >= 1 "
                "(the telemetry lanes do not exist at level 0)")
        if self.state is None:
            raise RuntimeError("call start() first")
        from ..analysis import hist_percentile
        from .state import PHASE_NAMES, QW_BUCKETS
        nd = len(self.program.device_cohorts)
        st = self.state
        runs, deliv, rej, mt, hist, ph = (
            getattr(st, f).cpu().numpy().astype(np.int64) for f in (
                "beh_runs", "beh_delivered", "beh_rejected",
                "coh_mute_ticks", "qwait_hist", "phase_cost"))
        hist = hist.reshape(nd, QW_BUCKETS)
        behaviours = {}
        for g, bdef in enumerate(self.program.behaviour_table):
            behaviours[f"{bdef.actor_type.__name__}.{bdef.name}"] = {
                "runs": int(runs[g]) + self._beh_host_runs.get(g, 0),
                "delivered": int(deliv[g]),
                "rejected": int(rej[g]),
            }
        cohorts = {}
        for di, ch in enumerate(self.program.device_cohorts):
            h = [int(x) for x in hist[di]]
            cohorts[ch.atype.__name__] = {
                "queue_wait_hist": h,
                "queue_wait_p50": hist_percentile(h, 0.50),
                "queue_wait_p99": hist_percentile(h, 0.99),
                "mute_ticks": int(mt[di]),
            }
        return {
            "steps": self.steps_run,
            "behaviours": behaviours,
            "cohorts": cohorts,
            "phases": {n: int(ph[i]) for i, n in enumerate(PHASE_NAMES)},
            "totals": {
                "processed": self.counter("n_processed"),
                "delivered": self.counter("n_delivered"),
                "rejected": self.counter("n_rejected"),
                "badmsg": self.counter("n_badmsg"),
                "deadletter": self.counter("n_deadletter"),
                "mutes": self.counter("n_mutes"),
                "host_processed": self.totals.get("host_processed", 0),
            },
            "gc": {
                "passes": self.totals.get("gc_runs", 0),
                "collected": self.counter("n_collected"),
                "blob_slots_reclaimed": self.totals.get(
                    "gc_swept_blobs", 0),
                "trace_iters": self.totals.get("gc_iters", 0),
                "aborted": self.totals.get("gc_aborted", 0),
            },
        }

    def traces(self) -> Dict[int, Dict[str, Any]]:
        """The reassembled causal traces: drains the device span ring,
        merges the host spans (injection roots, host-cohort dispatches)
        and returns one causal tree per trace id, {trace_id: {"roots",
        "spans", "n_spans", "latency", "critical_path"}}, latency in
        device ticks (tracing.reassemble). Needs tracing on (analysis >= 3
        and trace_sample > 0)."""
        if self._tracer is None:
            raise RuntimeError(
                "Runtime.traces() needs causal tracing on: "
                "RuntimeOptions(analysis=3, trace_sample=N) (the trace "
                "lanes do not exist otherwise)")
        from ..tracing import reassemble
        self._tracer.drain(self)
        return reassemble(self._tracer.spans)

    def _maybe_gc(self) -> None:
        """The run loop's periodic collection (≙ the cycle detector run
        off scheduler 0's idle path every --ponycdinterval,
        scheduler.c:976-989): every `cd_interval` ticks (skipped host-only
        boundaries count), once anything can be garbage — the host
        released an actor, or actors spawn on the device — and early when
        the host heap grew past its next trigger (≙ heap.c next_gc with
        --ponygcinitial/--ponygcfactor, start.c:204-209)."""
        if self.opts.noblock or not (self._ever_released
                                     or self.program.has_device_spawns):
            return
        heap_pressure = (self._heap is not None
                         and self._heap.bytes_since_gc > self._next_gc)
        eff_step = self.steps_run + self._idle_boundaries
        if heap_pressure or (self.opts.cd_interval > 0
                             and eff_step - self._last_gc_step
                             >= self.opts.cd_interval):
            self._last_gc_step = eff_step
            self.gc()

    # ---- the collector (≙ ORCA + the cycle detector; runtime/gc.py) ----
    def _set_flag_column(self, column: str, ids, value: bool) -> None:
        """Set a per-actor bool column host-side. A flag never frees a
        slot, so the spawn freelists stay valid."""
        ids = self._tensor(np.asarray(ids, np.int64).reshape(-1),
                           torch.int64)
        fkey = self._freelist_key
        col = getattr(self.state, column).clone()
        col[ids] = value
        self.state = self._replace(**{column: col})
        self._freelist_key = fkey

    def release(self, ids) -> None:
        """Drop the host's reference(s): the actors become collectable
        once they are unreachable and message-quiet (runtime/gc.py)."""
        self._set_flag_column("pinned", ids, False)
        self._ever_released = True

    def pin(self, ids) -> None:
        """(Re-)pin actors as host-held GC roots."""
        self._set_flag_column("pinned", ids, True)

    def gc(self) -> int:
        """Run one collection: trace reachability from the roots, free
        every actor not reached and sweep the blobs nothing holds (≙ ORCA
        and the cycle detector in one pass; runtime/gc.py). Returns the
        number of actors collected."""
        if self.state is None:
            raise RuntimeError("call start() first")
        from . import gc as gc_mod
        if self._gc_fn is None:
            self._gc_fn = gc_mod.build_gc(self.program, self.opts)
            self._ref_mask = gc_mod.build_ref_arg_mask(
                self.program, self.opts.msg_words)
            self._blob_mask = gc_mod.build_blob_arg_mask(
                self.program, self.opts.msg_words)
        # Host-side roots: refs in host-actor state and in queued
        # injections (they reach the device later), and the blobs the
        # host owns or has queued.
        total = self.program.total
        extra = np.zeros((total,), bool)
        for aid, stt in self._host_state.items():
            cohort = self.program.cohort_of(aid)
            for fname, spec in cohort.atype.field_specs.items():
                if pack.is_ref(spec):
                    v = int(stt.get(fname, -1))
                    if 0 <= v < total:
                        extra[v] = True
        n_blob = self.program.shards * self.opts.blob_slots
        blob_roots = np.zeros((n_blob,), bool)
        for h in self._host_blobs:
            slot = pack.blob_slot(int(h))
            if h >= 0 and 0 <= slot < n_blob:
                blob_roots[slot] = True
        for t, w, *_ in list(self._inject_q) + list(self._host_fast_q):
            if 0 <= t < total:
                extra[t] = True
            gid = int(w[0])
            if 0 <= gid < self._ref_mask.shape[0]:
                for i in np.nonzero(self._ref_mask[gid])[0]:
                    v = int(w[1 + i])
                    if 0 <= v < total:
                        extra[v] = True
                for i in np.nonzero(self._blob_mask[gid])[0]:
                    v = int(w[1 + i])
                    slot = pack.blob_slot(v)
                    if v >= 0 and 0 <= slot < n_blob:
                        blob_roots[slot] = True
        before = self.counter("n_collected")
        fkey = self._freelist_key
        self.state, (_n, converged, iters, n_swept) = self._gc_fn(
            self.state, self._tensor(extra, torch.bool),
            self._tensor(blob_roots, torch.bool))
        collected = self.counter("n_collected") - before
        if not collected:
            self._freelist_key = fkey     # no slot was freed
        self.totals["gc_runs"] += 1
        self.totals["gc_iters"] += int(iters)
        self.totals["gc_swept_blobs"] += int(n_swept)
        if not converged:
            self.totals["gc_aborted"] += 1
        # ≙ heap.c's next_gc update after a collection: every collection,
        # manual included, clears the allocation-pressure signal.
        if self._heap is not None:
            self._heap.bytes_since_gc = 0
            self._next_gc = max(self.opts.gc_initial,
                                int(self._heap.bytes_live
                                    * self.opts.gc_factor))
        return collected

    @property
    def heap(self):
        """Host object heap for rich message payloads (hostmem.py)."""
        if self._heap is None:
            from ..hostmem import HostHeap
            self._heap = HostHeap()
        return self._heap

    # ---- the device blob pool, host side ----
    def _pool_host(self):
        """(used, gen) of the pool as host arrays, and the lowest slot that
        may be free: read from the device once per state write that was
        not a host blob op (those keep it current)."""
        if self._blob_epoch != self._state_epoch:
            st = self.state
            self._blob_cache = [st.blob_used.cpu().numpy().copy(),
                                st.blob_gen.cpu().numpy().copy(), 0]
            self._blob_epoch = self._state_epoch
        return self._blob_cache

    def _pool_write(self, slot: int, **cols) -> None:
        """Write one slot of the pool leaves named in `cols` ({leaf: value
        of the slot}; n_blob_alloc/n_blob_free: added), cloning the pool's
        leaves on the first write since another state write, then in
        place, so that a run of host blob ops costs no whole-pool copy
        each."""
        if self._pool_own != self._state_epoch:
            st = self.state
            self._pool_host()
            fkey = self._freelist_key
            self.state = self._replace(**{
                f: getattr(st, f).clone() for f in (
                    "blob_data", "blob_used", "blob_len", "blob_gen",
                    "n_blob_alloc", "n_blob_free")})
            self._freelist_key = fkey
            self._blob_epoch = self._pool_own = self._state_epoch
        st = self.state
        for f, v in cols.items():
            t = getattr(st, f)
            if f.startswith("n_"):
                t[0] += v
            elif t.dim() == 2:
                t[:, slot] = self._tensor(v, t.dtype)
            else:
                t[slot] = v

    def _blob_slot_of(self, handle: int, what: str) -> int:
        """Decode and validate a handle host-side (range, allocation,
        generation: a stale handle to a recycled slot is rejected)."""
        n = self.program.shards * self.opts.blob_slots
        slot = pack.blob_slot(int(handle))
        if handle < 0 or not 0 <= slot < n:
            raise IndexError(f"{what}: blob handle {handle} out of range")
        used, gen, _ = self._pool_host()
        if not used[slot]:
            raise KeyError(f"{what}: blob handle {handle} is not "
                           "allocated")
        if (int(gen[slot]) & pack.BLOB_GEN_MASK) != pack.blob_gen_of(
                int(handle)):
            raise KeyError(f"{what}: blob handle {handle} is STALE — "
                           "its slot was recycled (generation mismatch)")
        return slot

    def blob_fetch(self, handle: int) -> np.ndarray:
        """Host-side read of a device blob's logical words (≙ receiving a
        payload on the main-thread scheduler). Raises on null,
        unallocated and stale handles."""
        slot = self._blob_slot_of(handle, "blob_fetch")
        ln = int(self.state.blob_len[slot])
        return self.state.blob_data[:ln, slot].cpu().numpy()

    def blob_store(self, words, length: Optional[int] = None,
                   near: Optional[int] = None) -> int:
        """Host-side blob allocation between windows (≙ the embedder
        building a message payload, pony_alloc_msg): claims the lowest
        free pool slot, writes `words` (int32, at most blob_words),
        returns the handle, which the host owns until a send moves it.
        `near` names an actor whose shard should own the slot (one shard
        here: every slot is near)."""
        if self.opts.blob_slots <= 0:
            raise RuntimeError("blob pool disabled: set "
                               "RuntimeOptions.blob_slots/blob_words")
        w = np.asarray(words, np.int32).reshape(-1)
        if w.shape[0] > self.opts.blob_words:
            raise ValueError(
                f"{w.shape[0]} words > blob_words={self.opts.blob_words}")
        ln = w.shape[0] if length is None else int(length)
        if not 0 <= ln <= self.opts.blob_words:
            raise ValueError(
                f"length={ln} outside [0, blob_words="
                f"{self.opts.blob_words}]")
        cache = self._pool_host()
        used, gen = cache[0], cache[1]
        slot = cache[2]
        while slot < used.shape[0] and used[slot]:
            slot += 1
        if slot >= used.shape[0]:
            raise BlobCapacityError("host blob_store: pool exhausted")
        full = np.zeros((self.opts.blob_words,), np.int32)
        full[:w.shape[0]] = w
        g = (int(gen[slot]) + 1) & pack.BLOB_GEN_MASK
        self._pool_write(slot, blob_data=full, blob_used=True,
                         blob_len=ln, blob_gen=g, n_blob_alloc=1)
        used[slot], gen[slot], cache[2] = True, g, slot + 1
        handle = pack.blob_handle(slot, g)
        self._host_blobs.add(handle)    # a GC root until sent or freed
        return handle

    def blob_free_host(self, handle: int) -> None:
        """Host-side release of a blob the host owns. Double frees and
        stale handles are rejected."""
        slot = self._blob_slot_of(handle, "blob_free_host")
        self._pool_write(slot, blob_used=False, blob_len=0, n_blob_free=1)
        cache = self._blob_cache
        cache[0][slot] = False
        cache[2] = min(cache[2], slot)
        self._host_blobs.discard(int(handle))

    def blob_store_str(self, text: str, near: Optional[int] = None) -> int:
        """Store a UTF-8 string as a device blob (4 bytes a word; pair
        with blob_fetch_str). A NUL in the text is rejected: it would be
        indistinguishable from the last word's padding."""
        raw = text.encode("utf-8")
        if b"\x00" in raw:
            raise ValueError(
                "blob_store_str: NUL (U+0000) in text is "
                "indistinguishable from word padding; store raw words "
                "with blob_store instead")
        if len(raw) > 4 * self.opts.blob_words:
            raise ValueError(
                f"{len(raw)} bytes > 4*blob_words="
                f"{4 * self.opts.blob_words}")
        padded = raw + b"\x00" * (-len(raw) % 4)
        words = np.frombuffer(padded, np.int32) if padded else \
            np.zeros((0,), np.int32)
        return self.blob_store(words, near=near)

    def blob_fetch_str(self, handle: int) -> str:
        """Read back a blob_store_str payload."""
        words = np.ascontiguousarray(self.blob_fetch(handle), np.int32)
        return words.tobytes().rstrip(b"\x00").decode("utf-8")

    def blob_release(self, handle: int) -> None:
        """Drop the host's GC root on a handle without freeing the slot
        (the val-blob release: device readers may still hold it; the next
        gc() reclaims it once nothing does)."""
        self._host_blobs.discard(int(handle))

    @property
    def blobs_in_use(self) -> int:
        """Allocated pool slots (a leak shows here: an orphaned blob
        persists until the next gc() sweeps it)."""
        return int(self.state.blob_used.sum())

    # ---- introspection ----
    def check_invariants(self) -> None:
        """Queue/flag invariants (≙ the reference's debug-build queue
        checkers, actor.c:57-92). Raises AssertionError."""
        st = self.state
        occ = (st.tail - st.head).cpu().numpy()
        c = self.opts.mailbox_cap
        alive = st.alive.cpu().numpy()
        muted = st.muted.cpu().numpy()
        if not (occ >= 0).all():
            raise AssertionError("mailbox occupancy negative (head>tail)")
        if not (occ <= c).all():
            raise AssertionError("mailbox occupancy exceeds capacity")
        if (muted & ~alive).any():
            raise AssertionError("dead actor still muted")
        if not (st.mute_refs.cpu().numpy()[:, ~muted] == -1).all():
            raise AssertionError("unmuted actor holds a mute ref")
        if not (occ[~alive] == 0).all():
            raise AssertionError("dead actor with queued messages")

    def counter(self, name: str) -> int:
        """A per-shard runtime counter (n_processed, n_delivered,
        n_rejected, n_badmsg, n_deadletter, n_mutes, ...) summed."""
        return int(getattr(self.state, name).sum())

    def state_of(self, actor_id: int) -> Dict[str, Any]:
        cohort = self.program.cohort_of(actor_id)
        if cohort.host:
            return dict(self._host_state.get(actor_id, {}))
        col = int(cohort.gid_to_col(actor_id))
        ts = self.state.type_state[cohort.atype.__name__]
        return {k: v[col].item() for k, v in ts.items()}

    def last_error(self, actor_id: int) -> int:
        """The latest int-coded error of an actor, 0 for none (device
        actors through ctx.error_int, host actors through PonyError)."""
        if self.program.cohort_of(actor_id).host:
            return self._host_errors.get(int(actor_id), 0)
        return int(self.state.last_error[actor_id])

    def last_error_loc(self, actor_id: int) -> str:
        """The source location of that error ("?" for none)."""
        from ..errors import error_site
        if self.program.cohort_of(actor_id).host:
            return self._host_error_locs.get(int(actor_id), "?")
        return error_site(int(self.state.last_error_loc[actor_id]))

    def cohort_state(self, atype: ActorTypeMeta) -> Dict[str, np.ndarray]:
        """State columns in slot (spawn) order."""
        cohort = self.program.by_type[atype]
        cols = np.asarray(
            cohort.slot_to_col(np.arange(cohort.capacity)), np.int64)
        return {k: v.cpu().numpy()[cols]
                for k, v in self.state.type_state[atype.__name__].items()}

    @property
    def exit_code(self) -> int:
        return self._exit_code

    @property
    def ticks_enqueued(self) -> int:
        """Ticks enqueued since start(), run or predicated off on the
        device (steps_run counts only those that ran). Each enqueued tick
        launches the tick's kernels once; under the window kernel
        (delivery="pallas_mega" on CUDA) a window is one launch, and the
        count adds the ticks each launched window may run."""
        return self._multi_g.enqueued

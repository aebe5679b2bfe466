"""Host driver of the PyTorch port: runtime construction, spawning,
host→device messaging and the run-to-quiescence loop (the counterpart of
``ponyc_tpu/runtime/runtime.py``).

≙ the reference's runtime bootstrap and lifecycle (src/libponyrt/sched/
start.c: pony_init sizes the world, pony_start runs until quiescence,
pony_get_exitcode returns the program's code) plus host-side actor
creation (pony_create, actor/actor.c:688-734) and external sends.

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
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..api import ActorTypeMeta, BehaviourDef
from ..config import RuntimeOptions, check_supported, unported
from ..errors import ERROR_CODES
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
        self._free: Dict[str, List[int]] = {}
        self._freelist_key = None     # None: stale; "synced": valid
        self._exit_code = 0
        self._device_dirty = True     # force the first window of a run
        self.steps_run = 0
        self._controller: Optional[WindowController] = None
        self._qi_auto = False
        self._qi_loaded = 0
        self._state_epoch = 0
        self._rl_windows = 0          # retired windows (cache write-back)

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
            raise unported("observability")
        self.program.finalize()
        # Building the window validates the program first (host cohorts,
        # device spawns and meshes raise before anything is allocated;
        # under pallas_fused or delivery="pallas_mega" every body is
        # traced for the kernel, and one the kernel cannot run raises
        # here).
        self._multi_g = engine.build_multi_step_gated(self.program,
                                                      self.opts)
        if self.device.type == "cuda" and self._multi_g.fused:
            fused_dispatch.compile_all(self._multi_g.fused)
        if self.device.type == "cuda" and isinstance(
                self._multi_g, megakernel.MegaWindow):
            self._multi_g.build()
        self.state = init_state(self.program, self.opts, self.device)
        from .. import tuning
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
        w1 = 1 + self.opts.msg_words
        k = self.opts.inject_slots
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
        if (self.program.has_device_spawns or self.steps_run) \
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
        gids = self._tensor(ids, torch.int64)
        alive = self.state.alive.clone()
        alive[gids] = True
        pinned = self.state.pinned.clone()
        pinned[gids] = True
        self.state = self._replace(
            type_state={**self.state.type_state, atype.__name__: ts},
            alive=alive, pinned=pinned)
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
        for cohort in self.program.cohorts:
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
    def send(self, target: int, behaviour_def: BehaviourDef, *args):
        if behaviour_def.global_id is None:
            raise RuntimeError(f"{behaviour_def} not part of this program")
        self._check_send_target(int(target), behaviour_def)
        self._check_ref_args(behaviour_def.arg_specs, args,
                             f"{behaviour_def.actor_type.__name__}."
                             f"{behaviour_def.name}")
        words = np.zeros((1 + self.opts.msg_words,), np.int32)
        words[0] = behaviour_def.global_id
        words[1:] = _host_pack_args(behaviour_def.arg_specs, args,
                                    self.opts.msg_words)
        self._inject_q.append((int(target), words))

    def bulk_send(self, targets, behaviour_def: BehaviourDef, *arg_cols):
        """Mass-enqueue one message per (distinct) target directly into
        the device mailboxes — the setup path for benchmark-scale
        seeding. Targets must be unique within one call."""
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
        self.state = self._replace(buf={**self.state.buf, cname: cbuf},
                                   tail=tail)

    def _drain_inject_tracked(self):
        """The next inject batch (targets [K], words [1+W, K]) and the
        consumed (target, words) pairs in order, so a gated-out window
        can re-queue them. At most one drain batch per target per window
        (host-side flow control, as in the reference)."""
        if not self._inject_q:
            return (*self._empty_inject, [])
        k = self.opts.inject_slots
        w1 = 1 + self.opts.msg_words
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

    # ---- the run loop ----
    def _dispatch_window(self, budget: int, force: bool,
                         prev_aux) -> Dict[str, Any]:
        """Enqueue one gated window and start the non-blocking copy of
        its control scalars; returns the in-flight record."""
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
                "epoch": epoch}

    def _retire_window(self, win: Dict[str, Any]):
        """Wait for an in-flight window's scalars and fold them into host
        accounting. A gated-out window (0 ticks) changed nothing: its
        injections go back to the front of the queue."""
        if win["event"] is not None:
            win["event"].synchronize()
        k, a = engine.aux_from_vector(win["vec"].tolist())
        if k == 0:
            if win["consumed"]:
                self._inject_q.extendleft(reversed(win["consumed"]))
            return 0, a
        if self._state_epoch == win["epoch"]:
            self._device_dirty = False
        self.steps_run += k
        if self.opts.debug_checks:
            self.check_invariants()
        self._rl_windows += 1
        attention = (a.host_pending or a.exit_flag or a.spill_overflow
                     or a.spawn_fail or a.blob_fail or a.blob_budget_fail)
        self._controller.observe(k, win["budget"], attention,
                                 qw_p99=a.qw_p99)
        return k, a

    def _fatal_checks(self, a) -> None:
        if a.spill_overflow:
            raise SpillOverflowError(
                f"spill overflow at step {self.steps_run}")
        if a.spawn_fail:
            raise SpawnCapacityError(
                f"device spawn found no free slot by step {self.steps_run}")

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
                                budget, force=False, prev_aux=win["aux"])
                    k, a = self._retire_window(win)
                    steps_this_run += k
                    win = spec
                # ---- host boundary for `a` ----
                self._fatal_checks(a)
                if a.exit_flag:
                    self._exit_code = int(a.exit_code)
                    break
                busy = (a.device_pending or a.host_pending
                        or bool(self._inject_q) or self._device_dirty)
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
            # scalars in so the runtime stays consistent for a restart.
            if win is not None:
                self._retire_window(win)
        if (self._qi_auto and ctrl.state == "steady"
                and self._rl_windows >= 8
                and ctrl.window != self._qi_loaded):
            from .. import tuning
            tuning.store_quiesce_interval(self.program, self.opts,
                                          ctrl.window, self.device)
            self._qi_loaded = ctrl.window
        return self._exit_code

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
        col = int(cohort.gid_to_col(actor_id))
        ts = self.state.type_state[cohort.atype.__name__]
        return {k: v[col].item() for k, v in ts.items()}

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

"""Program build for the PyTorch port (a copy of ``ponyc_tpu/program.py``
with its imports rewired to this package: the lint pass and the
build-hook plugins are the port's own, ponyc_tpu_torch.lint and
ponyc_tpu_torch.plugin).

Program build: whole-world actor-type registry → cohorts + dispatch table.

≙ the reference compiler's reachability + vtable painting stage
(src/libponyc/reach/reach.c builds the whole-program reachable type/method
set from Main; reach/paint.c colours method names into dispatch-table slots).
On TPU the same whole-program knowledge is what makes behaviour dispatch
vectorisable: actors are grouped into *cohorts by type* so each cohort's
dispatch is a `lax.switch` over only that type's behaviours (SURVEY.md §7
hard part (b) — heterogeneity kills vectorisation, cohorts bound it).

Global actor ids are a single [0, N) range; each type owns a contiguous
slice, so a message's routing needs only the id (the mailbox table is one
dense array) while dispatch semantics come from the owning cohort.
Behaviour ids are *global* (word 0 of every message); each cohort's switch
re-bases them and treats out-of-range ids as a traced no-op — the dynamic
analog of the type check Pony does statically.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .api import ActorTypeMeta
from .config import RuntimeOptions


class Cohort:
    """The actors of one type (≙ one reach_type_t).

    Id layout is *shard-major, cohort-minor* so the same static per-shard
    slicing works on every mesh shard (see Program docstring): global actor
    id = shard * n_local + local_start + (slot // shards), where `slot` is
    the cohort-relative slot (slot % shards picks the shard, round-robin
    for balance). With shards == 1 this degenerates to the contiguous
    [start, stop) range.
    """

    def __init__(self, atype: ActorTypeMeta, capacity: int,
                 opts: RuntimeOptions, shards: int):
        self.atype = atype
        self.shards = shards
        # Round capacity up so every shard holds the same number of rows.
        self.capacity = -(-capacity // shards) * shards
        self.local_capacity = self.capacity // shards
        self.local_start = 0        # per-shard row offset; set by finalize()
        self.batch = atype.BATCH or opts.batch
        self.priority = atype.PRIORITY
        self.host = bool(atype.HOST)
        # Static send budget: max ctx.send() calls across this type's
        # behaviours is discovered at trace time; the declared bound here is
        # the engine's outbox width. Behaviours exceeding it fail loudly at
        # trace, not silently at run.
        self.max_sends = getattr(atype, "MAX_SENDS", None) or opts.max_sends
        self.behaviours = list(atype.behaviour_defs)
        # Per-cohort mailbox word width (≙ per-type pony_msg_t sizes —
        # genfun.c packs exactly each behaviour's params; the reference
        # never pays one type's width for another's messages). The
        # cohort's mailbox table holds only what its own behaviours can
        # receive: min(opts.msg_words, widest behaviour). opts.msg_words
        # stays the program-wide declared maximum (outbox/spill/inject
        # width); narrower cohorts just stop paying HBM for it.
        from .ops.pack import spec_width
        need = max((sum(spec_width(s) for s in b.arg_specs)
                    for b in self.behaviours), default=0)
        self.msg_words = min(opts.msg_words, need)
        self.n_local_total = 0      # rows per shard over all cohorts (set later)
        # Resolved by Program.finalize():
        self.spawns: Dict[str, int] = {}     # target type name → sites/dispatch
        self.spawn_offsets: Dict[str, int] = {}  # target name → offset into
        #   the target cohort's compacted free-row list (static partition)
        sd = getattr(atype, "SPAWN_DISPATCHES", None)
        self.spawn_dispatches = min(self.batch, sd) if sd else self.batch
        # Device blob pool (≙ actor-heap payloads; ops.pack.Blob):
        # MAX_BLOBS = per-dispatch ctx.blob_alloc budget; blob_offset is
        # this cohort's static window into the compacted free-slot list
        # (set by Program._resolve_blobs).
        self.blob_sites = int(getattr(atype, "MAX_BLOBS", 0) or 0)
        self.blob_offset = 0
        bdk = getattr(atype, "BLOB_DISPATCHES", None)
        if bdk is not None and int(bdk) < 0:
            raise TypeError(
                f"{atype.__name__}.BLOB_DISPATCHES must be >= 0")
        # 0 is a real value (this type reserves nothing this config);
        # only None means "default: every dispatch may allocate".
        self.blob_dispatches = (min(self.batch, int(bdk))
                                if bdk is not None else self.batch)

    @property
    def uses_blobs(self) -> bool:
        """Does this cohort touch the device blob pool (allocates, or
        holds/receives Blob handles)? Decides whether the dispatch
        threads the pool arrays (engine._cohort_dispatch)."""
        from .ops.pack import is_blob
        if self.blob_sites:
            return True
        if any(is_blob(s) for s in self.atype.field_specs.values()):
            return True
        return any(is_blob(s) for b in self.behaviours
                   for s in b.arg_specs)

    def slot_to_gid(self, slot):
        """Cohort slot → global actor id (vectorised, numpy-friendly)."""
        shard = slot % self.shards
        row = self.local_start + slot // self.shards
        return shard * self.n_local_total + row

    def slot_to_col(self, slot):
        """Cohort slot → row in this cohort's [capacity] state columns
        (shard-major so the column array shards cleanly on its leading
        axis)."""
        shard = slot % self.shards
        return shard * self.local_capacity + slot // self.shards

    def gid_to_col(self, gid):
        """Global actor id → state-column row (vectorised)."""
        shard = gid // self.n_local_total
        row = gid % self.n_local_total - self.local_start
        return shard * self.local_capacity + row

    @property
    def local_stop(self) -> int:
        return self.local_start + self.local_capacity

    def __repr__(self):
        return (f"<cohort {self.atype.__name__} cap={self.capacity}"
                f"×{self.shards}sh batch={self.batch}>")


class Program:
    """The compiled actor world: types, capacities, id layout, dispatch ids.

    Build order (≙ pass pipeline tail, pass.h:208-231 reach→paint→codegen):
      1. declare(Type, capacity) for every actor type
      2. finalize() assigns cohort id ranges + global behaviour ids
      3. the engine traces one dispatch step over the frozen layout
    """

    def __init__(self, opts: Optional[RuntimeOptions] = None):
        self.opts = opts or RuntimeOptions()
        self.shards = max(1, self.opts.mesh_shards)
        self._declared: List[Tuple[ActorTypeMeta, int]] = []
        self.cohorts: List[Cohort] = []
        self.by_type: Dict[ActorTypeMeta, Cohort] = {}
        self.behaviour_table: List = []   # global id → BehaviourDef
        self.total = 0
        self.n_local = 0                  # actor rows per shard
        self.frozen = False

    def declare(self, atype: ActorTypeMeta, capacity: int):
        if self.frozen:
            raise RuntimeError("Program already finalized")
        if not isinstance(atype, ActorTypeMeta):
            raise TypeError(f"{atype!r} is not an actor type (use @actor)")
        if getattr(atype, "_type_params", ()):
            params = ", ".join(p.name for p in atype._type_params)
            raise TypeError(
                f"{atype.__name__} is generic over [{params}] — declare "
                f"a reification (e.g. {atype.__name__}[I32]) instead; "
                "only concrete types have a layout (≙ reify.c: codegen "
                "sees reified types only)")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._declared.append((atype, capacity))
        return self

    def finalize(self) -> "Program":
        if self.frozen:
            return self
        # Host cohorts last: their rows sit in a contiguous per-shard tail
        # range so delivery can classify "host-bound" with one compare
        # (≙ inject_main diverting use_main_thread actors, scheduler.c:179).
        # On a mesh each shard carries its share of every host cohort's
        # mailbox rows (shard-major slots, like device cohorts); the host
        # drains them all at poll boundaries — the mesh analog of
        # the main-thread scheduler (scheduler.c:179-190, 1030-1035).
        self._declared.sort(key=lambda tc: bool(tc[0].HOST))
        offset = 0
        for atype, cap in self._declared:
            cohort = Cohort(atype, cap, self.opts, self.shards)
            cohort.local_start = offset
            offset += cohort.local_capacity
            self.cohorts.append(cohort)
            self.by_type[atype] = cohort
        self.n_local = offset
        self.total = offset * self.shards
        for cohort in self.cohorts:
            cohort.n_local_total = self.n_local
        gid = 0
        for cohort in self.cohorts:
            for local, bdef in enumerate(cohort.behaviours):
                bdef.global_id = gid
                bdef.local_id = local
                self.behaviour_table.append(bdef)
                gid += 1
        # Verify pass (≙ the compiler's post-typecheck verify/, and
        # type/safeto.c's sendability): every typed Ref[T] field or
        # behaviour argument must name a type declared in this program —
        # a miswired program fails HERE, at build, not as runtime badmsg.
        # Payload geometry is verified too: a behaviour's total argument
        # width (vector args count their k words) must fit msg_words, and
        # vector specs are message-payload-only (state columns are
        # scalar by design — use one field per component).
        from .ops.pack import _VecSpec, ref_target, spec_width
        declared = {c.atype.__name__ for c in self.cohorts}
        for cohort in self.cohorts:
            for fname, spec in cohort.atype.field_specs.items():
                if isinstance(spec, _VecSpec):
                    raise TypeError(
                        f"{cohort.atype.__name__}.{fname}: {spec.__name__} "
                        "is a message-payload annotation; state fields are "
                        "scalar columns — declare one field per component")
                t = ref_target(spec)
                if t is not None and t not in declared:
                    raise TypeError(
                        f"{cohort.atype.__name__}.{fname} is Ref[{t}] but "
                        f"{t} is not declared in this program")
            for b in cohort.behaviours:
                total = sum(spec_width(s) for s in b.arg_specs)
                if total > self.opts.msg_words:
                    raise TypeError(
                        f"{cohort.atype.__name__}.{b.name} needs {total} "
                        f"payload words but msg_words="
                        f"{self.opts.msg_words}; raise "
                        "RuntimeOptions.msg_words")
                for i, spec in enumerate(b.arg_specs):
                    t = ref_target(spec)
                    if t is not None and t not in declared:
                        raise TypeError(
                            f"{cohort.atype.__name__}.{b.name} arg "
                            f"{b.arg_names[i]!r} is Ref[{t}] but {t} is "
                            "not declared in this program")
        self._resolve_spawns()
        self._resolve_blobs()
        self.frozen = True
        from . import plugin as _plugin
        if _plugin.active():
            _plugin.run_build_hooks(self)
        return self

    def _resolve_spawns(self) -> None:
        """Resolve SPAWNS declarations and statically partition each target
        cohort's free-slot list among its spawner cohorts.

        ≙ pony_create's allocation (actor.c:688) done ahead of time: each
        (spawner, target) pair owns a window of the target's compacted
        free rows; within the window, each *runnable* actor gets
        spawn_dispatches × sites disjoint slots (ranked by a cumsum over
        the runnable mask at step time), so concurrent vmapped spawns can
        never collide while idle actors reserve nothing. The static
        partition *between* spawner cohorts is worst-case
        (capacity × spawn_dispatches × sites) — the TPU-static price: a
        second spawner cohort can exhaust its window while the first's
        still has slots. Reservations unused at the end of a step simply
        remain free.
        """
        by_name = {c.atype.__name__: c for c in self.cohorts}
        offsets: Dict[str, int] = {n: 0 for n in by_name}
        for cohort in self.cohorts:
            raw = getattr(cohort.atype, "SPAWNS", {}) or {}
            for key, sites in raw.items():
                tname = key if isinstance(key, str) else key.__name__
                target = by_name.get(tname)
                if target is None:
                    raise TypeError(
                        f"{cohort.atype.__name__}.SPAWNS names {tname!r}, "
                        "which is not declared in this Program")
                if target.host or cohort.host:
                    raise TypeError(
                        "device-side spawn between host cohorts is not "
                        "supported; spawn host actors from the host API")
                if sites < 1:
                    continue
                cohort.spawns[tname] = int(sites)
                cohort.spawn_offsets[tname] = offsets[tname]
                offsets[tname] += (cohort.local_capacity
                                   * cohort.spawn_dispatches * int(sites))

    def _resolve_blobs(self) -> None:
        """Validate blob-pool usage and statically partition the free
        list among allocating cohorts (the _resolve_spawns pattern for
        the "actor heap"): each allocating cohort owns a
        capacity × BLOB_DISPATCHES × MAX_BLOBS window; unused
        reservations simply stay free. Blob handles are device-side values — host cohorts
        cannot hold or receive them (the host touches blob words via
        Runtime.blob_fetch/blob_store between steps)."""
        from .ops.pack import is_blob
        offset = 0
        for cohort in self.cohorts:
            if not cohort.uses_blobs:
                continue
            if self.opts.blob_slots <= 0:
                raise TypeError(
                    f"{cohort.atype.__name__} uses the device blob pool "
                    "(MAX_BLOBS or Blob annotations) but the pool is "
                    "disabled — set RuntimeOptions.blob_slots and "
                    "blob_words")
            if cohort.host:
                raise TypeError(
                    f"host actor type {cohort.atype.__name__} declares "
                    "blob usage; blobs are device-resident — use "
                    "Runtime.blob_fetch/blob_store host-side")
            cohort.blob_offset = offset
            offset += (cohort.local_capacity * cohort.blob_dispatches
                       * cohort.blob_sites)

    def lint(self, roots=None):
        """Whole-program static analysis over this program's world
        (≙ running reach/paint + safeto ahead of codegen): returns the
        list of lint Findings — see ponyc_tpu_torch.lint for the rules
        (R1 reachability … R5 budget feasibility), roots, and
        suppressions. Callable before or after finalize(); probes with
        this program's own msg_words/max_sends resolution."""
        from .lint import lint_types
        declared = (self._declared if not self.frozen
                    else [(c.atype, 0) for c in self.cohorts])
        return lint_types(*(t for t, _ in declared), roots=roots,
                          msg_words=self.opts.msg_words,
                          default_max_sends=self.opts.max_sends)

    @property
    def has_device_spawns(self) -> bool:
        return any(c.spawns for c in self.cohorts)

    @property
    def spawn_target_names(self):
        out = []
        for c in self.cohorts:
            for t in c.spawns:
                if t not in out:
                    out.append(t)
        return out

    @property
    def device_cohorts(self) -> List[Cohort]:
        return [c for c in self.cohorts if not c.host]

    @property
    def host_cohorts(self) -> List[Cohort]:
        return [c for c in self.cohorts if c.host]

    @property
    def first_host_row(self) -> int:
        """Per-shard rows >= this belong to host-resident actors (tail
        range), or n_local if there are none."""
        for c in self.cohorts:
            if c.host:
                return c.local_start
        return self.n_local

    def by_type_name(self, name: str) -> Cohort:
        for c in self.cohorts:
            if c.atype.__name__ == name:
                return c
        raise KeyError(name)

    def cohort_of(self, actor_id: int) -> Cohort:
        if not 0 <= actor_id < self.total:
            raise IndexError(
                f"actor id {actor_id} out of range [0,{self.total})")
        row = actor_id % self.n_local
        for c in self.cohorts:
            if c.local_start <= row < c.local_stop:
                return c
        raise IndexError(f"actor id {actor_id} maps to no cohort")

    def gid_to_slot(self, actor_id: int) -> int:
        """Inverse of Cohort.slot_to_gid."""
        c = self.cohort_of(actor_id)
        shard, row = divmod(actor_id, self.n_local)
        return (row - c.local_start) * self.shards + shard

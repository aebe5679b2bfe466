"""Front-end API of the PyTorch port: actor types, behaviours, and the
per-dispatch Context (the counterpart of ``ponyc_tpu/api.py``).

Behaviours are plain functions over torch tensors::

    @actor
    class RingNode:
        next_ref: Ref
        passes:   I32

        @behaviour
        def token(self, st, hops: I32):
            self.send(st["next_ref"], RingNode.token, hops - 1,
                      when=hops > 1)
            self.exit(0, when=hops <= 1)
            return {**st, "passes": st["passes"] + 1}

``self`` inside a behaviour is a Context: it carries the actors' global
ids (an int32 tensor over the cohort's lanes) and collects the effects
(sends, spawns, exit, yield, destroy, error) that the engine turns into
batched tensor operations. The state dict ``st`` maps field names to [lanes]
tensors; return the updated dict. A body that uses only Python operators
runs unchanged in both packages. The number of ``self.send(...)`` calls
per behaviour is fixed by the body; data-dependent sends use ``when=``
masks, exactly as in the JAX package. Bodies must not update tensors in
place (``st["x"] += 1``): tensors are shared across lanes, so the engine
raises when a body does.

An actor type with ``HOST = True`` lives on the host (≙ Pony's
main-thread actors and ``env.out``): its behaviours run in Python on
plain values between windows, with a runtime.HostContext as ``self``
(send, exit, yield_), and its state is a dict the Runtime keeps.

Payloads wider than a message live in the device blob pool
(``RuntimeOptions.blob_slots`` × ``blob_words``) and ride messages as
handles: ``ctx.blob_alloc/set/get/length/freeze/free`` (BlobPoolView).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Tuple

import torch

from .ops import pack
from .ops.pack import (Blob, BlobVal, Bool, Box, F32, I8, I16, I32,  # noqa
                       Iso, Mut, Ref, Tag, Trn, TypeParam, U8, U16,
                       U32, Val, VecF32, VecI32)  # re-exported


class BehaviourDef:
    """A behaviour declaration: dispatch id + typed argument spec (≙ a
    Pony behaviour's message id and parameter list; global ids are
    assigned at program build, reach/paint.c)."""

    def __init__(self, fn):
        self.fn = fn
        self.name = fn.__name__
        sig = inspect.signature(fn)
        params = list(sig.parameters.values())[2:]  # drop (self, st)
        self.arg_specs = tuple(
            pack.normalize_annotation(
                p.annotation if p.annotation is not inspect.Parameter.empty
                else I32)
            for p in params)
        self.arg_names = tuple(p.name for p in params)
        for p, spec in zip(params, self.arg_specs):
            m = pack.cap_mode(spec)
            if not pack.cap_sendable(m):
                raise TypeError(
                    f"behaviour {fn.__name__}: parameter {p.name!r} is "
                    f"{spec.__name__} — not sendable; only Iso, Val and "
                    "Tag payloads may cross an actor boundary "
                    "(CAP_SEND, type/cap.c:90; safeto.c)")
        self.global_id: Optional[int] = None
        self.local_id: Optional[int] = None
        self.actor_type: Optional["ActorTypeMeta"] = None

    def __repr__(self):
        owner = self.actor_type.__name__ if self.actor_type else "?"
        return f"<behaviour {owner}.{self.name} gid={self.global_id}>"


def behaviour(fn=None, *, lint_ignore=()):
    """Mark a method as an actor behaviour (≙ Pony ``be``).
    ``lint_ignore`` is accepted for source compatibility with the JAX
    package; the port has no lint pass yet."""
    if fn is None:
        return BehaviourDef
    return BehaviourDef(fn)


be = behaviour


class ActorTypeMeta(type):
    """Metaclass collecting state fields + behaviours from the class body."""

    def __new__(mcs, name, bases, ns):
        fields: Dict[str, Any] = {}
        inherited: List[BehaviourDef] = []
        for base in bases:
            fields.update(getattr(base, "_fields", {}))
            inherited.extend(getattr(base, "_behaviours", []))
        for key, val in list(ns.get("__annotations__", {}).items()):
            if key.startswith("_") or key.isupper():
                continue
            spec = pack.normalize_annotation(val)
            if spec in pack._NARROW:
                raise TypeError(
                    f"{name}.{key}: narrow/unsigned widths "
                    f"({spec.__name__}) are message-argument types; "
                    "declare state fields as I32 (or F32) and wrap "
                    "explicitly in the behaviour")
            fields[key] = spec
        own = [val for val in ns.values() if isinstance(val, BehaviourDef)]
        cls = super().__new__(mcs, name, bases, ns)
        # Inherited behaviours get a fresh BehaviourDef per subclass:
        # dispatch ids are per-(type, behaviour) slots (≙ paint.c).
        behaviours: List[BehaviourDef] = []
        own_names = {b.name for b in own}
        for b in inherited:
            if b.name in own_names:
                continue
            copy = BehaviourDef(b.fn)
            setattr(cls, copy.name, copy)
            behaviours.append(copy)
        behaviours.extend(own)
        cls._fields = fields
        cls._behaviours = behaviours
        for b in behaviours:
            b.actor_type = cls
        # Scheduling hints (≙ actor.c:398-423 lazy hint fns).
        cls.BATCH = ns.get("BATCH", None)
        cls.PRIORITY = ns.get("PRIORITY", 0)
        cls.HOST = ns.get("HOST", False)
        cls.TAG = ns.get("TAG", 0)
        cls.SPAWNS = ns.get("SPAWNS", {})
        cls.SPAWN_DISPATCHES = ns.get("SPAWN_DISPATCHES", None)
        cls.MAX_BLOBS = ns.get("MAX_BLOBS", 0)
        cls.BLOB_DISPATCHES = ns.get("BLOB_DISPATCHES", None)
        all_specs = list(fields.values())
        for b in behaviours:
            all_specs.extend(b.arg_specs)
        cls._type_params = pack.type_params_of(all_specs)
        cls._reifications = {}
        return cls

    def __getitem__(cls, item):
        """Reify a generic actor type: Cell[I32] substitutes the type
        parameters and yields a concrete actor type (≙ reify.c)."""
        params = cls._type_params
        if not params:
            raise TypeError(f"{cls.__name__} is not generic "
                            "(no TypeParam annotations)")
        args = item if isinstance(item, tuple) else (item,)
        args = tuple(pack.normalize_annotation(a)
                     if not isinstance(a, ActorTypeMeta) else a
                     for a in args)
        if len(args) != len(params):
            raise TypeError(
                f"{cls.__name__} takes {len(params)} type argument(s) "
                f"({', '.join(p.name for p in params)}), got {len(args)}")

        def _key_of(a):
            if isinstance(a, type):
                return a
            if isinstance(a, pack._RefTo) and not isinstance(a.target,
                                                             str):
                return ("Ref", a.target)
            return a.__name__ if hasattr(a, "__name__") else str(a)
        key = tuple(_key_of(a) for a in args)
        hit = cls._reifications.get(key)
        if hit is not None:
            return hit
        mapping = dict(zip(params, args))
        disp = tuple(a.__name__ if hasattr(a, "__name__") else str(a)
                     for a in args)
        name = f"{cls.__name__}[{', '.join(disp)}]"
        ns = {"__annotations__": {}, "__qualname__": name}
        for attr in ("BATCH", "PRIORITY", "HOST", "TAG", "SPAWNS",
                     "SPAWN_DISPATCHES", "MAX_SENDS", "MAX_BLOBS",
                     "BLOB_DISPATCHES"):
            if attr in cls.__dict__:
                ns[attr] = cls.__dict__[attr]
        new = ActorTypeMeta(name, (Actor,), ns)
        new.__name__ = name
        new._fields = {k: pack.substitute(s, mapping)
                       for k, s in cls._fields.items()}
        behaviours = []
        for b in cls._behaviours:
            copy = BehaviourDef(b.fn)
            copy.arg_specs = tuple(pack.substitute(s, mapping)
                                   for s in b.arg_specs)
            copy.actor_type = new
            setattr(new, copy.name, copy)
            behaviours.append(copy)
        new._behaviours = behaviours
        sub_specs = list(new._fields.values())
        for b in behaviours:
            sub_specs.extend(b.arg_specs)
        new._type_params = pack.type_params_of(sub_specs)
        cls._reifications[key] = new
        return new

    @property
    def field_specs(cls):
        return cls._fields

    @property
    def behaviour_defs(cls):
        return cls._behaviours


class Actor(metaclass=ActorTypeMeta):
    """Base class for actor types (subclass + annotate fields)."""


def actor(cls):
    """Class decorator: turn a plain class into an actor type."""
    ns = dict(cls.__dict__)
    ns.pop("__dict__", None)
    ns.pop("__weakref__", None)
    return ActorTypeMeta(cls.__name__, (Actor,), ns)


class BlobPoolView:
    """The device blob pool as one behaviour evaluation sees it (≙ the
    reference's actor heap and pony_alloc_msg payloads, pony.h:332-360).

    The plain dispatch hands each behaviour the cohort's working copies
    of the pool (`data` [W, B+1], `used`, `len_`, `gen` [B+1]: B slots
    and one trailing slot that takes the writes of lanes that must not
    write; constants are written with index_fill_, so that no write
    copies a value from the host), `take` (the lanes whose batch slot
    selected this behaviour)
    and `resv` ([sites, lanes] reserved global slot ids, -1 none; None
    for a receive-only cohort). Every op applies at once, masked by
    `take` and `when`, to the working copies in place: one blob has one
    owner and the take masks of a cohort's behaviours are disjoint, so
    applying the behaviours one after another is exact, and reads see
    the dispatch's own earlier writes. `budget_over` ([lanes] or None)
    marks lanes whose reservation window was withheld for BUDGET (more
    allocating dispatches than BLOB_DISPATCHES): an alloc that fails
    there sets `budget_fail`, elsewhere `fail` (the pool is exhausted).
    The lane tracer (ops/lanecode.py) has a view of the same methods
    that records them as lane-program nodes."""

    __slots__ = ("data", "used", "len_", "gen", "base", "nslots", "take",
                 "resv", "nsites", "fail", "budget_fail", "n_alloc",
                 "n_free", "n_remote", "alloced", "budget_over")

    def __init__(self, data, used, len_, gen, base, take, resv,
                 budget_over=None):
        self.data, self.used, self.len_, self.gen = data, used, len_, gen
        self.base = base                    # this pool's first slot id
        self.nslots = used.shape[0] - 1     # the last slot drops writes
        self.take = take
        self.resv = resv
        self.nsites = 0 if resv is None else resv.shape[0]
        self.budget_over = budget_over
        z = torch.zeros((), dtype=torch.int32, device=take.device)
        self.fail = self.budget_fail = z.bool()
        self.n_alloc = self.n_free = self.n_remote = z
        self.alloced = torch.zeros_like(take)

    def _i32(self, v):
        return pack._tensor(v, torch.int32, self.take.device)

    def _when(self, w):
        return pack._tensor(w, torch.bool, self.take.device) & self.take

    def local(self, h):
        """(slot index clamped into the pool, validity): the handle must
        address this pool and carry its slot's current generation (a
        stale handle to a recycled slot is dead)."""
        hl = pack.blob_slot(h) - self.base
        ok = (h >= 0) & (hl >= 0) & (hl < self.nslots)
        hc = torch.where(ok, hl, 0).long()
        ok = ok & (self.gen[hc] == pack.blob_gen_of(h))
        return hc, ok

    def _drop(self, ok, hc):
        """Write index: the slot where `ok`, else the dropping slot."""
        return torch.where(ok, hc, self.nslots)

    def alloc(self, site: int, length, when):
        slot = self.resv[site]
        w = self._when(when)
        ok = w & (slot >= 0)
        wanted = w & (slot < 0)
        if self.budget_over is not None:
            self.budget_fail = self.budget_fail | (
                wanted & self.budget_over).any()
            self.fail = self.fail | (wanted & ~self.budget_over).any()
        else:
            self.fail = self.fail | wanted.any()
        idx = torch.where(ok, slot - self.base, self.nslots).long()
        newgen = (self.gen[idx] + 1) & pack.BLOB_GEN_MASK
        self.gen[idx] = newgen
        self.used.index_fill_(0, idx, True)
        words = self.data.shape[0]
        if length is None:
            self.len_.index_fill_(0, idx, words)
        else:
            self.len_[idx] = self._i32(length).clamp(0, words).expand(
                idx.shape)
        self.data.index_fill_(1, idx, 0)
        self.n_alloc = self.n_alloc + ok.sum(dtype=torch.int32)
        self.alloced = self.alloced | ok
        return torch.where(ok, pack.blob_handle(slot, newgen), -1)

    def get(self, h, i):
        hc, ok = self.local(self._i32(h))
        i = self._i32(i)
        words = self.data.shape[0]
        ok = ok & self.used[hc] & (i >= 0) & (i < words)
        return torch.where(ok, self.data[i.clamp(0, words - 1).long(), hc],
                           0)

    def length(self, h):
        hc, ok = self.local(self._i32(h))
        return torch.where(ok, self.len_[hc], 0)

    def set(self, h, i, v, when):
        hc, okh = self.local(self._i32(h))
        i = self._i32(i)
        words = self.data.shape[0]
        ok = (self._when(when) & okh & (i >= 0) & (i < words)
              & self.used[hc])
        row = torch.where(ok, i.clamp(0, words - 1), 0).long()
        col = self._drop(ok, hc)
        self.data[row.expand(col.shape), col] = self._i32(v).expand(
            col.shape)

    def free(self, h, when):
        hc, okh = self.local(self._i32(h))
        ok = self._when(when) & okh & self.used[hc]
        idx = self._drop(ok, hc)
        self.used.index_fill_(0, idx, False)
        self.len_.index_fill_(0, idx, 0)
        self.n_free = self.n_free + ok.sum(dtype=torch.int32)

    def note_remote(self, remote):
        """Count Blob arguments that arrived off this pool."""
        self.n_remote = self.n_remote + (remote & self.take).sum(
            dtype=torch.int32)


class Context:
    """Per-dispatch effect collector, passed as ``self`` to behaviours
    (≙ pony_ctx_t + pony_sendv actor.c:773, pony_exitcode start.c:345).
    All effects are masked tensors; the engine pads them to the type's
    static send budget."""

    __slots__ = ("actor_id", "msg_words", "device", "sends", "exit_flag",
                 "exit_code", "yield_flag", "destroy_flag",
                 "destroy_called", "error_flag", "error_code", "error_loc",
                 "error_called", "ref_types", "cap_moves", "cap_types",
                 "exit_called", "yield_called", "spawn_fail",
                 "_spawn_resv", "spawn_claims", "_spawn_meta",
                 "sync_inits", "_blob", "_blob_claims")

    def __init__(self, actor_id, msg_words: int, spawn_resv=None,
                 spawn_meta=None, blob=None):
        self.actor_id = actor_id          # [lanes] int32 global ids
        self.msg_words = msg_words
        self.device = actor_id.device
        self.sends: List[Tuple[Any, Any, Any]] = []   # (target, words, when)
        # Effects start as Python defaults and become tensors when a body
        # sets them, so an untouched effect costs no device work.
        self.exit_flag = False
        self.exit_code = 0
        self.yield_flag = False
        self.destroy_flag = False
        self.destroy_called = False
        self.error_flag = False
        self.error_code = 0
        self.error_loc = 0
        self.error_called = False
        self.exit_called = False
        self.yield_called = False
        self.ref_types = pack.RefTypes()
        self.cap_moves = pack.CapMoves()
        self.cap_types = pack.CapTypes()
        # Device spawns: {target type name: [n_sites, lanes] int32 refs
        # reserved for this dispatch (-1: no free slot)}; the claims made
        # so far per target; whether a wanted spawn found no slot.
        self._spawn_resv = spawn_resv or {}
        self.spawn_claims: Dict[str, List[Any]] = {
            t: [] for t in self._spawn_resv}
        self.spawn_fail = False
        # {target type name: field specs}, for sync construction, and
        # {target type name: {site: (state dict, ok mask)}}.
        self._spawn_meta = spawn_meta or {}
        self.sync_inits: Dict[str, Dict[int, Any]] = {}
        # The device blob pool (a BlobPoolView, or the lane tracer's);
        # None where the pool is off or the cohort does not use it.
        self._blob = blob
        self._blob_claims = 0             # blob_alloc sites used so far

    def _mask(self, when):
        return pack._tensor(when, torch.bool, self.device)

    def _send_checks(self, target, behaviour_def: BehaviourDef, args):
        """Sendability (≙ type/safeto.c + expr/call.c) and the iso move
        discipline for one send: a typed ref may only receive its own
        type's behaviours, ref-typed params only accept matching refs,
        and a moved payload may not be used again."""
        owner = behaviour_def.actor_type.__name__
        tn = self.ref_types.lookup(target)
        if tn is not None and tn != owner:
            raise TypeError(
                f"sendability: ref typed Ref[{tn}] cannot receive "
                f"{owner}.{behaviour_def.name} — declare the field/arg "
                f"as Ref[{owner}] or fix the wiring")
        for spec, a in zip(behaviour_def.arg_specs, args):
            want = pack.ref_target(spec)
            got = self.ref_types.lookup(a)
            if want is not None and got is not None and got != want:
                raise TypeError(
                    f"sendability: {owner}.{behaviour_def.name} expects "
                    f"Ref[{want}] but was passed a Ref[{got}]")
        where = f"{owner}.{behaviour_def.name} send"
        for spec, a in zip(behaviour_def.arg_specs, args):
            if pack.concrete_null_handle(a):
                continue
            prev = self.cap_moves.was_moved(a)
            if prev is not None:
                raise TypeError(
                    f"capability: use-after-move — payload already moved "
                    f"by {prev} is passed to {where}")
            src = self.cap_types.lookup(a)
            want = pack.cap_mode(spec)
            if not pack.cap_store_ok(src, want):
                raise TypeError(
                    f"capability: {where} declares its parameter "
                    f"{want.capitalize()} but was passed a {src} "
                    f"payload — a {src} value cannot grant the rights "
                    f"{want} requires (is_cap_sub_cap, type/cap.c)")
        for spec, a in zip(behaviour_def.arg_specs, args):
            if pack.concrete_null_handle(a):
                continue
            want = pack.cap_mode(spec)
            if want == "iso" or (want is not None
                                 and self.cap_types.lookup(a) == "iso"):
                self.cap_moves.move(a, where)

    def send(self, target, behaviour_def: BehaviourDef, *args, when=True):
        if not isinstance(behaviour_def, BehaviourDef):
            raise TypeError("second argument to send() must be a behaviour "
                            "(e.g. SomeActor.some_behaviour)")
        if behaviour_def.global_id is None:
            raise RuntimeError(
                f"{behaviour_def} not registered in a Program yet")
        self._send_checks(target, behaviour_def, args)
        payload = pack.pack_args(behaviour_def.arg_specs, args,
                                 self.msg_words, self.device)
        gid_row = torch.full((1,) + tuple(payload.shape[1:]),
                             behaviour_def.global_id, dtype=torch.int32,
                             device=self.device)
        words = torch.cat([gid_row, payload], dim=0)
        self.sends.append((pack._tensor(target, torch.int32, self.device),
                           words, self._mask(when)))

    def spawn(self, ctor: BehaviourDef, *args, when=True):
        """Create an actor of the constructor's type and send it `ctor` as
        its first message (≙ pony_create, actor.c:688-734: in Pony
        ``create`` is itself an asynchronous behaviour, so construction is
        "claim a slot, deliver the constructor message").

        Returns the new actor's ref (an int32 tensor over the lanes),
        usable at once in this behaviour's sends and state. The spawner's
        class declares ``SPAWNS = {TargetType: n_sites}``. Where no free
        slot was reserved the ref is -1, the sticky `spawn_fail` flag
        raises SpawnCapacityError on the host, and the masked
        constructor send drops."""
        tname, ref, ok = self._claim_slot(ctor, when, "spawn")
        self.send(ref, ctor, *args, when=ok)
        return self.ref_types.tag(torch.where(ok, ref, -1), tname)

    def _claim_slot(self, ctor, when, what: str):
        """The spawn preamble shared by `spawn` and `spawn_sync`: budget
        checks and the claim of this site's reserved slot. Returns
        (target type name, reserved ref, ok mask)."""
        if not isinstance(ctor, BehaviourDef):
            raise TypeError(f"{what}() takes a constructor behaviour "
                            "(e.g. Worker.init)")
        tname = ctor.actor_type.__name__
        resv = self._spawn_resv.get(tname)
        if resv is None:
            raise RuntimeError(
                f"{tname} is not in this actor type's SPAWNS declaration; "
                f"add SPAWNS = {{{tname}: n}} to the spawning class")
        used = len(self.spawn_claims[tname])
        if used >= resv.shape[0]:
            raise RuntimeError(
                f"more than SPAWNS[{tname}]={resv.shape[0]} spawns in one "
                "behaviour dispatch; raise the declared budget")
        ref = resv[used]
        w = self._mask(when)
        ok = w & (ref >= 0)
        self.spawn_claims[tname].append(torch.where(ok, ref, -1))
        fail = w & (ref < 0)
        self.spawn_fail = fail if self.spawn_fail is False \
            else self.spawn_fail | fail
        return tname, ref, ok

    def spawn_sync(self, ctor: BehaviourDef, *args, when=True):
        """Spawn with a synchronous constructor (≙ the fork's
        pony_sendv_synchronous_constructor, actor.c:836-848): `ctor` runs
        inside this dispatch on the newborn's zeroed state, and its fields
        are written when the slot is claimed, so same-tick sends to the
        new ref find a constructed actor.

        The constructor must only return the initial state: a send,
        spawn, exit, destroy, yield or error inside it raises at build
        (an effectful create needs the asynchronous `spawn`)."""
        tname, ref, ok = self._claim_slot(ctor, when, "spawn_sync")
        specs = self._spawn_meta.get(tname)
        if specs is None:
            raise RuntimeError(
                "spawn_sync is only available in device behaviours")
        site = len(self.spawn_claims[tname]) - 1
        self._ctor_arg_checks(ctor, args, tname)
        cctx = Context(ref, self.msg_words)
        zero = {f: torch.full((), -1 if pack.is_ref(s) else 0,
                              dtype=torch.float32 if s is pack.F32
                              else torch.int32, device=self.device)
                for f, s in specs.items()}
        st2 = ctor.fn(cctx, zero, *args)
        if st2 is None or set(st2.keys()) != set(specs.keys()):
            raise TypeError(
                f"sync constructor {ctor} must return the full state dict "
                f"({sorted(specs)})")
        if (cctx.sends or cctx.destroy_called or cctx.error_called
                or any(cctx.spawn_claims.values()) or cctx.exit_called
                or cctx.yield_called):
            raise TypeError(
                f"sync constructor {ctor} performs effects; effects need a "
                "real dispatch — use ctx.spawn (async constructor message)")
        for f, s in specs.items():
            want = pack.ref_target(s)
            got = self.ref_types.lookup(st2[f])
            if want is not None and got is not None and got != want:
                raise TypeError(
                    f"sendability: sync constructor {ctor} stores a "
                    f"Ref[{got}] into field {f!r} declared Ref[{want}]")
            if pack.concrete_null_handle(st2[f]):
                continue
            src = self.cap_types.lookup(st2[f])
            dst = pack.cap_mode(s)
            if not pack.cap_store_ok(src, dst):
                raise TypeError(
                    f"capability: sync constructor {ctor} stores a "
                    f"{src} payload into field {f!r} declared "
                    f"{dst.capitalize()} — a {src} value cannot grant "
                    f"the rights {dst} requires (is_cap_sub_cap)")
            # The newborn is another actor: what lands in its fields
            # crosses an actor boundary and must be sendable.
            if src is not None and not pack.cap_sendable(src):
                raise TypeError(
                    f"capability: sync constructor {ctor} moves a "
                    f"{src} payload into the newborn's field {f!r} — "
                    f"{src} is not sendable; only iso/val/tag cross an "
                    "actor boundary (CAP_SEND, type/cap.c:90)")
        self.sync_inits.setdefault(tname, {})[site] = (st2, ok)
        return self.ref_types.tag(torch.where(ok, ref, -1), tname)

    def _ctor_arg_checks(self, ctor: BehaviourDef, args, tname: str):
        """Constructor arguments obey a send's sendability and capability
        rules (≙ expr/call.c parameter checks); handing a unique payload
        to the newborn is a move."""
        where = f"{tname}.{ctor.name} spawn_sync"
        for spec, a in zip(ctor.arg_specs, args):
            want = pack.ref_target(spec)
            got = self.ref_types.lookup(a)
            if want is not None and got is not None and got != want:
                raise TypeError(
                    f"sendability: {tname}.{ctor.name} expects Ref[{want}] "
                    f"but was passed a Ref[{got}]")
            if pack.concrete_null_handle(a):
                continue
            prev = self.cap_moves.was_moved(a)
            if prev is not None:
                raise TypeError(
                    f"capability: use-after-move — payload already moved "
                    f"by {prev} is passed to {where}")
            cwant = pack.cap_mode(spec)
            src = self.cap_types.lookup(a)
            if not pack.cap_store_ok(src, cwant):
                raise TypeError(
                    f"capability: {where} declares its parameter "
                    f"{cwant.capitalize()} but was passed a {src} "
                    f"payload — a {src} value cannot grant the rights "
                    f"{cwant} requires (is_cap_sub_cap, type/cap.c)")
        for spec, a in zip(ctor.arg_specs, args):
            if pack.concrete_null_handle(a):
                continue
            cwant = pack.cap_mode(spec)
            if cwant == "iso" or (cwant is not None
                                  and self.cap_types.lookup(a) == "iso"):
                self.cap_moves.move(a, where)

    def destroy(self, when=True):
        """Mark *this* actor for destruction at the end of the step: slot
        freed, queued messages discarded, later sends dead-letter."""
        self.destroy_called = True
        self.destroy_flag = self.destroy_flag | self._mask(when)

    def exit(self, code=0, when=True):
        """Request program termination (≙ pony_exitcode + quiescent stop)."""
        self.exit_called = True
        w = self._mask(when)
        self.exit_flag = self.exit_flag | w
        self.exit_code = torch.where(
            w, pack._tensor(code, torch.int32, self.device),
            pack._tensor(self.exit_code, torch.int32, self.device))

    def yield_(self, when=True):
        """Stop draining this actor's mailbox for the rest of the step
        (≙ the fork's ponyint_actor_yield, actor.c:675-679)."""
        self.yield_called = True
        self.yield_flag = self.yield_flag | self._mask(when)

    def error_int(self, code, when=True):
        """Record an int-coded error on this actor (≙ the fork's
        pony_error_int / pony_error_code, pony.h:622-665)."""
        self.error_called = True
        from .errors import caller_loc, register_error_site
        site = register_error_site(caller_loc())
        w = self._mask(when)
        dev = self.device
        self.error_flag = self.error_flag | w
        self.error_code = torch.where(
            w, pack._tensor(code, torch.int32, dev),
            pack._tensor(self.error_code, torch.int32, dev))
        self.error_loc = torch.where(
            w, torch.full((), site, dtype=torch.int32, device=dev),
            pack._tensor(self.error_loc, torch.int32, dev))

    # -- the device blob pool (≙ actor-heap message payloads; see
    # BlobPoolView) --
    def _require_blob(self, what: str):
        if self._blob is None:
            raise RuntimeError(
                f"{what}: the device blob pool is disabled — set "
                "RuntimeOptions.blob_slots and blob_words (> 0); host "
                "behaviours have no device pool")
        return self._blob

    def _blob_guard(self, h, what: str):
        """The iso discipline shared by the blob ops: touching a handle
        after it was moved (sent, or freed) is use-after-move."""
        prev = self.cap_moves.was_moved(h)
        if prev is not None:
            raise TypeError(
                f"capability: use-after-move — blob handle already moved "
                f"by {prev} is passed to {what}")

    def blob_alloc(self, length=None, when=True):
        """Claim a fresh device blob; returns its handle (-1 where `when`
        is false or the pool had no free slot — the sticky blob-fail flag
        then raises BlobCapacityError on the host). The slot's words are
        zeroed; `length` (default: the pool width) is the logical word
        count blob_length() reads back. The class declares
        ``MAX_BLOBS = n`` (allocs a dispatch). ≙ pony_alloc_msg on the
        owning actor's heap."""
        b = self._require_blob("blob_alloc")
        if b.nsites == 0:
            raise RuntimeError(
                "blob_alloc: declare MAX_BLOBS = n on the allocating "
                "actor class (the per-dispatch alloc budget)")
        used = self._blob_claims
        if used >= b.nsites:
            raise RuntimeError(
                f"more than MAX_BLOBS={b.nsites} blob_alloc calls in one "
                "behaviour dispatch; raise the declared budget")
        self._blob_claims = used + 1
        h = b.alloc(used, length, when)
        self.cap_types.tag(h, "iso")
        return h

    def blob_get(self, h, i):
        """Word `i` of blob `h` (int32; 0 for null, stale, unallocated or
        off-pool handles and out-of-range words). Floats:
        ``ctx.blob_get(h, i).view(torch.float32)``."""
        b = self._require_blob("blob_get")
        self._blob_guard(h, "blob_get")
        return b.get(h, i)

    def blob_length(self, h):
        """The logical word count recorded at blob_alloc (0 for null,
        stale or off-pool handles)."""
        b = self._require_blob("blob_length")
        self._blob_guard(h, "blob_length")
        return b.length(h)

    def blob_freeze(self, h):
        """Freeze an owned (iso) blob into shared-immutable VAL (≙ Pony's
        ``recover val``): the handle may then go to many readers (declare
        the parameter ``BlobVal``); writes and frees are rejected; the GC
        reclaims the slot once nothing references it. A capability tag
        only: no device work."""
        self._require_blob("blob_freeze")
        self._blob_guard(h, "blob_freeze")
        if self.cap_types.lookup(h) != "val":
            self.cap_types.tag(h, "val")
        return h

    def blob_set(self, h, i, v, when=True):
        """Write word `i` of blob `h` (int32, masked by `when`); later
        blob_get calls of this dispatch and the handle's next owner see
        it. Floats: pass ``value.view(torch.int32)``."""
        b = self._require_blob("blob_set")
        self._blob_guard(h, "blob_set")
        if self.cap_types.lookup(h) == "val":
            raise TypeError(
                "capability: blob_set on a frozen (val) blob — "
                "shared-immutable payloads cannot be written "
                "(≙ val's deny-write, type/cap.c)")
        b.set(h, i, v, when)

    def blob_free(self, h, when=True):
        """Return blob `h` to the pool. Freeing is a move: later use of
        the handle in this dispatch is rejected. Blobs whose owner died
        are swept by the next Runtime.gc()."""
        b = self._require_blob("blob_free")
        self._blob_guard(h, "blob_free")
        if self.cap_types.lookup(h) == "val":
            raise TypeError(
                "capability: blob_free on a frozen (val) blob — shared "
                "payloads have no single owner to free them; the GC "
                "mark pass reclaims unreferenced val blobs")
        b.free(h, when)
        self.cap_moves.move(h, "blob_free")

"""Fact gathering for the whole-program lint pass.

Probes every behaviour of the analysed world with the verify pass's
probe tracer (verify.probe_behaviour — meta-device tensors only, no
kernel runs, milliseconds per behaviour) and collects per-behaviour
facts: the effect signature, one SendFact per send/spawn site (target
behaviour, when-mask constness, argument capability tags), blob-op
sites, and — crucially — probe FAILURES. A behaviour whose trace
raises a capability/sendability TypeError is not a crash here: the
failure is itself a fact, which rules.py lifts into an R3 finding
(the whole-program version of the trace-time checks).

Host behaviours (HOST=True types) run real Python and are not traced;
they contribute zero-effect node facts so the message-flow graph sees
the host cohorts device messages land on (≙ inject_main's
use_main_thread actors, scheduler.c:179).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, List, Optional, Tuple

from ..api import ActorTypeMeta
from ..ops import pack
from ..verify import (Effects, SendFact, behaviour_effects,
                      behaviour_location, probe_behaviour)


@dataclasses.dataclass(frozen=True)
class BehaviourFacts:
    """Everything the probe learned about one behaviour."""

    type_name: str
    behaviour: str
    host: bool
    effects: Effects
    sends: Tuple[SendFact, ...] = ()
    blob_alloc_whens: Tuple[Optional[bool], ...] = ()   # per alloc site
    blob_free_sites: int = 0
    blob_freeze_sites: int = 0
    error: Optional[str] = None        # probe raised: the message
    error_kind: Optional[str] = None   # "capability"|"sendability"|"trace"
    file: Optional[str] = None         # def site (behaviour_location)
    line: Optional[int] = None
    ignore: Tuple[str, ...] = ()       # behaviour-level LINT_IGNORE

    @property
    def node(self) -> Tuple[str, str]:
        return (self.type_name, self.behaviour)


@dataclasses.dataclass(frozen=True)
class TypeFacts:
    """One actor type's static declarations + its behaviours' facts."""

    atype: ActorTypeMeta
    name: str
    host: bool
    spawns_declared: Dict[str, int]      # SPAWNS, names normalised
    max_blobs: int
    ignore: Tuple[str, ...]              # LINT_IGNORE rule ids
    roots_declared: Tuple[str, ...]      # LINT_ROOTS behaviour names
    behaviours: Tuple[BehaviourFacts, ...]
    file: Optional[str] = None           # class def site, if derivable
    line: Optional[int] = None

    def blob_specs(self):
        """(where, spec) for every Blob/BlobVal field or parameter —
        rules.py's R3 host-blob scan."""
        out = []
        for fname, spec in self.atype.field_specs.items():
            if pack.is_blob(spec):
                out.append((None, fname, spec))
        for b in self.atype.behaviour_defs:
            for aname, spec in zip(b.arg_names, b.arg_specs):
                if pack.is_blob(spec):
                    out.append((b.name, aname, spec))
        return out


def _classify(msg: str) -> str:
    if "capability:" in msg:
        return "capability"
    if "sendability:" in msg:
        return "sendability"
    return "trace"


def gather_type(atype: ActorTypeMeta, msg_words: int = 8,
                default_max_sends: int = 2) -> TypeFacts:
    """Probe one actor type's behaviours into TypeFacts."""
    name = atype.__name__
    host = bool(getattr(atype, "HOST", False))
    spawns = {(t if isinstance(t, str) else t.__name__): int(n)
              for t, n in (getattr(atype, "SPAWNS", {}) or {}).items()}
    ignore = tuple(str(r) for r in getattr(atype, "LINT_IGNORE", ()) or ())
    roots = tuple(
        (r.name if hasattr(r, "name") else str(r))
        for r in getattr(atype, "LINT_ROOTS", ()) or ())
    bfs: List[BehaviourFacts] = []
    for bdef in atype.behaviour_defs:
        bfile, bline = behaviour_location(bdef)
        bignore = tuple(getattr(bdef, "lint_ignore", ()) or ()) + tuple(
            str(r) for r in getattr(bdef, "LINT_IGNORE", ()) or ())
        if host:
            bfs.append(BehaviourFacts(
                type_name=name, behaviour=bdef.name, host=True,
                effects=behaviour_effects(bdef, atype),
                file=bfile, line=bline, ignore=bignore))
            continue
        try:
            ctx = probe_behaviour(bdef, atype, msg_words=msg_words)
        except (TypeError, RuntimeError, ValueError) as e:
            bfs.append(BehaviourFacts(
                type_name=name, behaviour=bdef.name, host=False,
                effects=Effects(sends=0, max_sends=0, can_error=False,
                                can_destroy=False, can_exit=False,
                                can_yield=False, spawns=(),
                                sync_spawns=()),
                error=str(e), error_kind=_classify(str(e)),
                file=bfile, line=bline, ignore=bignore))
            continue
        max_sends = (getattr(atype, "MAX_SENDS", None)
                     or int(default_max_sends))
        eff = Effects(
            sends=len(ctx.sends),
            max_sends=int(max_sends),
            can_error=ctx.error_called,
            can_destroy=ctx.destroy_called,
            can_exit=ctx.exit_called,
            can_yield=ctx.yield_called,
            spawns=tuple(sorted(
                (t, len(c)) for t, c in ctx.spawn_claims.items() if c)),
            sync_spawns=tuple(sorted(ctx.sync_inits.keys())),
            blob_allocs=ctx.blob_claims,
        )
        bfs.append(BehaviourFacts(
            type_name=name, behaviour=bdef.name, host=False,
            effects=eff, sends=tuple(ctx.send_facts),
            blob_alloc_whens=tuple(ctx.blob_alloc_whens),
            blob_free_sites=ctx.blob_free_sites,
            blob_freeze_sites=ctx.blob_freeze_sites,
            file=bfile, line=bline, ignore=bignore))
    try:
        tfile = inspect.getsourcefile(atype)
        tline = inspect.getsourcelines(atype)[1]
    except (OSError, TypeError):         # reified/exec'd types
        tfile, tline = (bfs[0].file, bfs[0].line) if bfs else (None, None)
    return TypeFacts(atype=atype, name=name, host=host,
                     spawns_declared=spawns, max_blobs=int(
                         getattr(atype, "MAX_BLOBS", 0) or 0),
                     ignore=ignore, roots_declared=roots,
                     behaviours=tuple(bfs), file=tfile, line=tline)


def gather(atypes, msg_words: int = 8,
           default_max_sends: int = 2) -> Dict[str, TypeFacts]:
    """The analysed world: {type name: TypeFacts}, insertion-ordered.
    Generic templates have no layout (≙ reify.c) and are rejected —
    pass reifications (Cls[I32])."""
    world: Dict[str, TypeFacts] = {}
    for atype in atypes:
        if not isinstance(atype, ActorTypeMeta):
            raise TypeError(f"{atype!r} is not an actor type (use @actor)")
        if getattr(atype, "_type_params", ()):
            params = ", ".join(p.name for p in atype._type_params)
            raise TypeError(
                f"{atype.__name__} is generic over [{params}] — lint a "
                f"reification (e.g. {atype.__name__}[I32]) instead")
        if atype.__name__ in world:
            continue
        world[atype.__name__] = gather_type(
            atype, msg_words=msg_words,
            default_max_sends=default_max_sends)
    return world

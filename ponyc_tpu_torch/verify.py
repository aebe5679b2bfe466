"""Verify pass of the PyTorch port: per-behaviour effect signatures,
discovered by probe tracing (the counterpart of ``ponyc_tpu/verify.py``).

≙ the reference's verify stage (src/libponyc/verify/fun.c: after type
checking, every function's partial-call/error behaviour is analysed and
mismatches rejected). Errors here are VALUES (ctx.error_int — the
fork's pony_error_int), so there is no caller-must-handle obligation to
enforce; what the pass delivers instead is the same ANALYSIS made
queryable: which behaviours can error/destroy/exit/yield, how many
sends they perform against the type's budget, and what they spawn —
surfaced programmatically (`verify_program`), in generated docs
(docgen marks behaviours like Pony marks partial functions with `?`),
and as hard failures for budget violations at verify time instead of
first dispatch.

Probe tracing runs each body once over one-lane tensors on the meta
device (shapes and dtypes only: nothing is computed and no kernel
launches), with the meta device as the default for tensors the body
builds, so verifying a program costs milliseconds. A body that needs a
value (``.item()``, ``if`` on a tensor, a NumPy conversion) raises
there, as it would under the JAX package's abstract trace.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import torch

from .api import ActorTypeMeta, BehaviourDef, BlobPoolView, Context
from .errors import ERROR_CODES
from .ops import pack


_META = torch.device("meta")


def when_const(when) -> Optional[bool]:
    """Classify a ``when=`` mask at trace time: True/False if it is a
    trace-time constant (the send/spawn provably always/never happens),
    None if data-dependent. The lint rules key on this — only
    *unconditional* edges prove amplification or pool exhaustion, and a
    constant-False send is a guaranteed dead letter.

    A Python or NumPy value is constant. Every tensor the probe sees is
    a meta tensor, whether computed from a field or an argument or built
    inside the body (the meta device is the probe's default), so it is
    None: the JAX package likewise gives None for every jnp value under
    its trace."""
    if isinstance(when, bool):
        return when
    if isinstance(when, torch.Tensor) and when.device == _META:
        return None
    try:
        return bool(when)
    except Exception:                       # noqa: BLE001 — traced/array
        return None


@dataclasses.dataclass(frozen=True)
class SendFact:
    """One send/spawn site observed by the probe — the unit fact the
    whole-program lint pass (ponyc_tpu.lint) assembles into the
    message-flow graph. `dst_*` name the TARGET behaviour; the owning
    (source) behaviour is implied by which probe recorded the fact."""

    kind: str                         # "send" | "spawn" | "spawn_sync"
    dst_type: str                     # target behaviour's actor type
    dst_behaviour: str                # target behaviour name
    when: Optional[bool]              # when_const() of the mask
    target_ref: Optional[str]         # typed provenance of the target
    arg_caps: Tuple[Optional[str], ...]   # declared param cap modes
    arg_src_caps: Tuple[Optional[str], ...]  # provenance of the values


@dataclasses.dataclass(frozen=True)
class Effects:
    """What one behaviour DOES, beyond its state update."""

    sends: int                    # ctx.send call sites
    max_sends: int                # the type's declared budget
    can_error: bool               # ctx.error_int reachable
    can_destroy: bool             # ctx.destroy reachable
    can_exit: bool                # ctx.exit reachable
    can_yield: bool               # ctx.yield_ reachable
    spawns: Tuple[Tuple[str, int], ...]   # (target type, claim sites)
    sync_spawns: Tuple[str, ...]  # targets constructed synchronously
    blob_allocs: int = 0          # ctx.blob_alloc call sites (≤ MAX_BLOBS)

    def marks(self) -> str:
        """Compact docgen suffix (≙ Pony's `?` partial mark)."""
        out = []
        if self.sends:
            # Observed count against the type's budget — `3/4`, not the
            # old `sends≤3`, which mislabelled the observed count as the
            # budget.
            out.append(f"sends {self.sends}/{self.max_sends}")
        for t, n in self.spawns:
            out.append(f"spawns {t}×{n}")
        if self.sync_spawns:
            out.append("sync-constructs "
                       + ",".join(sorted(set(self.sync_spawns))))
        if self.blob_allocs:
            out.append(f"allocs blobs×{self.blob_allocs}")
        if self.can_error:
            out.append("may error")      # ≙ the `?` mark
        if self.can_destroy:
            out.append("may destroy")
        if self.can_exit:
            out.append("may exit")
        if self.can_yield:
            out.append("may yield")
        return ", ".join(out)


class VerifyError(TypeError):
    """A behaviour violates its type's declared budgets (≙ the verify
    pass rejecting a method body, verify/fun.c)."""

    code = ERROR_CODES["VerifyError"]


def behaviour_location(bdef: BehaviourDef
                       ) -> Tuple[Optional[str], Optional[int]]:
    """(source file, first line) of a behaviour's definition, where
    derivable — captured at decoration time (api.BehaviourDef) from
    the function's __code__, so lint findings and verify failures can
    point at real source. (None, None) for functions without source
    (exec'd strings, builtins)."""
    file = getattr(bdef, "source_file", None)
    line = getattr(bdef, "source_line", None)
    if file is None:
        code = getattr(bdef.fn, "__code__", None)
        file = getattr(code, "co_filename", None)
        line = getattr(code, "co_firstlineno", None)
    if file is not None and not os.path.exists(file):
        return None, None
    return file, line


class _ProbeContext(Context):
    """A Context usable BEFORE any Program exists: send() records the
    call (plus the rich per-send facts lint consumes) without requiring
    registered behaviour ids or packing against a concrete msg_words
    (the verify pass runs on bare actor classes, like the reference
    verifying a method body before reachability).

    The probe runs the SAME trace-time sendability/capability checks as
    the real Context (api.Context._send_checks) — the whole-program
    lint pass (ponyc_tpu.lint R3) lifts those trace failures into
    findings instead of first-dispatch crashes."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.send_facts: List[SendFact] = []
        self.blob_alloc_whens: List[Optional[bool]] = []
        self.blob_free_sites = 0
        self.blob_freeze_sites = 0
        self._in_spawn = False            # inside ctx.spawn()
        self._spawn_when: Optional[bool] = None   # its user mask

    def _record(self, kind, behaviour_def, target, args, when):
        self.send_facts.append(SendFact(
            kind=kind,
            dst_type=behaviour_def.actor_type.__name__,
            dst_behaviour=behaviour_def.name,
            when=when,
            target_ref=self.ref_types.lookup(target),
            arg_caps=tuple(pack.cap_mode(s)
                           for s in behaviour_def.arg_specs),
            arg_src_caps=tuple(self.cap_types.lookup(a) for a in args),
        ))

    def send(self, target, behaviour_def, *args, when=True):
        if not isinstance(behaviour_def, BehaviourDef):
            raise TypeError(
                "second argument to send() must be a behaviour "
                "(e.g. SomeActor.some_behaviour)")
        self._send_checks(target, behaviour_def, args)
        if self._in_spawn:
            # The ctor message ctx.spawn() emits: conditionality is the
            # USER's mask (the slot-claim `ok` it pipes through here is
            # always traced — it folds in the reservation's validity).
            self._record("spawn", behaviour_def, target, args,
                         self._spawn_when)
        else:
            self._record("send", behaviour_def, target, args,
                         when_const(when))
        self.sends.append((target, None, when))

    def spawn(self, ctor, *args, when=True):
        self._in_spawn, self._spawn_when = True, when_const(when)
        try:
            return super().spawn(ctor, *args, when=when)
        finally:
            self._in_spawn, self._spawn_when = False, None

    def spawn_sync(self, ctor, *args, when=True):
        """Claim-only: the ctor does not RUN during effect probing (it
        must be pure construction anyway — the real path enforces
        that), so string-form SPAWNS targets need no field specs. The
        constructor ARGUMENTS still face the full sendability +
        capability discipline (api.Context._ctor_arg_checks)."""
        tname, ref, ok = self._claim_slot(ctor, when, "spawn_sync")
        self._ctor_arg_checks(ctor, args, tname)
        self._record("spawn_sync", ctor, None, args, when_const(when))
        self.sync_inits.setdefault(tname, {})
        return self.ref_types.tag(ref, tname)

    # Blob-op site facts (R5 pool-feasibility inputs): count sites and
    # keep each alloc's when-mask constness; then defer to the real ops.
    def blob_alloc(self, length=None, when=True):
        self.blob_alloc_whens.append(when_const(when))
        return super().blob_alloc(length=length, when=when)

    @property
    def blob_claims(self) -> int:
        """blob_alloc sites used (0 where the pool view is off)."""
        return self._blob_claims if self._blob is not None else 0

    def blob_free(self, h, when=True):
        self.blob_free_sites += 1
        return super().blob_free(h, when=when)

    def blob_freeze(self, h):
        self.blob_freeze_sites += 1
        return super().blob_freeze(h)


def _probe_value(spec) -> torch.Tensor:
    """A one-lane meta tensor shaped and typed as the engine hands a body
    an argument of `spec` (pack.unpack_arg / unpack_args)."""
    if isinstance(spec, pack._VecSpec):
        dt = torch.float32 if spec.base is pack.F32 else torch.int32
        return torch.zeros((spec.n, 1), dtype=dt, device=_META)
    if spec is pack.F32:
        dt = torch.float32
    elif spec is pack.Bool:
        dt = torch.bool
    elif spec in pack._NARROW:
        dt = pack._NARROW[spec][0]
    else:
        dt = torch.int32
    return torch.zeros((1,), dtype=dt, device=_META)


def probe_behaviour(bdef: BehaviourDef,
                    atype: Optional[ActorTypeMeta] = None,
                    msg_words: int = 8) -> _ProbeContext:
    """Probe-trace one DEVICE behaviour on one-lane meta tensors and
    return the probe context carrying everything it observed: the
    effect counters behind Effects plus the per-send SendFacts the lint
    pass consumes. Raises (TypeError/RuntimeError) exactly where the
    engine's real trace would — sendability, capability, and budget
    shape violations — and where a body needs a tensor's value."""
    atype = atype or bdef.actor_type
    field_specs = atype.field_specs
    spawn_budget = {
        (t if isinstance(t, str) else t.__name__): n
        for t, n in getattr(atype, "SPAWNS", {}).items()}
    i32 = dict(dtype=torch.int32, device=_META)
    with torch.device(_META):
        resv = {t: torch.full((max(1, n), 1), -1, **i32)
                for t, n in spawn_budget.items()}
        # A one-slot stand-in blob pool (and its dropping slot) so
        # blob-using behaviours probe; budgets enforce exactly like the
        # engine's MAX_BLOBS window.
        mb = int(getattr(atype, "MAX_BLOBS", 0) or 0)
        bv = BlobPoolView(
            torch.zeros((1, 2), **i32),
            torch.zeros((2,), dtype=torch.bool, device=_META),
            torch.zeros((2,), **i32), torch.zeros((2,), **i32), 0,
            torch.ones((1,), dtype=torch.bool, device=_META),
            torch.full((mb, 1), -1, **i32) if mb else None)
        ctx = _ProbeContext(torch.zeros((1,), **i32), msg_words,
                            spawn_resv=resv,
                            spawn_meta={t: {} for t in spawn_budget},
                            blob=bv)
        st = {k: torch.zeros((1,), dtype=torch.float32 if s is pack.F32
                             else torch.int32, device=_META)
              for k, s in field_specs.items()}
        args = [_probe_value(spec) for spec in bdef.arg_specs]
        for k, v in st.items():
            ctx.ref_types.tag(v, pack.ref_target(field_specs[k]))
            ctx.cap_types.tag(v, pack.cap_mode(field_specs[k]))
        for spec, a in zip(bdef.arg_specs, args):
            ctx.ref_types.tag(a, pack.ref_target(spec))
            ctx.cap_types.tag(a, pack.cap_mode(spec))
        try:
            bdef.fn(ctx, dict(st), *args)
        except (RuntimeError, TypeError) as e:
            if "meta" not in str(e):
                raise
            # A meta tensor has no value: the body read one (.item(),
            # bool() of `if`/`while`/`and`, a NumPy conversion).
            raise TypeError(
                f"trace: behaviour {atype.__name__}.{bdef.name} needs a "
                f"tensor's value at trace time ({e}); the trace cannot "
                "branch — mask effects with when= or select with "
                "torch.where") from e
    return ctx


def behaviour_effects(bdef: BehaviourDef,
                      atype: Optional[ActorTypeMeta] = None,
                      msg_words: int = 8,
                      default_max_sends: int = 2) -> Effects:
    """Probe-trace one behaviour and collect its effect signature.
    Host behaviours (HOST=True types) run real Python — they are not
    traced and report zero device effects.

    `default_max_sends` is the RuntimeOptions.max_sends fallback; the
    budget resolves EXACTLY as program build does
    (`MAX_SENDS or opts.max_sends`, program.py) so verify enforces the
    budget the engine actually uses."""
    atype = atype or bdef.actor_type
    max_sends = (getattr(atype, "MAX_SENDS", None)
                 or int(default_max_sends))
    if getattr(atype, "HOST", False):
        return Effects(sends=0, max_sends=0, can_error=False,
                       can_destroy=False, can_exit=False,
                       can_yield=False, spawns=(), sync_spawns=())
    ctx = probe_behaviour(bdef, atype, msg_words=msg_words)
    return Effects(
        sends=len(ctx.sends),
        max_sends=int(max_sends),
        can_error=ctx.error_called,
        can_destroy=ctx.destroy_called,
        can_exit=ctx.exit_called,
        can_yield=ctx.yield_called,
        spawns=tuple(sorted((t, len(c))
                            for t, c in ctx.spawn_claims.items() if c)),
        sync_spawns=tuple(sorted(ctx.sync_inits.keys())),
        blob_allocs=ctx.blob_claims,
    )


def verify_behaviour(bdef: BehaviourDef,
                     default_max_sends: int = 2) -> Effects:
    """Effects + budget enforcement for one behaviour."""
    eff = behaviour_effects(bdef, default_max_sends=default_max_sends)
    if eff.sends > eff.max_sends:
        raise VerifyError(
            f"verify: behaviour {bdef} performs {eff.sends} sends but "
            f"the type's budget is MAX_SENDS={eff.max_sends} "
            "(≙ verify/fun.c rejecting the body)")
    return eff


def verify_program(program, lint: bool = True
                   ) -> Dict[str, Dict[str, Effects]]:
    """The verify pass over every cohort: {type: {behaviour: Effects}};
    raises VerifyError on budget violations. Budgets come from the
    program's OWN resolution (cohort.max_sends), so the pass enforces
    exactly what the engine will run.

    Host cohorts are REPORTED too (zero-effect entries — host
    behaviours run real Python, not traced) rather than silently
    skipped, so whole-program consumers (the lint pass's message-flow
    graph) see the host nodes messages land on.

    With ``lint=True`` (default) the whole-program lint pass
    (ponyc_tpu.lint.lint_program) runs after the per-behaviour budgets:
    error-severity findings — provably-broken wiring like sends to
    types outside the program or capability violations — raise
    VerifyError; warnings/info are left to `lint_program` callers."""
    report: Dict[str, Dict[str, Effects]] = {}
    for cohort in program.cohorts:
        ents: Dict[str, Effects] = {}
        for bdef in cohort.behaviours:
            eff = behaviour_effects(
                bdef, cohort.atype,
                default_max_sends=program.opts.max_sends)
            if not cohort.host and eff.sends > cohort.max_sends:
                raise VerifyError(
                    f"verify: behaviour {bdef} performs {eff.sends} "
                    f"sends but the cohort's budget is "
                    f"{cohort.max_sends} (≙ verify/fun.c)")
            ents[bdef.name] = eff
        report[cohort.atype.__name__] = ents
    if lint:
        from .lint import lint_program
        errors = [f for f in lint_program(program)
                  if f.severity == "error"]
        if errors:
            lines = "\n".join(f"  {f}" for f in errors)
            raise VerifyError(
                f"verify: lint found {len(errors)} error-severity "
                f"finding(s) (≙ reach/paint + safeto rejecting the "
                f"program):\n{lines}")
    return report

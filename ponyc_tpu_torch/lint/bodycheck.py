"""Behaviour-body source analyzer — pure-AST rules R6–R9 (the PyTorch
port's copy of ``ponyc_tpu/lint/bodycheck.py``: the same rules, ids,
severities and positions; the advice names torch idioms).

≙ the reference compiler's SYNTACTIC body checks: safeto.c proves
sendability and the verify stage (src/libponyc/verify/fun.c) walks
every method body before codegen. The probe-based graph rules (R0–R5)
need a trace; an entire class of defects dies *at* the trace — Python
control flow on traced values surfaces as an opaque
RuntimeError from a meta tensor's bool(), non-static send counts as shape
errors — or worse, traces fine and silently corrupts semantics (host
I/O runs once at trace time, an in-place ``st`` mutation is dropped by
a rebuilt return dict). This module catches that class at DEFINITION
time with file:line:col findings, by walking the behaviour's AST:

  R6  traced-value control flow: ``if``/``while``/ternary/``and``/
      ``or``/``not``/chained comparison/``assert``/iteration branching
      on a state field or behaviour argument — the trace cannot
      branch; use ``when=`` masks, ``torch.where``, ``&``/``|``/``~``.
                                                              [error]
  R7  non-static effect sites: ``self.send``/``spawn``/``exit``/
      ``yield_``/blob ops under loops whose trip count is not a
      trace-time constant or inside nested (helper) functions
      [error/warning]; behaviour bodies that can fall off the end —
      or ``return`` bare — instead of returning the state dict
      on every path.                                    [error]
  R8  state-key discipline: ``st["key"]`` reads/writes and return-dict
      keys checked against the type's declared annotations with
      did-you-mean for typos [error]; return dicts that drop declared
      fields [error]; writes to Val/immutable-declared fields
      [warning]; in-place ``st`` mutations dropped by a rebuilt
      return dict [warning]; assignment to ``self.<attr>`` [error].
  R9  host impurity & linear handles: ``print``/``open``/``time.*``/
      ``np.random``/``random`` calls, ``global``/``nonlocal``, and
      mutation of captured mutable globals inside a traced body (they
      run ONCE, at trace) [warning]; a forward dataflow pass flagging
      Iso/Blob handles used again after being passed to ``self.send``
      / ``blob_free`` — the use-after-move check the trace can only
      catch dynamically — and writes to val (frozen) blobs. [error]

Everything here is ``ast`` only — NO torch, NO tracing, and no import of
the target: `check_source`/`check_path` analyse files that do not even
import (missing deps, broken top level). `check_types` runs the same
rules over already-imported actor types via `inspect.getsource`, which
is how lint_types/lint_module/lint_program/Program.lint pick R6–R9 up.
Analysis is a single linear walk per behaviour — well under 100 ms per
module. HOST behaviours run real Python: R6/R9 do not apply and loop
rules are skipped; the return-path and state-key rules still do.
"""

from __future__ import annotations

import ast
import dataclasses
import difflib
import os
import textwrap
from typing import (Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

from .rules import Finding, line_suppressed, sort_findings

# Annotation root name → capability mode (the AST-side mirror of
# ops.pack.cap_mode; kept string-only so this module never imports
# torch). Ref is an actor ref (tag-like wiring, freely aliased).
_CAP_BY_NAME = {"Iso": "iso", "Trn": "trn", "Mut": "ref", "Val": "val",
                "Box": "box", "Tag": "tag", "Blob": "iso",
                "BlobVal": "val"}
_IMMUTABLE_ROOTS = {"Val", "BlobVal", "Box"}
_LINEAR_ROOTS = {"Iso", "Blob"}          # moved-unique handles

# Context effect methods whose per-dispatch count/flags must be
# trace-time static (the engine pads to declared budgets).
_EFFECTS = {"send", "spawn", "spawn_sync", "exit", "yield_", "destroy",
            "error_int", "blob_alloc", "blob_free"}
# Context calls returning traced values.
_TRACED_CALLS = {"spawn", "spawn_sync", "blob_alloc", "blob_get",
                 "blob_length", "blob_freeze"}
# Builtins whose call is host I/O (runs once, at trace).
_IMPURE_BUILTINS = {"print", "open", "input", "breakpoint"}
# Attribute roots whose calls are host-impure in a traced body.
_IMPURE_MODULES = {"time", "random"}
# Mutating container methods (closure-capture mutation detection).
_MUTATORS = {"append", "add", "extend", "insert", "remove", "pop",
             "clear", "update", "setdefault", "discard", "popitem",
             "appendleft", "write"}
# Static tracer metadata attributes (reading them does NOT produce a
# traced value — .ndim/.shape feed Python-level shape arithmetic).
_STATIC_ATTRS = {"ndim", "shape", "dtype", "size", "itemsize"}


@dataclasses.dataclass
class BehaviourBody:
    """One behaviour's AST + typed-parameter view, however obtained
    (parsed from a file, or inspect.getsource of a live function)."""

    name: str
    node: ast.FunctionDef
    file: Optional[str]
    arg_caps: Dict[str, Optional[str]]    # param name → cap mode
    ignore: Tuple[str, ...] = ()          # behaviour-level LINT_IGNORE


@dataclasses.dataclass
class TypeBody:
    """One actor type's source-level view for the body rules."""

    name: str
    host: bool
    file: Optional[str]
    fields: Optional[Dict[str, str]]      # None = unknown (can't check)
    immutable: Set[str]                   # Val/Box-declared field names
    ignore: Tuple[str, ...]               # type-level LINT_IGNORE
    behaviours: List[BehaviourBody]


# A resolver maps (type name, behaviour name) → that behaviour's
# parameter cap modes, or None when the target is unknown. It decides
# whether a send MOVES its payload (iso parameter) — path mode
# resolves within the parsed files, types mode through fn globals.
Resolver = Callable[[str, str], Optional[Tuple[Optional[str], ...]]]


def _ann_root(node) -> str:
    """Root name of an annotation AST: Ref["Sink"] → Ref, pack.Iso →
    Iso, VecF32[8] → VecF32."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return "?"


def _deco_name(d) -> str:
    if isinstance(d, ast.Call):
        d = d.func
    if isinstance(d, ast.Attribute):
        return d.attr
    if isinstance(d, ast.Name):
        return d.id
    return ""


def _str_tuple(node) -> Tuple[str, ...]:
    """A (constant) tuple/list of strings from an AST value, else ()."""
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.append(el.value)
        return tuple(out)
    return ()


def _attr_chain(node) -> Tuple[str, ...]:
    """x.y.z → ("x", "y", "z"); () when the base is not a Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


# ---------------------------------------------------------------------------
# AST extraction: actor classes + behaviours from a parsed module


def _class_is_actor(cls: ast.ClassDef) -> Tuple[bool, bool]:
    """(is actor type, fields complete). Fields are complete when the
    class derives them only from its own annotations (@actor decorator
    or direct Actor base); other bases may contribute inherited fields
    the AST cannot see."""
    for d in cls.decorator_list:
        if _deco_name(d) == "actor":
            return True, True
    base_names = [_ann_root(b) for b in cls.bases]
    if "Actor" in base_names:
        return True, len(base_names) == 1
    for kw in cls.keywords:
        if kw.arg == "metaclass" and _ann_root(kw.value) == "ActorTypeMeta":
            return True, not cls.bases
    return False, False


def _behaviour_from_ast(item: ast.FunctionDef,
                        file: Optional[str]) -> Optional[BehaviourBody]:
    deco = None
    for d in item.decorator_list:
        if _deco_name(d) in ("behaviour", "be"):
            deco = d
            break
    if deco is None:
        return None
    ignore: Tuple[str, ...] = ()
    if isinstance(deco, ast.Call):
        for kw in deco.keywords:
            if kw.arg == "lint_ignore":
                ignore = _str_tuple(kw.value)
    params = item.args.args
    if len(params) < 2:
        return None                      # malformed; probe rules report
    arg_caps = {}
    for p in params[2:]:
        root = _ann_root(p.annotation) if p.annotation is not None else ""
        arg_caps[p.arg] = _CAP_BY_NAME.get(root)
    return BehaviourBody(name=item.name, node=item, file=file,
                         arg_caps=arg_caps, ignore=ignore)


def parse_module(src: str, filename: str = "<string>"
                 ) -> Tuple[List[TypeBody], Set[str]]:
    """All actor types in a module's SOURCE (no import), plus the
    module-level mutable-container globals (list/dict/set literals)
    the impurity rule watches for closure mutation. Nested classes
    (actors defined inside functions) are found too."""
    tree = ast.parse(src, filename=filename)
    mutable_globals: Set[str] = set()
    for s in tree.body:
        if isinstance(s, ast.Assign) and isinstance(
                s.value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    mutable_globals.add(t.id)
    types: List[TypeBody] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        is_actor, complete = _class_is_actor(node)
        if not is_actor:
            continue
        fields: Dict[str, str] = {}
        immutable: Set[str] = set()
        host = False
        ignore: Tuple[str, ...] = ()
        behaviours: List[BehaviourBody] = []
        for item in node.body:
            if isinstance(item, ast.AnnAssign) and isinstance(
                    item.target, ast.Name):
                fname = item.target.id
                if fname.startswith("_") or fname.isupper():
                    continue
                root = _ann_root(item.annotation)
                fields[fname] = root
                if root in _IMMUTABLE_ROOTS:
                    immutable.add(fname)
            elif isinstance(item, ast.Assign):
                for t in item.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if t.id == "HOST" and isinstance(
                            item.value, ast.Constant):
                        host = bool(item.value.value)
                    elif t.id == "LINT_IGNORE":
                        ignore = _str_tuple(item.value)
            elif isinstance(item, ast.FunctionDef):
                bb = _behaviour_from_ast(item, filename)
                if bb is not None:
                    behaviours.append(bb)
        types.append(TypeBody(
            name=node.name, host=host, file=filename,
            fields=fields if complete else None, immutable=immutable,
            ignore=ignore, behaviours=behaviours))
    return types, mutable_globals


# ---------------------------------------------------------------------------
# The analyzer: one forward walk per behaviour body


class _Env:
    """Forward dataflow state: taintedness (traced-value provenance),
    moved linear handles, live linear/val handle names."""

    __slots__ = ("tainted", "moved", "linear", "vals")

    def __init__(self, tainted=(), linear=(), vals=()):
        self.tainted: Set[str] = set(tainted)
        self.moved: Dict[str, int] = {}       # name → line of the move
        self.linear: Set[str] = set(linear)
        self.vals: Set[str] = set(vals)

    def clone(self) -> "_Env":
        e = _Env(self.tainted, self.linear, self.vals)
        e.moved = dict(self.moved)
        return e

    def merge_branches(self, a: "_Env", b: "_Env") -> None:
        """Join two exclusive branches: taint unions (either branch may
        have produced the value), moves INTERSECT (only a move on every
        path is a definite move — no false positives on `if c: send(p)
        else: send(p)`)."""
        self.tainted = a.tainted | b.tainted
        self.linear = a.linear | b.linear
        self.vals = a.vals | b.vals
        self.moved = {k: v for k, v in a.moved.items() if k in b.moved}

    def absorb(self, a: "_Env") -> None:
        """Join a maybe-executed block (loop body, try handler) back:
        taint unions, moves only if already moved here too."""
        self.tainted |= a.tainted
        self.linear |= a.linear
        self.vals |= a.vals


class _Analyzer:
    def __init__(self, tb: TypeBody, bb: BehaviourBody,
                 resolver: Optional[Resolver],
                 mutable_globals: Set[str]):
        self.tb = tb
        self.bb = bb
        self.resolver = resolver
        self.mutable_globals = set(mutable_globals)
        self.findings: List[Finding] = []
        params = bb.node.args.args
        self.self_name = params[0].arg
        self.st_name = params[1].arg
        self.loops: List[Tuple[str, bool]] = []   # (kind, static)
        self.nested = 0
        self.mutations: List[int] = []            # st[k]= lines
        self.drop_returns: List[int] = []         # returns not carrying st
        self.bare_returns: List[ast.Return] = []
        self.locals: Set[str] = {p.arg for p in params}
        self.local_imports: Dict[str, str] = {}   # alias → module root

    # -- reporting --
    def flag(self, rule: str, severity: str, node, message: str) -> None:
        self.findings.append(Finding(
            rule, severity, self.tb.name, self.bb.name, message,
            file=self.bb.file, line=getattr(node, "lineno", None),
            col=(getattr(node, "col_offset", None) or 0) + 1))

    # -- entry --
    def run(self) -> List[Finding]:
        env = _Env(tainted={self.st_name, *self.bb.arg_caps},
                   linear={a for a, cap in self.bb.arg_caps.items()
                           if cap == "iso"},
                   vals={a for a, cap in self.bb.arg_caps.items()
                         if cap == "val"})
        self.walk(self.bb.node.body, env)
        # R7: every path must return the state dict.
        if not _always_terminates(self.bb.node.body):
            self.flag("R7", "error", self.bb.node,
                      "behaviour can fall off the end without returning "
                      "the state dict — every path must `return st` (or "
                      "the updated dict)")
        for r in self.bare_returns:
            self.flag("R7", "error", r,
                      "behaviour returns no state dict on this path — "
                      "`return st` (the engine needs the full state "
                      "back every dispatch)")
        # R8: in-place mutations dropped by a rebuilt return dict.
        for mline in self.mutations:
            for rline in self.drop_returns:
                self.flag("R8", "warning", _Loc(mline),
                          f"in-place st mutation here is dropped by the "
                          f"return at line {rline}, which rebuilds the "
                          "state dict without **st — fold the update "
                          "into the returned dict")
        return self.findings

    # -- statements --
    def walk(self, stmts: Sequence[ast.stmt], env: _Env) -> None:
        for s in stmts:
            self.stmt(s, env)

    def stmt(self, s: ast.stmt, env: _Env) -> None:  # noqa: C901
        if isinstance(s, ast.Expr):
            self.expr(s.value, env)
        elif isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self.assign(s, env)
        elif isinstance(s, ast.Return):
            if self.nested == 0:
                if s.value is None or (isinstance(s.value, ast.Constant)
                                       and s.value.value is None):
                    self.bare_returns.append(s)
                else:
                    self.check_return(s, env)
            if s.value is not None:
                self.expr(s.value, env)
        elif isinstance(s, ast.If):
            if self.expr(s.test, env) and not self.tb.host:
                self.flag("R6", "error", s,
                          "Python `if` on a traced value — the trace "
                          "cannot branch (bool() of a traced tensor); "
                          "mask effects with when= or select with "
                          "torch.where")
            a, b = env.clone(), env.clone()
            self.walk(s.body, a)
            self.walk(s.orelse, b)
            env.merge_branches(a, b)
        elif isinstance(s, ast.While):
            if self.expr(s.test, env) and not self.tb.host:
                self.flag("R6", "error", s,
                          "`while` on a traced value — the trace cannot "
                          "branch; use a static loop bound (or rethink: "
                          "behaviours re-dispatch via self.send)")
            self.loops.append(("while", False))
            body_env = env.clone()
            self.walk(s.body, body_env)
            env.absorb(body_env)
            self.loops.pop()
            self.walk(s.orelse, env)
        elif isinstance(s, ast.For):
            it_tainted = self.expr(s.iter, env)
            if it_tainted and not self.tb.host:
                self.flag("R6", "error", s,
                          "`for` over a traced value — iteration/"
                          "range() on a traced tensor fails at trace; "
                          "use a static range")
            self._bind_target(s.target, it_tainted, env)
            self.loops.append(("for", not it_tainted))
            body_env = env.clone()
            self.walk(s.body, body_env)
            env.absorb(body_env)
            self.loops.pop()
            self.walk(s.orelse, env)
        elif isinstance(s, ast.Assert):
            if self.expr(s.test, env) and not self.tb.host:
                self.flag("R6", "error", s,
                          "assert on a traced value — the trace cannot "
                          "branch; use a when=-masked self.error_int "
                          "(errors are values here)")
            if s.msg is not None:
                self.expr(s.msg, env)
        elif isinstance(s, (ast.Global, ast.Nonlocal)):
            if not self.tb.host:
                kind = ("global" if isinstance(s, ast.Global)
                        else "nonlocal")
                self.flag("R9", "warning", s,
                          f"`{kind} {', '.join(s.names)}` in a traced "
                          "behaviour body — the rebind happens ONCE at "
                          "trace, not per dispatch; keep per-actor "
                          "state in st")
            self.locals.update(s.names)
        elif isinstance(s, ast.Try):
            body_env = env.clone()
            self.walk(s.body, body_env)
            env.absorb(body_env)
            for h in s.handlers:
                h_env = env.clone()
                self.walk(h.body, h_env)
                env.absorb(h_env)
            self.walk(s.orelse, env)
            self.walk(s.finalbody, env)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self.expr(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind_target(item.optional_vars, False, env)
            self.walk(s.body, env)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested defs are usually loop or helper bodies: their
            # params are traced; effects inside them trace ONCE.
            self.locals.add(s.name)
            inner = env.clone()
            inner.tainted |= {p.arg for p in s.args.args}
            self.nested += 1
            self.walk(s.body, inner)
            self.nested -= 1
        elif isinstance(s, ast.Delete):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    env.tainted.discard(t.id)
                    env.moved.pop(t.id, None)
                    env.linear.discard(t.id)
        elif isinstance(s, (ast.Import, ast.ImportFrom)):
            for alias in s.names:
                bound = (alias.asname or alias.name).split(".")[0]
                self.locals.add(bound)
                if isinstance(s, ast.Import):
                    self.local_imports[bound] = alias.name.split(".")[0]
        elif isinstance(s, (ast.Pass, ast.Break, ast.Continue)):
            pass
        elif isinstance(s, ast.Raise):
            if s.exc is not None:
                self.expr(s.exc, env)
        else:                            # match etc: visit expressions
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self.expr(child, env)

    def _bind_target(self, target, tainted: bool, env: _Env) -> None:
        """(Re)bind assignment/loop targets: clears old provenance."""
        if isinstance(target, ast.Name):
            self.locals.add(target.id)
            env.moved.pop(target.id, None)
            env.linear.discard(target.id)
            env.vals.discard(target.id)
            (env.tainted.add if tainted
             else env.tainted.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind_target(el, tainted, env)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, tainted, env)

    def assign(self, s, env: _Env) -> None:
        value = s.value
        vt = self.expr(value, env) if value is not None else False
        targets = s.targets if isinstance(s, ast.Assign) else [s.target]
        for t in targets:
            if isinstance(t, ast.Name):
                if isinstance(s, ast.AugAssign):
                    if t.id in env.moved:
                        self._use_after_move(t, env)
                    if vt:
                        env.tainted.add(t.id)
                    self.locals.add(t.id)
                    continue
                self._bind_target(t, vt, env)
                if self._is_linear_rhs(value, env):
                    env.linear.add(t.id)
                if self._is_val_rhs(value, env):
                    env.vals.add(t.id)
            elif isinstance(t, ast.Subscript):
                base = t.value
                if isinstance(base, ast.Name) and base.id == self.st_name:
                    self.check_st_key(t, write=True)
                    self.mutations.append(t.lineno)
                elif (isinstance(base, ast.Name)
                      and base.id in self.mutable_globals
                      and base.id not in self.locals
                      and not self.tb.host):
                    self.flag("R9", "warning", t,
                              f"write into captured mutable global "
                              f"{base.id!r} — runs ONCE at trace, not "
                              "per dispatch; keep per-actor state in st")
                else:
                    self.expr(base, env)
                    self.expr(t.slice, env)
            elif isinstance(t, ast.Attribute):
                if (isinstance(t.value, ast.Name)
                        and t.value.id == self.self_name):
                    self.flag("R8", "error", t,
                              f"assignment to self.{t.attr} — `self` is "
                              "the per-dispatch Context, not the actor; "
                              "actor state lives in the st dict "
                              "(declare a field annotation)")
                else:
                    self.expr(t.value, env)
            else:
                self._bind_target(t, vt, env)

    def _is_linear_rhs(self, value, env: _Env) -> bool:
        if isinstance(value, ast.Call):
            chain = _attr_chain(value.func)
            return (len(chain) == 2 and chain[0] == self.self_name
                    and chain[1] == "blob_alloc")
        return isinstance(value, ast.Name) and value.id in env.linear

    def _is_val_rhs(self, value, env: _Env) -> bool:
        if isinstance(value, ast.Call):
            chain = _attr_chain(value.func)
            return (len(chain) == 2 and chain[0] == self.self_name
                    and chain[1] == "blob_freeze")
        return isinstance(value, ast.Name) and value.id in env.vals

    # -- expressions (returns: is the value traced?) --
    def expr(self, node, env: _Env) -> bool:  # noqa: C901
        if node is None:
            return False
        if isinstance(node, ast.Name):
            if node.id in env.moved and isinstance(node.ctx, ast.Load):
                self._use_after_move(node, env)
            return node.id in env.tainted
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if (isinstance(node.value, ast.Name)
                    and node.value.id == self.self_name):
                return node.attr == "actor_id"
            base_t = self.expr(node.value, env)
            return base_t and node.attr not in _STATIC_ATTRS
        if isinstance(node, ast.Subscript):
            self.check_st_key(node, write=False)
            return self.expr(node.value, env) | self.expr(node.slice, env)
        if isinstance(node, ast.Call):
            return self.call(node, env)
        if isinstance(node, ast.BoolOp):
            ts = [self.expr(v, env) for v in node.values]
            if any(ts) and not self.tb.host:
                op = "and" if isinstance(node.op, ast.And) else "or"
                self.flag("R6", "error", node,
                          f"`{op}` on a traced value calls bool() at "
                          "trace — combine masks with & / | instead")
            return any(ts)
        if isinstance(node, ast.UnaryOp):
            t = self.expr(node.operand, env)
            if t and isinstance(node.op, ast.Not) and not self.tb.host:
                self.flag("R6", "error", node,
                          "`not` on a traced value calls bool() at "
                          "trace — use ~ on the mask")
            return t
        if isinstance(node, ast.Compare):
            ts = [self.expr(node.left, env)]
            ts += [self.expr(c, env) for c in node.comparators]
            if len(node.ops) > 1 and any(ts) and not self.tb.host:
                self.flag("R6", "error", node,
                          "chained comparison on traced values expands "
                          "to `and` (bool() at trace) — split into two "
                          "compares joined with &")
            return any(ts)
        if isinstance(node, ast.IfExp):
            tt = self.expr(node.test, env)
            if tt and not self.tb.host:
                self.flag("R6", "error", node,
                          "ternary on a traced condition — the trace "
                          "cannot branch; use torch.where(cond, a, b)")
            bt = self.expr(node.body, env)
            ot = self.expr(node.orelse, env)
            return tt or bt or ot
        if isinstance(node, ast.BinOp):
            return self.expr(node.left, env) | self.expr(node.right, env)
        if isinstance(node, ast.Dict):
            self.check_state_dict(node, env)
            t = False
            for k, v in zip(node.keys, node.values):
                t |= self.expr(k, env) if k is not None else False
                t |= self.expr(v, env)
            return t
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any([self.expr(el, env) for el in node.elts])
        if isinstance(node, ast.Starred):
            return self.expr(node.value, env)
        if isinstance(node, ast.JoinedStr):
            return any([self.expr(v, env) for v in node.values])
        if isinstance(node, ast.FormattedValue):
            return self.expr(node.value, env)
        if isinstance(node, ast.NamedExpr):
            t = self.expr(node.value, env)
            self._bind_target(node.target, t, env)
            return t
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            t = False
            inner = env.clone()
            for gen in node.generators:
                gt = self.expr(gen.iter, inner)
                if gt and not self.tb.host:
                    self.flag("R6", "error", gen.iter,
                              "comprehension over a traced value — "
                              "iteration on a tracer fails at trace")
                self._bind_target(gen.target, gt, inner)
                for cond in gen.ifs:
                    self.expr(cond, inner)
                t |= gt
            if isinstance(node, ast.DictComp):
                t |= self.expr(node.key, inner)
                t |= self.expr(node.value, inner)
            else:
                t |= self.expr(node.elt, inner)
            return t
        if isinstance(node, ast.Lambda):
            inner = env.clone()
            inner.tainted |= {p.arg for p in node.args.args}
            self.nested += 1
            self.expr(node.body, inner)
            self.nested -= 1
            return False
        # Anything else: conservative union over child expressions.
        return any([self.expr(c, env) for c in ast.iter_child_nodes(node)
                    if isinstance(c, ast.expr)])

    # -- calls --
    def call(self, node: ast.Call, env: _Env) -> bool:  # noqa: C901
        func = node.func
        func_t = self.expr(func, env)
        arg_ts = [self.expr(a, env) for a in node.args]
        kw_ts = [self.expr(kw.value, env) for kw in node.keywords]
        tainted = func_t or any(arg_ts) or any(kw_ts)
        chain = _attr_chain(func)
        # st.get("key") reads obey key discipline too.
        if (len(chain) == 2 and chain[0] == self.st_name
                and chain[1] == "get" and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            self._key_check(node.args[0].value, node, write=False)
        if (len(chain) == 2 and chain[0] == self.self_name):
            return self._ctx_call(node, chain[1], env, tainted)
        if not self.tb.host:
            self._impurity(node, func, chain, env)
        return tainted

    def _ctx_call(self, node: ast.Call, method: str, env: _Env,
                  tainted: bool) -> bool:
        if method in _EFFECTS:
            self._effect_site(node, method)
        if method == "send" and len(node.args) >= 2:
            self._apply_moves(node, node.args[1], node.args[2:], env)
        elif method in ("spawn", "spawn_sync") and node.args:
            self._apply_moves(node, node.args[0], node.args[1:], env)
        elif method == "blob_free" and node.args:
            a = node.args[0]
            if isinstance(a, ast.Name):
                if a.id in env.vals:
                    self.flag("R9", "error", node,
                              f"blob_free({a.id}) on a frozen (val) "
                              "blob — shared payloads have no owner to "
                              "free them; the GC mark pass reclaims "
                              "them")
                env.moved[a.id] = node.lineno
                env.linear.discard(a.id)
        elif method == "blob_set" and node.args:
            a = node.args[0]
            if isinstance(a, ast.Name) and a.id in env.vals:
                self.flag("R9", "error", node,
                          f"blob_set({a.id}, …) writes to a frozen "
                          "(val) blob — shared-immutable payloads "
                          "cannot be written (≙ val's deny-write)")
        elif method == "blob_freeze" and node.args:
            a = node.args[0]
            if isinstance(a, ast.Name):
                env.linear.discard(a.id)
                env.vals.add(a.id)
        return method in _TRACED_CALLS or (
            method in ("blob_get", "blob_length")) or (
            tainted and method not in _EFFECTS)

    def _effect_site(self, node: ast.Call, method: str) -> None:
        if self.tb.host:
            return
        if self.nested:
            self.flag("R7", "warning", node,
                      f"self.{method} inside a nested function — if "
                      "it runs a data-dependent number of times, "
                      "the trace sees one count; effect counts must be "
                      "trace-time static")
            return
        for kind, static in self.loops:
            if static:
                continue
            if kind == "while":
                self.flag("R7", "warning", node,
                          f"self.{method} under a `while` loop — the "
                          "per-dispatch effect count must be a "
                          "trace-time constant (the engine pads to "
                          "the declared budget); unroll a static "
                          "range or mask with when=")
            else:
                self.flag("R7", "error", node,
                          f"self.{method} under a loop whose trip "
                          "count depends on a traced value — the send/"
                          "spawn count cannot be static; emit a fixed "
                          "number of when=-masked effects instead")
            return

    def _apply_moves(self, node: ast.Call, bexpr, payload,
                     env: _Env) -> None:
        """Sending a payload MOVES it when it rides an iso parameter
        (or the value is a linear handle and the target is unknown) —
        ≙ Context._send_checks' move rule, run statically."""
        caps = self._resolve_caps(bexpr)
        for i, a in enumerate(payload):
            if not isinstance(a, ast.Name):
                continue
            is_linear = a.id in env.linear
            if caps is not None and i < len(caps):
                want = caps[i]
                moves = want == "iso" or (want is not None and is_linear)
            else:
                moves = is_linear
            if moves and a.id not in env.moved:
                env.moved[a.id] = node.lineno
                env.linear.discard(a.id)

    def _resolve_caps(self, bexpr) -> Optional[Tuple[Optional[str], ...]]:
        """`Type.behaviour` AST → the target's parameter cap modes."""
        chain = _attr_chain(bexpr)
        if len(chain) < 2 or self.resolver is None:
            return None
        return self.resolver(chain[-2], chain[-1])

    def _use_after_move(self, node: ast.Name, env: _Env) -> None:
        self.flag("R9", "error", node,
                  f"use-after-move: {node.id!r} was moved at line "
                  f"{env.moved[node.id]} (an Iso/Blob payload send or "
                  "blob_free is a move) and may not be used again this "
                  "dispatch")
        env.moved.pop(node.id, None)     # one finding per move

    # -- R9 impurity --
    def _impurity(self, node: ast.Call, func, chain, env: _Env) -> None:
        if isinstance(func, ast.Name):
            if (func.id in _IMPURE_BUILTINS
                    and func.id not in self.locals):
                self.flag("R9", "warning", node,
                          f"{func.id}() in a traced behaviour body "
                          "runs ONCE, at trace time — behaviours are "
                          "pure traced functions; use a HOST actor "
                          "for I/O")
            return
        if not chain:
            return
        root = self.local_imports.get(chain[0], chain[0])
        if chain[0] in self.locals and chain[0] not in self.local_imports:
            return
        if root in _IMPURE_MODULES:
            self.flag("R9", "warning", node,
                      f"{'.'.join(chain)}() is host-impure in a traced "
                      "body — it runs once at trace, not per dispatch "
                      "(wall clocks and host RNG have no device "
                      "meaning; seed traced RNG through state)")
        elif (root in ("np", "numpy", "jax", "torch") and len(chain) > 2
                and chain[1] == "random"):
            self.flag("R9", "warning", node,
                      f"{'.'.join(chain)}() draws host randomness at "
                      "trace time — every dispatch replays the SAME "
                      "draw; thread a traced RNG through state "
                      "instead")
        elif (root in self.mutable_globals
                and chain[-1] in _MUTATORS):
            self.flag("R9", "warning", node,
                      f"mutating captured global {root!r} inside a "
                      "traced body — the mutation happens once at "
                      "trace, not per dispatch; keep per-actor state "
                      "in st")

    # -- R8 state keys --
    def check_st_key(self, sub: ast.Subscript, write: bool) -> None:
        if not (isinstance(sub.value, ast.Name)
                and sub.value.id == self.st_name):
            return
        sl = sub.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            self._key_check(sl.value, sub, write=write)

    def _key_check(self, key: str, node, write: bool) -> None:
        fields = self.tb.fields
        if fields is None:
            return
        if key not in fields:
            hint = difflib.get_close_matches(key, fields, n=1)
            did = f" — did you mean {hint[0]!r}?" if hint else ""
            self.flag("R8", "error", node,
                      f"state dict has no declared field {key!r}{did} "
                      f"(declared: {', '.join(sorted(fields)) or 'none'})")
        elif write and key in self.tb.immutable:
            self.flag("R8", "warning", node,
                      f"write to {key!r}, declared "
                      f"{fields[key]} (shared-immutable) — val fields "
                      "freeze their payload; rebinding the field "
                      "defeats the declared immutability")

    def check_state_dict(self, node: ast.Dict, env: _Env) -> None:
        """`{**st, "key": v}` splats obey key discipline."""
        if not any(k is None and isinstance(v, ast.Name)
                   and v.id == self.st_name
                   for k, v in zip(node.keys, node.values)):
            return
        for k in node.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                self._key_check(k.value, k, write=True)

    def check_return(self, s: ast.Return, env: _Env) -> None:
        v = s.value
        if isinstance(v, ast.Name) and v.id == self.st_name:
            return                       # carries st (and mutations)
        if not isinstance(v, ast.Dict):
            return                       # unknown carrier: no claim
        splats = [val for k, val in zip(v.keys, v.values) if k is None]
        has_st = any(isinstance(sp, ast.Name) and sp.id == self.st_name
                     for sp in splats)
        if has_st:
            return                       # {**st, ...}: checked as Dict
        if splats:
            return                       # {**other}: can't see through
        keys = {k.value for k in v.keys
                if isinstance(k, ast.Constant)
                and isinstance(k.value, str)}
        for k in v.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                self._key_check(k.value, k, write=True)
        if self.tb.fields is not None:
            missing = sorted(set(self.tb.fields) - keys)
            if missing:
                self.flag("R8", "error", v,
                          "returned state dict drops declared "
                          f"field(s) {', '.join(missing)} — the engine "
                          "packs the FULL state every dispatch; add "
                          "them or splat **st")
        if self.mutations:
            self.drop_returns.append(s.lineno)


class _Loc:
    """A minimal lineno carrier for findings at a remembered line."""

    def __init__(self, lineno: int):
        self.lineno = lineno
        self.col_offset = 0


def _always_terminates(stmts: Sequence[ast.stmt]) -> bool:
    """Does every path through these statements return/raise?
    (≙ the reference's method-body completeness check in verify/fun.c
    — here 'complete' means the state dict comes back.)"""
    for s in stmts:
        if isinstance(s, (ast.Return, ast.Raise)):
            return True
        if isinstance(s, ast.If):
            if (s.orelse and _always_terminates(s.body)
                    and _always_terminates(s.orelse)):
                return True
        elif isinstance(s, ast.Try):
            if _always_terminates(s.finalbody):
                return True
            blocks = [list(s.body) + list(s.orelse)]
            blocks += [h.body for h in s.handlers]
            if all(_always_terminates(b) for b in blocks):
                return True
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            if _always_terminates(s.body):
                return True
        elif isinstance(s, ast.While):
            # `while True` with no break never falls through.
            if (isinstance(s.test, ast.Constant) and s.test.value
                    and not any(isinstance(n, ast.Break)
                                for n in ast.walk(s))):
                return True
    return False


# ---------------------------------------------------------------------------
# Entry points


def check_type_bodies(types: Sequence[TypeBody],
                      mutable_globals: Set[str] = frozenset(),
                      resolver: Optional[Resolver] = None
                      ) -> List[Finding]:
    """Run R6–R9 over already-extracted TypeBody views."""
    if resolver is None:
        world = {tb.name: tb for tb in types}

        def resolver(tname, bname):      # noqa: F811
            tb = world.get(tname)
            if tb is None:
                return None
            for bb in tb.behaviours:
                if bb.name == bname:
                    return tuple(bb.arg_caps.values())
            return None
    findings: List[Finding] = []
    for tb in types:
        for bb in tb.behaviours:
            findings += _Analyzer(tb, bb, resolver,
                                  set(mutable_globals)).run()
    return findings


def _apply_declared_suppressions(findings: Sequence[Finding],
                                 types: Sequence[TypeBody],
                                 src_lines: Dict[str, List[str]]
                                 ) -> List[Finding]:
    """Drop findings suppressed by LINT_IGNORE (type- or behaviour-
    level) or a trailing ``# lint: ignore[...]`` comment."""
    by_type = {tb.name: tb for tb in types}
    out = []
    for f in findings:
        tb = by_type.get(f.type_name)
        if tb is not None:
            if f.rule in tb.ignore:
                continue
            bb = next((b for b in tb.behaviours
                       if b.name == f.behaviour), None)
            if bb is not None and f.rule in bb.ignore:
                continue
        lines = src_lines.get(f.file or "")
        if (lines and f.line and f.line <= len(lines)
                and line_suppressed(f, lines[f.line - 1])):
            continue
        out.append(f)
    return out


def check_source(src: str, filename: str = "<string>",
                 include_suppressed: bool = False) -> List[Finding]:
    """Lint one module's SOURCE — no import, no JAX. Unparseable
    source yields a single R0 finding at the syntax error."""
    try:
        types, mutable_globals = parse_module(src, filename)
    except SyntaxError as e:
        return [Finding("R0", "error", os.path.basename(filename),
                        None, f"file does not parse: {e.msg}",
                        file=filename, line=e.lineno,
                        col=(e.offset or 0))]
    findings = check_type_bodies(types, mutable_globals)
    if not include_suppressed:
        findings = _apply_declared_suppressions(
            findings, types, {filename: src.splitlines()})
    return sort_findings(findings)


def iter_python_files(path: str) -> List[str]:
    """`path` itself if a file, else every *.py under it (sorted,
    skipping hidden and __pycache__ directories)."""
    if os.path.isfile(path):
        return [path]
    out = []
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs
                         if not d.startswith((".", "__pycache__")))
        for f in sorted(files):
            if f.endswith(".py") and not f.startswith("."):
                out.append(os.path.join(root, f))
    return out


def check_paths(paths: Sequence[str], include_suppressed: bool = False
                ) -> Tuple[List[Finding], int, int]:
    """Lint files/directories (pure AST — the files need not import).
    Returns (findings, n actor types seen, n behaviours seen)."""
    findings: List[Finding] = []
    n_types = n_beh = 0
    for path in paths:
        for file in iter_python_files(path):
            with open(file, "r", encoding="utf-8") as fh:
                src = fh.read()
            try:
                types, _ = parse_module(src, file)
                n_types += len(types)
                n_beh += sum(len(t.behaviours) for t in types)
            except SyntaxError:
                pass
            findings += check_source(
                src, file, include_suppressed=include_suppressed)
    return sort_findings(findings), n_types, n_beh


def check_path(path: str) -> List[Finding]:
    return check_paths([path])[0]


# -- live actor types (the lint_types/lint_module/lint_program hook) --


def _cap_of_spec(spec) -> Optional[str]:
    from ..ops import pack               # lazy: path mode stays AST-only
    return pack.cap_mode(spec)


def _type_body_of(atype) -> Optional[TypeBody]:
    """Build a TypeBody for a live actor type via inspect.getsource.
    None when no behaviour source is recoverable (exec'd classes)."""
    import inspect
    fields = {}
    immutable = set()
    for fname, spec in atype.field_specs.items():
        fields[fname] = getattr(spec, "__name__", "?")
        if _cap_of_spec(spec) in ("val", "box"):
            immutable.add(fname)
    behaviours = []
    for bdef in atype.behaviour_defs:
        try:
            lines, start = inspect.getsourcelines(bdef.fn)
            fnode = ast.parse(
                textwrap.dedent("".join(lines))).body[0]
        except (OSError, TypeError, SyntaxError, IndexError):
            continue
        if not isinstance(fnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        ast.increment_lineno(fnode, start - 1)
        if len(fnode.args.args) < 2:
            continue
        arg_caps = {n: _cap_of_spec(s)
                    for n, s in zip(bdef.arg_names, bdef.arg_specs)}
        behaviours.append(BehaviourBody(
            name=bdef.name, node=fnode,
            file=getattr(bdef, "source_file", None),
            arg_caps=arg_caps,
            ignore=tuple(getattr(bdef, "lint_ignore", ()) or ())))
    if not behaviours:
        return None
    return TypeBody(
        name=atype.__name__, host=bool(getattr(atype, "HOST", False)),
        file=getattr(behaviours[0], "file", None), fields=fields,
        immutable=immutable,
        ignore=tuple(str(r) for r in
                     getattr(atype, "LINT_IGNORE", ()) or ()),
        behaviours=behaviours)


def check_types(*atypes, include_suppressed: bool = False
                ) -> List[Finding]:
    """R6–R9 over live actor types (classes, not files): same rules,
    source recovered via inspect; send-move resolution sees the passed
    world plus each behaviour's module globals."""
    from ..api import ActorTypeMeta
    tbs: List[TypeBody] = []
    by_name: Dict[str, object] = {}
    fn_globals: List[dict] = []
    seen_globals: Set[int] = set()
    for at in atypes:
        by_name[at.__name__] = at
        tb = _type_body_of(at)
        if tb is not None:
            tbs.append(tb)
        for bdef in at.behaviour_defs:
            g = getattr(bdef.fn, "__globals__", None)
            if g is not None and id(g) not in seen_globals:
                seen_globals.add(id(g))
                fn_globals.append(g)

    def resolver(tname, bname):
        at = by_name.get(tname)
        if at is None:
            for g in fn_globals:
                cand = g.get(tname)
                if isinstance(cand, ActorTypeMeta):
                    at = cand
                    break
        if not isinstance(at, ActorTypeMeta):
            return None
        for bdef in at.behaviour_defs:
            if bdef.name == bname:
                return tuple(_cap_of_spec(s) for s in bdef.arg_specs)
        return None

    mutable_globals: Set[str] = set()
    for g in fn_globals:
        for name, val in g.items():
            if isinstance(val, (list, dict, set, bytearray)):
                mutable_globals.add(name)
    findings = check_type_bodies(tbs, mutable_globals, resolver)
    if not include_suppressed:
        src_lines: Dict[str, List[str]] = {}
        for tb in tbs:
            for bb in tb.behaviours:
                if bb.file and bb.file not in src_lines:
                    try:
                        with open(bb.file, "r", encoding="utf-8") as fh:
                            src_lines[bb.file] = fh.read().splitlines()
                    except OSError:
                        pass
        findings = _apply_declared_suppressions(findings, tbs, src_lines)
    return sort_findings(findings)

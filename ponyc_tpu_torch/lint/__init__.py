"""Whole-program static-analysis (lint) pass of the PyTorch port (a
copy of ``ponyc_tpu/lint/__init__.py``: the rules, their ids,
severities and file:line attribution are the JAX package's; the
probe traces bodies over meta-device tensors, verify.py).

≙ the reference compiler's whole-program stages: reach/paint prune and
analyse the complete call graph before codegen (src/libponyc/reach/),
and the capability type system proves data-race freedom at compile
time (type/cap.c, safeto.c, alias.c). This port's per-behaviour verify
pass (verify.py) sees one behaviour at a time; the lint pass assembles
every behaviour's probe facts into a program-wide MESSAGE-FLOW GRAPH
(nodes = (type, behaviour); edges = send/spawn sites with when-mask
constness) and runs rule passes over it — reachability, dead-letter,
capability/race, amplification/overflow, and budget feasibility
(rules.py documents R0–R5).

Everything runs on meta-device probe traces only — no kernel runs;
linting a full program costs milliseconds. Exactly the ahead-of-time
structural checking actor-on-accelerator systems lean on because
device-side introspection is expensive (CAF's OpenCL actors, PGAS
actors — PAPERS.md): a bad send should fail HERE, not surface as a
silent dead-letter counter deep inside a window.

Three surfaces:

  python -m ponyc_tpu_torch lint mymodule [--json] [--roots A.go,B.tick]
      CLI over a module's actor types (exit 0 = clean).

  from ponyc_tpu_torch.lint import lint_program, lint_types, lint_module
      findings = lint_program(runtime.program)
      findings = lint_types(A, B, roots=[A.go])

  verify.verify_program(program) runs lint_program and raises
      VerifyError on error-severity findings; docgen.document(program)
      marks unreachable/dead-letter behaviours.

Roots (host inject sites): without any declared roots, lint assumes
the host may inject messages into ANY behaviour — R1 reachability and
the rooted R2 sub-rule stay quiet. Declare roots to tighten:
``LINT_ROOTS = ("go",)`` on an actor type (its own behaviours),
``LINT_ROOTS = (A.go, "B.tick")`` at module level, or ``roots=`` /
``--roots``. Net/timer callback behaviours are inject sites too —
list them.

Suppressions, finest first: a trailing ``# lint: ignore[R6]`` (or
bare ``# lint: ignore``) comment on the finding's source line;
``@behaviour(lint_ignore=("R6", ...))`` on one behaviour;
``LINT_IGNORE = ("R4", ...)`` on the actor type. All three are
honoured by the graph rules (R0–R5) and the body rules (R6–R9) alike.

The body rules (bodycheck.py) also run standalone over FILES — pure
AST, no torch, no import of the target: ``check_source``/``check_path``
/ ``python -m ponyc_tpu_torch lint some_dir/`` lint files that do not even
import.
"""

from __future__ import annotations

import linecache
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import ActorTypeMeta, BehaviourDef
from . import bodycheck
from .bodycheck import check_path, check_paths, check_source
from .facts import BehaviourFacts, TypeFacts, gather
from .graph import Edge, FlowGraph, Node
from .rules import (SEVERITIES, Finding, line_suppressed, run_rules,
                    sort_findings)

__all__ = [
    "Finding", "FlowGraph", "Edge", "Node", "BehaviourFacts",
    "TypeFacts", "SEVERITIES", "lint_types", "lint_module",
    "lint_program", "format_findings", "findings_to_json",
    "findings_to_github", "gather", "bodycheck", "check_path",
    "check_paths", "check_source",
]


def _resolve_roots(roots, types: Dict[str, TypeFacts]
                   ) -> Optional[List[Node]]:
    """Explicit roots + LINT_ROOTS declarations → node list (None if no
    roots anywhere: un-rooted mode, every behaviour injectable)."""
    nodes: List[Node] = []
    for r in roots or ():
        if isinstance(r, BehaviourDef):
            nodes.append((r.actor_type.__name__, r.name))
        elif isinstance(r, str):
            tname, _, bname = r.partition(".")
            if not bname:
                raise ValueError(
                    f"lint root {r!r}: expected 'Type.behaviour'")
            nodes.append((tname, bname))
        elif isinstance(r, (tuple, list)) and len(r) == 2:
            nodes.append((str(r[0]), str(r[1])))
        else:
            raise TypeError(
                f"lint root {r!r}: pass a behaviour (A.go), a "
                "'Type.behaviour' string, or a (type, behaviour) pair")
    for tf in types.values():
        for bname in tf.roots_declared:
            nodes.append((tf.name, bname))
    if not nodes:
        return None
    known = {(tf.name, bf.behaviour)
             for tf in types.values() for bf in tf.behaviours}
    for n in nodes:
        if n not in known:
            raise ValueError(
                f"lint root {n[0]}.{n[1]} names no behaviour in the "
                "analysed program")
    return nodes


def _suppress(findings: Sequence[Finding],
              types: Dict[str, TypeFacts]
              ) -> Tuple[List[Finding], List[Finding]]:
    """Split into (active, suppressed): the subject type's LINT_IGNORE
    tuple, the behaviour's own lint_ignore, and trailing
    ``# lint: ignore[...]`` comments on the finding's source line."""
    active, muted = [], []
    for f in findings:
        tf = types.get(f.type_name)
        if tf is not None and f.rule in tf.ignore:
            muted.append(f)
            continue
        bf = None
        if tf is not None and f.behaviour is not None:
            bf = next((b for b in tf.behaviours
                       if b.behaviour == f.behaviour), None)
        if bf is not None and f.rule in bf.ignore:
            muted.append(f)
            continue
        if f.file and f.line and line_suppressed(
                f, linecache.getline(f.file, f.line)):
            muted.append(f)
            continue
        active.append(f)
    return active, muted


def lint_types(*atypes: ActorTypeMeta, roots=None, msg_words: int = 8,
               default_max_sends: int = 2,
               include_suppressed: bool = False) -> List[Finding]:
    """Lint a world of concrete actor types: the probe-fact graph
    rules (R0–R5) plus the pure-AST behaviour-body rules (R6–R9,
    bodycheck.py). `roots` (optional): behaviours the host injects
    into — BehaviourDefs, 'Type.behaviour' strings, or (type,
    behaviour) pairs; merged with any LINT_ROOTS class declarations.
    Returns findings sorted most severe first; suppressed findings
    (LINT_IGNORE / lint_ignore / line comments) are dropped unless
    `include_suppressed`."""
    types = gather(atypes, msg_words=msg_words,
                   default_max_sends=default_max_sends)
    g = FlowGraph(types)
    findings = run_rules(g, _resolve_roots(roots, types))
    findings = sort_findings(
        findings + bodycheck.check_types(*atypes,
                                         include_suppressed=True))
    if include_suppressed:
        return findings
    active, _ = _suppress(findings, types)
    return active


def lint_module(mod, roots=None,
                include_suppressed: bool = False) -> List[Finding]:
    """Lint every concrete actor type defined at a module's top level
    (generic templates are skipped — only reifications have layouts).
    Honours a module-level ``LINT_ROOTS`` unless `roots` overrides it.
    Raises ValueError if the module has no concrete actor types."""
    from ..api import Actor
    atypes = []
    for v in vars(mod).values():
        if (isinstance(v, ActorTypeMeta) and v is not Actor
                and not getattr(v, "_type_params", ())
                and v not in atypes):
            atypes.append(v)
    if not atypes:
        raise ValueError(
            f"no concrete actor types at the top level of "
            f"{getattr(mod, '__name__', mod)!r}")
    if roots is None:
        roots = getattr(mod, "LINT_ROOTS", None)
    return lint_types(*atypes, roots=roots,
                      include_suppressed=include_suppressed)


def lint_program(program, roots=None,
                 include_suppressed: bool = False) -> List[Finding]:
    """Lint a built Program's whole world (host cohorts included as
    graph nodes), probing with the program's own msg_words/max_sends
    resolution so facts match what the engine runs."""
    return lint_types(*(c.atype for c in program.cohorts), roots=roots,
                      msg_words=program.opts.msg_words,
                      default_max_sends=program.opts.max_sends,
                      include_suppressed=include_suppressed)


def format_findings(findings: Sequence[Finding]) -> str:
    """Human-readable report, one finding per line."""
    return "\n".join(str(f) for f in findings)


def findings_to_json(findings: Sequence[Finding]) -> str:
    """Machine-diffable report: one JSON object per line with stable
    keys {rule, severity, type, behaviour, message, file, line}
    (file/line null when unknown)."""
    return "\n".join(f.json_line() for f in findings)


def findings_to_github(findings: Sequence[Finding]) -> str:
    """GitHub Actions annotations, one ``::warning file=…,line=…::``
    command per finding (the CLI's ``--format github``)."""
    return "\n".join(f.github_line() for f in findings)

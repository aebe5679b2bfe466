"""Documentation generator — ≙ the reference's docgen pass
(src/libponyc/pass/docgen.c: walks the typechecked AST and emits a
mkdocs tree of packages/types/methods with docstrings).

Here the unit is an actor Program (or any module of actor types): emit
markdown with one section per actor type — scheduling hints, state
fields with dtypes, behaviours with typed signatures and docstrings,
spawn budgets — plus the program-level dispatch table.

    from ponyc_tpu_torch import docgen
    md = docgen.document(program)            # or document_types(A, B)
    docgen.write_tree(program, "docs/")      # one file per type + index
"""

from __future__ import annotations

import inspect
import os
from typing import List

from .api import ActorTypeMeta
from .ops import pack


_SPEC_NAMES = {pack.I32: "I32", pack.F32: "F32", pack.Bool: "Bool",
               pack.Ref: "Ref"}


def _sig(bdef) -> str:
    args = ", ".join(
        f"{n}: {_SPEC_NAMES.get(s, getattr(s, '__name__', '?'))}"
        for n, s in zip(bdef.arg_names, bdef.arg_specs))
    return f"{bdef.name}({args})"


def document_type(atype: ActorTypeMeta, lint_notes=None) -> str:
    """Markdown for one actor type (≙ doc_entity in docgen.c).

    `lint_notes` (optional): {behaviour name or None: [note, ...]} from
    the whole-program lint pass — type-level notes (key None) render
    under the hints line, behaviour notes under each signature (the
    unreachable/dead-letter marks, ≙ docgen flagging pruned entities).
    """
    lint_notes = lint_notes or {}
    lines: List[str] = [f"## actor {atype.__name__}", ""]
    doc = inspect.getdoc(atype)
    if doc:
        lines += [doc, ""]
    hints = []
    if atype.HOST:
        hints.append("HOST (runs host-side)")
    if atype.BATCH:
        hints.append(f"BATCH={atype.BATCH}")
    if atype.PRIORITY:
        hints.append(f"PRIORITY={atype.PRIORITY}")
    if getattr(atype, "SPAWNS", None):
        sp = ", ".join(
            f"{k if isinstance(k, str) else k.__name__}×{v}"
            for k, v in atype.SPAWNS.items())
        hints.append(f"SPAWNS({sp})")
    if hints:
        lines += ["*" + "; ".join(hints) + "*", ""]
    for note in lint_notes.get(None, ()):
        lines += [f"> **lint:** {note}", ""]
    if atype.field_specs:
        lines += ["| field | type |", "|---|---|"]
        for fname, spec in atype.field_specs.items():
            lines.append(f"| {fname} | {_SPEC_NAMES.get(spec, getattr(spec, '__name__', '?'))} |")
        lines.append("")
    for bdef in atype.behaviour_defs:
        lines.append(f"### be {_sig(bdef)}")
        lines.append("")
        # Effect marks (the verify pass, ≙ Pony's `?` partial mark in
        # generated docs): discovered by probe tracing; generic
        # templates and trace failures degrade to no marks.
        try:
            from .verify import behaviour_effects
            marks = behaviour_effects(bdef, atype).marks()
            if marks:
                lines += [f"*effects: {marks}*", ""]
        except Exception:                    # noqa: BLE001 — doc only
            pass
        for note in lint_notes.get(bdef.name, ()):
            lines += [f"> **lint:** {note}", ""]
        bdoc = inspect.getdoc(bdef.fn)
        if bdoc:
            lines += [bdoc, ""]
    return "\n".join(lines)


def document_types(*atypes: ActorTypeMeta, title: str = "Actors") -> str:
    parts = [f"# {title}", ""]
    for t in atypes:
        parts.append(document_type(t))
    return "\n".join(parts)


def _lint_notes_by_type(program, roots=None):
    """{type name: {behaviour or None: [note, ...]}} from the lint
    pass — unreachable (R1) / dead-letter (R2) and the body-rule
    findings (R6–R9, with their file:line) become doc marks. Doc
    generation must never fail on an unlintable program."""
    notes: dict = {}
    try:
        from .lint import lint_program
        for f in lint_program(program, roots=roots):
            where = (f" ({os.path.basename(f.file)}:{f.line})"
                     if f.file and f.line else "")
            notes.setdefault(f.type_name, {}).setdefault(
                f.behaviour, []).append(f"{f.rule} [{f.severity}] "
                                        f"{f.message}{where}")
    except Exception:                        # noqa: BLE001 — doc only
        pass
    return notes


def document(program, title: str = "Program", lint: bool = True,
             lint_roots=None) -> str:
    """Full program docs incl. the dispatch table (≙ docgen emitting the
    whole package tree after reach/paint assigned vtable slots). With
    `lint=True` the whole-program lint findings render as per-type /
    per-behaviour marks (unreachable, dead-letter, …); pass
    `lint_roots` to enable the rooted rules (see ponyc_tpu_torch.lint)."""
    parts = [f"# {title}", "",
             f"{program.total} actor slots over {program.shards} "
             f"shard(s); {len(program.behaviour_table)} behaviours.", ""]
    parts += ["| gid | behaviour | cohort |", "|---|---|---|"]
    for gid, bdef in enumerate(program.behaviour_table):
        parts.append(f"| {gid} | {_sig(bdef)} | "
                     f"{bdef.actor_type.__name__} |")
    parts.append("")
    notes = _lint_notes_by_type(program, lint_roots) if lint else {}
    for cohort in program.cohorts:
        parts.append(document_type(cohort.atype,
                                   notes.get(cohort.atype.__name__)))
    return "\n".join(parts)


def write_tree(program, out_dir: str, title: str = "Program",
               lint: bool = True, lint_roots=None) -> List[str]:
    """One markdown file per type + an index (≙ the mkdocs tree)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    notes = _lint_notes_by_type(program, lint_roots) if lint else {}
    index = [f"# {title}", "", "## Types", ""]
    for cohort in program.cohorts:
        name = cohort.atype.__name__
        path = os.path.join(out_dir, f"{name}.md")
        with open(path, "w") as f:
            f.write(document_type(cohort.atype, notes.get(name)))
        index.append(f"- [{name}]({name}.md)")
        written.append(path)
    idx = os.path.join(out_dir, "index.md")
    with open(idx, "w") as f:
        f.write("\n".join(index) + "\n")
    written.append(idx)
    return written

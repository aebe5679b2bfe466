"""Lint rule passes over the message-flow graph.

Rule ids are STABLE (suppressions and machine diffs key on them):

  R0  analysis failure — a behaviour failed to probe-trace for a
      reason that is not a capability/sendability violation; the lint
      result for it is incomplete.                          [error]
  R1  reachability (≙ libponyc reach/paint): behaviours/types no
      root or host inject site can reach. Only runs when roots are
      declared (LINT_ROOTS / roots=) — without them any behaviour may
      legally be injected from the host.                    [warning]
  R2  dead-letter: sends that provably cannot deliver — target type
      outside the analysed program [error]; a when=False-masked site
      [warning]; in rooted mode, a device type nothing ever spawns
      [warning].
  R3  capability/race lint: the whole-program lift of the trace-time
      iso/val discipline (an iso aliased into two sends, writes to
      val-frozen blobs, sendability breaks), plus device blob handles
      declared on HOST cohorts.                             [error]
  R4  amplification/overflow: an unconditional message cycle whose
      send multiplicity exceeds 1 with no yield pressure point on the
      cycle — a static mailbox-overflow risk (mailbox_cap). [warning]
  R5  budget feasibility: unconditional spawn/blob-alloc sites on a
      message cycle exhaust the SPAWNS / blob pools [warning];
      declared budgets no site ever uses reserve pool slots for
      nothing [info].

Rules R6–R9 are the behaviour-body SOURCE rules (bodycheck.py — pure
AST, no trace, no import of the target): R6 traced-value control flow,
R7 non-static effect sites, R8 state-key discipline, R9 host impurity
and linear-handle misuse. Their findings carry exact file/line/col;
the graph rules here attach the behaviour's def site where derivable.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, FrozenSet, List, Optional, Sequence

from .graph import FlowGraph, Node

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding. Stable, machine-diffable identity: (rule,
    type, behaviour, message); `file`/`line`/`col` locate the finding
    in source where derivable (None = unknown)."""

    rule: str                    # "R0".."R9"
    severity: str                # "error" | "warning" | "info"
    type_name: str               # subject actor type (suppression key)
    behaviour: Optional[str]     # None = type-level finding
    message: str
    file: Optional[str] = None
    line: Optional[int] = None
    col: Optional[int] = None    # 1-based column, body rules only

    def __str__(self) -> str:
        loc = self.type_name + (f".{self.behaviour}" if self.behaviour
                                else "")
        src = (f"{self.file}:{self.line}: " if self.file and self.line
               else "")
        return f"{src}{self.rule} {self.severity:<7} {loc}: {self.message}"

    def to_obj(self) -> Dict[str, Optional[str]]:
        return {"rule": self.rule, "severity": self.severity,
                "type": self.type_name, "behaviour": self.behaviour,
                "message": self.message, "file": self.file,
                "line": self.line}

    def json_line(self) -> str:
        return json.dumps(self.to_obj(), sort_keys=True)

    def github_line(self) -> str:
        """One GitHub Actions workflow annotation
        (``::warning file=…,line=…::message``) — the `--format github`
        CLI output; severities map error/warning/notice."""
        level = {"error": "error", "warning": "warning",
                 "info": "notice"}[self.severity]
        props = [f"title=lint {self.rule}"]
        if self.file:
            props.insert(0, f"file={self.file}")
            if self.line:
                props.insert(1, f"line={self.line}")
            if self.col:
                props.insert(2, f"col={self.col}")
        loc = self.type_name + (f".{self.behaviour}" if self.behaviour
                                else "")
        text = f"{self.rule} {loc}: {self.message}"
        text = (text.replace("%", "%25").replace("\r", "%0D")
                .replace("\n", "%0A"))
        return f"::{level} {','.join(props)}::{text}"


# ``# lint: ignore`` (all rules) / ``# lint: ignore[R6]`` /
# ``# lint: ignore[R6, R8]`` — trailing-comment line suppressions,
# honoured for every rule that can attach a source line.
_IGNORE_RE = re.compile(
    r"#\s*lint:\s*ignore(?:\s*\[([A-Za-z0-9_,\s]+)\])?")


def ignored_rules_on_line(src_line: str) -> Optional[FrozenSet[str]]:
    """Parse a source line's trailing lint-suppression comment:
    None = no suppression; empty frozenset = suppress ALL rules;
    otherwise the rule ids listed in the brackets."""
    m = _IGNORE_RE.search(src_line)
    if m is None:
        return None
    if m.group(1) is None:
        return frozenset()
    return frozenset(r.strip() for r in m.group(1).split(",")
                     if r.strip())


def line_suppressed(f: Finding, src_line: str) -> bool:
    """Does this source line's comment suppress this finding?"""
    rules = ignored_rules_on_line(src_line)
    return rules is not None and (not rules or f.rule in rules)


def sort_findings(findings: Sequence[Finding]) -> List[Finding]:
    """Stable report order: severity first, then rule/location — and
    dedupe (Finding is frozen/hashable)."""
    rank = {s: i for i, s in enumerate(SEVERITIES)}
    return sorted(set(findings),
                  key=lambda f: (rank[f.severity], f.rule, f.type_name,
                                 f.behaviour or "", f.line or 0,
                                 f.message))


def _node_str(n: Node) -> str:
    return f"{n[0]}.{n[1]}"


def rule_probe_failures(graph: FlowGraph) -> List[Finding]:
    """R3 for capability/sendability trace failures, R0 otherwise."""
    out = []
    for bf in graph.nodes.values():
        if bf.error is None:
            continue
        if bf.error_kind in ("capability", "sendability"):
            out.append(Finding(
                "R3", "error", bf.type_name, bf.behaviour,
                f"{bf.error_kind} violation at trace: {bf.error}"))
        else:
            out.append(Finding(
                "R0", "error", bf.type_name, bf.behaviour,
                f"behaviour failed to probe-trace ({bf.error}); lint "
                "analysis for it is incomplete"))
    return out


def rule_r1_reachability(graph: FlowGraph,
                         roots: Optional[List[Node]]) -> List[Finding]:
    """≙ reach.c/paint.c: with declared roots, everything a root cannot
    reach through live edges is dead code."""
    if roots is None:
        return []
    reach = graph.reachable(roots)
    dead_by_type: Dict[str, List[Node]] = {}
    for n in graph.nodes:
        if n not in reach:
            dead_by_type.setdefault(n[0], []).append(n)
    out = []
    for tname, dead in dead_by_type.items():
        total = sum(1 for n in graph.nodes if n[0] == tname)
        if len(dead) == total:
            out.append(Finding(
                "R1", "warning", tname, None,
                f"actor type is unreachable: none of its {total} "
                "behaviour(s) can be reached from any lint root "
                "(≙ a type reach.c would prune)"))
        else:
            for n in sorted(dead):
                out.append(Finding(
                    "R1", "warning", n[0], n[1],
                    "behaviour is unreachable from the lint roots — no "
                    "live send/spawn path leads here (≙ a method "
                    "reach.c would prune)"))
    return out


def rule_r2_dead_letter(graph: FlowGraph,
                        roots: Optional[List[Node]]) -> List[Finding]:
    out = []
    seen = set()
    for e in graph.edges:
        if e.external:
            key = (e.src, e.dst[0])
            if key not in seen:
                seen.add(key)
                out.append(Finding(
                    "R2", "error", e.src[0], e.src[1],
                    f"send targets {_node_str(e.dst)} but {e.dst[0]} is "
                    "not part of the analysed program — the message can "
                    "only dead-letter (declare the type, or lint the "
                    "full module)"))
        elif e.when is False:
            key = (e.src, e.dst, "false")
            if key not in seen:
                seen.add(key)
                out.append(Finding(
                    "R2", "warning", e.src[0], e.src[1],
                    f"{e.kind} to {_node_str(e.dst)} is masked "
                    "when=False — the site is provably dead"))
    if roots is not None:
        # Rooted mode: the host is assumed to inject only into roots
        # and spawn only root/host types; a device type that neither a
        # root owns nor any spawn site creates can never hold a live
        # ref — sends to it dead-letter against empty slots.
        root_types = {r[0] for r in roots}
        spawned = graph.spawn_target_types()
        flagged = set()
        for e in graph.edges:
            t = e.dst[0]
            if (e.kind == "send" and not e.external
                    and e.when is not False and t not in flagged
                    and t not in root_types and t not in spawned
                    and t in graph.types and not graph.types[t].host):
                flagged.add(t)
                senders = sorted({_node_str(x.src) for x in graph.edges
                                  if x.dst[0] == t and x.kind == "send"})
                out.append(Finding(
                    "R2", "warning", t, None,
                    "type receives sends (from "
                    + ", ".join(senders)
                    + ") but no spawn site ever creates it and it owns "
                    "no lint root — every such send can only "
                    "dead-letter"))
    return out


def rule_r3_host_blobs(graph: FlowGraph) -> List[Finding]:
    """Device blob handles on HOST cohorts: blobs are device-resident;
    a host behaviour can neither own nor read one (program build
    rejects the cohort — lint catches it before any Program exists)."""
    out = []
    for tf in graph.types.values():
        if not tf.host:
            continue
        for bname, aname, spec in tf.blob_specs():
            what = (f"parameter {aname!r}" if bname
                    else f"state field {aname!r}")
            out.append(Finding(
                "R3", "error", tf.name, bname,
                f"HOST actor type declares a device blob {what} "
                f"({spec.__name__}) — blob handles cannot cross to "
                "host cohorts (use Runtime.blob_fetch/blob_store "
                "between steps)"))
    return out


def rule_r4_amplification(graph: FlowGraph) -> List[Finding]:
    """Unconditional send cycles with multiplicity product > 1: every
    traversal multiplies the messages in flight, and with no yield
    pressure point on the cycle the mailboxes breach mailbox_cap in
    O(log) steps — a static overflow risk the runtime can only answer
    with spill/mute pressure."""
    out = []
    uncond = lambda e: e.kind == "send" and e.when is True  # noqa: E731
    for comp in graph.sccs(uncond):
        members = set(comp)
        if any(graph.nodes[n].effects.can_yield for n in members):
            continue        # a yield on the cycle is a pressure point
        for n in sorted(members):
            m = len(graph.edges_between(n, members, uncond))
            if m >= 2:
                cyc = " ↔ ".join(sorted({t for t, _ in members}))
                out.append(Finding(
                    "R4", "warning", n[0], n[1],
                    f"amplifying message cycle: each dispatch feeds {m} "
                    f"unconditional messages back into the cycle "
                    f"[{cyc}] with no yield pressure point — mailbox "
                    "overflow (mailbox_cap) is a matter of steps; mask "
                    "the sends (when=), or yield on the cycle"))
    return out


def rule_r5_budgets(graph: FlowGraph) -> List[Finding]:
    out = []
    # (a) unconditional spawn / net blob-alloc sites on an unconditional
    # message cycle: each traversal claims pool slots forever.
    uncond_all = lambda e: e.when is True  # noqa: E731
    cyclic: set = set()
    for comp in graph.sccs(uncond_all):
        cyclic.update(comp)
    for n in sorted(cyclic):
        bf = graph.nodes[n]
        spawn_edges = [e for e in graph.out_edges.get(n, ())
                       if e.kind in ("spawn", "spawn_sync")
                       and e.when is True]
        if spawn_edges:
            targets = sorted({e.dst[0] for e in spawn_edges})
            out.append(Finding(
                "R5", "warning", n[0], n[1],
                f"unconditional spawn of {', '.join(targets)} on an "
                "unconditional message cycle: every traversal claims a "
                "slot, so the target capacity/SPAWNS pool provably "
                "exhausts — gate the spawn with when="))
        net = (sum(1 for w in bf.blob_alloc_whens if w is True)
               - bf.blob_free_sites)
        if net > 0 and bf.blob_freeze_sites == 0:
            out.append(Finding(
                "R5", "warning", n[0], n[1],
                f"behaviour on an unconditional message cycle allocates "
                f"{net} more blob(s) than it frees (and freezes none "
                "for GC) — the blob pool (blob_slots) provably "
                "exhausts"))
    # (b) declared budgets nothing uses: each reserves real pool slots
    # (capacity × dispatches × sites windows, program._resolve_*).
    for tf in graph.types.values():
        claimed = set()
        allocs = 0
        for bf in tf.behaviours:
            for f in bf.sends:
                if f.kind in ("spawn", "spawn_sync"):
                    claimed.add(f.dst_type)
            allocs += len(bf.blob_alloc_whens)
        for target in tf.spawns_declared:
            if target not in claimed and not any(
                    bf.error for bf in tf.behaviours):
                out.append(Finding(
                    "R5", "info", tf.name, None,
                    f"SPAWNS declares {target!r} but no behaviour ever "
                    "spawns it — the reservation window "
                    "(capacity × SPAWN_DISPATCHES × sites) is paid for "
                    "nothing"))
        if tf.max_blobs and not allocs and not tf.host and not any(
                bf.error for bf in tf.behaviours):
            out.append(Finding(
                "R5", "info", tf.name, None,
                f"MAX_BLOBS={tf.max_blobs} is declared but no behaviour "
                "ever blob_allocs — the per-dispatch pool reservation "
                "is paid for nothing"))
    return out


def attach_locations(findings: Sequence[Finding],
                     graph: FlowGraph) -> List[Finding]:
    """Fill in file/line on graph-rule findings from the probe facts
    (behaviour def sites via fn.__code__; class sites for type-level
    findings). Findings that already carry a location keep it."""
    out = []
    for f in findings:
        if f.file is None:
            file = line = None
            bf = graph.nodes.get((f.type_name, f.behaviour))
            if f.behaviour is not None and bf is not None:
                file, line = bf.file, bf.line
            else:
                tf = graph.types.get(f.type_name)
                if tf is not None:
                    file, line = tf.file, tf.line
            if file is not None:
                f = dataclasses.replace(f, file=file, line=line)
        out.append(f)
    return out


def run_rules(graph: FlowGraph,
              roots: Optional[List[Node]]) -> List[Finding]:
    findings: List[Finding] = []
    findings += rule_probe_failures(graph)
    findings += rule_r1_reachability(graph, roots)
    findings += rule_r2_dead_letter(graph, roots)
    findings += rule_r3_host_blobs(graph)
    findings += rule_r4_amplification(graph)
    findings += rule_r5_budgets(graph)
    return sort_findings(attach_locations(findings, graph))

"""The program-wide message-flow graph.

Nodes are (actor type, behaviour) pairs; edges are the send/spawn
sites the probe observed, carrying their kind ("send" — a message to an
existing ref; "spawn"/"spawn_sync" — a constructor delivery to a fresh
slot) and the when-mask constness (True = unconditional, False =
provably dead, None = data-dependent).

≙ the reference's reach pass over the whole program's call graph
(src/libponyc/reach/reach.c walks Main's create transitively and prunes
everything unreached; paint.c then colours only the survivors). The
rules passes (rules.py) run reachability, SCC/cycle, and budget
analyses over this graph.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .facts import BehaviourFacts, TypeFacts

Node = Tuple[str, str]          # (type name, behaviour name)


@dataclasses.dataclass(frozen=True)
class Edge:
    """One send/spawn SITE (not aggregated: two unconditional sends to
    the same target are two edges — multiplicity matters for R4)."""

    src: Node
    dst: Node
    kind: str                   # "send" | "spawn" | "spawn_sync"
    when: Optional[bool]        # constness of the mask at the site
    external: bool              # dst type is outside the analysed world

    @property
    def delivers(self) -> bool:
        """Can this edge ever deliver a message? (when=False sites are
        provably dead; external targets dead-letter.)"""
        return self.when is not False and not self.external


class FlowGraph:
    """Message-flow graph over an analysed world of TypeFacts."""

    def __init__(self, types: Dict[str, TypeFacts]):
        self.types = types
        self.nodes: Dict[Node, BehaviourFacts] = {}
        self.edges: List[Edge] = []
        for tf in types.values():
            for bf in tf.behaviours:
                self.nodes[bf.node] = bf
        for tf in types.values():
            for bf in tf.behaviours:
                for fact in bf.sends:
                    dst = (fact.dst_type, fact.dst_behaviour)
                    self.edges.append(Edge(
                        src=bf.node, dst=dst, kind=fact.kind,
                        when=fact.when,
                        external=fact.dst_type not in types))
        self.out_edges: Dict[Node, List[Edge]] = {n: [] for n in self.nodes}
        for e in self.edges:
            self.out_edges[e.src].append(e)

    # -- reachability (≙ reach.c's transitive walk from Main) --
    def reachable(self, roots: Iterable[Node]) -> Set[Node]:
        seen: Set[Node] = set()
        stack = [r for r in roots if r in self.nodes]
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            for e in self.out_edges.get(n, ()):
                if e.delivers and e.dst in self.nodes and e.dst not in seen:
                    stack.append(e.dst)
        return seen

    # -- strongly connected components (iterative Tarjan) --
    def sccs(self, edge_ok) -> List[List[Node]]:
        """SCCs of the subgraph of edges where edge_ok(e); singleton
        components are included only when they carry a self-loop (so
        every returned component contains a cycle)."""
        adj: Dict[Node, List[Node]] = {n: [] for n in self.nodes}
        selfloop: Set[Node] = set()
        for e in self.edges:
            if not edge_ok(e) or e.external or e.dst not in self.nodes:
                continue
            adj[e.src].append(e.dst)
            if e.src == e.dst:
                selfloop.add(e.src)
        index: Dict[Node, int] = {}
        low: Dict[Node, int] = {}
        on_stack: Set[Node] = set()
        stack: List[Node] = []
        out: List[List[Node]] = []
        counter = [0]

        for start in self.nodes:
            if start in index:
                continue
            work = [(start, iter(adj[start]))]
            index[start] = low[start] = counter[0]
            counter[0] += 1
            stack.append(start)
            on_stack.add(start)
            while work:
                node, it = work[-1]
                advanced = False
                for nxt in it:
                    if nxt not in index:
                        index[nxt] = low[nxt] = counter[0]
                        counter[0] += 1
                        stack.append(nxt)
                        on_stack.add(nxt)
                        work.append((nxt, iter(adj[nxt])))
                        advanced = True
                        break
                    if nxt in on_stack:
                        low[node] = min(low[node], index[nxt])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1 or comp[0] in selfloop:
                        out.append(comp)
        return out

    # -- helpers for the rules --
    def spawn_target_types(self) -> Set[str]:
        """Types some live spawn/spawn_sync site creates (when!=False)."""
        return {e.dst[0] for e in self.edges
                if e.kind in ("spawn", "spawn_sync")
                and e.when is not False}

    def edges_between(self, src: Node, members: Set[Node], edge_ok):
        return [e for e in self.edges
                if e.src == src and e.dst in members and edge_ok(e)
                and not e.external]

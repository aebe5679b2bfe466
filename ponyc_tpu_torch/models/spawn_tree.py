"""Dynamic spawn tree on the PyTorch port — the same program as
``examples/spawn_tree.py`` (≙ the reference's actor-creates-actor pattern,
e.g. examples/circle): each node spawns two children on the device down
to a depth, then the leaves are counted back up through parent refs and
the root exits with the count.

A tree of depth d has 2^d leaves and 2^(d+1) - 1 nodes. Node is declared
at 4 × 2^d rows, the example's and examples/spreader.py's sizing: every
runnable actor reserves SPAWN_DISPATCHES × sites rows a tick, ranked over
the runnable mask, so a declaration of 3 × leaves or less runs out of
reservations at the last level.
"""

from __future__ import annotations

from .. import I32, Ref, Runtime, RuntimeOptions, actor, behaviour


@actor
class Node:
    parent: Ref
    acc: I32
    pending: I32

    SPAWNS = {"Node": 2}
    SPAWN_DISPATCHES = 1      # grow arrives once per node: tight windows
    MAX_SENDS = 3

    @behaviour
    def grow(self, st, depth: I32, parent: Ref):
        leaf = depth <= 0
        self.spawn(Node.grow, depth - 1, self.actor_id, when=~leaf)
        self.spawn(Node.grow, depth - 1, self.actor_id, when=~leaf)
        self.send(parent, Node.leaf_up, 1, when=leaf)
        return {**st, "parent": parent, "pending": 2}

    @behaviour
    def leaf_up(self, st, n: I32):
        acc = st["acc"] + n
        pending = st["pending"] - 1
        done = pending == 0
        root = st["parent"] < 0
        self.send(st["parent"], Node.leaf_up, acc, when=done & ~root)
        self.exit(acc, when=done & root)
        return {**st, "acc": acc * ~done, "pending": pending}


def options(**kw) -> RuntimeOptions:
    """The example's options (examples/spawn_tree.py), `kw` on top."""
    return RuntimeOptions(**{**dict(mailbox_cap=8, batch=4, max_sends=3,
                                    msg_words=2, inject_slots=8,
                                    spill_cap=512), **kw})


def build(depth: int, opts: RuntimeOptions | None = None,
          device=None) -> tuple[Runtime, int]:
    """A started runtime with Node declared at 4 × 2^depth rows, the root
    spawned and its `grow` queued; returns (runtime, root id)."""
    rt = Runtime(opts or options(), device=device)
    rt.declare(Node, 4 << depth).start()
    root = rt.spawn(Node)
    rt.send(root, Node.grow, depth, -1)
    return rt, root


def run(depth: int = 6, opts: RuntimeOptions | None = None, device=None,
        max_steps: int = 10_000) -> Runtime:
    """Grow the tree and count its leaves; `rt.exit_code` is the count
    (2^depth) and `rt.counter("n_spawned")` the nodes spawned on the
    device (2^(depth+1) - 2)."""
    rt, _root = build(depth, opts, device)
    rt.run(max_steps=max_steps)
    return rt

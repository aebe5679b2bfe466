"""The collective layer of a sharded world (the port's counterpart of the
XLA collectives the JAX package's tick calls under ``shard_map``).

The tick is written once, in per-shard coordinates, as a generator: at
each collective it yields a `Request` (`all_to_all`, `all_gather`,
`psum`, `pmax` below) and resumes with the result, as the JAX package's
``local_step`` calls ``lax.all_to_all``/``lax.psum`` at fixed points.
`drive` runs the generators of the shards a process owns in lockstep
and hands each round of requests to a `Comm`:

- `LocalComm`: every shard in this process (one device or several).
  Each collective's result is assembled in shard order, so it never
  depends on the order the shards ran in.
- `DistComm`: one shard a process over ``torch.distributed`` (NCCL for
  CUDA tensors, gloo on the CPU).

A shard whose tick reaches a different collective than its peers would
hang a barrier-based mesh; `drive` raises `MeshDivergence` instead.
Semantics are the JAX package's, with int32 wrap-around in `psum`:

- ``all_to_all(x, dim)``: block s of ``x`` along ``dim`` (``x.shape[dim]
  = shards * bucket``) goes to shard s; the result holds the blocks each
  shard sent here, in shard order (``lax.all_to_all(..., tiled=True)``).
- ``all_gather(x)``: every shard's ``x`` concatenated along dim 0.
- ``psum(x)``, ``pmax(x)``: elementwise int32 sum (wrapping mod 2^32)
  and max over the shards.
"""

from __future__ import annotations

from typing import Any, Generator, List, NamedTuple

import torch

class Request(NamedTuple):
    """One shard's side of a collective."""
    op: str
    x: torch.Tensor
    dim: int = 0


def all_to_all(x: torch.Tensor, dim: int = 0) -> Request:
    return Request("all_to_all", x, dim)


def all_gather(x: torch.Tensor) -> Request:
    return Request("all_gather", x)


def psum(x: torch.Tensor) -> Request:
    return Request("psum", x)


def pmax(x: torch.Tensor) -> Request:
    return Request("pmax", x)


class MeshDivergence(RuntimeError):
    """The shards of one tick reached different collectives (a
    collective skipped on some shards only), or a collective met
    tensors of different shapes or types."""


def solo(gen: Generator) -> Any:
    """Run a one-shard tick (no mesh) to its return value; a collective
    there is a fault of the caller."""
    try:
        req = next(gen)
    except StopIteration as e:
        return e.value
    gen.close()
    raise MeshDivergence(f"collective {req.op} on a single shard")


class Comm:
    """What a collective round needs: the mesh's size and the shard
    ranks this process drives (`ranks`), and `run(op, xs, dim)`, which
    takes one tensor per local rank and returns one result each."""

    size: int = 1
    ranks: List[int] = [0]

    def run(self, op: str, xs: List[torch.Tensor], dim: int
            ) -> List[torch.Tensor]:
        raise NotImplementedError


def _wrap_sum(xs: List[torch.Tensor]) -> torch.Tensor:
    acc = xs[0].to(torch.int64)
    for x in xs[1:]:
        acc = acc + x.to(acc.device, torch.int64)
    # Two's complement wrap, as XLA's int32 psum and the per-shard
    # int32 counters do.
    return ((acc + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


class LocalComm(Comm):
    """All `size` shards in this process. A result goes to the device of
    the shard it is for (the device of that shard's input)."""

    def __init__(self, size: int):
        self.size = int(size)
        self.ranks = list(range(self.size))

    def run(self, op, xs, dim):
        p = self.size
        if op == "all_to_all":
            chunks = [torch.chunk(x, p, dim=dim) for x in xs]
            return [torch.cat([chunks[s][r].to(xs[r].device)
                               for s in range(p)], dim=dim)
                    for r in range(p)]
        if op == "all_gather":
            return [torch.cat([x.to(xs[r].device) for x in xs], dim=0)
                    for r in range(p)]
        if op == "psum":
            s = _wrap_sum(xs)
            return [s.to(x.device) for x in xs]
        if op == "pmax":
            m = xs[0]
            for x in xs[1:]:
                m = torch.maximum(m, x.to(m.device))
            return [m.to(x.device) for x in xs]
        raise ValueError(f"unknown collective {op}")


class DistComm(Comm):
    """One shard a process over the default ``torch.distributed`` group
    (parallel/distributed.py initialises it): rank r drives shard r.
    Booleans travel as int32. NCCL takes one card a rank; it refuses two
    ranks on one device."""

    def __init__(self):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("DistComm needs torch.distributed "
                               "initialised (parallel.distributed."
                               "initialize)")
        self._dist = dist
        self.size = dist.get_world_size()
        self.ranks = [dist.get_rank()]

    def run(self, op, xs, dim):
        dist = self._dist
        (x,) = xs
        dtype = x.dtype
        y = x.to(torch.int32) if dtype == torch.bool else x
        if op == "all_to_all":
            moved = y.movedim(dim, 0).contiguous()
            out = torch.empty_like(moved)
            dist.all_to_all_single(out, moved)
            res = out.movedim(0, dim).contiguous()
        elif op == "all_gather":
            parts = [torch.empty_like(y) for _ in range(self.size)]
            dist.all_gather(parts, y.contiguous())
            res = torch.cat(parts, dim=0)
        elif op in ("psum", "pmax"):
            res = y.clone()
            dist.all_reduce(res, op=(dist.ReduceOp.SUM if op == "psum"
                                     else dist.ReduceOp.MAX))
        else:
            raise ValueError(f"unknown collective {op}")
        return [res.to(dtype) if dtype == torch.bool else res]

    def gather_leaf(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` concatenated along its last axis (a state
        leaf's shard → the global leaf)."""
        r = self.run("all_gather", [x.movedim(-1, 0).contiguous()], 0)[0]
        return r.movedim(0, -1).contiguous()


def drive(comm: Comm, gens: List[Generator]) -> List[Any]:
    """Run one generator per rank of `comm.ranks` to their return
    values, serving each round of their collectives together. The
    shards must reach the same collectives in the same order, with the
    same shapes and types (`MeshDivergence` otherwise)."""
    n = len(gens)
    sent: List[Any] = [None] * n
    out: List[Any] = [None] * n
    live = [True] * n
    try:
        while True:
            reqs = []
            for i, g in enumerate(gens):
                if not live[i]:
                    reqs.append(None)
                    continue
                try:
                    reqs.append(g.send(sent[i]))
                except StopIteration as e:
                    out[i] = e.value
                    live[i] = False
                    reqs.append(None)
            if not any(live):
                return out
            if not all(live):
                raise MeshDivergence(
                    "some shards finished their tick while others wait "
                    f"in a collective ({[r and r.op for r in reqs]})")
            r0 = reqs[0]
            for r in reqs[1:]:
                if (r.op, r.dim, tuple(r.x.shape), r.x.dtype) != (
                        r0.op, r0.dim, tuple(r0.x.shape), r0.x.dtype):
                    raise MeshDivergence(
                        f"shards disagree on a collective: {r0.op} "
                        f"{tuple(r0.x.shape)} {r0.x.dtype} vs {r.op} "
                        f"{tuple(r.x.shape)} {r.x.dtype}")
            sent = comm.run(r0.op, [r.x for r in reqs], r0.dim)
    finally:
        for g in gens:
            g.close()

"""The shards of an actor world and where they live (the counterpart of
``ponyc_tpu/parallel/mesh.py``).

The JAX package shards the actor-row axis of every runtime array over a
1-D ``jax.sharding.Mesh`` axis named 'actors': the LAST axis of each
state leaf is split into P equal blocks, block s on shard s
(``shard_state``). The port keeps that layout. A window, a tick or a
collection pass runs on the per-shard states (`split`), each with
contiguous tensors, through the collective layer (comm.py, `drive`),
and leaves the world resident on its shards (`Sharded`). The global
layout (what the host API, the collector's roots and snapshots read)
is joined only when the host reads the world (`Sharded.world`), as the
JAX package's sharded global arrays are gathered only when fetched; a
host write splits it again at the next window.

A device may carry several shards: `make_mesh(4, ["cuda:0"])` puts four
shards on one card, as `make_mesh(4, ["cpu"])` does on the CPU (the JAX
package's tests get their 8 devices from one CPU the same way). The
JAX package raises when it has fewer devices than shards.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from .comm import Comm, DistComm, LocalComm, drive, solo


class Mesh:
    """P shards over a device list (shard s on devices[s mod len]) and
    the Comm that joins them. `ranks` are the shards this process
    drives: all of them under LocalComm, its own under DistComm."""

    def __init__(self, n_shards: int, devices: Sequence, comm: Comm):
        self.n_shards = int(n_shards)
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if comm.size != self.n_shards:
            raise ValueError(f"{self.n_shards} shards over a comm of "
                             f"{comm.size}")
        self.comm = comm

    @property
    def ranks(self) -> List[int]:
        return self.comm.ranks

    @property
    def distributed(self) -> bool:
        return isinstance(self.comm, DistComm)

    def device_of(self, rank: int) -> torch.device:
        return self.devices[rank % len(self.devices)]

    def __repr__(self):
        return (f"Mesh({self.n_shards} shards over "
                f"{[str(d) for d in self.devices]}, "
                f"{type(self.comm).__name__})")


def make_mesh(n_shards: Optional[int] = None, devices=None,
              comm: Optional[Comm] = None) -> Mesh:
    """A 1-D mesh over the actor axis. `devices` defaults to every CUDA
    device; `n_shards` to their count. Under `comm` (a DistComm) the
    process drives its own rank only."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass "
                               "devices=['cpu']")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = int(n_shards or len(devices))
    return Mesh(n, devices, comm or LocalComm(n))


def _leaves_map(fn, st):
    """Apply fn to every tensor leaf of a state (its dicts included)."""
    def go(x):
        if isinstance(x, torch.Tensor):
            return fn(x)
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        return x
    return dataclasses.replace(st, **{
        f.name: go(getattr(st, f.name)) for f in dataclasses.fields(st)})


def shard_block(x: torch.Tensor, rank: int, p: int) -> torch.Tensor:
    """Shard `rank`'s block of a global leaf: its last axis in P equal
    blocks."""
    k = x.shape[-1] // p
    return x[..., rank * k:(rank + 1) * k]


def shard_state(state, mesh: Mesh) -> list:
    """The per-shard states of a global state, one for each rank this
    process drives, on that shard's device, every leaf contiguous."""
    p = mesh.n_shards
    return [_leaves_map(
        lambda x, r=r: shard_block(x, r, p).to(mesh.device_of(r))
        .contiguous(), state) for r in mesh.ranks]


def gather_state(shards: list, mesh: Mesh, device):
    """The global state of the per-shard states (`shard_state`'s
    inverse) on `device`. Under DistComm every rank contributes its
    shard and receives the whole world (one all_gather a leaf)."""
    if mesh.distributed:
        (st,) = shards
        return _leaves_map(
            lambda x: mesh.comm.gather_leaf(x).to(device), st)
    flat = [_flatten(s) for s in shards]
    out = [torch.cat([f[i].to(device) for f in flat], dim=-1)
           for i in range(len(flat[0]))]
    return _unflatten(shards[0], out)


def _flatten(st) -> List[torch.Tensor]:
    acc: List[torch.Tensor] = []
    _leaves_map(lambda x: acc.append(x) or x, st)
    return acc


def _unflatten(template, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return _leaves_map(lambda _x: next(it), template)


class Sharded:
    """A world resident on its shards: the per-shard states of the ranks
    this process drives, as a window, a tick or a collection pass left
    them (on the devices of `mesh`; `home` is the global state's
    device). `world()` joins the global layout once and keeps it until
    the next window replaces this object; any other attribute reads
    through it, so a caller may read a field of either form. Under
    DistComm the join is a collective (one all_gather a leaf): every
    rank reads the world at the same program point, as the JAX
    package's SPMD host driver does."""

    def __init__(self, shards: list, mesh: Mesh, home):
        self.shards = shards
        self.mesh = mesh
        self.home = torch.device(home)
        self._world = None

    def world(self):
        if self._world is None:
            self._world = gather_state(self.shards, self.mesh, self.home)
        return self._world

    def total(self, name: str) -> int:
        """A state leaf summed over the mesh (a per-shard counter),
        without joining the world where this process drives every
        shard."""
        if self._world is None and not self.mesh.distributed:
            return sum(int(getattr(s, name).sum()) for s in self.shards)
        return int(getattr(self.world(), name).sum())

    def __getattr__(self, name):
        if name.startswith("_") or name in ("shards", "mesh", "home"):
            raise AttributeError(name)
        return getattr(self.world(), name)


def world_of(st):
    """The global state of a resident world, or `st` itself."""
    return st.world() if isinstance(st, Sharded) else st


def home_of(st) -> torch.device:
    """The device of a state's global layout (no join)."""
    return st.home if isinstance(st, Sharded) else st.head.device


def mesh_for(st, shards: int, mesh: Optional[Mesh] = None
             ) -> Optional[Mesh]:
    """The mesh a pass over `st` runs on: None on one shard; else
    `mesh`, a resident world's own, or every shard on the state's
    device."""
    if shards <= 1:
        return None
    if mesh is not None:
        return mesh
    if isinstance(st, Sharded):
        return st.mesh
    return make_mesh(shards, [st.head.device])


def ranks_of(mesh: Optional[Mesh]) -> List[int]:
    return [0] if mesh is None else mesh.ranks


def split(st, mesh: Optional[Mesh]) -> list:
    """The per-shard states a pass runs on, one for each rank of
    `ranks_of(mesh)`: [st] on one shard, a resident world's own shards
    where they lie on `mesh`'s devices, else the global state split."""
    if mesh is None:
        return [st]
    if isinstance(st, Sharded) and st.mesh.ranks == mesh.ranks and all(
            s.head.device == mesh.device_of(r)
            for s, r in zip(st.shards, mesh.ranks)):
        return st.shards
    return shard_state(world_of(st), mesh)


def join(shards: list, mesh: Optional[Mesh], home):
    """`split`'s inverse, with no copy: the one state on one shard, a
    resident world on a mesh."""
    return shards[0] if mesh is None else Sharded(shards, mesh, home)


def drive_shards(mesh: Optional[Mesh], gens: list) -> list:
    """Run one per-shard generator for each rank of `ranks_of(mesh)` to
    its return value (comm.drive; comm.solo on one shard)."""
    if mesh is None:
        (gen,) = gens
        return [solo(gen)]
    return drive(mesh.comm, gens)

"""gups on the PyTorch port — the same program as
``ponyc_tpu/models/gups.py`` (the reference benchmark
`examples/gups_basic/main.pony`, RandomAccess/GUPS: random xor-updates
scattered over a distributed table held by actors).

Shape: the table is one cohort with *one word per actor* (the
actor-per-element limit case of the reference's actor-partitioned table —
scatter delivery IS the random-access operation), plus an updater cohort.
Each updater carries a xorshift32 PRNG in its state, picks a random table
actor every tick and fires an `update(val)` at it; delivery's sort+scatter
performs the GUP. Throughput in updates/sec ≙ GUPS.
"""

from __future__ import annotations

import numpy as np

from .. import I32, Runtime, RuntimeOptions, actor, behaviour


@actor
class TableCell:
    value: I32

    @behaviour
    def update(self, st, v: I32):
        return {**st, "value": st["value"] ^ v}


@actor
class Updater:
    rng: I32
    # TableCell id layout (shard-major; see Cohort.slot_to_gid): cell slot s
    # lives at gid (s % n_shards) * n_local + cell_start + s // n_shards.
    cell_start: I32
    n_shards: I32
    n_local: I32
    table_size: I32
    done: I32

    BATCH = 1
    MAX_SENDS = 2

    @behaviour
    def tick(self, st, n: I32):
        # xorshift32 (public-domain Marsaglia generator).
        x = st["rng"]
        x = x ^ (x << 13)
        x = x ^ ((x >> 17) & 0x7FFF)
        x = x ^ (x << 5)
        slot = x % st["table_size"]     # floor remainder: >= 0 for size > 0
        gid = ((slot % st["n_shards"]) * st["n_local"]
               + st["cell_start"] + slot // st["n_shards"])
        self.send(gid, TableCell.update, x, when=n > 0)
        self.send(self.actor_id, Updater.tick, n - 1, when=n > 1)
        return {**st, "rng": x, "done": st["done"] + (n > 0)}


def build(table_size: int = 4096, n_updaters: int = 64,
          opts: RuntimeOptions | None = None, device=None):
    """`device` as for Runtime (None = the CUDA device)."""
    opts = opts or RuntimeOptions(mailbox_cap=16, batch=2, msg_words=1,
                                  spill_cap=1024)
    rt = Runtime(opts, device=device)
    rt.declare(TableCell, table_size).declare(Updater, n_updaters)
    rt.start()
    cells = rt.spawn_many(TableCell, table_size)
    cell_cohort = rt.program.by_type[TableCell]
    rng = np.random.default_rng(7)
    upd = rt.spawn_many(
        Updater, n_updaters,
        rng=rng.integers(1, 2**31 - 1, n_updaters),
        cell_start=cell_cohort.local_start,
        n_shards=rt.program.shards,
        n_local=rt.program.n_local,
        table_size=table_size)
    return rt, cells, upd


def run(table_size: int = 4096, n_updaters: int = 64, updates_each: int = 32,
        opts: RuntimeOptions | None = None, device=None) -> Runtime:
    rt, cells, upd = build(table_size, n_updaters, opts, device)
    rt.bulk_send(upd, Updater.tick, [updates_each] * n_updaters)
    rt.run(max_steps=updates_each * 4 + 200)
    return rt


@actor
class OptUpdater:
    """≙ examples/gups_opt: the optimised variant amortises per-message
    overhead by issuing K updates per dispatch (the reference batches
    updates into array messages; here K parallel sends saturate the
    delivery sort instead — the device cost is per-*tick*, not
    per-message, so fan-out per dispatch is the analogous lever)."""

    rng: I32
    cell_start: I32
    n_shards: I32
    n_local: I32
    table_size: I32
    done: I32

    BATCH = 1
    K = 8
    MAX_SENDS = 9        # K updates + self-retrigger

    @behaviour
    def tick(self, st, n: I32):
        x = st["rng"]
        go = n > 0
        for _ in range(OptUpdater.K):
            x = x ^ (x << 13)
            x = x ^ ((x >> 17) & 0x7FFF)
            x = x ^ (x << 5)
            slot = x % st["table_size"]
            gid = ((slot % st["n_shards"]) * st["n_local"]
                   + st["cell_start"] + slot // st["n_shards"])
            self.send(gid, TableCell.update, x, when=go)
        self.send(self.actor_id, OptUpdater.tick, n - 1, when=n > 1)
        return {**st, "rng": x,
                "done": st["done"] + OptUpdater.K * go}


def build_opt(table_size: int = 4096, n_updaters: int = 64,
              opts: RuntimeOptions | None = None, device=None):
    opts = opts or RuntimeOptions(mailbox_cap=16, batch=2, msg_words=1,
                                  spill_cap=4096)
    rt = Runtime(opts, device=device)
    rt.declare(TableCell, table_size).declare(OptUpdater, n_updaters)
    rt.start()
    cells = rt.spawn_many(TableCell, table_size)
    cell_cohort = rt.program.by_type[TableCell]
    rng = np.random.default_rng(11)
    upd = rt.spawn_many(
        OptUpdater, n_updaters,
        rng=rng.integers(1, 2**31 - 1, n_updaters),
        cell_start=cell_cohort.local_start,
        n_shards=rt.program.shards,
        n_local=rt.program.n_local,
        table_size=table_size)
    return rt, cells, upd


def run_opt(table_size: int = 4096, n_updaters: int = 64,
            ticks_each: int = 8,
            opts: RuntimeOptions | None = None, device=None) -> Runtime:
    rt, cells, upd = build_opt(table_size, n_updaters, opts, device)
    rt.bulk_send(upd, OptUpdater.tick, [ticks_each] * n_updaters)
    rt.run(max_steps=ticks_each * 4 + 200)
    return rt

"""Worker of tests/test_torch_distributed.py: one rank of a
torch.distributed job (gloo on the CPU), one shard a rank.

Run identically on every rank (argv: init_method rank world_size stages
...): every rank makes the SAME host calls (declares, spawns, sends, run
calls), the SPMD host-driver contract of tests/_dist_worker.py, so the
tick's collectives meet in the same order on every rank. Each stage
prints `RANK<r>_<STAGE> <json>`: the world's numbers, which the test
holds against the same program run on one process over LocalComm
(`world`, below), and the conservation counters of tests/_dist_worker.py.

Stages: comm (one collective of each kind, int32 wrap-around included),
ubench (all-to-all traffic), ring (every hop crosses the process
boundary), gc (a released ring collected, its marks crossing the
process boundary) and pressure (fan-in through a two-entry route bucket: the
route spill, the mute and the release cross processes).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np                                      # noqa: E402

from ponyc_tpu_torch import Runtime, RuntimeOptions    # noqa: E402
from ponyc_tpu_torch.models import fanin, ring, ubench  # noqa: E402


def numbers(rt, atype):
    """What a run must give on every rank and over LocalComm alike."""
    return {"fields": {k: v.tolist()
                       for k, v in rt.cohort_state(atype).items()},
            "counters": {c: rt.counter(c) for c in (
                "n_processed", "n_delivered", "n_rejected", "n_mutes",
                "n_deadletter", "rspill_count")},
            "ticks": rt.steps_run}


def world(stage, shards, device="cpu"):
    """Run one stage's world over `shards` shards and return its numbers
    (with the stage's conservation facts)."""
    if stage == "ubench":
        n, pings, hops = 64, 2, 40
        rt, ids = ubench.build(n, RuntimeOptions(
            mailbox_cap=4, batch=pings, max_sends=1, msg_words=1,
            spill_cap=512, inject_slots=8, mesh_shards=shards,
            quiesce_interval=2, tuning_cache="off"), pings=pings,
            device=device)
        ubench.seed_all(rt, ids, hops=hops, pings=pings)
        assert rt.run(max_steps=20_000) == 0
        # Every seeded chain ran to exhaustion: none lost, none doubled.
        assert rt.counter("n_processed") == n * pings * (hops + 1)
        return numbers(rt, ubench.Pinger)
    if stage == "ring":
        hops = 64
        rt, ids = ring.build(shards, RuntimeOptions(
            mailbox_cap=4, batch=1, max_sends=1, msg_words=1, spill_cap=64,
            inject_slots=8, mesh_shards=shards, quiesce_interval=2,
            tuning_cache="off"), device=device)
        rt.send(int(ids[0]), ring.RingNode.token, hops)
        assert rt.run(max_steps=20_000) == 0
        assert rt.counter("n_processed") == hops
        return numbers(rt, ring.RingNode)
    if stage == "gc":
        # The collector's marks cross the process boundary (one psum a
        # hop): the ring's released tail is reachable from the pinned
        # head only through refs held on the other rank.
        n, hops = 4 * shards, 16
        rt, ids = ring.build(n, RuntimeOptions(
            mailbox_cap=4, batch=1, max_sends=1, msg_words=1, spill_cap=64,
            inject_slots=8, mesh_shards=shards, quiesce_interval=2,
            tuning_cache="off"), device=device)
        rt.send(int(ids[0]), ring.RingNode.token, hops)
        assert rt.run(max_steps=20_000) == 0
        rt.release(ids[1:])
        kept = rt.gc()
        rt.release(ids[:1])
        collected = rt.gc()
        assert (kept, collected) == (0, n)
        out = numbers(rt, ring.RingNode)
        out["collected"] = [kept, collected, rt.counter("n_collected")]
        return out
    if stage == "pressure":
        n_src, items = 6 * shards, 4
        rt = Runtime(RuntimeOptions(
            mailbox_cap=4, batch=1, max_sends=2, msg_words=2,
            mesh_shards=shards, spill_cap=4096, inject_slots=64,
            quiesce_interval=1, route_bucket=2, tuning_cache="off"),
            device=device)
        rt.declare(fanin.Producer, n_src).declare(fanin.Aggregator, shards)
        rt.start()
        agg = rt.spawn(fanin.Aggregator)
        srcs = rt.spawn_many(fanin.Producer, n_src, out=int(agg))
        rt.bulk_send(srcs, fanin.Producer.produce,
                     np.full(n_src, items, np.int64))
        saw_rspill = saw_muted = False
        for _ in range(100 * shards):
            rt.run(max_steps=1)
            saw_rspill = saw_rspill or rt.counter("rspill_count") > 0
            saw_muted = saw_muted or bool(rt.state.muted.any())
            if rt.state_of(int(agg))["total"] == n_src * items:
                break
        assert rt.state_of(int(agg))["total"] == n_src * items
        assert saw_rspill, "the route spill never engaged"
        assert saw_muted, "pressure never muted a sender"
        rt.run(max_steps=80)
        assert not bool(rt.state.muted.any())
        assert rt.counter("rspill_count") == 0
        return numbers(rt, fanin.Producer)
    raise ValueError(stage)


def comm_smoke(rank, size):
    """One collective of each kind over DistComm, checked against the
    values every rank can compute."""
    import torch
    from ponyc_tpu_torch.parallel import comm, distributed as dist
    assert dist.device_count() == size and dist.process_index() == rank
    assert dist.is_leader() == (rank == 0)
    c = comm.DistComm()
    top = torch.tensor([2**31 - 1, rank + 1], dtype=torch.int32)
    (s,) = c.run("psum", [top], 0)
    want = np.array([(2**31 - 1) * size, size * (size + 1) // 2],
                    np.int64)
    want = ((want + 2**31) % 2**32 - 2**31).astype(np.int32)
    assert s.dtype == torch.int32 and s.tolist() == want.tolist(), s
    (m,) = c.run("pmax", [torch.tensor([rank - 5], dtype=torch.int32)], 0)
    assert m.item() == size - 6
    (g,) = c.run("all_gather", [torch.tensor([rank % 2 == 0])], 0)
    assert g.tolist() == [r % 2 == 0 for r in range(size)]
    x = torch.arange(2 * size, dtype=torch.int32).reshape(1, -1) + 100 * rank
    (a,) = c.run("all_to_all", [x], 1)
    assert a.tolist() == [[100 * s + 2 * rank + j for s in range(size)
                           for j in range(2)]], a
    return {"psum": s.tolist()}


def main():
    init, rank, size = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import torch
    torch.set_num_threads(1)
    from ponyc_tpu_torch.parallel import distributed as dist
    dist.initialize(init, world_size=size, rank=rank, backend="gloo")
    try:
        for stage in sys.argv[4:]:
            out = (comm_smoke(rank, size) if stage == "comm"
                   else world(stage, size))
            print(f"RANK{rank}_{stage.upper()} {json.dumps(out)}",
                  flush=True)
        print(f"RANK{rank}_ALL_OK", flush=True)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()

"""Batched message delivery of the PyTorch port: the vectorised send path
on one device (the counterpart of ``ponyc_tpu/runtime/delivery.py``, both
of its formulations).

≙ the reference's pony_sendv → ponyint_maybe_mute → messageq_push chain
(src/libponyrt/actor/actor.c:773-968, actor/messageq.c:102-160) for
every in-flight message of a tick at once:

  1. the engine hands over all candidate messages: receiver spill
     (oldest first), host injections, then freshly produced messages;
  2. a stable sort by the composite key ``target * n_levels + level``
     makes per-target arrival order [older spill → inject → new in
     emission order], which keeps Pony's per-sender FIFO;
  3. per-target segment bounds come from `torch.searchsorted` over the
     sorted keys; each target accepts min(count, free space), so
     rejections are always the newest suffix of a target's segment;
  4. the mailbox table is rebuilt slot-plane by slot-plane: ring slot c
     of every actor takes sorted entry seg_start + (c - tail) mod cap;
  5. rejections compact into the next spill and their senders mute
     (≙ actor.c:898-921).

Where the JAX package branches with ``lax.cond`` (the cached plan, the
no-message tick, the pressure path), eager PyTorch would have to read a
predicate back to the host — a synchronisation per branch. This port
runs the general arm unconditionally instead; on a tick where the cheap
arm would have been taken, the general arm reduces to it exactly: the
sort of an unchanged key gives the cached permutation, a tick with no
valid entry accepts nothing and rewrites no slot, and a tick without
rejections or hot receivers compacts an empty spill and triggers no
mute. So results match the reference bit for bit, at the cost of always
paying for the sort and the pressure pass. The reference's plan cache
(skip the sort when the key vector repeats) is not kept for the same
reason: the skip is a branch on device data.

Two formulations, as in the JAX package (`cosort`, opts.delivery). The
reference's plan gathers the payload through the stable-sort permutation
and returns it with the segment bounds as the tick's plan (`plan_perm`,
`plan_bounds`); its cosort sorts (key, tgt, sender, *words) with one
stable multi-operand ``lax.sort`` and returns a placeholder plan
(``arange(E)``, zeros). PyTorch has no multi-operand sort, and with no
plan cache the two are one computation here: a stable ``torch.sort`` of
the key, then gathers of tgt, sender and the words by its order. Only the
returned plan differs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.segment import DUMP_SLOTS, compact_mask, dump_index


class Entries(NamedTuple):
    """A flat batch of in-flight messages (targets in local rows)."""
    tgt: torch.Tensor      # [E] int32 target row; -1 = empty slot
    sender: torch.Tensor   # [E] int32 sender global id; -1 = host
    words: torch.Tensor    # [1+W, E] int32 (word0 = behaviour gid)


class DeliveryResult(NamedTuple):
    buf: dict                  # {type: [cap, 1+W_c, rows_c]} per cohort
    trace_buf: dict            # {type: [cap, 2, rows_c]}; {} untraced
    tail: torch.Tensor
    spill: Entries             # rejected entries, compacted, oldest first
    spill_count: torch.Tensor  # [] int32
    spill_overflow: torch.Tensor
    newly_muted: torch.Tensor   # [n_local] bool
    new_mute_refs: torch.Tensor  # [K, n_local] refs slotted by ref % K
    new_mute_ovf: torch.Tensor  # [n_local] bool
    n_delivered: torch.Tensor
    n_rejected: torch.Tensor
    n_deadletter: torch.Tensor
    plan_key: torch.Tensor      # [E] the key vector this tick sorted
    plan_perm: torch.Tensor     # [E] its stable-sort permutation
    plan_bounds: torch.Tensor   # [n_local+1] segment bounds


def _isum(x: torch.Tensor) -> torch.Tensor:
    """int32 sum (torch sums integers into int64 by default; the world's
    counters are int32 and wrap like the reference's)."""
    return x.sum(dtype=torch.int32)


def mute_ref_slots(trig, mute_row, refs, *, n: int, k: int):
    """Scatter triggered (sender-row, receiver-ref) mute pairs into the
    K-slot-per-sender ref table (slot = ref % K). Returns (refs [k, n],
    ovf [n]) where ovf marks senders where two distinct refs collided in
    one slot this tick. Untriggered pairs land in dump slots."""
    big = 2**31 - 1
    flat = dump_index(trig, (refs % k).long() * n + mute_row.long(), k * n)
    i32 = torch.int32
    dev = refs.device
    rmax = torch.full((k * n + DUMP_SLOTS,), -1, dtype=i32, device=dev)
    rmax.scatter_reduce_(0, flat, torch.where(trig, refs, -1).to(i32),
                         reduce="amax")
    rmin = torch.full((k * n + DUMP_SLOTS,), big, dtype=i32, device=dev)
    rmin.scatter_reduce_(0, flat, torch.where(trig, refs, big).to(i32),
                         reduce="amin")
    rmax = rmax[:k * n].reshape(k, n)
    rmin = rmin[:k * n].reshape(k, n)
    ovf = torch.any((rmax >= 0) & (rmin != rmax), dim=0)
    return rmax, ovf


def empty_mute_slots(n: int, k: int, device):
    return (torch.full((k, n), -1, dtype=torch.int32, device=device),
            torch.zeros((n,), dtype=torch.bool, device=device))


def deliver(buf, head, tail, alive, entries: Entries, *, n_local: int,
            mailbox_cap: int, spill_cap: int, overload_occ: int,
            shard_base: int, cohort_layout, mute_slots: int = 4,
            level=None, n_levels: int = 1,
            pressured=None, cosort: bool = False,
            trace_buf=None) -> DeliveryResult:
    """`buf` is the per-cohort mailbox dict {type: [cap, 1+W_c, rows_c]};
    `cohort_layout` = [(type, s0, s1, w1_c)] tiles the local rows
    [0, n_local) in cohort order. `level` ([E] int32, 0 = most urgent)
    orders contenders for one mailbox by priority: 0 is the receiver
    spill, 1 host injections, 2+ sender cohorts by PRIORITY.
    `trace_buf` (causal tracing on: {type: [cap, 2, rows_c]}) takes the
    entries' two trailing word rows, (trace id, parent span), through
    the same (mask, source) pair as the payload."""
    n, c = n_local, mailbox_cap
    tgt, sender, words = entries
    e = tgt.shape[0]
    dev = tgt.device
    i32 = torch.int32

    in_range = (tgt >= 0) & (tgt < n)
    tgt_c = tgt.clamp(0, n - 1).long()
    to_dead = in_range & ~alive[tgt_c]
    valid = in_range & ~to_dead

    if level is None:
        level = torch.zeros((e,), dtype=i32, device=dev)
        n_levels = 1
    key = torch.where(valid, tgt * n_levels + level,
                      n * n_levels).to(i32)

    # --- one stable sort of the key: its permutation orders the payload,
    # and the per-target segment bounds come from the sorted key.
    key_s, perm = torch.sort(key, stable=True)
    bounds = torch.searchsorted(
        key_s, torch.arange(n + 1, dtype=i32, device=dev) * n_levels,
        side="left").to(i32)
    kt = torch.where(key_s < n * n_levels, tgt[perm], n).to(i32)
    snd = sender[perm]
    wds = words.index_select(1, perm)            # [w1, E] sorted
    ktc = kt.clamp(max=n - 1).long()
    seg_start = bounds[:-1]                      # [n]
    cnt = bounds[1:] - seg_start                 # [n] msgs per target
    occ = tail - head
    space = (c - occ).clamp(min=0)
    acc = torch.minimum(cnt, space)              # accepted per target
    new_tail = tail + acc

    # --- slot-plane ring rebuild, per cohort at its own word width.
    rels = (torch.arange(c, dtype=i32, device=dev)[:, None]
            - tail[None, :]) % c                 # [cap, n]
    wmasks = rels < acc[None, :]
    srcs = (seg_start[None, :] + rels).clamp(max=e - 1)
    buf2 = {}
    for cname, s0, s1, w1c in cohort_layout:
        nn = s1 - s0
        pulled = wds[:w1c].index_select(
            1, srcs[:, s0:s1].reshape(c * nn).long()).reshape(w1c, c, nn)
        # Contiguous operands keep the table contiguous (where() would
        # otherwise adopt the permuted layout; the drain kernel needs
        # the planar one).
        buf2[cname] = torch.where(wmasks[:, None, s0:s1],
                                  pulled.permute(1, 0, 2).contiguous(),
                                  buf[cname])

    tbuf2 = {}
    if trace_buf is not None:
        w1f = wds.shape[0]
        for cname, s0, s1, _w1c in cohort_layout:
            nn = s1 - s0
            pulled = wds[w1f - 2:].index_select(
                1, srcs[:, s0:s1].reshape(c * nn).long()).reshape(2, c, nn)
            tbuf2[cname] = torch.where(wmasks[:, None, s0:s1],
                                       pulled.permute(1, 0, 2).contiguous(),
                                       trace_buf[cname])

    n_delivered = _isum(acc)
    nrej = _isum(cnt - acc)
    occ_after = new_tail - head

    # --- pressure path (spill compaction + mute triggers), run every
    # tick: without rejections or hot receivers it yields the empty
    # spill and no mute, exactly the reference's quiet branch.
    rank = (torch.arange(e, dtype=i32, device=dev)
            - seg_start.index_select(0, ktc))
    ok = kt < n
    rej = ok & (rank >= acc.index_select(0, ktc))
    perm2, vspill, _ = compact_mask(rej, spill_cap)
    spill = Entries(
        tgt=torch.where(vspill, kt[perm2], -1),
        sender=torch.where(vspill, snd[perm2], -1),
        words=torch.where(vspill[None, :], wds.index_select(1, perm2), 0),
    )
    # Mute triggers (≙ actor.c:898-921 + actor.c:1171-1235): a valid
    # send whose receiver rejected it, is over the overload threshold, or
    # declared pressure mutes the sender — unless the sender is itself
    # overloaded or pressured.
    recv_hot = occ_after.index_select(0, ktc) > overload_occ
    if pressured is not None:
        recv_hot = recv_hot | pressured.index_select(0, ktc)
    lsnd = snd - shard_base
    sender_local = (lsnd >= 0) & (lsnd < n)
    sc = lsnd.clamp(0, n - 1).long()
    sender_hot = occ_after.index_select(0, sc) > overload_occ
    if pressured is not None:
        sender_hot = sender_hot | pressured.index_select(0, sc)
    trig = ok & sender_local & (rej | recv_hot) & ~sender_hot
    mute_row = torch.where(trig, sc, n)
    newly = torch.zeros((n + DUMP_SLOTS,), dtype=i32, device=dev)
    newly.scatter_reduce_(0, dump_index(trig, sc, n), trig.to(i32),
                          reduce="amax")
    refs, ovf = mute_ref_slots(trig, mute_row, kt + shard_base,
                               n=n, k=mute_slots)

    return DeliveryResult(
        buf=buf2, trace_buf=tbuf2, tail=new_tail,
        spill=spill, spill_count=nrej.clamp(max=spill_cap),
        spill_overflow=nrej > spill_cap,
        newly_muted=newly[:n] > 0, new_mute_refs=refs, new_mute_ovf=ovf,
        n_delivered=n_delivered, n_rejected=nrej,
        n_deadletter=_isum(to_dead),
        plan_key=key, **_plan(cosort, perm, bounds),
    )


def _plan(cosort: bool, perm, bounds):
    """The tick's carried plan: the permutation and bounds (plan), or
    the reference's placeholder under cosort, which nothing reads."""
    if cosort:
        return dict(plan_perm=torch.arange(perm.shape[0], dtype=torch.int32,
                                           device=perm.device),
                    plan_bounds=torch.zeros_like(bounds))
    return dict(plan_perm=perm.to(torch.int32), plan_bounds=bounds)

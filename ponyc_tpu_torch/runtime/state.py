"""Device-resident runtime state of the PyTorch port: the struct-of-arrays
actor world (the counterpart of ``ponyc_tpu/runtime/state.py``).

≙ the reference's per-actor structs flattened across all actors: actor
flags become [N] columns, each actor's mailbox one lane of a dense ring
table with monotonically increasing head/tail counts (occupancy =
tail - head, physical slot = count mod cap), and the scheduler's
unbounded queues a bounded spill table retried next tick.

Layout. The actor/entry axis is the minor-most (last) dimension of every
multi-dimensional tensor, as in the JAX package: a cohort's mailbox
table is [cap, 1+W_c, rows], entries are [words, E], mute tables [K, N].
The reference chose it so the million-actor axis fills the TPU's vector
lanes; on a GPU the same axis is the coalesced one — neighbouring
threads of a warp handle neighbouring actors and touch neighbouring
addresses.

Field names, shapes and dtypes match the JAX package's RtState one for
one, so a world can be carried across (interop.py). The telemetry leaves
(analysis >= 1: the profiler lanes, the phase costs; analysis >= 3: the
event ring; tracing: the trace side lanes and the span ring) take the
reference's sizes, and the zero length it gives them when off. The blob
pool is sized by RuntimeOptions.blob_slots and blob_words (zero-size when
off).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..config import RuntimeOptions
from ..ops.pack import F32, null_word
from ..program import Program

from ..tracing import SPAN_ROWS   # span-ring record rows (tracing.py)

# Queue-wait histogram geometry (engine.profile_lanes): bucket k counts
# dispatched messages that waited [2^k, 2^(k+1)) ticks between delivery
# (the enqueue stamp) and dispatch; the last bucket is open-ended.
QW_BUCKETS = 16

# Per-phase window telemetry (engine.phase_cost_lanes): one work-unit
# counter per phase of a tick, deterministic tallies, not wall time.
PHASE_NAMES = ("delivery", "drain", "dispatch", "gc_mark")
N_PHASES = len(PHASE_NAMES)


def layout_sizes(program: Program, opts: RuntimeOptions):
    """Static per-shard sizes shared by build_step and init_state:
    (e_out, bucket, n_delivery_entries). e_out — outbox entries one shard
    can emit per tick; bucket — mesh routing bucket (0 on one device);
    n_delivery_entries — rows of the delivery list (receiver spill + host
    inject + incoming), also the length of the delivery plan."""
    e_out = sum(ch.local_capacity * ch.batch * ch.max_sends
                for ch in program.device_cohorts)
    s = opts.spill_cap
    if program.shards > 1:
        from ..config import unported
        raise unported("mesh")
    incoming = s + e_out          # route-spill passthrough + outbox
    return e_out, 0, s + opts.inject_slots + incoming


# Word tables: mailbox rings, spill words (and trace lanes, with tracing):
# what ops/megakernel.py's int16 + escape codec packs (for snapshots; the
# window kernel reads and writes them as int32).
PACKED_WORD_FIELDS = ("buf", "dspill_words", "rspill_words", "trace_buf")


@dataclasses.dataclass
class RtState:
    """The complete device state of the actor world. Per-shard "scalars"
    are [P]-shaped (P = 1 here) so the layout matches the JAX package."""

    buf: Dict[str, torch.Tensor]   # {type: [cap, 1+W_c, capacity]} int32
    head: torch.Tensor        # [N] int32, monotonic pop count
    tail: torch.Tensor        # [N] int32, monotonic push count
    alive: torch.Tensor       # [N] bool — slot occupied
    muted: torch.Tensor       # [N] bool — ≙ FLAG_MUTED
    mute_refs: torch.Tensor   # [K, N] int32 — muting receivers (ref % K)
    mute_age: torch.Tensor    # [N] int32 — consecutive ticks muted
    mute_ovf: torch.Tensor    # [N] bool — muter slots collided
    pinned: torch.Tensor      # [N] bool — host holds a ref (GC root)
    pressured: torch.Tensor   # [N] bool — ≙ FLAG_UNDER_PRESSURE
    dspill_tgt: torch.Tensor      # [P*S] int32 local row, -1 = empty
    dspill_sender: torch.Tensor   # [P*S] int32 sender global id
    dspill_words: torch.Tensor    # [1+W, P*S] int32
    dspill_count: torch.Tensor    # [P] int32
    rspill_tgt: torch.Tensor      # [P*S] (mesh only; stays empty)
    rspill_sender: torch.Tensor
    rspill_words: torch.Tensor
    rspill_count: torch.Tensor
    spill_overflow: torch.Tensor  # [P] bool — a spill overflowed (fatal)
    exit_flag: torch.Tensor   # [P] bool
    exit_code: torch.Tensor   # [P] int32
    step_no: torch.Tensor     # [P] int32
    n_processed: torch.Tensor   # [P] int32 — behaviours dispatched
    n_delivered: torch.Tensor   # [P] int32 — accepted into mailboxes
    n_rejected: torch.Tensor    # [P] int32 — capacity rejections
    n_badmsg: torch.Tensor      # [P] int32 — wrong-type behaviour ids
    n_deadletter: torch.Tensor  # [P] int32 — sends to dead slots
    n_mutes: torch.Tensor       # [P] int32 — mute transitions
    n_spawned: torch.Tensor     # [P] int32
    n_destroyed: torch.Tensor   # [P] int32
    spawn_fail: torch.Tensor    # [P] bool
    n_collected: torch.Tensor   # [P] int32
    last_error: torch.Tensor    # [N] int32 — latest ctx.error_int code
    last_error_loc: torch.Tensor  # [N] int32 — its trace-site id
    n_errors: torch.Tensor      # [P] int32
    # Telemetry (zero-length where the level is off).
    ev_data: torch.Tensor       # [3, P*EV] (code, actor, step), level 3
    ev_count: torch.Tensor      # [P] int32 entries held
    ev_dropped: torch.Tensor    # [P] int32 events lost to a full ring
    beh_runs: torch.Tensor      # [P*NB] int32 dispatched, by behaviour
    beh_delivered: torch.Tensor  # [P*NB] accepted into mailboxes
    beh_rejected: torch.Tensor  # [P*NB] capacity rejections
    coh_mute_ticks: torch.Tensor  # [P*ND] actor-ticks muted, by cohort
    qwait_hist: torch.Tensor    # [P*ND*QW_BUCKETS] queue-wait histograms
    qwait_enq: Dict[str, torch.Tensor]   # {device type: [cap, rows]}
    #                              enqueue tick of each ring slot
    phase_cost: torch.Tensor    # [P*N_PHASES] work units by phase
    trace_buf: Dict[str, torch.Tensor]   # {type: [cap, 2, rows]} the
    #                              ring slots' (trace id, parent span)
    span_data: torch.Tensor     # [SPAN_ROWS, P*TS] the span ring
    span_count: torch.Tensor    # [P] int32 spans held
    span_dropped: torch.Tensor  # [P] int32 spans lost to a full ring
    span_next: torch.Tensor     # [P] int32 spans allocated (ids)
    plan_key: torch.Tensor      # [P*E] int32 — last tick's sort key
    plan_perm: torch.Tensor     # [P*E] int32 — its stable-sort permutation
    plan_bounds: torch.Tensor   # [P*(n_local+1)] int32 segment bounds
    # Device blob pool (≙ actor-heap message payloads, pony_alloc_msg;
    # see api.BlobPoolView): payloads wider than msg_words ride messages
    # as handles (ops.pack.blob_handle: slot | generation << 20; -1 null).
    # Planar like every hot array: word index major, slot minor.
    blob_data: torch.Tensor     # [blob_words, P*BS] int32 payload words
    blob_used: torch.Tensor     # [P*BS] bool — slot allocated
    blob_len: torch.Tensor      # [P*BS] int32 — logical word count
    blob_gen: torch.Tensor      # [P*BS] int32 — generation, bumped per alloc
    blob_fail: torch.Tensor     # [P] bool — sticky: an alloc found the pool
    #                              exhausted (raise blob_slots)
    blob_budget_fail: torch.Tensor  # [P] bool — sticky: an alloc fell past
    #                              its BLOB_DISPATCHES reservation budget
    n_blob_alloc: torch.Tensor  # [P] int32 — lifetime allocs
    n_blob_free: torch.Tensor   # [P] int32 — lifetime frees (GC sweeps too)
    n_blob_remote: torch.Tensor  # [P] int32 — Blob args that arrived
    #                              undereferenceable (off this pool)
    n_blob_moved: torch.Tensor  # [P] int32 — migrations (mesh only; 0)
    world_bits: torch.Tensor    # [P] int32 — bit0 pressured, bit1 muted,
    #                              bit2 route spill (previous tick's vote)
    type_state: Dict[str, Dict[str, torch.Tensor]]  # {type: {field: [cap]}}


def init_state(program: Program, opts: RuntimeOptions,
               device) -> RtState:
    """Allocate the zeroed actor world for a finalized program."""
    if not program.frozen:
        raise RuntimeError("finalize() the Program first")
    n = program.total
    p = program.shards
    w1 = 1 + opts.msg_words + opts.trace_lanes
    c = opts.mailbox_cap
    s = opts.spill_cap * p
    _, _, n_entries = layout_sizes(program, opts)
    i32, b = torch.int32, torch.bool
    # Profiler sizes: zero below analysis 1 (the lanes do not exist).
    nb = len(program.behaviour_table) if opts.analysis >= 1 else 0
    nd = len(program.device_cohorts) if opts.analysis >= 1 else 0

    def z(shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v, dtype=i32):
        return torch.full(shape, v, dtype=dtype, device=device)

    type_state = {}
    for cohort in program.cohorts:
        type_state[cohort.atype.__name__] = {
            fname: full((cohort.capacity,), null_word(spec),
                        torch.float32 if spec is F32 else i32)
            for fname, spec in cohort.atype.field_specs.items()}

    return RtState(
        buf={ch.atype.__name__: z((c, 1 + ch.msg_words, ch.capacity))
             for ch in program.cohorts},
        head=z((n,)), tail=z((n,)),
        alive=z((n,), b), muted=z((n,), b),
        mute_refs=full((opts.mute_slots, n), -1),
        mute_age=z((n,)), mute_ovf=z((n,), b),
        pinned=z((n,), b), pressured=z((n,), b),
        dspill_tgt=full((s,), -1), dspill_sender=full((s,), -1),
        dspill_words=z((w1, s)), dspill_count=z((p,)),
        rspill_tgt=full((s,), -1), rspill_sender=full((s,), -1),
        rspill_words=z((w1, s)), rspill_count=z((p,)),
        spill_overflow=z((p,), b),
        exit_flag=z((p,), b), exit_code=z((p,)), step_no=z((p,)),
        n_processed=z((p,)), n_delivered=z((p,)), n_rejected=z((p,)),
        n_badmsg=z((p,)), n_deadletter=z((p,)), n_mutes=z((p,)),
        n_spawned=z((p,)), n_destroyed=z((p,)), spawn_fail=z((p,), b),
        n_collected=z((p,)),
        last_error=z((n,)), last_error_loc=z((n,)), n_errors=z((p,)),
        ev_data=z((3, p * (opts.analysis_events
                           if opts.analysis >= 3 else 0))),
        ev_count=z((p,)), ev_dropped=z((p,)),
        beh_runs=z((p * nb,)), beh_delivered=z((p * nb,)),
        beh_rejected=z((p * nb,)), coh_mute_ticks=z((p * nd,)),
        qwait_hist=z((p * nd * QW_BUCKETS,)),
        qwait_enq=({ch.atype.__name__: z((c, ch.capacity))
                    for ch in program.device_cohorts}
                   if opts.analysis >= 1 else {}),
        phase_cost=z((p * (N_PHASES if opts.analysis >= 1 else 0),)),
        trace_buf=({ch.atype.__name__: full((c, 2, ch.capacity), -1)
                    for ch in program.cohorts} if opts.tracing else {}),
        span_data=z((SPAN_ROWS, p * (opts.trace_slots
                                     if opts.tracing else 0))),
        span_count=z((p,)),
        span_dropped=z((p,)), span_next=z((p,)),
        plan_key=full((p * n_entries,), -1),
        plan_perm=z((p * n_entries,)),
        plan_bounds=z((p * (program.n_local + 1),)),
        blob_data=z((opts.blob_words, p * opts.blob_slots)),
        blob_used=z((p * opts.blob_slots,), b),
        blob_len=z((p * opts.blob_slots,)),
        blob_gen=z((p * opts.blob_slots,)),
        blob_fail=z((p,), b), blob_budget_fail=z((p,), b),
        n_blob_alloc=z((p,)), n_blob_free=z((p,)),
        n_blob_remote=z((p,)), n_blob_moved=z((p,)),
        world_bits=z((p,)),
        type_state=type_state,
    )


def geometry_descriptor(program: Program, opts: RuntimeOptions):
    """The layout facts a snapshot carries so that a restore can re-lay
    out the state into a different geometry (serialise.py): everything
    that sizes a tensor without changing the program's structure.
    Cohorts are in declaration order (behaviour ids depend on it, and
    the structural fingerprint covers it); a slot is the actor's
    identity whatever the capacity. The JAX package's descriptor for
    the same program and options is the same dict, so snapshots cross
    between the packages."""
    assert program.frozen
    return {
        "shards": program.shards,
        "n_local": program.n_local,
        "total": program.total,
        "mailbox_cap": opts.mailbox_cap,
        "msg_words": opts.msg_words,
        "trace_lanes": opts.trace_lanes,
        "spill_cap": opts.spill_cap,
        "mute_slots": opts.mute_slots,
        "blob_slots": opts.blob_slots,
        "blob_words": opts.blob_words,
        "analysis": opts.analysis,
        "trace_slots": opts.trace_slots if opts.tracing else 0,
        "analysis_events": (opts.analysis_events
                            if opts.analysis >= 3 else 0),
        "cohorts": [{
            "name": c.atype.__name__,
            "capacity": c.capacity,
            "local_capacity": c.local_capacity,
            "local_start": c.local_start,
            "host": bool(c.host),
            "msg_words": c.msg_words,
        } for c in program.cohorts],
    }

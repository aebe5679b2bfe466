"""Actor garbage collection of the PyTorch port: whole-world reachability
tracing (the counterpart of ``ponyc_tpu/runtime/gc.py``).

≙ the reference's ORCA reference counting (src/libponyrt/gc/gc.c) and its
cycle detector (gc/cycle.c) in one synchronous trace: the actor world is
one address space of columns, so the collector marks everything reachable
from the roots with a vectorised frontier, one masked scatter a hop, to a
fixpoint. A cycle of actors that no root reaches is never marked.

Roots: host-pinned actors (Runtime.spawn pins, Runtime.release unpins),
actors with queued or spilled messages, muted actors, host-cohort rows,
and what the host holds (refs in host-actor state and in queued
injections, passed per collection). Edges: the Ref fields of live actors
and the Ref arguments of every queued or spilled message.

A hop cap (`gc_max_iters`, 0 = none) bounds pathological chains; a trace
that stops at the cap before its fixpoint collects nothing (always safe).
The same pass sweeps the device blob pool (≙ an actor's heap dying with
it, mem/heap.c): a slot survives where a surviving actor's Blob field, a
queued or spilled message's Blob argument, or the host holds its handle
(with the slot's current generation).

The JAX package runs this as one jitted function with a device-side
`while_loop`; the reference has no Pallas kernel here, and the port runs
it as plain torch ops between windows on the state's device. The mark
loop reads its "changed" flags to the host a batch of hops at a time (a
hop past the fixpoint changes nothing, since the marks only grow), so a
trace of a thousand hops pays a few dozen synchronisations, and reports
the JAX package's `iters` and `converged`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import RuntimeOptions
from ..ops import pack
from ..parallel import comm
from ..parallel.mesh import (drive_shards, home_of, join, mesh_for,
                             ranks_of, shard_block, split)
from ..program import Program
from .state import RtState


def build_ref_arg_mask(program: Program, msg_words: int) -> np.ndarray:
    """Static [n_gids, msg_words] bool: which payload words of each
    behaviour's message are actor refs (≙ the per-type trace function the
    compiler emits, gentrace.c — here derived from Ref annotations)."""
    n = len(program.behaviour_table)
    mask = np.zeros((max(n, 1), msg_words), bool)
    for gid, bdef in enumerate(program.behaviour_table):
        off = 0
        for spec in bdef.arg_specs:
            if pack.is_ref(spec) and off < msg_words:
                mask[gid, off] = True
            off += pack.spec_width(spec)
    return mask


def _ref_fields(cohort):
    return [f for f, spec in cohort.atype.field_specs.items()
            if pack.is_ref(spec)]


def build_blob_arg_mask(program: Program, msg_words: int,
                        mode: str | None = None) -> np.ndarray:
    """Static [n_gids, msg_words] bool: which payload words of each
    behaviour's message are blob handles (the Blob twin of
    build_ref_arg_mask). `mode` narrows to one capability ("iso" or
    "val"); None = both."""
    n = len(program.behaviour_table)
    mask = np.zeros((max(n, 1), msg_words), bool)
    for gid, bdef in enumerate(program.behaviour_table):
        off = 0
        for spec in bdef.arg_specs:
            if (pack.is_blob(spec) and off < msg_words
                    and (mode is None or spec.mode == mode)):
                mask[gid, off] = True
            off += pack.spec_width(spec)
    return mask


def _blob_fields(cohort):
    return [f for f, spec in cohort.atype.field_specs.items()
            if pack.is_blob(spec)]


def _mark(marks, idx, ok):
    """Set marks[idx] where `ok` and idx addresses a mark; `marks` has one
    more entry, last, that takes the rest."""
    n = marks.shape[0] - 1
    ok = ok & (idx >= 0) & (idx < n)
    marks[torch.where(ok, idx, n).long()] = True


def build_gc(program: Program, opts: RuntimeOptions, mesh=None):
    """The collection pass: gc(state, extra_roots [N] bool, blob_roots
    [shards * blob_slots] bool) → (state, (actors collected (an int32
    tensor), converged, iters, blob slots swept (an int32 tensor))).

    Written per shard, as the JAX package's local_gc: on a mesh each
    shard marks the global ids its live rows refer to, one psum a hop
    makes the marks mesh-wide (parallel/comm.py), and the pass runs on
    the shards of `mesh` this process drives (parallel/mesh.py; all on
    the state's device by default), taking a global state or a world
    resident on its shards and returning the latter, as the window
    does; the roots are global and each shard takes its block. The blob
    sweep stays shard-local: routing
    migrates a blob with its message, so a reachable handle rests on
    its pool's shard, and an off-shard one is unreadable anyway."""
    if not program.frozen:
        raise RuntimeError("finalize() the Program first")
    p = program.shards
    nl = program.n_local
    ntot = p * nl
    fh = program.first_host_row
    cap = opts.mailbox_cap
    ref_mask_np = build_ref_arg_mask(program, opts.msg_words)
    any_ref_args = bool(ref_mask_np.any())
    n_gids = ref_mask_np.shape[0]
    max_iters = opts.gc_max_iters
    bsl = opts.blob_slots
    blob_mask_np = build_blob_arg_mask(program, opts.msg_words)
    any_blob_args = bool(blob_mask_np.any())
    # Sweep wherever the pool is on and some cohort can allocate or carry
    # handles: a program whose handles never leave the allocating
    # behaviour makes every unfreed blob garbage by construction.
    sweep_blobs = bsl > 0 and (any_blob_args
                               or any(_blob_fields(c)
                                      for c in program.cohorts)
                               or any(c.blob_sites for c in program.cohorts))

    def arg_planes(words, tgt_ok, mask):
        """(payload word index, [E] bool) where a message's word is an
        argument that `mask` marks."""
        gid = words[0]
        g = gid.clamp(0, n_gids - 1).long()
        inr = (gid >= 0) & (gid < n_gids) & tgt_ok
        for w in range(min(words.shape[0] - 1, opts.msg_words)):
            yield w, mask[g, w] & inr

    def shard_gc(st: RtState, extra_roots, blob_roots, shard: int = 0):
        dev = st.head.device
        base = shard * nl
        occ = st.tail - st.head
        rows = torch.arange(nl, dtype=torch.int32, device=dev)
        rmask = torch.as_tensor(ref_mask_np, device=dev)
        bmask = torch.as_tensor(blob_mask_np, device=dev)

        def glob(marks):
            """This shard's rows of the mesh-wide marks."""
            if p > 1:
                marks = (yield comm.psum(marks[:ntot].to(torch.int32))) > 0
            return marks[base:base + nl]

        # --- roots, and the targets of in-flight (spilled) messages
        # (receiver-spill targets are rows here, route-spill targets
        # global ids) ---
        marks0 = torch.zeros((ntot + 1,), dtype=torch.bool, device=dev)
        marks0[base:base + nl] = (st.pinned | extra_roots | (occ > 0)
                                  | st.muted | (rows >= fh))
        for tgt, words in ((torch.where(st.dspill_tgt >= 0,
                                        st.dspill_tgt + base, -1),
                            st.dspill_words),
                           (st.rspill_tgt, st.rspill_words)):
            _mark(marks0, tgt, tgt >= 0)
            if any_ref_args:
                for w, rm in arg_planes(words, tgt >= 0, rmask):
                    _mark(marks0, words[1 + w], rm)

        # --- edges: Ref fields, and Ref args of queued messages ---
        field_edges = [
            (ch.local_start, ch.local_stop,
             st.type_state[ch.atype.__name__][f].to(torch.int32))
            for ch in program.device_cohorts for f in _ref_fields(ch)]
        mb_edges, mb_blobs = [], []      # (s0, s1, [rows] refs / handles)
        if any_ref_args or (sweep_blobs and any_blob_args):
            for ch in program.cohorts:
                cbuf = st.buf[ch.atype.__name__]
                if cbuf.shape[1] <= 1:
                    continue             # gid-only mailboxes: no refs
                s0, s1 = ch.local_start, ch.local_stop
                for ci in range(cap):
                    valid = ((ci - st.head[s0:s1]) % cap) < occ[s0:s1]
                    gid = cbuf[ci, 0]
                    g = gid.clamp(0, n_gids - 1).long()
                    inr = valid & (gid >= 0) & (gid < n_gids)
                    for w in range(cbuf.shape[1] - 1):
                        if any_ref_args:
                            mb_edges.append((s0, s1, torch.where(
                                rmask[g, w] & inr, cbuf[ci, 1 + w], -1)))
                        if sweep_blobs and any_blob_args:
                            mb_blobs.append(torch.where(
                                bmask[g, w] & inr, cbuf[ci, 1 + w], -1))

        def propagate(live):
            """One hop: live rows, and every target a live source refers
            to."""
            marks = torch.zeros((ntot + 1,), dtype=torch.bool, device=dev)
            marks[base:base + nl] = live
            for s0, s1, tgt in field_edges:
                _mark(marks, tgt, live[s0:s1] & st.alive[s0:s1])
            for s0, s1, tgt in mb_edges:
                _mark(marks, tgt, live[s0:s1])
            return marks

        # The trace to its fixpoint (or the hop cap), its flags read a
        # batch of hops at a time (mesh-wide: every shard reads the same).
        live = yield from glob(marks0)
        iters, changed, batch = 0, True, 4
        while changed and (not max_iters or iters < max_iters):
            n = batch if not max_iters else min(batch, max_iters - iters)
            flags = []
            for _ in range(n):
                new_live = live | (yield from glob(propagate(live)))
                ch = (new_live != live).any()
                if p > 1:
                    ch = (yield comm.psum(ch.to(torch.int32))) > 0
                flags.append(ch)
                live = new_live
            fl = torch.stack(flags).cpu().numpy()
            if not fl.all():
                iters += int(np.argmin(fl)) + 1
                changed = False
            else:
                iters += n
            batch = min(2 * batch, 64)
        converged = not changed

        # --- collect, only on a converged trace (≙ cycle.c `collect`) ---
        dead = st.alive & ~live & (rows < fh)
        if not converged:
            dead = torch.zeros_like(dead)
        n_dead = dead.sum(dtype=torch.int32)

        # --- blob sweep: a slot stays allocated where a surviving actor's
        # Blob field, a queued or spilled message's Blob argument, or the
        # host holds a handle carrying its current generation ---
        n_swept = torch.zeros((), dtype=torch.int32, device=dev)
        blob = {}
        if sweep_blobs:
            alive2 = st.alive & ~dead
            bm = torch.zeros((bsl + 1,), dtype=torch.bool, device=dev)
            bm[:bsl] = blob_roots
            bbase = shard * bsl

            def bmark(handles, ok):
                hl = pack.blob_slot(handles) - bbase
                good = ok & (handles >= 0) & (hl >= 0) & (hl < bsl)
                hc = torch.where(good, hl, 0).long()
                good = good & (st.blob_gen[hc] == pack.blob_gen_of(handles))
                _mark(bm, hl, good)

            for ch in program.device_cohorts:
                s0, s1 = ch.local_start, ch.local_stop
                for f in _blob_fields(ch):
                    col = st.type_state[ch.atype.__name__][f]
                    bmark(col.to(torch.int32), alive2[s0:s1])
            if any_blob_args:
                for tgt, words in ((st.dspill_tgt, st.dspill_words),
                                   (st.rspill_tgt, st.rspill_words)):
                    for w, bmm in arg_planes(words, tgt >= 0, bmask):
                        bmark(words[1 + w], bmm)
                for plane in mb_blobs:
                    bmark(plane, plane >= 0)
            keep = bm[:bsl]
            swept = st.blob_used & ~keep
            n_swept = swept.sum(dtype=torch.int32)
            blob = dict(blob_used=st.blob_used & keep,
                        blob_len=torch.where(swept, 0, st.blob_len),
                        n_blob_free=st.n_blob_free + n_swept.reshape(1))

        st2 = dataclasses.replace(
            st,
            head=torch.where(dead, st.tail, st.head),
            alive=st.alive & ~dead,
            muted=st.muted & ~dead,
            mute_refs=torch.where(dead[None, :], -1, st.mute_refs),
            mute_age=torch.where(dead, 0, st.mute_age),
            mute_ovf=st.mute_ovf & ~dead,
            pinned=st.pinned & ~dead,
            pressured=st.pressured & ~dead,
            n_collected=st.n_collected + n_dead.reshape(1),
            last_error=torch.where(dead, 0, st.last_error),
            last_error_loc=torch.where(dead, 0, st.last_error_loc),
            **blob)
        if p > 1:
            n_dead = yield comm.psum(n_dead)
            n_swept = yield comm.psum(n_swept)
        return st2, (n_dead, converged, iters, n_swept)

    def gc(st: RtState, extra_roots, blob_roots):
        m = mesh_for(st, p, mesh)
        home = home_of(st)
        shards = split(st, m)
        outs = drive_shards(m, [
            shard_gc(s, shard_block(extra_roots, r, p).to(s.head.device),
                     shard_block(blob_roots, r, p).to(s.head.device), r)
            for s, r in zip(shards, ranks_of(m))])
        return join([o[0] for o in outs], m, home), outs[0][1]

    return gc

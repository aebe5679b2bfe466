"""World serialisation of the PyTorch port: checkpoint, restore and re-lay
out a running actor world (the counterpart of ``ponyc_tpu/serialise.py``,
whose snapshot format this module reads and writes unchanged).

≙ the reference's serialisation subsystem (src/libponyrt/gc/serialise.c:
`pony_serialise`/`pony_deserialise` flatten an object graph to an
offset-encoded buffer using per-type trace hooks; `packages/serialise`
is the stdlib surface). The reference has no built-in checkpoint/resume
(SURVEY.md §5) — serialisation is its building block, and here it is
promoted to a first-class feature: the *entire world* (device state,
mailboxes in flight, host-actor state, allocator freelists, counters) is
one snapshot, because the whole world is one struct of tensors.

Type identity is structural: a fingerprint over cohort order, field
specs and behaviour signatures (≙ the descriptor table registered at
pony_start, start.c:286-292, which makes serialised ids stable between
runs of the same binary). Restoring into a runtime whose fingerprint
differs is an error. GEOMETRY (capacities, mailbox/spill/blob sizes) is
not part of identity: a snapshot restores into a different layout by
re-laying-out the state's tensors (see `restore` below).

Snapshots are taken at host boundaries with no window in flight, where
the device state is quiescent-consistent — exactly like serialising
between behaviours in Pony. `capture` copies every tensor into host
memory the snapshot owns (pinned buffers on CUDA, waited for through
the run loop's interruptible wait, so that a wedged card trips the
watchdog instead of hanging the checkpoint).

Format v3: one .npz holding every state array BY NAME (``st.<field>``,
``st.buf.<Type>``, ``st.ts.<Type>.<field>``, queue lanes ``q.*``) plus
a JSON header carrying the geometry descriptor, host-side runtime
state, and a per-array + header CRC32 table. Names and header fields are
the JAX package's letter for letter, so a snapshot written by one
package restores in the other. Writes go tmp → flush → fsync → atomic
rename, so a crash mid-flush can only ever leave a garbage ``.tmp``
beside an intact previous snapshot, never a torn snapshot under the real
name. `Checkpointer` (below) keeps a bounded ring of such snapshots on a
cadence, driven by the run loop.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import hashlib
import json
import os
import queue as _queue
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .errors import ERROR_CODES

# v2 adds the host fast-lane queue (fastq_tgt/fastq_words) to v1.
# v3 stores arrays BY NAME with a geometry descriptor and per-array +
# header checksums, so snapshots (a) survive layout-preserving
# refactors of RtState field order, (b) restore into a DIFFERENT
# geometry, (c) detect truncation/bit-rot loudly, and (d) carry the
# telemetry state (trace side-lanes + span ring, profiler lanes, error
# counters) — a restored world keeps its telemetry. v1/v2 snapshots
# restore through the legacy index path (same geometry only, telemetry
# lanes as saved); UNKNOWN future versions raise SnapshotFormatError,
# never a silent partial restore.
FORMAT_VERSION = 3
_ACCEPTED_FORMATS = (1, 2, 3)

_CKPT_SUFFIX = ".ckpt"


class FingerprintMismatch(RuntimeError):
    """Snapshot was taken by a structurally different program."""


class SnapshotFormatError(FingerprintMismatch):
    """Snapshot written by an unknown FUTURE format version — refuse
    loudly instead of silently dropping lanes we cannot understand."""

    code = ERROR_CODES["SnapshotFormatError"]


class SnapshotCorruptError(RuntimeError):
    """Snapshot failed checksum/structure verification (truncated file,
    bit flip, torn write) — the coded replacement for a raw numpy/zlib
    traceback; the supervisor falls back past these."""

    code = ERROR_CODES["SnapshotCorruptError"]


class SnapshotGeometryError(RuntimeError):
    """A geometry-changing restore found occupancy that does not fit
    the new layout (live actor above the new capacity, mailbox deeper
    than the new ring, more live blobs than pool slots, ...)."""

    code = ERROR_CODES["SnapshotGeometryError"]


def fingerprint(program, geometry: bool = False) -> str:
    """Structural hash of the program (≙ the per-type descriptor table
    identity; serialise.c relies on same-binary type ids): cohort order,
    host placement, field specs, behaviour signatures. `geometry=True`
    additionally folds in capacities and the shard count — the v2-era
    identity, kept for exact-layout assertions."""
    h = hashlib.sha256()
    for cohort in program.cohorts:
        atype = cohort.atype
        h.update(atype.__name__.encode())
        if geometry:
            h.update(str(cohort.capacity).encode())
        h.update(b"H" if cohort.host else b"D")
        for fname, spec in sorted(atype.field_specs.items()):
            h.update(fname.encode())
            h.update(spec.__name__.encode())
        for b in cohort.behaviours:
            h.update(b.name.encode())
            h.update(str(b.global_id).encode())
            for spec in b.arg_specs:
                h.update(spec.__name__.encode())
    # NOTE: geometry=True reproduces the v1/v2 fingerprint byte-for-byte
    # (capacity folded per cohort, nothing else) so legacy snapshots
    # still verify; the shard count rides the v3 geometry descriptor.
    return h.hexdigest()[:32]


def _opts_dict(opts) -> Dict[str, Any]:
    return dataclasses.asdict(opts)


# ---------------------------------------------------------------------------
# array naming: the v3 snapshot stores every RtState tensor by a stable
# name derived from the dataclass field (+ dict key), not by flatten
# index — the property the geometry-changing restore stands on.

def _named_state_arrays(state) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "type_state":
            for tname, fields in v.items():
                for fname, arr in fields.items():
                    out[f"st.ts.{tname}.{fname}"] = arr
        elif isinstance(v, dict):
            for tname, arr in v.items():
                out[f"st.{f.name}.{tname}"] = arr
        else:
            out[f"st.{f.name}"] = v
    return out


def _state_from_named(template, arrays: Dict[str, np.ndarray]):
    """Rebuild an RtState from named arrays into `template`'s exact
    geometry (the same-layout fast path): every template leaf must have
    a shape-identical named twin."""
    kw: Dict[str, Any] = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        if f.name == "type_state":
            kw[f.name] = {
                tname: {fname: _take(arrays, f"st.ts.{tname}.{fname}", arr)
                        for fname, arr in fields.items()}
                for tname, fields in v.items()}
        elif isinstance(v, dict):
            kw[f.name] = {tname: _take(arrays, f"st.{f.name}.{tname}", arr)
                          for tname, arr in v.items()}
        else:
            kw[f.name] = _take(arrays, f"st.{f.name}", v)
    return dataclasses.replace(template, **kw)


def _is_word_table(name: str) -> bool:
    from .runtime.state import PACKED_WORD_FIELDS
    return any(name == f"st.{f}" or name.startswith(f"st.{f}.")
               for f in PACKED_WORD_FIELDS)


def pack_snapshot_arrays(arrays: Dict[str, np.ndarray],
                         ) -> Dict[str, np.ndarray]:
    """The snapshot spelling of the mailbox bandwidth diet
    (ops/megakernel.py): every int32 word table (mailbox rings, spill
    words, trace lanes — state.PACKED_WORD_FIELDS) is stored as an
    int16 lane plane (`<name>.lo16`) plus an int32 escape plane
    (`<name>.esc32`). The codec is lossless, so a packed snapshot
    restores bit-identically; the escape plane compresses to almost
    nothing when payloads are narrow (savez_compressed). `_load_raw`
    decodes transparently — readers never see the planes."""
    from .ops.megakernel import pack_words_np
    out: Dict[str, np.ndarray] = {}
    for name, a in arrays.items():
        if _is_word_table(name) and a.dtype == np.int32:
            lo16, esc32 = pack_words_np(a)
            out[name + ".lo16"] = lo16
            out[name + ".esc32"] = esc32
        else:
            out[name] = a
    return out


def _unpack_snapshot_arrays(arrays: Dict[str, np.ndarray],
                            ) -> Dict[str, np.ndarray]:
    """Decode `pack_snapshot_arrays` planes back into int32 tables
    (no-op for unpacked snapshots — v3 stays one format, packing is an
    encoding choice per save)."""
    from .ops.megakernel import unpack_words_np
    out: Dict[str, np.ndarray] = {}
    for name, a in arrays.items():
        if name.endswith(".lo16"):
            base = name[:-len(".lo16")]
            esc = arrays.get(base + ".esc32")
            if esc is None:
                raise SnapshotCorruptError(
                    f"packed array {base!r} is missing its escape "
                    "plane")
            out[base] = unpack_words_np(a, esc)
        elif name.endswith(".esc32") and (name[:-len(".esc32")]
                                          + ".lo16") in arrays:
            continue
        else:
            out[name] = a
    return out


# State fields added after a snapshot format was already in the wild:
# a same-layout restore treats a missing named twin as zeros (cumulative
# telemetry starts over) instead of rejecting the whole snapshot.
_ZERO_IF_ABSENT = frozenset({"st.phase_cost"})


def _take(arrays, name, like):
    arr = arrays.get(name)
    if arr is None and name in _ZERO_IF_ABSENT:
        return torch.zeros(like.shape, dtype=like.dtype, device=like.device)
    if arr is None:
        raise FingerprintMismatch(f"snapshot is missing array {name!r}")
    if tuple(arr.shape) != tuple(like.shape):
        raise FingerprintMismatch(
            f"array {name!r} shape {tuple(arr.shape)} != "
            f"{tuple(like.shape)}")
    return torch.as_tensor(arr, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# capture / write / save

def _host_copies(rt, named: Dict[str, torch.Tensor]
                 ) -> Dict[str, np.ndarray]:
    """Every tensor of `named` as a numpy array that owns its bytes. On
    the CPU a tensor's numpy() is a view of the state, which the next
    window or a host blob op may change under the writer thread: copy.
    On CUDA every copy goes into a pinned host buffer, all enqueued
    without blocking; the run loop's interruptible wait then waits for
    them (`Runtime._wait_event`), so a wedged card trips the watchdog
    here instead of blocking inside the CUDA runtime."""
    if rt.device.type != "cuda":
        return {k: v.detach().numpy().copy() for k, v in named.items()}
    host = {}
    for k, v in named.items():
        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        h.copy_(v, non_blocking=True)
        host[k] = h
    ev = torch.cuda.Event()
    ev.record()
    rt._wait_event(ev)
    return {k: h.numpy() for k, h in host.items()}


def capture(rt) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Snapshot the world into host memory: (header, arrays). Splitting
    capture from `write_snapshot` lets the Checkpointer run the
    device→host copy on the run-loop thread while checksums and the
    fsync'd write ride the background writer thread. Call it from the
    run-loop thread only, with no window in flight (the run loop's
    boundary, or between runs)."""
    if rt.state is None:
        raise RuntimeError("runtime not started")
    from .runtime.state import geometry_descriptor
    arrays: Dict[str, np.ndarray] = _host_copies(
        rt, _named_state_arrays(rt.state))
    inject = list(rt._inject_q)
    w1 = 1 + rt.opts.msg_words + rt.opts.trace_lanes
    arrays["q.inject_tgt"] = np.asarray([t for t, _ in inject], np.int32)
    arrays["q.inject_words"] = (np.stack([w for _, w in inject])
                                if inject else np.zeros((0, w1), np.int32))
    # Fast-lane entries are (target, words[, trace_ctx]); the host
    # trace bookkeeping (tracing.Tracer) is per-process and not
    # snapshotted — a restored queue's messages deliver untraced.
    fast = list(rt._host_fast_q)
    arrays["q.fastq_tgt"] = np.asarray([e[0] for e in fast], np.int32)
    arrays["q.fastq_words"] = (np.stack([e[1] for e in fast])
                               if fast else np.zeros((0, w1), np.int32))
    header = {
        "format": FORMAT_VERSION,
        "time": time.time(),
        "fingerprint": fingerprint(rt.program),
        "fingerprint_geo": fingerprint(rt.program, geometry=True),
        "opts": _opts_dict(rt.opts),
        "geometry": geometry_descriptor(rt.program, rt.opts),
        # The header owns its values, as the arrays do: the writer
        # thread encodes it later, while the run loop goes on popping
        # free slots in place (`spawn`) and host behaviours may change
        # their state in place. So the free lists are copied, and the
        # host state goes through the JSON round trip the file will hold.
        "free": {k: list(v) for k, v in rt._free.items()},
        "host_state": json.loads(json.dumps(
            {str(k): v for k, v in rt._host_state.items()})),
        "totals": dict(rt.totals),
        "last_counters": dict(rt._last_counters),
        "steps_run": rt.steps_run,
        "exit_code": rt._exit_code,
        "noisy": rt._noisy,
        # Host-owned device-blob handles (GC roots for the blob sweep):
        # without them a restored world's first gc() would sweep blobs
        # the host legitimately holds.
        "host_blobs": sorted(rt._host_blobs),
        # Host-side telemetry residue, so a restored world keeps its
        # operational history.
        "host_errors": {str(k): v for k, v in rt._host_errors.items()},
        "host_error_locs": {str(k): v
                            for k, v in rt._host_error_locs.items()},
        "beh_host_runs": {str(k): int(v)
                          for k, v in rt._beh_host_runs.items()},
        "error_counts": [[cls, int(code), int(n)]
                         for (cls, code), n in sorted(
                             rt._error_counts.items())],
        "idle_boundaries": rt._idle_boundaries,
        "last_gc_step": rt._last_gc_step,
    }
    return header, arrays


def _crc(a: np.ndarray) -> int:
    """CRC32 of an array's C-order bytes (what the JAX package computes
    over `tobytes()`), read in place: no copy is made, and zlib lets go
    of the interpreter lock while it reads, so the writer thread does not
    stall the run loop's launches."""
    return zlib.crc32(memoryview(np.ascontiguousarray(a).reshape(-1))
                      .cast("B"))


def _write_npz(f, members: Dict[str, np.ndarray], compress: bool,
               halfway: Callable[[], None]) -> None:
    """The .npz `np.savez` (or `savez_compressed`) writes — a zip of one
    .npy member per array — written straight into the open file `f`,
    each array's bytes handed over in place. zipfile's CRC, zlib's
    deflate and the file writes all let go of the interpreter lock
    while they work, so the writer thread leaves the run loop's launches
    alone (np.savez copies every array with the lock held). `halfway`
    runs when half the members are written."""
    import zipfile
    from numpy.lib import format as npformat
    names = list(members)
    mode = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
    with zipfile.ZipFile(f, mode="w", compression=mode,
                         allowZip64=True) as zf:
        for i, name in enumerate(names):
            if i == len(names) // 2:
                halfway()
            a = np.ascontiguousarray(members[name])
            with zf.open(name + ".npy", "w", force_zip64=True) as out:
                npformat.write_array_header_1_0(
                    out, npformat.header_data_from_array_1_0(a))
                out.write(memoryview(a.reshape(-1)).cast("B"))


def write_snapshot(header: Dict[str, Any], arrays: Dict[str, np.ndarray],
                   path: str, compress: bool = True) -> int:
    """Checksum + serialise + durably write a captured snapshot:
    per-array CRC32s and a header CRC land in the file (corruption
    detection), the bytes are flushed AND fsync'd before the atomic
    rename (crash mid-flush leaves the previous snapshot intact).
    Returns the byte size written."""
    header = dict(header)
    header["arrays"] = {
        k: {"crc": _crc(a), "shape": list(a.shape), "dtype": str(a.dtype)}
        for k, a in arrays.items()}
    hbytes = json.dumps(header).encode()
    members = {"header": np.frombuffer(hbytes, np.uint8),
               "header_crc": np.asarray([zlib.crc32(hbytes)], np.uint32),
               **arrays}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        # A chaos point halfway through the members: the fault-injection
        # harness (testing.py) can SIGKILL the process mid-flush here,
        # proving the tmp+fsync+rename discipline means a torn write can
        # never surface under the real name.
        _write_npz(f, members, compress,
                   lambda: _chaos_point("snapshot-mid-flush"))
        f.flush()
        os.fsync(f.fileno())
        nbytes = f.tell()
    os.replace(tmp, path)
    try:        # directory durability: the rename itself must survive
        dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                      os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return nbytes


def _chaos_point(point: str) -> None:
    from . import testing
    testing.chaos.fire(point)


def save(rt, path: str, packed: bool = False) -> None:
    """Snapshot the full world to `path` (.npz). Call between runs/steps
    only (any queued-but-uninjected host sends are included).
    `packed=True` stores the word tables in the narrow-dtype form
    (pack_snapshot_arrays) — restore is transparent and bit-exact."""
    header, arrays = capture(rt)
    if packed:
        arrays = pack_snapshot_arrays(arrays)
    write_snapshot(header, arrays, path)


# ---------------------------------------------------------------------------
# loading / verification

_CORRUPT_EXC = (OSError, EOFError, ValueError, KeyError, zlib.error)


def _load_raw(path: str):
    """Open + structurally verify a snapshot: returns (header, arrays
    dict). Every member read is CRC-checked (the zip layer's own CRC
    plus our per-array table); any truncation/bit-flip raises the coded
    SnapshotCorruptError, an unknown future format SnapshotFormatError."""
    import zipfile
    try:
        with np.load(path, allow_pickle=False) as z:
            try:
                hbytes = bytes(z["header"])
                header = json.loads(hbytes.decode())
            except _CORRUPT_EXC + (json.JSONDecodeError,
                                   UnicodeDecodeError) as e:
                raise SnapshotCorruptError(
                    f"{path}: snapshot header unreadable ({e})") from e
            if "header_crc" in z.files:
                if int(z["header_crc"][0]) != zlib.crc32(hbytes):
                    raise SnapshotCorruptError(
                        f"{path}: header checksum mismatch")
            fmt = header.get("format")
            if fmt not in _ACCEPTED_FORMATS:
                raise SnapshotFormatError(
                    f"{path}: snapshot format {fmt} not in "
                    f"{_ACCEPTED_FORMATS} — written by a newer build? "
                    "(refusing to restore partially)")
            arrays: Dict[str, np.ndarray] = {}
            crcs = header.get("arrays", {})
            for name in z.files:
                if name in ("header", "header_crc"):
                    continue
                try:
                    arr = z[name]
                except _CORRUPT_EXC as e:
                    raise SnapshotCorruptError(
                        f"{path}: array {name!r} unreadable ({e})") from e
                meta = crcs.get(name)
                if meta is not None:
                    if (list(arr.shape) != meta["shape"]
                            or str(arr.dtype) != meta["dtype"]
                            or _crc(arr) != meta["crc"]):
                        raise SnapshotCorruptError(
                            f"{path}: array {name!r} failed its "
                            "checksum (bit flip or torn write)")
                arrays[name] = arr
            missing = set(crcs) - set(arrays)
            if missing:
                raise SnapshotCorruptError(
                    f"{path}: snapshot truncated — missing arrays "
                    f"{sorted(missing)[:4]}")
            # Narrow-dtype stored snapshots (save(packed=True)) decode
            # here, AFTER the CRC table verified the stored planes —
            # every reader downstream sees plain int32 word tables.
            return header, _unpack_snapshot_arrays(arrays)
    except (zipfile.BadZipFile, *_CORRUPT_EXC) as e:
        if isinstance(e, (SnapshotCorruptError, SnapshotFormatError)):
            raise
        if isinstance(e, OSError) and not os.path.exists(path):
            raise
        raise SnapshotCorruptError(
            f"{path}: not a readable snapshot ({e})") from e


def verify_snapshot(path: str) -> Dict[str, Any]:
    """Full integrity check (header + every array CRC); returns the
    header. Raises SnapshotCorruptError / SnapshotFormatError."""
    header, _arrays = _load_raw(path)
    return header


# ---------------------------------------------------------------------------
# restore

def restore(rt, path: str, opts=None) -> None:
    """Load a snapshot into a started runtime with the same program
    STRUCTURE (actor classes, behaviours, declaration order).

    The runtime's geometry — per-cohort capacity, mailbox_cap,
    spill_cap, blob_slots/words, mesh_shards, telemetry lane sizes —
    may differ from the snapshot's: the SoA arrays are re-laid-out
    (actor ids remapped slot-for-slot, mailbox rings re-rung, parked
    spill entries re-queued through the inject lane at their FIFO
    priority, blob handles re-encoded), with occupancy validated
    against the new layout (SnapshotGeometryError when it cannot fit).
    `opts` is an optional cross-check: the RuntimeOptions the TARGET
    runtime is expected to be running (≙ spelling the new geometry at
    the restore site); a mismatch with rt.opts raises ValueError."""
    if rt.state is None:
        raise RuntimeError("call start() before restore()")
    if opts is not None:
        # start() rewrites the "auto" fields (tuning.resolve /
        # resolve_quiesce_interval) — compare everything else.
        auto = {"quiesce_interval", "delivery", "pallas", "pallas_fused"}
        a = {k: v for k, v in _opts_dict(opts).items() if k not in auto}
        b = {k: v for k, v in _opts_dict(rt.opts).items()
             if k not in auto}
        if a != b:
            raise ValueError(
                "restore(opts=...) names a different geometry than the "
                "target runtime was started with — build the Runtime "
                "with those options first (geometry is fixed at "
                "start())")
    header, arrays = _load_raw(path)
    if header["format"] < 3:
        _restore_legacy(rt, header, arrays)
        return
    fp = fingerprint(rt.program)
    if header["fingerprint"] != fp:
        raise FingerprintMismatch(
            "snapshot was taken by a structurally different program "
            f"({header['fingerprint']} != {fp})")
    from .runtime.state import geometry_descriptor
    same_geometry = (header["geometry"]
                     == geometry_descriptor(rt.program, rt.opts))
    if same_geometry:
        rt.state = _state_from_named(rt.state, arrays)
        _restore_queues_exact(rt, arrays)
        _restore_host_side(rt, header)
        rt._free = {k: [int(x) for x in v]
                    for k, v in header["free"].items()}
    else:
        _restore_relayout(rt, header, arrays)


def _restore_queues_exact(rt, arrays) -> None:
    rt._inject_q.clear()
    tgts, words = arrays["q.inject_tgt"], arrays["q.inject_words"]
    for i in range(len(tgts)):
        rt._inject_q.append((int(tgts[i]), words[i]))
    rt._host_fast_q.clear()
    ftgts, fwords = arrays["q.fastq_tgt"], arrays["q.fastq_words"]
    for i in range(len(ftgts)):
        rt._host_fast_q.append((int(ftgts[i]), fwords[i], None))


def _restore_host_side(rt, header) -> None:
    import collections
    rt._host_state = {int(k): v for k, v in header["host_state"].items()}
    rt._host_blobs = set(int(h) for h in header.get("host_blobs", ()))
    rt.totals.clear()
    rt.totals.update(header["totals"])
    rt._last_counters = dict(header["last_counters"])
    rt.steps_run = int(header["steps_run"])
    rt._exit_code = int(header["exit_code"])
    rt._noisy = int(header["noisy"])
    rt._host_errors = {int(k): v
                       for k, v in header.get("host_errors", {}).items()}
    rt._host_error_locs = {
        int(k): v for k, v in header.get("host_error_locs", {}).items()}
    rt._beh_host_runs = collections.Counter(
        {int(k): int(v)
         for k, v in header.get("beh_host_runs", {}).items()})
    rt._error_counts = collections.Counter(
        {(cls, int(code)): int(n)
         for cls, code, n in header.get("error_counts", ())})
    rt._idle_boundaries = int(header.get("idle_boundaries", 0))
    rt._last_gc_step = int(header.get("last_gc_step", 0))


def _restore_legacy(rt, header, arrays) -> None:
    """v1/v2 snapshots: arrays stored by flatten INDEX — restorable
    into the exact same geometry only (the pre-v3 contract). v1
    restores with an empty fast queue; telemetry lanes restore as
    saved (zero-length when the snapshot was taken without them)."""
    fp = fingerprint(rt.program, geometry=True)
    if header["fingerprint"] != fp:
        raise FingerprintMismatch(
            "v<3 snapshot was taken by a structurally different program "
            f"or geometry ({header['fingerprint']} != {fp}; legacy "
            "snapshots cannot re-layout)")
    flat = _legacy_leaves(rt.state)
    if header["n_state_leaves"] != len(flat):
        raise FingerprintMismatch("state leaf count mismatch")
    new_flat = []
    for i, leaf in enumerate(flat):
        arr = arrays[f"state_{i}"]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise FingerprintMismatch(
                f"state leaf {i} shape {arr.shape} != {tuple(leaf.shape)} "
                "(options geometry must match a legacy snapshot)")
        new_flat.append(torch.as_tensor(arr, dtype=leaf.dtype,
                                        device=leaf.device))
    rt.state = _legacy_state(rt.state, new_flat)
    rt._inject_q.clear()
    tgts, words = arrays["inject_tgt"], arrays["inject_words"]
    for i in range(len(tgts)):
        rt._inject_q.append((int(tgts[i]), words[i]))
    rt._host_fast_q.clear()
    if "fastq_tgt" in arrays:      # absent in pre-fast-lane snapshots
        ftgts, fwords = arrays["fastq_tgt"], arrays["fastq_words"]
        for i in range(len(ftgts)):
            rt._host_fast_q.append((int(ftgts[i]), fwords[i], None))
    _restore_host_side(rt, header)
    rt._free = {k: [int(x) for x in v] for k, v in header["free"].items()}



def _legacy_leaves(state) -> List[torch.Tensor]:
    """The state's tensors in the order the v1/v2 writers numbered them:
    the JAX package's pytree flatten of RtState (fields in declaration
    order, dict keys sorted, type_state's nested dicts too)."""
    out: List[torch.Tensor] = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, dict):
            for k in sorted(v):
                if isinstance(v[k], dict):
                    out += [v[k][k2] for k2 in sorted(v[k])]
                else:
                    out.append(v[k])
        else:
            out.append(v)
    return out


def _legacy_state(template, flat: List[torch.Tensor]):
    """Rebuild `template`'s RtState from tensors in `_legacy_leaves`
    order."""
    it = iter(flat)
    kw: Dict[str, Any] = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        if isinstance(v, dict):
            kw[f.name] = {
                k: ({k2: next(it) for k2 in sorted(v[k])}
                    if isinstance(v[k], dict) else next(it))
                for k in sorted(v)}
        else:
            kw[f.name] = next(it)
    return dataclasses.replace(template, **kw)


# ---------------------------------------------------------------------------
# geometry-changing restore (the re-layout pass)

class _OldLayout:
    """Vectorised slot/gid/col math for the SNAPSHOT's geometry,
    reconstructed from the header's descriptor (mirrors program.Cohort
    without needing the old Program object)."""

    def __init__(self, g: Dict[str, Any]):
        self.shards = int(g["shards"])
        self.n_local = int(g["n_local"])
        self.total = int(g["total"])
        self.mailbox_cap = int(g["mailbox_cap"])
        self.msg_words = int(g["msg_words"])
        self.trace_lanes = int(g["trace_lanes"])
        self.spill_cap = int(g["spill_cap"])
        self.mute_slots = int(g["mute_slots"])
        self.blob_slots = int(g["blob_slots"])
        self.blob_words = int(g["blob_words"])
        self.cohorts = g["cohorts"]

    def slot_to_gid(self, co, slot):
        slot = np.asarray(slot, np.int64)
        shard = slot % self.shards
        row = int(co["local_start"]) + slot // self.shards
        return shard * self.n_local + row

    def slot_to_col(self, co, slot):
        slot = np.asarray(slot, np.int64)
        shard = slot % self.shards
        return (shard * int(co["local_capacity"])
                + slot // self.shards)



def _to_device(like, v, device):
    """Host arrays of the re-laid-out state as tensors of `like`'s dtypes
    on the runtime's device."""
    if isinstance(like, dict):
        return {k: _to_device(like[k], v[k], device) for k in like}
    return torch.as_tensor(np.ascontiguousarray(v), dtype=like.dtype,
                           device=device)


def _restore_relayout(rt, header, Z: Dict[str, np.ndarray]) -> None:
    """Re-lay-out a v3 snapshot into the target runtime's (different)
    geometry. The actor identity that survives is the cohort SLOT
    (spawn order); everything derived from layout — global ids, state
    columns, ring positions, spill parking, blob handles — is remapped.
    Parked spill entries re-enter through the host inject lane, which
    delivers at a strictly higher priority than fresh sends
    (delivery.py level 1 < emission levels), so per-edge FIFO is
    preserved exactly; the differential corpus crosses this boundary
    (tests/test_durability.py)."""
    from .interop import state_to_numpy
    from .ops import pack
    from .runtime import gc as gc_mod
    from .runtime.state import N_PHASES, QW_BUCKETS, init_state

    prog, opts = rt.program, rt.opts
    old = _OldLayout(header["geometry"])
    p_old, nl_old, n_old = old.shards, old.n_local, old.total
    p_new, n_new = prog.shards, prog.total

    old_cohorts = {c["name"]: c for c in old.cohorts}
    if [c["name"] for c in old.cohorts] != \
            [c.atype.__name__ for c in prog.cohorts]:
        raise FingerprintMismatch("cohort order/name mismatch")
    for c in prog.cohorts:
        if old_cohorts[c.atype.__name__]["msg_words"] != c.msg_words:
            raise SnapshotGeometryError(
                f"cohort {c.atype.__name__} message width changed "
                f"({old_cohorts[c.atype.__name__]['msg_words']} -> "
                f"{c.msg_words}): msg_words must cover the cohort's "
                "widest behaviour on both sides")

    alive_o = Z["st.alive"]
    head_o = Z["st.head"].astype(np.int64)
    tail_o = Z["st.tail"].astype(np.int64)

    # ---- actor id map (slot-preserving) + occupancy-fit validation ----
    gid_map = np.full((n_old,), -1, np.int64)
    kept_pairs: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    for c in prog.cohorts:
        co = old_cohorts[c.atype.__name__]
        slots = np.arange(int(co["capacity"]), dtype=np.int64)
        old_gids = old.slot_to_gid(co, slots)
        keep = slots < c.capacity
        dropped = old_gids[~keep]
        if dropped.size:
            occ_d = tail_o[dropped] - head_o[dropped]
            bad = alive_o[dropped] | (occ_d != 0)
            if bad.any():
                raise SnapshotGeometryError(
                    f"cohort {c.atype.__name__}: slot "
                    f"{int(slots[~keep][np.argmax(bad)])} is live "
                    f"(or has queued mail) but the new capacity is "
                    f"{c.capacity} — occupancy does not fit")
        new_gids = np.asarray(c.slot_to_gid(slots[keep]), np.int64)
        gid_map[old_gids[keep]] = new_gids
        kept_pairs[c.atype.__name__] = (slots[keep], old_gids[keep],
                                        new_gids)

    def map_gids(v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, np.int64)
        out = v.copy()
        inw = (v >= 0) & (v < n_old)
        out[inw] = gid_map[v[inw]]
        return out

    # ---- blob slot/handle map ----
    bs_old, bs_new = old.blob_slots, opts.blob_slots
    bw_old, bw_new = old.blob_words, opts.blob_words
    nbs_old, nbs_new = p_old * bs_old, p_new * bs_new
    blob_slot_map = np.full((max(nbs_old, 1),), -1, np.int64)
    used_o = Z.get("st.blob_used", np.zeros((nbs_old,), bool))
    gen_o = Z.get("st.blob_gen", np.zeros((nbs_old,), np.int32))
    if bs_old and used_o.any():
        if bs_new == 0:
            raise SnapshotGeometryError(
                "snapshot holds live blobs but the target runtime has "
                "blob_slots=0")
        len_o = Z["st.blob_len"]
        if bw_new < bw_old and (len_o[used_o] > bw_new).any():
            raise SnapshotGeometryError(
                f"a live blob is longer ({int(len_o[used_o].max())} "
                f"words) than the new blob_words={bw_new}")
        fill = np.zeros((p_new,), np.int64)
        for g in np.flatnonzero(used_o):
            want = (g // bs_old) % p_new
            shard = next((s for s in [want] + list(range(p_new))
                          if fill[s] < bs_new), None)
            if shard is None:
                raise SnapshotGeometryError(
                    f"{int(used_o.sum())} live blobs do not fit "
                    f"{p_new}x{bs_new} pool slots")
            blob_slot_map[g] = shard * bs_new + fill[shard]
            fill[shard] += 1

    def map_handles(h: np.ndarray) -> np.ndarray:
        h = np.asarray(h, np.int64)
        out = h.copy()
        pos = h >= 0
        if not pos.any():
            return out
        slots = h[pos] & ((1 << pack.BLOB_GEN_SHIFT) - 1)
        gens = (h[pos] >> pack.BLOB_GEN_SHIFT) & pack.BLOB_GEN_MASK
        ok = slots < max(nbs_old, 1)
        slots_c = np.where(ok, slots, 0)
        valid = (ok & used_o[slots_c]
                 & ((gen_o[slots_c] & pack.BLOB_GEN_MASK) == gens))
        ns = blob_slot_map[slots_c]
        # A stale/invalid handle maps to null (-1): it would have read
        # null in the old world too (generation mismatch), so this is
        # semantics-preserving, never data loss.
        out[pos] = np.where(valid & (ns >= 0),
                            (gens << pack.BLOB_GEN_SHIFT) | ns, -1)
        return out

    # ---- payload-word remap masks (ref/blob argument positions) ----
    mw_wide = max(old.msg_words, opts.msg_words)
    ref_mask = gc_mod.build_ref_arg_mask(prog, mw_wide)
    blob_mask = gc_mod.build_blob_arg_mask(prog, mw_wide)

    def remap_payload(words2d: np.ndarray) -> np.ndarray:
        """[M, 1+W] message block: word0 = behaviour gid; remap every
        ref-typed and blob-typed argument word in place."""
        if words2d.size == 0:
            return words2d
        g = words2d[:, 0].astype(np.int64)
        w = words2d.shape[1] - 1
        ok = (g >= 0) & (g < ref_mask.shape[0])
        gc_ = np.where(ok, g, 0)
        rm = ref_mask[gc_, :w] & ok[:, None]
        bm = blob_mask[gc_, :w] & ok[:, None]
        pay = words2d[:, 1:]
        if rm.any():
            pay[rm] = map_gids(pay[rm]).astype(pay.dtype)
        if bm.any():
            pay[bm] = map_handles(pay[bm]).astype(pay.dtype)
        words2d[:, 1:] = pay
        return words2d

    # ---- fresh template in the NEW geometry, as writable host arrays
    tmpl = init_state(prog, opts, "cpu")
    st: Dict[str, Any] = state_to_numpy(tmpl)

    # per-actor scatter columns
    for name in ("alive", "muted", "mute_age", "mute_ovf", "pinned",
                 "pressured", "last_error", "last_error_loc"):
        dst = st[name].copy()
        src = Z[f"st.{name}"]
        for _slots, og, ng in kept_pairs.values():
            dst[ng] = src[og]
        st[name] = dst

    # ---- mailbox re-ring (head=0, tail=occ in the new ring) ----
    c_old, c_new = old.mailbox_cap, opts.mailbox_cap
    head_n = np.zeros((n_new,), np.int64)
    tail_n = np.zeros((n_new,), np.int64)
    new_bufs: Dict[str, np.ndarray] = {}
    new_qw: Dict[str, np.ndarray] = dict(st["qwait_enq"])
    new_tb: Dict[str, np.ndarray] = dict(st["trace_buf"])
    for c in prog.cohorts:
        name = c.atype.__name__
        co = old_cohorts[name]
        slots, og, ng = kept_pairs[name]
        occ = tail_o[og] - head_o[og]
        if (occ > c_new).any():
            raise SnapshotGeometryError(
                f"cohort {name}: a mailbox holds {int(occ.max())} "
                f"messages but the new mailbox_cap is {c_new}")
        tail_n[ng] = occ
        old_cols = old.slot_to_col(co, slots)
        new_cols = np.asarray(c.slot_to_col(slots), np.int64)
        buf_o = Z[f"st.buf.{name}"]
        buf_n = st["buf"][name].copy()
        qw_o = Z.get(f"st.qwait_enq.{name}")
        tb_o = Z.get(f"st.trace_buf.{name}")
        for k in range(min(c_old, int(occ.max(initial=0)))):
            m = occ > k
            if not m.any():
                break
            src = ((head_o[og[m]] + k) % c_old).astype(np.int64)
            oc, nc = old_cols[m], new_cols[m]
            block = buf_o[src, :, oc]            # [M, w1c]
            buf_n[k][:, nc] = remap_payload(block.copy()).T
            if name in new_qw and qw_o is not None:
                new_qw[name][k][nc] = qw_o[src, oc]
            if name in new_tb and tb_o is not None:
                new_tb[name][k][:, nc] = tb_o[src, :, oc].T
        new_bufs[name] = buf_n
    st["buf"] = new_bufs
    st["qwait_enq"] = new_qw
    st["trace_buf"] = new_tb
    st["head"] = head_n.astype(st["head"].dtype)
    st["tail"] = tail_n.astype(st["tail"].dtype)

    # ---- mute receiver-set re-slot (values are gids; position is
    # ref % K, which moves when ids move — collisions go conservative
    # via the sticky overflow bit, never an early unmute) ----
    k_new = opts.mute_slots
    mr_o = Z["st.mute_refs"]
    mr_n = st["mute_refs"]
    ovf = st["mute_ovf"]
    for g in np.flatnonzero((mr_o >= 0).any(axis=0)):
        ng = gid_map[g]
        if ng < 0:
            continue
        for r in mr_o[:, g]:
            if r < 0:
                continue
            nr = int(map_gids(np.asarray([r]))[0])
            if nr < 0:
                continue
            sl = nr % k_new
            if mr_n[sl, ng] in (-1, nr):
                mr_n[sl, ng] = nr
            else:
                ovf[ng] = True
    st["mute_refs"], st["mute_ovf"] = mr_n, ovf

    # ---- blob pool scatter ----
    if bs_old and bs_new:
        data_o = Z["st.blob_data"]
        len_o = Z["st.blob_len"]
        for g in np.flatnonzero(used_o):
            ns = int(blob_slot_map[g])
            w = min(bw_old, bw_new)
            st["blob_data"][:w, ns] = data_o[:w, g]
            st["blob_used"][ns] = True
            st["blob_len"][ns] = len_o[g]
            st["blob_gen"][ns] = gen_o[g]

    # ---- per-shard reductions: counter sums to shard 0, sticky flags
    # OR-broadcast, monotonic scalars max-broadcast ----
    for name in ("n_processed", "n_delivered", "n_rejected", "n_badmsg",
                 "n_deadletter", "n_mutes", "n_spawned", "n_destroyed",
                 "n_collected", "n_errors", "ev_dropped", "span_dropped",
                 "n_blob_alloc", "n_blob_free", "n_blob_remote",
                 "n_blob_moved"):
        dst = st[name].copy()
        dst[:] = 0
        dst[0] = int(Z[f"st.{name}"].astype(np.int64).sum())
        st[name] = dst
    for name in ("spill_overflow", "spawn_fail", "blob_fail",
                 "blob_budget_fail", "exit_flag"):
        st[name] = np.full_like(st[name], bool(Z[f"st.{name}"].any()))
    st["exit_code"] = np.full_like(
        st["exit_code"], int(Z["st.exit_code"].max(initial=0)))
    st["step_no"] = np.full_like(
        st["step_no"], int(Z["st.step_no"].max(initial=0)))
    st["span_next"] = np.full_like(
        st["span_next"], int(Z["st.span_next"].max(initial=0)))

    # ---- profiler matrices (cumulative; summed into shard 0 so
    # profile()'s mesh-sum is exact whatever the shard count) ----
    nb = len(prog.behaviour_table)
    nd = len(prog.device_cohorts)
    for name, cols in (("beh_runs", nb), ("beh_delivered", nb),
                       ("beh_rejected", nb), ("coh_mute_ticks", nd),
                       ("qwait_hist", nd * QW_BUCKETS),
                       ("phase_cost", N_PHASES)):
        src = Z.get(f"st.{name}")
        if st[name].size and src is not None and src.size:
            dst = st[name].copy()
            dst[:] = 0
            dst[:cols] = src.reshape(-1, cols).sum(0)
            st[name] = dst

    # world facts for the first restored tick: recompute from the
    # restored columns (route spill is empty by construction).
    bits = (1 * bool(st["pressured"].any())
            | 2 * bool(st["muted"].any()))
    st["world_bits"] = np.full_like(st["world_bits"], bits)

    # ---- type_state scatter (+ ref/blob field value remap) ----
    new_ts: Dict[str, Dict[str, np.ndarray]] = {}
    for c in prog.cohorts:
        name = c.atype.__name__
        if c.host:
            new_ts[name] = dict(st["type_state"].get(name, {}))
            continue
        slots, _og, _ng = kept_pairs[name]
        co = old_cohorts[name]
        old_cols = old.slot_to_col(co, slots)
        new_cols = np.asarray(c.slot_to_col(slots), np.int64)
        fields = {}
        for fname, spec in c.atype.field_specs.items():
            dst = st["type_state"][name][fname].copy()
            vals = Z[f"st.ts.{name}.{fname}"][old_cols]
            if pack.ref_target(spec) is not None:
                vals = map_gids(vals).astype(dst.dtype)
            elif pack.is_blob(spec):
                vals = map_handles(vals).astype(dst.dtype)
            dst[new_cols] = vals
            fields[fname] = dst
        new_ts[name] = fields
    st["type_state"] = new_ts

    # ---- parked spill entries -> the inject lane (level 1: after any
    # surviving spill — there is none — and BEFORE fresh emissions, so
    # per-edge FIFO holds; see delivery.py's level encoding) ----
    w1_new = 1 + opts.msg_words + opts.trace_lanes
    tl_old, tl_new = old.trace_lanes, opts.trace_lanes
    mw_old, mw_new = old.msg_words, opts.msg_words

    def convert_words(w: np.ndarray) -> np.ndarray:
        out = np.zeros((w1_new,), np.int32)
        out[0] = w[0]
        n = min(mw_old, mw_new)
        out[1:1 + n] = w[1:1 + n]
        if mw_new < mw_old and np.any(w[1 + mw_new:1 + mw_old]):
            raise SnapshotGeometryError(
                "a parked message's payload does not fit the new "
                f"msg_words={mw_new}")
        if tl_new and tl_old:
            out[-2:] = w[-2:]
        elif tl_new:
            out[-2], out[-1] = -1, 0
        block = out[None, :1 + mw_new].copy()
        out[:1 + mw_new] = remap_payload(block)[0]
        return out

    converted: List[Tuple[int, np.ndarray]] = []
    for pref in ("dspill", "rspill"):
        tgt_a = Z[f"st.{pref}_tgt"].astype(np.int64)
        words_a = Z[f"st.{pref}_words"]
        for pos in np.flatnonzero(tgt_a >= 0):
            if pref == "dspill":
                shard = pos // old.spill_cap
                old_gid = shard * nl_old + tgt_a[pos]
            else:
                old_gid = tgt_a[pos]
            ngid = (gid_map[old_gid]
                    if 0 <= old_gid < n_old else -1)
            if ngid < 0:
                rt.totals["deadletter_host"] += 1
                continue
            converted.append((int(ngid), convert_words(words_a[:, pos])))

    # ---- assemble + assign ----
    rt.state = dataclasses.replace(tmpl, **{
        k: _to_device(getattr(tmpl, k), v, rt.device)
        for k, v in st.items()})

    # queues: converted spill entries FIRST (they are older than any
    # host send still in the saved queues), then the saved inject/fast
    # lanes, all remapped to new ids/widths.
    rt._inject_q.clear()
    for e in converted:
        rt._inject_q.append(e)
    inj_t = Z["q.inject_tgt"].astype(np.int64)
    inj_w = Z["q.inject_words"]
    for i in range(len(inj_t)):
        t = int(map_gids(inj_t[i:i + 1])[0]) \
            if 0 <= inj_t[i] < n_old else int(inj_t[i])
        rt._inject_q.append((t, convert_words(inj_w[i])))
    rt._host_fast_q.clear()
    f_t = Z["q.fastq_tgt"].astype(np.int64)
    f_w = Z["q.fastq_words"]
    for i in range(len(f_t)):
        t = int(map_gids(f_t[i:i + 1])[0]) \
            if 0 <= f_t[i] < n_old else int(f_t[i])
        rt._host_fast_q.append((t, convert_words(f_w[i]), None))

    _restore_host_side(rt, header)
    # host ids moved: remap host-state keys, ref/blob field values and
    # the host-owned blob roots.
    hs = {}
    for aid, fields in rt._host_state.items():
        ng = int(map_gids(np.asarray([aid]))[0]) \
            if 0 <= aid < n_old else aid
        if ng < 0:
            continue
        cohort = prog.cohort_of(ng)
        f2 = dict(fields)
        for fname, spec in cohort.atype.field_specs.items():
            if fname not in f2:
                continue
            if pack.ref_target(spec) is not None:
                f2[fname] = int(map_gids(np.asarray([f2[fname]]))[0])
            elif pack.is_blob(spec):
                f2[fname] = int(map_handles(np.asarray([f2[fname]]))[0])
        hs[ng] = f2
    rt._host_state = hs
    rt._host_errors = {
        int(map_gids(np.asarray([k]))[0]): v
        for k, v in rt._host_errors.items()
        if 0 <= k < n_old and gid_map[k] >= 0}
    rt._host_error_locs = {
        int(map_gids(np.asarray([k]))[0]): v
        for k, v in rt._host_error_locs.items()
        if 0 <= k < n_old and gid_map[k] >= 0}
    rt._host_blobs = set(
        int(h) for h in map_handles(np.asarray(sorted(rt._host_blobs),
                                               np.int64))
        if h >= 0) if rt._host_blobs else set()

    # freelists: device cohorts rebuild from device truth (slots freed
    # by growth are discovered there); host cohorts re-derive from the
    # saved lists plus the grown slot range.
    saved_free = {k: [int(x) for x in v]
                  for k, v in header["free"].items()}
    for c in prog.cohorts:
        name = c.atype.__name__
        old_cap = int(old_cohorts[name]["capacity"])
        kept = [s for s in saved_free.get(name, []) if s < c.capacity]
        grown = list(range(c.capacity - 1, old_cap - 1, -1))
        rt._free[name] = grown + kept
    rt._freelist_key = None
    if any(not c.host for c in prog.cohorts):
        rt._rebuild_freelists()


# ---------------------------------------------------------------------------
# checkpoint ring

def checkpoint_file(prefix: str, seq: int) -> str:
    return f"{prefix}-{seq:08d}{_CKPT_SUFFIX}"


def list_checkpoints(prefix: str) -> List[Tuple[int, str]]:
    """(seq, path) for every ring file under `prefix`, oldest first."""
    out = []
    for p in _glob.glob(prefix + "-*" + _CKPT_SUFFIX):
        tail = p[len(prefix) + 1:-len(_CKPT_SUFFIX)]
        if tail.isdigit():
            out.append((int(tail), p))
    return sorted(out)


def newest_intact(prefix: str,
                  log: Optional[Callable[[str], None]] = None
                  ) -> Optional[str]:
    """Newest ring snapshot that passes full verification, falling back
    past corrupt/truncated ones (the supervisor's recovery source)."""
    for _seq, path in reversed(list_checkpoints(prefix)):
        try:
            verify_snapshot(path)
            return path
        except (SnapshotCorruptError, SnapshotFormatError) as e:
            if log is not None:
                log(f"skipping corrupt checkpoint {path}: {e}")
    return None


class Checkpointer:
    """Periodic crash-safe checkpointing for one runtime: the run loop
    calls `tick()` at host boundaries; when the cadence
    (`RuntimeOptions.checkpoint_every_s`) is due AND no window is in
    flight, `checkpoint()` captures the world (the device→host copy) on
    the run-loop thread and hands the write — checksums, the stored
    (undeflated) zip, fsync, atomic rename, ring rotation — to a background
    writer thread, so the run loop's cost is the capture alone
    (recorded in `stats()`)."""

    def __init__(self, rt):
        opts = rt.opts
        self.rt = rt
        self.every_s = float(opts.checkpoint_every_s or 0.0)
        self.prefix = (opts.checkpoint_path
                       or opts.analysis_path + _CKPT_SUFFIX)
        self.keep = int(opts.checkpoint_keep)
        existing = list_checkpoints(self.prefix)
        self.seq = (existing[-1][0] + 1) if existing else 0
        self._last_t = time.monotonic()
        self._lock = threading.Lock()
        self._stats = {
            "checkpoints": 0, "written": 0, "failures": 0, "skipped": 0,
            "capture_ms_last": 0.0, "capture_ms_total": 0.0,
            "write_ms_last": 0.0, "write_ms_total": 0.0,
            "bytes_last": 0, "last_path": None, "last_seq": None,
            "last_time": None, "last_verified": False,
        }
        self._q: _queue.Queue = _queue.Queue(maxsize=1)
        self._writer = threading.Thread(
            target=self._write_loop, name="pony-tpu-checkpointer",
            daemon=True)
        self._writer.start()

    # -- run-loop surface --
    def due(self) -> bool:
        """True when the cadence has come round and the checkpoint will
        capture. While the writer is busy and one snapshot already waits
        for it, a due checkpoint is skipped here and counted, and the
        cadence starts again: the run loop then keeps its next
        speculative window, which it gives up only for a boundary that
        really captures."""
        if self.every_s <= 0 \
                or time.monotonic() - self._last_t < self.every_s:
            return False
        if self._q.full():
            self._last_t = time.monotonic()
            with self._lock:
                self._stats["skipped"] += 1
            return False
        return True

    def tick(self, rt, in_flight: bool) -> bool:
        """Called at host boundaries: checkpoint when due and the world
        is at a quiescent-consistent point (no in-flight window).
        Returns True when a checkpoint was captured this boundary."""
        if not self.due() or in_flight:
            return False
        self.checkpoint(rt)
        return True

    def checkpoint(self, rt, force: bool = False) -> Optional[int]:
        """Capture now and queue the write; returns the sequence number
        (None when skipped because the writer is still busy with the
        previous snapshot — cadence pressure never stalls the loop).
        A skipped checkpoint captures nothing: the JAX package captures
        first and then drops the capture, which at a cadence shorter
        than the write copies the whole world (117 MiB for ubench at
        2^20 × 4) every cadence for nothing."""
        if not force and self._q.full():
            self._last_t = time.monotonic()
            with self._lock:
                self._stats["skipped"] += 1
            return None
        t0 = time.perf_counter()
        header, arrays = capture(rt)
        capture_ms = (time.perf_counter() - t0) * 1e3
        self._last_t = time.monotonic()
        with self._lock:
            seq = self.seq
            try:
                self._q.put_nowait((seq, header, arrays))
                queued = True
            except _queue.Full:
                if not force:
                    self._stats["skipped"] += 1
                    return None
                queued = False
            self.seq += 1
            self._stats["checkpoints"] += 1
            self._stats["capture_ms_last"] = capture_ms
            self._stats["capture_ms_total"] += capture_ms
        if not queued:
            # Wait for the writer outside the lock: the writer takes it
            # to record the write it is finishing. (The JAX package waits
            # holding it, and deadlocks when a forced checkpoint, stop()'s
            # final one, meets a writer still busy with a large world.)
            self._q.put((seq, header, arrays))
        fr = getattr(rt, "_flight", None)
        if fr is not None:
            fr.event("checkpoint", seq=seq,
                     capture_ms=round(capture_ms, 3))
        return seq

    def flush(self, timeout: float = 30.0) -> None:
        """Block until every queued write has landed (tests/stop())."""
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.005)
        self._q.join()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._q.put(None)
            self._writer.join(timeout=10.0)

    # -- background writer --
    def _write_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            seq, header, arrays = item
            path = checkpoint_file(self.prefix, seq)
            t0 = time.perf_counter()
            try:
                # Stored, not deflated: the ring is written every
                # cadence, and deflating a large world costs the writer
                # seconds (restore reads both forms).
                nbytes = write_snapshot(header, arrays, path,
                                        compress=False)
                write_ms = (time.perf_counter() - t0) * 1e3
                with self._lock:
                    s = self._stats
                    s["written"] += 1
                    s["write_ms_last"] = write_ms
                    s["write_ms_total"] += write_ms
                    s["bytes_last"] = nbytes
                    s["last_path"] = path
                    s["last_seq"] = seq
                    s["last_time"] = time.time()
                    s["last_verified"] = True    # CRCs computed on write
                for _old_seq, old_path in list_checkpoints(
                        self.prefix)[:-self.keep]:
                    try:
                        os.remove(old_path)
                    except OSError:
                        pass
                fr = getattr(self.rt, "_flight", None)
                if fr is not None:
                    fr.event("checkpoint_written", seq=seq, path=path,
                             write_ms=round(write_ms, 3), bytes=nbytes)
            except Exception as e:               # noqa: BLE001
                with self._lock:
                    self._stats["failures"] += 1
                fr = getattr(self.rt, "_flight", None)
                if fr is not None:
                    fr.event("checkpoint_failed", seq=seq,
                             error=f"{type(e).__name__}: {e}")
            finally:
                # Drop the snapshot's buffers now, not when the next item
                # arrives: on CUDA they are pinned host memory the next
                # capture can reuse.
                item = header = arrays = None
                self._q.task_done()

    # -- observability --
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._stats)

    def info(self) -> Dict[str, Any]:
        """The postmortem/doctor/healthz block: where the newest
        restorable snapshot lives, how old it is, and whether its
        checksums were verified on the way out."""
        s = self.stats()
        path = s["last_path"]
        if path is None:       # nothing written this run — on-disk ring?
            existing = list_checkpoints(self.prefix)
            if existing:
                seq, path = existing[-1]
                try:
                    age = time.time() - os.path.getmtime(path)
                except OSError:
                    age = None
                return {"path": path, "seq": seq,
                        "age_s": round(age, 3) if age is not None
                        else None,
                        "verified": None, "writes": s["written"],
                        "failures": s["failures"]}
            return {"path": None, "seq": None, "age_s": None,
                    "verified": None, "writes": 0,
                    "failures": s["failures"]}
        return {"path": path, "seq": s["last_seq"],
                "age_s": round(time.time() - s["last_time"], 3)
                if s["last_time"] else None,
                "verified": bool(s["last_verified"]),
                "writes": s["written"], "failures": s["failures"],
                "capture_ms_last": round(s["capture_ms_last"], 3),
                "write_ms_last": round(s["write_ms_last"], 3)}

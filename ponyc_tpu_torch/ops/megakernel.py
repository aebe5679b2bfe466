"""The window megakernel and the int16 + escape record codec (the
counterpart of ``ponyc_tpu/ops/megakernel.py``).

≙ the whole of ponyint_actor_run's visit for every actor, tick after tick
(src/libponyrt/actor/actor.c:383-664), plus the scheduler's delivery and
mute bookkeeping: the entire gated window of engine.build_multi_step_gated
as ONE persistent kernel. The JAX package replays the window's jaxpr
inside one Pallas call; here it is the hand-written CUDA kernel
``csrc/mega_window.cu``, launched cooperatively on a grid sized to the
world (`grid_blocks`), with a grid-wide sync after each phase of a tick
(six, more on a tick that takes the radix sort, two more in a program
with device spawns: its `census` and `reserve` phases) and the gate
(`engine.aux_go`) evaluated by every block on the device, so a window is
one launch whatever its tick count. The
behaviour bodies reach it as lane programs (``ops/lanecode.py``), every
cohort of the program in one generated header.

Two things, as in the JAX package:

1. **The window** (`MegaWindow`): built at `Runtime.start()` (every body is
   traced then, so a body the lane code cannot emit raises there), it
   takes and returns what the plain window takes and returns:
   (st, inject_tgt, inject_words, limit, force, prev_aux[, probe]) →
   (state, last_aux, ticks_run), with ticks_run an int32 tensor and no
   host synchronisation. `forced=True` gives the tuner's spelling
   (engine.build_forced_window): `limit` ticks unconditionally, injections
   every tick. It chooses by where the state lies and by nothing else:
   CUDA tensors launch the kernel (or raise), CPU tensors take the plain
   window. `MegaWindow.launches` counts kernel launches and nothing else;
   each launch reports its bytes to an open cost-capture census
   (ops/census.py).
   The kernel reads and writes the state's int32 word tables (rings and
   spill words) in place, in clones of the input's leaves. Its sort is
   chosen on the device each tick (`tick_sort` names the choice): a
   per-target segment sort where no target gets more than SEGMENT_MAX
   entries, else an LSD radix sort in `radix_plan`'s passes. Bound and
   design: the header of ``csrc/mega_window.cu``; `MegaWindow.clock` and
   `phase_table` give its device time a tick, phase by phase.

2. **The codec** (`pack_words`/`unpack_words` and the numpy twins): word
   tables can be stored as an int16 plane plus an int32 escape plane. A
   word that fits int16 (and is not the sentinel ESC) travels in the
   int16 plane; any other word reads ESC there and lives in the escape
   plane. Lossless for every int32. The window kernel no longer uses it
   (on this card the state stays int32 and the planes saved no time); it
   is kept, held against the JAX package's, for the packed snapshots of
   slice 8. `modelled_bytes_per_msg` gives the bytes a ring record costs
   packed and unpacked at a measured escape rate.

The device blob pool is served where a cohort uses it (world["BLOB"]):
the pool's leaves are cloned and updated in place like every other
written leaf, the kernel's `census` also counts free slots and runnable
allocating rows, and its `bfree` phase ranks those rows and compacts the
free slots; the lanes' blob ops (ops/lanecode.py's blob nodes) load and
store the pool directly, and the gate writes the sticky blob_fail and
blob_budget_fail and the alloc, free and remote counts.

Telemetry is served where the options ask for it (world["PROF"] at
analysis >= 1, world["EV"] at analysis >= 3, world["TRACE"] with causal
tracing): the kernel computes the profiler lanes, the phase costs, the
aux's aggregates and qw_p99, the event ring and the span ring, and the
two trace words of every record in flight (the record width W1 includes
them), in the telemetry leaves and each cohort's qwait_enq and trace_buf,
cloned and updated in place (`telemetry_leaves`). Other programs'
kernels are compiled without any of it.

Host cohorts (HOST = True) are served as the plain step serves them:
their rows take delivery into their rings, which the kernel updates in
place with the device cohorts', and the window ends on the device at the
tick after which one of them is occupied (host_pending), for the host's
drain. Single shard only (`eligible`); an ineligible program runs the
plain window, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import re
from typing import Any, Dict, List

import numpy as np
import torch

from . import _build, census, lanecode

# The escaped sentinel: int16 min. -32768 fits int16 but collides with the
# sentinel, so it is escaped too: the codec is total on int32.
ESC = -32768

# ---------------------------------------------------------------------------
# the record codec (torch and numpy spellings)


def pack_words(w: torch.Tensor):
    """int32 words → (int16 plane, int32 escape plane). Lossless:
    `unpack_words(*pack_words(w)) == w` for every int32 value."""
    w = w.to(torch.int32)
    lo = w.to(torch.int16)
    fits = (lo.to(torch.int32) == w) & (lo != ESC)
    return torch.where(fits, lo, ESC), torch.where(fits, 0, w)


def unpack_words(lo16: torch.Tensor, esc32: torch.Tensor) -> torch.Tensor:
    return torch.where(lo16 == ESC, esc32, lo16.to(torch.int32))


def pack_words_np(w: np.ndarray):
    w = np.asarray(w, np.int32)
    lo = w.astype(np.int16)
    fits = (lo.astype(np.int32) == w) & (lo != np.int16(ESC))
    lo16 = np.where(fits, lo, np.int16(ESC)).astype(np.int16)
    esc32 = np.where(fits, np.int32(0), w).astype(np.int32)
    return lo16, esc32


def unpack_words_np(lo16: np.ndarray, esc32: np.ndarray) -> np.ndarray:
    return np.where(lo16 == np.int16(ESC), esc32,
                    lo16.astype(np.int32)).astype(np.int32)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def escape_rate(arrays) -> float:
    """Fraction of int32 words that need the escape plane (wide values
    plus the sentinel) across `arrays`."""
    total = escaped = 0
    for a in arrays:
        a = _host(a)
        if a.size == 0 or a.dtype != np.int32:
            continue
        lo = a.astype(np.int16)
        fits = (lo.astype(np.int32) == a) & (lo != np.int16(ESC))
        total += a.size
        escaped += int(a.size - np.count_nonzero(fits))
    return escaped / total if total else 0.0


def escape_rate_state(state) -> float:
    """Measured escape rate over the live word tables (mailbox rings and
    spill words) of an RtState."""
    from ..runtime.state import PACKED_WORD_FIELDS
    arrs = []
    for f in PACKED_WORD_FIELDS:
        v = getattr(state, f)
        arrs += list(v.values()) if isinstance(v, dict) else [v]
    return escape_rate(arrs)


def record_words(opts) -> int:
    """Ring-record width in words: behaviour id + payload + trace lanes."""
    return 1 + opts.msg_words + getattr(opts, "trace_lanes", 0)


def modelled_bytes_per_msg(opts, esc_rate: float = 0.0) -> Dict[str, Any]:
    """Bytes a ring record costs unpacked (4 a word) and packed (2 a word
    plus the escape plane at the measured escape rate)."""
    w1 = record_words(opts)
    unpacked = 4.0 * w1
    packed = w1 * (2.0 + 4.0 * float(esc_rate))
    return {
        "record_words": w1,
        "unpacked_bytes": unpacked,
        "packed_bytes": round(packed, 3),
        "ratio": round(unpacked / packed, 3),
        "escape_rate": round(float(esc_rate), 6),
    }


# ---------------------------------------------------------------------------
# eligibility


def eligible(program, opts) -> bool:
    """The kernel's preconditions: one shard, the other kernels of the
    tick off (the window kernel is the fused form of both), and some
    device cohort with behaviours. Device spawns and sync construction
    are served, as in the JAX package's `eligible`."""
    if program.shards != 1:
        return False
    if getattr(opts, "pallas", False) is True:
        return False
    if getattr(opts, "pallas_fused", False) is True:
        return False
    return any(ch.behaviours for ch in program.device_cohorts)


def auto_enumerable(program, opts, device) -> bool:
    """Whether delivery="auto" times the window kernel as a variant on
    `device`: on CUDA whenever `eligible` holds; on the CPU the variant
    is the plain window again, so only under PONY_TPU_MEGA_AUTO=1."""
    if not eligible(program, opts):
        return False
    if torch.device(device).type == "cuda":
        return True
    return os.environ.get("PONY_TPU_MEGA_AUTO", "0") == "1"


# ---------------------------------------------------------------------------
# the window kernel

SRC = os.path.join(_build.CSRC_DIR, "mega_window.cu")
# The fields of engine.StepAux that csrc/mega_window.cu names, by the
# enums it uses for them (OB_* in the bool plane, OI_* in the int plane;
# OI_TICKS, ticks run, is the int plane's last slot). `aux_layout` checks
# the kernel's layout against these and engine._AUX_BOOL at bind time.
_AUX_NAMED = ("device_pending", "host_pending", "exit_flag",
              "spill_overflow", "spawn_fail", "blob_fail",
              "blob_budget_fail", "any_muted", "exit_code", "n_processed",
              "n_delivered", "occ_sum", "occ_max", "n_muted_now",
              "n_overloaded_now", "n_rejected", "n_badmsg", "n_deadletter",
              "n_mutes", "qw_p99")
# State leaves the kernel updates in place: each is cloned before the
# launch, since the caller's input state stays referenced (the window is a
# function of it; Runtime and the checks read it again). The mailbox rings
# and the cohorts' fields are cloned beside these; leaves the kernel only
# reads (the route spill, the injections) are passed as they are.
_UPDATED = ("head", "tail", "alive", "muted", "mute_refs", "mute_age",
            "mute_ovf", "pinned", "pressured", "dspill_tgt",
            "dspill_sender", "dspill_words", "dspill_count",
            "spill_overflow", "exit_flag",
            "exit_code", "step_no", "n_processed", "n_delivered",
            "n_rejected", "n_badmsg", "n_deadletter", "n_mutes",
            "n_destroyed", "n_spawned", "spawn_fail", "last_error",
            "last_error_loc", "n_errors", "plan_key", "plan_perm",
            "plan_bounds", "world_bits")
# The blob pool's leaves, in the order of the kernel's W::PBLOB pointers;
# passed (cloned, updated in place) where a cohort uses the pool.
BLOB_LEAVES = ("blob_data", "blob_used", "blob_len", "blob_gen",
               "blob_fail", "blob_budget_fail", "n_blob_alloc",
               "n_blob_free", "n_blob_remote")
# The telemetry leaves, in the order of the kernel's W::PTEL pointers
# (cloned, updated in place): the profiler's at analysis >= 1, the event
# ring's at analysis >= 3, the span ring's with tracing on. Each device
# cohort's qwait_enq (analysis >= 1) and each cohort's trace_buf (tracing)
# follow them, as the cohort structs' PQW and PTB.
PROF_LEAVES = ("beh_runs", "beh_delivered", "beh_rejected",
               "coh_mute_ticks", "qwait_hist", "phase_cost")
EV_LEAVES = ("ev_data", "ev_count", "ev_dropped")
SPAN_LEAVES = ("span_data", "span_count", "span_dropped", "span_next")


def telemetry_leaves(opts) -> tuple:
    """The telemetry leaves the window kernel updates for `opts`."""
    return ((PROF_LEAVES if opts.analysis >= 1 else ())
            + (EV_LEAVES if opts.analysis >= 3 else ())
            + (SPAN_LEAVES if opts.tracing else ()))


def aux_layout():
    """The kernel's aux layout as engine.StepAux and engine._AUX_BOOL
    give it (see pony_mega_aux_layout in csrc/mega_window.cu): the number
    of aux fields, each field's output slot (bool slots 0.., int slots
    100 + slot), then the slots of the fields the kernel names and of
    ticks run."""
    from ..runtime.engine import _AUX_BOOL, StepAux
    slots, nb, ni = {}, 0, 0
    for f in StepAux._fields:
        if f in _AUX_BOOL:
            slots[f], nb = nb, nb + 1
        else:
            slots[f], ni = 100 + ni, ni + 1
    return ([len(StepAux._fields)] + [slots[f] for f in StepAux._fields]
            + [slots[f] for f in _AUX_NAMED] + [100 + ni])


def fixed_pointers() -> List[str]:
    """The fixed part of the kernel's pointer table, read from the source
    (enum PonyPtr up to P_AUX_IN), so the two cannot disagree."""
    with open(SRC) as f:
        text = f.read()
    body = re.search(r"enum PonyPtr \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"\bP_[A-Z0-9_]+\b", body)
    return names[:names.index("P_AUX_IN")]


DIGIT_BITS_MAX = 11      # csrc/mega_window.cu: RADIX <= 2048
SEGMENT_MAX = 32         # entries a target may get in a segment tick


def radix_plan(key_max: int):
    """(passes, digit bits) of the window kernel's radix sort over keys
    0..key_max (the dead key, n_local * n_levels): the fewest passes of at
    most 11-bit digits, the bits split evenly between them, so every key
    range under 2^22 takes two passes."""
    bits = max(1, int(key_max).bit_length())
    npass = -(-bits // DIGIT_BITS_MAX)
    return npass, -(-bits // npass)


GRID_MAX = 1024          # csrc/mega_window.cu: GMAX, the block-count table


def grid_blocks(resident: int, n_local: int, n_entries: int,
                threads: int = 256) -> int:
    """The window kernel's launch grid: the smallest of the blocks that fit
    on the card at once (`resident`, occupancy x SMs), what the world's
    widest phase can use (one thread a lane or an entry) and the kernel's
    table of per-block digit counts (GRID_MAX). Every loop in the kernel
    is grid-stride, so any grid from 1 up is correct."""
    widest = max(-(-n_local // threads), -(-n_entries // threads))
    return max(1, min(int(resident), widest, GRID_MAX))


def tick_sort(world: Dict[str, int], plan_key: torch.Tensor) -> str:
    """Which sort the window kernel chose for the tick whose keys are
    `plan_key` (the kernel decides on the device from the same counts):
    "segment" where no target got more than `world["SEG"]` live entries,
    else "radix"."""
    dead = world["NL"] * world["NLEV"]
    live = plan_key[plan_key < dead]
    most = int(torch.bincount(live.long() // world["NLEV"]).max()) \
        if live.numel() else 0
    return "segment" if most <= world["SEG"] else "radix"


def clock_phases() -> Dict[int, str]:
    """The per-phase clock's phase ids and names, read from the source
    (enum PonyPhase: CK_START = 0, ...)."""
    with open(SRC) as f:
        text = f.read()
    body = re.search(r"enum PonyPhase \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"\bCK_([A-Z0-9_]+)\b", body)
    return {k: n.lower() for k, n in enumerate(names)}


def clock_slots() -> int:
    with open(SRC) as f:
        return int(re.search(r"CLOCK_SLOTS = (\d+);", f.read()).group(1))


def phase_table(clock: torch.Tensor, ticks: int) -> Dict[str, float]:
    """Mean device µs a tick of each phase over the first `ticks` ticks of
    a window run with `MegaWindow.clock` set: each stamp minus the one
    before it in the same tick, summed by phase name (a phase met twice a
    tick, such as a radix pass, sums), and "tick" the first stamp to the
    last. Stamps are %globaltimer readings in ns."""
    names = clock_phases()
    c = clock[:ticks].cpu().numpy()
    out: Dict[str, float] = {}
    total = 0.0
    for t in range(ticks):
        ids, ns = c[t, :, 0], c[t, :, 1]
        n = int(np.count_nonzero(ns))
        for s in range(1, n):
            name = names[int(ids[s])]
            out[name] = out.get(name, 0.0) + (ns[s] - ns[s - 1]) / 1e3
        total += (ns[n - 1] - ns[0]) / 1e3
    out = {k: v / ticks for k, v in out.items()}
    out["tick"] = total / ticks
    return out


class MegaWindow:
    """One program's window kernel (see the module docstring)."""

    launches = 0          # kernel launches, all programs
    fused = ()            # no fused dispatch kernels: `eligible` excludes them

    def __init__(self, program, opts, plain, plain_forced):
        from ..runtime.engine import (StepAux, _dtype_of, spawn_meta_of,
                                      spawn_sites_of)
        from ..runtime.state import layout_sizes
        from . import pack
        self.program, self.opts = program, opts
        self.plain, self.plain_forced = plain, plain_forced
        self.enqueued_kernel = 0     # ticks offered to launched windows
        self.windows = 0             # windows launched
        self.cohorts = list(program.device_cohorts)
        nl = program.n_local
        e_out, _, n_entries = layout_sizes(program, opts)
        pri = sorted({ch.priority for ch in self.cohorts}, reverse=True)
        self.n_levels = 2 + max(1, len(pri))
        self.fixed = fixed_pointers()
        self.n_fixed = len(self.fixed) + len(StepAux._fields)
        self.specs = []
        off, ptr = 0, self.n_fixed
        index = {ch.atype.__name__: k for k, ch in enumerate(self.cohorts)}
        targets = set(program.spawn_target_names)
        for k, ch in enumerate(self.cohorts):
            fspecs = ch.atype.field_specs
            names = list(fspecs)
            dtypes = {f: _dtype_of(s) for f, s in fspecs.items()}
            sites = spawn_sites_of(ch)
            blob = ((ch.blob_sites, opts.blob_slots, opts.blob_words)
                    if ch.uses_blobs else None)
            progs = [lanecode.trace_behaviour(
                b, field_specs=fspecs, msg_words=opts.msg_words,
                msg_words_in=ch.msg_words, max_sends=ch.max_sends,
                spawn_sites=sites, spawn_meta=spawn_meta_of(program, ch),
                blob=blob)
                for b in ch.behaviours]
            self.specs.append(dict(
                cohort=ch, name=ch.atype.__name__, progs=progs,
                fields=names, dtypes=dtypes, sites=sites,
                blob=((ch.blob_sites, ch.blob_dispatches, ch.blob_offset)
                      if ch.uses_blobs else None),
                nulls={f: pack.null_word(sp) for f, sp in fspecs.items()},
                base=ch.behaviours[0].global_id if ch.behaviours else 0,
                extra=dict(S0=ch.local_start, ROWS=ch.local_capacity,
                           OUT_OFF=off, LEVEL=2 + pri.index(ch.priority),
                           PBUF=ptr, PFIELD=ptr + 1, CIDX=k,
                           TARGET=int(ch.atype.__name__ in targets))))
            off += ch.local_capacity * ch.batch * ch.max_sends
            ptr += 1 + len(names)
        # Host cohorts: their rings only (the host holds their state).
        self.host_specs = []
        for ch in program.host_cohorts:
            self.host_specs.append(dict(
                cohort=ch, name=ch.atype.__name__,
                extra=dict(S0=ch.local_start, ROWS=ch.local_capacity,
                           CAP=opts.mailbox_cap, W1_IN=1 + ch.msg_words,
                           PBUF=ptr)))
            ptr += 1
        # The blob pool's leaves, after every ring (csrc/mega_window.cu:
        # W::PBLOB), where a cohort uses the pool.
        self.blob = any(ch.uses_blobs for ch in self.cohorts)
        self.p_blob = ptr
        if self.blob:
            ptr += len(BLOB_LEAVES)
        # The telemetry leaves (W::PTEL), then each device cohort's
        # enqueue stamps (PQW) and each cohort's trace rows (PTB).
        self.tel = telemetry_leaves(opts)
        self.p_tel = ptr
        ptr += len(self.tel)
        prof, trace = opts.analysis >= 1, opts.tracing
        for sp in self.specs:
            if prof:
                sp["extra"]["PQW"] = ptr
                ptr += 1
            if trace:
                sp["extra"]["PTB"] = ptr
                ptr += 1
        for sp in self.host_specs:
            if prof:        # a host cohort's behaviours, and no stamps
                bs = sp["cohort"].behaviours
                sp["extra"].update(BASE=bs[0].global_id if bs else 0,
                                   NB=len(bs), PQW=-1)
            if trace:
                sp["extra"]["PTB"] = ptr
                ptr += 1
        self.n_ptr = ptr
        self.site_targets = {sp["name"]: [index[t] for t, _ in sp["sites"]]
                             for sp in self.specs}
        # Words a sync construction hands the commit: the widest target's
        # fields, where some body sync-constructs.
        sync = any(p.sync for sp in self.specs for p in sp["progs"])
        n_init = max((len(program.by_type_name(t).atype.field_specs)
                      for t in targets), default=0) if sync else 0
        e = n_entries
        npass, dbits = radix_plan(nl * self.n_levels)
        self.world = dict(
            NL=nl, CAP=opts.mailbox_cap, SPILL=opts.spill_cap,
            INJ=opts.inject_slots, K=opts.mute_slots,
            W1=1 + opts.msg_words + opts.trace_lanes, E_OUT=e_out, E=e,
            NLEV=self.n_levels, UNMUTE=opts.unmute_occ,
            OVERLOAD=opts.overload_occ, AGE=opts.mute_age_limit,
            NPASS=npass, DBITS=dbits, SEG=SEGMENT_MAX,
            SPAWN=int(program.has_device_spawns), NI=n_init,
            NCOH=len(self.cohorts), HOST=int(bool(self.host_specs)),
            FH=program.first_host_row, BLOB=int(self.blob),
            BSL=opts.blob_slots if self.blob else 0,
            BW=opts.blob_words if self.blob else 0,
            PBLOB=self.p_blob if self.blob else 0,
            PROF=int(prof), EV=int(opts.analysis >= 3), TRACE=int(trace),
            NB=len(program.behaviour_table) if prof else 0,
            EVCAP=opts.analysis_events if opts.analysis >= 3 else 0,
            TSCAP=opts.trace_slots if trace else 0,
            WT=1 + opts.msg_words,
            PTEL=self.p_tel if self.tel else 0)
        self.header = self.source("cuda")      # refusals surface here
        self.tag = "pony_mega_" + re.sub(
            r"\W", "_", "_".join(s["name"] for s in self.specs))[:48]
        self._fn = self._host_fn = None
        self.info = None
        # A measurement hook, not an option: an int64 CUDA tensor
        # [max(1, limit), clock_slots(), 2] (zeroed by the caller) makes
        # every launch stamp each phase of each tick into it
        # (`phase_table` reads it); None passes a null pointer.
        self.clock = None
        self._ws: Dict[Any, torch.Tensor] = {}

    @property
    def enqueued(self) -> int:
        """Ticks enqueued: the plain window's (on the CPU) plus, for every
        launched window, the ticks it may run (its limit; the kernel runs
        at most that many and stops on the device's vote)."""
        return self.plain.enqueued + self.enqueued_kernel

    def source(self, target: str = "cuda") -> str:
        """The generated pony_world.h for `target` ("cuda" or "host")."""
        opts = self.opts
        out = ["// Generated by ponyc_tpu_torch/ops/megakernel.py: one "
               "program of the", "// window kernel (csrc/mega_window.cu "
               "includes this).", "struct PonyWorld {"]
        out += [f"  static constexpr int64_t {k} = {v};"
                for k, v in self.world.items()]
        out.append(f"  static constexpr int NPTR = {self.n_ptr};")
        out.append("};")
        # The telemetry levels for the preprocessor too, for code whose
        # loop structure changes with them.
        out += [f"#define PONY_{k} {self.world[k]}"
                for k in ("PROF", "EV", "TRACE")]
        for k, sp in enumerate(self.specs):
            ch = sp["cohort"]
            progs = sp["progs"]
            out.append(lanecode.emit_cohort(
                progs, name=f"PonyC{k}", field_names=sp["fields"],
                field_dtypes=sp["dtypes"], base=sp["base"], batch=ch.batch,
                cap=opts.mailbox_cap, ms=ch.max_sends,
                w1=1 + opts.msg_words, w1_in=1 + ch.msg_words,
                noyield=opts.noyield,
                destroy=any(p.destroy_called for p in progs),
                error=any(p.error_called for p in progs), target=target,
                extra=sp["extra"], spawn_sites=sp["sites"],
                sd=ch.spawn_dispatches, init_words=self.world["NI"],
                site_targets=self.site_targets[sp["name"]],
                site_offsets=[ch.spawn_offsets[t] for t, _ in sp["sites"]],
                field_nulls=sp["nulls"], blob=sp["blob"]))
        out.append("#define PONY_COHORTS(X) " + " ".join(
            f"X(PonyC{k})" for k in range(len(self.specs))))
        for k, sp in enumerate(self.host_specs):
            out.append(f"struct PonyH{k} {{")
            out += [f"  static constexpr int {n} = {v};"
                    for n, v in sp["extra"].items()]
            out.append("};")
        out.append("#define PONY_HOSTS(X) " + " ".join(
            f"X(PonyH{k})" for k in range(len(self.host_specs))))
        return "\n".join(out) + "\n"

    def job(self, host: bool = False) -> _build.Job:
        return _build.Job("mega_window",
                          header=self.source("host") if host else self.header,
                          header_name="pony_world.h", tag=self.tag, host=host)

    def bind(self, lib: ctypes.CDLL):
        fn = lib.pony_mega_launch
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pony_mega_ws_words.restype = ctypes.c_longlong
        lib.pony_mega_nptr.restype = ctypes.c_int
        if lib.pony_mega_nptr() != self.n_ptr:
            raise RuntimeError("window kernel: pointer table of "
                               f"{lib.pony_mega_nptr()} entries, the "
                               f"wrapper has {self.n_ptr}")
        out = (ctypes.c_int * 64)()
        n = lib.pony_mega_aux_layout(out)
        got = list(out)[:n]
        if got != aux_layout():
            raise RuntimeError("window kernel: aux layout "
                               f"{got} disagrees with engine.StepAux's "
                               f"{aux_layout()}")
        fn.ws_words = int(lib.pony_mega_ws_words())
        return fn

    def build(self, log=None) -> None:
        """Build and bind the CUDA library, read its occupancy, and size
        the grid of every launch to the world (`grid_blocks`)."""
        lib = _build.build([self.job()], log)[0]
        fn = self.bind(lib)
        info = (ctypes.c_int * 8)()
        err = lib.pony_mega_info(info)
        if err != 0:
            raise RuntimeError(f"window kernel: occupancy query failed: "
                               f"CUDA error {err}")
        self.info = dict(zip(("blocks_per_sm", "sms", "resident",
                              "registers", "local_bytes", "shared_bytes",
                              "cooperative", "threads"), list(info)))
        self.info["grid"] = grid_blocks(
            self.info["resident"], self.world["NL"], self.world["E"],
            self.info["threads"])
        if self.info["resident"] < 1 or not self.info["cooperative"]:
            raise RuntimeError(f"window kernel cannot launch "
                               f"cooperatively: {self.info}")
        self._fn = fn

    # -- calls -----------------------------------------------------------
    def __call__(self, st, inject_tgt, inject_words, limit, force,
                 prev_aux, probe=None):
        """The gated window."""
        return self._dispatch(st, inject_tgt, inject_words, limit, force,
                              prev_aux, probe, forced=False)

    def forced(self, st, inject_tgt, inject_words, limit):
        """The forced spelling: `limit` ticks, injections every tick."""
        return self._dispatch(st, inject_tgt, inject_words, limit, True,
                              None, None, forced=True)

    def _dispatch(self, st, inject_tgt, inject_words, limit, force,
                  prev_aux, probe, forced):
        dev = st.head.device
        if dev.type == "cuda":
            if self._fn is None:
                raise RuntimeError(f"window kernel {self.tag} is not built: "
                                   "Runtime.start() builds it")
            self.windows += 1
            self.enqueued_kernel += max(1, int(limit)) if not forced \
                else int(limit)
            return self._launch(self._fn, st, inject_tgt, inject_words,
                                limit, force, prev_aux, forced)
        if dev.type != "cpu":
            raise ValueError(f"window kernel: unsupported device {dev}")
        if forced:
            return self.plain_forced(st, inject_tgt, inject_words, limit)
        return self.plain(st, inject_tgt, inject_words, limit, force,
                          prev_aux, probe)

    def run_host(self, st, inject_tgt, inject_words, limit, force,
                 prev_aux, forced=False):
        """The kernel's source built for the host CPU and run on CPU
        tensors (the phases in order). For tests: it holds the kernel's
        code against the plain window where there is no card."""
        if self._host_fn is None:
            self._host_fn = self.bind(_build.build([self.job(host=True)])[0])
        return self._launch(self._host_fn, st, inject_tgt, inject_words, limit, force,
                            prev_aux, forced, host=True)

    def workspace(self, dev, words: int) -> torch.Tensor:
        """The kernel's scratch, allocated once per device."""
        ws = self._ws.get(dev)
        if ws is None:
            ws = self._ws[dev] = torch.empty((words,), dtype=torch.int32,
                                             device=dev)
        return ws

    def _clock(self, dev, limit, host):
        if self.clock is None or host:
            return torch.empty((0,), dtype=torch.int64, device=dev)
        c = self.clock
        if c.dtype != torch.int64 or c.device != dev \
                or not c.is_contiguous() or c.dim() != 3 \
                or c.shape[0] < max(1, int(limit)) \
                or tuple(c.shape[1:]) != (clock_slots(), 2):
            raise ValueError(f"window kernel: clock {c.dtype} "
                             f"{tuple(c.shape)} on {c.device}, expected "
                             f"contiguous int64 [>= {max(1, int(limit))}, "
                             f"{clock_slots()}, 2] on {dev}")
        return c

    def _launch(self, fn, st, inject_tgt, inject_words, limit, force,
                prev_aux, forced, host=False):
        from ..runtime.engine import _AUX_BOOL, StepAux, zero_aux
        dev = st.head.device
        w1, inj = self.world["W1"], self.world["INJ"]
        for t, dt, shape in ((inject_tgt, torch.int32, (inj,)),
                             (inject_words, torch.int32, (w1, inj))):
            if t.dtype != dt or tuple(t.shape) != shape \
                    or not t.is_contiguous() or t.device != dev:
                raise ValueError(f"window kernel: inject input {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}, expected "
                                 f"contiguous {dt} {shape} on {dev}")
        if forced:
            prev_aux = zero_aux(dev)
        new = {f: getattr(st, f).clone() for f in _UPDATED
               + (BLOB_LEAVES if self.blob else ()) + self.tel}
        for f, t in list(new.items()) + [("rspill_words", st.rspill_words)]:
            if not t.is_contiguous() or t.device != dev:
                raise ValueError(f"window kernel: state leaf {f} must be "
                                 f"contiguous on {dev}")
        bufs = {sp["name"]: st.buf[sp["name"]].clone()
                for sp in self.specs + self.host_specs}
        fields = {sp["name"]: {f: st.type_state[sp["name"]][f].clone()
                               for f in sp["fields"]} for sp in self.specs}
        qwe = {n: t.clone() for n, t in st.qwait_enq.items()}
        tbuf = {n: t.clone() for n, t in st.trace_buf.items()}
        ws = self.workspace(dev, fn.ws_words)
        n_b = len(_AUX_BOOL)
        n_i = len(StepAux._fields) - n_b          # ticks run goes last
        out_b = torch.empty((n_b,), dtype=torch.bool, device=dev)
        out_i = torch.empty((n_i + 1,), dtype=torch.int32, device=dev)
        table = {"P_" + f.upper(): t for f, t in new.items()}
        table.update(
            P_RSPILL_TGT=st.rspill_tgt, P_RSPILL_SENDER=st.rspill_sender,
            P_RSPILL_WORDS=st.rspill_words, P_RSPILL_COUNT=st.rspill_count,
            P_INJECT_TGT=inject_tgt,
            P_INJECT_WORDS=inject_words, P_WS=ws, P_OUT_BOOL=out_b,
            P_OUT_INT=out_i, P_CLOCK=self._clock(dev, limit, host))
        tensors = [table[n] for n in self.fixed]
        for name, v in zip(StepAux._fields, prev_aux):
            want = torch.bool if name in _AUX_BOOL else torch.int32
            if v.dtype != want or v.numel() != 1 or v.device != dev:
                raise ValueError(f"window kernel: aux {name} is {v.dtype} "
                                 f"{tuple(v.shape)} on {v.device}")
            tensors.append(v)
        for sp in self.specs:
            tensors.append(bufs[sp["name"]])
            tensors += [fields[sp["name"]][f] for f in sp["fields"]]
        tensors += [bufs[sp["name"]] for sp in self.host_specs]
        if self.blob:
            tensors += [new[f] for f in BLOB_LEAVES]
        tensors += [new[f] for f in self.tel]
        for sp in self.specs:
            if "PQW" in sp["extra"]:
                tensors.append(qwe[sp["name"]])
            if "PTB" in sp["extra"]:
                tensors.append(tbuf[sp["name"]])
        tensors += [tbuf[sp["name"]] for sp in self.host_specs
                    if "PTB" in sp["extra"]]
        ptrs = _build.pointers(tensors)
        if host:
            err = fn(ptrs, int(limit), int(bool(force)), int(forced), 1,
                     None)
        else:
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = fn(ptrs, int(limit), int(bool(force)), int(forced),
                         self.info["grid"], stream)
        if err != 0:
            raise RuntimeError(f"window kernel {self.tag} launch failed: "
                               f"CUDA error {err}")
        if not host:
            MegaWindow.launches += 1
            # Every pointer argument is read; all but the injections and
            # the previous aux are also written (the state's leaves in
            # place, the workspace, the clock and the outputs).
            read_only = {id(inject_tgt), id(inject_words)} | {
                id(v) for v in prev_aux}
            census.report("mega", tensors,
                          [t for t in tensors if id(t) not in read_only])
        st2 = dataclasses.replace(
            st, **new, buf=bufs, type_state={**st.type_state, **fields},
            qwait_enq=qwe, trace_buf=tbuf)
        bools, ints = iter(range(n_b)), iter(range(n_i))
        aux = StepAux(*(out_b[next(bools)] if f in _AUX_BOOL
                        else out_i[next(ints)] for f in StepAux._fields))
        return st2, aux, out_i[n_i]

"""Runtime options of the PyTorch port: a copy of ``ponyc_tpu/config.py``
(the port never imports the JAX package) plus `check_supported`, which
names the slice of the port (ROADMAP.md, "Port slices") that will serve
each option this one does not.

Runtime options — TPU-native equivalent of the reference's runtime flag
system (reference: src/libponyrt/sched/start.c:75-94 parses --ponymaxthreads/
minthreads/noscale/suspendthreshold/cdinterval/gcinitial/gcfactor/noyield/
noblock/analysis/mainthread/pin/pinasio; src/libponyrt/options/options.c is
the shared getopt-ish parser).

On a TPU there are no scheduler *threads* to scale; the analogous knobs are
the static shapes of the device-resident actor world: mailbox capacity,
per-step drain batch, maximum sends per behaviour invocation, spill-buffer
capacity, and the cadence of host-side bookkeeping (quiescence checks ≙ the
CNF/ACK protocol interval, cycle-detection interval ≙ --ponycdinterval).

Flags are accepted both programmatically (RuntimeOptions(...)), from the
environment (PONY_TPU_<NAME>), and from argv (--pony<name> value), mirroring
how the reference strips --pony* flags from argv before the app sees them
(start.c:185-261).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from typing import List, Optional, Union


@dataclasses.dataclass(frozen=True)
class RuntimeOptions:
    """Static configuration of a runtime instance (≙ opt_t in start.c).

    Everything here is a *trace-time constant*: changing any field re-traces
    the dispatch step (XLA programs have static shapes).
    """

    # --- mailbox / message geometry (≙ messageq.c + actor.c batch) ---
    mailbox_cap: int = 64          # per-actor ring capacity (power of two)
    msg_words: int = 6             # payload words per message (int32 lanes)
    batch: int = 8                 # default msgs drained per actor per step
    #   (reference default batch is 100 msgs per *scheduler run*
    #    (actor.c:20); a TPU "step" is much finer-grained, so the default
    #    is lower; per-type override via `BATCH` class attr ≙ the fork's
    #    lazily-initialised batch hint fn, actor.c:417-422.)
    max_sends: int = 2             # default max ctx.send() calls per behaviour

    # --- backpressure (≙ actor.c:1103-1235, scheduler.c:1478-1635) ---
    overload_threshold: float = 0.75   # occupancy fraction that marks an
    #   actor OVERLOADED (reference: failing to drain within one batch,
    #   actor.c:369-381; occupancy is the steady-state TPU analog)
    unmute_threshold: float = 0.25     # occupancy fraction under which a
    #   muting receiver releases its senders (hysteresis)
    spill_cap: int = 4096          # device overflow-spill entries (≙ the
    #   unbounded pool-backed queues of the reference; bounded here because
    #   XLA shapes are static — overflow beyond this raises)
    mute_age_limit: int = 32       # consecutive muted ticks before a
    #   sender is force-released (the lockstep deadlock-breaker for
    #   mutual-mute cycles/chains — see state.mute_age; short enough to
    #   bound stall time, long enough that ordinary backpressure mutes
    #   release via recovery, not aging). Aging only fires when every
    #   congested muter is itself muted/dead (a true deadlock); a live
    #   runnable muter with queue/spill evidence holds the mute.
    #   <= 0 disables aging entirely (exact reference mute semantics,
    #   which can deadlock on mutual-mute cycles — documented
    #   divergence opt-out).
    mute_slots: int = 4            # muting-receiver refs tracked per sender
    #   (≙ mutemap.c's receiver-set + actor.h mute counters: unmute only
    #   when *every* tracked muting receiver recovers; refs hash into
    #   ref%K slots, and a collision sets a sticky overflow bit that
    #   defers release until the whole shard is quiet — conservative,
    #   never an early unmute)

    # --- lifecycle / quiescence (≙ scheduler.c:303-480 CNF/ACK) ---
    quiesce_interval: Union[int, str] = "auto"  # max ticks fused into
    #   one device dispatch (engine.build_multi_step); the window
    #   self-terminates on host work / exit / fatal flags, so this
    #   bounds only how long the device may run *uninterrupted* — raise
    #   to amortise dispatch overhead, lower to tighten max_steps
    #   granularity. "auto" (default): the run loop sizes the window
    #   ADAPTIVELY (runtime/controller.py — the fork's adaptive
    #   scheduler sleeping): grow geometrically while windows run their
    #   full budget with zero host attention, shrink multiplicatively
    #   when host events cut windows short or the on-device queue-wait
    #   p99 climbs, bounded by quiesce_interval_min/max; the initial
    #   window resolves through the tuning cache (a previous run's
    #   converged value). An explicit int fixes the window (no
    #   adaptation) — the pre-adaptive behaviour.
    quiesce_interval_min: int = 4  # adaptive window lower bound (the
    #   shrink floor; also the smallest useful fused window — below
    #   this, per-dispatch overhead dominates any workload)
    quiesce_interval_max: int = 1024  # adaptive window upper bound:
    #   caps host-event reaction latency (an in-flight window cannot be
    #   interrupted) and max_steps overshoot granularity
    pipeline: bool = True          # pipelined host bridge: dispatch
    #   window k+1 behind in-flight window k (tick 0 gated ON DEVICE by
    #   window k's aux — engine.build_multi_step_gated) and start a
    #   non-blocking host copy of window k's control scalars at dispatch
    #   time, so outbox drain / host behaviours / the analysis writer
    #   overlap device compute instead of serialising against it. False
    #   restores the fully synchronous fetch-then-dispatch loop (the
    #   differential oracle: tests/test_run_loop.py proves the two agree
    #   message-for-message)
    cd_interval: int = 128         # steps between cycle-detector scans
    #   (≙ --ponycdinterval default 100ms, start.c:206)
    gc_initial: int = 1 << 14      # host-heap bytes allocated since the
    #   last collection that trigger one early (≙ --ponygcinitial
    #   2^14, start.c:204-209 — growth-triggered GC, heap.c:603-806)
    gc_factor: float = 2.0         # next-trigger growth multiplier over
    #   live bytes after a collection (≙ --ponygcfactor 2.0)
    noblock: bool = False          # ≙ --ponynoblock: disable cycle detection
    gc_max_iters: int = 0          # reachability-trace hop cap (0 = run to
    #   fixpoint); if hit, that GC round collects nothing (safe)
    noyield: bool = False          # ≙ --ponynoyield: ignore yield hints
    max_steps: Optional[int] = None  # safety valve for tests

    # --- host bridge (≙ asio/) ---
    inject_slots: int = 256        # host→device injected msgs per step
    host_out_slots: int = 256      # device→host delivered msgs per step
    pin: int = -1                  # ≙ --ponypin: pin the host driver
    #   thread to this core (-1 = unpinned); the TPU analog of pinning
    #   scheduler threads — keeps the dispatch loop off noisy cores
    pin_asio: int = -1             # ≙ --ponypinasio: pin the native
    #   event-loop thread to this core (-1 = unpinned)

    # --- analysis / telemetry (≙ --ponyanalysis, analysis.c) ---
    analysis: int = 0              # 0 off, 1 summary, 2 window CSV,
    #   3 = 2 + per-EVENT rows (mute/unmute/overload/spawn/destroy/error
    #   transitions recorded on device in a bounded ring, drained to
    #   <analysis_path>.events.csv at window boundaries — ≙ the fork's
    #   per-event rows, analysis.c:587-692; costs one compaction per
    #   busy tick while enabled)
    analysis_path: str = os.path.join(tempfile.gettempdir(),
                                      "pony_tpu.analytics.csv")
    analysis_events: int = 4096    # device event-ring entries per shard
    #   (level 3); overflow between two drains drops and counts
    analysis_flush_ms: int = 200   # writer-thread flush cadence: rows
    #   batch and flush when the queue drains or this many ms pass,
    #   whichever first (flush-per-row serialised the writer under
    #   level-3 event bursts); 0 = flush after every batch
    # --- causal message tracing (PROFILE.md §10; ≙ the fork's per-event
    # analysis following one message send→dispatch, analysis.c:587-692 —
    # here a sampled TRACE CONTEXT rides every message: mailbox ring
    # slots gain (trace_id, parent_span) side lanes, dispatch records a
    # span per traced message in a bounded device ring, and every send/
    # spawn the behaviour performs inherits the context. Active only
    # when BOTH analysis >= 3 and trace_sample > 0; otherwise every
    # trace lane is zero-length and the step jaxpr is bit-identical to
    # a tracer-free build (tests/test_tracing.py asserts it). ---
    trace_sample: int = 0          # 0 = off; N >= 1 samples one in N
    #   host injections (send()); 1 traces every injection. Sampling is
    #   deterministic under trace_seed (a counter hash, not wall clock),
    #   so identical runs trace identical messages. Explicit ids via
    #   send(..., trace=...) are always traced regardless of N.
    trace_slots: int = 4096        # device span-ring entries per shard;
    #   overflow between two drains drops spans and counts them
    #   (state.span_dropped) — raise for deep fan-outs
    trace_seed: int = 0            # sampling-hash seed (determinism knob)
    pallas: Union[bool, str] = False   # the mailbox drain's kernel. The
    #   port has one drain: on CUDA the plain dispatch always launches
    #   csrc/drain.cu, on the CPU its plain version, whatever this says.
    #   True makes the window kernel ineligible, as in the JAX package;
    #   "auto" resolves to False at start() without being measured
    #   (tuning.py).
    pallas_fused: Union[bool, str] = False  # fuse drain + behaviour +
    #   outbox into ONE kernel per eligible cohort (ops/fused_dispatch.py,
    #   csrc/fused_dispatch.cu; a cohort that sync-constructs or uses the
    #   blob pool takes the plain dispatch). "auto" = time it against
    #   the plain dispatch at start() and keep the faster (tuning.py).
    host_fastpath: bool = True     # host-sender → host-target messages
    #   bypass the device mailbox table: they queue host-side and
    #   dispatch at host boundaries (≙ the main-thread scheduler's
    #   inject_main lane, scheduler.c:47,179-190 — main-thread actors
    #   message each other without crossing schedulers). Per-sender-pair
    #   FIFO is preserved (a host sender's messages to a host receiver
    #   ALL take this lane; device senders all take the device lane);
    #   lifts the host-plane ceiling ~the device-window cost per hop
    #   (benchmarks.md "host-bridge ceiling"). False restores the
    #   everything-through-the-device-table path.
    host_fastpath_budget: int = 100_000  # max fast-lane dispatches per
    #   host boundary; leftovers keep the loop busy (starvation guard so
    #   a host ping-pong cannot lock out device progress)
    dispatch_gating: bool = False  # skip a behaviour's planar evaluation
    #   under a scalar lax.cond when no lane's current batch slot selects
    #   it (engine scan_body). Semantics-identical (behaviours are
    #   lane-local by contract); pays one any-reduction + branch per
    #   (slot, behaviour) to avoid evaluating cold behaviours — the
    #   countermeasure to the planar-dispatch heterogeneity cliff
    #   (profiling/_hetero.py measures; the reference's switch is O(1),
    #   genfun.c). Off by default until measured on the real chip.
    delivery: str = "plan"         # delivery formulation (delivery.py):
    #   "plan"   — one stable sort of the key a tick, then permutation
    #              gathers of the payload (the JAX package also caches
    #              the plan and skips the sort when the key repeats; the
    #              port sorts every tick);
    #   "cosort" — the same stable sort, with the payload gathered in
    #              the sorted order and no plan kept (the JAX package
    #              moves the payload inside one multi-operand sort);
    #   "pallas_mega" — the window kernel (ops/megakernel.py,
    #              csrc/mega_window.cu): the WHOLE gated window —
    #              delivery, mailbox drain, dispatch, profiler lanes —
    #              as one cooperative CUDA launch on the card (the plain
    #              window on the CPU). Plan-formulation delivery
    #              semantics, bit-equivalent; an ineligible program
    #              (pallas or pallas_fused forced on) runs the plain
    #              window;
    #   "auto"   — time the formulations at Runtime.start() on the
    #              program's real cohort shapes (a short forced window
    #              each, on a synthetic busy state) and keep the faster
    #              (tuning.py; the decision persists in the tuning
    #              cache, so a later start on the same layout skips
    #              calibration). pallas_mega joins the candidates on
    #              CUDA, or under PONY_TPU_MEGA_AUTO=1 on the CPU, where
    #              it is the plain window again.
    debug_checks: bool = False     # run Runtime.check_invariants() at
    #   every aux fetch (≙ the reference's debug-build queue checkers,
    #   actor.c:57-92; costly — test/debug only)

    # --- operational observability (flight recorder / stall watchdog /
    # metrics export, flight.py and metrics.py; ≙ the fork's always-on
    # runtime-analysis posture). All three are HOST-side: none feeds a
    # window, so the kernels and the plain tick are built the same with
    # them as without. ---
    flight_windows: int = 64       # flight-recorder ring: how many
    #   retired-window records (control scalars the run loop already
    #   fetched, controller decisions, GC stats, recent host mail) the
    #   always-on black box retains for the crash/SIGQUIT/watchdog
    #   postmortem (Runtime.stop(postmortem=True) dumps it on demand)
    watchdog_s: Optional[float] = None  # stall-watchdog deadline in
    #   seconds (None = off): a monitor thread trips when a run-loop
    #   phase (backend init, a dispatched window, host work) makes no
    #   progress stamp for this long — scaled up by the adaptive
    #   controller's current window / initial window ratio so a
    #   legitimately grown window is not misread as a stall. A trip
    #   writes the flight-recorder postmortem and converts the silent
    #   hang into an int-coded errors.PonyStallError
    metrics_port: Optional[int] = None  # serve Prometheus text at
    #   /metrics and a JSON health verdict at /healthz on
    #   127.0.0.1:<port> via a stdlib-only HTTP thread (None = off,
    #   0 = ephemeral port — read it back from rt._metrics.port).
    #   Scrapes never touch the device: they render the snapshot the
    #   run loop last pushed at a window boundary (the same
    #   non-blocking posture as the analysis writer)
    cost_capture: bool = False     # measured device-cost capture
    #   (costs.py): at start(), AOT-compile the runtime's
    #   real step/window executables and record their
    #   cost_analysis()/memory_analysis() (bytes accessed, flops, peak
    #   HBM) next to the modelled bytes/msg — one extra compile per
    #   executable at start (the XLA disk cache absorbs the repeat).
    #   HOST-side: the traced step never sees it, so the step jaxpr is
    #   bit-identical with capture on or off. Off, the same capture is
    #   available on demand via Runtime.measured_costs()

    # --- durable worlds (serialise.py Checkpointer + supervise.py;
    # ≙ nothing in the reference — Pony has no built-in checkpoint/
    # restore (SURVEY.md §5); the TPU runtime's single-pytree world
    # makes one cheap. All three knobs are HOST-side: the traced step
    # never sees them, so the step jaxpr is bit-identical with
    # checkpointing on or off (tests/test_durability.py asserts). ---
    checkpoint_every_s: Optional[float] = None  # periodic crash-safe
    #   checkpoint cadence in seconds (None = off): the run loop
    #   snapshots the whole world at the next quiescent window boundary
    #   once this much time has passed — capture (device→host copy,
    #   started async) runs on the run-loop thread; checksumming
    #   and the fsync+atomic-rename write ride a
    #   background writer thread behind the next in-flight window
    #   (Runtime.checkpoint_stats() records both costs, PROFILE.md §12)
    checkpoint_path: str = ""      # checkpoint ring file PREFIX; files
    #   land as <prefix>-<seq>.ckpt with the newest `checkpoint_keep`
    #   retained. "" = derive <analysis_path>.ckpt
    checkpoint_keep: int = 3       # how many ring snapshots to retain
    #   (the supervisor falls back past corrupt ones, so > 1 is the
    #   crash-safety margin; old files beyond K are deleted)

    # --- autotuning / caches (tuning.py; ≙ nothing in the reference —
    # its dispatch is one fixed O(1) switch, genfun.c; ours has
    # formulation choices whose winner is hardware- and shape-dependent,
    # so the runtime measures instead of a human with a scratch script:
    # PROFILE.md §6) ---
    tuning_cache: str = "auto"     # on-disk decision cache for "auto"
    #   option values, keyed by (platform, device and its compute
    #   capability, torch and CUDA versions, the kernels' sources, cohort
    #   layout, geometry). "auto" = $PONY_TPU_TUNING_CACHE or
    #   ~/.cache/ponyc_tpu_torch/tuning; "off" disables (recalibrate
    #   every start); any other value = explicit directory.
    compile_cache: str = "auto"    # jax persistent compilation cache
    #   (attacks the measured 11.8 s warmup, PROFILE.md §4b). Same
    #   spelling: "auto" = $PONY_TPU_COMPILE_CACHE or
    #   ~/.cache/ponyc_tpu/xla; "off" leaves jax.config untouched.
    tuning_ticks: int = 0          # ticks per calibration window (a
    #   forced window, engine.build_forced_window, timed between two
    #   device synchronisations). 0 = auto-size from the synthetic
    #   workload's sustain.
    tuning_repeats: int = 3        # timed windows per variant (the
    #   median is kept; the first, compile-bearing window never counts)

    # --- device blob pool (≙ rich message payloads: pony_alloc_msg +
    # actor-heap objects riding messages, pony.h:332-360 / genfun.c.
    # Messages carry a blob HANDLE (i32, mode iso — moved-unique); the
    # words live device-resident in a [blob_words, shards*blob_slots]
    # pool, so payloads larger than msg_words never round-trip the
    # host. 0 = disabled (all blob plumbing compiles away). ---
    blob_slots: int = 0            # pool slots PER SHARD; handles carry
    #   (generation, global slot id) — ops/pack.py encoding. On a mesh a
    #   blob MIGRATES with its routed message (engine._route); host
    #   injections bypass routing, so host payloads should allocate on
    #   the receiver's shard (Runtime.blob_store(near=...)) — an
    #   undereferenceable arrival reads null and counts in
    #   rt.counter("n_blob_remote")
    blob_words: int = 0            # i32 words per blob slot (the pool's
    #   uniform width; ctx.blob_alloc records each blob's logical length)

    # --- sharding (≙ the scale axis the reference lacks; SURVEY §2.4) ---
    mesh_shards: int = 1           # actor-axis shards (1 = single chip)
    route_bucket: int = 0          # per-destination all_to_all bucket
    #   entries. 0 = auto-size (state.layout_sizes): covers the worst
    #   case one-shard emission up to 4 shards; beyond that (or with an
    #   explicit smaller value) a saturated link parks messages in the
    #   route spill and mutes senders — backpressure, not loss

    def __post_init__(self):
        if self.mailbox_cap & (self.mailbox_cap - 1):
            raise ValueError("mailbox_cap must be a power of two")
        if self.msg_words < 1:
            raise ValueError("msg_words must be >= 1")
        if self.batch < 1:
            raise ValueError("batch must be >= 1")
        if self.delivery not in ("plan", "cosort", "pallas_mega",
                                 "auto"):
            raise ValueError("delivery must be 'plan', 'cosort', "
                             "'pallas_mega' or 'auto'")
        if isinstance(self.quiesce_interval, str):
            if self.quiesce_interval != "auto":
                raise ValueError(
                    "quiesce_interval must be a positive int or 'auto'")
        elif self.quiesce_interval < 1:
            raise ValueError("quiesce_interval must be >= 1")
        if self.quiesce_interval_min < 1 \
                or self.quiesce_interval_max < self.quiesce_interval_min:
            raise ValueError(
                "need 1 <= quiesce_interval_min <= quiesce_interval_max")
        for name in ("pallas", "pallas_fused"):
            v = getattr(self, name)
            if not (v is True or v is False or v == "auto"):
                raise ValueError(f"{name} must be True, False or 'auto'")
        if self.tuning_repeats < 1:
            raise ValueError("tuning_repeats must be >= 1")
        if self.tuning_ticks < 0:
            raise ValueError("tuning_ticks must be >= 0 (0 = auto)")
        if self.analysis_flush_ms < 0:
            raise ValueError("analysis_flush_ms must be >= 0")
        if self.trace_sample < 0:
            raise ValueError(
                "trace_sample must be >= 0 (0 = off, N = 1-in-N)")
        if self.trace_slots < 1:
            raise ValueError("trace_slots must be >= 1")
        if self.flight_windows < 1:
            raise ValueError("flight_windows must be >= 1")
        if self.watchdog_s is not None and not self.watchdog_s > 0:
            raise ValueError("watchdog_s must be > 0 seconds (None = off)")
        if self.metrics_port is not None \
                and not 0 <= self.metrics_port < 65536:
            raise ValueError(
                "metrics_port must be in [0, 65535] (0 = ephemeral, "
                "None = off)")
        if self.checkpoint_every_s is not None \
                and not self.checkpoint_every_s > 0:
            raise ValueError(
                "checkpoint_every_s must be > 0 seconds (None = off)")
        if self.checkpoint_keep < 1:
            raise ValueError("checkpoint_keep must be >= 1")
        if self.blob_slots < 0 or self.blob_words < 0:
            raise ValueError("blob_slots/blob_words must be >= 0")
        if (self.blob_slots > 0) != (self.blob_words > 0):
            raise ValueError(
                "blob_slots and blob_words enable the blob pool together "
                "(both > 0) or not at all (both 0)")
        if self.blob_slots * max(1, self.mesh_shards) >= 1 << 20:
            raise ValueError(
                "shards x blob_slots must stay below 2^20 (handle "
                "encoding reserves the high bits for the slot "
                "generation; ops/pack.py BLOB_GEN_SHIFT)")

    @property
    def tracing(self) -> bool:
        """Causal tracing active: both the analysis level and the
        sampling knob must opt in (PROFILE.md §10)."""
        return self.analysis >= 3 and self.trace_sample > 0

    @property
    def trace_lanes(self) -> int:
        """Extra word rows every in-flight message carries when tracing
        is on: (trace_id, parent_span). 0 when off — inject buffers,
        spill tables and outbox entries keep the tracer-free width."""
        return 2 if self.tracing else 0

    @property
    def overload_occ(self) -> int:
        return max(1, int(self.mailbox_cap * self.overload_threshold))

    @property
    def unmute_occ(self) -> int:
        return max(0, int(self.mailbox_cap * self.unmute_threshold))


_FLAG_TYPES = {f.name: f.type for f in dataclasses.fields(RuntimeOptions)}

# bool-or-"auto" tri-state flags: bare flag spells True, "auto" survives
# coercion (everything else parses like a bool).
_TRISTATE = ("pallas", "pallas_fused")

# int-or-"auto" flags ("auto" survives coercion, anything else is int).
_INT_OR_AUTO = ("quiesce_interval",)


def _is_boolish(name: str) -> bool:
    return name in _TRISTATE or _FLAG_TYPES[name] in ("bool", bool)


def _coerce(name: str, raw: str):
    ty = _FLAG_TYPES[name]
    if name in _TRISTATE:
        return "auto" if raw.lower() == "auto" else (
            raw.lower() in ("1", "true", "yes", "on", ""))
    if name in _INT_OR_AUTO:
        return "auto" if raw.lower() == "auto" else int(raw)
    if ty in ("bool", bool):
        return raw.lower() in ("1", "true", "yes", "on", "")
    if ty in ("int", int, "Optional[int]", Optional[int]):
        return int(raw)
    if ty in ("float", float, "Optional[float]", Optional[float]):
        return float(raw)
    return raw


def options_from_env(base: Optional[RuntimeOptions] = None) -> RuntimeOptions:
    """Read PONY_TPU_* environment overrides (≙ start.c env handling)."""
    base = base or RuntimeOptions()
    overrides = {}
    for name in _FLAG_TYPES:
        raw = os.environ.get("PONY_TPU_" + name.upper())
        if raw is not None:
            overrides[name] = _coerce(name, raw)
    return dataclasses.replace(base, **overrides)


def strip_runtime_flags(argv: Optional[List[str]] = None,
                        base: Optional[RuntimeOptions] = None):
    """Parse and remove --pony* flags from argv, returning (opts, rest).

    ≙ pony_init's argv filtering (start.c:185-261): the application never
    sees runtime flags. Accepted spellings: --pony_mailbox_cap 64,
    --ponymailboxcap=64 (underscores optional).
    """
    argv = list(sys.argv if argv is None else argv)
    canon = {name.replace("_", ""): name for name in _FLAG_TYPES}
    rest, overrides, i = [], {}, 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--pony"):
            body = a[6:].lstrip("_")
            if "=" in body:
                key, raw = body.split("=", 1)
            else:
                key, raw = body, None
            key = key.replace("_", "")
            if key in canon:
                name = canon[key]
                if raw is None:
                    if _is_boolish(name):
                        raw = "true"
                    else:
                        i += 1
                        if i >= len(argv):
                            raise ValueError(f"missing value for flag {a}")
                        raw = argv[i]
                overrides[name] = _coerce(name, raw)
                i += 1
                continue
        rest.append(a)
        i += 1
    base = options_from_env(base)
    return dataclasses.replace(base, **overrides), rest


def auto_fields(opts: RuntimeOptions) -> List[str]:
    """Option fields whose value is the "auto" sentinel — the set the
    tuner (tuning.py) must resolve to concrete values before the engine
    traces (the engine only ever sees concrete formulations)."""
    return [n for n in ("delivery", "pallas", "pallas_fused")
            if getattr(opts, n) == "auto"]


# --- what the PyTorch port serves so far -----------------------------------
# Feature -> (description, the port slice that brings it; ROADMAP.md
# "Port slices"). Unserved options raise; they never fall back quietly.
PORT_SLICES = {
    "mesh": ("mesh sharding (mesh_shards > 1)", 10),
}


def unported(key: str) -> NotImplementedError:
    """The error for a feature this port slice does not serve."""
    what, n = PORT_SLICES[key]
    return NotImplementedError(
        f"{what} is not served by the PyTorch port yet; port slice {n} "
        "brings it (ROADMAP.md, 'Port slices')")


def check_supported(opts: RuntimeOptions) -> None:
    """Raise for every option value the port does not serve. `pallas`
    is accepted in every spelling: on CUDA the mailbox drain always
    runs as the hand-written kernel, on the CPU as its plain version.
    `pallas_fused=True` runs the fused dispatch kernel on CUDA (its
    plain version on the CPU). `delivery="pallas_mega"` runs the window
    kernel on CUDA where ops/megakernel.py's `eligible` holds (the plain
    window elsewhere). "auto" values are resolved by the tuner at
    Runtime.start() (tuning.py)."""
    if opts.mesh_shards > 1:
        raise unported("mesh")

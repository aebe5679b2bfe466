"""Host driver of the PyTorch port: runtime construction, spawning,
host→device messaging and the run-to-quiescence loop (the counterpart of
``ponyc_tpu/runtime/runtime.py``).

≙ the reference's runtime bootstrap and lifecycle (src/libponyrt/sched/
start.c: pony_init sizes the world, pony_start runs until quiescence,
pony_get_exitcode returns the program's code) plus host-side actor
creation (pony_create, actor/actor.c:688-734) and external sends.

Host cohorts (actor types with HOST = True, ≙ actors on the main-thread
scheduler and `env.out`) keep their state in Python dicts and run their
behaviours here, between windows: the device delivers into their
mailbox rows like any other, a window ends when one of those rows is
occupied (`host_pending`), and the run loop drains them (`_drain_host`).
Messages from a host sender to a host target skip the device and queue
on the host fast lane (`opts.host_fastpath`).

Memory: the collector (`gc`, runtime/gc.py; `release` and `pin` move the
host's roots) runs at host boundaries every `cd_interval` ticks once the
host released an actor or the program spawns on the device, and early
under host-heap pressure (`heap`, hostmem.py). The host reads and writes
the device blob pool between windows (`blob_store`, `blob_fetch`, ...),
and owns the handles it stored until a send moves them.

The loop dispatches one window of up to `quiesce_interval` ticks per
iteration (engine.build_multi_step_gated) and reads back one small
vector of control scalars to decide termination — the analog of the
CNF/ACK quiescence vote (scheduler.c:303-480). With `pipeline=True` the
next window is enqueued behind the in-flight one before the host reads
the in-flight window's scalars; its tick 0 is gated on the device by
that window's aux, so it cancels itself when the host must act.

`Runtime(opts, device=None)` runs on the card ("cuda") unless the
caller asks for the CPU; with no CUDA device and no explicit
``device="cpu"`` it raises rather than running somewhere else.

Operations (flight.py, metrics.py): every runtime keeps an always-on
flight recorder of its retired windows, GC passes and host mail, dumped
as a postmortem on a crash, on SIGQUIT and on `stop(postmortem=True)`;
`watchdog_s` arms a stall watchdog on the run loop's phase stamps
(`_stamp`), and `metrics_port` serves /metrics and /healthz. The run
loop waits for the card by polling from Python (`_wait_event`), so the
watchdog's interrupt lands while a window is still running.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import signal
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..api import ActorTypeMeta, BehaviourDef
from ..config import RuntimeOptions, auto_fields
from ..errors import ERROR_CODES, PonyError, PonyStallError, error_code
from ..ops import fused_dispatch, megakernel, pack
from ..program import Program
from . import engine
from .controller import WindowController
from ..parallel.mesh import Sharded, world_of
from .state import RtState, init_state


WIN_BUCKETS = 16     # run_loop_stats' window-length histogram (2^k ticks)

# The run loop's wait for the card (`Runtime._wait_event`). A window of
# the window kernel is one cooperative launch, and the plain window one
# enqueue of eager kernels: either can wedge (a grid sync that never
# completes, a body that spins, a card that stops answering).
# torch.cuda.Event.synchronize() would then block inside libcuda,
# where no Python signal handler runs, and run() would hang with
# no evidence: the watchdog's SIGINT (flight.Watchdog.trip) could not
# land. So the wait polls Event.query() from Python instead: a spin of
# up to WAIT_SPIN_S, which a quiet world's windows end inside at the
# cost of one query (synchronize() spins too, under CUDA's default
# scheduling), then sleeps from WAIT_SLEEP_MIN_S doubling to
# WAIT_SLEEP_MAX_S, which add at most that much to a longer window.
# Every poll returns to the interpreter, where a pending SIGINT or
# SIGTERM is raised, and yields the interpreter lock (synchronize()
# released it for the whole wait), so the watchdog's and the exporter's
# threads run meanwhile.
WAIT_SPIN_S = 0.1
WAIT_SLEEP_MIN_S = 50e-6
WAIT_SLEEP_MAX_S = 1e-3


def _state_tensors(x):
    """Every tensor of a state (the leaves of RtState's dicts)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _state_tensors(v)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _state_tensors(getattr(x, f.name))


class SpillOverflowError(RuntimeError):
    """The bounded overflow spill was exceeded — raise mailbox_cap or
    spill_cap, or let backpressure mute faster."""

    code = ERROR_CODES["SpillOverflowError"]


class SpawnCapacityError(RuntimeError):
    """A device-side spawn wanted a slot but found none."""

    code = ERROR_CODES["SpawnCapacityError"]


class BlobCapacityError(RuntimeError):
    """A device-side ctx.blob_alloc() wanted a pool slot but its window
    had none free — raise RuntimeOptions.blob_slots (or the class's
    BLOB_DISPATCHES, as the message says), or free blobs faster.
    ≙ pony_alloc exhausting the heap."""

    code = ERROR_CODES["BlobCapacityError"]


class AmbientAuth:
    """Root authority (≙ env.root: AmbientAuth). Obtained only from
    Runtime.ambient_auth(); narrower capability tokens check for it.
    The sentinel token (same pattern as files.FilesAuth) makes direct
    construction impossible, so holding `rt` alone does not mint it."""

    _token = object()

    def __init__(self, rt, token=None):
        if token is not AmbientAuth._token:
            raise PermissionError(
                "obtain AmbientAuth via rt.ambient_auth(), not directly")
        self._rt = rt


def resolve_device(device=None) -> torch.device:
    """The device a Runtime runs on: CUDA unless the caller names
    another. Asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ponyc_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class HostContext:
    """Effect collector of a host-resident behaviour (≙ running an actor
    on the main-thread scheduler, scheduler.c:1030-1035): `self` inside
    the body of a HOST = True actor type."""

    def __init__(self, rt: "Runtime", actor_id: int):
        self.rt = rt
        self.actor_id = actor_id
        self.exit_flag = False
        self.exit_code = 0
        self.yield_flag = False
        self.trace_ctx = None   # (trace id, span id) of this dispatch when
        #   causal tracing followed the message here: the sends below
        #   continue the chain

    def send(self, target, behaviour_def, *args, when=True):
        if when:
            self.rt.send(int(target), behaviour_def, *args,
                         trace=self.trace_ctx)

    def exit(self, code=0, when=True):
        if when:
            self.exit_flag = True
            self.exit_code = int(code)

    def yield_(self, when=True):
        if when:
            self.yield_flag = True


def _host_pack_args(specs, args, msg_words):
    words = np.zeros((msg_words,), np.int32)
    if len(args) != len(specs):
        raise TypeError(f"behaviour takes {len(specs)} args, got {len(args)}")
    off = 0
    for spec, v in zip(specs, args):
        if isinstance(spec, pack._VecSpec):
            dt = np.float32 if spec.base is pack.F32 else np.int32
            arr = np.asarray(v, dt).reshape(-1)
            if arr.shape[0] != spec.n:
                raise TypeError(f"argument for {spec.__name__} must have "
                                f"{spec.n} elements, got {arr.shape[0]}")
            words[off:off + spec.n] = arr.view(np.int32)
            off += spec.n
        elif spec is pack.F32:
            words[off] = np.float32(v).view(np.int32)
            off += 1
        elif spec is pack.Bool:
            words[off] = np.int32(bool(v))
            off += 1
        elif spec is pack.U32:
            words[off] = np.asarray(v, np.int64).astype(
                np.uint32).view(np.int32)
            off += 1
        elif spec in pack._NARROW:
            dt = pack.narrow_np_map()[spec]
            words[off] = np.asarray(v, np.int64).astype(dt).astype(np.int32)
            off += 1
        else:
            words[off] = np.int32(v)
            off += 1
    return words


def _host_unpack_args(specs, words):
    """A message's payload words as the behaviour's Python arguments (the
    inverse of `_host_pack_args`)."""
    out = []
    off = 0
    for spec in specs:
        if isinstance(spec, pack._VecSpec):
            blk = np.asarray(words[off:off + spec.n], np.int32)
            out.append(blk.view(np.float32) if spec.base is pack.F32
                       else blk)
            off += spec.n
            continue
        w = np.int32(words[off])
        off += 1
        if spec is pack.F32:
            out.append(float(w.view(np.float32)))
        elif spec is pack.Bool:
            out.append(bool(w))
        elif spec is pack.U32:
            out.append(int(w.view(np.uint32)))
        elif spec in pack._NARROW:
            out.append(int(w.astype(pack.narrow_np_map()[spec])))
        else:
            out.append(int(w))
    return tuple(out)


class Runtime:
    """A live actor world bound to one program layout.

    Typical use::

        rt = Runtime(opts)               # on the card; device="cpu" for CPU
        rt.declare(RingNode, 1024)
        rt.start()                       # ≙ pony_init: freeze + allocate
        refs = rt.spawn_many(RingNode, 1024)
        rt.set_fields(RingNode, refs, next_ref=np.roll(refs, -1))
        rt.send(int(refs[0]), RingNode.token, 1000)
        code = rt.run()                  # ≙ pony_start: run to quiescence
    """

    def __init__(self, opts: Optional[RuntimeOptions] = None, device=None):
        self._opts_defaulted = opts is None
        self.opts = opts or RuntimeOptions()
        self.device = resolve_device(device)
        self.program = Program(self.opts)
        self.state: Optional[RtState] = None
        self.mesh = None              # parallel.mesh.Mesh of a sharded
        #   world (start())
        self._host_rows_cache = None  # _host_rows, after start()
        self._inject_q: collections.deque = collections.deque()
        # Host fast lane (opts.host_fastpath): host-sender → host-target
        # messages, dispatched at host boundaries without touching the
        # device mailbox table (≙ inject_main, scheduler.c:179-190).
        self._host_fast_q: collections.deque = collections.deque()
        self._host_state: Dict[int, Dict[str, Any]] = {}
        self._host_errors: Dict[int, int] = {}
        self._host_error_locs: Dict[int, str] = {}
        self._exit_requested = False
        self.totals = collections.Counter()   # host-side counters
        self._free: Dict[str, List[int]] = {}
        self._freelist_key = None     # None: stale; "synced": valid
        self._exit_code = 0
        self._device_dirty = True     # force the first window of a run
        self.steps_run = 0
        self._controller: Optional[WindowController] = None
        self._qi_auto = False
        self._qi_loaded = 0
        self.tuning_record: Optional[Dict[str, Any]] = None   # set by
        #   start() when delivery, pallas or pallas_fused is "auto"
        #   (tuning.resolve): source, variants, table, winner, chosen,
        #   detail, cache_path
        self._state_epoch = 0
        # Run-loop telemetry (run_loop_stats()): windows retired, how
        #   many dispatches rode behind an in-flight window, cumulative
        #   host-imposed device-idle gap, re-queued gated-out injects,
        #   window-length histogram.
        self._rl_windows = 0
        self._rl_pipelined = 0
        self._rl_synced = 0
        self._rl_gap_ns = 0
        self._rl_requeued = 0
        self._win_hist = np.zeros((WIN_BUCKETS,), np.int64)
        # Operations (flight.py, metrics.py).
        self._flight = None           # flight.FlightRecorder (start())
        self._watchdog = None         # flight.Watchdog when watchdog_s
        self._metrics = None          # metrics.MetricsServer when
        #   metrics_port is not None
        self._ckpt = None             # serialise.Checkpointer when
        #   checkpoint_every_s is set (durable worlds)
        self._last_run_crashed = False  # run() exited exceptionally:
        #   stop() must not overwrite the ring's newest snapshot with
        #   the post-crash world (the supervisor restores the last
        #   intact pre-crash checkpoint)
        self._bridge_pollers: List[Any] = []   # register_poller's
        self._noisy = 0               # outside event sources holding the
        #   run open (≙ asio's noisy count: a socket, a timer, a pending
        #   lookup); while > 0 a quiescent run waits for them
        self.bridge = None            # attach_bridge / attach_net /
        self.net = None               #   attach_resolver /
        self.resolver = None          #   attach_processes
        self.procs = None
        self._last_aux = None         # the newest retired window's aux
        #   (host ints; serve.Server reads qw_p99 and n_muted_now)
        self._pre_pin_affinity = None  # the CPU set before opts.pin
        self._wd_epoch = 0            # phase-stamp progress counter
        self._wd_stamp = ("idle", 0, time.monotonic())  # (phase,
        #   epoch, t): one tuple assignment per transition — the
        #   progress evidence the watchdog thread reads
        # Coded runtime errors raised or caught on this runtime, keyed
        # (class name, int code): the metrics label and the
        # postmortem's error section.
        self._error_counts: collections.Counter = collections.Counter()
        # The collector and the blob pool (host side).
        self._gc_fn = None
        self._ever_released = False
        self._last_gc_step = 0
        self._next_gc = self.opts.gc_initial   # ≙ heap.c next_gc
        self._idle_boundaries = 0     # skipped host-only boundaries; they
        #   count toward the cd_interval cadence
        self._heap = None
        self._host_blobs: set = set()  # handles the host owns (GC roots)
        self._blob_epoch = None       # state epoch of the pool cache below
        self._blob_cache = None       # host (used, gen), and the lowest
        #   slot that may be free
        self._pool_own = None         # state epoch whose pool leaves the
        #   host blob ops cloned, and may write in place
        # Telemetry: host behaviours' runs (the device lanes never see
        # them; profile() merges both), the tracer (causal tracing on)
        # and the analysis hook (attached by run() at analysis >= 1).
        self._beh_host_runs: collections.Counter = collections.Counter()
        self._tracer = None
        self._analysis = None
        self._last_retire_t = None    # host clock at the last retire
        self._last_counters: Dict[str, int] = {}   # cumulative aux
        #   counters at the last retire (totals["processed"], ...)

    @property
    def state(self) -> Optional[RtState]:
        """The world in its global layout. On a mesh a window leaves it
        resident on its shards (parallel/mesh.py's `Sharded`), and the
        first read after the window joins it (under DistComm a
        collective, made by every rank at the same program point)."""
        return world_of(self._state)

    @state.setter
    def state(self, v) -> None:
        # Any state write may have created device work the last window's
        # aux cannot know about: the quiescence skip must not trust it,
        # and a window in flight when the write landed is not
        # authoritative (its epoch no longer matches). It may also have
        # claimed or freed slots (device spawns and destroys): the host
        # freelists are stale until `_rebuild_freelists`.
        self._state = v
        self._freelist_key = None
        self._device_dirty = True
        self._state_epoch = getattr(self, "_state_epoch", 0) + 1

    # ---- construction (≙ pony_init) ----
    def declare(self, atype: ActorTypeMeta, capacity: int) -> "Runtime":
        self.program.declare(atype, capacity)
        return self

    def start(self) -> "Runtime":
        """≙ pony_init. The flight recorder and the watchdog arm before
        the first device call, so a start() that hangs (CUDA context
        creation, a kernel build) trips the watchdog: postmortem on
        disk, PonyStallError raised."""
        self._apply_defaults_and_pin()
        from .. import flight as _flight
        self._flight = _flight.FlightRecorder(self, self.opts.flight_windows)
        self._stamp("backend-init")
        if self.opts.watchdog_s is not None:
            self._watchdog = _flight.Watchdog(self, self.opts.watchdog_s)
            self._watchdog.start()
        try:
            self._start_world()
        except KeyboardInterrupt:
            stall = self._stall_from_interrupt()
            if stall is not None:
                raise stall from None
            raise
        if self.opts.cost_capture:
            # Measured device costs (costs.py): one step and one
            # one-tick window under the byte census, on a copy of the
            # state (the world does not advance), judged against the
            # modelled bytes/msg, so /metrics and every postmortem
            # carry measured numbers beside the modelled ones.
            from .. import costs as _costs
            _costs.capture(self, force=True)
            _costs.measured_block(self)
        if self.opts.metrics_port is not None:
            from .. import metrics as _metrics
            self._metrics = _metrics.MetricsServer(self,
                                                   self.opts.metrics_port)
            self._metrics.update_now(self)
        if self.opts.checkpoint_every_s is not None:
            from .. import serialise as _serialise
            self._ckpt = _serialise.Checkpointer(self)
        self._stamp("idle")
        return self

    def register_poller(self, poller) -> None:
        """poller.poll(rt) is called at every host boundary of run(); it
        may send messages or raise (the chaos harness's coded fatal,
        testing.fatal_at_boundary). While a poller is registered a
        quiescent run polls a few more boundaries before it ends, as the
        JAX package's does."""
        self._bridge_pollers.append(poller)

    # ---- outside event sources (≙ asio/asio.c noisy accounting) ----
    def add_noisy(self) -> None:
        """One more outside source (a socket, a timer, a lookup) that may
        still send: a quiescent run waits while any is held."""
        self._noisy += 1

    def remove_noisy(self) -> None:
        self._noisy = max(0, self._noisy - 1)

    def attach_bridge(self):
        """Create (once) and register the ASIO bridge for this runtime
        (≙ ponyint_asio_start, asio/asio.c:47-56): OS events become actor
        messages at host boundaries (bridge/)."""
        if self.bridge is None:
            from ..bridge import Bridge
            self.bridge = Bridge(self)
            self.register_poller(self.bridge)
        return self.bridge

    def attach_net(self):
        """Create (once) the TCP/UDP layer (≙ packages/net over
        lang/socket.c) on top of the bridge (net/)."""
        if self.net is None:
            from ..net import Net
            self.net = Net(self)
        return self.net

    def attach_resolver(self):
        """Create (once) the asynchronous DNS resolver (≙ the addrinfo
        surface of lang/socket.c, delivered as actor messages)."""
        if self.resolver is None:
            from ..net.dns import Resolver
            self.resolver = Resolver(self)
        return self.resolver

    def attach_processes(self):
        """Create (once) the child-process monitor (≙ packages/process
        over lang/process.c): pipes through the bridge, exits reaped at
        host boundaries (process/)."""
        if self.procs is None:
            from ..process import Processes
            self.procs = Processes(self)
        return self.procs

    def files_auth(self):
        """Root file-system capability (≙ env.root AmbientAuth handed to
        the Main actor; see files.py)."""
        from ..files import FilesAuth
        return FilesAuth(FilesAuth._token)

    def ambient_auth(self) -> "AmbientAuth":
        """The root authority object (≙ env.root: AmbientAuth,
        packages/builtin/ambient_auth.pony). Narrower tokens —
        stdlib.backpressure.ApplyReleaseBackpressureAuth, capsicum
        rights — derive from it, so a library can be handed only the
        power it needs."""
        return AmbientAuth(self, AmbientAuth._token)

    def _apply_defaults_and_pin(self) -> None:
        if self._opts_defaulted:
            overrides = {}
            for atype, _cap in self.program._declared:
                overrides.update(getattr(atype, "RUNTIME_DEFAULTS", {}))
            if overrides:
                self.opts = dataclasses.replace(self.opts, **overrides)
                self.program.opts = self.opts
        if self.opts.pin >= 0:   # ≙ --ponypin (start.c:75-94): pin the
            # host thread that runs this runtime (its "scheduler")
            try:
                self._pre_pin_affinity = os.sched_getaffinity(0)
                os.sched_setaffinity(0, {self.opts.pin})
            except OSError as e:
                raise ValueError(
                    f"cannot pin host thread to core {self.opts.pin}: "
                    f"{e}") from None

    def _make_mesh(self):
        """The mesh of a sharded world (None on one shard): one shard a
        process over torch.distributed when this process is in a job of
        `mesh_shards` ranks (parallel/distributed.py), else every shard
        here, on the CPU, or shard s on CUDA device s mod the device
        count (all four on a one-card machine)."""
        p = self.program.shards
        if p <= 1:
            return None
        from ..parallel import distributed as _dist
        from ..parallel.comm import DistComm
        from ..parallel.mesh import make_mesh
        if _dist.is_initialized() and _dist.device_count() > 1:
            if _dist.device_count() != p:
                raise ValueError(
                    f"mesh_shards={p} in a job of {_dist.device_count()} "
                    "processes: one shard a process")
            return make_mesh(p, [self.device], comm=DistComm())
        if self.device.type == "cuda" and self.device.index is None:
            return make_mesh(p, [f"cuda:{i}" for i in
                                 range(torch.cuda.device_count())])
        return make_mesh(p, [self.device])

    def _start_world(self) -> None:
        self.program.finalize()
        self.state = init_state(self.program, self.opts, self.device)
        self.mesh = self._make_mesh()
        from .. import tuning
        if auto_fields(self.opts):
            # Resolve "auto" formulation choices to measured winners
            # before the window is built: the engine only ever sees
            # concrete options. Calibration runs on throwaway clones of
            # the fresh state; only delivery, pallas and pallas_fused may
            # change, none of which changes the layout or the state.
            self.opts, self.tuning_record = tuning.resolve(
                self.program, self.opts, self.state)
            self.program.opts = self.opts
        # Building the window validates the program (under pallas_fused
        # or delivery="pallas_mega" every body is traced for the kernel,
        # and one the kernel cannot run raises here). A kernel that
        # calibration built is loaded from ops/_build.py's cache.
        self._multi_g = engine.build_multi_step_gated(self.program,
                                                      self.opts, self.mesh)
        if self.device.type == "cuda" and self._multi_g.fused:
            fused_dispatch.compile_all(self._multi_g.fused)
        if self.device.type == "cuda" and isinstance(
                self._multi_g, megakernel.MegaWindow):
            self._multi_g.build()
        qi = self.opts.quiesce_interval
        self._qi_auto = qi == "auto"
        if self._qi_auto:
            qi = tuning.resolve_quiesce_interval(self.program, self.opts,
                                                 self.device)
            lo = self.opts.quiesce_interval_min
            hi = self.opts.quiesce_interval_max
        else:
            qi = max(1, int(qi))
            lo = hi = qi
        self._qi_loaded = qi
        self._controller = WindowController(qi, lo, hi)
        self.opts = dataclasses.replace(self.opts, quiesce_interval=qi)
        self.program.opts = self.opts
        self._probe = engine.StopProbe(self.device)
        self._zero_aux = engine.zero_aux(self.device)
        # Inject buffers carry the trace rows when tracing is on.
        w1 = 1 + self.opts.msg_words + self.opts.trace_lanes
        k = self.opts.inject_slots
        if self.opts.tracing:
            from ..tracing import Tracer
            self._tracer = Tracer(
                self.opts.trace_sample, self.opts.trace_seed,
                beh_names=[f"{b.actor_type.__name__}.{b.name}"
                           for b in self.program.behaviour_table])
        self._empty_inject = (
            torch.full((k,), -1, dtype=torch.int32, device=self.device),
            torch.zeros((w1, k), dtype=torch.int32, device=self.device))
        if self.device.type == "cuda":
            # A small ring of pinned rows: at most two windows are in
            # flight, and a row is reused only after its window retired.
            self._aux_host = torch.zeros((4, len(engine.StepAux._fields)
                                          + 1), dtype=torch.int32,
                                         pin_memory=True)
            self._aux_slot = 0
        for cohort in self.program.cohorts:
            self._free[cohort.atype.__name__] = list(
                range(cohort.capacity - 1, -1, -1))

    def _replace(self, **kw) -> RtState:
        return dataclasses.replace(self.state, **kw)

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(device=self.device,
                                                 dtype=dtype)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host int32 array → device without synchronising the stream
        (a copy from pageable memory would): staged through pinned
        memory and copied asynchronously on CUDA."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.int32))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # ---- spawning (≙ pony_create, actor.c:688-734) ----
    def spawn(self, atype: ActorTypeMeta, **fields) -> int:
        """Allocate one actor (see `spawn_many`); returns its id."""
        return int(self.spawn_many(atype, 1, **{
            k: np.asarray([v]) for k, v in fields.items()})[0])

    def spawn_many(self, atype: ActorTypeMeta, count: int,
                   **fields) -> np.ndarray:
        """Allocate `count` slots of a cohort and set initial state
        columns (scalars broadcast, or [count] arrays). Returns the global
        actor ids. Once the device may have claimed or freed slots
        (device spawns, destroys), the freelists are first rebuilt from
        the device state, at most once per state write."""
        if self._state is None:
            raise RuntimeError("call start() before spawn()")
        cohort = self.program.by_type[atype]
        unknown = set(fields) - set(atype.field_specs)
        if unknown:
            raise TypeError(f"{atype.__name__} has no fields {unknown}")
        self._check_ref_fields(atype, fields)
        if not cohort.host and (self.program.has_device_spawns
                                or self.steps_run) \
                and self._freelist_key is None:
            self._rebuild_freelists()
        fkey = self._freelist_key
        free = self._free[atype.__name__]
        if len(free) < count:
            raise RuntimeError(
                f"cohort {atype.__name__} capacity exhausted "
                f"({cohort.capacity} declared)")
        # The last `count` entries, in the order `count` pops take them.
        slots = np.array(free[len(free) - count:][::-1], np.int64)
        del free[len(free) - count:]
        ids = np.asarray(cohort.slot_to_gid(slots), np.int32)
        if cohort.host:
            # A host actor's state lives here, not in device columns.
            for i, gid in enumerate(ids):
                st = {}
                for fname, spec in atype.field_specs.items():
                    v = np.asarray(fields.get(
                        fname, -1 if pack.is_ref(spec) else 0))
                    st[fname] = v.reshape(-1)[i % max(v.size, 1)].item() \
                        if v.ndim else v.item()
                self._host_state[int(gid)] = st
            type_state = self.state.type_state
        else:
            cols = self._tensor(cohort.slot_to_col(slots), torch.int64)
            ts = dict(self.state.type_state[atype.__name__])
            for fname, spec in atype.field_specs.items():
                col = ts[fname].clone()
                if fname in fields:
                    val = self._tensor(fields[fname], col.dtype)
                    col[cols] = val.expand(count) if val.ndim == 0 else val
                else:
                    # Reused slots must not leak a previous life's state.
                    col[cols] = pack.null_word(spec)
                ts[fname] = col
            type_state = {**self.state.type_state, atype.__name__: ts}
        gids = self._tensor(ids, torch.int64)
        alive = self.state.alive.clone()
        alive[gids] = True
        pinned = self.state.pinned.clone()
        pinned[gids] = True
        self.state = self._replace(type_state=type_state, alive=alive,
                                   pinned=pinned)
        # Our own pops kept the freelists in step with the state.
        self._freelist_key = fkey
        return ids

    def _rebuild_freelists(self) -> None:
        """Every cohort's freelist from the device state. A slot is free
        only if it is dead, its mailbox is drained and no message
        addressed to it waits in the spill: the condition the device's
        own reservations use (engine.free_row_list), so a host spawn
        never takes a row the device claimed, nor one that a previous
        life's spilled message would reach."""
        st = self.state
        alive = st.alive.cpu().numpy()
        occ = (st.tail - st.head).cpu().numpy()
        dsp = st.dspill_tgt.cpu().numpy()
        rsp = st.rspill_tgt.cpu().numpy()
        n = self.program.total
        nl = self.program.n_local
        spill_hit = np.zeros((n,), bool)
        # Receiver-spill targets are rows of their shard; route-spill
        # targets are global ids.
        dsp = np.where(dsp >= 0, dsp + np.arange(dsp.shape[0])
                       // self.opts.spill_cap * nl, -1)
        spill_hit[dsp[(dsp >= 0) & (dsp < n)]] = True
        spill_hit[rsp[(rsp >= 0) & (rsp < n)]] = True
        free_ok = ~alive & (occ == 0) & ~spill_hit
        for cohort in self.program.device_cohorts:
            # Highest slot first, as the initial freelist is ordered.
            slots = np.arange(cohort.capacity - 1, -1, -1)
            gids = np.asarray(cohort.slot_to_gid(slots))
            self._free[cohort.atype.__name__] = [
                int(x) for x in slots[free_ok[gids]]]
        self._freelist_key = "synced"

    def set_fields(self, atype: ActorTypeMeta, ids, **fields):
        """Overwrite state columns for existing actors (host-side poke,
        e.g. wiring refs once ids are known). ids are global actor ids."""
        cohort = self.program.by_type[atype]
        self._check_ref_fields(atype, fields)
        if cohort.host:
            for i, aid in enumerate(np.asarray(ids).reshape(-1)):
                st = self._host_state.setdefault(int(aid), {})
                for fname, v in fields.items():
                    v = np.asarray(v).reshape(-1)
                    st[fname] = v[i % v.size].item()
            return
        cols = self._tensor(cohort.gid_to_col(np.asarray(ids)), torch.int64)
        ts = dict(self.state.type_state[atype.__name__])
        for fname, v in fields.items():
            col = ts[fname].clone()
            col[cols] = self._tensor(v, col.dtype)
            ts[fname] = col
        self.state = self._replace(
            type_state={**self.state.type_state, atype.__name__: ts})

    # ---- sendability checks (≙ type/safeto.c + expr/call.c at the host
    # boundary; out-of-range ids dead-letter on the device) ----
    def _check_send_target(self, target: int, bdef: BehaviourDef) -> None:
        if 0 <= target < self.program.total:
            owner = self.program.cohort_of(int(target)).atype.__name__
            want = bdef.actor_type.__name__
            if owner != want:
                raise TypeError(
                    f"sendability: actor {target} is a {owner}; it cannot "
                    f"receive {want}.{bdef.name}")

    def _check_ids_in_cohort(self, v, want: str, what: str) -> None:
        v = np.asarray(v, np.int64).reshape(-1)
        nl = self.program.n_local
        c = self.program.by_type_name(want)
        lid = v % max(nl, 1)
        bad = ((v >= 0) & (v < self.program.total)
               & ((lid < c.local_start) | (lid >= c.local_stop)))
        if bad.any():
            x = int(v[bad][0])
            owner = self.program.cohort_of(x).atype.__name__
            raise TypeError(
                f"sendability: {what} expects Ref[{want}] but id {x} "
                f"is a {owner}")

    def _check_ref_args(self, specs, args, what: str) -> None:
        for spec, v in zip(specs, args):
            want = pack.ref_target(spec)
            if want is not None:
                self._check_ids_in_cohort(v, want, what)

    def _check_ref_fields(self, atype: ActorTypeMeta, fields) -> None:
        for fname, v in fields.items():
            want = pack.ref_target(atype.field_specs.get(fname))
            if want is not None:
                self._check_ids_in_cohort(
                    v, want, f"field {atype.__name__}.{fname}")

    # ---- external sends (≙ pony_sendv from outside the runtime) ----
    def _check_host_iso_blob(self, h: int) -> None:
        """An iso Blob handle leaving the host must be host-owned (in
        _host_blobs: blob_store mints ownership, host delivery of an iso
        Blob argument transfers it). Anything else — a second send, a
        stale handle, a forged int — is an aliased move, rejected as
        HostHeap.send_iso and the device trace's use-after-move are
        (null, -1, rides freely)."""
        if h >= 0 and h not in self._host_blobs:
            from ..hostmem import CapabilityError
            raise CapabilityError(
                f"capability: aliased move — iso blob handle {h} is not "
                "owned by the host (already sent, freed, or never "
                "obtained via blob_store/host delivery); an iso is "
                "moved-unique — use a BlobVal parameter for shared "
                "payloads")

    def _move_host_blobs(self, specs, cols) -> None:
        """Iso Blob arguments of a send leave the host: check each is
        host-owned, then drop the host's roots (the in-flight message
        keeps the blob alive until its receiver owns it). Val handles
        alias: the host keeps its root until blob_release."""
        if self.opts.blob_slots <= 0:
            return
        isos = [np.asarray(c).reshape(-1) for spec, c in zip(specs, cols)
                if pack.is_blob(spec) and not pack.is_blob_val(spec)]
        for col in isos:
            for a in col:
                self._check_host_iso_blob(int(a))
        for col in isos:
            for a in col:
                self._host_blobs.discard(int(a))

    def _trace_context(self, trace):
        """A send's causal-trace context as (trace id, parent span), or
        (-1, 0) untraced. `trace`: None, the deterministic sampler
        decides (1 in trace_sample); an int, an explicit trace id (always
        traced, its root span got or created); a (trace id, span id)
        tuple, the continuation of a span (a host behaviour's sends)."""
        tr = self._tracer
        if tr is None:
            return -1, 0
        step = self.steps_run
        if isinstance(trace, tuple):
            return int(trace[0]), int(trace[1])
        if trace is not None:
            tid = int(trace)
            return tid, tr.root_span(tid, step)
        if tr.sample():
            return tr.begin(step)
        return -1, 0

    def send(self, target: int, behaviour_def: BehaviourDef, *args,
             trace=None):
        """Queue one message for `target` (≙ pony_sendv from outside the
        runtime). `trace` (causal tracing on): see `_trace_context`."""
        if behaviour_def.global_id is None:
            raise RuntimeError(f"{behaviour_def} not part of this program")
        self._check_send_target(int(target), behaviour_def)
        self._check_ref_args(behaviour_def.arg_specs, args,
                             f"{behaviour_def.actor_type.__name__}."
                             f"{behaviour_def.name}")
        tlanes = self.opts.trace_lanes
        words = np.zeros((1 + self.opts.msg_words + tlanes,), np.int32)
        words[0] = behaviour_def.global_id
        words[1:1 + self.opts.msg_words] = _host_pack_args(
            behaviour_def.arg_specs, args, self.opts.msg_words)
        tctx = None
        if tlanes:
            tid, psid = self._trace_context(trace)
            words[-2], words[-1] = tid, psid
            if tid >= 0:
                tctx = (tid, psid)
        # Iso payloads move with the message (≙ the gc.c send handler),
        # after packing validated, so a failed send never poisons a
        # handle: a host-heap handle goes in flight (hostmem.HostHeap),
        # a blob handle stops being a host root.
        if self._heap is not None:
            for spec, a in zip(behaviour_def.arg_specs, args):
                if (pack.cap_mode(spec) == "iso"
                        and not pack.is_blob(spec) and int(a) > 0):
                    self._heap.send_iso(int(a))
        self._move_host_blobs(behaviour_def.arg_specs, args)
        # Host senders (the API and host behaviours both run here) to
        # host targets take the fast lane; everything else rides the
        # device inject path. A sender's messages to one receiver always
        # take one lane, so per-sender-pair FIFO holds.
        if (self.opts.host_fastpath
                and 0 <= int(target) < self.program.total
                and self.program.cohort_of(int(target)).host):
            # The fast lane never touches the device: the trace context
            # rides the queue entry.
            self._host_fast_q.append((int(target), words, tctx))
        else:
            self._inject_q.append((int(target), words))

    def bulk_send(self, targets, behaviour_def: BehaviourDef, *arg_cols,
                  trace=None):
        """Mass-enqueue one message per (distinct) target directly into
        the device mailboxes — the setup path for benchmark-scale
        seeding. Targets must be unique within one call.

        `trace` (causal tracing on): an explicit trace id every seeded
        message joins (one root, a branch each). None: untraced (the
        sampler never fires here)."""
        targets = np.asarray(targets, np.int64)
        if len(np.unique(targets)) != len(targets):
            raise ValueError("bulk_send targets must be distinct; use "
                             "send() for repeated targets")
        self._check_ids_in_cohort(
            targets, behaviour_def.actor_type.__name__,
            f"bulk_send target of {behaviour_def.actor_type.__name__}."
            f"{behaviour_def.name}")
        self._check_ref_args(behaviour_def.arg_specs, arg_cols,
                             f"{behaviour_def.actor_type.__name__}."
                             f"{behaviour_def.name}")
        self._move_host_blobs(behaviour_def.arg_specs, arg_cols)
        k = len(targets)
        words = np.zeros((k, 1 + self.opts.msg_words), np.int32)
        words[:, 0] = behaviour_def.global_id
        specs = behaviour_def.arg_specs
        if len(arg_cols) != len(specs):
            raise TypeError(
                f"behaviour takes {len(specs)} args, got {len(arg_cols)}")
        off = 1
        for spec, col in zip(specs, arg_cols):
            col = np.asarray(col)
            if isinstance(spec, pack._VecSpec):
                if col.shape != (k, spec.n):
                    raise TypeError(
                        f"bulk_send column for {spec.__name__} must have "
                        f"shape ({k}, {spec.n}), got {col.shape}")
                dt = np.float32 if spec.base is pack.F32 else np.int32
                blk = np.ascontiguousarray(col.astype(dt))
                words[:, off:off + spec.n] = blk.view(np.int32)
                off += spec.n
            elif spec is pack.F32:
                words[:, off] = col.astype(np.float32).view(np.int32)
                off += 1
            else:
                words[:, off] = col.astype(np.int32)
                off += 1
        tg = self._tensor(targets, torch.int64)
        t_at = self.state.tail[tg].cpu().numpy()
        occ = t_at - self.state.head[tg].cpu().numpy()
        if (occ >= self.opts.mailbox_cap).any():
            full = targets[occ >= self.opts.mailbox_cap]
            raise RuntimeError(
                f"bulk_send would overflow {len(full)} full mailbox(es) "
                f"(first target {int(full[0])}); drain with run() first or "
                "raise mailbox_cap")
        slot = self._tensor(t_at.astype(np.int64) % self.opts.mailbox_cap,
                            torch.int64)
        cname = behaviour_def.actor_type.__name__
        cohort = self.program.by_type_name(cname)
        cols = self._tensor(cohort.gid_to_col(targets), torch.int64)
        w1c = 1 + cohort.msg_words
        cbuf = self.state.buf[cname].clone()
        cbuf[slot, :, cols] = self._tensor(words[:, :w1c])
        tail = self.state.tail.clone()
        tail[tg] += 1
        extra = {}
        if self._tracer is not None:
            # Stamp (or clear: ring slots are reused, and a stale lane
            # would adopt an earlier message's trace) every written
            # slot's trace rows.
            lanes = np.full((k, 2), -1, np.int32)
            lanes[:, 1] = 0
            if trace is not None:
                tid = int(trace)
                lanes[:, 0] = tid
                lanes[:, 1] = self._tracer.root_span(tid, self.steps_run)
            tb = self.state.trace_buf[cname].clone()
            tb[slot, :, cols] = self._tensor(lanes)
            extra["trace_buf"] = {**self.state.trace_buf, cname: tb}
        if cname in self.state.qwait_enq:
            # The profiler's enqueue stamp (analysis >= 1): the seeding
            # bypasses the delivery that writes it, so the queue waits of
            # seeded messages count from this boundary.
            qe = self.state.qwait_enq[cname].clone()
            qe[slot, cols] = self.steps_run
            extra["qwait_enq"] = {**self.state.qwait_enq, cname: qe}
        self.state = self._replace(buf={**self.state.buf, cname: cbuf},
                                   tail=tail, **extra)

    def _drain_inject_tracked(self):
        """The next inject batch (targets [K], words [1+W, K]) and the
        consumed (target, words) pairs in order, so a gated-out window
        can re-queue them. At most one drain batch per target per window
        (host-side flow control, as in the reference)."""
        if not self._inject_q:
            return (*self._empty_inject, [])
        k = self.opts.inject_slots
        w1 = 1 + self.opts.msg_words + self.opts.trace_lanes
        tgt = np.full((k,), -1, np.int32)
        words = np.zeros((w1, k), np.int32)
        taken: Dict[int, int] = {}
        quota: Dict[int, int] = {}
        held: List[Any] = []
        consumed: List[Any] = []
        i = 0
        while i < k and self._inject_q:
            t, w = self._inject_q.popleft()
            q = quota.get(t)
            if q is None:
                q = quota[t] = (self.program.cohort_of(t).batch
                                if 0 <= t < self.program.total
                                else self.opts.batch)
            c = taken.get(t, 0)
            if c >= q:
                held.append((t, w))
                continue
            taken[t] = c + 1
            consumed.append((t, w))
            tgt[i] = t
            words[:, i] = w
            i += 1
        self._inject_q.extendleft(reversed(held))
        return self._upload(tgt), self._upload(words), consumed

    # ---- host-cohort dispatch (≙ the main-thread scheduler's path; on
    # a mesh every shard's host rows, at the tail of its row range) ----
    @property
    def _host_rows(self) -> np.ndarray:
        """Global ids of every host-cohort mailbox row, shard by shard
        (host rows are each shard's rows from first_host_row on, not a
        suffix of the global columns)."""
        rows = self._host_rows_cache
        if rows is None:
            fh, nl = self.program.first_host_row, self.program.n_local
            rows = np.concatenate(
                [s * nl + np.arange(fh, nl)
                 for s in range(self.program.shards)]).astype(np.int64)
            self._host_rows_cache = rows
        return rows

    def _drain_host(self) -> bool:
        """Run the host behaviours of every message waiting in a host
        cohort's mailbox rows, each actor's in FIFO order up to a yield,
        and write the rows' heads back. Returns whether any ran."""
        rows = self._host_rows
        if rows.size == 0:
            return False
        self._await_device()
        st = self.state
        idx = self._tensor(rows, torch.int64)
        ht = torch.stack([st.head[idx], st.tail[idx]]).cpu().numpy()
        head, pending = ht[0], ht[1] - ht[0]
        if not pending.any():
            return False
        c = self.opts.mailbox_cap
        bufs: Dict[str, np.ndarray] = {}
        tbufs: Dict[str, np.ndarray] = {}     # the trace rows (tracing)
        new_head = head.astype(np.int64)
        for i in np.nonzero(pending)[0]:
            aid = int(rows[i])
            cohort = self.program.cohort_of(aid)
            cname = cohort.atype.__name__
            cbuf = bufs.get(cname)
            if cbuf is None:       # [cap, 1 + W_c, capacity], the ring
                cbuf = bufs[cname] = st.buf[cname].cpu().numpy()
                if self._tracer is not None:      # [cap, 2, capacity]
                    tbufs[cname] = st.trace_buf[cname].cpu().numpy()
            col = int(cohort.gid_to_col(aid))
            consumed = 0
            for k in range(int(pending[i])):
                slot = (int(head[i]) + k) % c
                msg = cbuf[slot, :, col]
                tctx = None
                if self._tracer is not None:
                    tlane = tbufs[cname][slot, :, col]
                    if int(tlane[0]) >= 0:
                        tctx = (int(tlane[0]), int(tlane[1]))
                consumed += 1
                ctx = self._dispatch_host_msg(aid, cohort, int(msg[0]),
                                              msg[1:], trace_ctx=tctx)
                if ctx is not None and ctx.yield_flag:
                    break
            new_head[i] = head[i] + consumed
        head_all = st.head.clone()
        head_all[idx] = self._upload(           # heads wrap as int32
            (new_head & 0xffffffff).astype(np.uint32).view(np.int32))
        self.state = self._replace(head=head_all)
        return True

    def _dispatch_host_msg(self, aid: int, cohort, gid: int, payload,
                           trace_ctx=None):
        """Dispatch one message to a host-resident actor (shared by the
        mailbox drain and the fast lane). Returns the HostContext, or
        None for a message its type has no behaviour for. `trace_ctx`,
        the message's (trace id, parent span) where tracing followed it
        here: the dispatch becomes an odd host span, and the behaviour's
        sends continue the chain."""
        table = self.program.behaviour_table
        bdef = table[gid] if 0 <= gid < len(table) else None
        if bdef is None or bdef.actor_type is not cohort.atype:
            self.totals["badmsg"] += 1
            return None
        ctx = HostContext(self, aid)
        if trace_ctx is not None and self._tracer is not None:
            tid, psid = trace_ctx
            ctx.trace_ctx = (tid, self._tracer.host_span(
                tid, psid, gid, aid, self.steps_run))
        st = self._host_state.get(aid, {})
        args = _host_unpack_args(bdef.arg_specs, payload)
        if self._heap is not None:
            # Delivery completes an iso move: the receiver may peek or
            # unbox now (≙ the gc.c recv handler).
            for spec, a in zip(bdef.arg_specs, args):
                if pack.cap_mode(spec) == "iso" and int(a) > 0:
                    self._heap.receive(int(a))
        if self.opts.blob_slots > 0:
            # An iso Blob delivered to a host actor is the host's now (a
            # GC root, and legitimately sent on).
            for spec, a in zip(bdef.arg_specs, args):
                if (pack.is_blob(spec) and not pack.is_blob_val(spec)
                        and int(a) >= 0):
                    self._host_blobs.add(int(a))
        if self._flight is not None:
            # The recent-host-mail lane of the black box.
            self._flight.mail(aid, f"{cohort.atype.__name__}.{bdef.name}")
        try:
            st2 = bdef.fn(ctx, st, *args)
        except PonyError as e:
            # ≙ a behaviour-local try ... else (int-coded errors): the
            # code is recorded and the actor goes on.
            self._host_errors[aid] = e.code
            self._host_error_locs[aid] = e.loc
            self.totals["host_errors"] += 1
            self._error_counts[("PonyError", e.code)] += 1
            st2 = st
        self._host_state[aid] = st2 if st2 is not None else st
        self.totals["host_processed"] += 1
        if self.opts.analysis >= 1:
            self._beh_host_runs[int(gid)] += 1
        if ctx.exit_flag:
            self._exit_code = ctx.exit_code
            self._exit_requested = True
        return ctx

    def _drain_host_fast(self, budget: int) -> bool:
        """Dispatch queued fast-lane messages (host → host sends) up to
        `budget`; leftovers keep the run loop busy. A target with no host
        state was never spawned: the message dead-letters, as a send to a
        dead device actor does."""
        q = self._host_fast_q
        if not q:
            return False
        n = 0
        yielded = set()      # actors that yielded: their batch stops
        held = []            # their remaining messages, in order
        while q and n < budget:
            aid, w, tctx = q.popleft()
            if aid in yielded:
                held.append((aid, w, tctx))
                continue
            n += 1
            if aid not in self._host_state:
                self.totals["deadletter_host"] += 1
                continue
            ctx = self._dispatch_host_msg(
                aid, self.program.cohort_of(aid), int(w[0]),
                w[1:1 + self.opts.msg_words], trace_ctx=tctx)
            if ctx is not None and ctx.yield_flag:
                # ≙ the device drain honouring yield mid-batch
                # (actor.c:675-679); the actor's queue keeps its order.
                yielded.add(aid)
            if self._exit_requested:
                break
        q.extendleft(reversed(held))
        return True

    # ---- the run loop ----
    def _stamp(self, phase: str) -> None:
        """Advance the watchdog phase stamp (flight.py): one int bump and
        one tuple assignment, readable atomically from any thread. The
        run loop stamps every phase change (dispatching, in-flight,
        host-work, quiescent, idle), so "no stamp within the deadline"
        is exactly "no progress"."""
        self._wd_epoch += 1
        self._wd_stamp = (phase, self._wd_epoch, time.monotonic())

    def _fatal(self, exc):
        """Record a coded runtime error (metrics label and postmortem
        evidence) on its way out; returns `exc`."""
        self._error_counts[(type(exc).__name__, error_code(exc))] += 1
        if self._flight is not None:
            self._flight.event("error", cls=type(exc).__name__,
                               code=error_code(exc), message=str(exc))
        return exc

    def _stall_from_interrupt(self):
        """A pending KeyboardInterrupt may be the watchdog's doing
        (flight.Watchdog.trip interrupts the main thread after dumping
        the postmortem): the int-coded stall error, or None for a
        genuine Ctrl-C."""
        wd = self._watchdog
        if wd is None or wd.tripped is None:
            return None
        t = wd.tripped
        return self._fatal(PonyStallError(
            f"runtime stalled: phase {t['phase']!r} made no progress "
            f"for {t['age_s']}s (deadline {t['deadline_s']}s; "
            f"postmortem: {t.get('postmortem') or '(unwritten)'})",
            phase=t["phase"], postmortem=t.get("postmortem", "")))

    def _defer_signals(self):
        """Block SIGINT/SIGTERM delivery across the window's call and the
        assignment of its state, so that a signal handler (the analysis
        SIGTERM dump, SIGQUIT's postmortem) never sees a state half
        replaced. Blocked signals are delivered the moment the mask is
        restored. Returns the previous mask, or None where masking is
        unavailable (not the main thread's business, or no pthreads)."""
        try:
            return signal.pthread_sigmask(
                signal.SIG_BLOCK, {signal.SIGINT, signal.SIGTERM})
        except (AttributeError, ValueError, OSError):
            return None

    def _restore_signals(self, prev) -> None:
        if prev is not None:
            signal.pthread_sigmask(signal.SIG_SETMASK, prev)

    @staticmethod
    def _wait_event(event) -> None:
        """Wait until `event` (a torch.cuda.Event) completed, polling it
        from Python so that signals land meanwhile (WAIT_SPIN_S above
        says why this is not Event.synchronize())."""
        if event.query():
            return
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WAIT_SPIN_S:
            time.sleep(0)
            if event.query():
                return
        nap = WAIT_SLEEP_MIN_S
        while not event.query():
            time.sleep(nap)
            nap = min(2 * nap, WAIT_SLEEP_MAX_S)

    def _await_device(self) -> None:
        """Wait, interruptibly, until the card has run everything
        enqueued so far. The run loop's host work calls it before it
        reads device memory (`_drain_host`, `gc`, `profile`, the level
        2-3 analysis drains), so that no read blocks inside C behind a
        wedged window; the host API's other reads (spawn, state_of,
        ...) run between runs, or in a host behaviour after
        `_drain_host` waited."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._wait_event(ev)

    def _dispatch_window(self, budget: int, force: bool, prev_aux,
                         pipelined: bool = False) -> Dict[str, Any]:
        """Enqueue one gated window and start the non-blocking copy of
        its control scalars; returns the in-flight record. A window
        enqueued behind an unretired one (`pipelined`) leaves the device
        no gap; any other is charged the host's time since the last
        retire (the analysis CSV's host_gap_us)."""
        if pipelined:
            self._rl_pipelined += 1
            gap_ns = 0
        else:
            self._rl_synced += 1
            gap_ns = 0 if self._last_retire_t is None else max(
                0, int((time.perf_counter() - self._last_retire_t) * 1e9))
        inj_t, inj_w, consumed = self._drain_inject_tracked()
        self._stamp("dispatching")
        mask = self._defer_signals()
        try:
            st2, aux, kdev = self._multi_g(
                self._state, inj_t, inj_w, max(1, budget), force, prev_aux,
                self._probe)
            self.state = st2
            epoch = self._state_epoch
        finally:
            self._restore_signals(mask)
        # From here the window is the card's: the watchdog's deadline
        # now covers its completion.
        self._stamp("in-flight")
        vec = engine.aux_vector(aux, kdev)
        event = None
        if self.device.type == "cuda":
            host = self._aux_host[self._aux_slot]
            self._aux_slot = (self._aux_slot + 1) % 4
            host.copy_(vec, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            vec = host
        return {"aux": aux, "vec": vec, "event": event,
                "budget": int(budget), "consumed": consumed,
                "epoch": epoch, "gap_ns": gap_ns, "pipelined": pipelined}

    def _retire_window(self, win: Dict[str, Any]):
        """Wait for an in-flight window's scalars and fold them into host
        accounting. A gated-out window (0 ticks) changed nothing: its
        injections go back to the front of the queue."""
        if win["event"] is not None:
            self._wait_event(win["event"])
        # The event completed: the scalars are in pinned host memory and
        # tolist() reads them without waiting (on the CPU they are a CPU
        # tensor).
        k, a = engine.aux_from_vector(win["vec"].tolist())
        self._last_retire_t = time.perf_counter()
        self._stamp("host-work")
        if k == 0:
            if win["consumed"]:
                self._inject_q.extendleft(reversed(win["consumed"]))
                self._rl_requeued += len(win["consumed"])
            return 0, a
        if self._state_epoch == win["epoch"]:
            self._device_dirty = False
        self._last_aux = a
        self.steps_run += k
        if self.opts.debug_checks:
            self.check_invariants()
        # The aux counters are cumulative int32: accumulate their mod 2^32
        # deltas, so the fetch cadence does not matter.
        for key, cur in (("processed", a.n_processed & 0xFFFFFFFF),
                         ("delivered", a.n_delivered & 0xFFFFFFFF)):
            last = self._last_counters.get(key, 0)
            self.totals[key] += (cur - last) & 0xFFFFFFFF
            self._last_counters[key] = cur
        self._rl_windows += 1
        self._rl_gap_ns += win["gap_ns"]
        self._win_hist[min(WIN_BUCKETS - 1, max(0, k.bit_length() - 1))] += 1
        attention = (a.host_pending or a.exit_flag or a.spill_overflow
                     or a.spawn_fail or a.blob_fail or a.blob_budget_fail)
        self._controller.observe(k, win["budget"], attention,
                                 qw_p99=a.qw_p99)
        # The black box keeps this window's already-fetched scalars: host
        # ints, one bounded-deque append, no device traffic.
        if self._flight is not None:
            self._flight.window(self.steps_run, k, win["budget"],
                                win["gap_ns"] / 1e3, win["pipelined"], a)
        if self._analysis is not None:
            if self.opts.analysis >= 2:
                self._await_device()      # the drains read the card
            self._analysis.window(a, ticks=k, gap_us=win["gap_ns"] / 1e3)
        if self._metrics is not None:
            self._metrics.maybe_update(self)
        return k, a

    def _fatal_checks(self, a) -> None:
        if a.spill_overflow:
            raise self._fatal(SpillOverflowError(
                f"spill overflow at step {self.steps_run}"))
        if a.spawn_fail:
            raise self._fatal(SpawnCapacityError(
                f"device spawn found no free slot by step "
                f"{self.steps_run}"))
        if a.blob_fail:
            raise self._fatal(BlobCapacityError(
                f"device blob_alloc found no free pool slot by step "
                f"{self.steps_run} — the pool is exhausted: raise "
                "RuntimeOptions.blob_slots, or free blobs "
                "(ctx.blob_free) faster"))
        if a.blob_budget_fail:
            raise self._fatal(BlobCapacityError(
                f"device blob_alloc exceeded its per-tick reservation "
                f"budget by step {self.steps_run} — more allocating "
                "dispatches than BLOB_DISPATCHES in one tick (free "
                "pool slots may remain): raise the actor class's "
                "BLOB_DISPATCHES (or lower its batch)"))

    @staticmethod
    def _clean_busy(a) -> bool:
        """Host-side twin of engine.aux_go."""
        return (a.device_pending and not a.host_pending
                and not a.exit_flag and not a.spill_overflow
                and not a.spawn_fail and not a.blob_fail
                and not a.blob_budget_fail)

    def run(self, max_steps: Optional[int] = None) -> int:
        """Run windows until quiescence, exit, or `max_steps` ticks
        (≙ pony_start). Returns the exit code."""
        if self._state is None:
            raise RuntimeError("call start() first")
        if self.opts.analysis >= 1 and self._analysis is None:
            from .. import analysis as _analysis_mod
            _analysis_mod.attach(self)
        max_steps = max_steps or self.opts.max_steps
        ctrl = self._controller
        pipelining = bool(self.opts.pipeline)
        steps_this_run = 0
        skipped = 0
        a = None          # newest retired aux; None forces a first window
        win = None        # the one in-flight (unretired) window
        idle_polls = 0
        self._last_retire_t = None
        self._last_run_crashed = False
        # SIGQUIT dumps the flight recorder and the run goes on (the
        # operator's "what is it doing right now" key, ^\ on a tty).
        prev_quit = None
        if self._flight is not None and hasattr(signal, "SIGQUIT"):
            def _quit_dump(_signum, _frame):
                self._flight.dump(reason="SIGQUIT")
            try:
                prev_quit = signal.signal(signal.SIGQUIT, _quit_dump)
            except ValueError:      # not the main thread: no handler
                prev_quit = None
        try:
            while True:
                if win is None:
                    # A boundary where the device is provably quiescent
                    # and nothing needs injecting is host-only: skip the
                    # device dispatch (counts against max_steps).
                    if (a is not None and not a.device_pending
                            and not a.host_pending and not self._inject_q
                            and not self._device_dirty):
                        skipped += 1
                        self._idle_boundaries += 1
                    else:
                        budget = ctrl.window
                        if max_steps is not None:
                            budget = min(budget, max_steps - steps_this_run
                                         - skipped)
                        prev = (engine.aux_to_device(a, self.device)
                                if a is not None else self._zero_aux)
                        win = self._dispatch_window(
                            max(1, budget), force=True, prev_aux=prev)
                        continue
                else:
                    # Pipeline refill: enqueue the next window behind the
                    # in-flight one before reading its scalars; its tick 0
                    # is gated on the device by the in-flight aux.
                    spec = None
                    # A due checkpoint suppresses the next speculation:
                    # the following boundary then has no window in
                    # flight, the quiescent-consistent point a snapshot
                    # needs (a delay of at most one window).
                    ckpt_due = self._ckpt is not None and self._ckpt.due()
                    if pipelining and not ckpt_due and a is not None \
                            and self._clean_busy(a):
                        budget = ctrl.window
                        if max_steps is not None:
                            budget = min(budget, max_steps - steps_this_run
                                         - skipped - win["budget"])
                        if budget >= 1:
                            spec = self._dispatch_window(
                                budget, force=False, prev_aux=win["aux"],
                                pipelined=True)
                    k, a = self._retire_window(win)
                    steps_this_run += k
                    win = spec
                # ---- host boundary for `a` ----
                self._stamp("host-work")
                self._fatal_checks(a)
                if a.exit_flag:
                    self._exit_code = int(a.exit_code)
                    break
                if a.host_pending:
                    self._drain_host()
                for p in self._bridge_pollers:
                    p.poll(self)
                # Fast lane: host → host messages, including those the
                # drain and the pollers just produced, dispatch now,
                # without a device window a hop.
                self._drain_host_fast(self.opts.host_fastpath_budget)
                self._maybe_gc()
                # Periodic crash-safe checkpoint: with no window in
                # flight the retired state and the host queues are
                # exactly what serialise captures. The device→host copy
                # runs now, the write on the checkpointer's thread. A
                # failed checkpoint is counted and recorded; it never
                # takes down the run it exists to protect.
                if self._ckpt is not None and win is None:
                    try:
                        self._ckpt.tick(self, in_flight=False)
                    except Exception as e:          # noqa: BLE001
                        self.totals["checkpoint_errors"] += 1
                        if self._flight is not None:
                            self._flight.event(
                                "checkpoint_failed",
                                error=f"{type(e).__name__}: {e}")
                if self._exit_requested:
                    self._exit_requested = False    # consume the request
                    break
                busy = (a.device_pending or a.host_pending
                        or bool(self._inject_q) or bool(self._host_fast_q)
                        or self._device_dirty)
                if not busy:
                    if win is not None:
                        k2, a2 = self._retire_window(win)
                        steps_this_run += k2
                        win = None
                        if k2 or self._inject_q:
                            if k2:
                                a = a2
                            continue
                    # Quiescent: terminate (≙ the ACK'd CNF token), after
                    # at most 3 cleanup ticks — the unmute pass lags the
                    # drain that satisfies it by one tick. With pollers
                    # registered, a few idle boundaries poll first; while
                    # an outside source is held (add_noisy) the run
                    # waits for it.
                    self._stamp("quiescent")
                    if self._noisy == 0 and (not self._bridge_pollers
                                             or idle_polls > 2):
                        cleanup = 0
                        while (a.any_muted and cleanup < 3
                               and (max_steps is None
                                    or steps_this_run + skipped
                                    < max_steps)):
                            cw = self._dispatch_window(
                                1, force=True,
                                prev_aux=engine.aux_to_device(a,
                                                              self.device))
                            k2, a = self._retire_window(cw)
                            steps_this_run += k2
                            cleanup += 1
                        break
                    idle_polls += 1
                    # Waiting on the outside world: block on the asio
                    # queue when a bridge is attached (the native epoll
                    # thread wakes the wait the instant an event lands,
                    # ≙ a suspended scheduler woken by the ASIO thread,
                    # scheduler.c:1427-1476), else back off. The cap
                    # bounds other pollers' cadence (resolver results).
                    waiter = next((p for p in self._bridge_pollers
                                   if hasattr(p, "wait")), None)
                    if waiter is not None:
                        waiter.wait(0.02)
                    else:
                        time.sleep(min(0.002,
                                       2e-5 * (1 << min(idle_polls, 7))))
                else:
                    idle_polls = 0
                if max_steps is not None \
                        and steps_this_run + skipped >= max_steps:
                    break
        except KeyboardInterrupt:
            # The interrupt may be the watchdog's (flight.Watchdog trips
            # by signalling the main thread after dumping the
            # postmortem): surface the int-coded stall, not a bare ^C.
            stall = self._stall_from_interrupt()
            if stall is not None:
                raise stall from None
            raise
        finally:
            # A tripped watchdog means the card (or a host phase) is
            # wedged: retiring the window in flight, draining host mail
            # or refreshing the metrics would block on the very hang
            # being turned into an error. Skip every device-touching
            # teardown and let the PonyStallError out (the postmortem is
            # the value; the runtime is not restartable after a stall).
            stalled = (self._watchdog is not None
                       and self._watchdog.tripped is not None)
            exc = sys.exc_info()[1]
            # Otherwise an in-flight window's output IS self.state: fold
            # its scalars in, and drain the host mail it surfaced, so the
            # runtime stays consistent for a restart.
            if win is not None and not stalled:
                _k, a2 = self._retire_window(win)
                if a2.host_pending:
                    self._drain_host()
            if exc is not None and not isinstance(exc, PonyStallError):
                # Interrupted between boundaries: deliver the host → host
                # messages already queued, which would otherwise wait for
                # the next run(). (After a stall the wedged behaviour may
                # be on this lane.)
                self._drain_host_fast(self.opts.host_fastpath_budget)
            if prev_quit is not None:
                try:
                    signal.signal(signal.SIGQUIT, prev_quit)
                except ValueError:
                    pass
            self._stamp("idle")
            self._last_run_crashed = (exc is not None
                                      and not isinstance(exc, SystemExit))
            # Crash postmortem: any exceptional exit dumps the black box
            # (a stall's dump was written by the watchdog already).
            if (exc is not None and self._flight is not None
                    and not isinstance(exc, (SystemExit, PonyStallError))):
                self._flight.dump(
                    reason=f"crash: {type(exc).__name__}: {exc}",
                    error_code=error_code(exc))
            if self._metrics is not None and not stalled:
                self._metrics.update_now(self)
        if (self._qi_auto and ctrl.state == "steady"
                and self._rl_windows >= 8
                and ctrl.window != self._qi_loaded):
            from .. import tuning
            tuning.store_quiesce_interval(self.program, self.opts,
                                          ctrl.window, self.device)
            self._qi_loaded = ctrl.window
        return self._exit_code

    def run_loop_stats(self) -> Dict[str, Any]:
        """Run-loop telemetry (metrics, the analysis dump, the
        postmortem): windows retired, pipelined and sync-point
        dispatches, the cumulative host-imposed device-idle gap,
        re-queued gated-out injections, the window-length histogram
        (power-of-two buckets) and the controller snapshot."""
        n = max(1, self._rl_windows)
        return {
            "windows": self._rl_windows,
            "pipelined_dispatches": self._rl_pipelined,
            "sync_dispatches": self._rl_synced,
            "host_gap_us_total": self._rl_gap_ns / 1e3,
            "host_gap_us_mean": self._rl_gap_ns / 1e3 / n,
            "injects_requeued": self._rl_requeued,
            "window_hist": [int(x) for x in self._win_hist],
            "controller": (self._controller.snapshot()
                           if self._controller is not None else None),
        }

    def checkpoint(self, path: Optional[str] = None) -> Optional[str]:
        """Write one snapshot now: to `path` (synchronous, serialise.save)
        or into the periodic ring (the write on the checkpointer's
        thread; needs checkpoint_every_s) — returns the file's path.
        Call between runs only, like serialise.save."""
        from .. import serialise as _serialise
        if path is not None:
            _serialise.save(self, path)
            return path
        if self._ckpt is None:
            raise RuntimeError(
                "no checkpoint ring configured: pass path=, or set "
                "RuntimeOptions.checkpoint_every_s/checkpoint_path")
        seq = self._ckpt.checkpoint(self, force=True)
        return _serialise.checkpoint_file(self._ckpt.prefix, seq)

    def checkpoint_stats(self) -> Optional[Dict[str, Any]]:
        """The checkpointer's telemetry: captures, writes, failures,
        skips, capture and write ms, bytes of the last snapshot, and the
        newest file; None when checkpointing is off."""
        return self._ckpt.stats() if self._ckpt is not None else None

    def request_exit(self, code: int = 0) -> None:
        """Ask the run loop to stop at the next host boundary (≙
        pony_exitcode + the quiescent stop, start.c:345, callable from
        host code outside any behaviour: an input handler, a signal
        callback). A request made before run() is honoured by it."""
        self._exit_code = int(code)
        self._exit_requested = True

    def stop(self, postmortem: bool = False) -> int:
        """Tear down the auxiliaries (≙ pony_stop, start.c:332-351): emit
        the analysis summary and stop its writer thread, take the final
        checkpoint (checkpointing on, the last run neither crashed nor
        stalled) and stop the checkpointer's, the watchdog's and the
        metrics threads. ``postmortem=True`` also dumps the flight
        recorder (the path lands in ``rt._flight.last_dump``). Returns
        the exit code."""
        if postmortem and self._flight is not None:
            self._flight.dump(reason="stop(postmortem=True)")
        a = self._analysis
        if a is not None:
            a.summary()
            a.close()
            self._analysis = None
        b = self.bridge
        if b is not None:
            b.close()
            self.bridge = None
            self._bridge_pollers = [p for p in self._bridge_pollers
                                    if p is not b]
        wd = self._watchdog
        if self._ckpt is not None:
            if (wd is None or wd.tripped is None) \
                    and not self._last_run_crashed:
                # The final checkpoint of a clean teardown, the fast-start
                # restore source. Skipped after a stall (the capture
                # would wait on the wedged card) and after any crashed
                # run: the ring's newest snapshot must stay the last
                # intact pre-crash world, or the supervisor would
                # restore straight back into the failure.
                try:
                    self._ckpt.checkpoint(self, force=True)
                except Exception:                  # noqa: BLE001
                    self.totals["checkpoint_errors"] += 1
            self._ckpt.close()
            self._ckpt = None
        if wd is not None:
            wd.close()
            self._watchdog = None
        if self._metrics is not None:
            if wd is None or wd.tripped is None:
                # A stalled card would hang this last snapshot's reads.
                self._metrics.update_now(self)
            self._metrics.close()
            self._metrics = None
        return self._exit_code

    def queue_depth(self, actor_id: int) -> int:
        """Messages waiting in an actor's mailbox (≙
        ponyint_actor_num_messages, actor.c:666)."""
        return int(self.state.tail[actor_id] - self.state.head[actor_id])

    def total_memory(self) -> Dict[str, int]:
        """Process and device memory accounting (≙ the fork's
        @ponyint_total_memory): the host's resident set, the bytes of the
        state's tensors (the actor world's device footprint), and the
        native pool's block counts, 0 here (the port has no native
        pool)."""
        try:    # current RSS (Linux); the peak through getrusage else
            with open("/proc/self/statm") as f:
                rss_bytes = (int(f.read().split()[1])
                             * os.sysconf("SC_PAGE_SIZE"))
        except OSError:
            import resource
            rss_bytes = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024
        dev = 0
        if self._state is not None:
            dev = sum(t.nbytes for t in _state_tensors(self.state))
        return {"host_rss_bytes": int(rss_bytes),
                "device_state_bytes": int(dev),
                "pool_live_blocks": 0,
                "pool_recycled_blocks": 0}

    def measured_costs(self, force: bool = False) -> Dict[str, Any]:
        """Measured, not modelled (costs.capture): the byte census of
        this runtime's real step and one-tick window (flops, bytes
        accessed, argument/output/peak bytes per executable, the
        kernels' launches and bytes). Lazy and memoized (the first call
        runs each once on a copy of the state; the world does not
        advance); ``opts.cost_capture=True`` runs it at start(). Fields
        nothing reports (the peak on the CPU) are None."""
        from .. import costs as _costs
        return _costs.capture(self, force=force)

    def profile_device(self, windows: int = 1, path: Optional[str] = None,
                       ticks: Optional[int] = None) -> str:
        """Trace `windows` forced windows of `ticks` ticks each (the
        controller's current window by default) with torch.profiler,
        CPU and CUDA activities, through the runtime's own window (the
        window kernel under delivery="pallas_mega" on CUDA): the world
        really advances, and the ticks count in steps_run. The first
        window runs outside the trace, so one-time costs stay out of
        it. Writes a Chrome trace (chrome://tracing, Perfetto) to
        `path`, by default ``<analysis_path>.trace.json``, and returns
        the path."""
        if self._state is None:
            raise RuntimeError("call start() first")
        from torch.profiler import ProfilerActivity, profile as tprof
        if path is None:
            path = (self.opts.analysis_path or "ponyc_profile") \
                + ".trace.json"
        n = max(1, int(ticks if ticks is not None
                       else self._controller.window))
        inj_t, inj_w = self._empty_inject
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)

        def window():
            st, _aux, k = self._multi_g(self._state, inj_t, inj_w, n, True,
                                        self._zero_aux, self._probe)
            self.state = st
            self._await_device()
            self.steps_run += int(k)

        window()
        with tprof(activities=acts) as prof:
            for _ in range(max(1, int(windows))):
                window()
        prof.export_chrome_trace(path)
        return path

    def profile(self) -> Dict[str, Any]:
        """The per-behaviour and per-cohort telemetry report, the host
        face of the device profiler lanes (engine.profile_lanes; the JAX
        package's Runtime.profile): cumulative runs, deliveries and
        rejections per behaviour (host behaviours report their host
        dispatches), queue-wait histograms, p50/p99 and mute-ticks per
        device cohort, work units by phase, the totals and the GC's
        window stats. Needs opts.analysis >= 1; one small device read,
        for window boundaries."""
        if self.opts.analysis < 1:
            raise RuntimeError(
                "Runtime.profile() needs RuntimeOptions.analysis >= 1 "
                "(the telemetry lanes do not exist at level 0)")
        if self._state is None:
            raise RuntimeError("call start() first")
        self._await_device()
        from ..analysis import hist_percentile
        from .state import PHASE_NAMES, QW_BUCKETS
        nd = len(self.program.device_cohorts)
        st = self.state
        p = self.program.shards
        # The profiler lanes are per shard: the mesh-wide sums.
        runs, deliv, rej, mt, hist, ph = (
            getattr(st, f).cpu().numpy().astype(np.int64).reshape(
                p, -1).sum(0) for f in (
                "beh_runs", "beh_delivered", "beh_rejected",
                "coh_mute_ticks", "qwait_hist", "phase_cost"))
        hist = hist.reshape(nd, QW_BUCKETS)
        behaviours = {}
        for g, bdef in enumerate(self.program.behaviour_table):
            behaviours[f"{bdef.actor_type.__name__}.{bdef.name}"] = {
                "runs": int(runs[g]) + self._beh_host_runs.get(g, 0),
                "delivered": int(deliv[g]),
                "rejected": int(rej[g]),
            }
        cohorts = {}
        for di, ch in enumerate(self.program.device_cohorts):
            h = [int(x) for x in hist[di]]
            cohorts[ch.atype.__name__] = {
                "queue_wait_hist": h,
                "queue_wait_p50": hist_percentile(h, 0.50),
                "queue_wait_p99": hist_percentile(h, 0.99),
                "mute_ticks": int(mt[di]),
            }
        return {
            "steps": self.steps_run,
            "behaviours": behaviours,
            "cohorts": cohorts,
            "phases": {n: int(ph[i]) for i, n in enumerate(PHASE_NAMES)},
            "totals": {
                "processed": self.counter("n_processed"),
                "delivered": self.counter("n_delivered"),
                "rejected": self.counter("n_rejected"),
                "badmsg": self.counter("n_badmsg"),
                "deadletter": self.counter("n_deadletter"),
                "mutes": self.counter("n_mutes"),
                "host_processed": self.totals.get("host_processed", 0),
            },
            "gc": {
                "passes": self.totals.get("gc_runs", 0),
                "collected": self.counter("n_collected"),
                "blob_slots_reclaimed": self.totals.get(
                    "gc_swept_blobs", 0),
                "trace_iters": self.totals.get("gc_iters", 0),
                "aborted": self.totals.get("gc_aborted", 0),
            },
        }

    def traces(self) -> Dict[int, Dict[str, Any]]:
        """The reassembled causal traces: drains the device span ring,
        merges the host spans (injection roots, host-cohort dispatches)
        and returns one causal tree per trace id, {trace_id: {"roots",
        "spans", "n_spans", "latency", "critical_path"}}, latency in
        device ticks (tracing.reassemble). Needs tracing on (analysis >= 3
        and trace_sample > 0)."""
        if self._tracer is None:
            raise RuntimeError(
                "Runtime.traces() needs causal tracing on: "
                "RuntimeOptions(analysis=3, trace_sample=N) (the trace "
                "lanes do not exist otherwise)")
        from ..tracing import reassemble
        self._tracer.drain(self)
        return reassemble(self._tracer.spans)

    def _maybe_gc(self) -> None:
        """The run loop's periodic collection (≙ the cycle detector run
        off scheduler 0's idle path every --ponycdinterval,
        scheduler.c:976-989): every `cd_interval` ticks (skipped host-only
        boundaries count), once anything can be garbage — the host
        released an actor, or actors spawn on the device — and early when
        the host heap grew past its next trigger (≙ heap.c next_gc with
        --ponygcinitial/--ponygcfactor, start.c:204-209)."""
        if self.opts.noblock or not (self._ever_released
                                     or self.program.has_device_spawns):
            return
        heap_pressure = (self._heap is not None
                         and self._heap.bytes_since_gc > self._next_gc)
        eff_step = self.steps_run + self._idle_boundaries
        if heap_pressure or (self.opts.cd_interval > 0
                             and eff_step - self._last_gc_step
                             >= self.opts.cd_interval):
            self._last_gc_step = eff_step
            self.gc()

    # ---- the collector (≙ ORCA + the cycle detector; runtime/gc.py) ----
    def _set_flag_column(self, column: str, ids, value: bool) -> None:
        """Set a per-actor bool column host-side. A flag never frees a
        slot, so the spawn freelists stay valid."""
        ids = self._tensor(np.asarray(ids, np.int64).reshape(-1),
                           torch.int64)
        fkey = self._freelist_key
        col = getattr(self.state, column).clone()
        col[ids] = value
        self.state = self._replace(**{column: col})
        self._freelist_key = fkey

    def release(self, ids) -> None:
        """Drop the host's reference(s): the actors become collectable
        once they are unreachable and message-quiet (runtime/gc.py)."""
        self._set_flag_column("pinned", ids, False)
        self._ever_released = True

    def pin(self, ids) -> None:
        """(Re-)pin actors as host-held GC roots."""
        self._set_flag_column("pinned", ids, True)

    def apply_backpressure(self, ids) -> None:
        """Mark actors under pressure (≙ pony_apply_backpressure,
        actor.c:1137-1162): senders to them mute on send until
        release_backpressure(), whatever their mailboxes hold — the hook
        for pressure the runtime cannot see (a stalled socket, a full
        outside queue). Raises bit 0 of world_bits, the "any pressure"
        bit, as the JAX package does; each tick's vote keeps it honest
        from then on."""
        self._set_flag_column("pressured", ids, True)
        fkey = self._freelist_key
        self.state = self._replace(world_bits=self.state.world_bits | 1)
        self._freelist_key = fkey

    def release_backpressure(self, ids) -> None:
        """Clear the pressure (≙ pony_release_backpressure); muted
        senders release on a later unmute pass once the receiver is also
        under the occupancy threshold."""
        self._set_flag_column("pressured", ids, False)

    def gc(self) -> int:
        """Run one collection: trace reachability from the roots, free
        every actor not reached and sweep the blobs nothing holds (≙ ORCA
        and the cycle detector in one pass; runtime/gc.py). Returns the
        number of actors collected."""
        if self._state is None:
            raise RuntimeError("call start() first")
        self._await_device()
        from . import gc as gc_mod
        if self._gc_fn is None:
            self._gc_fn = gc_mod.build_gc(self.program, self.opts,
                                          self.mesh)
            self._ref_mask = gc_mod.build_ref_arg_mask(
                self.program, self.opts.msg_words)
            self._blob_mask = gc_mod.build_blob_arg_mask(
                self.program, self.opts.msg_words)
        # Host-side roots: refs in host-actor state and in queued
        # injections (they reach the device later), and the blobs the
        # host owns or has queued.
        total = self.program.total
        extra = np.zeros((total,), bool)
        for aid, stt in self._host_state.items():
            cohort = self.program.cohort_of(aid)
            for fname, spec in cohort.atype.field_specs.items():
                if pack.is_ref(spec):
                    v = int(stt.get(fname, -1))
                    if 0 <= v < total:
                        extra[v] = True
        n_blob = self.program.shards * self.opts.blob_slots
        blob_roots = np.zeros((n_blob,), bool)
        for h in self._host_blobs:
            slot = pack.blob_slot(int(h))
            if h >= 0 and 0 <= slot < n_blob:
                blob_roots[slot] = True
        for t, w, *_ in list(self._inject_q) + list(self._host_fast_q):
            if 0 <= t < total:
                extra[t] = True
            gid = int(w[0])
            if 0 <= gid < self._ref_mask.shape[0]:
                for i in np.nonzero(self._ref_mask[gid])[0]:
                    v = int(w[1 + i])
                    if 0 <= v < total:
                        extra[v] = True
                for i in np.nonzero(self._blob_mask[gid])[0]:
                    v = int(w[1 + i])
                    slot = pack.blob_slot(v)
                    if v >= 0 and 0 <= slot < n_blob:
                        blob_roots[slot] = True
        before = self.counter("n_collected")
        fkey = self._freelist_key
        self.state, (_n, converged, iters, n_swept) = self._gc_fn(
            self._state, self._tensor(extra, torch.bool),
            self._tensor(blob_roots, torch.bool))
        collected = self.counter("n_collected") - before
        if self._flight is not None:
            self._flight.event("gc", collected=int(collected),
                               iters=int(iters), swept=int(n_swept),
                               converged=bool(converged))
        if not collected:
            self._freelist_key = fkey     # no slot was freed
        self.totals["gc_runs"] += 1
        self.totals["gc_iters"] += int(iters)
        self.totals["gc_swept_blobs"] += int(n_swept)
        if not converged:
            self.totals["gc_aborted"] += 1
        # ≙ heap.c's next_gc update after a collection: every collection,
        # manual included, clears the allocation-pressure signal.
        if self._heap is not None:
            self._heap.bytes_since_gc = 0
            self._next_gc = max(self.opts.gc_initial,
                                int(self._heap.bytes_live
                                    * self.opts.gc_factor))
        return collected

    @property
    def heap(self):
        """Host object heap for rich message payloads (hostmem.py)."""
        if self._heap is None:
            from ..hostmem import HostHeap
            self._heap = HostHeap()
        return self._heap

    # ---- the device blob pool, host side ----
    def _pool_host(self):
        """(used, gen) of the pool as host arrays, and the lowest slot that
        may be free: read from the device once per state write that was
        not a host blob op (those keep it current)."""
        if self._blob_epoch != self._state_epoch:
            st = self.state
            self._blob_cache = [st.blob_used.cpu().numpy().copy(),
                                st.blob_gen.cpu().numpy().copy(), 0]
            self._blob_epoch = self._state_epoch
        return self._blob_cache

    def _pool_write(self, slot: int, **cols) -> None:
        """Write one slot of the pool leaves named in `cols` ({leaf: value
        of the slot}; n_blob_alloc/n_blob_free: added), cloning the pool's
        leaves on the first write since another state write, then in
        place, so that a run of host blob ops costs no whole-pool copy
        each."""
        if self._pool_own != self._state_epoch:
            st = self.state
            self._pool_host()
            fkey = self._freelist_key
            self.state = self._replace(**{
                f: getattr(st, f).clone() for f in (
                    "blob_data", "blob_used", "blob_len", "blob_gen",
                    "n_blob_alloc", "n_blob_free")})
            self._freelist_key = fkey
            self._blob_epoch = self._pool_own = self._state_epoch
        st = self.state
        for f, v in cols.items():
            t = getattr(st, f)
            if f.startswith("n_"):                  # the slot's shard
                t[slot // self.opts.blob_slots] += v
            elif t.dim() == 2:
                t[:, slot] = self._tensor(v, t.dtype)
            else:
                t[slot] = v

    def _blob_slot_of(self, handle: int, what: str) -> int:
        """Decode and validate a handle host-side (range, allocation,
        generation: a stale handle to a recycled slot is rejected)."""
        n = self.program.shards * self.opts.blob_slots
        slot = pack.blob_slot(int(handle))
        if handle < 0 or not 0 <= slot < n:
            raise IndexError(f"{what}: blob handle {handle} out of range")
        used, gen, _ = self._pool_host()
        if not used[slot]:
            raise KeyError(f"{what}: blob handle {handle} is not "
                           "allocated")
        if (int(gen[slot]) & pack.BLOB_GEN_MASK) != pack.blob_gen_of(
                int(handle)):
            raise KeyError(f"{what}: blob handle {handle} is STALE — "
                           "its slot was recycled (generation mismatch)")
        return slot

    def blob_fetch(self, handle: int) -> np.ndarray:
        """Host-side read of a device blob's logical words (≙ receiving a
        payload on the main-thread scheduler). Raises on null,
        unallocated and stale handles."""
        slot = self._blob_slot_of(handle, "blob_fetch")
        ln = int(self.state.blob_len[slot])
        return self.state.blob_data[:ln, slot].cpu().numpy()

    def blob_store(self, words, length: Optional[int] = None,
                   near: Optional[int] = None) -> int:
        """Host-side blob allocation between windows (≙ the embedder
        building a message payload, pony_alloc_msg): claims the lowest
        free pool slot, writes `words` (int32, at most blob_words),
        returns the handle, which the host owns until a send moves it.
        `near` names an actor whose shard should own the slot: a host
        injection does not migrate blobs as routing does, so a payload
        for that actor must live on its shard (elsewhere it arrives
        null and counts in n_blob_remote)."""
        if self.opts.blob_slots <= 0:
            raise RuntimeError("blob pool disabled: set "
                               "RuntimeOptions.blob_slots/blob_words")
        w = np.asarray(words, np.int32).reshape(-1)
        if w.shape[0] > self.opts.blob_words:
            raise ValueError(
                f"{w.shape[0]} words > blob_words={self.opts.blob_words}")
        ln = w.shape[0] if length is None else int(length)
        if not 0 <= ln <= self.opts.blob_words:
            raise ValueError(
                f"length={ln} outside [0, blob_words="
                f"{self.opts.blob_words}]")
        cache = self._pool_host()
        used, gen = cache[0], cache[1]
        bsl = self.opts.blob_slots
        if near is None:
            slot, stop = cache[2], used.shape[0]
        else:
            shard = int(near) // self.program.n_local
            stop = (shard + 1) * bsl
            slot = max(shard * bsl, min(cache[2], stop))
        while slot < stop and used[slot]:
            slot += 1
        if slot >= stop:
            raise BlobCapacityError(
                "host blob_store: pool exhausted"
                + ("" if near is None else
                   f" on shard {int(near) // self.program.n_local}"))
        full = np.zeros((self.opts.blob_words,), np.int32)
        full[:w.shape[0]] = w
        g = (int(gen[slot]) + 1) & pack.BLOB_GEN_MASK
        self._pool_write(slot, blob_data=full, blob_used=True,
                         blob_len=ln, blob_gen=g, n_blob_alloc=1)
        used[slot], gen[slot] = True, g
        if near is None or slot == cache[2]:
            cache[2] = slot + 1
        handle = pack.blob_handle(slot, g)
        self._host_blobs.add(handle)    # a GC root until sent or freed
        return handle

    def blob_free_host(self, handle: int) -> None:
        """Host-side release of a blob the host owns. Double frees and
        stale handles are rejected."""
        slot = self._blob_slot_of(handle, "blob_free_host")
        self._pool_write(slot, blob_used=False, blob_len=0, n_blob_free=1)
        cache = self._blob_cache
        cache[0][slot] = False
        cache[2] = min(cache[2], slot)
        self._host_blobs.discard(int(handle))

    def blob_store_str(self, text: str, near: Optional[int] = None) -> int:
        """Store a UTF-8 string as a device blob (4 bytes a word; pair
        with blob_fetch_str). A NUL in the text is rejected: it would be
        indistinguishable from the last word's padding."""
        raw = text.encode("utf-8")
        if b"\x00" in raw:
            raise ValueError(
                "blob_store_str: NUL (U+0000) in text is "
                "indistinguishable from word padding; store raw words "
                "with blob_store instead")
        if len(raw) > 4 * self.opts.blob_words:
            raise ValueError(
                f"{len(raw)} bytes > 4*blob_words="
                f"{4 * self.opts.blob_words}")
        padded = raw + b"\x00" * (-len(raw) % 4)
        words = np.frombuffer(padded, np.int32) if padded else \
            np.zeros((0,), np.int32)
        return self.blob_store(words, near=near)

    def blob_fetch_str(self, handle: int) -> str:
        """Read back a blob_store_str payload."""
        words = np.ascontiguousarray(self.blob_fetch(handle), np.int32)
        return words.tobytes().rstrip(b"\x00").decode("utf-8")

    def blob_release(self, handle: int) -> None:
        """Drop the host's GC root on a handle without freeing the slot
        (the val-blob release: device readers may still hold it; the next
        gc() reclaims it once nothing does)."""
        self._host_blobs.discard(int(handle))

    @property
    def blobs_in_use(self) -> int:
        """Allocated pool slots (a leak shows here: an orphaned blob
        persists until the next gc() sweeps it)."""
        return int(self.state.blob_used.sum())

    # ---- introspection ----
    def check_invariants(self) -> None:
        """Queue/flag invariants (≙ the reference's debug-build queue
        checkers, actor.c:57-92). Raises AssertionError."""
        st = self.state
        occ = (st.tail - st.head).cpu().numpy()
        c = self.opts.mailbox_cap
        alive = st.alive.cpu().numpy()
        muted = st.muted.cpu().numpy()
        if not (occ >= 0).all():
            raise AssertionError("mailbox occupancy negative (head>tail)")
        if not (occ <= c).all():
            raise AssertionError("mailbox occupancy exceeds capacity")
        if (muted & ~alive).any():
            raise AssertionError("dead actor still muted")
        if not (st.mute_refs.cpu().numpy()[:, ~muted] == -1).all():
            raise AssertionError("unmuted actor holds a mute ref")
        if not (occ[~alive] == 0).all():
            raise AssertionError("dead actor with queued messages")

    def counter(self, name: str) -> int:
        """A per-shard runtime counter (n_processed, n_delivered,
        n_rejected, n_badmsg, n_deadletter, n_mutes, ...) summed."""
        if isinstance(self._state, Sharded):
            return self._state.total(name)
        return int(getattr(self.state, name).sum())

    def state_of(self, actor_id: int) -> Dict[str, Any]:
        cohort = self.program.cohort_of(actor_id)
        if cohort.host:
            return dict(self._host_state.get(actor_id, {}))
        col = int(cohort.gid_to_col(actor_id))
        ts = self.state.type_state[cohort.atype.__name__]
        return {k: v[col].item() for k, v in ts.items()}

    def last_error(self, actor_id: int) -> int:
        """The latest int-coded error of an actor, 0 for none (device
        actors through ctx.error_int, host actors through PonyError)."""
        if self.program.cohort_of(actor_id).host:
            return self._host_errors.get(int(actor_id), 0)
        return int(self.state.last_error[actor_id])

    def last_error_loc(self, actor_id: int) -> str:
        """The source location of that error ("?" for none)."""
        from ..errors import error_site
        if self.program.cohort_of(actor_id).host:
            return self._host_error_locs.get(int(actor_id), "?")
        return error_site(int(self.state.last_error_loc[actor_id]))

    def cohort_state(self, atype: ActorTypeMeta) -> Dict[str, np.ndarray]:
        """State columns in slot (spawn) order."""
        cohort = self.program.by_type[atype]
        cols = np.asarray(
            cohort.slot_to_col(np.arange(cohort.capacity)), np.int64)
        return {k: v.cpu().numpy()[cols]
                for k, v in self.state.type_state[atype.__name__].items()}

    @property
    def exit_code(self) -> int:
        return self._exit_code

    @property
    def ticks_enqueued(self) -> int:
        """Ticks enqueued since start(), run or predicated off on the
        device (steps_run counts only those that ran). Each enqueued tick
        launches the tick's kernels once; under the window kernel
        (delivery="pallas_mega" on CUDA) a window is one launch, and the
        count adds the ticks each launched window may run."""
        return self._multi_g.enqueued

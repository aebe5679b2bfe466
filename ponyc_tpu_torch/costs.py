"""Measured, not modelled: device-cost capture for the PyTorch port (the
counterpart of ``ponyc_tpu/costs.py`` up to its scoreboard).

ops/megakernel.modelled_bytes_per_msg prices a ring record from the
layout alone. This module measures what the runtime's real step and
one-tick window move, by the rule XLA's ``cost_analysis()`` uses for
``bytes accessed`` (the operand bytes plus the output bytes of every op
an executable runs), so a record means the same in both packages:

- ``capture(rt)`` — runs one step and one one-tick window of the
  runtime's own executables on a device copy of ``rt.state`` under a
  byte census (ops/census.py: every ATen op by a dispatch mode, every
  hand-written kernel launch by its wrapper's report) and throws the
  copy away: ``steps_run``, fields and counters stay as they were. On
  CUDA ``peak_bytes`` is the caching allocator's peak over the census
  run; on the CPU, where no allocator reports, it is None. A capture
  that fails is recorded per executable as ``{"error": ...}``.
- ``record_move_probe(opts)`` — the measured twin of the modelled
  bytes/msg: ``record + 1`` over a [record_words, n] int32 plane under
  the census, divided by the 2n record planes it touches: exactly
  ``4 * record_words`` bytes a message.
- ``divergence(modelled, measured)`` — the loud ``model_divergence``
  flag when the model and the measurement disagree past a threshold;
  ``measured_block(rt)`` composes the three into the record /metrics and
  the flight recorder's postmortem read from ``rt._costs``.

The bench's history and the ``perf`` scoreboard stay with the port's
bench.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, Optional

import torch

from .ops import census

COST_VERSION = 1

# Relative disagreement past which modelled and measured bytes/msg are
# flagged as diverged: |measured - modelled| / modelled > tolerance.
# 0.5 is deliberately loose — the flag exists to catch the model being
# WRONG (2x+), not to litigate rounding.
DIVERGENCE_TOLERANCE = 0.5


def _launch_counters() -> Dict[str, Callable[[], int]]:
    """Each hand-written kernel's launch counter, by its census name."""
    from .ops import fused_dispatch, mailbox_kernel, megakernel
    return {"drain": lambda: mailbox_kernel.drain_msgs.launches,
            "fused": lambda: fused_dispatch.FusedDispatch.launches,
            "mega": lambda: megakernel.MegaWindow.launches}


def _state_bytes(st) -> int:
    import dataclasses

    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        return 0
    return int(sum(walk(getattr(st, f.name))
                   for f in dataclasses.fields(st)))


def census_record(run: Callable[[], Any], device: torch.device,
                  state_bytes: Optional[int] = None) -> Dict[str, Any]:
    """The measured record of one call of `run` under a byte census:
    {flops, bytes_accessed, transcendentals, argument_bytes,
    output_bytes, temp_bytes, alias_bytes, generated_code_bytes,
    peak_bytes} as the JAX package names them (None where nothing
    reports the field), plus ``ops`` (ATen ops counted), ``kernels``
    ({name: {launches, bytes}}) and ``capture_s``. Raises CensusError
    when a kernel launched without reporting."""
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with census.Census(_launch_counters()) as c:
        run()
    peak = None
    if cuda:
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    c.check()
    return {"flops": c.flops, "bytes_accessed": float(c.bytes),
            "transcendentals": None, "argument_bytes": state_bytes,
            "output_bytes": state_bytes, "temp_bytes": None,
            "alias_bytes": None, "generated_code_bytes": None,
            "peak_bytes": peak, "ops": c.ops, "kernels": c.kernels,
            "capture_s": round(time.perf_counter() - t0, 6)}


# ---------------------------------------------------------------------------
# runtime capture: the REAL step/window executables

def _windows(rt):
    """(the plain window, the window kernel or None) of a runtime."""
    from .ops.megakernel import MegaWindow
    w = rt._multi_g
    if isinstance(w, MegaWindow):
        return w.plain, w
    return w, None


def capture(rt, force: bool = False) -> Dict[str, Any]:
    """Measured costs of the runtime's step and one-tick window,
    memoized on ``rt._costs``. Each runs once, on a copy of the state
    (the world does not advance), with the empty injection; the window
    is the runtime's own (the window kernel under
    delivery="pallas_mega" on CUDA), forced to one tick. ``flops``
    counts the float operations the census can attribute (ops/census.py)
    and is None where a hand-written kernel ran user bodies."""
    cached = getattr(rt, "_costs", None)
    if cached is not None and not force:
        return cached
    if rt.state is None:
        raise RuntimeError("call start() first")
    from .tuning import clone_state
    plain, mw = _windows(rt)
    inj_t, inj_w = rt._empty_inject
    nbytes = _state_bytes(rt.state)
    kept = (plain.enqueued, None if mw is None
            else (mw.windows, mw.enqueued_kernel))
    runs = {
        "step": lambda st: plain.step(st, inj_t, inj_w),
        "window": lambda st: rt._multi_g(st, inj_t, inj_w, 1, True,
                                         rt._zero_aux, None),
    }
    execs: Dict[str, Any] = {}
    try:
        for name, fn in runs.items():
            try:
                st = clone_state(rt.state)
                execs[name] = census_record(lambda: fn(st), rt.device,
                                            nbytes)
            except Exception as e:          # noqa: BLE001 — record, go on
                execs[name] = {"error": f"{type(e).__name__}: {e}"}
            finally:
                st = None
    finally:
        plain.enqueued = kept[0]
        if mw is not None:
            mw.windows, mw.enqueued_kernel = kept[1]
    out = {
        "version": COST_VERSION,
        "backend": rt.device.type,
        "delivery": rt.opts.delivery,
        "executables": execs,
    }
    rt._costs = out
    return out


# ---------------------------------------------------------------------------
# the measured twin of the modelled bytes/msg

_PROBE_CACHE: Dict[tuple, Dict[str, Any]] = {}


def record_move_probe(opts, n: int = 4096, device=None) -> Dict[str, Any]:
    """Measure what moving one mailbox ring record per actor costs:
    ``record + 1`` over a [record_words, n] int32 plane (a read of every
    record word and a write of every record word, the unpacked delivery
    move) under the census, divided by the 2n record planes it touches.
    By the census's rule this is exactly ``4 * record_words`` bytes a
    message, the model's ``unpacked_bytes``; a model or layout drift
    shows up as divergence. `device` defaults to the card when there is
    one."""
    from .ops.megakernel import record_words
    w1 = record_words(opts)
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    key = (w1, n, str(dev))
    hit = _PROBE_CACHE.get(key)
    if hit is not None:
        return dict(hit)
    table = torch.zeros((w1, n), dtype=torch.int32, device=dev)
    rec = census_record(lambda: table + 1, dev)
    ba = rec.get("bytes_accessed")
    per_msg = (float(ba) / n / 2.0) if ba else None
    out = {"record_words": w1, "n": n,
           "bytes_accessed": ba, "bytes_per_msg": per_msg}
    _PROBE_CACHE[key] = out
    return dict(out)


def divergence(modelled_bytes: float, measured_bytes: Optional[float],
               tolerance: float = DIVERGENCE_TOLERANCE,
               ) -> Dict[str, Any]:
    """The model-vs-measurement verdict: relative error of the measured
    bytes/msg against the modelled one, flagged past ``tolerance``.
    Unknown measurement is honest: ratio None, diverged False — absence
    of evidence is not divergence."""
    if not measured_bytes or not modelled_bytes:
        return {"modelled_bytes": modelled_bytes,
                "measured_bytes": measured_bytes,
                "ratio": None, "tolerance": tolerance, "diverged": False}
    ratio = float(measured_bytes) / float(modelled_bytes)
    diverged = abs(ratio - 1.0) > tolerance
    return {"modelled_bytes": float(modelled_bytes),
            "measured_bytes": float(measured_bytes),
            "ratio": round(ratio, 4), "tolerance": tolerance,
            "diverged": bool(diverged)}


def measured_block(rt, modelled: Optional[Dict[str, Any]] = None,
                   tolerance: float = DIVERGENCE_TOLERANCE,
                   quiet: bool = False) -> Dict[str, Any]:
    """The standing ``measured`` block: the real executables' census,
    the record-move probe on the runtime's device, the modelled
    bytes/msg it is judged against, and the loud ``model_divergence``
    verdict."""
    from .ops.megakernel import escape_rate_state, modelled_bytes_per_msg
    cap = dict(capture(rt))
    if modelled is None:
        esc = escape_rate_state(rt.state) if rt.state is not None else 0.0
        modelled = modelled_bytes_per_msg(rt.opts, esc)
    probe = record_move_probe(rt.opts, device=rt.device)
    div = divergence(modelled["unpacked_bytes"], probe["bytes_per_msg"],
                     tolerance)
    cap["record_probe"] = probe
    cap["modelled"] = modelled
    cap["model_divergence"] = div
    rt._costs = cap   # metrics /metrics + flight postmortem read this
    if div["diverged"] and not quiet:
        print(f"ponyc_tpu_torch costs: MODEL DIVERGENCE — modelled "
              f"{div['modelled_bytes']:.1f} B/msg vs measured "
              f"{div['measured_bytes']:.1f} B/msg "
              f"(ratio {div['ratio']}, tolerance {tolerance}): "
              "the bytes/msg model no longer matches the census",
              file=sys.stderr)
    return cap

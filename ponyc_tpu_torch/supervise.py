"""Supervised auto-recovery of the PyTorch port: restart a crashed or
stalled world from its newest intact checkpoint (a copy of
``ponyc_tpu/supervise.py``; the snapshots are serialise.py's).

≙ a Pony deployment's process supervisor (systemd/Erlang-style
restart-on-failure), made runtime-aware: the reference has nothing to
restore INTO — a restarted Pony binary starts cold. Here the world is a
single restorable snapshot (serialise.py), so a coded runtime error
(errors.ERROR_CODES — including the stall watchdog's code-7
PonyStallError) or an unclean process death (SIGKILL, OOM) is answered
by restoring the newest intact ring checkpoint (falling back past
corrupt ones, serialise.newest_intact) and resuming, with bounded
retries and exponential backoff.

The poison rule: a failure that reproduces DETERMINISTICALLY — the same
error code at the same world position twice in a row, with no forward
progress between the attempts — must not be restart-looped (restoring
the same world and replaying the same poison message forever). The
supervisor raises the coded ``PoisonError`` instead, carrying both
failures as evidence.

On the card a stall recovers through the subprocess mode: a wedged
kernel keeps its stream busy until it ends, so an in-process restart
would queue behind it; the child exits with code 7 and a fresh process
restores. The in-process mode is for coded fatals the host raises.

Two modes share one class:

- **in-process** — ``Supervisor(build=make_rt, prefix=...)``:
  ``build()`` returns a STARTED runtime; the supervisor restores the
  newest intact checkpoint into it (or calls ``seed`` when starting
  cold), runs it, and on a coded failure builds a fresh runtime and
  tries again. The wedged/stalled old runtime is stopped best-effort
  and abandoned — recovery never depends on it.
- **subprocess** — ``Supervisor(argv=[...], prefix=...)`` (the
  ``python -m ponyc_tpu_torch supervise <script>`` CLI): the child is
  restarted on any nonzero/killed exit with ``PONY_TPU_RESTORE``
  pointing at the newest intact checkpoint; the script opts in by
  calling ``supervise.maybe_restore(rt)`` after ``start()`` and
  seeding only when it returns None. Forward progress between
  attempts is measured by the checkpoint ring's newest sequence
  number (a child that advances the ring is not poisoned).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import serialise
from .errors import ERROR_CODES, error_code

RESTORE_ENV = "PONY_TPU_RESTORE"


class PoisonError(RuntimeError):
    """Deterministic poison: the same coded failure at the same world
    position twice in a row — restarting would loop forever, so the
    supervisor refuses. Carries the repeated failure record."""

    code = ERROR_CODES["PoisonError"]

    def __init__(self, message: str, failure: Optional[Dict] = None):
        super().__init__(message)
        self.failure = failure or {}


def maybe_restore(rt, prefix: Optional[str] = None) -> Optional[str]:
    """The supervised-script hook: restore from ``$PONY_TPU_RESTORE``
    (set by a supervising parent) or, with a `prefix`, from the newest
    intact ring checkpoint. Returns the restored path, or None (start
    cold and seed). Call right after ``start()``, BEFORE seeding."""
    path = os.environ.get(RESTORE_ENV) or ""
    if not path and prefix:
        path = serialise.newest_intact(prefix) or ""
    if not path:
        return None
    serialise.restore(rt, path)
    return path


class Supervisor:
    """Run a workload under restart-from-checkpoint supervision.

    Parameters
    ----------
    build: () -> Runtime — in-process mode; a STARTED runtime per
        attempt. The supervisor restores/seeds and calls ``run()``.
    argv: command list — subprocess mode (mutually exclusive with
        `build`); restarted with ``PONY_TPU_RESTORE`` exported.
    prefix: the checkpoint ring prefix recovery reads
        (``RuntimeOptions.checkpoint_path``).
    seed: (rt) -> None — called only when an attempt starts COLD
        (no intact checkpoint); the workload-injection site.
    retries: restart budget (total restarts, not attempts).
    backoff_s / backoff_max_s: exponential backoff between restarts.
    """

    def __init__(self, build: Optional[Callable[[], Any]] = None, *,
                 argv: Optional[Sequence[str]] = None,
                 prefix: str,
                 seed: Optional[Callable[[Any], None]] = None,
                 retries: int = 5,
                 backoff_s: float = 0.25,
                 backoff_max_s: float = 30.0,
                 sleep: Callable[[float], None] = time.sleep):
        if (build is None) == (argv is None):
            raise ValueError("exactly one of build= (in-process) or "
                             "argv= (subprocess) is required")
        self.build = build
        self.argv = list(argv) if argv is not None else None
        self.prefix = prefix
        self.seed = seed
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._sleep = sleep
        self.failures: List[Dict[str, Any]] = []   # evidence trail
        self.restarts = 0
        self.restored_from: Optional[str] = None   # newest attempt's

    # -- shared policy --
    def _backoff(self, attempt: int) -> float:
        return min(self.backoff_max_s,
                   self.backoff_s * (2.0 ** max(0, attempt - 1)))

    def _record(self, **failure) -> Dict[str, Any]:
        failure["t"] = time.time()
        self.failures.append(failure)
        return failure

    def _poison_check(self) -> None:
        """Same code at the same position twice IN A ROW → poison."""
        if len(self.failures) < 2:
            return
        a, b = self.failures[-2], self.failures[-1]
        if (a.get("code"), a.get("position")) \
                == (b.get("code"), b.get("position")):
            raise PoisonError(
                f"deterministic poison: error code {b.get('code')} at "
                f"world position {b.get('position')!r} twice in a row "
                "— refusing to restart-loop (fix the workload or "
                "delete the poisoned checkpoint ring)", failure=b)

    def run(self) -> int:
        """Supervise to completion; returns the workload's exit code.
        Raises PoisonError on deterministic poison, or re-raises the
        last coded error once the retry budget is exhausted."""
        if self.build is not None:
            return self._run_inprocess()
        return self._run_subprocess()

    # -- in-process mode --
    def _run_inprocess(self) -> int:
        attempt = 0
        while True:
            rt = self.build()
            restored = None
            path = serialise.newest_intact(
                self.prefix, log=lambda m: print(
                    f"supervise: {m}", file=sys.stderr))
            if path is not None:
                try:
                    serialise.restore(rt, path)
                    restored = path
                except (serialise.SnapshotCorruptError,
                        serialise.FingerprintMismatch,
                        serialise.SnapshotGeometryError) as e:
                    print(f"supervise: restore of {path} failed ({e}); "
                          "starting cold", file=sys.stderr)
            self.restored_from = restored
            if restored is None and self.seed is not None:
                self.seed(rt)
            try:
                code = rt.run()
                rt.stop()
                return code
            except Exception as e:               # noqa: BLE001
                c = error_code(e)
                if c == 0:
                    raise          # not a coded runtime error: not ours
                self._record(code=c, cls=type(e).__name__,
                             position=int(getattr(rt, "steps_run", -1)),
                             message=str(e), restored=restored)
                try:
                    rt.stop()
                except Exception:                # noqa: BLE001
                    pass           # a wedged runtime may not tear down
                self._poison_check()
                attempt += 1
                if attempt > self.retries:
                    raise
                self.restarts += 1
                print(f"supervise: attempt {attempt}/{self.retries} — "
                      f"{type(e).__name__} (code {c}) at step "
                      f"{self.failures[-1]['position']}; restarting "
                      f"after {self._backoff(attempt):.2f}s",
                      file=sys.stderr)
                self._sleep(self._backoff(attempt))

    # -- subprocess mode --
    def _ring_seq(self) -> int:
        ckpts = serialise.list_checkpoints(self.prefix)
        return ckpts[-1][0] if ckpts else -1

    def _run_subprocess(self) -> int:
        attempt = 0
        while True:
            path = serialise.newest_intact(
                self.prefix, log=lambda m: print(
                    f"supervise: {m}", file=sys.stderr)) or ""
            env = dict(os.environ)
            if path:
                env[RESTORE_ENV] = path
            else:
                env.pop(RESTORE_ENV, None)
            self.restored_from = path or None
            p = subprocess.run(self.argv, env=env)
            if p.returncode == 0:
                return 0
            # Position for the poison rule: the ring's newest sequence
            # number — a child that wrote new checkpoints made forward
            # progress, so an identical exit code is NOT the same
            # failure (the fault moved).
            self._record(code=p.returncode, cls="subprocess",
                         position=self._ring_seq(), restored=path or None)
            self._poison_check()
            attempt += 1
            if attempt > self.retries:
                return p.returncode
            self.restarts += 1
            how = ("killed by signal " + str(-p.returncode)
                   if p.returncode < 0 else "coded exit")
            print(f"supervise: attempt {attempt}/{self.retries} — child "
                  f"exited {p.returncode} ({how}); restarting after "
                  f"{self._backoff(attempt):.2f}s from the newest "
                  "intact checkpoint", file=sys.stderr)
            self._sleep(self._backoff(attempt))

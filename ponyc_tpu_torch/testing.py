"""Async test harness of the PyTorch port — a copy of
``ponyc_tpu/testing.py`` (≙ packages/ponytest), which the port does not
import: that module imports no JAX, but its package does.

The reference's ponytest runs each `UnitTest` as its own actor under a
`PonyTest` runner with per-test timeouts, assert helpers that *record*
failures rather than abort, exclusion filters, expected-failure support,
and (fork addition, DIVERGENCE.md) a `testsFinished` callback once the
last test completes. The framework's tests are actor *programs* (a
Runtime run to quiescence), so the runner here drives one runtime per
test with a watchdog timeout — the same structure, host-side.

    class RingTest(UnitTest):
        name = "ring/one-token"
        def apply(self, h):
            rt = build_ring(...)
            h.assert_eq(rt.run(), 0)
            h.assert_true(...)

    runner = TestRunner()
    runner.add(RingTest())
    ok = runner.run()          # prints ponytest-style per-test lines

The chaos hooks at the end (`ChaosHooks`, `chaos`, armed from
``PONY_TPU_CHAOS``) are the durability tests' fault injectors.
"""

from __future__ import annotations

import fnmatch
import sys
import threading
import time
import traceback
from typing import Callable, List, Optional


class TestHelper:
    """Per-test context (≙ ponytest's TestHelper): assertions record
    failures; `fail`/`complete` finish the test explicitly; `log` lines
    surface only when the test fails (ponytest semantics)."""

    __test__ = False      # not a pytest collection target

    def __init__(self, name: str):
        self.name = name
        self.failures: List[str] = []
        self.logs: List[str] = []
        self._completed: Optional[bool] = None

    # -- assertions (≙ TestHelper.assert_*) --
    def assert_true(self, cond, msg: str = "") -> bool:
        if not cond:
            self._fail(f"assert_true failed {msg}")
        return bool(cond)

    def assert_false(self, cond, msg: str = "") -> bool:
        if cond:
            self._fail(f"assert_false failed {msg}")
        return not cond

    def assert_eq(self, a, b, msg: str = "") -> bool:
        if not (a == b):
            self._fail(f"assert_eq: {a!r} != {b!r} {msg}")
            return False
        return True

    def assert_ne(self, a, b, msg: str = "") -> bool:
        if a == b:
            self._fail(f"assert_ne: both {a!r} {msg}")
            return False
        return True

    def assert_error(self, fn: Callable, msg: str = "") -> bool:
        """≙ assert_error: the callable must raise."""
        try:
            fn()
        except Exception:
            return True
        self._fail(f"assert_error: no exception raised {msg}")
        return False

    def _fail(self, text: str) -> None:
        self.failures.append(text)

    def fail(self, text: str = "explicit fail") -> None:
        self.failures.append(text)

    def log(self, line: str) -> None:
        self.logs.append(str(line))

    def complete(self, success: bool) -> None:
        """≙ TestHelper.complete for long tests."""
        self._completed = bool(success)

    @property
    def ok(self) -> bool:
        if self._completed is not None:
            return self._completed and not self.failures
        return not self.failures


class UnitTest:
    """≙ ponytest's UnitTest trait."""

    name: str = ""
    #: ≙ ponytest label/exclusion-group string
    label: str = ""
    #: Test passes only if apply() raises or records failures
    #: (≙ ponytest's expected-failure pattern).
    expect_failure: bool = False
    #: Per-test timeout override in seconds (≙ long_test timeout).
    timeout: Optional[float] = None

    def apply(self, h: TestHelper) -> None:
        raise NotImplementedError


class TestResult:
    __test__ = False      # not a pytest collection target
    __slots__ = ("name", "ok", "elapsed_s", "failures", "logs", "timed_out")

    def __init__(self, name, ok, elapsed_s, failures, logs, timed_out):
        self.name = name
        self.ok = ok
        self.elapsed_s = elapsed_s
        self.failures = failures
        self.logs = logs
        self.timed_out = timed_out


class TestRunner:
    """≙ the PonyTest runner actor (packages/ponytest/pony_test.pony):
    sequential by default (runtimes share the process's device),
    per-test timeout watchdog, `--only`-style filtering, summary line, and
    the fork's testsFinished callback."""

    __test__ = False      # not a pytest collection target

    def __init__(self, *, default_timeout: float = 120.0,
                 tests_finished: Optional[Callable] = None,
                 out=None):
        self.tests: List[UnitTest] = []
        self.default_timeout = default_timeout
        self.tests_finished = tests_finished
        self.out = out or sys.stdout
        self.results: List[TestResult] = []

    def add(self, test: UnitTest) -> "TestRunner":
        if not test.name:
            test.name = type(test).__name__
        self.tests.append(test)
        return self

    def _run_one(self, t: UnitTest) -> TestResult:
        h = TestHelper(t.name)
        timeout = t.timeout or self.default_timeout
        err: List[str] = []
        done = threading.Event()

        def body():
            try:
                t.apply(h)
            except Exception:
                err.append(traceback.format_exc())
            finally:
                done.set()

        t0 = time.time()
        th = threading.Thread(target=body, daemon=True)
        th.start()
        timed_out = not done.wait(timeout)
        elapsed = time.time() - t0
        failures = list(h.failures)
        if err:
            failures.append(err[0])
        if timed_out:
            failures.append(f"timed out after {timeout}s")
        ok = h.ok and not err and not timed_out
        if t.expect_failure:
            ok = not ok
            failures = [] if ok else ["expected failure but test passed"]
        return TestResult(t.name, ok, elapsed, failures, h.logs, timed_out)

    def run(self, only: str = "*", exclude: str = "",
            sequential: bool = True) -> bool:
        """Run matching tests; returns overall success. `only`/`exclude`
        are glob patterns on test names (≙ ponytest --only/--exclude)."""
        selected = [t for t in self.tests
                    if fnmatch.fnmatch(t.name, only)
                    and not (exclude and fnmatch.fnmatch(t.name, exclude))]
        w = self.out
        print(f"{len(selected)} test(s) starting", file=w)
        self.results = []
        for t in selected:
            r = self._run_one(t)
            self.results.append(r)
            mark = "OK  " if r.ok else "FAIL"
            print(f"---- {mark} {r.name} ({r.elapsed_s*1e3:.0f} ms)",
                  file=w)
            if not r.ok:
                for line in r.logs:
                    print(f"       log: {line}", file=w)
                for f in r.failures:
                    print(f"       {f}", file=w)
        n_ok = sum(1 for r in self.results if r.ok)
        n_fail = len(self.results) - n_ok
        print(f"---- {len(self.results)} test(s) ran: "
              f"{n_ok} ok, {n_fail} failed", file=w)
        if self.tests_finished is not None:
            # ≙ the fork's testsFinished() hook (DIVERGENCE.md ponytest).
            self.tests_finished(self.results)
        return n_fail == 0


def run_tests(*tests: UnitTest, **kw) -> bool:
    """One-liner entry (≙ PonyTest's Main pattern)."""
    r = TestRunner(**kw)
    for t in tests:
        r.add(t)
    return r.run()


# ---------------------------------------------------------------------------
# Chaos / fault-injection harness (≙ nothing in the reference —
# its test suite has no fault injector, SURVEY.md §4). Small, explicit
# hooks the durability acceptance tests use to prove kill → restart →
# restore → identical outcomes end-to-end: wedge a behaviour (the
# watchdog's code-7 path), raise a coded fatal at a chosen host
# boundary, corrupt/truncate a snapshot file, and SIGKILL the process —
# including deterministically MID-FLUSH inside a checkpoint write (the
# serialise.py chaos point). Hooks are one-shot by default so a
# supervised restart runs clean; subprocess tests arm them through the
# PONY_TPU_CHAOS env var ("<point>[@<nth>]", comma-separated).

class ChaosHooks:
    """Process-global registry of armed fault points. `fire(point)` is
    called from instrumented runtime sites and is a no-op unless that
    point was armed; an armed point triggers on its Nth firing and then
    disarms (one-shot), so recovery paths run unfaulted."""

    KILL = "kill"          # SIGKILL self — the mid-flush crash
    _ACTIONS = (KILL,)

    def __init__(self):
        self._armed = {}           # point -> {"after": n, "seen": k,
        #                             "action": callable|KILL}
        self._env_loaded = False

    def arm(self, point: str, action="kill", after: int = 1) -> None:
        if after < 1:
            raise ValueError("after must be >= 1 (fires on the Nth hit)")
        if isinstance(action, str) and action not in self._ACTIONS:
            raise ValueError(f"unknown chaos action {action!r}")
        self._armed[point] = {"after": int(after), "seen": 0,
                              "action": action}

    def disarm(self, point: str) -> None:
        self._armed.pop(point, None)

    def reset(self) -> None:
        self._armed.clear()
        self._env_loaded = True    # a reset also cancels env arming

    def _load_env(self) -> None:
        # "snapshot-mid-flush@2,other-point" — subprocess arming channel
        # (a supervised child cannot be reached through Python calls).
        self._env_loaded = True
        import os
        spec = os.environ.get("PONY_TPU_CHAOS", "")
        for part in (p.strip() for p in spec.split(",") if p.strip()):
            point, _, nth = part.partition("@")
            self.arm(point, after=int(nth) if nth else 1)

    def fire(self, point: str) -> None:
        if not self._env_loaded:
            self._load_env()
        hook = self._armed.get(point)
        if hook is None:
            return
        hook["seen"] += 1
        if hook["seen"] < hook["after"]:
            return
        del self._armed[point]
        if hook["action"] == self.KILL:
            import os
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        else:
            hook["action"]()


chaos = ChaosHooks()


def wedge_behaviour(bdef, at_dispatch: int = 1, sleep_s: float = 600.0):
    """Wedge a HOST behaviour: its `at_dispatch`-th call sleeps
    `sleep_s` (the stall watchdog's code-7 evidence), then the original
    body is restored — one-shot, so a supervised restart completes.
    Returns an undo callable."""
    import time as _time
    orig = bdef.fn
    state = {"n": 0}

    def wedged(ctx, st, *args):
        state["n"] += 1
        if state["n"] == at_dispatch:
            bdef.fn = orig             # disarm BEFORE sleeping: the
            _time.sleep(sleep_s)       # interrupted retry runs clean
        return orig(ctx, st, *args)

    bdef.fn = wedged

    def undo():
        bdef.fn = orig
    return undo


class FatalAtBoundary:
    """Bridge poller raising a coded PonyError at its Nth host boundary
    — a deterministic coded fatal mid-run (one-shot unless
    `every=True`, the poison-rule fixture)."""

    def __init__(self, boundary: int = 2, code: int = 99,
                 every: bool = False):
        self.boundary = int(boundary)
        self.code = int(code)
        self.every = every
        self.polls = 0
        self.fired = 0

    def poll(self, rt) -> None:
        from .errors import PonyError
        self.polls += 1
        if self.polls == self.boundary or (self.every
                                           and self.polls >= self.boundary):
            self.fired += 1
            raise PonyError(self.code,
                            f"chaos: injected fatal at boundary "
                            f"{self.polls}")


def fatal_at_boundary(rt, boundary: int = 2, code: int = 99,
                      every: bool = False) -> "FatalAtBoundary":
    hook = FatalAtBoundary(boundary, code, every)
    rt.register_poller(hook)
    return hook


def corrupt_snapshot(path: str, mode: str = "truncate") -> None:
    """Damage a snapshot file in a controlled way: "truncate" keeps the
    first half (torn write), "bitflip" flips one byte INSIDE the
    largest zip member's array payload (real bit rot — a flip in zip
    bookkeeping slack would be benign) — restore() must answer with the
    coded SnapshotCorruptError, never a raw numpy/zlib traceback."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if mode == "truncate":
        data = data[:max(1, len(data) // 2)]
    elif mode == "bitflip":
        import io
        import struct
        import zipfile
        with zipfile.ZipFile(io.BytesIO(bytes(data))) as zf:
            zi = max(zf.infolist(), key=lambda i: i.compress_size)
        # local header: sig4 ver2 flag2 method2 time2 date2 crc4
        # csize4 usize4 fnlen2 extralen2, then filename+extra, then data
        fnlen, extralen = struct.unpack_from(
            "<HH", data, zi.header_offset + 26)
        data_off = zi.header_offset + 30 + fnlen + extralen
        data[data_off + zi.compress_size // 2] ^= 0x40
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "wb") as f:
        f.write(bytes(data))


def sigkill_after(delay_s: float) -> threading.Thread:
    """Arm a hard SIGKILL of THIS process after `delay_s` — the
    unclean-death fixture (no atexit, no finally, exactly like the OOM
    killer). Returns the (daemon) timer thread."""
    import os
    import signal

    def _kill():
        time.sleep(delay_s)
        os.kill(os.getpid(), signal.SIGKILL)

    t = threading.Thread(target=_kill, name="chaos-sigkill", daemon=True)
    t.start()
    return t

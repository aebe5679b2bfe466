"""The port's ASIO bridge (ponyc_tpu_torch/bridge), under the JAX
package's tests (tests/test_bridge.py), case for case, on the CPU.

Bridge tests: OS events (timers, signals, fds) driving actors.

≙ how the reference exercises ASIO through stdlib tests over real OS
resources (packages/net, packages/time run under ponytest; SURVEY.md §4).
"""

import dataclasses
import os
import signal
import time

import pytest

import ponyc_tpu_torch
from ponyc_tpu_torch import (I32, RuntimeOptions, actor, behaviour)


def Runtime(opts=None):
    """The port's Runtime on the CPU (the tests' device), with the tuning
    cache off."""
    if opts is not None:
        opts = dataclasses.replace(opts, tuning_cache="off")
    return ponyc_tpu_torch.Runtime(opts, device="cpu")


@actor
class Ticker:
    """Device-resident actor counting timer events."""
    ticks: I32

    @behaviour
    def on_event(self, st, kind: I32, arg: I32, flags: I32):
        st["ticks"] = st["ticks"] + arg   # arg = expirations
        return st


@actor
class HostWatcher:
    """Host-resident actor recording the last event (≙ a main-thread
    actor observing signals)."""
    HOST = True
    kind: I32
    arg: I32

    @behaviour
    def on_event(self, st, kind: I32, arg: I32, flags: I32):
        st["kind"] = kind
        st["arg"] = arg
        return st

    @behaviour
    def stop(self, st):
        self.exit(0)
        return st


def _mk_rt(*decls):
    rt = Runtime(RuntimeOptions(mailbox_cap=16, batch=4, max_sends=1,
                                msg_words=3, spill_cap=64, inject_slots=32,
                                max_steps=20000))
    for atype, cap in decls:
        rt.declare(atype, cap)
    return rt.start()


def test_timer_drives_device_actor():
    rt = _mk_rt((Ticker, 1))
    tid = rt.spawn(Ticker)
    br = rt.attach_bridge()
    sid = br.timer(tid, Ticker.on_event, 0.01)
    t0 = time.time()
    while time.time() - t0 < 5.0:
        rt.run(max_steps=50)
        if rt.state_of(tid)["ticks"] >= 3:
            break
    assert rt.state_of(tid)["ticks"] >= 3
    br.unsubscribe(sid)
    br.poll(rt)                      # release the noisy hold
    assert br.loop.noisy == 0
    br.close()


def test_oneshot_timer_then_quiesce():
    rt = _mk_rt((Ticker, 1))
    tid = rt.spawn(Ticker)
    br = rt.attach_bridge()
    br.timer(tid, Ticker.on_event, 0.01, oneshot=True)
    t0 = time.time()
    while time.time() - t0 < 5.0 and rt.state_of(tid)["ticks"] < 1:
        rt.run(max_steps=50)
    assert rt.state_of(tid)["ticks"] == 1
    # After the oneshot fired there are no noisy subs: run() terminates
    # on its own (quiescence with an attached but silent bridge).
    br.poll(rt)
    assert br.loop.noisy == 0
    code = rt.run(max_steps=5000)
    assert code == 0
    br.close()


def test_signal_to_host_actor():
    rt = _mk_rt((HostWatcher, 1))
    wid = rt.spawn(HostWatcher)
    br = rt.attach_bridge()
    br.signal(wid, HostWatcher.on_event, signal.SIGUSR2)
    os.kill(os.getpid(), signal.SIGUSR2)
    t0 = time.time()
    while time.time() - t0 < 5.0:
        rt.run(max_steps=20)
        if rt.state_of(wid)["arg"] == signal.SIGUSR2:
            break
    st = rt.state_of(wid)
    assert st["kind"] == 2 and st["arg"] == signal.SIGUSR2
    br.close()


def test_fd_readiness_to_host_actor():
    rt = _mk_rt((HostWatcher, 1))
    wid = rt.spawn(HostWatcher)
    br = rt.attach_bridge()
    r, w = os.pipe()
    os.set_blocking(r, False)
    br.fd(wid, HostWatcher.on_event, r)
    os.write(w, b"!")
    t0 = time.time()
    while time.time() - t0 < 5.0:
        rt.run(max_steps=20)
        if rt.state_of(wid)["arg"] == r:
            break
    st = rt.state_of(wid)
    assert st["kind"] == 3 and st["arg"] == r   # FD_READ
    os.read(r, 1)
    os.close(r)
    os.close(w)
    br.close()


def test_subscribe_requires_event_signature():
    @actor
    class Bad:
        x: I32

        @behaviour
        def nope(self, st, v: I32):
            return st

    rt = _mk_rt((Bad, 1))
    bid = rt.spawn(Bad)
    br = rt.attach_bridge()
    with pytest.raises(TypeError):
        br.timer(bid, Bad.nope, 0.01)
    br.close()

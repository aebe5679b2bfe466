"""The port's serving front door as a process, on the CPU: the JAX
package's subprocess serve tests (tests/test_serve.py: the SIGTERM
drain and the supervisor restart) and the CLI.

- `python -m ponyc_tpu_torch serve --cpu` driven by
  `python -m ponyc_tpu_torch.loadgen`, then SIGTERM mid-load: exit 0,
  every request sent answered (OK or BUSY), the drained stats on
  stderr.
- A wedged egress behaviour trips the watchdog (code 7) and
  `python -m ponyc_tpu_torch supervise` restarts the service from the
  checkpoint ring on the same port; a reconnecting client is served by
  the second life.

Each child imports torch (a few seconds) and builds its world on the
CPU. This file imports no JAX."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from ponyc_tpu_torch import loadgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def _spawn_server(tmp_path, extra_args=()):
    proc = subprocess.Popen(
        [sys.executable, "-m", "ponyc_tpu_torch", "serve", "--cpu",
         "--workers", "8", *map(str, extra_args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=str(tmp_path))
    line = proc.stdout.readline()      # "serving on host:port (...)"
    assert line.startswith("serving on"), (line, proc.stderr.read()
                                           if proc.poll() else "")
    port = int(line.strip().rsplit(":", 1)[1].split()[0])
    return proc, port


def test_serve_verb_and_loadgen_cli(tmp_path):
    """The serve verb answers the loadgen CLI's requests (every value
    2x+1), and SIGTERM drains it to exit 0."""
    proc, port = _spawn_server(tmp_path)
    try:
        out = subprocess.run(
            [sys.executable, "-m", "ponyc_tpu_torch.loadgen", "127.0.0.1",
             str(port), "--conns", "2", "--depth", "2", "--requests",
             "25"], capture_output=True, text=True, env=_env(),
            timeout=120)
        assert out.returncode == 0, out.stderr
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["ok"] == res["sent"] == 50, res
        assert res["bad_value"] == 0 and res["unanswered"] == 0
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        drained = [ln for ln in err.splitlines()
                   if ln.startswith("serve: drained ")]
        st = json.loads(drained[-1][len("serve: drained "):])
        assert st["drained"] and st["replied"] == 50
    finally:
        if proc.poll() is None:
            proc.kill()


def test_sigterm_drains_every_admitted_request(tmp_path):
    """SIGTERM mid-load: the server answers every request sent before
    the drain (OK or BUSY), exits 0, and reports drained stats on
    stderr. Zero lost replies."""
    proc, port = _spawn_server(tmp_path, ["--drain-grace", "0.5"])
    try:
        warm = loadgen.run_load("127.0.0.1", port, conns=1, depth=1,
                                requests=5, timeout_s=60.0)
        assert warm["ok"] == 5, warm
        res = {}

        def stream():
            # 3x2 concurrent stays under the 8-worker admission limit,
            # so the first BUSY is the SIGTERM drain announcing itself.
            res["r"] = loadgen.run_load(
                "127.0.0.1", port, conns=3, depth=2,
                requests=1 << 30, duration_s=30.0, stop_on_busy=True)

        t = threading.Thread(target=stream, daemon=True)
        t.start()
        time.sleep(1.5)                    # traffic flowing
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=60)
        t.join(timeout=30.0)
        assert not t.is_alive()
        r = res["r"]
        assert proc.returncode == 0, err
        assert r["ok"] > 0
        assert r["unanswered"] == 0, r     # zero lost replies
        assert r["ok"] + r["busy"] + r["deadline"] == r["sent"]
        assert r["bad_value"] == 0
        drained = [ln for ln in err.splitlines()
                   if ln.startswith("serve: drained ")]
        assert drained, err
        st = json.loads(drained[-1][len("serve: drained "):])
        assert st["drained"] and st["inflight"] == 0
        assert st["accepted"] == st["replied"]
    finally:
        if proc.poll() is None:
            proc.kill()


WEDGE_SCRIPT = """\
import os, sys
sys.path.insert(0, {root!r})
from ponyc_tpu_torch import serve, testing
marker = {marker!r}
if not os.path.exists(marker):
    # First life only: wedge the egress behaviour after a few replies
    # so the watchdog (code 7) fires and the supervisor restarts us.
    open(marker, "w").write("wedged")
    testing.wedge_behaviour(serve.Egress.done, at_dispatch=5,
                            sleep_s=600.0)
sys.exit(serve.main(sys.argv[1:]))
"""


def test_supervisor_restart_reaccepts_connections(tmp_path):
    """A wedged world trips the watchdog (code 7), the supervisor
    restarts the service from the checkpoint ring, the fixed port is
    re-bound and a reconnecting client is served by the second life.

    The supervisor's output is read while the test runs: a round counts
    as the second life's only once the supervisor has said it is
    restarting. Under load the first life may answer part of a round
    and then hang in the next (its 5th egress dispatch wedges whatever
    round it falls in), so "the service failed" is any round short of
    full after the service had answered."""
    with socket.socket() as s:             # reserve a fixed free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    marker = tmp_path / "wedged.marker"
    script = tmp_path / "wedge_serve.py"
    script.write_text(WEDGE_SCRIPT.format(root=ROOT, marker=str(marker)))
    prefix = str(tmp_path / "ring")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ponyc_tpu_torch", "supervise",
         "--prefix", prefix, "--retries", "3", "--backoff", "0.1",
         str(script), "--port", str(port), "--workers", "4", "--cpu",
         "--ponywatchdog_s", "3", "--ponycheckpoint_every_s", "0.2",
         f"--ponycheckpoint_path={prefix}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=str(tmp_path), start_new_session=True)
    lines = {"out": [], "err": []}

    def pump(name, stream):
        for ln in stream:
            lines[name].append(ln)

    readers = [threading.Thread(target=pump, args=(k, f), daemon=True)
               for k, f in (("out", proc.stdout), ("err", proc.stderr))]
    for t in readers:
        t.start()

    def restarted():
        return any("restarting" in ln for ln in list(lines["err"]))

    try:
        # Wait for the service to answer, drive it into the wedge (a
        # round falls short), then reconnect until the second life
        # serves a full round.
        deadline = time.monotonic() + 120.0
        phase, answered, rounds = "wait_up", 0, []
        while time.monotonic() < deadline and phase != "recovered":
            if proc.poll() is not None:
                break
            second_life = restarted()
            r = loadgen.run_load("127.0.0.1", port, conns=1, depth=1,
                                 requests=3, timeout_s=3.0)
            full = r["ok"] == 3 and r["bad_value"] == 0
            rounds.append((phase, r["ok"], r["sent"], second_life))
            if phase == "wait_up" and (full or r["ok"]):
                phase = "up"
            if phase == "up" and not full and (answered or r["ok"]):
                phase = "wedged"           # the 5th egress dispatch hung
            elif phase == "wedged" and full and second_life:
                phase = "recovered"        # life 2 answered end to end
                break
            answered += r["ok"]
            time.sleep(0.2)
        assert marker.exists(), "the wedge never armed"
        assert phase == "recovered", \
            (f"no round-trip after the wedged life (stuck at {phase}; "
             f"rounds {rounds[-12:]})", "".join(lines["err"])[-4000:])
    finally:
        # The supervisor leads its own session: its group holds it and
        # every life it started.
        for sig, wait_s in ((signal.SIGTERM, 60), (signal.SIGKILL, 30)):
            try:
                os.killpg(proc.pid, sig)
            except (ProcessLookupError, OSError):
                pass
            try:
                proc.wait(timeout=wait_s)
            except subprocess.TimeoutExpired:
                pass
        for t in readers:
            t.join(timeout=30)
    err = "".join(lines["err"])
    assert "restarting" in err or "recovered after" in err, err

"""`python -m ponyc_tpu_torch` (ponyc_tpu_torch/__main__.py) against the JAX
package's CLI: `trace`, `trace --tree`, `top --once` and `doctor
--postmortem` give the reference's output and exit codes for the same
analysis CSV, span file and postmortem; the usage errors exit as the
reference's do; `version` runs; the verbs the port does not serve
yet (bench, perf) exit 2 naming what brings them, and doc, lint,
verify and test, served since slice 13, take the reference's usage
errors.

The files come from a traced run of the port on the CPU (analysis=3,
trace_sample=1).
"""

import json
import os
import subprocess
import sys

import pytest

import ponyc_tpu_torch
from ponyc_tpu.__main__ import main as ref_main
from ponyc_tpu_torch.__main__ import NOT_SERVED
from ponyc_tpu_torch.__main__ import main as port_main

from _torch_programs import define_telemetry, new_runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TT = define_telemetry(ponyc_tpu_torch)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The analysis CSV (with its .events.csv and .spans.jsonl) and a
    stop postmortem of one traced chain run by the port."""
    d = tmp_path_factory.mktemp("cli")
    path = str(d / "an.csv")
    rt = new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=8, batch=1, max_sends=1, msg_words=1, spill_cap=64,
        inject_slots=8, analysis=3, trace_sample=1, analysis_path=path))
    rt.declare(TT.Src, 2).declare(TT.Mid, 2).declare(TT.Sink, 2).start()
    sinks = rt.spawn_many(TT.Sink, 2)
    mids = rt.spawn_many(TT.Mid, 2, out=sinks)
    srcs = rt.spawn_many(TT.Src, 2, out=mids)
    rt.send(int(srcs[0]), TT.Src.go, 7)
    rt.run(max_steps=200)
    rt.stop(postmortem=True)
    stall = rt._flight.postmortem(
        "watchdog: phase 'host-work' made no progress for 2.0s "
        "(deadline 1.0s)", phase={"name": "host-work", "epoch": 3,
                                  "age_s": 2.0})
    spath = str(d / "stall.json")
    with open(spath, "w") as f:
        json.dump(stall, f)
    return {"dir": d, "csv": path, "spans": path + ".spans.jsonl",
            "pm": path + ".postmortem.json", "stall": spath}


def _both(capsys, argv):
    """(exit code, stdout) of each CLI on `argv`."""
    capsys.readouterr()
    rc_p = port_main(list(argv))
    out_p = capsys.readouterr().out
    rc_r = ref_main(list(argv))
    out_r = capsys.readouterr().out
    return (rc_p, out_p), (rc_r, out_r)


def test_trace_matches_reference(files, capsys):
    d = files["dir"]
    outs = {}
    for name, main in (("port", port_main), ("ref", ref_main)):
        out = str(d / f"{name}.trace.json")
        capsys.readouterr()
        assert main(["trace", files["csv"], "-o", out]) == 0
        printed = capsys.readouterr().out.replace(out, "OUT")
        with open(out) as f:
            outs[name] = (printed, json.load(f))
    assert outs["port"] == outs["ref"]
    evs = outs["port"][1]["traceEvents"]
    assert any(e["ph"] == "s" for e in evs)           # flow arrows
    assert any(e["ph"] == "C" for e in evs)           # counter tracks


def test_trace_tree_matches_reference(files, capsys):
    port, ref = _both(capsys, ["trace", "--tree", files["spans"]])
    assert port == ref
    assert port[0] == 0 and "critical path" in port[1]
    assert "Sink" in port[1]


def test_top_once_matches_reference(files, capsys):
    port, ref = _both(capsys, ["top", files["csv"], "--once"])
    assert port == ref
    assert port[0] == 0 and "traces: 1" in port[1]


def _detail(out):
    """The doctor's text without the environment line (each package
    describes its own)."""
    return [ln for ln in out.splitlines() if not ln.startswith("env:")]


@pytest.mark.parametrize("which,code", [("pm", 0), ("stall", 1)])
def test_doctor_postmortem_matches_reference(files, capsys, which, code):
    (rc_p, out_p), (rc_r, out_r) = _both(
        capsys, ["doctor", "--postmortem", files[which]])
    assert rc_p == rc_r == code
    lines_p, lines_r = _detail(out_p), _detail(out_r)
    if which == "stall":      # the phase hint names each package's phases
        assert lines_p[0].startswith(
            "STALLED: watchdog: phase 'host-work' made no progress")
        assert lines_p[0].split(" (a host")[0] == \
            lines_r[0].split(" (a host")[0]
        lines_p, lines_r = lines_p[1:], lines_r[1:]
    assert lines_p == lines_r


@pytest.mark.parametrize("argv", [
    ["trace"], ["trace", "-o"], ["trace", "--tree"], ["trace", "--spans"],
    ["trace", "absent.csv", "--spans", "none.jsonl", "-o", "x.json"],
    ["top", "--interval"], ["top", "--interval", "nope"],
    ["top", "a.csv", "b.csv"], ["doctor"], ["doctor", "--postmortem"],
    ["doctor", "--postmortem", "absent.json"], ["nope"], [],
])
def test_usage_errors_match_reference(tmp_path, monkeypatch, capsys,
                                      argv):
    monkeypatch.chdir(tmp_path)
    port, ref = _both(capsys, argv)
    assert port[0] == ref[0] == 2


@pytest.mark.parametrize("verb", ["bench", "doc", "lint", "perf", "test",
                                  "verify"])
def test_unserved_verbs_exit_2_naming_their_slice(capsys, monkeypatch,
                                                  verb):
    """The JAX package's verbs the port does not serve (bench, perf) exit
    2 naming what brings them; those served since slice 13 (doc, lint,
    verify, test) take the reference's usage errors and exit codes."""
    if verb in NOT_SERVED:
        assert port_main([verb, "x"]) == 2
        err = capsys.readouterr().err
        assert "not served by the PyTorch port yet" in err
        assert NOT_SERVED[verb] in err
        return
    if verb == "test":              # runs the port's tests with pytest
        seen = []
        monkeypatch.setattr(pytest, "main",
                            lambda args: seen.append(args) or 5)
        assert port_main(["test", "-k", "x"]) == 5
        assert seen[0][-2:] == ["-k", "x"]
        assert seen[0][:-2] and all(
            os.path.basename(f).startswith("test_torch_")
            for f in seen[0][:-2])
        return
    assert port_main([verb]) == ref_main([verb]) == 2
    err = capsys.readouterr().err
    assert f"ponyc_tpu_torch {verb}: missing module" in err


def test_module_entry_point_version_and_doctor(files):
    """`python -m ponyc_tpu_torch` runs as a program."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-m", "ponyc_tpu_torch", "version"],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT, env=env)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith(f"ponyc_tpu_torch {ponyc_tpu_torch.__version__}")
    assert "torch " in p.stdout and "backend: " in p.stdout
    p = subprocess.run([sys.executable, "-m", "ponyc_tpu_torch", "doctor",
                        "--postmortem", files["stall"]],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT, env=env)
    assert p.returncode == 1 and p.stdout.startswith("STALLED")

"""Command line of the port — ``python -m ponyc_tpu_torch <command>``
(the counterpart of ``ponyc_tpu/__main__.py``: same verbs, arguments and
exit codes for the verbs the port serves).

Commands:
  run [--safe P1:P2] <script.py> [args]
                              run an actor program. --pony* runtime
                              flags anywhere in argv are stripped and
                              handed to the script's
                              config.options_from_env; --safe limits
                              the OS-reaching packages stdlib.pkg.use
                              resolves. The script's Runtime() runs
                              on the card, or raises where there is
                              none: it asks for the CPU with
                              Runtime(opts, device="cpu"). Exit: 0,
                              or 2 usage.
  trace <csv> [-o F]          analysis CSVs → Chrome-trace/Perfetto
        [--spans F.jsonl]     JSON (counter tracks + causal-trace span
  trace --tree <spans.jsonl>  slices with sender→receiver flow arrows);
                              --tree prints reassembled causal trees
                              with per-trace critical-path latency.
                              Exit: 0 written, 2 usage or unreadable.
  top [<analytics.csv>]       live terminal view of a running runtime's
      [--interval S] [--once]  window stream (the level-2 CSV at
                              RuntimeOptions.analysis_path): window
                              throughput, queue pressure, GC stats,
                              the per-behaviour run table and
                              per-cohort queue-wait percentiles,
                              refreshed every --interval seconds
                              (--once renders a single frame).
  doctor --postmortem FILE    render a flight-recorder postmortem
  doctor <host:port|url>      (crash/SIGQUIT/watchdog dump) or a live
                              /metrics+/healthz endpoint
                              (RuntimeOptions.metrics_port) into a
                              one-line verdict + diagnosis. Exit:
                              0 ok/snapshot, 1 stalled/crashed/
                              degraded, 2 usage or unreadable.
  snapshot <file|prefix>      inspect a world snapshot (serialise.py):
           [--json]           header summary + checksum verdict; a
                              ring prefix resolves to its newest intact
                              file. Exit: 0 intact, 1 corrupt, 2 usage.
  restore <file|prefix>       deep restorability check (every array's
                              checksum, the format gate). Exit: 0
                              restorable, 1 corrupt, 2 usage.
  supervise --prefix P        run a script under restart-from-
            [--retries N]     checkpoint supervision (supervise.py):
            [--backoff S]     a coded exit or a kill restarts it with
            <script.py> ...   PONY_TPU_RESTORE at the newest intact
                              ring snapshot. Exit: the script's, 3 on
                              deterministic poison, 2 usage.
  serve [--host H] [--port P] run the serving front door (serve.py:
        [--workers N] [--cpu] batched socket ingress, admission
        [--tls-cert C         control, graceful drain on SIGTERM) over
         --tls-key K]         the default compute service, on the card
        [--pending-limit B]   unless --cpu. Exit: 0 drained, a coded
        [--drain-grace S]     failure's error code, 2 usage.
  test [pytest args...]       the port's tests (tests/test_torch_*.py;
                              ≙ ponytest aggregate). Exit: pytest's.
  doc <module[:ATTR]> [-o D]  generate docs for actor types reachable
                              from a module (≙ docgen pass, docgen.c).
                              Exit: 0 written, 1 no actor types.
  verify <module> [--json]    probe-trace every behaviour's effect
                              signature on meta tensors; fail on
                              budget violations and trace failures
                              (≙ the verify stage, verify/fun.c).
                              Exit: 0 ok, 1 violations, 2 usage,
                              3 no actor types in the module.
  lint <target...> [--json]   whole-program static analysis. A target
      [--format github]       is a MODULE NAME (message-flow graph
      [--roots A.go,B.tick]   rules R0–R5 over probe traces plus the
                              pure-AST behaviour-body rules R6–R9) or
                              a FILE/DIRECTORY (body rules only, the
                              files parsed and never imported).
                              --json emits one finding object per
                              line; --format github emits
                              ::warning/::error annotations. Exit
                              codes as for verify (1 = findings at
                              error or warning severity).
  version                     print the version, the torch build and
                              the card.

The JAX package's other verbs (bench, perf) print which part of the
port brings them and exit 2.

Runtime flags are accepted anywhere in `run` argv, exactly like the
reference stripping --pony* before the app sees argv (start.c:185-261):
  python -m ponyc_tpu_torch run app.py --ponymailboxcap=128 --input x
"""

from __future__ import annotations

import dataclasses
import json
import os
import runpy
import sys
import time


def _usage(code: int = 2) -> int:
    print(__doc__, file=sys.stderr)
    return code


def cmd_test(argv) -> int:
    """Run the port's tests (tests/test_torch_*.py; ≙ ponytest
    aggregate) with pytest, passing argv through. Exit: pytest's."""
    import glob

    import pytest
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(root, "tests",
                                          "test_torch_*.py")))
    target = files if files else ["--pyargs", "ponyc_tpu_torch"]
    return pytest.main(target + list(argv))


def cmd_doc(argv) -> int:
    if not argv:
        print("ponyc_tpu_torch doc: missing module[:ATTR]", file=sys.stderr)
        return 2
    out_dir = "docs_out"
    if "-o" in argv:
        i = argv.index("-o")
        out_dir = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    import importlib

    from .api import ActorTypeMeta
    from .docgen import document_types
    modname, _, attr = argv[0].partition(":")
    sys.path.insert(0, os.getcwd())
    mod = importlib.import_module(modname)
    objs = [getattr(mod, attr)] if attr else [
        v for v in vars(mod).values() if isinstance(v, ActorTypeMeta)]
    if not objs:
        print(f"ponyc_tpu_torch doc: no actor types in {modname}",
              file=sys.stderr)
        return 1
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, modname.replace(".", "_") + ".md")
    with open(path, "w") as f:
        f.write(document_types(*objs, title=modname))
    print(path)
    return 0


def _load_module_types(cmd: str, modname: str):
    """Import a module and collect its concrete actor types (shared by
    verify/lint). Returns (module, types) or (None, exit_code)."""
    import importlib

    from .api import ActorTypeMeta
    sys.path.insert(0, os.getcwd())
    mod = importlib.import_module(modname)
    atypes = [v for v in vars(mod).values()
              if isinstance(v, ActorTypeMeta)
              and v.behaviour_defs
              and not getattr(v, "_type_params", ())]
    if not atypes:
        print(f"ponyc_tpu_torch {cmd}: no concrete actor types in {modname}",
              file=sys.stderr)
        return None, 3
    return mod, atypes


def cmd_verify(argv) -> int:
    """Run the verify pass over a module's actor types (≙ the verify
    stage of the compile pipeline, verify/fun.c): print each
    behaviour's effect signature, fail on budget violations.

    Exit codes: 0 all behaviours verify, 1 budget/trace violations,
    2 usage error, 3 module has no concrete actor types. `--json`
    emits failures in the lint finding format (one object per line)."""
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    if not argv:
        print("ponyc_tpu_torch verify: missing module", file=sys.stderr)
        return 2
    mod, atypes = _load_module_types("verify", argv[0])
    if mod is None:
        return atypes
    from .lint.rules import Finding
    from .verify import VerifyError, behaviour_location, verify_behaviour
    bad = 0
    for atype in atypes:
        for bdef in atype.behaviour_defs:
            try:
                eff = verify_behaviour(bdef)
            except (VerifyError, TypeError, RuntimeError) as e:
                # Budget violations AND trace-time failures
                # (sendability/capability errors) report as FAILs, not
                # tracebacks, and the sweep continues.
                file, line = behaviour_location(bdef)
                if as_json:
                    print(Finding("VERIFY", "error", atype.__name__,
                                  bdef.name, str(e), file=file,
                                  line=line).json_line())
                else:
                    print(f"FAIL {atype.__name__}.{bdef.name}: {e}")
                bad += 1
                continue
            if not as_json:
                marks = eff.marks() or "pure state update"
                print(f"ok   {atype.__name__}.{bdef.name}: {marks}")
    return 1 if bad else 0


def cmd_lint(argv) -> int:
    """Whole-program lint (≙ reach/paint + the capability checks run
    program-wide, plus the compiler's syntactic body checks;
    ponyc_tpu_torch/lint). Targets are module names (graph rules R1–R5 from
    probe traces + body rules R6–R9) and/or file/directory paths
    (`lint examples/` — body rules only, pure AST: the files are
    PARSED, never imported, so a file whose imports are broken still
    lints, with no torch in the loop).

    Roots (host inject sites) come from --roots / the module's
    LINT_ROOTS / actor-type LINT_ROOTS; with none declared, any
    behaviour is assumed injectable (R1 and the rooted R2 sub-rule
    stay quiet). Output: human (default), --json (one object per
    line), --format github (::warning/::error annotations). Exit
    codes: 0 clean (info-severity findings are advisory), 1 findings
    at warning/error, 2 usage, 3 no actor types found."""
    fmt = "human"
    if "--json" in argv:
        fmt = "json"
        argv = [a for a in argv if a != "--json"]
    if "--format" in argv:
        i = argv.index("--format")
        if i + 1 >= len(argv) or argv[i + 1] not in ("human", "json",
                                                     "github"):
            print("ponyc_tpu_torch lint: --format takes human|json|github",
                  file=sys.stderr)
            return 2
        fmt = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    roots = None
    if "--roots" in argv:
        i = argv.index("--roots")
        if i + 1 >= len(argv):
            print("ponyc_tpu_torch lint: --roots needs a value "
                  "(e.g. --roots Main.create,Ring.token)",
                  file=sys.stderr)
            return 2
        roots = [r for r in argv[i + 1].split(",") if r]
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print("ponyc_tpu_torch lint: missing module or path", file=sys.stderr)
        return 2
    from .lint import (check_paths, findings_to_github,
                       findings_to_json, format_findings, lint_types)
    findings = []
    n_types = n_beh = 0
    paths = [a for a in argv if os.path.exists(a)]
    modules = [a for a in argv if a not in paths]
    if paths:
        pf, pt, pb = check_paths(paths)
        findings += pf
        n_types += pt
        n_beh += pb
    for modname in modules:
        mod, atypes = _load_module_types("lint", modname)
        if mod is None:
            return atypes
        mroots = roots if roots is not None else getattr(
            mod, "LINT_ROOTS", None)
        try:
            findings += lint_types(*atypes, roots=mroots)
        except (TypeError, ValueError) as e:
            print(f"ponyc_tpu_torch lint: {e}", file=sys.stderr)
            return 2
        n_types += len(atypes)
        n_beh += sum(len(t.behaviour_defs) for t in atypes)
    if not n_types:
        print("ponyc_tpu_torch lint: no actor types found in "
              + ", ".join(argv), file=sys.stderr)
        return 3
    if fmt == "json":
        out = findings_to_json(findings)
        if out:
            print(out)
    elif fmt == "github":
        out = findings_to_github(findings)
        if out:
            print(out)
    else:
        if findings:
            print(format_findings(findings))
        by_sev = {}
        for f in findings:
            by_sev[f.severity] = by_sev.get(f.severity, 0) + 1
        summary = (", ".join(f"{n} {s}" for s, n in sorted(by_sev.items()))
                   or "clean")
        print(f"lint: {n_types} type(s), {n_beh} behaviour(s): "
              f"{summary}")
    return 1 if any(f.severity in ("error", "warning")
                    for f in findings) else 0


def cmd_trace(argv) -> int:
    """Convert analysis CSVs to a Chrome-trace/Perfetto JSON:

        ponyc_tpu_torch trace <analytics.csv> [-o out.trace.json]
                              [--spans <spans.jsonl>]
        ponyc_tpu_torch trace --tree <spans.jsonl>

    The first form merges the window/counter tracks with the causal-
    trace span slices and sender→receiver flow arrows (`--spans`
    overrides the `<csv>.spans.jsonl` default). The second prints the
    reassembled causal trees — one indented tree per sampled trace with
    its critical-path latency in device ticks."""
    if "--tree" in argv:
        argv = [a for a in argv if a != "--tree"]
        if not argv:
            print("ponyc_tpu_torch trace: --tree needs a <spans.jsonl> "
                  "path", file=sys.stderr)
            return 2
        from .tracing import format_trace, load_spans, reassemble
        try:
            trees = reassemble(load_spans(argv[0]))
        except OSError as e:
            print(f"ponyc_tpu_torch trace: {e}", file=sys.stderr)
            return 2
        if not trees:
            print("(no spans recorded — is tracing on? "
                  "RuntimeOptions(analysis=3, trace_sample=N))")
            return 0
        for tid in sorted(trees):
            print(format_trace(tid, trees[tid]))
        return 0
    out = "trace.json"
    spans = None
    if "--spans" in argv:
        i = argv.index("--spans")
        if i + 1 >= len(argv):
            print("ponyc_tpu_torch trace: --spans needs a path",
                  file=sys.stderr)
            return 2
        spans = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if "-o" in argv:
        i = argv.index("-o")
        if i + 1 >= len(argv):
            print("ponyc_tpu_torch trace: -o needs a path",
                  file=sys.stderr)
            return 2
        out = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print("ponyc_tpu_torch trace: missing <analytics.csv> "
              "(RuntimeOptions.analysis_path)", file=sys.stderr)
        return 2
    from .analysis import chrome_trace
    try:
        print(chrome_trace(argv[0], out, spans_path=spans))
    except OSError as e:
        print(f"ponyc_tpu_torch trace: {e}", file=sys.stderr)
        return 2
    return 0


def cmd_top(argv) -> int:
    """Live profiler view: tails the level-2 window CSV a running
    runtime's writer thread appends to and reprints one frame per
    interval — throughput, queue pressure, GC, per-behaviour runs,
    per-cohort queue-wait percentiles (analysis.top_frame).

    ponyc_tpu_torch top [<analytics.csv>] [--interval S] [--once]"""
    import time as _time
    interval, once = 1.0, False
    path = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--interval":
            if i + 1 >= len(argv):
                print("ponyc_tpu_torch top: --interval needs seconds",
                      file=sys.stderr)
                return 2
            try:
                interval = float(argv[i + 1])
            except ValueError:
                print(f"ponyc_tpu_torch top: bad interval "
                      f"{argv[i + 1]!r}", file=sys.stderr)
                return 2
            i += 2
            continue
        if a == "--once":
            once = True
            i += 1
            continue
        if path is not None:
            print("ponyc_tpu_torch top: one CSV path only",
                  file=sys.stderr)
            return 2
        path = a
        i += 1
    if path is None:
        from .config import RuntimeOptions
        path = RuntimeOptions().analysis_path
    from .analysis import top_frame
    try:
        while True:
            try:
                frame = top_frame(path)
            except FileNotFoundError:
                frame = (f"ponyc_tpu top — {path}\n(waiting for a "
                         "runtime with analysis>=2 to write windows)")
            if once:
                print(frame)
                return 0
            # Clear + home, then the frame: a plain-ANSI live view.
            print("\x1b[2J\x1b[H" + frame, flush=True)
            _time.sleep(max(0.05, interval))
    except KeyboardInterrupt:
        return 0


def cmd_doctor(argv) -> int:
    """Operational diagnosis: read stall/crash evidence and lead with a
    one-line verdict.

        ponyc_tpu_torch doctor --postmortem <file.postmortem.json>
        ponyc_tpu_torch doctor <host:port | http://host:port>

    The first form renders a flight-recorder postmortem (also a JSON
    file whose `postmortem` key holds one); the second GETs /healthz and
    /metrics from a live runtime (RuntimeOptions.metrics_port). Exit
    codes: 0 the world looks healthy (ok / plain snapshot), 1 stalled/
    crashed/degraded, 2 usage error or unreadable target."""
    from .flight import diagnose_postmortem, load_postmortem
    if "--postmortem" in argv:
        i = argv.index("--postmortem")
        if i + 1 >= len(argv):
            print("ponyc_tpu_torch doctor: --postmortem needs a file",
                  file=sys.stderr)
            return 2
        path = argv[i + 1]
        try:
            pm = load_postmortem(path)
        except (OSError, ValueError) as e:
            # A wrapper JSON carries the postmortem nested under
            # "postmortem": accept it directly.
            import json
            try:
                with open(path) as f:
                    obj = json.load(f)
                pm = obj["postmortem"]
                if not isinstance(pm, dict) or "reason" not in pm:
                    raise KeyError("postmortem")
            except (OSError, ValueError, KeyError, TypeError):
                print(f"ponyc_tpu_torch doctor: {e}", file=sys.stderr)
                return 2
        line, detail = diagnose_postmortem(pm)
        print(line)
        print(detail)
        return 0 if line.startswith(("OK", "SNAPSHOT")) else 1
    if not argv or argv[0].startswith("-"):
        print("ponyc_tpu_torch doctor: need --postmortem FILE or a live "
              "host:port / URL (RuntimeOptions.metrics_port)",
              file=sys.stderr)
        return 2
    from .metrics import diagnose_endpoint
    try:
        status, line, detail = diagnose_endpoint(argv[0])
    except (OSError, ValueError) as e:
        print(f"ponyc_tpu_torch doctor: endpoint {argv[0]} unreachable: "
              f"{e}", file=sys.stderr)
        return 2
    print(line)
    print(detail)
    return 0 if status == "ok" else 1


def _resolve_snapshot_target(target: str):
    """A snapshot CLI target is a file OR a checkpoint-ring prefix;
    returns (path, err). Prefixes resolve to the newest intact ring
    file (falling back past corrupt ones, like the supervisor)."""
    from . import serialise
    if os.path.exists(target):
        return target, None
    ring = serialise.list_checkpoints(target)
    if not ring:
        return None, (f"no such snapshot file and no checkpoint ring "
                      f"under prefix {target!r}")
    path = serialise.newest_intact(target)
    if path is None:
        return None, (f"all {len(ring)} ring snapshot(s) under "
                      f"{target!r} are corrupt")
    return path, None


def cmd_snapshot(argv) -> int:
    """Inspect a world snapshot (serialise.py): header summary +
    checksum verdict. Exit 0 intact, 1 corrupt/unreadable, 2 usage."""
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    if len(argv) != 1:
        print("ponyc_tpu_torch snapshot: need exactly one <file|ring-prefix>",
              file=sys.stderr)
        return 2
    from . import serialise
    path, err = _resolve_snapshot_target(argv[0])
    if err:
        print(f"ponyc_tpu_torch snapshot: {err}", file=sys.stderr)
        return 1 if "corrupt" in err else 2
    try:
        header = serialise.verify_snapshot(path)
    except (serialise.SnapshotCorruptError,
            serialise.SnapshotFormatError, OSError) as e:
        print(f"ponyc_tpu_torch snapshot: CORRUPT — {e}", file=sys.stderr)
        return 1
    geo = header.get("geometry", {})
    info = {
        "path": path,
        "format": header.get("format"),
        "intact": True,
        "fingerprint": header.get("fingerprint"),
        "age_s": (round(time.time() - header["time"], 1)
                  if header.get("time") else None),
        "steps_run": header.get("steps_run"),
        "actors_total": geo.get("total"),
        "shards": geo.get("shards"),
        "mailbox_cap": geo.get("mailbox_cap"),
        "cohorts": {c["name"]: c["capacity"]
                    for c in geo.get("cohorts", [])},
        "totals": header.get("totals", {}),
    }
    if as_json:
        print(json.dumps(info))
    else:
        print(f"{path}: INTACT (format v{info['format']}, "
              f"fingerprint {info['fingerprint']})")
        print(f"  steps_run={info['steps_run']} "
              f"actors={info['actors_total']} shards={info['shards']} "
              f"mailbox_cap={info['mailbox_cap']}"
              + (f" age={info['age_s']}s"
                 if info["age_s"] is not None else ""))
        if info["cohorts"]:
            print("  cohorts: " + ", ".join(
                f"{n}[{c}]" for n, c in info["cohorts"].items()))
    return 0


def cmd_restore(argv) -> int:
    """Deep restorability check: full verification of every array plus
    the format gate — what serialise.restore() would accept. Exit 0
    restorable, 1 corrupt/unreadable, 2 usage."""
    if len(argv) != 1:
        print("ponyc_tpu_torch restore: need exactly one <file|ring-prefix> "
              "(in-program restore is serialise.restore(rt, path))",
              file=sys.stderr)
        return 2
    from . import serialise
    path, err = _resolve_snapshot_target(argv[0])
    if err:
        print(f"ponyc_tpu_torch restore: {err}", file=sys.stderr)
        return 1 if "corrupt" in err else 2
    try:
        header = serialise.verify_snapshot(path)
    except (serialise.SnapshotCorruptError,
            serialise.SnapshotFormatError, OSError) as e:
        print(f"ponyc_tpu_torch restore: NOT RESTORABLE — {e}",
              file=sys.stderr)
        return 1
    geo = header.get("geometry", {})
    print(f"{path}: RESTORABLE (format v{header.get('format')}, "
          f"{geo.get('total', '?')} actor rows, "
          f"step {header.get('steps_run', '?')}; restore with "
          "serialise.restore(rt, path) — geometry may differ since v3)")
    return 0


def cmd_supervise(argv) -> int:
    """Run a workload script under restart-from-checkpoint supervision
    (supervise.Supervisor subprocess mode)."""
    retries, backoff, prefix = 5, 0.25, None
    rest: list = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if rest:                      # after the script: its own argv
            rest.append(a)
            i += 1
            continue
        if a in ("--retries", "--backoff", "--prefix"):
            if i + 1 >= len(argv):
                print(f"ponyc_tpu_torch supervise: {a} needs a value",
                      file=sys.stderr)
                return 2
            try:
                if a == "--retries":
                    retries = int(argv[i + 1])
                elif a == "--backoff":
                    backoff = float(argv[i + 1])
                else:
                    prefix = argv[i + 1]
            except ValueError:
                print(f"ponyc_tpu_torch supervise: bad value for {a}: "
                      f"{argv[i + 1]!r}", file=sys.stderr)
                return 2
            i += 2
            continue
        rest.append(a)
        i += 1
    if not rest or prefix is None:
        print("ponyc_tpu_torch supervise: need --prefix <checkpoint-prefix> "
              "and a <script.py> (the script should set "
              "RuntimeOptions(checkpoint_every_s=..., checkpoint_path="
              "<prefix>) and call supervise.maybe_restore(rt))",
              file=sys.stderr)
        return 2
    script = rest[0]
    if not os.path.exists(script):
        print(f"ponyc_tpu_torch supervise: no such script: {script}",
              file=sys.stderr)
        return 2
    from .supervise import PoisonError, Supervisor
    # The child must find THIS ponyc_tpu_torch whatever directory its
    # script lives in: append our package root to PYTHONPATH (append,
    # not replace — an environment's own entries stay first).
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    existing = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = (existing + os.pathsep + pkg_root
                                if existing else pkg_root)
    sup = Supervisor(argv=[sys.executable, script] + rest[1:],
                     prefix=prefix, retries=retries, backoff_s=backoff)
    try:
        code = sup.run()
    except PoisonError as e:
        print(f"ponyc_tpu_torch supervise: POISON — {e}", file=sys.stderr)
        return 3
    if sup.restarts:
        print(f"ponyc_tpu_torch supervise: recovered after {sup.restarts} "
              f"restart(s); final exit {code}", file=sys.stderr)
    return code


def cmd_run(argv) -> int:
    """The JAX package's `run` verb without its backend choice: the port
    has one device, the card, and never falls back to the CPU here (a
    script's Runtime() raises where there is no card)."""
    # --safe pkg1:pkg2 / --safe=pkg1:pkg2 (≙ ponyc --safe,
    # package.c:685-692): restrict FFI-reaching packages for the
    # program being run.
    cleaned = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--safe":
            if i + 1 >= len(argv):
                print("ponyc_tpu_torch run: --safe needs a value "
                      "(e.g. --safe files:net)", file=sys.stderr)
                return 2
            os.environ["PONY_TPU_SAFE"] = argv[i + 1]
            i += 2
            continue
        if a.startswith("--safe="):
            os.environ["PONY_TPU_SAFE"] = a[len("--safe="):]
            i += 1
            continue
        cleaned.append(a)
        i += 1
    from .config import strip_runtime_flags
    opts, rest = strip_runtime_flags(cleaned)
    if not rest:
        print("ponyc_tpu_torch run: missing script path", file=sys.stderr)
        return 2
    # Hand the parsed runtime options to the script via the env channel
    # config.options_from_env reads, so `run app.py --ponybatch 4`
    # configures app.py's runtime (≙ pony_init eating --pony* from argv).
    defaults = type(opts)()
    for f in dataclasses.fields(opts):
        v = getattr(opts, f.name)
        if v != getattr(defaults, f.name) and v is not None:
            os.environ["PONY_TPU_" + f.name.upper()] = str(v)
    script, *args = rest
    if not os.path.exists(script):
        print(f"ponyc_tpu_torch run: no such script: {script}",
              file=sys.stderr)
        return 2
    sys.argv = [script] + args
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)) or ".")
    runpy.run_path(script, run_name="__main__")
    return 0


def cmd_serve(argv) -> int:
    """Run the serving front door (serve.py: batched socket ingress,
    admission control, graceful drain) over the default compute
    service."""
    from .serve import main as serve_main
    return serve_main(argv)


def cmd_version(_argv) -> int:
    import torch

    from . import __version__
    print(f"ponyc_tpu_torch {__version__}")
    print(f"torch {torch.__version__} (CUDA build {torch.version.cuda})")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        print(f"backend: cuda — {torch.cuda.get_device_name(0)}"
              + (f" (+{n - 1} more)" if n > 1 else ""))
    else:
        print("backend: cpu (no CUDA device; Runtime(opts, "
              "device='cpu') runs here)")
    return 0


COMMANDS = {"run": cmd_run, "test": cmd_test, "doc": cmd_doc,
            "verify": cmd_verify, "lint": cmd_lint, "trace": cmd_trace,
            "top": cmd_top, "doctor": cmd_doctor,
            "snapshot": cmd_snapshot, "restore": cmd_restore,
            "supervise": cmd_supervise, "serve": cmd_serve,
            "version": cmd_version}

# The JAX package's other verbs, and what part of the port brings each
# (ROADMAP.md, Queue 1).
NOT_SERVED = {
    "bench": "the port's bench (ROADMAP Queue 1 item 1)",
    "perf": "the port's bench, whose history the scoreboard reads "
            "(ROADMAP Queue 1 item 1)",
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        return _usage(0 if argv else 2)
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        if argv[0] in NOT_SERVED:
            print(f"ponyc_tpu_torch: {argv[0]!r} is not served by the "
                  f"PyTorch port yet; {NOT_SERVED[argv[0]]} brings it",
                  file=sys.stderr)
        else:
            print(f"ponyc_tpu_torch: unknown command {argv[0]!r} "
                  f"(expected one of {', '.join(COMMANDS)})",
                  file=sys.stderr)
        return 2
    return cmd(argv[1:])


if __name__ == "__main__":
    sys.exit(main())

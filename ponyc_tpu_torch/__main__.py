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
  version                     print the version, the torch build and
                              the card.

The JAX package's other verbs (bench, test, doc, verify, lint, perf)
print which part of the port brings them and exit 2.

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


COMMANDS = {"run": cmd_run, "trace": cmd_trace, "top": cmd_top,
            "doctor": cmd_doctor, "snapshot": cmd_snapshot,
            "restore": cmd_restore,
            "supervise": cmd_supervise, "serve": cmd_serve,
            "version": cmd_version}

# The JAX package's other verbs, and what part of the port brings each
# (ROADMAP.md, "Port slices" and Queue 1).
NOT_SERVED = {
    "bench": "the port's bench (ROADMAP Queue 1 item 1)",
    "test": "the port's bench (ROADMAP Queue 1 item 1)",
    "perf": "the port's bench and cost capture (port slice 11, "
            "ROADMAP Queue 1 items 1 and 5)",
    "doc": "the static checks (ROADMAP Queue 1 item 8)",
    "verify": "the static checks (ROADMAP Queue 1 item 8)",
    "lint": "the static checks (ROADMAP Queue 1 item 8)",
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

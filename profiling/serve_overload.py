"""The serve phase's overload (chip_smoke.py, `serve`) against the serve
verb of either package, run as a process of its own: calibration (2
connections x depth 2 x 30 requests), then 64 connections x 2,048
outstanding for 3 s with a 1,000 ms deadline and a 5 ms BUSY backoff,
driven from this process by the port's loadgen (pure sockets), then
SIGTERM and the drain. Prints what the client saw (goodput, OK p50/p99,
shed rate) and what the server spent: wall and CPU µs a frame of the
overload stage, the CPU read from /proc/<pid>/stat around that stage.

    python3 profiling/serve_overload.py [--package ponyc_tpu_torch|ponyc_tpu]
        [--cpu] [--threads N] [--runs N]
        [--profile PREFIX] [--out FILE]

`--package ponyc_tpu` starts the JAX package's `python -m ponyc_tpu
serve` with JAX_PLATFORMS=cpu: that comparison is for the CPU only, and
this script imports nothing of the JAX package (the load is the port's
loadgen over sockets, the server a child). `--cpu` runs the port's world on the CPU (its default
is the CUDA device); `--threads N` sets the server's OMP_NUM_THREADS;
`--profile PREFIX` runs the server under cProfile (its run-loop thread:
ingress, windows), which slows it, so its times are read one against
the other and not as the server's.
The deadline starts when the server reads a frame
(serve.Server._on_request), so a frame that waits in the socket's
buffer is not shed for that wait; the client's latency includes it, the
server's (`server_p50_us`) does not.
"""

import argparse
import json
import os
import select
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WORKERS = 1 << 16                     # the serve phase's worker pool
CALIB = (2, 2, 30)                    # conns, depth, requests a conn
LOAD = (64, 2048, 3.0, 0.005, 1000)   # conns, depth, s, backoff, deadline ms
TAIL_S = 120.0


def cpu_s(pid):
    """utime + stime of process `pid`, all its threads, in seconds."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def one_run(package, workers, cpu, threads=None, profile=None):
    from ponyc_tpu_torch import loadgen
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    cmd = [sys.executable] + (["-m", "cProfile", "-o", profile]
                              if profile else []) + [
        "-m", package, "serve", "--workers", str(workers)]
    if package == "ponyc_tpu":
        env["JAX_PLATFORMS"] = "cpu"
    elif cpu:
        cmd.append("--cpu")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ready, _w, _x = select.select([proc.stdout], [], [], 600)
        line = proc.stdout.readline() if ready else ""
        if not line.startswith("serving on"):
            proc.kill()
            raise RuntimeError(f"{package} serve: {line!r} "
                               f"{proc.stderr.read()[-2000:]}")
        port = int(line.split()[2].split(":")[1])
        start_s = time.perf_counter() - t0
        c, d, r = CALIB
        calib = loadgen.run_load("127.0.0.1", port, conns=c, depth=d,
                                 requests=r, timeout_s=60.0)
        lc, ld, secs, backoff, ddl = LOAD
        c0, m0 = cpu_s(proc.pid), cpu_s(os.getpid())
        load = loadgen.run_load("127.0.0.1", port, conns=lc, depth=ld,
                                requests=1 << 30, duration_s=secs,
                                deadline_ms=ddl, busy_backoff_s=backoff,
                                tail_s=TAIL_S, timeout_s=60.0)
        load_cpu = cpu_s(proc.pid) - c0
        client_cpu = cpu_s(os.getpid()) - m0
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stats = None
    for ln in err.splitlines():
        if ln.startswith("serve: drained "):
            stats = json.loads(ln[len("serve: drained "):])
    if proc.returncode != 0 or stats is None:
        raise RuntimeError(f"{package} serve: exit {proc.returncode} "
                           f"{err[-2000:]}")
    frames = load["sent"]
    answered = (load["ok"] + load["busy"] + load["deadline"]
                + load["badframe"])
    return dict(package=package, device="cpu" if cpu or package ==
                "ponyc_tpu" else "cuda", workers=workers, start_s=start_s,
                calib_ok=calib["ok"], calib_p50_us=calib["p50_us"],
                sent=frames, answered=answered,
                unanswered=load["unanswered"], ok=load["ok"],
                busy=load["busy"], deadline=load["deadline"],
                p50_us=load["p50_us"], p99_us=load["p99_us"],
                goodput_rps=load["goodput_rps"],
                shed_rate=load["shed_rate"], load_s=load["elapsed_s"],
                wall_us_a_frame=1e6 * load["elapsed_s"] / max(1, frames),
                server_cpu_s=load_cpu,
                cpu_us_a_frame=1e6 * load_cpu / max(1, frames),
                client_cpu_s=client_cpu, threads=threads,
                server_p50_us=stats["latency_us"]["p50"],
                server_p99_us=stats["latency_us"]["p99"],
                server_frames=stats["frames"],
                submitted=stats["submitted"], batches=stats["batches"],
                drained=stats["drained"], exit=proc.returncode)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default="ponyc_tpu_torch",
                    choices=("ponyc_tpu_torch", "ponyc_tpu"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--threads", type=int, default=None,
                    help="OMP_NUM_THREADS for the server (default: unset)")
    ap.add_argument("--profile", metavar="PREFIX",
                    help="run the server under cProfile, its stats to "
                         "PREFIX.<run> (pstats)")
    ap.add_argument("--out")
    args = ap.parse_args()
    print(f"host: {os.cpu_count()} cores", flush=True)
    res = []
    for i in range(args.runs):
        r = one_run(args.package, WORKERS, args.cpu, args.threads,
                    args.profile and f"{args.profile}.{i}")
        res.append(r)
        print(f"{r['package']} on the {r['device']}, {r['workers']} "
              f"workers, run {i}: calibration {r['calib_ok']} OK, p50 "
              f"{r['calib_p50_us']} us; overload {r['sent']} sent, "
              f"{r['answered']} answered ({r['unanswered']} not), "
              f"{r['ok']} OK, {r['busy']} BUSY, {r['deadline']} DEADLINE; "
              f"OK p50 {r['p50_us']} us, p99 {r['p99_us']} us; goodput "
              f"{r['goodput_rps']} rps, shed rate {r['shed_rate']}; "
              f"{r['load_s']} s = {r['wall_us_a_frame']:.1f} us a frame "
              f"of wall, the server's CPU {r['server_cpu_s']:.2f} s = "
              f"{r['cpu_us_a_frame']:.1f} us a frame (threads "
              f"{r['threads']}), the client's {r['client_cpu_s']:.2f} s; "
              f"OK p50 {r['server_p50_us']} us and p99 "
              f"{r['server_p99_us']} us from the server's read of the "
              f"frame; {r['submitted']} "
              f"submitted in {r['batches']} batches; exit {r['exit']}, "
              f"drained {r['drained']}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))


if __name__ == "__main__":
    main()

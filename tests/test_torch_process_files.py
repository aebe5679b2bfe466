"""Child processes and the file system on both packages: the cases of
tests/test_process_files.py (≙ packages/process and packages/files) run
through the JAX package and through the port (on the CPU), and must give
the same results, exactly.

The three process cases share one runtime a package (`proc_worlds`,
built once for the module: the JAX package's costs an XLA compile a
start): three collectors, one child each, run until every child has
been reaped."""

import importlib

import pytest

import ponyc_tpu
import ponyc_tpu_torch

PKGS = (ponyc_tpu, ponyc_tpu_torch)


def _runtime(pkg, opts_kw):
    opts = pkg.RuntimeOptions(tuning_cache="off", **opts_kw)
    if pkg is ponyc_tpu_torch:
        return pkg.Runtime(opts, device="cpu")
    return pkg.Runtime(opts)


def _collector(pkg):
    I32 = pkg.I32
    chunks = {}

    @pkg.actor
    class Collector:
        HOST = True
        n_out: I32
        n_err: I32
        code: I32
        done: I32

        @pkg.behaviour
        def on_stdout(self, st, proc: I32, data: I32, n: I32):
            chunks.setdefault(int(self.actor_id), []).append(
                self.rt.heap.unbox(data))
            return {**st, "n_out": st["n_out"] + n}

        @pkg.behaviour
        def on_stderr(self, st, proc: I32, data: I32, n: I32):
            self.rt.heap.drop(data)
            return {**st, "n_err": st["n_err"] + n}

        @pkg.behaviour
        def on_exit(self, st, proc: I32, code: I32):
            return {**st, "code": code, "done": 1}

    return Collector, chunks


CASES = {
    "echo": ["sh", "-c", "echo hello-child; exit 7"],
    "stdin": ["sh", "-c", "cat; echo oops >&2"],
    "kill": ["sh", "-c", "sleep 30"],
}


def _proc_world(pkg):
    C, chunks = _collector(pkg)
    rt = _runtime(pkg, dict(mailbox_cap=16, batch=4, max_sends=2,
                            msg_words=4, inject_slots=32))
    rt.declare(C, len(CASES)).start()
    procs = rt.attach_processes()
    assert rt.attach_processes() is procs
    owners, pids = {}, {}
    for name, argv in CASES.items():
        owners[name] = rt.spawn(C)
        pids[name] = procs.spawn(
            "/bin/sh", argv, owners[name], on_stdout=C.on_stdout,
            on_stderr=C.on_stderr, on_exit=C.on_exit)
    procs.write(pids["stdin"], b"pass-through-bytes")
    procs.close_stdin(pids["stdin"])
    procs.kill(pids["kill"], 9)
    rt.run(max_steps=20_000)
    out = {name: {**{k: int(v) for k, v in rt.state_of(a).items()},
                  "stdout": b"".join(chunks.get(int(a), []))}
           for name, a in owners.items()}
    bad = {"type": None}
    try:
        procs.spawn("/bin/sh", ["sh"], owners["echo"], on_stdout=C.on_exit,
                    on_stderr=C.on_stderr, on_exit=C.on_exit)
    except TypeError as e:
        bad = {"type": "TypeError", "text": str(e)}
    out["bad_arity"] = bad
    rt.stop()
    return out


@pytest.fixture(scope="module")
def proc_worlds():
    return [_proc_world(pkg) for pkg in PKGS]


@pytest.mark.parametrize("case", sorted(CASES) + ["bad_arity"])
def test_process_case_equals_jax(proc_worlds, case):
    want, got = (w[case] for w in proc_worlds)
    assert got == want
    if case == "echo":
        assert got["code"] == 7 and got["stdout"] == b"hello-child\n"
    elif case == "stdin":
        assert got["code"] == 0 and got["stdout"] == b"pass-through-bytes"
        assert got["n_err"] == len(b"oops\n")
    elif case == "kill":
        assert got["code"] == 256 + 9 and got["done"] == 1


# ---- files (≙ packages/files) ----

def _files(pkg):
    return importlib.import_module(pkg.__name__ + ".files")


def _file_runtime(pkg):
    C, _ = _collector(pkg)
    rt = _runtime(pkg, dict(mailbox_cap=8, batch=1, max_sends=1,
                            msg_words=4, inject_slots=8))
    rt.declare(C, 1)
    return rt


def _capabilities(pkg, tmp):
    F = _files(pkg)
    rt = _file_runtime(pkg)
    base = F.FilePath(rt.files_auth(), str(tmp))
    sub = base.join("inner/deeper")
    out = [sub.mkdir(), sub.is_dir(), sub.path[len(str(tmp)):]]
    for bad in (lambda: base.join("../escape"),
                lambda: F.FilePath("not-an-auth", "/etc"),
                lambda: F.FilesAuth(object())):
        try:
            bad()
            out.append("allowed")
        except PermissionError as e:
            out.append(("PermissionError", str(e).replace(str(tmp), "T")))
    return out


def _write_read_seek(pkg, tmp):
    F = _files(pkg)
    rt = _file_runtime(pkg)
    fp = F.FilePath(rt.files_auth(), str(tmp)).join("log.txt")
    with F.File(fp, "w+b") as f:
        f.print("line one").print("line two").flush()
        size = f.size()
        f.seek_start(5)
        pos = f.position()
        rest = f.read(4)
    with F.File(fp, "rb") as f:
        lines = f.lines()
    return [size, pos, rest, lines, fp.is_file(), fp.exists(),
            fp.info().st_size]


def _walk_remove(pkg, tmp):
    F = _files(pkg)
    rt = _file_runtime(pkg)
    base = F.FilePath(rt.files_auth(), str(tmp))
    d = F.Directory(base)
    sub = d.mkdir("pkg")
    sub.open_file("a.txt").write(b"a").dispose()
    sub.open_file("b.txt").write(b"b").dispose()
    walked = sorted((fp.path[len(str(tmp)):], dirs, files)
                    for fp, dirs, files in d.walk())
    entries = sub.entries()
    return [entries, walked, base.join("pkg").remove(),
            base.join("pkg").exists()]


@pytest.mark.parametrize("case", [_capabilities, _write_read_seek,
                                  _walk_remove],
                         ids=["capabilities", "write_read_seek",
                              "walk_remove"])
def test_files_case_equals_jax(tmp_path, case):
    runs = []
    for pkg in PKGS:
        (tmp_path / pkg.__name__).mkdir()
        runs.append(case(pkg, tmp_path / pkg.__name__))
    want, got = runs
    assert got == want
    assert got[0] not in (False, "allowed")


def test_ambient_auth_is_minted_only_by_the_runtime():
    rt = _file_runtime(ponyc_tpu_torch)
    from ponyc_tpu_torch.runtime.runtime import AmbientAuth
    auth = rt.ambient_auth()
    assert isinstance(auth, AmbientAuth) and auth._rt is rt
    with pytest.raises(PermissionError):
        AmbientAuth(rt)
    bp = importlib.import_module("ponyc_tpu_torch.stdlib.backpressure")
    assert bp.ApplyReleaseBackpressureAuth(auth)._rt is rt

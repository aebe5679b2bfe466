"""The port's standard library (ponyc_tpu_torch/stdlib/) against the JAX
package's: each module gets the same inputs through both packages and
must give the same outputs, exactly (values, reprs, raised error types
and messages; the graph serialiser's bytes). stdlib.random has its own
file (tests/test_torch_random.py).

The modules that drive a runtime (timers, backpressure, signals, the
custodian's actor disposal, a promise fulfilled by a host actor) run in
one world a package (`host_world`), built once for the module: the JAX
package's costs an XLA compile a start."""

import importlib
import io
import os
import signal as _os_signal
import time

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch

PKGS = (ponyc_tpu, ponyc_tpu_torch)


def S(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.stdlib.{name}")


def _outcome(fn, *args):
    """fn's value, or the type and text of what it raised."""
    try:
        return ("ok", fn(*args))
    except Exception as e:             # noqa: BLE001 - compared, not hidden
        return ("raised", type(e).__name__, str(e))


# ---- pure data packages: one scenario each, the same on both ----------

def sc_collections(pkg):
    c = S(pkg, "collections")
    f = c.Flags().set(1).set(2)
    mn, mx = c.MinHeap(), c.MaxHeap()
    for v in [5, 1, 4, 1, 9, 7]:
        mn.push(v)
        mx.push(v)
    rb = c.RingBuffer(4)
    pushed = [rb.push(i) for i in range(6)]
    lst = c.List([1, 2, 3])
    lst.head().next().remove()
    lst.unshift(0)
    return [f.value(), (f | c.Flags(4)).value(), c.Flags(1) < c.Flags(3),
            list(c.Range(10, -5, -5)), c.Range(0, 1, 0).is_infinite(),
            [mn.pop() for _ in range(len(mn))],
            [mx.pop() for _ in range(len(mx))], pushed, rb.head(), rb(5),
            _outcome(rb, 0), c.Sort.apply([3, 1, 2, 9, 7, 7, 0]),
            c.Sort.by(["bb", "a", "ccc"], len), list(c.Reverse(10, 2, 2)),
            list(lst), lst.pop()]


def sc_persistent(pkg):
    p = S(pkg, "persistent")
    m = p.Map()
    for i in range(300):
        m = m.update(f"k{i}", i)
    for i in range(0, 300, 3):
        m = m.remove(f"k{i}")
    v = p.Vec()
    for i in range(1100):
        v = v.push(i * 3)
    v2 = v.update(500, -1)
    v3, last = v2.pop()
    lst = p.List.of([1, 2, 3])
    s = p.Set.of([1, 2, 3])
    return [m.size(), sorted(m.values())[:10], m.get_or_else("k0", -7),
            _outcome(m, "k3"), v.size(), v2(500), v(500), last, v3.size(),
            list(lst.prepend(0)),
            lst.map(lambda x: x * 2).fold(lambda a, b: a + b, 0),
            sorted(s.union(p.Set.of([3, 4]))),
            sorted(s.intersect(p.Set.of([2, 3, 9]))),
            sorted(s.difference(p.Set.of([1])))]


def sc_json(pkg):
    j = S(pkg, "json")
    d = j.JsonDoc()
    d.parse('{"a": 1, "b": [true, null, 2.5, "x\\n"], '
            '"c": {"d": -3e2}, "u": "\\u0041\\ud83d\\ude00"}')
    out = [d.string(), d.string(indent="  ", pretty_print=True)]
    for bad in ('{"a": 1,\n "b": }', "{", "[1,]", "tru", '{"a" 1}', "01x",
                '"\\q"', "1 2", '"\\ud83d"'):
        out.append(_outcome(d.parse, bad))
        out.append(d.parse_report())
    return out


def sc_cli(pkg):
    c = S(pkg, "cli")

    def spec():
        sp = c.CommandSpec.parent("tool", "A tool", options=[
            c.OptionSpec.bool("verbose", "Noisy", short="v", default=False),
            c.OptionSpec.string("name", "Name", short="n", default="anon")])
        sp.add_command(c.CommandSpec.leaf("run", "Run", options=[
            c.OptionSpec.i64("count", "How many", short="c", default=1),
            c.OptionSpec.string_seq("tag", "Tags", short="t")],
            args=[c.ArgSpec.string("target", "Target"),
                  c.ArgSpec.f64("scale", "Scale", default=1.0)]))
        sp.add_help()
        return sp

    out = []
    for argv in (["tool", "-v", "run", "--count=3", "-t", "a", "-t", "b",
                  "x", "2.5"], ["tool", "nope"], ["tool", "run"],
                 ["tool", "run", "--count=zz", "x"],
                 ["tool", "run", "x", "1.0", "extra"], ["tool"],
                 ["tool", "help", "run"], ["tool", "run", "--", "-v"]):
        r = c.CommandParser(spec()).parse(argv)
        if isinstance(r, c.Command):
            out.append((r.full_name(), r.option("verbose"), r.option("name"),
                        r.option("count"), r.option("tag"),
                        r.arg("target"), r.arg("scale")))
        elif isinstance(r, c.CommandHelp):
            out.append(r.help_string())
        else:
            out.append(r.string())
    env = c.EnvVars({"TOOL_NAME": "from-env"})
    out.append(c.CommandParser(spec(), env).parse(["tool", "run", "x"])
               .option("name"))
    return out


def sc_buffered(pkg):
    b = S(pkg, "buffered")
    w = b.Writer()
    w.u8(7).u16_be(0x0102).u32_le(0x01020304).f32_be(1.5)
    w.i32_be(-2).u64_le(2 ** 63 + 5).i64_be(-(2 ** 40)).f64_be(0.25)
    w.write(b"hello\r\nrest:tail")
    data = b"".join(w.done())
    r = b.Reader()
    r.append(data[:3])
    r.append(data[3:8])
    r.append(data[8:])
    return [data, r.u8(), r.u16_be(), r.u32_le(), r.f32_be(), r.i32_be(),
            r.u64_le(), r.i64_be(), r.f64_be(), r.line(), r.peek_u8(0),
            r.read_until(ord(":")), r.size(), r.block(4), _outcome(r.u8)]


def sc_encode(pkg):
    e = S(pkg, "encode")
    data = bytes(range(256))
    return [[e.Base64.encode(s) for s in ("", "f", "fo", "foo", "foob",
                                          "fooba", "foobar")],
            e.Base64.encode_url(data), e.Base64.encode_pem(b"x" * 100),
            e.Base64.decode(e.Base64.encode_pem(b"y" * 70)),
            _outcome(e.Base64.decode, "a!b")]


def sc_format(pkg):
    f = S(pkg, "format")
    return [f.Format.int(255, f.FormatHex),
            f.Format.int(255, f.FormatHexSmall),
            f.Format.int(5, f.FormatBinary), f.Format.int(42, width=6),
            f.Format.int(42, width=6, fill="0"),
            f.Format.int(42, prefix=f.PrefixSign),
            f.Format.int(-42, f.FormatHex), f.Format.int(7, precision=3),
            f.Format.float(1234.5678, f.FormatFix, precision=2),
            f.Format.float(1234.5678, "exp", precision=1),
            f.Format("hi", width=6, align=f.AlignCenter, fill="."),
            f.Format("hi", width=5, align=f.AlignRight),
            f.Format("truncated", precision=4), f.Format(True)]


def sc_itertools(pkg):
    It = S(pkg, "itertools").Iter
    return [It(range(10)).filter(lambda x: x % 2 == 0).map(
                lambda x: x * x).collect(),
            It("abc").enum().collect(), It([1, 1, 2, 1]).unique().collect(),
            It([1, 1, 2, 1]).dedup().collect(),
            It(range(100)).skip(95).take(3).collect(),
            It([1, 2, 3]).fold(0, lambda a, b: a + b),
            It([[1], [2, 3]]).flat_map(lambda x: x).collect(),
            It.chain([[1], [], [2]]).collect(),
            It([1, 2]).zip("ab").collect(), It(range(5)).step_by(2).collect(),
            It([1, 2]).interleave([10, 20, 30]).collect(),
            It(range(5)).nth(2), It(It.repeat_value(7).take(3)).collect(),
            It([1, 2, 3]).last(), It([]).count(),
            _outcome(It([1]).find, lambda x: x > 5)]


def sc_ini(pkg):
    m = S(pkg, "ini").IniMap
    src = ["; comment", "top = 1", "[sec]", "a = hello ; trailing",
           "b: colon-delimited", "# another", "[empty]"]
    return [m.apply(src), _outcome(m.apply, ["[unclosed"]),
            _outcome(m.apply, ["keywithoutvalue"])]


def sc_strings_math(pkg):
    cp = S(pkg, "strings").CommonPrefix
    fib = S(pkg, "math").Fibonacci
    seq = fib()
    return [cp(["doable", "doing", "dock"]), cp(["a", "b"]), cp([]),
            cp([123, 124]), [fib.apply(i) for i in range(30)],
            [seq.next() for _ in range(12)], seq.has_next()]


def sc_capsicum(pkg):
    c = S(pkg, "capsicum")
    r = c.CapRights.from_caps({"read", "seek"})
    out = [r.contains(c.CapRights().set(c.Cap.read())),
           r.contains(c.CapRights().set(c.Cap.mmap())),
           r.contains(c.CapRights().set(c.Cap.write()))]
    r.set(c.Cap.write())
    other = c.CapRights().set(c.Cap.write())
    out.append(r.contains(other))
    r.remove(other)
    merged = c.CapRights().merge(r)
    out += [r.contains(other), merged.contains(r), r.limit(0),
            [getattr(c.Cap, n)() for n in ("read", "write", "seek", "mmap",
                                           "fstat", "ftruncate")]]
    return out


def sc_logger(pkg):
    L = S(pkg, "logger")
    out = io.StringIO()
    log = L.Logger(L.WARN, out=out)
    res = [log(L.INFO), log(L.ERROR), log.info("hidden"),
           log.warn("visible"), log.error("bad")]
    text = out.getvalue()
    return res + ["hidden" in text, "WARN" in text and "visible" in text,
                  text.count("\n")]


def sc_debug_assertion(pkg):
    D = S(pkg, "debug").Debug
    A = S(pkg, "assertion")
    old = os.environ.get("PONY_TPU_DEBUG")
    try:
        os.environ["PONY_TPU_DEBUG"] = "1"
        on = io.StringIO()
        D(["a", "b"], sep="/", stream=on)
        r1 = _outcome(A.Assert, False, "caught when debug on")
        os.environ["PONY_TPU_DEBUG"] = "0"
        off = io.StringIO()
        D("hidden", stream=off)
        r2 = _outcome(A.Assert, False, "ignored")
    finally:
        if old is None:
            os.environ.pop("PONY_TPU_DEBUG", None)
        else:
            os.environ["PONY_TPU_DEBUG"] = old
    return [on.getvalue(), off.getvalue(), r1[:2], r2,
            _outcome(A.Fact, True), _outcome(A.Fact, False, "nope")[:2]]


def sc_promises(pkg):
    P = S(pkg, "promises")
    seen = []
    p = P.Promise()
    p.next(lambda v: v * 2).next(seen.append)
    p.fulfil(21)
    p.fulfil(99)
    bad = P.Promise()
    caught = []
    bad.next(lambda v: v).next(seen.append, lambda r: caught.append(str(r)))
    bad.reject("boom")
    a, b = P.Promise(), P.Promise()
    joined = []
    P.join([a, b]).next(joined.append)
    first = []
    P.select([a, b]).next(first.append)
    b.fulfil("B")
    a.fulfil("A")
    return [seen, p.value(), caught, joined, first]


def sc_bureaucracy_registrar(pkg):
    B = S(pkg, "bureaucracy")
    reg = B.Registrar()
    got, rejected = [], []
    reg.update("db", "the-db")
    reg.apply("db").next(got.append)
    reg.apply("absent").next(got.append, lambda _r: rejected.append(1))
    reg.remove("db", "other")
    reg.apply("db").next(got.append)
    reg.remove("db", "the-db")
    reg.apply("db").next(got.append, lambda _r: rejected.append(2))
    closed = []

    class Thing:
        def __init__(self, n):
            self.n = n

        def dispose(self):
            closed.append(self.n)

    cust = B.Custodian()
    for i in range(3):
        cust.apply(Thing(i))
    cust.dispose()
    cust.dispose()
    return [got, rejected, sorted(closed)]


def sc_term(pkg):
    T = S(pkg, "term")

    class Log(T.ANSINotify):
        def __init__(self):
            self.events = []

        def apply(self, term, byte):
            self.events.append(("byte", byte))

        def up(self, ctrl=False, alt=False, shift=False):
            self.events.append(("up", ctrl, alt, shift))

        def left(self, ctrl=False, alt=False, shift=False):
            self.events.append(("left", ctrl, alt, shift))

        def home(self, ctrl=False, alt=False, shift=False):
            self.events.append(("home",))

        def fn_key(self, i, ctrl=False, alt=False, shift=False):
            self.events.append(("fn", i))

        def closed(self):
            self.events.append(("closed",))

    log = Log()
    term = T.ANSITerm(log, out=io.StringIO())
    log.events.clear()
    term.apply(b"a\x1b[A\x1b[1;5D\x1b[H\x1bOP\x1b[1")
    term.apply(b"5~z")
    term.dispose()

    class Lines(T.ReadlineNotify):
        def __init__(self):
            self.lines = []

        def apply(self, line, prompt):
            self.lines.append(line)
            prompt.fulfil("> ")

        def tab(self, line):
            return [c for c in ("help", "hello") if c.startswith(line)]

    notify = Lines()
    out = io.StringIO()
    rl = T.Readline(notify, out)
    t2 = T.ANSITerm(rl, out=out)
    t2.prompt("> ")
    t2.apply(b"hel\tx\x7f\r")
    t2.apply(b"abc\x1b[D\x1b[DZ\r")
    return [log.events, notify.lines, out.getvalue(),
            [T.ANSI.up(3), T.ANSI.cursor(2, 5), T.ANSI.clear(),
             T.ANSI.bold(), T.ANSI.reset(), T.ANSI.erase()]]


def sc_pkg(pkg):
    p = S(pkg, "pkg")
    out = []
    try:
        out.append(p.use("json").__name__.rsplit(".", 1)[-1])
        out.append(_outcome(p.use, "nonexistent")[:2])
        p.set_safe_packages(["files"])
        out += [p.use("files").__name__.rsplit(".", 1)[-1],
                _outcome(p.use, "net")[:2], _outcome(p.use, "process")[:2],
                p.safe_packages()]
        p.set_safe_packages([])
        out += [_outcome(p.use, "term")[:2], p.use("itertools") is not None]
        p.set_safe_packages(None)
        os.environ["PONY_TPU_SAFE"] = "net"
        out += [p.use("net") is not None, _outcome(p.use, "files")[:2]]
    finally:
        p.set_safe_packages(None)
        os.environ.pop("PONY_TPU_SAFE", None)
    return out + [sorted(p.FFI_PACKAGES)]


def sc_serialise(pkg):
    ser = S(pkg, "serialise")
    heap_mod = importlib.import_module(pkg.__name__ + ".hostmem")
    shared = [1, 2, 3]
    a = {"name": "a"}
    b = {"name": "b", "peer": a}
    a["peer"] = b
    loop = [1]
    loop.append(loop)
    obj = {"a": [1, 2.5, "three", b"\x00\xff", None, True], "b": (7, 8),
           "c": {"nested": {1: "one"}}, "big": 2 ** 80, "s": {3, 1, 2},
           "x": shared, "y": shared, "pair": a, "loop": loop}
    data = ser.Serialised(ser.SerialiseAuth(), obj).output(
        ser.OutputSerialisedAuth())
    back = ser.Serialised.from_bytes(data).apply(ser.DeserialiseAuth())
    h = heap_mod.HostHeap()
    hd = ser.serialise_to_handle(ser.SerialiseAuth(),
                                 {"p": shared, "q": shared}, h)
    hbytes = h.unbox(hd)
    return [data, back["x"] is back["y"],
            back["pair"]["peer"]["peer"] is back["pair"],
            back["loop"][1] is back["loop"], back["big"], back["s"],
            hbytes, _outcome(ser.Serialised.from_bytes, b"XXXX\x01")[:2],
            _outcome(ser.Serialised, object(), obj)[:2],
            _outcome(ser.Serialised(ser.SerialiseAuth(), 1).output,
                     object())[:2]]


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_collections, sc_persistent, sc_json, sc_cli, sc_buffered, sc_encode,
    sc_format, sc_itertools, sc_ini, sc_strings_math, sc_capsicum,
    sc_logger, sc_debug_assertion, sc_promises, sc_bureaucracy_registrar,
    sc_term, sc_pkg, sc_serialise)}


def _comparable(x):
    """Sets and dicts of mixed keys as sorted reprs; objects of either
    package by their class name and state."""
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(repr(v) for v in x))
    if isinstance(x, dict):
        return ("dict", sorted((repr(k), _comparable(v))
                               for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return [_comparable(v) for v in x]
    return x


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_module_equals_jax(name):
    fn = SCENARIOS[name]
    want, got = (_comparable(fn(pkg)) for pkg in PKGS)
    assert got == want


def test_every_stdlib_module_has_a_counterpart():
    ref = sorted(f for f in os.listdir(os.path.dirname(ponyc_tpu.__file__)
                                       + "/stdlib") if f.endswith(".py"))
    port = sorted(f for f in os.listdir(
        os.path.dirname(ponyc_tpu_torch.__file__) + "/stdlib")
        if f.endswith(".py"))
    assert port == ref
    for f in ref:
        importlib.import_module(f"ponyc_tpu_torch.stdlib.{f[:-3]}")


def test_unported_packages_name_what_brings_them():
    """Every package the JAX package's `use` resolves, the port resolves
    to its own module (ponybench since slice 13); an unknown name still
    raises ImportError naming the known ones."""
    p = S(ponyc_tpu_torch, "pkg")
    for name in ("ponybench", "benching"):
        assert p.use(name).__name__ == "ponyc_tpu_torch.benching"
    assert p.use("ponytest").__name__ == "ponyc_tpu_torch.testing"
    with pytest.raises(ImportError, match="known: .*ponybench"):
        p.use("no-such-package")


# ---- the modules that drive a runtime ---------------------------------

def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def _world_types(pkg):
    I32, Ref = pkg.I32, pkg.Ref

    @pkg.actor
    class Ticker:
        HOST = True
        ticks: I32

        @pkg.behaviour
        def tick(self, st, kind: I32, arg: I32, flags: I32):
            return {**st, "ticks": st["ticks"] + arg}

    @pkg.actor
    class Sink:
        total: I32
        BATCH = 4

        @pkg.behaviour
        def consume(self, st, v: I32):
            return {**st, "total": st["total"] + v}

    @pkg.actor
    class Producer:
        sink: Ref
        left: I32
        MAX_SENDS = 2

        @pkg.behaviour
        def produce(self, st, n: I32):
            self.send(st["sink"], Sink.consume, 1, when=n > 0)
            self.send(self.actor_id, Producer.produce, n - 1, when=n > 0)
            return {**st, "left": n - 1}

    done = {}

    @pkg.actor
    class Collect:
        HOST = True
        got: I32

        @pkg.behaviour
        def leaf(self, st, n: I32):
            total = st["got"] + n
            if total >= 3:
                done["promise"].fulfil(total)
            return {**st, "got": total}

    return Ticker, Sink, Producer, Collect, done


def _host_world(pkg):
    """Timers, backpressure, signals, the custodian and a promise
    fulfilled by a host actor, in one runtime of `pkg` (the port on the
    CPU). Returns what each step observed."""
    Ticker, Sink, Producer, Collect, done = _world_types(pkg)
    opts = pkg.RuntimeOptions(mailbox_cap=8, batch=2, msg_words=3,
                              max_sends=2, spill_cap=128, inject_slots=16,
                              tuning_cache="off")
    rt = (pkg.Runtime(opts, device="cpu") if pkg is ponyc_tpu_torch
          else pkg.Runtime(opts))
    rt.declare(Ticker, 3).declare(Producer, 1).declare(Sink, 1).declare(
        Collect, 1).start()
    out = {}
    # timers: a count-limited timer and a one-shot
    a, b = rt.spawn(Ticker), rt.spawn(Ticker)
    timers = S(pkg, "timers").Timers(rt)
    timers.timer(a, Ticker.tick, 0.01, count=3)
    timers.after(b, Ticker.tick, 0.03)
    t0 = time.time()
    rt.run(max_steps=20000)
    out["timers"] = [rt.state_of(a)["ticks"], rt.state_of(b)["ticks"],
                     time.time() - t0 >= 0.025, len(timers._live)]
    timers.dispose()
    # backpressure through its capability
    bp = S(pkg, "backpressure")
    sink = rt.spawn(Sink)
    prod = rt.spawn(Producer, sink=sink)
    out["bp_auth"] = [_outcome(bp.ApplyReleaseBackpressureAuth, object())[:2],
                      _outcome(bp.apply, object(), 0)[:2],
                      _outcome(type(rt.ambient_auth()), rt)[:2]]
    auth = bp.ApplyReleaseBackpressureAuth(rt.ambient_auth())
    bp.apply(auth, sink)
    rt.send(prod, Producer.produce, 24)
    rt.run(max_steps=6)
    pressured = [bool(_host(rt.state.muted)[prod]),
                 int(rt.state_of(sink)["total"])]
    bp.release(auth, sink)
    rt.run()
    out["backpressure"] = pressured + [int(rt.state_of(sink)["total"]),
                                       bool(_host(rt.state.muted)[prod])]
    # signals: a raised SIGUSR1 reaches the handler's actor
    sig = S(pkg, "signals")
    w = rt.spawn(Ticker)
    prev = _os_signal.signal(_os_signal.SIGUSR1, _os_signal.SIG_IGN)
    h = sig.SignalHandler(rt, w, Ticker.tick, sig.Sig.usr1())
    h.raise_()
    deadline = time.time() + 5.0
    while time.time() < deadline and rt.state_of(w)["ticks"] < 1:
        rt.run(max_steps=50)
        time.sleep(0.01)
    h.dispose()
    _os_signal.signal(_os_signal.SIGUSR1, prev)
    out["signals"] = [rt.state_of(w)["ticks"] >= 1, sig.Sig.usr1(),
                      sig.Sig.term(), sig.Sig.int_()]
    # the custodian disposes an actor with a message
    cust = S(pkg, "bureaucracy").Custodian()
    cust.apply_actor(rt, prod, Producer.produce, 2)
    cust.dispose()
    rt.run()
    out["custodian"] = int(rt.state_of(sink)["total"])
    # a promise fulfilled by a host actor, waited on through the runtime
    done["promise"] = S(pkg, "promises").Promise()
    done["promise"].rt = rt
    col = rt.spawn(Collect)
    for _ in range(3):
        rt.send(col, Collect.leaf, 1)
    out["promise"] = done["promise"].value(timeout=30)
    rt.stop()
    return out


@pytest.fixture(scope="module")
def host_worlds():
    return [_host_world(pkg) for pkg in PKGS]


@pytest.mark.parametrize("part", ["timers", "bp_auth", "backpressure",
                                  "signals", "custodian", "promise"])
def test_runtime_modules_equal_jax(host_worlds, part):
    want, got = (w[part] for w in host_worlds)
    assert got == want


# ---- the host-services world and the spreader's promise ---------------

PATHS = {"plain": {}, "fused": dict(pallas_fused=True),
         "mega": dict(delivery="pallas_mega")}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_heartbeat_and_child_process(path):
    """examples/heartbeat.py's Heart beaten 5 times by a stdlib timer
    (exit 0), after a child's stdout and exit code reached a host actor
    through attach_processes(), on each path (the modules' parity with
    the JAX package is held above and in test_torch_process_files.py)."""
    from _torch_programs import define_stdlib, stdlib_world
    rt, out = stdlib_world(ponyc_tpu_torch, define_stdlib(ponyc_tpu_torch),
                           **PATHS[path])
    rt.stop()
    assert out == {"proc": {"n_out": 14, "n_err": 0, "code": 3, "done": 1,
                            "stdout": b"child-says-hi\n"},
                   "proc_run_code": 0, "code": 0, "beats": 5,
                   "live_timers": 0}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spreader_waits_on_its_promise(path):
    """examples/spreader.py's program: the host collector fulfils a
    stdlib Promise at the last leaf, and the host waits on it (the
    promise drives the runtime while it waits)."""
    import _torch_programs as tp
    T = tp.define(ponyc_tpu_torch)
    depth = 4
    rt = tp.new_runtime(ponyc_tpu_torch, dict(
        mailbox_cap=8, batch=2, max_sends=5, msg_words=2, spill_cap=256,
        inject_slots=8, **PATHS[path]))
    rt.declare(T.Spread, 4 << depth).declare(T.Collect, 1).start()
    done = S(ponyc_tpu_torch, "promises").Promise(rt)
    T.spread_done["promise"] = (done, 1 << depth)
    col = rt.spawn(T.Collect, got=0)
    root = rt.spawn(T.Spread, col=int(col))
    rt.send(root, T.Spread.go, depth)
    assert done.value(timeout=120) == 1 << depth
    assert rt.run() == 0
    assert rt.state_of(col)["got"] == 1 << depth
    assert rt.counter("n_spawned") == (2 << depth) - 2

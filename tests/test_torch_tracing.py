"""Causal tracing in the PyTorch port against the JAX package: the cases
of tests/test_tracing.py on the plan delivery, and its chain under
cosort. The same program and seeds
run in both packages (the port on the CPU: its plain path, and the fused
kernel's plain version where named), and the recorded spans (trace id,
span id, parent, behaviour, actor, enqueue, dispatch and retire ticks),
the reassembled trees, the span ring's drop count, ticks, counters and
fields must be equal: all integers, exact. Each JAX world runs once per
module."""

import json
import os

import numpy as np
import pytest

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu import tracing as jtracing
from ponyc_tpu.models import ring as jring
from ponyc_tpu_torch import analysis as tanalysis
from ponyc_tpu_torch import tracing as ttracing
from ponyc_tpu_torch.models import ring as tring
from ponyc_tpu_torch.runtime import engine as tengine

from _torch_programs import define_telemetry, new_runtime, telemetry_of

JT, TT = define_telemetry(ponyc_tpu), define_telemetry(ponyc_tpu_torch)
RINGS = {ponyc_tpu: jring, ponyc_tpu_torch: tring}
BASE = dict(mailbox_cap=8, batch=1, max_sends=1, msg_words=1, spill_cap=64,
            inject_slots=8, analysis=3, trace_sample=1)


def _chain(pkg, T, path, **kw):
    rt = new_runtime(pkg, dict(BASE, analysis_path=path, **kw))
    rt.declare(T.Src, 2).declare(T.Mid, 2).declare(T.Sink, 2).start()
    sinks = rt.spawn_many(T.Sink, 2)
    mids = rt.spawn_many(T.Mid, 2, out=sinks)
    srcs = rt.spawn_many(T.Src, 2, out=mids)
    return rt, srcs, sinks


def _ring(pkg, n, path, **kw):
    rmod = RINGS[pkg]
    rt = new_runtime(pkg, dict(BASE, analysis_path=path, **kw))
    rt.declare(rmod.RingNode, n).start()
    ids = rt.spawn_many(rmod.RingNode, n)
    rt.set_fields(rmod.RingNode, ids, next_ref=np.roll(ids, -1))
    return rt, ids


def _world(kind, pkg, T, path, **kw):
    """One traced world run to its end and stopped, its analysis files
    at `path`: (telemetry, fields)."""
    if kind == "chain":
        rt, srcs, sinks = _chain(pkg, T, path, **kw)
        rt.send(int(srcs[0]), T.Src.go, 7)
        rt.run(max_steps=200)
        fields = rt.state_of(int(sinks[0]))
    elif kind == "fanout":
        rt = new_runtime(pkg, dict(BASE, max_sends=2, analysis_path=path,
                                   **kw))
        rt.declare(T.Fan, 1).declare(T.Sink, 2).start()
        sinks = rt.spawn_many(T.Sink, 2)
        fan = rt.spawn(T.Fan, a=int(sinks[0]), b=int(sinks[1]))
        rt.send(fan, T.Fan.go, 3)
        rt.run(max_steps=100)
        fields = [rt.state_of(int(s)) for s in sinks]
    elif kind == "host":
        rt = new_runtime(pkg, dict(BASE, msg_words=2, analysis_path=path,
                                   **kw))
        rt.declare(T.HostRelay, 1).declare(T.Sink, 1).start()
        sink = rt.spawn(T.Sink)
        hr = rt.spawn(T.HostRelay, out=sink)
        rt.send(hr, T.HostRelay.relay, 5)
        rt.run(max_steps=200)
        fields = rt.state_of(sink)
    elif kind == "explicit":
        rt, srcs, sinks = _chain(pkg, T, path, trace_sample=1000000,
                                 inject_slots=16, **kw)
        rt.send(int(srcs[0]), T.Src.go, 1, trace=77)
        rt.run(max_steps=200)
        rt.bulk_send(srcs, T.Src.go, [2, 2], trace=88)
        rt.run(max_steps=200)
        fields = [rt.state_of(int(s)) for s in sinks]
    elif kind == "overflow":
        rt, ids = _ring(pkg, 8, path, trace_slots=4, quiesce_interval=64,
                        pipeline=False, **kw)
        rt.send(int(ids[0]), RINGS[pkg].RingNode.token, 40)
        rt.run(max_steps=200)
        fields = rt.cohort_state(RINGS[pkg].RingNode)["passes"].tolist()
    else:                                     # sampled, three tokens
        rt, ids = _ring(pkg, 16, path, trace_sample=4, trace_seed=3,
                        inject_slots=16, **kw)
        for i in (0, 5, 11):
            rt.send(int(ids[i]), RINGS[pkg].RingNode.token, 20)
        rt.run(max_steps=500)
        fields = rt.cohort_state(RINGS[pkg].RingNode)["passes"].tolist()
    out = telemetry_of(rt), fields
    rt.stop()
    return out


KINDS = ("chain", "fanout", "host", "explicit", "overflow", "sampled")
PATHS = {"plain": {}, "fused": {"pallas_fused": True}}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_tracing")
    return {k: _world(k, ponyc_tpu, JT, str(d / f"{k}.csv"))
            for k in KINDS}


@pytest.fixture(scope="module")
def torch_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tracing")
    return {(k, p): _world(k, ponyc_tpu_torch, TT, str(d / f"{k}-{p}.csv"),
                           **kw)
            for k in KINDS for p, kw in PATHS.items()}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", KINDS)
def test_spans_equal_jax(jax_runs, torch_runs, kind, path):
    """Every span, tree, drop count, tick, counter and field equals the
    JAX package's; the fused path's outbox carries the trace words in
    the same rows-minor [batch, ms, rows] order as the plain path's."""
    assert torch_runs[(kind, path)] == jax_runs[kind]


@pytest.mark.parametrize("path", PATHS)
def test_chain_under_cosort_equals_jax(path, tmp_path):
    """tests/test_tracing.py's three-deep chain under delivery="cosort":
    the trace words travel with the payload through the sorted order;
    spans, trees, ticks, counters and fields equal the JAX package's
    cosort run, and its tree is the plan run's."""
    got = _world("chain", ponyc_tpu_torch, TT, str(tmp_path / "t.csv"),
                 delivery="cosort", **PATHS[path])
    want = _world("chain", ponyc_tpu, JT, str(tmp_path / "j.csv"),
                  delivery="cosort")
    assert got == want
    tree = next(iter(ttracing.reassemble(got[0]["spans"]).values()))
    assert tree["critical_path"] == ["inject", "Src.go", "Mid.relay",
                                     "Sink.take"]


def _trees(torch_runs, kind):
    tel = torch_runs[(kind, "plain")][0]
    return tel, ttracing.reassemble(tel["spans"])


def test_chain_fanout_and_host_trees(torch_runs):
    tel, trees = _trees(torch_runs, "chain")
    (t,) = trees.values()
    assert t["n_spans"] == 4 and ttracing.consistent(t)
    assert t["critical_path"] == ["inject", "Src.go", "Mid.relay",
                                  "Sink.take"]
    assert torch_runs[("chain", "plain")][1] == {"n": 7}
    _, trees = _trees(torch_runs, "fanout")
    (t,) = trees.values()
    fan = t["roots"][0].children[0]
    assert fan.beh == "Fan.go" and t["n_spans"] == 4
    assert sorted(c.beh for c in fan.children) == ["Sink.take"] * 2
    _, trees = _trees(torch_runs, "host")
    (t,) = trees.values()
    assert t["critical_path"] == ["inject", "HostRelay.relay", "Sink.take"]
    h = t["roots"][0].children[0]
    assert h.span_id % 2 == 1 and h.children[0].span_id % 2 == 0
    assert ttracing.consistent(t)


def test_explicit_ids_overflow_and_sampling(torch_runs):
    _, trees = _trees(torch_runs, "explicit")
    assert set(trees) == {77, 88} and trees[88]["n_spans"] == 7
    tel, trees = _trees(torch_runs, "overflow")
    (t,) = trees.values()
    assert tel["span_dropped"] > 0 and ttracing.consistent(t)
    assert t["n_spans"] < 41
    tel, _ = torch_runs[("sampled", "plain")]
    assert 1 <= len(tel["traces"]) < 3


def test_sampler_equals_jax():
    for seed in (7, 8):
        a, b = ttracing.Tracer(64, seed=seed), jtracing.Tracer(64,
                                                                seed=seed)
        assert [a.sample() for _ in range(2048)] \
            == [b.sample() for _ in range(2048)]


def test_differential_traced_vs_untraced(tmp_path):
    """Tracing changes nothing else: fields, counters and ticks equal an
    untraced run's."""
    def run_once(sample):
        rt, ids = _ring(ponyc_tpu_torch, 16, str(tmp_path / f"{sample}.csv"),
                        trace_sample=sample, inject_slots=16)
        for i in (0, 5, 11):
            rt.send(int(ids[i]), tring.RingNode.token, 20)
        code = rt.run(max_steps=500)
        rt.stop()
        return (code, rt.cohort_state(tring.RingNode)["passes"].tolist(),
                rt.counter("n_processed"), rt.counter("n_delivered"))
    assert run_once(0) == run_once(1)


def test_off_state_and_trap(monkeypatch, tmp_path):
    """With tracing off (analysis < 3, or trace_sample 0) the state has
    no trace lanes, traces() raises, and the step never calls
    trace_span_lanes (trapped); with it on, the step does."""
    def boom(*_a, **_k):
        raise AssertionError("trace lanes called while tracing is off")
    monkeypatch.setattr(tengine, "trace_span_lanes", boom)
    path = str(tmp_path / "an.csv")
    for kw in (dict(trace_sample=0), dict(analysis=2, trace_sample=8)):
        rt, ids = _ring(ponyc_tpu_torch, 8, path, **kw)
        rt.send(int(ids[0]), tring.RingNode.token, 5)
        assert rt.run() == 0
        rt.stop()
        assert rt.state.trace_buf == {} and rt.state.span_data.numel() == 0
        assert rt._tracer is None
        with pytest.raises(RuntimeError, match="tracing"):
            rt.traces()
    rt, ids = _ring(ponyc_tpu_torch, 8, path)
    rt.send(int(ids[0]), tring.RingNode.token, 5)
    with pytest.raises(AssertionError, match="trace lanes called"):
        rt.run()
    rt.stop()


def test_spans_jsonl_and_perfetto(tmp_path):
    path = str(tmp_path / "an.csv")
    rt, srcs, _ = _chain(ponyc_tpu_torch, TT, path)
    rt.send(int(srcs[0]), TT.Src.go, 2)
    rt.run(max_steps=200)
    rt.stop()
    recs = ttracing.load_spans(path + ".spans.jsonl")
    assert len(recs) == 4
    out = tanalysis.chrome_trace(path, str(tmp_path / "t.json"))
    evs = json.load(open(out))["traceEvents"]
    assert {e["name"] for e in evs if e["ph"] == "X"} \
        == {"inject", "Src.go", "Mid.relay", "Sink.take"}
    assert len([e for e in evs if e["ph"] == "s"]) == 3
    assert "traces: 1" in tanalysis.top_frame(path)
    assert os.path.exists(path + ".events.csv")

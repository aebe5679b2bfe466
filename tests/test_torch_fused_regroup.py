"""The fused kernel's regroup (ponyc_tpu_torch/csrc/fused_dispatch.cu,
"The regroup"): each tile of lanes ordered by message id before the
bodies run, with a lane's state and results carried across the batch in
the tile's stage.

The kernel's source is built for the host CPU (`FusedDispatch.run_host`),
which runs each tile's threads phase by phase in the order the kernel
uses (a tile whose messages name one behaviour in place, as the kernel
runs it), and is held against the plain version (`engine._plain_dispatch`)
on seeded inputs: the mixed model's 8 behaviours at widths that are not
a multiple of the tile, on id layouts that stress the sort; batches
that yield and exit part way (the exit key of the lowest lane); errors
and destroys; spawning cohorts (the `used` counter and the claims).
Then whole worlds run with the fused dispatch on that build, regrouped,
against the JAX package (one definition serves both, tests/
_torch_programs.py).

Tolerance: the regroup changes no bit. The regrouped build equals the
same cohort's build with one thread a lane on every output, floats as
their bits, and the plain version on every integer output; mixed's
floats (additions, products, reciprocals) equal the plain version's bit
for bit too. (The corpus's other float bodies differ from torch's CPU
kernels by a few ulp in either build, tests/test_torch_lanecode.py.)
Skips where there is no host C++ compiler.
"""

import copy

import numpy as np
import pytest
import torch

import ponyc_tpu
import ponyc_tpu_torch
from ponyc_tpu_torch import RuntimeOptions
from ponyc_tpu_torch.models import mixed, ubench
from ponyc_tpu_torch.ops import _build
from ponyc_tpu_torch.ops import fused_dispatch as fdm
from ponyc_tpu_torch.program import Program
from ponyc_tpu_torch.runtime.engine import spawn_meta_of

from _torch_programs import build_mixers, counters, define

JT, TT = define(ponyc_tpu), define(ponyc_tpu_torch)
MIXED = mixed.make_worker_type(8, work=2)
# Corpus cohorts that yield, exit, raise errors and destroy.
EFFECTS = ("Mixer", "Yielder", "Exiter")


@pytest.fixture(autouse=True)
def _need_cxx():
    if _build.host_cxx() is None:
        pytest.skip("no host C++ compiler to build the kernel's source")


def _fused(types, okw, rows, regroup=None):
    opts = RuntimeOptions(tuning_cache="off", pallas_fused=True, **okw)
    prog = Program(opts)
    for t in types:
        prog.declare(t, rows)
    prog.finalize()
    return [fdm.build_fused_dispatch(prog.by_type[t], opts,
                                     spawn_meta_of(prog, prog.by_type[t]),
                                     regroup=regroup) for t in types]


def _leaves(x, name="out"):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{name}.{k}")
    elif isinstance(x, tuple):
        names = getattr(x, "_fields", None) or range(len(x))
        for k, v in zip(names, x):
            yield from _leaves(v, f"{name}.{k}")
    else:
        yield name, x


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _host_equals_plain(fd, inputs, where, floats=False):
    """The regrouped host build against the one-thread-a-lane host build
    (every output bit for bit) and the plain version (integer outputs;
    float outputs too where `floats`); returns the plain outputs."""
    assert fd.regroup, where
    lane = copy.copy(fd)              # the same cohort, one thread a lane
    lane.regroup = False
    got, base = fd.run_host(*inputs), lane.run_host(*inputs)
    want = fd.plain(*inputs)
    for (name, x), (_, b), (_, y) in zip(_leaves(got), _leaves(base),
                                         _leaves(want)):
        if y is None:
            assert x is None and b is None, (where, name)
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (where, name)
        assert torch.equal(_bits(x), _bits(b)), (where, name)
        if floats or x.dtype != torch.float32:
            assert torch.equal(_bits(x), _bits(y)), (where, name)
    return want


def test_regroup_rule():
    """The rule regroups a cohort whose bodies a warp holding every id
    would run REGROUP_OPS ops beyond the costliest (mixed at 64 rounds a
    body); not one behaviour, nor cheap bodies (mixed at 8 rounds, the
    spawn tree's Node, the corpus Mixer)."""
    mk = mixed.make_worker_type
    mopts = dict(mailbox_cap=4, batch=1, max_sends=1, msg_words=1)
    fd = _fused([mk(8, work=64)], mopts, 64)[0]
    assert fd.regroup and "#define PONY_REGROUP 1" in fd.source("host")
    assert not _fused([mk(8, work=8)], mopts, 64)[0].regroup
    assert not _fused([ubench.Pinger], dict(mopts, batch=4), 64)[0].regroup
    assert not _fused([TT.Node], dict(mailbox_cap=8, batch=4, max_sends=3,
                                      msg_words=2), 64)[0].regroup
    fd = _fused([TT.Mixer], dict(mailbox_cap=8, batch=3, max_sends=2,
                                 msg_words=2), 64)[0]
    assert not fd.regroup and "#define PONY_REGROUP 0" in fd.source("host")


@pytest.mark.parametrize("pattern", (None,) + fdm.ID_PATTERNS)
@pytest.mark.parametrize("rows", [1, 257, 1000, fdm.TILE + 904])
def test_mixed_regrouped_equals_plain(rows, pattern):
    """Mixed's 8 behaviours (2 rounds a body, batch 2: state carried from
    the first slot to the second) at widths that are not a multiple of
    the tile, the last on two tiles; ids random (some out of range, some
    lanes idle) or laid out by `id_pattern` ("same" runs every tile in
    place; "odd_one" on two tiles regroups the first and runs the second
    in place)."""
    (fd,) = _fused([MIXED], dict(mailbox_cap=4, batch=2, max_sends=1,
                                 msg_words=1), rows, regroup=True)
    _host_equals_plain(fd, fd.sample_inputs(rows % 7, pattern=pattern),
                       f"rows {rows} ids {pattern}", floats=True)


@pytest.mark.parametrize("rows", [257, fdm.TILE + 4])
def test_batches_with_yield_exit_error_destroy(rows):
    """Corpus cohorts regrouped at batch 4 (the Mixer at 3): yields stop
    a lane's batch part way, exits keep the first code of the lowest
    exiting lane, errors the latest, destroys OR."""
    types = [getattr(TT, n) for n in EFFECTS]
    fds = _fused(types, dict(mailbox_cap=8, batch=4, max_sends=2,
                             msg_words=2), rows, regroup=True)
    exits = 0
    for fd in fds:
        for seed in range(2):
            want = _host_equals_plain(fd, fd.sample_inputs(seed),
                                      f"{fd.name} rows {rows} seed {seed}")
            exits += bool(want[3])
    assert exits >= 2                  # Exiter and Mixer exit somewhere


def test_exit_is_the_first_code_of_the_lowest_exiting_lane():
    """The Mixer (poke exits with its first argument when the second is
    45) at a full batch of 3, both behaviours in every tile: lanes 5 and
    TILE + 3 exit at two and three slots, no other lane exits. The exit
    code is lane 5's first."""
    (fd,) = _fused([TT.Mixer], dict(mailbox_cap=8, batch=4, max_sends=2,
                                    msg_words=2), fdm.TILE + 10,
                   regroup=True)
    fields, buf, head, n_run, ids, resv = fd.sample_inputs(6, steady=True)
    buf[:, 2, :] = 0                               # poke(a, 0): no exit
    add, poke = TT.Mixer.add.global_id, TT.Mixer.poke.global_id
    for lane, msgs in ((5, ((add, 1, 0), (poke, 11, 45), (poke, 12, 45))),
                       (fdm.TILE + 3, ((poke, 4, 45), (poke, 5, 45),
                                       (poke, 6, 45)))):
        for k, msg in enumerate(msgs):
            buf[(int(head[lane]) + k) % fd.cap, :, lane] = torch.tensor(msg)
    want = _host_equals_plain(fd, (fields, buf, head, n_run, ids, resv),
                              "Mixer")
    assert bool(want[3]) and int(want[4]) == 11


@pytest.mark.parametrize("names,okw", [
    (("Node",), dict(mailbox_cap=8, batch=4, max_sends=3, msg_words=2)),
    (("Boss", "Worker"), dict(mailbox_cap=8, batch=2, max_sends=2,
                              msg_words=2)),
    (("Spawner", "SpawnChild"), dict(mailbox_cap=8, batch=2, max_sends=1,
                                     msg_words=2))],
    ids=["tree", "boss", "spawner"])
def test_spawning_cohort_regrouped_equals_plain(names, okw):
    """Spawn planes through the regroup: each lane's `used` counter walks
    its reservations across the batch, claims land at (k, site, lane),
    and the sticky spawn fail rises (about one reservation in five is
    -1)."""
    fd = _fused([getattr(TT, n) for n in names], okw, fdm.TILE + 300,
                regroup=True)[0]
    want = _host_equals_plain(fd, fd.sample_inputs(4), fd.name)
    claims = torch.cat(want[9])
    assert (claims >= 0).any() and (claims < 0).any()


@pytest.fixture
def regrouped_host_build(monkeypatch):
    """Every fused dispatch regrouped and run by the kernel's host
    build; yields the names of the cohorts it ran."""
    libs = {}

    def host(self, *args):
        if self.name not in libs:
            libs[self.name] = self.bind(
                _build.build([self.job(host=True)])[0])
        return self._launch(libs[self.name], *args, host=True)

    monkeypatch.setattr(fdm, "regroup_rule", lambda *a, **k: True)
    monkeypatch.setattr(fdm.FusedDispatch, "__call__", host)
    yield libs


def test_regrouped_world_matches_jax(regrouped_host_build):
    """The Mixer world (every effect plane, batch 3) whose fused dispatch
    is the regrouped host build, against the JAX package: the exit code,
    ticks, counters, fields and last errors."""
    res = []
    for pkg, T, kw in ((ponyc_tpu, JT, {}),
                       (ponyc_tpu_torch, TT, dict(pallas_fused=True))):
        rt = build_mixers(pkg, T, 5, **kw)
        code = rt.run(max_steps=100_000)
        res.append((code, rt.steps_run, counters(rt),
                    {f: np.asarray(v).tolist() for f, v in
                     rt.cohort_state(T.Mixer).items()},
                    np.asarray(rt.state.last_error).tolist()))
    assert res[1] == res[0]
    assert list(regrouped_host_build) == ["Mixer"]

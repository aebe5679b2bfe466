"""Mixed-behaviour ubench on the PyTorch port — the same program as
``ponyc_tpu/models/mixed.py``: the dispatch-heterogeneity stressor.

≙ the reference's mixed workload benchmark (`examples/mixed/main.pony`)
reduced to the variable that matters for a planar dispatch: BEHAVIOUR
COUNT per type. The reference's generated dispatch switch costs one
indirect jump whatever the number of behaviours (genfun.c); the plain
dispatch evaluates every behaviour of a cohort per batch slot, so a
B-behaviour type pays ~B×, while the fused kernel (`pallas_fused`) runs
only the behaviour each message names.

One cohort of N workers; behaviour k bumps a counter and forwards to the
next worker's behaviour (k+1) % B, so sustained traffic exercises every
behaviour every tick (all-hot). `hot=1` keeps traffic on behaviour 0.
`work` > 0 adds that many dependent non-affine float rounds to each body.
"""

from __future__ import annotations

import numpy as np

from .. import F32, I32, Ref, Runtime, RuntimeOptions
from ..api import ActorTypeMeta, BehaviourDef


def make_worker_type(n_behaviours: int, hot: int | None = None,
                     work: int = 0):
    """A Worker actor type with behaviours step0..step{B-1}; each
    forwards to the target's next behaviour (always step0 when hot=1).
    `work` > 0 adds that many dependent rounds of
    acc = acc + 1/(acc*acc + 2 + k) to behaviour k."""
    ns = {"__annotations__": {"next_ref": Ref, "done": I32, "acc": F32},
          "MAX_SENDS": 1}
    defs = {}                    # name → BehaviourDef (closed over below)

    def mk(k: int):
        nxt = k + 1 if k + 1 < n_behaviours else 0
        if hot == 1:
            nxt = 0

        def step(self, st, n: I32):
            self.send(st["next_ref"], defs[f"step{nxt}"], n - 1,
                      when=n > 0)
            acc = st["acc"]
            # Dependent non-affine chain, distinct per behaviour (the
            # k-term), so no two bodies are the same expression.
            for _ in range(work):
                acc = acc + 1.0 / (acc * acc + 2.0 + k)
            return {**st, "done": st["done"] + 1, "acc": acc}

        step.__name__ = f"step{k}"
        return BehaviourDef(step)

    for k in range(n_behaviours):
        ns[f"step{k}"] = mk(k)
    cls = ActorTypeMeta(
        f"Worker{n_behaviours}" + ("H" if hot == 1 else ""), (), ns)
    for k in range(n_behaviours):
        defs[f"step{k}"] = getattr(cls, f"step{k}")
    return cls


def build(n_workers: int, n_behaviours: int,
          opts: RuntimeOptions | None = None, pings: int = 1,
          hot: int | None = None, seed: int = 0, work: int = 0,
          device=None):
    """`device` as for Runtime (None = the CUDA device)."""
    opts = opts or RuntimeOptions(mailbox_cap=max(4, pings), batch=pings,
                                  max_sends=1, msg_words=1)
    wt = make_worker_type(n_behaviours, hot=hot, work=work)
    rt = Runtime(opts, device=device)
    rt.declare(wt, n_workers)
    rt.start()
    ids = rt.spawn_many(wt, n_workers)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_workers)
    nxt = np.empty(n_workers, np.int64)
    nxt[order] = ids[np.roll(order, -1)]
    rt.set_fields(wt, ids, next_ref=nxt)
    return rt, ids, wt


def seed_all(rt: Runtime, ids, wt, hops: int, pings: int = 1,
             mix: bool = False):
    """Default seeding puts every token on step0 (each tick all lanes
    carry one behaviour id); mix=True spreads lanes across all B
    behaviours, so every tick carries every id."""
    steps = [getattr(wt, f"step{k}")
             for k in range(len(wt.behaviour_defs))]
    for _ in range(pings):
        if not mix:
            rt.bulk_send(ids, wt.step0, np.full(len(ids), hops, np.int64))
            continue
        ids_a = np.asarray(ids)
        for k, bd in enumerate(steps):
            sel = ids_a[k::len(steps)]
            if len(sel):
                rt.bulk_send(sel, bd, np.full(len(sel), hops, np.int64))

"""fan-in on the PyTorch port — the same program as
``ponyc_tpu/models/fanin.py`` (the reference benchmark
`examples/fan-in/main.pony`):
many producer actors hammer one aggregator to exercise the
overload → mute → unmute backpressure chain (actor.c:369-381, 1103-1235).

Each producer self-drives: on `produce(n)` it sends one item to the
aggregator and one `produce(n-1)` to itself. With an aggregator batch of 1
and many producers, the aggregator's mailbox saturates immediately; the
engine must (a) reject the overflow into spill, (b) mute the producers,
(c) unmute them as the aggregator drains, and (d) deliver *every* item
exactly once — the conservation property the reference checks by watching
its analytics mute counters.
"""

from __future__ import annotations

from .. import I32, Ref, Runtime, RuntimeOptions, actor, behaviour


@actor
class Producer:
    out: Ref
    sent: I32

    MAX_SENDS = 2

    @behaviour
    def produce(self, st, n: I32):
        self.send(st["out"], Aggregator.consume, 1, when=n > 0)
        self.send(self.actor_id, Producer.produce, n - 1, when=n > 0)
        return {**st, "sent": st["sent"] + (n > 0)}


@actor
class Aggregator:
    total: I32

    BATCH = 1      # deliberately slow consumer (≙ the fan-in example's
    #                single aggregator swamped by producers)

    @behaviour
    def consume(self, st, v: I32):
        return {**st, "total": st["total"] + v}


def build(n_producers: int = 32, items_each: int = 64,
          opts: RuntimeOptions | None = None, device=None) -> Runtime:
    """The started world with every producer's `produce(items_each)`
    queued, ready to run. `device` as for Runtime (None = the CUDA
    device)."""
    opts = opts or RuntimeOptions(mailbox_cap=8, batch=2, msg_words=1,
                                  spill_cap=256)
    rt = Runtime(opts, device=device)
    rt.declare(Producer, n_producers).declare(Aggregator, 1)
    rt.start()
    agg = rt.spawn(Aggregator)
    ids = rt.spawn_many(Producer, n_producers, out=agg)
    rt.bulk_send(ids, Producer.produce,
                 [items_each] * n_producers)
    return rt


def run(n_producers: int = 32, items_each: int = 64,
        opts: RuntimeOptions | None = None, device=None) -> Runtime:
    rt = build(n_producers, items_each, opts, device)
    rt.run(max_steps=items_each * n_producers * 4 + 100)
    return rt

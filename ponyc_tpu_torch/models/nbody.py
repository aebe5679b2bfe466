"""n-body on the PyTorch port — the same program as
``ponyc_tpu/models/nbody.py`` (the reference benchmark `examples/n-body/`:
gravity between bodies, the float-heavy behaviour workload).

A systolic ring of body actors: each body launches a token carrying its
position (one `VecF32[2]` argument) and mass (`F32`); tokens hop the
ring, and every body a token visits adds that body's pull to its own
acceleration. After n-1 hops every token has visited every other body:
one all-pairs round costs n-1 ticks.
"""

from __future__ import annotations

import numpy as np

from .. import F32, I32, Ref, Runtime, RuntimeOptions, VecF32, actor, \
    behaviour

G = 6.674e-3          # scaled constant (unit system is arbitrary here)
SOFTEN = 1e-2


@actor
class Body:
    next_ref: Ref["Body"]
    x: F32
    y: F32
    m: F32
    ax: F32
    ay: F32
    seen: I32

    MAX_SENDS = 1
    BATCH = 4

    @behaviour
    def token(self, st, hops: I32, pos: VecF32[2], pm: F32):
        # pos is a [2, lanes] block; component reads index axis 0.
        dx = pos[0] - st["x"]
        dy = pos[1] - st["y"]
        r2 = dx * dx + dy * dy + SOFTEN
        inv_r = 1.0 / (r2 ** 0.5)
        f = G * pm * inv_r * inv_r * inv_r
        self.send(st["next_ref"], Body.token, hops - 1, pos, pm,
                  when=hops > 1)
        return {**st,
                "ax": st["ax"] + f * dx,
                "ay": st["ay"] + f * dy,
                "seen": st["seen"] + 1}


def build(n_bodies: int = 256, opts: RuntimeOptions | None = None,
          seed: int = 3, device=None):
    """`device` as for Runtime (None = the CUDA device)."""
    opts = opts or RuntimeOptions(mailbox_cap=16, batch=4, max_sends=1,
                                  msg_words=4, spill_cap=1024)
    rt = Runtime(opts, device=device)
    rt.declare(Body, n_bodies)
    rt.start()
    rng = np.random.default_rng(seed)
    ids = rt.spawn_many(
        Body, n_bodies,
        x=rng.uniform(-1, 1, n_bodies).astype(np.float32),
        y=rng.uniform(-1, 1, n_bodies).astype(np.float32),
        m=rng.uniform(0.5, 2.0, n_bodies).astype(np.float32))
    rt.set_fields(Body, ids, next_ref=np.roll(ids, -1))
    return rt, ids


def run_round(n_bodies: int = 256, opts: RuntimeOptions | None = None,
              device=None) -> Runtime:
    """One full all-pairs interaction round (every token hops n-1
    times)."""
    rt, ids = build(n_bodies, opts, device=device)
    st = rt.cohort_state(Body)
    # Each body's token starts at its ring successor.
    nxt = np.roll(ids, -1)
    rt.bulk_send(nxt, Body.token,
                 np.full(n_bodies, n_bodies - 1),
                 np.stack([st["x"], st["y"]], axis=1),   # [count, 2] vec col
                 st["m"])
    rt.run(max_steps=4 * n_bodies + 100)
    return rt


def reference_accels(xs, ys, ms):
    """NumPy all-pairs oracle for verification."""
    dx = xs[None, :] - xs[:, None]
    dy = ys[None, :] - ys[:, None]
    r2 = dx * dx + dy * dy + SOFTEN
    inv_r3 = 1.0 / np.sqrt(r2) ** 3
    np.fill_diagonal(inv_r3, 0.0)
    f = G * ms[None, :] * inv_r3
    return (f * dx).sum(1), (f * dy).sum(1)

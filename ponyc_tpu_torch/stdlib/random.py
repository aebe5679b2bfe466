"""Randomness for behaviours — ≙ packages/random.

The reference ships splittable xoroshiro/xorshift generators whose state
lives in each actor's fields. Here, as in the JAX package, a behaviour
draws by *counter-based* hashing: an independent sample from (seed,
actor_id, step, draw-index) with pure arithmetic, so there is no
per-actor generator state to store and no sequential dependence between
lanes. The same body runs on the plain tick (eager torch ops over the
cohort's lanes) and in both kernels (``ops/lanecode.py`` records the ops
below, ``csrc/lane.cuh`` runs them one lane a thread).

    @behaviour
    def jump(self, st, step: I32):
        r = random.uniform(self.actor_id, step)        # f32 in [0,1)
        k = random.randint(self.actor_id, step, 0, 64, draw=1)
        ...

The JAX package computes in uint32. torch's uint32 has few operations,
so this module computes in int64 and masks to the low 32 bits after
every product and on every input (a negative int32 `step` wraps as a
uint32 conversion does); the results are bit-equal to the JAX
package's. Python ints stay Python ints until they meet a tensor.
`randint` with ``hi == lo`` gives `lo`, as the JAX package's uint32
remainder by zero does on the CPU (engine._IntDivision, pony_rem).

Host-side, `Rand` mirrors the reference's object API (next/int/real)
for host code and tests.
"""

from __future__ import annotations

import torch

_DEFAULT_SEED = 0x5DEECE66
_M32 = 0xFFFFFFFF


def _u32(x):
    """`x` as its uint32 value: an int64 tensor or a Python int."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _mix(a, b):
    """One 64→32 threefry-ish mixing round pair (cheap, statistically
    fine for actor workloads; not for cryptographic use). `a` is a uint32
    value already (the seed or an earlier round's result)."""
    x = (((a * 0x9E3779B9) & _M32) + _u32(b)) & _M32
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & _M32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.tensor(
        x, dtype=torch.int64)


def bits(actor_id, step, draw: int = 0, seed: int = _DEFAULT_SEED):
    """32 uniform bits per (actor, step, draw) — the counter-based core,
    as an int64 tensor of values in [0, 2^32)."""
    h = _mix(_u32(seed), actor_id)
    h = _mix(h, step)
    return _tensor(_mix(h, draw))


def uniform(actor_id, step, draw: int = 0, seed: int = _DEFAULT_SEED):
    """f32 in [0, 1) (≙ Random.real)."""
    return (bits(actor_id, step, draw, seed) >> 8).to(torch.float32) * (
        1.0 / (1 << 24))


def randint(actor_id, step, lo, hi, draw: int = 0,
            seed: int = _DEFAULT_SEED):
    """i32 in [lo, hi) (≙ Random.int)."""
    span = _u32(hi - lo)
    b = bits(actor_id, step, draw, seed)
    if isinstance(span, torch.Tensor):
        zero = span == 0
        r = torch.where(zero, 0, b % torch.where(zero, 1, span))
    else:
        r = b % span if span else b * 0
    lo32 = lo.to(torch.int32) if isinstance(lo, torch.Tensor) else int(lo)
    return lo32 + r.to(torch.int32)


class Rand:
    """Sequential host-side generator with the reference's object API
    (packages/random/random.pony: next/int/real/shuffle)."""

    def __init__(self, seed: int = _DEFAULT_SEED):
        self._s = seed & 0xFFFFFFFF
        self._i = 0

    def next(self) -> int:
        self._i += 1
        x = (self._s + self._i * 0x9E3779B9) & 0xFFFFFFFF
        x = ((x ^ (x >> 16)) * 0x85EBCA6B) & 0xFFFFFFFF
        x = ((x ^ (x >> 13)) * 0xC2B2AE35) & 0xFFFFFFFF
        return x ^ (x >> 16)

    def int(self, n: int) -> int:
        return self.next() % n

    def real(self) -> float:
        return (self.next() >> 8) / float(1 << 24)

    def shuffle(self, xs) -> None:
        for i in range(len(xs) - 1, 0, -1):
            j = self.int(i + 1)
            xs[i], xs[j] = xs[j], xs[i]

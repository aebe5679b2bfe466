"""mandelbrot on the PyTorch port — the same program as
``ponyc_tpu/models/mandelbrot.py`` (the reference example
`examples/mandelbrot/mandelbrot.pony`: Worker actors compute 8-pixel
groups of the escape-time fractal; the compute-dense F32 workload).

One Worker actor per 8-pixel group; `compute` receives the group's 8 real
coordinates as a VecF32[8] payload (a planar [8, lanes] block) and the
shared imaginary coordinate, runs the escape iteration over [8, lanes]
planes, and stores the finished bitmap byte in actor state. The
iteration is a Python loop of ITERATIONS rounds: the plain path runs it
eagerly, and the lane tracer (``ops/lanecode.py``) unrolls it into the
fused and window kernels' bodies, as it does `mixed`'s rounds. The byte
is a sum over the body's own 8-wide axis (a lane-local reduction) of
the alive bits times a constant vector of weights. The host assembles
the PBM from the byte column in one bulk read.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import F32, I32, Runtime, RuntimeOptions, VecF32, actor, behaviour

ITERATIONS = 64          # static trace bound (≙ --iterations, default 50)
LIMIT_SQ = 4.0           # escape when |z|² > limit² (≙ limit 4.0)
WEIGHTS = (2 ** np.arange(7, -1, -1)).astype(np.int32)   # MSB = leftmost


@actor
class Worker:
    byte: I32            # finished 8-pixel bitmap byte (MSB = leftmost)
    done: I32

    MAX_SENDS = 0
    BATCH = 1

    @behaviour
    def compute(self, st, cr: VecF32[8], ci: F32):
        zr, zi = cr, cr * 0.0 + ci
        alive = (zr * 0.0) < 1.0              # all True, [8, lanes]
        for _ in range(ITERATIONS):
            zr2, zi2 = zr * zr, zi * zi
            nzr = (zr2 - zi2) + cr
            nzi = (2.0 * zr * zi) + ci
            alive = alive & ((zr2 + zi2) <= LIMIT_SQ)
            zr, zi = nzr, nzi
        weights = torch.from_numpy(WEIGHTS).to(cr.device).reshape(
            (8,) + (1,) * (alive.ndim - 1))
        byte = (alive.to(torch.int32) * weights).sum(0)
        return {**st, "byte": byte, "done": 1}


def default_options() -> RuntimeOptions:
    return RuntimeOptions(mailbox_cap=4, batch=1, max_sends=0, msg_words=9,
                          spill_cap=64, inject_slots=64)


def build(width: int = 64, height: int = 64,
          opts: RuntimeOptions | None = None, device=None):
    """One Worker per 8-pixel group, row-major (width must be a multiple
    of 8, as the reference's byte packing requires). `device` as for
    Runtime (None = the CUDA device)."""
    if width % 8:
        raise ValueError("width must be a multiple of 8")
    groups = (width // 8) * height
    rt = Runtime(opts or default_options(), device=device)
    rt.declare(Worker, groups)
    rt.start()
    ids = rt.spawn_many(Worker, groups)
    return rt, ids


def coordinates(width: int, height: int):
    """The per-group payload columns: cr [groups, 8] and ci [groups],
    computed on the host as the reference's precomputed real and
    imaginary arrays are (mandelbrot.pony:147-155, 2/height for rows)."""
    gw = width // 8
    xs = np.arange(width, dtype=np.float32)
    ys = np.arange(height, dtype=np.float32)
    real = (2.0 / width) * xs - 1.5
    imag = (2.0 / height) * ys - 1.0
    cr = np.tile(real.reshape(gw, 8), (height, 1))
    ci = np.repeat(imag, gw)
    return cr, ci


def render(width: int = 64, height: int = 64,
           opts: RuntimeOptions | None = None, device=None) -> np.ndarray:
    """Compute the full image; returns the [height, width//8] byte grid
    (bit set = pixel in the set, as in the reference's PBM bitmap)."""
    rt, ids = build(width, height, opts, device=device)
    cr, ci = coordinates(width, height)
    rt.bulk_send(ids, Worker.compute, cr, ci)
    rt.run(max_steps=200)
    st = rt.cohort_state(Worker)
    if int(st["done"].sum()) != len(ids):
        raise RuntimeError("not all groups computed")
    return st["byte"].astype(np.uint8).reshape(height, width // 8)


def reference_bytes(width: int, height: int, rows=None) -> np.ndarray:
    """NumPy oracle with the same iteration and limit semantics; `rows`
    (an index array) computes only those rows of the image."""
    xs = np.arange(width, dtype=np.float32)
    ys = np.arange(height, dtype=np.float32)
    real = (2.0 / width) * xs - 1.5
    imag = (2.0 / height) * ys - 1.0
    if rows is not None:
        imag = imag[np.asarray(rows)]
    c = real[None, :] + 1j * imag[:, None]
    z = c.astype(np.complex64)
    alive = np.ones(c.shape, bool)
    for _ in range(ITERATIONS):
        alive &= (z.real * z.real + z.imag * z.imag) <= LIMIT_SQ
        z = np.where(alive, z * z + c, z)
    bits = alive.reshape(len(imag), width // 8, 8)
    return (bits * WEIGHTS).sum(-1).astype(np.uint8)


def f32_bytes(width: int, height: int, rows=None) -> np.ndarray:
    """The body's float32 arithmetic replayed in NumPy, op for op (no
    fused multiply-add), on the same coordinates; `rows` as for
    `reference_bytes`. `reference_bytes` mixes in complex128 after the
    first round (`z * z + c` with `c` complex128), so on wide images a
    few pixels near the set's edge differ between the two; the kernels
    and the plain path compute in float32 and equal this one."""
    xs = np.arange(width, dtype=np.float32)
    ys = np.arange(height, dtype=np.float32)
    real = (2.0 / width) * xs - 1.5
    imag = (2.0 / height) * ys - 1.0
    if rows is not None:
        imag = imag[np.asarray(rows)]
    gw = width // 8
    cr = np.broadcast_to(real[None, :], (len(imag), width))
    ci = np.broadcast_to(imag[:, None], cr.shape)
    zr, zi = cr, cr * np.float32(0.0) + ci
    alive = np.ones(cr.shape, bool)
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(ITERATIONS):
            zr2, zi2 = zr * zr, zi * zi
            nzr = (zr2 - zi2) + cr
            nzi = (np.float32(2.0) * zr * zi) + ci
            alive &= (zr2 + zi2) <= np.float32(LIMIT_SQ)
            zr, zi = nzr, nzi
    bits = alive.reshape(cr.shape[0], gw, 8)
    return (bits * WEIGHTS).sum(-1).astype(np.uint8)


def write_pbm(path: str, bytes_grid: np.ndarray, width: int) -> None:
    """P4 PBM writer (≙ the reference writing the bitmap via files)."""
    height = bytes_grid.shape[0]
    with open(path, "wb") as f:
        f.write(b"P4\n%d %d\n" % (width, height))
        f.write(bytes_grid.tobytes())

"""The mailbox drain: every actor's next `batch` messages in one pass.

≙ the hot half of ponyint_actor_run's message pop loop
(src/libponyrt/actor/actor.c:383-549). The JAX package runs it as a
Pallas TPU kernel (``ponyc_tpu/ops/mailbox_kernel.py: drain_msgs``) or
as an XLA select chain (``engine._ring_take``); this port runs it as the
hand-written CUDA kernel ``csrc/drain.cu`` on the card and as
`drain_msgs_plain` on the CPU.

`drain_msgs` chooses by where its tensors lie and by nothing else: CPU
tensors take the plain version, CUDA tensors launch the kernel (or
raise). `drain_msgs.launches` counts kernel launches and nothing else;
each launch reports its bytes to an open cost-capture census
(ops/census.py).
"""

from __future__ import annotations

import ctypes

import torch

from . import census


def drain_msgs_plain(buf: torch.Tensor, head: torch.Tensor,
                     n_run: torch.Tensor, batch: int):
    """The plain PyTorch version: per batch slot k, gather ring slot
    (head + k) mod cap of every lane, as ``engine._ring_take`` does.
    buf [cap, w1, N] int32; head, n_run [N] int32. Returns (msgs
    [batch, w1, N] int32, valid [batch, N] bool)."""
    cap, w1, n = buf.shape
    msgs = []
    for k in range(batch):
        slot = ((head + k) & (cap - 1)).long()            # [N]
        idx = slot.reshape(1, 1, n).expand(1, w1, n)
        msgs.append(torch.gather(buf, 0, idx)[0])
    ks = torch.arange(batch, dtype=torch.int32, device=buf.device)
    valid = ks[:, None] < n_run[None, :]
    if batch == 0:
        return buf.new_zeros((0, w1, n)), valid
    return torch.stack(msgs), valid


def _check(buf, head, n_run, batch):
    if buf.dtype != torch.int32 or head.dtype != torch.int32 \
            or n_run.dtype != torch.int32:
        raise TypeError("drain_msgs takes int32 buf, head and n_run")
    if buf.ndim != 3 or head.shape != (buf.shape[2],) \
            or n_run.shape != (buf.shape[2],):
        raise ValueError(f"drain_msgs shapes: buf {tuple(buf.shape)} "
                         f"head {tuple(head.shape)} "
                         f"n_run {tuple(n_run.shape)}")
    cap = buf.shape[0]
    if cap < 1 or cap & (cap - 1):
        raise ValueError("mailbox capacity must be a power of two")
    if batch < 0:
        raise ValueError("batch must be >= 0")


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_KERNEL = []          # the bound launch function, once loaded


def _kernel():
    """The drain's launch function, built and bound on first use (each
    later call costs nothing on the host)."""
    if not _KERNEL:
        from . import _build
        fn = _build.load("drain").pony_drain_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _KERNEL.append(fn)
    return _KERNEL[0]


def _launch(buf, head, n_run, batch):
    cap, w1, n = buf.shape
    if not (buf.is_contiguous() and head.is_contiguous()
            and n_run.is_contiguous()):
        raise ValueError("drain_msgs kernel takes contiguous tensors")
    if not (head.device == buf.device == n_run.device):
        raise ValueError("drain_msgs tensors must share one device")
    msgs = torch.empty((batch, w1, n), dtype=torch.int32, device=buf.device)
    valid = torch.empty((batch, n), dtype=torch.uint8, device=buf.device)
    if n == 0 or batch == 0:
        return msgs, valid.view(torch.bool)   # nothing to launch or count
    fn = _kernel()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = fn(buf.data_ptr(), head.data_ptr(), n_run.data_ptr(),
                 msgs.data_ptr(), valid.data_ptr(), cap, w1, n, batch,
                 stream)
    if err != 0:
        raise RuntimeError(f"drain kernel launch failed: CUDA error {err}")
    drain_msgs.launches += 1
    census.report("drain", (buf, head, n_run), (msgs, valid), flops=0.0)
    return msgs, valid.view(torch.bool)


def drain_msgs(buf: torch.Tensor, head: torch.Tensor, n_run: torch.Tensor,
               batch: int):
    """All actors' next `batch` messages in one pass over the mailbox.

    buf: [cap, w1, N] int32 (planar, actor-minor); head, n_run: [N]
    int32. Returns (msgs [batch, w1, N] int32, valid [batch, N] bool).
    On CUDA tensors this launches csrc/drain.cu; on CPU tensors it runs
    `drain_msgs_plain`."""
    _check(buf, head, n_run, batch)
    if buf.device.type == "cuda":
        return _launch(buf, head, n_run, batch)
    if buf.device.type != "cpu":
        raise ValueError(f"drain_msgs: unsupported device {buf.device}")
    return drain_msgs_plain(buf, head, n_run, batch)


drain_msgs.launches = 0

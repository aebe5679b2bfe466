"""The byte census behind cost capture (ponyc_tpu_torch/costs.py).

XLA reports the bytes an executable accesses by one rule: the operand
bytes plus the output bytes of every op it runs. PyTorch has no such
report, so the port counts by the same rule itself: a `Census` is a
TorchDispatchMode that sees every ATen op run under it and adds each
op's tensor operands' and outputs' bytes. View ops (their outputs alias
their input without writing: `view`, `select`, `slice`, `expand`, ...)
move no bytes, and allocations (`empty`, `empty_like`, ...) write none;
neither is counted. An in-place op counts its destination as an operand
and again as its output.

The three hand-written kernels are launched through ctypes, below the
dispatcher, so no dispatch mode sees them: each wrapper calls `report`
where it launches, with the tensors the launch reads and those it
writes. `Census.check` then holds the kernels' own launch counters
against the reports, so a launch that reported nothing fails the census
instead of reading low.

`flops` counts one operation an element of the output of every
pointwise op that reads or writes a float tensor, and 2·M·N·K a matrix
product. A kernel whose float work the census cannot see (the fused
dispatch and the window kernel run user bodies) reports None, and the
census's `flops` is then None.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# The censuses running now (a capture may nest none, but a report must
# reach every one that is open).
ACTIVE: List["Census"] = []

_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "resize_", "set_"}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv"}


def tensor_bytes(ts: Iterable[Optional[torch.Tensor]]) -> int:
    """Bytes of the tensors in `ts` (None skipped), each counted whole."""
    return int(sum(t.numel() * t.element_size() for t in ts
                   if t is not None))


def report(kernel: str, inputs: Iterable[Optional[torch.Tensor]],
           outputs: Iterable[Optional[torch.Tensor]],
           flops: Optional[float] = None) -> None:
    """A kernel wrapper's account of one launch: the bytes of the tensors
    it reads plus those it writes (a tensor both read and written is in
    both lists), and its float operations where known. A no-op unless a
    census is open."""
    if not ACTIVE:
        return
    nbytes = tensor_bytes(inputs) + tensor_bytes(outputs)
    for c in ACTIVE:
        c.kernel_launch(kernel, nbytes, flops)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


class CensusError(RuntimeError):
    """A census that cannot be trusted: a kernel launched without
    reporting its bytes."""


class Census(TorchDispatchMode):
    """Counts the bytes (and attributable float operations) of the ATen
    ops and kernel launches run under it; see the module docstring."""

    def __init__(self, counters: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.flops: Optional[float] = 0.0
        self.kernels: Dict[str, Dict[str, int]] = {}
        # {kernel name: a callable giving its launch counter}: read at
        # entry and exit, held against the reports by `check`.
        self._counters = dict(counters or {})
        self._start: Dict[str, int] = {}

    def __enter__(self):
        self._start = {k: int(f()) for k, f in self._counters.items()}
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    def kernel_launch(self, kernel: str, nbytes: int,
                      flops: Optional[float]) -> None:
        k = self.kernels.setdefault(kernel, {"launches": 0, "bytes": 0})
        k["launches"] += 1
        k["bytes"] += int(nbytes)
        self.bytes += int(nbytes)
        if flops is None:
            self.flops = None
        elif self.flops is not None:
            self.flops += float(flops)

    def check(self) -> None:
        """Raise CensusError unless every kernel launch made under the
        census reported its bytes."""
        for k, f in self._counters.items():
            launched = int(f()) - self._start.get(k, 0)
            reported = self.kernels.get(k, {}).get("launches", 0)
            if launched != reported:
                raise CensusError(
                    f"kernel {k!r} launched {launched} time(s) under the "
                    f"census but reported {reported}: its wrapper must "
                    "call ops.census.report where it launches")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _ALLOC or _is_view(func):
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.ops += 1
        self.bytes += tensor_bytes(ins) + tensor_bytes(outs)
        if self.flops is not None:
            if name in _MATMUL and len(ins) >= 2 and outs \
                    and _is_float(outs[0]):
                a = ins[-2]
                k = a.shape[-1] if a.dim() else 1
                self.flops += 2.0 * outs[0].numel() * k
            elif torch.Tag.pointwise in func.tags and outs and any(
                    _is_float(t) for t in ins + outs):
                self.flops += float(outs[0].numel())
        return out

"""Behaviour bodies as lane programs: what the fused dispatch kernel
(``csrc/fused_dispatch.cu``) and the window kernel
(``csrc/mega_window.cu``) run for each message.

The JAX package gets its bodies into the Pallas kernel for free: tracing
the body inside the kernel emits its operations there. A CUDA kernel has
no such tracer, so this module records each body once, at the ATen
level, while ``engine.eval_behaviour`` runs it on a few probe lanes under
a ``TorchDispatchMode``. The send budget, typed-ref, capability and
in-place checks therefore stay one implementation, and torch itself
settles type promotion and how an operator is spelt (``1.0 / x`` reaches
ATen as ``reciprocal`` then ``mul``, so it is not a float division).

A *lane program* is a list of nodes, each one value per actor lane:
inputs (a state field, a payload word, the actor id, a spawn site's
reserved ref), constants, and lane-wise ATen ops over earlier nodes. Shape ops (select, slice, view,
expand, cat, ...) never become nodes: a tensor of shape ``[*lead,
lanes]`` is held as one node per lead element, and shape ops only
rearrange those. The body's whole Context is recorded as nodes too: each
send's target (already masked by ``when``) and packed words (with the
F32 bit-casts of ``pack.pack_args``), exit, yield, destroy,
``error_int`` (whose site id is a constant), each spawn site's claimed
ref, the spawn fail flag and, for ``spawn_sync``, the constructor's
`has` mask and field values per site.

The device blob pool (``ctx.blob_*``) is not lane-wise: a read is a
gather over the pool, a write a scatter. A body of a cohort that uses the
pool is traced with a view of the pool (`_BlobTrace`) whose methods record
explicit "blob" nodes instead: the reads (``get``, ``len``, with the
handle's generation and `used` checks) and the effects (``alloc`` at the
lane's reserved slot of its site, ``set``, ``free``, the count of Blob
arguments that arrived off the pool), kept in program order, so that a
read sees the body's earlier writes. ``csrc/lane.cuh`` emits them as
loads and stores into the pool (``pony_blob_*``), which also count allocs
and frees and raise the fail and budget-fail flags.

Two ways to run a lane program: `replay` evaluates it with the recorded
ATen ops on CPU tensors (it equals eager evaluation bit for bit, which
the tests hold), and `emit_cohort` writes one C++ struct per cohort:
the cohort's constants and one ``__device__`` function per behaviour,
which both kernels take through ``csrc/lane.cuh``. The emitted C++ spells out torch's
elementwise semantics (int32 arithmetic wraps, ``//`` floors, ``%``
takes the divisor's sign, shifts of the width or more saturate) and, for
target "cuda", what torch's own CUDA kernels do where they differ from a
plain C expression (a float divided by a Python scalar is multiplied by
the scalar's reciprocal; ``pow`` special-cases its exponent). Target
"host" mirrors torch's CPU kernels instead, for the host build the CPU
tests use.

A constant tensor the body makes (``torch.tensor(w).reshape(8, 1)``)
is one "const" node per element, laid out like any other value; one that
holds a single value is one node. Reductions over a value's leading axes
only (``x.sum(0)`` of a ``[8, lanes]`` plane; ``sum``, ``prod``,
``amax``, ``amin``, the values of ``max``/``min`` over a dim, ``any``,
``all``) stay inside each lane: the tracer lowers each to a chain of the
binary nodes above (``add``, ``mul``, ``maximum``, ``minimum``,
``logical_or``, ``logical_and``), in torch's result dtype (an integer
or bool ``sum``/``prod`` computes in int64), so no op of its own reaches
C++.

Anything else raises NotImplementedError naming the behaviour and the
ATen op: an op that crosses lanes (a reduction over the actor axis, an
index over it), a float ``sum``/``prod`` (torch's reduce kernels choose
the order of the additions, and keep several accumulators on CUDA, so a
chain cannot match them bit for bit), the indices of ``max``/``min``,
an op without an emitter (transcendentals, float floor division,
in-place updates of body-local tensors), a constant tensor with an axis
of the lane count (a per-actor table written into the body), or reading
a lane value on the host (``bool(x)``, ``x.item()``).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _disable_current_modes)

aten = torch.ops.aten

CTYPE = {torch.bool: "bool", torch.uint8: "uint8_t", torch.int8: "int8_t",
         torch.int16: "int16_t", torch.int32: "int32_t",
         torch.int64: "int64_t", torch.float32: "float",
         torch.float64: "double"}
_UNSIGNED = {torch.uint8: "uint32_t", torch.int8: "uint32_t",
             torch.int16: "uint32_t", torch.int32: "uint32_t",
             torch.int64: "uint64_t"}
_FLOAT = (torch.float32, torch.float64)

# Effects of the Context, in the order the kernel's PonyOut holds them.
EFFECTS = ("exit_flag", "exit_code", "yield_flag", "destroy_flag",
           "error_flag", "error_code", "error_loc")
_EFFECT_SLOT = {"exit_flag": "ef", "exit_code": "ec", "yield_flag": "yf",
                "destroy_flag": "ds", "error_flag": "erf",
                "error_code": "erc", "error_loc": "erl"}

# Shape ops: they rearrange the nodes of a [*lead, lanes] tensor.
_IDENTITY = {"alias", "detach", "clone", "lift_fresh"}
_RESHAPE = {"view", "_unsafe_view", "unsqueeze", "squeeze"}
_REARRANGE = {"select", "slice", "unbind", "split", "split_with_sizes",
              "cat", "stack", "permute", "transpose", "t"}
# Ops that read across actors: named so in the error.
_CROSSING = {"sum", "mean", "prod", "max", "min", "amax", "amin", "any",
             "all", "argmax", "argmin", "cumsum", "cumprod", "cummax",
             "cummin", "sort", "argsort", "topk", "gather", "scatter",
             "index", "index_select", "index_put", "take", "roll", "flip",
             "nonzero", "masked_select", "unique", "bincount",
             "searchsorted", "var", "std", "norm", "count_nonzero",
             "matmul", "mm", "bmm", "dot", "mv", "logsumexp", "softmax",
             "_softmax", "log_softmax", "_log_softmax"}
# Reductions that stay inside a lane when they reduce leading axes only:
# the overloads taken, and the binary op each chains.
_REDUCE = {aten.sum.dim_IntList: aten.add.Tensor,
           aten.prod.dim_int: aten.mul.Tensor,
           aten.amax.default: aten.maximum.default,
           aten.amin.default: aten.minimum.default,
           aten.max.dim: aten.maximum.default,
           aten.min.dim: aten.minimum.default,
           aten.any.dim: aten.logical_or.default,
           aten.all.dim: aten.logical_and.default}
for _name, _op in (("any", aten.logical_or.default),
                   ("all", aten.logical_and.default)):
    if hasattr(getattr(aten, _name), "dims"):
        _REDUCE[getattr(aten, _name).dims] = _op
# Ops that would read a lane value into Python.
_HOST_READ = {"_local_scalar_dense", "is_nonzero", "equal", "item"}


class _Ref:
    """A tensor operand of a recorded op: node `i`."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __repr__(self):
        return f"v{self.i}"


@dataclasses.dataclass
class Node:
    """One value per actor lane. kind: "field" (key = field name),
    "word" (key = payload word index), "id", "resv" (key = flat spawn
    site: this dispatch's reserved ref there), "const" (key = the Python
    value; `dimmed` when it came from a tensor with dimensions, which
    matters for type promotion), or "op" (func over `leaves`, the
    flattened (args, kwargs) with `_Ref` for tensor operands; `cdtype`
    is the dtype torch computes in)."""
    kind: str
    dtype: torch.dtype
    key: Any = None
    func: Any = None
    spec: Any = None
    leaves: tuple = ()
    cdtype: Optional[torch.dtype] = None
    dimmed: bool = False


@dataclasses.dataclass
class LaneProgram:
    """One behaviour's body. `fields` maps every state field to its new
    value's node; `sends` holds, per send slot the body uses, the target
    node (-1 where `when` is false) and the w1 word nodes; `effects` maps
    each Context effect to its node, or None where the body never
    touched it. Spawns, per flat site (the cohort's spawn sites, target
    by target): `claims` the claimed ref's node (None: the body never
    claims there), `inits` the sync constructor's (has, [value node per
    target field]) (None: no spawn_sync there), and `spawn_fail` the
    fail flag's node (None: no spawn)."""
    name: str
    nodes: List[Node]
    fields: Dict[str, int]
    sends: List[Tuple[int, List[int]]]
    effects: Dict[str, Optional[int]]
    destroy_called: bool
    error_called: bool
    claims: List[Optional[int]] = dataclasses.field(default_factory=list)
    inits: List[Optional[Tuple[int, List[int]]]] = dataclasses.field(
        default_factory=list)
    spawn_fail: Optional[int] = None
    blob_effects: List[int] = dataclasses.field(default_factory=list)

    @property
    def sync(self) -> bool:
        """Does the body sync-construct (ctx.spawn_sync)?"""
        return any(i is not None for i in self.inits)


def _named(func, args, kwargs) -> Dict[str, Any]:
    """The op's arguments by schema name, defaults filled in."""
    out = {}
    for k, a in enumerate(func._schema.arguments):
        if k < len(args):
            out[a.name] = args[k]
        elif a.name in kwargs:
            out[a.name] = kwargs[a.name]
        elif a.has_default_value():
            out[a.name] = a.default_value
        else:
            out[a.name] = None
    return out


class _Tracer(TorchDispatchMode):
    """Records the lane-wise ATen ops a body runs on the probe lanes."""

    def __init__(self, lanes: int, where: str):
        super().__init__()
        self.P = lanes
        self.where = where
        self.nodes: List[Node] = []
        self.vals: Dict[int, torch.Tensor] = {}   # id(tensor) -> node ids
        self.keep: List[torch.Tensor] = []        # ids stay unique
        self.inputs: set = set()
        self.unusable: Dict[int, str] = {}        # id(tensor) -> why

    # -- bookkeeping --------------------------------------------------
    def refuse(self, func, why: str):
        return NotImplementedError(
            f"pallas_fused: behaviour {self.where} uses {func}, which {why}; "
            "the fused dispatch kernel evaluates a body one actor per "
            "thread (ponyc_tpu_torch/ops/lanecode.py lists what it runs)")

    def add(self, node: Node) -> int:
        if node.dtype not in CTYPE:
            raise NotImplementedError(
                f"pallas_fused: behaviour {self.where} makes a "
                f"{node.dtype} value; the fused kernel's types are "
                f"{', '.join(str(d) for d in CTYPE)}")
        self.nodes.append(node)
        return len(self.nodes) - 1

    def cshape(self, shape) -> Tuple[int, ...]:
        """Node layout of a tensor shape: the lane axis (last, of size P)
        collapses to 1."""
        shape = tuple(shape)
        if shape and shape[-1] == self.P:
            return shape[:-1] + (1,)
        return shape

    def lane_shaped(self, t: torch.Tensor) -> bool:
        return t.ndim >= 1 and t.shape[-1] == self.P

    def bind(self, t: torch.Tensor, comps: torch.Tensor) -> None:
        self.vals[id(t)] = comps
        self.keep.append(t)

    def input(self, t: torch.Tensor, comps: torch.Tensor) -> None:
        self.bind(t, comps)
        self.inputs.add(id(t))

    def comps_of(self, t: torch.Tensor) -> torch.Tensor:
        """The node ids of `t`; a tensor the body made without lane
        inputs is a constant, and must hold one value."""
        c = self.vals.get(id(t))
        if c is not None:
            return c
        if id(t) in self.unusable:
            raise NotImplementedError(
                f"pallas_fused: behaviour {self.where} uses "
                f"{self.unusable[id(t)]}; the fused kernel does not make it")
        flat = t.detach().reshape(-1)
        if flat.numel() == 0:
            raise NotImplementedError(
                f"pallas_fused: behaviour {self.where} uses an empty "
                f"constant tensor of shape {tuple(t.shape)}")
        if flat.numel() == 1 or bool((flat == flat[0]).all()):
            i = self.add(Node("const", t.dtype, key=flat[0].item(),
                              dimmed=t.ndim > 0))
            return torch.full(self.cshape(t.shape), i, dtype=torch.int64)
        if self.lane_shaped(t):
            raise NotImplementedError(
                f"pallas_fused: behaviour {self.where} uses a constant "
                f"tensor of shape {tuple(t.shape)}, whose last axis has the "
                "lane count (a per-actor table written into the body); the "
                "fused kernel takes constants without a lane axis only")
        ids = torch.empty(tuple(t.shape), dtype=torch.int64)
        for idx in np.ndindex(*t.shape):
            ids[idx] = self.add(Node("const", t.dtype, key=t[idx].item(),
                                     dimmed=True))
        return ids

    # -- dispatch -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        flat, _spec = pytree.tree_flatten((args, kwargs))
        tens = [a for a in flat if isinstance(a, torch.Tensor)]
        if name in _HOST_READ and any(id(a) in self.vals for a in tens):
            raise self.refuse(func, "reads a lane value on the host "
                              "(Python control flow on actor data)")
        out = func(*args, **kwargs)
        if not tens:
            return out          # a creation op: a constant, read at use
        if func._schema.is_mutable:
            mutated = [a for a in tens if id(a) in self.vals]
            if not mutated:
                return out      # updates a constant; read at use
            if all(id(a) in self.inputs for a in mutated):
                return out      # eval_behaviour raises for this itself
            raise self.refuse(func, "updates a tensor in place "
                              "(write x = x + 1, not x += 1)")
        if func in _REDUCE:
            self._reduce(func, args, kwargs, out)
            return out
        if name in _CROSSING:
            raise self.refuse(func, "is not lane-wise (it reads across "
                              "actors)")
        if func == aten.view.dtype or (name in EMITTERS and not (
                name == "_to_copy"
                and kwargs.get("dtype") in (None, args[0].dtype))):
            if not isinstance(out, torch.Tensor):
                raise self.refuse(func, "returns several tensors")
            self.bind(out, self._elementwise(func, args, kwargs, out))
        elif name in _IDENTITY or name == "_to_copy":
            self.bind(out, self.comps_of(args[0]))
        elif name in _RESHAPE or name in _REARRANGE or name == "expand":
            self._shape_op(func, name, args, kwargs, out)
        else:
            raise self.refuse(func, "has no lane-code emitter")
        return out

    def _shape_op(self, func, name, args, kwargs, out):
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        ins = [a for a in pytree.tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        if any(self.lane_shaped(a) for a in ins) and not all(
                self.lane_shaped(o) for o in outs):
            raise self.refuse(func, "moves or splits the actor axis (it "
                              "is not lane-wise)")
        if name in _RESHAPE or name == "expand":
            src = self.comps_of(args[0])
            shape = self.cshape(out.shape)
            if name == "expand":
                comps = src.expand(shape).clone()
            elif src.numel() == int(np.prod(shape, dtype=np.int64)):
                comps = src.reshape(shape).clone()
            elif bool((src == src.reshape(-1)[0]).all()):
                comps = torch.full(shape, int(src.reshape(-1)[0]),
                                   dtype=torch.int64)
            else:
                raise self.refuse(func, "mixes the actor axis with others")
            self.bind(out, comps)
            return
        # The same op over the node-id tensors rearranges the nodes.
        flat, spec = pytree.tree_flatten((args, kwargs))
        flat = [self.comps_of(a) if isinstance(a, torch.Tensor) else a
                for a in flat]
        a2, k2 = pytree.tree_unflatten(flat, spec)
        res = func(*a2, **k2)
        res = list(res) if isinstance(res, (tuple, list)) else [res]
        for o, c in zip(outs, res):
            if tuple(c.shape) != self.cshape(o.shape):
                raise self.refuse(func, "mixes the actor axis with others")
            self.bind(o, c.clone())

    def node(self, func, args, kwargs, dtype, cdtype) -> int:
        """An op node over `args`/`kwargs` whose tensor operands are
        _Refs."""
        flat, spec = pytree.tree_flatten((args, kwargs))
        return self.add(Node("op", dtype, func=func, spec=spec,
                             leaves=tuple(flat), cdtype=cdtype))

    def convert(self, i: int, dtype) -> int:
        """Node `i` as `dtype` (a _to_copy node; `i` itself if it has
        that dtype)."""
        if self.nodes[i].dtype == dtype:
            return i
        return self.node(aten._to_copy.default, (_Ref(i),),
                         {"dtype": dtype}, dtype, dtype)

    def _reduce(self, func, args, kwargs, out):
        """A reduction over leading axes: per output element, a chain of
        binary nodes over the reduced elements in row-major order."""
        x = args[0]
        if id(x) not in self.vals:
            return                  # over a constant: a constant
        named = _named(func, args, kwargs)
        dims = named.get("dim")
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            dims = range(x.ndim)
        elif not isinstance(dims, (list, tuple)):
            dims = [dims]
        dims = sorted({int(d) % max(x.ndim, 1) for d in dims})
        if self.lane_shaped(x) and x.ndim - 1 in dims:
            raise self.refuse(func, "is not lane-wise (it reads across "
                              "actors)")
        vals = out[0] if isinstance(out, (tuple, list)) else out
        if isinstance(out, (tuple, list)):
            for extra in out[1:]:
                self.unusable[id(extra)] = f"the indices of {func}"
                self.keep.append(extra)
        op = _REDUCE[func]
        rdt = vals.dtype
        if op in (aten.add.Tensor, aten.mul.Tensor) and rdt in _FLOAT:
            raise self.refuse(func, "reduces floats, whose order of "
                              "operations torch's reduce kernels choose "
                              "(on CUDA with several accumulators), so a "
                              "lane chain cannot match it bit for bit")
        edt = (torch.bool if op in (aten.logical_or.default,
                                    aten.logical_and.default) else rdt)
        comps = self.comps_of(x)
        kept = [a for a in range(comps.ndim) if a not in dims]
        cp = comps.permute(kept + dims)
        kshape = tuple(cp.shape[:len(kept)])
        groups = cp.reshape(kshape + (-1,))
        if groups.shape[-1] == 0:
            raise self.refuse(func, "reduces an empty axis")
        ids = torch.empty(kshape, dtype=torch.int64)
        for idx in np.ndindex(*kshape):
            elems = [self.convert(int(i), edt) for i in groups[idx]]
            acc = elems[0]
            for e in elems[1:]:
                acc = self.node(op, (_Ref(acc), _Ref(e)), {}, edt, edt)
            ids[idx] = self.convert(acc, rdt)
        self.bind(vals, ids.reshape(self.cshape(vals.shape)))

    def _elementwise(self, func, args, kwargs, out) -> torch.Tensor:
        flat, spec = pytree.tree_flatten((args, kwargs))
        tpos = [k for k, a in enumerate(flat) if isinstance(a, torch.Tensor)]
        comps = torch.broadcast_tensors(*[self.comps_of(flat[k])
                                          for k in tpos])
        shape = tuple(comps[0].shape)
        if shape != self.cshape(out.shape):
            raise self.refuse(func, "broadcasts across the actor axis")
        named = _named(func, args, kwargs)
        cdtype = out.dtype
        if "other" in named and "self" in named and not isinstance(
                named["self"], (list, tuple)):
            try:
                cdtype = torch.result_type(named["self"], named["other"])
            except (TypeError, RuntimeError):
                pass
        ids = torch.empty(shape, dtype=torch.int64)
        for idx in np.ndindex(*shape):
            leaves = list(flat)
            for k, c in zip(tpos, comps):
                leaves[k] = _Ref(int(c[idx]))
            ids[idx] = self.add(Node("op", out.dtype, func=func, spec=spec,
                                     leaves=tuple(leaves), cdtype=cdtype))
        return ids

    # -- outputs ------------------------------------------------------
    def one(self, v) -> int:
        """The single node of a lane value ([lanes] or 0-dim)."""
        c = self.comps_of(v).reshape(-1)
        if c.numel() != 1:
            raise NotImplementedError(
                f"pallas_fused: behaviour {self.where} produced a value of "
                f"shape {tuple(v.shape)} where one value per actor is due")
        return int(c[0])


def _untraced(fn):
    """Run a _BlobTrace method with the tracer's mode off, so that its
    bookkeeping records no ops of its own."""
    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return run


class _BlobTrace:
    """The device blob pool as the lane tracer sees it: the methods of
    api.BlobPoolView, each recording a "blob" node (key: the op and, for
    an alloc, its site; leaves: its operands as `_Ref`s) instead of
    touching a pool. Results are int32 lane values bound to their node;
    the effects' nodes are kept, in order, in `effects`."""

    base = 0

    def __init__(self, tr: "_Tracer", sites: int, slots: int, words: int):
        self.tr = tr
        self.nsites = sites
        self.nslots = slots
        self.words = words
        self.effects: List[int] = []

    def _node(self, v, dtype) -> int:
        if isinstance(v, torch.Tensor):
            return self.tr.one(v)
        return self.tr.add(Node("const", dtype, key=v))

    def _op(self, op: str, dtype, *operands, key=None) -> int:
        i = self.tr.add(Node("blob", dtype, key=(op, key), leaves=tuple(
            _Ref(self._node(v, t)) for v, t in operands)))
        if dtype == torch.bool or op == "alloc":
            self.effects.append(i)
        return i

    def _value(self, i: int) -> torch.Tensor:
        t = torch.zeros((self.tr.P,), dtype=torch.int32)
        self.tr.bind(t, torch.full((1,), i, dtype=torch.int64))
        return t

    @_untraced
    def alloc(self, site: int, length, when):
        ln = self.words if length is None else length
        return self._value(self._op("alloc", torch.int32,
                                    (ln, torch.int32), (when, torch.bool),
                                    key=site))

    @_untraced
    def get(self, h, i):
        return self._value(self._op("get", torch.int32, (h, torch.int32),
                                    (i, torch.int32)))

    @_untraced
    def length(self, h):
        return self._value(self._op("len", torch.int32, (h, torch.int32)))

    @_untraced
    def set(self, h, i, v, when):
        self._op("set", torch.bool, (h, torch.int32), (i, torch.int32),
                 (v, torch.int32), (when, torch.bool))

    @_untraced
    def free(self, h, when):
        self._op("free", torch.bool, (h, torch.int32), (when, torch.bool))

    @_untraced
    def note_remote(self, remote):
        self._op("remote", torch.bool, (remote, torch.bool))


def probe_lanes(w1: int) -> int:
    """Lane count of the trace: larger than any word axis, so the lane
    axis is the only axis of that size."""
    return max(67, 2 * w1 + 3)


def trace_behaviour(bdef, *, field_specs, msg_words: int,
                    msg_words_in: int, max_sends: int, spawn_sites=(),
                    spawn_meta=None, blob=None) -> LaneProgram:
    """Record one behaviour's body as a lane program. `msg_words` is the
    outbox width (program-wide), `msg_words_in` the cohort's mailbox
    payload width; `spawn_sites` and `spawn_meta` are the cohort's spawn
    budget and its targets' field specs (engine.spawn_sites_of,
    engine.spawn_meta_of); `blob` ((alloc sites, pool slots, pool words),
    for a cohort that uses the blob pool) traces its ops as blob nodes. Raises
    NotImplementedError for a body the fused kernel cannot run, and
    whatever eval_behaviour raises for a bad body."""
    from ..runtime.engine import _dtype_of, eval_behaviour, spawn_outputs
    owner = bdef.actor_type.__name__ if bdef.actor_type else "?"
    where = f"{owner}.{bdef.name}"
    P = probe_lanes(1 + msg_words)
    rng = np.random.default_rng(0)
    field_dtypes = {f: _dtype_of(s) for f, s in field_specs.items()}
    st = {}
    for f, dt in field_dtypes.items():
        if dt == torch.float32:
            st[f] = torch.from_numpy(rng.standard_normal(P).astype(
                np.float32))
        else:
            st[f] = torch.from_numpy(rng.integers(1, 1 << 20, P).astype(
                np.int32))
    payload = torch.from_numpy(rng.integers(1, 1 << 20, (msg_words_in, P))
                               .astype(np.int32))
    ids = torch.arange(P, dtype=torch.int32)
    tr = _Tracer(P, where)
    for f, t in st.items():
        tr.input(t, torch.full((1,), tr.add(Node("field", t.dtype, key=f)),
                               dtype=torch.int64))
    tr.input(payload, torch.tensor(
        [[tr.add(Node("word", torch.int32, key=k))]
         for k in range(msg_words_in)], dtype=torch.int64).reshape(
             msg_words_in, 1))
    tr.input(ids, torch.full((1,), tr.add(Node("id", torch.int32)),
                             dtype=torch.int64))
    resv, g = {}, 0
    for tname, n in spawn_sites:
        resv[tname] = torch.from_numpy(rng.integers(-1, 1 << 20, (n, P))
                                       .astype(np.int32))
        tr.input(resv[tname], torch.tensor(
            [[tr.add(Node("resv", torch.int32, key=g + s))]
             for s in range(n)], dtype=torch.int64).reshape(n, 1))
        g += n
    meta = spawn_meta or {}
    bview = None if blob is None else _BlobTrace(tr, *blob)
    with tr:
        ctx, st2, tgts, words = eval_behaviour(
            bdef, st, payload, ids, msg_words=msg_words,
            field_specs=field_specs, field_dtypes=field_dtypes, lanes=P,
            max_sends=max_sends, spawn_resv=resv, spawn_meta=meta,
            blob=bview)
        claims, inits, sf = spawn_outputs(ctx, spawn_sites, meta, P,
                                          ids.device)
    fields = {f: tr.one(st2[f]) for f in field_specs}
    sends = []
    for m in range(len(ctx.sends)):
        wc = tr.comps_of(words[m])
        sends.append((tr.one(tgts[m]), [int(x) for x in wc.reshape(-1)]))
    effects = {}
    for e in EFFECTS:
        v = getattr(ctx, e)
        effects[e] = tr.one(v) if isinstance(v, torch.Tensor) else None
    for f, i in fields.items():
        if tr.nodes[i].dtype != field_dtypes[f]:
            raise AssertionError(f"{where}: field {f} traced as "
                                 f"{tr.nodes[i].dtype}")
    site_claims, site_inits = [], []
    for (tname, n), got, ini in zip(spawn_sites, claims, inits):
        site_claims += [None if c is None else tr.one(c) for c in got]
        for s in range(n):
            if ini is None or ini[0][s] is None:
                site_inits.append(None)
                continue
            site_inits.append((tr.one(ini[0][s]),
                               [tr.one(ini[1][f][s]) for f in meta[tname]]))
    return LaneProgram(where, tr.nodes, fields, sends, effects,
                       ctx.destroy_called, ctx.error_called,
                       claims=site_claims, inits=site_inits,
                       spawn_fail=None if sf is None else tr.one(sf),
                       blob_effects=[] if bview is None else bview.effects)


# --- CPU replay --------------------------------------------------------

def replay(prog: LaneProgram, fields: Dict[str, torch.Tensor],
           payload: torch.Tensor, ids: torch.Tensor):
    """Evaluate a lane program with its recorded ATen ops on [N] CPU
    tensors. Returns (fields, tgts, words, effects) as eval_behaviour
    would: fields {name: [N]}, per used send slot tgt [N] and words
    [w1, N], effects {name: [N] or None}."""
    n = ids.shape[0]
    vals: List[torch.Tensor] = []
    for node in prog.nodes:
        if node.kind == "field":
            v = fields[node.key]
        elif node.kind == "word":
            v = payload[node.key]
        elif node.kind == "id":
            v = ids
        elif node.kind == "const":
            v = torch.full((1,) if node.dimmed else (), node.key,
                           dtype=node.dtype)
        elif node.kind == "blob":
            raise NotImplementedError(
                f"{prog.name}: blob-pool ops replay through the window "
                "kernel's host build (MegaWindow.run_host), not here")
        else:
            leaves = [vals[x.i] if isinstance(x, _Ref) else x
                      for x in node.leaves]
            a, k = pytree.tree_unflatten(leaves, node.spec)
            v = node.func(*a, **k)
        vals.append(v)

    def lanes(i):
        return vals[i].expand(n)

    return ({f: lanes(i) for f, i in prog.fields.items()},
            [lanes(t) for t, _ in prog.sends],
            [torch.stack([lanes(w) for w in ws]) for _, ws in prog.sends],
            {e: (None if i is None else lanes(i))
             for e, i in prog.effects.items()})


# --- C++ emission ------------------------------------------------------

def _bits_literal(v: float, dtype) -> str:
    if dtype == torch.float32:
        (u,) = struct.unpack("<I", struct.pack("<f", np.float32(v)))
        return f"pony_f32(0x{u:08x}u)"
    (u,) = struct.unpack("<Q", struct.pack("<d", float(v)))
    return f"pony_f64(0x{u:016x}ull)"


def literal(v, dtype) -> str:
    """A Python scalar as a C++ constant of `dtype`, converted the way
    torch converts a Scalar (floats round to nearest, ints wrap)."""
    if dtype == torch.bool:
        return "true" if bool(v) else "false"
    if dtype in _FLOAT:
        return _bits_literal(float(v), dtype)
    if isinstance(v, float):
        v = int(v)                      # truncates, as static_cast does
    bits = 8 * torch.tensor([], dtype=dtype).element_size()
    v = int(v) & ((1 << bits) - 1)
    if dtype != torch.uint8 and v >= 1 << (bits - 1):
        v -= 1 << bits
    if dtype == torch.int64:
        if v == -(1 << 63):
            return "(-9223372036854775807LL - 1)"
        return f"((int64_t){v}LL)"
    return f"(({CTYPE[dtype]}){v})"


def cast(expr: str, src, dst) -> str:
    """`expr` of dtype src as dst, as c10's static_cast_with_inter_type
    converts (to bool: != 0; to uint8: through int64)."""
    if src == dst:
        return expr
    if dst == torch.bool:
        return f"(({expr}) != 0)"
    if dst == torch.uint8 and src != torch.bool:
        return f"((uint8_t)(int64_t)({expr}))"
    return f"(({CTYPE[dst]})({expr}))"


class _Emit:
    """Operand access for one node's emitter."""

    def __init__(self, nodes, node, target):
        self.nodes = nodes
        self.node = node
        self.target = target
        a, k = pytree.tree_unflatten(list(node.leaves), node.spec)
        self.args = _named(node.func, a, k)

    def dtype(self, name):
        v = self.args[name]
        if isinstance(v, _Ref):
            return self.nodes[v.i].dtype
        if isinstance(v, bool):
            return torch.bool
        if isinstance(v, int):
            return torch.int64
        return torch.float64

    def get(self, name, dtype=None) -> str:
        """Operand `name` converted to `dtype` (default: compute dtype)."""
        dtype = dtype or self.node.cdtype
        v = self.args[name]
        if isinstance(v, _Ref):
            return cast(f"v{v.i}", self.nodes[v.i].dtype, dtype)
        return literal(v, dtype)

    def is_scalar(self, name) -> bool:
        return not isinstance(self.args[name], _Ref)

    def refuse(self, why):
        return NotImplementedError(
            f"pallas_fused: {self.node.func} {why}; the fused kernel has "
            "no emitter for it")


def _wrap(e: _Emit, op: str, a: str, b: str) -> str:
    """a op b in the compute dtype; integers wrap (unsigned arithmetic)."""
    t = e.node.cdtype
    if t in _UNSIGNED:
        u = _UNSIGNED[t]
        return f"(({CTYPE[t]})(({u})({a}) {op} ({u})({b})))"
    if t == torch.bool:
        if op == "*":
            return f"({a} && {b})"
        return f"((bool)((int)({a}) {op} (int)({b})))"
    return f"({a} {op} {b})"


def _alpha_term(e: _Emit, x: str) -> Tuple[str, bool]:
    """alpha * x for add/sub; (expr, alpha_is_one)."""
    alpha = e.args.get("alpha", 1)
    if alpha == 1:
        return x, True
    return _wrap(e, "*", literal(alpha, e.node.cdtype), x), False


def _em_add(e, sign="+"):
    t = e.node.cdtype
    b, one = _alpha_term(e, e.get("other"))
    if t in _FLOAT and not one:
        # torch's CUDA kernel computes a + alpha*b, which nvcc contracts
        # into one fma.
        alpha = e.args["alpha"] * (1 if sign == "+" else -1)
        fma = "__fmaf_rn" if t == torch.float32 else "__fma_rn"
        if e.target == "host":
            fma = "fmaf" if t == torch.float32 else "fma"
        return f"{fma}({literal(alpha, t)}, {e.get('other')}, {e.get('self')})"
    return _wrap(e, sign, e.get("self"), b)


def _em_rsub(e):
    t = e.node.cdtype
    b, one = _alpha_term(e, e.get("self"))
    if t in _FLOAT and not one:
        raise e.refuse("with alpha != 1")
    return _wrap(e, "-", e.get("other"), b)


def _em_div(e):
    t = e.node.cdtype
    mode = e.args.get("rounding_mode")
    a, b = e.get("self"), e.get("other")
    if mode is None:
        if t not in _FLOAT:
            raise e.refuse("on integers without a float result")
        if e.target == "cuda" and e.is_scalar("other"):
            # torch's CUDA div multiplies by the reciprocal of a Python
            # scalar divisor (computed on the host in float).
            inv = (np.float32(1) / np.float32(e.args["other"])
                   if t == torch.float32 else 1.0 / float(e.args["other"]))
            return f"({a} * {literal(float(inv), t)})"
        return f"({a} / {b})"
    if t in _FLOAT:
        raise e.refuse(f"with rounding_mode={mode!r} on floats")
    if mode == "trunc":
        return f"({a} / {b})"
    return f"pony_floordiv<{CTYPE[t]}>({a}, {b})"


def _em_floordiv(e):
    t = e.node.cdtype
    if t in _FLOAT:
        raise e.refuse("on floats")
    return f"pony_floordiv<{CTYPE[t]}>({e.get('self')}, {e.get('other')})"


def _em_remainder(e):
    t = e.node.cdtype
    if t == torch.bool:
        raise e.refuse("on bools")
    a, b = e.get("self"), e.get("other")
    return f"pony_rem<{CTYPE[t]}>({a}, {b})"


def _em_fmod(e):
    t = e.node.cdtype
    a, b = e.get("self"), e.get("other")
    if t == torch.float32:
        return f"fmodf({a}, {b})"
    if t == torch.float64:
        return f"fmod({a}, {b})"
    return f"({a} % {b})"


def _em_cmp(op):
    def em(e):
        return f"({e.get('self')} {op} {e.get('other')})"
    return em


def _em_bitwise(op):
    def em(e):
        t = e.node.cdtype
        if t in _FLOAT:
            raise e.refuse("on floats")
        return f"(({CTYPE[t]})({e.get('self')} {op} {e.get('other')}))"
    return em


def _em_logical(op):
    def em(e):
        a = e.get("self", torch.bool)
        b = e.get("other", torch.bool)
        return f"({a} {op} {b})"
    return em


def _em_shift(kind):
    def em(e):
        t = e.node.cdtype
        if t in _FLOAT or t == torch.bool:
            raise e.refuse("on a non-integer dtype")
        return (f"pony_{kind}<{CTYPE[t]}>({e.get('self')}, "
                f"{e.get('other')})")
    return em


def _em_where(e):
    t = e.node.dtype
    return (f"({e.get('condition', torch.bool)} ? {e.get('self', t)} : "
            f"{e.get('other', t)})")


def _em_masked_fill(e):
    t = e.node.dtype
    return (f"({e.get('mask', torch.bool)} ? {e.get('value', t)} : "
            f"{e.get('self', t)})")


def _em_minmax(kind):
    def em(e):
        t = e.node.cdtype
        a, b = e.get("self"), e.get("other")
        if t == torch.bool:
            return f"({a} {'||' if kind == 'max' else '&&'} {b})"
        v = f"pony_{kind}<{CTYPE[t]}>({a}, {b})"
        if t in _FLOAT:             # NaN in either operand propagates
            return f"(({a}) != ({a}) ? ({a}) : ({b}) != ({b}) ? ({b}) : {v})"
        return v
    return em


def _em_clamp(e):
    t = e.node.dtype
    v = e.get("self", t)
    lo, hi = e.args.get("min"), e.args.get("max")
    if lo is not None:
        v = f"pony_max<{CTYPE[t]}>({v}, {e.get('min', t)})"
    if hi is not None:
        v = f"pony_min<{CTYPE[t]}>({v}, {e.get('max', t)})"
    if t in _FLOAT:
        x = e.get("self", t)
        return f"(({x}) != ({x}) ? ({x}) : {v})"
    return v


def _em_clamp_one(kind):
    def em(e):
        t = e.node.dtype
        x = e.get("self", t)
        b = e.get(kind, t)
        fn = "pony_max" if kind == "min" else "pony_min"
        v = f"{fn}<{CTYPE[t]}>({x}, {b})"
        if t in _FLOAT:
            return f"(({x}) != ({x}) ? ({x}) : {v})"
        return v
    return em


def _em_unary(fn_f32, fn_f64=None, ints=None):
    def em(e):
        t = e.node.dtype
        if t == torch.float32:
            return fn_f32(e.get("self", t))
        if t == torch.float64 and fn_f64:
            return fn_f64(e.get("self", t))
        if t not in _FLOAT and ints is not None:
            return ints(e, e.get("self", t))
        raise e.refuse(f"on {t}")
    return em


def _em_neg(e):
    t = e.node.dtype
    x = e.get("self", t)
    if t in _UNSIGNED:
        return f"(({CTYPE[t]})(0u - ({_UNSIGNED[t]})({x})))"
    if t == torch.bool:
        raise e.refuse("on bools")
    return f"(-{x})"


def _em_abs(e):
    t = e.node.dtype
    x = e.get("self", t)
    if t == torch.float32:
        return f"fabsf({x})"
    if t == torch.float64:
        return f"fabs({x})"
    if t == torch.bool:
        return x
    u = _UNSIGNED[t]
    return f"(({x}) < 0 ? ({CTYPE[t]})(0u - ({u})({x})) : ({x}))"


def _em_bitwise_not(e):
    t = e.node.dtype
    x = e.get("self", t)
    if t == torch.bool:
        return f"(!{x})"
    if t in _FLOAT:
        raise e.refuse("on floats")
    return f"(({CTYPE[t]})(~{x}))"


def _em_rsqrt(e):
    t = e.node.dtype
    x = e.get("self", t)
    if t != torch.float32:
        raise e.refuse(f"on {t}")
    if e.target == "cuda":
        return f"rsqrtf({x})"
    return f"(1.0f / sqrtf({x}))"


def _em_pow(e):
    """pow(Tensor, Scalar) as torch dispatches it: exponent 0 fills 1 and
    1 copies (Pow.cpp); 0.5/-0.5/-1 run sqrt/rsqrt/reciprocal; 2, 3, -2
    are products; other exponents are refused."""
    t = e.node.dtype
    if e.node.func != aten.pow.Tensor_Scalar:
        raise e.refuse("with a tensor exponent")
    p = e.args["exponent"]
    x = e.get("self", t)
    if p == 0:
        return literal(1, t)
    if p == 1:
        return x
    if t in _FLOAT:
        one = literal(1.0, t)
        if p == 0.5:
            return f"sqrtf({x})" if t == torch.float32 else f"sqrt({x})"
        if p == -0.5 and t == torch.float32:
            return (f"rsqrtf({x})" if e.target == "cuda"
                    else f"(1.0f / sqrtf({x}))")
        if p == -1:
            return f"({one} / {x})"
        if p == 2:
            return f"({x} * {x})"
        if p == 3:
            return f"({x} * {x} * {x})"
        if p == -2:
            return f"(({CTYPE[t]})(1.0 / (double)({x} * {x})))"
        raise e.refuse(f"with exponent {p!r} (only 0, +-0.5, +-1, 2, 3 "
                       "and -2 are emitted)")
    if isinstance(p, bool) or not isinstance(p, int) or p < 0:
        raise e.refuse(f"on {t} with exponent {p!r}")
    return f"pony_powi<{CTYPE[t]}>({x}, {literal(p, t)})"


def _em_to_copy(e):
    return cast(f"v{e.args['self'].i}", e.dtype("self"), e.node.dtype)


def _em_view_dtype(e):
    src = e.dtype("self")
    dst = e.node.dtype
    if torch.tensor([], dtype=src).element_size() != \
            torch.tensor([], dtype=dst).element_size():
        raise e.refuse("between types of different widths")
    return f"pony_bitcast<{CTYPE[dst]}>(v{e.args['self'].i})"


def _em_round(e):
    if e.node.func != aten.round.default:
        raise e.refuse("with decimals")
    return _em_unary(lambda x: f"nearbyintf({x})",
                     lambda x: f"nearbyint({x})",
                     lambda _e, x: x)(e)


EMITTERS = {
    "add": _em_add, "sub": lambda e: _em_add(e, "-"), "rsub": _em_rsub,
    "mul": lambda e: _wrap(e, "*", e.get("self"), e.get("other")),
    "div": _em_div, "floor_divide": _em_floordiv,
    "remainder": _em_remainder, "fmod": _em_fmod,
    "eq": _em_cmp("=="), "ne": _em_cmp("!="), "lt": _em_cmp("<"),
    "le": _em_cmp("<="), "gt": _em_cmp(">"), "ge": _em_cmp(">="),
    "bitwise_and": _em_bitwise("&"), "bitwise_or": _em_bitwise("|"),
    "bitwise_xor": _em_bitwise("^"),
    "logical_and": _em_logical("&&"), "logical_or": _em_logical("||"),
    "logical_xor": _em_logical("!="),
    "logical_not": lambda e: f"(!{e.get('self', torch.bool)})",
    "__lshift__": _em_shift("shl"), "__rshift__": _em_shift("shr"),
    "bitwise_left_shift": _em_shift("shl"),
    "bitwise_right_shift": _em_shift("shr"),
    "where": _em_where, "masked_fill": _em_masked_fill,
    "maximum": _em_minmax("max"), "minimum": _em_minmax("min"),
    "clamp": _em_clamp, "clamp_min": _em_clamp_one("min"),
    "clamp_max": _em_clamp_one("max"),
    "neg": _em_neg, "abs": _em_abs, "bitwise_not": _em_bitwise_not,
    "sqrt": _em_unary(lambda x: f"sqrtf({x})", lambda x: f"sqrt({x})"),
    "rsqrt": _em_rsqrt,
    "reciprocal": _em_unary(lambda x: f"(1.0f / {x})",
                            lambda x: f"(1.0 / {x})"),
    "floor": _em_unary(lambda x: f"floorf({x})", lambda x: f"floor({x})",
                       lambda _e, x: x),
    "ceil": _em_unary(lambda x: f"ceilf({x})", lambda x: f"ceil({x})",
                      lambda _e, x: x),
    "trunc": _em_unary(lambda x: f"truncf({x})", lambda x: f"trunc({x})",
                       lambda _e, x: x),
    "round": _em_round,
    "pow": _em_pow, "_to_copy": _em_to_copy,
}


def _em_blob(nodes, node) -> str:
    """A blob-pool op of csrc/lane.cuh on the lane's Out `o` (the pool,
    this dispatch's reservations and the blob counters ride there)."""
    op, site = node.key
    ops = [cast(f"v{x.i}", nodes[x.i].dtype,
                torch.bool if k == len(node.leaves) - 1
                and op in ("alloc", "set", "free", "remote")
                else torch.int32)
           for k, x in enumerate(node.leaves)]
    if op == "alloc":
        return f"pony_blob_alloc(o, {site}, {ops[0]}, {ops[1]})"
    return f"pony_blob_{op}(o, {', '.join(ops)})"


def _expr(nodes, i, target) -> str:
    node = nodes[i]
    if node.kind == "field":
        raise AssertionError("field nodes are emitted by the caller")
    if node.kind == "word":
        return f"w[{node.key}]"
    if node.kind == "resv":
        return f"rv[{node.key}]"
    if node.kind == "id":
        return "id"
    if node.kind == "const":
        return literal(node.key, node.dtype)
    if node.kind == "blob":
        return _em_blob(nodes, node)
    e = _Emit(nodes, node, target)
    if node.func == aten.view.dtype:
        return _em_view_dtype(e)
    return EMITTERS[node.func.overloadpacket.__name__](e)


def _outputs(prog: LaneProgram) -> List[int]:
    outs = list(prog.fields.values())
    for t, ws in prog.sends:
        outs += [t] + ws
    outs += [i for i in prog.effects.values() if i is not None]
    outs += [i for i in prog.claims if i is not None]
    for ini in prog.inits:
        if ini is not None:
            outs += [ini[0]] + ini[1]
    if prog.spawn_fail is not None:
        outs.append(prog.spawn_fail)
    return outs + list(prog.blob_effects)


def _needed(prog: LaneProgram) -> List[int]:
    """Nodes the outputs depend on, in program order."""
    need = set()
    stack = _outputs(prog)
    while stack:
        i = stack.pop()
        if i in need:
            continue
        need.add(i)
        node = prog.nodes[i]
        stack += [x.i for x in node.leaves if isinstance(x, _Ref)]
    return sorted(need)


def op_count(prog: LaneProgram) -> int:
    """ATen ops one evaluation of the body runs (the op nodes its outputs
    need; inputs and constants are not counted)."""
    return sum(1 for i in _needed(prog) if prog.nodes[i].kind == "op")


def emit_behaviour(prog: LaneProgram, j: int, field_names: List[str],
                   target: str = "cuda") -> str:
    """The C++ of one behaviour, a static member of its cohort's struct:
    `beh_<j>(s, w, id, rv, o)` reads the lane's state `s`, payload words
    `w`, actor id and this dispatch's reserved refs `rv` (one a spawn
    site), and writes the new state into `s` and its sends, effects and
    spawns into `o` (sync-construction values as their int32 bits)."""
    slot = {f: k for k, f in enumerate(field_names)}
    lines = [f"  // {prog.name}",
             f"  static PONY_FN void beh_{j}(State& s, const int32_t* w, "
             "int32_t id, const int32_t* rv, Out& o) {",
             "    (void)w; (void)id; (void)rv;"]
    for i in _needed(prog):
        node = prog.nodes[i]
        ct = CTYPE[node.dtype]
        if node.kind == "field":
            expr = f"s.f{slot[node.key]}"
        else:
            try:
                expr = _expr(prog.nodes, i, target)
            except NotImplementedError as err:
                raise NotImplementedError(
                    f"behaviour {prog.name}: {err}") from None
        lines.append(f"    const {ct} v{i} = {expr};")
    for f, i in prog.fields.items():
        node = prog.nodes[i]
        if not (node.kind == "field" and node.key == f):
            lines.append(f"    s.f{slot[f]} = v{i};")
    for m, (t, ws) in enumerate(prog.sends):
        lines.append(f"    o.tgt[{m}] = v{t};")
        for k, wi in enumerate(ws):
            lines.append(f"    o.w[{m}][{k}] = v{wi};")
    for e, i in prog.effects.items():
        if i is not None:
            lines.append(f"    o.{_EFFECT_SLOT[e]} = v{i};")
    for g, i in enumerate(prog.claims):
        if i is not None:
            lines.append(f"    o.clm[{g}] = v{i};")
    for g, ini in enumerate(prog.inits):
        if ini is None:
            continue
        lines.append(f"    o.has[{g}] = v{ini[0]};")
        for f, i in enumerate(ini[1]):
            lines.append(f"    o.iv[{g}][{f}] = "
                         f"pony_bitcast<int32_t>(v{i});")
    if prog.spawn_fail is not None:
        lines.append(f"    o.sf = v{prog.spawn_fail};")
    lines.append("  }")
    return "\n".join(lines)


def _switch(fn: str, arg: str, cases: List[str]) -> str:
    """A static member function of g (a flat spawn site, or a field) and
    `arg`: a switch over g's cases, 0 past them."""
    body = " ".join(f"case {g}: return {c};" for g, c in enumerate(cases))
    return (f"  static PONY_FN int {fn}(int g{arg}) {{ switch (g) {{ "
            f"{body} default: return 0; }} }}")


def emit_cohort(progs: List[LaneProgram], *, name: str,
                field_names: List[str],
                field_dtypes: Dict[str, torch.dtype], base: int,
                batch: int, cap: int, ms: int, w1: int, w1_in: int,
                noyield: bool, destroy: bool, error: bool,
                target: str = "cuda", extra: Dict[str, int] = None,
                spawn_sites=(), sd: int = 1, init_words: int = 0,
                site_targets=None, site_offsets=None,
                field_nulls: Dict[str, int] = None, blob=None) -> str:
    """One cohort as a C++ struct named `name` (csrc/lane.cuh says what
    the kernels take from it): its constants (and the `extra` ones, as
    further `static constexpr int`s), its state struct, load/store of the
    state columns from a pointer list, `null_bits(f)`, the int32 bits of
    field f's null word (`field_nulls`, default 0), one function per
    behaviour and the dispatch switch. Each cohort is a
    struct of its own, so a program's cohorts share one translation
    unit.

    Spawns: `spawn_sites` ((target, sites), ...) lay out NS flat sites,
    target by target; `sd` is SPAWN_DISPATCHES, `init_words` the widest
    target's field count where a body sync-constructs (else 0). Per flat
    site g the struct gives `resv_row(g, d)` and `claim_row(g, k)`, the
    rows of the fused kernel's reservation planes [SD * NS, rows] and
    claim planes [BATCH * NS, rows]; `site_target(g)`
    (`site_targets[t]`, default t) and, for the window kernel,
    `site_off(g)` (`site_offsets[t]` + the site) and `site_per(g)` and
    `site_n(g)` (the target's SD * sites and sites).

    Blob pool: `blob` (alloc sites, BLOB_DISPATCHES, the cohort's offset
    into the free-slot list) for a cohort that uses the pool, else None:
    BLOB, NBS, BD and BOFF, and an Out that carries the pool
    (PonyOutB)."""
    nf = len(field_names)
    ct = [CTYPE[field_dtypes[f]] for f in field_names]
    ns = sum(n for _, n in spawn_sites)
    nbs, bd, boff = blob if blob is not None else (0, 0, 0)
    consts = dict(NF=nf, NB=len(progs), BATCH=batch, CAP=cap, MS=ms, W1=w1,
                  W1_IN=w1_in, BASE=base, NOYIELD=int(bool(noyield)),
                  DESTROY=int(bool(destroy)), ERROR=int(bool(error)),
                  NS=ns, SD=sd, NI=init_words, BLOB=int(blob is not None),
                  NBS=nbs, BD=bd, BOFF=boff, **(extra or {}))
    for p in progs:
        if p.sync and not init_words:
            raise ValueError(f"{p.name} sync-constructs; emit_cohort "
                             "needs init_words")
    out = [f"struct {name} {{"]
    out += [f"  static constexpr int {k} = {v};" for k, v in consts.items()]
    out.append("  typedef PonyOutB<PonyOutT<MS, W1, NS, NI>, NBS> Out;"
               if blob is not None else
               "  typedef PonyOutT<MS, W1, NS, NI> Out;")
    rr, cr, tg, off, per, nn = [], [], [], [], [], []
    t_off = 0
    for t, (_, n) in enumerate(spawn_sites):
        for s in range(n):
            rr.append(f"{sd * t_off + s} + d * {n}")
            cr.append(f"{batch * t_off + s} + k * {n}")
            tg.append(str(t if site_targets is None else site_targets[t]))
            off.append(str((site_offsets[t] if site_offsets else 0) + s))
            per.append(str(sd * n))
            nn.append(str(n))
        t_off += n
    out += [_switch("resv_row", ", int d", rr),
            _switch("claim_row", ", int k", cr),
            _switch("site_target", "", tg), _switch("site_off", "", off),
            _switch("site_per", "", per), _switch("site_n", "", nn)]
    nulls = field_nulls or {}
    out.append(_switch("null_bits", "", [str(int(nulls.get(f, 0)))
                                          for f in field_names]))
    out.append("  struct State {")
    out += [f"    {ct[k]} f{k};  // {field_names[k]}" for k in range(nf)]
    out.append("  };")
    out.append("  template <class P> static PONY_FN void load(State& s, "
               "const P& p, int64_t i) {")
    out += [f"    s.f{k} = ((const {ct[k]}*)p[{k}])[i];" for k in range(nf)]
    out.append("    (void)s; (void)p; (void)i;")
    out.append("  }")
    out.append("  template <class P> static PONY_FN void store("
               "const State& s, const P& p, int64_t i) {")
    out += [f"    (({ct[k]}*)p[{k}])[i] = s.f{k};" for k in range(nf)]
    out.append("    (void)s; (void)p; (void)i;")
    out.append("  }")
    for j, p in enumerate(progs):
        out.append(emit_behaviour(p, j, field_names, target))
    cases = " ".join(f"case {j}: beh_{j}(s, w, id, rv, o); break;"
                     for j in range(len(progs)))
    out.append("  static PONY_FN void dispatch(int32_t local, State& s, "
               "const int32_t* w, int32_t id, const int32_t* rv, Out& o) {")
    out.append(f"    switch (local) {{ {cases} default: "
               "(void)s; (void)w; (void)id; (void)rv; (void)o; break; }")
    out.append("  }")
    out.append("};")
    return "\n".join(out) + "\n"

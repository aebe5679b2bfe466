"""Message payload packing for the PyTorch port (the counterpart of
``ponyc_tpu/ops/pack.py``; reference: src/libponyc/codegen/genfun.c packs
a pony_msg_t per behaviour and the dispatch switch unpacks it).

Every message on the wire is a fixed vector of int32 words:
``[behaviour_id, arg0, arg1, ...]``. Typed arguments are bit-reinterpreted
into words according to the behaviour's annotations and back at dispatch,
so mailboxes stay one dense int32 table.

How the narrow and unsigned widths are held on the torch side. Torch's
int8, uint8 and int16 dtypes support every arithmetic op, so ``I8``,
``U8`` and ``I16`` arguments reach a behaviour in exactly those dtypes
and wrap at their width, as in the JAX package. Torch's uint16 and uint32
support few ops (no arithmetic on CUDA), so a ``U16`` argument arrives as
an int32 tensor and a ``U32`` argument as an int64 tensor, each holding
the zero-extended value. Comparisons, and arithmetic whose result fits,
are exact; an intermediate that would wrap at 16 or 32 bits in the JAX
package does not wrap here until the value is packed back into a word
(``pack_arg`` masks it to the declared width). ``I32``, ``F32``, ``Ref``
and ``Bool`` are exact: int32, float32 (bit-cast), int32 and bool.
"""

from __future__ import annotations

import numpy as np
import torch


class I32:
    """Marker annotation: 32-bit signed integer argument."""


class F32:
    """Marker annotation: 32-bit float argument (bitcast into an i32 lane)."""


class Bool:
    """Marker annotation: boolean argument."""


class U32:
    """Marker annotation: 32-bit unsigned integer (bit-reinterpreted into
    the i32 message word; behaviours receive an int64 tensor holding the
    unsigned value — see the module docstring)."""


class I16:
    """Marker annotation: 16-bit signed integer (wraps to i16 range)."""


class U16:
    """Marker annotation: 16-bit unsigned integer (an int32 tensor
    holding the zero-extended value inside a behaviour)."""


class I8:
    """Marker annotation: 8-bit signed integer (wraps to i8 range)."""


class U8:
    """Marker annotation: 8-bit unsigned integer."""


# marker -> (torch dtype a behaviour sees, numpy dtype of the wrapped
# value, mask applied when packing back into a word or None).
_NARROW = {U32: (torch.int64, np.uint32, 0xFFFFFFFF),
           I16: (torch.int16, np.int16, None),
           U16: (torch.int32, np.uint16, 0xFFFF),
           I8: (torch.int8, np.int8, None),
           U8: (torch.uint8, np.uint8, None)}


def narrow_np_map():
    """marker -> numpy scalar type of the declared width (host packing)."""
    return {m: v[1] for m, v in _NARROW.items()}


class _RefTo:
    """A typed actor-reference annotation: Ref[SomeActor] (≙ the
    reference type system's typed actor references; the sendability
    checker in api.Context.send enforces the wiring rule). `target` may
    be the actor class or its name (forward ref)."""

    __slots__ = ("target",)

    def __init__(self, target):
        self.target = target

    @property
    def target_name(self) -> str:
        t = self.target
        return t if isinstance(t, str) else t.__name__

    @property
    def __name__(self) -> str:
        return f"Ref[{self.target_name}]"

    def __repr__(self):
        return self.__name__


class Ref:
    """Marker annotation: actor reference (global actor id, i32).

    Bare `Ref` is untyped; `Ref[SomeActor]` is typed and send wiring is
    verified (see _RefTo)."""

    def __class_getitem__(cls, item):
        return _RefTo(item)


class TypeParam:
    """A type parameter for generic actor types (≙ the reference's formal
    type parameters; reify.c substitutes them at instantiation)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = str(name)

    @property
    def __name__(self) -> str:
        return self.name

    def __repr__(self):
        return f"TypeParam({self.name!r})"

    def __eq__(self, other):
        return isinstance(other, TypeParam) and other.name == self.name

    def __hash__(self):
        return hash(("TypeParam", self.name))


def substitute(spec, mapping):
    """Reification: replace TypeParams inside a spec."""
    if isinstance(spec, TypeParam):
        try:
            return mapping[spec]
        except KeyError:
            raise TypeError(
                f"unbound type parameter {spec.name!r}") from None
    if isinstance(spec, _RefTo) and isinstance(spec.target, TypeParam):
        got = mapping.get(spec.target)
        if got is None:
            raise TypeError(f"unbound type parameter "
                            f"{spec.target.name!r} in {spec!r}")
        if isinstance(got, _RefTo):
            return got
        if isinstance(got, str) or isinstance(got, type):
            return _RefTo(got)
        raise TypeError(
            f"Ref[{spec.target.name}] needs an actor type argument, "
            f"got {got!r}")
    return spec


def type_params_of(specs) -> tuple:
    """Ordered first-appearance TypeParams across an iterable of specs."""
    seen = []
    for spec in specs:
        p = None
        if isinstance(spec, TypeParam):
            p = spec
        elif isinstance(spec, _RefTo) and isinstance(spec.target, TypeParam):
            p = spec.target
        if p is not None and p not in seen:
            seen.append(p)
    return tuple(seen)


class _CapSpec:
    """Host-payload capability annotation — the six-cap lattice of the
    reference (src/libponyc/type/cap.c). Only {iso, val, tag} may cross
    an actor boundary (CAP_SEND, type/cap.c:90). The wire word is a
    handle (i32); the mode governs the trace-time move/alias checks."""

    __slots__ = ("mode",)

    _NAMES = {"iso": "Iso", "trn": "Trn", "ref": "Mut", "val": "Val",
              "box": "Box", "tag": "Tag"}

    def __init__(self, mode: str):
        self.mode = mode

    @property
    def __name__(self) -> str:
        return self._NAMES[self.mode]

    def __repr__(self):
        return self.__name__


Iso = _CapSpec("iso")
Trn = _CapSpec("trn")
Mut = _CapSpec("ref")
Val = _CapSpec("val")
Box = _CapSpec("box")
Tag = _CapSpec("tag")


class _BlobSpec(_CapSpec):
    """Device blob handle annotation (``Blob`` iso / ``BlobVal`` val):
    a message argument or field holding a handle into the device blob
    pool (api.BlobPoolView)."""

    @property
    def __name__(self) -> str:          # noqa: A003
        return "Blob" if self.mode == "iso" else "BlobVal"


Blob = _BlobSpec("iso")
BlobVal = _BlobSpec("val")


def is_blob(ann) -> bool:
    return isinstance(ann, _BlobSpec)


def is_blob_val(ann) -> bool:
    return isinstance(ann, _BlobSpec) and ann.mode == "val"


# Blob handle encoding: low bits = global pool slot, high bits = the
# slot's generation at alloc time (state.blob_gen, bumped per alloc). A
# handle whose generation mismatches its slot's current one is dead: a
# stale or forged reference to a recycled slot reads null instead of the
# new owner's words (wraps after 2^10 reuses of a slot). Works on ints,
# numpy and torch integers; -1 decodes to an out-of-range slot, so null
# handles stay invalid.
BLOB_GEN_SHIFT = 20          # pool addressing: shards*blob_slots < 2^20
BLOB_GEN_MASK = 0x3FF        # 10 generation bits


def blob_slot(h):
    return h & ((1 << BLOB_GEN_SHIFT) - 1)


def blob_gen_of(h):
    return (h >> BLOB_GEN_SHIFT) & BLOB_GEN_MASK


def blob_handle(slot, gen):
    return ((gen & BLOB_GEN_MASK) << BLOB_GEN_SHIFT) | slot


def null_word(ann) -> int:
    """The "no value" word for a spec: -1 for actor refs and blob
    handles (0 is a real id for both), 0 otherwise."""
    return -1 if (is_ref(ann) or is_blob(ann)) else 0


SENDABLE_CAPS = frozenset(("iso", "val", "tag"))


def cap_mode(ann):
    return ann.mode if isinstance(ann, _CapSpec) else None


def cap_sendable(mode) -> bool:
    return mode is None or mode in SENDABLE_CAPS


def cap_alias(mode):
    """The capability of an alias of a value (≙ cap_aliasing with
    TK_ALIASED, type/alias.c): iso aliases as tag, trn as box, everything
    else as itself."""
    return {"iso": "tag", "trn": "box"}.get(mode, mode)


def viewpoint(origin, field):
    """Viewpoint adaptation origin▷field (≙ cap_view_upper,
    type/cap.c:581-711): the capability a reader holding `origin` sees
    when reading a `field`-capped slot; None where the origin cannot read
    at all (a tag)."""
    if origin is None or field is None:
        return field
    if origin == "tag":
        return None
    if field == "tag":
        return "tag"
    if origin == "iso":
        return {"iso": "iso", "val": "val"}.get(field, "tag")
    if origin == "trn":
        return {"iso": "iso", "trn": "trn", "val": "val"}.get(field, "box")
    if origin == "ref":
        return field
    if origin == "val":
        return "val"
    if origin == "box":
        return {"iso": "tag", "val": "val"}.get(field, "box")
    raise ValueError(f"unknown capability mode {origin!r}")


def concrete_null_handle(a) -> bool:
    """True when `a` is a CONCRETE non-positive value — the 'no handle'
    sentinels, exempt from the iso-move discipline."""
    if isinstance(a, torch.Tensor):
        return False
    try:
        return int(a) <= 0
    except Exception:                     # noqa: BLE001 — arrays etc.
        return False


# The store lattice (≙ is_cap_sub_cap, type/cap.c:59-160).
_CAP_STORE_OK = {
    "iso": {"iso", "trn", "ref", "val", "box", "tag"},
    "trn": {"trn", "ref", "val", "box", "tag"},
    "ref": {"ref", "box", "tag"},
    "val": {"val", "box", "tag"},
    "box": {"box", "tag"},
    "tag": {"tag"},
}

CONSUMING_DSTS = frozenset(("iso", "trn", "ref", "val"))


def cap_store_ok(src_mode, dst_mode) -> bool:
    if src_mode is None or dst_mode is None:
        return True
    return dst_mode in _CAP_STORE_OK[src_mode]


class CapMoves:
    """Iso-move discipline over one behaviour evaluation, keyed by the
    identity of the moved tensor (≙ the consume/alias analysis of
    type/alias.c + safeto.c)."""

    __slots__ = ("_moved",)

    def __init__(self):
        self._moved = {}

    def move(self, obj, where: str):
        ent = self._moved.get(id(obj))
        if ent is not None:
            raise TypeError(
                f"capability: iso payload moved twice (aliased move) — "
                f"first by {ent[1]}, again by {where}; an iso is "
                "moved-unique (send it once, or box it Val for sharing)")
        self._moved[id(obj)] = (obj, where)

    def was_moved(self, obj):
        ent = self._moved.get(id(obj))
        return ent[1] if ent is not None else None


class _VecSpec:
    """A fixed-width vector argument: VecF32[k] / VecI32[k] — k
    consecutive int32 words; behaviours receive a [k, lanes] block."""

    __slots__ = ("base", "n")

    def __init__(self, base, n: int):
        self.base = base
        self.n = int(n)
        if self.n < 1:
            raise TypeError("vector width must be >= 1")

    @property
    def __name__(self) -> str:
        return f"Vec{self.base.__name__}[{self.n}]"

    def __repr__(self):
        return self.__name__


class VecF32:
    def __class_getitem__(cls, n):
        return _VecSpec(F32, n)


class VecI32:
    def __class_getitem__(cls, n):
        return _VecSpec(I32, n)


def spec_width(ann) -> int:
    """Payload words an argument occupies."""
    return ann.n if isinstance(ann, _VecSpec) else 1


def is_ref(ann) -> bool:
    return ann is Ref or isinstance(ann, _RefTo)


def ref_target(ann):
    return ann.target_name if isinstance(ann, _RefTo) else None


class RefTypes:
    """Provenance map: tensor object → declared ref type. Typed refs stay
    plain int32 tensors; the type tag rides on the tensor's identity, so
    a directly forwarded field or argument keeps its type and any derived
    value is untyped again (gradual checking). Entries hold a strong
    reference so an id cannot be recycled during one evaluation."""

    __slots__ = ("_m",)

    def __init__(self):
        self._m = {}

    def tag(self, obj, target_name):
        if target_name is not None:
            self._m[id(obj)] = (obj, target_name)
        return obj

    def lookup(self, obj):
        ent = self._m.get(id(obj))
        return ent[1] if ent is not None else None


class CapTypes(RefTypes):
    """Capability provenance map (same identity-keyed mechanics)."""


_MARKERS = (I32, F32, Bool, Ref, U32, I16, U16, I8, U8)


def normalize_annotation(ann):
    """Map a user annotation to a marker class (or typed-ref / vector /
    capability instance)."""
    if isinstance(ann, (_RefTo, _VecSpec, _CapSpec, TypeParam)):
        return ann
    if isinstance(ann, str) and ann in ("Iso", "Trn", "Mut", "Val",
                                        "Box", "Tag", "Blob", "BlobVal"):
        return {"Iso": Iso, "Trn": Trn, "Mut": Mut, "Val": Val,
                "Box": Box, "Tag": Tag, "Blob": Blob,
                "BlobVal": BlobVal}[ann]
    if ann in _MARKERS:
        return ann
    if isinstance(ann, str) and ann.endswith("]"):
        for prefix, base in (("VecF32[", F32), ("VecI32[", I32)):
            if ann.startswith(prefix):
                try:
                    n = int(ann[len(prefix):-1])
                except ValueError:
                    break
                return _VecSpec(base, n)
    if ann in (int, torch.int32, "int", "I32", "i32"):
        return I32
    if ann in (float, torch.float32, "float", "F32", "f32"):
        return F32
    if ann in (bool, torch.bool, "bool", "Bool"):
        return Bool
    narrow_alias = {"U32": U32, "u32": U32, "I16": I16, "i16": I16,
                    torch.int16: I16, "U16": U16, "u16": U16,
                    "I8": I8, "i8": I8, torch.int8: I8,
                    "U8": U8, "u8": U8, torch.uint8: U8}
    try:
        if ann in narrow_alias:
            return narrow_alias[ann]
    except TypeError:
        pass
    if ann in ("Ref", "ActorRef"):
        return Ref
    if isinstance(ann, str) and ann.startswith("Ref[") and ann.endswith("]"):
        return _RefTo(ann[4:-1].strip().strip("'\""))
    raise TypeError(f"unsupported behaviour argument annotation: {ann!r}")


def _tensor(value, dtype, device):
    """`value` as a tensor of `dtype` on `device`. Python and numpy
    scalars become a device-side fill (no host-to-device copy)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    if isinstance(value, np.ndarray) and value.ndim == 0:
        value = value.item()
    if isinstance(value, (bool, int, float, np.generic)):
        return torch.full((), value, dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(value), device=device).to(dtype)


def pack_arg(ann, value, device=None):
    """Encode one argument into an int32 word (a 0-dim or [lanes] tensor)."""
    if ann is F32:
        return _tensor(value, torch.float32, device).view(torch.int32)
    if ann is Bool:
        return _tensor(value, torch.bool, device).to(torch.int32)
    if ann in _NARROW:
        tdt, npdt, mask = _NARROW[ann]
        if not isinstance(value, torch.Tensor):
            # Out-of-range constants wrap to the declared width.
            value = np.asarray(value, np.int64).astype(npdt).astype(
                np.int64)
        v = _tensor(value, torch.int64, device)
        if mask is not None:
            v = v & mask
        else:
            v = v.to(tdt)
        return v.to(torch.int32)
    return _tensor(value, torch.int32, device)


def unpack_arg(ann, word):
    """Decode one int32 word back to its annotated type."""
    if ann is F32:
        return word.view(torch.float32)
    if ann is Bool:
        return word.to(torch.bool)
    if ann in _NARROW:
        tdt, _npdt, mask = _NARROW[ann]
        if mask is not None:
            return word.to(torch.int64).bitwise_and(mask).to(tdt)
        return word.to(tdt)
    return word


def pack_args(specs, values, msg_words, device=None):
    """Pack positional args into a [msg_words] (or planar
    [msg_words, R]) int32 tensor, zero padded. Args may mix constants
    with [R]-lane tensors; vector args contribute their k words as a
    block; everything broadcasts to a common lane shape before
    concatenating on the (small, major) word axis."""
    if len(values) != len(specs):
        raise TypeError(f"behaviour takes {len(specs)} args, got {len(values)}")
    total = sum(spec_width(a) for a in specs)
    if total > msg_words:
        raise TypeError(
            f"behaviour needs {total} payload words but msg_words="
            f"{msg_words}; raise RuntimeOptions.msg_words")
    parts = []
    for a, v in zip(specs, values):
        if isinstance(a, _VecSpec):
            dt = torch.float32 if a.base is F32 else torch.int32
            arr = _tensor(v, dt, device)
            if arr.ndim == 0 or arr.shape[0] != a.n:
                raise TypeError(
                    f"argument for {a.__name__} must have leading dim "
                    f"{a.n}, got shape {tuple(arr.shape)}")
            parts.append(arr.view(torch.int32) if a.base is F32
                         else arr.to(torch.int32))
        else:
            w = pack_arg(a, v, device)
            parts.append(w.reshape((1,) + tuple(w.shape)))
    lanes = (tuple(torch.broadcast_shapes(*(p.shape[1:] for p in parts)))
             if parts else ())
    parts = [p.reshape(p.shape[:1] + (1,) * (len(lanes) - (p.ndim - 1))
                       + p.shape[1:]).expand(p.shape[:1] + lanes)
             for p in parts]
    if total < msg_words:
        parts.append(torch.zeros((msg_words - total,) + lanes,
                                 dtype=torch.int32, device=device))
    return torch.cat(parts, dim=0)


def unpack_args(specs, words):
    """Inverse of pack_args; one tensor per spec ([k, ...lanes] blocks
    for vector specs)."""
    out = []
    off = 0
    for a in specs:
        if isinstance(a, _VecSpec):
            blk = words[off:off + a.n]
            out.append(blk.view(torch.float32) if a.base is F32 else blk)
            off += a.n
        else:
            out.append(unpack_arg(a, words[off]))
            off += 1
    return tuple(out)

"""Selective object-graph serialisation — the `packages/serialise`
surface over single host-object graphs.

≙ the reference's pony_serialise/pony_deserialise
(src/libponyrt/gc/serialise.c:33-47): trace ONE object graph into a
flat offset-encoded buffer (an object map de-duplicates shared
sub-objects and breaks cycles — serialise.c's `ponyint_serialise_object`
table), and reconstruct it elsewhere. The stdlib surface mirrors
`packages/serialise/serialise.pony`: capability tokens gate the
operations (`SerialiseAuth` / `DeserialiseAuth` / `OutputSerialisedAuth`
≙ the auth values minted from AmbientAuth), `Serialised` is the carrier.

The graph walker honours HOST-HEAP references: a `HandleRef(h)` inside
the graph pulls the referenced HostHeap object into the buffer —
capability-aware (hostmem.py):

- iso handles are CONSUMED into the buffer (the move rides the
  serialisation, exactly like an iso send);
- val handles are peeked and copied (shared-immutable);
- tag handles refuse (opaque addresses have no readable content).

Deserialisation re-boxes embedded handle targets as FRESH iso handles.
The world-checkpoint subsystem (ponyc_tpu_torch/serialise.py) snapshots the
entire runtime; this module is its selective, per-message sibling — the
IPC/payload use case the reference built serialise.c for.

Format: a record table, each record one object, references by record
index (offset-encoding). NOT pickle: only the closed set of types below
deserialises, so a hostile buffer can name no arbitrary classes.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional

from ..hostmem import CapabilityError, HostHeap

FORMAT_VERSION = 1
MAGIC = b"PTSG"          # Pony-Tpu Serialised Graph


class SerialiseAuth:
    """Capability token for serialisation (≙ SerialiseAuth,
    packages/serialise/serialise.pony — minted from AmbientAuth; here
    constructing it IS the ambient grant, the same trust model as the
    stdlib's capsicum rights)."""


class DeserialiseAuth:
    """Capability token for deserialisation."""


class OutputSerialisedAuth:
    """Capability token for extracting the raw bytes."""


class HandleRef:
    """A reference to a HostHeap object embedded in a serialisable
    graph (≙ a traced pointer field; serialise.c follows it via the
    per-type trace fn)."""

    __slots__ = ("handle",)

    def __init__(self, handle: int):
        self.handle = int(handle)

    def __repr__(self):
        return f"HandleRef({self.handle})"

    def __eq__(self, other):
        return isinstance(other, HandleRef) and other.handle == self.handle

    def __hash__(self):
        return hash(("HandleRef", self.handle))


class SerialiseError(TypeError):
    """Graph contains an unserialisable object (≙ serialise.c aborting
    on a type without serialise hooks)."""


# Record type tags (closed set — deserialisation can only ever build
# these, never arbitrary classes).
_T_NONE, _T_BOOL, _T_INT, _T_FLOAT, _T_STR, _T_BYTES = range(6)
_T_LIST, _T_TUPLE, _T_DICT, _T_SET, _T_HANDLE = range(6, 11)


class Serialised:
    """A serialised object graph (≙ the Serialised class of
    packages/serialise): create from a live graph, output bytes, or
    apply to get a fresh copy back."""

    def __init__(self, auth: SerialiseAuth, obj: Any,
                 heap: Optional[HostHeap] = None):
        if not isinstance(auth, SerialiseAuth):
            raise TypeError("serialise requires a SerialiseAuth token")
        self._records: List[Any] = []
        self._index: Dict[int, int] = {}   # id(obj) → record idx
        self._keep: List[Any] = []         # pin ids during the walk
        self._heap = heap
        self._consume: List[int] = []      # iso handles to move on success
        self._walk(obj)
        # Iso moves COMMIT only after the whole walk succeeded: a failed
        # serialisation must leave the caller's heap untouched (peek
        # during the walk, consume at the end).
        for h in self._consume:
            heap.unbox(h)
        self._bytes: Optional[bytes] = None

    # ---- construction from bytes (receiver side) ----
    @classmethod
    def from_bytes(cls, data: bytes) -> "Serialised":
        self = cls.__new__(cls)
        if data[:4] != MAGIC:
            raise SerialiseError("not a serialised graph (bad magic)")
        ver, n = struct.unpack_from("<II", data, 4)
        if ver != FORMAT_VERSION:
            raise SerialiseError(f"format {ver} != {FORMAT_VERSION}")
        try:
            records = json.loads(data[12:].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise SerialiseError(f"corrupt graph buffer: {e}") from None
        if not isinstance(records, list) or len(records) != n:
            raise SerialiseError("corrupt graph buffer: record count")
        self._records = records
        self._index = {}
        self._keep = []
        self._heap = None
        self._bytes = bytes(data)
        return self

    # ---- the graph walk (≙ ponyint_serialise_object, serialise.c) ----
    def _walk(self, obj: Any) -> int:
        # De-dup shared sub-objects AND break cycles: the record index
        # is reserved before children are walked (serialise.c reserves
        # the offset in its object map the same way).
        key = id(obj)
        if key in self._index and not isinstance(
                obj, (int, float, bool, str, bytes, type(None))):
            return self._index[key]
        idx = len(self._records)
        self._records.append(None)        # reserve
        if not isinstance(obj, (int, float, bool, str, bytes, type(None))):
            self._index[key] = idx
            self._keep.append(obj)        # pin so id() stays unique
        if obj is None:
            rec = [_T_NONE]
        elif isinstance(obj, bool):
            rec = [_T_BOOL, int(obj)]
        elif isinstance(obj, int):
            rec = [_T_INT, str(obj)]      # arbitrary precision via str
        elif isinstance(obj, float):
            rec = [_T_FLOAT, struct.pack("<d", obj).hex()]
        elif isinstance(obj, str):
            rec = [_T_STR, obj]
        elif isinstance(obj, bytes):
            rec = [_T_BYTES, obj.hex()]
        elif isinstance(obj, list):
            rec = [_T_LIST, [self._walk(x) for x in obj]]
        elif isinstance(obj, tuple):
            rec = [_T_TUPLE, [self._walk(x) for x in obj]]
        elif isinstance(obj, set):
            rec = [_T_SET, [self._walk(x) for x in sorted(
                obj, key=repr)]]
        elif isinstance(obj, dict):
            items = []
            for k, v in obj.items():
                items.append([self._walk(k), self._walk(v)])
            rec = [_T_DICT, items]
        elif isinstance(obj, HandleRef):
            # ≙ following a traced pointer into another actor's heap:
            # pull the referenced object INTO the buffer, honouring its
            # capability (hostmem.py).
            if self._heap is None:
                raise SerialiseError(
                    "graph contains HandleRef but no heap was given")
            mode = self._heap.mode(obj.handle)
            if mode == "tag":
                raise CapabilityError(
                    f"capability: handle {obj.handle} is tag (opaque) — "
                    "its content cannot be serialised")
            if mode == "iso":
                # Two HandleRefs to one iso in a single graph alias a
                # moved value — exactly what iso forbids.
                if obj.handle in self._consume:
                    raise CapabilityError(
                        f"capability: aliased move — iso handle "
                        f"{obj.handle} is referenced twice in one graph")
                self._consume.append(obj.handle)
            target = self._heap.peek(obj.handle)   # move commits at end
            rec = [_T_HANDLE, self._walk(target)]
        else:
            raise SerialiseError(
                f"unserialisable object in graph: {type(obj).__name__} "
                "(supported: None/bool/int/float/str/bytes/list/tuple/"
                "set/dict/HandleRef)")
        self._records[idx] = rec
        return idx

    # ---- output (≙ Serialised.output, OutputSerialisedAuth) ----
    def output(self, auth: OutputSerialisedAuth) -> bytes:
        if not isinstance(auth, OutputSerialisedAuth):
            raise TypeError("output requires an OutputSerialisedAuth token")
        if self._bytes is None:
            body = json.dumps(self._records,
                              separators=(",", ":")).encode("utf-8")
            self._bytes = MAGIC + struct.pack(
                "<II", FORMAT_VERSION, len(self._records)) + body
        return self._bytes

    # ---- apply (≙ Serialised.apply, DeserialiseAuth) ----
    def apply(self, auth: DeserialiseAuth,
              heap: Optional[HostHeap] = None) -> Any:
        if not isinstance(auth, DeserialiseAuth):
            raise TypeError("apply requires a DeserialiseAuth token")
        if not self._records:
            raise SerialiseError("empty graph")
        built: Dict[int, Any] = {}

        def build(idx: int) -> Any:
            if idx in built:
                return built[idx]
            rec = self._records[idx]
            t = rec[0]
            if t == _T_NONE:
                val = None
            elif t == _T_BOOL:
                val = bool(rec[1])
            elif t == _T_INT:
                val = int(rec[1])
            elif t == _T_FLOAT:
                val = struct.unpack("<d", bytes.fromhex(rec[1]))[0]
            elif t == _T_STR:
                val = rec[1]
            elif t == _T_BYTES:
                val = bytes.fromhex(rec[1])
            elif t == _T_LIST:
                val = []
                built[idx] = val          # pre-register: cycles resolve
                val.extend(build(i) for i in rec[1])
                return val
            elif t == _T_TUPLE:
                val = tuple(build(i) for i in rec[1])
            elif t == _T_SET:
                val = {build(i) for i in rec[1]}
            elif t == _T_DICT:
                val = {}
                built[idx] = val
                for k_i, v_i in rec[1]:
                    val[build(k_i)] = build(v_i)
                return val
            elif t == _T_HANDLE:
                if heap is None:
                    raise SerialiseError(
                        "graph contains a handle target but no heap was "
                        "given to re-box it")
                val = HandleRef(heap.box(build(rec[1])))   # fresh iso
            else:
                raise SerialiseError(f"unknown record tag {t}")
            built[idx] = val
            return val

        return build(0)


def serialise_to_handle(auth: SerialiseAuth, obj: Any,
                        heap: HostHeap) -> int:
    """One-call helper for the payload use case: serialise `obj` and box
    the bytes as a fresh iso handle, ready to ride an ``Iso`` message
    parameter."""
    data = Serialised(auth, obj, heap=heap).output(OutputSerialisedAuth())
    return heap.box(data)


def deserialise_from_handle(auth: DeserialiseAuth, handle: int,
                            heap: HostHeap) -> Any:
    """Receiver-side twin: unbox the bytes handle (consuming it) and
    rebuild the graph."""
    data = heap.unbox(handle)
    if not isinstance(data, (bytes, bytearray)):
        raise SerialiseError("handle does not hold serialised bytes")
    return Serialised.from_bytes(bytes(data)).apply(auth, heap=heap)

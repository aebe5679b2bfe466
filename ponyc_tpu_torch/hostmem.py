"""Host object heap: rich payloads referenced from int32 messages (a copy
of ``ponyc_tpu/hostmem.py``, which imports no JAX; the port keeps its own
so that it never imports the JAX package).

≙ the reference's per-actor heaps + ORCA ownership transfer for message
payloads (src/libponyrt/mem/heap.c; gc/gc.c send/recv object handlers):
a Pony message carries a *pointer* into some actor's heap and ORCA moves
the reference count with it. Device mailboxes here are fixed int32 words,
so host-side objects (socket buffers, strings, arbitrary Python values)
live in this handle table and messages carry the handle.

Handles carry a REFERENCE CAPABILITY (≙ src/libponyc/type/cap.c:1,
safeto.c:1 — the qualifiers that make a payload sendable):

- ``iso`` (default, ``box``): moved-unique. `unbox` consumes the handle
  (≙ Pony's `consume` on an iso send — the sender provably loses
  access, so no GC protocol is needed at all). Sending it through an
  ``Iso``-annotated parameter marks it in-flight: peek/unbox before the
  receiver takes delivery is use-after-send, and a second send is an
  aliased move — both raise. Delivery to a HOST actor completes the
  move (receive()); a handle sent into the DEVICE world stays
  in-flight for the host until some device actor forwards it back to a
  host receiver — the host gave it away, which is exactly the
  discipline.
- ``val`` (``box_val``): shared-immutable. Anyone may `peek`; `unbox`
  (taking ownership) is rejected; aliasing is free. Collected by the
  tracing GC when unreachable.
- ``tag`` (``box_tag``): opaque address. Identity/forwarding only —
  both `peek` and `unbox` are rejected.

Accounting mirrors the reference's USE_MEMTRACK counters
(scheduler.h:52-66): boxed/unboxed/live and peak-live are queryable.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Set

from .errors import ERROR_CODES


class CapabilityError(TypeError):
    """A handle was used against its capability mode (≙ the compile
    errors cap.c/safeto.c raise; dynamic here because host code is
    Python)."""

    code = ERROR_CODES["CapabilityError"]


class HandleRef:
    """An explicit in-object reference to another heap handle.

    Host objects are arbitrary Python values, so a slot holding a plain
    int is AMBIGUOUS — it may be data or may happen to equal a live
    handle id. peek_field() therefore only follows slots that are
    explicitly HandleRef-wrapped (≙ the reference knowing statically
    which fields are object references — gentrace.c's per-type trace
    fns); everything else reads as plain data."""

    __slots__ = ("handle",)

    def __init__(self, handle: int):
        self.handle = int(handle)

    def __repr__(self):
        return f"HandleRef({self.handle})"

    def __eq__(self, other):
        return isinstance(other, HandleRef) and other.handle == self.handle

    def __hash__(self):
        return hash(("HandleRef", self.handle))


class HostHeap:
    """Handle table with per-handle capability modes — all six of the
    reference's caps (iso/trn/ref/val/box/tag; src/libponyc/type/cap.c).
    The local-only caps (trn/ref ≙ ``Mut``/box) never ride messages
    (sendability is enforced at behaviour declaration, api.py) but
    govern host-side reads/writes/aliases:

    - read (`peek`): every mode but tag;
    - write (`poke`): iso, trn, ref — the write-rights caps;
    - take ownership (`unbox`): iso, trn (consume); ref is refused
      because unknown ref aliases may exist (ref is freely aliasable);
    - alias (`view`): a new handle to the same object at a mode covered
      by the ALIAS of the source's mode (alias.c: iso aliases as tag,
      trn as box) — e.g. box views of a trn, tag views of anything;
    - viewpoint-composed field read (`peek_field`): reading a slot of a
      host object through an origin handle re-caps the result with
      origin▷field (cap_view_upper, type/cap.c:581-711);
    - `freeze` (≙ consume-to-val) and `recover_iso` (≙ recover block)
      move along the lattice where the table can prove it safe.

    Handles are positive int32s; 0/-1 never issued (they collide with the
    framework's "empty word" / "no ref" conventions)."""

    _READABLE = ("iso", "trn", "ref", "val", "box")
    _WRITABLE = ("iso", "trn", "ref")

    def __init__(self):
        self._objs: Dict[int, Any] = {}
        self._sizes: Dict[int, int] = {}
        self._modes: Dict[int, str] = {}
        self._in_flight: Set[int] = set()
        self._root: Dict[int, int] = {}      # view handle → root handle
        self._views: Dict[int, Set[int]] = {}  # root → live view handles
        self._next = 1
        self.boxed = 0
        self.unboxed = 0
        self.peak_live = 0
        # Growth accounting (≙ the per-actor heap's used/next_gc fields,
        # mem/heap.c:603-806): the runtime's run loop triggers an early
        # collection when bytes_since_gc outgrows its threshold
        # (RuntimeOptions.gc_initial / gc_factor), exactly the
        # growth-triggered cadence of the reference. Sizes are shallow
        # (sys.getsizeof) — an accounting signal, not an allocator.
        self.bytes_live = 0
        self.bytes_since_gc = 0

    _MISSING = object()

    @staticmethod
    def _approx_size(obj: Any) -> int:
        try:
            return max(1, sys.getsizeof(obj))
        except TypeError:
            return 64

    def box(self, obj: Any, mode: str = "iso") -> int:
        if mode not in ("iso", "trn", "ref", "val", "box", "tag"):
            raise ValueError(f"unknown capability mode {mode!r}")
        h = self._next
        self._next += 1
        if self._next >= 2**31:         # wrap, skipping live handles
            self._next = 1
        while self._next in self._objs:
            self._next += 1
        self._objs[h] = obj
        self._modes[h] = mode
        sz = self._approx_size(obj)
        self._sizes[h] = sz
        self.bytes_live += sz
        self.bytes_since_gc += sz
        self.boxed += 1
        self.peak_live = max(self.peak_live, len(self._objs))
        return h

    def box_val(self, obj: Any) -> int:
        """Box as shared-immutable (≙ val)."""
        return self.box(obj, mode="val")

    def box_tag(self, obj: Any) -> int:
        """Box as opaque address (≙ tag)."""
        return self.box(obj, mode="tag")

    def mode(self, handle: int) -> str:
        return self._modes[int(handle)]

    def unbox(self, handle: int) -> Any:
        """Take ownership (the handle dies; ≙ consume). KeyError on
        double-take — the dynamic cousin of Pony rejecting
        use-after-send of an iso. Only the ownership-unique modes can
        be unboxed: iso and trn. ref is freely aliasable so unknown
        aliases may exist; val is shared-immutable (peek); box is a
        borrowed view; tag is opaque. Live read-views of a consumed
        trn stay readable (Pony: consume moves the owner, outstanding
        box aliases still see the object)."""
        h = int(handle)
        m = self._modes.get(h)
        if m == "val":
            raise CapabilityError(
                f"capability: handle {h} is val (shared-immutable) — "
                "peek it; ownership never moves")
        if m == "tag":
            raise CapabilityError(
                f"capability: handle {h} is tag (opaque address) — "
                "it cannot be read or unboxed")
        if m in ("ref", "box"):
            raise CapabilityError(
                f"capability: handle {h} is {m} — a freely-aliased "
                "local cap cannot be consumed (unknown aliases may "
                "exist); recover_iso() first if it is unaliased")
        if h in self._in_flight:
            raise CapabilityError(
                f"capability: use-after-send — iso handle {h} is in "
                "flight to its receiver")
        obj = self._objs.pop(h)
        self._modes.pop(h, None)
        self._unlink_view(h)
        self.bytes_live -= self._sizes.pop(h, 0)
        self.unboxed += 1
        return obj

    def _unlink_view(self, h: int) -> None:
        root = self._root.pop(h, None)
        if root is not None:
            self._views.get(root, set()).discard(h)

    def poke(self, handle: int, obj: Any) -> None:
        """Checked WRITE: replace the handle's object. Allowed only for
        the write-rights caps (iso/trn/ref — ≙ cap_send/write columns of
        cap.c); val/box/tag refuse. The one-writer property of trn holds
        structurally: box views carry no poke rights."""
        h = int(handle)
        m = self._modes.get(h)
        if h not in self._objs:
            raise KeyError(f"handle {h} does not exist")
        if m not in self._WRITABLE:
            raise CapabilityError(
                f"capability: handle {h} is {m} — no write rights "
                "(only iso/trn/ref may poke)")
        if h in self._in_flight:
            raise CapabilityError(
                f"capability: use-after-send — handle {h} is in flight")
        # Writes through ANY writable alias land on the shared object:
        # resolve to the root and re-point the root plus every live view
        # (a view handle's own entry would otherwise silently diverge
        # from its siblings). Bytes are accounted on the root only.
        root = self._root.get(h, h)
        if root in self._objs:       # root may have been consumed; never
            self._objs[root] = obj   # resurrect it — views carry on alone
            sz = self._approx_size(obj)
            self.bytes_live += sz - self._sizes.get(root, 0)
            self.bytes_since_gc += sz
            self._sizes[root] = sz
        for v in self._views.get(root, ()):
            self._objs[v] = obj
        self._objs[h] = obj          # h is the root or one of its views

    def view(self, handle: int, mode: str = "box") -> int:
        """Create an ALIAS handle of the same object at `mode`. Legal
        when `mode` is covered by the alias of the source's cap
        (alias.c: alias(iso)=tag, alias(trn)=box, else itself) — e.g.
        box views of trn/ref, val views of val, tag views of anything
        readable. The view is a separate handle; dropping it never
        frees the object."""
        from .ops import pack
        h = int(handle)
        if h not in self._objs:
            raise KeyError(f"handle {h} does not exist")
        if h in self._in_flight:
            raise CapabilityError(
                f"capability: use-after-send — handle {h} is in flight")
        src = self._modes.get(h)
        aliased = pack.cap_alias(src)
        if not pack.cap_store_ok(aliased, mode):
            raise CapabilityError(
                f"capability: a {src} handle aliases as {aliased} "
                f"(alias.c) — it cannot be viewed as {mode}")
        return self._register_view(h, mode)

    def _register_view(self, h: int, mode: str) -> int:
        """Mint a view handle of `h`'s object at `mode`, linked to the
        root for alias tracking; views share the object's bytes."""
        v = self.box(self._objs[h], mode=mode)
        root = self._root.get(h, h)
        self._root[v] = root
        self._views.setdefault(root, set()).add(v)
        self.bytes_live -= self._sizes[v]
        self.bytes_since_gc -= self._sizes[v]
        self._sizes[v] = 0
        return v

    def peek_field(self, origin: int, key: Any):
        """Viewpoint-composed field read (≙ cap_view_upper,
        type/cap.c:581-711): read slot `key` of the object behind
        `origin` (mapping key or attribute). If the slot holds an
        explicit `HandleRef`, the result is a VIEW of that handle
        re-capped origin▷field; a composition with no read rights (tag
        origin) refuses. Every other value — including a plain int that
        happens to equal a live handle id — returns as data; reading it
        only needs the origin to be readable at all."""
        from .ops import pack
        o = int(origin)
        om = self._modes.get(o)
        if o not in self._objs:
            raise KeyError(f"handle {o} does not exist")
        if om == "tag":
            raise CapabilityError(
                f"capability: origin handle {o} is tag — cannot read "
                "fields through a tag (cap_view_upper, cap.c:588-596)")
        if o in self._in_flight:
            raise CapabilityError(
                f"capability: use-after-send — handle {o} is in flight")
        obj = self._objs[o]
        try:
            value = obj[key]
        except (TypeError, KeyError, IndexError):
            value = getattr(obj, key)
        if not isinstance(value, HandleRef):
            return value
        fh = value.handle
        if fh not in self._objs:
            raise KeyError(f"field {key!r} references dead handle {fh}")
        fm = self._modes.get(fh)
        seen = pack.viewpoint(om, fm)
        if seen is None:
            raise CapabilityError(
                f"capability: {om}▷{fm} is unreadable (cap_view_upper)")
        # A field READ binds an ALIAS of the viewpoint-adapted cap
        # (Pony: `x = obj.f` has type alias(origin▷field), alias.c) —
        # never a second owner: iso▷iso reads as tag, trn▷trn as box.
        # Consuming a field's unique value is a store/take, not a peek.
        return self._register_view(fh, pack.cap_alias(seen))

    def freeze(self, handle: int) -> int:
        """Consume to val (≙ `consume x` into a val — trn→val is Pony's
        freeze; iso→val the sendable downgrade). ref freezes only when
        the table has issued no live views of it (the dynamic stand-in
        for recover's no-aliases proof). Returns the same handle,
        re-capped val; existing read-views stay valid."""
        h = int(handle)
        m = self._modes.get(h)
        if h not in self._objs:
            raise KeyError(f"handle {h} does not exist")
        if h in self._in_flight:
            raise CapabilityError(
                f"capability: use-after-send — handle {h} is in flight")
        if m in ("val",):
            return h
        if m in ("box", "tag"):
            raise CapabilityError(
                f"capability: handle {h} is {m} — a borrowed view/"
                "address cannot be frozen (no ownership)")
        if m == "ref" and self._views.get(self._root.get(h, h)):
            raise CapabilityError(
                f"capability: ref handle {h} has live views — freeze "
                "needs an unaliased original (≙ recover)")
        self._modes[h] = "val"
        return h

    def recover_iso(self, handle: int) -> int:
        """Lift to iso (≙ a recover block's cap lift): legal for trn/ref
        with no live views (the table's proof of unaliasedness); iso is
        a no-op. val/box/tag refuse — shared or borrowed rights can
        never become unique again."""
        h = int(handle)
        m = self._modes.get(h)
        if h not in self._objs:
            raise KeyError(f"handle {h} does not exist")
        if h in self._in_flight:
            raise CapabilityError(
                f"capability: use-after-send — handle {h} is in flight")
        if m == "iso":
            return h
        if m not in ("trn", "ref"):
            raise CapabilityError(
                f"capability: handle {h} is {m} — only trn/ref lift to "
                "iso under recover (cap.c ephemeral lifts)")
        if self._views.get(self._root.get(h, h)):
            raise CapabilityError(
                f"capability: handle {h} has live views — recover needs "
                "an unaliased original")
        self._modes[h] = "iso"
        return h

    def peek(self, handle: int) -> Any:
        h = int(handle)
        m = self._modes.get(h)
        if m == "tag" and h in self._objs:
            raise CapabilityError(
                f"capability: handle {h} is tag (opaque address) — "
                "identity only, no reads")
        if h in self._in_flight:
            raise CapabilityError(
                f"capability: use-after-send — iso handle {h} is in "
                "flight to its receiver")
        return self._objs[h]

    def send_iso(self, handle: int) -> None:
        """Mark an iso handle in flight (called by the runtime when a
        handle rides an ``Iso``-annotated message parameter). A second
        send of an in-flight handle is an aliased move."""
        h = int(handle)
        if h not in self._objs:
            raise KeyError(
                f"capability: iso handle {h} does not exist (already "
                "moved or never boxed)")
        m = self._modes.get(h)
        if m != "iso":
            return                       # val/tag ride freely
        if h in self._in_flight:
            raise CapabilityError(
                f"capability: aliased move — iso handle {h} is already "
                "in flight; an iso is moved-unique (box_val to share)")
        self._in_flight.add(h)

    def receive(self, handle: int) -> None:
        """Delivery completed: the receiver may now peek/unbox."""
        self._in_flight.discard(int(handle))

    def drop(self, handle: int) -> None:
        h = int(handle)
        if self._objs.pop(h, HostHeap._MISSING) is not HostHeap._MISSING:
            self.bytes_live -= self._sizes.pop(h, 0)
            self._modes.pop(h, None)
            self._in_flight.discard(h)
            self._unlink_view(h)
            self.unboxed += 1

    @property
    def live(self) -> int:
        return len(self._objs)

    def stats(self) -> Dict[str, int]:
        return {"boxed": self.boxed, "unboxed": self.unboxed,
                "live": self.live, "peak_live": self.peak_live,
                "bytes_live": self.bytes_live,
                "bytes_since_gc": self.bytes_since_gc}

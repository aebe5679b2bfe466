"""Name resolution for net actors — ≙ the reference's DNS surface
(src/libponyrt/lang/socket.c pony_os_addrinfo/pony_os_nextaddr/
pony_os_nameinfo/pony_os_ip_string/pony_os_host_ip4/pony_os_host_ip6
+ packages/net/dns.pony).

Two shapes:

- ``DNS`` — the synchronous primitive, exactly like the reference
  (dns.pony performs a blocking getaddrinfo on the calling scheduler
  thread): resolve/ip4/ip6/nameinfo/is_ip4/is_ip6. The underlying
  call IS the same libc getaddrinfo the reference binds.
- ``Resolver`` — the async upgrade the reference lacks: resolution runs
  on a worker thread and the result arrives as an ACTOR MESSAGE at a
  poll boundary: owner's on_resolved(token, handle, n) with a
  HostHeap-boxed list of (family, ip, port) tuples; n = entry count,
  or a NEGATIVE resolver error (-abs(gaierror errno), or -1 for other
  failures) with an empty list. A slow DNS server can never stall the
  host loop.
"""

from __future__ import annotations

import socket as _socket
import threading
from typing import List, Optional, Tuple

from ..api import BehaviourDef

AddrList = List[Tuple[int, str, int]]     # (family: 4|6, ip, port)


class DNS:
    """Synchronous resolution (≙ packages/net DNS primitive)."""

    @staticmethod
    def resolve(host: str, port: int = 0, *,
                family: Optional[int] = None) -> AddrList:
        """All addresses for host:port (both families unless pinned) —
        ≙ DNS.apply / pony_os_addrinfo + the nextaddr iteration."""
        fam = (_socket.AF_INET if family == 4 else
               _socket.AF_INET6 if family == 6 else _socket.AF_UNSPEC)
        try:
            infos = _socket.getaddrinfo(host, port, fam,
                                        _socket.SOCK_STREAM)
        except _socket.gaierror:
            return []
        out: AddrList = []
        for af, _kind, _proto, _canon, sa in infos:
            out.append((4 if af == _socket.AF_INET else 6, sa[0], sa[1]))
        return out

    @staticmethod
    def ip4(host: str, port: int = 0) -> AddrList:
        """IPv4 only (≙ DNS.ip4 / pony_os_addrinfo with AF_INET)."""
        return DNS.resolve(host, port, family=4)

    @staticmethod
    def ip6(host: str, port: int = 0) -> AddrList:
        """IPv6 only (≙ DNS.ip6)."""
        return DNS.resolve(host, port, family=6)

    @staticmethod
    def is_ip4(host: str) -> bool:
        """≙ pony_os_host_ip4: is the string a literal v4 address?"""
        try:
            _socket.inet_pton(_socket.AF_INET, host)
            return True
        except OSError:
            return False

    @staticmethod
    def is_ip6(host: str) -> bool:
        """≙ pony_os_host_ip6."""
        try:
            _socket.inet_pton(_socket.AF_INET6, host)
            return True
        except OSError:
            return False

    @staticmethod
    def nameinfo(ip: str, port: int = 0) -> Optional[Tuple[str, str]]:
        """Reverse lookup: (host, service) or None (≙ pony_os_nameinfo)."""
        fam = _socket.AF_INET6 if DNS.is_ip6(ip) else _socket.AF_INET
        sa = (ip, port, 0, 0) if fam == _socket.AF_INET6 else (ip, port)
        try:
            return _socket.getnameinfo(sa, 0)
        except (OSError, _socket.gaierror):
            return None


class Resolver:
    """Asynchronous resolution delivering actor messages (register via
    ``rt.attach_resolver()``). One worker thread per in-flight lookup;
    results cross back at poll boundaries through the runtime's poller
    protocol (the same boundary every bridge event crosses)."""

    def __init__(self, rt):
        self.rt = rt
        self._lock = threading.Lock()
        self._ready = []          # (owner, bdef, token, addrs, n)
        rt.register_poller(self)

    def resolve(self, host: str, port: int, owner: int, *,
                on_resolved: BehaviourDef, token: int = 0,
                family: Optional[int] = None) -> None:
        """Kick off a lookup. The owner receives
        on_resolved(token, handle, n): handle boxes the (family, ip,
        port) list (iso — unbox it); n = entry count (0 = host exists
        but no addresses), or a negative resolver error.
        """
        if not isinstance(on_resolved, BehaviourDef) \
                or on_resolved.global_id is None:
            raise TypeError(
                "on_resolved must be a program-registered behaviour")
        if len(on_resolved.arg_specs) != 3:
            raise TypeError("on_resolved must take (token, handle, n)")
        if not on_resolved.actor_type.HOST:
            raise TypeError("on_resolved must live on a HOST actor "
                            "(the address list is a host object)")
        # Validate the target NOW — a bad owner must fail at the call
        # site, not inside a later poll() where it would drop queued
        # results.
        self.rt._check_send_target(int(owner), on_resolved)
        self.rt.add_noisy()        # a pending lookup keeps the world up

        def work():
            addrs: AddrList = []
            n = 0
            try:
                fam = (_socket.AF_INET if family == 4 else
                       _socket.AF_INET6 if family == 6 else
                       _socket.AF_UNSPEC)
                infos = _socket.getaddrinfo(host, port, fam,
                                            _socket.SOCK_STREAM)
                for af, _k, _p, _c, sa in infos:
                    addrs.append((4 if af == _socket.AF_INET else 6,
                                  sa[0], sa[1]))
                n = len(addrs)
            except _socket.gaierror as e:
                n = -abs(e.errno or 1)
            except Exception:                     # noqa: BLE001 —
                n = -1     # e.g. UnicodeError on overlong IDNA labels
            finally:
                # ALWAYS enqueue: a lost result would leak the noisy
                # hold and the runtime would never quiesce.
                with self._lock:
                    self._ready.append((owner, on_resolved, token,
                                        addrs, n))

        threading.Thread(target=work, daemon=True).start()

    # -- poller protocol (Runtime host boundary) --
    def poll(self, rt) -> int:
        with self._lock:
            ready, self._ready = self._ready, []
        for owner, bdef, token, addrs, n in ready:
            try:
                h = rt.heap.box(addrs)
                rt.send(owner, bdef, token, h, n)
            finally:
                rt.remove_noisy()
        return len(ready)

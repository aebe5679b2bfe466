// Non-blocking socket operations for host-resident network actors.
//
// Host-side counterpart of the reference's OS socket layer
// (src/libponyrt/lang/socket.c, 5112 LoC): listen/accept/connect for TCP
// (≙ pony_os_listen_tcp socket.c:693, pony_os_accept, pony_os_connect_tcp),
// scatter-free recv/send (≙ pony_os_recv/send), UDP sockets with
// sendto/recvfrom (≙ pony_os_listen_udp/sendto/recvfrom), socket options
// (nodelay/keepalive ≙ pony_os_nodelay/keepalive), and local/peer name
// introspection. All sockets are created O_NONBLOCK and are meant to be
// subscribed to the asio loop (asio.cc) — the same split the reference
// uses (socket fd ←→ ASIO event ←→ owning actor).
//
// Error convention: >= 0 success value, < 0 is -errno. EAGAIN/EWOULDBLOCK
// surface as -EAGAIN so callers can wait for the next readiness event.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <net/if.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <sys/un.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>

namespace {

int set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  if (fl < 0) return -errno;
  if (fcntl(fd, F_SETFL, fl | O_NONBLOCK) < 0) return -errno;
  return 0;
}

// Resolve host:port; tries each result until the operation succeeds.
// op: 0 = bind (listen/UDP), 1 = connect.
int resolve_and(int socktype, const char* host, int32_t port, int op,
                int backlog) {
  struct addrinfo hints;
  memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = socktype;
  hints.ai_flags = (op == 0) ? AI_PASSIVE : 0;
  char portstr[16];
  snprintf(portstr, sizeof(portstr), "%d", port);
  struct addrinfo* res = nullptr;
  int rc = getaddrinfo((host && host[0]) ? host : nullptr, portstr, &hints,
                       &res);
  if (rc != 0) return -EHOSTUNREACH;
  int last_err = -ECONNREFUSED;
  for (struct addrinfo* ai = res; ai != nullptr; ai = ai->ai_next) {
    int fd = socket(ai->ai_family, ai->ai_socktype | SOCK_CLOEXEC,
                    ai->ai_protocol);
    if (fd < 0) {
      last_err = -errno;
      continue;
    }
    int e = set_nonblock(fd);
    if (e < 0) {
      close(fd);
      last_err = e;
      continue;
    }
    if (op == 0) {
      int one = 1;
      setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
      if (bind(fd, ai->ai_addr, ai->ai_addrlen) != 0) {
        last_err = -errno;
        close(fd);
        continue;
      }
      if (socktype == SOCK_STREAM && listen(fd, backlog) != 0) {
        last_err = -errno;
        close(fd);
        continue;
      }
      freeaddrinfo(res);
      return fd;
    }
    // connect: in-progress is success for a non-blocking socket — the
    // asio write-readiness event signals completion (≙ the reference's
    // connect flow, socket.c pony_os_connect_tcp + ASIO_WRITE).
    if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0 ||
        errno == EINPROGRESS) {
      freeaddrinfo(res);
      return fd;
    }
    last_err = -errno;
    close(fd);
  }
  freeaddrinfo(res);
  return last_err;
}

}  // namespace

extern "C" {

// ≙ pony_os_listen_tcp (socket.c:693). Returns listening fd or -errno.
int32_t ponyx_os_listen_tcp(const char* host, int32_t port,
                            int32_t backlog) {
  return resolve_and(SOCK_STREAM, host, port, 0, backlog > 0 ? backlog : 64);
}

// ≙ pony_os_connect_tcp: non-blocking connect, completion via ASIO write
// event. Returns fd (connection may still be in progress) or -errno.
int32_t ponyx_os_connect_tcp(const char* host, int32_t port) {
  return resolve_and(SOCK_STREAM, host, port, 1, 0);
}

// ≙ pony_os_accept: returns new non-blocking connection fd, -EAGAIN when
// the backlog is drained, other -errno on error.
int32_t ponyx_os_accept(int32_t listen_fd) {
  int fd = accept4(listen_fd, nullptr, nullptr,
                   SOCK_NONBLOCK | SOCK_CLOEXEC);
  if (fd < 0) {
    int e = errno;
    return (e == EAGAIN || e == EWOULDBLOCK) ? -EAGAIN : -e;
  }
  return fd;
}

// Did a non-blocking connect finish successfully? 0 yes, else -errno
// (≙ the reference checking SO_ERROR at the writeable event).
int32_t ponyx_os_connect_result(int32_t fd) {
  int err = 0;
  socklen_t len = sizeof(err);
  if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len) != 0) return -errno;
  return -err;
}

// ≙ pony_os_recv. Returns bytes read, 0 = orderly shutdown → -ESHUTDOWN,
// -EAGAIN when drained.
int32_t ponyx_os_recv(int32_t fd, uint8_t* buf, int32_t len) {
  ssize_t n = recv(fd, buf, size_t(len), 0);
  if (n > 0) return int32_t(n);
  if (n == 0) return -ESHUTDOWN;
  int e = errno;
  return (e == EAGAIN || e == EWOULDBLOCK) ? -EAGAIN : -e;
}

// ≙ pony_os_send. Returns bytes written (may be short) or -errno.
int32_t ponyx_os_send(int32_t fd, const uint8_t* buf, int32_t len) {
  ssize_t n = send(fd, buf, size_t(len), MSG_NOSIGNAL);
  if (n >= 0) return int32_t(n);
  int e = errno;
  return (e == EAGAIN || e == EWOULDBLOCK) ? -EAGAIN : -e;
}

// UDP socket bound to host:port (port 0 = ephemeral); ≙ pony_os_listen_udp.
int32_t ponyx_os_udp(const char* host, int32_t port) {
  return resolve_and(SOCK_DGRAM, host, port, 0, 0);
}

// ≙ pony_os_sendto (IPv4/IPv6 by dotted/numeric host).
int32_t ponyx_os_sendto(int32_t fd, const uint8_t* buf, int32_t len,
                        const char* host, int32_t port) {
  struct sockaddr_storage ss;
  socklen_t slen;
  memset(&ss, 0, sizeof(ss));
  struct sockaddr_in* a4 = reinterpret_cast<struct sockaddr_in*>(&ss);
  struct sockaddr_in6* a6 = reinterpret_cast<struct sockaddr_in6*>(&ss);
  if (inet_pton(AF_INET, host, &a4->sin_addr) == 1) {
    a4->sin_family = AF_INET;
    a4->sin_port = htons(uint16_t(port));
    slen = sizeof(*a4);
  } else if (inet_pton(AF_INET6, host, &a6->sin6_addr) == 1) {
    a6->sin6_family = AF_INET6;
    a6->sin6_port = htons(uint16_t(port));
    slen = sizeof(*a6);
  } else {
    return -EINVAL;
  }
  ssize_t n = sendto(fd, buf, size_t(len), MSG_NOSIGNAL,
                     reinterpret_cast<struct sockaddr*>(&ss), slen);
  if (n >= 0) return int32_t(n);
  int e = errno;
  return (e == EAGAIN || e == EWOULDBLOCK) ? -EAGAIN : -e;
}

// ≙ pony_os_recvfrom: fills buf; writes sender "ip" into addr_out
// (addr_cap bytes, NUL-terminated) and the port into *port_out.
int32_t ponyx_os_recvfrom(int32_t fd, uint8_t* buf, int32_t len,
                          char* addr_out, int32_t addr_cap,
                          int32_t* port_out) {
  struct sockaddr_storage ss;
  socklen_t slen = sizeof(ss);
  ssize_t n = recvfrom(fd, buf, size_t(len), 0,
                       reinterpret_cast<struct sockaddr*>(&ss), &slen);
  if (n < 0) {
    int e = errno;
    return (e == EAGAIN || e == EWOULDBLOCK) ? -EAGAIN : -e;
  }
  if (addr_out != nullptr && addr_cap > 0) {
    addr_out[0] = 0;
    if (ss.ss_family == AF_INET) {
      auto* a = reinterpret_cast<struct sockaddr_in*>(&ss);
      inet_ntop(AF_INET, &a->sin_addr, addr_out, addr_cap);
      if (port_out) *port_out = ntohs(a->sin_port);
    } else if (ss.ss_family == AF_INET6) {
      auto* a = reinterpret_cast<struct sockaddr_in6*>(&ss);
      inet_ntop(AF_INET6, &a->sin6_addr, addr_out, addr_cap);
      if (port_out) *port_out = ntohs(a->sin6_port);
    }
  }
  return int32_t(n);
}

// Local/peer port (useful for ephemeral listens); ≙ pony_os_sockname /
// pony_os_peername. Returns port or -errno.
int32_t ponyx_os_sockname_port(int32_t fd) {
  struct sockaddr_storage ss;
  socklen_t slen = sizeof(ss);
  if (getsockname(fd, reinterpret_cast<struct sockaddr*>(&ss), &slen) != 0)
    return -errno;
  if (ss.ss_family == AF_INET)
    return ntohs(reinterpret_cast<struct sockaddr_in*>(&ss)->sin_port);
  if (ss.ss_family == AF_INET6)
    return ntohs(reinterpret_cast<struct sockaddr_in6*>(&ss)->sin6_port);
  return -EAFNOSUPPORT;
}

int32_t ponyx_os_peername_port(int32_t fd) {
  struct sockaddr_storage ss;
  socklen_t slen = sizeof(ss);
  if (getpeername(fd, reinterpret_cast<struct sockaddr*>(&ss), &slen) != 0)
    return -errno;
  if (ss.ss_family == AF_INET)
    return ntohs(reinterpret_cast<struct sockaddr_in*>(&ss)->sin_port);
  if (ss.ss_family == AF_INET6)
    return ntohs(reinterpret_cast<struct sockaddr_in6*>(&ss)->sin6_port);
  return -EAFNOSUPPORT;
}

// ≙ pony_os_nodelay / pony_os_keepalive (socket.c).
int32_t ponyx_os_nodelay(int32_t fd, int32_t on) {
  int v = on ? 1 : 0;
  if (setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &v, sizeof(v)) != 0)
    return -errno;
  return 0;
}

int32_t ponyx_os_keepalive(int32_t fd, int32_t secs) {
  int on = secs > 0 ? 1 : 0;
  if (setsockopt(fd, SOL_SOCKET, SO_KEEPALIVE, &on, sizeof(on)) != 0)
    return -errno;
  if (on) {
    setsockopt(fd, IPPROTO_TCP, TCP_KEEPIDLE, &secs, sizeof(secs));
    setsockopt(fd, IPPROTO_TCP, TCP_KEEPINTVL, &secs, sizeof(secs));
  }
  return 0;
}

// ≙ pony_os_socket_shutdown / close.
int32_t ponyx_os_shutdown(int32_t fd) {
  if (shutdown(fd, SHUT_WR) != 0) return -errno;
  return 0;
}

int32_t ponyx_os_close(int32_t fd) {
  if (close(fd) != 0) return -errno;
  return 0;
}

// Scatter-gather write (≙ pony_os_writev + the reference's iovec chunk
// lists, socket.c — stdlib writev sends a chunk list without flattening).
// bufs/lens describe n chunks; returns total bytes written (possibly
// short, ending mid-chunk) or -errno.
int32_t ponyx_os_writev(int32_t fd, const uint8_t** bufs,
                        const int32_t* lens, int32_t n) {
  if (n <= 0) return 0;
  if (n > 64) n = 64;                    // IOV_MAX-safe static bound
  struct iovec iov[64];
  for (int i = 0; i < n; i++) {
    iov[i].iov_base = const_cast<uint8_t*>(bufs[i]);
    iov[i].iov_len = size_t(lens[i]);
  }
  struct msghdr mh;
  memset(&mh, 0, sizeof(mh));
  mh.msg_iov = iov;
  mh.msg_iovlen = size_t(n);
  ssize_t w = sendmsg(fd, &mh, MSG_NOSIGNAL);
  if (w >= 0) return int32_t(w);
  int e = errno;
  return (e == EAGAIN || e == EWOULDBLOCK) ? -EAGAIN : -e;
}

namespace {

// Multicast group membership, IPv4 or IPv6 by the group address family
// (≙ pony_os_multicast_join / pony_os_multicast_leave, socket.c —
// which also dispatch on family). iface: interface address (IPv4) or
// index name (IPv6), empty = any.
int32_t multicast_op(int32_t fd, const char* group, const char* iface,
                     bool join) {
  struct in_addr g4;
  struct in6_addr g6;
  if (inet_pton(AF_INET, group, &g4) == 1) {
    struct ip_mreq req;
    memset(&req, 0, sizeof(req));
    req.imr_multiaddr = g4;
    if (iface && iface[0]) {
      if (inet_pton(AF_INET, iface, &req.imr_interface) != 1)
        return -EINVAL;
    } else {
      req.imr_interface.s_addr = htonl(INADDR_ANY);
    }
    int op = join ? IP_ADD_MEMBERSHIP : IP_DROP_MEMBERSHIP;
    if (setsockopt(fd, IPPROTO_IP, op, &req, sizeof(req)) != 0)
      return -errno;
    return 0;
  }
  if (inet_pton(AF_INET6, group, &g6) == 1) {
    struct ipv6_mreq req;
    memset(&req, 0, sizeof(req));
    req.ipv6mr_multiaddr = g6;
    if (iface && iface[0]) {
      unsigned idx = if_nametoindex(iface);
      if (idx == 0) return -EINVAL;
      req.ipv6mr_interface = idx;
    } else {
      req.ipv6mr_interface = 0;         // any
    }
    int op = join ? IPV6_JOIN_GROUP : IPV6_LEAVE_GROUP;
    if (setsockopt(fd, IPPROTO_IPV6, op, &req, sizeof(req)) != 0)
      return -errno;
    return 0;
  }
  return -EINVAL;
}

// The socket's address family (for v4/v6 option dispatch below).
int sock_family(int fd) {
  int dom = 0;
  socklen_t len = sizeof(dom);
  if (getsockopt(fd, SOL_SOCKET, SO_DOMAIN, &dom, &len) != 0)
    return -errno;
  return dom;
}

// Family-aware name formatting shared by sockname/peername.
int32_t format_name(struct sockaddr_storage* ss, char* addr_out,
                    int32_t addr_cap, int32_t* port_out) {
  if (addr_out == nullptr || addr_cap < 2) return -EINVAL;
  addr_out[0] = 0;
  if (ss->ss_family == AF_INET) {
    auto* a = reinterpret_cast<struct sockaddr_in*>(ss);
    inet_ntop(AF_INET, &a->sin_addr, addr_out, addr_cap);
    if (port_out) *port_out = ntohs(a->sin_port);
    return 0;
  }
  if (ss->ss_family == AF_INET6) {
    auto* a = reinterpret_cast<struct sockaddr_in6*>(ss);
    inet_ntop(AF_INET6, &a->sin6_addr, addr_out, addr_cap);
    if (port_out) *port_out = ntohs(a->sin6_port);
    return 0;
  }
  return -EAFNOSUPPORT;
}

}  // namespace

int32_t ponyx_os_multicast_join(int32_t fd, const char* group,
                                const char* iface) {
  return multicast_op(fd, group, iface, true);
}

int32_t ponyx_os_multicast_leave(int32_t fd, const char* group,
                                 const char* iface) {
  return multicast_op(fd, group, iface, false);
}

// ≙ pony_os_multicast_ttl / _loopback (socket.c): scope + self-delivery
// of outgoing multicast datagrams; dispatched on the socket family like
// the join path (IPv6 wants IPPROTO_IPV6 hop-limit/loop options).
int32_t ponyx_os_multicast_ttl(int32_t fd, int32_t ttl) {
  int fam = sock_family(fd);
  if (fam < 0) return fam;
  if (fam == AF_INET6) {
    int v = ttl;
    if (setsockopt(fd, IPPROTO_IPV6, IPV6_MULTICAST_HOPS, &v,
                   sizeof(v)) != 0)
      return -errno;
    return 0;
  }
  unsigned char v = (unsigned char)ttl;
  if (setsockopt(fd, IPPROTO_IP, IP_MULTICAST_TTL, &v, sizeof(v)) != 0)
    return -errno;
  return 0;
}

int32_t ponyx_os_multicast_loopback(int32_t fd, int32_t on) {
  int fam = sock_family(fd);
  if (fam < 0) return fam;
  if (fam == AF_INET6) {
    int v = on ? 1 : 0;
    if (setsockopt(fd, IPPROTO_IPV6, IPV6_MULTICAST_LOOP, &v,
                   sizeof(v)) != 0)
      return -errno;
    return 0;
  }
  unsigned char v = on ? 1 : 0;
  if (setsockopt(fd, IPPROTO_IP, IP_MULTICAST_LOOP, &v, sizeof(v)) != 0)
    return -errno;
  return 0;
}

// ≙ pony_os_broadcast.
int32_t ponyx_os_broadcast(int32_t fd, int32_t on) {
  int v = on ? 1 : 0;
  if (setsockopt(fd, SOL_SOCKET, SO_BROADCAST, &v, sizeof(v)) != 0)
    return -errno;
  return 0;
}

// Generic int-valued socket options (≙ the reference's ~600-line
// per-option get/getsockopt surface, socket.c pony_os_getsockopt* —
// collapsed to one pair since options are (level, name, int) triples).
int32_t ponyx_os_setsockopt_int(int32_t fd, int32_t level, int32_t name,
                                int32_t value) {
  if (setsockopt(fd, level, name, &value, sizeof(value)) != 0)
    return -errno;
  return 0;
}

int32_t ponyx_os_getsockopt_int(int32_t fd, int32_t level, int32_t name,
                                int32_t* value_out) {
  int v = 0;
  socklen_t len = sizeof(v);
  if (getsockopt(fd, level, name, &v, &len) != 0) return -errno;
  if (value_out) *value_out = v;
  return 0;
}

// Full local/peer names: "addr" string (IPv4 dotted or IPv6 hex) + port
// (≙ pony_os_sockname / pony_os_peername with their IPv6 handling).
int32_t ponyx_os_sockname(int32_t fd, char* addr_out, int32_t addr_cap,
                          int32_t* port_out) {
  struct sockaddr_storage ss;
  socklen_t slen = sizeof(ss);
  if (getsockname(fd, reinterpret_cast<struct sockaddr*>(&ss), &slen) != 0)
    return -errno;
  return format_name(&ss, addr_out, addr_cap, port_out);
}

int32_t ponyx_os_peername(int32_t fd, char* addr_out, int32_t addr_cap,
                          int32_t* port_out) {
  struct sockaddr_storage ss;
  socklen_t slen = sizeof(ss);
  if (getpeername(fd, reinterpret_cast<struct sockaddr*>(&ss), &slen) != 0)
    return -errno;
  return format_name(&ss, addr_out, addr_cap, port_out);
}

}  // extern "C"

// Async-I/O event loop for the host side of the actor runtime.
//
// Host-side counterpart of the reference's ASIO subsystem
// (src/libponyrt/asio/asio.{c,h}, asio/epoll.c, asio/event.{c,h}):
// one dedicated thread runs epoll_wait (≙ ponyint_asio_backend_dispatch,
// epoll.c:207-230); timers are timerfd-backed (≙ epoll.c:328-375),
// signals use a process-wide handler writing the signum into a self-pipe
// the loop watches (the reference's exact scheme, epoll.c:54-133 — a
// signalfd would require every thread in the process to block the
// signal, which a Python host can't guarantee), and arbitrary fds
// (sockets, stdin) subscribe with read/write interest.
// Ready events become flat int32 messages on an MPSC queue that the
// Python host driver drains at step boundaries — replacing the
// ASIO-thread → scheduler mailbox hop (asio/event.c
// pony_asio_event_send → pony_sendv).
//
// The `noisy` count (≙ asio.c:80-91) keeps the runtime from reaching
// quiescence while subscriptions that can produce fresh work exist.
//
// Event record pushed to the queue (6 int32 words):
//   [0] event id  [1] owner actor id  [2] behaviour gid
//   [3] kind (1=timer 2=signal 3=fd-read 4=fd-write 5=fd-hup)
//   [4] arg (timer expiry count / signum / fd)
//   [5] flags (epoll events bitmask for fd kinds, else 0)

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <sched.h>
#include <signal.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/timerfd.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <unordered_map>

#include "mpscq.h"
#include "pool.h"

namespace {

enum Kind : int32_t {
  kTimer = 1,
  kSignal = 2,
  kFdRead = 3,
  kFdWrite = 4,
  kFdHup = 5,
};

struct Sub {
  int32_t id;
  int32_t owner;
  int32_t behaviour;
  int fd;           // timerfd / user fd; -1 for signal subs
  Kind base_kind;   // kTimer, kSignal, or kFdRead for user fds
  bool owns_fd;     // close(fd) on unsubscribe (timers)
  bool oneshot;
  bool noisy;
  int signum;       // for signals
};

struct Loop {
  int epfd = -1;
  int wakefd = -1;   // eventfd: wake/stop the loop
  int sigpipe[2] = {-1, -1};  // handler → loop self-pipe (≙ epoll.c:54)
  std::thread thread;
  std::atomic<bool> running{false};
  ponyx_mpscq_t* events = nullptr;
  std::mutex mu;  // guards subs + next_id
  std::unordered_map<int32_t, Sub*> subs;
  std::unordered_map<int, int32_t> by_fd;
  std::unordered_map<int, int32_t> by_signum;
  int32_t next_id = 1;
  std::atomic<int64_t> noisy{0};
  // Event-arrival wait (ponyx_asio_wait): lets the host driver BLOCK
  // until the epoll thread queues an event instead of poll-sleeping —
  // ≙ a sleeping scheduler woken by the ASIO thread
  // (ponyint_sched_maybe_wakeup from asio, scheduler.c:1427-1476).
  std::mutex wmu;
  std::condition_variable wcv;
};

// Process-wide signal routing: the async-signal-safe handler writes the
// signum to the owning loop's pipe (one owner per signum). NSIG-sized
// flat arrays keep the handler free of locks and allocation.
std::atomic<int> g_sig_pipe_w[NSIG];
struct sigaction g_sig_prev[NSIG];

void signal_handler(int signum) {
  int fd = g_sig_pipe_w[signum].load(std::memory_order_relaxed);
  if (fd >= 0) {
    int32_t v = signum;
    (void)!write(fd, &v, sizeof(v));
  }
}

void push_event(Loop* l, const Sub* s, Kind kind, int32_t arg,
                int32_t flags) {
  int32_t w[6] = {s->id, s->owner, s->behaviour, kind, arg, flags};
  ponyx_mpscq_push(l->events, w, 6);
  // Wake a blocked ponyx_asio_wait. The empty critical section orders
  // the push before the waiter's predicate re-check (no lost wakeup).
  { std::lock_guard<std::mutex> g(l->wmu); }
  l->wcv.notify_one();
}

void loop_main(Loop* l) {
  constexpr int kMax = 64;
  struct epoll_event evs[kMax];
  while (l->running.load(std::memory_order_acquire)) {
    int n = epoll_wait(l->epfd, evs, kMax, -1);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      uint32_t e = evs[i].events;
      if (fd == l->wakefd) {
        uint64_t v;
        (void)!read(l->wakefd, &v, sizeof(v));
        continue;
      }
      if (fd == l->sigpipe[0]) {
        int32_t signum;
        while (read(l->sigpipe[0], &signum, sizeof(signum)) ==
               ssize_t(sizeof(signum))) {
          Sub copy;
          bool have = false;
          {
            std::lock_guard<std::mutex> lock(l->mu);
            auto it = l->by_signum.find(signum);
            if (it != l->by_signum.end()) {
              copy = *l->subs[it->second];
              have = true;
            }
          }
          if (have) push_event(l, &copy, kSignal, signum, 0);
        }
        continue;
      }
      Sub copy;
      Sub* retired = nullptr;
      {
        std::lock_guard<std::mutex> lock(l->mu);
        auto it = l->by_fd.find(fd);
        if (it == l->by_fd.end()) continue;
        Sub* s = l->subs[it->second];
        copy = *s;
        if (s->oneshot) {
          l->subs.erase(s->id);
          l->by_fd.erase(fd);
          epoll_ctl(l->epfd, EPOLL_CTL_DEL, fd, nullptr);
          retired = s;
        }
      }
      switch (copy.base_kind) {
        case kTimer: {
          uint64_t expirations = 0;
          (void)!read(copy.fd, &expirations, sizeof(expirations));
          push_event(l, &copy, kTimer, int32_t(expirations), 0);
          break;
        }
        case kSignal:  // unreachable: signals arrive via sigpipe
          break;
        default: {
          if (e & (EPOLLIN | EPOLLPRI))
            push_event(l, &copy, kFdRead, copy.fd, int32_t(e));
          if (e & EPOLLOUT)
            push_event(l, &copy, kFdWrite, copy.fd, int32_t(e));
          if (e & (EPOLLHUP | EPOLLERR))
            push_event(l, &copy, kFdHup, copy.fd, int32_t(e));
          break;
        }
      }
      if (retired != nullptr) {
        if (copy.owns_fd) close(copy.fd);
        if (copy.noisy) l->noisy.fetch_sub(1, std::memory_order_relaxed);
        ponyx_pool_free(sizeof(Sub), retired);
      }
    }
  }
}

int32_t add_sub(Loop* l, Sub* s, uint32_t epoll_flags) {
  std::lock_guard<std::mutex> lock(l->mu);
  s->id = l->next_id++;
  struct epoll_event ev;
  std::memset(&ev, 0, sizeof(ev));
  ev.events = epoll_flags;
  ev.data.fd = s->fd;
  if (epoll_ctl(l->epfd, EPOLL_CTL_ADD, s->fd, &ev) != 0) {
    int32_t err = -errno;
    if (s->owns_fd) close(s->fd);
    ponyx_pool_free(sizeof(Sub), s);
    return err;
  }
  l->subs[s->id] = s;
  l->by_fd[s->fd] = s->id;
  if (s->noisy) l->noisy.fetch_add(1, std::memory_order_relaxed);
  return s->id;
}

}  // namespace

extern "C" {

typedef struct Loop ponyx_asio_t;

ponyx_asio_t* ponyx_asio_create() {
  static std::once_flag once;
  std::call_once(once, [] {
    for (int i = 0; i < NSIG; i++) g_sig_pipe_w[i].store(-1);
  });
  auto* l = new Loop();
  l->epfd = epoll_create1(EPOLL_CLOEXEC);
  l->wakefd = eventfd(0, EFD_CLOEXEC | EFD_NONBLOCK);
  if (pipe2(l->sigpipe, O_CLOEXEC | O_NONBLOCK) != 0)
    l->sigpipe[0] = l->sigpipe[1] = -1;
  l->events = ponyx_mpscq_create();
  struct epoll_event ev;
  std::memset(&ev, 0, sizeof(ev));
  ev.events = EPOLLIN;
  ev.data.fd = l->wakefd;
  epoll_ctl(l->epfd, EPOLL_CTL_ADD, l->wakefd, &ev);
  if (l->sigpipe[0] >= 0) {
    ev.data.fd = l->sigpipe[0];
    epoll_ctl(l->epfd, EPOLL_CTL_ADD, l->sigpipe[0], &ev);
  }
  l->running.store(true, std::memory_order_release);
  l->thread = std::thread(loop_main, l);
  return l;
}

// Set the event-loop thread's affinity to a core set (≙ --ponypinasio,
// start.c:75-94 + ponyint_cpu_affinity, sched/cpu.c:278): latency-
// sensitive deployments keep the I/O thread off the busy cores — or
// restore the full mask when only the DRIVER thread is pinned (new
// threads inherit the creator's mask). Returns 0 on success, -errno
// otherwise (this file's convention).
int32_t ponyx_asio_setaffinity(ponyx_asio_t* l, const int32_t* cores,
                               int32_t n) {
  if (n <= 0 || cores == nullptr) return -EINVAL;
  cpu_set_t set;
  CPU_ZERO(&set);
  bool any = false;
  for (int32_t i = 0; i < n; i++) {
    if (cores[i] >= 0 && cores[i] < CPU_SETSIZE) {
      CPU_SET(cores[i], &set);
      any = true;
    }
  }
  if (!any) return -EINVAL;
  int err = pthread_setaffinity_np(l->thread.native_handle(),
                                   sizeof(set), &set);
  return err ? -err : 0;
}

void ponyx_asio_destroy(ponyx_asio_t* l) {
  l->running.store(false, std::memory_order_release);
  uint64_t one = 1;
  (void)!write(l->wakefd, &one, sizeof(one));
  l->thread.join();
  {
    std::lock_guard<std::mutex> lock(l->mu);
    for (auto& kv : l->subs) {
      Sub* s = kv.second;
      if (s->base_kind == kSignal) {
        g_sig_pipe_w[s->signum].store(-1, std::memory_order_relaxed);
        sigaction(s->signum, &g_sig_prev[s->signum], nullptr);
      } else {
        epoll_ctl(l->epfd, EPOLL_CTL_DEL, s->fd, nullptr);
      }
      if (s->owns_fd) close(s->fd);
      ponyx_pool_free(sizeof(Sub), s);
    }
    l->subs.clear();
    l->by_fd.clear();
    l->by_signum.clear();
  }
  close(l->wakefd);
  if (l->sigpipe[0] >= 0) {
    close(l->sigpipe[0]);
    close(l->sigpipe[1]);
  }
  close(l->epfd);
  ponyx_mpscq_destroy(l->events);
  delete l;
}

// Periodic or one-shot timer; interval in nanoseconds.
// ≙ the reference's timer events (epoll.c:328-375). Returns sub id (<0 =
// -errno).
int32_t ponyx_asio_timer(ponyx_asio_t* l, int64_t first_ns,
                         int64_t interval_ns, int32_t owner,
                         int32_t behaviour, int32_t oneshot,
                         int32_t noisy) {
  int fd = timerfd_create(CLOCK_MONOTONIC, TFD_CLOEXEC | TFD_NONBLOCK);
  if (fd < 0) return -errno;
  struct itimerspec its;
  its.it_value.tv_sec = first_ns / 1000000000;
  its.it_value.tv_nsec = first_ns % 1000000000;
  its.it_interval.tv_sec = oneshot ? 0 : interval_ns / 1000000000;
  its.it_interval.tv_nsec = oneshot ? 0 : interval_ns % 1000000000;
  if (timerfd_settime(fd, 0, &its, nullptr) != 0) {
    int e = -errno;
    close(fd);
    return e;
  }
  auto* s = static_cast<Sub*>(ponyx_pool_alloc(sizeof(Sub)));
  *s = Sub{0, owner, behaviour, fd, kTimer, true, oneshot != 0,
           noisy != 0, 0};
  return add_sub(l, s, EPOLLIN);
}

// Signal subscription: installs the self-pipe handler for `signum` and
// routes deliveries to this loop (≙ the reference's handler scheme,
// epoll.c:54-133). One subscriber per signum per process.
int32_t ponyx_asio_signal(ponyx_asio_t* l, int32_t signum, int32_t owner,
                          int32_t behaviour, int32_t noisy) {
  if (signum <= 0 || signum >= NSIG) return -EINVAL;
  auto* s = static_cast<Sub*>(ponyx_pool_alloc(sizeof(Sub)));
  *s = Sub{0, owner, behaviour, -1, kSignal, false, false, noisy != 0,
           signum};
  {
    std::lock_guard<std::mutex> lock(l->mu);
    if (l->by_signum.count(signum)) {
      ponyx_pool_free(sizeof(Sub), s);
      return -EBUSY;
    }
    s->id = l->next_id++;
    l->subs[s->id] = s;
    l->by_signum[signum] = s->id;
  }
  if (s->noisy) l->noisy.fetch_add(1, std::memory_order_relaxed);
  g_sig_pipe_w[signum].store(l->sigpipe[1], std::memory_order_relaxed);
  struct sigaction sa;
  std::memset(&sa, 0, sizeof(sa));
  sa.sa_handler = signal_handler;
  sigemptyset(&sa.sa_mask);
  sa.sa_flags = SA_RESTART;
  sigaction(signum, &sa, &g_sig_prev[signum]);
  return s->id;
}

// Arbitrary fd (socket, pipe, stdin). interest: 1=read 2=write 3=both.
// Edge-triggered (≙ the reference arming epoll with EPOLLET for sockets,
// epoll.c): one event per readiness *transition*, so a ready-but-undrained
// fd cannot storm the event queue between host polls. Consumers must
// drain to EAGAIN — which the net layer's accept/recv loops do.
int32_t ponyx_asio_fd(ponyx_asio_t* l, int32_t fd, int32_t interest,
                      int32_t owner, int32_t behaviour, int32_t oneshot,
                      int32_t noisy) {
  uint32_t flags = EPOLLET;
  if (interest & 1) flags |= EPOLLIN;
  if (interest & 2) flags |= EPOLLOUT;
  flags |= EPOLLRDHUP;
  auto* s = static_cast<Sub*>(ponyx_pool_alloc(sizeof(Sub)));
  *s = Sub{0, owner, behaviour, fd, kFdRead, false, oneshot != 0,
           noisy != 0, 0};
  return add_sub(l, s, flags);
}

// Change a live fd subscription's interest set (1=read 2=write 3=both);
// ≙ pony_asio_event_resubscribe_read/write (asio/event.c) — the
// reference's way of arming write-readiness only while writes are
// pending, which is also exactly what the net layer does here.
int32_t ponyx_asio_fd_interest(ponyx_asio_t* l, int32_t sub_id,
                               int32_t interest) {
  std::lock_guard<std::mutex> lock(l->mu);
  auto it = l->subs.find(sub_id);
  if (it == l->subs.end()) return -ENOENT;
  Sub* s = it->second;
  if (s->fd < 0) return -EINVAL;
  struct epoll_event ev;
  std::memset(&ev, 0, sizeof(ev));
  ev.events = EPOLLET | EPOLLRDHUP;
  if (interest & 1) ev.events |= EPOLLIN;
  if (interest & 2) ev.events |= EPOLLOUT;
  ev.data.fd = s->fd;
  // MOD re-arms: if the fd is already ready for the new interest the
  // kernel delivers a fresh edge — the property the write path relies on.
  if (epoll_ctl(l->epfd, EPOLL_CTL_MOD, s->fd, &ev) != 0) return -errno;
  return 0;
}

// ≙ pony_asio_event_unsubscribe (asio/event.c).
int32_t ponyx_asio_unsubscribe(ponyx_asio_t* l, int32_t sub_id) {
  std::lock_guard<std::mutex> lock(l->mu);
  auto it = l->subs.find(sub_id);
  if (it == l->subs.end()) return 0;
  Sub* s = it->second;
  if (s->base_kind == kSignal) {
    g_sig_pipe_w[s->signum].store(-1, std::memory_order_relaxed);
    sigaction(s->signum, &g_sig_prev[s->signum], nullptr);
    l->by_signum.erase(s->signum);
  } else {
    epoll_ctl(l->epfd, EPOLL_CTL_DEL, s->fd, nullptr);
    l->by_fd.erase(s->fd);
  }
  l->subs.erase(it);
  if (s->noisy) l->noisy.fetch_sub(1, std::memory_order_relaxed);
  if (s->owns_fd) close(s->fd);
  ponyx_pool_free(sizeof(Sub), s);
  return 1;
}

// Drain up to `max_events` pending events into `out` ([max_events, 6]
// row-major int32). Returns the number of events written. Called by the
// host driver at step boundaries — the single consumer.
int32_t ponyx_asio_drain(ponyx_asio_t* l, int32_t* out,
                         int32_t max_events) {
  int32_t n = 0;
  while (n < max_events) {
    int32_t r = ponyx_mpscq_pop(l->events, out + n * 6, 6);
    if (r <= 0) break;
    n++;
  }
  return n;
}

int64_t ponyx_asio_pending(ponyx_asio_t* l) {
  return ponyx_mpscq_count(l->events);
}

// Block the calling (host-driver) thread until the event queue is
// non-empty or `timeout_ms` passes; returns 1 if events are pending.
// ≙ a quiescing scheduler blocking until the ASIO thread wakes it
// (perhaps_suspend_scheduler / ponyint_sched_maybe_wakeup) — the host
// loop uses this instead of backoff poll-sleeps when the only pending
// work is external I/O.
int32_t ponyx_asio_wait(ponyx_asio_t* l, int32_t timeout_ms) {
  if (ponyx_mpscq_count(l->events) > 0) return 1;
  std::unique_lock<std::mutex> lk(l->wmu);
  l->wcv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                  [l] { return ponyx_mpscq_count(l->events) > 0; });
  return ponyx_mpscq_count(l->events) > 0 ? 1 : 0;
}

// ≙ ponyint_asio_noisy_add/remove + count (asio.c:80-91): subscriptions
// register their own noisiness; apps may add manual holds too.
void ponyx_asio_noisy_add(ponyx_asio_t* l) {
  l->noisy.fetch_add(1, std::memory_order_relaxed);
}

void ponyx_asio_noisy_remove(ponyx_asio_t* l) {
  l->noisy.fetch_sub(1, std::memory_order_relaxed);
}

int64_t ponyx_asio_noisy_count(ponyx_asio_t* l) {
  return l->noisy.load(std::memory_order_relaxed);
}

}  // extern "C"

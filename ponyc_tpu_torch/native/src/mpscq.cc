#include "mpscq.h"

#include <atomic>
#include <cstring>

#include "pool.h"

namespace {

struct Node {
  std::atomic<Node*> next;
  int32_t nwords;
  int32_t words[];  // flexible payload

  static size_t bytes(int32_t nwords) {
    return sizeof(Node) + size_t(nwords) * sizeof(int32_t);
  }
};

}  // namespace

struct ponyx_mpscq {
  // head = producer end, tail = consumer end; stub node makes the queue
  // intrusive and lock-free exactly as messageq.c:31-100 does (head tag
  // bit tricks are unnecessary here: emptiness is detected by the
  // consumer seeing next == nullptr, and the "empty" transition never
  // needs to reschedule anything — the host driver polls).
  std::atomic<Node*> head;
  Node* tail;
  Node* stub;
  std::atomic<int64_t> count;
};

extern "C" {

ponyx_mpscq_t* ponyx_mpscq_create() {
  auto* q = static_cast<ponyx_mpscq_t*>(
      ponyx_pool_alloc(sizeof(ponyx_mpscq_t)));
  q->stub = static_cast<Node*>(ponyx_pool_alloc(Node::bytes(0)));
  q->stub->next.store(nullptr, std::memory_order_relaxed);
  q->stub->nwords = 0;
  q->head.store(q->stub, std::memory_order_relaxed);
  q->tail = q->stub;
  q->count.store(0, std::memory_order_relaxed);
  return q;
}

void ponyx_mpscq_destroy(ponyx_mpscq_t* q) {
  int32_t sink[1];
  while (true) {
    int32_t r = ponyx_mpscq_pop(q, sink, 0);
    if (r == 0) break;
    if (r < 0) {  // drain oversized message by popping with enough room
      int32_t need = -r;
      auto* buf = static_cast<int32_t*>(
          ponyx_pool_alloc(size_t(need) * sizeof(int32_t)));
      ponyx_mpscq_pop(q, buf, need);
      ponyx_pool_free(size_t(need) * sizeof(int32_t), buf);
    }
  }
  if (q->tail != q->stub)  // last consumed node is retired lazily
    ponyx_pool_free(Node::bytes(q->tail->nwords), q->tail);
  ponyx_pool_free(Node::bytes(0), q->stub);
  ponyx_pool_free(sizeof(ponyx_mpscq_t), q);
}

void ponyx_mpscq_push(ponyx_mpscq_t* q, const int32_t* words,
                      int32_t nwords) {
  auto* n = static_cast<Node*>(ponyx_pool_alloc(Node::bytes(nwords)));
  n->nwords = nwords;
  std::memcpy(n->words, words, size_t(nwords) * sizeof(int32_t));
  n->next.store(nullptr, std::memory_order_relaxed);
  Node* prev = q->head.exchange(n, std::memory_order_acq_rel);
  prev->next.store(n, std::memory_order_release);
  q->count.fetch_add(1, std::memory_order_relaxed);
}

int32_t ponyx_mpscq_pop(ponyx_mpscq_t* q, int32_t* out, int32_t cap) {
  Node* tail = q->tail;
  Node* next = tail->next.load(std::memory_order_acquire);
  if (next == nullptr) return 0;
  if (next->nwords > cap) return -next->nwords;
  std::memcpy(out, next->words, size_t(next->nwords) * sizeof(int32_t));
  int32_t n = next->nwords;
  q->tail = next;
  if (tail != q->stub)
    ponyx_pool_free(Node::bytes(tail->nwords), tail);
  // `next` becomes the new stub-position node; freed on the following pop.
  q->count.fetch_sub(1, std::memory_order_relaxed);
  return n;
}

int64_t ponyx_mpscq_count(ponyx_mpscq_t* q) {
  return q->count.load(std::memory_order_relaxed);
}

}  // extern "C"

#include "pool.h"

#include <atomic>
#include <cstdlib>
#include <mutex>

namespace {

constexpr int kMinBits = 5;    // 32 B
constexpr int kMaxBits = 20;   // 1 MiB
constexpr int kClasses = kMaxBits - kMinBits + 1;
constexpr int kLocalMax = 64;  // per-thread blocks kept before spilling

struct Node {
  Node* next;
};

// Global tier: one lock-guarded stack per class. The reference uses a
// lock-free central list; host-side traffic here is orders of magnitude
// lower (events and staged messages, not every actor message), so a
// mutex is the simpler correct choice.
struct GlobalTier {
  std::mutex mu;
  Node* head = nullptr;
  size_t count = 0;
};

GlobalTier g_global[kClasses];
std::atomic<uint64_t> g_live{0};
std::atomic<uint64_t> g_parked{0};

struct LocalTier {
  Node* head[kClasses] = {};
  int count[kClasses] = {};

  ~LocalTier() {
    // Thread exit: hand everything back to the global tier.
    for (int i = 0; i < kClasses; i++) {
      while (head[i]) {
        Node* n = head[i];
        head[i] = n->next;
        std::lock_guard<std::mutex> lock(g_global[i].mu);
        n->next = g_global[i].head;
        g_global[i].head = n;
        g_global[i].count++;
      }
      count[i] = 0;
    }
  }
};

thread_local LocalTier t_local;

int class_index(size_t size) {
  if (size <= (size_t{1} << kMinBits)) return 0;
  int bits = kMinBits;
  size_t c = size_t{1} << kMinBits;
  while (c < size) {
    c <<= 1;
    bits++;
  }
  return bits - kMinBits;
}

}  // namespace

extern "C" {

void* ponyx_pool_alloc(size_t size) {
  int idx = class_index(size);
  if (idx >= kClasses)  // oversize: straight malloc, no pooling
    return std::malloc(size);
  LocalTier& lt = t_local;
  if (lt.head[idx]) {
    Node* n = lt.head[idx];
    lt.head[idx] = n->next;
    lt.count[idx]--;
    g_live.fetch_add(1, std::memory_order_relaxed);
    g_parked.fetch_sub(1, std::memory_order_relaxed);
    return n;
  }
  {
    GlobalTier& gt = g_global[idx];
    std::lock_guard<std::mutex> lock(gt.mu);
    if (gt.head) {
      Node* n = gt.head;
      gt.head = n->next;
      gt.count--;
      g_live.fetch_add(1, std::memory_order_relaxed);
      g_parked.fetch_sub(1, std::memory_order_relaxed);
      return n;
    }
  }
  g_live.fetch_add(1, std::memory_order_relaxed);
  return std::malloc(size_t{1} << (kMinBits + idx));
}

void ponyx_pool_free(size_t size, void* p) {
  if (p == nullptr) return;
  int idx = class_index(size);
  if (idx >= kClasses) {
    std::free(p);
    return;
  }
  g_live.fetch_sub(1, std::memory_order_relaxed);
  g_parked.fetch_add(1, std::memory_order_relaxed);
  Node* n = static_cast<Node*>(p);
  LocalTier& lt = t_local;
  n->next = lt.head[idx];
  lt.head[idx] = n;
  lt.count[idx]++;
  if (lt.count[idx] > kLocalMax) {
    // Spill half to the global tier so bursty threads don't hoard.
    Node* keep = lt.head[idx];
    for (int i = 1; i < kLocalMax / 2; i++) keep = keep->next;
    Node* spill = keep->next;
    keep->next = nullptr;
    lt.count[idx] = kLocalMax / 2;
    GlobalTier& gt = g_global[idx];
    std::lock_guard<std::mutex> lock(gt.mu);
    while (spill) {
      Node* nx = spill->next;
      spill->next = gt.head;
      gt.head = spill;
      gt.count++;
      spill = nx;
    }
  }
}

uint64_t ponyx_pool_allocated() {
  return g_live.load(std::memory_order_relaxed);
}

uint64_t ponyx_pool_recycled() {
  return g_parked.load(std::memory_order_relaxed);
}

int ponyx_pool_index(size_t size) { return class_index(size); }

}  // extern "C"

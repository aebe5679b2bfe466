// In-process microbenchmarks for the native host-runtime components —
// this framework's counterpart of the reference's Google-Benchmark
// suite over its allocator and queues (benchmark/libponyrt/mem/pool.cc,
// benchmark/libponyrt/ds/hash.cc). Timed loops run entirely in native
// code (one ctypes call per measurement), so Python call overhead never
// enters the measured region — the same property gbenchmark gives the
// reference.
#include <chrono>
#include <cstdint>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include "mpscq.h"
#include "pool.h"

namespace {
double ns_per_op(std::chrono::steady_clock::time_point t0, uint64_t ops) {
  auto dt = std::chrono::steady_clock::now() - t0;
  return std::chrono::duration<double, std::nano>(dt).count() /
         static_cast<double>(ops);
}
}  // namespace

extern "C" {

// Alloc+free round-trips of `size`-byte blocks (free-list hit path after
// the first lap; ≙ BM_PoolAllocFree).
double ponyx_bench_pool(uint64_t iters, uint64_t size) {
  // Warm the class's free list so steady-state recycling is measured.
  void* warm = ponyx_pool_alloc(size);
  ponyx_pool_free(size, warm);
  auto t0 = std::chrono::steady_clock::now();
  for (uint64_t i = 0; i < iters; i++) {
    void* p = ponyx_pool_alloc(size);
    ponyx_pool_free(size, p);
  }
  return ns_per_op(t0, iters);
}

// Depth-`depth` alloc bursts then frees (exercises list growth;
// ≙ BM_PoolAllocMultiple).
double ponyx_bench_pool_burst(uint64_t iters, uint64_t size,
                              uint64_t depth) {
  std::vector<void*> held(depth);
  auto t0 = std::chrono::steady_clock::now();
  for (uint64_t i = 0; i < iters; i++) {
    for (uint64_t j = 0; j < depth; j++) held[j] = ponyx_pool_alloc(size);
    for (uint64_t j = 0; j < depth; j++) ponyx_pool_free(size, held[j]);
  }
  return ns_per_op(t0, iters * depth);
}

// Single-threaded push+pop round-trips of `nwords`-word messages
// through the MPSC staging queue (≙ messageq push/pop microbench).
double ponyx_bench_mpscq(uint64_t iters, uint64_t nwords) {
  ponyx_mpscq_t* q = ponyx_mpscq_create();
  std::vector<int32_t> msg(nwords, 7), out(nwords + 4);
  auto t0 = std::chrono::steady_clock::now();
  for (uint64_t i = 0; i < iters; i++) {
    ponyx_mpscq_push(q, msg.data(), static_cast<int32_t>(nwords));
    ponyx_mpscq_pop(q, out.data(), static_cast<int32_t>(out.size()));
  }
  double r = ns_per_op(t0, iters);
  ponyx_mpscq_destroy(q);
  return r;
}

// `nprod` producer threads flooding one consumer (the ASIO-loop →
// host-driver shape); returns ns per message consumed.
double ponyx_bench_mpscq_mt(uint64_t total_msgs, uint64_t nprod,
                            uint64_t nwords) {
  ponyx_mpscq_t* q = ponyx_mpscq_create();
  uint64_t per = total_msgs / nprod;
  if (per == 0) per = 1;                  // tiny scales: never measure 0 ops
  total_msgs = per * nprod;
  // Spawn first, time after a ready-barrier: thread-creation cost stays
  // outside the measured region (as gbenchmark's MT harness does).
  std::atomic<uint64_t> ready{0};
  std::atomic<bool> go{false};
  std::vector<std::thread> ts;
  for (uint64_t p = 0; p < nprod; p++) {
    ts.emplace_back([&, p]() {
      std::vector<int32_t> msg(nwords, static_cast<int32_t>(p));
      ready.fetch_add(1);
      while (!go.load(std::memory_order_acquire)) std::this_thread::yield();
      for (uint64_t i = 0; i < per; i++)
        ponyx_mpscq_push(q, msg.data(), static_cast<int32_t>(nwords));
    });
  }
  while (ready.load() < nprod) std::this_thread::yield();
  auto t0 = std::chrono::steady_clock::now();
  go.store(true, std::memory_order_release);
  std::vector<int32_t> out(nwords + 4);
  uint64_t got = 0;
  while (got < total_msgs) {
    if (ponyx_mpscq_pop(q, out.data(),
                        static_cast<int32_t>(out.size())) > 0)
      got++;
  }
  for (auto& t : ts) t.join();
  double r = ns_per_op(t0, total_msgs);
  ponyx_mpscq_destroy(q);
  return r;
}

}  // extern "C"

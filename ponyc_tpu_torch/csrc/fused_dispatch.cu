// Fused drain + dispatch + outbox for Hopper (sm_90a): one cohort's
// message pop, behaviour dispatch and send construction in one kernel.
//
// Replaces the TPU kernel ponyc_tpu/ops/fused_dispatch.py:
// build_fused_dispatch (:97), kernel (:134), _slim_branch (:61). It
// computes what the plain loop ponyc_tpu_torch/runtime/engine.py
// (_plain_dispatch) computes, for every actor lane i of the cohort:
//
//   for k < batch:  valid = n_run[i] > k, act = valid && !stopped
//     msg   = buf[(head[i] + k) mod cap, :, i]           (only when act)
//     local = msg[0] - base; in_range = 0 <= local < nb
//     the behaviour `local` runs on (state, msg[1:], id)  (only when both)
//     outbox entry (k, m, i): target (-1 = none) and w1 words
//     spawns: the behaviour reads this dispatch's reserved refs (the
//       `used` counter walks SD dispatches' worth of the reservation
//       planes and advances on a slot that claimed or failed a wanted
//       spawn); claim (k, site, i): the claimed ref (-1 = none)
//     exit: the first code wins; error: the latest code and site win;
//     destroy: OR; yield stops the batch (unless noyield)
//   state out, head + consumed, and the cohort sums nproc, nbad, the
//   first exiting lane's code, whether any lane exited and whether any
//   wanted spawn found no reserved slot (sticky spawn_fail).
//
// The per-lane drain is `pony_lane` (csrc/lane.cuh, shared with the window
// kernel). The behaviour bodies come from a generated header
// (pony_cohort.h, written by ponyc_tpu_torch/ops/lanecode.py from an
// ATen-level trace of each body, found through -I): the cohort's struct,
// named PonyCohort there, and PONY_ENTRY, the name of this library's entry.
// Where the TPU kernel evaluates every behaviour on every lane and selects,
// a thread here evaluates only the one its message names: bodies are
// lane-local and pure, so that is exact, and it is the reference compiler's
// generated dispatch switch (genfun.c).
//
// Layout (actor axis minor everywhere, so a warp's 32 threads touch 32
// neighbouring words): buf int32 [cap, w1_in, rows]; head, n_run, ids
// int32 [rows]; fields [rows] each, their pointers passed as two host
// arrays (in, out); out_tgt int32 [batch*ms*rows] with entry (k, m, i) at
// (k*ms + m)*rows + i; out_words int32 [w1, batch*ms*rows] (the engine's
// final layout, so no permute pass follows); the destroy plane uint8
// [rows] and the error planes uint8/int32/int32 [rows] only when a body
// uses them; the reservation planes int32 [SD * NS, rows] in and the claim
// planes int32 [BATCH * NS, rows] out, target by target (the rows of flat
// site g: the cohort's resv_row(g, d) and claim_row(g, k)), only when the
// cohort spawns (NS > 0); red int32 [8]: nproc, nbad, exit code, any exit,
// then a 64-bit exit key, a block ticket (scratch) and any spawn fail.
//
// Bound. One thread per lane; each lane reads its state, head, n_run and
// id, the words of the slots it consumes, and writes its state, head and
// every outbox entry. At ubench's shape (2^20 lanes, cap 4, w1 2, batch
// 4, ms 1) that is about 113 MB, so the kernel is bound by memory, about
// 0.034 ms at 3.35 TB/s. Bodies with long float chains (the mixed model's
// 64 dependent divisions) add operations; chip_smoke.py computes both
// terms from the run's data. The sums go through shared memory, one atomic
// per block, and the last block to finish writes the exit code. This
// first version aims to be right; nothing is staged through shared memory
// or vectorised.
//
// The same source also builds as host C++ (no __CUDACC__): the entry then
// runs the lanes in order on the CPU. The CPU tests use that build to hold
// the generated bodies against eager torch on a machine without a card.

#include "lane.cuh"
#include "pony_cohort.h"

typedef PonyCohort C;
typedef PonyPtrs<C::NF> Fields;

// The cohort's mailbox, read-only in this kernel.
struct PonyRing {
  const int32_t* __restrict__ buf;
  int64_t rows, i;
  PONY_FN int32_t operator()(uint32_t slot, int j) const {
    return buf[((size_t)slot * C::W1_IN + j) * rows + i];
  }
};

// Outbox entry (k, m, i) at (k*ms + m)*rows + i, words planar.
struct PonyOutbox {
  int32_t* __restrict__ tgt;
  int32_t* __restrict__ words;
  int64_t rows, i;
  PONY_FN void operator()(int k, int m, int32_t t, const int32_t* w) const {
    const size_t e = (size_t)C::BATCH * C::MS * (size_t)rows;
    const size_t entry = ((size_t)k * C::MS + m) * rows + i;
    tgt[entry] = t;
    for (int j = 0; j < C::W1; ++j) words[j * e + entry] = w[j];
  }
};

// Spawn sites: reservations read from, claims written to the planes.
struct PonyPlanes {
  const int32_t* __restrict__ rplane;
  int32_t* __restrict__ cplane;
  int64_t rows, i;
  PONY_FN int32_t resv(int d, int g) const {
    return rplane[(int64_t)C::resv_row(g, d) * rows + i];
  }
  template <class O>
  PONY_FN void claim(int k, const O& o) const {
    for (int g = 0; g < C::NS; ++g)
      cplane[(int64_t)C::claim_row(g, k) * rows + i] = o.clm[g];
  }
};

// One actor lane: the part shared by the kernel and the host build.
PONY_FN PonyLane pony_fused_lane(int64_t i, int64_t rows,
                                 const int32_t* __restrict__ buf,
                                 const int32_t* __restrict__ head,
                                 const int32_t* __restrict__ n_run,
                                 const int32_t* __restrict__ ids,
                                 const Fields& fin, const Fields& fout,
                                 int32_t* __restrict__ out_tgt,
                                 int32_t* __restrict__ out_words,
                                 int32_t* __restrict__ new_head,
                                 uint8_t* __restrict__ ds_out,
                                 uint8_t* __restrict__ erf_out,
                                 int32_t* __restrict__ erc_out,
                                 int32_t* __restrict__ erl_out,
                                 const int32_t* __restrict__ resv,
                                 int32_t* __restrict__ claims) {
  C::State s;
  C::load(s, fin, i);
  const uint32_t h = (uint32_t)head[i];
  const PonyRing ring = {buf, rows, i};
  const PonyOutbox send = {out_tgt, out_words, rows, i};
  const PonyPlanes spawn = {resv, claims, rows, i};
  const PonyLane r = pony_lane<C>(s, h, n_run[i], ids[i], ring, send, spawn);
  C::store(s, fout, i);
  new_head[i] = (int32_t)(h + r.consumed);
  if constexpr (C::DESTROY) ds_out[i] = r.ds;
  if constexpr (C::ERROR) {
    erf_out[i] = r.erf;
    erc_out[i] = r.erc;
    erl_out[i] = r.erl;
  }
  return r;
}

#ifdef __CUDACC__

#define PONY_THREADS 256

__global__ void __launch_bounds__(PONY_THREADS) pony_fused_kernel(
    int64_t rows, const int32_t* __restrict__ buf,
    const int32_t* __restrict__ head, const int32_t* __restrict__ n_run,
    const int32_t* __restrict__ ids, const Fields fin, const Fields fout,
    int32_t* __restrict__ out_tgt, int32_t* __restrict__ out_words,
    int32_t* __restrict__ new_head, uint8_t* __restrict__ ds_out,
    uint8_t* __restrict__ erf_out, int32_t* __restrict__ erc_out,
    int32_t* __restrict__ erl_out, const int32_t* __restrict__ resv,
    int32_t* __restrict__ claims, int32_t* __restrict__ red) {
  __shared__ int32_t s_np, s_nb;
  __shared__ unsigned long long s_key;
  if (threadIdx.x == 0) {
    s_np = 0;
    s_nb = 0;
    s_key = 0ull;
  }
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  PonyLane r = {0, 0, 0, 0, 0, 0, 0u, false, false, false, false};
  if (i < rows)
    r = pony_fused_lane(i, rows, buf, head, n_run, ids, fin, fout, out_tgt,
                        out_words, new_head, ds_out, erf_out, erc_out,
                        erl_out, resv, claims);
  const int32_t np = __reduce_add_sync(0xffffffffu, r.nproc);
  const int32_t nb = __reduce_add_sync(0xffffffffu, r.nbad);
  if ((threadIdx.x & 31) == 0) {
    if (np) atomicAdd(&s_np, np);
    if (nb) atomicAdd(&s_nb, nb);
  }
  if constexpr (C::NS > 0) {
    // Any spawn fail: one store a warp that saw one (the flag only rises).
    if (__any_sync(0xffffffffu, r.sf) && (threadIdx.x & 31) == 0)
      atomicOr(&red[7], 1);
  }
  if (r.ef) {
    // The lowest exiting lane wins: its key is the largest.
    const unsigned long long key =
        ((unsigned long long)(0xffffffffu - (uint32_t)i) << 32) |
        (uint32_t)r.ec;
    atomicMax(&s_key, key);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long* g_key = (unsigned long long*)(red + 4);
    if (s_np) atomicAdd(&red[0], s_np);
    if (s_nb) atomicAdd(&red[1], s_nb);
    if (s_key) atomicMax(g_key, s_key);
    __threadfence();
    const unsigned ticket = atomicAdd((unsigned*)(red + 6), 1u);
    if (ticket == gridDim.x - 1) {       // the last block: every key is in
      __threadfence();
      const unsigned long long key = atomicAdd(g_key, 0ull);
      red[2] = key ? (int32_t)(uint32_t)(key & 0xffffffffull) : 0;
      red[3] = key ? 1 : 0;
    }
  }
}

static Fields pony_fields(void* const* p) {
  Fields f;
  for (int k = 0; k < C::NF; ++k) f.p[k] = p[k];
  return f;
}

// Launches on `stream` after zeroing `red`, and returns
// cudaGetLastError() as an int (0 = ok). `fin` and `fout` are host arrays
// of the NF field pointers. Allocates nothing and does not synchronise.
extern "C" int PONY_ENTRY(const void* buf, const void* head,
                          const void* n_run, const void* ids,
                          void* const* fin, void* const* fout,
                          void* out_tgt, void* out_words, void* new_head,
                          void* ds_out, void* erf_out, void* erc_out,
                          void* erl_out, const void* resv, void* claims,
                          void* red, long long rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(red, 0, 8 * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return 0;
  const long long blocks = (rows + PONY_THREADS - 1) / PONY_THREADS;
  pony_fused_kernel<<<(unsigned)blocks, PONY_THREADS, 0, st>>>(
      (int64_t)rows, (const int32_t*)buf, (const int32_t*)head,
      (const int32_t*)n_run, (const int32_t*)ids, pony_fields(fin),
      pony_fields(fout), (int32_t*)out_tgt, (int32_t*)out_words,
      (int32_t*)new_head, (uint8_t*)ds_out, (uint8_t*)erf_out,
      (int32_t*)erc_out, (int32_t*)erl_out, (const int32_t*)resv,
      (int32_t*)claims, (int32_t*)red);
  return (int)cudaGetLastError();
}

#else  // host build: the lanes in order, for the CPU tests

extern "C" int PONY_ENTRY(const void* buf, const void* head,
                          const void* n_run, const void* ids,
                          void* const* fin, void* const* fout,
                          void* out_tgt, void* out_words, void* new_head,
                          void* ds_out, void* erf_out, void* erc_out,
                          void* erl_out, const void* resv, void* claims,
                          void* red, long long rows, void* stream) {
  (void)stream;
  Fields fi, fo;
  for (int k = 0; k < C::NF; ++k) {
    fi.p[k] = fin[k];
    fo.p[k] = fout[k];
  }
  int32_t* r = (int32_t*)red;
  memset(r, 0, 8 * sizeof(int32_t));
  bool any = false;
  for (long long i = 0; i < rows; ++i) {
    PonyLane l = pony_fused_lane(
        i, rows, (const int32_t*)buf, (const int32_t*)head,
        (const int32_t*)n_run, (const int32_t*)ids, fi, fo,
        (int32_t*)out_tgt, (int32_t*)out_words, (int32_t*)new_head,
        (uint8_t*)ds_out, (uint8_t*)erf_out, (int32_t*)erc_out,
        (int32_t*)erl_out, (const int32_t*)resv, (int32_t*)claims);
    r[7] |= l.sf;
    r[0] = (int32_t)((uint32_t)r[0] + (uint32_t)l.nproc);
    r[1] = (int32_t)((uint32_t)r[1] + (uint32_t)l.nbad);
    if (l.ef && !any) {
      any = true;
      r[2] = l.ec;
      r[3] = 1;
    }
  }
  return 0;
}

#endif

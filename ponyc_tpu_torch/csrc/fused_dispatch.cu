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
// The behaviour bodies come from a generated header (pony_cohort.h,
// written by ponyc_tpu_torch/ops/lanecode.py from an ATen-level trace of
// each body, found through -I): the cohort's struct, named PonyCohort
// there, PONY_ENTRY, the name of this library's entry, and PONY_REGROUP,
// PONY_TILE, PONY_RT and PONY_BPS (ops/fused_dispatch.py). Where the TPU
// kernel evaluates every behaviour on every lane and selects, a thread
// here evaluates only the one its message names: bodies are lane-local
// and pure, so that is exact, and it is the reference compiler's
// generated dispatch switch (genfun.c).
//
// Two designs, chosen when the cohort's kernel is built:
//
// - One thread a lane (PONY_REGROUP 0: a cohort of one behaviour, or
//   bodies too cheap for the regroup to pay). The per-lane drain is
//   `pony_lane` (csrc/lane.cuh, shared with the window kernel). A warp
//   whose 32 lanes name several behaviours runs each named body in turn.
// - Lanes regrouped by message id (PONY_REGROUP 1). PONY_BPS persistent
//   blocks of PONY_RT threads a multiprocessor take tiles of PONY_TILE
//   lanes in turn. A block stages a tile's state in shared memory, and
//   for each batch slot k it buckets every lane by the behaviour its
//   message names (or "none": idle, stopped or an id out of range),
//   orders the lanes by bucket with a stable counting sort, and
//   then runs the bodies in that order: the 32 threads of a warp take 32
//   neighbouring places of the order, so most warps run one body. What a
//   lane carries across k (state, stopped, exit, error, destroy, the
//   spawn `used` counter) lives with the lane in shared memory, not with
//   the thread, and the exit key is built from the lane index. At the end
//   the state, heads and planes go back to device memory. A tile whose
//   slots all name one behaviour has nothing to regroup: it runs in
//   place, lane by lane as the first design does. See "The regroup"
//   below.
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
// Bound. Each lane reads its state, head, n_run and id, the words of the
// slots it consumes, and writes its state, head and every outbox entry.
// At ubench's shape (2^20 lanes, cap 4, w1 2, batch 4, ms 1) that is about
// 113 MB, so the kernel is bound by memory, about 0.034 ms at 3.35 TB/s.
// Bodies with long float chains (the mixed model's 64 dependent divisions)
// add operations; chip_smoke.py computes both terms from the run's data.
// With one thread a lane, a warp that holds all 8 of mixed's ids runs 8
// bodies, and the 8 bodies' code overflows the instruction cache; the
// regroup cuts that to about 1.1 bodies a warp, for a sort of a few dozen
// instructions a lane and five barriers a slot (PERF.md section 6).
// The sums go through shared memory, one atomic per block, and the last
// block to finish writes the exit code.
//
// The same source also builds as host C++ (no __CUDACC__): the entry then
// runs the lanes in order on the CPU, or, with the regroup, each tile's
// threads phase by phase in the permuted order the kernel uses (the same
// functions, the block's barriers becoming the ends of loops). The CPU
// tests use that build to hold the generated bodies and the regroup
// against eager torch on a machine without a card.

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

#if PONY_REGROUP
// ---- The regroup ------------------------------------------------------
//
// PONY_BPS blocks of PONY_RT threads a streaming multiprocessor,
// persistent: each takes tiles of PONY_TILE lanes [base, base + PONY_TILE)
// in turn. Thread t owns lanes PONY_LPT*t + q (q < PONY_LPT, a chunk) for
// the key phase, the count and the scatter, keeping their heads, run
// counts, consumed counts and buckets in registers (PonyRegs); it stages
// state in and out for lanes q*PONY_RT + t (coalesced), and runs the
// bodies of places q*PONY_RT + t of the order. For each slot k:
//
//   keys     each lane's bucket: its behaviour, or NB (none: idle,
//            stopped or an id out of range); the thread's count of each
//            bucket into column t of `cnt` [NK, RT]
//   scan     `cnt` flattened bucket-major, exclusive prefix: each thread
//            sums a segment of NK counts, the segments' sums are scanned
//            across the block, each thread rewrites its segment
//   scatter  each lane's place: the next offset of its bucket in its
//            thread's column (stable: by bucket, then by lane)
//   bodies   the lane at each place runs its body on its staged state
//
// with a barrier after each. A lane beyond `rows` (the last tile) is
// never active; its place is skipped. The bodies read the payload and
// write the outbox in device memory directly, in the order's lanes:
// staging those through shared memory and moving them in lane order was
// measured no faster (PERF.md section 6).
//
// Before all that, the block finds the lowest and the highest behaviour
// that the tile's slots name (`span`). Where they are one, there is
// nothing to regroup, and the tile runs in place (`in_place`: pony_lane
// for each lane, as the first design runs it).
//
// The tiling (2,048 lanes, two blocks of 1,024 threads a multiprocessor,
// ptxas held to 32 registers) was chosen by measuring mixed all-hot,
// one-hot and with empty bodies at seven tilings (PERF.md section 6): larger
// tiles and fewer blocks ran all-hot a little faster and one-hot and
// empty bodies slower. Mixed's 8 bodies of 64 rounds are 19,120 lines of
// SASS (about 150 KB); run by one warp after another they overflow the
// instruction cache, so the first design took 22 times as long with all
// 8 ids in every warp as with one. The body loop is not unrolled, so
// that its machine code is one copy of the bodies.

constexpr int PONY_LPT = PONY_TILE / PONY_RT;   // lanes a thread owns
constexpr int PONY_NK = C::NB + 1;              // buckets: ids, then none
static_assert(PONY_TILE % PONY_RT == 0 && PONY_TILE < 65536,
              "a tile is whole threads' lanes, placed by uint16");
static_assert(C::NB < 255, "a bucket fits a byte");

// A lane's flags, carried across k.
enum : uint8_t { PONY_STOPPED = 1, PONY_EF = 2, PONY_DS = 4, PONY_ERF = 8 };

// One tile's shared memory.
struct PonyStage {
  C::State st[PONY_TILE];                       // state, carried across k
  int32_t ec[PONY_TILE];                        // the first exit code
  int32_t erc[C::ERROR ? PONY_TILE : 1];        // the latest error code
  int32_t erl[C::ERROR ? PONY_TILE : 1];        // ... and site
  uint16_t cnt[PONY_NK * PONY_RT];              // counts, then offsets
  int32_t wsum[PONY_RT / 32];                   // the scan's warp totals
  uint16_t perm[PONY_TILE];                     // place -> lane
  uint8_t key[PONY_TILE];                       // bucket at slot k
  uint8_t flags[PONY_TILE];
  uint8_t used[C::NS > 0 ? PONY_TILE : 1];      // spawn dispatches used
};

// What a thread keeps in registers from phase to phase (its chunk).
struct PonyRegs {
  uint32_t h[PONY_LPT], cons[PONY_LPT];         // head, consumed
  int32_t nr[PONY_LPT];                         // n_run
  uint8_t key[PONY_LPT];
  int32_t nproc, nbad;
  bool sf;
};

// The kernel's tensors.
struct PonyArgs {
  int64_t rows;
  const int32_t* __restrict__ buf;
  const int32_t* __restrict__ head;
  const int32_t* __restrict__ n_run;
  const int32_t* __restrict__ ids;
  Fields fin, fout;
  int32_t* __restrict__ out_tgt;
  int32_t* __restrict__ out_words;
  int32_t* __restrict__ new_head;
  uint8_t* __restrict__ ds_out;
  uint8_t* __restrict__ erf_out;
  int32_t* __restrict__ erc_out;
  int32_t* __restrict__ erl_out;
  const int32_t* __restrict__ resv;
  int32_t* __restrict__ claims;
};

// One tile: the phases, each for thread t (see above). A template, so
// that the parts of a cohort without spawns or errors compile out.
template <class K>
struct PonyTile : PonyArgs {
  PonyStage& S;
  int64_t base;

  // The lowest and the highest behaviour that a slot of the thread's
  // lanes q*PONY_RT + t names (an idle slot or an id out of range names
  // none; lo > hi: none at all).
  PONY_FN void span(int t, uint32_t& lo, uint32_t& hi) const {
    lo = 0xffffffffu;
    hi = 0u;
    for (int q = 0; q < PONY_LPT; ++q) {
      const int64_t i = base + q * PONY_RT + t;
      if (i >= rows) continue;
      const uint32_t h = (uint32_t)head[i];
      for (int k = 0; k < K::BATCH && k < n_run[i]; ++k) {
        const uint32_t slot = (h + (uint32_t)k) & (uint32_t)(K::CAP - 1);
        const uint32_t local = (uint32_t)buf[(size_t)slot * K::W1_IN * rows +
                                             i] - (uint32_t)K::BASE;
        if (local < (uint32_t)K::NB) {
          lo = local < lo ? local : lo;
          hi = local > hi ? local : hi;
        }
      }
    }
  }

  // A tile whose slots all name one behaviour runs in place, one lane
  // after another as the one-thread-a-lane kernel runs them; returns the
  // largest exit key of the thread's lanes.
  PONY_FN unsigned long long in_place(int t, PonyRegs& r) const {
    unsigned long long key = 0ull;
#pragma unroll 1
    for (int q = 0; q < PONY_LPT; ++q) {
      const int64_t i = base + q * PONY_RT + t;
      if (i >= rows) continue;
      const PonyLane l = pony_fused_lane(
          i, rows, buf, head, n_run, ids, fin, fout, out_tgt, out_words,
          new_head, ds_out, erf_out, erc_out, erl_out, resv, claims);
      r.nproc += l.nproc;
      r.nbad += l.nbad;
      r.sf = r.sf || l.sf;
      if (l.ef) {
        const unsigned long long lk =
            ((unsigned long long)(0xffffffffu - (uint32_t)i) << 32) |
            (uint32_t)l.ec;
        key = lk > key ? lk : key;
      }
    }
    return key;
  }

  // The tile's state into shared memory; the thread's heads and run
  // counts into registers.
  PONY_FN void load(int t, PonyRegs& r) const {
    for (int q = 0; q < PONY_LPT; ++q) {
      const int p = q * PONY_RT + t;
      const int64_t i = base + p;
      if (i < rows) {
        typename K::State s;
        K::load(s, fin, i);
        S.st[p] = s;
      }
      S.flags[p] = 0;
      if constexpr (K::NS > 0) S.used[p] = 0;
    }
    for (int q = 0; q < PONY_LPT; ++q) {
      const int64_t i = base + PONY_LPT * t + q;
      r.h[q] = i < rows ? (uint32_t)head[i] : 0u;
      r.nr[q] = i < rows ? n_run[i] : 0;
      r.cons[q] = 0;
    }
  }

  // Slot k's bucket of each of the thread's lanes, and the thread's count
  // of each bucket.
  PONY_FN void keys(int t, int k, PonyRegs& r) const {
    for (int q = 0; q < PONY_LPT; ++q) {
      const int p = PONY_LPT * t + q;
      uint8_t b = K::NB;
      if (r.nr[q] > k && !(S.flags[p] & PONY_STOPPED)) {
        const uint32_t slot = (r.h[q] + (uint32_t)k) & (uint32_t)(K::CAP - 1);
        const int32_t local = (int32_t)(
            (uint32_t)buf[(size_t)slot * K::W1_IN * rows + base + p] -
            (uint32_t)K::BASE);
        if (local >= 0 && local < K::NB) {
          b = (uint8_t)local;
          ++r.nproc;
        } else {
          ++r.nbad;
        }
        ++r.cons[q];
      }
      r.key[q] = b;
      S.key[p] = b;
    }
    for (int b = 0; b < PONY_NK; ++b) {
      int32_t c = 0;
      for (int q = 0; q < PONY_LPT; ++q) c += r.key[q] == b;
      S.cnt[b * PONY_RT + t] = (uint16_t)c;
    }
  }

  // The sum of thread t's segment of the flattened counts.
  PONY_FN int32_t seg_sum(int t) const {
    int32_t s = 0;
    for (int j = 0; j < PONY_NK; ++j) s += S.cnt[t * PONY_NK + j];
    return s;
  }

  // The segment's counts turned into offsets, from its exclusive prefix.
  PONY_FN void seg_offsets(int t, int32_t run) const {
    for (int j = 0; j < PONY_NK; ++j) {
      const int32_t v = S.cnt[t * PONY_NK + j];
      S.cnt[t * PONY_NK + j] = (uint16_t)run;
      run += v;
    }
  }

  PONY_FN void scatter(int t, const PonyRegs& r) const {
    for (int q = 0; q < PONY_LPT; ++q)
      S.perm[S.cnt[r.key[q] * PONY_RT + t]++] =
          (uint16_t)(PONY_LPT * t + q);
  }

  // Slot k of the lanes at thread t's places: the body their bucket names
  // on their staged state, their sends and claims, their flags.
  PONY_FN void bodies(int t, int k, PonyRegs& r) const {
#pragma unroll 1
    for (int q = 0; q < PONY_LPT; ++q) {
      const int p = S.perm[q * PONY_RT + t];
      const int64_t i = base + p;
      if (i >= rows) continue;
      typename K::Out o;
      for (int m = 0; m < (K::MS > 0 ? K::MS : 1); ++m) {
        o.tgt[m] = -1;
        for (int j = 0; j < K::W1; ++j) o.w[m][j] = 0;
      }
      o.ef = o.yf = o.ds = o.erf = false;
      o.ec = o.erc = o.erl = 0;
      if constexpr (K::NS > 0) {
        o.sf = false;
        for (int g = 0; g < K::NS; ++g) {
          o.clm[g] = -1;
          o.has[g] = false;
        }
      }
      const int b = S.key[p];
      const PonyPlanes spawn = {resv, claims, rows, i};
      if (b < K::NB) {
        typename K::State s = S.st[p];
        const uint32_t slot =
            ((uint32_t)head[i] + (uint32_t)k) & (uint32_t)(K::CAP - 1);
        int32_t w[K::W1_IN > 1 ? K::W1_IN - 1 : 1];
        for (int j = 1; j < K::W1_IN; ++j)
          w[j - 1] = buf[((size_t)slot * K::W1_IN + j) * rows + i];
        if constexpr (K::NS > 0) {
          const int used = S.used[p];
          int32_t rv[K::NS];
          for (int g = 0; g < K::NS; ++g)
            rv[g] = used < K::SD ? spawn.resv(used, g) : -1;
          K::dispatch(b, s, w, ids[i], rv, o);
        } else {
          K::dispatch(b, s, w, ids[i], nullptr, o);
        }
        S.st[p] = s;
      }
      const PonyOutbox send = {out_tgt, out_words, rows, i};
      for (int m = 0; m < K::MS; ++m) send(k, m, o.tgt[m], o.w[m]);
      if constexpr (K::NS > 0) {
        bool spawned = o.sf;
        for (int g = 0; g < K::NS; ++g) spawned = spawned || o.clm[g] >= 0;
        S.used[p] += spawned;
        r.sf = r.sf || o.sf;
        spawn.claim(k, o);
      }
      uint8_t f = S.flags[p];
      if (o.ef && !(f & PONY_EF)) {          // exit: the first code wins
        f |= PONY_EF;
        S.ec[p] = o.ec;
      }
      if (o.ds) f |= PONY_DS;
      if constexpr (K::ERROR) {
        if (o.erf) {                         // errors: the latest code wins
          f |= PONY_ERF;
          S.erc[p] = o.erc;
          S.erl[p] = o.erl;
        }
      }
      if (!K::NOYIELD && o.yf) f |= PONY_STOPPED;
      S.flags[p] = f;
    }
  }

  // The tile's state, heads and planes back to device memory; returns the
  // largest exit key of the thread's lanes (0: none exited).
  PONY_FN unsigned long long store(int t, const PonyRegs& r) const {
    unsigned long long key = 0ull;
    for (int q = 0; q < PONY_LPT; ++q) {
      const int p = q * PONY_RT + t;
      const int64_t i = base + p;
      if (i >= rows) continue;
      K::store(S.st[p], fout, i);
      const uint8_t f = S.flags[p];
      if constexpr (K::DESTROY) ds_out[i] = (f & PONY_DS) != 0;
      if constexpr (K::ERROR) {
        erf_out[i] = (f & PONY_ERF) != 0;
        erc_out[i] = (f & PONY_ERF) ? S.erc[p] : 0;
        erl_out[i] = (f & PONY_ERF) ? S.erl[p] : 0;
      }
      if (f & PONY_EF) {      // the lowest exiting lane's key is the largest
        const unsigned long long lk =
            ((unsigned long long)(0xffffffffu - (uint32_t)i) << 32) |
            (uint32_t)S.ec[p];
        key = lk > key ? lk : key;
      }
    }
    for (int q = 0; q < PONY_LPT; ++q) {
      const int64_t i = base + PONY_LPT * t + q;
      if (i < rows) new_head[i] = (int32_t)(r.h[q] + r.cons[q]);
    }
    return key;
  }
};
#endif  // PONY_REGROUP

#ifdef __CUDACC__

#if !PONY_REGROUP

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

#else  // PONY_REGROUP

__global__ void __launch_bounds__(PONY_RT, PONY_BPS)
pony_fused_kernel_regroup(
    const PonyArgs a, int32_t* __restrict__ red) {
  extern __shared__ __align__(16) unsigned char pony_smem[];
  __shared__ int32_t s_np, s_nb;
  __shared__ unsigned long long s_key;
  __shared__ unsigned s_lo, s_hi;
  const int t = threadIdx.x;
  if (t == 0) {
    s_np = 0;
    s_nb = 0;
    s_key = 0ull;
  }
  PonyStage& S = *reinterpret_cast<PonyStage*>(pony_smem);
  PonyRegs r;
  r.nproc = r.nbad = 0;
  r.sf = false;
  unsigned long long key = 0ull;
  for (int64_t base = (int64_t)blockIdx.x * PONY_TILE; base < a.rows;
       base += (int64_t)gridDim.x * PONY_TILE) {
    const PonyTile<C> T = {a, S, base};
    // Does any slot of the tile name a behaviour other than the rest?
    if (t == 0) {
      s_lo = 0xffffffffu;
      s_hi = 0u;
    }
    __syncthreads();
    uint32_t lo, hi;
    T.span(t, lo, hi);
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if ((t & 31) == 0) {
      atomicMin(&s_lo, lo);
      atomicMax(&s_hi, hi);
    }
    __syncthreads();
    const bool one = s_lo >= s_hi;
    __syncthreads();
    if (one) {
      const unsigned long long tk = T.in_place(t, r);
      key = tk > key ? tk : key;
      continue;
    }
    T.load(t, r);
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < C::BATCH; ++k) {
      T.keys(t, k, r);
      __syncthreads();
      // The segments' exclusive prefix: a warp scan, then earlier warps'
      // totals.
      const int32_t v = T.seg_sum(t);
      int32_t inc = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, inc, d);
        if ((t & 31) >= d) inc += y;
      }
      if ((t & 31) == 31) S.wsum[t >> 5] = inc;
      __syncthreads();
      int32_t run = inc - v;
      for (int w = 0; w < (t >> 5); ++w) run += S.wsum[w];
      T.seg_offsets(t, run);
      __syncthreads();
      T.scatter(t, r);
      __syncthreads();
      T.bodies(t, k, r);
      __syncthreads();
    }
    const unsigned long long tk = T.store(t, r);
    key = tk > key ? tk : key;
  }
  // The block's sums, as the one-thread-a-lane kernel takes them (a copy,
  // so that kernel keeps its machine code).
  const int32_t np = __reduce_add_sync(0xffffffffu, r.nproc);
  const int32_t nb = __reduce_add_sync(0xffffffffu, r.nbad);
  if ((t & 31) == 0) {
    if (np) atomicAdd(&s_np, np);
    if (nb) atomicAdd(&s_nb, nb);
  }
  if constexpr (C::NS > 0) {
    if (__any_sync(0xffffffffu, r.sf) && (t & 31) == 0) atomicOr(&red[7], 1);
  }
  if (key) atomicMax(&s_key, key);
  __syncthreads();
  if (t == 0) {
    unsigned long long* g_key = (unsigned long long*)(red + 4);
    if (s_np) atomicAdd(&red[0], s_np);
    if (s_nb) atomicAdd(&red[1], s_nb);
    if (s_key) atomicMax(g_key, s_key);
    __threadfence();
    const unsigned ticket = atomicAdd((unsigned*)(red + 6), 1u);
    if (ticket == gridDim.x - 1) {       // the last block: every key is in
      __threadfence();
      const unsigned long long gk = atomicAdd(g_key, 0ull);
      red[2] = gk ? (int32_t)(uint32_t)(gk & 0xffffffffull) : 0;
      red[3] = gk ? 1 : 0;
    }
  }
}

#endif  // PONY_REGROUP

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
#if PONY_REGROUP
  // The tile's stage is dynamic shared memory; past 48 KB the kernel
  // must be allowed it (a refusal is reported, never worked round).
  const int smem = (int)sizeof(PonyStage);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(pony_fused_kernel_regroup,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  const PonyArgs a = {
      (int64_t)rows, (const int32_t*)buf,
      (const int32_t*)head, (const int32_t*)n_run, (const int32_t*)ids,
      pony_fields(fin), pony_fields(fout), (int32_t*)out_tgt,
      (int32_t*)out_words, (int32_t*)new_head, (uint8_t*)ds_out,
      (uint8_t*)erf_out, (int32_t*)erc_out, (int32_t*)erl_out,
      (const int32_t*)resv, (int32_t*)claims};
  // PONY_BPS blocks a multiprocessor (see "The regroup").
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (rows + PONY_TILE - 1) / PONY_TILE;
  const long long slots = (long long)sms * PONY_BPS;
  const unsigned grid = (unsigned)(tiles < slots ? tiles : slots);
  pony_fused_kernel_regroup<<<grid, PONY_RT, smem, st>>>(a, (int32_t*)red);
#else
  const long long blocks = (rows + PONY_THREADS - 1) / PONY_THREADS;
  pony_fused_kernel<<<(unsigned)blocks, PONY_THREADS, 0, st>>>(
      (int64_t)rows, (const int32_t*)buf, (const int32_t*)head,
      (const int32_t*)n_run, (const int32_t*)ids, pony_fields(fin),
      pony_fields(fout), (int32_t*)out_tgt, (int32_t*)out_words,
      (int32_t*)new_head, (uint8_t*)ds_out, (uint8_t*)erf_out,
      (int32_t*)erc_out, (int32_t*)erl_out, (const int32_t*)resv,
      (int32_t*)claims, (int32_t*)red);
#endif
  return (int)cudaGetLastError();
}

#else  // host build, for the CPU tests: the lanes in order, or each tile's
       // threads phase by phase in the kernel's order

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
#if PONY_REGROUP
  const PonyArgs a = {
      (int64_t)rows, (const int32_t*)buf, (const int32_t*)head,
      (const int32_t*)n_run, (const int32_t*)ids, fi, fo,
      (int32_t*)out_tgt, (int32_t*)out_words, (int32_t*)new_head,
      (uint8_t*)ds_out, (uint8_t*)erf_out, (int32_t*)erc_out,
      (int32_t*)erl_out, (const int32_t*)resv, (int32_t*)claims};
  PonyStage* stage = new PonyStage;
  PonyRegs* regs = new PonyRegs[PONY_RT];
  for (int t = 0; t < PONY_RT; ++t) {
    regs[t].nproc = regs[t].nbad = 0;
    regs[t].sf = false;
  }
  unsigned long long best = 0ull;
  for (int64_t base = 0; base < rows; base += PONY_TILE) {
    const PonyTile<C> T = {a, *stage, base};
    uint32_t lo = 0xffffffffu, hi = 0u;
    for (int t = 0; t < PONY_RT; ++t) {
      uint32_t l, h;
      T.span(t, l, h);
      lo = l < lo ? l : lo;
      hi = h > hi ? h : hi;
    }
    if (lo >= hi) {
      for (int t = 0; t < PONY_RT; ++t) {
        const unsigned long long key = T.in_place(t, regs[t]);
        best = key > best ? key : best;
      }
      continue;
    }
    for (int t = 0; t < PONY_RT; ++t) T.load(t, regs[t]);
    for (int k = 0; k < C::BATCH; ++k) {
      for (int t = 0; t < PONY_RT; ++t) T.keys(t, k, regs[t]);
      int32_t run = 0;
      for (int t = 0; t < PONY_RT; ++t) {
        const int32_t v = T.seg_sum(t);
        T.seg_offsets(t, run);
        run += v;
      }
      for (int t = 0; t < PONY_RT; ++t) T.scatter(t, regs[t]);
      for (int t = 0; t < PONY_RT; ++t) T.bodies(t, k, regs[t]);
    }
    for (int t = 0; t < PONY_RT; ++t) {
      const unsigned long long key = T.store(t, regs[t]);
      best = key > best ? key : best;
    }
  }
  for (int t = 0; t < PONY_RT; ++t) {
    r[0] = (int32_t)((uint32_t)r[0] + (uint32_t)regs[t].nproc);
    r[1] = (int32_t)((uint32_t)r[1] + (uint32_t)regs[t].nbad);
    r[7] |= regs[t].sf;
  }
  r[2] = best ? (int32_t)(uint32_t)(best & 0xffffffffull) : 0;
  r[3] = best ? 1 : 0;
  delete[] regs;
  delete stage;
#else
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
#endif
  return 0;
}

#endif

// The whole gated window as one persistent kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ponyc_tpu/ops/megakernel.py: build_mega_window
// (:347), mega (:388), kernel (:427). It computes what the plain window
// ponyc_tpu_torch/runtime/engine.py (build_multi_step_gated, with
// build_step's plan formulation) computes:
//
//   i = 0
//   while (i == 0 && (force || aux_go(aux))) || (i < limit && aux_go(aux)):
//     one scheduler tick (injections on tick 0 only); i += 1
//
// and, with `forced`, the tuner's spelling (engine.build_forced_window):
// `limit` ticks unconditionally, injections every tick.
//
// Design. One cooperative launch of a grid that fits on the card at once
// (occupancy x SMs, so every block is resident); every loop inside is
// grid-stride. A tick is a fixed sequence of phases with a grid-wide sync
// wherever a phase reads what another lane wrote:
//
//   1. spill-pending counts, the largest occupancy, any pressure;
//   2. per lane: unmute (≙ engine.py step 1), then the drain and dispatch
//      of its cohort through `pony_lane` (csrc/lane.cuh, the per-lane code
//      of the fused kernel) into the outbox of the entry list;
//   3. per entry of the delivery list [dspill | inject | rspill | cohort 0
//      outbox (k, m, lane) | cohort 1 ...]: its sort key (plan_key),
//      dead letters, per-target counts, and the first digit's per-tile
//      histograms;
//   4./5. the stable sort: an LSD radix sort over the key range
//      n_local*n_levels+1 in 8-bit digits; each pass is per-tile
//      histograms, a grid-wide exclusive scan in digit-major order, and a
//      scatter with stable in-tile ranks (warp match + per-warp counts).
//      Beside the first pass, the segment bounds (plan_bounds) and the
//      rejection offsets are grid-wide scans of the per-target counts;
//   6. per target: the slot-plane ring rebuild and the spill (rejected
//      entries in sorted order, truncated to spill_cap); per sorted entry:
//      the mute triggers (atomic max and min into the muting-ref table);
//   7. per lane: destroys, mute bookkeeping, the commit of head, tail and
//      the flags; the new spill replaces the old;
//   8. one thread: counters, world_bits, the aux and the gate, read by
//      every block after the sync.
//
// State the kernel updates lies in the caller's tensors (copies of the
// input state). A buffer one phase writes and a later phase reads in the
// same launch is never read through const __restrict__ or the read-only
// cache. Word tables (mailbox rings, spill words) are the int16 + int32
// escape planes of ops/megakernel.py's codec: a word reads as
// `lo == ESC ? esc : lo`, and a write fills both planes.
//
// Numbers. Heads, tails and counters wrap as int32 (unsigned arithmetic).
// Only integer sums cross lanes, so atomics keep the result exact; float
// work stays per lane, built with -fmad=false.
//
// Bound. A ubench tick (2^20 lanes, cap 4, batch 4) reads and writes the
// per-lane state and rings once (about 70 MB), writes and reads the
// entry list, and moves every entry's key and index once per radix pass
// (three passes, about 100 MB each way): a memory bound of roughly 0.1 ms
// a tick at 3.35 TB/s; chip_smoke.py computes it from the run. This first
// version aims to be right: a grid sync costs microseconds, the sort
// moves every entry three times, and nothing is staged in shared memory
// beyond the sort's tiles.
//
// The same source builds as host C++ (no __CUDACC__): one "block" of one
// "thread" runs the phases in order and the grid sync is a no-op. The CPU
// tests hold that build against the plain window.

#include <limits.h>

#include "lane.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
#define PONY_SHARED __shared__
#define PONY_BSYNC() __syncthreads()
#define PONY_GSYNC() cg::this_grid().sync()
#else
#define PONY_SHARED
#define PONY_BSYNC() ((void)0)
#define PONY_GSYNC() ((void)0)
#endif

// The pointer table. ops/megakernel.py reads these names, in this order;
// the 20 previous-aux pointers (engine.StepAux's fields in order) follow
// P_AUX_IN, then the cohorts' pointers (rings lo/esc, then fields).
enum PonyPtr {
  P_HEAD, P_TAIL, P_ALIVE, P_MUTED, P_MUTE_REFS, P_MUTE_AGE, P_MUTE_OVF,
  P_PINNED, P_PRESSURED,
  P_DSPILL_TGT, P_DSPILL_SENDER, P_DSPILL_LO, P_DSPILL_ESC, P_DSPILL_COUNT,
  P_RSPILL_TGT, P_RSPILL_SENDER, P_RSPILL_LO, P_RSPILL_ESC, P_RSPILL_COUNT,
  P_SPILL_OVERFLOW, P_EXIT_FLAG, P_EXIT_CODE, P_STEP_NO, P_N_PROCESSED,
  P_N_DELIVERED, P_N_REJECTED, P_N_BADMSG, P_N_DEADLETTER, P_N_MUTES,
  P_N_DESTROYED, P_SPAWN_FAIL, P_LAST_ERROR, P_LAST_ERROR_LOC, P_N_ERRORS,
  P_PLAN_KEY, P_PLAN_PERM, P_PLAN_BOUNDS, P_WORLD_BITS,
  P_INJECT_TGT, P_INJECT_WORDS, P_WS, P_OUT_BOOL, P_OUT_INT,
  P_AUX_IN,
  P_FIXED = P_AUX_IN + 20
};

// The world: PonyWorld's constants and one struct per cohort (lanecode.py
// emit_cohort, with S0, ROWS, OUT_OFF, LEVEL, PBUF and PFIELD), and
// PONY_COHORTS(X), which applies X to every cohort in row order.
#include "pony_world.h"

typedef PonyWorld W;

constexpr int THREADS = 256;           // = RADIX: one digit per thread
constexpr int RADIX = 256;
constexpr int ROUNDS = 8;
constexpr int64_t TILE = (int64_t)THREADS * ROUNDS;
constexpr int64_t NTILE = (W::E + TILE - 1) / TILE;
constexpr int64_t CH = 2048;           // chunk of the per-target scans
constexpr int64_t NCH = (W::NL + 1 + CH - 1) / CH;
constexpr int64_t OUT0 = 2 * W::SPILL + W::INJ;   // first outbox entry
constexpr int16_t ESC = -32768;

// The workspace (int32 words): offsets of its arrays.
namespace pws {
constexpr int64_t ACC = 0;                       // 64 scalars
constexpr int64_t DSP_CNT = 64;                  // [NL] spill entries a row
constexpr int64_t TCNT = DSP_CNT + W::NL;        // [NL] entries a target
constexpr int64_t WMUTED = TCNT + W::NL;         // [NL] muted after unmute
constexpr int64_t NEWHEAD = WMUTED + W::NL;      // [NL] head after dispatch
constexpr int64_t DSTR = NEWHEAD + W::NL;        // [NL] destroyed this tick
constexpr int64_t NEWLY = DSTR + W::NL;          // [NL] mute triggered
constexpr int64_t ACCW = NEWLY + W::NL;          // [NL] accepted a target
constexpr int64_t RMAX = ACCW + W::NL;           // [K, NL] muting refs
constexpr int64_t RMIN = RMAX + W::K * W::NL;    // [K, NL]
constexpr int64_t ROFF = RMIN + W::K * W::NL;    // [NL+1] spill offsets
constexpr int64_t CTOT = ROFF + W::NL + 1;       // [NCH] chunk totals
constexpr int64_t RTOT = CTOT + NCH;             // [NCH]
constexpr int64_t OUT_TGT = RTOT + NCH;          // [E_OUT]
constexpr int64_t OUT_W = OUT_TGT + W::E_OUT;    // [W1, E_OUT]
constexpr int64_t KA = OUT_W + W::W1 * W::E_OUT; // sort ping-pong [E] x4
constexpr int64_t VA = KA + W::E;
constexpr int64_t KB = VA + W::E;
constexpr int64_t VB = KB + W::E;
constexpr int64_t SKEY = VB + W::E;              // [E] sorted keys
constexpr int64_t COUNTS = SKEY + W::E;          // [RADIX, NTILE]
constexpr int64_t DTOT = COUNTS + RADIX * NTILE; // [RADIX]
constexpr int64_t NSP_TGT = DTOT + RADIX;        // [SPILL] the new spill
constexpr int64_t NSP_SND = NSP_TGT + W::SPILL;
constexpr int64_t NSP_W = NSP_SND + W::SPILL;    // [W1, SPILL]
constexpr int64_t END = NSP_W + W::W1 * W::SPILL;
}  // namespace pws

// Accumulator slots (pws::ACC + ...).
enum PonyAcc {
  A_EXITKEY = 0,   // 64-bit: (0xffffffff - row) << 32 | code, max wins
  A_NPROC = 2, A_NBAD, A_NDESTROYED, A_NERR, A_NDEAD, A_BECAME, A_ANY_OCC,
  A_ANY_MUTED, A_ANY_PR_END, A_OCC_MAX, A_ANY_PR, A_GO, A_NACC
};

struct PonyMegaArgs {
  void* p[W::NPTR];
  int32_t limit, force, forced;
};

struct Grid {
  int64_t block, nblocks, tid, nthreads;
  PONY_FN bool first() const { return block == 0 && tid == 0; }
};

#define PONY_FOR(i, n)                                                   \
  for (int64_t i = g.block * g.nthreads + g.tid; i < (int64_t)(n);       \
       i += g.nblocks * g.nthreads)
#define PONY_FOR_BLOCKS(b, n) \
  for (int64_t b = g.block; b < (int64_t)(n); b += g.nblocks)

// ---- atomics and block-wide sums (plain on the host build) ------------

PONY_FN int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

PONY_FN void g_add(int32_t* p, int32_t v) {
#ifdef __CUDACC__
  atomicAdd(p, v);
#else
  *p = wadd(*p, v);
#endif
}
PONY_FN void g_max(int32_t* p, int32_t v) {
#ifdef __CUDACC__
  atomicMax(p, v);
#else
  if (v > *p) *p = v;
#endif
}
PONY_FN void g_min(int32_t* p, int32_t v) {
#ifdef __CUDACC__
  atomicMin(p, v);
#else
  if (v < *p) *p = v;
#endif
}
PONY_FN void g_max64(unsigned long long* p, unsigned long long v) {
#ifdef __CUDACC__
  atomicMax(p, v);
#else
  if (v > *p) *p = v;
#endif
}

// The block's total of v (every thread of the block calls it).
PONY_FN int32_t block_sum(int32_t v) {
#ifdef __CUDACC__
  __shared__ int32_t s_w[THREADS / 32];
  v = __reduce_add_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_w[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t t = 0;
  for (int w = 0; w < THREADS / 32; ++w) t = wadd(t, s_w[w]);
  return t;
#else
  return v;
#endif
}

// The exclusive prefix of v over the block's threads, and the total.
PONY_FN int32_t block_excl_scan(int32_t v, int32_t* total) {
#ifdef __CUDACC__
  __shared__ int32_t s_s[THREADS / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = wadd(x, y);
  }
  __syncthreads();
  if (lane == 31) s_s[wid] = x;
  __syncthreads();
  int32_t pre = 0, tot = 0;
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < wid) pre = wadd(pre, s_s[w]);
    tot = wadd(tot, s_s[w]);
  }
  *total = tot;
  return wadd(pre, (int32_t)((uint32_t)x - (uint32_t)v));
#else
  *total = v;
  return 0;
#endif
}

// ---- the codec ---------------------------------------------------------

PONY_FN int32_t unpack_word(const int16_t* lo, const int32_t* esc,
                            int64_t k) {
  const int16_t l = lo[k];
  return l == ESC ? esc[k] : (int32_t)l;
}
PONY_FN void pack_word(int16_t* lo, int32_t* esc, int64_t k, int32_t w) {
  const int16_t l = (int16_t)w;
  const bool fits = (int32_t)l == w && l != ESC;
  lo[k] = fits ? l : ESC;
  esc[k] = fits ? 0 : w;
}

PONY_FN int32_t block_max(int32_t v) {
#ifdef __CUDACC__
  __shared__ int32_t s_m[THREADS / 32];
  v = __reduce_max_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_m[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t t = INT_MIN;
  for (int w = 0; w < THREADS / 32; ++w) t = s_m[w] > t ? s_m[w] : t;
  return t;
#else
  return v;
#endif
}

// ---- the entry list ----------------------------------------------------

#define PI32(k) ((int32_t*)a.p[k])
#define PU8(k) ((uint8_t*)a.p[k])
#define PI16(k) ((int16_t*)a.p[k])

// Sender row and delivery level of outbox entry o (cohort C's range).
template <class C>
PONY_FN bool outbox_sender(int64_t o, int32_t* snd) {
  constexpr int64_t n = (int64_t)C::BATCH * C::MS * C::ROWS;
  if (o < C::OUT_OFF || o >= C::OUT_OFF + n) return false;
  *snd = (int32_t)(C::S0 + (o - C::OUT_OFF) % C::ROWS);
  return true;
}

PONY_FN int32_t outbox_sender_of(int64_t o) {
  int32_t snd = -1;
#define PONY_OUT_SENDER(C) \
  if (outbox_sender<C>(o, &snd)) return snd;
  PONY_COHORTS(PONY_OUT_SENDER)
#undef PONY_OUT_SENDER
  return snd;
}

// 2 + the priority rank of row x's cohort (engine.py's prio_row).
PONY_FN int32_t level_of_row(int64_t x) {
#define PONY_ROW_LEVEL(C) \
  if (x >= C::S0 && x < C::S0 + C::ROWS) return C::LEVEL;
  PONY_COHORTS(PONY_ROW_LEVEL)
#undef PONY_ROW_LEVEL
  return 2;
}

PONY_FN int32_t entry_sender(const PonyMegaArgs& a, int64_t e) {
  if (e < W::SPILL) return PI32(P_DSPILL_SENDER)[e];
  if (e < W::SPILL + W::INJ) return -1;
  if (e < OUT0) return PI32(P_RSPILL_SENDER)[e - W::SPILL - W::INJ];
  return outbox_sender_of(e - OUT0);
}

PONY_FN int32_t entry_word(const PonyMegaArgs& a, const int32_t* ws,
                           int64_t e, int j, bool inject) {
  if (e < W::SPILL)
    return unpack_word(PI16(P_DSPILL_LO), PI32(P_DSPILL_ESC),
                       (int64_t)j * W::SPILL + e);
  if (e < W::SPILL + W::INJ)
    return inject ? PI32(P_INJECT_WORDS)[(int64_t)j * W::INJ + e - W::SPILL]
                  : 0;
  if (e < OUT0)
    return unpack_word(PI16(P_RSPILL_LO), PI32(P_RSPILL_ESC),
                       (int64_t)j * W::SPILL + e - W::SPILL - W::INJ);
  return ws[pws::OUT_W + (int64_t)j * W::E_OUT + e - OUT0];
}

// Target row (-1 = none) and level of entry e, as engine.py's delivery
// list gives them.
PONY_FN void entry_target(const PonyMegaArgs& a, const int32_t* ws,
                          int64_t e, bool inject, int32_t* tgt,
                          int32_t* lvl) {
  if (e < W::SPILL) {
    *tgt = PI32(P_DSPILL_TGT)[e];
    *lvl = 0;
  } else if (e < W::SPILL + W::INJ) {
    const int32_t v = inject ? PI32(P_INJECT_TGT)[e - W::SPILL] : -1;
    *tgt = (v >= 0 && v < W::NL) ? v : -1;
    *lvl = 1;
  } else if (e < OUT0) {
    const int64_t q = e - W::SPILL - W::INJ;
    const int32_t t = PI32(P_RSPILL_TGT)[q];
    const int32_t s = PI32(P_RSPILL_SENDER)[q];
    *tgt = t >= 0 ? t : -1;
    *lvl = s >= 0 ? level_of_row(s % W::NL) : 2;
  } else {
    const int32_t t = ws[pws::OUT_TGT + e - OUT0];
    *tgt = t >= 0 ? t : -1;
    *lvl = level_of_row(outbox_sender_of(e - OUT0));
  }
}

// ---- phase 1: spill-pending counts, largest occupancy, any pressure ----

PONY_FN void ph_pending(const PonyMegaArgs& a, const Grid& g, int32_t* ws) {
  const int32_t* dt = PI32(P_DSPILL_TGT);
  PONY_FOR(q, W::SPILL) {
    const int32_t t = dt[q];
    if (t >= 0) g_add(ws + pws::DSP_CNT + (t < W::NL ? t : W::NL - 1), 1);
  }
  const int32_t* head = PI32(P_HEAD);
  const int32_t* tail = PI32(P_TAIL);
  const uint8_t* pr = PU8(P_PRESSURED);
  int32_t mx = INT_MIN, anyp = 0;
  PONY_FOR(r, W::NL) {
    const int32_t occ = (int32_t)((uint32_t)tail[r] - (uint32_t)head[r]);
    mx = occ > mx ? occ : mx;
    anyp |= pr[r];
  }
  mx = block_max(mx);
  anyp = block_sum(anyp);
  if (g.tid == 0) {
    g_max(ws + pws::ACC + A_OCC_MAX, mx);
    if (anyp) g_add(ws + pws::ACC + A_ANY_PR, 1);
  }
}

// ---- phase 2: unmute, then drain and dispatch, per lane -----------------

struct PonySums {
  int32_t nproc, nbad, ndes, nerr;
};

template <class C>
struct MegaRing {
  const int16_t* lo;
  const int32_t* esc;
  int64_t i;
  PONY_FN int32_t operator()(uint32_t slot, int j) const {
    return unpack_word(lo, esc, ((int64_t)slot * C::W1_IN + j) * C::ROWS + i);
  }
};

template <class C>
struct MegaSend {
  int32_t* tgt;
  int32_t* words;
  int64_t i;
  PONY_FN void operator()(int k, int m, int32_t t, const int32_t* w) const {
    const int64_t o = C::OUT_OFF + ((int64_t)k * C::MS + m) * C::ROWS + i;
    tgt[o] = t;
    for (int j = 0; j < C::W1; ++j) words[(int64_t)j * W::E_OUT + o] = w[j];
  }
};

struct MegaFields {
  const PonyMegaArgs* a;
  int base;
  PONY_FN void* operator[](int k) const { return a->p[base + k]; }
};

template <class C>
PONY_FN void lane_dispatch(const PonyMegaArgs& a, int32_t* ws, int64_t r,
                           bool runnable, uint32_t h, int32_t occ0,
                           PonySums& sums) {
  const int64_t i = r - C::S0;
  const int32_t nr = runnable ? (occ0 < C::BATCH ? occ0 : C::BATCH) : 0;
  typename C::State s;
  const MegaFields f = {&a, C::PFIELD};
  C::load(s, f, i);
  const MegaRing<C> ring = {(const int16_t*)a.p[C::PBUF],
                            (const int32_t*)a.p[C::PBUF + 1], i};
  const MegaSend<C> send = {ws + pws::OUT_TGT, ws + pws::OUT_W, i};
  const PonyLane l = pony_lane<C>(s, h, nr, (int32_t)r, ring, send);
  C::store(s, f, i);
  ws[pws::NEWHEAD + r] = (int32_t)(h + l.consumed);
  ws[pws::DSTR + r] = l.ds;
  if (l.erf) {                     // errors: the latest code per actor
    PI32(P_LAST_ERROR)[r] = l.erc;
    PI32(P_LAST_ERROR_LOC)[r] = l.erl;
  }
  sums.nproc = wadd(sums.nproc, l.nproc);
  sums.nbad = wadd(sums.nbad, l.nbad);
  sums.ndes += l.ds;
  sums.nerr += l.erf;
  if (l.ef)                        // exit: the lowest exiting row wins
    g_max64((unsigned long long*)(ws + pws::ACC + A_EXITKEY),
            ((unsigned long long)(0xffffffffu - (uint32_t)r) << 32) |
                (uint32_t)l.ec);
}

PONY_FN void ph_lanes(const PonyMegaArgs& a, const Grid& g, int32_t* ws) {
  const int32_t* head = PI32(P_HEAD);
  const int32_t* tail = PI32(P_TAIL);
  const uint8_t* alive = PU8(P_ALIVE);
  const uint8_t* muted = PU8(P_MUTED);
  const uint8_t* pr = PU8(P_PRESSURED);
  int32_t* refs = PI32(P_MUTE_REFS);
  uint8_t* ovf = PU8(P_MUTE_OVF);
  const int32_t* age = PI32(P_MUTE_AGE);
  const int32_t* dcnt = ws + pws::DSP_CNT;
  const bool any_pr = ws[pws::ACC + A_ANY_PR] > 0;
  const int32_t rsp = PI32(P_RSPILL_COUNT)[0];
  const bool quiet = ws[pws::ACC + A_OCC_MAX] <= W::UNMUTE &&
                     PI32(P_DSPILL_COUNT)[0] == 0 && rsp == 0 && !any_pr;
  PonySums sums = {0, 0, 0, 0};
  PONY_FOR(r, W::NL) {
    // Unmute (≙ ponyint_sched_unmute_senders, scheduler.c:1552-1635): a
    // sender releases when every muting receiver has recovered, or by age.
    bool all_ok = true, by_pr = false, by_live = false;
    for (int k = 0; k < W::K; ++k) {
      const int32_t ref = refs[(int64_t)k * W::NL + r];
      const bool has = ref >= 0;
      const bool local = has && ref < W::NL;
      const int64_t x = ref < 0 ? 0 : (ref < W::NL ? ref : W::NL - 1);
      const int32_t occx = (int32_t)((uint32_t)tail[x] - (uint32_t)head[x]);
      const bool local_ok = has && local && occx <= W::UNMUTE &&
                            dcnt[x] == 0 && !pr[x];
      const bool remote_ok = has && !local && rsp == 0 && !pr[x];
      all_ok = all_ok && (!has || local_ok || remote_ok);
      if (W::AGE > 0 && has) {
        by_pr = by_pr || pr[x];
        by_live = by_live || (((occx > W::UNMUTE) || dcnt[x] > 0) &&
                              alive[x] && !muted[x]);
      }
    }
    const bool m0 = muted[r], o0 = ovf[r];
    bool aged_ok = false;
    if constexpr (W::AGE > 0)
      aged_ok = age[r] >= (int32_t)(W::AGE + r % W::AGE) && !by_pr &&
                !by_live && (!o0 || !any_pr);
    const bool release = m0 && ((all_ok && (!o0 || quiet)) || aged_ok);
    if (release) {
      for (int k = 0; k < W::K; ++k) refs[(int64_t)k * W::NL + r] = -1;
      ovf[r] = 0;
    }
    const bool wm = m0 && !release;
    ws[pws::WMUTED + r] = wm;
    // Drain and dispatch (≙ the actor run loop).
    const uint32_t h = (uint32_t)head[r];
    const int32_t occ0 = (int32_t)((uint32_t)tail[r] - h);
    const bool runnable = alive[r] && !wm;
#define PONY_LANE(C) \
    if (r < C::S0 + C::ROWS) lane_dispatch<C>(a, ws, r, runnable, h, occ0, sums); else
    PONY_COHORTS(PONY_LANE) {}
#undef PONY_LANE
  }
  const int32_t np = block_sum(sums.nproc), nb = block_sum(sums.nbad);
  const int32_t nd = block_sum(sums.ndes), ne = block_sum(sums.nerr);
  if (g.tid == 0) {
    if (np) g_add(ws + pws::ACC + A_NPROC, np);
    if (nb) g_add(ws + pws::ACC + A_NBAD, nb);
    if (nd) g_add(ws + pws::ACC + A_NDESTROYED, nd);
    if (ne) g_add(ws + pws::ACC + A_NERR, ne);
  }
}

// ---- phase 3: keys, dead letters, per-target counts, first histograms --

PONY_FN void ph_keys(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                     bool inject) {
  PONY_SHARED int32_t hist[RADIX];
  const uint8_t* alive = PU8(P_ALIVE);
  int32_t* key_out = PI32(P_PLAN_KEY);
  int32_t ndead = 0;
  PONY_FOR_BLOCKS(tile, NTILE) {
    for (int64_t d = g.tid; d < RADIX; d += g.nthreads) hist[d] = 0;
    PONY_BSYNC();
    const int64_t e1 = (tile + 1) * TILE < W::E ? (tile + 1) * TILE : W::E;
    for (int64_t e = tile * TILE + g.tid; e < e1; e += g.nthreads) {
      int32_t tgt, lvl;
      entry_target(a, ws, e, inject, &tgt, &lvl);
      const bool in_range = tgt >= 0 && tgt < W::NL;
      const bool dead = in_range && !alive[tgt];
      const bool valid = in_range && !dead;
      const int32_t key = valid ? tgt * (int32_t)W::NLEV + lvl
                                : (int32_t)(W::NL * W::NLEV);
      key_out[e] = key;
      if (valid) g_add(ws + pws::TCNT + tgt, 1);
      ndead += dead;
      g_add(&hist[key & (RADIX - 1)], 1);
    }
    PONY_BSYNC();
    for (int64_t d = g.tid; d < RADIX; d += g.nthreads)
      ws[pws::COUNTS + d * NTILE + tile] = hist[d];
    PONY_BSYNC();
  }
  ndead = block_sum(ndead);
  if (g.tid == 0 && ndead) g_add(ws + pws::ACC + A_NDEAD, ndead);
}

// ---- the radix sort's passes -------------------------------------------

// Per-tile histograms of digit `pass` of `keys`.
PONY_FN void ph_hist(const Grid& g, int32_t* ws, const int32_t* keys,
                     int pass) {
  PONY_SHARED int32_t hist[RADIX];
  PONY_FOR_BLOCKS(tile, NTILE) {
    for (int64_t d = g.tid; d < RADIX; d += g.nthreads) hist[d] = 0;
    PONY_BSYNC();
    const int64_t e1 = (tile + 1) * TILE < W::E ? (tile + 1) * TILE : W::E;
    for (int64_t e = tile * TILE + g.tid; e < e1; e += g.nthreads)
      g_add(&hist[(keys[e] >> (8 * pass)) & (RADIX - 1)], 1);
    PONY_BSYNC();
    for (int64_t d = g.tid; d < RADIX; d += g.nthreads)
      ws[pws::COUNTS + d * NTILE + tile] = hist[d];
    PONY_BSYNC();
  }
}

// Exclusive scan of each digit's row of tile counts, and the row totals.
PONY_FN void ph_scan(const Grid& g, int32_t* ws) {
  PONY_FOR_BLOCKS(d, RADIX) {
    int32_t* row = ws + pws::COUNTS + d * NTILE;
    int32_t carry = 0;
    for (int64_t b = 0; b < NTILE; b += g.nthreads) {
      const int64_t t = b + g.tid;
      const int32_t v = t < NTILE ? row[t] : 0;
      int32_t tot;
      const int32_t ex = block_excl_scan(v, &tot);
      if (t < NTILE) row[t] = carry + ex;
      carry += tot;
    }
    if (g.tid == 0) ws[pws::DTOT + d] = carry;
  }
}

// The stable scatter of one pass: entry idx of tile t with digit d goes
// to (entries of smaller digits) + (digit d in earlier tiles) + (digit d
// earlier in this tile). `vals` null: the value is the entry's index.
PONY_FN void ph_scatter(const Grid& g, int32_t* ws, const int32_t* keys,
                        const int32_t* vals, int32_t* kout, int32_t* vout,
                        int pass) {
  PONY_SHARED int32_t s_base[RADIX];
  const int shift = 8 * pass;
  const int32_t* counts = ws + pws::COUNTS;
  const int32_t* dtot = ws + pws::DTOT;
#ifdef __CUDACC__
  __shared__ int32_t s_wc[THREADS / 32][RADIX];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  PONY_FOR_BLOCKS(tile, NTILE) {
    int32_t tot;
    const int32_t ex = block_excl_scan(dtot[threadIdx.x], &tot);
    s_base[threadIdx.x] = ex + counts[threadIdx.x * NTILE + tile];
    __syncthreads();
    for (int rd = 0; rd < ROUNDS; ++rd) {
      const int64_t idx = tile * TILE + (int64_t)rd * THREADS + threadIdx.x;
      const bool has = idx < W::E;
      int32_t key = 0, val = 0;
      int d = RADIX;
      if (has) {
        key = keys[idx];
        val = vals ? vals[idx] : (int32_t)idx;
        d = (key >> shift) & (RADIX - 1);
      }
      for (int w = 0; w < THREADS / 32; ++w) s_wc[w][threadIdx.x] = 0;
      __syncthreads();
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (has && rank == 0) s_wc[wid][d] = __popc(peers);
      __syncthreads();
      if (has) {
        int32_t dest = s_base[d] + rank;
        for (int w = 0; w < wid; ++w) dest += s_wc[w][d];
        kout[dest] = key;
        vout[dest] = val;
      }
      __syncthreads();
      int32_t sum = 0;
      for (int w = 0; w < THREADS / 32; ++w) sum += s_wc[w][threadIdx.x];
      s_base[threadIdx.x] += sum;
      __syncthreads();
    }
  }
#else
  PONY_FOR_BLOCKS(tile, NTILE) {
    int32_t run = 0;
    for (int d = 0; d < RADIX; ++d) {
      s_base[d] = run + counts[d * NTILE + tile];
      run += dtot[d];
    }
    const int64_t e1 = (tile + 1) * TILE < W::E ? (tile + 1) * TILE : W::E;
    for (int64_t idx = tile * TILE; idx < e1; ++idx) {
      const int32_t key = keys[idx];
      const int d = (key >> shift) & (RADIX - 1);
      const int32_t dest = s_base[d]++;
      kout[dest] = key;
      vout[dest] = vals ? vals[idx] : (int32_t)idx;
    }
  }
#endif
}

// ---- segment bounds and rejection offsets ------------------------------

// Per chunk of targets: accepted = min(count, free space), rejected =
// count - accepted, and the chunk-local exclusive scans of both.
PONY_FN void ph_target_scan(const PonyMegaArgs& a, const Grid& g,
                            int32_t* ws) {
  const int32_t* tail = PI32(P_TAIL);
  int32_t* bounds = PI32(P_PLAN_BOUNDS);
  PONY_FOR_BLOCKS(c, NCH) {
    const int64_t end = (c + 1) * CH < W::NL + 1 ? (c + 1) * CH : W::NL + 1;
    int32_t cb = 0, cr = 0;
    for (int64_t b = c * CH; b < end; b += g.nthreads) {
      const int64_t t = b + g.tid;
      int32_t cnt = 0, rej = 0;
      if (t < W::NL) {
        cnt = ws[pws::TCNT + t];
        const int32_t occ =
            (int32_t)((uint32_t)tail[t] - (uint32_t)ws[pws::NEWHEAD + t]);
        int32_t space = (int32_t)((uint32_t)W::CAP - (uint32_t)occ);
        space = space < 0 ? 0 : space;
        const int32_t acc = cnt < space ? cnt : space;
        ws[pws::ACCW + t] = acc;
        rej = cnt - acc;
      }
      int32_t tb, tr;
      const int32_t eb = block_excl_scan(cnt, &tb);
      const int32_t er = block_excl_scan(rej, &tr);
      if (t < end) {
        bounds[t] = cb + eb;
        ws[pws::ROFF + t] = cr + er;
      }
      cb += tb;
      cr += tr;
    }
    if (g.tid == 0) {
      ws[pws::CTOT + c] = cb;
      ws[pws::RTOT + c] = cr;
    }
  }
}

// Add each chunk's prefix of the chunk totals.
PONY_FN void ph_target_fix(const PonyMegaArgs& a, const Grid& g,
                           int32_t* ws) {
  int32_t* bounds = PI32(P_PLAN_BOUNDS);
  PONY_FOR_BLOCKS(c, NCH) {
    int32_t pb = 0, pr = 0;
    for (int64_t k = g.tid; k < c; k += g.nthreads) {
      pb += ws[pws::CTOT + k];
      pr += ws[pws::RTOT + k];
    }
    pb = block_sum(pb);
    pr = block_sum(pr);
    const int64_t end = (c + 1) * CH < W::NL + 1 ? (c + 1) * CH : W::NL + 1;
    for (int64_t t = c * CH + g.tid; t < end; t += g.nthreads) {
      bounds[t] += pb;
      ws[pws::ROFF + t] += pr;
    }
  }
}

// ---- phase 6: ring rebuild, spill, mute triggers ------------------------

// Ring slot c of target t takes sorted entry bounds[t] + (c - tail) mod
// cap where that is below the accepted count (delivery.py's slot planes).
template <class C>
PONY_FN void ring_fill(const PonyMegaArgs& a, const int32_t* ws, int64_t t,
                       uint32_t tl, int32_t acc, int32_t b, bool inject) {
  const int64_t i = t - C::S0;
  int16_t* lo = (int16_t*)a.p[C::PBUF];
  int32_t* esc = (int32_t*)a.p[C::PBUF + 1];
  const int32_t* perm = PI32(P_PLAN_PERM);
  for (int c = 0; c < C::CAP; ++c) {
    const uint32_t rel = ((uint32_t)c - tl) & (uint32_t)(C::CAP - 1);
    if ((int64_t)rel >= acc) continue;
    int64_t p = (int64_t)b + rel;
    p = p < W::E - 1 ? p : W::E - 1;
    const int64_t e = perm[p];
    for (int j = 0; j < C::W1_IN; ++j)
      pack_word(lo, esc, ((int64_t)c * C::W1_IN + j) * C::ROWS + i,
                entry_word(a, ws, e, j, inject));
  }
}

PONY_FN int32_t occ_after(const int32_t* tail, const int32_t* ws,
                          int64_t x) {
  return (int32_t)((uint32_t)tail[x] + (uint32_t)ws[pws::ACCW + x] -
                   (uint32_t)ws[pws::NEWHEAD + x]);
}

PONY_FN void ph_deliver(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                        bool inject) {
  const int32_t* bounds = PI32(P_PLAN_BOUNDS);
  const int32_t* perm = PI32(P_PLAN_PERM);
  const int32_t* tail = PI32(P_TAIL);
  const uint8_t* pr = PU8(P_PRESSURED);
  PONY_FOR(t, W::NL) {
    const int32_t acc = ws[pws::ACCW + t];
    const int32_t b = bounds[t];
    if (acc > 0) {
      const uint32_t tl = (uint32_t)tail[t];
#define PONY_FILL(C) \
      if (t < C::S0 + C::ROWS) ring_fill<C>(a, ws, t, tl, acc, b, inject); else
      PONY_COHORTS(PONY_FILL) {}
#undef PONY_FILL
    }
    // The rejected entries, in sorted order, after those of lower targets.
    const int32_t nrej = bounds[t + 1] - b - acc;
    const int32_t ro = ws[pws::ROFF + t];
    for (int32_t j = 0; j < nrej && (int64_t)ro + j < W::SPILL; ++j) {
      const int64_t e = perm[(int64_t)b + acc + j];
      const int64_t q = (int64_t)ro + j;
      ws[pws::NSP_TGT + q] = (int32_t)t;
      ws[pws::NSP_SND + q] = entry_sender(a, e);
      for (int k = 0; k < W::W1; ++k)
        ws[pws::NSP_W + (int64_t)k * W::SPILL + q] =
            entry_word(a, ws, e, k, inject);
    }
  }
  // Mute triggers (≙ actor.c:898-921): a valid send whose receiver
  // rejected it, is overloaded or pressured mutes its sender, unless the
  // sender is itself overloaded or pressured.
  const int32_t* skey = ws + pws::SKEY;
  PONY_FOR(p, W::E) {
    const int32_t kt = skey[p] / (int32_t)W::NLEV;
    if (kt >= W::NL) continue;
    const int32_t snd = entry_sender(a, perm[p]);
    if (snd < 0 || snd >= W::NL) continue;
    const bool rej = p - bounds[kt] >= ws[pws::ACCW + kt];
    const bool recv_hot = occ_after(tail, ws, kt) > W::OVERLOAD || pr[kt];
    const bool send_hot = occ_after(tail, ws, snd) > W::OVERLOAD || pr[snd];
    if ((rej || recv_hot) && !send_hot) {
      ws[pws::NEWLY + snd] = 1;
      const int64_t k = kt % W::K;
      g_max(ws + pws::RMAX + k * W::NL + snd, kt);
      g_min(ws + pws::RMIN + k * W::NL + snd, kt);
    }
  }
}

// ---- phase 7: destroys, mute bookkeeping, commit ------------------------

PONY_FN void ph_commit(const PonyMegaArgs& a, const Grid& g, int32_t* ws) {
  int32_t* head = PI32(P_HEAD);
  int32_t* tail = PI32(P_TAIL);
  uint8_t* alive = PU8(P_ALIVE);
  uint8_t* muted = PU8(P_MUTED);
  int32_t* refs = PI32(P_MUTE_REFS);
  int32_t* age = PI32(P_MUTE_AGE);
  uint8_t* ovf = PU8(P_MUTE_OVF);
  uint8_t* pinned = PU8(P_PINNED);
  uint8_t* pr = PU8(P_PRESSURED);
  int32_t any_occ = 0, any_m = 0, any_p = 0, became_n = 0;
  PONY_FOR(r, W::NL) {
    const uint32_t nt = (uint32_t)tail[r] + (uint32_t)ws[pws::ACCW + r];
    uint32_t nh = (uint32_t)ws[pws::NEWHEAD + r];
    const bool d = ws[pws::DSTR + r] != 0;
    const bool al = alive[r] && !d;
    bool wm = ws[pws::WMUTED + r] != 0;
    bool o = ovf[r];
    if (d) {                 // ≙ ponyint_actor_destroy, actor.c:570-664
      nh = nt;
      wm = false;
      o = false;
      for (int k = 0; k < W::K; ++k) refs[(int64_t)k * W::NL + r] = -1;
      pinned[r] = 0;
      pr[r] = 0;
    }
    // ≙ ponyint_mute_actor + mutemap insert, actor.c:1171-1207.
    const bool newly = ws[pws::NEWLY + r] && al;
    const bool became = newly && !wm;
    const bool m2 = wm || newly;
    if (newly) {
      bool novf = false, clash = false;
      for (int k = 0; k < W::K; ++k) {
        const int64_t kk = (int64_t)k * W::NL + r;
        const int32_t mx = ws[pws::RMAX + kk], mn = ws[pws::RMIN + kk];
        novf = novf || (mx >= 0 && mn != mx);
        const int32_t old = refs[kk];
        clash = clash || (old >= 0 && mx >= 0 && old != mx);
        refs[kk] = old < 0 ? mx : (mx < 0 ? old : (old > mx ? old : mx));
      }
      o = o || novf || clash;
    }
    age[r] = m2 ? (became ? 0 : (int32_t)((uint32_t)age[r] + 1u)) : 0;
    head[r] = (int32_t)nh;
    tail[r] = (int32_t)nt;
    alive[r] = al;
    muted[r] = m2;
    ovf[r] = o;
    any_occ |= (int32_t)(nt - nh) > 0;
    any_m |= m2;
    any_p |= pr[r];
    became_n += became;
    // This tick's per-lane scratch, cleared for the next.
    ws[pws::DSP_CNT + r] = 0;
    ws[pws::TCNT + r] = 0;
    ws[pws::NEWLY + r] = 0;
    for (int k = 0; k < W::K; ++k) {
      ws[pws::RMAX + (int64_t)k * W::NL + r] = -1;
      ws[pws::RMIN + (int64_t)k * W::NL + r] = INT_MAX;
    }
  }
  // The new spill replaces the old (rejections beyond spill_cap are lost
  // and flagged as an overflow at the gate).
  const int32_t rtot = ws[pws::ROFF + W::NL];
  const int64_t n_sp = rtot < W::SPILL ? rtot : W::SPILL;
  PONY_FOR(q, W::SPILL) {
    const bool v = q < n_sp;
    PI32(P_DSPILL_TGT)[q] = v ? ws[pws::NSP_TGT + q] : -1;
    PI32(P_DSPILL_SENDER)[q] = v ? ws[pws::NSP_SND + q] : -1;
    for (int k = 0; k < W::W1; ++k)
      pack_word(PI16(P_DSPILL_LO), PI32(P_DSPILL_ESC),
                (int64_t)k * W::SPILL + q,
                v ? ws[pws::NSP_W + (int64_t)k * W::SPILL + q] : 0);
  }
  any_occ = block_sum(any_occ);
  any_m = block_sum(any_m);
  any_p = block_sum(any_p);
  became_n = block_sum(became_n);
  if (g.tid == 0) {
    if (any_occ) g_add(ws + pws::ACC + A_ANY_OCC, 1);
    if (any_m) g_add(ws + pws::ACC + A_ANY_MUTED, 1);
    if (any_p) g_add(ws + pws::ACC + A_ANY_PR_END, 1);
    if (became_n) g_add(ws + pws::ACC + A_BECAME, became_n);
  }
}

// ---- phase 8: counters, aux and the gate (one thread) -------------------

// engine.StepAux's fields in order: 0-2 and 4-8 are bool, the rest int32.
// Host and device: pony_mega_aux_layout reports it to the wrapper.
#ifdef __CUDACC__
__host__ __device__
#endif
inline bool aux_is_bool(int k) { return k <= 8 && k != 3; }
// The window's aux output: out_bool [8] = device_pending, host_pending,
// exit_flag, spill_overflow, spawn_fail, blob_fail, blob_budget_fail,
// any_muted; out_int [13] = exit_code, n_processed, n_delivered, occ_sum,
// occ_max, n_muted_now, n_overloaded_now, n_rejected, n_badmsg,
// n_deadletter, n_mutes, qw_p99, then ticks run.
enum { OB_PENDING, OB_HOST, OB_EXIT, OB_OVERFLOW, OB_SPAWN, OB_BLOB,
       OB_BUDGET, OB_MUTED };
enum { OI_CODE, OI_NPROC, OI_NDELIV, OI_TICKS = 12 };

PONY_FN bool aux_go(const uint8_t* b) {
  return b[OB_PENDING] && !b[OB_HOST] && !b[OB_EXIT] && !b[OB_OVERFLOW] &&
         !b[OB_SPAWN] && !b[OB_BLOB] && !b[OB_BUDGET];
}

PONY_FN void acc_reset(int32_t* acc) {
  for (int k = 0; k < A_NACC; ++k) acc[k] = 0;
  acc[A_OCC_MAX] = INT_MIN;
}

PONY_FN void ph_gate(const PonyMegaArgs& a, int32_t* ws, int32_t i) {
  int32_t* acc = ws + pws::ACC;
  uint8_t* ob = PU8(P_OUT_BOOL);
  int32_t* oi = PI32(P_OUT_INT);
  const unsigned long long key = *(unsigned long long*)(acc + A_EXITKEY);
  uint8_t* ef = PU8(P_EXIT_FLAG);
  int32_t* ec = PI32(P_EXIT_CODE);
  if (key && !ef[0]) ec[0] = (int32_t)(uint32_t)(key & 0xffffffffull);
  ef[0] = ef[0] || key;
  const int32_t nb = PI32(P_PLAN_BOUNDS)[W::NL];
  const int32_t rtot = ws[pws::ROFF + W::NL];
  const int32_t n_sp = rtot < W::SPILL ? rtot : (int32_t)W::SPILL;
  int32_t* c;
  c = PI32(P_N_PROCESSED); c[0] = wadd(c[0], acc[A_NPROC]);
  c = PI32(P_N_DELIVERED); c[0] = wadd(c[0], nb - rtot);
  c = PI32(P_N_REJECTED); c[0] = wadd(c[0], rtot);
  c = PI32(P_N_BADMSG); c[0] = wadd(c[0], acc[A_NBAD]);
  c = PI32(P_N_DEADLETTER); c[0] = wadd(c[0], acc[A_NDEAD]);
  c = PI32(P_N_MUTES); c[0] = wadd(c[0], acc[A_BECAME]);
  c = PI32(P_N_DESTROYED); c[0] = wadd(c[0], acc[A_NDESTROYED]);
  c = PI32(P_N_ERRORS); c[0] = wadd(c[0], acc[A_NERR]);
  c = PI32(P_STEP_NO); c[0] = wadd(c[0], 1);
  PI32(P_DSPILL_COUNT)[0] = n_sp;
  uint8_t* so = PU8(P_SPILL_OVERFLOW);
  so[0] = so[0] || rtot > W::SPILL;
  const bool rsp = PI32(P_RSPILL_COUNT)[0] > 0;
  const bool pending = acc[A_ANY_OCC] > 0 || n_sp > 0 || rsp;
  const bool any_m = acc[A_ANY_MUTED] > 0;
  PI32(P_WORLD_BITS)[0] =
      (acc[A_ANY_PR_END] > 0) | (any_m << 1) | ((int32_t)rsp << 2);
  ob[OB_PENDING] = pending;
  ob[OB_HOST] = 0;
  ob[OB_EXIT] = ef[0];
  ob[OB_OVERFLOW] = so[0];
  ob[OB_SPAWN] = PU8(P_SPAWN_FAIL)[0];
  ob[OB_BLOB] = 0;
  ob[OB_BUDGET] = 0;
  ob[OB_MUTED] = any_m;
  for (int k = 0; k < OI_TICKS; ++k) oi[k] = 0;
  oi[OI_CODE] = ec[0];
  oi[OI_NPROC] = PI32(P_N_PROCESSED)[0];
  oi[OI_NDELIV] = PI32(P_N_DELIVERED)[0];
  oi[OI_TICKS] = i + 1;
  acc_reset(acc);
  acc[A_GO] = (i + 1 < a.limit) && (a.forced || aux_go(ob));
}

// ---- the window ---------------------------------------------------------

PONY_FN void pony_window(const PonyMegaArgs& a, const Grid& g) {
  int32_t* ws = (int32_t*)a.p[P_WS];
  PONY_FOR(r, W::NL) {
    ws[pws::DSP_CNT + r] = 0;
    ws[pws::TCNT + r] = 0;
    ws[pws::NEWLY + r] = 0;
    for (int k = 0; k < W::K; ++k) {
      ws[pws::RMAX + (int64_t)k * W::NL + r] = -1;
      ws[pws::RMIN + (int64_t)k * W::NL + r] = INT_MAX;
    }
  }
  if (g.first()) {
    // A window that runs no tick returns the previous aux unchanged.
    uint8_t* ob = PU8(P_OUT_BOOL);
    int32_t* oi = PI32(P_OUT_INT);
    int nb = 0, ni = 0;
    for (int k = 0; k < 20; ++k) {
      if (aux_is_bool(k)) ob[nb++] = *(const uint8_t*)a.p[P_AUX_IN + k] != 0;
      else oi[ni++] = *(const int32_t*)a.p[P_AUX_IN + k];
    }
    oi[OI_TICKS] = 0;
    acc_reset(ws + pws::ACC);
    ws[pws::ACC + A_GO] = a.forced ? a.limit > 0 : (a.force || aux_go(ob));
  }
  PONY_GSYNC();
  for (int32_t i = 0;; ++i) {
    if (!*(volatile int32_t*)(ws + pws::ACC + A_GO)) break;
    const bool inject = a.forced || i == 0;
    ph_pending(a, g, ws);
    PONY_GSYNC();
    ph_lanes(a, g, ws);
    PONY_GSYNC();
    ph_keys(a, g, ws, inject);
    PONY_GSYNC();
    ph_scan(g, ws);
    ph_target_scan(a, g, ws);
    PONY_GSYNC();
    for (int pass = 0; pass < W::NPASS; ++pass) {
      if (pass > 0) {
        ph_hist(g, ws, ws + (pass % 2 ? pws::KA : pws::KB), pass);
        PONY_GSYNC();
        ph_scan(g, ws);
        PONY_GSYNC();
      }
      const bool last = pass == W::NPASS - 1;
      const int32_t* kin = pass == 0 ? PI32(P_PLAN_KEY)
                                     : ws + (pass % 2 ? pws::KA : pws::KB);
      const int32_t* vin = pass == 0 ? nullptr
                                     : ws + (pass % 2 ? pws::VA : pws::VB);
      int32_t* kout = last ? ws + pws::SKEY
                           : ws + (pass % 2 ? pws::KB : pws::KA);
      int32_t* vout = last ? PI32(P_PLAN_PERM)
                           : ws + (pass % 2 ? pws::VB : pws::VA);
      ph_scatter(g, ws, kin, vin, kout, vout, pass);
      if (pass == 0) ph_target_fix(a, g, ws);
      PONY_GSYNC();
    }
    ph_deliver(a, g, ws, inject);
    PONY_GSYNC();
    ph_commit(a, g, ws);
    PONY_GSYNC();
    if (g.first()) ph_gate(a, ws, i);
    PONY_GSYNC();
  }
}

// ---- entry points ------------------------------------------------------

// Words of int32 workspace the window needs, and the pointer-table length.
extern "C" long long pony_mega_ws_words() { return pws::END; }
extern "C" int pony_mega_nptr() { return W::NPTR; }

// The aux layout, for ops/megakernel.py to check against engine.StepAux
// at bind time: out[0] the number of previous-aux pointers; out[1 + k]
// for StepAux field k its output slot (bool slots 0.., int slots
// 100 + slot); then the slots this file names: OB_PENDING .. OB_MUTED,
// 100 + OI_CODE, 100 + OI_NPROC, 100 + OI_NDELIV, 100 + OI_TICKS.
// Returns the number of ints written (out holds at least 64).
extern "C" int pony_mega_aux_layout(int* out) {
  const int n = P_FIXED - P_AUX_IN;
  int m = 0, nb = 0, ni = 0;
  out[m++] = n;
  for (int k = 0; k < n; ++k) out[m++] = aux_is_bool(k) ? nb++ : 100 + ni++;
  const int named[] = {OB_PENDING, OB_HOST, OB_EXIT, OB_OVERFLOW, OB_SPAWN,
                       OB_BLOB, OB_BUDGET, OB_MUTED, 100 + OI_CODE,
                       100 + OI_NPROC, 100 + OI_NDELIV, 100 + OI_TICKS};
  for (int v : named) out[m++] = v;
  return m;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS) pony_mega_kernel(
    const PonyMegaArgs a) {
  const Grid g = {blockIdx.x, gridDim.x, threadIdx.x, blockDim.x};
  pony_window(a, g);
}

// out: blocks per SM, SMs, grid, registers a thread, local (spill) bytes
// a thread, static shared bytes a block, cooperative launch supported.
extern "C" int pony_mega_info(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, pony_mega_kernel);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, coop = 0, nb = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, pony_mega_kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = nb;
  out[1] = sms;
  out[2] = nb * sms;
  out[3] = fa.numRegs;
  out[4] = (int)fa.localSizeBytes;
  out[5] = (int)fa.sharedSizeBytes;
  out[6] = coop;
  return 0;
}

// One cooperative launch of `grid` blocks on `stream`; returns the launch
// error (cudaErrorCooperativeLaunchTooLarge where the grid does not fit).
// Allocates nothing and does not synchronise.
extern "C" int pony_mega_launch(void* const* ptrs, int limit, int force,
                                int forced, int grid, void* stream) {
  PonyMegaArgs a;
  for (int k = 0; k < W::NPTR; ++k) a.p[k] = ptrs[k];
  a.limit = limit;
  a.force = force;
  a.forced = forced;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)pony_mega_kernel, dim3((unsigned)grid), dim3(THREADS),
      args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#else  // host build: one block of one thread, the phases in order

extern "C" int pony_mega_launch(void* const* ptrs, int limit, int force,
                                int forced, int grid, void* stream) {
  (void)grid;
  (void)stream;
  PonyMegaArgs a;
  for (int k = 0; k < W::NPTR; ++k) a.p[k] = ptrs[k];
  a.limit = limit;
  a.force = force;
  a.forced = forced;
  const Grid g = {0, 1, 0, 1};
  pony_window(a, g);
  return 0;
}

#endif

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
// Design. One cooperative launch; every loop inside is grid-stride, so the
// grid may be any size that fits on the card at once. The wrapper sizes it
// to the world (ops/megakernel.py: grid_blocks): the smaller of occupancy
// x SMs and what the widest phase can use (lanes or entries over the block
// size). A tick is six phases on a segment tick and 5 + 3 * NPASS on a
// radix tick, each ended by a grid-wide sync, and two more first where the
// program spawns on the device (W::SPAWN, a constant of pony_world.h, so
// the other programs' kernels have no spawn code at all):
//
//   0. (spawn world only) census: per row, unmute (≙ engine.py step 1),
//      and each block's count of the free rows of spawn targets (dead,
//      mailbox empty, no spilled message addressed to them) and of the
//      runnable rows of spawners, over a contiguous range of rows a
//      block; reserve: every block's prefix of those counts, then the
//      free rows compacted in row order and each runnable spawner's rank
//      (engine.py step 1b: free_row_list, spawn_reservations);
//   1. lanes: per lane, unmute (unless the census did), then the drain
//      and dispatch of its cohort through `pony_lane` (csrc/lane.cuh, the
//      per-lane code of the fused kernel) into the outbox of the entry
//      list (a host cohort's row, from W::FH on, is not dispatched: its
//      head passes through, and the host drains it between windows); a
//      spawner reads its reservations from the free list at its
//      window (offset + rank * SD * sites) and marks each row it claims
//      (BORN, and its sync constructor's values); the claims apply where
//      engine.py's step 2b would have them: a claimed row counts as alive
//      in `keys`, its ring fills from 0 in `deliver`, and `commit` makes
//      it alive with head and tail 0 and its fields set (no phase reads a
//      claimed row's state in the phase that writes it);
//   2. keys: per entry of the delivery list [dspill | inject | rspill |
//      cohort 0 outbox (k, m, lane) | cohort 1 ...], its sort key
//      (plan_key), dead letters, per-target counts (the atomic returns
//      the entry's slot in its target's segment) and the live entries of
//      each tile;
//   3. scan: per-target scans (plan_bounds, acceptance, rejection offsets,
//      the largest segment, each lane's overloaded-or-pressured flag) and
//      the tiles' live prefix;
//   4. the stable sort (plan_perm = argsort(key, stable=True)), one of
//      two, chosen on the device from the tick's own counts:
//      - segment (no target got more than SEG entries, as in ubench,
//        mixed, nbody and the ring): each live entry goes to the slot
//        phase 2 gave it, every block places the dead entries after the
//        live ones in entry order (dead keys all equal NL*NLEV, sort
//        last), and phase 5 sorts each segment by (level, entry);
//      - radix (fan-in): an LSD radix sort over the key range in NPASS
//        passes of DBITS-bit digits (two under 2^22), reduce then scan:
//        each block owns a contiguous run of tiles and moves its entries
//        from its digit offsets, ranking each tile stably (warp-private
//        digit counts in shared memory, `__match_any_sync` within a round
//        of 32, the walk replayed to place); each pass is three phases:
//        a count, a scan of the counts and the move;
//   5. deliver: per target, (segment tick) the sort of its segment, the
//      slot-plane ring rebuild and the spill (rejected entries in sorted
//      order, truncated to spill_cap) and the next tick's spill-pending
//      counts; the mute triggers (atomic max and min into the muting-ref
//      table) per live sorted entry (per target on a segment tick), whose
//      sender is read only for an entry that was rejected or whose
//      receiver is hot;
//   6. commit: per lane, destroys, mute bookkeeping, the commit of head,
//      tail and the flags, and the next tick's largest occupancy and
//      pressure; the new spill replaces the old.
//
// Where the program uses the device blob pool (W::BLOB, a constant of
// pony_world.h, so the other programs' kernels have no blob code), the
// census also counts each block's free pool slots and runnable rows of
// allocating cohorts (and whether one of them has queued work), and one
// more phase follows it:
//
//   0c. bfree: each runnable allocating row's rank, and, unless no
//       allocating row has queued work, the free slots compacted in
//       ascending order (≙ the JAX package's compact_mask(~blob_used));
//       a lane's alloc sites read their window of it (offset + rank * BD
//       * sites + d * sites + site, engine.py's blob_reservations), and
//       its blob ops load and store the pool directly (csrc/lane.cuh:
//       one owner a blob, and a tick's free list fixed before lanes, so
//       no two lanes write one slot). The gate ORs the sticky fail flags
//       into OB_BLOB and OB_BUDGET and adds the alloc, free and remote
//       counts.
//
// Then every block computes the gate from the tick's accumulators (two
// sets, by tick parity, so a block that reads one set never races the
// reset of the other); block 0 writes the counters and the aux. No sync
// follows the gate. Host rows (W::HOST, a constant of pony_world.h, so
// a program without host cohorts has none of this code) take delivery
// like any other row: they are targets in keys, the sort and deliver
// (their rings are the host cohorts' tables, PONY_HOSTS), they reject
// into the spill and mute their senders; the commit counts an occupied
// one apart from the device rows, and the gate writes it as
// host_pending (OB_HOST), which ends the window for the host's drain.
//
// Telemetry (W::PROF at analysis >= 1, W::EV at analysis >= 3, W::TRACE
// with causal tracing; constants of pony_world.h, so the kernels of other
// programs have none of this code) replays engine.py's profile_lanes,
// phase_cost_lanes, trace_span_lanes, event ring and aggregates:
//
//   keys: per device row, over a contiguous range of rows a block, the
//     slots its lane drained (head to NEWHEAD): beh_runs by behaviour id,
//     the queue-wait bucket of step - qwait_enq into the cohort's
//     histogram, the drained count; with tracing, each block's count of
//     traced drained slots per (cohort, ring slot) (BTR);
//   scan (tracing): each traced drained slot's rank, in the reference's
//     slot-major [cap, rows] order within a cohort, from those counts
//     (a block's prefix over the blocks before it), its span id and its
//     span-ring row; then every outbox entry's two trailing words,
//     (trace id, span id) of the batch slot that emitted it, or (-1, 0);
//   deliver: beh_delivered of every filled slot, the fresh slots'
//     qwait_enq stamps (device cohorts) and trace_buf rows;
//   commit: beh_rejected from the new spill, coh_mute_ticks, the
//     occupancy aggregates; at W::EV each row's transitions (mute,
//     release, overload-on, spawn, destroy, error), over a contiguous
//     range of rows a block, and each block's count of each;
//   gate: the event ring in the reference's class-major, row order (every
//     block writes its rows from its prefix, and stops where the ring is
//     full), the phase costs, the span and event counters, and the aux's
//     aggregates and qw_p99 from the cumulative histograms.
//
// Counts go through per-block shared counters (warp-aggregated) and one
// atomic per counter per block; integer sums do not depend on order. The
// rings are compacted in the reference's order by block prefix sums, never
// by atomic slot claims.
//
// State the kernel updates lies in the caller's tensors (copies of the
// input state). Word tables (mailbox rings, spill words) are int32, read
// and written in place. A buffer one phase writes and a later phase reads
// in the same launch is never read through const __restrict__ or the
// read-only cache.
//
// Numbers. Heads, tails and counters wrap as int32 (unsigned arithmetic).
// Only integer sums cross lanes, so atomics keep the result exact; float
// work stays per lane, built with -fmad=false.
//
// Bound. A ubench tick (2^20 lanes, cap 4, batch 4) must read and write
// the per-lane state and rings once and write the last plan (about
// 172 MB a tick, 0.05 ms at 3.35 TB/s; chip_smoke.py::mega_bound). This
// design also writes and reads the entry list and moves each entry's key
// and index once (a segment tick) or once a pass (a radix tick). What
// bounds it now is latency, not bytes: the dispatch's per-lane work, the
// delivery's dependent gathers through plan_perm, the sort's scattered
// 4-byte stores and atomics, and for a small world the grid syncs. The
// per-phase clock (P_CLOCK) measures each phase.
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
// P_AUX_IN, then the cohorts' pointers (the ring, then the fields).
enum PonyPtr {
  P_HEAD, P_TAIL, P_ALIVE, P_MUTED, P_MUTE_REFS, P_MUTE_AGE, P_MUTE_OVF,
  P_PINNED, P_PRESSURED,
  P_DSPILL_TGT, P_DSPILL_SENDER, P_DSPILL_WORDS, P_DSPILL_COUNT,
  P_RSPILL_TGT, P_RSPILL_SENDER, P_RSPILL_WORDS, P_RSPILL_COUNT,
  P_SPILL_OVERFLOW, P_EXIT_FLAG, P_EXIT_CODE, P_STEP_NO, P_N_PROCESSED,
  P_N_DELIVERED, P_N_REJECTED, P_N_BADMSG, P_N_DEADLETTER, P_N_MUTES,
  P_N_DESTROYED, P_SPAWN_FAIL, P_LAST_ERROR, P_LAST_ERROR_LOC, P_N_ERRORS,
  P_PLAN_KEY, P_PLAN_PERM, P_PLAN_BOUNDS, P_WORLD_BITS,
  P_INJECT_TGT, P_INJECT_WORDS, P_WS, P_OUT_BOOL, P_OUT_INT, P_CLOCK,
  P_N_SPAWNED, P_AUX_IN,
  P_FIXED = P_AUX_IN + 20
};

// The world: PonyWorld's constants (NPASS and DBITS from
// ops/megakernel.py: radix_plan; SPAWN, whether any cohort spawns on the
// device; NI, the words a sync construction writes; NCOH, the cohorts) and
// one struct per cohort (lanecode.py emit_cohort, with S0, ROWS, OUT_OFF,
// LEVEL, PBUF, PFIELD, CIDX and TARGET, and its spawn sites), and
// PONY_COHORTS(X), which applies X to every device cohort in row order;
// HOST, whether the program has host cohorts, FH, their first row, one
// struct per host cohort (S0, ROWS, CAP, W1_IN and PBUF: its ring) and
// PONY_HOSTS(X), which applies X to each of them in row order (nothing
// without host cohorts); BLOB, whether a cohort uses the blob pool, BSL
// and BW, the pool's slots and words, and PBLOB, the first of the pool's
// nine pointers (data, used, len, gen, blob_fail, blob_budget_fail,
// n_blob_alloc, n_blob_free, n_blob_remote) after every ring (none
// without the pool).
#include "pony_world.h"

typedef PonyWorld W;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                        // entries a thread a tile
constexpr int64_t TILE = (int64_t)THREADS * ITEMS;
constexpr int64_t NTILE = (W::E + TILE - 1) / TILE;
constexpr int WROUNDS = ITEMS;                   // rounds of 32 a warp
constexpr int32_t SEG = (int32_t)W::SEG;         // segment tick: each
                                                 // target's entries <= this
constexpr int NPASS = (int)W::NPASS;
constexpr int DBITS = (int)W::DBITS;
constexpr int RADIX = 1 << DBITS;
constexpr int32_t DEAD = (int32_t)(W::NL * W::NLEV);   // a dead entry's key
// Chunk of the per-target scans: at least one round of 32 a warp, and
// at most about 1,024 chunks (256 targets a chunk for the ring's 1,024
// lanes, 2,048 at 2^20 lanes).
constexpr int64_t pow2_at_least(int64_t x) {
  int64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}
constexpr int64_t CH = pow2_at_least((W::NL + 1 + 1023) / 1024) > 256
                           ? pow2_at_least((W::NL + 1 + 1023) / 1024)
                           : 256;
constexpr int64_t NCH = (W::NL + 1 + CH - 1) / CH;
constexpr int64_t OUT0 = 2 * W::SPILL + W::INJ;   // first outbox entry
constexpr int ACC_SET = 32;            // words of one accumulator set
constexpr int64_t GMAX = 1024;         // the most blocks a launch may have
static_assert(RADIX <= 2048, "a digit is at most 11 bits");
static_assert(W::E < (1LL << 31), "entry indices are int32");

// The workspace (int32 words): offsets of its arrays.
namespace pws {
constexpr int64_t ACC = 0;                       // 2 sets, by tick parity
constexpr int64_t DSP_CNT = 2 * ACC_SET;         // [NL] spill entries a row
constexpr int64_t TCNT = DSP_CNT + W::NL;        // [NL] entries a target
constexpr int64_t WMUTED = TCNT + W::NL;         // [NL] muted after unmute
constexpr int64_t NEWHEAD = WMUTED + W::NL;      // [NL] head after dispatch
constexpr int64_t DSTR = NEWHEAD + W::NL;        // [NL] destroyed this tick
constexpr int64_t NEWLY = DSTR + W::NL;          // [NL] mute triggered
constexpr int64_t ACCW = NEWLY + W::NL;          // [NL] accepted a target
constexpr int64_t RMAX = ACCW + W::NL;           // [K, NL] muting refs
constexpr int64_t RMIN = RMAX + W::K * W::NL;    // [K, NL]
constexpr int64_t ROFF = RMIN + W::K * W::NL;    // [NL+1] spill offsets
constexpr int64_t BLOC = ROFF + W::NL + 1;       // [NL+1] chunk-local bounds
constexpr int64_t CTOT = BLOC + W::NL + 1;       // [NCH] chunk totals
constexpr int64_t RTOT = CTOT + NCH;             // [NCH]
constexpr int64_t OUT_TGT = RTOT + NCH;          // [E_OUT]
constexpr int64_t OUT_W = OUT_TGT + W::E_OUT;    // [E_OUT, W1] entry-major
constexpr int64_t KA = OUT_W + W::W1 * W::E_OUT; // sort ping-pong [E] x4
constexpr int64_t VA = KA + W::E;
constexpr int64_t KB = VA + W::E;
constexpr int64_t VB = KB + W::E;
constexpr int64_t SKEY = VB + W::E;              // [E] sorted keys (radix)
constexpr int64_t SLOT = SKEY + W::E;            // [E] slot in its segment
constexpr int64_t HOT = SLOT + W::E;             // [NL] overloaded/pressured
constexpr int64_t LCNT = HOT + W::NL;            // [NTILE+1] live a tile
constexpr int64_t GTOT = LCNT + NTILE + 1;       // [NPASS, RADIX]
constexpr int64_t BCNT = GTOT + NPASS * RADIX;   // [RADIX, GMAX] a block's
constexpr int64_t NSP_TGT = BCNT + RADIX * GMAX;  // new spill
constexpr int64_t NSP_SND = NSP_TGT + W::SPILL;
constexpr int64_t NSP_W = NSP_SND + W::SPILL;    // [W1, SPILL]
// Device spawns (empty unless W::SPAWN): each block's free and runnable
// counts, every cohort's prefix of both at its first row (and the totals
// at NCOH), the compacted free rows, each runnable spawner's global
// runnable prefix, each row's claim this tick (1, or 2 with its sync
// constructor's values in BINIT [NI, NL]).
constexpr int64_t SPN = W::SPAWN ? 1 : 0;
constexpr int64_t BFREE = NSP_W + W::W1 * W::SPILL;  // [GMAX]
constexpr int64_t BRUN = BFREE + SPN * GMAX;         // [GMAX]
constexpr int64_t FPRE = BRUN + SPN * GMAX;          // [NCOH + 1]
constexpr int64_t UPRE = FPRE + SPN * (W::NCOH + 1); // [NCOH + 1]
constexpr int64_t FREE = UPRE + SPN * (W::NCOH + 1); // [NL]
constexpr int64_t RANK = FREE + SPN * W::NL;         // [NL]
constexpr int64_t BORN = RANK + SPN * W::NL;         // [NL]
constexpr int64_t BINIT = BORN + SPN * W::NL;        // [NI, NL]
// The blob pool (empty unless W::BLOB): each block's free slots, runnable
// allocating rows and whether one of them has queued work; every cohort's
// runnable prefix at its first row; the free slots compacted (and their
// count); each runnable allocating row's global prefix.
constexpr int64_t BPN = W::BLOB ? 1 : 0;
constexpr int64_t BFREEB = BINIT + SPN * W::NI * W::NL;  // [GMAX]
constexpr int64_t BRUNB = BFREEB + BPN * GMAX;           // [GMAX]
constexpr int64_t BBUSY = BRUNB + BPN * GMAX;            // [GMAX]
constexpr int64_t UPREB = BBUSY + BPN * GMAX;            // [NCOH + 1]
constexpr int64_t NFREEB = UPREB + BPN * (W::NCOH + 1);  // [1]
constexpr int64_t FREEB = NFREEB + BPN;                  // [BSL]
constexpr int64_t RANKB = FREEB + BPN * W::BSL;          // [NL]
// Telemetry (empty unless W::TRACE / W::EV): each block's traced drained
// slots per (cohort, ring slot); each row's error flag and transition bits
// this tick, and each block's count of each transition class.
constexpr int64_t TRN = W::TRACE ? 1 : 0;
constexpr int64_t EVN = W::EV ? 1 : 0;
constexpr int64_t BTR = RANKB + BPN * W::NL;     // [NCOH, CAP, GMAX]
constexpr int64_t ERRF = BTR + TRN * W::NCOH * W::CAP * GMAX;   // [NL]
constexpr int64_t EVM = ERRF + EVN * W::NL;      // [NL]
constexpr int64_t BEV = EVM + EVN * W::NL;       // [6, GMAX]
constexpr int64_t END = BEV + EVN * 6 * GMAX;
static_assert(ACC % 2 == 0, "the 64-bit exit key is aligned");
}  // namespace pws

// Accumulator slots (within a set).
enum PonyAcc {
  A_EXITKEY = 0,   // 64-bit: (0xffffffff - row) << 32 | code, max wins
  A_NPROC = 2, A_NBAD, A_NDESTROYED, A_NERR, A_NDEAD, A_SEGMAX,
  A_BECAME, A_ANY_OCC, A_ANY_MUTED, A_ANY_PR_END, A_OCC_MAX, A_NSPAWN,
  A_SFAIL, A_HOSTOCC, A_BALLOC, A_BFREE, A_BREMOTE, A_BFAIL, A_BBUDGET,
  // Telemetry (W::PROF): the occupancy aggregates, the phase costs'
  // delivery-list entries and drained slots, the spans of the tick.
  A_PROF0, A_OCCSUM = A_PROF0, A_NMUTED, A_NOVER, A_PCDELIV, A_PCDRAIN,
  A_SPANS, A_NACC
};
static_assert(A_NACC <= ACC_SET, "an accumulator set holds them all");

struct PonyMegaArgs {
  void* p[W::NPTR];
  int32_t limit, force, forced;
};

struct Grid {
  int64_t block, nblocks, tid, nthreads;
  PONY_FN bool first() const { return block == 0 && tid == 0; }
};

// Shared memory, one buffer for the phases that use it in turn.
struct Smem {
  union {
    uint16_t wh[WARPS][RADIX];          // scatter: per-warp digit counts
    int32_t hist[RADIX];                // radix count: a block's digits
    int32_t cpre[NCH];                  // segment place: chunk prefix
  } u;
  int32_t off[RADIX];                   // scatter: the block's digit offsets
};

#define PONY_FOR(i, n)                                                   \
  for (int64_t i = g.block * g.nthreads + g.tid; i < (int64_t)(n);       \
       i += g.nblocks * g.nthreads)
#define PONY_FOR_BLOCKS(b, n) \
  for (int64_t b = g.block; b < (int64_t)(n); b += g.nblocks)
// This block's contiguous range of tiles (a radix pass's count and move
// share it, so a block's digit counts describe what it will move).
#define PONY_FOR_MY_TILES(t)                                   \
  for (int64_t t = NTILE * g.block / g.nblocks,               \
               t##_end = NTILE * (g.block + 1) / g.nblocks;   \
       t < t##_end; ++t)

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

// In-place exclusive scan of n words by one block; returns the total.
PONY_FN int32_t block_scan_array(const Grid& g, int32_t* x, int64_t n) {
  int32_t carry = 0;
  for (int64_t b = 0; b < n; b += g.nthreads) {
    const int64_t t = b + g.tid;
    const int32_t v = t < n ? x[t] : 0;
    int32_t tot;
    const int32_t ex = block_excl_scan(v, &tot);
    if (t < n) x[t] = wadd(carry, ex);
    carry = wadd(carry, tot);
  }
  return carry;
}

// ---- telemetry: per-block counters ------------------------------------

// The telemetry leaves, W::PTEL + k (the profiler's at W::PROF, the event
// ring's at W::EV, the span ring's at W::TRACE; ops/megakernel.py:
// telemetry_leaves).
enum PonyTel {
  T_RUNS, T_DELIV, T_REJ, T_MUTE, T_QWH, T_PHASE, T_EVDATA, T_EVCOUNT,
  T_EVDROP, T_SPDATA, T_SPCOUNT, T_SPDROP, T_SPNEXT
};
constexpr int QWB = 16;              // queue-wait buckets (state.py)
constexpr int NEVC = 6;              // event classes (codes 1..6)

// A bucket of a queue-wait delta: k for [2^k, 2^(k+1)), deltas below 1
// as 1, the last bucket open (engine.py: _qwait_bucket).
PONY_FN int32_t qwait_bucket(int32_t d) {
  d = d < 1 ? 1 : d;
  int32_t b = 0;
  for (int k = 1; k < QWB; ++k) b += d >= (1 << k);
  return b;
}

#if PONY_PROF
// A block's shared counters, by section: beh_runs, beh_delivered,
// beh_rejected [NB] each, coh_mute_ticks [NCOH], qwait_hist [NCOH, QWB].
constexpr int64_t TS_RUNS = 0, TS_DELIV = W::NB, TS_REJ = 2 * W::NB,
                  TS_MUTE = 3 * W::NB, TS_QWH = 3 * W::NB + W::NCOH,
                  TEL_N = 3 * W::NB + (1 + QWB) * W::NCOH;

#ifdef __CUDACC__
PONY_FN int32_t* tel_smem() {
  __shared__ int32_t s[TEL_N > 0 ? TEL_N : 1];
  return s;
}
#else
// The host build's counters: a variable of internal linkage, one for each
// program's library (a static local of an inline function would be one
// symbol for the whole process, shared by every library loaded).
static thread_local int32_t pony_tel_host[TEL_N > 0 ? TEL_N : 1];
static inline int32_t* tel_smem() { return pony_tel_host; }
#endif

// Count one at s[k] where `on`: the lanes of a warp that meet here with
// the same k add together, through one shared atomic.
PONY_FN void tel_count(int32_t* s, int32_t k, bool on) {
#ifdef __CUDACC__
  const unsigned act = __activemask();
  const unsigned peers = __match_any_sync(act, on ? k : -1);
  if (on && (peers & ((1u << (threadIdx.x & 31)) - 1u)) == 0)
    atomicAdd(s + k, (int32_t)__popc(peers));
#else
  if (on) s[k] = wadd(s[k], 1);
#endif
}

// Add a section of the block's counters into the leaf `dst` (one atomic
// per nonzero counter) and clear it. Every thread of the block calls it.
PONY_FN void tel_flush(const Grid& g, int32_t* s, int64_t n, int32_t* dst) {
  PONY_BSYNC();
  for (int64_t k = g.tid; k < n; k += g.nthreads) {
    const int32_t v = s[k];
    if (v) {
      g_add(dst + k, v);
      s[k] = 0;
    }
  }
}
#endif

// ---- the entry list ----------------------------------------------------

#define PI32(k) ((int32_t*)a.p[k])
#define PU8(k) ((uint8_t*)a.p[k])

// Sender row of outbox entry o (cohort C's range).
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
  if (e < W::SPILL) return PI32(P_DSPILL_WORDS)[(int64_t)j * W::SPILL + e];
  if (e < W::SPILL + W::INJ)
    return inject ? PI32(P_INJECT_WORDS)[(int64_t)j * W::INJ + e - W::SPILL]
                  : 0;
  if (e < OUT0)
    return PI32(P_RSPILL_WORDS)[(int64_t)j * W::SPILL + e - W::SPILL -
                                W::INJ];
  return ws[pws::OUT_W + (e - OUT0) * W::W1 + j];
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

// ---- the window's prologue: spill-pending counts, occupancy, pressure ---

// For tick 0 only; later ticks get these from the deliver (spill-pending
// counts) and commit (largest occupancy, any pressure) phases before them.
PONY_FN void ph_pending(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                        int32_t* prev) {
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
    g_max(prev + A_OCC_MAX, mx);
    if (anyp) g_add(prev + A_ANY_PR_END, 1);
  }
}

// ---- phase 1: unmute, then drain and dispatch, per lane -----------------

struct PonySums {
  int32_t nproc, nbad, ndes, nerr, nspawn, sf;
};
// A blob world's lane sums (the other worlds keep PonySums as it was).
struct PonySumsB : PonySums {
  PonyBlobAcc blob;
};
typedef std::conditional<W::BLOB != 0, PonySumsB, PonySums>::type Sums;
// The blob members of the world's sums and sticky scalars, through
// templates: code that reads them sits behind `if constexpr (W::BLOB)`,
// and a template is not instantiated in a discarded branch, so the other
// worlds' types need no such members.
template <class S>
PONY_FN PonyBlobAcc& sums_blob(S& s) { return s.blob; }

template <class C>
struct MegaRing {
  const int32_t* buf;
  int64_t i;
  PONY_FN int32_t operator()(uint32_t slot, int j) const {
    return buf[((int64_t)slot * C::W1_IN + j) * C::ROWS + i];
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
    for (int j = 0; j < C::W1; ++j) words[o * W::W1 + j] = w[j];
  }
};

struct MegaFields {
  const PonyMegaArgs* a;
  int base;
  PONY_FN void* operator[](int k) const { return a->p[base + k]; }
};

// A spawner's reservations and claims. Reservation (dispatch d, flat site
// g) of the runnable spawner of rank `rank` in its cohort: the target
// cohort's compacted free row at its static offset + rank * SD * sites +
// d * sites + site, -1 past the free rows. A claim marks the row born
// (BORN, 2 with its sync constructor's values in BINIT); the commit phase
// applies it. Reservation windows are disjoint, so no two lanes claim one
// row.
template <class C>
struct MegaSpawn {
  int32_t* ws;
  int64_t rank;
  PONY_FN int32_t resv(int d, int g) const {
    const int t = C::site_target(g);
    const int32_t f0 = ws[pws::FPRE + t];
    const int64_t idx = (int64_t)C::site_off(g) + rank * C::site_per(g) +
                        (int64_t)d * C::site_n(g);
    return idx < (int64_t)(ws[pws::FPRE + t + 1] - f0)
               ? ws[pws::FREE + f0 + idx]
               : -1;
  }
  template <class O>
  PONY_FN void claim(int k, const O& o) const {
    (void)k;
    for (int g = 0; g < C::NS; ++g) {
      const int32_t ref = o.clm[g];
      if (ref < 0) continue;
      ws[pws::BORN + ref] = o.has[g] ? 2 : 1;
      if (o.has[g])
        for (int f = 0; f < C::NI; ++f)
          ws[pws::BINIT + (int64_t)f * W::NL + ref] = o.iv[g][f];
    }
  }
};

// A blob cohort's pool and reservations: alloc site g of dispatch window d
// of the runnable row of rank `rank` in its cohort reads the compacted
// free list at BOFF + rank * BD * NBS + d * NBS + g (-1 past the free
// slots).
template <class C>
struct MegaBlob {
  PonyBlobPool pool;
  const int32_t* ws;
  int64_t rank;
  PonyBlobAcc* acc;
  PONY_FN int32_t resv(int d, int g) const {
    const int64_t idx = (int64_t)C::BOFF + rank * (C::BD * C::NBS) +
                        (int64_t)d * C::NBS + g;
    return idx < (int64_t)ws[pws::NFREEB] ? ws[pws::FREEB + idx] : -1;
  }
};

PONY_FN PonyBlobPool blob_pool(const PonyMegaArgs& a) {
  return {PI32(W::PBLOB), PU8(W::PBLOB + 1), PI32(W::PBLOB + 2),
          PI32(W::PBLOB + 3), (int64_t)W::BSL, (int32_t)W::BW};
}

template <class C>
PONY_FN void lane_dispatch(const PonyMegaArgs& a, int32_t* ws,
                           int32_t* cur, int64_t r, bool runnable,
                           uint32_t h, int32_t occ0, Sums& sums) {
  const int64_t i = r - C::S0;
  const int32_t nr = runnable ? (occ0 < C::BATCH ? occ0 : C::BATCH) : 0;
  typename C::State s;
  const MegaFields f = {&a, C::PFIELD};
  C::load(s, f, i);
  const MegaRing<C> ring = {(const int32_t*)a.p[C::PBUF], i};
  const MegaSend<C> send = {ws + pws::OUT_TGT, ws + pws::OUT_W, i};
  std::conditional_t<C::BLOB, MegaBlob<C>, PonyNoBlob> blob{};
  if constexpr (C::BLOB) {
    const int64_t rank = runnable && C::NBS > 0
        ? (int64_t)(ws[pws::RANKB + r] - ws[pws::UPREB + C::CIDX]) : 0;
    blob = {blob_pool(a), ws, rank, &sums_blob(sums)};
  }
  PonyLane l;
  if constexpr (C::NS > 0) {
    const int64_t rank = runnable
        ? (int64_t)(ws[pws::RANK + r] - ws[pws::UPRE + C::CIDX]) : 0;
    const MegaSpawn<C> spawn = {ws, rank};
    l = pony_lane<C>(s, h, nr, (int32_t)r, ring, send, spawn, blob);
    sums.nspawn += l.nclaim;
    sums.sf |= l.sf;
  } else {
    l = pony_lane<C>(s, h, nr, (int32_t)r, ring, send, PonyNoSpawn(), blob);
  }
  C::store(s, f, i);
  ws[pws::NEWHEAD + r] = (int32_t)(h + l.consumed);
  ws[pws::DSTR + r] = l.ds;
  if (l.erf) {                     // errors: the latest code per actor
    PI32(P_LAST_ERROR)[r] = l.erc;
    PI32(P_LAST_ERROR_LOC)[r] = l.erl;
  }
  if constexpr (W::EV) ws[pws::ERRF + r] = l.erf;   // the error event
  sums.nproc = wadd(sums.nproc, l.nproc);
  sums.nbad = wadd(sums.nbad, l.nbad);
  sums.ndes += l.ds;
  sums.nerr += l.erf;
  if (l.ef)                        // exit: the lowest exiting row wins
    g_max64((unsigned long long*)(cur + A_EXITKEY),
            ((unsigned long long)(0xffffffffu - (uint32_t)r) << 32) |
                (uint32_t)l.ec);
}

// Unmute (≙ ponyint_sched_unmute_senders, scheduler.c:1552-1635): a
// sender releases when every muting receiver has recovered, or by age.
// Writes row r's mute table and WMUTED[r]; returns whether r stays muted.
// `prev` holds the previous tick's largest occupancy and pressure (the
// prologue's for tick 0); `dsp` is the current spill's length.
struct Unmute {
  const int32_t *head, *tail, *age, *dcnt;
  const uint8_t *alive, *muted, *pr;
  int32_t* refs;
  uint8_t* ovf;
  bool any_pr, quiet;
  int32_t rsp;
  PONY_FN Unmute(const PonyMegaArgs& a, int32_t* ws, const int32_t* prev,
                 int32_t dsp) {
    head = PI32(P_HEAD);
    tail = PI32(P_TAIL);
    age = PI32(P_MUTE_AGE);
    dcnt = ws + pws::DSP_CNT;
    alive = PU8(P_ALIVE);
    muted = PU8(P_MUTED);
    pr = PU8(P_PRESSURED);
    refs = PI32(P_MUTE_REFS);
    ovf = PU8(P_MUTE_OVF);
    any_pr = prev[A_ANY_PR_END] > 0;
    rsp = PI32(P_RSPILL_COUNT)[0];
    quiet = prev[A_OCC_MAX] <= W::UNMUTE && dsp == 0 && rsp == 0 && !any_pr;
  }
  PONY_FN bool row(int32_t* ws, int64_t r) const {
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
    return wm;
  }
};

// Drain and dispatch (≙ the actor run loop), after the unmute: here, or
// in the spawn world's census phase, which also needs it (WMUTED).
PONY_FN void ph_lanes(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                      int32_t* cur, const int32_t* prev, int32_t dsp) {
  const Unmute um(a, ws, prev, dsp);
  Sums sums = {};
  PONY_FOR(r, W::NL) {
    const bool wm = W::SPAWN || W::BLOB ? ws[pws::WMUTED + r] != 0
                                        : um.row(ws, r);
    const uint32_t h = (uint32_t)um.head[r];
    const int32_t occ0 = (int32_t)((uint32_t)um.tail[r] - h);
    const bool runnable = um.alive[r] && !wm;
#define PONY_LANE(C) \
    if (r < C::S0 + C::ROWS) lane_dispatch<C>(a, ws, cur, r, runnable, h, occ0, sums); else
    PONY_COHORTS(PONY_LANE) {
      if constexpr (W::HOST) {     // a host row: no dispatch, head kept
        ws[pws::NEWHEAD + r] = (int32_t)h;
        ws[pws::DSTR + r] = 0;
        if constexpr (W::EV) ws[pws::ERRF + r] = 0;
      }
    }
#undef PONY_LANE
  }
  const int32_t np = block_sum(sums.nproc), nb = block_sum(sums.nbad);
  const int32_t nd = block_sum(sums.ndes), ne = block_sum(sums.nerr);
  if (g.tid == 0) {
    if (np) g_add(cur + A_NPROC, np);
    if (nb) g_add(cur + A_NBAD, nb);
    if (nd) g_add(cur + A_NDESTROYED, nd);
    if (ne) g_add(cur + A_NERR, ne);
  }
  if constexpr (W::SPAWN) {
    const int32_t ns = block_sum(sums.nspawn), sf = block_sum(sums.sf);
    if (g.tid == 0) {
      if (ns) g_add(cur + A_NSPAWN, ns);
      if (sf) g_add(cur + A_SFAIL, 1);
    }
  }
  if constexpr (W::BLOB) {
    const PonyBlobAcc& b = sums_blob(sums);
    const int32_t nal = block_sum(b.nal), nfr = block_sum(b.nfr);
    const int32_t nrm = block_sum(b.nrm), bf = block_sum(b.bf);
    const int32_t bbf = block_sum(b.bbf);
    if (g.tid == 0) {
      if (nal) g_add(cur + A_BALLOC, nal);
      if (nfr) g_add(cur + A_BFREE, nfr);
      if (nrm) g_add(cur + A_BREMOTE, nrm);
      if (bf) g_add(cur + A_BFAIL, 1);
      if (bbf) g_add(cur + A_BBUDGET, 1);
    }
  }
}

// ---- the spawn world's phases 0a and 0b: reservations ----------------
//
// (≙ pony_create's slot allocation, actor.c:688-734, ahead of dispatch;
// engine.py's free_row_list and spawn_reservations.) Both walk the rows in
// contiguous ranges, one a block, so that two grid-wide prefix sums give
// row order: the free rows of every target cohort (dead, mailbox empty,
// no spilled message addressed to them, all at the tick's start) and the
// runnable actors of every spawner cohort.

// Row r's cohort: its index, whether it is a spawn target, whether it
// spawns.
PONY_FN void row_cohort(int64_t r, int* k, bool* target, bool* spawner) {
#define PONY_ROW_COHORT(C)                   \
  if (r >= C::S0 && r < C::S0 + C::ROWS) {  \
    *k = C::CIDX;                            \
    *target = C::TARGET != 0;                \
    *spawner = C::NS > 0;                    \
    return;                                  \
  }
  PONY_COHORTS(PONY_ROW_COHORT)
#undef PONY_ROW_COHORT
  *k = 0;
  *target = *spawner = false;
}

PONY_FN bool row_is_start(int64_t r, int* k) {
#define PONY_ROW_START(C) \
  if (r == C::S0) {        \
    *k = C::CIDX;          \
    return true;           \
  }
  PONY_COHORTS(PONY_ROW_START)
#undef PONY_ROW_START
  return false;
}

// Row r's flags at the tick's start (after the unmute, WMUTED): a free
// row of a target cohort, a runnable row of a spawner cohort.
PONY_FN void spawn_flags(const PonyMegaArgs& a, const int32_t* ws,
                         int64_t r, int32_t* f, int32_t* u) {
  int k;
  bool target, spawner;
  row_cohort(r, &k, &target, &spawner);
  const bool al = PU8(P_ALIVE)[r] != 0;
  *f = target && !al && PI32(P_TAIL)[r] == PI32(P_HEAD)[r] &&
       ws[pws::DSP_CNT + r] == 0;
  *u = spawner && al && !ws[pws::WMUTED + r];
}

PONY_FN void block_rows(const Grid& g, int64_t* r0, int64_t* r1) {
  *r0 = W::NL * g.block / g.nblocks;
  *r1 = W::NL * (g.block + 1) / g.nblocks;
}

// Row r of a cohort that allocates blobs (NBS > 0): runnable after the
// unmute (WMUTED), and with queued work.
PONY_FN void blob_flags(const PonyMegaArgs& a, const int32_t* ws, int64_t r,
                        int32_t* u, int32_t* busy) {
  bool alloc = false;
#define PONY_ROW_ALLOC(C) \
  if (r >= C::S0 && r < C::S0 + C::ROWS) alloc = C::NBS > 0; else
  PONY_COHORTS(PONY_ROW_ALLOC) {}
#undef PONY_ROW_ALLOC
  *u = alloc && PU8(P_ALIVE)[r] && !ws[pws::WMUTED + r];
  *busy = *u && PI32(P_TAIL)[r] != PI32(P_HEAD)[r];
}

PONY_FN void block_slots(const Grid& g, int64_t* s0, int64_t* s1) {
  *s0 = W::BSL * g.block / g.nblocks;
  *s1 = W::BSL * (g.block + 1) / g.nblocks;
}

// 0a, census: the unmute of every row, and each block's counts (spawn:
// free target rows and runnable spawners; blobs: runnable allocating
// rows, whether one has queued work, and the free pool slots of the
// block's contiguous range of slots).
PONY_FN void ph_census(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                       const int32_t* prev, int32_t dsp) {
  const Unmute um(a, ws, prev, dsp);
  int64_t r0, r1;
  block_rows(g, &r0, &r1);
  int32_t nf = 0, nu = 0, bu = 0, bb = 0;
  for (int64_t r = r0 + g.tid; r < r1; r += g.nthreads) {
    um.row(ws, r);
    if constexpr (W::SPAWN) {
      int32_t f, u;
      spawn_flags(a, ws, r, &f, &u);
      nf += f;
      nu += u;
    }
    if constexpr (W::BLOB) {
      int32_t u, busy;
      blob_flags(a, ws, r, &u, &busy);
      bu += u;
      bb |= busy;
    }
  }
  if constexpr (W::SPAWN) {
    nf = block_sum(nf);
    nu = block_sum(nu);
    if (g.tid == 0) {
      ws[pws::BFREE + g.block] = nf;
      ws[pws::BRUN + g.block] = nu;
    }
  }
  if constexpr (W::BLOB) {
    int64_t s0, s1;
    block_slots(g, &s0, &s1);
    const uint8_t* used = PU8(W::PBLOB + 1);
    int32_t nfree = 0;
    for (int64_t q = s0 + g.tid; q < s1; q += g.nthreads) nfree += !used[q];
    nfree = block_sum(nfree);
    bu = block_sum(bu);
    bb = block_sum(bb);
    if (g.tid == 0) {
      ws[pws::BFREEB + g.block] = nfree;
      ws[pws::BRUNB + g.block] = bu;
      ws[pws::BBUSY + g.block] = bb;
    }
  }
}

// 0b, reserve: the free rows compacted in row order (FREE), each runnable
// row's global runnable prefix (RANK), and each cohort's prefixes at its
// first row (FPRE, UPRE; the totals at NCOH).
PONY_FN void ph_reserve(const PonyMegaArgs& a, const Grid& g, int32_t* ws) {
  int32_t pf = 0, pu = 0;
  for (int64_t b = g.tid; b < g.block; b += g.nthreads) {
    pf += ws[pws::BFREE + b];
    pu += ws[pws::BRUN + b];
  }
  pf = block_sum(pf);
  pu = block_sum(pu);
  int64_t r0, r1;
  block_rows(g, &r0, &r1);
  for (int64_t base = r0; base < r1; base += g.nthreads) {
    const int64_t r = base + g.tid;
    int32_t f = 0, u = 0;
    if (r < r1) spawn_flags(a, ws, r, &f, &u);
    int32_t tf, tu;
    const int32_t xf = block_excl_scan(f, &tf);
    const int32_t xu = block_excl_scan(u, &tu);
    if (f) ws[pws::FREE + pf + xf] = (int32_t)r;
    if (u) ws[pws::RANK + r] = pu + xu;
    int k;
    if (r < r1 && row_is_start(r, &k)) {
      ws[pws::FPRE + k] = pf + xf;
      ws[pws::UPRE + k] = pu + xu;
    }
    pf += tf;
    pu += tu;
  }
  if (g.block == g.nblocks - 1 && g.tid == 0) {
    ws[pws::FPRE + W::NCOH] = pf;
    ws[pws::UPRE + W::NCOH] = pu;
  }
}

// 0c, bfree (blob world): each runnable allocating row's global rank
// (RANKB) and each cohort's prefix at its first row (UPREB); then, where
// some allocating row has queued work, the free slots compacted in
// ascending order (FREEB, NFREEB their count). Without queued work no lane
// allocates this tick, so no window is read and the compaction is
// skipped, as the JAX package skips it.
PONY_FN void ph_bfree(const PonyMegaArgs& a, const Grid& g, int32_t* ws) {
  int32_t pu = 0, pf = 0, busy = 0;
  for (int64_t b = g.tid; b < g.nblocks; b += g.nthreads) {
    if (b < g.block) {
      pu += ws[pws::BRUNB + b];
      pf += ws[pws::BFREEB + b];
    }
    busy |= ws[pws::BBUSY + b];
  }
  pu = block_sum(pu);
  pf = block_sum(pf);
  busy = block_sum(busy);
  int64_t r0, r1;
  block_rows(g, &r0, &r1);
  for (int64_t base = r0; base < r1; base += g.nthreads) {
    const int64_t r = base + g.tid;
    int32_t u = 0, bz;
    if (r < r1) blob_flags(a, ws, r, &u, &bz);
    int32_t tu;
    const int32_t xu = block_excl_scan(u, &tu);
    if (u) ws[pws::RANKB + r] = pu + xu;
    int k;
    if (r < r1 && row_is_start(r, &k)) ws[pws::UPREB + k] = pu + xu;
    pu += tu;
  }
  if (!busy) return;
  int64_t s0, s1;
  block_slots(g, &s0, &s1);
  const uint8_t* used = PU8(W::PBLOB + 1);
  for (int64_t base = s0; base < s1; base += g.nthreads) {
    const int64_t q = base + g.tid;
    const int32_t f = q < s1 && !used[q];
    int32_t tf;
    const int32_t xf = block_excl_scan(f, &tf);
    if (f) ws[pws::FREEB + pf + xf] = (int32_t)q;
    pf += tf;
  }
  if (g.block == g.nblocks - 1 && g.tid == 0) ws[pws::NFREEB] = pf;
}

// ---- telemetry of the drained slots (keys phase) and the spans (scan) --

// The rows of cohort C in this block's contiguous range [*lo, *hi).
template <class C>
PONY_FN void cohort_rows(const Grid& g, int64_t* lo, int64_t* hi) {
  int64_t r0, r1;
  block_rows(g, &r0, &r1);
  *lo = r0 > C::S0 ? r0 : C::S0;
  *hi = r1 < C::S0 + C::ROWS ? r1 : C::S0 + C::ROWS;
}

// Ring slot c of lane r was drained this tick: its count lies in
// [head, NEWHEAD) (engine.py: _drained).
template <class C>
PONY_FN bool slot_drained(uint32_t h0, uint32_t n, int c) {
  return (((uint32_t)c - h0) & (uint32_t)(C::CAP - 1)) < n;
}

#if PONY_PROF
// Cohort C's drained slots in this block's rows: beh_runs and the
// queue-wait histogram into the block's counters; with tracing, the
// block's count of traced drained slots per ring slot (BTR). Returns this
// thread's drained slots.
template <class C>
PONY_FN int32_t keys_rows(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                          int32_t step) {
  int64_t lo, hi;
  cohort_rows<C>(g, &lo, &hi);
  int32_t* s = tel_smem();
  const int32_t* buf = (const int32_t*)a.p[C::PBUF];
  const int32_t* qw = (const int32_t*)a.p[C::PQW];
  const int32_t* head = PI32(P_HEAD);
  int32_t nd = 0;
  int32_t tc[C::CAP];
  for (int c = 0; c < C::CAP; ++c) tc[c] = 0;
  for (int64_t b = lo; b < hi; b += g.nthreads) {
    const int64_t r = b + g.tid;
    const bool in = r < hi;
    const int64_t i = in ? r - C::S0 : 0;
    const uint32_t h0 = in ? (uint32_t)head[r] : 0u;
    const uint32_t n = in ? (uint32_t)ws[pws::NEWHEAD + r] - h0 : 0u;
    nd += (int32_t)n;
    for (int c = 0; c < C::CAP; ++c) {
      const bool d = slot_drained<C>(h0, n, c);
      const int32_t gid = d ? buf[(int64_t)c * C::W1_IN * C::ROWS + i] : -1;
      tel_count(s + TS_RUNS, gid, d && gid >= C::BASE && gid < C::BASE + C::NB);
      const int32_t wait = d ? (int32_t)((uint32_t)step -
                                         (uint32_t)qw[c * C::ROWS + i])
                             : 0;
      tel_count(s + TS_QWH, C::CIDX * QWB + qwait_bucket(wait), d);
      if constexpr (W::TRACE) {
        const int32_t* tb = (const int32_t*)a.p[C::PTB];
        tc[c] += d && tb[(int64_t)c * 2 * C::ROWS + i] >= 0;
      }
    }
  }
  if constexpr (W::TRACE) {
    for (int c = 0; c < C::CAP; ++c) {
      const int32_t v = block_sum(tc[c]);
      if (g.tid == 0)
        ws[pws::BTR + ((int64_t)C::CIDX * C::CAP + c) * GMAX + g.block] = v;
    }
  }
  return nd;
}
#endif

#if PONY_TRACE
// Cohort C's spans (engine.py: trace_span_lanes), in the scan phase: the
// traced drained slots before each of this block's rows, per ring slot,
// are the counts of the blocks before it (BTR) plus the block's own
// prefix; a slot's rank is that within its cohort in slot-major [cap,
// rows] order, its span id (span_next + spans of earlier cohorts + rank) *
// 2 + 2, its span-ring row span_count + earlier + rank while below
// TSCAP. Then the two trailing words of each of the lanes' outbox entries
// (batch slot b, send m): (trace id, span id) of the message the lane
// drained in batch slot b, or (-1, 0). `done` = the spans of the cohorts
// before C; returns it with C's added.
template <class C>
PONY_FN int32_t span_rows(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                          int32_t step, int32_t nxt0, int32_t cnt0,
                          int32_t done) {
  int32_t pre[C::CAP], before[C::CAP], tot = 0;
  for (int c = 0; c < C::CAP; ++c) {
    const int32_t* row =
        ws + pws::BTR + ((int64_t)C::CIDX * C::CAP + c) * GMAX;
    int32_t p = 0, t = 0;
    for (int64_t b = g.tid; b < g.nblocks; b += g.nthreads) {
      t += row[b];
      if (b < g.block) p += row[b];
    }
    pre[c] = block_sum(p);
    before[c] = tot;
    tot += block_sum(t);
  }
  int64_t lo, hi;
  cohort_rows<C>(g, &lo, &hi);
  const int32_t* buf = (const int32_t*)a.p[C::PBUF];
  const int32_t* qw = (const int32_t*)a.p[C::PQW];
  const int32_t* tb = (const int32_t*)a.p[C::PTB];
  const int32_t* head = PI32(P_HEAD);
  int32_t* sd = PI32(W::PTEL + T_SPDATA);
  int32_t* ow = ws + pws::OUT_W;
  const uint32_t sbase = (uint32_t)nxt0 + (uint32_t)done;
  const int64_t cbase = (int64_t)cnt0 + done < W::TSCAP
                            ? (int64_t)cnt0 + done : (int64_t)W::TSCAP;
  for (int64_t b = lo; b < hi; b += g.nthreads) {
    const int64_t r = b + g.tid;
    const bool in = r < hi;
    const int64_t i = in ? r - C::S0 : 0;
    const uint32_t h0 = in ? (uint32_t)head[r] : 0u;
    const uint32_t n = in ? (uint32_t)ws[pws::NEWHEAD + r] - h0 : 0u;
    int32_t tid[C::CAP], sid[C::CAP];
    for (int c = 0; c < C::CAP; ++c) {
      const bool d = in && slot_drained<C>(h0, n, c);
      tid[c] = d ? tb[(int64_t)c * 2 * C::ROWS + i] : -1;
      const int32_t t = tid[c] >= 0;
      int32_t tt;
      const int32_t ex = block_excl_scan(t, &tt);
      const int32_t rank = before[c] + pre[c] + ex;
      pre[c] += tt;
      sid[c] = t ? (int32_t)((sbase + (uint32_t)rank) * 2u + 2u) : 0;
      const int64_t pos = cbase + rank;
      if (t && pos < W::TSCAP) {
        const int32_t v[8] = {
            tid[c], sid[c], tb[((int64_t)c * 2 + 1) * C::ROWS + i],
            buf[(int64_t)c * C::W1_IN * C::ROWS + i], (int32_t)r,
            qw[c * C::ROWS + i], step, (int32_t)((uint32_t)step + 1u)};
        for (int k = 0; k < 8; ++k) sd[(int64_t)k * W::TSCAP + pos] = v[k];
      }
    }
    if (!in) continue;
    for (int k = 0; k < C::BATCH; ++k) {
      const uint32_t slot = (h0 + (uint32_t)k) & (uint32_t)(C::CAP - 1);
      int32_t ts = -1, ss = 0;
      for (int c = 0; c < C::CAP; ++c)
        if ((uint32_t)c == slot) {
          ts = tid[c];
          ss = sid[c];
        }
      const bool ok = (uint32_t)k < n && ts >= 0;
      for (int m = 0; m < C::MS; ++m) {
        const int64_t o = C::OUT_OFF + ((int64_t)k * C::MS + m) * C::ROWS + i;
        ow[o * W::W1 + W::WT] = ok ? ts : -1;
        ow[o * W::W1 + W::WT + 1] = ok ? ss : 0;
      }
    }
  }
  return (int32_t)((uint32_t)done + (uint32_t)tot);
}
#endif

// ---- phase 2: keys, dead letters, per-target counts, digit counts -------

PONY_FN int32_t digit(int32_t key, int pass) {
  return (int32_t)(((uint32_t)key >> (DBITS * pass)) & (RADIX - 1));
}

PONY_FN void acc_reset(int32_t* acc) {
  // The spawn, host and blob accumulators only where the program has
  // them.
  for (int k = 0; k < (W::PROF   ? (int)A_NACC
                       : W::BLOB ? (int)A_PROF0
                       : W::SPAWN || W::HOST ? (int)A_BALLOC
                                             : (int)A_NSPAWN);
       ++k)
    acc[k] = 0;
  acc[A_OCC_MAX] = INT_MIN;
}

// Also resets `prev` (the previous tick's accumulators, read by nobody
// after phase 1) for the next tick. Each live entry's per-target count
// is taken with the atomic that returns its slot in the segment.
PONY_FN void ph_keys(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                     bool inject, int32_t* cur, int32_t* prev) {
  if (g.first()) acc_reset(prev);
  const uint8_t* alive = PU8(P_ALIVE);
  int32_t* key_out = PI32(P_PLAN_KEY);
  int32_t ndead = 0;
  int32_t ngather = 0;       // entries with a target (W::PROF)
  // Each block takes a contiguous run of chunks of one entry a thread (a
  // chunk lies in one tile); a warp counts its tile's live entries and
  // adds them to LCNT when its tile changes, so blocks meet on no counter.
  const int64_t nchunk = (W::E + g.nthreads - 1) / g.nthreads;
  const int64_t c0 = nchunk * g.block / g.nblocks;
  const int64_t c1 = nchunk * (g.block + 1) / g.nblocks;
  int64_t tile_at = -1;
  int32_t tile_live = 0;
  for (int64_t c = c0; c < c1; ++c) {
    const int64_t e = c * g.nthreads + g.tid;
    bool valid = false;
    if (e < W::E) {
      int32_t tgt, lvl;
      entry_target(a, ws, e, inject, &tgt, &lvl);
      const bool in_range = tgt >= 0 && tgt < W::NL;
      // A row claimed this tick is alive for its delivery.
      const bool dead = in_range && !alive[tgt] &&
                        !(W::SPAWN && ws[pws::BORN + tgt]);
      valid = in_range && !dead;
      const int32_t key = valid ? tgt * (int32_t)W::NLEV + lvl : DEAD;
      key_out[e] = key;
      if (valid) {
#ifdef __CUDACC__
        ws[pws::SLOT + e] = atomicAdd(ws + pws::TCNT + tgt, 1);
#else
        ws[pws::SLOT + e] = ws[pws::TCNT + tgt]++;
#endif
      }
      ndead += dead;
      if constexpr (W::PROF) ngather += tgt >= 0;
    }
    const int64_t tile = c * g.nthreads / TILE;
    if (tile != tile_at) {
      if (tile_live) g_add(ws + pws::LCNT + tile_at, tile_live);
      tile_at = tile;
      tile_live = 0;
    }
#ifdef __CUDACC__
    const int32_t wl = __popc(__ballot_sync(0xffffffffu, valid));
    if ((threadIdx.x & 31) == 0) tile_live += wl;     // lane 0 keeps it
#else
    tile_live += valid;
#endif
  }
  if (tile_live) g_add(ws + pws::LCNT + tile_at, tile_live);
  ndead = block_sum(ndead);
  if (g.tid == 0 && ndead) g_add(cur + A_NDEAD, ndead);
#if PONY_PROF
  // The profiler's drain side (engine.py: profile_lanes) and the phase
  // costs' delivery-list entries and drained slots.
  const int32_t step = PI32(P_STEP_NO)[0];
  int32_t nd = 0;
#define PONY_KEYS_ROWS(C) nd += keys_rows<C>(a, g, ws, step);
  PONY_COHORTS(PONY_KEYS_ROWS)
#undef PONY_KEYS_ROWS
  nd = block_sum(nd);
  ngather = block_sum(ngather);
  if (g.tid == 0) {
    if (nd) g_add(cur + A_PCDRAIN, nd);
    if (ngather) g_add(cur + A_PCDELIV, ngather);
  }
  int32_t* s = tel_smem();
  tel_flush(g, s + TS_RUNS, W::NB, PI32(W::PTEL + T_RUNS));
  tel_flush(g, s + TS_QWH, (int64_t)W::NCOH * QWB, PI32(W::PTEL + T_QWH));
#else
  (void)ngather;
#endif
}

// ---- phase 3: per-target scans; digit offsets or the tiles' live prefix -

// Per chunk of targets: accepted = min(count, free space), rejected =
// count - accepted, and the chunk-local exclusive scans of both.
// One target's acceptance and overload flag; returns its count.
PONY_FN int32_t target_accept(const PonyMegaArgs& a, int32_t* ws,
                              int64_t t) {
  const int32_t cnt = ws[pws::TCNT + t];
  const int32_t occ = (int32_t)((uint32_t)PI32(P_TAIL)[t] -
                                (uint32_t)ws[pws::NEWHEAD + t]);
  int32_t space = (int32_t)((uint32_t)W::CAP - (uint32_t)occ);
  space = space < 0 ? 0 : space;
  const int32_t acc = cnt < space ? cnt : space;
  ws[pws::ACCW + t] = acc;
  // Overloaded after this tick's delivery, or pressured (the mute
  // triggers' test of a receiver and of a sender).
  const int32_t after = (int32_t)((uint32_t)occ + (uint32_t)acc);
  ws[pws::HOT + t] = after > W::OVERLOAD || PU8(P_PRESSURED)[t];
  return cnt;
}

PONY_FN void target_chunk(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                          int32_t* cur, int64_t c) {
  const int64_t t1 = (c + 1) * CH < W::NL ? (c + 1) * CH : W::NL;
  int32_t cb = 0, cr = 0, seg = 0;    // this thread's start, the chunk's max
#ifdef __CUDACC__
  // Warp w takes the chunk's w-th run of CH / WARPS targets, 32 at a
  // time: it sums them, the warps exchange sums once, and it scans them.
  constexpr int RUN = (int)(CH / WARPS);
  __shared__ int32_t s_b[WARPS], s_r[WARPS];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t t0 = c * CH + (int64_t)wid * RUN + lane;
  int32_t sb = 0, sr = 0;
  for (int r = 0; r < RUN / 32; ++r) {
    const int64_t t = t0 + 32 * r;
    if (t < t1) {
      const int32_t cnt = target_accept(a, ws, t);
      sb += cnt;
      sr += cnt - ws[pws::ACCW + t];
      seg = cnt > seg ? cnt : seg;
    }
  }
  sb = __reduce_add_sync(0xffffffffu, sb);
  sr = __reduce_add_sync(0xffffffffu, sr);
  if (lane == 0) {
    s_b[wid] = sb;
    s_r[wid] = sr;
  }
  __syncthreads();
  int32_t tb = 0, tr = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w == wid) {
      cb = tb;
      cr = tr;
    }
    tb += s_b[w];
    tr += s_r[w];
  }
  for (int r = 0; r < RUN / 32; ++r) {
    const int64_t t = t0 + 32 * r;
    const int32_t cnt = t < t1 ? ws[pws::TCNT + t] : 0;
    const int32_t rej = t < t1 ? cnt - ws[pws::ACCW + t] : 0;
    int32_t xb = cnt, xr = rej;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t yb = __shfl_up_sync(0xffffffffu, xb, o);
      const int32_t yr = __shfl_up_sync(0xffffffffu, xr, o);
      if (lane >= o) {
        xb += yb;
        xr += yr;
      }
    }
    if (t < t1) {
      ws[pws::BLOC + t] = cb + xb - cnt;
      ws[pws::ROFF + t] = cr + xr - rej;
    }
    cb += __shfl_sync(0xffffffffu, xb, 31);
    cr += __shfl_sync(0xffffffffu, xr, 31);
  }
  __syncthreads();
#else
  for (int64_t t = c * CH; t < t1; ++t) {
    const int32_t cnt = target_accept(a, ws, t);
    ws[pws::BLOC + t] = cb;
    ws[pws::ROFF + t] = cr;
    cb += cnt;
    cr += cnt - ws[pws::ACCW + t];
    seg = cnt > seg ? cnt : seg;
  }
  const int32_t tb = cb, tr = cr;
#endif
  // The chunk that holds NL also holds the totals there.
  if (c * CH <= W::NL && W::NL < (c + 1) * CH && g.tid == 0) {
    ws[pws::BLOC + W::NL] = tb;
    ws[pws::ROFF + W::NL] = tr;
  }
  seg = block_max(seg);
  if (g.tid == 0) {
    ws[pws::CTOT + c] = tb;
    ws[pws::RTOT + c] = tr;
    g_max(cur + A_SEGMAX, seg);
  }
}

// Pass `pass`'s digit offsets, one warp a digit row: BCNT[d][b] becomes
// where block b's first entry of digit d goes: the entries of smaller
// digits (from the digit totals) plus digit d's entries in the blocks
// before b.
PONY_FN void digit_rows(const Grid& g, int32_t* ws, int pass) {
  const int32_t* tot = ws + pws::GTOT + pass * RADIX;
#ifdef __CUDACC__
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (g.nblocks * g.nthreads) >> 5;
  for (int64_t d = (g.block * g.nthreads + g.tid) >> 5; d < RADIX;
       d += nwarps) {
    int32_t base = 0;
    for (int64_t k = lane; k < d; k += 32) base += tot[k];
    int32_t carry = __reduce_add_sync(0xffffffffu, base);
    int32_t* row = ws + pws::BCNT + d * GMAX;
    for (int64_t b0 = 0; b0 < g.nblocks; b0 += 32) {
      const int64_t b = b0 + lane;
      const int32_t v = b < g.nblocks ? row[b] : 0;
      int32_t x = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (b < g.nblocks) row[b] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
#else
  int32_t base = 0;
  for (int64_t d = 0; d < RADIX; ++d) {
    ws[pws::BCNT + d * GMAX] = base;        // one block
    base += tot[d];
  }
#endif
}

PONY_FN void ph_scan(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                     int32_t* cur) {
  PONY_FOR_BLOCKS(b, NCH + 1) {
    if (b < NCH) {
      target_chunk(a, g, ws, cur, b);
    } else {
      const int32_t tot = block_scan_array(g, ws + pws::LCNT, NTILE);
      if (g.tid == 0) ws[pws::LCNT + NTILE] = tot;
    }
  }
#if PONY_TRACE
  const int32_t step = PI32(P_STEP_NO)[0];
  const int32_t nxt0 = PI32(W::PTEL + T_SPNEXT)[0];
  const int32_t cnt0 = PI32(W::PTEL + T_SPCOUNT)[0];
  int32_t done = 0;
#define PONY_SPAN_ROWS(C) done = span_rows<C>(a, g, ws, step, nxt0, cnt0, done);
  PONY_COHORTS(PONY_SPAN_ROWS)
#undef PONY_SPAN_ROWS
  if (g.first()) cur[A_SPANS] = done;
#endif
}

// Add each chunk's prefix of the chunk totals (run in the sort phase).
PONY_FN void fix_chunk(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                       int64_t c) {
  int32_t* bounds = PI32(P_PLAN_BOUNDS);
  int32_t pb = 0, pr = 0;
  for (int64_t k = g.tid; k < c; k += g.nthreads) {
    pb += ws[pws::CTOT + k];
    pr += ws[pws::RTOT + k];
  }
  pb = block_sum(pb);
  pr = block_sum(pr);
  const int64_t end = (c + 1) * CH < W::NL + 1 ? (c + 1) * CH : W::NL + 1;
  for (int64_t t = c * CH + g.tid; t < end; t += g.nthreads) {
    bounds[t] = ws[pws::BLOC + t] + pb;
    ws[pws::ROFF + t] += pr;
  }
}


// ---- phase 4, wide tick: LSD radix passes, reduce then scan ---------------

// Each pass first counts its digit over each block's tiles of its input
// (BCNT[d][block], and the digit totals in GTOT), then a scan phase
// (`digit_rows`) turns the counts into offsets.
PONY_FN void ph_count(const Grid& g, int32_t* ws, Smem& sm,
                      const int32_t* kin, int pass) {
  for (int64_t d = g.tid; d < RADIX; d += g.nthreads) sm.u.hist[d] = 0;
  PONY_BSYNC();
  PONY_FOR_MY_TILES(tile) {
    const int64_t e1 = (tile + 1) * TILE < W::E ? (tile + 1) * TILE : W::E;
    for (int64_t e = tile * TILE + g.tid; e < e1; e += g.nthreads) {
#ifdef __CUDACC__
      atomicAdd(&sm.u.hist[digit(kin[e], pass)], 1);
#else
      ++sm.u.hist[digit(kin[e], pass)];
#endif
    }
  }
  PONY_BSYNC();
  for (int64_t d = g.tid; d < RADIX; d += g.nthreads) {
    const int32_t v = sm.u.hist[d];
    ws[pws::BCNT + d * GMAX + g.block] = v;
    if (v) g_add(ws + pws::GTOT + pass * RADIX + d, v);
  }
}

// Pass `pass` moves (key, value) from kin/vin to kout/vout (vin null: the
// value is the entry's index), stably by digit `pass`: each block walks
// its tiles in order from its digit offsets (BCNT[d][block]).
PONY_FN void ph_scatter(const Grid& g, int32_t* ws, Smem& sm,
                        const int32_t* kin, const int32_t* vin,
                        int32_t* kout, int32_t* vout, int pass) {
  for (int64_t d = g.tid; d < RADIX; d += g.nthreads)
    sm.off[d] = ws[pws::BCNT + d * GMAX + g.block];
#ifdef __CUDACC__
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  PONY_FOR_MY_TILES(tile) {
    uint32_t* whw = (uint32_t*)&sm.u.wh[0][0];
    for (int k = threadIdx.x; k < WARPS * RADIX / 2; k += THREADS) whw[k] = 0;
    __syncthreads();
    // Warp w owns the tile's w-th run of 32 * WROUNDS entries and walks it
    // in order, 32 at a time: first counting each digit, then (after the
    // warps' exclusive prefix per digit) replaying the same walk to place
    // each entry at its stable rank.
    const int64_t e0 = tile * TILE + (int64_t)wid * 32 * WROUNDS + lane;
    for (int r = 0; r < WROUNDS; ++r) {
      const int64_t e = e0 + 32 * r;
      const bool has = e < W::E;
      const int d = has ? digit(kin[e], pass) : RADIX;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (has && (peers & lt) == 0)
        sm.u.wh[wid][d] = (uint16_t)(sm.u.wh[wid][d] + __popc(peers));
      __syncwarp();
    }
    __syncthreads();
    for (int d = threadIdx.x; d < RADIX; d += THREADS) {
      uint32_t run = 0;
      for (int w = 0; w < WARPS; ++w) {
        const uint32_t c = sm.u.wh[w][d];
        sm.u.wh[w][d] = (uint16_t)run;
        run += c;
      }
    }
    __syncthreads();
    for (int r = 0; r < WROUNDS; ++r) {
      const int64_t e = e0 + 32 * r;
      const bool has = e < W::E;
      const int32_t key = has ? kin[e] : 0;
      const int d = has ? digit(key, pass) : RADIX;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (has) {
        const int32_t dest = sm.off[d] + sm.u.wh[wid][d] + __popc(peers & lt);
        kout[dest] = key;
        vout[dest] = vin ? vin[e] : (int32_t)e;
      }
      __syncwarp();
      if (has && (peers & lt) == 0)
        sm.u.wh[wid][d] = (uint16_t)(sm.u.wh[wid][d] + __popc(peers));
      __syncwarp();
    }
    __syncthreads();
    // The last warp's running count is now the tile's count of each digit.
    for (int d = threadIdx.x; d < RADIX; d += THREADS)
      sm.off[d] += sm.u.wh[WARPS - 1][d];
    __syncthreads();
  }
#else
  PONY_FOR_MY_TILES(tile) {
    const int64_t e1 = (tile + 1) * TILE < W::E ? (tile + 1) * TILE : W::E;
    for (int64_t e = tile * TILE; e < e1; ++e) {
      const int32_t key = kin[e];
      const int32_t dest = sm.off[digit(key, pass)]++;
      kout[dest] = key;
      vout[dest] = vin ? vin[e] : (int32_t)e;
    }
  }
#endif
}

// ---- phase 4, segment tick: each live entry into its target's segment ---

// The dead entries of one tile, in entry order, after the `nlive` live
// ones. LCNT holds the tiles' exclusive live prefix.
PONY_FN void dead_tile(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                       int32_t nlive, int64_t tile) {
  const int32_t* key = PI32(P_PLAN_KEY);
  int32_t* perm = PI32(P_PLAN_PERM);
  // Dead entries before this tile: its start minus the live ones.
  const int32_t at0 = nlive + (int32_t)(tile * TILE) - ws[pws::LCNT + tile];
  const int64_t e1 = (tile + 1) * TILE < W::E ? (tile + 1) * TILE : W::E;
#ifdef __CUDACC__
  // Warp w takes the tile's w-th run of 32 * WROUNDS entries: it counts
  // its dead entries, the warps exchange counts once, and it places them.
  __shared__ int32_t s_dead[WARPS];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t e0 = tile * TILE + (int64_t)wid * 32 * WROUNDS + lane;
  int32_t n = 0;
  for (int r = 0; r < WROUNDS; ++r) {
    const int64_t e = e0 + 32 * r;
    n += __popc(__ballot_sync(0xffffffffu, e < e1 && key[e] == DEAD));
  }
  if (lane == 0) s_dead[wid] = n;
  __syncthreads();
  int32_t at = at0;
  for (int w = 0; w < wid; ++w) at += s_dead[w];
  for (int r = 0; r < WROUNDS; ++r) {
    const int64_t e = e0 + 32 * r;
    const bool dead = e < e1 && key[e] == DEAD;
    const unsigned m = __ballot_sync(0xffffffffu, dead);
    if (dead) perm[at + __popc(m & ((1u << lane) - 1u))] = (int32_t)e;
    at += __popc(m);
  }
  __syncthreads();
#else
  int32_t at = at0;
  for (int64_t e = tile * TILE; e < e1; ++e)
    if (key[e] == DEAD) perm[at++] = (int32_t)e;
#endif
}

// The dead entries of every tile and every chunk's bounds, one job a
// block.
PONY_FN void dead_and_bounds(const PonyMegaArgs& a, const Grid& g,
                             int32_t* ws, int32_t nlive) {
  const int64_t jobs = NTILE + NCH;
  for (int64_t j = g.block; j < jobs; j += g.nblocks) {
    if (j < NTILE) dead_tile(a, g, ws, nlive, j);
    else fix_chunk(a, g, ws, j - NTILE);
  }
}

// Where every target's segment is short (at most SEG entries), each live
// entry goes to the slot of its target's segment that the keys phase's
// atomic gave it (in no particular order), as level * E + entry, and the
// deliver phase sorts each segment by that, which is the stable order
// (key, entry) within a target; the dead entries go after them in entry
// order. Segment starts are the chunk-local bounds plus the chunk totals'
// prefix, scanned by every block into shared memory.
constexpr bool SEG_FITS = (uint64_t)W::NLEV * W::E <= 0xffffffffull;

PONY_FN void ph_place(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                      Smem& sm) {
  if constexpr (SEG_FITS) {
    // With more blocks than dead-placement and bounds jobs, blocks
    // [0, jobs) take one job each and the others place the live entries,
    // so the two chains of dependent loads run side by side.
    const int64_t jobs = NTILE + NCH;
    const bool split = g.nblocks > jobs;
    if (!split || g.block >= jobs) {
      int32_t* cpre = sm.u.cpre;
      for (int64_t c = g.tid; c < NCH; c += g.nthreads)
        cpre[c] = ws[pws::CTOT + c];
      PONY_BSYNC();
      block_scan_array(g, cpre, NCH);
      PONY_BSYNC();
      const int32_t* key = PI32(P_PLAN_KEY);
      int32_t* perm = PI32(P_PLAN_PERM);
      const int64_t b0 = split ? g.block - jobs : g.block;
      const int64_t nb = split ? g.nblocks - jobs : g.nblocks;
      for (int64_t e = b0 * g.nthreads + g.tid; e < W::E;
           e += nb * g.nthreads) {
        const int32_t k = key[e];
        if (k == DEAD) continue;
        const int32_t t = k / (int32_t)W::NLEV;
        int32_t slot = ws[pws::SLOT + e];
#ifndef __CUDACC__
        // The host build's slots come in entry order; reverse them, so the
        // CPU tests exercise the segment sort as the card's atomics do.
        slot = ws[pws::TCNT + t] - 1 - slot;
#endif
        perm[ws[pws::BLOC + t] + cpre[t / CH] + slot] =
            (int32_t)((uint32_t)(k - t * (int32_t)W::NLEV) *
                          (uint32_t)W::E +
                      (uint32_t)e);
      }
    }
    if (!split || g.block < jobs)
      dead_and_bounds(a, g, ws, ws[pws::LCNT + NTILE]);
  }
}

// ---- phase 5: ring rebuild, spill, mute triggers ------------------------

// Ring slot c of target t takes sorted entry bounds[t] + (c - tail) mod
// cap where that is below the accepted count (delivery.py's slot planes).
template <class C>
PONY_FN void ring_fill(const PonyMegaArgs& a, const int32_t* ws, int64_t t,
                       uint32_t tl, int32_t acc, int32_t b, bool inject) {
  const int64_t i = t - C::S0;
  int32_t* buf = (int32_t*)a.p[C::PBUF];
  const int32_t* perm = PI32(P_PLAN_PERM);
  // The slots' entries first (independent loads), then their words.
  int32_t es[C::CAP];
  for (int c = 0; c < C::CAP; ++c) {
    const uint32_t rel = ((uint32_t)c - tl) & (uint32_t)(C::CAP - 1);
    int64_t p = (int64_t)b + rel;
    p = p < W::E - 1 ? p : W::E - 1;
    es[c] = (int64_t)rel < acc ? perm[p] : -1;
  }
  for (int c = 0; c < C::CAP; ++c) {
    if (es[c] < 0) continue;
    int32_t w[C::W1_IN];
    for (int j = 0; j < C::W1_IN; ++j) w[j] = entry_word(a, ws, es[c], j, inject);
    for (int j = 0; j < C::W1_IN; ++j)
      buf[((int64_t)c * C::W1_IN + j) * C::ROWS + i] = w[j];
#if PONY_PROF
    // beh_delivered of the cohort's own behaviours, the enqueue stamp of
    // a device cohort's slot, and with tracing the slot's trace rows,
    // from the entry's two trailing words.
    tel_count(tel_smem() + TS_DELIV, w[0],
              w[0] >= C::BASE && w[0] < C::BASE + C::NB);
    if constexpr (C::PQW >= 0)
      ((int32_t*)a.p[C::PQW])[c * C::ROWS + i] = PI32(P_STEP_NO)[0];
    if constexpr (W::TRACE) {
      int32_t* tb = (int32_t*)a.p[C::PTB];
      tb[(int64_t)c * 2 * C::ROWS + i] = entry_word(a, ws, es[c], W::WT, inject);
      tb[((int64_t)c * 2 + 1) * C::ROWS + i] =
          entry_word(a, ws, es[c], W::WT + 1, inject);
    }
#endif
  }
}

// Entry e, rejected by target t, into slot q of the new spill.
PONY_FN void spill_put(const PonyMegaArgs& a, int32_t* ws, int32_t t,
                       int64_t e, int64_t q, bool inject) {
  ws[pws::NSP_TGT + q] = t;
  ws[pws::NSP_SND + q] = entry_sender(a, e);
  for (int k = 0; k < W::W1; ++k)
    ws[pws::NSP_W + (int64_t)k * W::SPILL + q] =
        entry_word(a, ws, e, k, inject);
}

// Mute trigger (≙ actor.c:898-921): a valid send whose receiver rejected
// it, is overloaded or pressured mutes its sender, unless the sender is
// itself overloaded or pressured. kt is the receiver, e the entry.
PONY_FN void mute_trigger(const PonyMegaArgs& a, int32_t* ws, int32_t kt,
                          int32_t e) {
  const int32_t snd = entry_sender(a, e);
  if (snd < 0 || snd >= W::NL) return;
  if (!ws[pws::HOT + snd]) {
    ws[pws::NEWLY + snd] = 1;
    const int64_t k = kt % W::K;
    g_max(ws + pws::RMAX + k * W::NL + snd, kt);
    g_min(ws + pws::RMIN + k * W::NL + snd, kt);
  }
}

// `seg`: a segment tick, whose target segments are unsorted (ph_place);
// the thread of each target sorts its segment by (key, entry) first and
// walks its own entries for the mute triggers.
PONY_FN void ph_deliver(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                        bool inject, bool seg) {
  const int32_t* bounds = PI32(P_PLAN_BOUNDS);
  int32_t* perm = PI32(P_PLAN_PERM);
  const int32_t* tail = PI32(P_TAIL);
  PONY_FOR(t, W::NL) {
    const int32_t acc = ws[pws::ACCW + t];
    const int32_t b = bounds[t];
    if (seg) {
      const int32_t n = bounds[t + 1] - b;
      // Insertion sort of at most SEG (level * E + entry), then entries.
      uint32_t v[SEG > 1 ? SEG : 1];
      for (int32_t j = 0; j < n; ++j) v[j] = (uint32_t)perm[b + j];
      for (int32_t j = 1; j < n; ++j) {
        const uint32_t x = v[j];
        int32_t i = j - 1;
        for (; i >= 0 && v[i] > x; --i) v[i + 1] = v[i];
        v[i + 1] = x;
      }
      for (int32_t j = 0; j < n; ++j)
        perm[b + j] = (int32_t)(v[j] % (uint32_t)W::E);
      const bool recv_hot = ws[pws::HOT + t] != 0;
      for (int32_t j = 0; j < n; ++j)
        if (j >= acc || recv_hot) mute_trigger(a, ws, (int32_t)t, perm[b + j]);
    }
    if (acc > 0) {
      // A row claimed this tick starts its mailbox at 0.
      const uint32_t tl =
          W::SPAWN && ws[pws::BORN + t] ? 0u : (uint32_t)tail[t];
#define PONY_FILL(C) \
      if (t < C::S0 + C::ROWS) ring_fill<C>(a, ws, t, tl, acc, b, inject); else
      PONY_COHORTS(PONY_FILL) PONY_HOSTS(PONY_FILL) {}
#undef PONY_FILL
    }
    // The rejected entries, in sorted order, after those of lower targets;
    // how many of them the new spill keeps is the next tick's
    // spill-pending count of t. A segment tick's thread copies its own (at
    // most SEG); a radix tick copies one entry a thread, below.
    const int32_t nrej = bounds[t + 1] - b - acc;
    const int32_t ro = ws[pws::ROFF + t];
    const int64_t room = W::SPILL - (int64_t)ro;
    const int32_t kept = room <= 0 ? 0 : (nrej < room ? nrej : (int32_t)room);
    if (seg)
      for (int32_t j = 0; j < kept; ++j)
        spill_put(a, ws, (int32_t)t, perm[(int64_t)b + acc + j],
                  (int64_t)ro + j, inject);
    ws[pws::DSP_CNT + t] = kept;
  }
#if PONY_PROF
  tel_flush(g, tel_smem() + TS_DELIV, W::NB, PI32(W::PTEL + T_DELIV));
#endif
  if (seg) return;
  // The radix sort's spill and mute triggers, per sorted live entry
  // (valid entries sort first): rejected entry j of target kt goes to
  // spill slot ROFF[kt] + j while the spill has room; the sender is read
  // only for an entry that can trigger.
  const int32_t* skey = ws + pws::SKEY;
  PONY_FOR(p, bounds[W::NL]) {
    const int32_t kt = skey[p] / (int32_t)W::NLEV;
    const int32_t e = perm[p];                 // loaded beside the key
    const int32_t j = p - bounds[kt] - ws[pws::ACCW + kt];
    if (j >= 0) {
      const int64_t q = (int64_t)ws[pws::ROFF + kt] + j;
      if (q < W::SPILL) spill_put(a, ws, kt, e, q, inject);
    }
    if (j >= 0 || ws[pws::HOT + kt]) mute_trigger(a, ws, kt, e);
  }
}

// ---- phase 6: destroys, mute bookkeeping, commit ------------------------

template <class C>
PONY_FN void born_fields(const PonyMegaArgs& a, const int32_t* ws, int64_t r,
                         int32_t born) {
  const int64_t i = r - C::S0;
  for (int f = 0; f < C::NF; ++f)
    ((int32_t*)a.p[C::PFIELD + f])[i] =
        born == 2 && f < W::NI ? ws[pws::BINIT + (int64_t)f * W::NL + r]
                               : (int32_t)C::null_bits(f);
}

PONY_FN void ph_commit(const PonyMegaArgs& a, const Grid& g, int32_t* ws,
                       int32_t* cur) {
  int32_t* head = PI32(P_HEAD);
  int32_t* tail = PI32(P_TAIL);
  uint8_t* alive = PU8(P_ALIVE);
  uint8_t* muted = PU8(P_MUTED);
  int32_t* refs = PI32(P_MUTE_REFS);
  int32_t* age = PI32(P_MUTE_AGE);
  uint8_t* ovf = PU8(P_MUTE_OVF);
  uint8_t* pinned = PU8(P_PINNED);
  uint8_t* pr = PU8(P_PRESSURED);
  int32_t any_occ = 0, any_m = 0, any_p = 0, became_n = 0, occ_max = INT_MIN;
  int32_t any_host = 0;    // an occupied host row (W::HOST only)
#if PONY_PROF
  // The aggregates (occupancy, muted, overloaded).
  int32_t occ_sum = 0, n_mut = 0, n_over = 0;
  int32_t* tel = tel_smem();
#endif
#if PONY_EV
  int32_t nev[NEVC] = {0, 0, 0, 0, 0, 0};   // each transition class
#endif
#if PONY_EV
  // The event ring is written in row order (at the gate), from each
  // block's prefix: a contiguous range of rows a block.
  int64_t rr0, rr1;
  block_rows(g, &rr0, &rr1);
  for (int64_t r = rr0 + g.tid; r < rr1; r += g.nthreads) {
#else
  PONY_FOR(r, W::NL) {
#endif
    // A claimed row (≙ engine.py's apply_claims) becomes alive with head
    // and tail 0 and its fields at their null words or its sync
    // constructor's values.
    const int32_t born = W::SPAWN ? ws[pws::BORN + r] : 0;
    if (born) {
      ws[pws::BORN + r] = 0;
#define PONY_BORN(C) \
      if (r >= C::S0 && r < C::S0 + C::ROWS) born_fields<C>(a, ws, r, born); else
      PONY_COHORTS(PONY_BORN) {}
#undef PONY_BORN
    }
    const uint32_t nt = (born ? 0u : (uint32_t)tail[r]) +
                        (uint32_t)ws[pws::ACCW + r];
    uint32_t nh = born ? 0u : (uint32_t)ws[pws::NEWHEAD + r];
    const bool d = ws[pws::DSTR + r] != 0;
    const bool al = (alive[r] || born) && !d;
#if PONY_EV
    const bool al0 = alive[r] != 0, m0 = muted[r] != 0;   // tick start
    const int32_t occ0 = (int32_t)((uint32_t)tail[r] - (uint32_t)head[r]);
#endif
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
    const int32_t occ = (int32_t)(nt - nh);
    if constexpr (W::HOST) {
      if (r < W::FH) any_occ |= occ > 0;
      else any_host |= occ > 0;
    } else {
      any_occ |= occ > 0;
    }
    occ_max = occ > occ_max ? occ : occ_max;
    any_m |= m2;
    any_p |= pr[r];
    became_n += became;
#if PONY_PROF
    occ_sum = wadd(occ_sum, occ);
    n_mut += m2;
    n_over += occ > W::OVERLOAD;
    {
      int k;
      bool target, spawner;
      row_cohort(r, &k, &target, &spawner);
      tel_count(tel + TS_MUTE, k, m2 && r < W::FH);
    }
#endif
#if PONY_EV
    // Transitions (engine.py: the event ring's classes 1..6).
    const int32_t bits =
        (int32_t)became | (int32_t)(m0 && !wm && al) << 1 |
        (int32_t)(occ > W::OVERLOAD && !(occ0 > W::OVERLOAD)) << 2 |
        (int32_t)(al && !al0) << 3 | (int32_t)(al0 && !al) << 4 |
        (int32_t)(ws[pws::ERRF + r] != 0) << 5;
    ws[pws::EVM + r] = bits;
    for (int k = 0; k < NEVC; ++k) nev[k] += (bits >> k) & 1;
#endif
    // This tick's per-lane scratch, cleared for the next.
    ws[pws::TCNT + r] = 0;
    ws[pws::NEWLY + r] = 0;
    for (int k = 0; k < W::K; ++k) {
      ws[pws::RMAX + (int64_t)k * W::NL + r] = -1;
      ws[pws::RMIN + (int64_t)k * W::NL + r] = INT_MAX;
    }
  }
  PONY_FOR(d, NPASS * RADIX) ws[pws::GTOT + d] = 0;
  PONY_FOR(k, NTILE) ws[pws::LCNT + k] = 0;
  // The new spill replaces the old (rejections beyond spill_cap are lost
  // and flagged as an overflow at the gate).
  const int32_t rtot = ws[pws::ROFF + W::NL];
  const int64_t n_sp = rtot < W::SPILL ? rtot : W::SPILL;
  PONY_FOR(q, W::SPILL) {
    const bool v = q < n_sp;
#if PONY_PROF
    // beh_rejected: the new spill's behaviour ids (every behaviour).
    const int32_t rg = v ? ws[pws::NSP_W + q] : -1;
    tel_count(tel + TS_REJ, rg, rg >= 0 && rg < W::NB);
#endif
    PI32(P_DSPILL_TGT)[q] = v ? ws[pws::NSP_TGT + q] : -1;
    PI32(P_DSPILL_SENDER)[q] = v ? ws[pws::NSP_SND + q] : -1;
    for (int k = 0; k < W::W1; ++k)
      PI32(P_DSPILL_WORDS)[(int64_t)k * W::SPILL + q] =
          v ? ws[pws::NSP_W + (int64_t)k * W::SPILL + q] : 0;
  }
  any_occ = block_sum(any_occ);
  any_m = block_sum(any_m);
  any_p = block_sum(any_p);
  became_n = block_sum(became_n);
  occ_max = block_max(occ_max);
  if (g.tid == 0) {
    if (any_occ) g_add(cur + A_ANY_OCC, 1);
    if (any_m) g_add(cur + A_ANY_MUTED, 1);
    if (any_p) g_add(cur + A_ANY_PR_END, 1);
    if (became_n) g_add(cur + A_BECAME, became_n);
    g_max(cur + A_OCC_MAX, occ_max);
  }
  if constexpr (W::HOST) {
    any_host = block_sum(any_host);
    if (g.tid == 0 && any_host) g_add(cur + A_HOSTOCC, 1);
  }
#if PONY_PROF
  occ_sum = block_sum(occ_sum);
  n_mut = block_sum(n_mut);
  n_over = block_sum(n_over);
  if (g.tid == 0) {
    if (occ_sum) g_add(cur + A_OCCSUM, occ_sum);
    if (n_mut) g_add(cur + A_NMUTED, n_mut);
    if (n_over) g_add(cur + A_NOVER, n_over);
  }
  tel_flush(g, tel + TS_MUTE, W::NCOH, PI32(W::PTEL + T_MUTE));
  tel_flush(g, tel + TS_REJ, W::NB, PI32(W::PTEL + T_REJ));
#endif
#if PONY_EV
  for (int k = 0; k < NEVC; ++k) {
    const int32_t v = block_sum(nev[k]);
    if (g.tid == 0) ws[pws::BEV + (int64_t)k * GMAX + g.block] = v;
  }
#endif
}

// ---- the gate: counters and aux, computed by every block ----------------

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
       OB_BUDGET, OB_MUTED, OB_N };
enum { OI_CODE, OI_NPROC, OI_NDELIV, OI_OCCSUM, OI_OCCMAX, OI_NMUTED,
       OI_NOVER, OI_NREJ, OI_NBAD, OI_NDEAD, OI_NMUTES, OI_QW99,
       OI_TICKS };

PONY_FN bool aux_go(const uint8_t* b) {
  return b[OB_PENDING] && !b[OB_HOST] && !b[OB_EXIT] && !b[OB_OVERFLOW] &&
         !b[OB_SPAWN] && !b[OB_BLOB] && !b[OB_BUDGET];
}

// What every block keeps across ticks, so that no block reads a state
// scalar that block 0 rewrites at the gate.
struct Sticky {
  bool ef, so, spawn;
  int32_t ec, dsp;
};
// A blob world's sticky scalars: the pool and budget fail flags too.
struct StickyB : Sticky {
  bool bf, bbf;
};
typedef std::conditional<W::BLOB != 0, StickyB, Sticky>::type StickyT0;
// An event-ring world's: the tick's step and the ring's count.
struct StickyE : StickyT0 {
  int32_t step, evc;
};
typedef std::conditional<W::EV != 0, StickyE, StickyT0>::type StickyT;
template <class S>
PONY_FN bool& sticky_bf(S& s) { return s.bf; }
template <class S>
PONY_FN bool& sticky_bbf(S& s) { return s.bbf; }
template <class S>
PONY_FN int32_t& sticky_step(S& s) { return s.step; }
template <class S>
PONY_FN int32_t& sticky_evc(S& s) { return s.evc; }

#if PONY_PROF
// The worst device cohort's queue-wait p99 of the cumulative histograms
// `h` [NCOH, QWB] (engine.py: queue_wait_p99, in its int32 arithmetic):
// 2^k of the first bucket whose cumulative count reaches max(1, (total *
// 99 + 99) // 100); 0 for an empty histogram.
PONY_FN int32_t queue_wait_p99(const int32_t* h) {
  int32_t best = 0;
  for (int d = 0; d < W::NCOH; ++d) {
    uint32_t tot = 0;
    for (int k = 0; k < QWB; ++k) tot += (uint32_t)h[d * QWB + k];
    int32_t need = pony_floordiv((int32_t)(tot * 99u + 99u), (int32_t)100);
    need = need < 1 ? 1 : need;
    uint32_t cum = 0;
    int32_t first = -1;
    for (int k = 0; k < QWB; ++k) {
      cum += (uint32_t)h[d * QWB + k];
      if (first < 0 && (int32_t)cum >= need) first = k;
    }
    const int32_t v = (int32_t)tot > 0 ? 1 << (first < 0 ? 0 : first) : 0;
    best = v > best ? v : best;
  }
  return best;
}
#endif

#if PONY_EV
// The event ring (engine.py: event_ring), at the gate: class k's events
// after those of the classes before it, each class in row order, from the
// ring's count `evc` at the tick's start; a block writes its rows' events
// from the counts of the blocks before it (BEV) and stops where the ring
// is full. Returns the tick's events.
PONY_FN int32_t ev_rows(const PonyMegaArgs& a, const Grid& g,
                        const int32_t* ws, int32_t evc, int32_t step) {
  int32_t* ev = PI32(W::PTEL + T_EVDATA);
  int64_t r0, r1;
  block_rows(g, &r0, &r1);
  int32_t before = 0;
  for (int k = 0; k < NEVC; ++k) {
    const int32_t* row = ws + pws::BEV + (int64_t)k * GMAX;
    int32_t p = 0, t = 0;
    for (int64_t b = g.tid; b < g.nblocks; b += g.nthreads) {
      t += row[b];
      if (b < g.block) p += row[b];
    }
    p = block_sum(p);
    t = block_sum(t);
    int64_t at = (int64_t)evc + before + p;
    if (row[g.block] > 0) {
      for (int64_t b = r0; b < r1 && at < W::EVCAP; b += g.nthreads) {
        const int64_t r = b + g.tid;
        const int32_t on = r < r1 && ((ws[pws::EVM + r] >> k) & 1);
        int32_t tot;
        const int64_t q = at + block_excl_scan(on, &tot);
        if (on && q < W::EVCAP) {
          ev[q] = k + 1;
          ev[W::EVCAP + q] = (int32_t)r;
          ev[2 * W::EVCAP + q] = (int32_t)((uint32_t)step + 1u);
        }
        at += tot;
      }
    }
    before += t;
  }
  return before;
}
#endif


// After tick i's commit: every block reads the tick's accumulators `cur`
// and the scans' totals, and returns whether tick i + 1 runs; block 0's
// first thread writes the counters, the spill length and the aux.
PONY_FN bool gate(const PonyMegaArgs& a, const Grid& g, const int32_t* ws,
                  const int32_t* cur, int32_t i, StickyT& s) {
  const unsigned long long key = *(const unsigned long long*)(cur + A_EXITKEY);
  if (key && !s.ef) s.ec = (int32_t)(uint32_t)(key & 0xffffffffull);
  s.ef = s.ef || key;
  const int32_t nb = PI32(P_PLAN_BOUNDS)[W::NL];
  const int32_t rtot = ws[pws::ROFF + W::NL];
  const int32_t n_sp = rtot < W::SPILL ? rtot : (int32_t)W::SPILL;
  s.so = s.so || rtot > W::SPILL;
  if constexpr (W::SPAWN) s.spawn = s.spawn || cur[A_SFAIL] > 0;
  s.dsp = n_sp;
  const bool rsp = PI32(P_RSPILL_COUNT)[0] > 0;
  const bool any_m = cur[A_ANY_MUTED] > 0;
  uint8_t ob[OB_N] = {0};
  ob[OB_PENDING] = cur[A_ANY_OCC] > 0 || n_sp > 0 || rsp;
  ob[OB_EXIT] = s.ef;
  ob[OB_OVERFLOW] = s.so;
  ob[OB_SPAWN] = s.spawn;
  ob[OB_MUTED] = any_m;
  // host_pending: a host row is occupied after this tick's delivery.
  if constexpr (W::HOST) ob[OB_HOST] = cur[A_HOSTOCC] > 0;
  if constexpr (W::BLOB) {
    bool &bf = sticky_bf(s), &bbf = sticky_bbf(s);
    bf = bf || cur[A_BFAIL] > 0;
    bbf = bbf || cur[A_BBUDGET] > 0;
    ob[OB_BLOB] = bf;
    ob[OB_BUDGET] = bbf;
  }
#if PONY_EV
  const int32_t evc0 = sticky_evc(s);
  const int32_t nev = ev_rows(a, g, ws, evc0, sticky_step(s));
  sticky_evc(s) = (int64_t)evc0 + nev < W::EVCAP ? evc0 + nev
                                                 : (int32_t)W::EVCAP;
  sticky_step(s) = wadd(sticky_step(s), 1);
#endif
  if (g.block == 0) {
    // One counter a thread of block 0, so their round trips overlap.
    const int ptr[] = {P_N_REJECTED, P_N_BADMSG, P_N_DEADLETTER, P_N_MUTES,
                       P_N_DESTROYED, P_N_ERRORS, P_STEP_NO};
    const int32_t add[] = {rtot, cur[A_NBAD], cur[A_NDEAD], cur[A_BECAME],
                           cur[A_NDESTROYED], cur[A_NERR], 1};
    for (int64_t k = g.tid; k < 7; k += g.nthreads)
      PI32(ptr[k])[0] = wadd(PI32(ptr[k])[0], add[k]);
#if PONY_PROF
    // The phase costs (engine.py: phase_cost_lanes; state.PHASE_NAMES).
    const int32_t pc[] = {cur[A_PCDELIV], cur[A_PCDRAIN], cur[A_NPROC],
                          wadd(cur[A_NSPAWN], cur[A_NDESTROYED])};
    int32_t* ph = PI32(W::PTEL + T_PHASE);
    for (int64_t k = g.tid; k < 4; k += g.nthreads) ph[k] = wadd(ph[k], pc[k]);
    PONY_BSYNC();        // the counters, read below
#endif
  }
  if (g.first()) {
    int32_t* c;
    c = PI32(P_N_PROCESSED); c[0] = wadd(c[0], cur[A_NPROC]);
    c = PI32(P_N_DELIVERED); c[0] = wadd(c[0], nb - rtot);
    PI32(P_DSPILL_COUNT)[0] = n_sp;
    PU8(P_SPILL_OVERFLOW)[0] = s.so;
    if constexpr (W::SPAWN) {
      c = PI32(P_N_SPAWNED); c[0] = wadd(c[0], cur[A_NSPAWN]);
      PU8(P_SPAWN_FAIL)[0] = s.spawn;
    }
    if constexpr (W::BLOB) {
      PU8(W::PBLOB + 4)[0] = sticky_bf(s);
      PU8(W::PBLOB + 5)[0] = sticky_bbf(s);
      const int acc[] = {A_BALLOC, A_BFREE, A_BREMOTE};
      for (int k = 0; k < 3; ++k) {
        c = PI32(W::PBLOB + 6 + k);
        c[0] = wadd(c[0], cur[acc[k]]);
      }
    }
    PU8(P_EXIT_FLAG)[0] = s.ef;
    PI32(P_EXIT_CODE)[0] = s.ec;
    PI32(P_WORLD_BITS)[0] =
        (cur[A_ANY_PR_END] > 0) | (any_m << 1) | ((int32_t)rsp << 2);
    uint8_t* outb = PU8(P_OUT_BOOL);
    int32_t* oi = PI32(P_OUT_INT);
    for (int k = 0; k < OB_N; ++k) outb[k] = ob[k];
    for (int k = 0; k < OI_TICKS; ++k) oi[k] = 0;
    oi[OI_CODE] = s.ec;
    oi[OI_NPROC] = PI32(P_N_PROCESSED)[0];
    oi[OI_NDELIV] = PI32(P_N_DELIVERED)[0];
    oi[OI_TICKS] = i + 1;
#if PONY_PROF
    // The aggregates and the cumulative counters ride the aux.
    oi[OI_OCCSUM] = cur[A_OCCSUM];
    oi[OI_OCCMAX] = cur[A_OCC_MAX];
    oi[OI_NMUTED] = cur[A_NMUTED];
    oi[OI_NOVER] = cur[A_NOVER];
    oi[OI_NREJ] = PI32(P_N_REJECTED)[0];
    oi[OI_NBAD] = PI32(P_N_BADMSG)[0];
    oi[OI_NDEAD] = PI32(P_N_DEADLETTER)[0];
    oi[OI_NMUTES] = PI32(P_N_MUTES)[0];
    oi[OI_QW99] = queue_wait_p99(PI32(W::PTEL + T_QWH));
#endif
#if PONY_EV
    PI32(W::PTEL + T_EVCOUNT)[0] = sticky_evc(s);
    c = PI32(W::PTEL + T_EVDROP);
    if ((int64_t)evc0 + nev > W::EVCAP)
      c[0] = wadd(c[0], (int32_t)((int64_t)evc0 + nev - W::EVCAP));
#endif
#if PONY_TRACE
    // The span counters (engine.py: trace_span_lanes).
    int32_t* sc = PI32(W::PTEL + T_SPCOUNT);
    const int32_t spans = cur[A_SPANS], cnt0 = sc[0];
    c = PI32(W::PTEL + T_SPNEXT);
    c[0] = wadd(c[0], spans);
    if ((int64_t)cnt0 + spans > W::TSCAP) {
      c = PI32(W::PTEL + T_SPDROP);
      c[0] = wadd(c[0], (int32_t)((int64_t)cnt0 + spans - W::TSCAP));
    }
    sc[0] = (int64_t)cnt0 + spans < W::TSCAP ? cnt0 + spans
                                            : (int32_t)W::TSCAP;
#endif
  }
  return (i + 1 < a.limit) && (a.forced || aux_go(ob));
}

// ---- the per-phase clock ---------------------------------------------------

// A measurement hook: where P_CLOCK is not null, thread 0 of block 0 writes
// after every grid sync of tick i (and after its gate) the pair (phase id,
// %globaltimer in ns) into the int64 buffer [max(1, limit), CLOCK_SLOTS,
// 2]. A phase's time is its stamp minus the one before it (CK_START opens
// the tick), so it includes the sync that ends it. A null pointer costs
// one branch; the host build writes nothing. ops/megakernel.py reads these
// names.
enum PonyPhase {
  CK_START, CK_LANES, CK_KEYS, CK_SCAN, CK_PLACE, CK_COUNT, CK_RSCAN,
  CK_SCATTER, CK_DELIVER, CK_COMMIT, CK_GATE, CK_CENSUS, CK_RESERVE,
  CK_BFREE
};
constexpr int CLOCK_SLOTS = 32;

struct Clock {
  int64_t* p;
  int32_t tick, slot, rows;
  PONY_FN void stamp(const Grid& g, int ph) {
#ifdef __CUDACC__
    if (p != nullptr && g.first() && tick < rows && slot < CLOCK_SLOTS) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      int64_t* q = p + ((int64_t)tick * CLOCK_SLOTS + slot) * 2;
      q[0] = ph;
      q[1] = (int64_t)t;
    }
    ++slot;
#else
    (void)g;
    (void)ph;
#endif
  }
};

#define PONY_GSYNC_AT(ph) \
  do {                     \
    PONY_GSYNC();          \
    ck.stamp(g, ph);       \
  } while (0)

// ---- the window ---------------------------------------------------------

PONY_FN void pony_window(const PonyMegaArgs& a, const Grid& g, Smem& sm) {
  int32_t* ws = (int32_t*)a.p[P_WS];
  int32_t* acc = ws + pws::ACC;
  // Every block reads the previous aux and the sticky scalars before the
  // first sync; nothing writes them before the first gate.
  uint8_t ob[OB_N];
  int32_t oi[OI_TICKS];
  {
    int nb = 0, ni = 0;
    for (int k = 0; k < 20; ++k) {
      if (aux_is_bool(k)) ob[nb++] = *(const uint8_t*)a.p[P_AUX_IN + k] != 0;
      else oi[ni++] = *(const int32_t*)a.p[P_AUX_IN + k];
    }
  }
  StickyT s = {};
  s.ef = PU8(P_EXIT_FLAG)[0] != 0;
  s.so = PU8(P_SPILL_OVERFLOW)[0] != 0;
  s.spawn = PU8(P_SPAWN_FAIL)[0] != 0;
  s.ec = PI32(P_EXIT_CODE)[0];
  s.dsp = PI32(P_DSPILL_COUNT)[0];
  if constexpr (W::BLOB) {
    sticky_bf(s) = PU8(W::PBLOB + 4)[0] != 0;
    sticky_bbf(s) = PU8(W::PBLOB + 5)[0] != 0;
  }
  if constexpr (W::EV) {
    sticky_step(s) = PI32(P_STEP_NO)[0];
    sticky_evc(s) = PI32(W::PTEL + T_EVCOUNT)[0];
  }
#if PONY_PROF
  for (int64_t k = g.tid; k < TEL_N; k += g.nthreads) tel_smem()[k] = 0;
#endif
  bool go = a.forced ? a.limit > 0 : (a.force || aux_go(ob));
  if (g.first()) {
    // A window that runs no tick returns the previous aux unchanged.
    for (int k = 0; k < OB_N; ++k) PU8(P_OUT_BOOL)[k] = ob[k];
    for (int k = 0; k < OI_TICKS; ++k) PI32(P_OUT_INT)[k] = oi[k];
    PI32(P_OUT_INT)[OI_TICKS] = 0;
    acc_reset(acc);
    acc_reset(acc + ACC_SET);
  }
  PONY_FOR(r, W::NL) {
    ws[pws::DSP_CNT + r] = 0;
    ws[pws::TCNT + r] = 0;
    ws[pws::NEWLY + r] = 0;
    if constexpr (W::SPAWN) ws[pws::BORN + r] = 0;
    for (int k = 0; k < W::K; ++k) {
      ws[pws::RMAX + (int64_t)k * W::NL + r] = -1;
      ws[pws::RMIN + (int64_t)k * W::NL + r] = INT_MAX;
    }
  }
  PONY_FOR(d, NPASS * RADIX) ws[pws::GTOT + d] = 0;
  PONY_FOR(k, NTILE) ws[pws::LCNT + k] = 0;
  PONY_GSYNC();
  if (go) ph_pending(a, g, ws, acc + ACC_SET);   // tick 0's "previous"
  PONY_GSYNC();
  Clock ck = {(int64_t*)a.p[P_CLOCK], 0, 0, a.limit > 1 ? a.limit : 1};
  for (int32_t i = 0; go; ++i) {
    int32_t* cur = acc + (i & 1) * ACC_SET;
    int32_t* prev = acc + ((i + 1) & 1) * ACC_SET;
    const bool inject = a.forced || i == 0;
    ck.tick = i;
    ck.slot = 0;
    ck.stamp(g, CK_START);
    if constexpr (W::SPAWN || W::BLOB) {
      ph_census(a, g, ws, prev, s.dsp);
      PONY_GSYNC_AT(CK_CENSUS);
    }
    if constexpr (W::SPAWN) {
      ph_reserve(a, g, ws);
      PONY_GSYNC_AT(CK_RESERVE);
    }
    if constexpr (W::BLOB) {
      ph_bfree(a, g, ws);
      PONY_GSYNC_AT(CK_BFREE);
    }
    ph_lanes(a, g, ws, cur, prev, s.dsp);
    PONY_GSYNC_AT(CK_LANES);
    ph_keys(a, g, ws, inject, cur, prev);
    PONY_GSYNC_AT(CK_KEYS);
    ph_scan(a, g, ws, cur);
    PONY_GSYNC_AT(CK_SCAN);
    const bool seg = SEG_FITS && cur[A_SEGMAX] <= SEG;
    if (seg) {
      ph_place(a, g, ws, sm);
      PONY_GSYNC_AT(CK_PLACE);
    } else {
      for (int pass = 0; pass < NPASS; ++pass) {
        const bool last = pass == NPASS - 1;
        const int32_t* kin = pass == 0 ? PI32(P_PLAN_KEY)
                                       : ws + (pass % 2 ? pws::KA : pws::KB);
        const int32_t* vin = pass == 0 ? nullptr
                                       : ws + (pass % 2 ? pws::VA : pws::VB);
        int32_t* kout = last ? ws + pws::SKEY
                             : ws + (pass % 2 ? pws::KB : pws::KA);
        int32_t* vout = last ? PI32(P_PLAN_PERM)
                             : ws + (pass % 2 ? pws::VB : pws::VA);
        ph_count(g, ws, sm, kin, pass);
        PONY_GSYNC_AT(CK_COUNT);
        digit_rows(g, ws, pass);
        PONY_GSYNC_AT(CK_RSCAN);
        ph_scatter(g, ws, sm, kin, vin, kout, vout, pass);
        if (pass == 0)
          PONY_FOR_BLOCKS(c, NCH) fix_chunk(a, g, ws, c);
        PONY_GSYNC_AT(CK_SCATTER);
      }
    }
    ph_deliver(a, g, ws, inject, seg);
    PONY_GSYNC_AT(CK_DELIVER);
    ph_commit(a, g, ws, cur);
    PONY_GSYNC_AT(CK_COMMIT);
    go = gate(a, g, ws, cur, i, s);
    ck.stamp(g, CK_GATE);
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
                       100 + OI_NPROC, 100 + OI_NDELIV, 100 + OI_OCCSUM,
                       100 + OI_OCCMAX, 100 + OI_NMUTED, 100 + OI_NOVER,
                       100 + OI_NREJ, 100 + OI_NBAD, 100 + OI_NDEAD,
                       100 + OI_NMUTES, 100 + OI_QW99, 100 + OI_TICKS};
  for (int v : named) out[m++] = v;
  return m;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS, 4) pony_mega_kernel(
    const PonyMegaArgs a) {
  __shared__ Smem sm;
  const Grid g = {blockIdx.x, gridDim.x, threadIdx.x, blockDim.x};
  pony_window(a, g, sm);
}

// out: blocks per SM, SMs, resident blocks (their product), registers a
// thread, local (spill) bytes a thread, static shared bytes a block,
// cooperative launch supported, threads a block.
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
  out[7] = THREADS;
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
  static thread_local Smem sm;
  pony_window(a, g, sm);
  return 0;
}

#endif

// One actor lane's drain and dispatch, shared by the fused dispatch kernel
// (csrc/fused_dispatch.cu) and the window kernel (csrc/mega_window.cu).
//
// A cohort reaches this code as a struct generated by
// ponyc_tpu_torch/ops/lanecode.py (emit_cohort): its constants (NB, BATCH,
// CAP, MS, W1, W1_IN, BASE, NOYIELD, NS spawn sites, SD dispatches that may
// spawn, NI sync-construction words, ...), its State struct, load/store of
// the state columns, one function beh_<j> per behaviour, the `dispatch`
// switch that picks one by message id, and the per-site spawn layout
// (resv_row, claim_row, site_target, site_off, site_per, site_n). Each cohort is a struct of its own,
// so the window kernel holds every cohort of a program in one translation
// unit.
//
// Numbers. The helpers below spell torch's elementwise semantics: integer
// arithmetic wraps (done in unsigned types), `//` floors, `%` takes the
// divisor's sign, a shift by the width or more saturates. Sources that
// include this are built with -fmad=false and never --use_fast_math, so a
// float expression rounds after every op, as torch's eager kernels do.
//
// The same code builds as host C++ (no __CUDACC__); the CPU tests use that
// build.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PONY_FN __device__ __forceinline__
#else
#define PONY_FN inline
#endif

// ---- torch's elementwise semantics ------------------------------------

template <typename To, typename From>
PONY_FN To pony_bitcast(From x) {
  static_assert(sizeof(To) == sizeof(From), "bitcast of unequal widths");
  To y;
  memcpy(&y, &x, sizeof(To));
  return y;
}
PONY_FN float pony_f32(uint32_t bits) { return pony_bitcast<float>(bits); }
PONY_FN double pony_f64(uint64_t bits) { return pony_bitcast<double>(bits); }

// Integer floor division (c10 div_floor_integer). A zero divisor gives
// -1 for a zero dividend and -2 otherwise, as the plain path does
// (runtime/engine.py's _IntDivision, the JAX package's CPU results).
template <typename T>
PONY_FN T pony_floordiv(T a, T b) {
  if (b == 0) return a == 0 ? (T)-1 : (T)-2;
  if ((a < 0) != (b < 0)) {
    const T q = a / b;
    const T r = a % b;
    return r ? (T)(q - 1) : q;
  }
  return a / b;
}

// Remainder with the divisor's sign (torch.remainder); an integer zero
// divisor gives 0, as the plain path does (see pony_floordiv).
template <typename T>
PONY_FN T pony_rem(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    T r = fmod(a, b);
    if ((r != 0) && ((b < 0) != (r < 0))) r += b;
    return r;
  } else {
    if (b == 0) return 0;
    T r = a % b;
    if (r != 0 && ((r < 0) != (b < 0))) r = (T)(r + b);
    return r;
  }
}

// Shifts: a shift by the width or more (or negative) saturates.
template <typename T>
PONY_FN T pony_shl(T a, T b) {
  constexpr T max_shift = sizeof(T) * 8;
  if ((typename std::make_signed<T>::type)b < 0 || b >= max_shift) return 0;
  return (T)((typename std::make_unsigned<T>::type)a << b);
}
template <typename T>
PONY_FN T pony_shr(T a, T b) {
  constexpr T max_shift = sizeof(T) * 8 - std::is_signed<T>::value;
  if ((typename std::make_signed<T>::type)b < 0 || b >= max_shift)
    return (T)(a >> max_shift);
  return (T)(a >> b);
}

template <typename T>
PONY_FN T pony_max(T a, T b) {
  if constexpr (std::is_same<T, float>::value) return fmaxf(a, b);
  else if constexpr (std::is_same<T, double>::value) return fmax(a, b);
  else return a < b ? b : a;
}
template <typename T>
PONY_FN T pony_min(T a, T b) {
  if constexpr (std::is_same<T, float>::value) return fminf(a, b);
  else if constexpr (std::is_same<T, double>::value) return fmin(a, b);
  else return b < a ? b : a;
}

// Integer power by squaring, wrapping (torch's powi for exponents >= 0).
template <typename T>
PONY_FN T pony_powi(T a, T b) {
  typedef typename std::conditional<(sizeof(T) > 4), uint64_t,
                                    uint32_t>::type U;
  U result = 1, base = (U)a;
  while (b) {
    if (b & 1) result *= base;
    b /= 2;
    base *= base;
  }
  return (T)result;
}

// What one behaviour did on one lane for one message. A cohort with spawn
// sites (NS > 0) also records, per flat site g, the claimed ref (-1: none)
// and, for a sync construction, `has` and the constructor's field values
// as int32 bits, and `sf`: a wanted spawn found no reserved slot. A cohort
// without keeps the smaller struct (it may live in local memory, where
// every byte counts against the window kernel's spills).
template <int MS, int W1>
struct PonyOutBase {
  int32_t tgt[MS > 0 ? MS : 1];
  int32_t w[MS > 0 ? MS : 1][W1];
  bool ef, yf, ds, erf;
  int32_t ec, erc, erl;
};
template <int MS, int W1, int NS = 0, int NI = 0>
struct PonyOutT : PonyOutBase<MS, W1> {
  bool sf;
  int32_t clm[NS];
  bool has[NS];
  int32_t iv[NS][NI > 0 ? NI : 1];
};
template <int MS, int W1, int NI>
struct PonyOutT<MS, W1, 0, NI> : PonyOutBase<MS, W1> {};

// ---- the device blob pool (cohorts with BLOB = 1; the window kernel) ----
//
// The pool as a lane sees it (planar: word w of slot s at data[w * nslots
// + s]; a handle is slot | generation << 20, ops/pack.py). One blob has
// one owner (iso) and the free slots a tick hands out are fixed before
// any lane runs, so no two lanes write one slot in a tick; a val blob is
// only read.
struct PonyBlobPool {
  int32_t* data;
  uint8_t* used;
  int32_t* len;
  int32_t* gen;
  int64_t nslots;
  int32_t words;
};

// A blob cohort's Out: the pool, this dispatch's reserved global slot at
// each alloc site (rb, -1 none) and whether its BLOB_DISPATCHES budget is
// spent (bover); back: a wanted alloc found no slot (bf: the pool is
// exhausted; bbf: past the budget), whether it allocated (bal), and the
// allocs, frees and Blob arguments that arrived off the pool.
template <class Base, int NBS>
struct PonyOutB : Base {
  const PonyBlobPool* pool;
  int32_t rb[NBS > 0 ? NBS : 1];
  bool bover, bf, bbf, bal;
  int32_t nal, nfr, nrm;
};

constexpr int32_t PONY_BLOB_GEN_SHIFT = 20;
constexpr int32_t PONY_BLOB_GEN_MASK = 0x3FF;

// Handle h's slot, where h addresses the pool with its slot's current
// generation (a stale handle to a recycled slot is dead).
template <class O>
PONY_FN bool pony_blob_local(const O& o, int32_t h, int64_t* hl) {
  const int64_t s = h & ((1 << PONY_BLOB_GEN_SHIFT) - 1);
  if (h < 0 || s >= o.pool->nslots) return false;
  *hl = s;
  return o.pool->gen[s] ==
         ((h >> PONY_BLOB_GEN_SHIFT) & PONY_BLOB_GEN_MASK);
}

// Word i of blob h; 0 for a dead handle, a free slot or a word past the
// pool's width.
template <class O>
PONY_FN int32_t pony_blob_get(const O& o, int32_t h, int32_t i) {
  int64_t s;
  if (!pony_blob_local(o, h, &s) || !o.pool->used[s] || i < 0 ||
      i >= o.pool->words)
    return 0;
  return o.pool->data[(int64_t)i * o.pool->nslots + s];
}

template <class O>
PONY_FN int32_t pony_blob_len(const O& o, int32_t h) {
  int64_t s;
  return pony_blob_local(o, h, &s) ? o.pool->len[s] : 0;
}

template <class O>
PONY_FN bool pony_blob_set(const O& o, int32_t h, int32_t i, int32_t v,
                           bool when) {
  int64_t s;
  if (when && pony_blob_local(o, h, &s) && i >= 0 && i < o.pool->words &&
      o.pool->used[s])
    o.pool->data[(int64_t)i * o.pool->nslots + s] = v;
  return true;
}

template <class O>
PONY_FN bool pony_blob_free(O& o, int32_t h, bool when) {
  int64_t s;
  if (when && pony_blob_local(o, h, &s) && o.pool->used[s]) {
    o.pool->used[s] = 0;
    o.pool->len[s] = 0;
    ++o.nfr;
  }
  return true;
}

// Alloc at this dispatch's reserved slot of site g: the generation bumps,
// the slot is used with length ln (clamped to the width) and zeroed
// words. Returns the handle, or -1 where `when` is false or no slot was
// reserved (then the fail flag of the knob to raise).
template <class O>
PONY_FN int32_t pony_blob_alloc(O& o, int g, int32_t ln, bool when) {
  if (!when) return -1;
  const int32_t slot = o.rb[g];
  if (slot < 0) {
    if (o.bover) o.bbf = true;
    else o.bf = true;
    return -1;
  }
  const PonyBlobPool& p = *o.pool;
  const int32_t ng = (p.gen[slot] + 1) & PONY_BLOB_GEN_MASK;
  p.gen[slot] = ng;
  p.used[slot] = 1;
  p.len[slot] = ln < 0 ? 0 : (ln > p.words ? p.words : ln);
  for (int w = 0; w < p.words; ++w) p.data[(int64_t)w * p.nslots + slot] = 0;
  ++o.nal;
  o.bal = true;
  return (int32_t)(((uint32_t)ng << PONY_BLOB_GEN_SHIFT) | (uint32_t)slot);
}

template <class O>
PONY_FN bool pony_blob_remote(O& o, bool remote) {
  o.nrm += remote;
  return true;
}

// What a lane's blob ops did over its whole drain.
struct PonyBlobAcc {
  int32_t nal, nfr, nrm;
  bool bf, bbf;
};

// The blob hooks of a cohort without the pool.
struct PonyNoBlob {};

// A fixed list of pointers (state columns), passed to a kernel by value.
template <int N>
struct PonyPtrs {
  void* p[N > 0 ? N : 1];
  PONY_FN void* operator[](int k) const { return p[k]; }
};

// What one lane's whole drain did (nclaim: spawns that claimed a slot;
// sf: a wanted spawn found none).
struct PonyLane {
  int32_t nproc, nbad, ec, erc, erl, nclaim;
  uint32_t consumed;
  bool ef, ds, erf, sf;
};

// The spawn hooks of a cohort without spawn sites.
struct PonyNoSpawn {
  PONY_FN int32_t resv(int d, int g) const {
    (void)d;
    (void)g;
    return -1;
  }
  template <class O>
  PONY_FN void claim(int k, const O& o) const {
    (void)k;
    (void)o;
  }
};

// One actor lane's drain (≙ ponyint_actor_run's loop, actor.c:383-549):
// for k < BATCH, while k < n_run and no yield stopped the batch, read the
// message in ring slot (head + k) mod CAP through `ring(slot, word)`, run
// the behaviour its id names on the lane's state `s`, and hand every send
// slot (k, m) to `send(k, m, target, words)` (target -1 = no message).
// Exit: the first code wins; error: the latest code and site win; destroy
// ORs. Heads wrap: the caller adds `consumed` in unsigned arithmetic.
//
// Spawns (C::NS sites): a `used` counter walks the SD dispatches' worth of
// reserved refs, `spawn.resv(d, g)` for dispatch d and flat site g (-1 past
// SD); it advances on a slot that claimed a slot or failed a wanted spawn
// (a second spawn never reuses the first's reservation). Every slot k hands
// its claims to `spawn.claim(k, o)`.
//
// The blob pool (C::BLOB): each dispatch gets the pool (`blob.pool`) and,
// per alloc site g, `blob.resv(d, g)` of the d-th of its BD windows, d the
// count of earlier dispatches that allocated (-1 past BD, where a wanted
// alloc raises the budget flag); what the blob ops did adds into
// `blob.acc`.
template <class C, class Ring, class Send, class Spawn,
          class Blob = PonyNoBlob>
PONY_FN PonyLane pony_lane(typename C::State& s, uint32_t h, int32_t nr,
                           int32_t id, const Ring& ring, const Send& send,
                           const Spawn& spawn, const Blob& blob = Blob()) {
  PonyLane r = {0, 0, 0, 0, 0, 0, 0u, false, false, false, false};
  bool stopped = false;
  int used = 0;
  int bused = 0;
  for (int k = 0; k < C::BATCH; ++k) {
    typename C::Out o;
    for (int m = 0; m < (C::MS > 0 ? C::MS : 1); ++m) {
      o.tgt[m] = -1;
      for (int j = 0; j < C::W1; ++j) o.w[m][j] = 0;
    }
    o.ef = o.yf = o.ds = o.erf = false;
    o.ec = o.erc = o.erl = 0;
    if constexpr (C::NS > 0) {
      o.sf = false;
      for (int g = 0; g < C::NS; ++g) {
        o.clm[g] = -1;
        o.has[g] = false;
      }
    }
    if constexpr (C::BLOB) {
      o.pool = &blob.pool;
      o.bover = o.bf = o.bbf = o.bal = false;
      o.nal = o.nfr = o.nrm = 0;
    }
    if (nr > k && !stopped) {
      const uint32_t slot = (h + (uint32_t)k) & (uint32_t)(C::CAP - 1);
      int32_t w[C::W1_IN];
      for (int j = 0; j < C::W1_IN; ++j) w[j] = ring(slot, j);
      const int32_t local = (int32_t)((uint32_t)w[0] - (uint32_t)C::BASE);
      if (local >= 0 && local < C::NB) {
        ++r.nproc;
        if constexpr (C::BLOB) {
          for (int g = 0; g < C::NBS; ++g)
            o.rb[g] = bused < C::BD ? blob.resv(bused, g) : -1;
          o.bover = bused >= C::BD;
        }
        if constexpr (C::NS > 0) {
          int32_t rv[C::NS];
          for (int g = 0; g < C::NS; ++g)
            rv[g] = used < C::SD ? spawn.resv(used, g) : -1;
          C::dispatch(local, s, w + 1, id, rv, o);
        } else {
          C::dispatch(local, s, w + 1, id, nullptr, o);
        }
      } else {
        ++r.nbad;
      }
      ++r.consumed;
    }
    for (int m = 0; m < C::MS; ++m) send(k, m, o.tgt[m], o.w[m]);
    if constexpr (C::BLOB) {
      bused += o.bal;
      PonyBlobAcc& a = *blob.acc;
      a.nal += o.nal;
      a.nfr += o.nfr;
      a.nrm += o.nrm;
      a.bf = a.bf || o.bf;
      a.bbf = a.bbf || o.bbf;
    }
    if constexpr (C::NS > 0) {
      bool spawned = o.sf;
      for (int g = 0; g < C::NS; ++g) {
        spawned = spawned || o.clm[g] >= 0;
        r.nclaim += o.clm[g] >= 0;
      }
      used += spawned;
      r.sf = r.sf || o.sf;
      spawn.claim(k, o);
    }
    if (o.ef && !r.ef) r.ec = o.ec;        // exit: the first code wins
    r.ef = r.ef || o.ef;
    r.ds = r.ds || o.ds;
    if (o.erf) {                           // errors: the latest code wins
      r.erc = o.erc;
      r.erl = o.erl;
    }
    r.erf = r.erf || o.erf;
    if (!C::NOYIELD) stopped = stopped || o.yf;
  }
  return r;
}

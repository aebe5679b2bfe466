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
//     exit: the first code wins; error: the latest code and site win;
//     destroy: OR; yield stops the batch (unless noyield)
//   state out, head + consumed, and the cohort sums nproc, nbad, the
//   first exiting lane's code and whether any lane exited.
//
// The behaviour bodies come from a generated header (pony_cohort.h,
// written by ponyc_tpu_torch/ops/lanecode.py from an ATen-level trace of
// each body, found through -I): its constants (PONY_NB, PONY_BATCH, ...), the state struct,
// one function pony_beh_<j> per behaviour and the PONY_SWITCH that picks
// one by message id. Where the TPU kernel evaluates every behaviour on
// every lane and selects, a thread here evaluates only the one its message
// names: bodies are lane-local and pure, so that is exact, and it is the
// reference compiler's generated dispatch switch (genfun.c).
//
// Layout (actor axis minor everywhere, so a warp's 32 threads touch 32
// neighbouring words): buf int32 [cap, w1_in, rows]; head, n_run, ids
// int32 [rows]; fields [rows] each; out_tgt int32 [batch*ms*rows] with
// entry (k, m, i) at (k*ms + m)*rows + i; out_words int32 [w1, batch*ms*
// rows] (the engine's final layout, so no permute pass follows); the
// destroy plane uint8 [rows] and the error planes uint8/int32/int32 [rows]
// only when a body uses them; red int32 [8]: nproc, nbad, exit code, any
// exit, then a 64-bit exit key and a block ticket (scratch).
//
// Numbers. Built with -fmad=false and never --use_fast_math, so a float
// expression rounds after every op, as torch's eager kernels do (each op
// there is its own kernel). Integer arithmetic is spelt in unsigned types
// where it must wrap; torch's floor division, remainder and shift rules
// are the helpers below.
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

// Integer floor division (c10 div_floor_integer).
template <typename T>
PONY_FN T pony_floordiv(T a, T b) {
  if ((a < 0) != (b < 0)) {
    const T q = a / b;
    const T r = a % b;
    return r ? (T)(q - 1) : q;
  }
  return a / b;
}

// Remainder with the divisor's sign (torch.remainder).
template <typename T>
PONY_FN T pony_rem(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    T r = fmod(a, b);
    if ((r != 0) && ((b < 0) != (r < 0))) r += b;
    return r;
  } else {
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

// What one behaviour did on one lane for one message.
template <int MS, int W1>
struct PonyOutT {
  int32_t tgt[MS > 0 ? MS : 1];
  int32_t w[MS > 0 ? MS : 1][W1];
  bool ef, yf, ds, erf;
  int32_t ec, erc, erl;
};

#include "pony_cohort.h"

struct PonyLane {
  int32_t nproc, nbad, ec;
  bool ef;
};

// One actor lane's whole drain: the part shared by the kernel and the
// host build.
PONY_FN PonyLane pony_lane(int64_t i, int64_t rows,
                           const int32_t* __restrict__ buf,
                           const int32_t* __restrict__ head,
                           const int32_t* __restrict__ n_run,
                           const int32_t* __restrict__ ids, PONY_FIELD_PARAMS,
                           int32_t* __restrict__ out_tgt,
                           int32_t* __restrict__ out_words,
                           int32_t* __restrict__ new_head,
                           uint8_t* __restrict__ ds_out,
                           uint8_t* __restrict__ erf_out,
                           int32_t* __restrict__ erc_out,
                           int32_t* __restrict__ erl_out) {
  PonyState s;
  PONY_LOAD(s, i);
  const uint32_t h = (uint32_t)head[i];
  const int32_t nr = n_run[i];
  const int32_t id = ids[i];
  const size_t e = (size_t)PONY_BATCH * PONY_MS * (size_t)rows;
  bool stopped = false, ef = false, ds = false, erf = false;
  int32_t ec = 0, erc = 0, erl = 0, nproc = 0, nbad = 0;
  uint32_t consumed = 0;
  (void)e; (void)out_tgt; (void)out_words;
  for (int k = 0; k < PONY_BATCH; ++k) {
    PonyOut o;
    for (int m = 0; m < (PONY_MS > 0 ? PONY_MS : 1); ++m) {
      o.tgt[m] = -1;
      for (int j = 0; j < PONY_W1; ++j) o.w[m][j] = 0;
    }
    o.ef = o.yf = o.ds = o.erf = false;
    o.ec = o.erc = o.erl = 0;
    if (nr > k && !stopped) {
      const uint32_t slot = (h + (uint32_t)k) & (uint32_t)(PONY_CAP - 1);
      const int32_t* src = buf + (size_t)slot * PONY_W1_IN * rows + i;
      int32_t w[PONY_W1_IN];
      for (int j = 0; j < PONY_W1_IN; ++j) w[j] = src[(size_t)j * rows];
      const int32_t local = (int32_t)((uint32_t)w[0] - (uint32_t)PONY_BASE);
      if (local >= 0 && local < PONY_NB) {
        ++nproc;
        PONY_SWITCH(local, s, w + 1, id, o);
      } else {
        ++nbad;
      }
      ++consumed;
    }
    for (int m = 0; m < PONY_MS; ++m) {
      const size_t entry = ((size_t)k * PONY_MS + m) * rows + i;
      out_tgt[entry] = o.tgt[m];
      for (int j = 0; j < PONY_W1; ++j) out_words[j * e + entry] = o.w[m][j];
    }
    if (o.ef && !ef) ec = o.ec;          // exit: the first code wins
    ef = ef || o.ef;
    ds = ds || o.ds;
    if (o.erf) {                         // errors: the latest code wins
      erc = o.erc;
      erl = o.erl;
    }
    erf = erf || o.erf;
    if (!PONY_NOYIELD) stopped = stopped || o.yf;
  }
  PONY_STORE(s, i);
  new_head[i] = (int32_t)(h + consumed);
#if PONY_DESTROY
  ds_out[i] = ds;
#else
  (void)ds; (void)ds_out;
#endif
#if PONY_ERROR
  erf_out[i] = erf;
  erc_out[i] = erc;
  erl_out[i] = erl;
#else
  (void)erf_out; (void)erc_out; (void)erl_out;
#endif
  PonyLane r = {nproc, nbad, ec, ef};
  return r;
}

#ifdef __CUDACC__

#define PONY_THREADS 256

__global__ void __launch_bounds__(PONY_THREADS) pony_fused_kernel(
    int64_t rows, const int32_t* __restrict__ buf,
    const int32_t* __restrict__ head, const int32_t* __restrict__ n_run,
    const int32_t* __restrict__ ids, PONY_FIELD_PARAMS,
    int32_t* __restrict__ out_tgt, int32_t* __restrict__ out_words,
    int32_t* __restrict__ new_head, uint8_t* __restrict__ ds_out,
    uint8_t* __restrict__ erf_out, int32_t* __restrict__ erc_out,
    int32_t* __restrict__ erl_out, int32_t* __restrict__ red) {
  __shared__ int32_t s_np, s_nb;
  __shared__ unsigned long long s_key;
  if (threadIdx.x == 0) {
    s_np = 0;
    s_nb = 0;
    s_key = 0ull;
  }
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  PonyLane r = {0, 0, 0, false};
  if (i < rows)
    r = pony_lane(i, rows, buf, head, n_run, ids, PONY_FIELD_ARGS, out_tgt,
                  out_words, new_head, ds_out, erf_out, erc_out, erl_out);
  const int32_t np = __reduce_add_sync(0xffffffffu, r.nproc);
  const int32_t nb = __reduce_add_sync(0xffffffffu, r.nbad);
  if ((threadIdx.x & 31) == 0) {
    if (np) atomicAdd(&s_np, np);
    if (nb) atomicAdd(&s_nb, nb);
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

// Launches on `stream` after zeroing `red`, and returns
// cudaGetLastError() as an int (0 = ok). Allocates nothing and does not
// synchronise.
extern "C" int PONY_ENTRY(const void* buf, const void* head,
                          const void* n_run, const void* ids,
                          PONY_FIELD_VOIDS, void* out_tgt, void* out_words,
                          void* new_head, void* ds_out, void* erf_out,
                          void* erc_out, void* erl_out, void* red,
                          long long rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(red, 0, 8 * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return 0;
  const long long blocks = (rows + PONY_THREADS - 1) / PONY_THREADS;
  pony_fused_kernel<<<(unsigned)blocks, PONY_THREADS, 0, st>>>(
      (int64_t)rows, (const int32_t*)buf, (const int32_t*)head,
      (const int32_t*)n_run, (const int32_t*)ids, PONY_FIELD_CASTS,
      (int32_t*)out_tgt, (int32_t*)out_words, (int32_t*)new_head,
      (uint8_t*)ds_out, (uint8_t*)erf_out, (int32_t*)erc_out,
      (int32_t*)erl_out, (int32_t*)red);
  return (int)cudaGetLastError();
}

#else  // host build: the lanes in order, for the CPU tests

extern "C" int PONY_ENTRY(const void* buf, const void* head,
                          const void* n_run, const void* ids,
                          PONY_FIELD_VOIDS, void* out_tgt, void* out_words,
                          void* new_head, void* ds_out, void* erf_out,
                          void* erc_out, void* erl_out, void* red,
                          long long rows, void* stream) {
  (void)stream;
  int32_t* r = (int32_t*)red;
  memset(r, 0, 8 * sizeof(int32_t));
  bool any = false;
  for (long long i = 0; i < rows; ++i) {
    PonyLane l = pony_lane(
        i, rows, (const int32_t*)buf, (const int32_t*)head,
        (const int32_t*)n_run, (const int32_t*)ids, PONY_FIELD_CASTS,
        (int32_t*)out_tgt, (int32_t*)out_words, (int32_t*)new_head,
        (uint8_t*)ds_out, (uint8_t*)erf_out, (int32_t*)erc_out,
        (int32_t*)erl_out);
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

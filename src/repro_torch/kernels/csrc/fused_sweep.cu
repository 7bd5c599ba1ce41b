// Fused maintenance sweep iteration — the paper's per-vertex inner loop in
// one launch (JOD or VDC, drop modes none / det / prob).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_sweep.py::fused_sweep
// (body _kernel).  For every query q and vertex v, at sweep iteration i:
//
//   1. expand: new = carry (+) (+)_d msg(states[q, nbr[v, d]], w[v, d])
//      (csrc/ell_row.cuh, the same code as the ell_spmv kernel); in VDC the
//      engine aggregates the J store's messages itself and passes `new`
//      (the reference's new= variant), and the kernel reads new[q, v]
//   2. DroppedVT probe: dropped_here = Det row has i | Bloom query of
//      (v, i) salted by q (csrc/bloom_hash.cuh);  repair = dropped & active & !sched
//   3. change-point detection against the frozen pre-update store:
//      old, stale, changed
//   4. drop selection (the per-query DropParams row, stateless hash coin),
//      difference-store upsert (oldest eviction) and remove_at
//   5. cur advance
//   6. (det) Det store: upsert(i, to_drop), upsert(evicted_iter, evicted),
//      remove(i, to_store | vanish); evictions and the highest registered
//      iteration reduce per query by atomics (integer, exact in any order)
//
// Every store operation repeats the order of repro_torch/core/diffstore.py
// (value_at takes the first matching column; upsert returns the row's
// column-0 iteration as evicted_iter whatever happens and evicts only when an
// insert meets a full row; removal runs on the upserted row), so the outputs
// equal the plain version's bit for bit; pr_sum's expand differs from the
// plain PyTorch sum only in summation order, and equals ell_spmv's exactly.
//
// Stores are written out of place: the pre-update store (old_dstore) is
// also the working store of the first iteration and must stay frozen.
//
// Bound on the card.  The function reads the adjacency and gathered states,
// the [Q, V] inputs, the working store (S iterations + values + count), the
// old store's iterations (and one value per row), and writes the store and
// the per-vertex outputs once.  In the main path's shape (Q=8, V=3,774,768,
// D=24, S=16) that is about 12 GB, about 3.6 ms at 3.35 TB/s; det mode adds
// the Det rows (S_d=32 iterations + count) in and out, about 8 GB more.
// chip_smoke.py computes the bound from each run's shapes.  The work is a
// few integer and float operations per byte: bytes bound it.
//
// The new= variant reads new[q, v] (4 bytes a row) in place of the
// adjacency, the gathered states and the carry; the rest is the same.
//
// Design (a simple, correct first version).  One thread per vertex row; it
// runs the expand for a block of up to 8 queries in registers (the adjacency
// is read once, as in ell_spmv) and then stages 2-6 for each query of the
// block on that row, with the store row in registers (static indexing over
// MAXS = 16 or 32 columns, so no local memory).  A top-level switch picks a
// body specialised for semiring x drop mode x MAXS; the new= variant has
// one body per drop mode x MAXS (nothing after the expand depends on the
// semiring).  Not yet done: staging
// store rows through shared memory for coalesced 16-byte loads, and writing
// in place to skip unchanged rows.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "bloom_hash.cuh"
#include "ell_row.cuh"

namespace {

using ell_row::QB;

constexpr int THREADS = 128;
constexpr int MAX_SD = 32;  // Det store capacity the kernel takes
constexpr int IMAX = 0x7fffffff;

enum Mode { NONE = 0, DET = 1, PROB = 2 };

}  // namespace

// Arguments, mirrored field for field by kernels/fused_sweep.py (_FusedArgs).
struct FusedArgs {
  // expand
  const float* states_t;  // [Vp, Q] (transposed; column V holds the identity)
  const int* nbr;         // [V, D]
  const float* w;         // [V, D]
  const float* kcarry;    // [Q, V]
  const float* new_vals;  // [Q, V] the new= variant (VDC): null runs the expand
  // sweep inputs
  const unsigned char* sched;      // bool [Q, V]
  const unsigned char* active;     // bool [Q]
  const float* cur;                // [Q, V]
  const float* cur_old;            // [Q, V]
  const unsigned char* stale_old;  // bool [Q, V]
  const int* d_iters;              // [Q, V, S]
  const float* d_vals;             // [Q, V, S]
  const int* d_count;              // [Q, V]
  const int* o_iters;              // [Q, V, S_old] frozen pre-update store
  const float* o_vals;             // [Q, V, S_old]
  // dropping (null in mode none)
  const float* degree;                // [V] total degree
  const float* p;                     // [Q]
  const float* tau_min;               // [Q]
  const float* tau_max;               // [Q]
  const unsigned char* degree_sel;    // bool [Q]
  const long long* seed;              // [Q] uint32 values
  const int* det_iters;               // [Q, V, S_d] (det)
  const int* det_count;               // [Q, V] (det)
  const unsigned char* bloom;         // bool [Q, M] (prob)
  // outputs
  int* out_iters;             // [Q, V, S]
  float* out_vals;            // [Q, V, S]
  int* out_count;             // [Q, V]
  float* out_cur;             // [Q, V]
  float* out_old;             // [Q, V]
  unsigned char* out_stale;   // bool [Q, V]
  unsigned char* out_changed;
  unsigned char* out_repair;
  unsigned char* out_to_store;
  unsigned char* out_to_drop;
  unsigned char* out_vanish;
  unsigned char* out_evicted;
  int* out_evicted_iter;      // [Q, V]
  int* out_det_iters;         // [Q, V, S_d] (det)
  int* out_det_count;         // [Q, V] (det)
  int* out_det_overflow;      // [Q] (det; zeroed by the caller)
  int* out_det_max_iter;      // [Q] (det; -1 filled by the caller)
  // sizes
  long long bloom_bits;  // M
  int q, v, d, s, s_old, s_det, num_hashes, i, semiring, mode;
  float hop_cap;
};

namespace {

// ------------------------------------------------------------ sorted rows
// A row is `it[k]`/`va[k]` for k < s (IMAX-padded iterations), held in
// registers: every loop runs over the static extent N with a `k < s` guard,
// so each index is a compile-time constant.

template <int N>
__device__ __forceinline__ int first_eq(const int (&it)[N], int s, int i) {
  int f = -1;
#pragma unroll
  for (int k = N - 1; k >= 0; --k)
    if (k < s && it[k] == i) f = k;
  return f;
}

template <int N>
__device__ __forceinline__ float pick(const float (&va)[N], int e) {
  float x = va[0];
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (k == e) x = va[k];
  return x;
}

// Columns p .. s-1 take their right neighbour; the last becomes padding.
template <int N, bool VALS>
__device__ __forceinline__ void shift_left_from(int (&it)[N], float (&va)[N],
                                                int s, int p) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k < s && k >= p) {
      const bool last = k == s - 1;
      constexpr int dummy = 0;
      const int nx = k < N - 1 ? k + 1 : dummy;
      it[k] = last ? IMAX : it[nx];
      if (VALS) va[k] = last ? 0.0f : va[nx];
    }
  }
}

// diffstore.upsert on one row; returns the eviction flag.
template <int N, bool VALS>
__device__ __forceinline__ bool upsert(int (&it)[N], float (&va)[N], int& cnt,
                                       int s, int i, bool write, float nv) {
  const int e = first_eq<N>(it, s, i);
  if (VALS && write && e >= 0) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k == e) va[k] = nv;
  }
  const bool ins = write && e < 0;
  const bool evict = ins && cnt >= s;
  if (evict) {
    shift_left_from<N, VALS>(it, va, s, 0);
    cnt -= 1;
  }
  if (ins) {
    int pos = 0;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < s && it[k] < i) ++pos;
#pragma unroll
    for (int k = N - 1; k >= 0; --k) {
      if (k < s) {
        const int pv = k > 0 ? k - 1 : 0;
        if (k > pos) {
          it[k] = it[pv];
          if (VALS) va[k] = va[pv];
        } else if (k == pos) {
          it[k] = i;
          if (VALS) va[k] = nv;
        }
      }
    }
    cnt += 1;
  }
  return evict;
}

// diffstore.remove_at on one row.
template <int N, bool VALS>
__device__ __forceinline__ void remove_at(int (&it)[N], float (&va)[N], int& cnt,
                                          int s, int i, bool mask) {
  const int p = first_eq<N>(it, s, i);
  if (mask && p >= 0) {
    shift_left_from<N, VALS>(it, va, s, p);
    cnt -= 1;
  }
}

template <int N>
__device__ __forceinline__ void load_row(int (&it)[N], const int* __restrict__ src,
                                         int s) {
#pragma unroll
  for (int k = 0; k < N; ++k) it[k] = k < s ? src[k] : IMAX;
}

template <int N>
__device__ __forceinline__ void load_row(float (&va)[N],
                                         const float* __restrict__ src, int s) {
#pragma unroll
  for (int k = 0; k < N; ++k) va[k] = k < s ? src[k] : 0.0f;
}

template <int N, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ dst, const T (&x)[N],
                                          int s) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < s) dst[k] = x[k];
}

// dropping.select_to_drop for one (q, v): the stateless coin
// _uniform01(seed, q, v, i) and the Degree policy's thresholds.
__device__ __forceinline__ bool select_to_drop(const FusedArgs& a, int q,
                                               uint32_t v, float deg) {
  using bloom_hash::fmix32;
  const uint32_t seed = (uint32_t)a.seed[q];
  const uint32_t h = fmix32(v ^ fmix32((uint32_t)a.i * 0x9E3779B9u) ^
                            fmix32((uint32_t)q + seed));
  const float u = __uint2float_rn(h) / 4294967296.0f;
  const bool coin = u < a.p[q];
  if (!a.degree_sel[q]) return coin;
  if (deg < a.tau_min[q]) return true;
  if (deg > a.tau_max[q]) return false;
  return coin;
}

// Stages 2-6 on row (q, v), given the expanded candidate `nw`.
template <int MODE, int MAXS>
__device__ __forceinline__ void sweep_row(const FusedArgs& a, int q, long long v,
                                          float nw, float deg) {
  const long long r = (long long)q * a.v + v;
  const int i = a.i;
  const bool sch = a.sched[r];
  const bool act = a.active[q];
  const float cu = a.cur[r];

  // ---- stage 2: DroppedVT probe -> repair
  int dit[MAX_SD];
  float dva[MAX_SD];  // unused: Det rows carry no values
  int dcnt = 0;
  bool dropped_here = false;
  if (MODE == DET) {
    load_row<MAX_SD>(dit, a.det_iters + r * a.s_det, a.s_det);
    dcnt = a.det_count[r];
    dropped_here = first_eq<MAX_SD>(dit, a.s_det, i) >= 0;
  } else if (MODE == PROB) {
    uint32_t h1, h2;
    bloom_hash::hash_key((uint32_t)v, (uint32_t)i, (uint32_t)q, h1, h2);
    const unsigned char* row = a.bloom + q * a.bloom_bits;
    dropped_here = true;
    for (int j = 0; j < a.num_hashes && dropped_here; ++j)
      dropped_here = row[bloom_hash::probe(h1, h2, (uint32_t)j, (uint32_t)a.bloom_bits)];
  }
  const bool repair = dropped_here && act && !sch;

  // ---- stage 3: change-point detection vs the frozen old trajectory
  bool old_has = false;
  float old_val = 0.0f;
  const int* oit = a.o_iters + r * a.s_old;
  for (int k = 0; k < a.s_old; ++k) {
    if (oit[k] == i) {
      old_has = true;
      old_val = a.o_vals[r * a.s_old + k];
      break;
    }
  }
  const float old_i = old_has ? old_val : a.cur_old[r];
  const bool stale = (a.stale_old[r] || dropped_here) && !old_has;
  const bool changed = sch && ((nw != old_i) || stale);

  // ---- stage 4: drop selection + store upsert / remove
  const bool want = sch && (nw != cu);
  int it[MAXS];
  float va[MAXS];
  load_row<MAXS>(it, a.d_iters + r * a.s, a.s);
  load_row<MAXS>(va, a.d_vals + r * a.s, a.s);
  int cnt = a.d_count[r];
  const int e = first_eq<MAXS>(it, a.s, i);
  const bool has_cur = e >= 0;
  const float cur_stored = pick<MAXS>(va, e);
  const bool to_drop = MODE != NONE && want && select_to_drop(a, q, (uint32_t)v, deg);
  const bool to_store = want && !to_drop;
  const int evicted_iter = it[0];
  const bool evicted = upsert<MAXS, true>(it, va, cnt, a.s, i, to_store, nw);
  const bool vanish = sch && !want && has_cur;
  remove_at<MAXS, true>(it, va, cnt, a.s, i, (to_drop && has_cur) || vanish);

  // ---- stage 5: exact-front advance
  const float cur_next = (sch || repair) ? nw : (has_cur ? cur_stored : cu);

  store_row<MAXS>(a.out_iters + r * a.s, it, a.s);
  store_row<MAXS>(a.out_vals + r * a.s, va, a.s);
  a.out_count[r] = cnt;
  a.out_cur[r] = cur_next;
  a.out_old[r] = old_i;
  a.out_stale[r] = stale;
  a.out_changed[r] = changed;
  a.out_repair[r] = repair;
  a.out_to_store[r] = to_store;
  a.out_to_drop[r] = to_drop;
  a.out_vanish[r] = vanish;
  a.out_evicted[r] = evicted;
  a.out_evicted_iter[r] = evicted_iter;

  // ---- stage 6 (det): register the dropped and the evicted points,
  //      unregister what was stored or vanished
  if (MODE == DET) {
    const bool ev1 = upsert<MAX_SD, false>(dit, dva, dcnt, a.s_det, i, to_drop, 0.0f);
    const bool ev2 =
        upsert<MAX_SD, false>(dit, dva, dcnt, a.s_det, evicted_iter, evicted, 0.0f);
    remove_at<MAX_SD, false>(dit, dva, dcnt, a.s_det, i, to_store || vanish);
    store_row<MAX_SD>(a.out_det_iters + r * a.s_det, dit, a.s_det);
    a.out_det_count[r] = dcnt;
    if (ev1 || ev2) atomicAdd(a.out_det_overflow + q, (int)ev1 + (int)ev2);
    if (to_drop || evicted)
      atomicMax(a.out_det_max_iter + q,
                max(to_drop ? i : -1, evicted ? evicted_iter : -1));
  }
}

// One thread per vertex row: the expand for a block of QB queries in
// registers, then stages 2-6 for each of them.
template <int SR, int MODE, int MAXS>
__global__ void __launch_bounds__(THREADS) fused_sweep_kernel(const FusedArgs a) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= a.v) return;
  const int* nrow = a.nbr + v * a.d;
  const float* wrow = a.w + v * a.d;
  const float deg = MODE == NONE ? 0.0f : a.degree[v];
  for (int q0 = 0; q0 < a.q; q0 += QB) {
    const int nq = min(QB, a.q - q0);
    float acc[QB];
    ell_row::expand_block<SR>(a.states_t, nrow, wrow, q0, nq, a.q, a.d, a.hop_cap, acc);
    for (int j = 0; j < nq; ++j) {
      float x = acc[0];
#pragma unroll
      for (int k = 1; k < QB; ++k)
        if (k == j) x = acc[k];
      const int q = q0 + j;
      const float nw = ell_row::combine<SR>(x, a.kcarry[(long long)q * a.v + v]);
      sweep_row<MODE, MAXS>(a, q, v, nw, deg);
    }
  }
}

// The new= variant: the candidate comes in as new[q, v]; one thread per
// vertex row, stages 2-6 for every query.
template <int MODE, int MAXS>
__global__ void __launch_bounds__(THREADS) fused_sweep_new_kernel(const FusedArgs a) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= a.v) return;
  const float deg = MODE == NONE ? 0.0f : a.degree[v];
  for (int q = 0; q < a.q; ++q)
    sweep_row<MODE, MAXS>(a, q, v, a.new_vals[(long long)q * a.v + v], deg);
}

template <int MODE, int MAXS>
void launch_new(const FusedArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.v + THREADS - 1) / THREADS);
  fused_sweep_new_kernel<MODE, MAXS><<<blocks, THREADS, 0, stream>>>(a);
}

template <int MODE>
void launch_new_s(const FusedArgs& a, cudaStream_t stream) {
  if (a.s <= 16)
    launch_new<MODE, 16>(a, stream);
  else
    launch_new<MODE, 32>(a, stream);
}

template <int SR, int MODE, int MAXS>
void launch(const FusedArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.v + THREADS - 1) / THREADS);
  fused_sweep_kernel<SR, MODE, MAXS><<<blocks, THREADS, 0, stream>>>(a);
}

template <int SR, int MODE>
void launch_s(const FusedArgs& a, cudaStream_t stream) {
  if (a.s <= 16)
    launch<SR, MODE, 16>(a, stream);
  else
    launch<SR, MODE, 32>(a, stream);
}

template <int SR>
void launch_mode(const FusedArgs& a, cudaStream_t stream) {
  switch (a.mode) {
    case DET: launch_s<SR, DET>(a, stream); break;
    case PROB: launch_s<SR, PROB>(a, stream); break;
    default: launch_s<SR, NONE>(a, stream); break;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes, dtypes, devices, contiguity and the limits S <= 32,
// S_d <= 32 before calling; it passes new_vals or the expand's operands.
extern "C" int fused_sweep_launch(const FusedArgs* args, void* stream) {
  const FusedArgs& a = *args;
  if (a.q > 0 && a.v > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (a.new_vals != nullptr) {
      switch (a.mode) {
        case DET: launch_new_s<DET>(a, st); break;
        case PROB: launch_new_s<PROB>(a, st); break;
        default: launch_new_s<NONE>(a, st); break;
      }
      return (int)cudaGetLastError();
    }
    switch (a.semiring) {
      case ell_row::MIN_PLUS: launch_mode<ell_row::MIN_PLUS>(a, st); break;
      case ell_row::MIN_HOP: launch_mode<ell_row::MIN_HOP>(a, st); break;
      case ell_row::MIN_LABEL: launch_mode<ell_row::MIN_LABEL>(a, st); break;
      default: launch_mode<ell_row::PR_SUM>(a, st); break;
    }
  }
  return (int)cudaGetLastError();
}

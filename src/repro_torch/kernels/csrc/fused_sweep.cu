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
//      (v + off, i) salted by q (csrc/bloom_hash.cuh);  repair = dropped & active & !sched
//   3. change-point detection against the frozen pre-update store:
//      old, stale, changed
//   4. drop selection (the per-query DropParams row, stateless hash coin of
//      (seed, q, v + off, i)), difference-store upsert (oldest eviction) and
//      remove_at
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
// In place or out of place.  Out of place (`inplace` 0) every row of the
// store (and of the Det store) is written to fresh outputs: the engine's
// first sweep iteration, whose working store is the frozen pre-update store
// itself.  In place (`inplace` 1; the outputs are the working stores) only
// the rows whose content changes are written: D rows where a point is
// stored or removed, Det rows where a point is registered, evicted or
// unregistered.  The reference returns new arrays; the port updates the
// sweep's own buffers from the second iteration on.
//
// Bound on the card.  The function reads what its outputs depend on: the
// [Q, V] inputs, every store row's iterations (the probes at i), a value
// where a column matches i, the values and counts of the rows it rewrites,
// the old store's iterations (and one value where one matches), and the
// expand's operands only for the (q, v) that need the candidate: scheduled
// or repairing ones.  It writes the [Q, V] outputs and the changed rows.
// chip_smoke.py's fused_bounds_ms counts this on each run's data; on the
// main path's captured call (Q=8, V=3,774,768, D=24, S=16, i = 2, 256
// scheduled cells) it is 4.7 GB in none mode, 1.42 ms at 3.35 TB/s; det
// mode adds the Det rows' iterations (S_d=32): 2.57 ms.  The work is a few
// integer and float operations per byte: bytes bound it.  The earlier
// out-of-place design moved every store row in and out each call (its
// "out-of-place floor": 3.51 ms none, 5.89 ms det), which the in-place form
// no longer pays.  How close it gets (chip_smoke.py on an H100 80GB HBM3 at
// 700 W; PERF.md has each run): in place 1.70-1.75 ms none (81-83% of the
// bound), 2.95-3.09 ms det (83-87%), 3.12-3.21 ms prob (46-47%: a Bloom
// probe reads a 32-byte sector where the bound counts the byte it needs).
//
// Design.  Two threads share a vertex row (Q > 4): each takes four
// queries.  For its queries a thread first probes the DroppedVT and reads
// sched; the expand runs only if one of them is scheduled or repairs (the
// candidate is read nowhere else), from the row read straight from device
// memory as 16-byte vectors (staging every tile through shared memory, as
// K1 does, would move the whole adjacency for the few rows that need it).
// Store rows move as 16-byte vectors where the capacity is a multiple of 4
// and the base is aligned (else words) into registers (static indexing
// over MAXS = 16 or 32 columns, so no local memory); an unchanged row in
// place is only scanned, its values never read.  A top-level switch picks a
// body specialised for semiring x drop mode x MAXS; the new= variant has one
// body per drop mode x MAXS (nothing after the expand depends on the
// semiring).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "bloom_hash.cuh"
#include "ell_row.cuh"

namespace {

using ell_row::QG;

constexpr int THREADS = 128;
constexpr int MAX_SD = 32;  // Det store capacity the kernel takes
constexpr int IMAX = 0x7fffffff;

enum Mode { NONE = 0, DET = 1, PROB = 2 };

}  // namespace

// Arguments, mirrored field for field by kernels/fused_sweep.py (_FusedArgs).
struct FusedArgs {
  // expand
  const float* states_t;  // [Vp, Q] (transposed; row Vp - 1 holds the identity)
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
  // outputs (in place: out_iters/out_vals/out_count are d_*, out_det_* det_*)
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
  int q, v, d, s, s_old, s_det, num_hashes, i, semiring, mode, vp, inplace;
  // global id of row 0: a vertex-sharded sweep passes its shard's block, and
  // the coin and the Bloom key hash v + off (rows, stores and degree[v] stay
  // local)
  int off;
  float hop_cap;
};

namespace {

// How this launch reads its rows (filled on the host).
struct Plan {
  ell_row::Adj adj;
  ell_row::States st;
  int vec_d;    // D store rows (in and out) as 16-byte vectors
  int vec_o;    // old store rows
  int vec_det;  // Det rows (in and out)
};

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

// ------------------------------------------------------------ row moves
template <typename T>
__device__ __forceinline__ T from_bits(int x);
template <>
__device__ __forceinline__ int from_bits<int>(int x) { return x; }
template <>
__device__ __forceinline__ float from_bits<float>(int x) { return __int_as_float(x); }
__device__ __forceinline__ int to_bits(int x) { return x; }
__device__ __forceinline__ int to_bits(float x) { return __float_as_int(x); }

// 16-byte vectors when `vec` (s % 4 == 0, base aligned), else words; the
// static columns past s take `fill`.  Plain loads: in place, the same
// thread rewrites the row afterwards.
template <int N, typename T>
__device__ __forceinline__ void load_row(T (&x)[N], const T* src, int s, bool vec,
                                         T fill) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      if (4 * c < s) {
        const int4 y = *reinterpret_cast<const int4*>(src + 4 * c);
        x[4 * c] = from_bits<T>(y.x), x[4 * c + 1] = from_bits<T>(y.y);
        x[4 * c + 2] = from_bits<T>(y.z), x[4 * c + 3] = from_bits<T>(y.w);
      } else {
        x[4 * c] = x[4 * c + 1] = x[4 * c + 2] = x[4 * c + 3] = fill;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = k < s ? src[k] : fill;
  }
}

template <int N, typename T>
__device__ __forceinline__ void store_row(T* dst, const T (&x)[N], int s, bool vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      if (4 * c < s)
        *reinterpret_cast<int4*>(dst + 4 * c) =
            make_int4(to_bits(x[4 * c]), to_bits(x[4 * c + 1]),
                      to_bits(x[4 * c + 2]), to_bits(x[4 * c + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < s) dst[k] = x[k];
  }
}

// Index of the first column equal to i in a row of any capacity (-1: none),
// 16 columns' loads in flight before their compares.
template <bool NC>
__device__ __forceinline__ int find_first(const int* src, int s, int i, bool vec) {
  if (vec) {
    for (int c0 = 0; c0 < s; c0 += 16) {
      int4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int* p = src + c0 + 4 * u;
        x[u] = c0 + 4 * u < s ? (NC ? __ldg(reinterpret_cast<const int4*>(p))
                                    : *reinterpret_cast<const int4*>(p))
                              : make_int4(~i, ~i, ~i, ~i);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = c0 + 4 * u;
        if (x[u].x == i) return k;
        if (x[u].y == i) return k + 1;
        if (x[u].z == i) return k + 2;
        if (x[u].w == i) return k + 3;
      }
    }
    return -1;
  }
  for (int k = 0; k < s; ++k)
    if ((NC ? __ldg(src + k) : src[k]) == i) return k;
  return -1;
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

// Stage 2: is (v, i) in query q's DroppedVT?
template <int MODE>
__device__ __forceinline__ bool dropped_at(const FusedArgs& a, const Plan& p, int q,
                                           long long v, long long r) {
  if (MODE == DET) return find_first<false>(a.det_iters + r * a.s_det, a.s_det, a.i, p.vec_det) >= 0;
  if (MODE == PROB) {
    uint32_t h1, h2;
    bloom_hash::hash_key((uint32_t)(v + a.off), (uint32_t)a.i, (uint32_t)q, h1, h2);
    const unsigned char* row = a.bloom + q * a.bloom_bits;
    bool hit = true;
    for (int j = 0; j < a.num_hashes && hit; ++j)
      hit = __ldg(row + bloom_hash::probe(h1, h2, (uint32_t)j, (uint32_t)a.bloom_bits));
    return hit;
  }
  return false;
}

// Stages 3-6 on row (q, v), given the candidate `nw` (read only where
// sched or repair) and stage 2's results.
template <int MODE, int MAXS>
__device__ __forceinline__ void sweep_row(const FusedArgs& a, const Plan& p, int q,
                                          long long v, float nw, bool sch,
                                          bool dropped_here, float deg) {
  const long long r = (long long)q * a.v + v;
  const int i = a.i;
  const bool act = a.active[q];
  const float cu = a.cur[r];
  const bool repair = dropped_here && act && !sch;

  // ---- stage 3: change-point detection vs the frozen old trajectory
  const int ok = find_first<true>(a.o_iters + r * a.s_old, a.s_old, i, p.vec_o);
  const bool old_has = ok >= 0;
  const float old_i = old_has ? __ldg(a.o_vals + r * a.s_old + ok) : a.cur_old[r];
  const bool stale = (a.stale_old[r] || dropped_here) && !old_has;
  const bool changed = sch && ((nw != old_i) || stale);

  // ---- stage 4: drop selection + store upsert / remove.  A row the call
  //      may change (scheduled), or must copy (out of place), comes in
  //      whole; an unchanged one in place is only scanned.
  const bool want = sch && (nw != cu);
  const bool whole = sch || !a.inplace;
  bool has_cur, to_drop = false, to_store = false, vanish = false, evicted = false;
  float cur_stored;
  int evicted_iter;
  {
    int it[MAXS];
    load_row<MAXS, int>(it, a.d_iters + r * a.s, a.s, p.vec_d, IMAX);
    const int e = first_eq<MAXS>(it, a.s, i);
    has_cur = e >= 0;
    evicted_iter = it[0];
    if (whole) {
      float va[MAXS];
      load_row<MAXS, float>(va, a.d_vals + r * a.s, a.s, p.vec_d, 0.0f);
      int cnt = a.d_count[r];
      cur_stored = pick<MAXS>(va, e);
      to_drop = MODE != NONE && want && select_to_drop(a, q, (uint32_t)(v + a.off), deg);
      to_store = want && !to_drop;
      evicted = upsert<MAXS, true>(it, va, cnt, a.s, i, to_store, nw);
      vanish = sch && !want && has_cur;
      const bool rm = (to_drop && has_cur) || vanish;
      remove_at<MAXS, true>(it, va, cnt, a.s, i, rm);
      if (!a.inplace || to_store || rm) {
        store_row<MAXS, int>(a.out_iters + r * a.s, it, a.s, p.vec_d);
        store_row<MAXS, float>(a.out_vals + r * a.s, va, a.s, p.vec_d);
        a.out_count[r] = cnt;
      }
    } else {
      cur_stored = has_cur ? a.d_vals[r * a.s + e] : 0.0f;
    }
  }

  // ---- stage 5: exact-front advance
  const float cur_next = (sch || repair) ? nw : (has_cur ? cur_stored : cu);

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
  //      unregister what was stored or vanished; in place only rows that
  //      one of these touches are read whole and written
  if (MODE == DET && (!a.inplace || to_drop || evicted || to_store || vanish)) {
    int dit[MAX_SD];
    float dva[MAX_SD];  // unused: Det rows carry no values
    load_row<MAX_SD, int>(dit, a.det_iters + r * a.s_det, a.s_det, p.vec_det, IMAX);
    int dcnt = a.det_count[r];
    const bool ev1 = upsert<MAX_SD, false>(dit, dva, dcnt, a.s_det, i, to_drop, 0.0f);
    const bool ev2 =
        upsert<MAX_SD, false>(dit, dva, dcnt, a.s_det, evicted_iter, evicted, 0.0f);
    remove_at<MAX_SD, false>(dit, dva, dcnt, a.s_det, i, to_store || vanish);
    store_row<MAX_SD, int>(a.out_det_iters + r * a.s_det, dit, a.s_det, p.vec_det);
    a.out_det_count[r] = dcnt;
    if (ev1 || ev2) atomicAdd(a.out_det_overflow + q, (int)ev1 + (int)ev2);
    if (to_drop || evicted)
      atomicMax(a.out_det_max_iter + q,
                max(to_drop ? i : -1, evicted ? evicted_iter : -1));
  }
}

// A thread: vertex row v, queries QG*h .. of it (and every lanes-th group
// after).  Stage 2 for the group first, then the candidate where a query
// needs it (EXPAND: the ELL row body; else new[q, v]), then stages 3-6.
// The 32-column bodies ask for one block an SM at least: left to itself,
// ptxas holds them at 168 registers and spills; the 16-column bodies keep
// its own choice (0: no bound), which measured faster than any set bound.
template <int SR, int MODE, int MAXS, bool EXPAND>
__global__ void __launch_bounds__(THREADS, MAXS == 32 ? 1 : 0)
    fused_sweep_kernel(const FusedArgs a, const Plan p) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lanes = p.adj.lanes;
  const long long v = g / lanes;
  if (v >= a.v) return;
  const int h = (int)(g - v * lanes);
  const float deg = MODE == NONE ? 0.0f : a.degree[v];
  for (int q0 = QG * h; q0 < a.q; q0 += QG * lanes) {
    const int nq = min(QG, a.q - q0);
    unsigned sch = 0, dropped = 0, need = 0;
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      if (j < nq) {
        const int q = q0 + j;
        const long long r = (long long)q * a.v + v;
        const bool s = a.sched[r];
        const bool dh = dropped_at<MODE>(a, p, q, v, r);
        sch |= (unsigned)s << j;
        dropped |= (unsigned)dh << j;
        if (s || (dh && a.active[q])) need |= 1u << j;
      }
    }
    float nw[QG];
#pragma unroll
    for (int j = 0; j < QG; ++j) nw[j] = 0.0f;
    if (need != 0) {
      if constexpr (EXPAND) {
        float acc[QG];
        ell_row::expand_group<SR, false>(p.adj, ell_row::global_row(p.adj, v), p.st, q0, nq,
                                  a.hop_cap, acc);
#pragma unroll
        for (int j = 0; j < QG; ++j)
          if ((need >> j) & 1u)
            nw[j] = ell_row::combine<SR>(acc[j], a.kcarry[(long long)(q0 + j) * a.v + v]);
      } else {
#pragma unroll
        for (int j = 0; j < QG; ++j)
          if ((need >> j) & 1u) nw[j] = a.new_vals[(long long)(q0 + j) * a.v + v];
      }
    }
#pragma unroll 1
    for (int j = 0; j < nq; ++j) {  // one copy of the row body, not QG
      float x = nw[0];
#pragma unroll
      for (int k = 1; k < QG; ++k)
        if (k == j) x = nw[k];
      sweep_row<MODE, MAXS>(a, p, q0 + j, v, x, (sch >> j) & 1u, (dropped >> j) & 1u, deg);
    }
  }
}

template <int SR, int MODE, int MAXS, bool EXPAND>
void launch(const FusedArgs& a, const Plan& p, cudaStream_t stream) {
  const long long threads = (long long)a.v * p.adj.lanes;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  fused_sweep_kernel<SR, MODE, MAXS, EXPAND><<<blocks, THREADS, 0, stream>>>(a, p);
}

template <int SR, int MODE, bool EXPAND>
void launch_s(const FusedArgs& a, const Plan& p, cudaStream_t stream) {
  if (a.s <= 16)
    launch<SR, MODE, 16, EXPAND>(a, p, stream);
  else
    launch<SR, MODE, 32, EXPAND>(a, p, stream);
}

template <int SR, bool EXPAND>
void launch_mode(const FusedArgs& a, const Plan& p, cudaStream_t stream) {
  switch (a.mode) {
    case DET: launch_s<SR, DET, EXPAND>(a, p, stream); break;
    case PROB: launch_s<SR, PROB, EXPAND>(a, p, stream); break;
    default: launch_s<SR, NONE, EXPAND>(a, p, stream); break;
  }
}

bool vec_rows(int s, const void* x, const void* y) {
  return s % 4 == 0 && ell_row::aligned16(x) && (y == nullptr || ell_row::aligned16(y));
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes, dtypes, devices, contiguity, aliasing and the limits S <=
// 32, S_d <= 32 before calling; it passes new_vals or the expand's operands.
extern "C" int fused_sweep_launch(const FusedArgs* args, void* stream) {
  const FusedArgs& a = *args;
  if (a.q > 0 && a.v > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    Plan p{};
    const bool uses_w = a.semiring == ell_row::MIN_PLUS || a.semiring == ell_row::PR_SUM;
    size_t smem = 0;  // rows come straight from device memory
    p.adj = ell_row::make_adj(a.nbr, uses_w ? a.w : nullptr, a.v, a.d,
                              ell_row::lanes_for(a.q), THREADS, false, &smem);
    p.st = ell_row::make_states(a.states_t, a.vp, a.q);
    p.vec_d = vec_rows(a.s, a.d_iters, a.d_vals) && vec_rows(a.s, a.out_iters, a.out_vals);
    p.vec_o = vec_rows(a.s_old, a.o_iters, nullptr);
    p.vec_det = a.mode == DET && vec_rows(a.s_det, a.det_iters, a.out_det_iters);
    if (a.new_vals != nullptr) {
      launch_mode<ell_row::MIN_PLUS, false>(a, p, st);  // no expand: any semiring
      return (int)cudaGetLastError();
    }
    switch (a.semiring) {
      case ell_row::MIN_PLUS: launch_mode<ell_row::MIN_PLUS, true>(a, p, st); break;
      case ell_row::MIN_HOP: launch_mode<ell_row::MIN_HOP, true>(a, p, st); break;
      case ell_row::MIN_LABEL: launch_mode<ell_row::MIN_LABEL, true>(a, p, st); break;
      default: launch_mode<ell_row::PR_SUM, true>(a, p, st); break;
    }
  }
  return (int)cudaGetLastError();
}

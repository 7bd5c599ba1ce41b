// The blocked-ELL row body shared by ell_spmv.cu (K1) and fused_sweep.cu
// (K2): one vertex row, a group of up to QG queries, the accumulators in
// registers.  Both kernels run this same code, so the fused sweep's expand
// equals the ELL kernel's bit for bit on the card, pr_sum included (the
// contract the reference gets from its shared expand_tile).
//
//   acc[j] = (+)_d msg(states[q0 + j, nbr[v, d]], w[v, d])     j < nq, d ascending
//   out    = combine(acc[j], carry[q0 + j, v])
//
// semiring 0 min_plus : msg = s + w,   reduce min, min with carry
//          1 min_hop  : msg = s + 1 (inf past hop_cap), reduce min, min with carry
//          2 min_label: msg = s,       reduce min, min with carry
//          3 pr_sum   : msg = s * w,   reduce sum, plus carry (teleport base)
//
// The states are handed transposed, [Vp, Q], so the values of all queries of
// a neighbour lie in one 32-byte sector.  One or two threads share a row
// (`lanes`): for Q > 4 the two threads of a pair take queries 0-3 and 4-7
// of the row, each gathering a neighbour's four values as one 16-byte load,
// so a pair's gathers fill the whole sector in one request.  The min family
// does one add/compare per message, as the plain version does; pr_sum keeps
// the product and the add apart (__fmul_rn/__fadd_rn: no FMA contraction)
// and sums d-ascending per query, so only its summation order can differ
// from the plain PyTorch sum.
//
// Padding cells (nbr == Vp - 1, the sentinel) take the sentinel's values,
// loaded once per row and query group, instead of a gather: the message is
// the one the gather would have given, so the skip is exact whatever the
// sentinel holds.  On the main path 82% of the cells are padding.
//
// Where a row comes from:
//  * VEC: staged in shared memory (K1's tiles, issue_tile / tile_row), rows
//    padded to an odd number of 16-byte chunks, read as 16-byte vectors.
//    A quarter-warp's 16-byte reads then fall in eight different bank
//    groups (D = 24 unpadded would be 8-way conflicted as scalar reads).
//  * SCALAR: staged in shared memory unpadded (D % 4 != 0 or a base that is
//    not 16-byte aligned), read as words; odd D, and D = 4k + 2 with a lane
//    pair a row (16 rows a warp), are free of bank conflicts.
//  * GLOBAL: read straight from device memory, as 16-byte vectors where D %
//    4 == 0 and the bases are aligned (K2, which expands only the rows that
//    need it; K1 when a tile would not fit in shared memory), else as words.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace ell_row {

constexpr int QG = 4;           // queries per thread group (one float4)
constexpr int MAX_STAGE_BYTES = 96 * 1024;  // a K1 block's tiles: two blocks an SM at least

enum Semiring { MIN_PLUS = 0, MIN_HOP = 1, MIN_LABEL = 2, PR_SUM = 3 };
enum Layout { VEC = 0, SCALAR = 1, GLOBAL = 2 };

// The adjacency and how its rows are read (filled on the host by make_adj).
struct Adj {
  const int* nbr;    // [V, D]
  const float* w;    // [V, D]; null when the semiring reads no weight
  long long v_rows;  // V
  long long tiles;   // row tiles of blockDim / lanes rows (K1)
  int d;             // D
  int lanes;         // threads per row: 1 (Q <= 4) or 2
  int layout;        // Layout
  int vec_global;    // GLOBAL rows as 16-byte vectors (D % 4 == 0, aligned)
  int row_words;     // VEC: shared-memory words per row (odd chunks x 4)
  int stage_words;   // words per array per stage
};

// The gathered states, transposed.
struct States {
  const float* t;  // [Vp, Q]
  long long pad;   // Vp - 1: the sentinel row padding cells point at
  int q;           // Q
  int vec;         // Q % 4 == 0 and t 16-byte aligned: float4 gathers
};

// One row as the body reads it.
struct RowRef {
  const int* n;
  const float* w;
};

template <int SR>
__device__ __forceinline__ float msg_reduce(float acc, float s, float wv,
                                            float hop_cap) {
  if (SR == MIN_PLUS) return fminf(acc, __fadd_rn(s, wv));
  if (SR == MIN_HOP) {
    float m = __fadd_rn(s, 1.0f);
    if (m > hop_cap) m = CUDART_INF_F;
    return fminf(acc, m);
  }
  if (SR == MIN_LABEL) return fminf(acc, s);
  return __fadd_rn(acc, __fmul_rn(s, wv));  // PR_SUM
}

// The reduce of the expanded messages with the carry (previous state for
// the min family, the teleport base for pr_sum).
template <int SR>
__device__ __forceinline__ float combine(float acc, float carry) {
  return SR == PR_SUM ? __fadd_rn(acc, carry) : fminf(acc, carry);
}

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ int4 lds_int4(const void* p) {
  int4 x;
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "r"(a));
  return x;
}

__device__ __forceinline__ float4 lds_float4(const void* p) {
  float4 x;
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(a));
  return x;
}

// An L2 policy that evicts first: for bytes read once (the adjacency
// tiles), so that L2 keeps the gathered states instead.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, uint64_t pol) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(a),
               "l"(gmem), "l"(pol));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, uint64_t pol) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;" ::"r"(a),
               "l"(gmem), "l"(pol));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// ------------------------------------------------------------ gathers
// The values of queries q0 .. q0 + nq - 1 at state row n.
template <bool V4>
__device__ __forceinline__ void fetch(const States& st, long long n, int q0,
                                      int nq, float (&s)[QG]) {
  const float* p = st.t + n * st.q + q0;
  if (V4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    s[0] = x.x, s[1] = x.y, s[2] = x.z, s[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < QG; ++j) s[j] = j < nq ? __ldg(p + j) : 0.0f;
  }
}

// A cell's source values: the sentinel's from registers, else a gather.
template <bool V4>
__device__ __forceinline__ void cell(const States& st, int n, int q0, int nq,
                                     const float (&sent)[QG], float (&s)[QG]) {
  if (n == st.pad) {
#pragma unroll
    for (int j = 0; j < QG; ++j) s[j] = sent[j];
  } else {
    fetch<V4>(st, n, q0, nq, s);
  }
}

template <int SR>
__device__ __forceinline__ void reduce(float (&acc)[QG], const float (&s)[QG],
                                       float wv, int nq, float hop_cap) {
#pragma unroll
  for (int j = 0; j < QG; ++j)
    if (j < nq) acc[j] = msg_reduce<SR>(acc[j], s[j], wv, hop_cap);
}

// Four cells (one 16-byte chunk k of the row): their gathers are issued
// before their reduces.
template <int SR, bool SMEM>
__device__ __forceinline__ void expand_chunk(const RowRef& row, const States& st, int k,
                                             int q0, int nq, const float (&sent)[QG],
                                             float hop_cap, float (&acc)[QG]) {
  constexpr bool kW = SR == MIN_PLUS || SR == PR_SUM;
  const int4* n4 = reinterpret_cast<const int4*>(row.n);
  const float4* w4 = reinterpret_cast<const float4*>(row.w);
  int4 nn;
  float4 ww = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (SMEM) {
    nn = lds_int4(n4 + k);
    if (kW) ww = lds_float4(w4 + k);
  } else {
    nn = __ldg(n4 + k);
    if (kW) ww = __ldg(w4 + k);
  }
  float s0[QG], s1[QG], s2[QG], s3[QG];
  cell<true>(st, nn.x, q0, nq, sent, s0);
  cell<true>(st, nn.y, q0, nq, sent, s1);
  cell<true>(st, nn.z, q0, nq, sent, s2);
  cell<true>(st, nn.w, q0, nq, sent, s3);
  reduce<SR>(acc, s0, ww.x, nq, hop_cap);
  reduce<SR>(acc, s1, ww.y, nq, hop_cap);
  reduce<SR>(acc, s2, ww.z, nq, hop_cap);
  reduce<SR>(acc, s3, ww.w, nq, hop_cap);
}

// The row body.  V4ROW: the row is read as 16-byte chunks (from shared
// memory if SMEM, else from device memory) and the states as float4, the
// chunk loop unrolled UNROLL3 ? 3 : 2 times so that 12 or 8 gathers are in
// flight (K1 takes 3, K2 2: each the faster on the card, and free of
// spills).  Otherwise words and scalar gathers.  The accumulation order is
// d-ascending either way.
template <int SR, bool V4ROW, bool SMEM, bool UNROLL3>
__device__ __forceinline__ void expand_impl(const RowRef& row, const States& st,
                                            int d_cols, int q0, int nq,
                                            float hop_cap, float (&acc)[QG]) {
  constexpr bool kW = SR == MIN_PLUS || SR == PR_SUM;
  float sent[QG];
  fetch<V4ROW>(st, st.pad, q0, nq, sent);
#pragma unroll
  for (int j = 0; j < QG; ++j) acc[j] = SR == PR_SUM ? 0.0f : CUDART_INF_F;
  if (V4ROW) {
    const int m = d_cols >> 2;
    if (UNROLL3) {
#pragma unroll 3
      for (int k = 0; k < m; ++k) expand_chunk<SR, SMEM>(row, st, k, q0, nq, sent, hop_cap, acc);
    } else {
#pragma unroll 2
      for (int k = 0; k < m; ++k) expand_chunk<SR, SMEM>(row, st, k, q0, nq, sent, hop_cap, acc);
    }
  } else {
#pragma unroll 4
    for (int d = 0; d < d_cols; ++d) {
      const int n = row.n[d];
      const float wv = kW ? row.w[d] : 0.0f;
      float s[QG];
      cell<false>(st, n, q0, nq, sent, s);
      reduce<SR>(acc, s, wv, nq, hop_cap);
    }
  }
}

// acc[j] for queries q0 .. q0 + nq - 1 of one row, read as `adj.layout`
// says (uniform over the launch, so the branch never diverges).  STAGED:
// the launch may stage rows in shared memory (K1, chunk loop unrolled 3
// times); else they come from device memory only (K2, unrolled twice), and
// no shared-memory reader is compiled.
template <int SR, bool STAGED>
__device__ __forceinline__ void expand_group(const Adj& adj, const RowRef& row,
                                             const States& st, int q0, int nq,
                                             float hop_cap, float (&acc)[QG]) {
  if (STAGED && adj.layout == VEC && st.vec)
    expand_impl<SR, true, true, STAGED>(row, st, adj.d, q0, nq, hop_cap, acc);
  else if (adj.layout == GLOBAL && adj.vec_global && st.vec)
    expand_impl<SR, true, false, STAGED>(row, st, adj.d, q0, nq, hop_cap, acc);
  else
    expand_impl<SR, false, false, STAGED>(row, st, adj.d, q0, nq, hop_cap, acc);
}

// The row as read straight from device memory.
__device__ __forceinline__ RowRef global_row(const Adj& a, long long v) {
  return RowRef{a.nbr + v * a.d, a.w != nullptr ? a.w + v * a.d : nullptr};
}

// ------------------------------------------------------------ row tiles
// Shared memory holds two stages of [nbr | w] tiles: stage s's nbr at word
// s * stage_words, its w at (2 + s) * stage_words.

// Copy words src[0 .. n) to dst[shift .. shift + n), shift = the word offset
// of src within its 16-byte chunk, so chunk-aligned spans go as 16-byte
// copies and only a ragged head and tail as 4-byte ones.
__device__ __forceinline__ void issue_words(int* dst, const int* src, int n, uint64_t pol) {
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int chunks = (shift + n + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int k0 = 4 * c - shift;
    if (k0 >= 0 && k0 + 4 <= n) {
      cp_async16(dst + 4 * c, src + k0, pol);
    } else {
      for (int e = 0; e < 4; ++e)
        if (k0 + e >= 0 && k0 + e < n) cp_async4(dst + 4 * c + e, src + k0 + e, pol);
    }
  }
}

// Start the copies of rows v0 .. v0 + rows - 1 (clipped at V) into stage s.
__device__ __forceinline__ void issue_tile(const Adj& a, int* smem, int s,
                                           long long v0, int rows) {
  const uint64_t pol = evict_first();
  const int nrows = (int)min((long long)rows, a.v_rows - v0);
  int* dn = smem + s * a.stage_words;
  int* dw = smem + (2 + s) * a.stage_words;
  if (a.layout == VEC) {
    const int m = a.d >> 2;             // 16-byte chunks per row
    const int stride = a.row_words >> 2;  // chunks per shared-memory row
    const int4* gn = reinterpret_cast<const int4*>(a.nbr + v0 * a.d);
    const int4* gw =
        a.w != nullptr ? reinterpret_cast<const int4*>(a.w + v0 * a.d) : nullptr;
    const int total = nrows * m;
    for (int c = threadIdx.x; c < total; c += blockDim.x) {
      const int r = c / m, k = c - r * m;
      cp_async16(reinterpret_cast<int4*>(dn) + r * stride + k, gn + c, pol);
      if (a.w != nullptr) cp_async16(reinterpret_cast<int4*>(dw) + r * stride + k, gw + c, pol);
    }
  } else {
    issue_words(dn, a.nbr + v0 * a.d, nrows * a.d, pol);
    if (a.w != nullptr)
      issue_words(dw, reinterpret_cast<const int*>(a.w + v0 * a.d), nrows * a.d, pol);
  }
}

// Row r of the tile that starts at v0, in stage s.
__device__ __forceinline__ RowRef tile_row(const Adj& a, const int* smem, int s,
                                           long long v0, int r) {
  const int* dn = smem + s * a.stage_words;
  const int* dw = smem + (2 + s) * a.stage_words;
  if (a.layout == VEC) {
    return RowRef{dn + r * a.row_words,
                  reinterpret_cast<const float*>(dw + r * a.row_words)};
  }
  const int sn = (int)((reinterpret_cast<uintptr_t>(a.nbr + v0 * a.d) >> 2) & 3);
  const int sw = a.w != nullptr
                     ? (int)((reinterpret_cast<uintptr_t>(a.w + v0 * a.d) >> 2) & 3)
                     : 0;
  return RowRef{dn + sn + r * a.d, reinterpret_cast<const float*>(dw + sw + r * a.d)};
}

// ------------------------------------------------------------ host side
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// How a launch reads its rows; *smem_bytes gets the dynamic shared memory
// the tiles take (0 unless `staged` and they fit in MAX_STAGE_BYTES).
inline Adj make_adj(const int* nbr, const float* w, long long v_rows, int d,
                    int lanes, int threads, bool staged, size_t* smem_bytes) {
  Adj a{};
  a.nbr = nbr;
  a.w = w;
  a.v_rows = v_rows;
  a.d = d;
  a.lanes = lanes;
  const int rows = threads / lanes;
  a.tiles = (v_rows + rows - 1) / rows;
  const bool vec = d % 4 == 0 && aligned16(nbr) && (w == nullptr || aligned16(w));
  a.vec_global = vec;
  a.layout = vec ? VEC : SCALAR;
  a.row_words = vec ? 4 * ((d / 4) | 1) : d;
  a.stage_words = vec ? rows * a.row_words : ((rows * d + 7) & ~3);
  size_t bytes = (size_t)2 * (w != nullptr ? 2 : 1) * (size_t)a.stage_words * 4;
  if (!staged || bytes > (size_t)MAX_STAGE_BYTES) {
    a.layout = GLOBAL;
    bytes = 0;
  }
  *smem_bytes = bytes;
  return a;
}

inline States make_states(const float* states_t, long long vp, int q) {
  return States{states_t, vp - 1, q, q % 4 == 0 && aligned16(states_t)};
}

// Threads per row: a pair splits Q > 4 queries as 0-3 / 4-7 (and on).
inline int lanes_for(int q) { return q > QG ? 2 : 1; }

// Blocks for a persistent launch: as many as the SMs hold at once, at most
// one per tile.  Returns 0 if the kernel fits no SM.
template <class K>
inline int persistent_grid(K kernel, int threads, size_t smem, long long tiles) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const long long g = (long long)per_sm * sms;
  return (int)(g < tiles ? g : tiles);
}

}  // namespace ell_row

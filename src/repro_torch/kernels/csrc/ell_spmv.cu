// Blocked-ELL semiring SpMV — the IFE inner loop (Join + Min, JOD fused).
//
// Replaces the Pallas TPU kernel repro/kernels/ell_spmv.py::ell_spmv (body
// _kernel -> expand_tile).  For every query q and vertex row v:
//
//   out[q, v] = carry[q, v] (+) (+)_d msg(states[q, nbr[v, d]], w[v, d])
//
// semiring 0 min_plus : msg = s + w,   reduce min, min with carry
//          1 min_hop  : msg = s + 1 (inf past hop_cap), reduce min, min with carry
//          2 min_label: msg = s,       reduce min, min with carry
//          3 pr_sum   : msg = s * w,   reduce sum, plus carry (teleport base)
// Padding cells point at the sentinel column V, whose state is the reduce
// identity, so they contribute nothing.
//
// Bound on the card.  The function must read the adjacency once (V*D*8 bytes
// for nbr + w; min_hop/min_label need no w), the state rows once
// (Q*(V+1)*4), the carry once and write the output once (Q*V*8).  It does
// 2*Q*V*D float operations, far below the card's float32 rate, so it is
// bound by bytes: at Q=8, V=3,774,768, D=24 that is ~1.1 GB, ~0.32 ms at
// 3.35 TB/s.
//
// Design.  The TPU kernel keeps a whole [V+1] state row in VMEM; a Hopper
// block cannot (227 KB of shared memory against 15 MB), so gathers go to
// L2/HBM.  Two choices keep the bytes near the bound:
//  * one thread per vertex row loops over the queries in blocks of QB with
//    the accumulators in registers, so nbr/w are read once for Q <= QB
//    (a kernel that re-read the adjacency per query would move ~6.2 GB);
//  * the wrapper hands the states transposed, [V+1, Q], so one gather
//    fetches the values of all queries of a neighbour from one 32-byte
//    sector instead of Q sectors from Q separate rows.
// The grid masks the ragged last block itself (no block-multiple contract).
//
// Exactness.  The min family does one add/compare per message, as the plain
// version does, so results are bit-identical.  pr_sum keeps the product and
// the add separate (__fmul_rn/__fadd_rn: no FMA contraction), so only the
// summation order can differ from the plain version.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int QB = 8;        // queries per register block
constexpr int THREADS = 256;  // threads (vertex rows) per block

enum Semiring { MIN_PLUS = 0, MIN_HOP = 1, MIN_LABEL = 2, PR_SUM = 3 };

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

// One vertex row, all queries: the row's nbr/w are read once per block of
// QB queries, whose accumulators stay in registers.
template <int SR>
__device__ __forceinline__ void spmv_row(const float* __restrict__ states_t,
                                         const int* __restrict__ nrow,
                                         const float* __restrict__ wrow,
                                         const float* __restrict__ carry,
                                         float* __restrict__ out, long long v,
                                         int q_total, int v_rows, int d_cols,
                                         float hop_cap) {
  constexpr bool kSum = SR == PR_SUM;
  constexpr bool kNeedsW = SR == MIN_PLUS || SR == PR_SUM;
  for (int q0 = 0; q0 < q_total; q0 += QB) {
    const int nq = min(QB, q_total - q0);
    float acc[QB];
#pragma unroll
    for (int j = 0; j < QB; ++j) acc[j] = kSum ? 0.0f : CUDART_INF_F;
#pragma unroll 4
    for (int d = 0; d < d_cols; ++d) {
      const long long n = __ldg(nrow + d);
      const float wv = kNeedsW ? __ldg(wrow + d) : 0.0f;
      const float* srow = states_t + n * q_total + q0;
#pragma unroll
      for (int j = 0; j < QB; ++j)
        if (j < nq) acc[j] = msg_reduce<SR>(acc[j], __ldg(srow + j), wv, hop_cap);
    }
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      if (j < nq) {
        const long long o = (long long)(q0 + j) * v_rows + v;
        out[o] = kSum ? __fadd_rn(acc[j], carry[o]) : fminf(acc[j], carry[o]);
      }
    }
  }
}

// One thread per vertex row; the runtime `semiring` picks the row body.
__global__ void ell_spmv_kernel(const float* __restrict__ states_t,  // [Vp, Q]
                                const int* __restrict__ nbr,         // [V, D]
                                const float* __restrict__ w,         // [V, D]
                                const float* __restrict__ carry,     // [Q, V]
                                float* __restrict__ out,             // [Q, V]
                                int q_total, int v_rows, int d_cols,
                                int semiring, float hop_cap) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= v_rows) return;
  const int* nrow = nbr + v * d_cols;
  const float* wrow = w + v * d_cols;
  switch (semiring) {
    case MIN_PLUS:
      spmv_row<MIN_PLUS>(states_t, nrow, wrow, carry, out, v, q_total, v_rows, d_cols, hop_cap);
      break;
    case MIN_HOP:
      spmv_row<MIN_HOP>(states_t, nrow, wrow, carry, out, v, q_total, v_rows, d_cols, hop_cap);
      break;
    case MIN_LABEL:
      spmv_row<MIN_LABEL>(states_t, nrow, wrow, carry, out, v, q_total, v_rows, d_cols, hop_cap);
      break;
    default:
      spmv_row<PR_SUM>(states_t, nrow, wrow, carry, out, v, q_total, v_rows, d_cols, hop_cap);
      break;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes, dtypes, devices and contiguity before calling.
extern "C" int ell_spmv_launch(const float* states_t, const int* nbr,
                               const float* w, const float* carry, float* out,
                               int q_total, int v_rows, int d_cols,
                               int semiring, float hop_cap, void* stream) {
  if (q_total > 0 && v_rows > 0) {
    const int blocks = (v_rows + THREADS - 1) / THREADS;
    ell_spmv_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        states_t, nbr, w, carry, out, q_total, v_rows, d_cols, semiring,
        hop_cap);
  }
  return (int)cudaGetLastError();
}

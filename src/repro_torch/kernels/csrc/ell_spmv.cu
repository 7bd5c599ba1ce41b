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
// Exactness and the shared row body: csrc/ell_row.cuh (also K2's expand).

#include <cuda_runtime.h>

#include "ell_row.cuh"

namespace {

using namespace ell_row;

constexpr int THREADS = 256;  // threads (vertex rows) per block

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
  for (int q0 = 0; q0 < q_total; q0 += QB) {
    const int nq = min(QB, q_total - q0);
    float acc[QB];
    expand_block<SR>(states_t, nrow, wrow, q0, nq, q_total, d_cols, hop_cap, acc);
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      if (j < nq) {
        const long long o = (long long)(q0 + j) * v_rows + v;
        out[o] = combine<SR>(acc[j], carry[o]);
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

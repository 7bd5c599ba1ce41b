// The per-row blocked-ELL expand shared by ell_spmv.cu (K1) and
// fused_sweep.cu (K2): one vertex row, a block of up to QB queries, the
// accumulators in registers.  Both kernels run this same code, so the fused
// sweep's expand equals the ELL kernel's bit for bit on the card, pr_sum
// included (the contract the reference gets from its shared expand_tile).
//
//   acc[j] = (+)_d msg(states[q0 + j, nbr[v, d]], w[v, d])     j < nq
//   out    = combine(acc[j], carry[q0 + j, v])
//
// semiring 0 min_plus : msg = s + w,   reduce min, min with carry
//          1 min_hop  : msg = s + 1 (inf past hop_cap), reduce min, min with carry
//          2 min_label: msg = s,       reduce min, min with carry
//          3 pr_sum   : msg = s * w,   reduce sum, plus carry (teleport base)
//
// The states are handed transposed, [Vp, Q], so one gather fetches the
// values of all queries of a neighbour from one 32-byte sector.  The min
// family does one add/compare per message, as the plain version does;
// pr_sum keeps the product and the add apart (__fmul_rn/__fadd_rn: no FMA
// contraction), so only its summation order can differ from the plain
// PyTorch version.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace ell_row {

constexpr int QB = 8;  // queries per register block

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

// acc[j] for queries q0 .. q0 + nq - 1 of one row; the row's nbr/w are read
// once for the whole block.
template <int SR>
__device__ __forceinline__ void expand_block(const float* __restrict__ states_t,
                                             const int* __restrict__ nrow,
                                             const float* __restrict__ wrow,
                                             int q0, int nq, int q_total,
                                             int d_cols, float hop_cap,
                                             float (&acc)[QB]) {
  constexpr bool kSum = SR == PR_SUM;
  constexpr bool kNeedsW = SR == MIN_PLUS || SR == PR_SUM;
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
}

// The reduce of the expanded messages with the carry (previous state for
// the min family, the teleport base for pr_sum).
template <int SR>
__device__ __forceinline__ float combine(float acc, float carry) {
  return SR == PR_SUM ? __fadd_rn(acc, carry) : fminf(acc, carry);
}

}  // namespace ell_row

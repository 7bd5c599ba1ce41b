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
// Padding cells point at the sentinel row Vp - 1, whose state is the reduce
// identity, so they contribute nothing.
//
// Bound on the card.  The function must read the adjacency once (V*D*8
// bytes for nbr + w; min_hop/min_label need no w), the state rows once
// (Q*(V+1)*4), the carry once and write the output once (Q*V*8).  It does
// 2*Q*V*D float operations, far below the card's float32 rate, so it is
// bound by bytes: at Q=8, V=3,774,768, D=24 that is ~1.1 GB, 0.325 ms at
// 3.35 TB/s (H100 SXM).
//
// Design.  The TPU kernel keeps a whole [V+1] state row in VMEM; a Hopper
// block cannot (227 KB of shared memory against 15 MB), so gathers go to
// L2/HBM.  The row body is csrc/ell_row.cuh (also K2's expand):
//  * the adjacency streams through shared memory: each block walks row
//    tiles in a persistent loop, the next tile's nbr/w rows in flight as
//    16-byte cp.async copies (coalesced: a tile is one contiguous span)
//    while this tile's rows are expanded from the copy;
//  * two threads share a row (Q > 4), each gathering four queries'
//    states of a neighbour as one 16-byte load from the transposed [Vp, Q]
//    states, so a pair fills a 32-byte sector in one request; the wrapper
//    (or the engine) hands the states transposed, built in one pass;
//  * padding cells take the sentinel's values from registers;
//  * what is read or written once (the tiles, the carry, the output) goes
//    through L2 as evict-first, so that L2 keeps the gathered states.
// What still bounds it: the gathers.  16.5 M live cells on the main path
// fetch 32-byte sectors at random from a 121 MB state array that the 50 MB
// L2 cannot hold, so the gathered bytes (and their latency) exceed the
// function's bytes.  chip_smoke.py on an H100 80GB HBM3 at 700 W: min_plus
// 0.89-1.03 ms against the 0.325 ms bound (32-36%), pr_sum 0.88-0.97 ms,
// below torch.sparse.mm's 1.75-1.84 ms on the same CSR (PERF.md has each
// run).  The chunk loop is unrolled three times (12 gathers in flight): the
// rows of the main path hold their ~4.4 live cells in the first two chunks,
// so the gathers of a row go out together.
//
// Exactness and the shared row body: csrc/ell_row.cuh.

#include <cuda_runtime.h>

#include "ell_row.cuh"

namespace {

using namespace ell_row;

constexpr int THREADS = 128;  // threads per block: 128 / lanes rows per tile

struct SpmvArgs {
  Adj adj;
  States st;
  const float* carry;  // [Q, V]
  float* out;          // [Q, V]
  float hop_cap;
};

// A persistent loop over row tiles of THREADS / lanes rows: the next
// tile's copies are in flight while this one's rows are expanded.
template <int SR>
__global__ void __launch_bounds__(THREADS) ell_spmv_kernel(const SpmvArgs a) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int lanes = a.adj.lanes, q_total = a.st.q;
  const int rows = THREADS / lanes;
  const int r = threadIdx.x / lanes, h = threadIdx.x - r * lanes;
  const long long v_rows = a.adj.v_rows, tiles = a.adj.tiles;
  const bool staged = a.adj.layout != GLOBAL;
  long long t = blockIdx.x;
  if (staged && t < tiles) issue_tile(a.adj, smem, 0, t * rows, rows);
  cp_async_commit();
  for (int it = 0; t < tiles; ++it, t += gridDim.x) {
    const long long next = t + gridDim.x;
    if (staged && next < tiles) issue_tile(a.adj, smem, (it + 1) & 1, next * rows, rows);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const long long v0 = t * rows, v = v0 + r;
    if (v < v_rows) {
      const RowRef row = staged ? tile_row(a.adj, smem, it & 1, v0, r) : global_row(a.adj, v);
      for (int q0 = QG * h; q0 < q_total; q0 += QG * lanes) {
        const int nq = min(QG, q_total - q0);
        float acc[QG];
        expand_group<SR, true>(a.adj, row, a.st, q0, nq, a.hop_cap, acc);
#pragma unroll
        for (int j = 0; j < QG; ++j) {
          if (j < nq) {
            const long long o = (long long)(q0 + j) * v_rows + v;
            __stcs(a.out + o, combine<SR>(acc[j], __ldcs(a.carry + o)));
          }
        }
      }
    }
    __syncthreads();  // the stage is refilled next round
  }
  cp_async_wait<0>();
}

template <int SR>
int launch(const SpmvArgs& a, size_t smem, cudaStream_t stream) {
  const int grid = persistent_grid(ell_spmv_kernel<SR>, THREADS, smem, a.adj.tiles);
  if (grid > 0) ell_spmv_kernel<SR><<<grid, THREADS, smem, stream>>>(a);
  return grid;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes, dtypes, devices and contiguity before calling; states_t is
// [vp, q_total], its row vp - 1 the sentinel.
extern "C" int ell_spmv_launch(const float* states_t, const int* nbr,
                               const float* w, const float* carry, float* out,
                               int q_total, int v_rows, int d_cols, int vp,
                               int semiring, float hop_cap, void* stream) {
  if (q_total > 0 && v_rows > 0) {
    const bool uses_w = semiring == MIN_PLUS || semiring == PR_SUM;
    size_t smem = 0;
    SpmvArgs a{};
    a.adj = make_adj(nbr, uses_w ? w : nullptr, v_rows, d_cols, lanes_for(q_total),
                     THREADS, true, &smem);
    a.st = make_states(states_t, vp, q_total);
    a.carry = carry;
    a.out = out;
    a.hop_cap = hop_cap;
    const cudaStream_t st = (cudaStream_t)stream;
    int grid = 0;
    switch (semiring) {
      case MIN_PLUS: grid = launch<MIN_PLUS>(a, smem, st); break;
      case MIN_HOP: grid = launch<MIN_HOP>(a, smem, st); break;
      case MIN_LABEL: grid = launch<MIN_LABEL>(a, smem, st); break;
      default: grid = launch<PR_SUM>(a, smem, st); break;
    }
    if (grid == 0) {
      const int err = (int)cudaGetLastError();
      return err != 0 ? err : (int)cudaErrorInvalidConfiguration;
    }
  }
  return (int)cudaGetLastError();
}

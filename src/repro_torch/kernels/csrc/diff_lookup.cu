// Latest change point <= qi per sorted store row (K4, the J store's lookup).
//
// Replaces the Pallas TPU kernel repro/kernels/diff_lookup.py::diff_lookup
// (body _kernel).  For every row n of a sorted, IMAX-padded store:
//
//   idx      = #{k : iters[n, k] <= qi[n]} - 1         (-1 .. S-1)
//   found[n] = idx >= 0
//   val[n]   = found ? vals[n, idx]  : 0
//   iter[n]  = found ? iters[n, idx] : -1
//
// The index is a <=-count over the whole row, as the TPU kernel and
// diffstore.lookup_le compute it, so a row with a repeated iteration lands
// on the last repeat.  The value is a gather, as lookup_le and the plain
// version take it: the TPU body's one-hot sum(where(onehot, v, 0)) would
// turn a stored -0.0 into +0.0.
//
// Bound on the card.  Each row reads its S iterations and, where a point is
// found, one value (the iteration comes from the row already read), and
// writes val, iter and found: N*S*4 + found*4 bytes read and N*9 written.
// The VDC engine calls it twice per sweep iteration on the whole J store
// (N = Q*E_cap = 8 x 22.3 M at cit-Patents size, S = S_J = 8): 7.3 to 8.0 GB
// as few or all rows are found, 2.2 to 2.4 ms at 3.35 TB/s.  A compare and
// an add per stored iteration: bytes bound it.
//
// Design (simple and right first).  One thread per row; the row's
// iterations come in as 16-byte vectors when S is a multiple of 4 and the
// base is 16-byte aligned (the wrapper checks and says so), else as scalars.
// Neighbouring threads read neighbouring rows, so a warp's loads cover one
// contiguous span.  Offsets are 64-bit: the J call has ~1.4e9 elements.
// The query iteration is either a per-row array or one scalar argument
// (the engine's form: every J row asks for the sweep iteration i).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
diff_lookup_kernel(const int* __restrict__ iters,   // [N, S]
                   const float* __restrict__ vals,  // [N, S]
                   const int* __restrict__ qi,      // [N], or null: use qi_scalar
                   int qi_scalar,
                   float* __restrict__ out_val,        // [N]
                   int* __restrict__ out_iter,         // [N]
                   unsigned char* __restrict__ out_found,  // bool [N]
                   long long n, int s) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int q = qi != nullptr ? __ldg(qi + r) : qi_scalar;
  const long long base = r * (long long)s;
  int cnt = 0;
  if (VEC) {
    const int4* row = reinterpret_cast<const int4*>(iters + base);
    for (int k = 0; k < s / 4; ++k) {
      const int4 x = __ldg(row + k);
      cnt += (x.x <= q) + (x.y <= q) + (x.z <= q) + (x.w <= q);
    }
  } else {
    for (int k = 0; k < s; ++k) cnt += __ldg(iters + base + k) <= q;
  }
  const bool found = cnt > 0;
  const long long at = base + (found ? cnt - 1 : 0);
  out_val[r] = found ? __ldg(vals + at) : 0.0f;
  out_iter[r] = found ? __ldg(iters + at) : -1;
  out_found[r] = found;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `vec`
// asks for 16-byte row loads: the caller passes it only when S % 4 == 0 and
// `iters` is 16-byte aligned.  The caller checks shapes, dtypes, devices
// and contiguity before calling.
extern "C" int diff_lookup_launch(const int* iters, const float* vals,
                                  const int* qi, int qi_scalar, float* out_val,
                                  int* out_iter, unsigned char* out_found,
                                  long long n, int s, int vec, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    const cudaStream_t st = (cudaStream_t)stream;
    if (vec)
      diff_lookup_kernel<true><<<blocks, THREADS, 0, st>>>(
          iters, vals, qi, qi_scalar, out_val, out_iter, out_found, n, s);
    else
      diff_lookup_kernel<false><<<blocks, THREADS, 0, st>>>(
          iters, vals, qi, qi_scalar, out_val, out_iter, out_found, n, s);
  }
  return (int)cudaGetLastError();
}

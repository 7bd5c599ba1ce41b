// Multi-probe Bloom query over packed 32-bit words (Prob-Drop, paper §5.1.2).
//
// Replaces the Pallas TPU kernel repro/kernels/bloom.py::bloom_query.  For
// every query row q and key n:
//
//   out[q, n] = AND_{j < k} bit(words[q], probe_j(v[q, n], i[q, n], salt[q]))
//
// with the hash of csrc/bloom_hash.cuh (the one K2's prob stage probes with).
//
// Bound on the card.  Each key reads v and i (8 bytes) and writes one byte,
// and the filter rows are read once at best: (Q*N*9 + Q*4 + min(Q*M/8,
// 4 * probes reached)) bytes at 3.35 TB/s.  What the card spends besides is
// the probes: the AND stops at the first clear bit, so a key costs 1 + f +
// f^2 + ... random words of its row (f the row's fill), each a separate
// 32-byte L2 sector, since a row (2^26 bits, 8 MB, on the main path's
// filter) is far past L1 and the words a warp asks for are scattered over
// it.
//
// Design for Hopper:
//  * Overlapped probes, early exit kept.  A thread takes a quad of four keys
//    and issues probe j of every key of the quad that is still alive before
//    it tests any of them: four L2 requests in flight a thread where the
//    AND's short-circuit had one, and still only the probes the early exit
//    reaches.  More keys a thread only add registers: at the main path's
//    filter the probes are bound by the rate at which L2 serves scattered
//    sectors, not by their latency (PERF.md §6).
//  * No division.  A power-of-two M (every path's filter) masks; any other M
//    takes Lemire, Kaser and Kurz's exact reciprocal: with c = floor((2^64 -
//    1) / M) + 1 from the wrapper, x mod M = umulhi64(c * x mod 2^64, M) for
//    every 32-bit x.  bloom_hash::probe, which K2 calls, keeps its `%`.
//  * Key streams as 16-byte vectors and each quad's answers as one 4-byte
//    word, all with evict-first hints (ld/st .cs), so the keys pass through
//    L2 without pushing out the filter lines the probes reuse.  The grid is
//    (quad tiles, Q), row-major in q, so the resident blocks share one or two
//    rows (16 MB of the 50 MB L2).
//  * Scalar path in the kernel: a quad that straddles two rows, or every quad
//    of a launch whose v, i or out is not 16-byte (out: 4-byte) aligned,
//    loads its keys one by one and stores bytes; the probes are the same.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_hash.cuh"

namespace {

constexpr int THREADS = 256;  // one quad of keys a thread

// x mod d without a division (see the header).
template <bool POW2>
__device__ __forceinline__ uint32_t mod_bits(uint32_t x, uint64_t c, uint32_t d) {
  if constexpr (POW2) {
    return x & (d - 1u);
  } else {
    return (uint32_t)__umul64hi(c * (uint64_t)x, (uint64_t)d);
  }
}

// Row q's keys are the flat keys [q*N, q*N + N); its quads are the flat
// quads (four keys from a multiple of 4) that hold any of them, numbered u
// from the first.  Thread t of block b takes quad b*THREADS + t.
template <bool POW2>
__global__ void __launch_bounds__(THREADS)
bloom_query_kernel(const uint32_t* __restrict__ words,  // [Q, W]
                   const int* __restrict__ v,           // [Q, N]
                   const int* __restrict__ it,          // [Q, N]
                   const int* __restrict__ salt,        // [Q]
                   unsigned char* __restrict__ out,     // [Q, N]
                   long long n_keys, long long n_words, int num_hashes,
                   uint64_t c, int vec) {
  const int q = blockIdx.y;
  const long long row0 = (long long)q * n_keys;
  const long long row1 = row0 + n_keys;
  const long long g0 = row0 >> 2;
  const long long u = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (u > ((row1 - 1) >> 2) - g0) return;  // past the row's last quad
  const long long k0 = (g0 + u) * 4;
  const bool full = vec && k0 >= row0 && k0 + 4 <= row1;
  const uint32_t d = (uint32_t)(n_words * 32);
  const uint32_t s = (uint32_t)__ldg(salt + q);
  const uint32_t* row = words + q * n_words;

  uint32_t kv[4] = {0, 0, 0, 0}, ki[4] = {0, 0, 0, 0};
  uint32_t valid = 0;  // bit e: key k0 + e is in the row
  if (full) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(v + k0));
    const int4 b = __ldcs(reinterpret_cast<const int4*>(it + k0));
    kv[0] = a.x, kv[1] = a.y, kv[2] = a.z, kv[3] = a.w;
    ki[0] = b.x, ki[1] = b.y, ki[2] = b.z, ki[3] = b.w;
    valid = 0xFu;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k0 + e >= row0 && k0 + e < row1) {
        kv[e] = (uint32_t)__ldcs(v + k0 + e);
        ki[e] = (uint32_t)__ldcs(it + k0 + e);
        valid |= 1u << e;
      }
    }
  }
  // probe j = (h1 + j*h2) mod 2^32 mod M: acc walks h1, h1 + h2, ...
  uint32_t acc[4], step[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) bloom_hash::hash_key(kv[e], ki[e], s, acc[e], step[e]);

  uint32_t live = valid;
  for (int j = 0; j < num_hashes && live; ++j) {
    uint32_t p[4], w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // every load issued before any is tested
      p[e] = 0, w[e] = 0;
      if ((live >> e) & 1u) {
        p[e] = mod_bits<POW2>(acc[e], c, d);
        w[e] = __ldg(row + (p[e] >> 5));
      }
      acc[e] += step[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!((w[e] >> (p[e] & 31u)) & 1u)) live &= ~(1u << e);
  }

  if (full) {  // one bit a byte: bit e of live becomes byte e of the word
    const uint32_t word = (live & 1u) | ((live & 2u) << 7) | ((live & 4u) << 14) | ((live & 8u) << 21);
    __stcs(reinterpret_cast<unsigned int*>(out + k0), word);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((valid >> e) & 1u) __stcs(out + k0 + e, (unsigned char)((live >> e) & 1u));
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes, dtypes, devices and contiguity before calling, and passes
// c = floor((2^64 - 1) / (32 * n_words)) + 1.
extern "C" int bloom_query_launch(const uint32_t* words, const int* v,
                                  const int* it, const int* salt,
                                  unsigned char* out, int q_rows,
                                  long long n_keys, long long n_words,
                                  int num_hashes, unsigned long long c,
                                  void* stream) {
  if (q_rows > 0 && n_keys > 0) {
    const long long max_quads = (n_keys + 6) / 4;  // a row's quads, whatever its offset
    const dim3 grid((unsigned)((max_quads + THREADS - 1) / THREADS), (unsigned)q_rows);
    const int vec = ((uintptr_t)v % 16 == 0) && ((uintptr_t)it % 16 == 0) && ((uintptr_t)out % 4 == 0);
    const uint32_t num_bits = (uint32_t)(n_words * 32);
    cudaStream_t s = (cudaStream_t)stream;
    if ((num_bits & (num_bits - 1u)) == 0) {
      bloom_query_kernel<true><<<grid, THREADS, 0, s>>>(words, v, it, salt, out, n_keys, n_words,
                                                        num_hashes, c, vec);
    } else {
      bloom_query_kernel<false><<<grid, THREADS, 0, s>>>(words, v, it, salt, out, n_keys, n_words,
                                                         num_hashes, c, vec);
    }
  }
  return (int)cudaGetLastError();
}

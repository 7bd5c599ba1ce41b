// Multi-probe Bloom query over packed 32-bit words (Prob-Drop, paper §5.1.2).
//
// Replaces the Pallas TPU kernel repro/kernels/bloom.py::bloom_query.  For
// every query row q and key n:
//
//   out[q, n] = AND_{j < k} bit(words[q], probe_j(v[q, n], i[q, n], salt[q]))
//
// with the hash of csrc/bloom_hash.cuh (the one K2's prob stage probes with).
//
// Bound on the card.  Each key reads v and i (8 bytes) and writes one byte;
// the k probes touch k words of the filter row, which for a random key are
// k separate 32-byte sectors.  Counting each input once, the bound is
// (Q*N*9 + Q*M/8) bytes at 3.35 TB/s; the k word gathers make the real cost
// up to k*32 bytes per key once the filter outgrows the 50 MB L2.
//
// Design.  One thread per key, grid (ceil(N / THREADS), Q); the filter row
// stays in device memory (the TPU kernel holds it in VMEM; at 2^26 bits it is
// 8 MB a row, beyond a block's shared memory) and the gathers go through L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_hash.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void bloom_query_kernel(const uint32_t* __restrict__ words,  // [Q, W]
                                   const int* __restrict__ v,           // [Q, N]
                                   const int* __restrict__ it,          // [Q, N]
                                   const int* __restrict__ salt,        // [Q]
                                   unsigned char* __restrict__ out,     // [Q, N]
                                   long long n_keys, long long n_words,
                                   int num_hashes) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_keys) return;
  const int q = blockIdx.y;
  const long long k = q * n_keys + n;
  const uint32_t num_bits = (uint32_t)(n_words * 32);
  uint32_t h1, h2;
  bloom_hash::hash_key((uint32_t)v[k], (uint32_t)it[k], (uint32_t)salt[q], h1, h2);
  const uint32_t* row = words + q * n_words;
  bool hit = true;
  for (int j = 0; j < num_hashes; ++j) {
    const uint32_t p = bloom_hash::probe(h1, h2, (uint32_t)j, num_bits);
    hit = hit && ((__ldg(row + (p >> 5)) >> (p & 31u)) & 1u);
  }
  out[k] = hit;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes, dtypes, devices and contiguity before calling.
extern "C" int bloom_query_launch(const uint32_t* words, const int* v,
                                  const int* it, const int* salt,
                                  unsigned char* out, int q_rows,
                                  long long n_keys, long long n_words,
                                  int num_hashes, void* stream) {
  if (q_rows > 0 && n_keys > 0) {
    const dim3 grid((unsigned)((n_keys + THREADS - 1) / THREADS), (unsigned)q_rows);
    bloom_query_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        words, v, it, salt, out, n_keys, n_words, num_hashes);
  }
  return (int)cudaGetLastError();
}

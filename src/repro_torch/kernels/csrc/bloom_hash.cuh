// The Prob-Drop key hash shared by fused_sweep.cu (K2's DroppedVT probe) and
// bloom.cu (K3): murmur3 fmix32 mixes of the (vertex, iteration) key, salted
// by the query slot, and Kirsch–Mitzenmacher double hashing
//
//   probe_j = (h1 + j * h2) mod M,   j < k,
//
// all in native uint32 arithmetic (wrap-around is the hash's definition).
// The same functions as repro_torch/core/bloom.py (hash_key, _probes), which
// emulates the uint32 arithmetic in int64.
#pragma once

#include <stdint.h>

namespace bloom_hash {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void hash_key(uint32_t v, uint32_t i, uint32_t salt,
                                         uint32_t& h1, uint32_t& h2) {
  h1 = fmix32((v * 0x27D4EB2Fu) ^ fmix32(i + salt));
  h2 = fmix32((i * 0x85EBCA6Bu) ^ fmix32(v ^ (salt * 0xC2B2AE35u))) | 1u;  // odd
}

__device__ __forceinline__ uint32_t probe(uint32_t h1, uint32_t h2, uint32_t j,
                                          uint32_t num_bits) {
  return (h1 + j * h2) % num_bits;
}

}  // namespace bloom_hash

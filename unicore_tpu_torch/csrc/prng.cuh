// Counter-hash dropout bits shared by the port's kernels.
//
// Device counterpart of unicore_tpu/ops/pallas/prng.py (and of the plain
// version unicore_tpu_torch/ops/prng.py): element `idx` of a block drawn
// under `seed` gets mix(idx + seed * 0x9E3779B9), mix being the
// splitmix32 finalizer, all in uint32 arithmetic, so a kernel draws the
// very bits the TPU kernels draw.  A signed int32 seed converts to uint32
// by wrapping mod 2^32, as JAX's astype(uint32) does.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t unicore_mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x21F0AAADu;
  h ^= h >> 15;
  h *= 0x735A2D97u;
  h ^= h >> 15;
  return h;
}

__device__ __forceinline__ uint32_t unicore_random_bits(uint32_t seed,
                                                        uint32_t idx) {
  return unicore_mix32(idx + seed * 0x9E3779B9u);
}

// fp32 -> bf16 stochastic rounding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of unicore_tpu/ops/pallas/rounding.py
// (_kernel).  Element i of the flat fp32 input gets 16 random bits added
// below the bf16 mantissa boundary and is truncated to its high 16 bits:
//
//   hi = (finite(x) ? bits(x) + (noise & 0xFFFF) : bits(x)) >> 16
//
// A result that is a NaN becomes the quiet NaN 0x7FC0 with x's sign, as
// XLA's fp32 -> bf16 convert of the reference gives it.  The noise is the
// TPU kernel's, bit for bit (prng.cuh): the reference lays the input out
// as [rows, 1024] and gives each block of r_blk rows (its pick_layout: 256
// when the padded row count divides by 256, else 8) the seed seed + pid,
// so element i draws random_bits(seed + row / r_blk, (row % r_blk) * 1024
// + lane) with row = i / 1024, lane = i % 1024.  The reference's zero
// padding needs no memory here: the kernel indexes the flat tensor.
//
// Design: one thread per element in a grid-stride loop; the seed is read
// from device memory, so a caller that draws seeds on the card never
// synchronises with the host.
//
// Bound: bytes, 4 read and 2 written per element: a 1M-element leaf is
// ~1.9 us at 3.35 TB/s.  The optimizer's leaves are small, so launch
// overhead dominates; a multi-tensor launch is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prng.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    fp32_to_bf16_sr_kernel(const float* __restrict__ x,
                           uint16_t* __restrict__ out, long long n,
                           const int* __restrict__ seed, int r_blk) {
  const uint32_t s = static_cast<uint32_t>(seed[0]);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long row = i >> 10;
    const uint32_t lane = static_cast<uint32_t>(i & 1023);
    const uint32_t pid = static_cast<uint32_t>(row / r_blk);
    const uint32_t idx = static_cast<uint32_t>(row % r_blk) * 1024u + lane;
    const uint32_t noise = unicore_random_bits(s + pid, idx) & 0xFFFFu;
    const uint32_t bits = __float_as_uint(x[i]);
    const bool finite = (bits & 0x7F800000u) != 0x7F800000u;
    uint32_t hi = (finite ? bits + noise : bits) >> 16;
    if ((hi & 0x7F80u) == 0x7F80u && (hi & 0x7Fu)) hi = (hi & 0x8000u) | 0x7FC0u;
    out[i] = static_cast<uint16_t>(hi);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  x is n
// contiguous floats, out n contiguous bf16 (as uint16), seed one int32 on
// the card; r_blk is the reference layout's row block.
extern "C" int unicore_fp32_to_bf16_sr(const float* x, void* out, long long n,
                                       const int* seed, int r_blk,
                                       void* stream) {
  if (n == 0) return 0;
  if (r_blk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  fp32_to_bf16_sr_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<uint16_t*>(out), n, seed, r_blk);
  return static_cast<int>(cudaGetLastError());
}

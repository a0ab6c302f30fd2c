// fp32 -> bf16 stochastic rounding for Hopper (sm_90a), many tensors in
// one launch.
//
// Replaces the Pallas TPU kernel of unicore_tpu/ops/pallas/rounding.py
// (_kernel).  Element i of a flat fp32 input gets 16 random bits added
// below the bf16 mantissa boundary and is truncated to its high 16 bits:
//
//   hi = (finite(x) ? bits(x) + (noise & 0xFFFF) : bits(x)) >> 16
//
// A result that is a NaN becomes the quiet NaN 0x7FC0 with x's sign, as
// XLA's fp32 -> bf16 convert of the reference gives it.  The noise is the
// TPU kernel's, bit for bit (prng.cuh): the reference lays each input out
// as [rows, 1024] and gives each block of r_blk rows (its pick_layout: 256
// when the padded row count divides by 256, else 8) the seed seed + pid,
// so element i draws random_bits(seed + row / r_blk, (row % r_blk) * 1024
// + lane) with row = i / 1024, lane = i % 1024.  The reference's zero
// padding needs no memory here: the kernel indexes the flat tensor.
//
// Bound: bytes, 4 read and 2 written per element.  The callers round
// every parameter leaf of a model (688 in evoformer_base, most of them
// under 100K elements), where one launch a leaf costs a few microseconds
// of launch latency against well under one of bytes.  So one launch
// takes a table of entries (x, out, numel, r_blk, seed index), passed
// by value as a __grid_constant__ kernel parameter (up to kMaxEntries of
// them: the table fills most of the 32,764 bytes sm_90 allows), with one
// device pointer to the int32 seeds: no host staging buffer to keep
// alive, and the seeds never leave the card.  The grid runs over the sum
// of the entries' blocks; a block finds its entry by a binary search of
// the entries' first blocks, all in parameter space.  A thread rounds 8
// consecutive elements of one row with two 16-byte loads and one 16-byte
// store where the entry's pointers allow, else element by element (a
// leaf's ragged tail).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "prng.cuh"

// One tensor of a launch.  first_block is filled by the host entry point.
// (At namespace scope: a type of the C entry point's signature.)
struct SrEntry {
  const float* x;
  uint16_t* out;
  long long n;
  long long first_block;
  int r_blk;
  int seed;  // index into the seeds array
};
static_assert(sizeof(SrEntry) == 40, "SrEntry is mirrored by ctypes");

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr long long kBlockElems = kThreads * kPerThread;
constexpr int kMaxEntries = 800;

struct SrTable {
  const int* seeds;
  int count;
  int unused;
  SrEntry e[kMaxEntries];
};
static_assert(sizeof(SrTable) <= 32764, "a kernel parameter of sm_90");

__device__ __forceinline__ uint32_t sr_bits(uint32_t bits, uint32_t seed,
                                            uint32_t idx) {
  const uint32_t noise = unicore_random_bits(seed, idx) & 0xFFFFu;
  const bool finite = (bits & 0x7F800000u) != 0x7F800000u;
  uint32_t hi = (finite ? bits + noise : bits) >> 16;
  if ((hi & 0x7F80u) == 0x7F80u && (hi & 0x7Fu)) hi = (hi & 0x8000u) | 0x7FC0u;
  return hi;
}

__global__ void __launch_bounds__(kThreads)
    fp32_to_bf16_sr_kernel(const __grid_constant__ SrTable t) {
  const long long b = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // the last entry whose first block <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.e[mid].first_block <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const SrEntry& e = t.e[lo];
  const long long i0 =
      (b - e.first_block) * kBlockElems + threadIdx.x * kPerThread;
  if (i0 >= e.n) return;
  // i0 is a multiple of 8: its 8 elements share one 1024-wide row
  const long long row = i0 >> 10;
  const int shift = __ffs(e.r_blk) - 1;  // r_blk is a power of two
  const uint32_t seed = static_cast<uint32_t>(t.seeds[e.seed]) +
                        static_cast<uint32_t>(row >> shift);
  const uint32_t idx = (static_cast<uint32_t>(row & (e.r_blk - 1)) << 10) |
                       static_cast<uint32_t>(i0 & 1023);
  const float* x = e.x + i0;
  uint16_t* out = e.out + i0;
  const bool vec = i0 + kPerThread <= e.n &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(x)[0];
    const float4 c = reinterpret_cast<const float4*>(x)[1];
    const float v[kPerThread] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
    uint32_t packed[kPerThread / 2];
#pragma unroll
    for (int j = 0; j < kPerThread / 2; ++j) {
      packed[j] = sr_bits(__float_as_uint(v[2 * j]), seed, idx + 2 * j) |
                  (sr_bits(__float_as_uint(v[2 * j + 1]), seed,
                           idx + 2 * j + 1) << 16);
    }
    reinterpret_cast<uint4*>(out)[0] =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  } else {
    for (int j = 0; j < kPerThread && i0 + j < e.n; ++j) {
      out[j] = static_cast<uint16_t>(
          sr_bits(__float_as_uint(x[j]), seed, idx + j));
    }
  }
}

}  // namespace

// The most entries one launch takes.
extern "C" int unicore_fp32_to_bf16_sr_capacity() { return kMaxEntries; }

// Round `count` entries (1 <= count <= kMaxEntries; each n > 0, r_blk a
// power of two; first_block ignored) in one launch on `stream`; seeds is
// the int32 seed array on the card that each entry's seed indexes.
// Returns cudaGetLastError() (0 on success).
extern "C" int unicore_fp32_to_bf16_sr(const SrEntry* entries, int count,
                                       const int* seeds, void* stream) {
  if (count <= 0 || count > kMaxEntries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SrTable t;  // copied into the launch's parameters by the launch
  t.seeds = seeds;
  t.count = count;
  long long blocks = 0;
  for (int k = 0; k < count; ++k) {
    const SrEntry& in = entries[k];
    if (in.n <= 0 || in.r_blk <= 0 || (in.r_blk & (in.r_blk - 1))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    t.e[k] = in;
    t.e[k].first_block = blocks;
    blocks += (in.n + kBlockElems - 1) / kBlockElems;
  }
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fp32_to_bf16_sr_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// EMA of the fp32 master parameters for Hopper (sm_90a), many tensors in
// one launch.
//
// No TPU kernel stands behind it: the JAX trainer updates its EMA inside
// the jitted step (unicore_tpu/trainer.py, train_step's ema_decay branch),
//
//   ema = ema * d + p * (1 - d)      with d = float32(ema_decay)
//
// and XLA contracts it to one fused multiply-add, fma(ema, d, p * (1 - d)):
// p * (1 - d) rounds to fp32 first, then the product ema * d is added
// with one rounding.  The kernel computes exactly that, with the
// intrinsics __fmul_rn and __fmaf_rn so that nvcc can neither contract the
// first product nor split the second; 1 - d comes from the host already
// formed in fp32.  The plain version (ops/ema.py) reaches the same bits on
// any device through float64.
//
// Bound: bytes, 8 read and 4 written per element.  The trainer updates
// every parameter leaf after each applied step (688 leaves in
// evoformer_base, most under 100K elements), so one launch takes a table
// of entries (ema, param, numel), passed by value as a __grid_constant__
// kernel parameter, as the SR kernel's table (rounding.cu).  A block finds
// its entry by a binary search of the entries' first blocks; a thread
// updates 4 consecutive elements with 16-byte loads and stores where the
// pointers allow, else element by element (a leaf's ragged tail).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

// One tensor pair of a launch.  first_block is filled by the host entry
// point.  (At namespace scope: a type of the C entry point's signature.)
struct EmaEntry {
  float* ema;
  const float* p;
  long long n;
  long long first_block;
};
static_assert(sizeof(EmaEntry) == 32, "EmaEntry is mirrored by ctypes");

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr long long kBlockElems = kThreads * kPerThread;
constexpr int kMaxEntries = 1000;

struct EmaTable {
  float d;
  float one_minus_d;
  int count;
  int unused;
  EmaEntry e[kMaxEntries];
};
static_assert(sizeof(EmaTable) <= 32764, "a kernel parameter of sm_90");

__device__ __forceinline__ float ema_one(float e, float p, float d,
                                         float omd) {
  return __fmaf_rn(e, d, __fmul_rn(p, omd));
}

__global__ void __launch_bounds__(kThreads)
    ema_update_kernel(const __grid_constant__ EmaTable t) {
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
  const EmaEntry& en = t.e[lo];
  const long long i0 =
      (b - en.first_block) * kBlockElems + threadIdx.x * kPerThread;
  if (i0 >= en.n) return;
  float* e = en.ema + i0;
  const float* p = en.p + i0;
  const bool vec = i0 + kPerThread <= en.n &&
                   ((reinterpret_cast<uintptr_t>(e) |
                     reinterpret_cast<uintptr_t>(p)) & 15) == 0;
  if (vec) {
    float4 ev = reinterpret_cast<const float4*>(e)[0];
    const float4 pv = reinterpret_cast<const float4*>(p)[0];
    ev.x = ema_one(ev.x, pv.x, t.d, t.one_minus_d);
    ev.y = ema_one(ev.y, pv.y, t.d, t.one_minus_d);
    ev.z = ema_one(ev.z, pv.z, t.d, t.one_minus_d);
    ev.w = ema_one(ev.w, pv.w, t.d, t.one_minus_d);
    reinterpret_cast<float4*>(e)[0] = ev;
  } else {
    for (int j = 0; j < kPerThread && i0 + j < en.n; ++j) {
      e[j] = ema_one(e[j], p[j], t.d, t.one_minus_d);
    }
  }
}

}  // namespace

// The most entries one launch takes.
extern "C" int unicore_ema_update_capacity() { return kMaxEntries; }

// Update `count` entries (1 <= count <= kMaxEntries; each n > 0;
// first_block ignored) in place in one launch on `stream`:
// ema = fma(ema, d, p * one_minus_d).  Returns cudaGetLastError() (0 on
// success).
extern "C" int unicore_ema_update(const EmaEntry* entries, int count,
                                  float d, float one_minus_d, void* stream) {
  if (count <= 0 || count > kMaxEntries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EmaTable t;  // copied into the launch's parameters by the launch
  t.d = d;
  t.one_minus_d = one_minus_d;
  t.count = count;
  long long blocks = 0;
  for (int k = 0; k < count; ++k) {
    const EmaEntry& in = entries[k];
    if (in.n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    t.e[k] = in;
    t.e[k].first_block = blocks;
    blocks += (in.n + kBlockElems - 1) / kBlockElems;
  }
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  ema_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

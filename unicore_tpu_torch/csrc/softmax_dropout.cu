// Fused bias + mask + softmax + dropout, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of unicore_tpu/ops/pallas/
// softmax_dropout.py: the forward _fwd_kernel and the backward
// _bwd_kernel.  For a row (lead..., r) of x [L0, L1, L2, Q, K]:
//
//   z[c]   = float(x[c]) + float(mask[c]) + float(bias[c])   (that order)
//   y[c]   = exp(z[c] - max z) / sum_c exp(z[c] - max z)
//   out[c] = keep[c] ? y[c] * inv_keep : 0          (in x's type)
//   sm[c]  = y[c]                                   (in x's type, grad mode)
//
// and the backward, from g and the saved sm (both in x's type):
//
//   g'[c]  = keep[c] ? g[c] * inv_keep : 0
//   dx[c]  = y[c] * (g'[c] - sum_c g'[c] y[c])      (y = float(sm))
//
// Dropout bits are those of the TPU kernel (prng.cuh): element (row, c)
// draws under seed + pid at index (r % q_blk) * K + c, where pid is the
// row-major linear index over (lead dims..., r / q_blk) and q_blk is the
// REFERENCE's row block (its _pick_q_blk_for, passed in), not this
// kernel's work split.  The backward recomputes the same mask.
//
// Layouts: x, mask and bias are read by strides over (L0, L1, L2, Q) with
// a unit last dim; a broadcast dim of mask or bias has stride 0, which
// covers the Evoformer contracts (mask [B, G, 1, 1, K], bias
// [1|B, 1|G, H, Q, K]) and BERT's [1, B, H, T, T] (a 4-D call gets a
// leading 1).  mask and bias are fp32 or bf16 each; x is templated.
// out, sm, g and dx are contiguous [rows, K].
//
// Design: each row is owned by one warp when K <= 1024 (K / 32 values per
// lane, in registers) and by one block of 256 threads up to K = 8192;
// the row's max and sum reduce by warp shuffles (and shared memory across
// the block's warps).  A lane reads columns lane, lane + 32, ... so a
// warp's loads are contiguous.
//
// Bound: bytes.  The forward reads x and writes out and sm (6 bytes an
// element in bf16, plus the mask and bias at their own sizes); the
// backward reads g and sm and writes dx.  Against 3.35 TB/s that is
// ~0.12 ms for each pass of the Evoformer triangle attention
// ([1, 256, 4, 256, 256] bf16).  This first design makes 2-byte loads in
// bf16; vector loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "prng.cuh"

// Mirrored field by field by _Params in ops/softmax_dropout.py: the
// 8-byte fields first, then the 4-byte ones.
struct SoftmaxDropoutParams {
  const void* x;
  const void* mask;
  const void* bias;
  const int* seed;
  void* out;
  void* sm;
  const void* g;
  void* dx;
  long long sx[4];  // strides of x over (L0, L1, L2, Q)
  long long smk[4];  // of mask, 0 on broadcast dims
  long long sb[4];  // of bias, 0 on broadcast dims
  long long rows;   // L0 * L1 * L2 * Q
  int L1, L2, Q, K;
  int mask_bf16, bias_bf16, dropout, q_blk;
  float inv_keep;
  uint32_t keep_thresh;
};

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float load_any(const void* p, long long off,
                                          int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[off])
              : static_cast<const float*>(p)[off];
}

// Reduce over the kTPR threads that own a row: one warp, or the block.
template <int kTPR, bool kMax>
__device__ __forceinline__ float row_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  if (kTPR == 32) return v;
  __shared__ float red[kThreads / 32];
  __syncthreads();  // the previous reduction's readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) v = kMax ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

// The row this thread works on, or -1 past the end.
template <int kTPR>
__device__ __forceinline__ long long my_row(const SoftmaxDropoutParams& p) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / kTPR) + threadIdx.x / kTPR;
  return row < p.rows ? row : -1;
}

// The dropout seed of a row: seed + pid, pid over (lead..., r / q_blk).
__device__ __forceinline__ uint32_t row_seed(const SoftmaxDropoutParams& p,
                                             long long row) {
  const long long lead = row / p.Q;
  const int r = static_cast<int>(row - lead * p.Q);
  const long long pid = lead * (p.Q / p.q_blk) + r / p.q_blk;
  return static_cast<uint32_t>(p.seed[0]) + static_cast<uint32_t>(pid);
}

__device__ __forceinline__ bool keep(const SoftmaxDropoutParams& p,
                                     uint32_t seed, int r, int c) {
  const uint32_t idx =
      static_cast<uint32_t>(r % p.q_blk) * static_cast<uint32_t>(p.K) + c;
  return unicore_random_bits(seed, idx) < p.keep_thresh;
}

template <typename T, int kTPR, int kNPT>
__global__ void __launch_bounds__(kThreads)
    softmax_dropout_fwd_kernel(const SoftmaxDropoutParams p) {
  const long long row = my_row<kTPR>(p);
  if (row < 0) return;  // the row's whole warp (or block) leaves together
  const int lane = threadIdx.x % kTPR;
  const int K = p.K;
  // (l0, l1, l2, r) of the row
  const long long lead = row / p.Q;
  const int r = static_cast<int>(row - lead * p.Q);
  const int l2 = static_cast<int>(lead % p.L2);
  const long long t = lead / p.L2;
  const int l1 = static_cast<int>(t % p.L1);
  const long long l0 = t / p.L1;
  const T* x = static_cast<const T*>(p.x) + l0 * p.sx[0] + l1 * p.sx[1] +
               l2 * p.sx[2] + r * p.sx[3];
  const long long mo =
      l0 * p.smk[0] + l1 * p.smk[1] + l2 * p.smk[2] + r * p.smk[3];
  const long long bo = l0 * p.sb[0] + l1 * p.sb[1] + l2 * p.sb[2] + r * p.sb[3];

  float v[kNPT];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    const int c = i * kTPR + lane;
    v[i] = -INFINITY;
    if (c < K) {
      float z = to_float(x[c]);
      if (p.mask) z += load_any(p.mask, mo + c, p.mask_bf16);
      if (p.bias) z += load_any(p.bias, bo + c, p.bias_bf16);
      v[i] = z;
      mx = fmaxf(mx, z);
    }
  }
  mx = row_reduce<kTPR, true>(mx);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    const int c = i * kTPR + lane;
    if (c < K) {
      v[i] = expf(v[i] - mx);
      s += v[i];
    }
  }
  s = row_reduce<kTPR, false>(s);
  const uint32_t seed = p.dropout ? row_seed(p, row) : 0u;
  T* out = static_cast<T*>(p.out) + row * K;
  T* sm = p.sm ? static_cast<T*>(p.sm) + row * K : nullptr;
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    const int c = i * kTPR + lane;
    if (c < K) {
      const float y = v[i] / s;
      if (sm) sm[c] = from_float<T>(y);
      float o = y;
      if (p.dropout) o = keep(p, seed, r, c) ? y * p.inv_keep : 0.f;
      out[c] = from_float<T>(o);
    }
  }
}

template <typename T, int kTPR, int kNPT>
__global__ void __launch_bounds__(kThreads)
    softmax_dropout_bwd_kernel(const SoftmaxDropoutParams p) {
  const long long row = my_row<kTPR>(p);
  if (row < 0) return;
  const int lane = threadIdx.x % kTPR;
  const int K = p.K;
  const int r = static_cast<int>(row % p.Q);
  const T* g = static_cast<const T*>(p.g) + row * K;
  const T* sm = static_cast<const T*>(p.sm) + row * K;
  const uint32_t seed = p.dropout ? row_seed(p, row) : 0u;
  float gv[kNPT], yv[kNPT];
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    const int c = i * kTPR + lane;
    gv[i] = 0.f;
    yv[i] = 0.f;
    if (c < K) {
      float gi = to_float(g[c]);
      if (p.dropout) gi = keep(p, seed, r, c) ? gi * p.inv_keep : 0.f;
      gv[i] = gi;
      yv[i] = to_float(sm[c]);
      dot += gi * yv[i];
    }
  }
  dot = row_reduce<kTPR, false>(dot);
  T* dx = static_cast<T*>(p.dx) + row * K;
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    const int c = i * kTPR + lane;
    if (c < K) dx[c] = from_float<T>(yv[i] * (gv[i] - dot));
  }
}

template <typename T, int kTPR, int kNPT>
int launch(const SoftmaxDropoutParams& p, bool fwd, cudaStream_t st) {
  const long long rows_per_block = kThreads / kTPR;
  const long long blocks = (p.rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (fwd)
    softmax_dropout_fwd_kernel<T, kTPR, kNPT>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p);
  else
    softmax_dropout_bwd_kernel<T, kTPR, kNPT>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The work split of a row of K: a warp with K / 32 values a lane up to
// K = 1024, then a block of 256 threads.
template <typename T>
int dispatch(const SoftmaxDropoutParams& p, bool fwd, cudaStream_t st) {
  const int K = p.K;
  if (K <= 128) return launch<T, 32, 4>(p, fwd, st);
  if (K <= 256) return launch<T, 32, 8>(p, fwd, st);
  if (K <= 512) return launch<T, 32, 16>(p, fwd, st);
  if (K <= 1024) return launch<T, 32, 32>(p, fwd, st);
  if (K <= 2048) return launch<T, kThreads, 8>(p, fwd, st);
  if (K <= 4096) return launch<T, kThreads, 16>(p, fwd, st);
  if (K <= 8192) return launch<T, kThreads, 32>(p, fwd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int entry(const SoftmaxDropoutParams* p, int bf16, bool fwd, void* stream) {
  if (p->rows == 0) return 0;
  if (p->K <= 0 || p->Q <= 0 || p->q_blk <= 0 || p->Q % p->q_blk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(*p, fwd, st)
              : dispatch<float>(*p, fwd, st);
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 on success).
// The caller checks types, shapes and strides, and guarantees K <= 8192.
extern "C" int unicore_softmax_dropout_fwd(const SoftmaxDropoutParams* p,
                                           int bf16, void* stream) {
  return entry(p, bf16, true, stream);
}

extern "C" int unicore_softmax_dropout_bwd(const SoftmaxDropoutParams* p,
                                           int bf16, void* stream) {
  return entry(p, bf16, false, stream);
}

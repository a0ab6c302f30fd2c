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
// [1|B, 1|G, H, Q, K]), BERT's [1, B, H, T, T] (a 4-D call gets a
// leading 1) and Uni-Mol's per-batch pair bias [1, B, H, N, N].  x is
// fp32, bf16 or fp16 (a type code: SdType); mask and bias each fp32 or
// x's own type, which bounds the forward's instantiations (the caller
// widens any other type to fp32, exactly).  The forward takes all three
// types as template parameters.  out, sm, g and dx are contiguous
// [rows, K].
//
// Design.  Each row is owned by lanes of one warp when K <= 1024 and by
// one block of 256 threads up to K = 8192, its values in registers; the
// row's reductions go by warp shuffles (and shared memory across the
// block's warps).  Both passes move runs of 16 bytes on one work split
// (split below): a lane owns runs of 16 / sizeof(x) contiguous columns,
// runs lane, lane + kTPR, ... so a row's accesses are contiguous, and
// every load and store of x, out, sm, g and dx is one 16-byte access;
// the forward reads mask and bias over the same columns in their own
// types.  bf16 and fp16 share runs of 8 values and so every split.  Up
// to K = 1024 a lane owns 4 runs (32 bf16 or fp16 values: 4 lanes a row
// of 128, 32 a row of 1024), enough work to amortize the row's index
// arithmetic and reductions; the index arithmetic is 32-bit, once a row
// (row_info, RowInfo::drop).  With fewer than 32 lanes a row, several
// rows share a warp, and the reductions shuffle over the whole warp (and
// synchronize the block for a row of 256 threads): a thread past the
// last row therefore works on the last row, takes part in every
// reduction, and stores nothing.  The caller gives an operand whose
// address or strides are not multiples of 16 bytes a contiguous copy;
// the entry checks it.  The backward recomputes the forward's keep bits
// for its runs and reduces the row's dot sum_c g'[c] y[c] in fp32.
//
// Bound: bytes.  The forward reads x and writes out and sm (6 bytes an
// element in bf16 or fp16, plus the mask and bias at their own sizes);
// the backward reads g and sm and writes dx (6 bytes an element).
// Against 3.35 TB/s that is ~0.12 ms for each pass of the Evoformer
// triangle attention ([1, 256, 4, 256, 256] bf16), and 0.160 ms for the
// forward of Uni-Mol's [16, 64, 256, 256] fp16 scores with their
// same-shape bias (8 bytes an element).  The exp and the
// counter hash of each element take instruction slots the 16-byte
// accesses leave free.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
  int mask_type, bias_type;  // SdType codes: fp32 or x's type
  int dropout, q_blk;
  float inv_keep;
  uint32_t keep_thresh;
};

// The type codes of x (the entries' argument), mask and bias.
enum SdType { kF32 = 0, kBF16 = 1, kF16 = 2 };

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

// The 2-byte types' pair conversions.
template <typename H>
struct Pair16;

template <>
struct Pair16<bf16> {
  static __device__ __forceinline__ float2 to_float2(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
  static __device__ __forceinline__ uint32_t from_floats(float lo, float hi) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&b);
  }
};

template <>
struct Pair16<f16> {
  static __device__ __forceinline__ float2 to_float2(uint32_t w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
  static __device__ __forceinline__ uint32_t from_floats(float lo, float hi) {
    const __half2 b = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&b);
  }
};

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// N contiguous elements at p as floats, by 16-byte loads (one 8-byte
// load for four 2-byte values).
template <int N>
__device__ __forceinline__ void load_run(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    v[i] = x.x;
    v[i + 1] = x.y;
    v[i + 2] = x.z;
    v[i + 3] = x.w;
  }
}

template <int N, typename H>
__device__ __forceinline__ void load_run16(const H* p, float (&v)[N]) {
  static_assert(N == 4 || N % 8 == 0, "runs of 4 or of 8k 2-byte values");
  uint32_t w[N / 2];
  if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x;
    w[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; i += 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + 2 * i);
      w[i] = x.x;
      w[i + 1] = x.y;
      w[i + 2] = x.z;
      w[i + 3] = x.w;
    }
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = Pair16<H>::to_float2(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <int N>
__device__ __forceinline__ void load_run(const bf16* p, float (&v)[N]) {
  load_run16(p, v);
}

template <int N>
__device__ __forceinline__ void load_run(const f16* p, float (&v)[N]) {
  load_run16(p, v);
}

// A run of 16 bytes (4 fp32 or 8 bf16 or fp16 values) in one store, each
// value rounded to nearest once.
__device__ __forceinline__ void store_run(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename H>
__device__ __forceinline__ void store_run16(H* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = Pair16<H>::from_floats(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store_run(bf16* p, const float (&v)[8]) {
  store_run16(p, v);
}

__device__ __forceinline__ void store_run(f16* p, const float (&v)[8]) {
  store_run16(p, v);
}

// Reduce over the kTPR threads that own a row: an aligned group of a
// warp's lanes, a warp, or the block.
template <int kTPR, bool kMax>
__device__ __forceinline__ float row_reduce(float v) {
#pragma unroll
  for (int o = (kTPR < 32 ? kTPR : 32) / 2; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  if (kTPR <= 32) return v;
  __shared__ float red[kThreads / 32];
  __syncthreads();  // the previous reduction's readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) v = kMax ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

// A thread's row, of kThreads / kTPR rows a block with kTPR threads
// each: a thread past the last row works on the last row (live false),
// so that it takes part in the row's reductions, and stores nothing.
// 32-bit arithmetic once a row (rows < 2^31, checked by the entry).
struct RowInfo {
  long long base;  // row * K: the row's offset into out, sm, g and dx
  unsigned lead;   // row / Q: the row's index over (L0, L1, L2)
  unsigned r;      // row % Q
  bool live;

  // The row's dropout seed, seed + pid with pid over (lead...,
  // r / q_blk) mod 2^32, and the dropout index of its column 0,
  // (r % q_blk) * K.  The forward asks after its reductions, so that
  // the seed's load and registers do not span them.
  __device__ __forceinline__ void drop(const SoftmaxDropoutParams& p,
                                       uint32_t& seed, uint32_t& idx0) const {
    const unsigned q_blk = static_cast<unsigned>(p.q_blk);
    const unsigned rb = r / q_blk;
    seed = p.dropout ? static_cast<uint32_t>(p.seed[0]) +
                           lead * (static_cast<unsigned>(p.Q) / q_blk) + rb
                     : 0u;
    idx0 = (r - rb * q_blk) * static_cast<uint32_t>(p.K);
  }
};

template <int kTPR>
__device__ __forceinline__ RowInfo row_info(const SoftmaxDropoutParams& p) {
  RowInfo ri;
  const unsigned rows = static_cast<unsigned>(p.rows);
  const unsigned row0 = blockIdx.x * (kThreads / kTPR) + threadIdx.x / kTPR;
  ri.live = row0 < rows;
  const unsigned row = ri.live ? row0 : rows - 1;
  ri.lead = row / static_cast<unsigned>(p.Q);
  ri.r = row - ri.lead * p.Q;
  ri.base = static_cast<long long>(row) * p.K;
  return ri;
}

// The forward over runs of kV = 16 / sizeof(T) columns: each of a row's
// kTPR threads owns kNV runs, run i at columns (i * kTPR + lane) * kV.
template <typename T, typename MaskT, typename BiasT, int kTPR, int kNV>
__global__ void __launch_bounds__(kThreads)
    softmax_dropout_fwd_kernel(const SoftmaxDropoutParams p) {
  constexpr int kV = 16 / sizeof(T);
  const RowInfo ri = row_info<kTPR>(p);
  const int lane = threadIdx.x % kTPR;
  const int K = p.K;
  // (l0, l1, l2, r) of the row
  const unsigned r = ri.r;
  const unsigned t = ri.lead / static_cast<unsigned>(p.L2);
  const unsigned l2 = ri.lead - t * p.L2;
  const unsigned l0 = t / static_cast<unsigned>(p.L1);
  const unsigned l1 = t - l0 * p.L1;
  const T* x = static_cast<const T*>(p.x) + l0 * p.sx[0] + l1 * p.sx[1] +
               l2 * p.sx[2] + r * p.sx[3];
  const MaskT* mask =
      p.mask ? static_cast<const MaskT*>(p.mask) + l0 * p.smk[0] +
                   l1 * p.smk[1] + l2 * p.smk[2] + r * p.smk[3]
             : nullptr;
  const BiasT* bias = p.bias ? static_cast<const BiasT*>(p.bias) +
                                   l0 * p.sb[0] + l1 * p.sb[1] +
                                   l2 * p.sb[2] + r * p.sb[3]
                             : nullptr;

  float v[kNV][kV];  // z = x + mask + bias, then exp(z - max)
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int c = (i * kTPR + lane) * kV;
    if (c >= K) continue;
    load_run(x + c, v[i]);
    if (mask) {
      float m[kV];
      load_run(mask + c, m);
#pragma unroll
      for (int e = 0; e < kV; ++e) v[i][e] += m[e];
    }
    if (bias) {
      float bb[kV];
      load_run(bias + c, bb);
#pragma unroll
      for (int e = 0; e < kV; ++e) v[i][e] += bb[e];
    }
#pragma unroll
    for (int e = 0; e < kV; ++e) mx = fmaxf(mx, v[i][e]);
  }
  mx = row_reduce<kTPR, true>(mx);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    if ((i * kTPR + lane) * kV >= K) continue;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      v[i][e] = expf(v[i][e] - mx);
      s += v[i][e];
    }
  }
  s = row_reduce<kTPR, false>(s);
  if (!ri.live) return;
  uint32_t seed, idx0;
  ri.drop(p, seed, idx0);
  T* out = static_cast<T*>(p.out) + ri.base;
  T* sm = p.sm ? static_cast<T*>(p.sm) + ri.base : nullptr;
  const float inv_s = 1.f / s;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int c = (i * kTPR + lane) * kV;
    if (c >= K) continue;
    float y[kV], o[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      y[e] = v[i][e] * inv_s;
      o[e] = y[e];
      if (p.dropout)
        o[e] = unicore_random_bits(seed, idx0 + c + e) < p.keep_thresh
                   ? y[e] * p.inv_keep
                   : 0.f;
    }
    if (sm) store_run(sm + c, y);
    store_run(out + c, o);
  }
}

// The backward over the forward's runs and split: each of a row's kTPR
// threads reads its kNV runs of g and sm, drops and scales g by the
// forward's keep bits, and reduces the row's dot in fp32; dx = y (g' -
// dot) is rounded once to T.
template <typename T, int kTPR, int kNV>
__global__ void __launch_bounds__(kThreads)
    softmax_dropout_bwd_kernel(const SoftmaxDropoutParams p) {
  constexpr int kV = 16 / sizeof(T);
  const RowInfo ri = row_info<kTPR>(p);
  const int lane = threadIdx.x % kTPR;
  const int K = p.K;
  const T* g = static_cast<const T*>(p.g) + ri.base;
  const T* sm = static_cast<const T*>(p.sm) + ri.base;
  uint32_t seed, idx0;
  ri.drop(p, seed, idx0);
  float gv[kNV][kV], yv[kNV][kV];  // g', y
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int c = (i * kTPR + lane) * kV;
    if (c >= K) continue;
    load_run(g + c, gv[i]);
    load_run(sm + c, yv[i]);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      if (p.dropout)
        gv[i][e] = unicore_random_bits(seed, idx0 + c + e) <
                           p.keep_thresh
                       ? gv[i][e] * p.inv_keep
                       : 0.f;
      dot += gv[i][e] * yv[i][e];
    }
  }
  dot = row_reduce<kTPR, false>(dot);
  if (!ri.live) return;
  T* dx = static_cast<T*>(p.dx) + ri.base;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int c = (i * kTPR + lane) * kV;
    if (c >= K) continue;
    float d[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) d[e] = yv[i][e] * (gv[i][e] - dot);
    store_run(dx + c, d);
  }
}

// Launch `kernel` over the rows, kThreads / kTPR rows a block.
template <int kTPR>
int launch_rows(void (*kernel)(SoftmaxDropoutParams),
                const SoftmaxDropoutParams& p, cudaStream_t st) {
  const long long rows_per_block = kThreads / kTPR;
  const long long blocks = (p.rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The two passes, each launching its kernel at a split (kTPR, kNV).
template <typename T, typename MaskT, typename BiasT>
struct FwdPass {
  static constexpr int kV = 16 / sizeof(T);
  template <int kTPR, int kNV>
  static int run(const SoftmaxDropoutParams& p, cudaStream_t st) {
    return launch_rows<kTPR>(
        softmax_dropout_fwd_kernel<T, MaskT, BiasT, kTPR, kNV>, p, st);
  }
};

template <typename T>
struct BwdPass {
  static constexpr int kV = 16 / sizeof(T);
  template <int kTPR, int kNV>
  static int run(const SoftmaxDropoutParams& p, cudaStream_t st) {
    return launch_rows<kTPR>(softmax_dropout_bwd_kernel<T, kTPR, kNV>, p,
                             st);
  }
};

// The work split of a row of K = nv runs of kV columns, one for both
// passes: up to K = 1024, 4 to 32 lanes of a warp with 4 runs each (8 for
// an fp32 row of 1024), then a block of 256 threads.  Only the splits
// that a K which is a multiple of 128 can reach are instantiated.
template <class Pass>
int split(const SoftmaxDropoutParams& p, cudaStream_t st) {
  constexpr int kV = Pass::kV;
  const int nv = p.K / kV;
  if (p.K <= 1024) {
    if constexpr (kV == 8) {
      if (nv <= 16) return Pass::template run<4, 4>(p, st);
    }
    if (nv <= 32) return Pass::template run<8, 4>(p, st);
    if (nv <= 64) return Pass::template run<16, 4>(p, st);
    if (nv <= 128) return Pass::template run<32, 4>(p, st);
    if constexpr (kV == 4) return Pass::template run<32, 8>(p, st);
  }
  if constexpr (kV == 8) {
    if (nv <= 256) return Pass::template run<kThreads, 1>(p, st);
  }
  if (nv <= 512) return Pass::template run<kThreads, 2>(p, st);
  if (nv <= 1024) return Pass::template run<kThreads, 4>(p, st);
  if constexpr (kV == 4) {
    if (nv <= 2048) return Pass::template run<kThreads, 8>(p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// mask and bias are fp32 or T (entry checks it): for fp32 x, one
// instantiation.
template <typename T, typename MaskT>
int fwd_bias_type(const SoftmaxDropoutParams& p, cudaStream_t st) {
  return p.bias_type == kF32 ? split<FwdPass<T, MaskT, float>>(p, st)
                             : split<FwdPass<T, MaskT, T>>(p, st);
}

template <typename T>
int fwd(const SoftmaxDropoutParams& p, cudaStream_t st) {
  return p.mask_type == kF32 ? fwd_bias_type<T, float>(p, st)
                             : fwd_bias_type<T, T>(p, st);
}

int item_size(int type) { return type == kF32 ? 4 : 2; }

bool aligned16(const void* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
}

// What the forward's 16-byte runs assume and the caller guarantees: each
// operand's address, and its strides over (L0, L1, L2, Q), multiples of
// 16 bytes.
bool fwd_takes(const SoftmaxDropoutParams& p, int x_item) {
  const struct {
    const void* ptr;
    const long long* strides;
    int item;
  } ops[] = {{p.x, p.sx, x_item},
             {p.mask, p.smk, item_size(p.mask_type)},
             {p.bias, p.sb, item_size(p.bias_type)}};
  for (const auto& op : ops) {
    if (!aligned16(op.ptr)) return false;
    for (int d = 0; d < 4; ++d)
      if (op.ptr && (op.strides[d] * op.item) % 16 != 0) return false;
  }
  return aligned16(p.out) && aligned16(p.sm);
}

// What the backward's runs assume and the caller guarantees: g, sm and
// dx contiguous [rows, K] at addresses that are multiples of 16 bytes
// (K a multiple of 128 puts every row there too).
bool bwd_takes(const SoftmaxDropoutParams& p) {
  return aligned16(p.g) && aligned16(p.sm) && aligned16(p.dx);
}

// An operand's type: fp32, or x's own type.
bool op_type_ok(const void* op, int type, int x_type) {
  return !op || type == kF32 || type == x_type;
}

int entry(const SoftmaxDropoutParams* p, int x_type, bool forward,
          void* stream) {
  if (p->rows == 0) return 0;
  if (p->K <= 0 || p->K % 128 || p->rows >= (1LL << 31) || p->Q <= 0 ||
      p->q_blk <= 0 || p->Q % p->q_blk || x_type < kF32 || x_type > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (forward && !(op_type_ok(p->mask, p->mask_type, x_type) &&
                   op_type_ok(p->bias, p->bias_type, x_type)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(forward ? fwd_takes(*p, item_size(x_type)) : bwd_takes(*p)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (forward) {
    if (x_type == kBF16) return fwd<bf16>(*p, st);
    if (x_type == kF16) return fwd<f16>(*p, st);
    return fwd<float>(*p, st);
  }
  if (x_type == kBF16) return split<BwdPass<bf16>>(*p, st);
  if (x_type == kF16) return split<BwdPass<f16>>(*p, st);
  return split<BwdPass<float>>(*p, st);
}

}  // namespace

// Launch on `stream` for x of type `x_type` (SdType); each returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// parameters the kernels do not take (K not a multiple of 128 or above
// 8192, rows >= 2^31, an operand off 16 bytes, a type code out of range,
// a mask or bias neither fp32 nor x's type).  The caller checks types
// and shapes and gives 16-byte aligned operands.
extern "C" int unicore_softmax_dropout_fwd(const SoftmaxDropoutParams* p,
                                           int x_type, void* stream) {
  return entry(p, x_type, true, stream);
}

extern "C" int unicore_softmax_dropout_bwd(const SoftmaxDropoutParams* p,
                                           int x_type, void* stream) {
  return entry(p, x_type, false, stream);
}

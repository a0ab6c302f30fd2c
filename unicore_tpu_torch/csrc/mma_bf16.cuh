// Building blocks of the tensor-core flash kernels for Hopper (sm_90a),
// shared by flash_attention_fwd.cu (the forward) and
// flash_attention_bwd.cu (the backward), for bf16 and for fp16 operands.
//
// - mma.sync.m16n8k16 (bf16 or fp16 operands, fp32 accumulators),
//   ldmatrix and ldmatrix.trans, 16-byte cp.async with a two-stage
//   pipeline.  Both operand types are 2 bytes, so the tiles, the ldmatrix
//   loads, the fragment map and the shared memory are the same; Elem<T>
//   holds what differs: the mma instruction and the rounding of an fp32
//   pair to the operand type (round to nearest even, by the intrinsics).
// - The accumulator fragment map: lane (g = lane / 4, t = lane % 4) of a
//   warp's 16-row tile holds, for each 8-column block n, elements
//   e = 0..3 at row g + 8 (e / 2) and column 8 n + 2 t + e % 2
//   (acc_row, acc_col).  The same four values, packed as operand-type
//   pairs, are the A operand of the next product over those 16 columns.
// - 64-row tiles in shared memory with D zero-filled to 32, 64 or 128
//   plus 16 bytes of pad (row stride kD + 8), so ldmatrix's eight rows
//   fall in distinct banks.
// - The dropout bits of a tile in the REFERENCE's block geometry (geo_*
//   of FlashParams, multiples of 64): a tile draws under one seed, its
//   indices a base plus r_local * gbk + c_local (DropTile).
// - The exact skip rule of padded and causal key tiles (row_may_skip,
//   tile_padded).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_params.cuh"
#include "prng.cuh"

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kTile = 64;   // query and key rows of a tile
constexpr int kWarps = 4;   // 16 rows of the tile each
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;  // the TPU kernels' NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// D zero-filled to the width of a tile's rows: 32, 64 or 128.
__host__ __device__ constexpr int padded_head_dim(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

// Row and column of accumulator element e (0..3) of 8-column block n, for
// lane (g, t) of a warp's 16-row mma tile.
__device__ __forceinline__ int acc_row(int g, int e) {
  return g + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int n, int t, int e) {
  return n * 8 + 2 * t + (e & 1);
}

// ------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group is in flight.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// ------------------------------------------------- operand types ----

// What differs between the two operand types.  mma: c += a * b, a 16 x 16
// (row), b 16 x 8 (col), c fp32; not volatile, a pure function of its
// operands, free to be scheduled.  pair: two floats rounded to nearest
// even, lo in the low half.  kBiasType: the bias code of this type.
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  using Pair = __nv_bfloat162;
  static constexpr int kBiasType = kBiasBf16;
  static __device__ __forceinline__ Pair pair(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ bf16 zero() { return __float2bfloat16(0.f); }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Elem<f16> {
  using Pair = __half2;
  static constexpr int kBiasType = kBiasF16;
  static __device__ __forceinline__ Pair pair(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ f16 zero() { return __float2half_rn(0.f); }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  Elem<T>::mma(c, a, b0, b1);
}

// Two floats as a T pair in one register, lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const typename Elem<T>::Pair v = Elem<T>::pair(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats rounded to T at dst and dst + 1 (dst 4-byte aligned).
template <typename T>
__device__ __forceinline__ void store2(T* dst, float lo, float hi) {
  *reinterpret_cast<typename Elem<T>::Pair*>(dst) = Elem<T>::pair(lo, hi);
}

// The A fragments (rows this warp's 16; k = keys 16 kk .. 16 kk + 15) of
// accumulators s[2 kk] and s[2 kk + 1], rounded to T.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack<T>(lo[0], lo[1]);
  a[1] = pack<T>(lo[2], lo[3]);
  a[2] = pack<T>(hi[0], hi[1]);
  a[3] = pack<T>(hi[2], hi[3]);
}

// ----------------------------------------------------------- tiles ----

// Rows [row0, row0 + 64) of head h, batch row b of a [B, T, H, D] T
// tensor read by strides, into dst[64][kD + 8] by 16-byte cp.async.
template <int kD, typename T>
__device__ __forceinline__ void load_tile(T* dst, const void* src,
                                          long long sb, long long st,
                                          long long sh, int b, int h,
                                          int row0, int D) {
  const T* base = static_cast<const T*>(src) + b * sb + h * sh +
                     static_cast<long long>(row0) * st;
  const int chunks = D >> 3;
  for (int i = threadIdx.x; i < kTile * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    cp_async16(dst + r * (kD + 8) + c * 8, base + r * st + c * 8);
  }
}

// 64 consecutive 4-byte values (lse, delta or pad of a tile's rows).
__device__ __forceinline__ void load_row64(void* dst, const void* src) {
  if (threadIdx.x < 16)
    cp_async16(static_cast<char*>(dst) + 16 * threadIdx.x,
               static_cast<const char*>(src) + 16 * threadIdx.x);
}

// Zero columns [D, kD) of a tile: they enter the products over d, and
// cp.async never writes them.
template <int kD, typename T>
__device__ __forceinline__ void zero_cols(T* tile, int D) {
  const int w = kD - D;
  for (int i = threadIdx.x; i < kTile * w; i += kThreads) {
    const int r = i / w;
    tile[r * (kD + 8) + D + (i - r * w)] = Elem<T>::zero();
  }
}

// ------------------------------------------------------------ bias ----

// The bias is fp32, bf16 or fp16 (FlashParams::bias_type); its values
// enter the scores as fp32.  The kernels take the type as a template
// argument (kNoBias: no bias), so the per-element reads below fold to one
// load and one conversion.
constexpr int kNoBias = -1;

// The bias value at `at`, of type `type`, as a float.
__device__ __forceinline__ float bias_value(const char* at, int type) {
  if (type == kBiasBf16) return __bfloat162float(*reinterpret_cast<const bf16*>(at));
  if (type == kBiasF16) return __half2float(*reinterpret_cast<const f16*>(at));
  return *reinterpret_cast<const float*>(at);
}

// The bias values at `at` and the next element (`at` 2-element aligned).
__device__ __forceinline__ float2 bias_pair(const char* at, int type) {
  if (type == kBiasBf16)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
  if (type == kBiasF16)
    return __half22float2(*reinterpret_cast<const __half2*>(at));
  return *reinterpret_cast<const float2*>(at);
}

// The bias rows [q0, q0 + 64) x keys [k0, k0 + 64) of head h into
// dst[64][64 * item + 16 bytes] by 16-byte cp.async (16 bytes of pad: a
// warp's reads of a column pair, and dk/dv's transposed reads, fall in
// distinct banks).
__device__ __forceinline__ void load_bias(char* dst, const FlashParams& p,
                                          int h, int q0, int k0) {
  const int item = bias_item(p.bias_type), chunks = 4 * item;
  const int ld = kTile * item + 16;
  const char* base = static_cast<const char*>(p.bias) +
                     (h * p.sb_h + q0 * p.sb_q + k0) * item;
  for (int i = threadIdx.x; i < kTile * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    cp_async16(dst + r * ld + c * 16, base + r * p.sb_q * item + c * 16);
  }
}

// Bytes of one bias tile of `item`-byte elements staged by load_bias.
__host__ __device__ constexpr int bias_tile_bytes(int item) {
  return kTile * (kTile * item + 16);
}

// Element (r, c) of a bias tile of type `type` staged by load_bias.
__device__ __forceinline__ float bias_smem(const char* tile, int type, int r,
                                           int c) {
  const int item = bias_item(type);
  return bias_value(tile + r * (kTile * item + 16) + c * item, type);
}

// Elements (r, c) and (r, c + 1), c even, of a bias tile staged by
// load_bias.
__device__ __forceinline__ float2 bias2_smem(const char* tile, int type,
                                             int r, int c) {
  const int item = bias_item(type);
  return bias_pair(tile + r * (kTile * item + 16) + c * item, type);
}

// bias[h, r, c] and bias[h, r, c + 1], c even, of a bias of type kType.
template <int kType>
__device__ __forceinline__ float2 bias2_at(const FlashParams& p, int h, int r,
                                           int c) {
  const long long off = h * p.sb_h + r * p.sb_q + c;
  return bias_pair(static_cast<const char*>(p.bias) + off * bias_item(kType),
                   kType);
}

// --------------------------------------------------------- dropout ----

// The dropout stream of one 64 x 64 tile (q0, k0): element (rl, cl) of
// the tile is kept iff mix32(base + rl * gbk + cl + seed * golden) < thresh.
struct DropTile {
  uint32_t seedmul, base, gbk;
};

__device__ __forceinline__ DropTile drop_tile(const FlashParams& p,
                                              uint32_t seed_b, int h, int q0,
                                              int k0) {
  const int i = q0 / p.geo_bq, j = k0 / p.geo_bk;
  const uint32_t seed =
      seed_b + static_cast<uint32_t>((h * p.geo_ni + i) * p.geo_nj + j);
  return {seed * 0x9E3779B9u,
          static_cast<uint32_t>((q0 - i * p.geo_bq) * p.geo_bk +
                                (k0 - j * p.geo_bk)),
          static_cast<uint32_t>(p.geo_bk)};
}

__device__ __forceinline__ bool kept(const FlashParams& p, const DropTile& d,
                                     int rl, int cl) {
  return unicore_mix32(d.base + static_cast<uint32_t>(rl) * d.gbk +
                       static_cast<uint32_t>(cl) + d.seedmul) < p.keep_thresh;
}

// ----------------------------------------------------------- skips ----

// Whether a skip is exact in batch row b: every query admits an unpadded
// key (non-causal: some key is unpadded; causal: key 0 is).  A query
// whose admitted keys are all padded scores -1e30 on each of them and
// gets p = 1 there (the reference's arithmetic), so its row skips
// nothing.  Uniform over the warp.
__device__ inline bool row_may_skip(const FlashParams& p, int b) {
  if (p.pad == nullptr) return true;
  const int* row = p.pad + static_cast<long long>(b) * p.Tk;
  if (p.causal) return row[0] <= 0;
  bool any = false;
  for (int c = threadIdx.x & 31; c < p.Tk; c += 32) any |= row[c] <= 0;
  return __any_sync(kFull, any);
}

// Whether keys [k0, k0 + 64) of batch row b are all padded.  Uniform over
// the warp.
__device__ __forceinline__ bool tile_padded(const FlashParams& p, int b,
                                            int k0) {
  if (p.pad == nullptr) return false;
  const int* row = p.pad + static_cast<long long>(b) * p.Tk + k0;
  const int lane = threadIdx.x & 31;
  return __all_sync(kFull, row[lane] > 0 && row[lane + 32] > 0);
}

// Whether key tile k0 adds exactly nothing to query tile q0 of batch row
// b: all padded, or under causal wholly above the diagonal, in a row
// where skips are exact (may_skip).
__device__ __forceinline__ bool tile_skipped(const FlashParams& p,
                                             bool may_skip, int b, int q0,
                                             int k0) {
  if (!may_skip) return false;
  if (p.causal && k0 > q0) return true;
  return tile_padded(p, b, k0);
}

// ---------------------------------------------------------- checks ----

__host__ inline bool aligned16(const void* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
}

// What every tensor-core flash kernel assumes and the caller guarantees:
// 16-byte aligned tiles, strides of whole 16-byte chunks, D <= 128 in
// steps of 8, 64-row tiles that divide T and the reference's blocks.
__host__ inline bool takes_tiles(const FlashParams& p) {
  const long long strides[] = {p.sq_b, p.sq_t, p.sq_h, p.sk_b, p.sk_t, p.sk_h,
                               p.sv_b, p.sv_t, p.sv_h, p.sd_b, p.sd_t, p.sd_h};
  for (long long s : strides)
    if (s % 8 != 0) return false;
  const void* tiles[] = {p.q,   p.k,     p.v,   p.dout,
                         p.lse, p.delta, p.pad, p.bias};
  for (const void* x : tiles)
    if (!aligned16(x)) return false;
  const int bias_step = 16 / bias_item(p.bias_type);  // elements of 16 B
  if (p.bias && (p.sb_q % bias_step != 0 || p.sb_h % bias_step != 0))
    return false;
  return p.D >= 8 && p.D <= 128 && p.D % 8 == 0 && p.Tq % kTile == 0 &&
         p.Tk % kTile == 0 && p.geo_bq > 0 && p.geo_bq % kTile == 0 &&
         p.geo_bk > 0 && p.geo_bk % kTile == 0;
}

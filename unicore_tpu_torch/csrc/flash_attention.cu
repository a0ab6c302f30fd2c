// Flash attention forward and backward for fp32 operands, fp32 math on
// the CUDA cores, for Hopper (sm_90a).
//
// Replaces, for fp32 operands, the Pallas TPU kernels of
// unicore_tpu/ops/pallas/flash_attention.py: the forward (_fwd_hb_kernel,
// single block, and _fwd_kernel, multi-block) and the backward
// (_bwd_hb_kernel, fused single block; _joint_bwd_kernel, _dq_kernel,
// _dkv_kernel and _dbias_kernel, multi-block).  bf16 operands, the
// training path, take the tensor cores: flash_attention_fwd.cu and
// flash_attention_bwd.cu.  For batch row b, head h, query r and key c
//
//   s[r,c]  = scale * <q[b,r,h,:], k[b,c,h,:]> + bias[h,r,c]
//             + (pad[b,c] > 0 ? -1e30 : 0) + (causal && c > r ? -1e30 : 0)
//   p[r,c]  = exp(s[r,c] - m[r]),  l[r] = sum_c p[r,c]  (undropped)
//   out[r]  = sum_c keep[r,c] / keep_prob * p[r,c] v[c] / l[r]
//   lse[r]  = m[r] + log(l[r])      (l == 0 taken as 1)
//
// The pad is added, not set: a query whose keys are all padded gets the
// uniform average over V.  Dropout bits are those of the TPU kernels
// (prng.cuh): element (r, c) of head h draws under seed
// seed[b] + (h * n_i + i) * n_j + j at index (r % gbq) * gbk + c % gbk,
// with i = r / gbq, j = c / gbk, where (gbq, gbk) is the REFERENCE's block
// geometry (its _pick_blocks, passed in as geo_*), not this kernel's tiles.
// The backward recomputes s and p from lse, masks and scales dP as the
// forward masked p, and forms dS = p * (dP - delta) with the undropped p,
// delta = rowsum(dO * O) computed by the caller.
//
// Layouts: q, k, v and dO are [B, T, H, D] read by strides (the last dim
// contiguous), so the module's fused-QKV view needs no copy; out, dq, dk,
// dv are contiguous [B, T, H, D]; lse and delta [B, H, Tq] fp32; bias
// [1, 1|H, 1|Tq, Tk] (fp32, bf16 or fp16) by strides, 0 on a broadcast
// dim; pad
// [B, Tk] int32; seed [B] int32; dbias [H, Tq, Tk] fp32, summed over the
// batch in a fixed order (no atomics).  Operands, math and outputs are
// fp32 (the kernels are templated on the operand type; only float is
// instantiated).
//
// Design: four kernels over 64 x 64 tiles staged in shared memory, 256
// threads, each thread owning a 4 x 4 block of the score tile and a
// 4 x (D / 16) block of the accumulator, fp32 FMA on the CUDA cores.
//   flash_fwd:   one block per (query tile, h, b), a loop over key tiles
//                with an online softmax (m, l, acc).
//   flash_dkdv:  one block per (key tile, h, b), a loop over query tiles.
//   flash_dq:    one block per (query tile, h, b), a loop over key tiles.
//   flash_dbias: one block per (key tile, query tile, h), a loop over b.
//
// Bound: arithmetic.  At the BERT shapes (T = 512, D = 64) the forward
// needs 4 B H T^2 D flops and the backward 10 B H T^2 D (this design does
// 18: dq and dbias recompute s and dP), against 67 TFLOP/s of fp32 on the
// CUDA cores (TF32 tensor cores would change what fp32 means).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_params.cuh"
#include "prng.cuh"

namespace {

constexpr int kBQ = 64;  // query rows of a tile
constexpr int kBK = 64;  // key rows of a tile
constexpr int kThreads = 256;
constexpr int kLdS = kBK + 1;  // padded row of a score tile in smem
constexpr float kNeg = -1e30f;  // the TPU kernels' NEG_INF
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

// Rows [row0, row0 + kBQ) of head h, batch row b of a [B, T, H, D]
// tensor read by strides, into dst[kBQ][ld] as float.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const void* src,
                                          long long sb, long long st,
                                          long long sh, int b, int h,
                                          int row0, int D, int ld) {
  const T* base = static_cast<const T*>(src) + b * sb + h * sh;
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = to_float(base[static_cast<long long>(row0 + r) * st + d]);
  }
}

__device__ __forceinline__ float bias_at(const FlashParams& p, int h, int r,
                                         int c) {
  const long long off = h * p.sb_h + r * p.sb_q + c;
  if (p.bias_type == kBiasBf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[off]);
  if (p.bias_type == kBiasF16)
    return __half2float(static_cast<const __half*>(p.bias)[off]);
  return static_cast<const float*>(p.bias)[off];
}

// The scaled dot product of (r, c) plus bias, pad and causal terms, added
// in the TPU kernels' order.
__device__ __forceinline__ float adjust(const FlashParams& p, float dot, int b,
                                        int h, int r, int c) {
  float s = dot * p.scale;
  if (p.bias) s += bias_at(p, h, r, c);
  if (p.pad && p.pad[static_cast<long long>(b) * p.Tk + c] > 0) s += kNeg;
  if (p.causal && c > r) s += kNeg;
  return s;
}

__device__ __forceinline__ bool keep_at(const FlashParams& p, uint32_t seed_b,
                                        int h, int r, int c) {
  const int i = r / p.geo_bq, j = c / p.geo_bk;
  const uint32_t seed =
      seed_b + static_cast<uint32_t>((h * p.geo_ni + i) * p.geo_nj + j);
  const uint32_t idx =
      static_cast<uint32_t>((r - i * p.geo_bq) * p.geo_bk + (c - j * p.geo_bk));
  return unicore_random_bits(seed, idx) < p.keep_thresh;
}

// s[i][j] = <a[ty + 16 i], b[tx + 16 j]> and, when b2 is given,
// g[i][j] = <a2[ty + 16 i], b2[tx + 16 j]>, over smem rows of stride ld.
__device__ __forceinline__ void tile_dots(const float* a, const float* bm,
                                          const float* a2, const float* b2,
                                          int D, int ld, int tx, int ty,
                                          float (&s)[4][4], float (&g)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = g[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = bm[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
    if (a2 != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = a2[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = b2[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = fmaf(x[i], y[j], g[i][j]);
    }
  }
}

// dS (and the dropped p, when p_out is given) of one 64 x 64 tile: rows
// q0 + ty + 16 i, columns k0 + tx + 16 j, written to smem [kBQ][kLdS].
__device__ __forceinline__ void tile_ds(const FlashParams& p, int b, int h,
                                        int q0, int k0, uint32_t seed_b,
                                        const float (&s)[4][4],
                                        const float (&dp)[4][4],
                                        const float* lse_s, const float* dl_s,
                                        int tx, int ty, float* ds_out,
                                        float* p_out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = tx + 16 * j;
      const float pr = expf(adjust(p, s[i][j], b, h, q0 + rl, k0 + cl) - lse_s[rl]);
      float pd = pr, g = dp[i][j];
      if (p.dropout) {
        const bool keep = keep_at(p, seed_b, h, q0 + rl, k0 + cl);
        pd = keep ? pr * p.inv_keep : 0.f;
        g = keep ? g * p.inv_keep : 0.f;
      }
      ds_out[rl * kLdS + cl] = pr * (g - dl_s[rl]);
      if (p_out != nullptr) p_out[rl * kLdS + cl] = pd;
    }
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashParams p) {
  constexpr int kJ = kD / 16;
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D, ld = D + 1;
  float* q_s = smem;               // [kBQ][ld]
  float* k_s = q_s + kBQ * ld;     // [kBK][ld]
  float* v_s = k_s + kBK * ld;     // [kBK][ld]
  float* s_s = v_s + kBK * ld;     // [kBQ][kLdS]: scores, then dropped p
  float* m_s = s_s + kBQ * kLdS;   // [kBQ] running max
  float* l_s = m_s + kBQ;          // [kBQ] running sum of undropped p
  float* c_s = l_s + kBQ;          // [kBQ] this tile's rescale
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int srow = tid >> 2, squart = tid & 3;  // softmax: 4 lanes a row
  const uint32_t seed_b = p.dropout ? static_cast<uint32_t>(p.seed[b]) : 0u;

  load_rows<T>(q_s, p.q, p.sq_b, p.sq_t, p.sq_h, b, h, q0, D, ld);
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) acc[i][jj] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += kBK) {
    __syncthreads();  // q_s and the stats are written; the last tile is used
    load_rows<T>(k_s, p.k, p.sk_b, p.sk_t, p.sk_h, b, h, k0, D, ld);
    load_rows<T>(v_s, p.v, p.sv_b, p.sv_t, p.sv_h, b, h, k0, D, ld);
    __syncthreads();
    float s[4][4], unused[4][4];
    tile_dots(q_s, k_s, nullptr, nullptr, D, ld, tx, ty, s, unused);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s_s[(ty + 16 * i) * kLdS + tx + 16 * j] =
            adjust(p, s[i][j], b, h, q0 + ty + 16 * i, k0 + tx + 16 * j);
    __syncthreads();
    {
      float* row = s_s + srow * kLdS + squart * 16;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_old = m_s[srow];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float e = expf(row[c] - m_new);
        sum += e;  // l sums the undropped p
        if (p.dropout)
          e = keep_at(p, seed_b, h, q0 + srow, k0 + squart * 16 + c)
                  ? e * p.inv_keep
                  : 0.f;
        row[c] = e;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const float corr = expf(m_old - m_new);
      __syncwarp();  // the row's 4 lanes have read m_s before it changes
      if (squart == 0) {
        m_s[srow] = m_new;
        l_s[srow] = l_s[srow] * corr + sum;
        c_s[srow] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) acc[i][jj] *= corr;
    }
    for (int c = 0; c < kBK; ++c) {
      float pc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pc[i] = s_s[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int d = tx + 16 * jj;
        const float vv = d < D ? v_s[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pc[i], vv, acc[i][jj]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty + 16 * i, r = q0 + rl;
    const float l = l_s[rl];
    const float l_safe = l == 0.f ? 1.f : l;
    T* o = static_cast<T*>(p.out) +
           (static_cast<long long>(b * p.Tq + r) * p.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) o[d] = from_float<T>(acc[i][jj] / l_safe);
    }
    if (tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Tq + r] =
          m_s[rl] + logf(l_safe);
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) flash_dkdv_kernel(const FlashParams p) {
  constexpr int kJ = kD / 16;
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D, ld = D + 1;
  float* k_s = smem;                // [kBK][ld]
  float* v_s = k_s + kBK * ld;      // [kBK][ld]
  float* q_s = v_s + kBK * ld;      // [kBQ][ld]
  float* do_s = q_s + kBQ * ld;     // [kBQ][ld]
  float* p_s = do_s + kBQ * ld;     // [kBQ][kLdS] dropped p
  float* ds_s = p_s + kBQ * kLdS;   // [kBQ][kLdS] dS
  float* lse_s = ds_s + kBQ * kLdS; // [kBQ]
  float* dl_s = lse_s + kBQ;        // [kBQ]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const uint32_t seed_b = p.dropout ? static_cast<uint32_t>(p.seed[b]) : 0u;
  const long long row_bh = (static_cast<long long>(b) * p.H + h) * p.Tq;

  load_rows<T>(k_s, p.k, p.sk_b, p.sk_t, p.sk_h, b, h, k0, D, ld);
  load_rows<T>(v_s, p.v, p.sv_b, p.sv_t, p.sv_h, b, h, k0, D, ld);
  float dk[4][kJ], dv[4][kJ];  // rows: key k0 + ty + 16 i; cols d
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  for (int q0 = 0; q0 < p.Tq; q0 += kBQ) {
    __syncthreads();
    load_rows<T>(q_s, p.q, p.sq_b, p.sq_t, p.sq_h, b, h, q0, D, ld);
    load_rows<T>(do_s, p.dout, p.sd_b, p.sd_t, p.sd_h, b, h, q0, D, ld);
    if (tid < kBQ) {
      lse_s[tid] = p.lse[row_bh + q0 + tid];
      dl_s[tid] = p.delta[row_bh + q0 + tid];
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots(q_s, k_s, do_s, v_s, D, ld, tx, ty, s, dp);
    tile_ds(p, b, h, q0, k0, seed_b, s, dp, lse_s, dl_s, tx, ty, ds_s, p_s);
    __syncthreads();
    for (int r = 0; r < kBQ; ++r) {
      float pc[4], dc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pc[i] = p_s[r * kLdS + ty + 16 * i];
        dc[i] = ds_s[r * kLdS + ty + 16 * i];
      }
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int d = tx + 16 * jj;
        const float g = d < D ? do_s[r * ld + d] : 0.f;
        const float x = d < D ? q_s[r * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][jj] = fmaf(pc[i], g, dv[i][jj]);
          dk[i][jj] = fmaf(dc[i], x, dk[i][jj]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long off =
        (static_cast<long long>(b * p.Tk + k0 + ty + 16 * i) * p.H + h) * D;
    T* dko = static_cast<T*>(p.dk) + off;
    T* dvo = static_cast<T*>(p.dv) + off;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) {
        dko[d] = from_float<T>(dk[i][jj] * p.scale);
        dvo[d] = from_float<T>(dv[i][jj]);
      }
    }
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const FlashParams p) {
  constexpr int kJ = kD / 16;
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D, ld = D + 1;
  float* q_s = smem;                // [kBQ][ld]
  float* do_s = q_s + kBQ * ld;     // [kBQ][ld]
  float* k_s = do_s + kBQ * ld;     // [kBK][ld]
  float* v_s = k_s + kBK * ld;      // [kBK][ld]
  float* ds_s = v_s + kBK * ld;     // [kBQ][kLdS]
  float* lse_s = ds_s + kBQ * kLdS; // [kBQ]
  float* dl_s = lse_s + kBQ;        // [kBQ]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const uint32_t seed_b = p.dropout ? static_cast<uint32_t>(p.seed[b]) : 0u;
  const long long row_bh = (static_cast<long long>(b) * p.H + h) * p.Tq;

  load_rows<T>(q_s, p.q, p.sq_b, p.sq_t, p.sq_h, b, h, q0, D, ld);
  load_rows<T>(do_s, p.dout, p.sd_b, p.sd_t, p.sd_h, b, h, q0, D, ld);
  if (tid < kBQ) {
    lse_s[tid] = p.lse[row_bh + q0 + tid];
    dl_s[tid] = p.delta[row_bh + q0 + tid];
  }
  float dq[4][kJ];  // rows: query q0 + ty + 16 i; cols d
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) dq[i][jj] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += kBK) {
    __syncthreads();
    load_rows<T>(k_s, p.k, p.sk_b, p.sk_t, p.sk_h, b, h, k0, D, ld);
    load_rows<T>(v_s, p.v, p.sv_b, p.sv_t, p.sv_h, b, h, k0, D, ld);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots(q_s, k_s, do_s, v_s, D, ld, tx, ty, s, dp);
    tile_ds(p, b, h, q0, k0, seed_b, s, dp, lse_s, dl_s, tx, ty, ds_s, nullptr);
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      float dc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dc[i] = ds_s[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int d = tx + 16 * jj;
        const float x = d < D ? k_s[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][jj] = fmaf(dc[i], x, dq[i][jj]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* o = static_cast<T*>(p.dq) +
           (static_cast<long long>(b * p.Tq + q0 + ty + 16 * i) * p.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) o[d] = from_float<T>(dq[i][jj] * p.scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dbias_kernel(const FlashParams p) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * kBK, q0 = blockIdx.y * kBQ, h = blockIdx.z;
  const int D = p.D, ld = D + 1;
  float* q_s = smem;                // [kBQ][ld]
  float* do_s = q_s + kBQ * ld;     // [kBQ][ld]
  float* k_s = do_s + kBQ * ld;     // [kBK][ld]
  float* v_s = k_s + kBK * ld;      // [kBK][ld]
  float* ds_s = v_s + kBK * ld;     // [kBQ][kLdS]
  float* lse_s = ds_s + kBQ * kLdS; // [kBQ]
  float* dl_s = lse_s + kBQ;        // [kBQ]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int b = 0; b < p.B; ++b) {  // fixed order: deterministic
    const long long row_bh = (static_cast<long long>(b) * p.H + h) * p.Tq;
    __syncthreads();
    load_rows<T>(q_s, p.q, p.sq_b, p.sq_t, p.sq_h, b, h, q0, D, ld);
    load_rows<T>(do_s, p.dout, p.sd_b, p.sd_t, p.sd_h, b, h, q0, D, ld);
    load_rows<T>(k_s, p.k, p.sk_b, p.sk_t, p.sk_h, b, h, k0, D, ld);
    load_rows<T>(v_s, p.v, p.sv_b, p.sv_t, p.sv_h, b, h, k0, D, ld);
    if (tid < kBQ) {
      lse_s[tid] = p.lse[row_bh + q0 + tid];
      dl_s[tid] = p.delta[row_bh + q0 + tid];
    }
    __syncthreads();
    const uint32_t seed_b = p.dropout ? static_cast<uint32_t>(p.seed[b]) : 0u;
    float s[4][4], dp[4][4];
    tile_dots(q_s, k_s, do_s, v_s, D, ld, tx, ty, s, dp);
    tile_ds(p, b, h, q0, k0, seed_b, s, dp, lse_s, dl_s, tx, ty, ds_s, nullptr);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += ds_s[(ty + 16 * i) * kLdS + tx + 16 * j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* o = p.dbias +
               (static_cast<long long>(h) * p.Tq + q0 + ty + 16 * i) * p.Tk + k0;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[tx + 16 * j] = acc[i][j];
  }
}

// Shared memory of each kernel, in floats.
inline size_t fwd_smem(int D) {
  return static_cast<size_t>(kBQ + 2 * kBK) * (D + 1) + kBQ * kLdS + 3 * kBQ;
}
inline size_t dkdv_smem(int D) {
  return static_cast<size_t>(kBQ + kBK) * 2 * (D + 1) + 2 * kBQ * kLdS + 2 * kBQ;
}
inline size_t dq_smem(int D) {
  return static_cast<size_t>(kBQ + kBK) * 2 * (D + 1) + kBQ * kLdS + 2 * kBQ;
}

inline int launch_kernel(void (*kernel)(FlashParams), dim3 grid,
                         size_t smem_floats, const FlashParams& p,
                         cudaStream_t stream) {
  return flash_launch(kernel, grid, kThreads, smem_floats * sizeof(float), p,
                      stream);
}

template <typename T, int kD>
int fwd(const FlashParams& p, cudaStream_t st) {
  return launch_kernel(flash_fwd_kernel<T, kD>, dim3(p.Tq / kBQ, p.H, p.B),
                fwd_smem(p.D), p, st);
}

template <typename T, int kD>
int dkdv(const FlashParams& p, cudaStream_t st) {
  return launch_kernel(flash_dkdv_kernel<T, kD>, dim3(p.Tk / kBK, p.H, p.B),
                dkdv_smem(p.D), p, st);
}

template <typename T, int kD>
int dq(const FlashParams& p, cudaStream_t st) {
  return launch_kernel(flash_dq_kernel<T, kD>, dim3(p.Tq / kBQ, p.H, p.B),
                dq_smem(p.D), p, st);
}

template <typename T, int kD>
int dbias(const FlashParams& p, cudaStream_t st) {
  return launch_kernel(flash_dbias_kernel<T>, dim3(p.Tk / kBK, p.Tq / kBQ, p.H),
                dq_smem(p.D), p, st);
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 on success).
// The caller checks types, shapes and strides, and guarantees fp32
// operands, Tq and Tk multiples of 64 and 8 <= D <= 128 with D % 8 == 0.
#define UNICORE_FLASH_ENTRY(NAME)                                            \
  extern "C" int unicore_flash_##NAME(const FlashParams* p, void* stream) {  \
    if (p->B == 0 || p->H == 0 || p->Tq == 0 || p->Tk == 0) return 0;        \
    if (p->D <= 0 || p->D > 128)                                             \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    return p->D <= 64 ? NAME<float, 64>(*p, st) : NAME<float, 128>(*p, st);  \
  }

UNICORE_FLASH_ENTRY(fwd)
UNICORE_FLASH_ENTRY(dkdv)
UNICORE_FLASH_ENTRY(dq)
UNICORE_FLASH_ENTRY(dbias)

// Ragged paged attention over a paged KV pool, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel unicore_tpu/ops/pallas/paged_attention.py
// (_kernel, reached through ragged_paged_attention).  It computes the same
// function, not the same blocks: for each batch row b, head h and query t
//
//   out[b,t,h,:] = sum_c p[c] v[c] / sum_c p[c],
//   p[c] = exp(s[c] - max s),  s[c] = scale * <q[b,t,h,:], k[c,h,:]>,
//
// over the admitted columns c (c <= positions[b,t] and c < lengths[b]),
// where column c of row b lives in pool slot
// page_table[b, c / page_size] * page_size + c % page_size.  A query with no
// admitted column (position -1, or a row with length 0) comes out 0.
//
// Layouts (all contiguous): q and out [B, T, H, D]; k_pool and v_pool
// [num_slots, H, D]; page_table [B, P]; positions [B, T]; lengths [B]; the
// index arrays are int32.
//
// Design.  One block per (head, row); the block walks the row's columns in
// tiles of kTile = 32 (one lane per column), stages the tile's K and V rows
// of head h into shared memory, and folds them into an fp32 online softmax
// (m, l, acc) per query: one warp per query, lanes over the columns for the
// scores and over D for the accumulator.  A block handles up to
// kQPerPass = 32 queries per pass and walks the pages once per pass.
//
// Bound: memory.  Each row's admitted K and V columns are read once per
// pass (T <= 32 on the serve path, so once), the gathered [B, S, H, D]
// copy the plain version makes never exists, and the walk stops at the
// row's last admitted column.  Staging with cp.async/TMA and splitting long
// rows across blocks are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;            // key columns per staged tile
constexpr int kQPerWarp = 4;         // queries a warp carries per pass
constexpr int kQPerPass = kWarps * kQPerWarp;
constexpr int kMaxD = 256;
constexpr int kDPerLane = kMaxD / 32;
constexpr float kNeg = -1e30f;       // finite mask fill, as the TPU kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int* __restrict__ page_table,
                       const int* __restrict__ positions,
                       const int* __restrict__ lengths,
                       float* __restrict__ out,
                       int T, int H, int D, int P, int page_size,
                       float scale) {
  extern __shared__ float4 smem4[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d4n = D >> 2;
  const int ld = D + 4;  // padded tile row: float4 reads stay conflict-free
  float* q_s = reinterpret_cast<float*>(smem4);   // [kQPerPass, D]
  float* k_s = q_s + kQPerPass * D;               // [kTile, ld]
  float* v_s = k_s + kTile * ld;                  // [kTile, ld]
  const int length = lengths[b];
  const int* table = page_table + static_cast<size_t>(b) * P;

  for (int t0 = 0; t0 < T; t0 += kQPerPass) {
    const int nq = min(kQPerPass, T - t0);
    __syncthreads();  // the previous pass is done with q_s, k_s, v_s
    for (int i = threadIdx.x; i < nq * d4n; i += kThreads) {
      const int tq = i / d4n, d4 = i - tq * d4n;
      float4 x = reinterpret_cast<const float4*>(
          q + (static_cast<size_t>(b * T + t0 + tq) * H + h) * D)[d4];
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
      reinterpret_cast<float4*>(q_s + tq * D)[d4] = x;
    }
    // The walk ends at the last column any query of this pass admits, so
    // no table entry at or past cdiv(length, page_size) is ever read.
    // Every thread computes the same bound: the loops below stay uniform.
    int max_pos = -1;
    for (int i = 0; i < nq; ++i) max_pos = max(max_pos, positions[b * T + t0 + i]);
    const int n_cols = min(length, max_pos + 1);

    int pos[kQPerWarp];
    float m[kQPerWarp], l[kQPerWarp], acc[kQPerWarp][kDPerLane];
#pragma unroll
    for (int qi = 0; qi < kQPerWarp; ++qi) {
      const int tq = warp + qi * kWarps;
      pos[qi] = tq < nq ? positions[b * T + t0 + tq] : -1;
      m[qi] = kNeg;
      l[qi] = 0.f;
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) acc[qi][i] = 0.f;
    }

    for (int c0 = 0; c0 < n_cols; c0 += kTile) {
      __syncthreads();  // q_s is written; the previous tile is consumed
      for (int i = threadIdx.x; i < kTile * d4n; i += kThreads) {
        const int j = i / d4n, d4 = i - j * d4n;
        const int c = c0 + j;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (c < n_cols) {
          const int page = table[c / page_size];
          const size_t row =
              (static_cast<size_t>(page) * page_size + c % page_size) * H + h;
          kx = reinterpret_cast<const float4*>(k_pool + row * D)[d4];
          vx = reinterpret_cast<const float4*>(v_pool + row * D)[d4];
        }
        reinterpret_cast<float4*>(k_s + j * ld)[d4] = kx;
        reinterpret_cast<float4*>(v_s + j * ld)[d4] = vx;
      }
      __syncthreads();

#pragma unroll
      for (int qi = 0; qi < kQPerWarp; ++qi) {
        if (pos[qi] < c0) continue;  // warp-uniform: nothing admitted here
        const int c = c0 + lane;
        // c < n_cols <= length: the unwritten tail stays out, as in the
        // plain version
        const bool valid = c <= pos[qi] && c < n_cols;
        float s = kNeg;
        if (valid) {
          const float4* qv =
              reinterpret_cast<const float4*>(q_s + (warp + qi * kWarps) * D);
          const float4* kv = reinterpret_cast<const float4*>(k_s + lane * ld);
          float dot = 0.f;
          for (int d4 = 0; d4 < d4n; ++d4) {
            const float4 a = qv[d4], k4 = kv[d4];
            dot = fmaf(a.x, k4.x, dot);
            dot = fmaf(a.y, k4.y, dot);
            dot = fmaf(a.z, k4.z, dot);
            dot = fmaf(a.w, k4.w, dot);
          }
          s = dot;
        }
        const float m_new = fmaxf(m[qi], warp_max(s));
        // A query whose admitted columns all lie in later tiles has
        // m_new == s == kNeg here: exp(s - m_new) would admit every masked
        // column, so masked columns get p = 0 explicitly.
        const float p = valid ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[qi] - m_new);
        l[qi] = l[qi] * alpha + warp_sum(p);
#pragma unroll
        for (int i = 0; i < kDPerLane; ++i) acc[qi][i] *= alpha;
        for (int j = 0; j < kTile; ++j) {
          const float pj = __shfl_sync(kFull, p, j);
          const float* vrow = v_s + j * ld;
#pragma unroll
          for (int i = 0; i < kDPerLane; ++i) {
            const int d = lane + 32 * i;
            if (d < D) acc[qi][i] = fmaf(pj, vrow[d], acc[qi][i]);
          }
        }
        m[qi] = m_new;
      }
    }

#pragma unroll
    for (int qi = 0; qi < kQPerWarp; ++qi) {
      const int tq = warp + qi * kWarps;
      if (tq >= nq) continue;
      // Inactive queries never accumulate: 0 / 1e-30 keeps them finite.
      const float inv = 1.f / fmaxf(l[qi], 1e-30f);
      float* o = out + (static_cast<size_t>(b * T + t0 + tq) * H + h) * D;
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) o[d] = acc[qi][i] * inv;
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller validates shapes, types, contiguity and 16-byte alignment, and
// guarantees D % 4 == 0, D <= 256.
extern "C" int unicore_paged_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int* page_table, const int* positions, const int* lengths,
    float* out, int B, int T, int H, int D, int P, int page_size,
    float scale, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kQPerPass) * D + 2 * kTile * (D + 4));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_attention_kernel<<<dim3(H, B), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      q, k_pool, v_pool, page_table, positions, lengths, out, T, H, D, P,
      page_size, scale);
  return static_cast<int>(cudaGetLastError());
}

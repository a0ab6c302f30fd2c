// Ragged paged attention over a paged KV pool, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel unicore_tpu/ops/pallas/paged_attention.py
// (_kernel, reached through ragged_paged_attention and, at T == 1,
// ragged_decode_attention).  It computes the same function, not the same
// blocks: for each batch row b, head h and query t
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
// Bound: bytes.  A call must read each row's admitted K and V columns once
// (the first min(len, max_t pos + 1) of the row, 2 * H * D * 4 bytes a
// column), q and the index arrays, and write out; two fp32 dot products per
// admitted (query, column) pair are far below the fp32 rate.
//
// Design.
// - Split-KV.  The grid is (split, head, row): each row's table columns are
//   cut into `splits` ranges of `split_cols` (the wrapper's split_plan, from
//   host-known shapes alone, so no launch waits on lengths or positions).
//   Every block finds its row's last admitted column n_cols itself; a block
//   whose range starts at or past it exits at once.  Long rows so spread
//   over several SMs instead of one block walking them in series.
// - One launch, a fixed combine order.  A row with one active split writes
//   out directly.  Otherwise each active split writes its partial
//   (m, l, unnormalized acc) per query to a workspace, takes a ticket from
//   the (row, head)'s counter, and the last to arrive merges the partials in
//   split order and resets the counter: the result does not depend on which
//   block came last, and two calls give the same bits.  A partial with no
//   admitted column (l == 0) is left out explicitly: exp(m - M) is 1 when
//   both are -1e30.  Not a cluster: there every split would stay resident
//   until the cluster's merge, and most splits of a ragged batch are empty.
// - K and V arrive by 16-byte cp.async into a ring of stages (3 at decode,
//   2 in a chunk), the next tiles' copies in flight while one is computed.
//   Each copy is 4 floats of one slot's head row, its address taken from
//   the page table; columns past the split's end are zero-filled and read
//   nothing, so no table entry at or past cdiv(n_cols, page_size) is read.
// - Decode (T == 1): the 8 warps take disjoint columns of each 32-column
//   tile, 4 a warp, 8 lanes a column over D; each 8-lane group keeps its
//   own online softmax (m, l, acc over its slice of D) and the 32 streams
//   merge at the end, in the warp's registers and then across warps in
//   shared memory.  No warp waits idle for a query.
// - Chunk (T > 1): a warp carries 4 queries; each lane scores 4 queries x
//   (64-column tile: 2, else 1) columns from shared memory, so one 16-byte
//   load of k feeds 16 FMAs per query group; p goes through shared memory
//   as one float4 per column for the warp's 4 queries, and P.V runs with
//   lanes over D in float2, each v load feeding 8 FMAs.  Up to 32 queries a
//   pass; a warp skips a tile none of its queries admits.
// - Head dim.  Templated on a bucket kD (64, 128, 256) that sizes the
//   registers; every D % 4 == 0 up to 256 runs, D = 64 pays for 64.
// - fp32 FMA and expf throughout: no TF32 and no tensor cores.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQPerWarp = 4;                   // chunk: queries a warp carries
constexpr int kQPerPass = kWarps * kQPerWarp;  // chunk: queries a pass
constexpr int kDecodeTile = 32;                // decode: columns a tile
constexpr int kDecodeStages = 3;
constexpr int kChunkStages = 2;
constexpr float kNeg = -1e30f;                 // finite mask fill, as the TPU kernel
constexpr unsigned kFull = 0xffffffffu;

// ctypes passes these once; the kernels take them by value
struct Params {
  const float* q;
  const float* k_pool;
  const float* v_pool;
  const int* page_table;
  const int* positions;
  const int* lengths;
  float* out;
  float* ws;      // [B, H, splits, T, D] acc, then [B, H, splits, T, 2] (m, l)
  int* tickets;   // [B * H], 0 between calls
  int B, T, H, D, P, page_size, splits, split_cols;
  float scale;
};

template <int kD>
__host__ __device__ constexpr int chunk_tile() { return kD <= 64 ? 64 : 32; }

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

// 16 bytes from global to shared, bypassing L1; src_bytes == 0 reads
// nothing and fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                     fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// The row's admitted columns end at min(len, max_t pos + 1, P * page_size):
// every thread of the block gets the same value.  The cap keeps a row
// whose lengths or positions run past its table inside the plan's splits,
// so its (row, head) still merges and its ticket goes back to 0.
__device__ int row_cols(const Params& p, int b) {
  __shared__ int red[kWarps];
  int mp = -1;
  for (int t = threadIdx.x; t < p.T; t += kThreads)
    mp = max(mp, p.positions[b * p.T + t]);
  mp = __reduce_max_sync(kFull, mp);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mp;
  __syncthreads();
  mp = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mp = max(mp, red[w]);
  return max(0, min(min(p.lengths[b], mp + 1), p.P * p.page_size));
}

// Split 0 of a row that admits nothing writes its zeros.
__device__ void write_zeros(const Params& p, int b, int h) {
  const int d4n = p.D >> 2;
  for (int i = threadIdx.x; i < p.T * d4n; i += kThreads) {
    const int t = i / d4n, d4 = i - t * d4n;
    reinterpret_cast<float4*>(
        p.out + (static_cast<size_t>(b * p.T + t) * p.H + h) * p.D)[d4] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Issue the copies of tile columns [c0, c0 + kTile) of head h into k_dst
// and v_dst ([kTile, ld] each); columns at or past `hi` are zero-filled.
template <int kTile>
__device__ __forceinline__ void stage(const Params& p, const int* table,
                                      int h, int c0, int hi, float* k_dst,
                                      float* v_dst, int ld) {
  const int d4n = p.D >> 2;
  for (int i = threadIdx.x; i < kTile * d4n; i += kThreads) {
    const int j = i / d4n, d4 = i - j * d4n;
    const int c = c0 + j;
    const float* ks = p.k_pool;
    const float* vs = p.v_pool;
    int bytes = 0;
    if (c < hi) {
      const int page = table[c / p.page_size];
      const size_t off =
          ((static_cast<size_t>(page) * p.page_size + c % p.page_size) * p.H +
           h) * p.D + 4 * d4;
      ks += off;
      vs += off;
      bytes = 16;
    }
    cp_async16(k_dst + j * ld + 4 * d4, ks, bytes);
    cp_async16(v_dst + j * ld + 4 * d4, vs, bytes);
  }
}

// Workspace records: record (b, h, split, t) holds D floats of acc in the
// first region and (m, l) in the second.
__device__ __forceinline__ size_t record(const Params& p, int b, int h,
                                         int split, int t) {
  return ((static_cast<size_t>(b) * p.H + h) * p.splits + split) * p.T + t;
}

__device__ __forceinline__ float* ml_region(const Params& p) {
  return p.ws + static_cast<size_t>(p.B) * p.H * p.splits * p.T * p.D;
}

// After every thread has written the block's partials: take a ticket; the
// last active split of the (row, head) merges all of them, in split order,
// into out and resets the counter for the next call.
__device__ void finish_split(const Params& p, int b, int h, int active) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = p.tickets + b * p.H + h;
    is_last = atomicAdd(ticket, 1) == active - 1;
    if (is_last) atomicExch(ticket, 0);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* ml = ml_region(p);
  const int d4n = p.D >> 2;
  for (int i = threadIdx.x; i < p.T * d4n; i += kThreads) {
    const int t = i / d4n, d4 = i - t * d4n;
    float m_all = kNeg;
    for (int s = 0; s < active; ++s) {
      const size_t r = record(p, b, h, s, t);
      if (__ldcg(ml + 2 * r + 1) > 0.f) m_all = fmaxf(m_all, __ldcg(ml + 2 * r));
    }
    float l_all = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < active; ++s) {
      const size_t r = record(p, b, h, s, t);
      const float l = __ldcg(ml + 2 * r + 1);
      // a split with no admitted column for this query gets weight 0
      // explicitly, never through exp(m - m_all)
      if (l > 0.f) {
        const float w = expf(__ldcg(ml + 2 * r) - m_all);
        l_all = fmaf(w, l, l_all);
        acc = fma4(w, __ldcg(reinterpret_cast<const float4*>(p.ws + r * p.D) + d4),
                   acc);
      }
    }
    const float inv = 1.f / fmaxf(l_all, 1e-30f);
    reinterpret_cast<float4*>(
        p.out + (static_cast<size_t>(b * p.T + t) * p.H + h) * p.D)[d4] =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Params p) {
  constexpr int kV = kD / 32;  // float4 of D a lane: d4 = j + 8 * i
  extern __shared__ float4 smem4[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 3, j = lane & 7;  // the warp's column, d-slice
  const int D = p.D, d4n = D >> 2, ld = D + 4;

  const int n_cols = row_cols(p, b);
  const int lo = split * p.split_cols;
  if (lo >= n_cols) {
    if (split == 0) write_zeros(p, b, h);
    return;
  }
  const int hi = min(lo + p.split_cols, n_cols);
  const int active = (n_cols + p.split_cols - 1) / p.split_cols;
  const int pos = p.positions[b];
  const int* table = p.page_table + static_cast<size_t>(b) * p.P;

  float* ring = reinterpret_cast<float*>(smem4);  // [stages][K, V][tile][ld]
  const int stage_floats = 2 * kDecodeTile * ld;
  float* merge = ring + kDecodeStages * stage_floats;  // [kWarps][D], m, l

  float4 qv[kV], acc[kV];
  const float4* q4 = reinterpret_cast<const float4*>(
      p.q + (static_cast<size_t>(b) * p.H + h) * D);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int d4 = j + 8 * i;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (d4 < d4n) {
      x = q4[d4];
      x.x *= p.scale; x.y *= p.scale; x.z *= p.scale; x.w *= p.scale;
    }
    qv[i] = x;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNeg, l = 0.f;

  const int n_tiles = (hi - lo + kDecodeTile - 1) / kDecodeTile;
#pragma unroll
  for (int s = 0; s < kDecodeStages - 1; ++s) {
    if (s < n_tiles) {
      float* dst = ring + s * stage_floats;
      stage<kDecodeTile>(p, table, h, lo + s * kDecodeTile, hi, dst,
                         dst + kDecodeTile * ld, ld);
    }
    cp_async_commit();
  }
  const int cj = warp * 4 + grp;  // this lane group's column of each tile
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kDecodeStages - 2>();  // tile `it` has landed
    __syncthreads();  // for every thread; and tile it-1's stage is free
    const int nx = it + kDecodeStages - 1;
    if (nx < n_tiles) {
      float* dst = ring + (nx % kDecodeStages) * stage_floats;
      stage<kDecodeTile>(p, table, h, lo + nx * kDecodeTile, hi, dst,
                         dst + kDecodeTile * ld, ld);
    }
    cp_async_commit();

    const float* ks = ring + (it % kDecodeStages) * stage_floats;
    const float4* kr = reinterpret_cast<const float4*>(ks + cj * ld);
    const float4* vr =
        reinterpret_cast<const float4*>(ks + (kDecodeTile + cj) * ld);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (j + 8 * i < d4n) dot = dot4(qv[i], kr[j + 8 * i], dot);
    dot += __shfl_xor_sync(kFull, dot, 1);
    dot += __shfl_xor_sync(kFull, dot, 2);
    dot += __shfl_xor_sync(kFull, dot, 4);
    const int c = lo + it * kDecodeTile + cj;
    if (c < hi && c <= pos) {  // uniform in the 8-lane group
      const float m_new = fmaxf(m, dot);
      const float alpha = expf(m - m_new);
      const float pr = expf(dot - m_new);
      l = fmaf(l, alpha, pr);
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        if (j + 8 * i < d4n) {
          const float4 v = vr[j + 8 * i];
          acc[i] = make_float4(fmaf(acc[i].x, alpha, pr * v.x),
                               fmaf(acc[i].y, alpha, pr * v.y),
                               fmaf(acc[i].z, alpha, pr * v.z),
                               fmaf(acc[i].w, alpha, pr * v.w));
        }
      }
      m = m_new;
    }
  }

  // Merge the warp's four column streams (lanes j, j+8, j+16, j+24 hold
  // slice j), then the warps', in warp order.  An empty stream (l == 0)
  // has acc == 0 and gets weight 0.
  float m_w = fmaxf(m, __shfl_xor_sync(kFull, m, 8));
  m_w = fmaxf(m_w, __shfl_xor_sync(kFull, m_w, 16));
  const float w = l > 0.f ? expf(m - m_w) : 0.f;
  float l_w = l * w;
  l_w += __shfl_xor_sync(kFull, l_w, 8);
  l_w += __shfl_xor_sync(kFull, l_w, 16);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    float4 a = make_float4(acc[i].x * w, acc[i].y * w, acc[i].z * w,
                           acc[i].w * w);
    a.x += __shfl_xor_sync(kFull, a.x, 8);
    a.y += __shfl_xor_sync(kFull, a.y, 8);
    a.z += __shfl_xor_sync(kFull, a.z, 8);
    a.w += __shfl_xor_sync(kFull, a.w, 8);
    a.x += __shfl_xor_sync(kFull, a.x, 16);
    a.y += __shfl_xor_sync(kFull, a.y, 16);
    a.z += __shfl_xor_sync(kFull, a.z, 16);
    a.w += __shfl_xor_sync(kFull, a.w, 16);
    if (grp == 0 && j + 8 * i < d4n)
      reinterpret_cast<float4*>(merge + warp * D)[j + 8 * i] = a;
  }
  float* merge_ml = merge + kWarps * D;
  if (lane == 0) {
    merge_ml[2 * warp] = m_w;
    merge_ml[2 * warp + 1] = l_w;
  }
  __syncthreads();
  float m_b = kNeg;
#pragma unroll
  for (int v = 0; v < kWarps; ++v)
    if (merge_ml[2 * v + 1] > 0.f) m_b = fmaxf(m_b, merge_ml[2 * v]);
  float wv[kWarps];
  float l_b = 0.f;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const float lv = merge_ml[2 * v + 1];
    wv[v] = lv > 0.f ? expf(merge_ml[2 * v] - m_b) : 0.f;
    l_b = fmaf(wv[v], lv, l_b);
  }
  const float inv = 1.f / fmaxf(l_b, 1e-30f);
  for (int d4 = threadIdx.x; d4 < d4n; d4 += kThreads) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      if (wv[v] > 0.f)
        a = fma4(wv[v], reinterpret_cast<const float4*>(merge + v * D)[d4], a);
    if (active == 1) {
      reinterpret_cast<float4*>(
          p.out + (static_cast<size_t>(b) * p.H + h) * D)[d4] =
          make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    } else {
      reinterpret_cast<float4*>(p.ws + record(p, b, h, split, 0) * D)[d4] = a;
    }
  }
  if (active == 1) return;
  if (threadIdx.x == 0) {
    float* ml = ml_region(p) + 2 * record(p, b, h, split, 0);
    ml[0] = m_b;
    ml[1] = l_b;
  }
  finish_split(p, b, h, active);
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const Params p) {
  constexpr int kTile = chunk_tile<kD>();
  constexpr int kCPL = kTile / 32;  // columns a lane scores
  constexpr int kV2 = kD / 64;      // float2 of D a lane: d2 = lane + 32 * i
  extern __shared__ float4 smem4[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = p.D, T = p.T, d4n = D >> 2, d2n = D >> 1, ld = D + 4;

  const int n_cols = row_cols(p, b);
  const int lo = split * p.split_cols;
  if (lo >= n_cols) {
    if (split == 0) write_zeros(p, b, h);
    return;
  }
  const int hi = min(lo + p.split_cols, n_cols);
  const int active = (n_cols + p.split_cols - 1) / p.split_cols;
  const int* table = p.page_table + static_cast<size_t>(b) * p.P;

  float* q_s = reinterpret_cast<float*>(smem4);  // [kQPerPass][D], scaled
  float* ring = q_s + kQPerPass * D;             // [stages][K, V][tile][ld]
  const int stage_floats = 2 * kTile * ld;
  // the warp's p: one float4 a column, its 4 queries' probabilities
  float4* p_s = reinterpret_cast<float4*>(ring + kChunkStages * stage_floats) +
                warp * kTile;
  const float4* q_w = reinterpret_cast<const float4*>(q_s) +
                      warp * kQPerWarp * d4n;
  const int n_tiles = (hi - lo + kTile - 1) / kTile;

  for (int t0 = 0; t0 < T; t0 += kQPerPass) {
    const int nq = min(kQPerPass, T - t0);
    __syncthreads();  // the previous pass is done with q_s and the ring
    for (int i = threadIdx.x; i < kQPerPass * d4n; i += kThreads) {
      const int tq = i / d4n, d4 = i - tq * d4n;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tq < nq) {
        x = reinterpret_cast<const float4*>(
            p.q + (static_cast<size_t>(b * T + t0 + tq) * p.H + h) * D)[d4];
        x.x *= p.scale; x.y *= p.scale; x.z *= p.scale; x.w *= p.scale;
      }
      reinterpret_cast<float4*>(q_s)[i] = x;
    }
    int pos[kQPerWarp];
    float m[kQPerWarp], l[kQPerWarp];
    float2 acc[kQPerWarp][kV2];
    int warp_pos = -1;  // the last column any of the warp's queries admits
#pragma unroll
    for (int qi = 0; qi < kQPerWarp; ++qi) {
      const int tq = warp * kQPerWarp + qi;
      pos[qi] = tq < nq ? p.positions[b * T + t0 + tq] : -1;
      warp_pos = max(warp_pos, pos[qi]);
      m[qi] = kNeg;
      l[qi] = 0.f;
#pragma unroll
      for (int i = 0; i < kV2; ++i) acc[qi][i] = make_float2(0.f, 0.f);
    }
    const int warp_hi = min(hi, warp_pos + 1);

#pragma unroll
    for (int s = 0; s < kChunkStages - 1; ++s) {
      if (s < n_tiles) {
        float* dst = ring + s * stage_floats;
        stage<kTile>(p, table, h, lo + s * kTile, hi, dst, dst + kTile * ld,
                     ld);
      }
      cp_async_commit();
    }
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<kChunkStages - 2>();  // tile `it` has landed
      __syncthreads();  // for every thread (and q_s); tile it-1 is consumed
      const int nx = it + kChunkStages - 1;
      if (nx < n_tiles) {
        float* dst = ring + (nx % kChunkStages) * stage_floats;
        stage<kTile>(p, table, h, lo + nx * kTile, hi, dst, dst + kTile * ld,
                     ld);
      }
      cp_async_commit();
      const int c0 = lo + it * kTile;
      if (warp_hi <= c0) continue;  // warp-uniform: nothing admitted here

      const float* ks = ring + (it % kChunkStages) * stage_floats;
      const float* vs = ks + kTile * ld;
      float s[kQPerWarp][kCPL];
#pragma unroll
      for (int qi = 0; qi < kQPerWarp; ++qi)
#pragma unroll
        for (int ci = 0; ci < kCPL; ++ci) s[qi][ci] = 0.f;
      for (int d4 = 0; d4 < d4n; ++d4) {
        float4 kk[kCPL];
#pragma unroll
        for (int ci = 0; ci < kCPL; ++ci)
          kk[ci] = reinterpret_cast<const float4*>(
              ks + (lane + 32 * ci) * ld)[d4];
#pragma unroll
        for (int qi = 0; qi < kQPerWarp; ++qi) {
          const float4 a = q_w[qi * d4n + d4];
#pragma unroll
          for (int ci = 0; ci < kCPL; ++ci) s[qi][ci] = dot4(a, kk[ci], s[qi][ci]);
        }
      }
      float pr[kQPerWarp][kCPL];
#pragma unroll
      for (int qi = 0; qi < kQPerWarp; ++qi) {
        float tile_max = kNeg;
#pragma unroll
        for (int ci = 0; ci < kCPL; ++ci) {
          const int c = c0 + lane + 32 * ci;
          if (c < hi && c <= pos[qi]) tile_max = fmaxf(tile_max, s[qi][ci]);
        }
        tile_max = warp_max(tile_max);
        const float m_new = fmaxf(m[qi], tile_max);
        const float alpha = expf(m[qi] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int ci = 0; ci < kCPL; ++ci) {
          const int c = c0 + lane + 32 * ci;
          // a masked column gets p = 0 explicitly: while a query has no
          // admitted column yet, m_new == -1e30 and exp(s - m_new) would
          // admit it
          pr[qi][ci] = (c < hi && c <= pos[qi]) ? expf(s[qi][ci] - m_new) : 0.f;
          sum += pr[qi][ci];
        }
        l[qi] = fmaf(l[qi], alpha, sum);  // this lane's share of the sum
#pragma unroll
        for (int i = 0; i < kV2; ++i) {
          acc[qi][i].x *= alpha;
          acc[qi][i].y *= alpha;
        }
        m[qi] = m_new;
      }
#pragma unroll
      for (int ci = 0; ci < kCPL; ++ci)
        p_s[lane + 32 * ci] =
            make_float4(pr[0][ci], pr[1][ci], pr[2][ci], pr[3][ci]);
      __syncwarp();
      const int n_pv = min(kTile, warp_hi - c0);  // columns past are p = 0
      for (int cj = 0; cj < n_pv; ++cj) {
        const float4 pp = p_s[cj];
        const float2* vr = reinterpret_cast<const float2*>(vs + cj * ld);
#pragma unroll
        for (int i = 0; i < kV2; ++i) {
          if (lane + 32 * i < d2n) {
            const float2 v = vr[lane + 32 * i];
            acc[0][i].x = fmaf(pp.x, v.x, acc[0][i].x);
            acc[0][i].y = fmaf(pp.x, v.y, acc[0][i].y);
            acc[1][i].x = fmaf(pp.y, v.x, acc[1][i].x);
            acc[1][i].y = fmaf(pp.y, v.y, acc[1][i].y);
            acc[2][i].x = fmaf(pp.z, v.x, acc[2][i].x);
            acc[2][i].y = fmaf(pp.z, v.y, acc[2][i].y);
            acc[3][i].x = fmaf(pp.w, v.x, acc[3][i].x);
            acc[3][i].y = fmaf(pp.w, v.y, acc[3][i].y);
          }
        }
      }
      __syncwarp();  // p_s is rewritten by the next tile
    }

    // The pass's results: out directly for a row of one active split,
    // else this split's partials.
#pragma unroll
    for (int qi = 0; qi < kQPerWarp; ++qi) {
      const int tq = warp * kQPerWarp + qi;
      const float l_q = warp_sum(l[qi]);
      if (tq >= nq) continue;
      const int t = t0 + tq;
      float* dst;
      float mul = 1.f;
      if (active == 1) {
        dst = p.out + (static_cast<size_t>(b * T + t) * p.H + h) * D;
        mul = 1.f / fmaxf(l_q, 1e-30f);
      } else {
        const size_t r = record(p, b, h, split, t);
        dst = p.ws + r * D;
        if (lane == 0) {
          ml_region(p)[2 * r] = m[qi];
          ml_region(p)[2 * r + 1] = l_q;
        }
      }
#pragma unroll
      for (int i = 0; i < kV2; ++i)
        if (lane + 32 * i < d2n)
          reinterpret_cast<float2*>(dst)[lane + 32 * i] =
              make_float2(acc[qi][i].x * mul, acc[qi][i].y * mul);
    }
  }
  if (active > 1) finish_split(p, b, h, active);
}

size_t decode_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(kDecodeStages) * 2 *
                              kDecodeTile * (D + 4) +
                          kWarps * (D + 2));
}

template <int kD>
size_t chunk_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(kQPerPass) * D +
                          kChunkStages * 2 * chunk_tile<kD>() * (D + 4) +
                          kWarps * chunk_tile<kD>() * 4);
}

constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared memory limit to `most` (its bucket's
// largest need) once for each device, not at every launch: the serve step
// is host-bound.  `raised` is the kernel instance's own set of flags.
int allow_smem(void (*kernel)(Params), size_t most,
               std::atomic<bool> (&raised)[kMaxDevices]) {
  if (most <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (raised[dev].load(std::memory_order_acquire)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(most));
  if (e != cudaSuccess) return static_cast<int>(e);
  raised[dev].store(true, std::memory_order_release);
  return 0;
}

template <int kD, bool kDecode>
int launch(const Params& p, cudaStream_t stream) {
  static std::atomic<bool> raised[kMaxDevices];
  void (*kernel)(Params) =
      kDecode ? paged_decode_kernel<kD> : paged_chunk_kernel<kD>;
  const int err = allow_smem(
      kernel, kDecode ? decode_smem(kD) : chunk_smem<kD>(kD), raised);
  if (err) return err;
  const size_t smem = kDecode ? decode_smem(p.D) : chunk_smem<kD>(p.D);
  kernel<<<dim3(p.splits, p.H, p.B), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int run(const Params& p, cudaStream_t stream) {
  return p.T == 1 ? launch<kD, true>(p, stream) : launch<kD, false>(p, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller validates shapes, types, contiguity and 16-byte alignment, and
// guarantees D % 4 == 0, D <= 256.  The split plan (splits ranges of
// split_cols columns) must cover the table's P * page_size columns with
// no range wholly past them; with splits > 1, `workspace` holds
// B * H * splits * T * (D + 2) floats and `tickets` B * H zeroed ints,
// which the kernel leaves zeroed.
extern "C" int unicore_paged_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int* page_table, const int* positions, const int* lengths,
    float* out, float* workspace, int* tickets, int B, int T, int H, int D,
    int P, int page_size, int splits, int split_cols, float scale,
    void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  const long long cols = static_cast<long long>(P) * page_size;
  if (splits < 1 || split_cols < 1 ||
      static_cast<long long>(splits) * split_cols < cols ||
      (splits > 1 && static_cast<long long>(splits - 1) * split_cols >= cols) ||
      (splits > 1 && (workspace == nullptr || tickets == nullptr)) ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k_pool, v_pool, page_table, positions, lengths, out,
                 workspace, tickets, B, T, H, D, P, page_size, splits,
                 split_cols, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return run<64>(p, s);
  if (D <= 128) return run<128>(p, s);
  return run<256>(p, s);
}

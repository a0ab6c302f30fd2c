// Flash attention forward for bf16 and fp16 operands on the tensor cores
// of Hopper (sm_90a): flash_fwd_bf16 and flash_fwd_fp16, one body
// (fwd_body) instantiated for each operand type T.
//
// Replaces, for bf16 and fp16 operands, the Pallas TPU forward kernels of
// unicore_tpu/ops/pallas/flash_attention.py: _fwd_hb_kernel (:121, the
// single-block pass BERT takes at T = 512, pallas_call :825) and
// _fwd_kernel (:241, the multi-block online softmax, pallas_call :786).
// The fp32 forward stays in flash_attention.cu (fp32 FMA, no TF32).  For
// batch row b, head h, query r and key c:
//
//   s      = scale * <q[r], k[c]> + bias[h,r,c] + (pad[b,c] ? -1e30 : 0)
//            + (causal && c > r ? -1e30 : 0)        (added in that order)
//   m      = max_c s,   l = sum_c exp(s - m)         (undropped, fp32)
//   out[r] = sum_c T(keep ? exp(s - m) / keep_prob : 0) v[c] / l_safe
//   lse[r] = m + log(l_safe)    (fp32; l_safe = l, or 1 where l == 0)
//
// with the max and the sum taken online over 64-key tiles: a tile's p is
// exp(s - m_run) under the running max, and the accumulators rescale by
// exp(m_old - m_new) when the max grows, as the reference's multi-block
// kernel does over its key blocks.  p is rounded to T before the p.V
// product, where the reference casts (its :157, :283: to v's type).  The
// scores, the max, exp, the sums and the dropout hash stay fp32 in both
// instantiations; out rounds to T once at the end.  Element (r, c)
// of head h draws the TPU kernels' dropout bits (prng.cuh) through the
// REFERENCE's block geometry (geo_*): see mma_bf16.cuh.
//
// Design.  Grid (query tile, h, b), blocks of 4 warps over 64-row tiles;
// each warp owns 16 query rows.  The q tile arrives once by cp.async and
// its A fragments stay in registers (ldmatrix).  A loop over key tiles
// keeps the next tile's k, v, bias and pad in flight by 16-byte cp.async
// (two stages) while this one computes:
//   S = Q K^T by mma.sync.m16n8k16 (T operands, fp32 accumulators);
//   in registers, at each accumulator's (r, c): the scale, bias, pad and
//     causal terms, the row max by quad shuffles, the rescale of l and of
//     the output accumulators, p = expf(s - m), the dropout bits;
//   P rounded to T and packed as A fragments (P never touches shared
//     memory), and O += P V with V through ldmatrix.trans.
// q, k and v are read by strides (the fused [B, T, 3, H, D] projection
// needs no copy) into rows with D zero-filled up to 32, 64 or 128.  The
// q tile shares its shared memory with stage 1's k tile.  Skips, exact by
// the online rescale: a key tile that is all padding, or under causal
// wholly above the diagonal, in a batch row whose every query admits an
// unpadded key (the backward's rule, mma_bf16.cuh).  mma.sync rather than
// wgmma, for the reasons flash_attention_bwd.cu gives.  No atomics: two
// calls give the same bits.
//
// Bound.  The forward needs 4 B H Tq Tk D flops on unpadded pairs and
// reads q, k, v and the bias once and writes out and lse.  At BERT's
// shape (B 16, H 12, T 512, D 64, ~100 padded keys a row) that is ~10.4
// GFLOP (0.0105 ms at 989 TFLOP/s, the bf16 and the fp16 rate alike)
// against ~57 MB (0.017 ms at 3.35 TB/s): bytes bound it, the
// [12, 512, 512] 2-byte bias a quarter of them;
// without a bias at T >= 1024 the flops do.  This design reads k and v
// once per query tile and the bias once per batch row (again and again
// from L2, not device memory) and does exactly the 4 units on unskipped
// tiles on the tensor cores, plus an exp and a counter hash per element
// on the CUDA cores, which at D = 64 cost about as many instructions as the
// mma.sync products (whose ceiling is about two thirds of 989 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_params.cuh"
#include "mma_bf16.cuh"
#include "prng.cuh"

namespace {

// Dynamic shared memory of the kernel, in bytes: two stages of k and v
// tiles (the q tile in stage 1's k), two bias tiles of kBiasItem-byte
// elements (none for 0), two tiles of pad.  ops/flash_attention.py
// repeats it (fwd_smem_bytes).
constexpr size_t fwd_smem(int kD, int kBiasItem) {
  return 4 * kTile * (kD + 8) * 2 +
         (kBiasItem ? 2 * bias_tile_bytes(kBiasItem) : 0) +
         2 * kTile * sizeof(int);
}

// T: the operand type (bf16 or f16).  kBias: kNoBias without a bias,
// else the bias's type code (kBiasF32, or T's own).
template <int kD, typename T, int kBias>
__device__ __forceinline__ void fwd_body(const FlashParams& p) {
  constexpr int kLd = kD + 8;
  constexpr int kElems = kTile * kLd;
  constexpr int kN = kD / 8;  // output column blocks
  constexpr int kBiasItem = kBias == kNoBias ? 0 : bias_item(kBias);
  constexpr int kBiasTile = kBiasItem ? bias_tile_bytes(kBiasItem) : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kv_s = reinterpret_cast<T*>(smem);  // [2 stages][k, v][kElems]
  T* q_s = kv_s + 2 * kElems;            // = stage 1's k tile
  char* bias_s = reinterpret_cast<char*>(kv_s + 4 * kElems);   // [2][tile]
  int* pad_s = reinterpret_cast<int*>(bias_s + 2 * kBiasTile);  // [2][64]

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int D = p.D;
  const int nk = p.Tk / kTile;
  const int ql0 = warp * 16 + g;  // this thread's rows ql0, ql0 + 8
  const bool may_skip = row_may_skip(p, b);
  auto next_live = [&](int kt) {
    do {
      ++kt;
    } while (kt < nk && tile_skipped(p, may_skip, b, q0, kt * kTile));
    return kt;
  };
  // a key tile's k, v, bias and pad into a stage
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kTile;
    load_tile<kD>(kv_s + 2 * stage * kElems, p.k, p.sk_b, p.sk_t, p.sk_h, b,
                  h, k0, D);
    load_tile<kD>(kv_s + (2 * stage + 1) * kElems, p.v, p.sv_b, p.sv_t,
                  p.sv_h, b, h, k0, D);
    if (kBiasItem) load_bias(bias_s + stage * kBiasTile, p, h, q0, k0);
    if (p.pad)
      load_row64(pad_s + stage * kTile,
                 p.pad + static_cast<long long>(b) * p.Tk + k0);
  };

  if (D < kD)
    for (int i = 0; i < 4; ++i) zero_cols<kD>(kv_s + i * kElems, D);
  load_tile<kD>(q_s, p.q, p.sq_b, p.sq_t, p.sq_h, b, h, q0, D);
  cp_async_commit();
  int cur = next_live(-1);
  if (cur < nk) load_kv(cur, 0);
  cp_async_commit();
  cp_async_wait_1();  // the q tile has landed
  __syncthreads();
  uint32_t qa[kD / 16][4];  // A fragments of the warp's 16 query rows
#pragma unroll
  for (int kd = 0; kd < kD / 16; ++kd)
    ldsm_x4(qa[kd],
            q_s + (warp * 16 + (lane & 15)) * kLd + kd * 16 + (lane >> 4) * 8);
  __syncthreads();  // stage 1 may now be refilled

  const uint32_t seed_b = p.dropout ? static_cast<uint32_t>(p.seed[b]) : 0u;
  float m_run[2] = {kNeg, kNeg};  // running max of rows ql0, ql0 + 8
  float l_run[2] = {0.f, 0.f};    // this thread's share of the row sums
  float o[kN][4];                 // rows ql0, ql0 + 8; cols 8 n + 2 t
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int stage = 0; cur < nk; stage ^= 1) {
    const int nxt = next_live(cur);
    if (nxt < nk) load_kv(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int k0 = cur * kTile;
    const T* ks = kv_s + 2 * stage * kElems;
    const T* vs = ks + kElems;
    const char* bs = bias_s + stage * kBiasTile;
    const int* pads = pad_s + stage * kTile;

    // S = Q K^T: rows the warp's queries, cols the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kD / 16; ++kd) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                        kd * 16 + ((lane >> 3) & 1) * 8);
        mma<T>(s[2 * np], qa[kd], kb[0], kb[1]);
        mma<T>(s[2 * np + 1], qa[kd], kb[2], kb[3]);
      }
    }

    // the score's added terms, in the reference's order, and the row max
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ql = ql0 + 8 * i, cl = n * 8 + 2 * t;
        const float2 bb = kBiasItem ? bias2_smem(bs, kBias, ql, cl)
                                    : make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[n][2 * i + j] * p.scale;
          if (kBiasItem) x += j ? bb.y : bb.x;
          if (p.pad && pads[cl + j] > 0) x += kNeg;
          if (p.causal && k0 + cl + j > q0 + ql) x += kNeg;
          s[n][2 * i + j] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float corr = expf(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= corr;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
    }

    // by 16 keys: p (l sums it undropped), the dropped p rounded to T
    // as A fragments, then O += P V
    const DropTile drop =
        p.dropout ? drop_tile(p, seed_b, h, q0, k0) : DropTile{0u, 0u, 0u};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float pu[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kk + half;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = expf(s[n][e] - m_run[e >> 1]);
          l_run[e >> 1] += pr;
          pu[half][e] = pr;
          if (p.dropout)
            pu[half][e] = kept(p, drop, warp * 16 + acc_row(g, e),
                               acc_col(n, t, e))
                              ? pr * p.inv_keep
                              : 0.f;
        }
      }
      uint32_t pa[4];
      pack_a<T>(pa, pu[0], pu[1]);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs +
                          (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                          dp * 16 + (lane >> 4) * 8);
        mma<T>(o[2 * dp], pa, vb[0], vb[1]);
        mma<T>(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
    cur = nxt;
  }

  // the row sums over the quad, then out = O / l_safe in T and lse
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const float l_safe = l == 0.f ? 1.f : l;
    const int r = q0 + ql0 + 8 * i;
    T* out = static_cast<T*>(p.out) +
             ((static_cast<long long>(b) * p.Tq + r) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (n * 8 >= D) continue;
      store2<T>(out + n * 8 + 2 * t, o[n][2 * i] / l_safe,
                o[n][2 * i + 1] / l_safe);
    }
    if (t == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Tq + r] =
          m_run[i] + logf(l_safe);
  }
}

// One kernel name per operand type, so a profile tells them apart.
template <int kD, int kBias>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const FlashParams p) {
  fwd_body<kD, bf16, kBias>(p);
}

template <int kD, int kBias>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_fp16_kernel(const FlashParams p) {
  fwd_body<kD, f16, kBias>(p);
}

template <typename T, int kD, int kBias>
int launch(const FlashParams& p, cudaStream_t st) {
  constexpr size_t smem =
      fwd_smem(kD, kBias == kNoBias ? 0 : bias_item(kBias));
  const dim3 grid(p.Tq / kTile, p.H, p.B);
  if constexpr (Elem<T>::kBiasType == kBiasBf16)
    return flash_launch(flash_fwd_bf16_kernel<kD, kBias>, grid, kThreads,
                        smem, p, st);
  else
    return flash_launch(flash_fwd_fp16_kernel<kD, kBias>, grid, kThreads,
                        smem, p, st);
}

// The bias may be fp32 or of the operands' type.
template <typename T, int kD>
int fwd(const FlashParams& p, cudaStream_t st) {
  constexpr int kOwn = Elem<T>::kBiasType;
  if (p.bias == nullptr) return launch<T, kD, kNoBias>(p, st);
  if (p.bias_type == kBiasF32) return launch<T, kD, kBiasF32>(p, st);
  if (p.bias_type == kOwn) return launch<T, kD, kOwn>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int fwd_entry(const FlashParams* p, void* stream) {
  if (p->B == 0 || p->H == 0 || p->Tq == 0 || p->Tk == 0) return 0;
  if (!takes_tiles(*p) || p->out == nullptr || p->lse == nullptr ||
      p->seed == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(p->D)) {
    case 32:
      return fwd<T, 32>(*p, st);
    case 64:
      return fwd<T, 64>(*p, st);
    default:
      return fwd<T, 128>(*p, st);
  }
}

}  // namespace

// Launch on `stream`; each returns the CUDA error (0 on success), or
// cudaErrorInvalidValue for parameters the kernel does not take.
extern "C" int unicore_flash_fwd_bf16(const FlashParams* p, void* stream) {
  return fwd_entry<bf16>(p, stream);
}

extern "C" int unicore_flash_fwd_fp16(const FlashParams* p, void* stream) {
  return fwd_entry<f16>(p, stream);
}

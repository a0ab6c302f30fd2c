// Flash attention backward for bf16 and fp16 operands on the tensor cores
// of Hopper (sm_90a): two kernels, flash_bwd_dkdv and flash_bwd_dq (with
// dbias), each one body (dkdv_body, dq_body) instantiated for each
// operand type T (the fp16 kernels' names end in _fp16).
//
// Replaces, for bf16 and fp16 operands, the Pallas TPU backward kernels of
// unicore_tpu/ops/pallas/flash_attention.py: _bwd_hb_kernel (:164, the
// fused single-block pass BERT takes at T = 512), _dkv_kernel (:298),
// _dq_kernel (:362), _joint_bwd_kernel (:406) and _dbias_kernel (:488).
// The fp32 backward stays in flash_attention.cu (fp32 FMA, no TF32).
// For batch row b, head h, query r and key c, with lse and
// delta = rowsum(dO * O) from the caller:
//
//   s      = scale * <q[r], k[c]> + bias[h,r,c] + (pad[b,c] ? -1e30 : 0)
//            + (causal && c > r ? -1e30 : 0)        (added in that order)
//   p      = exp(s - lse[r]),   keep = dropout bits (prng.cuh) < thresh
//   p_drop = keep ? p / keep_prob : 0,   dP = keep ? <dO[r], v[c]> / keep_prob : 0
//   dS     = p * (dP - delta[r])                           (fp32)
//   dv[c]  = sum_r T(p_drop) dO[r]
//   dk[c]  = scale * sum_r T(dS) q[r]
//   dq[r]  = scale * sum_c T(dS) k[c]
//   dbias  = sum_b dS                                      (fp32)
//
// p_drop and dS are rounded to the operand type T before their products
// and dbias sums the fp32 dS, where the reference casts (its :214,
// :223-224, :234); the caller casts dbias to the bias's type.
// Element (r, c) of head h draws the TPU kernels' bits: seed
// seed[b] + (h * n_i + r / gbq) * n_j + c / gbk at index
// (r % gbq) * gbk + c % gbk, (gbq, gbk) the REFERENCE's block geometry
// (geo_*), a multiple of this kernel's 64-row tiles, so a tile draws under
// one seed and its indices are a base plus r_local * gbk + c_local.
//
// Design.  Blocks of 4 warps over 64 x 64 tiles; each warp owns 16 rows
// of the tile.  Every product is mma.sync.m16n8k16 (T operands, fp32
// accumulators) with operands from shared memory by ldmatrix, and
// ldmatrix.trans for the operands the products read transposed (dO and q
// for dv and dk, k for dq); the score-shaped accumulators become the A
// operand of the next product in registers.  mma.sync was chosen over
// wgmma: its 16-row warp tiles fit the 64-row tiles that the padded-key
// and causal skips work on, the accumulator layout is fixed and
// documented for the elementwise step (positions, dropout bits), and no
// descriptor or swizzle layout has to be right on a card nobody can debug
// on; its ceiling on H100 is about two thirds of wgmma's 989 TFLOP/s.
// The building blocks (the PTX wrappers, the fragment map, the tile
// layout, the dropout bits and the skip rule) are mma_bf16.cuh, shared
// with the forward.  Tiles arrive by 16-byte cp.async, double-buffered:
// the next tile is in flight while this one is computed.  dk/dv stages
// the bias tile the same way (it reads it transposed, a gather from
// device memory otherwise); dq, its shared memory spent on the dq
// accumulators, loads each thread's bias pairs of a key tile into
// registers once for the group's rows.  q, k, v and dO are read by
// strides (the fused [B, T, 3, H, D] projection needs no copy); rows sit
// in shared memory with D zero-filled up to 32, 64 or 128 plus 16 bytes
// of pad, so ldmatrix's eight rows fall in distinct banks.
//   flash_bwd_dkdv: grid (key tile, h, b); K and V stay, a loop over
//     query tiles recomputes S^T = K Q^T and dP^T = V dO^T, forms p_drop
//     and dS, and accumulates dV += P_drop^T dO and dK += dS^T Q.
//   flash_bwd_dq: grid (query tile, h, batch group); the q and dO tiles
//     of the group's rows stay in shared memory, and a loop over key
//     tiles, and within each over the group's batch rows in order,
//     recomputes S = Q K^T and dP = dO V^T, accumulates dQ += dS K into
//     fp32 accumulators in shared memory (one per row of the group) and
//     the fp32 dS into the group's dbias tile in registers, written once
//     per key tile into the partials [groups, H, Tq, Tk]; the caller sums
//     the partials.  Without a bias gradient a group is one batch row.
// No atomics: two calls on the same inputs give the same bits.
// Skips, each exact: a key tile whose 64 keys are all padded, and under
// causal a tile wholly above the diagonal, add exactly 0 (p = 0) -- but
// only in a batch row whose every query admits an unpadded key.  A query
// whose admitted keys are all padded has lse = -1e30 and p = 1 on every
// key whose score rounds to -1e30 (the reference's arithmetic), so such a
// row skips nothing.  dk and dv of a skipped key tile are written as 0.
//
// Bound: operations.  The backward needs 10 B H Tq Tk D flops on unpadded
// pairs; this design does 14 (8 in dk/dv, 6 in dq: S and dP twice) on
// unskipped tiles, plus the exp and the counter hash of every element in
// both kernels, against 989 TFLOP/s of bf16 (or fp16) tensor cores.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_params.cuh"
#include "mma_bf16.cuh"
#include "prng.cuh"

namespace {

constexpr int kMaxRows = 32;  // batch rows of a dq group

// p_drop and dS of one element from its raw dot products <q, k> and
// <dO, v> and the score's added terms (bias, pad, causal: added in the
// reference's order after the scale).
struct Grad {
  float p_drop, ds;
};

__device__ __forceinline__ Grad element(const FlashParams& p, float dot,
                                        float dpv, float bias, float padt,
                                        bool above, float lse, float delta,
                                        bool keep) {
  float s = dot * p.scale;
  if (p.bias) s += bias;
  if (p.pad) s += padt;
  if (above) s += kNeg;
  const float pr = expf(s - lse);
  float pd = pr, g = dpv;
  if (p.dropout) {
    pd = keep ? pr * p.inv_keep : 0.f;
    g = keep ? g * p.inv_keep : 0.f;
  }
  return {pd, pr * (g - delta)};
}

// ---------------------------------------------------------- kernels ----

// kBias: kNoBias without a bias, else the bias's type code.
template <int kD, typename T, int kBias>
__device__ __forceinline__ void dkdv_body(const FlashParams& p) {
  constexpr int kLd = kD + 8;
  constexpr int kElems = kTile * kLd;
  constexpr int kN = kD / 8;  // accumulator column blocks
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kElems;
  T* q_s = v_s + kElems;       // [2][kElems]
  T* do_s = q_s + 2 * kElems;  // [2][kElems]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kElems);  // [2][64]
  float* dl_s = lse_s + 2 * kTile;                              // [2][64]
  char* bias_s = reinterpret_cast<char*>(dl_s + 2 * kTile);     // [2][tile]
  constexpr int bias_tile =
      kBias == kNoBias ? 0 : bias_tile_bytes(bias_item(kBias));

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int D = p.D;
  const int nq = p.Tq / kTile;
  const long long row_bh = (static_cast<long long>(b) * p.H + h) * p.Tq;
  const uint32_t seed_b = p.dropout ? static_cast<uint32_t>(p.seed[b]) : 0u;
  const bool may_skip = row_may_skip(p, b);
  int qt = (p.causal && may_skip) ? blockIdx.x : 0;
  if (may_skip && tile_padded(p, b, k0)) qt = nq;  // dk = dv = 0

  // this thread's two keys (accumulator rows g and g + 8 of the warp)
  const int kl0 = warp * 16 + g;
  float padt[2] = {0.f, 0.f};
  if (p.pad)
    for (int i = 0; i < 2; ++i)
      padt[i] = p.pad[static_cast<long long>(b) * p.Tk + k0 + kl0 + 8 * i] > 0
                    ? kNeg
                    : 0.f;

  auto load_q = [&](int q0, int stage) {
    load_tile<kD>(q_s + stage * kElems, p.q, p.sq_b, p.sq_t, p.sq_h, b, h, q0,
                  D);
    load_tile<kD>(do_s + stage * kElems, p.dout, p.sd_b, p.sd_t, p.sd_h, b, h,
                  q0, D);
    load_row64(lse_s + stage * kTile, p.lse + row_bh + q0);
    load_row64(dl_s + stage * kTile, p.delta + row_bh + q0);
    if (kBias != kNoBias) load_bias(bias_s + stage * bias_tile, p, h, q0, k0);
  };
  if (qt < nq) {
    if (D < kD) {
      zero_cols<kD>(k_s, D);
      zero_cols<kD>(v_s, D);
      for (int i = 0; i < 2; ++i) {
        zero_cols<kD>(q_s + i * kElems, D);
        zero_cols<kD>(do_s + i * kElems, D);
      }
    }
    load_tile<kD>(k_s, p.k, p.sk_b, p.sk_t, p.sk_h, b, h, k0, D);
    load_tile<kD>(v_s, p.v, p.sv_b, p.sv_t, p.sv_h, b, h, k0, D);
    load_q(qt * kTile, 0);
  }
  cp_async_commit();

  float dk[kN][4], dv[kN][4];  // rows: keys kl0, kl0 + 8; cols 8 n + 2 t
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int stage = 0; qt < nq; ++qt, stage ^= 1) {
    if (qt + 1 < nq) load_q((qt + 1) * kTile, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int q0 = qt * kTile;
    const T* qs = q_s + stage * kElems;
    const T* dos = do_s + stage * kElems;
    const float* lse = lse_s + stage * kTile;
    const float* dl = dl_s + stage * kTile;
    const char* bs = bias_s + stage * bias_tile;

    // S^T = K Q^T, dP^T = V dO^T: rows keys, cols the tile's 64 queries
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      uint32_t ka[4], va[4];
      const int a_off = (warp * 16 + (lane & 15)) * kLd + ks * 16 + (lane >> 4) * 8;
      ldsm_x4(ka, k_s + a_off);
      ldsm_x4(va, v_s + a_off);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t qb[4], ob[4];
        const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                          ks * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(qb, qs + b_off);
        ldsm_x4(ob, dos + b_off);
        mma<T>(st[2 * np], ka, qb[0], qb[1]);
        mma<T>(st[2 * np + 1], ka, qb[2], qb[3]);
        mma<T>(dpt[2 * np], va, ob[0], ob[1]);
        mma<T>(dpt[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    const DropTile drop =
        p.dropout ? drop_tile(p, seed_b, h, q0, k0) : DropTile{0u, 0u, 0u};
    // by 16 queries: P_drop^T and dS^T as A operands, then
    // dV += P_drop^T dO and dK += dS^T Q
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t pa[4], da[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kq + half;
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = kl0 + (e >> 1) * 8, ql = n * 8 + 2 * t + (e & 1);
          const Grad gr = element(
              p, st[n][e], dpt[n][e],
              kBias != kNoBias ? bias_smem(bs, kBias, ql, kl) : 0.f,
              padt[e >> 1],
              p.causal && k0 + kl > q0 + ql, lse[ql], dl[ql],
              p.dropout && kept(p, drop, ql, kl));
          pd[e] = gr.p_drop;
          ds[e] = gr.ds;
        }
        pa[2 * half] = pack<T>(pd[0], pd[1]);
        pa[2 * half + 1] = pack<T>(pd[2], pd[3]);
        da[2 * half] = pack<T>(ds[0], ds[1]);
        da[2 * half + 1] = pack<T>(ds[2], ds[3]);
      }
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t ob[4], qb[4];
        const int off = (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                        dp * 16 + (lane >> 4) * 8;
        ldsm_x4_t(ob, dos + off);
        ldsm_x4_t(qb, qs + off);
        mma<T>(dv[2 * dp], pa, ob[0], ob[1]);
        mma<T>(dv[2 * dp + 1], pa, ob[2], ob[3]);
        mma<T>(dk[2 * dp], da, qb[0], qb[1]);
        mma<T>(dk[2 * dp + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int n = 0; n < kN; ++n) {
    if (n * 8 >= D) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long off =
          ((static_cast<long long>(b) * p.Tk + k0 + kl0 + 8 * i) * p.H + h) *
              D +
          n * 8 + 2 * t;
      store2<T>(static_cast<T*>(p.dk) + off, dk[n][2 * i] * p.scale,
                dk[n][2 * i + 1] * p.scale);
      store2<T>(static_cast<T*>(p.dv) + off, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// kBias: kNoBias without a bias, else the bias's type code.  The bias
// pairs of a key tile are loaded once into registers and serve the
// group's rows; without a bias those registers are not spent.
template <int kD, typename T, int kBias>
__device__ __forceinline__ void dq_body(const FlashParams& p) {
  constexpr int kLd = kD + 8;  // of T tiles and of the fp32 dq rows
  constexpr int kElems = kTile * kLd;
  constexpr int kN = kD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, grp = blockIdx.z;
  const int b_lo = static_cast<int>(static_cast<long long>(grp) * p.B / p.groups);
  const int rows =
      static_cast<int>(static_cast<long long>(grp + 1) * p.B / p.groups) - b_lo;
  T* kv_s = reinterpret_cast<T*>(smem);  // [2 stages][k, v][kElems]
  T* qo_s = kv_s + 4 * kElems;           // [rows][q, dO][kElems]
  float* acc_s = reinterpret_cast<float*>(qo_s + 2 * rows * kElems);
  float* stat_s = acc_s + rows * kElems;  // [rows][lse, delta][64]
  int* pad_s = reinterpret_cast<int*>(stat_s + 2 * rows * kTile);  // [2][64]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int D = p.D;
  const int nk = p.Tk / kTile, pairs = nk * rows;
  const int ql0 = warp * 16 + g;  // this thread's rows ql0, ql0 + 8

  uint32_t may_skip = 0;  // bit r: skips are exact in batch row b_lo + r
  for (int r = 0; r < rows; ++r)
    if (row_may_skip(p, b_lo + r)) may_skip |= 1u << r;
  // (key tile, row) pairs in order, key tile outer; skipped pairs add 0
  auto skipped = [&](int pair) {
    const int kt = pair / rows, r = pair - kt * rows;
    return tile_skipped(p, (may_skip >> r) & 1u, b_lo + r, q0, kt * kTile);
  };
  auto next_live = [&](int pair) {
    do {
      ++pair;
    } while (pair < pairs && skipped(pair));
    return pair;
  };
  // a pair's k and v tiles (and pad) into a stage; q, dO, lse and delta
  // of the group's rows stay for the whole loop
  auto load_pair = [&](int pair, int stage) {
    const int kt = pair / rows, b = b_lo + pair - kt * rows, k0 = kt * kTile;
    load_tile<kD>(kv_s + 2 * stage * kElems, p.k, p.sk_b, p.sk_t, p.sk_h, b,
                  h, k0, D);
    load_tile<kD>(kv_s + (2 * stage + 1) * kElems, p.v, p.sv_b, p.sv_t,
                  p.sv_h, b, h, k0, D);
    if (p.pad)
      load_row64(pad_s + stage * kTile,
                 p.pad + static_cast<long long>(b) * p.Tk + k0);
  };

  if (D < kD)
    for (int i = 0; i < 4 + 2 * rows; ++i) zero_cols<kD>(kv_s + i * kElems, D);
  for (int i = threadIdx.x; i < rows * kElems; i += kThreads) acc_s[i] = 0.f;
  for (int r = 0; r < rows; ++r) {
    const int b = b_lo + r;
    const long long row_bh = (static_cast<long long>(b) * p.H + h) * p.Tq;
    load_tile<kD>(qo_s + 2 * r * kElems, p.q, p.sq_b, p.sq_t, p.sq_h, b, h,
                  q0, D);
    load_tile<kD>(qo_s + (2 * r + 1) * kElems, p.dout, p.sd_b, p.sd_t, p.sd_h,
                  b, h, q0, D);
    load_row64(stat_s + 2 * r * kTile, p.lse + row_bh + q0);
    load_row64(stat_s + (2 * r + 1) * kTile, p.delta + row_bh + q0);
  }
  int cur = next_live(-1);
  if (cur < pairs) load_pair(cur, 0);
  cp_async_commit();

  // the group's dbias tile of key tile db_kt: rows ql0, ql0 + 8; cols
  // 8 n + 2 t
  float db[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[n][e] = 0.f;
  int db_kt = 0;
  auto flush_db = [&]() {  // write tile db_kt, move to the next
    float* o = p.dbias +
               ((static_cast<long long>(grp) * p.H + h) * p.Tq + q0 + ql0) *
                   p.Tk +
               db_kt * kTile + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(o + n * 8) = make_float2(db[n][0], db[n][1]);
      *reinterpret_cast<float2*>(o + 8 * static_cast<long long>(p.Tk) + n * 8) =
          make_float2(db[n][2], db[n][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) db[n][e] = 0.f;
    }
    ++db_kt;
  };

  float2 bv[2][8];  // bias pairs of key tile bias_kt
  int bias_kt = -1;
  for (int stage = 0; cur < pairs; stage ^= 1) {
    const int nxt = next_live(cur);
    if (nxt < pairs) load_pair(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int kt = cur / rows, r = cur - kt * rows, b = b_lo + r;
    const int k0 = kt * kTile;
    if (p.dbias)
      while (db_kt < kt) flush_db();
    const T* qs = qo_s + 2 * r * kElems;
    const T* dos = qs + kElems;
    const T* ks = kv_s + 2 * stage * kElems;
    const T* vs = ks + kElems;
    const int* pads = pad_s + stage * kTile;
    const float* st = stat_s + 2 * r * kTile;
    const float lse[2] = {st[ql0], st[ql0 + 8]};
    const float dl[2] = {st[kTile + ql0], st[kTile + ql0 + 8]};

    // this thread's bias pairs of key tile kt (rows ql0, ql0 + 8; keys
    // 8 n + 2 t, + 1), loaded as the products start
    if (kBias != kNoBias && kt != bias_kt) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          bv[i][n] =
              bias2_at<kBias>(p, h, q0 + ql0 + 8 * i, k0 + n * 8 + 2 * t);
      bias_kt = kt;
    }

    // S = Q K^T, dP = dO V^T: rows the warp's queries, cols 64 keys
    float s[8][4], dpv[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dpv[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kD / 16; ++kd) {
      uint32_t qa[4], oa[4];
      const int a_off = (warp * 16 + (lane & 15)) * kLd + kd * 16 + (lane >> 4) * 8;
      ldsm_x4(qa, qs + a_off);
      ldsm_x4(oa, dos + a_off);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4], vb[4];
        const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                          kd * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(kb, ks + b_off);
        ldsm_x4(vb, vs + b_off);
        mma<T>(s[2 * np], qa, kb[0], kb[1]);
        mma<T>(s[2 * np + 1], qa, kb[2], kb[3]);
        mma<T>(dpv[2 * np], oa, vb[0], vb[1]);
        mma<T>(dpv[2 * np + 1], oa, vb[2], vb[3]);
      }
    }

    // dQ += dS K by 16 keys, on the row's fp32 accumulators
    float* acc = acc_s + r * kElems;
    float c[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 v2 =
            *reinterpret_cast<const float2*>(acc + (ql0 + 8 * i) * kLd + n * 8 + 2 * t);
        c[n][2 * i] = v2.x;
        c[n][2 * i + 1] = v2.y;
      }
    const uint32_t seed_b = p.dropout ? static_cast<uint32_t>(p.seed[b]) : 0u;
    const DropTile drop =
        p.dropout ? drop_tile(p, seed_b, h, q0, k0) : DropTile{0u, 0u, 0u};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kk + half;
        const int cl = n * 8 + 2 * t;  // this thread's keys cl, cl + 1
        float ds[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // rows ql0 + 8 i
          const int ql = ql0 + 8 * i;
          const float2 bias2 =
              kBias != kNoBias ? bv[i][n] : make_float2(0.f, 0.f);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 2 * i + j;
            const Grad gr = element(
                p, s[n][e], dpv[n][e], j ? bias2.y : bias2.x,
                p.pad && pads[cl + j] > 0 ? kNeg : 0.f,
                p.causal && k0 + cl + j > q0 + ql, lse[i], dl[i],
                p.dropout && kept(p, drop, ql, cl + j));
            ds[e] = gr.ds;
            if (p.dbias) db[n][e] += gr.ds;
          }
        }
        da[2 * half] = pack<T>(ds[0], ds[1]);
        da[2 * half + 1] = pack<T>(ds[2], ds[3]);
      }
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t kb[4];
        ldsm_x4_t(kb, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                          dp * 16 + (lane >> 4) * 8);
        mma<T>(c[2 * dp], da, kb[0], kb[1]);
        mma<T>(c[2 * dp + 1], da, kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(acc + (ql0 + 8 * i) * kLd + n * 8 + 2 * t) =
            make_float2(c[n][2 * i], c[n][2 * i + 1]);
    __syncthreads();  // this stage is refilled by the next iteration
    cur = nxt;
  }
  if (p.dbias)
    while (db_kt < nk) flush_db();

  // dq * scale in T, from the warp's own accumulator rows (zeroed by
  // all threads, so a group with no live pair needs the barrier)
  __syncthreads();
  for (int r = 0; r < rows; ++r) {
    const float* acc = acc_s + r * kElems;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (n * 8 >= D) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ql = ql0 + 8 * i;
        const float2 v2 =
            *reinterpret_cast<const float2*>(acc + ql * kLd + n * 8 + 2 * t);
        const long long off =
            ((static_cast<long long>(b_lo + r) * p.Tq + q0 + ql) * p.H + h) * D +
            n * 8 + 2 * t;
        store2<T>(static_cast<T*>(p.dq) + off, v2.x * p.scale,
                  v2.y * p.scale);
      }
    }
  }
}

// The kernels, one name per operand type, so a profile tells them apart.
// dk/dv: at most 168 registers for D <= 64, so that three blocks share an
// SM.
template <int kD, int kBias>
__global__ void __launch_bounds__(kThreads, kD <= 64 ? 3 : 1)
    flash_bwd_dkdv_kernel(const FlashParams p) {
  dkdv_body<kD, bf16, kBias>(p);
}

template <int kD, int kBias>
__global__ void __launch_bounds__(kThreads, kD <= 64 ? 3 : 1)
    flash_bwd_dkdv_fp16_kernel(const FlashParams p) {
  dkdv_body<kD, f16, kBias>(p);
}

template <int kD, int kBias>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const FlashParams p) {
  dq_body<kD, bf16, kBias>(p);
}

template <int kD, int kBias>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_fp16_kernel(const FlashParams p) {
  dq_body<kD, f16, kBias>(p);
}

// Dynamic shared memory of each kernel, in bytes (T is 2 bytes);
// ops/flash_attention.py repeats dq_smem to pick the batch groups.
size_t dkdv_smem(int kD, const FlashParams& p) {
  const size_t bias =
      p.bias ? 2 * bias_tile_bytes(bias_item(p.bias_type)) : 0;
  return 6 * kTile * (kD + 8) * 2 + 4 * kTile * sizeof(float) + bias;
}
constexpr size_t dq_smem(int kD, int rows) {
  return 4 * kTile * (kD + 8) * 2 + 2 * kTile * sizeof(int) +
         static_cast<size_t>(rows) *
             (2 * kTile * (kD + 8) * 2 + kTile * (kD + 8) * sizeof(float) +
              2 * kTile * sizeof(float));
}

template <typename T, int kD, int kBias>
int dkdv_launch(const FlashParams& p, cudaStream_t st) {
  const dim3 grid(p.Tk / kTile, p.H, p.B);
  if constexpr (Elem<T>::kBiasType == kBiasBf16)
    return flash_launch(flash_bwd_dkdv_kernel<kD, kBias>, grid, kThreads,
                        dkdv_smem(kD, p), p, st);
  else
    return flash_launch(flash_bwd_dkdv_fp16_kernel<kD, kBias>, grid,
                        kThreads, dkdv_smem(kD, p), p, st);
}

template <typename T, int kD, int kBias>
int dq_launch(const FlashParams& p, cudaStream_t st) {
  const int rows = (p.B + p.groups - 1) / p.groups;
  const dim3 grid(p.Tq / kTile, p.H, p.groups);
  if constexpr (Elem<T>::kBiasType == kBiasBf16)
    return flash_launch(flash_bwd_dq_kernel<kD, kBias>, grid, kThreads,
                        dq_smem(kD, rows), p, st);
  else
    return flash_launch(flash_bwd_dq_fp16_kernel<kD, kBias>, grid, kThreads,
                        dq_smem(kD, rows), p, st);
}

// Each kernel instantiated for no bias, an fp32 bias and a bias of the
// operands' type (what takes<T> admits).
template <typename T, int kD>
int dkdv(const FlashParams& p, cudaStream_t st) {
  if (p.bias == nullptr) return dkdv_launch<T, kD, kNoBias>(p, st);
  if (p.bias_type == kBiasF32) return dkdv_launch<T, kD, kBiasF32>(p, st);
  return dkdv_launch<T, kD, Elem<T>::kBiasType>(p, st);
}

template <typename T, int kD>
int dq(const FlashParams& p, cudaStream_t st) {
  if (p.bias == nullptr) return dq_launch<T, kD, kNoBias>(p, st);
  if (p.bias_type == kBiasF32) return dq_launch<T, kD, kBiasF32>(p, st);
  return dq_launch<T, kD, Elem<T>::kBiasType>(p, st);
}

// What the kernels assume and the caller guarantees; checked again here.
// The bias may be fp32 or of the operands' type.
template <typename T>
bool takes(const FlashParams& p) {
  return takes_tiles(p) && p.groups >= 1 && p.groups <= p.B &&
         (p.B + p.groups - 1) / p.groups <= kMaxRows &&
         (p.dbias != nullptr || p.groups == p.B) &&
         (p.bias == nullptr || p.bias_type == kBiasF32 ||
          p.bias_type == Elem<T>::kBiasType);
}

}  // namespace

// Launch on `stream`; each returns the CUDA error (0 on success), or
// cudaErrorInvalidValue for parameters the kernels do not take.
#define UNICORE_FLASH_BWD_ENTRY(NAME, SUFFIX, T)                            \
  extern "C" int unicore_flash_bwd_##NAME##SUFFIX(const FlashParams* p,     \
                                                  void* stream) {           \
    if (p->B == 0 || p->H == 0 || p->Tq == 0 || p->Tk == 0) return 0;       \
    if (!takes<T>(*p)) return static_cast<int>(cudaErrorInvalidValue);      \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                    \
    return p->D <= 32   ? NAME<T, 32>(*p, st)                               \
           : p->D <= 64 ? NAME<T, 64>(*p, st)                               \
                        : NAME<T, 128>(*p, st);                             \
  }

UNICORE_FLASH_BWD_ENTRY(dkdv, , bf16)
UNICORE_FLASH_BWD_ENTRY(dq, , bf16)
UNICORE_FLASH_BWD_ENTRY(dkdv, _fp16, f16)
UNICORE_FLASH_BWD_ENTRY(dq, _fp16, f16)

// Parameters of the flash-attention kernels, shared by flash_attention.cu
// (the fp32 kernels), flash_attention_fwd.cu and flash_attention_bwd.cu
// (the bf16 and fp16 tensor-core kernels), with the launch helper they
// use.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field by field by _Params in ops/flash_attention.py: the
// 8-byte fields first, then the 4-byte ones.  `dbias` is the batch-summed
// [H, Tq, Tk] gradient for the fp32 kernels and the per-group partials
// [groups, H, Tq, Tk] for the tensor-core backward; `groups` splits the
// batch rows of the tensor-core dq/dbias kernel (group g takes rows
// g*B/groups up to (g+1)*B/groups).  `bias_type` is the bias's element
// type, one of the codes below.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  const int* pad;
  const int* seed;
  void* out;
  float* lse;
  const void* dout;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  float* dbias;
  long long sq_b, sq_t, sq_h;
  long long sk_b, sk_t, sk_h;
  long long sv_b, sv_t, sv_h;
  long long sd_b, sd_t, sd_h;
  long long sb_h, sb_q;
  int B, H, Tq, Tk, D;
  int bias_type, causal, dropout;
  int geo_bq, geo_bk, geo_ni, geo_nj;
  int groups;
  float scale, inv_keep;
  uint32_t keep_thresh;
};

// FlashParams::bias_type: the bias's element type, and its size in bytes.
enum : int { kBiasF32 = 0, kBiasBf16 = 1, kBiasF16 = 2 };

__host__ __device__ constexpr int bias_item(int type) {
  return type == kBiasF32 ? 4 : 2;
}

// Launch `kernel` with `threads` a block and `smem_bytes` of dynamic
// shared memory (above 48 KB only after the attribute is raised); returns
// the CUDA error of the attribute call or of the launch, 0 on success.
template <typename K>
int flash_launch(K kernel, dim3 grid, int threads, size_t smem_bytes,
                 const FlashParams& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

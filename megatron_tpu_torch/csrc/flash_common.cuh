// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the TPU kernels' masking constants, the attention-dropout hash, exp2 for
// the wgmma kernels' softmax, the bf16 packing and hi + lo split, and the
// launch helper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int BM = 64;  // q rows per tile
constexpr int BN = 64;  // kv rows per tile
constexpr float NEG_INF = -1e30f;
constexpr float MASK_CLAMP = -1e20f;
constexpr float LOG2E = 1.4426950408889634f;

// murmur3 fmix32 and the dropout keep bit of flash_attention_pallas.py
// `_fmix32` / `_dropout_keep`, in uint32: wrapping multiplies and logical
// shifts give the TPU kernel's int32 bits. The keep bit of (bh = batch * nq
// + q-head, query qi, key kj) depends on absolute positions only, so any
// tiling regenerates the same mask (bh with offsets: struct Dropout below).
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}


__device__ __forceinline__ bool dropout_keep(uint32_t row, int kj,
                                             uint32_t thresh) {
  return (fmix32(row ^ static_cast<uint32_t>(kj)) >> 1) >= thresh;
}

// Attention dropout: off when scale == 0. z = keep ? scale : 0, with scale
// = 1 / (1 - rate) and keep = (hash >> 1) >= thresh = rate * 2^31. The hash
// numbers a row by its place in the whole attention call, bh = (batch +
// batch_offset) * total_heads + head_offset + q-head: a launch over a slice
// of the batch (a data-parallel rank's rows) or of the heads (a tensor-
// parallel rank's) draws exactly that slice of the whole call's mask.
// Offsets 0 and total_heads = nq number the launch's own rows.
struct Dropout {
  uint32_t seed;
  uint32_t thresh;
  float scale;
  int batch_offset;
  int head_offset;
  int total_heads;
};

__device__ __forceinline__ uint32_t dropout_row(const Dropout& d, int bi,
                                                int h, int qi) {
  const int bh = (bi + d.batch_offset) * d.total_heads + d.head_offset + h;
  return fmix32(d.seed ^ (static_cast<uint32_t>(bh) * 0x9e3779b1u) ^
                (static_cast<uint32_t>(qi) * 0x61c88647u));
}

// --- arithmetic helpers -----------------------------------------------------

// 2^x on the special-function unit (scores are kept in log2 units)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x as hi + lo, both bf16 pairs: hi carries x's top 8 mantissa bits, lo the
// next 8, so a product through both keeps x at ~fp32 precision
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// raise a kernel's dynamic shared-memory limit, then launch it on `stream`
template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, const Params& p, dim3 grid, int threads,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash

// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the TPU kernels' masking constants, the attention-dropout hash, and the
// bf16 tensor-core helpers (mma.sync m16n8k16 fragments, 16-byte tile
// loads into padded shared memory).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int BM = 64;  // q rows per tile
constexpr int BN = 64;  // kv rows per tile
constexpr float NEG_INF = -1e30f;
constexpr float MASK_CLAMP = -1e20f;

// murmur3 fmix32 and the dropout keep bit of flash_attention_pallas.py
// `_fmix32` / `_dropout_keep`, in uint32: wrapping multiplies and logical
// shifts give the TPU kernel's int32 bits. The keep bit of (bh = batch * nq
// + q-head, query qi, key kj) depends on absolute positions only, so any
// tiling regenerates the same mask.
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t dropout_row(uint32_t seed, int bh,
                                                int qi) {
  return fmix32(seed ^ (static_cast<uint32_t>(bh) * 0x9e3779b1u) ^
                (static_cast<uint32_t>(qi) * 0x61c88647u));
}

__device__ __forceinline__ bool dropout_keep(uint32_t row, int kj,
                                             uint32_t thresh) {
  return (fmix32(row ^ static_cast<uint32_t>(kj)) >> 1) >= thresh;
}

// Attention dropout: off when scale == 0. z = keep ? scale : 0, with scale
// = 1 / (1 - rate) and keep = (hash >> 1) >= thresh = rate * 2^31.
struct Dropout {
  uint32_t seed;
  uint32_t thresh;
  float scale;
};

// --- bf16 tensor-core helpers ---------------------------------------------

// bf16 elements per shared-memory row: +8 makes the fragment reads of 8 rows
// at one column fall into distinct banks and keeps rows 16-byte aligned
template <int HD>
__host__ __device__ constexpr int mma_pitch() {
  return HD + 8;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (16 rows x 16 columns starting at `base`, row pitch P) of
// a bf16 tile in shared memory, for the lane with fragment row g and
// column pair t4
template <int P>
__device__ __forceinline__ void load_a(uint32_t a[4],
                                       const __nv_bfloat16* base, int g,
                                       int t4) {
  const __nv_bfloat16* r = base + g * P + 2 * t4;
  a[0] = ld32(r);
  a[1] = ld32(r + 8 * P);
  a[2] = ld32(r + 8);
  a[3] = ld32(r + 8 * P + 8);
}

// rows [row0, row0 + 64) of a [s, HD] head slice (row stride `ss`) into a
// shared tile, 16 bytes at a time, by `threads` threads; rows at or past
// `limit` are zero
template <int HD, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int row0, int limit) {
  constexpr int P = mma_pitch<HD>();
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < BM * CHUNKS; e += THREADS) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * P + c) = val;
  }
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

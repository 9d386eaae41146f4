// Fused RMSNorm and LayerNorm, forward and backward, for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the four Pallas TPU kernels of megatron_tpu/ops/fused_norms.py:
// `_rms_fwd_kernel`, `_rms_bwd_kernel`, `_ln_fwd_kernel` and
// `_ln_bwd_kernel`. They compute the same functions on rows x [rows, h]:
//
//   RMSNorm    y = x * r * s,             r = rsqrt(mean(x^2) + eps)
//   LayerNorm  y = (x - mu) * r * s + b,  r = rsqrt(mean((x - mu)^2) + eps)
//
// with the statistics and the affine in fp32 and one cast to x's dtype at
// the end. The backward recomputes the row statistics from x and writes dx
// in x's dtype plus fp32 partial sums of dscale (and dbias) per thread
// block, [blocks, h], which the caller sums, as the TPU kernels write one
// partial row per grid step.
//
// Design. A row is owned by 1, 2, 4 or 8 warps of a 256-thread block
// (`wpr`, chosen by the caller so that each thread holds a few 16-byte
// chunks), so a block holds 8 / wpr rows: one row of Llama's 4096 per
// block, eight rows of a 64-wide test model. Each thread loads its chunks
// of x (and dy) with 16-byte vector loads where the row's bytes allow
// (scalar loads otherwise) and keeps them in shared memory, so x and dy are
// read from device memory once and the later passes read shared memory. Row
// sums go through warp shuffles, then shared memory across the row's
// warps. Rows past the end are masked (the tail block runs its
// reductions with zeros and writes nothing). The backward's blocks stride
// over row groups and keep their per-column dscale/dbias sums in shared
// memory, so the partials are [blocks, h] with a few hundred blocks, not
// one row per input row.
//
// Bound. A norm does a few operations per byte (fp32 sums of squares and an
// affine), far below the H100's ~295 bf16 operations per byte, so the least
// time is bytes over 3.35 TB/s: forward x read and y written once; backward
// x and dy read and dx written once. This first version loads synchronously
// (no cp.async ring) and runs one row per block at transformer widths;
// making it fast is a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Params {
  const void* x;      // [rows, h] contiguous
  const void* dy;     // [rows, h] contiguous, x's dtype (backward)
  const void* scale;  // [h]
  const void* bias;   // [h] (LayerNorm forward)
  void* out;          // forward y, backward dx: [rows, h] in x's dtype
  float* ds_part;     // [gridDim.x, h] (backward)
  float* db_part;     // [gridDim.x, h] (LayerNorm backward)
  long long rows;
  int h;
  int wpr;            // warps per row: 1, 2, 4 or 8
  int s_dtype;        // 0 fp32, 1 bf16
  int b_dtype;
  float eps;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float param(const void* p, int dtype, int i) {
  return dtype == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                    : static_cast<const float*>(p)[i];
}

// One chunk of V consecutive elements: 16 bytes when V > 1.
template <typename T, int V>
struct Chunk {
  // global -> shared copy of the raw chunk, returned as floats
  __device__ static void load(const T* g, T* s, float (&f)[V]) {
    if constexpr (V == 1) {
      const T t = g[0];
      s[0] = t;
      f[0] = to_float(t);
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(g);
      *reinterpret_cast<uint4*>(s) = raw;
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = to_float(t[i]);
    }
  }
  __device__ static void read(const T* s, float (&f)[V]) {
    if constexpr (V == 1) {
      f[0] = to_float(s[0]);
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(s);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = to_float(t[i]);
    }
  }
  __device__ static void store(T* g, const float (&f)[V]) {
    if constexpr (V == 1) {
      g[0] = from_float<T>(f[0]);
    } else {
      uint4 raw;
      T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) t[i] = from_float<T>(f[i]);
      *reinterpret_cast<uint4*>(g) = raw;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums of (a, b) over the threads of one row: every thread of the block
// calls it, the same number of times (it synchronises the block).
struct RowSum {
  float* red;  // [WARPS][2]
  int slot, wir, wpr, lane;
  __device__ float2 operator()(float a, float b) const {
    a = warp_sum(a);
    b = warp_sum(b);
    const int w = slot * wpr + wir;
    if (lane == 0) {
      red[2 * w] = a;
      red[2 * w + 1] = b;
    }
    __syncthreads();
    float2 s = make_float2(0.f, 0.f);
    for (int i = 0; i < wpr; ++i) {
      s.x += red[2 * (slot * wpr + i)];
      s.y += red[2 * (slot * wpr + i) + 1];
    }
    __syncthreads();
    return s;
  }
};

template <typename T, int V, bool LN>
__global__ void __launch_bounds__(THREADS) norm_fwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * WARPS];
  const int tpr = 32 * p.wpr;
  const int rpb = WARPS / p.wpr;
  const int slot = threadIdx.x / tpr;
  const int lt = threadIdx.x % tpr;
  const RowSum row_sum{red, slot, lt / 32, p.wpr, static_cast<int>(threadIdx.x % 32)};
  const int h = p.h;
  const int nch = h / V;
  const long long row = static_cast<long long>(blockIdx.x) * rpb + slot;
  const bool live = row < p.rows;
  const float hf = static_cast<float>(h);
  T* xs = reinterpret_cast<T*>(smem) + static_cast<size_t>(slot) * h;
  const T* x = static_cast<const T*>(p.x) + row * h;

  float acc = 0.f;
  if (live) {
    for (int c = lt; c < nch; c += tpr) {
      float f[V];
      Chunk<T, V>::load(x + c * V, xs + c * V, f);
#pragma unroll
      for (int i = 0; i < V; ++i) acc += LN ? f[i] : f[i] * f[i];
    }
  }
  float sum = row_sum(acc, 0.f).x;
  float mu = 0.f;
  if constexpr (LN) {
    mu = sum / hf;
    acc = 0.f;
    if (live) {
      for (int c = lt; c < nch; c += tpr) {
        float f[V];
        Chunk<T, V>::read(xs + c * V, f);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = f[i] - mu;
          acc += d * d;
        }
      }
    }
    sum = row_sum(acc, 0.f).x;
  }
  const float r = 1.f / sqrtf(sum / hf + p.eps);
  if (!live) return;
  T* y = static_cast<T*>(p.out) + row * h;
  for (int c = lt; c < nch; c += tpr) {
    float f[V];
    Chunk<T, V>::read(xs + c * V, f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int col = c * V + i;
      const float xc = LN ? __fsub_rn(f[i], mu) : f[i];
      float o = __fmul_rn(__fmul_rn(xc, r), param(p.scale, p.s_dtype, col));
      if constexpr (LN) o = __fadd_rn(o, param(p.bias, p.b_dtype, col));
      f[i] = o;
    }
    Chunk<T, V>::store(y + c * V, f);
  }
}

template <typename T, bool LN>
struct BwdSmem {
  // cached x and dy rows (x's dtype), then the fp32 column sums
  __host__ __device__ static size_t cache_bytes(int rpb, int h) {
    const size_t b = 2 * static_cast<size_t>(rpb) * h * sizeof(T);
    return (b + 15) / 16 * 16;
  }
  __host__ __device__ static size_t bytes(int rpb, int h) {
    return cache_bytes(rpb, h) + (LN ? 2 : 1) * static_cast<size_t>(rpb) * h * 4;
  }
};

template <typename T, int V, bool LN>
__global__ void __launch_bounds__(THREADS) norm_bwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * WARPS];
  const int tpr = 32 * p.wpr;
  const int rpb = WARPS / p.wpr;
  const int slot = threadIdx.x / tpr;
  const int lt = threadIdx.x % tpr;
  const RowSum row_sum{red, slot, lt / 32, p.wpr, static_cast<int>(threadIdx.x % 32)};
  const int h = p.h;
  const int nch = h / V;
  const float hf = static_cast<float>(h);
  T* xs = reinterpret_cast<T*>(smem) + static_cast<size_t>(slot) * h;
  T* dys = reinterpret_cast<T*>(smem) + static_cast<size_t>(rpb + slot) * h;
  float* ds_acc = reinterpret_cast<float*>(
                      smem + BwdSmem<T, LN>::cache_bytes(rpb, h)) +
                  static_cast<size_t>(slot) * h;
  float* db_acc = ds_acc + static_cast<size_t>(rpb) * h;  // LayerNorm only
  for (int c = lt; c < nch; c += tpr) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ds_acc[c * V + i] = 0.f;
      if constexpr (LN) db_acc[c * V + i] = 0.f;
    }
  }

  const long long groups = (p.rows + rpb - 1) / rpb;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long row = g * rpb + slot;
    const bool live = row < p.rows;
    const T* x = static_cast<const T*>(p.x) + row * h;
    const T* dy = static_cast<const T*>(p.dy) + row * h;
    float acc = 0.f;
    if (live) {
      for (int c = lt; c < nch; c += tpr) {
        float f[V], d[V];
        Chunk<T, V>::load(x + c * V, xs + c * V, f);
        Chunk<T, V>::load(dy + c * V, dys + c * V, d);
#pragma unroll
        for (int i = 0; i < V; ++i) acc += LN ? f[i] : f[i] * f[i];
      }
    }
    float sum = row_sum(acc, 0.f).x;
    float mu = 0.f;
    if constexpr (LN) {
      mu = sum / hf;
      acc = 0.f;
      if (live) {
        for (int c = lt; c < nch; c += tpr) {
          float f[V];
          Chunk<T, V>::read(xs + c * V, f);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float d = f[i] - mu;
            acc += d * d;
          }
        }
      }
      sum = row_sum(acc, 0.f).x;
    }
    const float r = 1.f / sqrtf(sum / hf + p.eps);
    // sums of g = dy * s and of g * xh, xh = (x - mu) * r
    float sg = 0.f, sgx = 0.f;
    if (live) {
      for (int c = lt; c < nch; c += tpr) {
        float f[V], d[V];
        Chunk<T, V>::read(xs + c * V, f);
        Chunk<T, V>::read(dys + c * V, d);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = __fmul_rn(LN ? __fsub_rn(f[i], mu) : f[i], r);
          const float gi = __fmul_rn(d[i], param(p.scale, p.s_dtype, c * V + i));
          sg += gi;
          sgx += gi * xh;
        }
      }
    }
    const float2 s2 = row_sum(sg, sgx);
    const float gm = s2.x / hf;
    const float cc = s2.y / hf;
    if (!live) continue;
    T* dx = static_cast<T*>(p.out) + row * h;
    for (int c = lt; c < nch; c += tpr) {
      float f[V], d[V];
      Chunk<T, V>::read(xs + c * V, f);
      Chunk<T, V>::read(dys + c * V, d);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int col = c * V + i;
        const float xh = __fmul_rn(LN ? __fsub_rn(f[i], mu) : f[i], r);
        const float gi = __fmul_rn(d[i], param(p.scale, p.s_dtype, col));
        const float gc = LN ? __fsub_rn(gi, gm) : gi;
        ds_acc[col] += d[i] * xh;
        if constexpr (LN) db_acc[col] += d[i];
        f[i] = __fmul_rn(r, __fsub_rn(gc, __fmul_rn(xh, cc)));
      }
      Chunk<T, V>::store(dx + c * V, f);
    }
  }
  __syncthreads();
  // this block's partial column sums, over its row slots
  float* ds0 = reinterpret_cast<float*>(
      smem + BwdSmem<T, LN>::cache_bytes(rpb, h));
  float* db0 = ds0 + static_cast<size_t>(rpb) * h;
  for (int col = threadIdx.x; col < h; col += THREADS) {
    float s = 0.f, b = 0.f;
    for (int k = 0; k < rpb; ++k) {
      s += ds0[static_cast<size_t>(k) * h + col];
      if constexpr (LN) b += db0[static_cast<size_t>(k) * h + col];
    }
    p.ds_part[static_cast<size_t>(blockIdx.x) * h + col] = s;
    if constexpr (LN) p.db_part[static_cast<size_t>(blockIdx.x) * h + col] = b;
  }
}

// a block's opt-in maximum on sm_90: a row too wide for one block is
// refused here, and the wrapper raises on the return code
constexpr size_t SMEM_MAX = 232448;

template <typename Kernel>
cudaError_t run(Kernel kernel, const Params& p, size_t smem, unsigned blocks,
                cudaStream_t stream) {
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool LN>
cudaError_t fwd(const Params& p, bool vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int rpb = WARPS / p.wpr;
  const size_t smem = static_cast<size_t>(rpb) * p.h * sizeof(T);
  const unsigned blocks = static_cast<unsigned>((p.rows + rpb - 1) / rpb);
  if (vec) return run(norm_fwd_kernel<T, V, LN>, p, smem, blocks, stream);
  return run(norm_fwd_kernel<T, 1, LN>, p, smem, blocks, stream);
}

template <typename T, bool LN>
cudaError_t bwd(const Params& p, bool vec, int blocks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const size_t smem = BwdSmem<T, LN>::bytes(WARPS / p.wpr, p.h);
  if (vec) return run(norm_bwd_kernel<T, V, LN>, p, smem, blocks, stream);
  return run(norm_bwd_kernel<T, 1, LN>, p, smem, blocks, stream);
}

bool valid(int x_dtype, int wpr, long long rows, int h) {
  return (x_dtype == 0 || x_dtype == 1) && rows > 0 && h > 0 &&
         (wpr == 1 || wpr == 2 || wpr == 4 || wpr == 8);
}

}  // namespace

// Forward. x_dtype, s_dtype, b_dtype: 0 fp32, 1 bf16; layernorm 0 or 1
// (bias is read only for LayerNorm); vec 1 when h * itemsize is a multiple
// of 16 and x and out are 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int fused_norm_fwd(const void* x, const void* scale,
                              const void* bias, void* out, int x_dtype,
                              int s_dtype, int b_dtype, int layernorm,
                              int vec, long long rows, int h, int wpr,
                              float eps, void* stream) {
  if (!valid(x_dtype, wpr, rows, h)) return cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.scale = scale;
  p.bias = bias;
  p.out = out;
  p.rows = rows;
  p.h = h;
  p.wpr = wpr;
  p.s_dtype = s_dtype;
  p.b_dtype = b_dtype;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return layernorm ? fwd<float, true>(p, vec, st) : fwd<float, false>(p, vec, st);
  return layernorm ? fwd<__nv_bfloat16, true>(p, vec, st)
                   : fwd<__nv_bfloat16, false>(p, vec, st);
}

// Backward: dx [rows, h] in x's dtype, ds_part (and for LayerNorm db_part)
// fp32 [blocks, h]. vec as for the forward, with dy and dx aligned too.
extern "C" int fused_norm_bwd(const void* x, const void* scale,
                              const void* dy, void* dx, void* ds_part,
                              void* db_part, int x_dtype, int s_dtype,
                              int layernorm, int vec, long long rows, int h,
                              int wpr, int blocks, float eps, void* stream) {
  if (!valid(x_dtype, wpr, rows, h) || blocks < 1) return cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.dy = dy;
  p.scale = scale;
  p.out = dx;
  p.ds_part = static_cast<float*>(ds_part);
  p.db_part = static_cast<float*>(db_part);
  p.rows = rows;
  p.h = h;
  p.wpr = wpr;
  p.s_dtype = s_dtype;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return layernorm ? bwd<float, true>(p, vec, blocks, st)
                     : bwd<float, false>(p, vec, blocks, st);
  return layernorm ? bwd<__nv_bfloat16, true>(p, vec, blocks, st)
                   : bwd<__nv_bfloat16, false>(p, vec, blocks, st);
}

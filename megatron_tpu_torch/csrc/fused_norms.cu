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
// in x's dtype, and dscale (and dbias) as fp32 sums over every row, [h],
// in a fixed order.
//
// Bound. A norm does a few operations per byte (fp32 sums of squares and an
// affine), far below the H100's ~295 bf16 operations per byte, so the least
// time is bytes over 3.35 TB/s: forward x read and y written once; backward
// x and dy read and dx written once.
//
// Forward design (`norm_fwd_rows_kernel` or, for rows too wide for its
// registers, `norm_fwd_wide_kernel`), the backward's layout:
// - The row lives in registers. A slot of `wpr` warps owns a row, chunk c
//   of it (16 bytes, or one element on the scalar path) belongs to thread
//   c mod 32 * wpr of the slot, and a thread owns at most NC chunks, 16
//   values at most; the caller's plan (ops/fused_norms_cuda.py `fwd_plan`)
//   picks wpr and NC from h. The scale (and bias) stay in registers as
//   fp32 over every row a thread handles.
// - Slot-local sums: RMSNorm reduces sum x^2 once, LayerNorm sum x and
//   then sum (x - mu)^2, each through warp shuffles and, with more than one
//   warp a row, shared memory behind a named barrier of that slot's warps.
// - Loads stay in flight. The grid is persistent and each slot strides over
//   rows. On the vector path each thread copies its own chunks of the
//   slot's rows with 16-byte cp.async into a ring of RING rows, waits on
//   its own commit groups alone (no barrier guards the ring), and refills a
//   stage as soon as its row is in registers: the next two rows are in
//   flight while one is reduced and written. On the scalar path the next
//   row is loaded into registers while the current one is reduced.
// - Rows over 16 values a thread at 16 warps a row (wider than 8,192
//   values, or 4,096 on the scalar path) take `norm_fwd_wide_kernel`: 1-8
//   warps a row (`wpr`, so that a thread holds a few 16-byte chunks), the
//   row kept in shared memory, sums through shared memory behind block
//   barriers; it takes rows up to a block's shared memory.
// - y keeps the reference's cast order (__fmul_rn, __fsub_rn, __fadd_rn).
//
// Backward design (`norm_bwd_rows_kernel` or, for rows too wide for its
// registers, `norm_bwd_wide_kernel`; then `norm_bwd_colsum_kernel`).
// - The row lives in registers. A row is owned by `wpr` warps (a "slot"),
//   and chunk c of a row (16 bytes, or one element on the scalar path)
//   belongs to thread c mod 32 * wpr of its slot, so lanes load neighbouring
//   chunks. A thread owns at most NC chunks; the caller's plan
//   (ops/fused_norms_cuda.py `bwd_plan`) picks wpr and NC from h.
// - Few row reductions, none block-wide: RMSNorm reduces (sum x^2,
//   sum g x) once, LayerNorm (sum x, sum g) and then (sum (x - mu)^2,
//   sum g (x - mu)), g = dy * s. Each goes through warp shuffles and, with
//   more than one warp a row, shared memory behind a named barrier of that
//   slot's warps alone. c = mean(g * xh) is taken as r * mean(g * (x - mu)):
//   the same fp32 value up to the order of roundings in a sum.
// - Loads stay in flight. The grid is persistent (every SM's resident
//   blocks) and each slot strides over rows. On the vector path each thread
//   copies its own chunks of the slot's next row of x and dy with 16-byte
//   cp.async into a shared-memory ring of RING rows, and waits on its
//   own commit groups alone: no thread reads another's copy, so no barrier
//   guards the ring. On the scalar path (rows whose bytes are not a
//   multiple of 16) the next row is loaded into registers while the current
//   one is reduced.
// - The scale (as fp32) and the column sums of dy * xh (and dy) stay in
//   registers over every row a thread handles. At the end each block sums
//   its slots' columns in slot order through shared memory into one fp32
//   partial row of a workspace, and a second kernel sums the partial rows
//   in block order: the result is the same bits on every run (no atomics).
// - Rows over 16 values a thread at 16 warps a row (wider than 8,192
//   values, or 4,096 on the scalar path) take `norm_bwd_wide_kernel`: one
//   row a block of 16 warps, each thread walking its chunks of x and dy in
//   device memory on every pass (the re-reads hit L1 or L2) and adding into
//   its own columns of the block's partial row in place. It holds nothing
//   a column in registers or shared memory, so it takes any width.
// - dx keeps the kernels' cast order and roundings (__fmul_rn, __fsub_rn
//   where contraction would move a bf16 rounding).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// a rows-kernel block: 8 warps, or 16 when one row takes 16
constexpr int WARPS_MAX = 16;
// rows of the vector path's ring, a slot: in the backward the row in use
// and the next one (3 or 4 were no faster at any measured shape); in the
// forward, which holds its row in registers, the next two
constexpr int RING = 2;

struct Params {
  const void* x;      // [rows, h] contiguous
  const void* scale;  // [h]
  const void* bias;   // [h] (LayerNorm)
  void* out;          // y: [rows, h] in x's dtype
  long long rows;
  int h;
  int wpr;            // warps per row: 1-16 (1-8 in the wide kernel)
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

// Sums of v[0..N) over the threads of one slot (row): warp shuffles, then,
// with more than one warp a row, the warps' sums in warp order through
// `red` behind a barrier of the slot's warps alone. `red` holds two
// buffers taken in turn: a buffer is written again only after the next
// barrier, which every reader of its last use has passed.
template <int N>
struct SlotSum {
  float (*red)[WARPS_MAX][N];  // [2][WARPS_MAX][N]
  int slot, wir, wpr, lane;
  int buf;
  __device__ __forceinline__ void operator()(float (&v)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
    if (wpr == 1) return;
    float(*r)[N] = red[buf];
    buf ^= 1;
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) r[slot * wpr + wir][i] = v[i];
    }
    hopper::named_barrier_sync(1 + slot, 32 * wpr);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = 0.f;
      // unrolled over the most warps a row may take: a loop to the
      // run-time wpr costs more than the predicated loads
#pragma unroll
      for (int w = 0; w < WARPS_MAX; ++w)
        if (w < wpr) s += r[slot * wpr + w][i];
      v[i] = s;
    }
  }
};

// y for the rows of every slot of the grid. A slot of wpr warps owns a
// row; chunk c of it (V elements: 16 bytes, or 1 on the scalar path)
// belongs to thread c mod 32 * wpr of the slot, at most NC chunks a thread,
// NC * V <= 16. The row, the scale and the bias stay in registers as fp32;
// on the vector path each thread copies its own chunks of the slot's next
// two rows with cp.async into a ring of RING rows and refills a stage as
// soon as it holds the stage's row in registers.
template <typename T, int V, int NC, bool LN>
__global__ void __launch_bounds__(32 * WARPS_MAX, 1)
    norm_fwd_rows_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][WARPS_MAX][1];
  const int wpr = p.wpr;
  const int tpr = 32 * wpr;
  const int rpb = blockDim.x / tpr;
  const int slot = threadIdx.x / tpr;
  const int lt = threadIdx.x % tpr;
  SlotSum<1> slot_sum{red, slot, lt / 32, wpr,
                      static_cast<int>(threadIdx.x % 32), 0};
  const int h = p.h;
  const int nch = h / V;
  const float hf = static_cast<float>(h);
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.out);

  // this thread's chunks
  bool own[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) own[j] = lt + j * tpr < nch;

  // the slot's rows: first, first + stride, ...; n of them
  const long long first = static_cast<long long>(blockIdx.x) * rpb + slot;
  const long long stride = static_cast<long long>(gridDim.x) * rpb;
  const int n =
      p.rows > first ? static_cast<int>((p.rows - 1 - first) / stride + 1) : 0;
  // the vector path's ring: [stage][slot][h] in x's dtype; row k of the
  // slot goes to stage k % RING
  T* ring = reinterpret_cast<T*>(smem);
  auto stage_at = [&](int st) {
    return ring + (static_cast<size_t>(st) * rpb + slot) * h;
  };
  // copy the thread's chunks of row k of the slot into its stage, one
  // commit group a row (empty past the slot's last row)
  auto copy_row = [&](int k) {
    if (k < n) {
      const size_t off = static_cast<size_t>(first + k * stride) * h;
      T* st = stage_at(k % RING);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (!own[j]) continue;
        const int e = (lt + j * tpr) * V;
        hopper::cp_async_cg16(st + e, x + off + e);
      }
    }
    hopper::cp_async_commit();
  };
  // the scalar path: row k of the slot straight into registers
  auto load = [&](int k, float (&xf)[NC][V]) {
    const size_t off = static_cast<size_t>(first + k * stride) * h;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = (lt + j * tpr) * V;
#pragma unroll
      for (int i = 0; i < V; ++i)
        xf[j][i] = own[j] ? to_float(x[off + e + i]) : 0.f;
    }
  };

  float nx[NC][V];  // the scalar path's next row
  if constexpr (V > 1) {
    for (int k = 0; k < RING; ++k) copy_row(k);
  } else {
    if (n > 0) load(0, nx);
  }
  // while the first rows arrive: the thread's scale (and bias) as fp32
  float s[NC][V], b[NC][V];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int col = (lt + j * tpr) * V + i;
      s[j][i] = own[j] ? param(p.scale, p.s_dtype, col) : 0.f;
      b[j][i] = LN && own[j] ? param(p.bias, p.b_dtype, col) : 0.f;
    }
  }

  for (int k = 0; k < n; ++k) {
    float xf[NC][V];
    if constexpr (V > 1) {
      // rows 0..k + 1 committed; row k is complete once at most one group
      // is in flight
      hopper::cp_async_wait<RING - 1>();
      const T* st = stage_at(k % RING);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (own[j]) {
          Chunk<T, V>::read(st + (lt + j * tpr) * V, xf[j]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) xf[j][i] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
#pragma unroll
        for (int i = 0; i < V; ++i) xf[j][i] = nx[j][i];
      }
      if (k + 1 < n) load(k + 1, nx);
    }

    // RMSNorm: sum x^2; LayerNorm: sum x (an unowned chunk holds 0)
    float v[1] = {0.f};
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[0] += LN ? xf[j][i] : xf[j][i] * xf[j][i];
    }
    // the sum above has consumed the stage's values: row k + RING may
    // overwrite them
    if constexpr (V > 1) copy_row(k + RING);
    slot_sum(v);
    float mu = 0.f;
    if constexpr (LN) {
      // then sum (x - mu)^2 over the owned chunks
      mu = v[0] / hf;
      v[0] = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (!own[j]) continue;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = xf[j][i] - mu;
          v[0] += d * d;
        }
      }
      slot_sum(v);
    }
    const float r = 1.f / sqrtf(v[0] / hf + p.eps);

    const size_t off = static_cast<size_t>(first + k * stride) * h;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (!own[j]) continue;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xc = LN ? __fsub_rn(xf[j][i], mu) : xf[j][i];
        o[i] = __fmul_rn(__fmul_rn(xc, r), s[j][i]);
        if constexpr (LN) o[i] = __fadd_rn(o[i], b[j][i]);
      }
      Chunk<T, V>::store(y + off + (lt + j * tpr) * V, o);
    }
  }
}

// y for rows too wide for norm_fwd_rows_kernel's registers: a row is owned
// by 1, 2, 4 or 8 warps of a 256-thread block (the caller's wpr), so a
// block holds 8 / wpr rows, one each; each thread loads its chunks of x
// once and keeps them in shared memory, and the row sums go through warp
// shuffles, then shared memory across the row's warps.
template <typename T, int V, bool LN>
__global__ void __launch_bounds__(THREADS) norm_fwd_wide_kernel(Params p) {
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

struct BwdParams {
  const void* x;      // [rows, h] contiguous
  const void* dy;     // [rows, h] contiguous, x's dtype
  const void* scale;  // [h]
  void* dx;           // [rows, h] in x's dtype
  float* part;        // [1 + LayerNorm][gridDim.x][h] partial column sums
  long long rows;
  int h;
  int wpr;            // warps per row: 1, 2, 4, 8 or 16
  int s_dtype;        // 0 fp32, 1 bf16
  float eps;
};

// dx for the rows of every slot of the grid, and each block's partial
// column sums of dy * xh (and dy). V elements a chunk (16 bytes, or 1 on
// the scalar path), at most NC chunks a thread, NC * V <= 16: at most 128
// registers a thread, so an SM holds two blocks of 8 warps or one of 16.
template <typename T, int V, int NC, bool LN>
__global__ void __launch_bounds__(32 * WARPS_MAX, 1)
    norm_bwd_rows_kernel(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][WARPS_MAX][2];
  const int wpr = p.wpr;
  const int tpr = 32 * wpr;
  const int rpb = blockDim.x / tpr;
  const int slot = threadIdx.x / tpr;
  const int lt = threadIdx.x % tpr;
  SlotSum<2> slot_sum{red, slot, lt / 32, wpr,
                      static_cast<int>(threadIdx.x % 32), 0};
  const int h = p.h;
  const int nch = h / V;
  const float hf = static_cast<float>(h);
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  T* dx = static_cast<T*>(p.dx);

  // this thread's chunks
  bool own[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) own[j] = lt + j * tpr < nch;

  // the slot's rows: first, first + stride, ...; n of them
  const long long first = static_cast<long long>(blockIdx.x) * rpb + slot;
  const long long stride = static_cast<long long>(gridDim.x) * rpb;
  const int n =
      p.rows > first ? static_cast<int>((p.rows - 1 - first) / stride + 1) : 0;
  // the vector path's ring: [stage][slot][x, dy][h] in x's dtype; row k of
  // the slot goes to stage k % RING
  T* ring = reinterpret_cast<T*>(smem);
  auto stage_at = [&](int st) {
    return ring + (static_cast<size_t>(st) * rpb + slot) * 2 * h;
  };
  // copy the thread's chunks of row k of the slot into its stage, one
  // commit group a row (empty past the slot's last row)
  auto copy_row = [&](int k) {
    if (k < n) {
      const size_t off = static_cast<size_t>(first + k * stride) * h;
      T* st = stage_at(k % RING);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (!own[j]) continue;
        const int e = (lt + j * tpr) * V;
        hopper::cp_async_cg16(st + e, x + off + e);
        hopper::cp_async_cg16(st + h + e, dy + off + e);
      }
    }
    hopper::cp_async_commit();
  };
  // the scalar path: row k of the slot straight into registers
  auto load = [&](int k, float (&xf)[NC][V], float (&df)[NC][V]) {
    const size_t off = static_cast<size_t>(first + k * stride) * h;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = (lt + j * tpr) * V;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        xf[j][i] = own[j] ? to_float(x[off + e + i]) : 0.f;
        df[j][i] = own[j] ? to_float(dy[off + e + i]) : 0.f;
      }
    }
  };

  float nx[NC][V], nd[NC][V];  // the scalar path's next row
  if constexpr (V > 1) {
    for (int k = 0; k < RING - 1; ++k) copy_row(k);
  } else {
    if (n > 0) load(0, nx, nd);
  }
  // while the first rows arrive: the thread's scale as fp32, its column
  // sums
  float s[NC][V], ds[NC][V], db[NC][V];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[j][i] = own[j] ? param(p.scale, p.s_dtype, (lt + j * tpr) * V + i)
                       : 0.f;
      ds[j][i] = 0.f;
      db[j][i] = 0.f;
    }
  }

  for (int k = 0; k < n; ++k) {
    float xf[NC][V], df[NC][V];
    if constexpr (V > 1) {
      // k + RING groups committed; rows 0..k complete once at most
      // RING - 1 are in flight. The stage refilled here held row k - 1,
      // which this thread read and used in the last iteration.
      copy_row(k + RING - 1);
      hopper::cp_async_wait<RING - 1>();
      const T* st = stage_at(k % RING);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int e = (lt + j * tpr) * V;
        if (own[j]) {
          Chunk<T, V>::read(st + e, xf[j]);
          Chunk<T, V>::read(st + h + e, df[j]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) xf[j][i] = df[j][i] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          xf[j][i] = nx[j][i];
          df[j][i] = nd[j][i];
        }
      }
      if (k + 1 < n) load(k + 1, nx, nd);
    }

    // RMSNorm: (sum x^2, sum g x); LayerNorm: (sum x, sum g), g = dy * s
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float g = __fmul_rn(df[j][i], s[j][i]);
        if constexpr (LN) {
          v[0] += xf[j][i];
          v[1] += g;
        } else {
          v[0] += xf[j][i] * xf[j][i];
          v[1] += g * xf[j][i];
        }
      }
    }
    slot_sum(v);
    float gm = 0.f;
    if constexpr (LN) {
      // then (sum (x - mu)^2, sum g (x - mu)) over the owned chunks (an
      // unowned one holds x = 0, which must not add mu^2); xf keeps x - mu
      const float mu = v[0] / hf;
      gm = v[1] / hf;
      v[0] = v[1] = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (!own[j]) continue;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = __fsub_rn(xf[j][i], mu);
          xf[j][i] = d;
          v[0] += d * d;
          v[1] += __fmul_rn(df[j][i], s[j][i]) * d;
        }
      }
      slot_sum(v);
    }
    const float r = 1.f / sqrtf(v[0] / hf + p.eps);
    const float cc = r * v[1] / hf;  // mean(g * xh)

    const size_t off = static_cast<size_t>(first + k * stride) * h;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (!own[j]) continue;
      const int e = (lt + j * tpr) * V;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = __fmul_rn(xf[j][i], r);  // LayerNorm: x - mu
        const float gi = __fmul_rn(df[j][i], s[j][i]);
        const float gc = LN ? __fsub_rn(gi, gm) : gi;
        ds[j][i] += df[j][i] * xh;
        if constexpr (LN) db[j][i] += df[j][i];
        o[i] = __fmul_rn(r, __fsub_rn(gc, __fmul_rn(xh, cc)));
      }
      Chunk<T, V>::store(dx + off + e, o);
    }
  }

  // this block's partial column sums, its slots added in slot order, in
  // the ring's shared memory: [1 + LN][rpb][h] fp32
  if constexpr (V > 1) hopper::cp_async_wait<0>();
  __syncthreads();
  constexpr int NACC = LN ? 2 : 1;
  float* acc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (!own[j]) continue;
    const int e = (lt + j * tpr) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      acc[static_cast<size_t>(slot) * h + e + i] = ds[j][i];
      if constexpr (LN)
        acc[static_cast<size_t>(rpb + slot) * h + e + i] = db[j][i];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < h; col += blockDim.x) {
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      float t = 0.f;
      for (int sl = 0; sl < rpb; ++sl)
        t += acc[static_cast<size_t>(a * rpb + sl) * h + col];
      p.part[(static_cast<size_t>(a) * gridDim.x + blockIdx.x) * h + col] = t;
    }
  }
}

// V consecutive fp32 values (16-byte aligned when V > 1)
template <int V>
struct Floats {
  __device__ static void load(const float* f, float (&v)[V]) {
    if constexpr (V == 1) {
      v[0] = f[0];
    } else {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 t = reinterpret_cast<const float4*>(f)[q];
        v[4 * q] = t.x;
        v[4 * q + 1] = t.y;
        v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
      }
    }
  }
  __device__ static void store(float* f, const float (&v)[V]) {
    if constexpr (V == 1) {
      f[0] = v[0];
    } else {
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        reinterpret_cast<float4*>(f)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
};

// dx for rows too wide for norm_bwd_rows_kernel's registers, and each
// block's partial column sums. One row a block of WARPS_MAX warps, the
// blocks striding over rows; chunk c of a row (V elements) belongs to
// thread c mod the block's threads, as in the rows kernel. Each pass walks
// the thread's chunks of x and dy in device memory; dy * xh (and dy) go
// straight into the thread's own columns of the block's partial row, which
// no other thread touches. A chunk's loads (x, dy, scale, its column sums)
// all start before any of its stores.
template <typename T, int V, bool LN>
__global__ void __launch_bounds__(32 * WARPS_MAX, 1)
    norm_bwd_wide_kernel(BwdParams p) {
  __shared__ float red[2][WARPS_MAX][2];
  constexpr int tpr = 32 * WARPS_MAX;
  const int lt = threadIdx.x;
  SlotSum<2> slot_sum{red, 0, lt / 32, WARPS_MAX, lt % 32, 0};
  const int h = p.h;
  const int nch = h / V;
  const float hf = static_cast<float>(h);
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  T* dx = static_cast<T*>(p.dx);
  float* ds_row = p.part + static_cast<size_t>(blockIdx.x) * h;
  float* db_row = ds_row + static_cast<size_t>(gridDim.x) * h;
  auto chunk = [&](const T* xr, const T* dyr, int e, float (&xf)[V],
                   float (&df)[V], float (&sv)[V]) {
    Chunk<T, V>::read(xr + e, xf);
    Chunk<T, V>::read(dyr + e, df);
#pragma unroll
    for (int i = 0; i < V; ++i) sv[i] = param(p.scale, p.s_dtype, e + i);
  };
  const float zero[V] = {};
  for (int c = lt; c < nch; c += tpr) {
    Floats<V>::store(ds_row + c * V, zero);
    if constexpr (LN) Floats<V>::store(db_row + c * V, zero);
  }

  for (long long row = blockIdx.x; row < p.rows; row += gridDim.x) {
    const T* xr = x + row * h;
    const T* dyr = dy + row * h;
    // as the rows kernel: RMSNorm (sum x^2, sum g x), LayerNorm (sum x,
    // sum g), then (sum (x - mu)^2, sum g (x - mu))
    float v[2] = {0.f, 0.f};
    for (int c = lt; c < nch; c += tpr) {
      float xf[V], df[V], sv[V];
      chunk(xr, dyr, c * V, xf, df, sv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float g = __fmul_rn(df[i], sv[i]);
        if constexpr (LN) {
          v[0] += xf[i];
          v[1] += g;
        } else {
          v[0] += xf[i] * xf[i];
          v[1] += g * xf[i];
        }
      }
    }
    slot_sum(v);
    float mu = 0.f, gm = 0.f;
    if constexpr (LN) {
      mu = v[0] / hf;
      gm = v[1] / hf;
      v[0] = v[1] = 0.f;
      for (int c = lt; c < nch; c += tpr) {
        float xf[V], df[V], sv[V];
        chunk(xr, dyr, c * V, xf, df, sv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = __fsub_rn(xf[i], mu);
          v[0] += d * d;
          v[1] += __fmul_rn(df[i], sv[i]) * d;
        }
      }
      slot_sum(v);
    }
    const float r = 1.f / sqrtf(v[0] / hf + p.eps);
    const float cc = r * v[1] / hf;  // mean(g * xh)

    for (int c = lt; c < nch; c += tpr) {
      const int e = c * V;
      float xf[V], df[V], sv[V], ds[V], db[V], o[V];
      chunk(xr, dyr, e, xf, df, sv);
      Floats<V>::load(ds_row + e, ds);
      if constexpr (LN) Floats<V>::load(db_row + e, db);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xc = LN ? __fsub_rn(xf[i], mu) : xf[i];
        const float xh = __fmul_rn(xc, r);
        const float gi = __fmul_rn(df[i], sv[i]);
        const float gc = LN ? __fsub_rn(gi, gm) : gi;
        ds[i] += df[i] * xh;
        if constexpr (LN) db[i] += df[i];
        o[i] = __fmul_rn(r, __fsub_rn(gc, __fmul_rn(xh, cc)));
      }
      Chunk<T, V>::store(dx + row * h + e, o);
      Floats<V>::store(ds_row + e, ds);
      if constexpr (LN) Floats<V>::store(db_row + e, db);
    }
  }
}

// out[a][col] = the sum over b of part[a][b][col], b in order. A block
// takes 32 columns with 32 groups of rows: group g adds rows g, g + 32, ...
// in order, then the groups' sums are added in group order.
constexpr int COLSUM_THREADS = 1024;

__global__ void __launch_bounds__(COLSUM_THREADS)
    norm_bwd_colsum_kernel(const float* part, float* out, int blocks, int h) {
  __shared__ float red[32][33];
  const int lane = threadIdx.x % 32;
  const int g = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const float* src = part + static_cast<size_t>(blockIdx.y) * blocks * h;
  float t = 0.f;
  if (col < h) {
#pragma unroll 8
    for (int b = g; b < blocks; b += 32)
      t += src[static_cast<size_t>(b) * h + col];
  }
  red[g][lane] = t;
  __syncthreads();
  if (g == 0 && col < h) {
    float u = 0.f;
    for (int i = 0; i < 32; ++i) u += red[i][lane];
    out[static_cast<size_t>(blockIdx.y) * h + col] = u;
  }
}

// a block's opt-in maximum on sm_90: a row too wide for one block is
// refused here, and the wrapper raises on the return code
constexpr size_t SMEM_MAX = 232448;

template <typename Kernel, typename P>
cudaError_t run(Kernel kernel, const P& p, size_t smem, unsigned blocks,
                cudaStream_t stream, int threads = THREADS) {
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the instantiations, NC * V <= 16, or nc 0 for the wide kernel; a rows
// block of 8 warps, or of 16 when a row takes 16
template <typename T, int V, bool LN>
cudaError_t fwd_rows(const Params& p, int nc, size_t smem, unsigned blocks,
                     cudaStream_t stream) {
  if (nc == 0)
    return run(norm_fwd_wide_kernel<T, V, LN>, p, smem, blocks, stream);
  const int threads = 32 * (p.wpr > WARPS ? p.wpr : WARPS);
  if (nc == 2)
    return run(norm_fwd_rows_kernel<T, V, 2, LN>, p, smem, blocks, stream,
               threads);
  if constexpr (4 * V <= 16) {
    if (nc == 4)
      return run(norm_fwd_rows_kernel<T, V, 4, LN>, p, smem, blocks, stream,
                 threads);
  }
  if constexpr (8 * V <= 16) {
    if (nc == 8)
      return run(norm_fwd_rows_kernel<T, V, 8, LN>, p, smem, blocks, stream,
                 threads);
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool LN>
cudaError_t fwd(const Params& p, bool vec, int nc, size_t smem,
                unsigned blocks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec) return fwd_rows<T, V, LN>(p, nc, smem, blocks, stream);
  return fwd_rows<T, 1, LN>(p, nc, smem, blocks, stream);
}

// as fwd_rows
template <typename T, int V, bool LN>
cudaError_t bwd_rows(const BwdParams& p, int nc, size_t smem,
                     unsigned blocks, cudaStream_t stream) {
  const int threads = 32 * (p.wpr > WARPS ? p.wpr : WARPS);
  if (nc == 0)
    return run(norm_bwd_wide_kernel<T, V, LN>, p, smem, blocks, stream,
               threads);
  if (nc == 2)
    return run(norm_bwd_rows_kernel<T, V, 2, LN>, p, smem, blocks, stream,
               threads);
  if constexpr (4 * V <= 16) {
    if (nc == 4)
      return run(norm_bwd_rows_kernel<T, V, 4, LN>, p, smem, blocks, stream,
                 threads);
  }
  if constexpr (8 * V <= 16) {
    if (nc == 8)
      return run(norm_bwd_rows_kernel<T, V, 8, LN>, p, smem, blocks, stream,
                 threads);
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool LN>
cudaError_t bwd(const BwdParams& p, bool vec, int nc, size_t smem,
                unsigned blocks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec) return bwd_rows<T, V, LN>(p, nc, smem, blocks, stream);
  return bwd_rows<T, 1, LN>(p, nc, smem, blocks, stream);
}

// warps per row: a power of two up to max_wpr
bool valid(int x_dtype, int wpr, long long rows, int h,
           int max_wpr = WARPS) {
  return (x_dtype == 0 || x_dtype == 1) && rows > 0 && h > 0 && wpr >= 1 &&
         wpr <= max_wpr && (wpr & (wpr - 1)) == 0;
}

}  // namespace

// Forward. x_dtype, s_dtype, b_dtype: 0 fp32, 1 bf16; layernorm 0 or 1
// (bias is read only for LayerNorm); vec 1 when h * itemsize is a multiple
// of 16 and x and out are 16-byte aligned. The launch plan
// (ops/fused_norms_cuda.py `fwd_plan`) gives wpr (1-16), nc (chunks a
// thread holds: 2, 4 or 8; 0 for the wide kernel, at most 8 warps a row),
// blocks and smem (dynamic shared bytes: the ring, or the wide kernel's
// rows). Returns the launch's cudaError_t.
extern "C" int fused_norm_fwd(const void* x, const void* scale,
                              const void* bias, void* out, int x_dtype,
                              int s_dtype, int b_dtype, int layernorm,
                              int vec, long long rows, int h, int wpr,
                              int nc, int blocks, int smem, float eps,
                              void* stream) {
  if (!valid(x_dtype, wpr, rows, h, nc == 0 ? WARPS : WARPS_MAX) ||
      blocks < 1 || smem < 0)
    return cudaErrorInvalidValue;
  const size_t item = x_dtype == 0 ? 4 : 2;
  const int v = vec ? static_cast<int>(16 / item) : 1;
  const int rpb = wpr > WARPS ? 1 : WARPS / wpr;
  const size_t rows_bytes = static_cast<size_t>(rpb) * h * item;
  if (vec && (h * item) % 16 != 0) return cudaErrorInvalidValue;
  // the wide kernel keeps its rows in shared memory; the rows kernel's
  // chunks must fit its threads, and its ring the shared memory
  if (nc == 0 ? static_cast<size_t>(smem) < rows_bytes
              : (static_cast<long long>(nc) * 32 * wpr * v < h ||
                 static_cast<size_t>(smem) < (vec ? RING * rows_bytes : 0)))
    return cudaErrorInvalidValue;
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
  const unsigned nb = static_cast<unsigned>(blocks);
  if (x_dtype == 0)
    return layernorm ? fwd<float, true>(p, vec, nc, smem, nb, st)
                     : fwd<float, false>(p, vec, nc, smem, nb, st);
  return layernorm ? fwd<__nv_bfloat16, true>(p, vec, nc, smem, nb, st)
                   : fwd<__nv_bfloat16, false>(p, vec, nc, smem, nb, st);
}

// Backward. dx [rows, h] in x's dtype; out fp32 [1 + layernorm][h]: dscale
// (and dbias) summed over every row; ws fp32 [1 + layernorm][blocks][h],
// the blocks' partial rows. The launch plan (ops/fused_norms_cuda.py
// `bwd_plan`) gives wpr (1-16), nc (chunks a thread holds: 2, 4 or 8; 0
// for the wide kernel, at wpr 16), blocks and smem (dynamic shared bytes);
// vec as for the forward, with dy and dx aligned too. Returns the first
// failing launch's cudaError_t: two launches on the stream, the rows (or
// wide) kernel and the column sum.
extern "C" int fused_norm_bwd(const void* x, const void* scale,
                              const void* dy, void* dx, void* ws, void* out,
                              int x_dtype, int s_dtype, int layernorm,
                              int vec, long long rows, int h, int wpr,
                              int nc, int blocks, int smem, float eps,
                              void* stream) {
  if (!valid(x_dtype, wpr, rows, h, WARPS_MAX) || blocks < 1 ||
      smem < 0 || (nc == 0 && wpr != WARPS_MAX))
    return cudaErrorInvalidValue;
  const size_t item = x_dtype == 0 ? 4 : 2;
  const int v = vec ? static_cast<int>(16 / item) : 1;
  const int rpb = wpr > WARPS ? 1 : WARPS / wpr;
  // the rows kernel's chunks must fit the threads, and its ring and column
  // sums the shared memory
  if (vec && (h * item) % 16 != 0) return cudaErrorInvalidValue;
  if (nc > 0) {
    if (static_cast<long long>(nc) * 32 * wpr * v < h)
      return cudaErrorInvalidValue;
    const size_t need_ring =
        vec ? static_cast<size_t>(RING) * rpb * 2 * h * item : 0;
    const size_t need_sums =
        static_cast<size_t>(layernorm ? 2 : 1) * rpb * h * sizeof(float);
    if (static_cast<size_t>(smem) < need_ring ||
        static_cast<size_t>(smem) < need_sums)
      return cudaErrorInvalidValue;
  }
  BwdParams p{};
  p.x = x;
  p.dy = dy;
  p.scale = scale;
  p.dx = dx;
  p.part = static_cast<float*>(ws);
  p.rows = rows;
  p.h = h;
  p.wpr = wpr;
  p.s_dtype = s_dtype;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  cudaError_t err;
  if (x_dtype == 0)
    err = layernorm ? bwd<float, true>(p, vec, nc, smem, nb, st)
                    : bwd<float, false>(p, vec, nc, smem, nb, st);
  else
    err = layernorm ? bwd<__nv_bfloat16, true>(p, vec, nc, smem, nb, st)
                    : bwd<__nv_bfloat16, false>(p, vec, nc, smem, nb, st);
  if (err != cudaSuccess) return err;
  const dim3 grid((h + 31) / 32, layernorm ? 2 : 1);
  norm_bwd_colsum_kernel<<<grid, COLSUM_THREADS, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), blocks, h);
  return cudaGetLastError();
}

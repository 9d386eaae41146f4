// Block-native decode attention for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel `_bn_kernel`
// (megatron_tpu/ops/block_attention_pallas.py, launched by
// `block_native_attention`). It computes the same function: the w queries
// of serving slot s sit at positions lengths[s] .. lengths[s] + w - 1 and
// attend, causally, to the slot's keys at positions 0 .. their own, which
// live in a flat arena k/v [T, B, nkv, hd] at physical block
// map[s, pos / B], row pos % B. GQA: q-head h reads kv-head h / group.
// int8 arenas carry fp32 scales [T, B, nkv, 1] per (token, head) and are
// dequantized after the load. Softmax statistics (m, l) and the output sum
// stay in fp32; the output is written in q's dtype.
//
// Design. One thread block owns one (slot, kv head, chunk of up to 8
// query rows; 1 when the kv head has a single row, as in MHA decode): the
// g * w rows of a kv head are that head's group of q-heads times the w
// queries, so MQA and GQA read each kv head once per chunk and never
// broadcast it. The block walks the slot's live keys, 0 .. lengths[s] +
// w - 1, in tiles of 128 keys: each key's physical row is read through the
// map once into shared memory, then all 128 threads load the K tile and the
// V tile with 16-byte loads, 8 of each in flight per thread, so the arena
// is read in place (no gathered [S, cap] view, no gather kernel). Blocks
// past the last live key are neither loaded nor computed: a slot's work is
// its live length, not the region's capacity. Each of the 4 warps then
// owns 32 keys of the tile, one per lane: a lane computes its key's score
// against every row of the chunk, the warp keeps its own running (m, l)
// per row in registers and its output sum spread over the lanes (hd / 32
// dims each), and P V reads V rows that the lanes share. After the last
// tile the four warps' partial states are merged in shared memory.
// Shared-memory rows are padded by 16 bytes, so the lanes' 16-byte reads of
// 32 different key rows hit distinct banks.
//
// Masking follows the TPU kernel: masked scores are NEG_INF = -1e30 and the
// exponent is clamped at MASK_CLAMP = -1e20, so a row with no visible key
// in a warp's slice adds nothing; a row whose l stays 0 divides by 1.
// Key 0 is visible to every row, so an idle slot (length 0, map on the
// trash block) reads one garbage row and returns finite output.
//
// Bound. Decode does 4 hd FLOPs per (query row, live key) against 4 hd
// bytes of bf16 K and V per (kv head, live key): with g * w query rows per
// kv head that is g * w FLOP per byte, far below the H100's ~295, so the
// least time is the live K/V bytes (plus q and out) over 3.35 TB/s. What
// this first version leaves on the table: loads are synchronous (no
// cp.async / TMA ring overlapping the next tile with this tile's math),
// and one slot's keys are walked by one block (no split-KV across blocks,
// so the longest slot's tiles run one after another and MQA gets only
// S * ceil(g * w / 8) blocks). Those are a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TN = 32 * WARPS;  // keys per tile, one per lane
constexpr int RMAX = 8;         // query rows per block, at most
constexpr float NEG_INF = -1e30f;
constexpr float MASK_CLAMP = -1e20f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // [T, B, nkv] fp32, int8 arenas only
  const float* v_scale;
  const int* map;        // [S, nb] int32
  const int* lengths;    // [S] int32
  void* out;             // [S, w, nq, hd] contiguous, q's dtype
  int S, w, nq, nkv, group, B, nb;
  long long q_s0, q_s1, q_s2;  // q strides (elements) of slot, query, head
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of an arena row as floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * j + b] = static_cast<float>(
            static_cast<int8_t>((w[j] >> (8 * b)) & 0xffu));
  }
};

// Shared memory: the K and V tiles (reused for the warps' partial states
// after the last tile), each tile key's arena row, the tile's int8 scales,
// the chunk's scaled q rows, and each warp's probabilities.
template <typename KT, int HD, int ROWS>
struct Smem {
  static constexpr int PITCH = HD + 16 / sizeof(KT);  // elements per row
  static constexpr int TILE = TN * PITCH * sizeof(KT);
  static constexpr int RED = WARPS * ROWS * (HD + 2) * 4;
  static constexpr int A = 2 * TILE > RED ? 2 * TILE : RED;
  static constexpr int ROW = A;                      // TN long longs
  static constexpr int SCALES = ROW + TN * 8;        // 2 * TN floats
  static constexpr int Q = SCALES + 2 * TN * 4;      // ROWS * HD floats
  static constexpr int P = Q + ROWS * HD * 4;        // WARPS * ROWS * 32
  static constexpr int BYTES = P + WARPS * ROWS * 32 * 4;
};

// ROWS is the most query rows a block holds: 1 when a kv head has one
// (MHA decode, the main path), else RMAX
template <typename QT, typename KT, int HD, int ROWS>
__global__ void __launch_bounds__(THREADS)
    block_attn_kernel(const Params p) {
  using L = Smem<KT, HD, ROWS>;
  constexpr int PITCH = L::PITCH;
  constexpr int VN = Vec<KT>::N;
  constexpr int CHUNKS = HD / VN;  // 16-byte loads per key row
  constexpr int DPL = HD / 32;     // output dims per lane
  constexpr bool QUANT = sizeof(KT) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  KT* k_tile = reinterpret_cast<KT*>(smem);
  KT* v_tile = reinterpret_cast<KT*>(smem + L::TILE);
  long long* row_s = reinterpret_cast<long long*>(smem + L::ROW);
  float* k_sc = reinterpret_cast<float*>(smem + L::SCALES);
  float* v_sc = k_sc + TN;
  float* q_s = reinterpret_cast<float*>(smem + L::Q);
  float* p_s = reinterpret_cast<float*>(smem + L::P);

  const int chunk = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = chunk * ROWS;
  const int R = min(ROWS, p.group * p.w - r0);
  const int len = p.lengths[s];
  const int n_keys = min(len + p.w, p.nb * p.B);  // live keys 0 .. n_keys-1

  // the chunk's q rows, fp32 and pre-scaled as the TPU kernel scales them;
  // row r is (group member r / w, query r % w)
  const QT* q = static_cast<const QT*>(p.q);
  for (int e = threadIdx.x; e < R * HD; e += THREADS) {
    const int i = e / HD, d = e % HD, r = r0 + i;
    const int qh = h * p.group + r / p.w;
    q_s[e] = to_float(q[s * p.q_s0 + (r % p.w) * p.q_s1 + qh * p.q_s2 + d]) *
             p.scale;
  }
  int q_pos[ROWS];
  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    q_pos[i] = len + (r0 + i) % p.w;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  const KT* k_arena = static_cast<const KT*>(p.k);
  const KT* v_arena = static_cast<const KT*>(p.v);
  const int* map_row = p.map + static_cast<long long>(s) * p.nb;
  for (int t0 = 0; t0 < n_keys; t0 += TN) {
    __syncthreads();  // the previous tile is consumed; q_s is written
    // each tile key's arena row, read once through the map (-1: dead)
    for (int kk = threadIdx.x; kk < TN; kk += THREADS) {
      const int pos = t0 + kk;
      long long row = -1;
      if (pos < n_keys)
        row = (static_cast<long long>(map_row[pos / p.B]) * p.B +
               pos % p.B) * p.nkv + h;
      row_s[kk] = row;
      if (QUANT) {
        k_sc[kk] = row >= 0 ? p.k_scale[row] : 0.f;
        v_sc[kk] = row >= 0 ? p.v_scale[row] : 0.f;
      }
    }
    __syncthreads();
    // the K and V tiles, BATCH independent 16-byte loads of each in flight
    // per thread before their stores
    constexpr int PER = TN * CHUNKS / THREADS;
    constexpr int BATCH = PER < 8 ? PER : 8;
#pragma unroll 1
    for (int b0 = 0; b0 < PER; b0 += BATCH) {
      uint4 kv[BATCH], vv[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int e = (b0 + j) * THREADS + threadIdx.x;
        const int kk = e / CHUNKS, c = (e % CHUNKS) * VN;
        const long long row = row_s[kk];
        kv[j] = vv[j] = make_uint4(0, 0, 0, 0);
        if (row >= 0) {
          kv[j] = *reinterpret_cast<const uint4*>(k_arena + row * HD + c);
          vv[j] = *reinterpret_cast<const uint4*>(v_arena + row * HD + c);
        }
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int e = (b0 + j) * THREADS + threadIdx.x;
        const int kk = e / CHUNKS, c = (e % CHUNKS) * VN;
        *reinterpret_cast<uint4*>(k_tile + kk * PITCH + c) = kv[j];
        *reinterpret_cast<uint4*>(v_tile + kk * PITCH + c) = vv[j];
      }
    }
    __syncthreads();
    if (t0 + warp * 32 >= n_keys) continue;  // this warp's keys are all dead

    // scores of this lane's key against every row
    const int kk = warp * 32 + lane;
    const int pos = t0 + kk;
    const KT* k_row = k_tile + kk * PITCH;
    const float ksc = QUANT ? k_sc[kk] : 1.f;
    float sc[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) sc[i] = 0.f;
#pragma unroll 2
    for (int c = 0; c < HD; c += VN) {
      float kf[VN];
      Vec<KT>::unpack(*reinterpret_cast<const uint4*>(k_row + c), kf);
#pragma unroll
      for (int t = 0; t < VN; ++t) {
        if (QUANT) kf[t] *= ksc;
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          if (i < R) sc[i] = fmaf(q_s[i * HD + c + t], kf[t], sc[i]);
      }
    }
    // the warp's online softmax over its 32 keys, one row at a time
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i >= R) break;
      const float sv = (pos < n_keys && pos <= q_pos[i]) ? sc[i] : NEG_INF;
      float mx = sv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float pr = expf(sv - fmaxf(m_new, MASK_CLAMP));
      const float alpha = expf(m[i] - m_new);
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= alpha;
      p_s[(warp * ROWS + i) * 32 + lane] = pr;
    }
    __syncwarp();
    // P V: every lane walks the warp's 32 keys for its hd / 32 dims
    for (int j = 0; j < 32; ++j) {
      const KT* v_row = v_tile + (warp * 32 + j) * PITCH + lane * DPL;
      const float vsc = QUANT ? v_sc[warp * 32 + j] : 1.f;
      float vf[DPL];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) {
        vf[dd] = to_float(v_row[dd]);
        if (QUANT) vf[dd] *= vsc;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (i >= R) break;
        const float pk = p_s[(warp * ROWS + i) * 32 + j];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd)
          acc[i][dd] = fmaf(pk, vf[dd], acc[i][dd]);
      }
    }
    __syncwarp();
  }

  // merge the four warps' partial (m, l, acc) per row
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][ROWS][HD + 2]
  for (int i = 0; i < ROWS; ++i) {
    if (i >= R) break;
    float* dst = red + (warp * ROWS + i) * (HD + 2);
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) dst[lane * DPL + dd] = acc[i][dd];
    if (lane == 0) {
      dst[HD] = m[i];
      dst[HD + 1] = l[i];
    }
  }
  __syncthreads();
  QT* out = static_cast<QT*>(p.out);
  for (int e = threadIdx.x; e < R * HD; e += THREADS) {
    const int i = e / HD, d = e % HD, r = r0 + i;
    float mx = NEG_INF;
    for (int wi = 0; wi < WARPS; ++wi)
      mx = fmaxf(mx, red[(wi * ROWS + i) * (HD + 2) + HD]);
    float lsum = 0.f, a = 0.f;
    for (int wi = 0; wi < WARPS; ++wi) {
      const float* src = red + (wi * ROWS + i) * (HD + 2);
      const float f = expf(src[HD] - mx);
      lsum += src[HD + 1] * f;
      a += src[d] * f;
    }
    const int qh = h * p.group + r / p.w;
    const long long o =
        ((static_cast<long long>(s) * p.w + r % p.w) * p.nq + qh) * HD + d;
    store(out + o, a / (lsum > 0.f ? lsum : 1.f));
  }
}

template <typename QT, typename KT, int HD, int ROWS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = Smem<KT, HD, ROWS>::BYTES;
  auto kernel = block_attn_kernel<QT, KT, HD, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.group * p.w + ROWS - 1) / ROWS, p.nkv, p.S);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KT, int HD>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  if (p.group * p.w == 1) return launch<QT, KT, HD, 1>(p, stream);
  return launch<QT, KT, HD, RMAX>(p, stream);
}

template <typename QT, typename KT>
cudaError_t launch_hd(const Params& p, int hd, cudaStream_t stream) {
  if (hd == 64) return launch_rows<QT, KT, 64>(p, stream);
  if (hd == 128) return launch_rows<QT, KT, 128>(p, stream);
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t launch_kv(const Params& p, int kv_dtype, int hd,
                      cudaStream_t stream) {
  if (kv_dtype == 0) return launch_hd<QT, float>(p, hd, stream);
  if (kv_dtype == 1) return launch_hd<QT, __nv_bfloat16>(p, hd, stream);
  if (kv_dtype == 2) return launch_hd<QT, int8_t>(p, hd, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 fp32, 1 bf16; kv_dtype: 0 fp32, 1 bf16, 2 int8 (with scales).
// Returns the launch's cudaError_t (0 on success).
extern "C" int block_attn(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* map, const void* lengths, void* out,
                          int q_dtype, int kv_dtype, int hd, int S, int w,
                          int nq, int nkv, int B, int nb, long long q_s0,
                          long long q_s1, long long q_s2, float scale,
                          void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.map = static_cast<const int*>(map);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.S = S;
  p.w = w;
  p.nq = nq;
  p.nkv = nkv;
  p.group = nq / nkv;
  p.B = B;
  p.nb = nb;
  p.q_s0 = q_s0;
  p.q_s1 = q_s1;
  p.q_s2 = q_s2;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0) err = launch_kv<float>(p, kv_dtype, hd, st);
  if (q_dtype == 1) err = launch_kv<__nv_bfloat16>(p, kv_dtype, hd, st);
  return static_cast<int>(err);
}

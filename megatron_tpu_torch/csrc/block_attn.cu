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
// Bound. Decode does 4 hd FLOPs per (query row, live key) against 4 hd
// bytes of bf16 K and V per (kv head, live key): with g * w query rows per
// kv head that is g * w FLOP per byte, far below the H100's ~295, so the
// least time is the live K/V bytes (plus q and out) over 3.35 TB/s. What
// holds such a kernel back is latency: a slot's keys read one tile after
// another by one block, and no load in flight while a tile is computed.
// The tile, warp and ring sizes and the split plan's keys were picked by
// timing variants on the card (PERF.md).
//
// Design: split-KV (flash-decoding) behind a cp.async ring.
// - The grid is (kv head x chunk of query rows, slot, split), splits
//   outermost, so every slot's first split is dispatched before any later
//   one. A split is `kps` consecutive keys of the slot, a whole number of
//   its blocks; ops/block_attention_cuda.py `split_plan` picks kps from
//   the shapes alone, so the grid never depends on the lengths and the
//   launch reads nothing on the host. A block whose split starts past the
//   slot's live keys (lengths[s] + w, read on the device) exits at once: a
//   slot's work is its live length, spread over ceil(live / kps) blocks.
// - A chunk holds ROWS query rows of one kv head: 1 when the kv head has a
//   single row (MHA decode), else up to RMAX = 8 of its g * w rows (GQA
//   group times verify window), so MQA and GQA read each kv head once per
//   chunk and never broadcast it.
// - A block loads its split's map entries, the slot's length and its q
//   rows together, once, up front. Each of its 8 warps then walks its own
//   tiles of TK = 8 keys (tiles w, w + 8, ... of the split) through its
//   own ring of 2-4 tiles in shared memory, copied with 16-byte cp.async
//   (the int8 scales with 4-byte ones): the warp's next tiles are in
//   flight while it computes this one. A warp waits on its own commit
//   groups and then __syncwarp; the loop has no block barrier. Keys past
//   the live end are never copied, and no lane reads their ring rows into
//   a result. Small tiles keep a warp's ring small (8 KB at bf16 hd 128,
//   a block's 68 KB), so three blocks of 8 warps, and their loads, are
//   in flight an SM. cp.async rather than TMA: a tile's rows are single
//   arena rows scattered by the map (one 2-D box a key, a descriptor and a
//   barrier each), while a lane copies its own 16-byte pieces with the
//   row it computed, and its warp needs no barrier to wait on them.
// - LPK = 4 lanes a key: lane l scores key l % 8 against a quarter of hd
//   and shuffles add the parts. The warp keeps a running (m, l) per row in
//   registers and its output sum spread over the lanes (hd / 32 dims
//   each); P V reads V rows that the lanes share.
// - After the last tile the warps' states merge in shared memory into the
//   split's (m, l, acc), which the block writes in fp32 to a workspace
//   [S * w * nq][splits] (with one split it writes the output itself).
//   `block_attn_combine_kernel` merges each row's live splits in split
//   order, with no atomics, so two runs give the same bits. It is launched
//   as a programmatic dependent of the split kernel: it starts while the
//   last split blocks run and waits for their results inside.
// - K ring rows are padded by 16 bytes, so the lanes' 16-byte reads of 8
//   different key rows hit distinct banks.
//
// Masking follows the TPU kernel: masked scores are NEG_INF = -1e30 and the
// exponent is clamped at MASK_CLAMP = -1e20, so a row with no visible key
// in a warp's tiles, or in a whole split (a verify window's earliest query
// in a split that only later queries made live), keeps m = NEG_INF and
// l = 0 and adds nothing in either merge; a row whose l stays 0 divides by
// 1. Key 0 is visible to every row, so an idle slot (length 0, map on the
// trash block) reads one garbage row and returns finite output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 8;          // keys a warp's tile holds
constexpr int LPK = 32 / TK;   // lanes a key
constexpr int RMAX = 8;   // query rows per block, at most
constexpr float NEG_INF = -1e30f;
constexpr float MASK_CLAMP = -1e20f;
constexpr unsigned FULL = 0xffffffffu;
// map entries a split holds, at most (split_plan's keys / B is at most
// 256), and a thread's share of them
constexpr int MAP_MAX = 512;
constexpr int MAP_PER = MAP_MAX / THREADS;
// a block's ring, at most (and at least 2 stages a warp): 2 stages of 8
// keys a warp at bf16 hd 128
constexpr int RING_BYTES = 72 * 1024;
// a block's opt-in shared-memory maximum on sm_90
constexpr int SMEM_MAX = 232448;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // [T, B, nkv] fp32, int8 arenas only
  const float* v_scale;
  const int* map;        // [S, nb] int32
  const int* lengths;    // [S] int32
  void* out;             // [S, w, nq, hd] contiguous, q's dtype
  // splits > 1: [S * w * nq][splits][hd] fp32 sums, then [..][splits] (m, l)
  float* ws;
  int S, w, nq, nkv, group, B, nb;
  int kps, splits;       // keys a split (a multiple of B), splits a slot
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

// one 32-bit word of an arena row as floats
__device__ __forceinline__ void decode(uint32_t w, float* f, float) {
  f[0] = __uint_as_float(w);
}
__device__ __forceinline__ void decode(uint32_t w, float* f, __nv_bfloat16) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void decode(uint32_t w, float* f, int8_t) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = static_cast<float>(static_cast<int8_t>((w >> (8 * b)) & 0xffu));
}

// N consecutive elements of an arena row in shared memory as floats, with
// the widest load their bytes allow
template <typename KT, int N>
__device__ __forceinline__ void read_row(const KT* src, float (&f)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(KT));
  constexpr int PER = 4 / static_cast<int>(sizeof(KT));  // values a word
  if constexpr (BYTES == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) decode(w[j], f + j * PER, KT{});
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    decode(u.x, f, KT{});
    decode(u.y, f + PER, KT{});
  } else if constexpr (BYTES == 4) {
    decode(*reinterpret_cast<const uint32_t*>(src), f, KT{});
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_float(src[i]);
  }
}

// Shared memory: each warp's ring of STAGES tiles (reused for the warps'
// states after the last tile), the chunk's scaled q rows, each warp's
// probabilities, and the split's map entries. A tile holds TK K rows
// (padded), TK V rows and, for int8, the TK k and v scales.
template <typename KT, int HD, int ROWS>
struct Smem {
  static constexpr bool QUANT = sizeof(KT) == 1;
  static constexpr int KPITCH = HD + 16 / sizeof(KT);  // elements a K row
  static constexpr int K_BYTES = TK * KPITCH * sizeof(KT);
  static constexpr int V_BYTES = TK * HD * sizeof(KT);
  static constexpr int STAGE = K_BYTES + V_BYTES + (QUANT ? 2 * TK * 4 : 0);
  static constexpr int FIT = RING_BYTES / (WARPS * STAGE);
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 4 ? 4 : FIT);
  static constexpr int RING = WARPS * STAGES * STAGE;
  static constexpr int RED = WARPS * ROWS * (HD + 2) * 4;
  // q row pitch in floats: each lane's part of a row (HD / LPK dims)
  // starts 4 floats after the last one ends, so the parts' broadcast reads
  // fall in different banks
  static constexpr int QP = HD + 4 * LPK;
  static constexpr int Q = RING > RED ? RING : RED;  // ROWS * QP floats
  static constexpr int P = Q + ROWS * QP * 4;        // WARPS * ROWS * TK
  static constexpr int MAP = P + WARPS * ROWS * TK * 4;  // kps / B ints
};

// ROWS is the most query rows a block holds: 1 when a kv head has one
// (MHA decode, the main path), else RMAX
template <typename QT, typename KT, int HD, int ROWS>
__global__ void __launch_bounds__(THREADS)
    block_attn_split_kernel(const Params p) {
  using L = Smem<KT, HD, ROWS>;
  constexpr int VN = 16 / sizeof(KT);  // elements a 16-byte chunk
  constexpr int CH = HD / VN;          // chunks a row
  constexpr int PART = HD / LPK;       // dims a lane scores
  constexpr int DPL = HD / 32;         // output dims a lane
  constexpr bool QUANT = L::QUANT;
  constexpr int Q_PER = (ROWS * HD + THREADS - 1) / THREADS;  // q values
  // fully unrolled for one row; with RMAX rows the loop body's FMAs fill
  // the pipeline already, and unrolling further spills
  constexpr int SCORE_UNROLL = ROWS == 1 ? PART / VN : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::Q);
  float* p_s = reinterpret_cast<float*>(smem + L::P);
  int* map_s = reinterpret_cast<int*>(smem + L::MAP);

  const int chunks = (p.group * p.w + ROWS - 1) / ROWS;
  const int split = blockIdx.z, s = blockIdx.y;
  const int h = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int start = split * p.kps;
  const int r0 = chunk * ROWS;
  const int R = min(ROWS, p.group * p.w - r0);
  // the split's map entries, once, and the chunk's q rows: loads issued
  // together with the length's, so the block waits on one round trip
  const int* map_row = p.map + static_cast<long long>(s) * p.nb + start / p.B;
  const int n_map = min(p.kps / p.B, p.nb - start / p.B);
  const int len = p.lengths[s];
  int mv[MAP_PER];
#pragma unroll
  for (int j = 0; j < MAP_PER; ++j) {
    const int e = j * THREADS + threadIdx.x;
    mv[j] = e < n_map ? map_row[e] : 0;
  }
  const QT* q = static_cast<const QT*>(p.q);
  QT qv[Q_PER];
#pragma unroll
  for (int j = 0; j < Q_PER; ++j) {
    const int e = j * THREADS + threadIdx.x, i = e / HD, r = r0 + i;
    if (i < R)
      qv[j] = q[s * p.q_s0 + (r % p.w) * p.q_s1 +
                (h * p.group + r / p.w) * p.q_s2 + e % HD];
  }
  const int n_keys = min(len + p.w, p.nb * p.B);  // live keys 0 .. n_keys-1
  if (start >= n_keys) return;  // a dead split: nothing to read or write
  hopper::griddep_launch_dependents();
  const int end = min(start + p.kps, n_keys);
#pragma unroll
  for (int j = 0; j < MAP_PER; ++j) {
    const int e = j * THREADS + threadIdx.x;
    if (e < n_map) map_s[e] = mv[j];
  }
  // q fp32 and pre-scaled as the TPU kernel scales it; row r is (group
  // member r / w, query r % w)
#pragma unroll
  for (int j = 0; j < Q_PER; ++j) {
    const int e = j * THREADS + threadIdx.x, i = e / HD, d = e % HD;
    if (i < R) q_s[i * L::QP + d + d / PART * 4] =
        to_float(qv[j]) * p.scale;
  }
  __syncthreads();

  // this warp's tiles of the split: w, w + WARPS, ...
  const int ntiles = (end - start + TK - 1) / TK;
  const int mine = warp < ntiles ? (ntiles - 1 - warp) / WARPS + 1 : 0;
  unsigned char* ring = smem + warp * L::STAGES * L::STAGE;
  const KT* k_arena = static_cast<const KT*>(p.k);
  const KT* v_arena = static_cast<const KT*>(p.v);
  const int kk = lane % TK, part = lane / TK;

  // copy this warp's tile `it` into its stage, one commit group a tile
  // (empty past the warp's last tile); keys past `end` are not copied
  auto issue = [&](int it) {
    if (it < mine) {
      unsigned char* st = ring + (it % L::STAGES) * L::STAGE;
      KT* ks = reinterpret_cast<KT*>(st);
      KT* vs = reinterpret_cast<KT*>(st + L::K_BYTES);
      const int pos = start + (warp + it * WARPS) * TK + kk;
      int row = -1;  // this lane's key's arena row
      if (pos < end)
        row = (map_s[(pos - start) / p.B] * p.B + pos % p.B) * p.nkv + h;
#pragma unroll
      for (int j = 0; j < TK * CH / 32; ++j) {
        const int e = j * 32 + lane, key = e / CH, c = (e % CH) * VN;
        const int r = __shfl_sync(FULL, row, key);
        if (r >= 0) {
          const long long off = static_cast<long long>(r) * HD + c;
          hopper::cp_async_cg16(ks + key * L::KPITCH + c, k_arena + off);
          hopper::cp_async_cg16(vs + key * HD + c, v_arena + off);
        }
      }
      if constexpr (QUANT) {
        // the key's k scale, then its v scale, by its first lanes
        float* sc = reinterpret_cast<float*>(st + L::K_BYTES + L::V_BYTES);
        for (int t = part; t < 2 && row >= 0; t += LPK)
          hopper::cp_async_ca4(sc + t * TK + kk,
                               (t ? p.v_scale : p.k_scale) + row);
      }
    }
    hopper::cp_async_commit();
  };

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

  for (int it = 0; it < L::STAGES - 1; ++it) issue(it);
  for (int it = 0; it < mine; ++it) {
    __syncwarp();  // every lane is done with the stage tile it - 1 used
    issue(it + L::STAGES - 1);
    hopper::cp_async_wait<L::STAGES - 1>();  // this lane's copies of tile it
    __syncwarp();                            // ... and every lane's
    const unsigned char* st = ring + (it % L::STAGES) * L::STAGE;
    const KT* ks = reinterpret_cast<const KT*>(st);
    const KT* vs = reinterpret_cast<const KT*>(st + L::K_BYTES);
    const float* sc = reinterpret_cast<const float*>(st + L::K_BYTES +
                                                     L::V_BYTES);
    const int t0 = start + (warp + it * WARPS) * TK;
    const int live = min(TK, end - t0);  // the tile's live keys
    const int pos = t0 + kk;

    // scores of key kk against every row, HD / LPK dims a lane
    const KT* k_row = ks + kk * L::KPITCH + part * PART;
    const float* qh = q_s + part * (PART + 4);
    float sco[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) sco[i] = 0.f;
#pragma unroll(SCORE_UNROLL)
    for (int c = 0; c < PART; c += VN) {
      float kf[VN];
      read_row(k_row + c, kf);
#pragma unroll
      for (int t = 0; t < VN; ++t) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          if (i < R) sco[i] = fmaf(qh[i * L::QP + c + t], kf[t], sco[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int o = TK; o < 32; o <<= 1)
        sco[i] += __shfl_xor_sync(FULL, sco[i], o);
      if constexpr (QUANT) sco[i] *= sc[kk];
    }
    // the warp's online softmax over the tile's keys, a row at a time
    // (every lane of a key holds its score)
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i >= R) break;
      const float sv = (kk < live && pos <= q_pos[i]) ? sco[i] : NEG_INF;
      float mx = sv;
#pragma unroll
      for (int o = TK / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float pr = expf(sv - fmaxf(m_new, MASK_CLAMP));
      const float alpha = expf(m[i] - m_new);
      float sum = pr;
#pragma unroll
      for (int o = TK / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(FULL, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= alpha;
      // P V takes the probability times the int8 v scale
      if (part == 0)
        p_s[(warp * ROWS + i) * TK + kk] = QUANT ? pr * sc[TK + kk] : pr;
    }
    __syncwarp();
    // P V: every lane walks the tile's live keys for its hd / 32 dims
    for (int j = 0; j < live; ++j) {
      float vf[DPL];
      read_row(vs + j * HD + lane * DPL, vf);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (i >= R) break;
        const float pk = p_s[(warp * ROWS + i) * TK + j];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd)
          acc[i][dd] = fmaf(pk, vf[dd], acc[i][dd]);
      }
    }
  }

  // merge the warps' (m, l, acc) per row into the split's, in the rings'
  // shared memory
  hopper::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][ROWS][HD + 2]
#pragma unroll
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
  const long long rows = static_cast<long long>(p.S) * p.w * p.nq;
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
        (static_cast<long long>(s) * p.w + r % p.w) * p.nq + qh;
    if (p.splits == 1) {
      store(out + o * HD + d, a / (lsum > 0.f ? lsum : 1.f));
    } else {
      const long long rec = o * p.splits + split;
      p.ws[rec * HD + d] = a;
      if (d == 0)
        reinterpret_cast<float2*>(p.ws + rows * p.splits * HD)[rec] =
            make_float2(mx, lsum);
    }
  }
}

// One warp an output row (s, query, q-head): the row's live splits'
// (m, l, acc) merged in split order, then normalised and cast to q's
// dtype. Lane j holds split j's (m, l) (and j + 32's, ...); the stats and
// the row's length load together, and the sums of several splits are in
// flight at once, so a row costs few round trips.
template <typename QT, int HD>
__global__ void __launch_bounds__(THREADS)
    block_attn_combine_kernel(const Params p) {
  constexpr int DPL = HD / 32;
  const long long rows = static_cast<long long>(p.S) * p.w * p.nq;
  const long long o =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (o >= rows) return;
  const int lane = threadIdx.x % 32;
  const int s = static_cast<int>(o / (static_cast<long long>(p.w) * p.nq));
  const float2* ml =
      reinterpret_cast<const float2*>(p.ws + rows * p.splits * HD) +
      o * p.splits;
  const float2 none = make_float2(NEG_INF, 0.f);
  const int n_keys = min(p.lengths[s] + p.w, p.nb * p.B);
  hopper::griddep_wait();  // the split kernel's results
  float2 st = lane < p.splits ? ml[lane] : none;
  const int live = (n_keys + p.kps - 1) / p.kps;  // splits that wrote
  float mx = lane < live ? st.x : NEG_INF;
  for (int j = lane + 32; j < live; j += 32) mx = fmaxf(mx, ml[j].x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  const float* acc = p.ws + o * p.splits * HD + lane * DPL;
  float lsum = 0.f, a[DPL];
#pragma unroll
  for (int dd = 0; dd < DPL; ++dd) a[dd] = 0.f;
  for (int b = 0; b < live; b += 32) {
    if (b > 0) st = b + lane < live ? ml[b + lane] : none;
    const float f = b + lane < live ? expf(st.x - mx) : 0.f;
    const float lw = b + lane < live ? st.y * f : 0.f;
    const int n = min(32, live - b);
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float fi = __shfl_sync(FULL, f, i);
      lsum += __shfl_sync(FULL, lw, i);
      float v[DPL];
      read_row(acc + static_cast<long long>(b + i) * HD, v);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) a[dd] += v[dd] * fi;
    }
  }
  QT* out = static_cast<QT*>(p.out) + o * HD + lane * DPL;
#pragma unroll
  for (int dd = 0; dd < DPL; ++dd)
    store(out + dd, a[dd] / (lsum > 0.f ? lsum : 1.f));
}

template <typename QT, typename KT, int HD, int ROWS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Smem<KT, HD, ROWS>;
  const int smem = (L::MAP + 4 * (p.kps / p.B) + 15) / 16 * 16;
  const int chunks = (p.group * p.w + ROWS - 1) / ROWS;
  if (smem > SMEM_MAX || p.kps / p.B > MAP_MAX || p.nkv * chunks > 65535 ||
      p.S > 65535)
    return cudaErrorInvalidValue;
  auto kernel = block_attn_split_kernel<QT, KT, HD, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nkv * chunks, p.S, p.splits);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  // the combine may launch while the split kernel's last blocks run; it
  // waits for their results inside (griddep_wait)
  const long long rows = static_cast<long long>(p.S) * p.w * p.nq;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((rows + WARPS - 1) / WARPS));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, block_attn_combine_kernel<QT, HD>, p);
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
// kps keys a split (a multiple of B) and splits of them cover the region of
// nb * B keys (ops/block_attention_cuda.py `split_plan`); with splits > 1,
// ws is an fp32 workspace of S * w * nq * splits * (hd + 2) values and a
// second launch (the combine) follows the first. Arena rows (T * B * nkv)
// must number under 2^31. Returns the first failing launch's cudaError_t
// (0 on success).
extern "C" int block_attn(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* map, const void* lengths, void* out,
                          void* ws, int q_dtype, int kv_dtype, int hd, int S,
                          int w, int nq, int nkv, int B, int nb, int kps,
                          int splits, long long q_s0, long long q_s1,
                          long long q_s2, float scale, void* stream) {
  const long long cap = static_cast<long long>(nb) * B;
  if (S < 1 || w < 1 || nkv < 1 || nq % nkv != 0 || B < 1 || nb < 1 ||
      kps < B || kps % B != 0 || splits < 1 ||
      static_cast<long long>(kps) * splits < cap ||
      static_cast<long long>(kps) * (splits - 1) >= cap ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.map = static_cast<const int*>(map);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.S = S;
  p.w = w;
  p.nq = nq;
  p.nkv = nkv;
  p.group = nq / nkv;
  p.B = B;
  p.nb = nb;
  p.kps = kps;
  p.splits = splits;
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

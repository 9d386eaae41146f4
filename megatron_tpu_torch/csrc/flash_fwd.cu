// FlashAttention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (megatron_tpu/ops/flash_attention_pallas.py, launched by `_flash_fwd`).
// It computes the same function: out = softmax(q k^T * scale) v with the
// online softmax in fp32, causal masking aligned top-left (q_pos >= kv_pos),
// an optional sliding-window band (q_pos - kv_pos < window), optional
// segment ids (q and k in different documents never attend), optional
// attention dropout (the TPU kernel's counter hash, flash_common.cuh), GQA
// with q-head h reading kv-head h / group, and the per-row logsumexp.
// The TPU's sequential kv grid axis becomes a loop inside a block, with the
// running (m, l, acc) in registers instead of VMEM scratch; kv tiles past
// the causal diagonal or wholly behind the sliding-window band are never
// loaded. Inputs are read through their strides ([b, s, n, d], unit stride
// on d), so k and v may be the strided halves of a fused projection.
//
// Bound. Causal attention does 2 s^2 d FLOPs per head against 8 s d bytes
// of bf16 q, k, v and out, i.e. s / 4 FLOP per byte: device memory bounds
// the serving prefill (s 512, 128 FLOP/byte, under the H100's ~295), the
// tensor cores every s from ~1200 on (training, s 4096). Keeping P in fp32
// precision (below) makes the tensor work 1.5x the bound's 4 d FLOPs a
// visible pair.
//
// bf16 (`flash_fwd_wgmma_kernel`): a warp-specialised TMA + wgmma pipeline.
// One block of three warpgroups owns one (batch, q-head, 128-row q tile):
// - a producer warpgroup gives its registers away (setmaxnreg) and one of
//   its threads issues every load as a TMA tile copy: Q once, then K and V
//   tiles of 128 rows (64 at hd 128 with segment ids or dropout, whose
//   registers would spill at 128) into a ring of as many stages as 160 KB
//   hold (2-4), each with a `full` mbarrier (armed with the tile's bytes)
//   and an `empty` one.
//   Loads run ahead of the math by the ring's depth, and no thread spends
//   registers or instructions on addresses; TMA zero-fills rows past sq
//   and sk, so ragged tails need no masked loads;
// - two consumer warpgroups, 64 q rows each, take the registers and run
//   both products as wgmma, the only path to the card's tensor-core rate:
//   S = Q K^T with both operands in shared memory (K-major, 128-byte
//   swizzle, one 64-column box per 128 bytes of a row) into fp32
//   registers; the online softmax on those registers (exp2 with the scale
//   folded in as scale * log2 e); then O += P V with P from registers: the
//   accumulator layout of S is the A-fragment layout of the register form
//   once pairs are packed, so no shuffle is needed, and V is read as
//   stored ([kv][d], MN-major, the transpose bit). A consumer arrives on a
//   stage's empty barrier once its P V has retired, and the producer
//   refills the stage.
// - masks cost only where they act: the per-element causal, window,
//   ragged and segment tests run on tiles that cross the diagonal, the
//   window's edge or sk (any tile when segment ids are given); interior
//   tiles skip them;
// - under causal masking q tiles run longest first, so the short ones
//   fill the tail;
// - the epilogue stages O / l through the consumer's own rows of the Q
//   tile (the 128-byte swizzle, no bank conflicts) and writes 16 bytes a
//   thread; the thread that owns a row writes its lse.
// P is split into bf16 hi + lo parts (two products into the same O), so it
// keeps the TPU kernel's fp32 precision instead of a bf16 rounding; that
// doubles the P V work. Left for later: a persistent schedule, the two
// consumers' ping-pong and softmax overlapped with the products.
//
// fp32 (`flash_fwd_fma_kernel`): 64-row q tiles and 64-row kv tiles
// staged in shared memory by all threads, a 16 x 16 thread grid computing
// 4x4 blocks of the score tile and 4 x HD/16 blocks of the output with fp32
// FMAs, so fp32 callers keep fp32 products (tensor-core tf32 would not hold
// 1e-4).
//
// Segment ids and dropout are the training path's; both kernels take them
// only in their EXTRA instantiation, so the serving path's inner loop is
// the one it had without them. Segment ids are int32 [b, s], one row for q
// and k. With dropout, l keeps the undropped sum and only P V sees z = keep
// / (1 - rate), as in the TPU kernel; the lse is the undropped one.
//
// Numerics follow the TPU kernel: masked scores are NEG_INF = -1e30, the
// exponent is clamped at MASK_CLAMP = -1e20 so a fully masked row adds
// nothing, and a row whose l stays 0 gets out 0 and lse NEG_INF.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* seg;  // [b, s] int32 segment ids, or null
  long long seg_sb;
  int b, sq, sk, nq, group;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal;
  int window;  // <= 0: no band
  Dropout drop;
};

// kv rows [begin, end) that a TM-row q tile starting at q0 can see; begin
// is a multiple of TN
template <int TM, int TN>
__device__ __forceinline__ void kv_range(const Params& p, int q0,
                                         int* begin, int* end) {
  *end = p.sk;
  *begin = 0;
  if (p.causal) {
    *end = min(p.sk, q0 + TM);
    if (p.window > 0) *begin = max(0, q0 - p.window + 1) / TN * TN;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  bool keep = kj < p.sk;
  if (p.causal) {
    keep = keep && qi >= kj;
    if (p.window > 0) keep = keep && (qi - kj < p.window);
  }
  return keep;
}

// the segment id of query row qi (-1 past the end)
__device__ __forceinline__ int q_segment(const Params& p, int bi, int qi) {
  return qi < p.sq ? p.seg[bi * p.seg_sb + qi] : -1;
}

// the segment id of key row kj (-2 past the end)
__device__ __forceinline__ int k_segment(const Params& p, int bi, int kj) {
  return kj < p.sk ? __ldg(p.seg + bi * p.seg_sb + kj) : -2;
}

// a kv tile's segment ids into shared memory (-2 past the end)
__device__ __forceinline__ void load_kv_segments(const Params& p, int bi,
                                                 int k0, int* dst) {
  for (int r = threadIdx.x; r < BN; r += blockDim.x)
    dst[r] = k_segment(p, bi, k0 + r);
}

// ---------------------------------------------------------------------------
// fp32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;

template <int HD>
constexpr size_t fma_smem_bytes() {
  // Q [BM][HD+1], K [BN][HD+1], V [BN][HD], P [BM][BN+1], kv segment ids
  // [BN]; the odd pitches keep the column-wise reads free of bank conflicts
  return sizeof(float) *
         (BM * (HD + 1) + BN * (HD + 1) + BN * HD + BM * (BN + 1) + BN);
}

template <int HD, bool EXTRA>
__global__ void __launch_bounds__(FMA_THREADS)
    flash_fwd_fma_kernel(Params p) {
  constexpr int QP = HD + 1;
  constexpr int KP = HD + 1;
  constexpr int PP = BN + 1;
  constexpr int CPT = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * QP;
  float* Vs = Ks + BN * KP;
  float* Ps = Vs + BN * HD;
  int* Ss = reinterpret_cast<int*>(Ps + BM * PP);

  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows tr + 16 i of the tile
  const int tc = tid & 15;  // score cols tc + 16 j, out cols tc + 16 c
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / p.group;

  const float* qg = static_cast<const float*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const float* kg =
      static_cast<const float*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  for (int e = tid; e < BM * HD; e += FMA_THREADS) {
    const int r = e / HD, c = e % HD;
    const int qi = q0 + r;
    Qs[r * QP + c] = qi < p.sq ? qg[qi * p.q_ss + c] * p.scale : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
  int qseg[4];
  uint32_t qrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
    if constexpr (EXTRA) {
      const int qi = q0 + tr + 16 * i;
      qseg[i] = p.seg ? q_segment(p, bi, qi) : 0;
      qrow[i] = dropout_row(p.drop.seed, bi * p.nq + h, qi);
    }
  }

  int kv_begin, kv_end;
  kv_range<BM, BN>(p, q0, &kv_begin, &kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BN * HD; e += FMA_THREADS) {
      const int r = e / HD, c = e % HD;
      const int kj = k0 + r;
      const bool ok = kj < p.sk;
      Ks[r * KP + c] = ok ? kg[kj * p.k_ss + c] : 0.f;
      Vs[r * HD + c] = ok ? vg[kj * p.v_ss + c] : 0.f;
    }
    if constexpr (EXTRA) {
      if (p.seg) load_kv_segments(p, bi, k0, Ss);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(tr + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(tc + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool vis = visible(p, qi, k0 + tc + 16 * j);
        if constexpr (EXTRA) {
          if (p.seg) vis = vis && qseg[i] == Ss[tc + 16 * j];
        }
        if (!vis) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // a row's 16 threads are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float base = fmaxf(m_new, MASK_CLAMP);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - base);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv = s[i][j];
        if constexpr (EXTRA) {
          if (p.drop.scale != 0.f)
            pv *= dropout_keep(qrow[i], k0 + tc + 16 * j, p.drop.thresh)
                      ? p.drop.scale
                      : 0.f;
        }
        Ps[(tr + 16 * i) * PP + tc + 16 * j] = pv;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float pr[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(tr + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[kk * HD + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

  float* og = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= p.sq) continue;
    const float ls = l[i] > 0.f ? l[i] : 1.f;
    float* orow =
        og + ((static_cast<long long>(bi) * p.sq + qi) * p.nq + h) * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tc + 16 * c] = acc[i][c] / ls;
    if (tc == 0)
      p.lse[(static_cast<long long>(bi) * p.nq + h) * p.sq + qi] =
          m[i] + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised TMA + wgmma kernel
// ---------------------------------------------------------------------------

constexpr int WBM = 128;  // q rows a block: two consumers of 64
constexpr int W_THREADS = 384;  // producer + two consumer warpgroups
constexpr float LN2 = 0.6931471805599453f;

// kv rows a tile: 128, or 64 where the registers of a 128-row tile do not
// fit (hd 128 with segment ids or dropout: ptxas spills)
template <int HD, bool EXTRA>
__host__ __device__ constexpr int w_bn() {
  return HD == 128 && EXTRA ? 64 : 128;
}

// K/V ring stages: as many as 160 KB of tiles hold, at most 4
template <int HD, int TN>
__host__ __device__ constexpr int w_stages() {
  return (160 * 1024 - 2 * WBM * HD) / (4 * TN * HD) < 4
             ? (160 * 1024 - 2 * WBM * HD) / (4 * TN * HD)
             : 4;
}

template <int HD, int TN>
constexpr size_t wgmma_smem_bytes() {
  // 1024 bytes of slack to align the tiles for the swizzle, Q, the K and
  // V rings, the barriers (Q, full and empty per stage), then two slots of
  // kv segment ids for each consumer
  return 1024 + 2 * (WBM * HD + 2 * w_stages<HD, TN>() * TN * HD) +
         8 * (1 + 2 * w_stages<HD, TN>()) + 4 * 2 * 2 * TN;
}

template <int HD, int TN, bool EXTRA>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Params p) {
  using namespace hopper;
  constexpr int ST = w_stages<HD, TN>();
  constexpr int CB = HD / 64;              // 64-column boxes of a row
  constexpr uint32_t Q_BOX = WBM * 128;    // bytes of one Q box
  constexpr uint32_t KV_BOX = TN * 128;    // bytes of one K or V box
  constexpr uint32_t KV_TILE = CB * KV_BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* const Qs = smem;
  unsigned char* const Ks = Qs + CB * Q_BOX;  // stage s at s * KV_TILE
  unsigned char* const Vs = Ks + ST * KV_TILE;
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(Vs + ST * KV_TILE);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + ST;
  int* const kv_segs = reinterpret_cast<int*>(empty + ST);

  const int h = blockIdx.x % p.nq;
  const int bi = blockIdx.x / p.nq;
  const int hk = h / p.group;
  // longest q tiles first under causal masking
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * WBM;
  int kv_begin, kv_end;
  kv_range<WBM, TN>(p, q0, &kv_begin, &kv_end);
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + TN - 1) / TN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, CB * Q_BOX);
      for (int cb = 0; cb < CB; ++cb)
        tma_load_4d(Qs + cb * Q_BOX, &tq, q_full, cb * 64, h, q0, bi);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        const int k0 = kv_begin + it * TN;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, 2 * KV_TILE);
        for (int cb = 0; cb < CB; ++cb) {
          tma_load_4d(Ks + s * KV_TILE + cb * KV_BOX, &tk, full + s, cb * 64,
                      hk, k0, bi);
          tma_load_4d(Vs + s * KV_TILE + cb * KV_BOX, &tv, full + s, cb * 64,
                      hk, k0, bi);
        }
      }
    }
  } else {
    // consumers: 64 q rows each
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int w = t / 32;
    const int g = (t % 32) / 4;  // fragment row within 8
    const int t4 = t % 4;        // fragment column pair
    const int r0 = q0 + 64 * c;  // this consumer's first q row
    const int row_a = r0 + 16 * w + g;
    const int row_b = row_a + 8;
    const float sl2 = p.scale * LOG2E;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    // running max in log2 units (scores times scale * log2 e), and this
    // thread's share of the row sums (its columns only, summed at the end)
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
    int seg_a = 0, seg_b = 0;
    uint32_t hrow_a = 0, hrow_b = 0;
    if constexpr (EXTRA) {
      if (p.seg) {
        seg_a = q_segment(p, bi, row_a);
        seg_b = q_segment(p, bi, row_b);
      }
      hrow_a = dropout_row(p.drop.seed, bi * p.nq + h, row_a);
      hrow_b = dropout_row(p.drop.seed, bi * p.nq + h, row_b);
    }
    const uint32_t q_rows = smem_addr(Qs) + 64 * c * 128;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % ST;
      const int k0 = kv_begin + it * TN;
      mbar_wait(full + s, (it / ST) & 1);
      const uint32_t k_tile = smem_addr(Ks + s * KV_TILE);
      const uint32_t v_tile = smem_addr(Vs + s * KV_TILE);
      // with segment ids, each consumer thread fetches one of the tile's
      // kv ids, into a slot of two that the barrier of the next tile frees
      // again
      int my_kv_seg = 0;
      int* const segs = kv_segs + (2 * c + (it & 1)) * TN;
      if constexpr (EXTRA) {
        if (p.seg && t < TN) my_kv_seg = k_segment(p, bi, k0 + t);
      }

      // S = Q K^T: k-steps of 16 walk 32 bytes along the 128-byte rows of
      // each 64-column box. S is declared afresh a tile and left undefined
      // (the first k-step ignores it), so last tile's P is dead once it is
      // packed, not kept for the next tile's accumulator operands.
      float sacc[TN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<TN>(sacc,
                     desc_sw128(q_rows + (kk / 4) * Q_BOX + off, 16, 1024),
                     desc_sw128(k_tile + (kk / 4) * KV_BOX + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();

      // While S computes: the tile's visibility and dropout keep bits, one
      // bit a score (score i = 4 j + e of this thread in bit i % 32 of word
      // i / 32). Masks are tested only on a tile that crosses the
      // diagonal, the window's edge or sk (any tile with segment ids).
      bool need_mask = k0 + TN > p.sk;
      if (p.causal) {
        need_mask = need_mask || k0 + TN - 1 > r0;
        if (p.window > 0) need_mask = need_mask || r0 + 63 - k0 >= p.window;
      }
      if constexpr (EXTRA) need_mask = need_mask || p.seg != nullptr;
      uint32_t vis[TN / 64] = {};
      if (need_mask) {
        if constexpr (EXTRA) {
          if (p.seg) {
            if (t < TN) segs[t] = my_kv_seg;
            named_barrier_sync(1 + c, 128);
          }
        }
#pragma unroll
        for (int wd = 0; wd < TN / 64; ++wd) {
          uint32_t bits = 0;
#pragma unroll 8
          for (int i = 0; i < 32; ++i) {
            const int j = 8 * wd + i / 4, e = i % 4;
            const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
            bool keep = visible(p, e < 2 ? row_a : row_b, kj);
            if constexpr (EXTRA) {
              if (p.seg)
                keep = keep && (e < 2 ? seg_a : seg_b) ==
                                   segs[8 * j + 2 * t4 + (e & 1)];
            }
            bits |= static_cast<uint32_t>(keep) << i;
          }
          vis[wd] = bits;
        }
      }
      uint32_t kept[TN / 64] = {};
      if constexpr (EXTRA) {
        if (p.drop.scale != 0.f) {
#pragma unroll
          for (int wd = 0; wd < TN / 64; ++wd) {
            uint32_t bits = 0;
#pragma unroll 8
            for (int i = 0; i < 32; ++i) {
              const int j = 8 * wd + i / 4, e = i % 4;
              const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
              bits |= static_cast<uint32_t>(dropout_keep(
                          e < 2 ? hrow_a : hrow_b, kj, p.drop.thresh))
                      << i;
            }
            kept[wd] = bits;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(sacc);

      // scores to log2 units, masked ones to NEG_INF
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < TN / 2; ++i)
          sacc[i] = (vis[i / 32] >> (i % 32)) & 1 ? sacc[i] * sl2 : NEG_INF;
      } else {
#pragma unroll
        for (int i = 0; i < TN / 2; ++i) sacc[i] *= sl2;
      }

      // online softmax; a row's values are spread over the 4 lanes of a
      // group
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float base_a = fmaxf(mn_a, MASK_CLAMP);
      const float base_b = fmaxf(mn_b, MASK_CLAMP);
      const float alpha_a = fast_exp2(m_a - mn_a);
      const float alpha_b = fast_exp2(m_b - mn_b);
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        sacc[4 * j] = fast_exp2(sacc[4 * j] - base_a);
        sacc[4 * j + 1] = fast_exp2(sacc[4 * j + 1] - base_a);
        sacc[4 * j + 2] = fast_exp2(sacc[4 * j + 2] - base_b);
        sacc[4 * j + 3] = fast_exp2(sacc[4 * j + 3] - base_b);
        rs_a += sacc[4 * j] + sacc[4 * j + 1];
        rs_b += sacc[4 * j + 2] + sacc[4 * j + 3];
      }
      l_a = l_a * alpha_a + rs_a;
      l_b = l_b * alpha_b + rs_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= alpha_a;
        o[4 * j + 1] *= alpha_a;
        o[4 * j + 2] *= alpha_b;
        o[4 * j + 3] *= alpha_b;
      }
      if constexpr (EXTRA) {
        // dropout after the sums: l keeps the undropped probabilities
        if (p.drop.scale != 0.f) {
#pragma unroll
          for (int i = 0; i < TN / 2; ++i)
            sacc[i] *= (kept[i / 32] >> (i % 32)) & 1 ? p.drop.scale : 0.f;
        }
      }

      // O += P V: the accumulators of column groups 2kk and 2kk + 1 are
      // the A fragment of k-step kk, split into bf16 hi + lo parts
      uint32_t ph[TN / 16][4], pl[TN / 16][4];
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1],
                     &ph[kk][r], &pl[kk][r]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk) {
        // 16 kv rows of V from row 16 kk; the next 64 columns of d lie one
        // box (KV_BOX bytes) further on
        const uint64_t dv = desc_sw128(v_tile + kk * 16 * 128, KV_BOX, 1024);
        wgmma_rs<HD>(o, ph[kk], dv, 1);
        wgmma_rs<HD>(o, pl[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
      mbar_arrive(empty + s);
    }

    // epilogue: the row sums across the group's 4 lanes, O / l into this
    // consumer's rows of the Q tile (swizzled as TMA wrote Q), then rows
    // of 16-byte chunks to device memory
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = l_a > 0.f ? 1.f / l_a : 1.f;
    const float inv_b = l_b > 0.f ? 1.f / l_b : 1.f;
    named_barrier_sync(1 + c, 128);  // every Q read of this consumer is done
    unsigned char* const stage = Qs + 64 * c * 128;
    const int ra = 16 * w + g;  // local rows ra and ra + 8; both % 8 == g
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      unsigned char* const box = stage + (j / 8) * Q_BOX;
      const int chunk = ((j % 8) ^ g) * 16 + 4 * t4;
      *reinterpret_cast<uint32_t*>(box + ra * 128 + chunk) =
          pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(box + (ra + 8) * 128 + chunk) =
          pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
    named_barrier_sync(1 + c, 128);
    __nv_bfloat16* const og = static_cast<__nv_bfloat16*>(p.o);
    constexpr int CHUNKS = HD / 8;  // 16-byte chunks of a row
#pragma unroll
    for (int e = t; e < 64 * CHUNKS; e += 128) {
      const int rr = e / CHUNKS, cc = e % CHUNKS;
      const int qi = r0 + rr;
      if (qi < p.sq) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            stage + (cc / 8) * Q_BOX + rr * 128 + (((cc % 8) ^ (rr % 8)) * 16));
        *reinterpret_cast<uint4*>(
            og + ((static_cast<long long>(bi) * p.sq + qi) * p.nq + h) * HD +
            cc * 8) = val;
      }
    }
    if (t4 == 0) {
      float* const lse = p.lse + (static_cast<long long>(bi) * p.nq + h) * p.sq;
      if (row_a < p.sq)
        lse[row_a] = l_a > 0.f ? m_a * LN2 + logf(l_a) : NEG_INF;
      if (row_b < p.sq)
        lse[row_b] = l_b > 0.f ? m_b * LN2 + logf(l_b) : NEG_INF;
    }
  }
}

template <int HD, bool EXTRA>
cudaError_t launch_wgmma(const Params& p, cudaStream_t st) {
  constexpr int TN = w_bn<HD, EXTRA>();
  CUtensorMap tq, tk, tv;
  const int nkv = p.nq / p.group;
  if (!hopper::bf16_rows_map(&tq, p.q, HD, p.nq, p.sq, p.b, p.q_sh, p.q_ss,
                             p.q_sb, WBM))
    return cudaErrorInvalidValue;
  if (p.sk == 0) {
    tk = tv = tq;  // no kv tile is ever loaded
  } else if (!hopper::bf16_rows_map(&tk, p.k, HD, nkv, p.sk, p.b, p.k_sh,
                                    p.k_ss, p.k_sb, TN) ||
             !hopper::bf16_rows_map(&tv, p.v, HD, nkv, p.sk, p.b, p.v_sh,
                                    p.v_ss, p.v_sb, TN)) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = flash_fwd_wgmma_kernel<HD, TN, EXTRA>;
  const size_t smem = wgmma_smem_bytes<HD, TN>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nq * p.b, (p.sq + WBM - 1) / WBM);
  kernel<<<grid, W_THREADS, smem, st>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int HD, bool EXTRA>
cudaError_t dispatch(int dtype, const Params& p, cudaStream_t st) {
  if (dtype == 0)
    return launch(flash_fwd_fma_kernel<HD, EXTRA>, p,
                  dim3((p.sq + BM - 1) / BM, p.nq, p.b), FMA_THREADS,
                  fma_smem_bytes<HD>(), st);
  return launch_wgmma<HD, EXTRA>(p, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; d has stride 1.
// For bf16, q, k and v must start 16-byte aligned and every stride must be
// a multiple of 8 elements: TMA's rules for the tensor maps built here.
// out is a contiguous [b, sq, nq, hd] tensor of the input dtype, lse a
// contiguous [b, nq, sq] fp32 tensor. seg is null or a contiguous [b, sq]
// int32 tensor (requires sq == sk). drop_scale == 0 turns dropout off;
// otherwise drop_scale = 1 / (1 - rate) and drop_thresh = rate * 2^31.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for an
// unsupported dtype or head dim).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, const int* seg, int dtype,
                         int hd, int b, int sq, int sk, int nq, int nkv,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         float scale, int causal, int window,
                         unsigned int drop_seed, unsigned int drop_thresh,
                         float drop_scale, void* stream) {
  if (nkv <= 0 || nq % nkv != 0 || (dtype != 0 && dtype != 1) ||
      (seg && sq != sk))
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = lse;
  p.seg = seg;
  p.seg_sb = sq;
  p.b = b;
  p.sq = sq;
  p.sk = sk;
  p.nq = nq;
  p.group = nq / nkv;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.drop = Dropout{drop_seed, drop_thresh, drop_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool extra = seg != nullptr || drop_scale != 0.f;
  if (hd == 64)
    return extra ? dispatch<64, true>(dtype, p, st)
                 : dispatch<64, false>(dtype, p, st);
  if (hd == 128)
    return extra ? dispatch<128, true>(dtype, p, st)
                 : dispatch<128, false>(dtype, p, st);
  return cudaErrorInvalidValue;
}

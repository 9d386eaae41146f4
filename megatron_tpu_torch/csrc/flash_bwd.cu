// FlashAttention-2 backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (megatron_tpu/ops/flash_attention_pallas.py, launched by
// `_flash_bwd_core`). Both recompute the attention probabilities from the
// forward's saved logsumexp instead of storing them:
//
//   s  = q k^T * scale, masked (causal top-left, sliding window, segment
//        ids, ragged tails) to NEG_INF
//   p  = exp(s - max(lse, MASK_CLAMP))
//   dp = (dO v^T) * z              z = the forward's regenerated dropout
//   ds = p * (dp - delta + dlse)   delta = rowsum(dO * O), computed outside
//   dq = ds k * scale,  dk = ds^T q * scale,  dv = (p * z)^T dO
//
// dQ kernel. One thread block owns one (batch, q-head, 64-row q tile) and
// loops over the kv tiles that the causal and window bounds leave: the
// TPU's sequential kv grid axis becomes that loop and its `dq_acc` VMEM
// scratch becomes registers.
//
// dK/dV kernel. One thread block owns one (batch, kv-head, 64-row kv tile)
// and loops over the q-heads of its GQA group and, inside, over the q tiles
// the mask leaves, accumulating dK and dV in fp32 registers; it writes them
// once, in k's dtype. The TPU version writes per-q-head fp32 dK/dV and sums
// each group outside the kernel (flash_attention_pallas.py:584-586); here
// the sum happens inside, so the [b, nq, sk, d] fp32 buffers never exist.
// Neither kernel uses atomics: gradients are bit-reproducible. The known
// cost: with one kv head (MQA) at s = 4096 the dK/dV grid has only 64
// blocks for 132 SMs.
//
// Arithmetic, as in the forward (csrc/flash_fwd.cu):
// - bf16: four warps per block, each owning 16 rows of the tile the block
//   owns; every product runs on the tensor cores as mma.sync m16n8k16 with
//   fp32 accumulation. The score and dP tiles are computed 16 columns at a
//   time, so that each 16-column slice becomes, in registers, the A
//   fragment of one k-step of the following product (dS K, P^T dO, dS^T Q).
//   The TPU kernels keep P and dS in fp32; here P * z and dS are split into
//   bf16 hi + lo parts and each such product runs twice, which keeps them
//   at ~16 mantissa bits instead of bf16's 8.
// - fp32: a 16 x 16 thread grid, fp32 FMAs from shared memory, so fp32
//   callers keep fp32 products.
//
// Bound. Per visible (q, k) pair the dQ kernel needs 6 d operations (S, dP,
// dQ) and the dK/dV kernel 8 d (S, dP, dV, dK) against a few bytes per row:
// at the training shape (s = 4096, d = 128, bf16) both are bound by the
// tensor cores. What the design leaves on the table: synchronous tile
// loads (no cp.async/TMA pipeline), mma.sync instead of wgmma, the hi + lo
// split's extra products, and tiles of P recomputed in both kernels.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [b, nq, sq] fp32
  const float* delta;  // [b, nq, sq] fp32
  const float* dlse;   // [b, nq, sq] fp32, or null
  const int* seg;      // [b, s] int32 segment ids, or null
  void* dq;            // [b, sq, nq, hd] contiguous, q's dtype
  void* dk;            // [b, sk, nkv, hd] contiguous, k's dtype
  void* dv;            // [b, sk, nkv, hd] contiguous, v's dtype
  int b, sq, sk, nq, nkv, group;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dout
  float scale;
  int causal;
  int window;  // <= 0: no band
  Dropout drop;
};

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  bool keep = qi < p.sq && kj < p.sk;
  if (p.causal) {
    keep = keep && qi >= kj;
    if (p.window > 0) keep = keep && (qi - kj < p.window);
  }
  return keep;
}

// kv tiles [begin, end) that the q tile starting at q0 can see
__device__ __forceinline__ void kv_range(const Params& p, int q0, int* begin,
                                         int* end) {
  *begin = 0;
  *end = p.sk;
  if (p.causal) {
    *end = min(p.sk, q0 + BM);
    if (p.window > 0) *begin = max(0, q0 - p.window + 1) / BN * BN;
  }
}

// q tiles [begin, end) that can see the kv tile starting at k0
__device__ __forceinline__ void q_range(const Params& p, int k0, int* begin,
                                        int* end) {
  *begin = 0;
  *end = p.sq;
  if (p.causal) {
    *begin = min(p.sq, k0 / BM * BM);
    if (p.window > 0) *end = min(p.sq, k0 + BN - 1 + p.window);
  }
}

__device__ __forceinline__ long long stat_index(const Params& p, int bi,
                                                int h, int qi) {
  return (static_cast<long long>(bi) * p.nq + h) * p.sq + qi;
}

// the per-row terms of one q row: max(lse, MASK_CLAMP) and dlse - delta
__device__ __forceinline__ void row_stats(const Params& p, int bi, int h,
                                          int qi, float* lse_c, float* rest) {
  if (qi >= p.sq) {
    *lse_c = 0.f;
    *rest = 0.f;
    return;
  }
  const long long i = stat_index(p, bi, h, qi);
  *lse_c = fmaxf(p.lse[i], MASK_CLAMP);
  *rest = (p.dlse ? p.dlse[i] : 0.f) - p.delta[i];
}

__device__ __forceinline__ int segment(const Params& p, int bi, int pos,
                                       int limit, int past_end) {
  return pos < limit ? p.seg[static_cast<long long>(bi) * p.sq + pos]
                     : past_end;
}

__device__ __forceinline__ float dropout_z(const Params& p, uint32_t row,
                                           int kj) {
  return dropout_keep(row, kj, p.drop.thresh) ? p.drop.scale : 0.f;
}

// ---------------------------------------------------------------------------
// fp32: FMA kernels
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;

template <int HD>
constexpr size_t fma_dq_smem_bytes() {
  // Q, dO, K, V [64][HD+1], dS [64][65], kv segment ids [64]
  return sizeof(float) * (4 * BM * (HD + 1) + BM * (BN + 1) + BN);
}

template <int HD, bool EXTRA>
__global__ void __launch_bounds__(FMA_THREADS)
    flash_bwd_dq_fma_kernel(Params p) {
  constexpr int TP = HD + 1;
  constexpr int SP = BN + 1;
  constexpr int CPT = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + BM * TP;  // dO
  float* Ks = Os + BM * TP;
  float* Vs = Ks + BN * TP;
  float* Ds = Vs + BN * TP;  // dS
  int* Sk = reinterpret_cast<int*>(Ds + BM * SP);

  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // q rows tr + 16 i
  const int tc = tid & 15;  // kv cols tc + 16 j, d cols tc + 16 c
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / p.group;
  const float* qg = static_cast<const float*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const float* og =
      static_cast<const float*>(p.dout) + bi * p.o_sb + h * p.o_sh;
  const float* kg =
      static_cast<const float*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  for (int e = tid; e < BM * HD; e += FMA_THREADS) {
    const int r = e / HD, c = e % HD;
    const bool ok = q0 + r < p.sq;
    Qs[r * TP + c] = ok ? qg[(q0 + r) * p.q_ss + c] * p.scale : 0.f;
    Os[r * TP + c] = ok ? og[(q0 + r) * p.o_ss + c] : 0.f;
  }
  float lse_c[4], rest[4], acc[4][CPT];
  int qseg[4];
  uint32_t qrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    row_stats(p, bi, h, qi, &lse_c[i], &rest[i]);
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
    if constexpr (EXTRA) {
      qseg[i] = p.seg ? segment(p, bi, qi, p.sq, -1) : 0;
      qrow[i] = dropout_row(p.drop.seed, bi * p.nq + h, qi);
    }
  }

  int kv_begin, kv_end;
  kv_range(p, q0, &kv_begin, &kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += BN) {
    __syncthreads();
    for (int e = tid; e < BN * HD; e += FMA_THREADS) {
      const int r = e / HD, c = e % HD;
      const bool ok = k0 + r < p.sk;
      Ks[r * TP + c] = ok ? kg[(k0 + r) * p.k_ss + c] : 0.f;
      Vs[r * TP + c] = ok ? vg[(k0 + r) * p.v_ss + c] : 0.f;
    }
    if constexpr (EXTRA) {
      if (p.seg)
        for (int r = tid; r < BN; r += FMA_THREADS)
          Sk[r] = segment(p, bi, k0 + r, p.sk, -2);
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], o[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(tr + 16 * i) * TP + d];
        o[i] = Os[(tr + 16 * i) * TP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Ks[(tc + 16 * j) * TP + d];
        vb[j] = Vs[(tc + 16 * j) * TP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(o[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc + 16 * j;
        bool vis = visible(p, qi, kj);
        float dpz = dp[i][j];
        if constexpr (EXTRA) {
          if (p.seg) vis = vis && qseg[i] == Sk[tc + 16 * j];
          if (p.drop.scale != 0.f) dpz *= dropout_z(p, qrow[i], kj);
        }
        const float pv = vis ? expf(s[i][j] - lse_c[i]) : 0.f;
        Ds[(tr + 16 * i) * SP + tc + 16 * j] = pv * (dpz + rest[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float dsr[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = Ds[(tr + 16 * i) * SP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[kk * TP + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(dsr[i], kv[c], acc[i][c]);
    }
  }

  float* dqg = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= p.sq) continue;
    float* row = dqg + ((static_cast<long long>(bi) * p.sq + qi) * p.nq + h) * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[tc + 16 * c] = acc[i][c] * p.scale;
  }
}

template <int HD>
constexpr size_t fma_dkv_smem_bytes() {
  // K, V, Q, dO [64][HD+1], P*z and dS [64][65], per-q-row lse / rest /
  // segment [64] each, kv segment ids [64]
  return sizeof(float) * (4 * BM * (HD + 1) + 2 * BM * (BN + 1) + 4 * BM);
}

template <int HD, bool EXTRA>
__global__ void __launch_bounds__(FMA_THREADS)
    flash_bwd_dkv_fma_kernel(Params p) {
  constexpr int TP = HD + 1;
  constexpr int SP = BN + 1;
  constexpr int CPT = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * TP;
  float* Qs = Vs + BN * TP;
  float* Os = Qs + BM * TP;   // dO
  float* Pz = Os + BM * TP;   // P * z, [q][kv]
  float* Ds = Pz + BM * SP;   // dS, [q][kv]
  float* Ls = Ds + BM * SP;   // max(lse, MASK_CLAMP) per q row
  float* Rs = Ls + BM;        // dlse - delta per q row
  int* Sq = reinterpret_cast<int*>(Rs + BM);
  int* Sk = Sq + BM;

  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // scores: q rows tr + 16 i; sums: kv rows
  const int tc = tid & 15;  // scores: kv cols tc + 16 j; sums: d cols
  const int k0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const float* kg =
      static_cast<const float*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  for (int e = tid; e < BN * HD; e += FMA_THREADS) {
    const int r = e / HD, c = e % HD;
    const bool ok = k0 + r < p.sk;
    Ks[r * TP + c] = ok ? kg[(k0 + r) * p.k_ss + c] : 0.f;
    Vs[r * TP + c] = ok ? vg[(k0 + r) * p.v_ss + c] : 0.f;
  }
  if constexpr (EXTRA) {
    if (p.seg)
      for (int r = tid; r < BN; r += FMA_THREADS)
        Sk[r] = segment(p, bi, k0 + r, p.sk, -2);
  }

  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  int q_begin, q_end;
  q_range(p, k0, &q_begin, &q_end);
  for (int hh = 0; hh < p.group; ++hh) {
    const int h = hk * p.group + hh;
    const float* qg =
        static_cast<const float*>(p.q) + bi * p.q_sb + h * p.q_sh;
    const float* og =
        static_cast<const float*>(p.dout) + bi * p.o_sb + h * p.o_sh;
    for (int q0 = q_begin; q0 < q_end; q0 += BM) {
      __syncthreads();  // the previous tile's readers are done
      for (int e = tid; e < BM * HD; e += FMA_THREADS) {
        const int r = e / HD, c = e % HD;
        const bool ok = q0 + r < p.sq;
        Qs[r * TP + c] = ok ? qg[(q0 + r) * p.q_ss + c] * p.scale : 0.f;
        Os[r * TP + c] = ok ? og[(q0 + r) * p.o_ss + c] : 0.f;
      }
      for (int r = tid; r < BM; r += FMA_THREADS) {
        row_stats(p, bi, h, q0 + r, &Ls[r], &Rs[r]);
        if constexpr (EXTRA) {
          if (p.seg) Sq[r] = segment(p, bi, q0 + r, p.sq, -1);
        }
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[4], o[4], kb[4], vb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = Qs[(tr + 16 * i) * TP + d];
          o[i] = Os[(tr + 16 * i) * TP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kb[j] = Ks[(tc + 16 * j) * TP + d];
          vb[j] = Vs[(tc + 16 * j) * TP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i], kb[j], s[i][j]);
            dp[i][j] = fmaf(o[i], vb[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr + 16 * i;
        const int qi = q0 + r;
        uint32_t qrow = 0;
        if constexpr (EXTRA) qrow = dropout_row(p.drop.seed, bi * p.nq + h, qi);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k0 + tc + 16 * j;
          bool vis = visible(p, qi, kj);
          float z = 1.f;
          if constexpr (EXTRA) {
            if (p.seg) vis = vis && Sq[r] == Sk[tc + 16 * j];
            if (p.drop.scale != 0.f) z = dropout_z(p, qrow, kj);
          }
          const float pv = vis ? expf(s[i][j] - Ls[r]) : 0.f;
          Pz[r * SP + tc + 16 * j] = pv * z;
          Ds[r * SP + tc + 16 * j] = pv * (dp[i][j] * z + Rs[r]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < BM; ++qq) {
        float pz[4], ds[4], ov[CPT], qv[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pz[i] = Pz[qq * SP + tr + 16 * i];
          ds[i] = Ds[qq * SP + tr + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          ov[c] = Os[qq * TP + tc + 16 * c];
          qv[c] = Qs[qq * TP + tc + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            dv[i][c] = fmaf(pz[i], ov[c], dv[i][c]);
            dk[i][c] = fmaf(ds[i], qv[c], dk[i][c]);
          }
      }
    }
  }

  float* dkg = static_cast<float*>(p.dk);
  float* dvg = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + tr + 16 * i;
    if (kj >= p.sk) continue;
    const long long row =
        ((static_cast<long long>(bi) * p.sk + kj) * p.nkv + hk) * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkg[row + tc + 16 * c] = dk[i][c];  // q was pre-scaled
      dvg[row + tc + 16 * c] = dv[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows

template <int HD>
constexpr size_t mma_dq_smem_bytes() {
  // Q, dO, K, V tiles, kv segment ids
  return sizeof(__nv_bfloat16) * 4 * BM * mma_pitch<HD>() + sizeof(int) * BN;
}

// acc[t] += A (a 16-row bf16-split fp32 fragment pair) * B, where B's k rows
// are the 16 tile rows starting at `rows` (pitch P) and its n columns the
// d columns t * 8 ..: the P V pattern of the forward
template <int HD>
__device__ __forceinline__ void mma_rows(float acc[][4], const uint32_t hi[4],
                                         const uint32_t lo[4],
                                         const __nv_bfloat16* rows, int g,
                                         int t4) {
  constexpr int P = mma_pitch<HD>();
  const __nv_bfloat16* r = rows + (2 * t4) * P + g;
#pragma unroll
  for (int t = 0; t < HD / 8; ++t) {
    const __nv_bfloat16* b = r + t * 8;
    const uint32_t b0 = pack_bf16(b[0], b[P]);
    const uint32_t b1 = pack_bf16(b[8 * P], b[9 * P]);
    mma_bf16(acc[t], hi, b0, b1);
    mma_bf16(acc[t], lo, b0, b1);
  }
}

// the A fragments (hi, lo) of one k-step from two 16x8 accumulator tiles
__device__ __forceinline__ void split_a(const float x0[4], const float x1[4],
                                        uint32_t hi[4], uint32_t lo[4]) {
  split_bf16(x0[0], x0[1], &hi[0], &lo[0]);
  split_bf16(x0[2], x0[3], &hi[1], &lo[1]);
  split_bf16(x1[0], x1[1], &hi[2], &lo[2]);
  split_bf16(x1[2], x1[3], &hi[3], &lo[3]);
}

template <int HD, bool EXTRA>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dq_mma_kernel(Params p) {
  constexpr int P = mma_pitch<HD>();
  constexpr int KSTEPS = HD / 16;
  constexpr int NT_D = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + BM * P;  // dO
  __nv_bfloat16* Ks = Os + BM * P;
  __nv_bfloat16* Vs = Ks + BN * P;
  int* Sk = reinterpret_cast<int*>(Vs + BN * P);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / p.group;
  const int wr = warp * 16;
  using bf16 = __nv_bfloat16;
  const bf16* qg = static_cast<const bf16*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const bf16* og =
      static_cast<const bf16*>(p.dout) + bi * p.o_sb + h * p.o_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  load_tile<HD, MMA_THREADS>(Qs, qg, p.q_ss, q0, p.sq);
  load_tile<HD, MMA_THREADS>(Os, og, p.o_ss, q0, p.sq);
  __syncthreads();
  // this warp's 16 q rows of Q and dO as A fragments, one per k-step
  uint32_t qa[KSTEPS][4], oa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    load_a<P>(qa[kk], Qs + wr * P + kk * 16, g, t4);
    load_a<P>(oa[kk], Os + wr * P + kk * 16, g, t4);
  }
  // this thread's rows: fragment rows g (a) and g + 8 (b)
  const int row_a = q0 + wr + g, row_b = row_a + 8;
  float lse_a, lse_b, rest_a, rest_b;
  row_stats(p, bi, h, row_a, &lse_a, &rest_a);
  row_stats(p, bi, h, row_b, &lse_b, &rest_b);
  int seg_a = 0, seg_b = 0;
  uint32_t hrow_a = 0, hrow_b = 0;
  if constexpr (EXTRA) {
    if (p.seg) {
      seg_a = segment(p, bi, row_a, p.sq, -1);
      seg_b = segment(p, bi, row_b, p.sq, -1);
    }
    hrow_a = dropout_row(p.drop.seed, bi * p.nq + h, row_a);
    hrow_b = dropout_row(p.drop.seed, bi * p.nq + h, row_b);
  }
  float dq[NT_D][4];
#pragma unroll
  for (int t = 0; t < NT_D; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[t][e] = 0.f;

  int kv_begin, kv_end;
  kv_range(p, q0, &kv_begin, &kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += BN) {
    __syncthreads();
    load_tile<HD, MMA_THREADS>(Ks, kg, p.k_ss, k0, p.sk);
    load_tile<HD, MMA_THREADS>(Vs, vg, p.v_ss, k0, p.sk);
    if constexpr (EXTRA) {
      if (p.seg)
        for (int r = threadIdx.x; r < BN; r += MMA_THREADS)
          Sk[r] = segment(p, bi, k0 + r, p.sk, -2);
    }
    __syncthreads();

    // 16 kv columns at a time: S and dP n-tiles 2j, 2j+1 are the A
    // fragment of k-step j of dS K
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][e] = dp[u][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int off = ((2 * j + u) * 8 + g) * P + kk * 16 + 2 * t4;
          mma_bf16(s[u], qa[kk], ld32(Ks + off), ld32(Ks + off + 8));
          mma_bf16(dp[u], oa[kk], ld32(Vs + off), ld32(Vs + off + 8));
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (2 * j + u) * 8 + 2 * t4 + (e & 1);
          const int kj = k0 + col;
          const bool ra = e < 2;
          bool vis = visible(p, ra ? row_a : row_b, kj);
          float dpz = dp[u][e];
          if constexpr (EXTRA) {
            if (p.seg) vis = vis && (ra ? seg_a : seg_b) == Sk[col];
            if (p.drop.scale != 0.f)
              dpz *= dropout_z(p, ra ? hrow_a : hrow_b, kj);
          }
          const float pv =
              vis ? expf(s[u][e] * p.scale - (ra ? lse_a : lse_b)) : 0.f;
          s[u][e] = pv * (dpz + (ra ? rest_a : rest_b));  // dS
        }
      uint32_t hi[4], lo[4];
      split_a(s[0], s[1], hi, lo);
      mma_rows<HD>(dq, hi, lo, Ks + j * 16 * P, g, t4);
    }
  }

  bf16* dqg = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? row_b : row_a;
    if (qi >= p.sq) continue;
    bf16* row = dqg + ((static_cast<long long>(bi) * p.sq + qi) * p.nq + h) * HD;
#pragma unroll
    for (int t = 0; t < NT_D; ++t)
      *reinterpret_cast<uint32_t*>(row + t * 8 + 2 * t4) =
          pack_bf16(dq[t][2 * half] * p.scale, dq[t][2 * half + 1] * p.scale);
  }
}

template <int HD>
constexpr size_t mma_dkv_smem_bytes() {
  // K, V, Q, dO tiles, then per-q-row lse / rest / segment [64] each
  return sizeof(__nv_bfloat16) * 4 * BM * mma_pitch<HD>() +
         sizeof(float) * 3 * BM;
}

template <int HD, bool EXTRA>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dkv_mma_kernel(Params p) {
  constexpr int P = mma_pitch<HD>();
  constexpr int KSTEPS = HD / 16;
  constexpr int NT_D = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using bf16 = __nv_bfloat16;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BN * P;
  bf16* Qs = Vs + BN * P;
  bf16* Os = Qs + BM * P;  // dO
  float* Ls = reinterpret_cast<float*>(Os + BM * P);
  float* Rs = Ls + BM;
  int* Sq = reinterpret_cast<int*>(Rs + BM);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int wr = warp * 16;
  const bf16* kg = static_cast<const bf16*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  load_tile<HD, MMA_THREADS>(Ks, kg, p.k_ss, k0, p.sk);
  load_tile<HD, MMA_THREADS>(Vs, vg, p.v_ss, k0, p.sk);

  // this thread's kv rows: fragment rows g (a) and g + 8 (b)
  const int kv_a = k0 + wr + g, kv_b = kv_a + 8;
  int kseg_a = 0, kseg_b = 0;
  if constexpr (EXTRA) {
    if (p.seg) {
      kseg_a = segment(p, bi, kv_a, p.sk, -2);
      kseg_b = segment(p, bi, kv_b, p.sk, -2);
    }
  }
  float dk[NT_D][4], dv[NT_D][4];
#pragma unroll
  for (int t = 0; t < NT_D; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;

  int q_begin, q_end;
  q_range(p, k0, &q_begin, &q_end);
  for (int hh = 0; hh < p.group; ++hh) {
    const int h = hk * p.group + hh;
    const bf16* qg = static_cast<const bf16*>(p.q) + bi * p.q_sb + h * p.q_sh;
    const bf16* og =
        static_cast<const bf16*>(p.dout) + bi * p.o_sb + h * p.o_sh;
    for (int q0 = q_begin; q0 < q_end; q0 += BM) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<HD, MMA_THREADS>(Qs, qg, p.q_ss, q0, p.sq);
      load_tile<HD, MMA_THREADS>(Os, og, p.o_ss, q0, p.sq);
      for (int r = threadIdx.x; r < BM; r += MMA_THREADS) {
        row_stats(p, bi, h, q0 + r, &Ls[r], &Rs[r]);
        if constexpr (EXTRA) {
          if (p.seg) Sq[r] = segment(p, bi, q0 + r, p.sq, -1);
        }
      }
      __syncthreads();

      // 16 q columns at a time: S^T = K Q^T and dP^T = V dO^T n-tiles
      // 2j, 2j+1 are the A fragment of k-step j of P^T dO and dS^T Q
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) {
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[u][e] = dpt[u][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t ka[4], va[4];
          load_a<P>(ka, Ks + wr * P + kk * 16, g, t4);
          load_a<P>(va, Vs + wr * P + kk * 16, g, t4);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int off = ((2 * j + u) * 8 + g) * P + kk * 16 + 2 * t4;
            mma_bf16(st[u], ka, ld32(Qs + off), ld32(Qs + off + 8));
            mma_bf16(dpt[u], va, ld32(Os + off), ld32(Os + off + 8));
          }
        }
        // element (kv row, q column): st[u][e] has kv row e < 2 ? a : b
        // and q column (2j + u) * 8 + 2 t4 + (e & 1)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = (2 * j + u) * 8 + 2 * t4 + c;
            const int qi = q0 + col;
            uint32_t qrow = 0;
            if constexpr (EXTRA) {
              if (p.drop.scale != 0.f)
                qrow = dropout_row(p.drop.seed, bi * p.nq + h, qi);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + c;
              const int kj = r ? kv_b : kv_a;
              bool vis = visible(p, qi, kj);
              float z = 1.f;
              if constexpr (EXTRA) {
                if (p.seg) vis = vis && Sq[col] == (r ? kseg_b : kseg_a);
                if (p.drop.scale != 0.f) z = dropout_z(p, qrow, kj);
              }
              const float pv =
                  vis ? expf(st[u][e] * p.scale - Ls[col]) : 0.f;
              st[u][e] = pv * z;                            // (P z)^T
              dpt[u][e] = pv * (dpt[u][e] * z + Rs[col]);  // dS^T
            }
          }
        uint32_t hi[4], lo[4];
        split_a(st[0], st[1], hi, lo);
        mma_rows<HD>(dv, hi, lo, Os + j * 16 * P, g, t4);
        split_a(dpt[0], dpt[1], hi, lo);
        mma_rows<HD>(dk, hi, lo, Qs + j * 16 * P, g, t4);
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(p.dk);
  bf16* dvg = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = half ? kv_b : kv_a;
    if (kj >= p.sk) continue;
    const long long row =
        ((static_cast<long long>(bi) * p.sk + kj) * p.nkv + hk) * HD;
#pragma unroll
    for (int t = 0; t < NT_D; ++t) {
      const int c = t * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dkg + row + c) = pack_bf16(
          dk[t][2 * half] * p.scale, dk[t][2 * half + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + row + c) =
          pack_bf16(dv[t][2 * half], dv[t][2 * half + 1]);
    }
  }
}

template <int HD, bool EXTRA>
cudaError_t dispatch_dq(int dtype, const Params& p, cudaStream_t st) {
  const dim3 grid((p.sq + BM - 1) / BM, p.nq, p.b);
  if (dtype == 0)
    return launch(flash_bwd_dq_fma_kernel<HD, EXTRA>, p, grid, FMA_THREADS,
                  fma_dq_smem_bytes<HD>(), st);
  return launch(flash_bwd_dq_mma_kernel<HD, EXTRA>, p, grid, MMA_THREADS,
                mma_dq_smem_bytes<HD>(), st);
}

template <int HD, bool EXTRA>
cudaError_t dispatch_dkv(int dtype, const Params& p, cudaStream_t st) {
  const dim3 grid((p.sk + BN - 1) / BN, p.nkv, p.b);
  if (dtype == 0)
    return launch(flash_bwd_dkv_fma_kernel<HD, EXTRA>, p, grid, FMA_THREADS,
                  fma_dkv_smem_bytes<HD>(), st);
  return launch(flash_bwd_dkv_mma_kernel<HD, EXTRA>, p, grid, MMA_THREADS,
                mma_dkv_smem_bytes<HD>(), st);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const float* dlse, const int* seg, int b, int sq, int sk,
                   int nq, int nkv, const long long* strides, float scale,
                   int causal, int window, unsigned int drop_seed,
                   unsigned int drop_thresh, float drop_scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dlse = dlse;
  p.seg = seg;
  p.b = b;
  p.sq = sq;
  p.sk = sk;
  p.nq = nq;
  p.nkv = nkv;
  p.group = nq / nkv;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.drop = Dropout{drop_seed, drop_thresh, drop_scale};
  return p;
}

bool valid(int dtype, int hd, int sq, int sk, int nq, int nkv,
           const int* seg) {
  return nkv > 0 && nq % nkv == 0 && (dtype == 0 || dtype == 1) &&
         (hd == 64 || hd == 128) && (!seg || sq == sk);
}

}  // namespace

// Both entry points take q [b, sq, nq, hd], k and v [b, sk, nkv, hd] and
// dout [b, sq, nq, hd] through `strides` (12 element strides: batch, seq,
// head of q, k, v, dout in that order; hd has stride 1; for bf16 every
// tensor starts 16-byte aligned and its strides are multiples of 8), and
// lse, delta and dlse (or null) as contiguous [b, nq, sq] fp32. seg is null
// or a contiguous [b, sq] int32 tensor (sq == sk). drop_scale == 0 turns
// dropout off; otherwise drop_scale = 1 / (1 - rate) and drop_thresh =
// rate * 2^31. dtype: 0 = float32, 1 = bfloat16. Each returns the launch's
// cudaError_t (cudaErrorInvalidValue for what it does not take).

// dq: a contiguous [b, sq, nq, hd] tensor of q's dtype.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* dlse,
                            const int* seg, void* dq, int dtype, int hd,
                            int b, int sq, int sk, int nq, int nkv,
                            const long long* strides, float scale,
                            int causal, int window, unsigned int drop_seed,
                            unsigned int drop_thresh, float drop_scale,
                            void* stream) {
  if (!valid(dtype, hd, sq, sk, nq, nkv, seg)) return cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, lse, delta, dlse, seg, b, sq, sk, nq,
                         nkv, strides, scale, causal, window, drop_seed,
                         drop_thresh, drop_scale);
  p.dq = dq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool extra = seg != nullptr || drop_scale != 0.f;
  if (hd == 64)
    return extra ? dispatch_dq<64, true>(dtype, p, st)
                 : dispatch_dq<64, false>(dtype, p, st);
  return extra ? dispatch_dq<128, true>(dtype, p, st)
               : dispatch_dq<128, false>(dtype, p, st);
}

// dk, dv: contiguous [b, sk, nkv, hd] tensors of k's dtype, summed over
// each kv head's group of q heads.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const float* dlse,
                             const int* seg, void* dk, void* dv, int dtype,
                             int hd, int b, int sq, int sk, int nq, int nkv,
                             const long long* strides, float scale,
                             int causal, int window, unsigned int drop_seed,
                             unsigned int drop_thresh, float drop_scale,
                             void* stream) {
  if (!valid(dtype, hd, sq, sk, nq, nkv, seg)) return cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, lse, delta, dlse, seg, b, sq, sk, nq,
                         nkv, strides, scale, causal, window, drop_seed,
                         drop_thresh, drop_scale);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool extra = seg != nullptr || drop_scale != 0.f;
  if (hd == 64)
    return extra ? dispatch_dkv<64, true>(dtype, p, st)
                 : dispatch_dkv<64, false>(dtype, p, st);
  return extra ? dispatch_dkv<128, true>(dtype, p, st)
               : dispatch_dkv<128, false>(dtype, p, st);
}

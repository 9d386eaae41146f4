// FlashAttention backward for Hopper (sm_90a), plain C interface for ctypes.
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
// Bound. A visible (q, k) pair costs the dQ kernel 6 d operations (S, dP,
// dQ) and the dK/dV kernel 8 d (S, dP, dV, dK) against a few bytes a row:
// at the training shape (s 4096, d 128, bf16) the tensor cores bound both.
// P * z and dS are kept at fp32 precision as bf16 hi + lo parts, each
// product that takes them as its A operand running twice, so the tensor
// work is 8 d and 12 d a pair: 1.33x and 1.5x the bound's.
//
// bf16: two warp-specialised kernels on TMA and wgmma (csrc/hopper.cuh),
// the forward's design (csrc/flash_fwd.cu) turned to the backward. A block
// has three warpgroups: a producer that gives its registers away
// (setmaxnreg), one thread of which issues every tile load as a TMA copy
// (128-byte swizzle, zero fill past sq and sk) into a ring of stages with
// `full` and `empty` mbarriers, while a second warp copies the small
// per-tile side data (segment ids; the dK/dV kernel's per-q-row terms)
// into the same stage; and two consumer warpgroups of 64 rows that take
// the registers and run every product as wgmma.
// - dQ (`flash_bwd_dq_wgmma_kernel`): a block owns (batch, q-head, 128 q
//   rows). Q and dO are loaded once; K and V tiles of 64 rows stream
//   through the ring. Per tile S = Q K^T and dP = dO V^T are issued back to
//   back (both operands K-major) and waited on once; P = exp2 with the
//   scale folded in; dS in registers from P, z and the rows' lse, delta
//   and dlse (read once); then dQ += dS K with dS's accumulator pairs as
//   the A fragments and K read MN-major (the transpose bit), as the
//   forward reads V. The epilogue scales by `scale`, stages dQ through the
//   consumer's own rows of the Q tile and stores 16 bytes a thread. Under
//   causal masking q tiles run longest first.
// - dK/dV (`flash_bwd_dkv_wgmma_kernel`): a block owns (batch, kv-head,
//   128 kv rows, one chunk of the group's q-heads). K and V are loaded
//   once; Q and dO tiles stream through the ring, with each tile's
//   max(lse, MASK_CLAMP) in log2 units, dlse - delta and q segment ids,
//   over the q tiles the causal and window bounds leave. S^T = K Q^T and
//   dP^T = V dO^T run as wgmma from shared memory; then dV += (P z)^T dO
//   and, in a second group whose fragments are split while the first
//   runs, dK += dS^T Q, both from registers, with dO and Q read MN-major
//   from the same swizzled tiles that were K-major operands one product
//   earlier. dK and dV stay in fp32 registers and are written once. kv
//   tiles run longest first (k0 = 0 sees every q tile).
// - MQA and GQA without atomics: where one chunk per kv head would leave
//   the card short of blocks (Falcon-7B's 71/1 heads: 16 blocks at s 2048
//   for 132 SMs), the wrapper splits each group's q-heads into chunks
//   (ops/flash_attention_cuda.py `dkv_head_chunks`); each block writes its
//   chunk's fp32 partial dK/dV into a workspace, and
//   `flash_bwd_dkv_sum_kernel` sums the chunks in a fixed order and casts.
//   Nothing is summed with atomics, so two runs give the same bits; for
//   the same reason dQ stays a kernel of its own.
// - Masks cost only where they act: the per-element causal, window and
//   ragged tests run on the tiles that cross the diagonal, the window's
//   edge, sq or sk (every tile with segment ids); tiles that no pair of a
//   consumer's rows can see are skipped. Segment ids and dropout exist
//   only in the EXTRA instantiations, so the plain path carries neither.
// - Registers: a dK/dV consumer holds dK and dV (64 + 64 fp32 a thread at
//   d 128) beside S^T, dP^T and hi + lo fragments, so its q tiles are 32
//   rows at d 128 and in the EXTRA instantiations, 64 otherwise; dQ's kv
//   tiles are 64 rows. The consumers wait on their barriers without the
//   10-s trap of hopper::mbar_wait (a trap reachable from their code holds
//   ptxas under ~180 registers and serialises their wgmma); a producer
//   thread waits, trap armed, on a `done` barrier that the consumers
//   arrive on at the end, so a fault of the protocol still fails the
//   launch instead of hanging the card. Producer 32 registers, consumers
//   232: every instantiation shows 0 spill bytes under `nvcc -Xptxas -v`.
// Left for later: 64-row q tiles at d 128 (a few registers short), a
// persistent schedule, overlapping one tile's softmax with the next
// tile's products, and tiles of P recomputed in both kernels.
//
// fp32: a 16 x 16 thread grid, fp32 FMAs from shared memory, so fp32
// callers keep fp32 products; the dK/dV FMA kernel loops over the whole
// group of q-heads in one block.

#include "flash_common.cuh"
#include "hopper.cuh"

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
  float* ws;           // bf16 dK/dV with chunks > 1: fp32 partials
                       // [2][chunks][b, sk, nkv, hd] (dk, then dv)
  int b, sq, sk, nq, nkv, group;
  int chunks;          // q-head chunks of a group (bf16 dK/dV)
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
// bf16: warp-specialised TMA + wgmma kernels
// ---------------------------------------------------------------------------

constexpr int W_THREADS = 384;  // producer + two consumer warpgroups
constexpr int DQ_ROWS = 128;    // q rows a dQ block: two consumers of 64
constexpr int DKV_ROWS = 128;   // kv rows a dK/dV block: two consumers of 64

// kv rows a dQ tile: at 128 (d 64) S, dP and dS's fragments beside dQ
// leave ptxas too few registers for the wgmma pipeline
constexpr int DQ_TN = 64;

// q rows a dK/dV tile: 64, and 32 where S^T, dP^T and their fragments
// beside dK and dV (64 + 64 fp32 a thread at d 128) or beside the masks of
// the EXTRA instantiation would spill at 64
template <int HD, bool EXTRA>
__host__ __device__ constexpr int dkv_tm() {
  return HD == 128 || EXTRA ? 32 : 64;
}

__host__ __device__ constexpr int ring_stages(int fixed, int stage,
                                              int most) {
  return (200 * 1024 - fixed) / stage < most ? (200 * 1024 - fixed) / stage
                                             : most;
}

// dQ: Q and dO fixed, K and V tiles in the ring (at most 4 stages)
template <int HD>
__host__ __device__ constexpr int dq_stages() {
  return ring_stages(2 * 2 * DQ_ROWS * HD, 2 * 2 * DQ_TN * HD, 4);
}

// dK/dV: K and V fixed, Q and dO tiles and their row data in the ring
template <int HD, int TM>
__host__ __device__ constexpr int dkv_stages() {
  return ring_stages(2 * 2 * DKV_ROWS * HD, 2 * 2 * TM * HD + 12 * TM, 8);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // 1024 bytes of slack to align the tiles for the swizzle, Q and dO, the
  // K and V rings, the barriers (Q, full and empty per stage, done), then
  // each stage's kv segment ids
  constexpr int ST = dq_stages<HD>();
  return 1024 + 2 * (2 * DQ_ROWS * HD + 2 * ST * DQ_TN * HD) +
         8 * (2 + 2 * ST) + 4 * ST * DQ_TN;
}

template <int HD, int TM>
constexpr size_t dkv_smem_bytes() {
  // slack, K and V, the Q and dO rings, the barriers, then each stage's
  // q-row data: lse in log2 units, dlse - delta, segment ids
  constexpr int ST = dkv_stages<HD, TM>();
  return 1024 + 2 * (2 * DKV_ROWS * HD + 2 * ST * TM * HD) +
         8 * (2 + 2 * ST) + 12 * ST * TM;
}

// a q row's lse in log2 units (clamped as the TPU kernel clamps it) and
// dlse - delta; zeros past sq, where Q and dO arrive as zeros
__device__ __forceinline__ void row_terms(const Params& p, int bi, int h,
                                          int qi, float* lse2, float* rest) {
  *lse2 = 0.f;
  *rest = 0.f;
  if (qi < p.sq) {
    const long long i = stat_index(p, bi, h, qi);
    *lse2 = fmaxf(p.lse[i], MASK_CLAMP) * LOG2E;
    *rest = (p.dlse ? p.dlse[i] : 0.f) - p.delta[i];
  }
}

// the A fragments (hi, lo) of wgmma_rs from an accumulator of N / 2
// values: k-step kk takes accumulator pairs 8 kk + 2 r, r = 0..3
template <int N>
__device__ __forceinline__ void split_frags(const float (&acc)[N / 2],
                                            uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1], &hi[kk][r],
                 &lo[kk][r]);
}

// 64 rows x HD of fp32 accumulators (rows ra and ra + 8 of this thread, as
// wgmma lays them out), times `mul`, as bf16 into a 64-row slice of a
// swizzled tile whose 64-column boxes lie `box` bytes apart; the caller
// brackets it with the consumer's barrier
template <int HD>
__device__ __forceinline__ void stage_rows(unsigned char* rows, uint32_t box,
                                           const float (&acc)[HD / 2],
                                           float mul, int ra, int g,
                                           int t4) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    unsigned char* const b = rows + (j / 8) * box;
    const int chunk = ((j % 8) ^ g) * 16 + 4 * t4;
    *reinterpret_cast<uint32_t*>(b + ra * 128 + chunk) =
        pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    *reinterpret_cast<uint32_t*>(b + (ra + 8) * 128 + chunk) =
        pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// the 64-row slice staged by stage_rows to rows [row0, row0 + 64) of a
// contiguous [b, s, n, HD] bf16 tensor (head `head` of `n`), 16 bytes a
// thread, rows at or past s skipped
template <int HD>
__device__ __forceinline__ void store_rows(const unsigned char* rows,
                                           uint32_t box, __nv_bfloat16* out,
                                           int bi, int s, int n, int head,
                                           int row0, int t) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks of a row
#pragma unroll
  for (int e = t; e < 64 * CHUNKS; e += 128) {
    const int rr = e / CHUNKS, cc = e % CHUNKS;
    const int r = row0 + rr;
    if (r < s) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          rows + (cc / 8) * box + rr * 128 + (((cc % 8) ^ (rr % 8)) * 16));
      *reinterpret_cast<uint4*>(
          out + ((static_cast<long long>(bi) * s + r) * n + head) * HD +
          cc * 8) = val;
    }
  }
}

template <int HD, bool EXTRA>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const Params p) {
  using namespace hopper;
  constexpr int TN = DQ_TN;
  constexpr int ST = dq_stages<HD>();
  constexpr int CB = HD / 64;               // 64-column boxes of a row
  constexpr uint32_t Q_BOX = DQ_ROWS * 128;  // bytes of one Q or dO box
  constexpr uint32_t KV_BOX = TN * 128;      // bytes of one K or V box
  constexpr uint32_t KV_TILE = CB * KV_BOX;
  constexpr int NW = (TN / 2 + 31) / 32;     // mask words a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* const Qs = smem;
  unsigned char* const Os = Qs + CB * Q_BOX;  // dO
  unsigned char* const Ks = Os + CB * Q_BOX;  // stage s at s * KV_TILE
  unsigned char* const Vs = Ks + ST * KV_TILE;
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(Vs + ST * KV_TILE);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + ST;
  uint64_t* const done = empty + ST;  // the consumers are through
  int* const kv_segs = reinterpret_cast<int*>(done + 1);  // [ST][TN]

  const int h = blockIdx.x % p.nq;
  const int bi = blockIdx.x / p.nq;
  const int hk = h / p.group;
  // longest q tiles first under causal masking
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * DQ_ROWS;
  int kv_begin = 0, kv_end = p.sk;
  if (p.causal) {
    kv_end = min(p.sk, q0 + DQ_ROWS);
    if (p.window > 0) kv_begin = max(0, q0 - p.window + 1) / TN * TN;
  }
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + TN - 1) / TN : 0;
  bool segs = false;
  if constexpr (EXTRA) segs = p.seg != nullptr;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, segs ? 1 + 32 : 1);
      mbar_init(empty + s, 2 * 128);
    }
    mbar_init(done, 2 * 128);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full; with segment ids, warp 1
    // copies each kv tile's ids (-2 past sk) into its stage; a thread of
    // warp 3 bounds the consumers' untimed waits (mbar_spin)
    setmaxnreg_dec<32>();
    if (threadIdx.x == 96) mbar_wait(done, 0);
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, 2 * CB * Q_BOX);
      for (int cb = 0; cb < CB; ++cb) {
        tma_load_4d(Qs + cb * Q_BOX, &tq, q_full, cb * 64, h, q0, bi);
        tma_load_4d(Os + cb * Q_BOX, &tdo, q_full, cb * 64, h, q0, bi);
      }
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
    } else if (segs && threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        const int k0 = kv_begin + it * TN;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        for (int r = lane; r < TN; r += 32)
          kv_segs[s * TN + r] = segment(p, bi, k0 + r, p.sk, -2);
        mbar_arrive(full + s);
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
    float lse_a, lse_b, rest_a, rest_b;
    row_terms(p, bi, h, row_a, &lse_a, &rest_a);
    row_terms(p, bi, h, row_b, &lse_b, &rest_b);
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
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    const uint32_t q_base = smem_addr(Qs) + 64 * c * 128;
    const uint32_t o_base = smem_addr(Os) + 64 * c * 128;

    mbar_spin(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % ST;
      const int k0 = kv_begin + it * TN;
      // this consumer's rows re-read each tile, so that the compiler builds
      // the k-steps' 64-bit descriptors per tile instead of keeping all of
      // them in registers across the loop
      uint32_t q_rows = q_base, o_rows = o_base;
      asm volatile("" : "+r"(q_rows), "+r"(o_rows));
      mbar_spin(full + s, (it / ST) & 1);
      // a tile that no pair of these 64 rows can see adds nothing
      bool dead = false;
      if (p.causal)
        dead = k0 > r0 + 63 ||
               (p.window > 0 && r0 - (k0 + TN - 1) >= p.window);
      if (!dead) {
        const uint32_t k_tile = smem_addr(Ks + s * KV_TILE);
        const uint32_t v_tile = smem_addr(Vs + s * KV_TILE);
        // S = Q K^T and dP = dO V^T back to back, one wait. Both are
        // declared afresh a tile and left undefined (the first k-step
        // ignores them), so no earlier tile's values stay alive.
        float sacc[TN / 2], dpacc[TN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk / 4) * Q_BOX + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * KV_BOX + (kk % 4) * 32;
          wgmma_ss<TN>(sacc, desc_sw128(q_rows + off, 16, 1024),
                       desc_sw128(k_tile + koff, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk / 4) * Q_BOX + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * KV_BOX + (kk % 4) * 32;
          wgmma_ss<TN>(dpacc, desc_sw128(o_rows + off, 16, 1024),
                       desc_sw128(v_tile + koff, 16, 1024), kk > 0);
        }
        wgmma_commit();

        // While they compute: visibility and dropout keep bits, one bit a
        // score (score i = 4 j + e of this thread in bit i % 32 of word
        // i / 32), on tiles that cross the diagonal, the window's edge or
        // sk (any tile with segment ids)
        bool need_mask = k0 + TN > p.sk;
        if (p.causal) {
          need_mask = need_mask || k0 + TN - 1 > r0;
          if (p.window > 0)
            need_mask = need_mask || r0 + 63 - k0 >= p.window;
        }
        need_mask = need_mask || segs;
        uint32_t vis[NW] = {};
        if (need_mask) {
          const int* const ks = kv_segs + s * TN;
#pragma unroll
          for (int wd = 0; wd < NW; ++wd) {
            uint32_t bits = 0;
#pragma unroll 8
            for (int i = 0; i < 32; ++i) {
              const int j = 8 * wd + i / 4, e = i % 4;
              const int col = 8 * j + 2 * t4 + (e & 1);
              bool keep = visible(p, e < 2 ? row_a : row_b, k0 + col);
              if constexpr (EXTRA) {
                if (segs) keep = keep && (e < 2 ? seg_a : seg_b) == ks[col];
              }
              bits |= static_cast<uint32_t>(keep) << i;
            }
            vis[wd] = bits;
          }
        }
        uint32_t kept[NW] = {};
        if constexpr (EXTRA) {
          if (p.drop.scale != 0.f) {
#pragma unroll
            for (int wd = 0; wd < NW; ++wd) {
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
        fence_regs(dpacc);

        // dS = P (z dP + dlse - delta), into dP's registers
#pragma unroll
        for (int i = 0; i < TN / 2; ++i) {
          const bool ra = (i % 4) < 2;
          float pv = fast_exp2(fmaf(sacc[i], sl2, -(ra ? lse_a : lse_b)));
          if (need_mask) pv = (vis[i / 32] >> (i % 32)) & 1 ? pv : 0.f;
          float dpz = dpacc[i];
          if constexpr (EXTRA) {
            if (p.drop.scale != 0.f)
              dpz *= (kept[i / 32] >> (i % 32)) & 1 ? p.drop.scale : 0.f;
          }
          dpacc[i] = pv * (dpz + (ra ? rest_a : rest_b));
        }

        // dQ += dS K: dS as bf16 hi + lo A fragments, K MN-major (16 kv
        // rows from row 16 kk; the next 64 columns of d one box further)
        uint32_t dh[TN / 16][4], dl[TN / 16][4];
        split_frags<TN>(dpacc, dh, dl);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TN / 16; ++kk) {
          const uint64_t kb = desc_sw128(k_tile + kk * 16 * 128, KV_BOX, 1024);
          wgmma_rs<HD>(dq, dh[kk], kb, 1);
          wgmma_rs<HD>(dq, dl[kk], kb, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < TN / 16; ++kk) {
          fence_regs(dh[kk]);
          fence_regs(dl[kk]);
        }
      }
      mbar_arrive(empty + s);
    }

    // epilogue: dQ * scale into this consumer's rows of the Q tile
    // (swizzled as TMA wrote Q), then rows of 16-byte chunks
    named_barrier_sync(1 + c, 128);  // every Q read of this consumer is done
    unsigned char* const stage = Qs + 64 * c * 128;
    stage_rows<HD>(stage, Q_BOX, dq, p.scale, 16 * w + g, g, t4);
    named_barrier_sync(1 + c, 128);
    store_rows<HD>(stage, Q_BOX, static_cast<__nv_bfloat16*>(p.dq), bi,
                   p.sq, p.nq, h, r0, t);
    mbar_arrive(done);
  }
}

template <int HD, int TM, bool EXTRA>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const Params p) {
  using namespace hopper;
  constexpr int ST = dkv_stages<HD, TM>();
  constexpr int CB = HD / 64;                 // 64-column boxes of a row
  constexpr uint32_t KV_BOX = DKV_ROWS * 128;  // bytes of one K or V box
  constexpr uint32_t Q_BOX = TM * 128;         // bytes of one Q or dO box
  constexpr uint32_t Q_TILE = CB * Q_BOX;
  constexpr int NW = (TM / 2 + 31) / 32;       // mask words a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* const Ks = smem;
  unsigned char* const Vs = Ks + CB * KV_BOX;
  unsigned char* const Qs = Vs + CB * KV_BOX;  // stage s at s * Q_TILE
  unsigned char* const Os = Qs + ST * Q_TILE;  // dO
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(Os + ST * Q_TILE);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + ST;
  uint64_t* const done = empty + ST;  // the consumers are through
  float* const lse2s = reinterpret_cast<float*>(done + 1);  // [ST][TM]
  float* const rests = lse2s + ST * TM;                       // [ST][TM]
  int* const qsegs = reinterpret_cast<int*>(rests + ST * TM);  // [ST][TM]

  // blockIdx.x walks (batch, kv-head, chunk), blockIdx.y the kv tiles, so
  // every head's tile 0, which under causal masking sees every q tile,
  // is scheduled first
  const int chunk = blockIdx.x % p.chunks;
  const int hk = (blockIdx.x / p.chunks) % p.nkv;
  const int bi = blockIdx.x / (p.chunks * p.nkv);
  const int k0 = blockIdx.y * DKV_ROWS;
  // this chunk's q-heads [h_begin, h_end) of the group (dkv_head_chunks)
  const int h_begin = hk * p.group + chunk * p.group / p.chunks;
  const int h_end = hk * p.group + (chunk + 1) * p.group / p.chunks;
  int q_begin = 0, q_end = p.sq;
  if (p.causal) {
    q_begin = min(p.sq, k0);
    if (p.window > 0) q_end = min(p.sq, k0 + DKV_ROWS - 1 + p.window);
  }
  const int n_qt = q_end > q_begin ? (q_end - q_begin + TM - 1) / TM : 0;
  const int n_it = (h_end - h_begin) * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1 + 32);
      mbar_init(empty + s, 2 * 128);
    }
    mbar_init(done, 2 * 128);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full, warp 1 copies each q
    // tile's row data into its stage, a thread of warp 3 bounds the
    // consumers' untimed waits (mbar_spin)
    setmaxnreg_dec<32>();
    if (threadIdx.x == 96) mbar_wait(done, 0);
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * CB * KV_BOX);
      for (int cb = 0; cb < CB; ++cb) {
        tma_load_4d(Ks + cb * KV_BOX, &tk, kv_full, cb * 64, hk, k0, bi);
        tma_load_4d(Vs + cb * KV_BOX, &tv, kv_full, cb * 64, hk, k0, bi);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST;
        const int h = h_begin + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * TM;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, 2 * Q_TILE);
        for (int cb = 0; cb < CB; ++cb) {
          tma_load_4d(Qs + s * Q_TILE + cb * Q_BOX, &tq, full + s, cb * 64,
                      h, q0, bi);
          tma_load_4d(Os + s * Q_TILE + cb * Q_BOX, &tdo, full + s, cb * 64,
                      h, q0, bi);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST;
        const int h = h_begin + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * TM;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        for (int r = lane; r < TM; r += 32) {
          row_terms(p, bi, h, q0 + r, &lse2s[s * TM + r], &rests[s * TM + r]);
          if constexpr (EXTRA) {
            if (p.seg) qsegs[s * TM + r] = segment(p, bi, q0 + r, p.sq, -1);
          }
        }
        mbar_arrive(full + s);
      }
    }
  } else {
    // consumers: 64 kv rows each
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int w = t / 32;
    const int g = (t % 32) / 4;  // fragment row within 8
    const int t4 = t % 4;        // fragment column pair
    const int kc0 = k0 + 64 * c;  // this consumer's first kv row
    const int kv_a = kc0 + 16 * w + g;
    const int kv_b = kv_a + 8;
    const float sl2 = p.scale * LOG2E;
    int kseg_a = 0, kseg_b = 0;
    if constexpr (EXTRA) {
      if (p.seg) {
        kseg_a = segment(p, bi, kv_a, p.sk, -2);
        kseg_b = segment(p, bi, kv_b, p.sk, -2);
      }
    }
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_base = smem_addr(Ks) + 64 * c * 128;
    const uint32_t v_base = smem_addr(Vs) + 64 * c * 128;

    mbar_spin(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST;
      [[maybe_unused]] const int h = h_begin + it / n_qt;  // dropout's
      const int q0 = q_begin + (it % n_qt) * TM;
      // re-read each tile, as in the dQ kernel
      uint32_t k_rows = k_base, v_rows = v_base;
      asm volatile("" : "+r"(k_rows), "+r"(v_rows));
      mbar_spin(full + s, (it / ST) & 1);
      // a q tile that no pair of these 64 kv rows can see adds nothing
      bool dead = false;
      if (p.causal)
        dead = q0 + TM - 1 < kc0 ||
               (p.window > 0 && q0 - (kc0 + 63) >= p.window);
      if (!dead) {
        const uint32_t q_tile = smem_addr(Qs + s * Q_TILE);
        const uint32_t o_tile = smem_addr(Os + s * Q_TILE);
        // S^T = K Q^T and dP^T = V dO^T, one wait
        float sacc[TM / 2], dpacc[TM / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t koff = (kk / 4) * KV_BOX + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * Q_BOX + (kk % 4) * 32;
          wgmma_ss<TM>(sacc, desc_sw128(k_rows + koff, 16, 1024),
                       desc_sw128(q_tile + qoff, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t koff = (kk / 4) * KV_BOX + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * Q_BOX + (kk % 4) * 32;
          wgmma_ss<TM>(dpacc, desc_sw128(v_rows + koff, 16, 1024),
                       desc_sw128(o_tile + qoff, 16, 1024), kk > 0);
        }
        wgmma_commit();

        // While they compute: visibility and dropout keep bits of the
        // transposed scores (element 4 j + e: kv row e < 2 ? a : b, q
        // column 8 j + 2 t4 + (e & 1)); dropout's row hash is a q column's
        const float* const l2s = lse2s + s * TM;
        const float* const rs = rests + s * TM;
        const int* const qs = qsegs + s * TM;
        bool need_mask = q0 + TM > p.sq || kc0 + 64 > p.sk;
        if (p.causal) {
          need_mask = need_mask || kc0 + 63 > q0;
          if (p.window > 0)
            need_mask = need_mask || q0 + TM - 1 - kc0 >= p.window;
        }
        if constexpr (EXTRA) need_mask = need_mask || p.seg != nullptr;
        uint32_t vis[NW] = {};
        if (need_mask) {
#pragma unroll
          for (int i = 0; i < TM / 2; ++i) {
            const int e = i % 4;
            const int col = 8 * (i / 4) + 2 * t4 + (e & 1);
            bool keep = visible(p, q0 + col, e < 2 ? kv_a : kv_b);
            if constexpr (EXTRA) {
              if (p.seg) keep = keep && qs[col] == (e < 2 ? kseg_a : kseg_b);
            }
            vis[i / 32] |= static_cast<uint32_t>(keep) << (i % 32);
          }
        }
        uint32_t kept[NW] = {};
        if constexpr (EXTRA) {
          if (p.drop.scale != 0.f) {
#pragma unroll
            for (int j = 0; j < TM / 8; ++j)
#pragma unroll
              for (int e1 = 0; e1 < 2; ++e1) {
                const uint32_t qrow = dropout_row(p.drop.seed, bi * p.nq + h,
                                                  q0 + 8 * j + 2 * t4 + e1);
                const int ia = 4 * j + e1, ib = 4 * j + 2 + e1;
                kept[ia / 32] |=
                    static_cast<uint32_t>(
                        dropout_keep(qrow, kv_a, p.drop.thresh))
                    << (ia % 32);
                kept[ib / 32] |=
                    static_cast<uint32_t>(
                        dropout_keep(qrow, kv_b, p.drop.thresh))
                    << (ib % 32);
              }
          }
        }
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(dpacc);

        // (P z)^T into S^T's registers, dS^T = P^T (z dP^T + dlse - delta)
        // into dP^T's
#pragma unroll
        for (int j = 0; j < TM / 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(l2s + 8 * j + 2 * t4);
          const float2 rr =
              *reinterpret_cast<const float2*>(rs + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float pv = fast_exp2(
                fmaf(sacc[i], sl2, -((e & 1) ? l2.y : l2.x)));
            if (need_mask) pv = (vis[i / 32] >> (i % 32)) & 1 ? pv : 0.f;
            float z = 1.f;
            if constexpr (EXTRA) {
              if (p.drop.scale != 0.f)
                z = (kept[i / 32] >> (i % 32)) & 1 ? p.drop.scale : 0.f;
            }
            dpacc[i] = pv * (dpacc[i] * z + ((e & 1) ? rr.y : rr.x));
            sacc[i] = pv * z;
          }
        }

        // dV += (P z)^T dO, then dK += dS^T Q: the fragments as A, dO and
        // Q MN-major (16 q rows from row 16 kk; the next 64 columns of d
        // one box further). Two groups, dS split while dV's runs, so that
        // only one product's fragments are live beside dK and dV.
        {
          uint32_t ph[TM / 16][4], pl[TM / 16][4];
          split_frags<TM>(sacc, ph, pl);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < TM / 16; ++kk) {
            const uint64_t ob =
                desc_sw128(o_tile + kk * 16 * 128, Q_BOX, 1024);
            wgmma_rs<HD>(dv, ph[kk], ob, 1);
            wgmma_rs<HD>(dv, pl[kk], ob, 1);
          }
          wgmma_commit();
          uint32_t dh[TM / 16][4], dl[TM / 16][4];
          split_frags<TM>(dpacc, dh, dl);
          wgmma_wait<0>();
          fence_regs(dv);
#pragma unroll
          for (int kk = 0; kk < TM / 16; ++kk) {
            fence_regs(ph[kk]);
            fence_regs(pl[kk]);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < TM / 16; ++kk) {
            const uint64_t qb =
                desc_sw128(q_tile + kk * 16 * 128, Q_BOX, 1024);
            wgmma_rs<HD>(dk, dh[kk], qb, 1);
            wgmma_rs<HD>(dk, dl[kk], qb, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dk);
#pragma unroll
          for (int kk = 0; kk < TM / 16; ++kk) {
            fence_regs(dh[kk]);
            fence_regs(dl[kk]);
          }
        }
      }
      mbar_arrive(empty + s);
    }

    // epilogue: dK = dS^T Q * scale (Q entered unscaled) and dV
    const int ra = 16 * w + g;  // local rows ra and ra + 8
    if (p.chunks == 1) {
      // staged through this consumer's own rows of the K and V tiles
      named_barrier_sync(1 + c, 128);  // every K and V read is done
      unsigned char* const k_stage = Ks + 64 * c * 128;
      unsigned char* const v_stage = Vs + 64 * c * 128;
      stage_rows<HD>(k_stage, KV_BOX, dk, p.scale, ra, g, t4);
      stage_rows<HD>(v_stage, KV_BOX, dv, 1.f, ra, g, t4);
      named_barrier_sync(1 + c, 128);
      store_rows<HD>(k_stage, KV_BOX, static_cast<__nv_bfloat16*>(p.dk), bi,
                     p.sk, p.nkv, hk, kc0, t);
      store_rows<HD>(v_stage, KV_BOX, static_cast<__nv_bfloat16*>(p.dv), bi,
                     p.sk, p.nkv, hk, kc0, t);
    } else {
      // this chunk's fp32 partials, summed by flash_bwd_dkv_sum_kernel
      const long long part =
          static_cast<long long>(p.b) * p.sk * p.nkv * HD;  // one chunk
      float* const wk = p.ws + chunk * part;
      float* const wv = p.ws + (p.chunks + chunk) * part;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kj = half ? kv_b : kv_a;
        if (kj >= p.sk) continue;
        const long long row =
            ((static_cast<long long>(bi) * p.sk + kj) * p.nkv + hk) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(wk + row + col) =
              make_float2(dk[4 * j + 2 * half] * p.scale,
                          dk[4 * j + 2 * half + 1] * p.scale);
          *reinterpret_cast<float2*>(wv + row + col) =
              make_float2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
        }
      }
    }
    mbar_arrive(done);
  }
}

// dk, dv (n bf16 values each) = the sums over `chunks` of the fp32 partials
// [2][chunks][n], taken in chunk order so that every run gives the same bits
__global__ void flash_bwd_dkv_sum_kernel(const float* __restrict__ ws,
                                         __nv_bfloat16* dk,
                                         __nv_bfloat16* dv, long long n,
                                         int chunks) {
  const long long n4 = n / 4;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < 2 * n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const bool second = i >= n4;
    const long long e = second ? i - n4 : i;
    const float4* src = reinterpret_cast<const float4*>(ws) +
                        (second ? chunks * n4 : 0) + e;
    float4 acc = src[0];
    for (int c = 1; c < chunks; ++c) {
      const float4 x = src[c * n4];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<uint2*>((second ? dv : dk) + 4 * e) =
        make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  }
}

// the tensor maps of q and dout (box `q_rows`) and k and v (box `kv_rows`);
// an empty side gets the other's maps, which are then never loaded
template <int HD>
bool bwd_maps(const Params& p, int q_rows, int kv_rows, CUtensorMap* tq,
              CUtensorMap* tdo, CUtensorMap* tk, CUtensorMap* tv) {
  using hopper::bf16_rows_map;
  if (p.sq > 0 &&
      (!bf16_rows_map(tq, p.q, HD, p.nq, p.sq, p.b, p.q_sh, p.q_ss, p.q_sb,
                      q_rows) ||
       !bf16_rows_map(tdo, p.dout, HD, p.nq, p.sq, p.b, p.o_sh, p.o_ss,
                      p.o_sb, q_rows)))
    return false;
  if (p.sk > 0 &&
      (!bf16_rows_map(tk, p.k, HD, p.nkv, p.sk, p.b, p.k_sh, p.k_ss, p.k_sb,
                      kv_rows) ||
       !bf16_rows_map(tv, p.v, HD, p.nkv, p.sk, p.b, p.v_sh, p.v_ss, p.v_sb,
                      kv_rows)))
    return false;
  if (p.sq == 0) *tq = *tdo = *tk;
  if (p.sk == 0) *tk = *tv = *tq;
  return true;
}

template <typename Kernel>
cudaError_t launch_wgmma(Kernel kernel, size_t smem, dim3 grid,
                         const CUtensorMap& tq, const CUtensorMap& tdo,
                         const CUtensorMap& tk, const CUtensorMap& tv,
                         const Params& p, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, W_THREADS, smem, st>>>(tq, tdo, tk, tv, p);
  return cudaGetLastError();
}

template <int HD, bool EXTRA>
cudaError_t dispatch_dq(int dtype, const Params& p, cudaStream_t st) {
  if (dtype == 0)
    return launch(flash_bwd_dq_fma_kernel<HD, EXTRA>, p,
                  dim3((p.sq + BM - 1) / BM, p.nq, p.b), FMA_THREADS,
                  fma_dq_smem_bytes<HD>(), st);
  CUtensorMap tq, tdo, tk, tv;
  if (!bwd_maps<HD>(p, DQ_ROWS, DQ_TN, &tq, &tdo, &tk, &tv))
    return cudaErrorInvalidValue;
  return launch_wgmma(flash_bwd_dq_wgmma_kernel<HD, EXTRA>,
                      dq_smem_bytes<HD>(),
                      dim3(p.nq * p.b, (p.sq + DQ_ROWS - 1) / DQ_ROWS), tq,
                      tdo, tk, tv, p, st);
}

template <int HD, bool EXTRA>
cudaError_t dispatch_dkv(int dtype, const Params& p, cudaStream_t st) {
  if (dtype == 0)
    return launch(flash_bwd_dkv_fma_kernel<HD, EXTRA>, p,
                  dim3((p.sk + BN - 1) / BN, p.nkv, p.b), FMA_THREADS,
                  fma_dkv_smem_bytes<HD>(), st);
  constexpr int TM = dkv_tm<HD, EXTRA>();
  CUtensorMap tq, tdo, tk, tv;
  if (!bwd_maps<HD>(p, TM, DKV_ROWS, &tq, &tdo, &tk, &tv))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_wgmma(
      flash_bwd_dkv_wgmma_kernel<HD, TM, EXTRA>, dkv_smem_bytes<HD, TM>(),
      dim3(p.b * p.nkv * p.chunks, (p.sk + DKV_ROWS - 1) / DKV_ROWS), tq,
      tdo, tk, tv, p, st);
  if (err != cudaSuccess || p.chunks == 1) return err;
  const long long n = static_cast<long long>(p.b) * p.sk * p.nkv * HD;
  const long long blocks = (2 * n / 4 + 255) / 256;
  flash_bwd_dkv_sum_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                             256, 0, st>>>(
      p.ws, static_cast<__nv_bfloat16*>(p.dk),
      static_cast<__nv_bfloat16*>(p.dv), n, p.chunks);
  return cudaGetLastError();
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
  p.chunks = 1;
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
// tensor starts 16-byte aligned and its strides are multiples of 8, TMA's
// rules for the tensor maps built here), and lse, delta and dlse (or null)
// as contiguous [b, nq, sq] fp32. seg is null or a contiguous [b, sq] int32
// tensor (sq == sk). drop_scale == 0 turns dropout off; otherwise
// drop_scale = 1 / (1 - rate) and drop_thresh = rate * 2^31. dtype: 0 =
// float32, 1 = bfloat16. Each returns the launch's cudaError_t
// (cudaErrorInvalidValue for what it does not take).

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
// each kv head's group of q heads. chunks: the number of parts each group's
// q-heads are split into for bf16 (1 for fp32; at most the group); with
// more than one, workspace is a contiguous fp32 [2, chunks, b, sk, nkv, hd]
// scratch tensor, else it may be null.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const float* dlse,
                             const int* seg, void* dk, void* dv, int dtype,
                             int hd, int b, int sq, int sk, int nq, int nkv,
                             const long long* strides, float scale,
                             int causal, int window, unsigned int drop_seed,
                             unsigned int drop_thresh, float drop_scale,
                             int chunks, float* workspace, void* stream) {
  if (!valid(dtype, hd, sq, sk, nq, nkv, seg) || chunks < 1 ||
      chunks > nq / nkv || (chunks > 1 && (dtype != 1 || !workspace)))
    return cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, lse, delta, dlse, seg, b, sq, sk, nq,
                         nkv, strides, scale, causal, window, drop_seed,
                         drop_thresh, drop_scale);
  p.dk = dk;
  p.dv = dv;
  p.chunks = chunks;
  p.ws = workspace;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool extra = seg != nullptr || drop_scale != 0.f;
  if (hd == 64)
    return extra ? dispatch_dkv<64, true>(dtype, p, st)
                 : dispatch_dkv<64, false>(dtype, p, st);
  return extra ? dispatch_dkv<128, true>(dtype, p, st)
               : dispatch_dkv<128, false>(dtype, p, st);
}

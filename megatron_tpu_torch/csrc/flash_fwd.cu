// FlashAttention-2 forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (megatron_tpu/ops/flash_attention_pallas.py, launched by `_flash_fwd`).
// It computes the same function: out = softmax(q k^T * scale) v with the
// online softmax in fp32, causal masking aligned top-left (q_pos >= kv_pos),
// an optional sliding-window band (q_pos - kv_pos < window), optional
// segment ids (q and k in different documents never attend), optional
// attention dropout (the TPU kernel's counter hash, flash_common.cuh), GQA
// with q-head h reading kv-head h / group, and the per-row logsumexp.
//
// Design. One thread block owns one (batch, q-head, 64-row q tile) and walks
// its kv tiles in a loop: the TPU's sequential kv grid axis becomes that
// loop, and the running (m, l, acc) stay in registers instead of VMEM
// scratch. Tiles past the causal diagonal, and tiles wholly behind the
// sliding-window band, are never loaded. The Q tile and each 64-row K/V
// tile are staged in shared memory. Inputs are read through their strides
// ([b, s, n, d] with unit stride on d), so no transpose copy is made, and
// the ragged tails of q and kv are masked, so any sequence length runs.
// Two kernels share that shape and differ in the arithmetic:
//
// - bf16 (`flash_fwd_mma_kernel`): four warps, each owning 16 q rows. Both
//   products run on the tensor cores as mma.sync m16n8k16 with fp32
//   accumulation; Q stays in registers as A fragments, the score fragments
//   are rescaled, masked and exponentiated in registers and become the A
//   fragments of P V directly, as in FlashAttention-2. P is split into bf16
//   hi + lo parts (two products) so that it keeps the TPU kernel's fp32
//   precision instead of FlashAttention-2's bf16 rounding.
// - fp32 (`flash_fwd_fma_kernel`): a 16 x 16 thread grid computes 4x4
//   blocks of the score tile and 4 x HD/16 blocks of the output with fp32
//   FMAs, so fp32 callers keep fp32 products (tensor-core tf32 would not
//   hold 1e-4).
//
// Segment ids and dropout are the training path's; both kernels take them
// only in their EXTRA instantiation, so the serving path's inner loop is
// the one it had without them. Segment ids are int32 [b, s], one row for q
// and k: a block keeps its q rows' ids in registers and stages each kv
// tile's ids in shared memory. With dropout, l keeps the undropped sum and
// only P V sees z = keep / (1 - rate), as in the TPU kernel; the lse is the
// undropped one.
//
// Bound. Causal attention does 2 s^2 d FLOPs per head against 8 s d bytes
// of bf16 q, k, v and out, i.e. s / 4 FLOP per byte. At the serving
// prefill (Llama-2-7B, s = 512, d = 128) that is 128 FLOP/byte, under the
// H100's ~295 FLOP/byte balance point, so the least time is set by device
// memory; from s ~ 1200 on, as at the training shape s = 4096, it is set by
// the tensor cores. The design keeps every intermediate (scores,
// probabilities, running statistics) on chip, so device memory sees only
// the minimum traffic plus K/V tiles re-read (mostly from L2) once per q
// tile. What it leaves on the table: loads are synchronous (no cp.async/TMA
// pipeline overlapping the next tile's load with this tile's math) and
// mma.sync runs at a fraction of wgmma's rate; those are a later PR's work.
//
// Numerics follow the TPU kernel: masked scores are NEG_INF = -1e30, the
// exponent is clamped at MASK_CLAMP = -1e20 so a fully masked row adds
// nothing, and a row whose l stays 0 divides by 1 (out 0, lse NEG_INF).

#include "flash_common.cuh"

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

// kv tiles [kv_begin, kv_end) that the q tile starting at q0 can see
__device__ __forceinline__ void kv_range(const Params& p, int q0,
                                         int* begin, int* end) {
  *end = p.sk;
  *begin = 0;
  if (p.causal) {
    *end = min(p.sk, q0 + BM);
    if (p.window > 0) *begin = max(0, q0 - p.window + 1) / BN * BN;
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

// a kv tile's segment ids into shared memory (-2 past the end)
__device__ __forceinline__ void load_kv_segments(const Params& p, int bi,
                                                 int k0, int* dst) {
  for (int r = threadIdx.x; r < BN; r += blockDim.x)
    dst[r] = k0 + r < p.sk ? p.seg[bi * p.seg_sb + k0 + r] : -2;
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
  kv_range(p, q0, &kv_begin, &kv_end);
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
// bf16: tensor-core kernel (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 q rows

template <int HD>
constexpr size_t mma_smem_bytes() {
  // Q, K, V tiles, then the kv tile's segment ids
  return sizeof(__nv_bfloat16) * 3 * BM * mma_pitch<HD>() + sizeof(int) * BN;
}

template <int HD, bool EXTRA>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_mma_kernel(Params p) {
  constexpr int P = mma_pitch<HD>();
  constexpr int KSTEPS = HD / 16;  // k-steps of Q K^T
  constexpr int NT_S = BN / 8;     // n-tiles of the score tile
  constexpr int NT_O = HD / 8;     // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * P;
  __nv_bfloat16* Vs = Ks + BN * P;
  int* Ss = reinterpret_cast<int*>(Vs + BN * P);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and B column) within 8
  const int t4 = lane & 3;  // fragment column pair
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / p.group;

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  load_tile<HD, MMA_THREADS>(Qs, qg, p.q_ss, q0, p.sq);
  __syncthreads();
  // this warp's 16 q rows as A fragments, one per k-step
  const int wr = warp * 16;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) load_a<P>(qa[kk], Qs + wr * P + kk * 16, g, t4);

  // this thread's two rows: fragment rows g and g + 8
  const int row_a = q0 + wr + g;
  const int row_b = row_a + 8;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float o[NT_O][4];
#pragma unroll
  for (int t = 0; t < NT_O; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
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

  int kv_begin, kv_end;
  kv_range(p, q0, &kv_begin, &kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<HD, MMA_THREADS>(Ks, kg, p.k_ss, k0, p.sk);
    load_tile<HD, MMA_THREADS>(Vs, vg, p.v_ss, k0, p.sk);
    if constexpr (EXTRA) {
      if (p.seg) load_kv_segments(p, bi, k0, Ss);
    }
    __syncthreads();

    // S = Q K^T: B is K^T, i.e. K rows read as columns
    float s[NT_S][4];
#pragma unroll
    for (int t = 0; t < NT_S; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int t = 0; t < NT_S; ++t) {
        const __nv_bfloat16* kb = Ks + (t * 8 + g) * P + kk * 16 + 2 * t4;
        mma_bf16(s[t], qa[kk], ld32(kb), ld32(kb + 8));
      }
    }

    // scale, mask, online softmax; s[t][0..1] is row a, s[t][2..3] row b
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int t = 0; t < NT_S; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * 8 + 2 * t4 + (e & 1);
        const int qi = e < 2 ? row_a : row_b;
        bool vis = visible(p, qi, k0 + col);
        if constexpr (EXTRA) {
          if (p.seg) vis = vis && (e < 2 ? seg_a : seg_b) == Ss[col];
        }
        s[t][e] = vis ? s[t][e] * p.scale : NEG_INF;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[t][0], s[t][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[t][2], s[t][3]));
    }
    // a row's values are spread over the 4 lanes of one group
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float base_a = fmaxf(mn_a, MASK_CLAMP);
    const float base_b = fmaxf(mn_b, MASK_CLAMP);
    const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int t = 0; t < NT_S; ++t) {
      s[t][0] = expf(s[t][0] - base_a);
      s[t][1] = expf(s[t][1] - base_a);
      s[t][2] = expf(s[t][2] - base_b);
      s[t][3] = expf(s[t][3] - base_b);
      rs_a += s[t][0] + s[t][1];
      rs_b += s[t][2] + s[t][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
      rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
    }
    l_a = l_a * alpha_a + rs_a;
    l_b = l_b * alpha_b + rs_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int t = 0; t < NT_O; ++t) {
      o[t][0] *= alpha_a;
      o[t][1] *= alpha_a;
      o[t][2] *= alpha_b;
      o[t][3] *= alpha_b;
    }
    if constexpr (EXTRA) {
      // dropout after the sums: l keeps the undropped probabilities
      if (p.drop.scale != 0.f) {
#pragma unroll
        for (int t = 0; t < NT_S; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + t * 8 + 2 * t4 + (e & 1);
            s[t][e] *= dropout_keep(e < 2 ? hrow_a : hrow_b, kj,
                                    p.drop.thresh)
                           ? p.drop.scale
                           : 0.f;
          }
      }
    }

    // O += P V: the score fragments of n-tiles 2j and 2j+1 are the A
    // fragment of k-step j, split into bf16 hi + lo parts so that P keeps
    // the TPU kernel's fp32 precision; B is V, two kv rows per register
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * j][0], s[2 * j][1], &hi[0], &lo[0]);
      split_bf16(s[2 * j][2], s[2 * j][3], &hi[1], &lo[1]);
      split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], &hi[2], &lo[2]);
      split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], &hi[3], &lo[3]);
      const __nv_bfloat16* vr = Vs + (j * 16 + 2 * t4) * P + g;
#pragma unroll
      for (int t = 0; t < NT_O; ++t) {
        const __nv_bfloat16* vb = vr + t * 8;
        const uint32_t b0 = pack_bf16(vb[0], vb[P]);
        const uint32_t b1 = pack_bf16(vb[8 * P], vb[9 * P]);
        mma_bf16(o[t], hi, b0, b1);
        mma_bf16(o[t], lo, b0, b1);
      }
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o);
  const float ls_a = l_a > 0.f ? l_a : 1.f;
  const float ls_b = l_b > 0.f ? l_b : 1.f;
  if (row_a < p.sq) {
    __nv_bfloat16* orow =
        og + ((static_cast<long long>(bi) * p.sq + row_a) * p.nq + h) * HD;
#pragma unroll
    for (int t = 0; t < NT_O; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8 + 2 * t4) =
          pack_bf16(o[t][0] / ls_a, o[t][1] / ls_a);
    if (t4 == 0)
      p.lse[(static_cast<long long>(bi) * p.nq + h) * p.sq + row_a] =
          m_a + logf(ls_a);
  }
  if (row_b < p.sq) {
    __nv_bfloat16* orow =
        og + ((static_cast<long long>(bi) * p.sq + row_b) * p.nq + h) * HD;
#pragma unroll
    for (int t = 0; t < NT_O; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8 + 2 * t4) =
          pack_bf16(o[t][2] / ls_b, o[t][3] / ls_b);
    if (t4 == 0)
      p.lse[(static_cast<long long>(bi) * p.nq + h) * p.sq + row_b] =
          m_b + logf(ls_b);
  }
}

template <int HD, bool EXTRA>
cudaError_t dispatch(int dtype, const Params& p, cudaStream_t st) {
  const dim3 grid((p.sq + BM - 1) / BM, p.nq, p.b);
  if (dtype == 0)
    return launch(flash_fwd_fma_kernel<HD, EXTRA>, p, grid, FMA_THREADS,
                  fma_smem_bytes<HD>(), st);
  return launch(flash_fwd_mma_kernel<HD, EXTRA>, p, grid, MMA_THREADS,
                mma_smem_bytes<HD>(), st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; d has stride 1.
// For bf16, q, k and v must start 16-byte aligned and every stride must be
// a multiple of 8 elements: tiles load 16 bytes at a time.
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

// FlashAttention-2 backward for Hopper (sm_90a), behind a plain C interface:
// two kernels, as in the reference, both recomputing P = exp(S·scale − lse)
// tile by tile from q, k and the forward's lse, so the (s, s) score matrix
// never reaches device memory.
//
// - K2, entry tpusched_flash_bwd_dkdv, replaces the TPU kernel
//   tpusched/jaxbridge/attention.py:_flash_bwd_dkdv_kernel. One CUDA block
//   owns 64 key rows of one KV head and walks, in an in-block loop, every
//   (group query head r, q-tile) pair from the causal diagonal on:
//   dV += Pᵀ dO, dS = P ∘ (dO Vᵀ − D) · scale, dK += dSᵀ Q. dK and dV stay
//   in f32 registers for the whole walk, so the GQA group is reduced inside
//   the block: no atomics, no (b, s, h, d)-sized intermediate.
// - K3, entry tpusched_flash_bwd_dq, replaces _flash_bwd_dq_kernel. One
//   block owns 64 query rows of one query head and walks the key tiles up to
//   the diagonal: dQ += dS K, dQ in f32 registers. Kept apart from K2 (no
//   atomic dQ), so every gradient is deterministic.
//
// Both read lse and D = Σ_d dO ∘ O from the caller and never derive them
// (ring attention hands in global ones). Rows of a ragged last tile are
// masked by index, so a q row past s adds nothing to dK or dV whatever its
// lse holds.
//
// What bounds it on this card: at the training shape (b=1, s=4096, 16 query
// heads over 4 KV heads, d=128, causal, bf16) K2 does four causal-halved
// (s, s, d) products per head and K3 three, about 69 and 52 GFLOP, against
// some 50 MB that must move: operations bound both, far above the bf16
// ridge, so the products belong on the tensor cores.
//
// - bfloat16: four warps of 16 rows each, every product through mma.sync
//   m16n8k16 (bf16 in, f32 accumulate). K2 computes Sᵀ = K Qᵀ and
//   dPᵀ = V dOᵀ directly (key rows as the M dimension), so Pᵀ and dSᵀ are
//   already in the accumulator layout that is the A operand of dV += Pᵀ dO
//   and dK += dSᵀ Q; the transposes go to the staging of Q and dO, which
//   land in shared memory twice, row-major and transposed. K3 stages K both
//   ways for the same reason. P and dS are rounded to bf16 as A operands;
//   every sum stays f32. K2 walks q-tiles of 32 rows at d=128 (64 below),
//   so that two 64x128 f32 accumulators, S and dP fit the registers.
// - float32: the tensor cores would round to TF32, so the products run on
//   the CUDA cores with FMA from shared memory, four threads per row.
// wgmma, TMA and pipelined loads are the next steps toward the bound.
//
// Layout: q, dO (b, s, h, d) and k, v (b, s, kv, d), read through the
// element strides the caller gives (the head dim contiguous; in bf16 every
// row 16-byte aligned); lse and D (b·h, s) f32 contiguous. dq (b, s, h, d)
// and dk, dv (b, s, kv, d) are written contiguous in the input type. Query
// head hq reads KV head hq / (h / kv).
#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BLOCK = 64;                // rows a block owns: keys in K2, queries in K3

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dd;
  void* dq;
  void* dk;
  void* dv;
  int b, s, h, kv, n_rep;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t g_sb, g_ss, g_sh;              // dO
  float scale;
  int causal;
};

// Whether query row `row` sees key `col`; rows and keys past s see nothing.
__device__ __forceinline__ bool live(const Params& p, int row, int col) {
  return row < p.s && col < p.s && !(p.causal && col > row);
}

template <typename T>
__device__ __forceinline__ const T* head(const void* base, int64_t sb, int64_t sh, int bi,
                                         int hi) {
  return static_cast<const T*>(base) + bi * sb + hi * sh;
}

// rows [r0, r0 + rows) of a (b·h, s) f32 row vector, zero past s
__device__ __forceinline__ void stage_rows(const float* src, int r0, int rows, int s,
                                           float* dst) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) dst[i] = r0 + i < s ? src[r0 + i] : 0.f;
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMA, four threads per row

constexpr int FMA_THREADS = 256;
constexpr int FMA_COLS = BLOCK / 4;      // score columns per thread
constexpr int FMA_LDP = BLOCK + 1;       // padded row of a P or dS tile

template <int D>
__host__ __device__ constexpr int fma_ld() { return D + 1; }

template <int D>
__device__ __forceinline__ void stage_f32(const float* src, int64_t row_stride, int r0,
                                          int s, float* dst) {
  for (int idx = threadIdx.x; idx < BLOCK * D; idx += FMA_THREADS) {
    const int row = idx / D, col = idx % D;
    const int g = r0 + row;
    dst[row * fma_ld<D>() + col] = g < s ? src[g * row_stride + col] : 0.f;
  }
}

template <int D>
__host__ __device__ constexpr size_t dq_fma_smem() {
  return ((size_t)4 * BLOCK * fma_ld<D>() + BLOCK * FMA_LDP + 2 * BLOCK) * sizeof(float);
}

// K3 in f32: block (q-tile, b·h); row r of the tile, columns quad + 4j.
template <int D>
__global__ void __launch_bounds__(FMA_THREADS) flash_bwd_dq_fma(const Params p) {
  constexpr int LD = fma_ld<D>();
  constexpr int DPT = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sG = sQ + BLOCK * LD;
  float* sK = sG + BLOCK * LD;
  float* sV = sK + BLOCK * LD;
  float* sS = sV + BLOCK * LD;
  float* sL = sS + BLOCK * FMA_LDP;
  float* sD = sL + BLOCK;

  const int nq = (p.s + BLOCK - 1) / BLOCK;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BLOCK;   // long causal rows first
  const int bh = blockIdx.y, bi = bh / p.h, hi = bh % p.h, kvi = hi / p.n_rep;
  const int n_tiles = p.causal ? (min(q0 + BLOCK, p.s) - 1) / BLOCK + 1 : nq;
  const int tid = threadIdx.x, r = tid >> 2, quad = tid & 3;
  const int row = q0 + r;

  stage_f32<D>(head<float>(p.q, p.q_sb, p.q_sh, bi, hi), p.q_ss, q0, p.s, sQ);
  stage_f32<D>(head<float>(p.dout, p.g_sb, p.g_sh, bi, hi), p.g_ss, q0, p.s, sG);
  stage_rows(p.lse + (int64_t)bh * p.s, q0, BLOCK, p.s, sL);
  stage_rows(p.dd + (int64_t)bh * p.s, q0, BLOCK, p.s, sD);
  const float* k = head<float>(p.k, p.k_sb, p.k_sh, bi, kvi);
  const float* v = head<float>(p.v, p.v_sb, p.v_sh, bi, kvi);

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BLOCK;
    __syncthreads();                     // the previous tile is consumed
    stage_f32<D>(k, p.k_ss, k0, p.s, sK);
    stage_f32<D>(v, p.v_ss, k0, p.s, sV);
    __syncthreads();

    float sc[FMA_COLS], dp[FMA_COLS];
#pragma unroll
    for (int j = 0; j < FMA_COLS; ++j) sc[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * LD + d], gd = sG[r * LD + d];
#pragma unroll
      for (int j = 0; j < FMA_COLS; ++j) {
        sc[j] += qd * sK[(quad + 4 * j) * LD + d];
        dp[j] += gd * sV[(quad + 4 * j) * LD + d];
      }
    }
#pragma unroll
    for (int j = 0; j < FMA_COLS; ++j) {
      const float pj = live(p, row, k0 + quad + 4 * j) ? expf(sc[j] * p.scale - sL[r]) : 0.f;
      sS[r * FMA_LDP + quad + 4 * j] = pj * (dp[j] - sD[r]) * p.scale;
    }
    __syncwarp();                        // a row's dS is written and read by one warp

    for (int c = 0; c < BLOCK; ++c) {
      const float ds = sS[r * FMA_LDP + c];
      const float* krow = sK + c * LD + quad;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] += ds * krow[4 * j];
    }
  }

  if (row < p.s) {
    float* dq = static_cast<float*>(p.dq) + (((int64_t)bi * p.s + row) * p.h + hi) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq[quad + 4 * j] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through mma.sync m16n8k16, four warps of 16 rows

constexpr int MMA_THREADS = 128;

// 16 bytes of padding per staged row: the fragment reads of a warp's eight
// row groups land on distinct banks, and rows stay 16-byte aligned.
template <int D>
__host__ __device__ constexpr int mma_ld() { return D + 8; }

// Copy rows [r0, r0 + rows) of an (s, D) slice into shared memory with
// 16-byte loads, zero past s: row-major into `dst` (row stride ld) and, if
// `dst_t` is given, transposed into dst_t[col * ld_t + row].
template <int D>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* src, int64_t row_stride,
                                           int r0, int rows, int s, __nv_bfloat16* dst,
                                           int ld, __nv_bfloat16* dst_t, int ld_t) {
  for (int idx = threadIdx.x * 8; idx < rows * D; idx += MMA_THREADS * 8) {
    const int row = idx / D, col = idx % D;
    const int g = r0 + row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < s) val = *reinterpret_cast<const uint4*>(src + g * row_stride + col);
    if (dst) *reinterpret_cast<uint4*>(dst + row * ld + col) = val;
    if (dst_t) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(col + j) * ld_t + row] = e[j];
    }
  }
}

constexpr int DQ_LDT = BLOCK + 8;        // row of K3's transposed K tile

template <int D>
__host__ __device__ constexpr size_t dq_mma_smem() {
  return ((size_t)4 * BLOCK * mma_ld<D>() + (size_t)D * DQ_LDT) * sizeof(__nv_bfloat16) +
         2 * BLOCK * sizeof(float);
}

// K3 in bf16: block (q-tile, b·h); warp w owns query rows 16w .. 16w + 15.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_mma(const Params p) {
  constexpr int LD = mma_ld<D>();
  constexpr int KD = D / 16;             // k-steps over the head dim
  constexpr int ND = D / 8;              // n-tiles of dQ
  constexpr int NS = BLOCK / 8;          // n-tiles of S and dP
  constexpr int KS = BLOCK / 16;         // k-steps of dS K
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sG = sQ + BLOCK * LD;
  __nv_bfloat16* sK = sG + BLOCK * LD;
  __nv_bfloat16* sV = sK + BLOCK * LD;
  __nv_bfloat16* sKt = sV + BLOCK * LD;
  float* sL = reinterpret_cast<float*>(sKt + D * DQ_LDT);
  float* sD = sL + BLOCK;

  const int nq = (p.s + BLOCK - 1) / BLOCK;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BLOCK;   // long causal rows first
  const int bh = blockIdx.y, bi = bh / p.h, hi = bh % p.h, kvi = hi / p.n_rep;
  const int n_tiles = p.causal ? (min(q0 + BLOCK, p.s) - 1) / BLOCK + 1 : nq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  // this thread holds rows g and g + 8 of its warp's 16
  const int lr[2] = {warp * 16 + g, warp * 16 + g + 8};

  stage_bf16<D>(head<__nv_bfloat16>(p.q, p.q_sb, p.q_sh, bi, hi), p.q_ss, q0, BLOCK, p.s,
                sQ, LD, nullptr, 0);
  stage_bf16<D>(head<__nv_bfloat16>(p.dout, p.g_sb, p.g_sh, bi, hi), p.g_ss, q0, BLOCK,
                p.s, sG, LD, nullptr, 0);
  stage_rows(p.lse + (int64_t)bh * p.s, q0, BLOCK, p.s, sL);
  stage_rows(p.dd + (int64_t)bh * p.s, q0, BLOCK, p.s, sD);
  const __nv_bfloat16* k = head<__nv_bfloat16>(p.k, p.k_sb, p.k_sh, bi, kvi);
  const __nv_bfloat16* v = head<__nv_bfloat16>(p.v, p.v_sb, p.v_sh, bi, kvi);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BLOCK;
    __syncthreads();                     // the previous tile is consumed
    stage_bf16<D>(k, p.k_ss, k0, BLOCK, p.s, sK, LD, sKt, DQ_LDT);
    stage_bf16<D>(v, p.v_ss, k0, BLOCK, p.s, sV, LD, nullptr, 0);
    __syncthreads();

    // S = Q Kᵀ and dP = dO Vᵀ for this warp's 16 rows
    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], ga[4];
      load_a(qa, sQ + warp * 16 * LD + kk * 16, LD, g, c2);
      load_a(ga, sG + warp * 16 * LD + kk * 16, LD, g, c2);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kb = sK + (n * 8 + g) * LD + kk * 16 + c2;
        const __nv_bfloat16* vb = sV + (n * 8 + g) * LD + kk * 16 + c2;
        mma_16816(sc[n], qa, ld32(kb), ld32(kb + 8));
        mma_16816(dp[n], ga, ld32(vb), ld32(vb + 8));
      }
    }

    // element e of a tile sits at local row lr[e >> 1], column c2 + (e & 1)
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lr[e >> 1];
        const float pe = live(p, q0 + r, k0 + n * 8 + c2 + (e & 1))
                             ? expf(sc[n][e] * p.scale - sL[r])
                             : 0.f;
        sc[n][e] = pe * (dp[n][e] - sD[r]) * p.scale;       // dS
      }
    }

    // dQ += dS K, with dS's accumulator layout as the A operand
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t da[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* kb = sKt + (n * 8 + g) * DQ_LDT + kk * 16 + c2;
        mma_16816(acc[n], da, ld32(kb), ld32(kb + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lr[r];
    if (row >= p.s) continue;
    __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq) +
                        (((int64_t)bi * p.s + row) * p.h + hi) * D + c2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dq + n * 8) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// K2: dK and dV

template <int D>
__host__ __device__ constexpr size_t dkdv_fma_smem() {
  return ((size_t)4 * BLOCK * fma_ld<D>() + 2 * BLOCK * FMA_LDP + 2 * BLOCK) * sizeof(float);
}

// K2 in f32: block (k-tile, b·kv); key row r of the tile, q columns quad + 4j.
template <int D>
__global__ void __launch_bounds__(FMA_THREADS) flash_bwd_dkdv_fma(const Params p) {
  constexpr int LD = fma_ld<D>();
  constexpr int DPT = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + BLOCK * LD;
  float* sQ = sV + BLOCK * LD;
  float* sG = sQ + BLOCK * LD;
  float* sP = sG + BLOCK * LD;
  float* sS = sP + BLOCK * FMA_LDP;
  float* sL = sS + BLOCK * FMA_LDP;
  float* sD = sL + BLOCK;

  const int k0 = blockIdx.x * BLOCK;     // early key tiles walk the most q-tiles: first
  const int bkv = blockIdx.y, bi = bkv / p.kv, kvi = bkv % p.kv;
  const int nq = (p.s + BLOCK - 1) / BLOCK;
  const int first = p.causal ? k0 / BLOCK : 0;   // q-tiles before it see no key here
  const int tid = threadIdx.x, r = tid >> 2, quad = tid & 3;
  const int key = k0 + r;

  stage_f32<D>(head<float>(p.k, p.k_sb, p.k_sh, bi, kvi), p.k_ss, k0, p.s, sK);
  stage_f32<D>(head<float>(p.v, p.v_sb, p.v_sh, bi, kvi), p.v_ss, k0, p.s, sV);

  float dk[DPT], dv[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk[j] = dv[j] = 0.f;

  for (int rep = 0; rep < p.n_rep; ++rep) {
    const int hq = kvi * p.n_rep + rep;
    const int64_t bh = (int64_t)bi * p.h + hq;
    const float* q = head<float>(p.q, p.q_sb, p.q_sh, bi, hq);
    const float* gq = head<float>(p.dout, p.g_sb, p.g_sh, bi, hq);
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * BLOCK;
      __syncthreads();                   // the previous q-tile is consumed
      stage_f32<D>(q, p.q_ss, q0, p.s, sQ);
      stage_f32<D>(gq, p.g_ss, q0, p.s, sG);
      stage_rows(p.lse + bh * p.s, q0, BLOCK, p.s, sL);
      stage_rows(p.dd + bh * p.s, q0, BLOCK, p.s, sD);
      __syncthreads();

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ for key row r
      float sc[FMA_COLS], dp[FMA_COLS];
#pragma unroll
      for (int j = 0; j < FMA_COLS; ++j) sc[j] = dp[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = sK[r * LD + d], vd = sV[r * LD + d];
#pragma unroll
        for (int j = 0; j < FMA_COLS; ++j) {
          sc[j] += kd * sQ[(quad + 4 * j) * LD + d];
          dp[j] += vd * sG[(quad + 4 * j) * LD + d];
        }
      }
#pragma unroll
      for (int j = 0; j < FMA_COLS; ++j) {
        const int c = quad + 4 * j;
        const float pj = live(p, q0 + c, key) ? expf(sc[j] * p.scale - sL[c]) : 0.f;
        sP[r * FMA_LDP + c] = pj;
        sS[r * FMA_LDP + c] = pj * (dp[j] - sD[c]) * p.scale;
      }
      __syncwarp();                      // a row's P and dS are written and read by one warp

      for (int c = 0; c < BLOCK; ++c) {
        const float pc = sP[r * FMA_LDP + c], ds = sS[r * FMA_LDP + c];
        const float* grow = sG + c * LD + quad;
        const float* qrow = sQ + c * LD + quad;
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv[j] += pc * grow[4 * j];
          dk[j] += ds * qrow[4 * j];
        }
      }
    }
  }

  if (key < p.s) {
    const int64_t off = (((int64_t)bi * p.s + key) * p.kv + kvi) * D;
    float* dko = static_cast<float*>(p.dk) + off;
    float* dvo = static_cast<float*>(p.dv) + off;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dko[quad + 4 * j] = dk[j];
      dvo[quad + 4 * j] = dv[j];
    }
  }
}

// K2's q-tile in bf16: 32 rows at d=128 keeps dK, dV (64 registers each),
// Sᵀ and dPᵀ (16 each) inside a thread's registers; 64 rows below.
template <int D>
__host__ __device__ constexpr int kq() { return D > 64 ? 32 : 64; }

template <int D>
__host__ __device__ constexpr int kq_ldt() { return kq<D>() + 8; }

template <int D>
__host__ __device__ constexpr size_t dkdv_mma_smem() {
  return ((size_t)2 * BLOCK * mma_ld<D>() + (size_t)2 * kq<D>() * mma_ld<D>() +
          (size_t)2 * D * kq_ldt<D>()) * sizeof(__nv_bfloat16) +
         2 * kq<D>() * sizeof(float);
}

// K2 in bf16: block (k-tile, b·kv); warp w owns key rows 16w .. 16w + 15.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkdv_mma(const Params p) {
  constexpr int LD = mma_ld<D>();
  constexpr int KQ = kq<D>();
  constexpr int LDT = kq_ldt<D>();
  constexpr int KD = D / 16;             // k-steps over the head dim
  constexpr int ND = D / 8;              // n-tiles of dK and dV
  constexpr int NQ = KQ / 8;             // n-tiles of Sᵀ and dPᵀ
  constexpr int KS = KQ / 16;            // k-steps of Pᵀ dO and dSᵀ Q
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BLOCK * LD;
  __nv_bfloat16* sQ = sV + BLOCK * LD;
  __nv_bfloat16* sG = sQ + KQ * LD;
  __nv_bfloat16* sQt = sG + KQ * LD;
  __nv_bfloat16* sGt = sQt + D * LDT;
  float* sL = reinterpret_cast<float*>(sGt + D * LDT);
  float* sD = sL + KQ;

  const int k0 = blockIdx.x * BLOCK;     // early key tiles walk the most q-tiles: first
  const int bkv = blockIdx.y, bi = bkv / p.kv, kvi = bkv % p.kv;
  const int nq = (p.s + KQ - 1) / KQ;
  const int first = p.causal ? k0 / KQ : 0;      // q-tiles before it see no key here
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  // this thread holds key rows g and g + 8 of its warp's 16
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  stage_bf16<D>(head<__nv_bfloat16>(p.k, p.k_sb, p.k_sh, bi, kvi), p.k_ss, k0, BLOCK, p.s,
                sK, LD, nullptr, 0);
  stage_bf16<D>(head<__nv_bfloat16>(p.v, p.v_sb, p.v_sh, bi, kvi), p.v_ss, k0, BLOCK, p.s,
                sV, LD, nullptr, 0);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int rep = 0; rep < p.n_rep; ++rep) {
    const int hq = kvi * p.n_rep + rep;
    const int64_t bh = (int64_t)bi * p.h + hq;
    const __nv_bfloat16* q = head<__nv_bfloat16>(p.q, p.q_sb, p.q_sh, bi, hq);
    const __nv_bfloat16* gq = head<__nv_bfloat16>(p.dout, p.g_sb, p.g_sh, bi, hq);
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * KQ;
      __syncthreads();                   // the previous q-tile is consumed
      stage_bf16<D>(q, p.q_ss, q0, KQ, p.s, sQ, LD, sQt, LDT);
      stage_bf16<D>(gq, p.g_ss, q0, KQ, p.s, sG, LD, sGt, LDT);
      stage_rows(p.lse + bh * p.s, q0, KQ, p.s, sL);
      stage_rows(p.dd + bh * p.s, q0, KQ, p.s, sD);
      __syncthreads();

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ for this warp's 16 key rows
      float sc[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, sK + warp * 16 * LD + kk * 16, LD, g, c2);
        load_a(va, sV + warp * 16 * LD + kk * 16, LD, g, c2);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const __nv_bfloat16* qb = sQ + (n * 8 + g) * LD + kk * 16 + c2;
          const __nv_bfloat16* gb = sG + (n * 8 + g) * LD + kk * 16 + c2;
          mma_16816(sc[n], ka, ld32(qb), ld32(qb + 8));
          mma_16816(dp[n], va, ld32(gb), ld32(gb + 8));
        }
      }

      // element e of a tile sits at key keys[e >> 1], q column c2 + (e & 1)
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + c2 + (e & 1);
          const float pe =
              live(p, q0 + c, keys[e >> 1]) ? expf(sc[n][e] * p.scale - sL[c]) : 0.f;
          sc[n][e] = pe;                                    // Pᵀ
          dp[n][e] = pe * (dp[n][e] - sD[c]) * p.scale;     // dSᵀ
        }
      }

      // dV += Pᵀ dO and dK += dSᵀ Q, with Pᵀ and dSᵀ as A operands
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
        const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const __nv_bfloat16* gb = sGt + (n * 8 + g) * LDT + kk * 16 + c2;
          const __nv_bfloat16* qb = sQt + (n * 8 + g) * LDT + kk * 16 + c2;
          mma_16816(dv[n], pa, ld32(gb), ld32(gb + 8));
          mma_16816(dk[n], da, ld32(qb), ld32(qb + 8));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.s) continue;
    const int64_t off = (((int64_t)bi * p.s + keys[r]) * p.kv + kvi) * D + c2;
    __nv_bfloat16* dko = static_cast<__nv_bfloat16*>(p.dk) + off;
    __nv_bfloat16* dvo = static_cast<__nv_bfloat16*>(p.dv) + off;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dko + n * 8) = pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvo + n * 8) = pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(bool bf16, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.s + BLOCK - 1) / BLOCK, p.b * p.kv);
  if (bf16)
    return launch(flash_bwd_dkdv_mma<D>, grid, MMA_THREADS, dkdv_mma_smem<D>(), p, stream);
  return launch(flash_bwd_dkdv_fma<D>, grid, FMA_THREADS, dkdv_fma_smem<D>(), p, stream);
}

template <int D>
cudaError_t launch_dq(bool bf16, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.s + BLOCK - 1) / BLOCK, p.b * p.h);
  if (bf16) return launch(flash_bwd_dq_mma<D>, grid, MMA_THREADS, dq_mma_smem<D>(), p, stream);
  return launch(flash_bwd_dq_fma<D>, grid, FMA_THREADS, dq_fma_smem<D>(), p, stream);
}

// Checks what both entry points share; fills `p` on success.
cudaError_t make_params(Params& p, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dd, int b, int s,
                        int h, int kv, const int64_t* st, float scale, int causal,
                        int dtype) {
  if (b < 1 || s < 1 || kv < 1 || h % kv != 0 || b * h > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (dtype == 1 && !(aligned16(q, st[0], st[1], st[2]) && aligned16(k, st[3], st[4], st[5]) &&
                      aligned16(v, st[6], st[7], st[8]) &&
                      aligned16(dout, st[9], st[10], st[11])))
    return cudaErrorMisalignedAddress;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.dd = static_cast<const float*>(dd);
  p.dq = p.dk = p.dv = nullptr;
  p.b = b;
  p.s = s;
  p.h = h;
  p.kv = kv;
  p.n_rep = h / kv;
  p.q_sb = st[0], p.q_ss = st[1], p.q_sh = st[2];
  p.k_sb = st[3], p.k_ss = st[4], p.k_sh = st[5];
  p.v_sb = st[6], p.v_ss = st[7], p.v_sh = st[8];
  p.g_sb = st[9], p.g_ss = st[10], p.g_sh = st[11];
  p.scale = scale;
  p.causal = causal;
  return cudaSuccess;
}

}  // namespace

// Both entry points: q, dO (b, s, h, d) and k, v (b, s, kv, d) with the
// element strides (batch, seq, head) of q, k, v, dO in that order; lse and
// dd (b·h, s) f32 contiguous; outputs contiguous. dtype: 0 = float32,
// 1 = bfloat16. Each returns the cudaError_t of its launch.
extern "C" int tpusched_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* dd,
                                       void* dk, void* dv, int b, int s, int h, int kv,
                                       int d, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                       int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                       int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                       int64_t g_sb, int64_t g_ss, int64_t g_sh,
                                       float scale, int causal, int dtype, void* stream) {
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, g_sb, g_ss, g_sh};
  Params p;
  cudaError_t err = make_params(p, q, k, v, dout, lse, dd, b, s, h, kv, st, scale, causal,
                                dtype);
  if (err != cudaSuccess) return (int)err;
  p.dk = dk;
  p.dv = dv;
  const bool bf16 = dtype == 1;
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch_dkdv<32>(bf16, p, stm);
    case 64: return (int)launch_dkdv<64>(bf16, p, stm);
    case 128: return (int)launch_dkdv<128>(bf16, p, stm);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int tpusched_flash_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* dd,
                                     void* dq, int b, int s, int h, int kv, int d,
                                     int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                     int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                     int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                     int64_t g_sb, int64_t g_ss, int64_t g_sh,
                                     float scale, int causal, int dtype, void* stream) {
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, g_sb, g_ss, g_sh};
  Params p;
  cudaError_t err = make_params(p, q, k, v, dout, lse, dd, b, s, h, kv, st, scale, causal,
                                dtype);
  if (err != cudaSuccess) return (int)err;
  p.dq = dq;
  const bool bf16 = dtype == 1;
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch_dq<32>(bf16, p, stm);
    case 64: return (int)launch_dq<64>(bf16, p, stm);
    case 128: return (int)launch_dq<128>(bf16, p, stm);
    default: return (int)cudaErrorInvalidValue;
  }
}

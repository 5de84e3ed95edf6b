// FlashAttention-2 backward for Hopper (sm_90a), behind a plain C interface:
// two kernels, as in the reference, both recomputing P = exp(S·scale − lse)
// tile by tile from q, k and the forward's lse, so the (s, s) score matrix
// never reaches device memory.
//
// - K2, entry tpusched_flash_bwd_dkdv, replaces the TPU kernel
//   tpusched/jaxbridge/attention.py:_flash_bwd_dkdv_kernel:
//   dV = Σ Pᵀ dO and dK = Σ dSᵀ Q with dS = P ∘ (dO Vᵀ − D) · scale, summed
//   over the GQA group's query heads inside the kernel, as the reference
//   does: no atomics, no (b, s, h, d)-sized intermediate, and the same bits
//   on every run.
// - K3, entry tpusched_flash_bwd_dq, replaces
//   tpusched/jaxbridge/attention.py:_flash_bwd_dq_kernel: dQ = Σ_j dS_j K_j
//   over the key tiles a query row sees, P recomputed from lse, D given. A
//   block owns query rows of one query head and walks the key tiles up to
//   the diagonal with dQ in f32 registers. Kept apart from K2: dQ inside K2
//   would save K3's two recomputed products (S and dP), but only with
//   atomic adds into a scratch buffer, whose sums then depend on the order
//   the blocks run in; apart, each dQ element is summed by one warpgroup in
//   key order, and every gradient has the same bits on every run.
//
// Both read lse and D = Σ_d dO ∘ O from the caller and never derive them
// (ring attention hands in global ones). Rows of a ragged last tile are
// masked by index, so a q row past s adds nothing to dK or dV whatever its
// lse holds.
//
// What bounds them on this card: operations. At the training shape (b=1,
// s=4096, 16 query heads over 4 KV heads, d=128, causal, bf16) K2 does four
// causal-halved (s, s, d) products per head, 137.5 GFLOP, against about
// 51 MB that must move, and K3 three, 103.1 GFLOP, against about 59 MB (q,
// dO, dq, k, v, lse, D): far above the bf16 ridge, so the products belong
// on the tensor cores at the rate only wgmma gives.
//
// K2 by dtype and head dim (dispatch by shape, in the entry point):
// - bfloat16, d = 128: hopper::flash_bwd_dkdv_sm90. Work is cut into
//   segments (b·kv, 64-key tile, q-tile range); a segment walks every query
//   head of the group over its q-tiles, so dK and dV of its keys leave the
//   block complete. The schedule, built on the host by
//   attention._dkdv_schedule and read as an int32 table, gives each causal
//   block key tile i and key tile n − 1 − i, whose walks add up to the same
//   length for every block (the reference's longest key tile walked 1.97×
//   the mean); non-causal blocks take one key tile each. A block is two
//   consumer warpgroups and a producer warpgroup (setmaxnreg 232 and 40):
//   one producer thread loads K and V of a segment once by TMA, and the
//   producer warp streams Q and dO tiles by TMA, lse and D by cp.async, into
//   a four-stage ring of full/empty mbarriers. Consumer warpgroups take the
//   steps in turn, both over all 64 keys: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ are
//   wgmma m64n64k16 with both operands in shared memory, K-major; Pᵀ and
//   dSᵀ are rounded to bf16 straight from their accumulators into the A
//   registers of dV += Pᵀ dO and dK += dSᵀ Q, wgmma m64n128k16 whose B (dO,
//   Q) is read MN-major through the transpose bit, so no tile is ever
//   transposed by hand. At a segment's end the two warpgroups add their dK
//   and dV through the then idle K/V bytes, in a fixed order.
// - bfloat16, d = 32 or 64 (the tiny configuration's): four warps of 16 key
//   rows on mma.sync m16n8k16, Q and dO staged row-major and transposed
//   (flash_bwd_dkdv_mma), one block per (64-key tile, KV head).
// - float32: the tensor cores would round to TF32, so the products run on
//   the CUDA cores with FMA from shared memory, four threads per row.
//
// K3 by dtype and head dim:
// - bfloat16, d = 128: hopper::flash_bwd_dq_sm90. A block is one query
//   head's 128-row q-tile, the heaviest causal tiles dispatched first, with
//   two consumer warpgroups of 64 rows each and a producer warpgroup
//   (setmaxnreg 240 and 24). One producer thread loads the block's Q and
//   dO once by TMA, then streams K and V of the query head's KV head in
//   64-key tiles, up to the block's diagonal, into a three-stage ring of
//   full/empty mbarriers. Per key tile a consumer warpgroup runs S = Q Kᵀ
//   and dP = dO Vᵀ as wgmma m64n64k16 from shared memory, both operands
//   K-major, forms P = exp(S·scale − lse) while dP is still running (lse
//   and D of its two rows sit in registers from the start), then dS =
//   P ∘ (dP − D) · scale, rounds dS to bf16 straight from the accumulator
//   into A registers, and adds dS K with wgmma m64n128k16 whose B, K, is
//   read MN-major through the transpose bit: no K tile is transposed by
//   hand. The next tile's S and dP are issued right behind dS K, so a
//   warpgroup's products run back to back instead of draining after each
//   tile (PERF.md has both times); barriers are touched only while no
//   product is in flight, or ptxas serializes every wgmma (C7514, C7518).
//   The last causal tile lies wholly above warpgroup 0's rows; it skips
//   the products there but still releases the stage. No host table: the
//   block's work follows from its indices, so the C signature is K3's of
//   the mma.sync version.
// - bfloat16, d = 32 or 64: flash_bwd_dq_mma, four warps of 16 query rows
//   on mma.sync m16n8k16 with K staged transposed, one block per 64-row
//   q-tile.
// - float32: flash_bwd_dq_fma, FMA on the CUDA cores, as K2's.
//
// Left for later on both d = 128 paths: in K2, the same issue-ahead of the
// next step's products that K3 does; TMA multicast of K/V or of Q/dO
// across blocks with clusters; a persistent grid; fp8.
//
// Layout: q, dO (b, s, h, d) and k, v (b, s, kv, d), read through the
// element strides the caller gives (the head dim contiguous; in bf16 every
// row 16-byte aligned, for vector loads and TMA); lse and D (b·h, s) f32
// contiguous. dq (b, s, h, d) and dk, dv (b, s, kv, d) are written
// contiguous in the input type. Query head hq reads KV head hq / (h / kv).
#include <math.h>

#include "sm90.cuh"

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

// K3 in bf16 at d <= 64: block (q-tile, b·h); warp w owns query rows
// 16w .. 16w + 15.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_mma(const Params p) {
  static_assert(D <= 64, "bf16 at d=128 runs on hopper::flash_bwd_dq_sm90");
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

// K2's q-tile in bf16 at d <= 64 (d = 128 runs on hopper::flash_bwd_dkdv_sm90)
constexpr int KQ = 64;
constexpr int KQ_LDT = KQ + 8;           // row of the transposed Q and dO tiles

template <int D>
__host__ __device__ constexpr size_t dkdv_mma_smem() {
  return ((size_t)2 * BLOCK * mma_ld<D>() + (size_t)2 * KQ * mma_ld<D>() +
          (size_t)2 * D * KQ_LDT) * sizeof(__nv_bfloat16) +
         2 * KQ * sizeof(float);
}

// K2 in bf16: block (k-tile, b·kv); warp w owns key rows 16w .. 16w + 15.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkdv_mma(const Params p) {
  static_assert(D <= 64, "bf16 at d=128 runs on hopper::flash_bwd_dkdv_sm90");
  constexpr int LD = mma_ld<D>();
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
  __nv_bfloat16* sGt = sQt + D * KQ_LDT;
  float* sL = reinterpret_cast<float*>(sGt + D * KQ_LDT);
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
      stage_bf16<D>(q, p.q_ss, q0, KQ, p.s, sQ, LD, sQt, KQ_LDT);
      stage_bf16<D>(gq, p.g_ss, q0, KQ, p.s, sG, LD, sGt, KQ_LDT);
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
          const __nv_bfloat16* gb = sGt + (n * 8 + g) * KQ_LDT + kk * 16 + c2;
          const __nv_bfloat16* qb = sQt + (n * 8 + g) * KQ_LDT + kk * 16 + c2;
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
// K2 in bf16 at d = 128: wgmma and TMA with a producer warp (sm90.cuh), on
// the balanced schedule attention._dkdv_schedule builds on the host

namespace hopper {

constexpr int D = 128;
constexpr int BK = 64;                   // keys of a segment, shared by both consumer warpgroups
constexpr int BQ = 64;                   // query rows of a step
constexpr int STAGES = 4;                // (Q, dO, lse, D) tiles in flight: two per warpgroup
constexpr int CONSUMERS = 2;             // consumer warpgroups; one producer warpgroup follows
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr uint32_t KV_BYTES = BK * D * 2;          // K or V of a segment
constexpr uint32_t QT_BYTES = BQ * D * 2;          // a Q or dO tile
constexpr size_t SMEM = 1024 + 2 * KV_BYTES + STAGES * (2 * QT_BYTES + 2 * BQ * 4) + 64;
static_assert(2 * KV_BYTES == 64 * 128 * 4, "a warpgroup's dK or dV fits the K/V bytes");

struct Params {
  CUtensorMap tq, tk, tv, tdo;
  const float* lse;
  const float* dd;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  // two segments per block: (b·kv, key tile, first q-tile, end q-tile), a
  // negative key tile for none; each walks the group's n_rep query heads
  const int4* sched;
  int s, kv, n_rep;
  float scale, scale_log2;
  int causal;
};

// Rows key0 and key0 + 8 of a warpgroup's 64 x 128 f32 accumulator (dK or
// dV in K2, dQ in K3, whose rows are queries) as bf16 at
// dst + key · row_stride (dst already at this thread's first column).
__device__ __forceinline__ void store_rows(const float (&x)[64], __nv_bfloat16* dst, int key0,
                                           int s, int64_t row_stride) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= s) continue;
    __nv_bfloat16* row = dst + key * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) = pack_bf16(x[4 * n + 2 * r], x[4 * n + 2 * r + 1]);
  }
}

__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_sm90(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* sK = smem;
  uint8_t* sV = smem + KV_BYTES;
  float* xchg = reinterpret_cast<float*>(smem);    // the K/V bytes once a segment's steps are done
  uint8_t* sStage = smem + 2 * KV_BYTES;           // stage st: Q at st · 2 QT_BYTES, dO after it
  float* sRows = reinterpret_cast<float*>(sStage + STAGES * 2 * QT_BYTES);   // stage st: lse, D
  uint64_t* bars = reinterpret_cast<uint64_t*>(sRows + STAGES * 2 * BQ);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + STAGES;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1 + 32);      // the TMA's expect-tx, then each lane's lse/D copies
      mbar_init(&empty[st], 4);          // the warps of the warpgroup that took the step
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Step i of a segment is query head r = i / len, q-tile first + i % len;
  // the block's steps are numbered on through both segments, step n lands
  // in stage n % STAGES and consumer warpgroup n % 2 takes it.
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one warp streams K/V per segment and (Q, dO, lse, D) per
    // step. setmaxnreg only moves the registers the block got at launch,
    // 384 x 168: 2 x 128 x 232 + 128 x 40 fits (24 for the producer spills;
    // a split over the launch's total leaves setmaxnreg.inc waiting forever)
    setmaxnreg_dec<40>();
    if (threadIdx.x / 32 == CONSUMERS * 4) {
      const int lane = threadIdx.x % 32;
      int step = 0;
      for (int seg = 0; seg < 2; ++seg) {
        const int4 e = p.sched[2 * blockIdx.x + seg];
        if (e.y < 0) break;
        const int bi = e.x / p.kv, kvi = e.x % p.kv;
        if (lane == 0) {
          mbar_wait(kv_empty, (seg & 1) ^ 1);
          mbar_arrive_expect_tx(kv_full, 2 * KV_BYTES);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(sK + c * (KV_BYTES / 2), &p.tk, kv_full, c * 64, kvi, e.y * BK, bi);
            tma_load_4d(sV + c * (KV_BYTES / 2), &p.tv, kv_full, c * 64, kvi, e.y * BK, bi);
          }
        }
        for (int r = 0; r < p.n_rep; ++r) {
          const int hq = kvi * p.n_rep + r;
          const int64_t row = ((int64_t)bi * p.kv * p.n_rep + hq) * p.s;   // of lse and D
          for (int qt = e.z; qt < e.w; ++qt, ++step) {
            const int st = step % STAGES, q0 = qt * BQ;
            uint8_t* stage = sStage + st * 2 * QT_BYTES;
            float* rows = sRows + st * 2 * BQ;
            mbar_wait(&empty[st], ((step / STAGES) & 1) ^ 1);
            if (lane == 0) {
              mbar_arrive_expect_tx(&full[st], 2 * QT_BYTES);
              for (int c = 0; c < D / 64; ++c) {
                tma_load_4d(stage + c * (QT_BYTES / 2), &p.tq, &full[st], c * 64, hq, q0, bi);
                tma_load_4d(stage + QT_BYTES + c * (QT_BYTES / 2), &p.tdo, &full[st], c * 64, hq,
                            q0, bi);
              }
            }
            for (int i = lane; i < BQ; i += 32) {
              const bool in = q0 + i < p.s;
              const int64_t at = row + (in ? q0 + i : 0);
              cp_async_f32(rows + i, p.lse + at, in);
              cp_async_f32(rows + BQ + i, p.dd + at, in);
            }
            cp_async_arrive(&full[st]);
          }
        }
      }
    }
  } else {
    // consumer warpgroup wg: every key of the segment, every other step
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c2 = (lane % 4) * 2;
    const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
    int step = 0;
    for (int seg = 0; seg < 2; ++seg) {
      const int4 e = p.sched[2 * blockIdx.x + seg];
      if (e.y < 0) break;
      const int bi = e.x / p.kv, kvi = e.x % p.kv;
      const int k0 = e.y * BK;
      const int key0 = k0 + warp * 16 + lane / 4;         // and key0 + 8
      const int len = e.w - e.z, n_steps = p.n_rep * len;
      float dk[64], dv[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(kv_full, seg & 1);

      for (int i = (wg - step) & 1; i < n_steps; i += 2) {
        const int n = step + i, st = n % STAGES, q0 = (e.z + i % len) * BQ;
        const uint32_t q_base = smem_u32(sStage + st * 2 * QT_BYTES);
        const uint32_t g_base = q_base + QT_BYTES;
        const float* sL = sRows + st * 2 * BQ;
        const float* sD = sL + BQ;
        mbar_wait(&full[st], (n / STAGES) & 1);

        // Sᵀ = K Qᵀ, then dPᵀ = V dOᵀ: A = K or V, B = the Q or dO tile,
        // all K-major; Pᵀ is formed while dPᵀ runs
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sc, gmma_desc(k_base + (kk / 4) * (KV_BYTES / 2) + (kk % 4) * 32, 16, 1024),
                       gmma_desc(q_base + (kk / 4) * (QT_BYTES / 2) + (kk % 4) * 32, 16, 1024),
                       kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dp, gmma_desc(v_base + (kk / 4) * (KV_BYTES / 2) + (kk % 4) * 32, 16, 1024),
                       gmma_desc(g_base + (kk / 4) * (QT_BYTES / 2) + (kk % 4) * 32, 16, 1024),
                       kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        keep(sc);

        // Pᵀ = exp(Sᵀ·scale − lse), zero where the query is past s or the
        // key past the query; element i sits at key key0 + 8 ((i >> 1) & 1),
        // query q0 + c
        const bool edge = q0 + BQ > p.s || (p.causal && k0 + BK - 1 > q0);
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) {
          const int c = 8 * (i2 / 4) + c2 + (i2 & 1);
          float pe = exp2f(fmaf(sc[i2], p.scale_log2, -sL[c] * 1.4426950408889634f));
          if (edge && (q0 + c >= p.s || (p.causal && key0 + 8 * ((i2 >> 1) & 1) > q0 + c)))
            pe = 0.f;
          sc[i2] = pe;
        }
        wgmma_wait<0>();
        keep(dp);
        // dSᵀ = Pᵀ ∘ (dPᵀ − D) · scale
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) {
          const int c = 8 * (i2 / 4) + c2 + (i2 & 1);
          dp[i2] = sc[i2] * (dp[i2] - sD[c]) * p.scale;
        }

        // dV += Pᵀ dO and dK += dSᵀ Q: A from registers, B read MN-major
        uint32_t pa[4][4], da[4][4];
        acc_to_a<32>(pa, sc);
        acc_to_a<32>(da, dp);
        keep(dv);
        keep(dk);
        keep(pa);
        keep(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs_n128(dv, pa[kk], gmma_desc(g_base + kk * 16 * 128, QT_BYTES / 2, 1024), 1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs_n128(dk, da[kk], gmma_desc(q_base + kk * 16 * 128, QT_BYTES / 2, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        keep(dv);
        keep(dk);
        keep(pa);
        keep(da);
        if (lane == 0) mbar_arrive(&empty[st]);
      }
      step += n_steps;

      // dK = dK₀ + dK₁ and dV = dV₁ + dV₀ (warpgroup order, so the sums are
      // the same on every run), exchanged through the K/V bytes that no step
      // reads any more: warpgroup 0 writes dK, warpgroup 1 dV
      fence_proxy_async();
      bar_sync(1, CONSUMERS * 128);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) xchg[i * 128 + t] = dk[i];
      }
      bar_sync(1, CONSUMERS * 128);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) dk[i] += xchg[i * 128 + t];
      }
      bar_sync(1, CONSUMERS * 128);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) xchg[i * 128 + t] = dv[i];
      }
      bar_sync(1, CONSUMERS * 128);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) dv[i] += xchg[i * 128 + t];
      }
      // the next segment's K and V may land once every exchange is read
      fence_proxy_async();
      bar_sync(1, CONSUMERS * 128);
      if (threadIdx.x == 0) mbar_arrive(kv_empty);

      const int64_t off = ((int64_t)bi * p.s * p.kv + kvi) * D + c2;
      if (wg == 0)
        store_rows(dk, p.dk + off, key0, p.s, p.kv * D);
      else
        store_rows(dv, p.dv + off, key0, p.s, p.kv * D);
    }
  }
}

// The tensor maps of q, k, v, dO, then the launch: one block per entry pair
// of the schedule. A table cut for another tile (its block count differs
// from BK's) is refused, not walked.
cudaError_t launch(const ::Params& a, const void* sched, int n_blocks, cudaStream_t stream) {
  static_assert(BK == BQ, "the schedule's tiles are square");
  const int n = (a.s + BK - 1) / BK;
  if (!sched || n_blocks != a.b * a.kv * (a.causal ? (n + 1) / 2 : n))
    return cudaErrorInvalidValue;
  Params p;
  cudaError_t err = make_tile_map(&p.tq, a.q, a.b, a.s, a.h, a.q_sb, a.q_ss, a.q_sh, BQ);
  if (err == cudaSuccess)
    err = make_tile_map(&p.tdo, a.dout, a.b, a.s, a.h, a.g_sb, a.g_ss, a.g_sh, BQ);
  if (err == cudaSuccess)
    err = make_tile_map(&p.tk, a.k, a.b, a.s, a.kv, a.k_sb, a.k_ss, a.k_sh, BK);
  if (err == cudaSuccess)
    err = make_tile_map(&p.tv, a.v, a.b, a.s, a.kv, a.v_sb, a.v_ss, a.v_sh, BK);
  if (err != cudaSuccess) return err;
  p.lse = a.lse;
  p.dd = a.dd;
  p.dk = static_cast<__nv_bfloat16*>(a.dk);
  p.dv = static_cast<__nv_bfloat16*>(a.dv);
  p.sched = static_cast<const int4*>(sched);
  p.s = a.s;
  p.kv = a.kv;
  p.n_rep = a.n_rep;
  p.scale = a.scale;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  p.causal = a.causal;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_sm90<<<n_blocks, THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3 in bf16 at d = 128: wgmma and TMA with a producer warpgroup

constexpr int DQ_BM = 128;               // query rows of a block: 64 per consumer warpgroup
constexpr int DQ_BN = 64;                // keys of a K/V tile
constexpr int DQ_STAGES = 3;             // K/V tiles in flight
constexpr uint32_t DQ_Q_BYTES = DQ_BM * D * 2;     // the block's Q or dO
constexpr uint32_t DQ_KV_BYTES = DQ_BN * D * 2;    // one K or V tile
constexpr size_t DQ_SMEM = 1024 + 2 * DQ_Q_BYTES + 2 * DQ_STAGES * DQ_KV_BYTES + 64;

struct DqParams {
  CUtensorMap tq, tdo, tk, tv;
  const float* lse;
  const float* dd;
  __nv_bfloat16* dq;
  int s, h, n_rep;
  float scale, scale_log2;
  int causal;
};

// S = Q Kᵀ, then dP = dO Vᵀ, of the key tile whose K starts at k_base (V
// after it), one commit group each: A = this warpgroup's rows of Q or dO,
// B = K or V, all K-major
__device__ __forceinline__ void dq_scores(float (&sc)[32], float (&dp)[32], uint32_t q_base,
                                          uint32_t g_base, uint32_t k_base) {
  const uint32_t v_base = k_base + DQ_KV_BYTES;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(sc, gmma_desc(q_base + (kk / 4) * (DQ_Q_BYTES / 2) + (kk % 4) * 32, 16, 1024),
                 gmma_desc(k_base + (kk / 4) * (DQ_KV_BYTES / 2) + (kk % 4) * 32, 16, 1024),
                 kk > 0);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(dp, gmma_desc(g_base + (kk / 4) * (DQ_Q_BYTES / 2) + (kk % 4) * 32, 16, 1024),
                 gmma_desc(v_base + (kk / 4) * (DQ_KV_BYTES / 2) + (kk % 4) * 32, 16, 1024),
                 kk > 0);
  wgmma_commit();
}

// block (b·h, q-tile): blockIdx.y counts q-tiles from the last, so every
// head's heaviest causal rows are dispatched before any lighter ones
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_sm90(const __grid_constant__ DqParams p) {
  extern __shared__ uint8_t smem_raw[];
  // every box starts on 1024 bytes, the swizzle atom
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* sQ = smem;
  uint8_t* sG = smem + DQ_Q_BYTES;                 // dO
  uint8_t* sKV = smem + 2 * DQ_Q_BYTES;            // stage st: K at st · 2 DQ_KV_BYTES, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + 2 * DQ_STAGES * DQ_KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + DQ_STAGES;

  const int nq = (p.s + DQ_BM - 1) / DQ_BM;
  const int q0 = (nq - 1 - (int)blockIdx.y) * DQ_BM;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  // causal tiles past the block's diagonal are never loaded
  const int n_tiles =
      p.causal ? (min(q0 + DQ_BM, p.s) - 1) / DQ_BN + 1 : (p.s + DQ_BN - 1) / DQ_BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < DQ_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMERS * 4);        // one arrival per consumer warp, tile skipped or not
    }
    fence_barrier_init();
  }
  __syncthreads();

  // broadcast from lane 0, so ptxas knows every branch on it is warp-uniform:
  // from threadIdx.x / 128 alone it builds, with no warning, a kernel that
  // runs about a third slower (PERF.md has both times)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    // producer: one thread loads Q and dO, then keeps the K/V ring full; the
    // split moves only the registers the block got at launch: 2 x 128 x 240
    // + 128 x 24 = 384 x 168
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      const int kvi = hi / p.n_rep;
      mbar_arrive_expect_tx(q_full, 2 * DQ_Q_BYTES);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sQ + c * (DQ_Q_BYTES / 2), &p.tq, q_full, c * 64, hi, q0, bi);
        tma_load_4d(sG + c * (DQ_Q_BYTES / 2), &p.tdo, q_full, c * 64, hi, q0, bi);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % DQ_STAGES;
        mbar_wait(&empty[st], ((j / DQ_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * DQ_KV_BYTES);
        uint8_t* sK = sKV + st * 2 * DQ_KV_BYTES;
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sK + c * (DQ_KV_BYTES / 2), &p.tk, &full[st], c * 64, kvi, j * DQ_BN, bi);
          tma_load_4d(sK + DQ_KV_BYTES + c * (DQ_KV_BYTES / 2), &p.tv, &full[st], c * 64, kvi,
                      j * DQ_BN, bi);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows r0 .. r0 + 63
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c2 = (lane % 4) * 2;
    const int r0 = q0 + wg * 64;
    const int row0 = r0 + warp * 16 + lane / 4;    // and row0 + 8
    // this warpgroup's half of Q and dO starts on its own 1024-byte atom
    const uint32_t q_base = smem_u32(sQ) + wg * 64 * 128;
    const uint32_t g_base = smem_u32(sG) + wg * 64 * 128;
    // key tiles this warpgroup's rows see; none if every row is past s
    const int wg_tiles =
        r0 >= p.s ? 0 : p.causal ? (min(r0 + 64, p.s) - 1) / DQ_BN + 1 : n_tiles;
    // lse (in base 2) and D of this thread's two rows; a row past s would
    // read the next head's, so it reads none
    float lse2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool in = row < p.s;
      lse2[r] = in ? p.lse[(int64_t)bh * p.s + row] * 1.4426950408889634f : 0.f;
      dd[r] = in ? p.dd[(int64_t)bh * p.s + row] : 0.f;
    }
    float dq[64], sc[32], dp[32];
    uint32_t da[4][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    mbar_wait(q_full, 0);

    // Tile j + 1's S and dP are queued right behind tile j's dS K, so the
    // warpgroup's products run back to back and the tensor cores wait only
    // on P and dS. Commit groups complete in order. Between iterations
    // nothing is in flight, on every path ptxas sees: it serializes every
    // wgmma of a kernel where a product may be in flight across a branch
    // that lanes may take apart (C7518) or while its accumulator is read
    // (C7514).
    const auto stage_of = [&](int j) { return smem_u32(sKV + (j % DQ_STAGES) * 2 * DQ_KV_BYTES); };
    // P of tile j, once its S (and any dS K before it) has landed; returns
    // once its dP has landed too
    const auto probs = [&](int j) {
      wgmma_wait<1>();
      keep(sc);

      // P = exp(S·scale − lse), zero where the row or key is past s or the
      // key past the row; element i sits at row row0 + 8 ((i >> 1) & 1), key
      // k0 + 8 (i / 4) + c2 + (i & 1); only a tile that crosses the diagonal
      // or s is masked
      const int k0 = j * DQ_BN;
      const bool edge = k0 + DQ_BN > p.s || r0 + 64 > p.s || (p.causal && k0 + DQ_BN - 1 > r0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float pe = exp2f(fmaf(sc[i], p.scale_log2, -lse2[r]));
        const int row = row0 + 8 * r, col = k0 + 8 * (i / 4) + c2 + (i & 1);
        if (edge && (row >= p.s || col >= p.s || (p.causal && col > row))) pe = 0.f;
        sc[i] = pe;
      }
      wgmma_wait<0>();
      keep(dp);
      keep(dq);
      keep(da);
    };
    // dS of tile j, then dQ += dS K issued (A from registers, B = K read
    // MN-major); barriers are waited on and released only here, with
    // nothing in flight: tile j − 1's stage is free, tile j + 1's must have
    // landed
    const auto update = [&](int j) {
      if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % DQ_STAGES]);
      if (j + 1 < wg_tiles) mbar_wait(&full[(j + 1) % DQ_STAGES], ((j + 1) / DQ_STAGES) & 1);
      // dS = P ∘ (dP − D) · scale
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dd[(i >> 1) & 1]) * p.scale;
      acc_to_a<32>(da, dp);
      keep(dq);
      keep(da);
      wgmma_fence();
      const uint32_t k_base = stage_of(j);
#pragma unroll
      for (int kk = 0; kk < DQ_BN / 16; ++kk)
        wgmma_rs_n128(dq, da[kk], gmma_desc(k_base + kk * 16 * 128, DQ_KV_BYTES / 2, 1024), 1);
      wgmma_commit();
    };
    if (wg_tiles > 0) {
      mbar_wait(&full[0], 0);
      dq_scores(sc, dp, q_base, g_base, stage_of(0));
      probs(0);
      for (int j = 0; j + 1 < wg_tiles; ++j) {
        update(j);
        dq_scores(sc, dp, q_base, g_base, stage_of(j + 1));
        probs(j + 1);
      }
      update(wg_tiles - 1);
      wgmma_wait<0>();
      keep(dq);
      keep(da);
    }
    // the last product's stage, then the tiles that lie wholly above this
    // warpgroup's rows: each still waited for and released
    for (int j = max(wg_tiles - 1, 0); j < n_tiles; ++j) {
      if (j >= wg_tiles) mbar_wait(&full[j % DQ_STAGES], (j / DQ_STAGES) & 1);
      if (lane == 0) mbar_arrive(&empty[j % DQ_STAGES]);
    }

    const int64_t off = ((int64_t)bi * p.s * p.h + hi) * D + c2;
    store_rows(dq, p.dq + off, row0, p.s, (int64_t)p.h * D);
  }
}

// The tensor maps of q, dO, k, v, then the launch: one block per 128 query
// rows of one head.
cudaError_t launch_dq(const ::Params& a, cudaStream_t stream) {
  DqParams p;
  cudaError_t err = make_tile_map(&p.tq, a.q, a.b, a.s, a.h, a.q_sb, a.q_ss, a.q_sh, DQ_BM);
  if (err == cudaSuccess)
    err = make_tile_map(&p.tdo, a.dout, a.b, a.s, a.h, a.g_sb, a.g_ss, a.g_sh, DQ_BM);
  if (err == cudaSuccess)
    err = make_tile_map(&p.tk, a.k, a.b, a.s, a.kv, a.k_sb, a.k_ss, a.k_sh, DQ_BN);
  if (err == cudaSuccess)
    err = make_tile_map(&p.tv, a.v, a.b, a.s, a.kv, a.v_sb, a.v_ss, a.v_sh, DQ_BN);
  if (err != cudaSuccess) return err;
  p.lse = a.lse;
  p.dd = a.dd;
  p.dq = static_cast<__nv_bfloat16*>(a.dq);
  p.s = a.s;
  p.h = a.h;
  p.n_rep = a.n_rep;
  p.scale = a.scale;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  p.causal = a.causal;
  err = cudaFuncSetAttribute(flash_bwd_dq_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DQ_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.h, (a.s + DQ_BM - 1) / DQ_BM);
  flash_bwd_dq_sm90<<<grid, THREADS, DQ_SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace hopper

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
  if constexpr (D <= 64) {
    if (bf16)
      return launch(flash_bwd_dkdv_mma<D>, grid, MMA_THREADS, dkdv_mma_smem<D>(), p, stream);
  }
  return launch(flash_bwd_dkdv_fma<D>, grid, FMA_THREADS, dkdv_fma_smem<D>(), p, stream);
}

template <int D>
cudaError_t launch_dq(bool bf16, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.s + BLOCK - 1) / BLOCK, p.b * p.h);
  if constexpr (D <= 64) {
    if (bf16)
      return launch(flash_bwd_dq_mma<D>, grid, MMA_THREADS, dq_mma_smem<D>(), p, stream);
  }
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
// 1 = bfloat16. Each returns the cudaError_t of its launch. K2 in bf16 at
// d = 128 also reads `sched`, n_blocks pairs of int4 segments on the card
// (attention._dkdv_schedule); the other kernels ignore it, and the wrapper
// passes null there.
extern "C" int tpusched_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* dd,
                                       void* dk, void* dv, int b, int s, int h, int kv,
                                       int d, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                       int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                       int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                       int64_t g_sb, int64_t g_ss, int64_t g_sh,
                                       float scale, int causal, int dtype, const void* sched,
                                       int n_blocks, void* stream) {
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
    case 128:
      if (bf16) return (int)hopper::launch(p, sched, n_blocks, stm);
      return (int)launch_dkdv<128>(false, p, stm);
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
    case 128:
      if (bf16) return (int)hopper::launch_dq(p, stm);
      return (int)launch_dq<128>(false, p, stm);
    default: return (int)cudaErrorInvalidValue;
  }
}

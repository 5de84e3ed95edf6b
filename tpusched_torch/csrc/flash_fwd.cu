// FlashAttention-2 forward for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel tpusched/jaxbridge/attention.py:_flash_kernel.
// Same function: O = softmax(Q Kᵀ / √d) V by an online softmax over K/V
// tiles (running max m, denominator l, f32 accumulator rescaled by
// alpha = exp(m_prev − m_new)), plus lse = m + log l in f32. −inf-safe:
// a fully masked row keeps p = alpha = 0 and a zero l becomes 1. As in K1,
// the second product takes P rounded to the input type while l sums the
// unrounded P.
//
// What bounds it on this card: operations. At the training shape (b=1,
// s=4096, 16 query heads over 4 KV heads, d=128, causal, bf16) the two
// causal-halved products are 68.7 GFLOP against about 42 MB that must move,
// far above the H100's bf16 ridge of about 295 FLOP per byte (the serving
// prefill shape, s=1024, is 4.3 GFLOP against 10.5 MB). So the products
// belong on the tensor cores at their full rate, which only wgmma reaches,
// and the loads must stay off the critical path. The (s, s) score matrix
// never reaches device memory, as in K1.
//
// The kernel by dtype and head dim (dispatch by shape, in the entry point):
// - bfloat16, d = 128: hopper::flash_fwd_sm90, FlashAttention-2's algorithm
//   in FlashAttention-3's shape. A block owns 128 query rows of one head:
//   two consumer warpgroups of 64 rows each, then a producer warpgroup whose
//   one thread issues TMA and which gives its registers up (setmaxnreg 24;
//   the consumers take 240). Q lands once; K and V tiles of 128 keys stream
//   through a two-stage ring with full/empty mbarriers, 128-byte swizzled.
//   S = Q Kᵀ is wgmma m64n128k16 with both operands in shared memory,
//   K-major; O += P V is the register-A form, P rounded to bf16 straight from
//   the S accumulator, V read MN-major through the transpose bit, so nothing
//   is ever transposed by hand. Online softmax runs in f32 on the
//   accumulator layout, in base 2 on pre-scaled logits. Causal tiles past
//   the diagonal are never loaded, only tiles that cross the diagonal or s
//   are masked, and the grid dispatches every head's heaviest (latest)
//   query tile first. TMA zero-fills rows past s.
// - bfloat16, d = 32 or 64 (the tiny configuration's): four warps of 16
//   query rows on mma.sync m16n8k16, V staged transposed (flash_fwd_mma).
// - float32: the tensor cores would round to TF32, so the products run on
//   the CUDA cores with FMA from shared memory, four threads per row.
// Left for later on the d = 128 path: ping-pong of the two consumer
// warpgroups and overlap of one tile's softmax with the next tile's
// wgmma inside a warpgroup, TMA multicast of K/V across the GQA group with
// clusters, and fp8.
//
// Layout: q (b, s, h, d), k/v (b, s, kv, d), read through the element
// strides the caller gives (the head dim must be contiguous; in bf16 every
// row must start on 16 bytes, for vector loads and TMA). GQA is resolved by
// index: query head hq reads KV head hq / (h / kv); K and V are never
// expanded. A ragged last tile is masked here, so any s runs. O is written
// (b, s, h, d) contiguous in the input type; lse (b·h, s) f32.
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int BLOCK_M = 64;              // query rows per CUDA block
constexpr int BLOCK_N = 64;              // key rows per K/V tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int b, s, h, n_rep;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

// The work of one CUDA block: its query tile (latest first), head, and the
// K/V tiles it walks.
struct Tile {
  int q0, bh, bi, hi, kvi, n_tiles;
};

__device__ __forceinline__ Tile tile_of(const Params& p) {
  Tile t;
  const int nq = (p.s + BLOCK_M - 1) / BLOCK_M;
  t.q0 = (nq - 1 - (int)blockIdx.x) * BLOCK_M;
  t.bh = blockIdx.y;
  t.bi = t.bh / p.h;
  t.hi = t.bh % p.h;
  t.kvi = t.hi / p.n_rep;
  const int last_row = min(t.q0 + BLOCK_M, p.s) - 1;
  t.n_tiles = p.causal ? last_row / BLOCK_N + 1 : (p.s + BLOCK_N - 1) / BLOCK_N;
  return t;
}

__device__ __forceinline__ bool masked(const Params& p, int row, int col) {
  return col >= p.s || (p.causal && col > row);
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMA

constexpr int FMA_THREADS = 256;         // four threads per query row
constexpr int FMA_COLS = BLOCK_N / 4;    // score columns per thread
constexpr int FMA_LDP = BLOCK_N + 1;     // padded row of the P tile

// One word of padding per staged row puts the rows a warp reads at once on
// different shared-memory banks.
template <int D>
__host__ __device__ constexpr int fma_ld() { return D + 1; }

template <int D>
__host__ __device__ constexpr size_t fma_smem_bytes() {
  return (size_t)(BLOCK_M + 2 * BLOCK_N) * fma_ld<D>() * sizeof(float) +
         (size_t)BLOCK_M * FMA_LDP * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(FMA_THREADS) flash_fwd_fma(const Params p) {
  constexpr int LD = fma_ld<D>();
  constexpr int DPT = D / 4;             // output dims per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BLOCK_M * LD;
  float* sV = sK + BLOCK_N * LD;
  float* sP = sV + BLOCK_N * LD;

  const Tile t = tile_of(p);
  const int tid = threadIdx.x;
  const int r = tid >> 2;                // query row inside the tile
  const int quad = tid & 3;              // columns quad + 4j, dims quad + 4j
  const float* q = static_cast<const float*>(p.q) + t.bi * p.q_sb + t.hi * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + t.bi * p.k_sb + t.kvi * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + t.bi * p.v_sb + t.kvi * p.v_sh;

  for (int idx = tid; idx < BLOCK_M * D; idx += FMA_THREADS) {
    const int row = idx / D, col = idx % D;
    const int g = t.q0 + row;
    sQ[row * LD + col] = g < p.s ? q[g * p.q_ss + col] : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  const int q_row = t.q0 + r;

  for (int kt = 0; kt < t.n_tiles; ++kt) {
    const int k0 = kt * BLOCK_N;
    __syncthreads();                     // the previous tile is consumed
    for (int idx = tid; idx < BLOCK_N * D; idx += FMA_THREADS) {
      const int row = idx / D, col = idx % D;
      const int g = k0 + row;
      const bool in = g < p.s;
      sK[row * LD + col] = in ? k[g * p.k_ss + col] : 0.f;
      sV[row * LD + col] = in ? v[g * p.v_ss + col] : 0.f;
    }
    __syncthreads();

    float sc[FMA_COLS];
#pragma unroll
    for (int j = 0; j < FMA_COLS; ++j) sc[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * LD + d];
#pragma unroll
      for (int j = 0; j < FMA_COLS; ++j) sc[j] += qd * sK[(quad + 4 * j) * LD + d];
    }

    float row_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < FMA_COLS; ++j) {
      const float x = masked(p, q_row, k0 + quad + 4 * j) ? -INFINITY : sc[j] * p.scale;
      sc[j] = x;
      row_max = fmaxf(row_max, x);
    }
    // the four threads of a row are neighbouring lanes of one warp
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    const float m_new = fmaxf(m, row_max);
    const float m_sub = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);

    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < FMA_COLS; ++j) {
      const float pj = expf(sc[j] - m_sub);
      row_sum += pj;
      sP[r * FMA_LDP + quad + 4 * j] = pj;
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l = alpha * l + row_sum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
    __syncwarp();                        // a row's P is written and read by one warp

    for (int c = 0; c < BLOCK_N; ++c) {
      const float pc = sP[r * FMA_LDP + c];
      const float* vrow = sV + c * LD + quad;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] += pc * vrow[4 * j];
    }
  }

  if (q_row < p.s) {
    const float safe_l = l == 0.f ? 1.f : l;
    float* o = static_cast<float*>(p.o) + (((int64_t)t.bi * p.s + q_row) * p.h + t.hi) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) o[quad + 4 * j] = acc[j] / safe_l;
    if (quad == 0) p.lse[(int64_t)t.bh * p.s + q_row] = m + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through mma.sync m16n8k16

constexpr int MMA_THREADS = 128;         // four warps of 16 query rows
constexpr int LDVT = BLOCK_N + 8;        // row of the transposed V tile

// 16 bytes of padding per staged row: 32-bit fragment reads by the eight
// row groups of a warp land on distinct banks, and rows stay 16-byte
// aligned for vector stores.
template <int D>
__host__ __device__ constexpr int mma_ld() { return D + 8; }

template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return ((size_t)(BLOCK_M + BLOCK_N) * mma_ld<D>() + (size_t)D * LDVT) *
         sizeof(__nv_bfloat16);
}

// Copy rows [r0, r0 + rows) of a (s, D) slice into shared memory with
// 16-byte loads (the entry point refuses unaligned rows), zero past s; with
// `transpose` the tile lands as dst[col * ld + row].
template <int D>
__device__ __forceinline__ void stage(const Params& p, const __nv_bfloat16* src,
                                      int64_t row_stride, int r0, int rows,
                                      __nv_bfloat16* dst, int ld, bool transpose) {
  for (int idx = threadIdx.x * 8; idx < rows * D; idx += MMA_THREADS * 8) {
    const int row = idx / D, col = idx % D;
    const int g = r0 + row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < p.s) val = *reinterpret_cast<const uint4*>(src + g * row_stride + col);
    if (transpose) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(col + j) * ld + row] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + row * ld + col) = val;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_mma(const Params p) {
  static_assert(D <= 64, "bf16 at d=128 runs on hopper::flash_fwd_sm90");
  constexpr int LD = mma_ld<D>();
  constexpr int KD = D / 16;             // k-steps of Q Kᵀ
  constexpr int ND = D / 8;              // n-tiles of the output
  constexpr int NS = BLOCK_N / 8;        // n-tiles of S
  constexpr int KS = BLOCK_N / 16;       // k-steps of P V
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BLOCK_M * LD;
  __nv_bfloat16* sVt = sK + BLOCK_N * LD;

  const Tile t = tile_of(p);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;               // fragment row group
  const int c2 = (lane & 3) * 2;         // fragment column pair
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + t.bi * p.q_sb + t.hi * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + t.bi * p.k_sb + t.kvi * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + t.bi * p.v_sb + t.kvi * p.v_sh;

  stage<D>(p, q, p.q_ss, t.q0, BLOCK_M, sQ, LD, false);
  __syncthreads();
  uint32_t qf[KD][4];                    // this warp's 16 rows of Q, all of D
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const __nv_bfloat16* base = sQ + (warp * 16 + g) * LD + kk * 16 + c2;
    qf[kk][0] = ld32(base);
    qf[kk][1] = ld32(base + 8 * LD);
    qf[kk][2] = ld32(base + 8);
    qf[kk][3] = ld32(base + 8 * LD + 8);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // this thread holds rows g and g + 8 of the warp's 16
  const int rows[2] = {t.q0 + warp * 16 + g, t.q0 + warp * 16 + g + 8};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < t.n_tiles; ++kt) {
    const int k0 = kt * BLOCK_N;
    __syncthreads();                     // the previous tile is consumed
    stage<D>(p, k, p.k_ss, k0, BLOCK_N, sK, LD, false);
    stage<D>(p, v, p.v_ss, k0, BLOCK_N, sVt, LDVT, true);
    __syncthreads();

    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* kb = sK + (n * 8 + g) * LD + kk * 16 + c2;
        mma_16816(sc[n], qf[kk], ld32(kb), ld32(kb + 8));
      }
    }

    // element e of an S tile sits at row rows[e >> 1], column c2 + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + c2 + (e & 1);
        const float x = masked(p, rows[e >> 1], col) ? -INFINITY : sc[n][e] * p.scale;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_sub[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's four threads are neighbouring lanes of one warp
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_sub[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(sc[n][e] - m_sub[e >> 1]);
        sum[e >> 1] += pe;
        sc[n][e] = pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = alpha[r] * l[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // P's accumulator layout is the A-operand layout of P V: two S tiles
    // make one 16-key k-step
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vb = sVt + (n * 8 + g) * LDVT + kk * 16 + c2;
        mma_16816(o[n], pa, ld32(vb), ld32(vb + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.s) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) +
                         (((int64_t)t.bi * p.s + rows[r]) * p.h + t.hi) * D + c2;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack_bf16(o[n][2 * r] / safe_l, o[n][2 * r + 1] / safe_l);
    }
    if ((lane & 3) == 0) p.lse[(int64_t)t.bh * p.s + rows[r]] = m[r] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// bfloat16, d = 128: wgmma and TMA with a producer warp (sm90.cuh)

namespace hopper {

constexpr int D = 128;
constexpr int BM = 128;                  // query rows per block: 64 per consumer warpgroup
constexpr int BN = 128;                  // keys per K/V tile
constexpr int STAGES = 2;                // K/V tiles in flight
constexpr int CONSUMERS = 2;             // consumer warpgroups; one producer warpgroup follows
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr uint32_t Q_BYTES = BM * D * 2;
constexpr uint32_t KV_BYTES = BN * D * 2;          // one K or V tile
constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 64;

struct Params {
  CUtensorMap tq, tk, tv;
  void* o;
  float* lse;
  int s, h, n_rep;
  float scale, scale_log2;
  int causal;
};

// block (b·h, q-tile): blockIdx.y counts q-tiles from the last, so every
// head's heaviest causal rows are dispatched before any lighter ones
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_sm90(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  // every box starts on 1024 bytes, the swizzle atom
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* sQ = smem;
  uint8_t* sKV = smem + Q_BYTES;         // stage st: K at st * 2 * KV_BYTES, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + 2 * STAGES * KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int nq = (p.s + BM - 1) / BM;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BM;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  // causal tiles past the diagonal are never loaded
  const int n_tiles = p.causal ? (min(q0 + BM, p.s) - 1) / BN + 1 : (p.s + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMERS * 4);           // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one thread keeps the K/V ring full; the split moves only the
    // registers the block got at launch: 2 x 128 x 240 + 128 x 24 = 384 x 168
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      const int kvi = hi / p.n_rep;
      mbar_arrive_expect_tx(q_full, Q_BYTES);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(sQ + c * (Q_BYTES / 2), &p.tq, q_full, c * 64, hi, q0, bi);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * KV_BYTES);
        uint8_t* sK = sKV + st * 2 * KV_BYTES;
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sK + c * (KV_BYTES / 2), &p.tk, &full[st], c * 64, kvi, j * BN, bi);
          tma_load_4d(sK + KV_BYTES + c * (KV_BYTES / 2), &p.tv, &full[st], c * 64, kvi, j * BN,
                      bi);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c2 = (lane % 4) * 2;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;   // and row0 + 8
    const uint32_t q_base = smem_u32(sQ) + wg * 64 * 128;
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const uint32_t k_base = smem_u32(sKV + st * 2 * KV_BYTES);
      const uint32_t v_base = k_base + KV_BYTES;
      mbar_wait(&full[st], (j / STAGES) & 1);

      // S = Q Kᵀ: A = Q, B = K, both K-major
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * (Q_BYTES / 2) + (kk % 4) * 32;
        wgmma_ss_n128(sc, gmma_desc(q_base + off, 16, 1024),
                      gmma_desc(k_base + (kk / 4) * (KV_BYTES / 2) + (kk % 4) * 32, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      keep(sc);

      // online softmax on the accumulator layout, in base 2 on scaled
      // logits; only a tile that crosses the diagonal or s is masked
      const int k0 = j * BN;
      if (k0 + BN > p.s || (p.causal && k0 + BN - 1 > q0 + wg * 64)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = k0 + 8 * (i / 4) + c2 + (i & 1);
          const int row = row0 + 8 * ((i >> 1) & 1);
          if (col >= p.s || (p.causal && col > row)) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float m_sub[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // a row's four threads are neighbouring lanes of one warp
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // a row masked so far keeps p = alpha = 0
        m_sub[r] = m_new == -INFINITY ? 0.f : m_new * p.scale_log2;
        alpha[r] = m[r] == -INFINITY ? 0.f : exp2f((m[r] - m_new) * p.scale_log2);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float pe = exp2f(fmaf(sc[i], p.scale_log2, -m_sub[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += pe;
        sc[i] = pe;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = alpha[r] * l[r] + sum[r];     // l sums the unrounded P
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V: A = P (bf16, from the accumulator), B = V read MN-major
      uint32_t pa[8][4];
      acc_to_a<64>(pa, sc);
      keep(o);
      keep(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_n128(o, pa[kk], gmma_desc(v_base + kk * 16 * 128, KV_BYTES / 2, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      keep(o);
      keep(pa);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.s) continue;
      const float safe_l = l[r] == 0.f ? 1.f : l[r];
      __nv_bfloat16* out =
          static_cast<__nv_bfloat16*>(p.o) + (((int64_t)bi * p.s + row) * p.h + hi) * D + c2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + n * 8) =
            pack_bf16(o[4 * n + 2 * r] / safe_l, o[4 * n + 2 * r + 1] / safe_l);
      if (lane % 4 == 0)
        p.lse[(int64_t)bh * p.s + row] = (m[r] == -INFINITY ? 0.f : m[r] * p.scale) + logf(safe_l);
    }
  }
}

// The tensor maps of q, k, v, then the launch: one block per 128 query rows
// of one head.
cudaError_t launch(const ::Params& a, cudaStream_t stream) {
  Params p;
  const int kv = a.h / a.n_rep;
  cudaError_t err = make_tile_map(&p.tq, a.q, a.b, a.s, a.h, a.q_sb, a.q_ss, a.q_sh, BM);
  if (err == cudaSuccess)
    err = make_tile_map(&p.tk, a.k, a.b, a.s, kv, a.k_sb, a.k_ss, a.k_sh, BN);
  if (err == cudaSuccess)
    err = make_tile_map(&p.tv, a.v, a.b, a.s, kv, a.v_sb, a.v_ss, a.v_sh, BN);
  if (err != cudaSuccess) return err;
  p.o = a.o;
  p.lse = a.lse;
  p.s = a.s;
  p.h = a.h;
  p.n_rep = a.n_rep;
  p.scale = a.scale;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  p.causal = a.causal;
  err = cudaFuncSetAttribute(flash_fwd_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.h, (a.s + BM - 1) / BM);
  flash_fwd_sm90<<<grid, THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + BLOCK_M - 1) / BLOCK_M, p.b * p.h);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dim(bool bf16, const Params& p, cudaStream_t stream) {
  if (bf16) return launch(flash_fwd_mma<D>, MMA_THREADS, mma_smem_bytes<D>(), p, stream);
  return launch(flash_fwd_fma<D>, FMA_THREADS, fma_smem_bytes<D>(), p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int tpusched_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int b, int s, int h, int kv, int d,
                                  int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                  int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                  int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                  float scale, int causal, int dtype, void* stream) {
  if (b < 1 || s < 1 || kv < 1 || h % kv != 0 || b * h > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  if (bf16 && !(aligned16(q, q_sb, q_ss, q_sh) && aligned16(k, k_sb, k_ss, k_sh) &&
                aligned16(v, v_sb, v_ss, v_sh)))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.b = b;
  p.s = s;
  p.h = h;
  p.n_rep = h / kv;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch_dim<32>(bf16, p, st);
    case 64: return (int)launch_dim<64>(bf16, p, st);
    case 128:
      if (bf16) return (int)hopper::launch(p, st);
      return (int)launch(flash_fwd_fma<128>, FMA_THREADS, fma_smem_bytes<128>(), p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

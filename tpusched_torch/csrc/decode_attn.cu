// Single-token attention over the serving arena (K4), behind a plain C
// interface: flash-decoding on mma.sync, reading each slot's live rows once.
//
// Replaces no Pallas kernel. The reference writes this step as two einsums
// over the whole cache (tpusched/jaxbridge/decode.py:83-102); in PyTorch
// their (b·g)-batched products need K and V contiguous per (slot, KV head),
// so every layer of every tick copied the whole arena, 4096 rows of every
// slot, before reading all of it again. This kernel reads K and V where
// they lie, through their strides, and only up to each slot's cursor.
//
// What bounds it on this card: bytes. Each live K/V row is read once and
// meets n_rep query heads, about 2·n_rep FLOP per byte (n_rep = 4 here),
// far below the H100's bf16 ridge of about 295. So the design is about
// keeping enough loads in flight and reading nothing twice:
// - A slot's rows [0, min(pos, max_seq − 1)] are split into chunks of
//   `chunk` rows (a multiple of 64, chosen by the wrapper from the shapes).
//   One block takes one (chunk, KV head, slot), so that unequal lengths
//   spread over the 132 SMs (flash-decoding). The grid is static, sized
//   from (b, max_seq, kv), and the cursor is read on the device: a block
//   past its slot's cursor exits before loading anything, and the launch
//   can be recorded in a CUDA graph.
// - Every query head of the GQA group shares the block's one read of a
//   K/V row: the group (up to 16 heads, zero-padded) is the A operand of
//   mma.sync m16n8k16, a 16-row step of K the B operand of S = Q Kᵀ, and
//   P (the S accumulator rounded to the input type, as in K1) the A operand
//   of O += P V, with V's B fragments read transposed by ldmatrix.trans.
// - Each of the block's four warps streams its own 16 rows of every
//   64-row step through a private three-stage ring of 16-byte cp.async
//   copies (no block-wide barrier in the loop); rows past the cursor are
//   zero-filled, never loaded. Online softmax in f32, in base 2, on logits
//   kept in f32 (the einsum rounded them to the input type).
// - The warps merge in shared memory at the end. A slot whose live rows fit
//   one chunk writes its output there; otherwise each live chunk writes an
//   f32 partial (o normalised, lse in base 2), at most 2·n_rep·hd·4 bytes a
//   chunk against chunk·hd·4 bytes of K/V, and a second small kernel merges
//   a slot's partials by their lse.
//
// Layout: q (b, 1, h, hd) with h = kv·n_rep, query head hq reading KV head
// hq / n_rep; ck, cv (b, max_seq, kv, hd) read in place; hd = 128, the head
// dim contiguous, q's rows 4-byte and K/V's 16-byte aligned; pos int64,
// one cursor (pos_stride 0) or one a slot. O (b, 1, h, hd) contiguous in
// the input type. bf16 or fp16.
#include <cuda_fp16.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int HD = 128;                  // head dim the kernel is built for
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 16;                 // rows a warp takes from each step
constexpr int STEP = WARPS * ROWS;       // rows of one step of the block
constexpr int STAGES = 3;                // a warp's ring of steps in flight
constexpr int GROUP = 16;                // query heads of a block: mma's M
constexpr int LDS = HD + 8;              // staged row: 272 bytes, so the eight
                                         // rows an ldmatrix reads hit distinct banks
constexpr int WARP_STAGE = 2 * ROWS * LDS;   // one step's K and V rows of a warp
constexpr size_t SMEM = (size_t)WARPS * STAGES * WARP_STAGE * 2;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int64_t* pos;
  void* o;
  float* o_part;                         // (b, n_chunks, h, hd)
  float* lse_part;                       // (b, n_chunks, h), base 2
  int b, max_seq, h, kv, n_rep, groups, chunk, n_chunks, pos_stride;
  int64_t q_sb, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  float scale_log2;
};

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    mma_16816(d, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_bf16(lo, hi); }
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) { return __float2bfloat16(x); }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __half cast(float x) { return __float2half_rn(x); }
};

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `in` false writes zeros and reads
// nothing
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_u32(p)));
}

// rows of slot `bi` that its query attends: 0 .. min(pos, max_seq - 1)
__device__ __forceinline__ int live_rows(const Params& p, int bi) {
  int64_t c = p.pos[(int64_t)bi * p.pos_stride];
  c = c < 0 ? 0 : (c > p.max_seq - 1 ? p.max_seq - 1 : c);
  return (int)c + 1;
}

// One warp's 16 rows of a step, K then V, into its stage: lane l copies
// 16-byte segment l % 16 of rows 2j + l / 16, so each instruction of the
// warp reads two whole 256-byte rows.
template <typename T>
__device__ __forceinline__ void load_step(const Params& p, const T* k, const T* v, int r0,
                                          int end, T* dst, int lane) {
  const int seg = (lane & 15) * 8;
#pragma unroll
  for (int j = 0; j < ROWS / 2; ++j) {
    const int row = 2 * j + (lane >> 4);
    const int g = r0 + row;
    const bool in = g < end;
    const int gs = in ? g : 0;
    cp16(dst + row * LDS + seg, k + gs * p.k_ss + seg, in);
    cp16(dst + (ROWS + row) * LDS + seg, v + gs * p.v_ss + seg, in);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 8 / WARPS) decode_attn_split(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bi = blockIdx.z;
  const int kvi = blockIdx.y / p.groups;
  const int r0 = (blockIdx.y % p.groups) * GROUP;    // first head of the group
  const int heads = min(GROUP, p.n_rep - r0);
  const int len = live_rows(p, bi);
  const int row0 = blockIdx.x * p.chunk;
  if (row0 >= len) return;                           // past the cursor
  const int end = min(row0 + p.chunk, len);
  const int hq0 = kvi * p.n_rep + r0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;               // fragment row group: heads g, g + 8
  const int c2 = (lane & 3) * 2;         // fragment column pair

  // this warp's steps: rows row0 + 16·warp + 64·i, i < n_steps
  const int first = row0 + warp * ROWS;
  const int n_steps = first < end ? (end - first + STEP - 1) / STEP : 0;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + kvi * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + kvi * p.v_sh;
  T* ring = reinterpret_cast<T*>(smem) + warp * STAGES * WARP_STAGE;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load_step<T>(p, k, v, first + s * STEP, end, ring + s * WARP_STAGE, lane);
    cp_commit();
  }

  // Q of the group, the A operand: heads g and g + 8, zero past `heads`
  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + hq0 * p.q_sh;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const T* lo = q + g * p.q_sh + kk * 16 + c2;
    const T* hi = lo + 8 * p.q_sh;
    qa[kk][0] = g < heads ? *reinterpret_cast<const uint32_t*>(lo) : 0u;
    qa[kk][1] = g + 8 < heads ? *reinterpret_cast<const uint32_t*>(hi) : 0u;
    qa[kk][2] = g < heads ? *reinterpret_cast<const uint32_t*>(lo + 8) : 0u;
    qa[kk][3] = g + 8 < heads ? *reinterpret_cast<const uint32_t*>(hi + 8) : 0u;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // heads g, g + 8, base 2
  float l[2] = {0.f, 0.f};               // this lane's share of the sums

  // ldmatrix addresses: K as the B operand (matrix lane / 8 = rows 8·(mi / 2)..,
  // dims 8·(mi % 2)..), V transposed (rows 8·(mi % 2).., dims 8·(mi / 2)..)
  const int mi = lane >> 3;
  const int k_off = ((mi >> 1) * 8 + (lane & 7)) * LDS + (mi & 1) * 8;
  const int v_off = (ROWS + (mi & 1) * 8 + (lane & 7)) * LDS + (mi >> 1) * 8;

  for (int i = 0; i < n_steps; ++i) {
    cp_wait<STAGES - 2>();               // step i has landed for this lane
    __syncwarp();                        // and for every lane of the warp
    const int nxt = i + STAGES - 1;      // refill the stage step i - 1 used
    if (nxt < n_steps)
      load_step<T>(p, k, v, first + nxt * STEP, end, ring + (nxt % STAGES) * WARP_STAGE, lane);
    cp_commit();
    const T* st = ring + (i % STAGES) * WARP_STAGE;

    // S (16 heads × 16 rows) = Q Kᵀ: n-tile 0 rows 0-7, n-tile 1 rows 8-15
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, st + k_off + kk * 16);
      Mma<T>::run(s[0], qa[kk], b[0], b[1]);
      Mma<T>::run(s[1], qa[kk], b[2], b[3]);
    }
    // element e of n-tile n: head g + 8 (e >> 1), row 8n + c2 + (e & 1)
    const int base = first + i * STEP;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = base + 8 * n + c2 + (e & 1) < end;
        const float x = live ? s[n][e] * p.scale_log2 : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a head's row of S lies on the four lanes of one quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);      // finite: row `base` is live
      alpha[r] = exp2f(m[r] - m_new);              // 0 at the first step
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);      // a dead row: exp2(-inf) = 0
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P V: P's A fragment is the S accumulator of both n-tiles
    const uint32_t pa[4] = {Mma<T>::pack(s[0][0], s[0][1]), Mma<T>::pack(s[0][2], s[0][3]),
                            Mma<T>::pack(s[1][0], s[1][1]), Mma<T>::pack(s[1][2], s[1][3])};
#pragma unroll
    for (int d2 = 0; d2 < HD / 16; ++d2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, st + v_off + d2 * 16);
      Mma<T>::run(acc[2 * d2], pa, b[0], b[1]);
      Mma<T>::run(acc[2 * d2 + 1], pa, b[2], b[3]);
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // The four warps merge in shared memory, over the ring: each warp's m and
  // l a head, then its accumulator scaled to the block's max.
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);        // [WARPS][GROUP]
  float* wl = wm + WARPS * GROUP;                    // [WARPS][GROUP]
  float* wo = wl + WARPS * GROUP;                    // [WARPS][GROUP][HD]
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wm[warp * GROUP + g + 8 * r] = m[r];
      wl[warp * GROUP + g + 8 * r] = l[r];
    }
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, wm[w * GROUP + g + 8 * r]);
    f[r] = n_steps ? exp2f(m[r] - mb) : 0.f;         // a warp with no rows adds 0
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int head = g + 8 * (e >> 1);
      if (head < heads)
        wo[(warp * GROUP + head) * HD + 8 * n + c2 + (e & 1)] = acc[n][e] * f[e >> 1];
    }
  }
  __syncthreads();

  const bool whole = end == len && row0 == 0;        // the slot's one chunk
  for (int idx = threadIdx.x; idx < heads * HD; idx += THREADS) {
    const int head = idx / HD, d = idx % HD;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, wm[w * GROUP + head]);
    float lb = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float lw = wl[w * GROUP + head];
      if (lw > 0.f) {
        lb += lw * exp2f(wm[w * GROUP + head] - mb);
        o += wo[(w * GROUP + head) * HD + d];
      }
    }
    const int hq = hq0 + head;
    if (whole) {
      static_cast<T*>(p.o)[((int64_t)bi * p.h + hq) * HD + d] = Mma<T>::cast(o / lb);
    } else {
      const int64_t at = ((int64_t)bi * p.n_chunks + blockIdx.x) * p.h + hq;
      p.o_part[at * HD + d] = o / lb;
      if (d == 0) p.lse_part[at] = mb + log2f(lb);
    }
  }
}

// A slot's partials merged by their lse: one block a (query head, slot),
// one thread an output dim. The chunks' loads are independent, so the
// loops unroll and keep them in flight together. A slot of one chunk was
// written whole by decode_attn_split.
template <typename T>
__global__ void __launch_bounds__(HD) decode_attn_combine(const Params p) {
  const int hq = blockIdx.x;
  const int bi = blockIdx.y;
  const int n_live = (live_rows(p, bi) + p.chunk - 1) / p.chunk;
  if (n_live == 1) return;
  const int d = threadIdx.x;
  const float* lse = p.lse_part + (int64_t)bi * p.n_chunks * p.h + hq;   // chunk c: lse[c·h]
  const float* o = p.o_part + ((int64_t)bi * p.n_chunks * p.h + hq) * HD + d;
  float mb = -INFINITY;
#pragma unroll 8
  for (int c = 0; c < n_live; ++c) mb = fmaxf(mb, lse[(int64_t)c * p.h]);
  float lb = 0.f, acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < n_live; ++c) {
    const float w = exp2f(lse[(int64_t)c * p.h] - mb);
    lb += w;
    acc += w * o[(int64_t)c * p.h * HD];
  }
  static_cast<T*>(p.o)[((int64_t)bi * p.h + hq) * HD + d] = Mma<T>::cast(acc / lb);
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(decode_attn_split<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  decode_attn_split<T><<<dim3(p.n_chunks, p.kv * p.groups, p.b), THREADS, SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine<T><<<dim3(p.h, p.b), HD, 0, stream>>>(p);
  return cudaGetLastError();
}

inline bool rows_aligned(const void* ptr, int64_t sb, int64_t ss, int64_t sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 && ss % 8 == 0 && sh % 8 == 0;
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16. Two launches, the split and the
// combine, on `stream`. Returns the first cudaError_t.
extern "C" int tpusched_decode_attn(const void* q, const void* k, const void* v,
                                    const void* pos, void* o, void* o_part, void* lse_part,
                                    int b, int max_seq, int h, int kv, int d, int chunk,
                                    int pos_stride, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                                    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                    int64_t v_sh, float scale, int dtype, void* stream) {
  if (b < 1 || b > 65535 || max_seq < 1 || kv < 1 || h % kv != 0 || d != HD || chunk < STEP ||
      chunk % STEP != 0 || (pos_stride != 0 && pos_stride != 1) || (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  if (!rows_aligned(k, k_sb, k_ss, k_sh) || !rows_aligned(v, v_sb, v_ss, v_sh) ||
      reinterpret_cast<uintptr_t>(q) % 4 != 0 || q_sb % 2 != 0 || q_sh % 2 != 0)
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.pos = static_cast<const int64_t*>(pos);
  p.o = o;
  p.o_part = static_cast<float*>(o_part);
  p.lse_part = static_cast<float*>(lse_part);
  p.b = b;
  p.max_seq = max_seq;
  p.h = h;
  p.kv = kv;
  p.n_rep = h / kv;
  p.groups = (p.n_rep + GROUP - 1) / GROUP;
  p.chunk = chunk;
  p.n_chunks = (max_seq + chunk - 1) / chunk;
  p.pos_stride = pos_stride;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.scale_log2 = scale * LOG2E;
  if ((int64_t)kv * p.groups > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch<__nv_bfloat16>(p, st) : launch<__half>(p, st));
}

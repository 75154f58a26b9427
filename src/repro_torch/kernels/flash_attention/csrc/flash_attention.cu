// Variable-length grouped-query flash attention for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel flash_attention_kernel
// (kernels/flash_attention/flash_attention.py:94) and its decode use
// (ops.py:54 flash_decode).  It computes the serve path's _sdpa:
//
//   o[b, h, i] = softmax_k(q[b, h, i] . k[b, h / group, k] * scale) v
//
// over keys k < lens[b] (when lens is given) and, when causal, k <=
// q_offset[b] + i; scale is 1 / sqrt(hd) unless the caller gives another
// (MLA: 1 / sqrt(192)).  Softmax is online, in f32; a row with no valid
// key gives 0 (the TPU kernel's l == 0 rule).  q (B, H, Sq, hd), k (B,
// Hkv, Sk, hd) and v (B, Hkv, Sk, dv) are read through their strides
// (unit stride along the head dim, 16-byte aligned rows); every size,
// stride, lens and q_offset is a runtime argument, so a new length inside
// a bucket launches the library already built, and nothing syncs with
// the host.  The (hd, dv) head dims are template constants: (16, 16) (the
// reduced configs), (64, 64), (112, 112), (128, 128) and DeepSeek-V2's
// MLA prefill / expanded decode (192, 128) (reduced: (24, 16)) are
// instantiated.  A fourth
// form, mla_decode_kernel (below), is MLA's absorbed decode over the
// 576-wide latent cache.  Each instance sets its dynamic shared memory on
// its first launch.
//
// What bounds it on an H100.  Prefill at S = 2048 does 4 hd flops per
// visible (q, k) pair and head, ~64 per byte it must move: operations,
// on the tensor cores for 16-bit inputs (989 TFLOP/s dense).  Decode
// reads each cached K / V byte once and does ~group flops per byte:
// bytes (3.35 TB/s), at B = 4 a few MB a step, so it is also bound by
// how many SMs its grid keeps busy.
//
// Three forms (and the MLA absorbed decode, described at its kernel):
//
// * prefill_tc_kernel (bf16 / f16, prefill and chunks): FlashAttention-2
//   on mma.sync.m16n8k16 with f32 accumulators.  A block is 64 query
//   rows of one head (4 warps of 16 rows; 2 blocks fit an SM); grid (H,
//   q blocks, B), the q blocks launched last-first, so the heaviest
//   causal blocks start first.  The Q tile is copied once into shared
//   memory by cp.async and each warp keeps its rows as ldmatrix A
//   fragments in registers for the whole key loop.  K and V go through a
//   2-stage ring of 64-key tiles filled by cp.async, in their own 16-bit
//   type (rows padded by 8 elements, so ldmatrix reads them without bank
//   conflicts at hd 16, 64, 112 and 128): tile t + 1 is in flight while
//   tile t is scored.  S = Q K^T by mma (B fragments from the K tile by
//   ldmatrix), scaled in f32 after the product with log2(e) folded in
//   (2^x on the SFU).  The lens / causal mask is applied only on tiles
//   that straddle lens[b] or the diagonal.  The row max is shared by the
//   4 lanes of a quad; the row sum is kept per lane and summed once at
//   the end.  P stays in registers: the accumulator layout of S is the A
//   fragment layout of P V, so P is split there into two fragments of
//   the input type, hi = round(p) and lo = round(p - hi), and fed
//   straight back, two mma on the same V fragments (ldmatrix.trans).
//   The output is divided by l once, staged through shared memory and
//   stored as 16-byte rows.
// * prefill_kernel (f32): IEEE f32 FFMA, one block per (64-row q block,
//   head, batch row), 256 threads, each owning 4 rows x 4 keys of the
//   64 x 64 score tile and 4 rows x hd/16 columns of the output (f32
//   keeps its exact products; the tensor cores have no f32 mode that
//   does).
// * decode (Sq = 1, every dtype), split over the keys: grid (Hkv, B,
//   n_split), where n_split and the keys per split come from the cache's
//   static extent, the batch, Hkv and the SM count (ops.py
//   decode_splits), never from lens.  A block scores its key range
//   (clipped to lens[b]) for the query heads of its kv head's group, so
//   each K / V byte is read once per group, and every one of its 4 warps
//   takes 16 keys of each 64-key tile, so all of them work at group 1
//   too.  K / V tiles go through a 2-stage cp.async ring in their own
//   type and are widened to f32 as they are read: lanes score (key,
//   head) pairs in FFMA, 8 heads a pass, then each accumulates P V for a
//   column group of every head.  The decode bound is bytes, and f32
//   arithmetic there keeps a decode step's outputs rounding as the
//   plain version's do (numerics, below).  The warps' (m, l, acc) are
//   merged in shared memory into one f32 partial per (b, h, split) (m =
//   -inf, l = 0 for a split with no valid key); decode_combine_kernel
//   merges the splits per (b, h) and writes q's dtype (l == 0 everywhere
//   gives 0).  The two launches are one call of the C entry point.
//
// Key tiles at or beyond lens[b], or wholly above the causal diagonal,
// are never visited: the prefill key loop ends at min(lens[b],
// q_offset[b] + last row + 1).  That skip is the point against the
// plain version, which scores every (q, k) pair of the padded cache.
//
// Numerics.  The tensor-core prefill forms the scores as products of
// the 16-bit inputs summed in f32 and scales them after the product (2^x
// on the SFU, log2(e) folded into the scale).  Tensor-core flash
// attentions usually round P to the 16-bit type before P V; at bf16 that
// moves each output by up to ~2^-9 of its size, which the serve path's
// cache check (layer 1's K / V within 8e-3 of the plain version's) did
// not hold.  So P V takes P as hi + lo (exact to ~2^-16; twice the P V
// mma).  Decode runs once per
// layer for every generated token, and every output it rounds apart
// from the plain version's is carried into all later layers and tokens:
// it computes in f32 as the plain version does (x = s * scale, expf(x -
// m), P V in f32; the splits merged with expf).  f32 prefill follows the
// plain version: q scaled by 1/sqrt(hd) before the dot, products by
// fmaf (the library is built with --fmad=false), expf, acc / l rounded
// once.  Sums run in another order than the plain version's everywhere.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using disc::cp_async16;
using disc::cp_async_commit;
using disc::cp_async_wait;
using disc::ldsm_x4;
using disc::ldsm_x4_t;
using disc::mma16816;

constexpr int BQ = 64;          // query rows per prefill block
constexpr int BK = 64;          // keys per step, every form
constexpr int NT = 256;         // threads of the f32 prefill block
constexpr int TC_NT = 128;      // threads of the tensor-core prefill block
static_assert(TC_NT / 32 * 16 == BQ, "a warp holds 16 query rows");
constexpr int DEC_WARPS = 4;    // decode: warps a block, 16 keys of a tile each
constexpr int DEC_NT = 32 * DEC_WARPS;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx.ftz: ~2^-22 relative error, subnormal
// results flushed to 0), for the tensor-core prefill's probabilities
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int VEC = 4;  // elements per 16-byte chunk
  __device__ static float get(const uint4& c, int j) {
    return __uint_as_float(reinterpret_cast<const uint32_t*>(&c)[j]);
  }
  __device__ static float one(const float* p) { return *p; }
  __device__ static float out(float x) { return x; }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float get(const uint4& c, int j) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(&c)[j >> 1];
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static __nv_bfloat16 out(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Elt<__half> {
  static constexpr int VEC = 8;
  __device__ static float get(const uint4& c, int j) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(&c)[j >> 1];
    const unsigned short bits =
        static_cast<unsigned short>((j & 1) ? (w >> 16) : (w & 0xffffu));
    return __half2float(__ushort_as_half(bits));
  }
  __device__ static float one(const __half* p) { return __half2float(*p); }
  __device__ static __half out(float x) { return __float2half_rn(x); }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* lens;      // (B,) valid keys per row, or null (all Sk)
  const int* q_offset;  // (B,) absolute position of query 0, or null (0)
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float* part;          // decode: (B, H, n_split, hd + 2) f32 partials
  int B, H, Hkv, Sq, Sk;
  int causal;
  int n_split, kps;     // decode: key splits, keys per split (the last
                        // split runs to Sk)
  float scale;  // 1 / sqrt(hd): f32 prefill applies it to q before the
                // dot, the other forms to the f32 score
};

// A ROWS x HD tile of a [row][hd] slab (row stride ld elements), moved as
// 16-byte chunks, CH per thread.  TR: chunks numbered row-fastest, so
// that the transposed store ([hd][ROWS]) of a warp hits consecutive
// words; otherwise part-fastest, for the row-major store.
template <typename T, int ROWS, int HD>
struct Tile {
  static constexpr int VEC = Elt<T>::VEC;
  static constexpr int PER_ROW = HD / VEC;
  static constexpr int CHUNKS = ROWS * PER_ROW;
  static constexpr int CH = (CHUNKS + NT - 1) / NT;
  uint4 r[CH];

  template <bool TR>
  __device__ __forceinline__ void load(const T* base, long long ld,
                                       int n_rows) {
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int i = threadIdx.x + u * NT;
      const int row = TR ? i % ROWS : i / PER_ROW;
      const int part = TR ? i / ROWS : i % PER_ROW;
      uint4 c = make_uint4(0u, 0u, 0u, 0u);
      if (i < CHUNKS && row < n_rows)
        c = __ldg(reinterpret_cast<const uint4*>(
            base + (long long)row * ld + part * VEC));
      r[u] = c;
    }
  }

  // dst[d][row] = x * mul  (row-fastest chunks)
  __device__ __forceinline__ void store_t(float* dst, float mul) const {
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int i = threadIdx.x + u * NT;
      if (i >= CHUNKS) break;
      const int row = i % ROWS, part = i / ROWS;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        dst[(part * VEC + j) * ROWS + row] = Elt<T>::get(r[u], j) * mul;
    }
  }

  // dst[row][d] = x  (part-fastest chunks)
  __device__ __forceinline__ void store_rm(float* dst) const {
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int i = threadIdx.x + u * NT;
      if (i >= CHUNKS) break;
      const int row = i / PER_ROW, part = i % PER_ROW;
      float* p = dst + row * HD + part * VEC;
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(p + j) =
            make_float4(Elt<T>::get(r[u], j), Elt<T>::get(r[u], j + 1),
                        Elt<T>::get(r[u], j + 2), Elt<T>::get(r[u], j + 3));
    }
  }
};

__device__ __forceinline__ int valid_keys(const Args& a, int b) {
  return a.lens ? max(0, min(a.lens[b], a.Sk)) : a.Sk;
}

template <int W>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int s = W / 2; s > 0; s >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int s = W / 2; s > 0; s >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// ------------------------------------------------------ f32 prefill

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NT) prefill_kernel(Args a) {
  constexpr int DC = DV / 16;  // output columns per thread
  constexpr int PS = BK + 4;   // padded row stride of P
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [DQK][BQ]  q block, transposed, scaled
  float* Kt = Qt + DQK * BQ;   // [DQK][BK]  k block, transposed
  float* Vs = Kt + DQK * BK;   // [BK][DV]
  float* Ps = Vs + BK * DV;    // [BQ][PS]  probabilities

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int tr = threadIdx.x >> 4;  // rows tr*4 .. tr*4+3
  const int tc = threadIdx.x & 15;  // keys / columns of group tc
  const int kv_len = valid_keys(a, b);
  const int off = a.q_offset ? a.q_offset[b] : 0;
  int k_end = kv_len;
  if (a.causal) k_end = min(k_end, max(0, off + q0 + BQ));

  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  {
    Tile<T, BQ, DQK> t;
    t.template load<true>(Q + (long long)q0 * a.q_ss, a.q_ss, a.Sq - q0);
    t.store_t(Qt, a.scale);
  }

  float o[4][DC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous step is done with Kt, Vs
    {
      Tile<T, BK, DQK> t;
      t.template load<true>(K + (long long)k0 * a.k_ss, a.k_ss, kv_len - k0);
      t.store_t(Kt, 1.f);
    }
    {
      Tile<T, BK, DV> t;
      t.template load<false>(V + (long long)k0 * a.v_ss, a.v_ss,
                             kv_len - k0);
      t.store_rm(Vs);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16  // at 8, ptxas spilled 4 bytes at hd 112
    for (int d = 0; d < DQK; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * BQ + tr * 4);
      const float4 kv = *reinterpret_cast<const float4*>(Kt + d * BK + tc * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // mask, online softmax; the 16 threads of a row group share its rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + tc * 4 + j;
        ok[j] = kk < kv_len && (!a.causal || kk <= off + qi);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max<16>(mx);
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = ok[j] ? expf(s[i][j] - mn) : 0.f;
        sum += p[j];
      }
      sum = group_sum<16>(sum);
      l[i] = alpha * l[i] + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
      *reinterpret_cast<float4*>(Ps + (tr * 4 + i) * PS + tc * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncwarp();  // a row group's P is written by its own half-warp

    const int n_keys = min(BK, kv_len - k0);
    for (int kk = 0; kk < n_keys; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (tr * 4 + i) * PS + kk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DC];
        if constexpr (DC % 4 == 0) {
#pragma unroll
          for (int c = 0; c < DC; c += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(
                Vs + (kk + jj) * DV + tc * DC + c);
            vv[c] = v4.x;
            vv[c + 1] = v4.y;
            vv[c + 2] = v4.z;
            vv[c + 3] = v4.w;
          }
        } else {  // hd 16 and 112: 1 and 7 columns, not 16-byte aligned
#pragma unroll
          for (int c = 0; c < DC; ++c) vv[c] = Vs[(kk + jj) * DV + tc * DC + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = jj == 0 ? pv[i].x
                            : jj == 1 ? pv[i].y
                            : jj == 2 ? pv[i].z
                                      : pv[i].w;
#pragma unroll
          for (int c = 0; c < DC; ++c) o[i][c] = fmaf(pij, vv[c], o[i][c]);
        }
      }
    }
    __syncwarp();  // P is rewritten by the next step
  }

  T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= a.Sq) continue;
    T* row = O + (long long)qi * a.o_ss + tc * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      row[c] = Elt<T>::out(l[i] == 0.f ? 0.f : __fdiv_rn(o[i][c], l[i]));
  }
}


// ------------------------------------------- tensor-core prefill (16-bit)

template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi);
template <>
__device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
template <>
__device__ __forceinline__ unsigned pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(unsigned u);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(unsigned u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(unsigned u) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// P as two 16-bit A fragments, hi = round(p) and lo = round(p - hi):
// hi + lo carries p to ~2^-16 of itself (two mma on the same V
// fragments), where one 16-bit P would move bf16 outputs by ~2^-9
template <typename T>
__device__ __forceinline__ void split_p(float x, float y, unsigned& hi,
                                        unsigned& lo) {
  hi = pack2<T>(x, y);
  const float2 h = unpack2<T>(hi);
  lo = pack2<T>(x - h.x, y - h.y);
}

// Q and K rows are DQK wide, V and output rows DV (MLA: 192 and 128).
// A DQK that is not a multiple of the mma's k step of 16 (the reduced
// MLA's 24) is zero-filled to DQKP in shared memory.
template <typename T, int DQK, int DV>
struct TcShape {
  static constexpr int DQKP = (DQK + 15) / 16 * 16;  // Q / K row, padded
  static constexpr int LD = DQKP + 8;    // padded Q / K row, in elements
  static constexpr int LDV = DV + 8;     // padded V row
  static constexpr int CH = DQKP / 8;    // 16-byte chunks per Q / K row
  static constexpr int CHV = DV / 8;     // ... per V / output row
  static constexpr int TILE = BK * LD;   // elements of one K tile
  static constexpr int TILE_V = BK * LDV;
  // Q tile (the output tile at the end), then the K and V rings
  static constexpr size_t SMEM =
      (size_t)(BQ * LD + 2 * TILE + 2 * TILE_V) * sizeof(T);
};

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(TC_NT, 2) prefill_tc_kernel(Args a) {
  using Sh = TcShape<T, DQK, DV>;
  constexpr int LD = Sh::LD, LDV = Sh::LDV, CH = Sh::CH, CHV = Sh::CHV;
  constexpr int KS = Sh::DQKP / 16;  // k steps of Q K^T
  constexpr int NO = DV / 8;         // 8-column tiles of the output
  static_assert(DQK % 8 == 0 && DV % 16 == 0 && DV <= DQK,
                "head dims: 16-byte q / k rows, v a multiple of 16, the "
                "output within the Q tile");
  static_assert(DQK == DV ? Sh::DQKP == DQK : true,
                "K and V share a row layout only unpadded");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* Ks = Qs + BQ * LD;                    // [2][BK][LD]
  T* Vs = Ks + 2 * Sh::TILE;               // [2][BK][LDV]

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = valid_keys(a, b);
  const int off = a.q_offset ? a.q_offset[b] : 0;
  int k_end = kv_len;
  if (a.causal) k_end = min(k_end, max(0, off + min(a.Sq, q0 + BQ)));
  const int n_tiles = (k_end + BK - 1) / BK;

  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // columns at or past DQK (padding) are zero-filled
  for (int i = tid; i < BQ * CH; i += TC_NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q0 + r < a.Sq && (Sh::DQKP == DQK || c < DQK);
    cp_async16(Qs + r * LD + c, ok ? Q + (long long)(q0 + r) * a.q_ss + c : Q,
               ok);
  }
  cp_async_commit();
  // rows at or past kv_len are zero-filled (never read from the cache)
  auto load_kv = [&](int t) {
    const int k0 = t * BK;
    T* ks = Ks + (t & 1) * Sh::TILE;
    T* vs = Vs + (t & 1) * Sh::TILE_V;
    if constexpr (DQK == DV) {
      for (int i = tid; i < BK * CH; i += TC_NT) {
        const int r = i / CH, c = (i % CH) * 8;
        const bool ok = k0 + r < kv_len;
        cp_async16(ks + r * LD + c,
                   ok ? K + (long long)(k0 + r) * a.k_ss + c : K, ok);
        cp_async16(vs + r * LD + c,
                   ok ? V + (long long)(k0 + r) * a.v_ss + c : V, ok);
      }
    } else {
      for (int i = tid; i < BK * CH; i += TC_NT) {
        const int r = i / CH, c = (i % CH) * 8;
        const bool ok = k0 + r < kv_len && (Sh::DQKP == DQK || c < DQK);
        cp_async16(ks + r * LD + c,
                   ok ? K + (long long)(k0 + r) * a.k_ss + c : K, ok);
      }
      for (int i = tid; i < BK * CHV; i += TC_NT) {
        const int r = i / CHV, c = (i % CHV) * 8;
        const bool ok = k0 + r < kv_len;
        cp_async16(vs + r * LDV + c,
                   ok ? V + (long long)(k0 + r) * a.v_ss + c : V, ok);
      }
    }
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();

  // this warp's 16 query rows as A fragments, for the whole key loop
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                        (lane >> 4) * 8);

  // accumulator layout: lane holds rows r0 and r0 + 8, columns 2c, 2c + 1
  // of each 8-column tile
  const int r0 = q0 + warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  const float sl2 = a.scale * LOG2E;
  float o[NO][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv(t + 1);  // in flight while t is scored
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t has landed for every thread
    const T* ks = Ks + (t & 1) * Sh::TILE;
    const T* vs = Vs + (t & 1) * Sh::TILE_V;
    const int k0 = t * BK;

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        unsigned r[4];  // keys j*8 .. j*8 + 15, hd kk*16 .. kk*16 + 15
        ldsm_x4(r, ks + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816<T>(s[j], qf[kk], r[0], r[1]);
        mma16816<T>(s[j + 1], qf[kk], r[2], r[3]);
      }

    // the mask, on tiles that straddle lens[b] or the diagonal only
    if (k0 + BK > kv_len || (a.causal && k0 + BK - 1 > off + q0)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + c2 + (e & 1);
          const int row = r0 + (e >> 1) * 8;
          if (key >= kv_len || (a.causal && key > off + row))
            s[j][e] = -INFINITY;
        }
    }

    // online softmax, in log2 units; the 4 lanes of a quad share a row
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hr], mx * sl2);
      const float base = mn == -INFINITY ? 0.f : mn;
      const float alpha = fast_exp2(m[hr] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float p = fast_exp2(fmaf(s[j][e], sl2, -base));
          s[j][e] = p;
          sum += p;
        }
      l[hr] = alpha * l[hr] + sum;  // this lane's part of the row sum
      m[hr] = mn;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * hr] *= alpha;
        o[j][2 * hr + 1] *= alpha;
      }
    }

    // O += P V: P's accumulator layout is the A fragment layout
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned ph[4], pl[4];
      split_p<T>(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_p<T>(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_p<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_p<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        unsigned r[4];  // keys kk*16 .. kk*16 + 15, columns j*8 .. j*8 + 15
        ldsm_x4_t(r, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                         (j + (lane >> 4)) * 8);
        mma16816<T>(o[j], ph, r[0], r[1]);
        mma16816<T>(o[j + 1], ph, r[2], r[3]);
        mma16816<T>(o[j], pl, r[0], r[1]);
        mma16816<T>(o[j + 1], pl, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with stage t & 1
  }

  // o / l into this warp's rows of the Q tile, then 16-byte row stores
  T* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lr = l[hr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const float x0 = lr == 0.f ? 0.f : o[j][2 * hr] / lr;
      const float x1 = lr == 0.f ? 0.f : o[j][2 * hr + 1] / lr;
      *reinterpret_cast<unsigned*>(
          Os + ((lane >> 2) + hr * 8) * LD + j * 8 + c2) = pack2<T>(x0, x1);
    }
  }
  __syncwarp();
  T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  for (int i = lane; i < 16 * CHV; i += 32) {
    const int r = i / CHV, c = (i % CHV) * 8;
    const int qi = q0 + warp * 16 + r;
    if (qi < a.Sq)
      *reinterpret_cast<uint4*>(O + (long long)qi * a.o_ss + c) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c);
  }
}

// --------------------------------------------------- split-key decode
//
// The decode body writes, per (b, h, split), an f32 partial (m, l,
// acc[hd]) (m = -inf, l = 0, acc = 0 where the split has no valid key);
// decode_combine_kernel merges them.

// N consecutive elements of a shared-memory row, widened to f32 (one
// 16-, 8- or 4-byte load where the row segment has that size)
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES == 16 || BYTES == 8 || BYTES == 4) {
    uint4 c = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (BYTES == 16) {
      c = *reinterpret_cast<const uint4*>(p);
    } else if constexpr (BYTES == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      c.x = w.x;
      c.y = w.y;
    } else {
      c.x = *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = Elt<T>::get(c, j);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = Elt<T>::one(p + j);
  }
}

// The decode body, every dtype: FFMA in f32 on the inputs' values, as
// the plain version computes (the scores, expf(x - m) and P V in f32).
// A pass takes DG query heads of the group; the scores of each warp's 16
// keys are computed a (key, head pair) per lane, then each lane
// accumulates P V for its columns of every head.  K / V tiles stay in
// their own type in shared memory (a 2-stage cp.async ring) and are
// widened as they are read.
constexpr int DG = 8;

template <typename T, int DQK, int DV>
struct DecShape {
  static constexpr int VEC = Elt<T>::VEC;     // elements per 16 bytes
  static constexpr int LD = DQK + VEC;        // padded K row, in elements
  static constexpr int LDV = DV + VEC;        // padded V row
  static constexpr int CH = DQK / VEC;        // 16-byte chunks per K row
  static constexpr int CHV = DV / VEC;        // ... per V row
  static constexpr int TILE = BK * LD;
  static constexpr int TILE_V = BK * LDV;
  static constexpr int QLD = DQK + 4;         // padded f32 q row
  static constexpr int DPL = (DV + 31) / 32;  // output columns per lane
  static constexpr size_t RING = 2 * (size_t)(TILE + TILE_V) * sizeof(T);
  static constexpr size_t MERGE = (size_t)DEC_WARPS * DG * DV * sizeof(float);
  static constexpr size_t BASE = RING > MERGE ? RING : MERGE;
  // the ring (the warps' accumulators after the key loop), q rows, P,
  // each warp's alpha, m and l per head
  static constexpr size_t SMEM =
      BASE + (size_t)(DG * QLD + DEC_WARPS * DG * 16 + 3 * DEC_WARPS * DG) *
                 sizeof(float);
};

// (__launch_bounds__ lets ptxas plan 128 registers a thread: without the
// minimum of 4 blocks it took 96 and spilled 12 bytes at hd 128)
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(DEC_NT, 4) decode_kernel(Args a) {
  using Sh = DecShape<T, DQK, DV>;
  constexpr int VEC = Sh::VEC, LD = Sh::LD, LDV = Sh::LDV, CH = Sh::CH,
                CHV = Sh::CHV, QLD = Sh::QLD, DPL = Sh::DPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);           // [2][BK][LD]
  T* Vs = Ks + 2 * Sh::TILE;                        // [2][BK][LDV]
  float* Acc = reinterpret_cast<float*>(smem_raw);  // [warp][DG][DV], after
  float* Qs = reinterpret_cast<float*>(smem_raw + Sh::BASE);  // [DG][QLD]
  float* Ps = Qs + DG * QLD;                        // [warp][DG][16]
  float* Al = Ps + DEC_WARPS * DG * 16;             // [warp][DG]
  float* Mw = Al + DEC_WARPS * DG;                  // [warp][DG]
  float* Lw = Mw + DEC_WARPS * DG;                  // [warp][DG]

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int group = a.H / a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = valid_keys(a, b);
  const int lo = split * a.kps;
  const int hi = min(kv_len, split == a.n_split - 1 ? a.Sk : lo + a.kps);
  const int n_tiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // score layout: lane -> key kl of the warp's 16, heads hh + 2i;
  // output layout: lane -> columns col .. col + DPL - 1 of every head
  const int kl = lane & 15, hh = lane >> 4, col = lane * DPL;

  auto load_kv = [&](int t) {
    const int k0 = lo + t * BK;
    T* ks = Ks + (t & 1) * Sh::TILE;
    T* vs = Vs + (t & 1) * Sh::TILE_V;
    if constexpr (DQK == DV) {
      for (int i = tid; i < BK * CH; i += DEC_NT) {
        const int r = i / CH, c = (i % CH) * VEC;
        const bool ok = k0 + r < hi;
        cp_async16(ks + r * LD + c,
                   ok ? K + (long long)(k0 + r) * a.k_ss + c : K, ok);
        cp_async16(vs + r * LD + c,
                   ok ? V + (long long)(k0 + r) * a.v_ss + c : V, ok);
      }
    } else {
      for (int i = tid; i < BK * CH; i += DEC_NT) {
        const int r = i / CH, c = (i % CH) * VEC;
        const bool ok = k0 + r < hi;
        cp_async16(ks + r * LD + c,
                   ok ? K + (long long)(k0 + r) * a.k_ss + c : K, ok);
      }
      for (int i = tid; i < BK * CHV; i += DEC_NT) {
        const int r = i / CHV, c = (i % CHV) * VEC;
        const bool ok = k0 + r < hi;
        cp_async16(vs + r * LDV + c,
                   ok ? V + (long long)(k0 + r) * a.v_ss + c : V, ok);
      }
    }
  };

  for (int g0 = 0; g0 < group; g0 += DG) {
    const int gn = min(DG, group - g0);
    __syncthreads();  // the previous pass is done with the shared memory
    if (n_tiles > 0) load_kv(0);
    cp_async_commit();
    for (int i = tid; i < DG * DQK; i += DEC_NT) {
      const int r = i / DQK, d = i % DQK;
      Qs[r * QLD + d] =
          r < gn ? Elt<T>::one(Q + (long long)(hk * group + g0 + r) * a.q_sh +
                               d)
                 : 0.f;
    }

    float ms[DG / 2], ls[DG / 2], acc[DG][DPL];
#pragma unroll
    for (int i = 0; i < DG / 2; ++i) {
      ms[i] = -INFINITY;
      ls[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) load_kv(t + 1);  // in flight while t is scored
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // tile t (and the q rows) visible to every thread
      const T* ks = Ks + (t & 1) * Sh::TILE;
      const T* vs = Vs + (t & 1) * Sh::TILE_V;
      const int kw = warp * 16;  // the warp's keys within the tile
      const bool valid = lo + t * BK + kw + kl < hi;

      float s[DG / 2];
#pragma unroll
      for (int i = 0; i < DG / 2; ++i) s[i] = 0.f;
      const T* krow = ks + (kw + kl) * LD;
#pragma unroll 2
      for (int c = 0; c < CH; ++c) {
        const uint4 chunk = *reinterpret_cast<const uint4*>(krow + c * VEC);
        float kf[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) kf[j] = Elt<T>::get(chunk, j);
#pragma unroll
        for (int i = 0; i < DG / 2; ++i) {
          if (hh + 2 * i < gn) {
            const float* qr = Qs + (hh + 2 * i) * QLD + c * VEC;
#pragma unroll
            for (int j = 0; j < VEC; j += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qr + j);
              s[i] = fmaf(q4.x, kf[j], s[i]);
              s[i] = fmaf(q4.y, kf[j + 1], s[i]);
              s[i] = fmaf(q4.z, kf[j + 2], s[i]);
              s[i] = fmaf(q4.w, kf[j + 3], s[i]);
            }
          }
        }
      }

      // online softmax per head over the warp's 16 keys (a half-warp
      // each); every lane takes part in the shuffles
#pragma unroll
      for (int i = 0; i < DG / 2; ++i) {
        const float x = valid ? s[i] * a.scale : -INFINITY;
        float mx = x;
#pragma unroll
        for (int sh = 8; sh > 0; sh >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        const float mn = fmaxf(ms[i], mx);
        const float base = mn == -INFINITY ? 0.f : mn;
        const float p = expf(x - base);
        float sum = p;
#pragma unroll
        for (int sh = 8; sh > 0; sh >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, sh);
        const float alpha = expf(ms[i] - base);
        ls[i] = alpha * ls[i] + sum;
        ms[i] = mn;
        const int g = hh + 2 * i;
        Ps[(warp * DG + g) * 16 + kl] = p;
        if (kl == 0) Al[warp * DG + g] = alpha;
      }
      __syncwarp();

      if (col < DV) {
#pragma unroll
        for (int g = 0; g < DG; ++g)
          if (g < gn) {
            const float al = Al[warp * DG + g];
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[g][d] *= al;
          }
#pragma unroll 4
        for (int kk = 0; kk < 16; ++kk) {
          float vf[DPL];
          load_f32<T, DPL>(vs + (kw + kk) * LDV + col, vf);
#pragma unroll
          for (int g = 0; g < DG; ++g)
            if (g < gn) {
              const float p = Ps[(warp * DG + g) * 16 + kk];
#pragma unroll
              for (int d = 0; d < DPL; ++d)
                acc[g][d] = fmaf(p, vf[d], acc[g][d]);
            }
        }
      }
      __syncthreads();  // stage t & 1, P and alpha are free again
    }

    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it holds the accumulators now
    if (kl == 0) {
#pragma unroll
      for (int i = 0; i < DG / 2; ++i) {
        Mw[warp * DG + hh + 2 * i] = ms[i];
        Lw[warp * DG + hh + 2 * i] = ls[i];
      }
    }
    if (col < DV) {
#pragma unroll
      for (int g = 0; g < DG; ++g)
        if (g < gn) {
#pragma unroll
          for (int d = 0; d < DPL; ++d)
            Acc[(warp * DG + g) * DV + col + d] = acc[g][d];
        }
    }
    __syncthreads();
    // the warps' (m, l, acc) merged into this split's partial per head
    for (int i = tid; i < gn * DV; i += DEC_NT) {
      const int g = i / DV, d = i % DV;
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, Mw[w * DG + g]);
      const float base = M == -INFINITY ? 0.f : M;
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float f = expf(Mw[w * DG + g] - base);
        L += f * Lw[w * DG + g];
        A += f * Acc[(w * DG + g) * DV + d];
      }
      float* P = a.part + (((long long)b * a.H + hk * group + g0 + g) *
                               a.n_split + split) * (DV + 2);
      if (d == 0) {
        P[0] = M;
        P[1] = L;
      }
      P[2 + d] = A;
    }
  }
}

// merges the n_split partials of each (b, h) into o, in q's dtype; one
// block of DEC_NT threads per (b, h), n_split floats of dynamic shared
// memory for the splits' weights.  SPARSE: a split with no valid key
// wrote only its m = -inf and l = 0, so its accumulators (never written)
// are skipped
template <typename T, int DV, bool SPARSE = false, typename A = Args>
__global__ void __launch_bounds__(DEC_NT) decode_combine_kernel(A a) {
  extern __shared__ float wts[];  // [n_split]
  __shared__ float red[DEC_WARPS];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* P = a.part + (long long)bh * a.n_split * (DV + 2);
  float mx = -INFINITY;
  for (int s = tid; s < a.n_split; s += DEC_NT)
    mx = fmaxf(mx, P[s * (DV + 2)]);
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float M = red[0];
#pragma unroll
  for (int w = 1; w < DEC_WARPS; ++w) M = fmaxf(M, red[w]);
  const float base = M == -INFINITY ? 0.f : M;
  __syncthreads();  // red is reused for the row sum
  float lsum = 0.f;
  for (int s = tid; s < a.n_split; s += DEC_NT) {
    const float w = expf(P[s * (DV + 2)] - base);
    wts[s] = w;
    lsum += w * P[s * (DV + 2) + 1];
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, sh);
  if (lane == 0) red[warp] = lsum;
  __syncthreads();
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < DEC_WARPS; ++w) L += red[w];
  T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  for (int d = tid; d < DV; d += DEC_NT) {
    float acc = 0.f;
    if constexpr (SPARSE) {
      for (int s = 0; s < a.n_split; ++s)
        if (wts[s] != 0.f) acc += wts[s] * P[s * (DV + 2) + 2 + d];
    } else {
#pragma unroll 4
      for (int s = 0; s < a.n_split; ++s)
        acc += wts[s] * P[s * (DV + 2) + 2 + d];
    }
    O[d] = Elt<T>::out(L == 0.f ? 0.f : acc / L);
  }
}

// --------------------------------------------- MLA absorbed decode
//
// DeepSeek-V2's absorbed decode step (the JAX package's models/layers.py
// mla_apply, MLA_ABSORBED_DECODE): every query head h scores the latent
// cache directly,
//
//   s[b, h, k] = (q_abs[b, h] . kv_c[b, k] + q_pe[b, h] . k_pe[b, k]) * scale
//   o[b, h]    = softmax_k(s) kv_c          (keys k < lens[b])
//
// with q / k rows of L + R = 512 + 64 = 576 and v rows of L = 512: one kv
// head (the latent) shared by all H = 128 query heads.  kv_c (B, S, L) and
// k_pe (B, S, R) are read in place through their own pointers and row
// strides; the cache is never concatenated.  Grid (ceil(H / MLA_HG), B,
// n_split), the key splits from ops.decode_splits(S, B, 1, SMs) as for
// the decode form above; each block takes MLA_HG heads (where H is not a
// multiple of MLA_HG, the TAIL instance: the last block's heads past H
// score zero rows and write nothing) and its split in
// tiles of MLA_KT keys, one [kv_c | k_pe] tile in shared memory (a
// 2-stage cp.async ring in the cache's type) serving as K for the scores
// and, its first L columns, as V.  Scores: the 8 warps split the 576 dims
// in runs of 16-byte chunks, a lane holding a 4 heads x 4 keys register
// tile, the partial sums added in shared memory; softmax: a warp takes 2
// heads, a lane a key, online in f32; P V: a warp takes 64 output
// columns, a lane 4 heads x 8 columns.  (L, R) = (512, 64) and the
// reduced configs' (32, 8) are instantiated; at L = 32 one warp does the
// P V.  Everything is FFMA in f32 on the inputs' values, as the plain
// version computes.  Each block writes its heads' f32 partials (m, l,
// acc[L]); a split with no valid key writes m = -inf, l = 0 only, and
// decode_combine_kernel<..., SPARSE> merges the splits.  Bound: at B = 4
// and a few thousand valid keys the FFMA work (2 H (L + R + L) flops a
// key) outweighs the latent's bytes, and every head group re-reads its
// tile (from L2, mostly): 8 passes over the latent for 128 heads.
constexpr int MLA_HG = 16;               // query heads a block
constexpr int MLA_KT = 32;               // keys a tile
constexpr int MLA_WARPS = 8;
constexpr int MLA_NT = 32 * MLA_WARPS;

struct MlaArgs {
  const void* q;    // q_abs (B, H, L), strides q_sb, q_sh
  const void* qr;   // q_pe (B, H, R), strides qr_sb, qr_sh
  const void* c;    // kv_c (B, S, L), strides c_sb, c_ss
  const void* r;    // k_pe (B, S, R), strides r_sb, r_ss
  void* o;          // (B, H, L), strides o_sb, o_sh
  const int* lens;  // (B,) valid keys per row, or null (all Sk)
  float* part;      // (B, H, n_split, L + 2) f32 partials
  long long q_sb, q_sh, qr_sb, qr_sh, c_sb, c_ss, r_sb, r_ss, o_sb, o_sh;
  int B, H, Sk, n_split, kps;
  float scale;
};

template <typename T, int L, int R>
struct MlaShape {
  static constexpr int VEC = Elt<T>::VEC;
  static constexpr int D = L + R;             // q / k row
  static constexpr int LDK = D + VEC;         // padded tile row (576:
                                              // an odd number of chunks)
  static constexpr int CHL = L / VEC, CH = D / VEC;
  static constexpr int TILE = MLA_KT * LDK;
  static constexpr int QLD = D + 4;           // padded f32 q row
  // 16-byte chunks of a warp's run of the scores' dims
  static constexpr int CPW = (CH + MLA_WARPS - 1) / MLA_WARPS;
  static constexpr size_t RING = 2 * (size_t)TILE * sizeof(T);
  // the ring, q rows, the warps' partial scores, P, alpha per head
  static constexpr size_t SMEM =
      RING + (size_t)(MLA_HG * QLD + MLA_WARPS * MLA_HG * MLA_KT +
                      MLA_KT * MLA_HG + MLA_HG) * sizeof(float);
  static_assert(L % VEC == 0 && R % VEC == 0,
                "latent and rope widths: whole 16-byte chunks");
  static_assert(L % 32 == 0 && L <= MLA_WARPS * 64,
                "P V: up to 64 output columns a warp, in runs of 32");
  static_assert(MLA_HG == 16 && MLA_KT == 32, "4 x 4 score tiles a lane");
};

template <typename T, int L, int R, bool TAIL>
__global__ void __launch_bounds__(MLA_NT, 1) mla_decode_kernel(MlaArgs a) {
  using Sh = MlaShape<T, L, R>;
  constexpr int VEC = Sh::VEC, D = Sh::D, LDK = Sh::LDK, CHL = Sh::CHL,
                CH = Sh::CH, QLD = Sh::QLD, CPW = Sh::CPW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);                     // [2][KT][LDK]
  float* Qs = reinterpret_cast<float*>(smem_raw + Sh::RING);  // [HG][QLD]
  float* Sp = Qs + MLA_HG * QLD;             // [warp][HG][KT] partial scores
  float* Ps = Sp + MLA_WARPS * MLA_HG * MLA_KT;               // [KT][HG]
  float* Al = Ps + MLA_KT * MLA_HG;                           // [HG]

  const int h0 = blockIdx.x * MLA_HG, b = blockIdx.y, split = blockIdx.z;
  // this block's heads (a constant without TAIL: a head count held across
  // the key loop cost the bf16 (512, 64) instance ~25 % on an H100)
  const int nh = TAIL ? min(MLA_HG, a.H - h0) : MLA_HG;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = a.lens ? max(0, min(a.lens[b], a.Sk)) : a.Sk;
  const int lo = split * a.kps;
  const int hi = min(kv_len, split == a.n_split - 1 ? a.Sk : lo + a.kps);
  const int n_tiles = hi > lo ? (hi - lo + MLA_KT - 1) / MLA_KT : 0;
  // this block's partial of head h0 + i: part + i * head_stride
  const long long head_stride = (long long)a.n_split * (L + 2);
  float* part = a.part + ((long long)b * a.H + h0) * head_stride +
                (long long)split * (L + 2);
  if (n_tiles == 0) {  // no valid key: m = -inf, l = 0, no accumulators
    if (tid < nh) {
      part[tid * head_stride] = -INFINITY;
      part[tid * head_stride + 1] = 0.f;
    }
    return;
  }
  const T* C = static_cast<const T*>(a.c) + b * a.c_sb;
  const T* Rp = static_cast<const T*>(a.r) + b * a.r_sb;

  // rows at or past hi are zero-filled (never read from the cache)
  auto load_k = [&](int t) {
    const int k0 = lo + t * MLA_KT;
    T* ks = Ks + (t & 1) * Sh::TILE;
    for (int i = tid; i < MLA_KT * CH; i += MLA_NT) {
      const int r = i / CH, c = i % CH;
      const bool ok = k0 + r < hi;
      const T* src = c < CHL
                         ? C + (long long)(k0 + r) * a.c_ss + c * VEC
                         : Rp + (long long)(k0 + r) * a.r_ss + (c - CHL) * VEC;
      cp_async16(ks + r * LDK + c * VEC, ok ? src : C, ok);
    }
  };
  load_k(0);
  cp_async_commit();
  {  // this block's q rows [q_abs | q_pe], widened to f32
    const T* Qa = static_cast<const T*>(a.q) + b * a.q_sb;
    const T* Qr = static_cast<const T*>(a.qr) + b * a.qr_sb;
    for (int i = tid; i < MLA_HG * D; i += MLA_NT) {
      const int r = i / D, d = i % D;
      Qs[r * QLD + d] =
          r >= nh ? 0.f
          : d < L ? Elt<T>::one(Qa + (long long)(h0 + r) * a.q_sh + d)
                  : Elt<T>::one(Qr + (long long)(h0 + r) * a.qr_sh + d - L);
    }
  }

  // scores: lane -> keys kr + 8j, heads g + 4i (j, i < 4) over the warp's
  // dims; P V: lane -> heads 4 hg .. 4 hg + 3, columns warp * 64 + 32 u +
  // 4 cg .. + 3 (u < 2)
  const int kr = lane & 7, g = lane >> 3;
  const int cg = lane & 7, hg = lane >> 3;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_k(t + 1);  // in flight while t is scored
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t (and the q rows) visible to every thread
    const T* ks = Ks + (t & 1) * Sh::TILE;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    // a warp's run of CPW chunks, cut at CH where the warps do not split
    // the chunks evenly (at 576 they do: the run is [warp, warp + 1) WD)
    constexpr int WD = CPW * VEC;
    const int d_end = CH % MLA_WARPS == 0 ? (warp + 1) * WD
                                          : min(D, (warp + 1) * WD);
#pragma unroll 2
    for (int d0 = warp * WD; d0 < d_end; d0 += VEC) {
      float kf[4][VEC];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 chunk =
            *reinterpret_cast<const uint4*>(ks + (kr + 8 * j) * LDK + d0);
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[j][e] = Elt<T>::get(chunk, e);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* qr = Qs + (g + 4 * i) * QLD + d0;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(q4.x, kf[j][e], s[i][j]);
            s[i][j] = fmaf(q4.y, kf[j][e + 1], s[i][j]);
            s[i][j] = fmaf(q4.z, kf[j][e + 2], s[i][j]);
            s[i][j] = fmaf(q4.w, kf[j][e + 3], s[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Sp[(warp * MLA_HG + g + 4 * i) * MLA_KT + kr + 8 * j] = s[i][j];
    __syncthreads();

    // the warps' partial scores summed, masked, online softmax per head
    const bool valid = lo + t * MLA_KT + lane < hi;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int h = 2 * warp + u;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < MLA_WARPS; ++w)
        x += Sp[(w * MLA_HG + h) * MLA_KT + lane];
      x = valid ? x * a.scale : -INFINITY;
      const float mn = fmaxf(m[u], group_max<32>(x));
      const float base = mn == -INFINITY ? 0.f : mn;
      const float p = expf(x - base);
      const float alpha = expf(m[u] - base);
      l[u] = alpha * l[u] + group_sum<32>(p);
      m[u] = mn;
      Ps[lane * MLA_HG + h] = p;
      if (lane == 0) Al[h] = alpha;
    }
    __syncthreads();

    // O += P V over the tile's first L columns (the warps past L idle)
    if (L == MLA_WARPS * 64 || warp * 64 < L) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float al = Al[4 * hg + i];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= al;
      }
#pragma unroll 4
      for (int kk = 0; kk < MLA_KT; ++kk) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Ps + kk * MLA_HG + 4 * hg);
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
        float vf[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (L % 64 == 0 || warp * 64 + u * 32 < L)
            load_f32<T, 4>(ks + kk * LDK + warp * 64 + u * 32 + cg * 4,
                           vf[u]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (L % 64 == 0 || warp * 64 + u * 32 < L)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][u * 4 + e] = fmaf(pa[i], vf[u][e], acc[i][u * 4 + e]);
      }
    }
    __syncthreads();  // stage t & 1, the partial scores, P, alpha free
  }

  // this split's partials of the block's heads below H: m, l of the
  // warp's softmax heads; acc of the lane's heads and columns (8-byte
  // stores: a record is L + 2 floats)
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (2 * warp + u < nh) {
        part[(2 * warp + u) * head_stride] = m[u];
        part[(2 * warp + u) * head_stride + 1] = l[u];
      }
  }
  if (L < MLA_WARPS * 64 && warp * 64 >= L) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (4 * hg + i >= nh) continue;
    float* row = part + (4 * hg + i) * head_stride + 2 + warp * 64 + cg * 4;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (L % 64 == 0 || warp * 64 + u * 32 < L) {
        *reinterpret_cast<float2*>(row + u * 32) =
            make_float2(acc[i][u * 4], acc[i][u * 4 + 1]);
        *reinterpret_cast<float2*>(row + u * 32 + 2) =
            make_float2(acc[i][u * 4 + 2], acc[i][u * 4 + 3]);
      }
  }
}

// ------------------------------------------------------------- launch

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, int DQK, int DV>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  if (a.part == nullptr || a.n_split < 1 || a.kps < 1 || a.B > 65535 ||
      a.n_split > 65535)
    return cudaErrorInvalidValue;
  constexpr size_t smem = DecShape<T, DQK, DV>::SMEM;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = allow_smem(decode_kernel<T, DQK, DV>, smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  decode_kernel<T, DQK, DV>
      <<<dim3(a.Hkv, a.B, a.n_split), DEC_NT, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T, DV><<<a.B * a.H, DEC_NT,
                                 a.n_split * sizeof(float), stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DQK, int DV>
cudaError_t launch_prefill(const Args& a, cudaStream_t stream) {
  if (a.B > 65535) return cudaErrorInvalidConfiguration;
  if constexpr (sizeof(T) == 4) {  // f32: the FFMA body
    constexpr size_t smem =
        (DQK * BQ + DQK * BK + DV * BK + BQ * (BK + 4)) * sizeof(float);
    static bool sized = false;
    if (!sized) {
      cudaError_t e = allow_smem(prefill_kernel<T, DQK, DV>, smem);
      if (e != cudaSuccess) return e;
      sized = true;
    }
    prefill_kernel<T, DQK, DV>
        <<<dim3((a.Sq + BQ - 1) / BQ, a.H, a.B), NT, smem, stream>>>(a);
  } else {
    const dim3 grid(a.H, (a.Sq + BQ - 1) / BQ, a.B);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    constexpr size_t smem = TcShape<T, DQK, DV>::SMEM;
    static bool sized = false;
    if (!sized) {
      cudaError_t e = allow_smem(prefill_tc_kernel<T, DQK, DV>, smem);
      if (e != cudaSuccess) return e;
      sized = true;
    }
    prefill_tc_kernel<T, DQK, DV><<<grid, TC_NT, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, int DQK, int DV>
cudaError_t launch(const Args& a, int decode, cudaStream_t s) {
  return decode ? launch_decode<T, DQK, DV>(a, s)
                : launch_prefill<T, DQK, DV>(a, s);
}

// the (q / k, v) head dims the library is instantiated for
template <typename T>
cudaError_t launch_hd(const Args& a, int hd, int dv, int decode,
                      cudaStream_t s) {
  if (hd == dv) {
    switch (hd) {
      case 16: return launch<T, 16, 16>(a, decode, s);
      case 64: return launch<T, 64, 64>(a, decode, s);
      case 112: return launch<T, 112, 112>(a, decode, s);
      case 128: return launch<T, 128, 128>(a, decode, s);
    }
  } else if (hd == 192 && dv == 128) {  // MLA: [q_nope | q_pe], v
    return launch<T, 192, 128>(a, decode, s);
  } else if (hd == 24 && dv == 16) {  // the reduced configs' MLA
    return launch<T, 24, 16>(a, decode, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int L, int R, bool TAIL>
cudaError_t launch_mla(const MlaArgs& a, cudaStream_t s) {
  if (a.part == nullptr || a.n_split < 1 || a.kps < 1 || a.B > 65535 ||
      a.n_split > 65535)
    return cudaErrorInvalidValue;
  constexpr size_t smem = MlaShape<T, L, R>::SMEM;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = allow_smem(mla_decode_kernel<T, L, R, TAIL>, smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  mla_decode_kernel<T, L, R, TAIL><<<dim3((a.H + MLA_HG - 1) / MLA_HG, a.B,
                                          a.n_split), MLA_NT, smem, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T, L, true, MlaArgs>
      <<<a.B * a.H, DEC_NT, a.n_split * sizeof(float), s>>>(a);
  return cudaGetLastError();
}

template <typename T, int L, int R>
cudaError_t launch_mla_heads(const MlaArgs& a, cudaStream_t s) {
  return a.H % MLA_HG == 0 ? launch_mla<T, L, R, false>(a, s)
                           : launch_mla<T, L, R, true>(a, s);
}

// the (latent, rope) widths the MLA decode is instantiated for
template <typename T>
cudaError_t launch_mla_dims(const MlaArgs& a, int l, int r, cudaStream_t s) {
  if (l == 512 && r == 64)  // DeepSeek-V2
    return launch_mla_heads<T, 512, 64>(a, s);
  if (l == 32 && r == 8)  // the reduced configs
    return launch_mla_heads<T, 32, 8>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dims: B H Hkv Sq Sk hd dv causal, the (batch, head, position) strides of
// q, k, v and o in elements, then n_split and keys per split (decode); hd
// is q's and k's head dim, dv v's and o's.  dtype: 0 f32, 1 bf16, 2 f16.
// part: the decode form's f32 scratch, B * H * n_split * (dv + 2) floats
// (null for prefill).  Returns the launch's cudaError_t (0 on success).
extern "C" int disc_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, const int* lens,
                                    const int* q_offset,
                                    const long long* dims, float scale,
                                    int dtype, int decode, void* part,
                                    void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lens = lens;
  a.q_offset = q_offset;
  a.part = static_cast<float*>(part);
  a.B = (int)dims[0];
  a.H = (int)dims[1];
  a.Hkv = (int)dims[2];
  a.Sq = (int)dims[3];
  a.Sk = (int)dims[4];
  const int hd = (int)dims[5];
  const int dv = (int)dims[6];
  a.causal = (int)dims[7];
  a.q_sb = dims[8];
  a.q_sh = dims[9];
  a.q_ss = dims[10];
  a.k_sb = dims[11];
  a.k_sh = dims[12];
  a.k_ss = dims[13];
  a.v_sb = dims[14];
  a.v_sh = dims[15];
  a.v_ss = dims[16];
  a.o_sb = dims[17];
  a.o_sh = dims[18];
  a.o_ss = dims[19];
  a.n_split = (int)dims[20];
  a.kps = (int)dims[21];
  a.scale = scale;
  if (a.B == 0 || a.Sq == 0 || a.H == 0) return 0;
  if (a.Hkv <= 0 || a.H % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_hd<float>(a, hd, dv, decode, s);
    case 1: return (int)launch_hd<__nv_bfloat16>(a, hd, dv, decode, s);
    case 2: return (int)launch_hd<__half>(a, hd, dv, decode, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The MLA absorbed decode.  dims: B H Sk L R, the (batch, head) strides of
// q_abs, q_pe and o and the (batch, position) strides of kv_c and k_pe in
// elements, then n_split and keys per split.  dtype: 0 f32, 1 bf16, 2
// f16 (every input and o).  part: B * H * n_split * (L + 2) floats.
extern "C" int disc_mla_decode(const void* q_abs, const void* q_pe,
                               const void* kv_c, const void* k_pe, void* o,
                               const int* lens, const long long* dims,
                               float scale, int dtype, void* part,
                               void* stream) {
  MlaArgs a;
  a.q = q_abs;
  a.qr = q_pe;
  a.c = kv_c;
  a.r = k_pe;
  a.o = o;
  a.lens = lens;
  a.part = static_cast<float*>(part);
  a.B = (int)dims[0];
  a.H = (int)dims[1];
  a.Sk = (int)dims[2];
  const int l = (int)dims[3];
  const int r = (int)dims[4];
  a.q_sb = dims[5];
  a.q_sh = dims[6];
  a.qr_sb = dims[7];
  a.qr_sh = dims[8];
  a.c_sb = dims[9];
  a.c_ss = dims[10];
  a.r_sb = dims[11];
  a.r_ss = dims[12];
  a.o_sb = dims[13];
  a.o_sh = dims[14];
  a.n_split = (int)dims[15];
  a.kps = (int)dims[16];
  a.scale = scale;
  if (a.B == 0 || a.H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_mla_dims<float>(a, l, r, s);
    case 1: return (int)launch_mla_dims<__nv_bfloat16>(a, l, r, s);
    case 2: return (int)launch_mla_dims<__half>(a, l, r, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* disc_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Variable-length grouped-query flash attention for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel flash_attention_kernel
// (kernels/flash_attention/flash_attention.py:94) and its decode use
// (ops.py:54 flash_decode).  It computes the serve path's _sdpa:
//
//   o[b, h, i] = softmax_k(q[b, h, i] . k[b, h / group, k] / sqrt(hd)) v
//
// over keys k < lens[b] (when lens is given) and, when causal, k <=
// q_offset[b] + i.  Softmax is online, in f32; a row with no valid key
// gives 0 (the TPU kernel's l == 0 rule).  q (B, H, Sq, hd) and k, v
// (B, Hkv, Sk, hd) are read through their strides (unit stride along hd,
// 16-byte aligned rows); every size, stride, lens and q_offset is a
// runtime argument, so a new length inside a bucket launches the library
// already built, and nothing syncs with the host.  The head dim is a
// template constant: 16 (the reduced configs), 64, 112 and 128 are
// instantiated.  Each instance sets its dynamic shared memory on its
// first launch.
//
// What bounds it on an H100.  Prefill at S = 2048 does 4 hd flops per
// visible (q, k) pair and head, ~64 per byte it must move: operations,
// on the tensor cores for 16-bit inputs (989 TFLOP/s dense).  Decode
// reads each cached K / V byte once and does ~group flops per byte:
// bytes (3.35 TB/s), at B = 4 a few MB a step, so it is also bound by
// how many SMs its grid keeps busy.
//
// Three forms:
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

template <typename T, int HD>
__global__ void __launch_bounds__(NT) prefill_kernel(Args a) {
  constexpr int DC = HD / 16;  // output columns per thread
  constexpr int PS = BK + 4;   // padded row stride of P
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [HD][BQ]  q block, transposed, scaled
  float* Kt = Qt + HD * BQ;    // [HD][BK]  k block, transposed
  float* Vs = Kt + HD * BK;    // [BK][HD]
  float* Ps = Vs + BK * HD;    // [BQ][PS]  probabilities

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
    Tile<T, BQ, HD> t;
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
      Tile<T, BK, HD> t;
      t.template load<true>(K + (long long)k0 * a.k_ss, a.k_ss, kv_len - k0);
      t.store_t(Kt, 1.f);
    }
    {
      Tile<T, BK, HD> t;
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
    for (int d = 0; d < HD; ++d) {
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
                Vs + (kk + jj) * HD + tc * DC + c);
            vv[c] = v4.x;
            vv[c + 1] = v4.y;
            vv[c + 2] = v4.z;
            vv[c + 3] = v4.w;
          }
        } else {  // hd 16 and 112: 1 and 7 columns, not 16-byte aligned
#pragma unroll
          for (int c = 0; c < DC; ++c) vv[c] = Vs[(kk + jj) * HD + tc * DC + c];
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

template <typename T, int HD>
struct TcShape {
  static constexpr int LD = HD + 8;      // padded row, in elements
  static constexpr int CH = HD / 8;      // 16-byte chunks per row
  static constexpr int TILE = BK * LD;   // elements of one K or V tile
  // Q tile (the output tile at the end), then the K and V rings
  static constexpr size_t SMEM = (size_t)(BQ * LD + 4 * TILE) * sizeof(T);
};

template <typename T, int HD>
__global__ void __launch_bounds__(TC_NT, 2) prefill_tc_kernel(Args a) {
  using Sh = TcShape<T, HD>;
  constexpr int LD = Sh::LD, CH = Sh::CH;
  constexpr int KS = HD / 16;  // k steps of Q K^T
  constexpr int NO = HD / 8;   // 8-column tiles of the output
  static_assert(HD % 16 == 0, "head dim: a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* Ks = Qs + BQ * LD;                    // [2][BK][LD]
  T* Vs = Ks + 2 * Sh::TILE;               // [2][BK][LD]

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

  for (int i = tid; i < BQ * CH; i += TC_NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q0 + r < a.Sq;
    cp_async16(Qs + r * LD + c, ok ? Q + (long long)(q0 + r) * a.q_ss + c : Q,
               ok);
  }
  cp_async_commit();
  // rows at or past kv_len are zero-filled (never read from the cache)
  auto load_kv = [&](int t) {
    const int k0 = t * BK;
    T* ks = Ks + (t & 1) * Sh::TILE;
    T* vs = Vs + (t & 1) * Sh::TILE;
    for (int i = tid; i < BK * CH; i += TC_NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = k0 + r < kv_len;
      cp_async16(ks + r * LD + c,
                 ok ? K + (long long)(k0 + r) * a.k_ss + c : K, ok);
      cp_async16(vs + r * LD + c,
                 ok ? V + (long long)(k0 + r) * a.v_ss + c : V, ok);
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
    const T* vs = Vs + (t & 1) * Sh::TILE;
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
        ldsm_x4_t(r, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
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
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
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

template <typename T, int HD>
struct DecShape {
  static constexpr int VEC = Elt<T>::VEC;     // elements per 16 bytes
  static constexpr int LD = HD + VEC;         // padded row, in elements
  static constexpr int CH = HD / VEC;         // 16-byte chunks per row
  static constexpr int TILE = BK * LD;
  static constexpr int QLD = HD + 4;          // padded f32 q row
  static constexpr int DPL = (HD + 31) / 32;  // output columns per lane
  static constexpr size_t RING = 4 * (size_t)TILE * sizeof(T);
  static constexpr size_t MERGE = (size_t)DEC_WARPS * DG * HD * sizeof(float);
  static constexpr size_t BASE = RING > MERGE ? RING : MERGE;
  // the ring (the warps' accumulators after the key loop), q rows, P,
  // each warp's alpha, m and l per head
  static constexpr size_t SMEM =
      BASE + (size_t)(DG * QLD + DEC_WARPS * DG * 16 + 3 * DEC_WARPS * DG) *
                 sizeof(float);
};

// (__launch_bounds__ lets ptxas plan 128 registers a thread: without the
// minimum of 4 blocks it took 96 and spilled 12 bytes at hd 128)
template <typename T, int HD>
__global__ void __launch_bounds__(DEC_NT, 4) decode_kernel(Args a) {
  using Sh = DecShape<T, HD>;
  constexpr int VEC = Sh::VEC, LD = Sh::LD, CH = Sh::CH, QLD = Sh::QLD,
                DPL = Sh::DPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);           // [2][BK][LD]
  T* Vs = Ks + 2 * Sh::TILE;                        // [2][BK][LD]
  float* Acc = reinterpret_cast<float*>(smem_raw);  // [warp][DG][HD], after
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
    T* vs = Vs + (t & 1) * Sh::TILE;
    for (int i = tid; i < BK * CH; i += DEC_NT) {
      const int r = i / CH, c = (i % CH) * VEC;
      const bool ok = k0 + r < hi;
      cp_async16(ks + r * LD + c,
                 ok ? K + (long long)(k0 + r) * a.k_ss + c : K, ok);
      cp_async16(vs + r * LD + c,
                 ok ? V + (long long)(k0 + r) * a.v_ss + c : V, ok);
    }
  };

  for (int g0 = 0; g0 < group; g0 += DG) {
    const int gn = min(DG, group - g0);
    __syncthreads();  // the previous pass is done with the shared memory
    if (n_tiles > 0) load_kv(0);
    cp_async_commit();
    for (int i = tid; i < DG * HD; i += DEC_NT) {
      const int r = i / HD, d = i % HD;
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
      const T* vs = Vs + (t & 1) * Sh::TILE;
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

      if (col < HD) {
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
          load_f32<T, DPL>(vs + (kw + kk) * LD + col, vf);
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
    if (col < HD) {
#pragma unroll
      for (int g = 0; g < DG; ++g)
        if (g < gn) {
#pragma unroll
          for (int d = 0; d < DPL; ++d)
            Acc[(warp * DG + g) * HD + col + d] = acc[g][d];
        }
    }
    __syncthreads();
    // the warps' (m, l, acc) merged into this split's partial per head
    for (int i = tid; i < gn * HD; i += DEC_NT) {
      const int g = i / HD, d = i % HD;
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, Mw[w * DG + g]);
      const float base = M == -INFINITY ? 0.f : M;
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float f = expf(Mw[w * DG + g] - base);
        L += f * Lw[w * DG + g];
        A += f * Acc[(w * DG + g) * HD + d];
      }
      float* P = a.part + (((long long)b * a.H + hk * group + g0 + g) *
                               a.n_split + split) * (HD + 2);
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
// memory for the splits' weights
template <typename T, int HD>
__global__ void __launch_bounds__(DEC_NT) decode_combine_kernel(Args a) {
  extern __shared__ float wts[];  // [n_split]
  __shared__ float red[DEC_WARPS];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* P = a.part + (long long)bh * a.n_split * (HD + 2);
  float mx = -INFINITY;
  for (int s = tid; s < a.n_split; s += DEC_NT)
    mx = fmaxf(mx, P[s * (HD + 2)]);
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
    const float w = expf(P[s * (HD + 2)] - base);
    wts[s] = w;
    lsum += w * P[s * (HD + 2) + 1];
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
  for (int d = tid; d < HD; d += DEC_NT) {
    float A = 0.f;
#pragma unroll 4
    for (int s = 0; s < a.n_split; ++s) A += wts[s] * P[s * (HD + 2) + 2 + d];
    O[d] = Elt<T>::out(L == 0.f ? 0.f : A / L);
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

template <typename T, int HD>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  if (a.part == nullptr || a.n_split < 1 || a.kps < 1 || a.B > 65535 ||
      a.n_split > 65535)
    return cudaErrorInvalidValue;
  constexpr size_t smem = DecShape<T, HD>::SMEM;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = allow_smem(decode_kernel<T, HD>, smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  decode_kernel<T, HD>
      <<<dim3(a.Hkv, a.B, a.n_split), DEC_NT, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T, HD><<<a.B * a.H, DEC_NT,
                                 a.n_split * sizeof(float), stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_prefill(const Args& a, cudaStream_t stream) {
  if (a.B > 65535) return cudaErrorInvalidConfiguration;
  if constexpr (sizeof(T) == 4) {  // f32: the FFMA body
    constexpr size_t smem =
        (HD * BQ + 2 * HD * BK + BQ * (BK + 4)) * sizeof(float);
    static bool sized = false;
    if (!sized) {
      cudaError_t e = allow_smem(prefill_kernel<T, HD>, smem);
      if (e != cudaSuccess) return e;
      sized = true;
    }
    prefill_kernel<T, HD>
        <<<dim3((a.Sq + BQ - 1) / BQ, a.H, a.B), NT, smem, stream>>>(a);
  } else {
    const dim3 grid(a.H, (a.Sq + BQ - 1) / BQ, a.B);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    constexpr size_t smem = TcShape<T, HD>::SMEM;
    static bool sized = false;
    if (!sized) {
      cudaError_t e = allow_smem(prefill_tc_kernel<T, HD>, smem);
      if (e != cudaSuccess) return e;
      sized = true;
    }
    prefill_tc_kernel<T, HD><<<grid, TC_NT, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int decode, cudaStream_t s) {
  return decode ? launch_decode<T, HD>(a, s) : launch_prefill<T, HD>(a, s);
}

template <typename T>
cudaError_t launch_hd(const Args& a, int hd, int decode, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(a, decode, s);
    case 64: return launch<T, 64>(a, decode, s);
    case 112: return launch<T, 112>(a, decode, s);
    case 128: return launch<T, 128>(a, decode, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dims: B H Hkv Sq Sk hd causal, the (batch, head, position) strides of
// q, k, v and o in elements, then n_split and keys per split (decode).
// dtype: 0 f32, 1 bf16, 2 f16.  part: the decode form's f32 scratch,
// B * H * n_split * (hd + 2) floats (null for prefill).  Returns the
// launch's cudaError_t (0 on success).
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
  a.causal = (int)dims[6];
  a.q_sb = dims[7];
  a.q_sh = dims[8];
  a.q_ss = dims[9];
  a.k_sb = dims[10];
  a.k_sh = dims[11];
  a.k_ss = dims[12];
  a.v_sb = dims[13];
  a.v_sh = dims[14];
  a.v_ss = dims[15];
  a.o_sb = dims[16];
  a.o_sh = dims[17];
  a.o_ss = dims[18];
  a.n_split = (int)dims[19];
  a.kps = (int)dims[20];
  a.scale = scale;
  if (a.B == 0 || a.Sq == 0 || a.H == 0) return 0;
  if (a.Hkv <= 0 || a.H % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_hd<float>(a, hd, decode, s);
    case 1: return (int)launch_hd<__nv_bfloat16>(a, hd, decode, s);
    case 2: return (int)launch_hd<__half>(a, hd, decode, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* disc_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

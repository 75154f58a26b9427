// Mamba-2 SSD (state-space dual) chunked scan for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel mamba2_kernel
// (kernels/mamba2/mamba2.py:68) and, on the model path, the recurrence
// of models/layers.py mamba2_apply (its decode einsums and _ssd_chunked).
// Per (batch row b, head h), with the state h (N x P, f32):
//
//   h_t = a_t h_{t-1} + b_t x_t^T        (a_t in (0, 1), a scalar)
//   y_t = c_t^T h_t
//
// for t < n_b = min(lens[b], T); the TPU kernel is the case of a zero
// initial state and lens = T.  Extended for the serve path:
//
// * an optional initial state s0 (B, H, N, P) (null: zeros), so a
//   prompt continues from the cache's state (chunked prefill, decode);
// * the final state s1 (B, H, N, P), written for every row (a row with
//   lens = 0 gets s0 back bit for bit);
// * per-row lens (B,) int32 on the device (null: T): steps t >= n_b
//   leave the state alone and write y = 0 (the reference's padding rule,
//   identity decay and zero input), so padded chunk positions and padded
//   batch rows never touch it;
// * T and every stride are runtime arguments, and a ragged last chunk
//   is masked here, not padded on the host.  N = P = 64 (the config's).
//
// x (B, H, T, P) is read through its (b, h, t) strides and b, c (B, T,
// N) through their (b, t) strides (every head of a row shares them), all
// with a unit last stride and 16-byte aligned rows; the decay a (B, H,
// T) is f32; y (B, H, T, P) is written in f32 through its strides.  The
// model passes token-major views, so nothing is transposed in memory.
// Inputs (f32 or bf16) are widened to f32 as they are staged.
//
// What bounds it on an H100.  The recurrent form needs 4 N P flops per
// head and step (b x^T, a h + ., c^T h): at B = 1, T = 2048, H = 112,
// 3.76 GFLOP, 0.0076 ms at the 495 TFLOP/s of TF32 tensor cores (0.056
// ms on f32 FFMA); it moves ~92 MB (x in bf16, y in f32, b, c, a), 0.027
// ms at 3.35 TB/s: bytes, once the products are on tensor cores.  The
// chunked form does about twice the recurrence's work (four L x N x P
// products a chunk and head, half of S X masked), three times over in
// f32 for the split below.
//
// Two instances, picked by the wrapper's plan (mamba2.ssd_plan):
//
// Decode (T <= DECODE_MAX_T, the engine's T = 1): one block per (b, h),
// 256 threads, each holding 16 of the state's elements (4 rows x 4
// columns) in registers: one streaming pass over s0 and s1 with 16-byte
// accesses, h = exp(log a) h + b x^T and y = c^T h per step, the column
// sums of y by a shuffle and a second level through shared memory.
//
// Chunked (longer T): one launch over (b, chunk of L = 64 steps, group of
// 2 heads), not (b, h): at B = 1, T = 2048, 32 chunks x 56 groups, 1792
// blocks, two an SM.  The plain version's order (ref.py mamba2_chunked),
// per chunk and head, with cum the cumulative log-decay (a warp's
// shuffle scan) and g = exp(cum):
//
//   D      = (B o exp(cum_last - cum))^T X          the chunk's own state
//   h_end  = g_last h_prev + D                      handed to the next chunk
//   S      = (C B^T) o exp(cum_t - cum_s)  (s <= t)
//   y      = diag(g) C h_prev + S X
//
// C B^T is computed once a block (every head of a row shares b and c).
// The chain over chunks runs inside the launch: a block takes its chunk
// from a ticket in launch order, computes C B^T and its heads' D, waits
// for the previous chunk's block of its (b, group) to publish h_prev
// (an acquire load of a flag), publishes h_end through a two-slot ring
// (release), then computes y.  So the chunk states pass through L2 once
// instead of device memory four times (a three-launch version, states
// D and h_prev for every chunk in scratch, was slower at every case).
// The exp of a decay between steps in different 16-step blocks is the
// product of two factors through the later block's first step, both in
// (0, 1], each taken once a head.
//
// The four 64 x 64 x 64 products run on tensor cores (mma.sync m16n8k8
// TF32, eight warps of 16 x 32 outputs) at near-f32 accuracy by the
// 3 x TF32 split: an f32 operand v is hi = v with its low 13 mantissa
// bits cleared plus lo = v - hi, and a product is a_lo b_hi + a_hi b_lo
// + a_hi b_hi with f32 accumulators; an operand that is a bf16 input (b,
// c and x on the bf16 path) is exact in TF32 and takes no low part.
// Tiles sit in shared memory as f32 in rows of 68 floats (read along
// rows) or 72 (read along columns), so that fragment loads hit 32
// banks.  The next head's x is loaded under the current head's products.
// Steps past a chunk's valid ones are staged as zeros and S X stops at
// the warp's last row.
//
// Numerics follow the plain chunked version: log of max(a, 1e-37), expf,
// the products above in place of f32 FFMA (max|d|/max|ref| within 1e-5;
// tests/test_torch_zamba.py emulates this arithmetic on the CPU), the
// chain g_last h + D as a multiply and an add (the library is built with
// --fmad=false), y = g C h + S X summed in the accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int L = 64;         // steps per chunk
constexpr int D = 64;         // N = P
constexpr int NT = 256;       // threads per block
constexpr int LDR = D + 4;    // row stride of tiles read along rows
constexpr int LDC = D + 8;    // row stride of tiles read along columns
constexpr int DECODE_MAX_T = 8;

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int VEC = 4;        // elements per 16-byte chunk
  static constexpr bool EXACT = false;  // exact in TF32
  __device__ static float get(const uint4& c, int j) {
    return __uint_as_float(reinterpret_cast<const uint32_t*>(&c)[j]);
  }
  __device__ static float one(const float* p) { return *p; }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr bool EXACT = true;
  __device__ static float get(const uint4& c, int j) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(&c)[j >> 1];
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

struct Args {
  const void* x;
  const float* a;
  const void* b;
  const void* c;
  const float* s0;
  float* s1;
  float* y;
  const int* lens;
  float* work;    // chunked: the hand-off ring (2, B, H, D, D)
  int* sync;      // chunked: the ticket, then a flag per (b, head group)
  int B, H, T, nc, groups;
  long long x_sb, x_sh, x_st, a_sb, a_sh, a_st, b_sb, b_st, c_sb, c_st;
  long long y_sb, y_sh, y_st;
};

__device__ __forceinline__ int valid_steps(const Args& p, int b) {
  const int n = p.lens ? p.lens[b] : p.T;
  return max(0, min(n, p.T));
}

// A 64-row slab of D elements (row stride ld elements; rows >= n_rows
// read as 0) on its way to shared memory: 16-byte loads into registers,
// a warp's consecutive chunks along a row, then stored widened to f32
// with row stride LD.  Loading a slab ahead of its store keeps the loads
// in flight under the products before it.
template <typename T>
struct Slab {
  static constexpr int VEC = Elt<T>::VEC;
  static constexpr int PER_ROW = D / VEC;
  static constexpr int N = L * PER_ROW / NT;
  uint4 v[N];

  __device__ __forceinline__ void load(const T* src, long long ld,
                                       int n_rows) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * NT;
      const int row = i / PER_ROW;
      // zero first, then a predicated load: nothing waits on the data
      // until the store
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (row < n_rows)
        v[u] = __ldg(reinterpret_cast<const uint4*>(src + row * ld +
                                                    (i % PER_ROW) * VEC));
    }
  }

  template <int LD>
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * NT;
      float* d = dst + (i / PER_ROW) * LD + (i % PER_ROW) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(d + j) =
            make_float4(Elt<T>::get(v[u], j), Elt<T>::get(v[u], j + 1),
                        Elt<T>::get(v[u], j + 2), Elt<T>::get(v[u], j + 3));
    }
  }
};

// One warp, for one head's chunk: la = log(max(a, 1e-37)) at the chunk's
// `steps` valid steps and 0 past them; cum its inclusive sum (a shuffle
// scan of two 32-step halves), de = exp(cum_last - cum), *gl =
// exp(cum_last), and the factors of the decay between 16-step blocks:
// uv[t] = exp(cum_t - cum_{16 I}) (I = t / 16) and uv[64 I + s] =
// exp(cum_{16 I} - cum_s) for s < 16 I, so that for s in an earlier block
// than t, exp(cum_t - cum_s) = uv[t] uv[64 I + s] (both factors in (0,
// 1]: cum does not increase).
__device__ __forceinline__ void head_decays(const float* a, long long a_st,
                                            int steps, float* cum, float* de,
                                            float* gl, float* uv) {
  const int l = threadIdx.x & 31;
  float v0 = l < steps ? logf(fmaxf(a[l * a_st], 1e-37f)) : 0.f;
  float v1 = l + 32 < steps ? logf(fmaxf(a[(l + 32) * a_st], 1e-37f)) : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
    const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
    if (l >= off) {
      v0 += u0;
      v1 += u1;
    }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  const float last = __shfl_sync(0xffffffffu, v1, 31);
  cum[l] = v0;
  cum[l + 32] = v1;
  de[l] = expf(last - v0);
  de[l + 32] = expf(last - v1);
  if (l == 0) *gl = expf(last);
  const float p0 = __shfl_sync(0xffffffffu, v0, 0);
  const float p16 = __shfl_sync(0xffffffffu, v0, 16);
  const float p32 = __shfl_sync(0xffffffffu, v1, 0);
  const float p48 = __shfl_sync(0xffffffffu, v1, 16);
  uv[l] = expf(v0 - (l < 16 ? p0 : p16));
  uv[l + 32] = expf(v1 - (l < 16 ? p32 : p48));
  if (l < 16) uv[64 + l] = expf(p16 - v0);
  uv[128 + l] = expf(p32 - v0);
  uv[192 + l] = expf(p48 - v0);
  if (l < 16) uv[224 + l] = expf(p48 - v1);
}

// ---------------------------------------------------------- 3 x TF32 --

using disc::mma_tf32;
using disc::split;

// acc (a warp's 16 x 32 outputs at rows m0.., columns n0..) +=
// sum_{k < kend} A(m, k) B(k, n), kend a multiple of 8.  Fragment
// layout of m16n8k8: lane = 4 g + t; A (g | g + 8, t | t + 4), B (t |
// t + 4, g), acc[j] (g | g + 8, n0 + 8 j + 2 t + {0, 1}).  SA / SB: the
// operand needs the low part (f32), else it is exact in TF32.
template <bool SA, bool SB, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4], int m0, int n0,
                                         int kend, FA fa, FB fb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < kend; k0 += 8) {
    uint32_t ah[4], al[4];
    split<SA>(fa(m0 + g, k0 + t), ah[0], al[0]);
    split<SA>(fa(m0 + g + 8, k0 + t), ah[1], al[1]);
    split<SA>(fa(m0 + g, k0 + t + 4), ah[2], al[2]);
    split<SA>(fa(m0 + g + 8, k0 + t + 4), ah[3], al[3]);
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 8 * j + g;
      split<SB>(fb(k0 + t, n), bh[j][0], bl[j][0]);
      split<SB>(fb(k0 + t + 4, n), bh[j][1], bl[j][1]);
    }
    // one pass over the four accumulators at a time, the small terms
    // first: consecutive products are independent
    if (SA) {
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
    }
    if (SB) {
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// --------------------------------------------------------- chunked --

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// polls of a predecessor's flag before a block gives up (__trap: a
// launch error, never a hung card)
constexpr long long kSpinLimit = 1ll << 26;
// heads a chunked block walks: at 2, its tiles (108 KB of shared memory)
// leave room for two blocks an SM (mamba2.HEADS_PER_BLOCK)
constexpr int HG = 2;
constexpr size_t kChunkedSmem =
    (3 * L * LDR + (1 + HG) * L * LDC + 6 * HG * L + HG) * sizeof(float);

__device__ __forceinline__ float* ring_slot(const Args& p, int parity, int b,
                                            int h) {
  return p.work +
         ((static_cast<size_t>(parity) * p.B + b) * p.H + h) * D * D;
}

// acc's 16 x 32 outputs of a warp into a [row][col] tile of row stride ld
__device__ __forceinline__ void put_tile(const float (&acc)[4][4], float* dst,
                                         int ld, int m0, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(dst + (m0 + g) * ld + col) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(dst + (m0 + g + 8) * ld + col) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// One launch for every chunk.  A block takes (chunk, b, head group) from
// a ticket in launch order (chunk-major); it stages the chunk's C and B
// and computes C B^T once, and each head's chunk state D; it waits for
// the block of the previous chunk of its (b, group) to publish the state
// that chunk ends with, publishes g_last h_prev + D for the next chunk
// (through a two-slot ring: the slot it overwrites was read before its
// predecessor published), then computes each head's y from h_prev.  A
// block only waits on a smaller ticket, whose block is running or done,
// so every wait ends.
template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_chunked(const Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int tk_s;
  float* Cs = smem;              // [t][n], LDR
  float* Ss = Cs + L * LDR;      // [s][n] of B, then S [t][s], LDR
  float* CB = Ss + L * LDR;      // C B^T [t][s], LDR
  float* Xs = CB + L * LDR;      // [s][p], LDC
  float* Hst = Xs + L * LDC;     // per head: D, then h_prev [n][p], LDC
  float* cums = Hst + HG * L * LDC;  // per head [L]
  float* des = cums + HG * L;    // per head [L] exp(cum_last - cum)
  float* uvs = des + HG * L;     // per head [4 L] block decay factors
  float* gl = uvs + 4 * HG * L;  // per head g_last

  if (threadIdx.x == 0) tk_s = atomicAdd(p.sync, 1);
  __syncthreads();
  const int tk = tk_s;
  const int per_chunk = p.B * p.groups;
  const int c = tk / per_chunk;
  const int b = (tk % per_chunk) / p.groups;
  const int grp = tk % p.groups;
  const int h0 = grp * HG;
  const int nh = min(p.H, h0 + HG) - h0;
  const int c0 = c * L;
  const int n_b = valid_steps(p, b);
  const int ncb = (n_b + L - 1) / L;
  const int steps = min(L, n_b - c0);
  const int rows = min(L, p.T - c0);   // rows of y in this chunk
  int* flag = p.sync + 1 + b * p.groups + grp;

  if (c >= ncb) {  // every step past the row's length: y = 0
    for (int hi = 0; hi < nh; ++hi) {
      float* Y = p.y + b * p.y_sb + (h0 + hi) * p.y_sh + c0 * p.y_st;
      for (int i = threadIdx.x; i < rows * (D / 4); i += NT)
        *reinterpret_cast<float4*>(Y + (i / (D / 4)) * p.y_st +
                                   (i % (D / 4)) * 4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      if (c == 0) {  // lens 0: the state is s0 (or 0) as it came
        const size_t base = (static_cast<size_t>(b) * p.H + h0 + hi) * D * D;
        for (int i = threadIdx.x; i < D * D / 4; i += NT)
          reinterpret_cast<float4*>(p.s1 + base)[i] =
              p.s0 ? reinterpret_cast<const float4*>(p.s0 + base)[i]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 16;
  const int n0 = (warp >> 2) * 32;
  const int gi = lane >> 2;
  constexpr bool SX = !Elt<T>::EXACT;   // x, b, c need a low part
  const int kend = (steps + 7) & ~7;
  const T* X0 = static_cast<const T*>(p.x) + b * p.x_sb + h0 * p.x_sh +
                c0 * p.x_st;

  {  // every read that waits on nothing, at once
    Slab<T> sc, sb, sx0;
    sc.load(static_cast<const T*>(p.c) + b * p.c_sb + c0 * p.c_st, p.c_st,
            steps);
    sb.load(static_cast<const T*>(p.b) + b * p.b_sb + c0 * p.b_st, p.b_st,
            steps);
    sx0.load(X0, p.x_st, steps);
    if (warp < nh)
      head_decays(p.a + b * p.a_sb + (h0 + warp) * p.a_sh + c0 * p.a_st,
                  p.a_st, steps, cums + warp * L, des + warp * L, gl + warp,
                  uvs + 4 * warp * L);
    sc.template store<LDR>(Cs);
    sb.template store<LDR>(Ss);
    sx0.template store<LDC>(Xs);
  }

  // C B^T, then each head's chunk state D = (B o de)^T X; the next
  // head's x is loaded under the product
  Slab<T> sx;
  for (int hi = 0; hi < nh; ++hi) {
    if (hi > 0) {
      __syncthreads();  // the previous head's product is done with Xs
      sx.template store<LDC>(Xs);
    }
    __syncthreads();
    if (hi + 1 < nh) sx.load(X0 + (hi + 1) * p.x_sh, p.x_st, steps);
    float acc[4][4];
    if (hi == 0 && n0 <= m0 + 15) {  // the tiles that hold some s <= t
      zero(acc);
      warp_mma<SX, SX>(acc, m0, n0, D,
                       [&](int m, int k) { return Cs[m * LDR + k]; },
                       [&](int k, int n) { return Ss[n * LDR + k]; });
      put_tile(acc, CB, LDR, m0, n0);
    }
    const float* de = des + hi * L;
    zero(acc);
    warp_mma<true, SX>(
        acc, m0, n0, kend,
        [&](int m, int k) { return Ss[k * LDR + m] * de[k]; },
        [&](int k, int n) { return Xs[k * LDC + n]; });
    put_tile(acc, Hst + hi * L * LDC, LDC, m0, n0);
  }
  __syncthreads();

  // the hand-off: h_prev from the previous chunk (s0 or 0 at chunk 0),
  // g_last h_prev + D to the next (s1 at the row's last chunk)
  if (c > 0 && threadIdx.x == 0) {
    long long polls = 0;
    while (ld_acquire(flag) < c) {
      if (++polls > kSpinLimit) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
  const bool last = c == ncb - 1;
  // two heads' reads at a time, then their updates
  constexpr int Q = D * D / 4 / NT;   // float4s of a state a thread
  for (int h2 = 0; h2 < nh; h2 += 2) {
    float4 hp[2][Q];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int hi = h2 + e;
      const size_t sbase = (static_cast<size_t>(b) * p.H + h0 + hi) * D * D;
      const float4* prev = reinterpret_cast<const float4*>(
          c > 0 ? ring_slot(p, (c - 1) & 1, b, h0 + hi) : p.s0 + sbase);
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        const int i = threadIdx.x + u * NT;
        hp[e][u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (hi < nh) {
          if (c > 0)
            hp[e][u] = __ldcg(prev + i);
          else if (p.s0)
            hp[e][u] = prev[i];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int hi = h2 + e;
      if (hi >= nh) break;
      const size_t sbase = (static_cast<size_t>(b) * p.H + h0 + hi) * D * D;
      float4* next = reinterpret_cast<float4*>(
          last ? p.s1 + sbase : ring_slot(p, c & 1, b, h0 + hi));
      float* Dh = Hst + hi * L * LDC;
      const float g = gl[hi];
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        const int i = threadIdx.x + u * NT;
        float4* dp = reinterpret_cast<float4*>(Dh + (i / (D / 4)) * LDC +
                                               (i % (D / 4)) * 4);
        const float4 d = *dp;
        const float4 v = hp[e][u];
        next[i] = make_float4(g * v.x + d.x, g * v.y + d.y, g * v.z + d.z,
                              g * v.w + d.w);
        *dp = v;
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && !last) st_release(flag, c + 1);

  // y = diag(g) C h_prev + S X, the last head first (its x is staged);
  // the next head's x is loaded under the products
  const int kend_y = min(m0 + 16, kend);
  const int r0 = m0 + gi, r1 = r0 + 8;
  for (int j = 0; j < nh; ++j) {
    const int hi = nh - 1 - j;
    const float* cum = cums + hi * L;
    __syncthreads();  // the previous head is done with Xs and Ss
    if (j > 0) sx.template store<LDC>(Xs);
    if (j + 1 < nh) sx.load(X0 + (hi - 1) * p.x_sh, p.x_st, steps);
    // S by patches of 2 rows x 16 columns a warp: a patch lies in a
    // diagonal 16 x 16 block (exp of the difference), in an earlier
    // column block (the two factors' product) or above the diagonal (0)
    const float* uv = uvs + 4 * hi * L;
#pragma unroll 4
    for (int u = 0; u < L * L / NT; ++u) {
      const int patch = warp + u * (NT / 32);
      const int t = 2 * (patch >> 2) + (lane >> 4);
      const int blk = patch & 3;
      const int s = 16 * blk + (lane & 15);
      const int tb = t >> 4;
      float v = 0.f;
      if (blk == tb) {
        if (s <= t) v = CB[t * LDR + s] * expf(cum[t] - cum[s]);
      } else if (blk < tb) {
        v = CB[t * LDR + s] * (uv[t] * uv[64 * tb + s]);
      }
      Ss[t * LDR + s] = v;
    }
    __syncthreads();
    const float* Hp = Hst + hi * L * LDC;
    float acc[4][4];
    zero(acc);
    warp_mma<SX, true>(acc, m0, n0, D,
                       [&](int m, int k) { return Cs[m * LDR + k]; },
                       [&](int k, int n) { return Hp[k * LDC + n]; });
    const float g0 = expf(cum[r0]), g1 = expf(cum[r1]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[q][0] *= g0;
      acc[q][1] *= g0;
      acc[q][2] *= g1;
      acc[q][3] *= g1;
    }
    warp_mma<true, SX>(acc, m0, n0, kend_y,
                       [&](int m, int k) { return Ss[m * LDR + k]; },
                       [&](int k, int n) { return Xs[k * LDC + n]; });
    float* Y = p.y + b * p.y_sb + (h0 + hi) * p.y_sh + c0 * p.y_st;
    const int ti = lane & 3;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + 8 * q + 2 * ti;
      if (r0 < rows)
        *reinterpret_cast<float2*>(Y + r0 * p.y_st + col) =
            r0 < steps ? make_float2(acc[q][0], acc[q][1])
                       : make_float2(0.f, 0.f);
      if (r1 < rows)
        *reinterpret_cast<float2*>(Y + r1 * p.y_st + col) =
            r1 < steps ? make_float2(acc[q][2], acc[q][3])
                       : make_float2(0.f, 0.f);
    }
  }
}

// ----------------------------------------------------------- decode --

// One block per (b, h): thread tid holds rows n = tid / 16 + 16 j (j <
// 4) at columns 4 (tid % 16) .. + 3 of the state.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_decode(const Args p) {
  __shared__ float part[NT / 32][D];
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int n_b = valid_steps(p, b);
  const int q = threadIdx.x & 15;
  const int r = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5;
  const size_t sbase = (static_cast<size_t>(b) * p.H + h) * D * D;
  float st[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.s0)
      v = *reinterpret_cast<const float4*>(p.s0 + sbase + (r + 16 * j) * D +
                                           4 * q);
    st[j][0] = v.x;
    st[j][1] = v.y;
    st[j][2] = v.z;
    st[j][3] = v.w;
  }
  const T* X = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* Bg = static_cast<const T*>(p.b) + b * p.b_sb;
  const T* Cg = static_cast<const T*>(p.c) + b * p.c_sb;
  const float* A = p.a + b * p.a_sb + h * p.a_sh;
  float* Y = p.y + b * p.y_sb + h * p.y_sh;
  for (int t = 0; t < p.T; ++t) {
    if (t >= n_b) {  // uniform over the block
      if (threadIdx.x < D / 4)
        *reinterpret_cast<float4*>(Y + t * p.y_st + 4 * threadIdx.x) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float gt = expf(logf(fmaxf(A[t * p.a_st], 1e-37f)));
    float xv[4], yv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = Elt<T>::one(X + t * p.x_st + 4 * q + i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = r + 16 * j;
      const float bn = Elt<T>::one(Bg + t * p.b_st + n);
      const float cn = Elt<T>::one(Cg + t * p.c_st + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st[j][i] = gt * st[j][i] + bn * xv[i];
        yv[i] = fmaf(cn, st[j][i], yv[i]);
      }
    }
    // the column sums over the 16 row groups: lanes tid, tid ^ 16 hold
    // two of them, the 8 warps the rest
#pragma unroll
    for (int i = 0; i < 4; ++i) yv[i] += __shfl_xor_sync(0xffffffffu, yv[i], 16);
    if ((threadIdx.x & 16) == 0)
      *reinterpret_cast<float4*>(&part[warp][4 * q]) =
          make_float4(yv[0], yv[1], yv[2], yv[3]);
    __syncthreads();
    if (threadIdx.x < D) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) s += part[w][threadIdx.x];
      Y[t * p.y_st + threadIdx.x] = s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(p.s1 + sbase + (r + 16 * j) * D + 4 * q) =
        make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
}

template <typename T>
cudaError_t launch(const Args& a, int instance, cudaStream_t stream) {
  if (instance == 0) {
    if (a.T > DECODE_MAX_T) return cudaErrorInvalidValue;
    ssd_decode<T><<<a.B * a.H, NT, 0, stream>>>(a);
    return cudaGetLastError();
  }
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunked<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kChunkedSmem));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  if (a.sync == nullptr || a.work == nullptr) return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>(a.B) * a.nc * a.groups;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (tiles > 0)
    ssd_chunked<T><<<static_cast<unsigned>(tiles), NT, kChunkedSmem,
                     stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dims: B H T N P, then the (batch, head, step) strides of x and a, the
// (batch, step) strides of b and c, and the (batch, head, step) strides
// of y, in elements.  dtype (of x, b and c): 0 f32, 1 bf16.  instance: 0
// decode (T <= 8), 1 chunked (HG = 2 heads a block), with `work` 2 * B *
// H * N * P floats (the hand-off ring) and `sync` 1 + B * ceil(H / 2)
// ints, zero (the ticket and flags).
// s0 and lens may be null.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int disc_mamba2(const void* x, const float* a, const void* b,
                           const void* c, const float* s0, float* s1,
                           float* y, const int* lens, float* work,
                           int* sync, const long long* dims, int dtype,
                           int instance, void* stream) {
  Args p;
  p.x = x;
  p.a = a;
  p.b = b;
  p.c = c;
  p.s0 = s0;
  p.s1 = s1;
  p.y = y;
  p.lens = lens;
  p.work = work;
  p.sync = sync;
  p.B = static_cast<int>(dims[0]);
  p.H = static_cast<int>(dims[1]);
  p.T = static_cast<int>(dims[2]);
  if (dims[3] != D || dims[4] != D) return static_cast<int>(cudaErrorInvalidValue);
  p.x_sb = dims[5];
  p.x_sh = dims[6];
  p.x_st = dims[7];
  p.a_sb = dims[8];
  p.a_sh = dims[9];
  p.a_st = dims[10];
  p.b_sb = dims[11];
  p.b_st = dims[12];
  p.c_sb = dims[13];
  p.c_st = dims[14];
  p.y_sb = dims[15];
  p.y_sh = dims[16];
  p.y_st = dims[17];
  p.nc = (p.T + L - 1) / L;
  if (p.B == 0 || p.H == 0) return 0;
  p.groups = (p.H + HG - 1) / HG;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(p, instance, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(p, instance, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* disc_mamba2_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

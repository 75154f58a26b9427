// Row normalisations for sm_90a: RMSNorm and LayerNorm over rows of width
// D, built into two libraries (rmsnorm/csrc/rmsnorm.cu,
// layernorm/csrc/layernorm.cu).
//
// They replace the JAX package's Pallas TPU kernels rmsnorm_kernel
// (kernels/rmsnorm/rmsnorm.py:26) and layernorm_kernel
// (kernels/layernorm/layernorm.py:24):
//   RMSNorm    y = x * rsqrt(mean(x^2) + eps) * w
//   LayerNorm  y = (x - mu) * rsqrt(mean((x - mu)^2) + eps) * g + b
// each accumulated in f32 whatever the input type and rounded once to x's
// type.
//
// What bounds them on an H100: bytes.  One read of x and one write of y,
// ~4 (RMSNorm) or ~7 (LayerNorm) flops an element: well under one flop a
// byte.  At a decode step's few rows, latency: the chain from a row's
// first load to its last store, a few microseconds against a bound of
// nanoseconds.
//
// Design.
// * A row held in registers at its exact width.  A group of G threads (a
//   power of two, 1 to 512) holds a row; thread i of the group holds
//   chunks i, i + G, ..., CH of them, each VEC consecutive columns (16
//   bytes where the rows are 16-byte readable, else one column).  The
//   chunks cover the row's D / VEC units and no more: only the last chunk
//   has lanes that hold nothing (at D = 2560 in bf16, 320 units, not the
//   512 a power-of-two block would mask).
// * The weight loaded once a thread, not once a row.  A thread owns the
//   same columns in every row, so it loads its weight (and bias) chunks
//   once, widened to f32 in registers, and reuses them for every row its
//   group takes: in whole chunks where the weight (and bias) is f32 and
//   16-byte aligned, as in every model (the wrapper picks that instance),
//   else an element a load.  The grid comes from row_norm.norm_plan: for
//   many rows it is sized to the card and each group walks rows with a
//   stride; for few rows (decode) it is sized to the rows.
// * Loads first.  A chunk is held as loaded, in 32-bit words, and
//   converted where it is used, so a thread issues its row's loads, then
//   its weight's, with no instruction between them that waits on a load;
//   where registers allow (kPrefetch below) it issues the next row's
//   loads before it reduces the current row.
// * Reductions: a thread's values as a pairwise tree, then a
//   __shfl_xor_sync butterfly (all five steps for a group of a warp or
//   more); a group of several warps meets in shared memory for a second
//   butterfly.  Every thread of a block runs the same number of rows (the
//   walk's bound is the block's first row), so the barriers match; a
//   thread past the last row loads and stores nothing.
// * Rows too wide for registers (more than 8 chunks, or more than 32
//   values a thread for RMSNorm, 24 for LayerNorm) take the loop
//   instance: a block of 512 threads a row that reads the row from device
//   memory in passes (RMSNorm two, LayerNorm three) and the weight with
//   it.  No model of the port has such rows.
// The row count and the row stride are runtime arguments; D picks only
// the plan.
//
// Numerics are those of the plain versions (rmsnorm/ref.py,
// layernorm/ref.py): every sum in f32, each mean the f32 sum times the
// f32 1/D (as PyTorch's mean reduction computes it), rsqrtf from the CUDA
// math library (as torch.rsqrt), LayerNorm's variance that of the centred
// row (two passes over the registers, so rows far from zero mean do not
// cancel), the products in the plain versions' order ((x * r) * w, and
// ((x - mu) * r) * g + b) with no fused multiply-add (the library is
// built with --fmad=false), and one rounding to x's type.  Only the
// summation order differs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace disc {

// threads a block at most; chunks a thread in the register instances, and
// values a thread (LayerNorm holds a bias beside the scale, so fewer);
// the registers a thread may spend on its weight and two rows' chunks
// before the next row's loads wait for the store
constexpr int kNormThreads = 512;
constexpr int kNormLoopLog = 9;
constexpr int kNormChunks = 8;
constexpr int kNormElemsRms = 32;
constexpr int kNormElemsLn = 24;
constexpr int kPrefetchRegs = 80;

// Elements of T packed in 32-bit words: get widens element e to f32,
// bits rounds an f32 once to T's bit pattern.
template <typename T>
struct NormElt;
template <>
struct NormElt<float> {
  static constexpr int kPerWord = 1;
  __device__ static float get(const uint32_t* w, int e) {
    return __uint_as_float(w[e]);
  }
  __device__ static uint32_t bits(float v) { return __float_as_uint(v); }
};
template <>
struct NormElt<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static float get(const uint32_t* w, int e) {
    const uint32_t x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
  __device__ static uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <>
struct NormElt<__half> {
  static constexpr int kPerWord = 2;
  __device__ static float get(const uint32_t* w, int e) {
    const uint32_t x = w[e >> 1];
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>((e & 1) ? (x >> 16) : (x & 0xffffu))));
  }
  __device__ static uint32_t bits(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

// VEC consecutive elements of T held as loaded, in 32-bit words (a chunk
// is converted where it is used, so that no instruction waits on a load
// before the other loads are issued)
template <typename T, int VEC>
struct NormChunk {
  static constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  static constexpr int kWords = (kBytes + 3) / 4;
  uint32_t w[kWords];
};

// a chunk from a, in 16-byte (or 8-, 4-, 2-byte) accesses: a is aligned
// to the chunk's size, or to 16 bytes for a larger chunk
template <typename T, int VEC>
__device__ __forceinline__ void chunk_load(NormChunk<T, VEC>& c, const T* a) {
  constexpr int B = NormChunk<T, VEC>::kBytes;
  if constexpr (B % 16 == 0) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(a)[i];
      c.w[4 * i] = v.x;
      c.w[4 * i + 1] = v.y;
      c.w[4 * i + 2] = v.z;
      c.w[4 * i + 3] = v.w;
    }
  } else if constexpr (B == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(a);
    c.w[0] = v.x;
    c.w[1] = v.y;
  } else if constexpr (B == 4) {
    c.w[0] = *reinterpret_cast<const uint32_t*>(a);
  } else {
    c.w[0] = *reinterpret_cast<const unsigned short*>(a);
  }
}

// the same an element a load (a weight that is not so aligned)
template <typename T, int VEC>
__device__ __forceinline__ void chunk_load_each(NormChunk<T, VEC>& c,
                                                const T* a) {
  constexpr int P = NormElt<T>::kPerWord;
#pragma unroll
  for (int i = 0; i < NormChunk<T, VEC>::kWords; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (i * P + q < VEC) {
        if constexpr (P == 1)
          word = reinterpret_cast<const uint32_t*>(a)[i];
        else
          word |= static_cast<uint32_t>(
                      reinterpret_cast<const unsigned short*>(a)[i * P + q])
                  << (16 * q);
      }
    c.w[i] = word;
  }
}

// y rounded once to T, as one chunk, stored at a
template <typename T, int VEC>
__device__ __forceinline__ void chunk_store(T* a, const float (&y)[VEC]) {
  constexpr int P = NormElt<T>::kPerWord;
  NormChunk<T, VEC> c;
#pragma unroll
  for (int i = 0; i < NormChunk<T, VEC>::kWords; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (i * P + q < VEC) word |= NormElt<T>::bits(y[i * P + q]) << (16 * q);
    c.w[i] = word;
  }
  constexpr int B = NormChunk<T, VEC>::kBytes;
  if constexpr (B == 16) {
    *reinterpret_cast<uint4*>(a) = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
  } else if constexpr (B == 4) {
    *reinterpret_cast<uint32_t*>(a) = c.w[0];
  } else {
    static_assert(B == 2, "a chunk of x is 16, 4 or 2 bytes");
    *reinterpret_cast<unsigned short*>(a) = static_cast<unsigned short>(c.w[0]);
  }
}

// element i of a weight of dtype dt (0 f32, 1 bf16, 2 f16), widened to f32
__device__ __forceinline__ float weight_any(const void* w, long long i,
                                            int dt) {
  if (dt == 0) return static_cast<const float*>(w)[i];
  const uint32_t h = static_cast<const unsigned short*>(w)[i];
  return dt == 1 ? NormElt<__nv_bfloat16>::get(&h, 0)
                 : NormElt<__half>::get(&h, 0);
}

struct NormArgs {
  const void* x;  // R rows of D, row stride xs (elements), unit column stride
  const void* w;  // the scale (D), dtype wdt
  const void* b;  // LayerNorm's bias (D), dtype bdt (RMSNorm: unused)
  void* o;        // R rows of D, row stride D
  long long R, xs;
  int D;
  int units;  // chunks of the row: D / VEC
  int glog;   // log2 of the threads a row
  int wdt, bdt;
  float inv_d, eps;
};

// The thread's chunks of a weight of type W, widened to f32: every load
// first, then the conversions.  EACH: an element a load
// (a weight not aligned to its chunk, or to 16 bytes), else a chunk in
// 16-byte (or 8-, 4-, 2-byte) accesses.
template <bool EACH, typename W, int VEC, int CH>
__device__ __forceinline__ void load_weight(float (&r)[CH][VEC], const W* w,
                                            int lane, int glog, int units) {
  // A lane's chunk past the row is zeroed: left undefined, it let the
  // compiler fill it with a copy of another chunk's registers, an
  // instruction that waits on that chunk's load before the loads after it
  // are issued (a memory round trip on a decode step's critical path).
  NormChunk<W, VEC> raw[CH] = {};
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int u = lane + (j << glog);
    if (j < CH - 1 || u < units) {
      const W* src = w + static_cast<long long>(u) * VEC;
      if constexpr (EACH)
        chunk_load_each(raw[j], src);
      else
        chunk_load(raw[j], src);
    }
  }
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[j][e] = NormElt<W>::get(raw[j].w, e);
}

// The weight's chunks for the instance's weight path WSEL: kWeightF32
// reads an f32 weight in whole chunks (the wrapper takes it for 16-byte
// rows whose weight and bias are f32 and 16-byte aligned); kWeightAny
// reads a weight of dtype dt (0 f32, 1 bf16, 2 f16) an element a load.
constexpr int kWeightF32 = 0, kWeightAny = 1;
template <int WSEL, int VEC, int CH>
__device__ __forceinline__ void load_weight_sel(float (&r)[CH][VEC],
                                                const void* w, int dt,
                                                int lane, int glog,
                                                int units) {
  if constexpr (WSEL == kWeightF32) {
    load_weight<false>(r, static_cast<const float*>(w), lane, glog, units);
  } else if (dt == 0) {
    load_weight<true>(r, static_cast<const float*>(w), lane, glog, units);
  } else if (dt == 1) {
    load_weight<true>(r, static_cast<const __nv_bfloat16*>(w), lane, glog,
                      units);
  } else {
    load_weight<true>(r, static_cast<const __half*>(w), lane, glog, units);
  }
}

// The sum of v over the row's group of 1 << glog threads: a butterfly in
// the warp (all five steps for a group of a warp or more) and, for a group
// of several warps, a second butterfly over the warps' sums, which meet in
// red (callers alternate two arrays, so one barrier a reduction
// suffices).  Every thread of the group ends with the same bits.
__device__ __forceinline__ float group_sum(float v, int glog, float* red) {
  if (glog >= 5) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
  } else {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      if (off < (1 << glog)) v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  if (glog > 5) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int per_row = 1 << (glog - 5);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    // lane i holds warp (i mod per_row) of the row's warps
    v = red[(warp & ~(per_row - 1)) + (lane & (per_row - 1))];
#pragma unroll
    for (int off = kNormThreads / 64; off > 0; off >>= 1)
      if (off < per_row) v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// the sum of t[0..N) as a pairwise tree
template <int N>
struct TreeSum {
  __device__ __forceinline__ static float of(const float* t) {
    return TreeSum<N / 2>::of(t) + TreeSum<N - N / 2>::of(t + N / 2);
  }
};
template <>
struct TreeSum<1> {
  __device__ __forceinline__ static float of(const float* t) { return t[0]; }
};

// A thread's partial sum, as a pairwise tree, over the values it holds of
// x (OP 0), x^2 (1) or (x - mu)^2 (2); lanes past the row add 0
template <int OP, typename T, int VEC, int CH>
__device__ __forceinline__ float thread_sum(const NormChunk<T, VEC> (&c)[CH],
                                            bool last, float mu) {
  float t[CH * VEC];
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float v = NormElt<T>::get(c[j].w, e);
      const float d = v - mu;
      const float y = OP == 0 ? v : OP == 1 ? v * v : d * d;
      t[j * VEC + e] = j < CH - 1 || last ? y : 0.f;
    }
  return TreeSum<CH * VEC>::of(t);
}

// a row's chunks (nothing for a row past R; the last chunk only where the
// thread holds it)
template <typename T, int VEC, int CH>
__device__ __forceinline__ void load_row(NormChunk<T, VEC> (&c)[CH],
                                         const NormArgs& p, long long row,
                                         int lane, bool last) {
  if (row < p.R) {
    const T* src = static_cast<const T*>(p.x) + row * p.xs +
                   static_cast<long long>(lane) * VEC;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (j < CH - 1 || last) chunk_load(c[j], src + (j << p.glog) * VEC);
  }
}

// The register instance: blockDim.x / G groups a block, group g of block
// b taking rows b * rows + g, then (WALK) every gridDim.x * rows rows
// after; without WALK the grid covers the rows and the code holds no loop.
template <typename T, int VEC, int CH, bool LN, int WSEL, bool WALK>
__global__ void __launch_bounds__(kNormThreads)
    norm_rows(const NormArgs p) {
  using C = NormChunk<T, VEC>;
  using E = NormElt<T>;
  // registers: the weight (and bias) in f32, a row's chunks as loaded
  constexpr int kW = (LN ? 2 : 1) * CH * VEC;
  constexpr bool kPrefetch =
      WALK && kW + 2 * CH * C::kWords <= kPrefetchRegs;
  __shared__ float red[2][kNormThreads / 32];
  const int glog = p.glog;
  const int lane = threadIdx.x & ((1 << glog) - 1);
  const int rows = blockDim.x >> glog;
  const long long stride = static_cast<long long>(gridDim.x) * rows;
  const long long first = static_cast<long long>(blockIdx.x) * rows;
  // the last chunk is partial: lanes past the row's units hold nothing
  const bool last = lane + ((CH - 1) << glog) < p.units;

  // the first row's loads, then the weight's: the row is needed first
  long long row = first + (threadIdx.x >> glog);
  C cur[CH];
  load_row<T, VEC, CH>(cur, p, row, lane, last);
  float w[CH][VEC];
  float b[LN ? CH : 1][VEC];
  load_weight_sel<WSEL>(w, p.w, p.wdt, lane, glog, p.units);
  if constexpr (LN) load_weight_sel<WSEL>(b, p.b, p.bdt, lane, glog, p.units);

  int k = 0;  // reductions so far: the next one meets in red[k & 1]
  for (long long base = first; base < p.R; base += stride, row += stride) {
    C nxt[CH];
    if constexpr (kPrefetch)
      load_row<T, VEC, CH>(nxt, p, row + stride, lane, last);
    float mu = 0.f, r;
    if constexpr (LN) {
      mu = group_sum(thread_sum<0>(cur, last, 0.f), glog, red[k++ & 1]) *
           p.inv_d;
      r = rsqrtf(group_sum(thread_sum<2>(cur, last, mu), glog,
                           red[k++ & 1]) * p.inv_d + p.eps);
    } else {
      r = rsqrtf(group_sum(thread_sum<1>(cur, last, 0.f), glog,
                           red[k++ & 1]) * p.inv_d + p.eps);
    }
    if (row < p.R) {
      T* dst = static_cast<T*>(p.o) + row * p.D +
               static_cast<long long>(lane) * VEC;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        if (j < CH - 1 || last) {
          float y[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            if constexpr (LN)
              y[e] = (E::get(cur[j].w, e) - mu) * r * w[j][e] + b[j][e];
            else
              y[e] = E::get(cur[j].w, e) * r * w[j][e];
          }
          chunk_store(dst + (j << glog) * VEC, y);
        }
      }
    }
    if constexpr (!WALK) break;
    if constexpr (kPrefetch) {
#pragma unroll
      for (int j = 0; j < CH; ++j) cur[j] = nxt[j];
    } else {
      load_row<T, VEC, CH>(cur, p, row + stride, lane, last);
    }
  }
}

// The loop instance: a block of kNormThreads threads a row (rows
// blockIdx.x, then every gridDim.x-th), thread i taking chunks i, i +
// kNormThreads, ... of VEC columns in each pass.
template <typename T, int VEC, bool LN>
__global__ void __launch_bounds__(kNormThreads) norm_loop(const NormArgs p) {
  using C = NormChunk<T, VEC>;
  using E = NormElt<T>;
  __shared__ float red[2][kNormThreads / 32];
  int k = 0;
  for (long long row = blockIdx.x; row < p.R; row += gridDim.x) {
    const T* xr = static_cast<const T*>(p.x) + row * p.xs;
    T* orow = static_cast<T*>(p.o) + row * p.D;
    float mu = 0.f, r;
    if constexpr (LN) {
      float s = 0.f;
#pragma unroll 4
      for (int i = threadIdx.x; i < p.units; i += kNormThreads) {
        C c;
        chunk_load(c, xr + static_cast<long long>(i) * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += E::get(c.w, e);
      }
      mu = group_sum(s, kNormLoopLog, red[k++ & 1]) * p.inv_d;
      float q = 0.f;
#pragma unroll 4
      for (int i = threadIdx.x; i < p.units; i += kNormThreads) {
        C c;
        chunk_load(c, xr + static_cast<long long>(i) * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = E::get(c.w, e) - mu;
          q += d * d;
        }
      }
      r = rsqrtf(group_sum(q, kNormLoopLog, red[k++ & 1]) * p.inv_d + p.eps);
    } else {
      float s = 0.f;
#pragma unroll 4
      for (int i = threadIdx.x; i < p.units; i += kNormThreads) {
        C c;
        chunk_load(c, xr + static_cast<long long>(i) * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = E::get(c.w, e);
          s += v * v;
        }
      }
      r = rsqrtf(group_sum(s, kNormLoopLog, red[k++ & 1]) * p.inv_d + p.eps);
    }
#pragma unroll 4
    for (int i = threadIdx.x; i < p.units; i += kNormThreads) {
      C c;
      chunk_load(c, xr + static_cast<long long>(i) * VEC);
      float y[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const long long col = static_cast<long long>(i) * VEC + e;
        const float g = weight_any(p.w, col, p.wdt);
        if constexpr (LN)
          y[e] = (E::get(c.w, e) - mu) * r * g + weight_any(p.b, col, p.bdt);
        else
          y[e] = E::get(c.w, e) * r * g;
      }
      chunk_store(orow + static_cast<long long>(i) * VEC, y);
    }
  }
}

// Register instances: kWeightF32 for 16-byte chunks only (a row read a
// column a chunk is rare, and takes kWeightAny)
template <typename T, bool LN, int VEC, int CH, bool WALK>
cudaError_t norm_launch_w(const NormArgs& a, int wsel, int threads, int grid,
                          cudaStream_t s) {
  if (wsel == kWeightAny)
    norm_rows<T, VEC, CH, LN, kWeightAny, WALK><<<grid, threads, 0, s>>>(a);
  else if constexpr (VEC == 1)
    return cudaErrorInvalidValue;
  else
    norm_rows<T, VEC, CH, LN, kWeightF32, WALK><<<grid, threads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool LN, int VEC, int CH>
cudaError_t norm_launch_ch(const NormArgs& a, int wsel, bool walk,
                           int threads, int grid, cudaStream_t s) {
  if constexpr (VEC * CH > (LN ? kNormElemsLn : kNormElemsRms)) {
    return cudaErrorInvalidValue;
  } else {
    return walk ? norm_launch_w<T, LN, VEC, CH, true>(a, wsel, threads, grid,
                                                      s)
                : norm_launch_w<T, LN, VEC, CH, false>(a, wsel, threads,
                                                       grid, s);
  }
}

template <typename T, bool LN, int VEC>
cudaError_t norm_launch_vec(const NormArgs& a, int ch, int wsel, bool walk,
                            int threads, int grid, cudaStream_t s) {
  switch (ch) {
    case 1:
      return norm_launch_ch<T, LN, VEC, 1>(a, wsel, walk, threads, grid, s);
    case 2:
      return norm_launch_ch<T, LN, VEC, 2>(a, wsel, walk, threads, grid, s);
    case 3:
      return norm_launch_ch<T, LN, VEC, 3>(a, wsel, walk, threads, grid, s);
    case 4:
      return norm_launch_ch<T, LN, VEC, 4>(a, wsel, walk, threads, grid, s);
    case 5:
      return norm_launch_ch<T, LN, VEC, 5>(a, wsel, walk, threads, grid, s);
    case 6:
      return norm_launch_ch<T, LN, VEC, 6>(a, wsel, walk, threads, grid, s);
    case 7:
      return norm_launch_ch<T, LN, VEC, 7>(a, wsel, walk, threads, grid, s);
    case 8:
      return norm_launch_ch<T, LN, VEC, 8>(a, wsel, walk, threads, grid, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool LN>
cudaError_t norm_launch(const NormArgs& a, bool wide, bool loop, int ch,
                        int wsel, bool walk, int threads, int grid,
                        cudaStream_t s) {
  constexpr int WIDE = 16 / sizeof(T);
  if (loop) {
    if (wide)
      norm_loop<T, WIDE, LN><<<grid, kNormThreads, 0, s>>>(a);
    else
      norm_loop<T, 1, LN><<<grid, kNormThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  return wide ? norm_launch_vec<T, LN, WIDE>(a, ch, wsel, walk, threads,
                                             grid, s)
              : norm_launch_vec<T, LN, 1>(a, ch, wsel, walk, threads, grid,
                                          s);
}

// The C entry of either library.  x (R rows of D, row stride xs
// elements, unit column stride), w and b (D each; b null for RMSNorm),
// o (R rows of D, contiguous).  cfg is row_norm.launch_word's packing of
// the dtypes and the plan: bits 0-1 x's dtype (0 f32, 1 bf16, 2 f16),
// 2-3 the weight's, 4-5 the bias's, bit 6 wide (16-byte chunks: x's rows
// and o 16-byte aligned, D a multiple of 16 / sizeof(x)), bit 7 the loop
// instance, bits 8-11 chunks a thread (1-8), 12-15 log2 of the threads a
// row (0-9), 16-23 rows a block, bit 24 the weight path (kWeightF32: w
// and b f32 and 16-byte aligned, the rows wide; kWeightAny), bit 26 the
// walk (groups take several rows; without it the grid must cover the
// rows); `grid` blocks.  DTYPES says which x dtypes the library holds.
// Returns the launch's cudaError_t (0 on success).
template <bool LN, int DTYPES>
int norm_entry(const void* x, const void* w, const void* b, void* o,
               long long R, int D, long long xs, int cfg, int grid,
               float eps, void* stream) {
  if (R <= 0 || D <= 0) return 0;
  const int dt = cfg & 3, wdt = (cfg >> 2) & 3, bdt = (cfg >> 4) & 3;
  const bool wide = (cfg >> 6) & 1, loop = (cfg >> 7) & 1;
  const int ch = (cfg >> 8) & 15, glog = (cfg >> 12) & 15;
  const int rows = (cfg >> 16) & 255, wsel = (cfg >> 24) & 1;
  const bool walk = (cfg >> 26) & 1;
  const int threads = rows << glog;
  const int vec = wide ? (dt == 0 ? 4 : 8) : 1;
  const cudaError_t bad = cudaErrorInvalidValue;
  if (dt >= DTYPES || wdt > 2 || bdt > 2 || (LN && b == nullptr) ||
      glog > kNormLoopLog || rows < 1 || threads > kNormThreads ||
      threads % 32 || grid <= 0 || D % vec ||
      (!walk && !loop && static_cast<long long>(grid) * rows < R))
    return static_cast<int>(bad);
  const int units = D / vec;
  if (loop ? (glog != kNormLoopLog || rows != 1)
           : (ch < 1 || ch > kNormChunks ||
              (static_cast<long long>(ch) << glog) < units ||
              (static_cast<long long>(ch - 1) << glog) >= units))
    return static_cast<int>(bad);
  NormArgs a{x, w, b, o, R, xs, D, units, glog, wdt, bdt,
             1.0f / static_cast<float>(D), eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = bad;
  switch (dt) {
    case 0:
      e = norm_launch<float, LN>(a, wide, loop, ch, wsel, walk, threads, grid,
                                 s);
      break;
    case 1:
      e = norm_launch<__nv_bfloat16, LN>(a, wide, loop, ch, wsel, walk,
                                         threads, grid, s);
      break;
    case 2:
      if constexpr (DTYPES > 2)
        e = norm_launch<__half, LN>(a, wide, loop, ch, wsel, walk, threads,
                                    grid, s);
      break;
  }
  return static_cast<int>(e);
}

}  // namespace disc

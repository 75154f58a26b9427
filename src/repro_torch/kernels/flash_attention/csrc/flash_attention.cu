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
// (B, Hkv, Sk, hd) are read through their strides (unit stride along hd);
// every size, stride, lens and q_offset is a runtime argument, so a new
// length inside a bucket launches the library already built.  The head
// dim is a template constant (16, 64, 112 and 128 are instantiated: 16 is
// the reduced configs' head dim; at 16 and 112 a prefill thread owns 1
// and 7 output columns, read as scalars, and a decode lane 1 and 4
// columns, those past hd masked).  Each instance
// sets its dynamic shared memory on its first launch (at 112: ~101 KB
// prefill, ~62 KB decode, both above the 48 KB default).
//
// Two forms:
//
// * prefill_kernel: one block per (64-row q block, head, batch row),
//   256 threads, each owning 4 rows x 4 keys of the 64 x 64 score tile
//   and 4 rows x hd/16 columns of the output.  K blocks at or beyond
//   lens[b], or wholly above the causal diagonal, are never visited: the
//   key loop ends at min(lens[b], q_offset[b] + last row + 1).  That skip
//   is the point against the plain version, which scores every (q, k)
//   pair of the padded cache.
// * decode_kernel (Sq = 1): one block per (kv head, batch row), whose 8
//   warps are the query heads of that kv head's group, so each K/V block
//   is read from device memory once per group (the reference pads q to 8
//   rows of ONE head instead).  The next K/V block is loaded into
//   registers while the current one is scored.
//
// What bounds it on an H100.  Prefill at S = 2048 does ~2 * 2 * hd flops
// per (q, k) pair under the diagonal, ~64 per byte it must move:
// operations.  This version runs them as IEEE f32 FFMA on the CUDA cores
// for every input type (bf16 / f16 inputs are widened to f32 as they are
// staged into shared memory), so its ceiling is the 67 TFLOP/s FFMA rate,
// not the tensor cores'; mma / wgmma for bf16 is a later version's work.
// Decode reads each cached K/V byte once and does ~1 flop per byte:
// bytes.  Its grid is B x Hkv blocks (16 at B = 4 on TinyLlama), too few
// to pull the card's full memory rate; splitting the key range over
// blocks is a later version's work.
//
// Numerics follow the plain version: q is scaled by 1/sqrt(hd) (an f32
// multiply, as PyTorch divides by a scalar) before the dot, scores and
// probabilities stay f32 (P is never rounded to a 16-bit type), the
// products use fmaf (the library is built with --fmad=false), exp is
// expf and the output is acc / l, rounded once to the output type.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per prefill block
constexpr int BK = 64;          // keys per step
constexpr int NT = 256;         // threads per block, both forms
constexpr int DROWS = NT / 32;  // query heads per decode block (a warp each)
constexpr float NEG = -1e30f;

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
  int B, H, Hkv, Sq, Sk;
  int causal;
  float scale;  // 1 / sqrt(hd), applied to q before the dot
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
#pragma unroll 8
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

template <typename T, int HD>
__global__ void __launch_bounds__(NT) decode_kernel(Args a) {
  // output columns per lane: lane + 32 c for c < DJ, those below HD
  constexpr int DJ = (HD + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [DROWS][HD]  q rows, scaled
  float* Kt = Qs + DROWS * HD; // [HD][BK]
  float* Vs = Kt + HD * BK;    // [BK][HD]
  float* Ps = Vs + BK * HD;    // [DROWS][BK]

  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = a.H / a.Hkv;
  const int g0 = blockIdx.z * DROWS;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool row_ok = g0 + w < group;
  const int kv_len = valid_keys(a, b);

  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb;
  for (int i = threadIdx.x; i < DROWS * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    Qs[i] = g0 + r < group
                ? Elt<T>::one(Q + (long long)(hk * group + g0 + r) * a.q_sh +
                              d) * a.scale
                : 0.f;
  }
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  Tile<T, BK, HD> tk, tv;
  tk.template load<true>(K, a.k_ss, kv_len);
  tv.template load<false>(V, a.v_ss, kv_len);

  float o[DJ], m = NEG, l = 0.f;
#pragma unroll
  for (int c = 0; c < DJ; ++c) o[c] = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += BK) {
    __syncthreads();  // Qs written; the previous step is done with Kt, Vs
    tk.store_t(Kt, 1.f);
    tv.store_rm(Vs);
    __syncthreads();
    // the next block is in flight while this one is scored
    tk.template load<true>(K + (long long)(k0 + BK) * a.k_ss, a.k_ss,
                           kv_len - k0 - BK);
    tv.template load<false>(V + (long long)(k0 + BK) * a.v_ss, a.v_ss,
                            kv_len - k0 - BK);
    if (!row_ok) continue;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[w * HD + d];
      s0 = fmaf(qd, Kt[d * BK + lane], s0);
      s1 = fmaf(qd, Kt[d * BK + lane + 32], s1);
    }
    const bool ok0 = k0 + lane < kv_len, ok1 = k0 + lane + 32 < kv_len;
    float mx = fmaxf(ok0 ? s0 : NEG, ok1 ? s1 : NEG);
    mx = group_max<32>(mx);
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    const float p0 = ok0 ? expf(s0 - mn) : 0.f;
    const float p1 = ok1 ? expf(s1 - mn) : 0.f;
    l = alpha * l + group_sum<32>(p0 + p1);
    m = mn;
    Ps[w * BK + lane] = p0;
    Ps[w * BK + lane + 32] = p1;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < DJ; ++c) o[c] *= alpha;
    const int n_keys = min(BK, kv_len - k0);
    for (int kk = 0; kk < n_keys; ++kk) {
      const float p = Ps[w * BK + kk];
#pragma unroll
      for (int c = 0; c < DJ; ++c)
        if (lane + 32 * c < HD)
          o[c] = fmaf(p, Vs[kk * HD + lane + 32 * c], o[c]);
    }
    __syncwarp();
  }
  if (!row_ok) return;
  T* O = static_cast<T*>(a.o) + b * a.o_sb +
         (long long)(hk * group + g0 + w) * a.o_sh;
#pragma unroll
  for (int c = 0; c < DJ; ++c)
    if (lane + 32 * c < HD)
      O[lane + 32 * c] = Elt<T>::out(l == 0.f ? 0.f : __fdiv_rn(o[c], l));
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int decode, cudaStream_t stream) {
  if (decode) {
    const size_t smem = (DROWS * HD + 2 * HD * BK + DROWS * BK) * sizeof(float);
    static bool sized = false;
    if (!sized) {
      cudaError_t e = cudaFuncSetAttribute(
          decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
      sized = true;
    }
    const int group = a.H / a.Hkv;
    dim3 grid(a.Hkv, a.B, (group + DROWS - 1) / DROWS);
    decode_kernel<T, HD><<<grid, NT, smem, stream>>>(a);
  } else {
    const size_t smem =
        (HD * BQ + 2 * HD * BK + BQ * (BK + 4)) * sizeof(float);
    static bool sized = false;
    if (!sized) {
      cudaError_t e = cudaFuncSetAttribute(
          prefill_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
      sized = true;
    }
    dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    prefill_kernel<T, HD><<<grid, NT, smem, stream>>>(a);
  }
  return cudaGetLastError();
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

// dims: B H Hkv Sq Sk hd causal, then the (batch, head, position)
// strides of q, k, v and o, in elements.  dtype: 0 f32, 1 bf16, 2 f16.
// Returns the launch's cudaError_t (0 on success).
extern "C" int disc_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, const int* lens,
                                    const int* q_offset,
                                    const long long* dims, float scale,
                                    int dtype, int decode, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lens = lens;
  a.q_offset = q_offset;
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

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
// Design.  The TPU kernel's sequential chunk axis of the grid becomes a
// loop inside one block per (b, h) (blocks run in no order, so nothing
// carries between them): 256 threads, the state in shared memory.  Per
// chunk of L = 64 steps, with cum the cumulative log-decay of the chunk
// (padded steps add 0) and g = exp(cum):
//
//   S[t, s] = (C B^T)[t, s] exp(cum_t - cum_s)   (s <= t, else 0)
//   y       = diag(g) C h_prev + S X
//   h      <- g_last h_prev + (B o exp(cum_last - cum))^T X
//
// Each of the four 64 x 64 x 64 products gives every thread a 4 x 4
// tile of its output (rows (tid / 16) * 4, columns (tid % 16) * 4): the
// row operand is read as broadcast float4s (two distinct per warp), the
// column operand as consecutive float4s.  X and B are staged row-major,
// B and C transposed as well, so each product reads its operands along
// their stored rows.  Work beyond the chunk's valid steps is skipped,
// so a decode step (T = 1) costs one row of each product.
//
// What bounds it on an H100.  The recurrent form needs 4 N P flops per
// head and step (b x^T, a h + ., c^T h): at B = 1, T = 2048, H = 112,
// ~3.8 GFLOP, 0.056 ms at the 67 TFLOP/s f32 FFMA rate; it moves ~92 MB
// (x in bf16, y in f32, b, c, a), 0.027 ms at 3.35 TB/s: operations.
// The chunked form does about 2 x that work (the 4 products cost 4 L
// N P per chunk and head, half of S X masked), in exchange for products
// instead of a dependent chain per step.  This version is bound by
// neither: the grid is B * H blocks (112 at B = 1, on 132 SMs), and each
// product step is two shared-memory loads per 16 FFMAs.  Tensor cores
// (the products suit mma / wgmma in bf16) and sharing C B^T across the
// heads of a row are a later version's work.
//
// Numerics follow the plain chunked version (ref.py mamba2_chunked): log
// of max(a, 1e-37), a sequential cumulative sum, expf, f32 products with
// fmaf (the library is built with --fmad=false); y = g C h + S X.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 64;         // steps per chunk
constexpr int D = 64;         // N = P
constexpr int NT = 256;       // threads per block
constexpr int SLD = L + 4;    // padded row stride of the score tile

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int VEC = 4;  // elements per 16-byte chunk
  __device__ static float get(const uint4& c, int j) {
    return __uint_as_float(reinterpret_cast<const uint32_t*>(&c)[j]);
  }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float get(const uint4& c, int j) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(&c)[j >> 1];
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
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
  int B, H, T;
  long long x_sb, x_sh, x_st, a_sb, a_sh, a_st, b_sb, b_st, c_sb, c_st;
  long long y_sb, y_sh, y_st;
};

// Rows [0, n_rows) of an L x D slab (row stride ld elements) into shared
// memory as f32, rows >= n_rows as 0.  TR: dst[col][row] (row stride L),
// chunks numbered row-fastest so that a warp's stores hit consecutive
// words; otherwise dst[row][col] (row stride D), chunks part-fastest so
// that a warp's loads are coalesced.
template <typename T, bool TR>
__device__ __forceinline__ void stage(const T* src, long long ld,
                                      int n_rows, float* dst) {
  constexpr int VEC = Elt<T>::VEC;
  constexpr int PER_ROW = D / VEC;
  constexpr int CHUNKS = L * PER_ROW;
#pragma unroll
  for (int u = 0; u < CHUNKS / NT; ++u) {
    const int i = threadIdx.x + u * NT;
    const int row = TR ? i % L : i / PER_ROW;
    const int part = TR ? i / L : i % PER_ROW;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows)
      v = __ldg(reinterpret_cast<const uint4*>(src + row * ld + part * VEC));
    if (TR) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        dst[(part * VEC + j) * L + row] = Elt<T>::get(v, j);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(dst + row * D + part * VEC + j) =
            make_float4(Elt<T>::get(v, j), Elt<T>::get(v, j + 1),
                        Elt<T>::get(v, j + 2), Elt<T>::get(v, j + 3));
    }
  }
}

__device__ __forceinline__ void unpack(const float4& v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;              // [L][D]  x of the chunk (s, p)
  float* Bs = Xs + L * D;        // [L][D]  b of the chunk (s, n)
  float* Bt = Bs + L * D;        // [D][L]  b transposed (n, s)
  float* Ct = Bt + D * L;        // [D][L]  c transposed (n, t)
  float* Hs = Ct + D * L;        // [D][D]  the state (n, p)
  float* Sc = Hs + D * D;        // [L][SLD] masked scores (t, s)
  float* la = Sc + L * SLD;      // [L] log-decay of each step
  float* cum = la + L;           // [L] its cumulative sum
  float* g = cum + L;            // [L] exp(cum)
  float* de = g + L;             // [L] exp(cum_last - cum)

  const int h = blockIdx.x % p.H;
  const int b = blockIdx.x / p.H;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;       // output rows tr * 4 .. tr * 4 + 3
  const int tc = tid & 15;       // output columns tc * 4 .. tc * 4 + 3
  int n = p.lens ? p.lens[b] : p.T;
  n = max(0, min(n, p.T));

  const T* X = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* A = p.a + b * p.a_sb + h * p.a_sh;
  const T* Bg = static_cast<const T*>(p.b) + b * p.b_sb;
  const T* Cg = static_cast<const T*>(p.c) + b * p.c_sb;
  float* Y = p.y + b * p.y_sb + h * p.y_sh;
  const size_t sbase = (static_cast<size_t>(b) * p.H + h) * D * D;

  for (int i = tid; i < D * D; i += NT) Hs[i] = p.s0 ? p.s0[sbase + i] : 0.f;

  for (int c0 = 0; c0 < n; c0 += L) {
    const int steps = min(L, n - c0);
    __syncthreads();  // the previous chunk is done with every tile
    stage<T, false>(X + c0 * p.x_st, p.x_st, steps, Xs);
    stage<T, false>(Bg + c0 * p.b_st, p.b_st, steps, Bs);
    stage<T, true>(Bg + c0 * p.b_st, p.b_st, steps, Bt);
    stage<T, true>(Cg + c0 * p.c_st, p.c_st, steps, Ct);
    if (tid < L)
      la[tid] = tid < steps ? logf(fmaxf(A[(c0 + tid) * p.a_st], 1e-37f))
                            : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int s = 0; s < L; ++s) {
        run += la[s];
        cum[s] = run;
      }
    }
    __syncthreads();
    if (tid < L) {
      g[tid] = expf(cum[tid]);
      de[tid] = expf(cum[L - 1] - cum[tid]);
    }

    // S = (C B^T) o L: the tiles on or below the diagonal
    if (tc <= tr && tr * 4 < steps) {
      float acc[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < D; ++k) {
        float cv[4], bv[4];
        unpack(*reinterpret_cast<const float4*>(Ct + k * L + tr * 4), cv);
        unpack(*reinterpret_cast<const float4*>(Bt + k * L + tc * 4), bv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tr * 4 + i;
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tc * 4 + j;
          o[j] = t >= s ? acc[i][j] * expf(cum[t] - cum[s]) : 0.f;
        }
        *reinterpret_cast<float4*>(Sc + t * SLD + tc * 4) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();  // S, g and de are ready

    // y = diag(g) C h_prev + S X, for the chunk's valid rows
    if (tr * 4 < steps) {
      float inter[4][4] = {}, intra[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < D; ++k) {
        float cv[4], hv[4];
        unpack(*reinterpret_cast<const float4*>(Ct + k * L + tr * 4), cv);
        unpack(*reinterpret_cast<const float4*>(Hs + k * D + tc * 4), hv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            inter[i][j] = fmaf(cv[i], hv[j], inter[i][j]);
      }
      const int s_end = min(steps, tr * 4 + 4);
      for (int s = 0; s < s_end; ++s) {
        float xv[4];
        unpack(*reinterpret_cast<const float4*>(Xs + s * D + tc * 4), xv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sv = Sc[(tr * 4 + i) * SLD + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) intra[i][j] = fmaf(sv, xv[j], intra[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tr * 4 + i;
        if (t >= steps) break;
        const float gt = g[t];
        *reinterpret_cast<float4*>(Y + (c0 + t) * p.y_st + tc * 4) =
            make_float4(gt * inter[i][0] + intra[i][0],
                        gt * inter[i][1] + intra[i][1],
                        gt * inter[i][2] + intra[i][2],
                        gt * inter[i][3] + intra[i][3]);
      }
    }
    __syncthreads();  // every read of h_prev is done

    // h <- g_last h_prev + (B o exp(cum_last - cum))^T X
    {
      float acc[4][4] = {};
      for (int s = 0; s < steps; ++s) {
        float bv[4], xv[4];
        unpack(*reinterpret_cast<const float4*>(Bs + s * D + tr * 4), bv);
        unpack(*reinterpret_cast<const float4*>(Xs + s * D + tc * 4), xv);
        const float d = de[s];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bd = bv[i] * d;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bd, xv[j], acc[i][j]);
        }
      }
      const float gl = g[L - 1];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hp = Hs + (tr * 4 + i) * D + tc * 4 + j;
          *hp = gl * *hp + acc[i][j];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < D * D; i += NT) p.s1[sbase + i] = Hs[i];
  // steps past n_b: y = 0, state untouched
  for (int i = tid; i < (p.T - n) * (D / 4); i += NT) {
    const int t = n + i / (D / 4);
    *reinterpret_cast<float4*>(Y + t * p.y_st + (i % (D / 4)) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

constexpr size_t kSmemBytes =
    (5 * L * D + L * SLD + 4 * L) * sizeof(float);

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const long long blocks = static_cast<long long>(a.B) * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_kernel<T><<<static_cast<unsigned>(blocks), NT, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dims: B H T N P, then the (batch, head, step) strides of x and a, the
// (batch, step) strides of b and c, and the (batch, head, step) strides
// of y, in elements.  dtype (of x, b and c): 0 f32, 1 bf16.  s0 and lens
// may be null.  Returns the launch's cudaError_t (0 on success).
extern "C" int disc_mamba2(const void* x, const float* a, const void* b,
                           const void* c, const float* s0, float* s1,
                           float* y, const int* lens, const long long* dims,
                           int dtype, void* stream) {
  Args p;
  p.x = x;
  p.a = a;
  p.b = b;
  p.c = c;
  p.s0 = s0;
  p.s1 = s1;
  p.y = y;
  p.lens = lens;
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
  if (p.B == 0 || p.H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(p, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* disc_mamba2_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

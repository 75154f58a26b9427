// RWKV-6 (Finch) WKV recurrence for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel rwkv6_kernel
// (kernels/rwkv6/rwkv6.py:60) and, on the model path, the jnp recurrence
// of models/layers.py rwkv6_apply (its decode einsums and _wkv_scan).
// Per (batch row b, head h), with the state S (N x N, f32):
//
//   y_t = r_t . (S + diag(u) k_t v_t^T)       (a V-vector)
//   S  <- diag(w_t) S + k_t v_t^T
//
// for t < n_b = min(lens[b], T); the TPU kernel is the case of a zero
// initial state and lens = T.  Extended for the serve path:
//
// * an optional initial state s0 (B, H, N, N) (null: zeros), so a
//   prompt continues from the cache's state (chunked prefill, decode);
// * the final state s1 (B, H, N, N), written for every row (a row with
//   lens = 0 gets s0 back bit for bit);
// * per-row lens (B,) int32 on the device (null: T): steps t >= n_b
//   leave the state alone and write y = 0, so padded chunk positions and
//   padded batch rows never touch it;
// * T and every stride are runtime arguments: a new length inside a
//   bucket launches the library already built.  N (= K = V, the head
//   size) is a template constant (16 and 64 are instantiated).
//
// r, k, v (B, H, T, N) and y are read and written through their (b, h,
// t) strides with a unit stride along N, so the model's token-major
// projections are read in place; w (the decay, in (0, 1)) is f32, u
// (H, N) f32.
//
// Design.  The T axis is a sequential loop inside the block (the TPU
// kernel's sequential grid axis): blocks run in no order, so nothing
// carries between them.  A block owns VS = 32 columns of one (b, h)
// state (N / VS blocks per head); each column is split over KG = 4
// lanes of a warp, which hold rows k = j * KG + g of that column in
// registers (N / 4 floats each).  Per step a lane forms its part of
// y_t[v] as a dot over its rows and updates them with one fmaf each; the
// four parts meet by two warp shuffles, so a step needs no
// __syncthreads.  r, k, w and v of 16 steps are staged in shared memory
// (as f32), the next chunk's global loads are issued into registers
// before the current chunk is computed, and y is staged per chunk and
// written row by row.
//
// What bounds it on an H100.  At T = 2048, B = 1, H = 40, N = 64 the
// function moves ~64 MB (r, k, v, y in bf16, w in f32; 0.019 ms at
// 3.35 TB/s) and does ~2.3 GFLOP in f32 (7 flops per state element per
// step: k*v, u*kv + s, r*tmp + y, w*s + kv), 0.035 ms at the 67 TFLOP/s
// FFMA rate: operations.  In f32 the bonus factors out, y_t = r_t . S +
// (sum_k r_k u_k k_k) v_t, so the function needs 5 flops per element and
// step (r*s + y, k*v, w*s + kv): ~1.7 GFLOP, 0.025 ms, under the ~105 MB
// of f32 inputs and outputs (0.032 ms): bytes.  Only bf16 needs all 7,
// because it rounds k*v per element.  This version is bound by neither: the grid
// is B * H * N / 32 blocks of 128 threads (80 at B = 1, on 132 SMs), one
// block per SM, and each step is a chain of shared-memory loads, FFMAs
// and two shuffles that four warps cannot hide.  The occupancy is the
// next version's problem: the tensor-core chunked form
// (models/layers.py _wkv_chunked) turns the recurrence into matrix
// products over chunks of steps.
//
// Numerics follow the plain version (ref.py): kv = k * v is rounded to
// the input type (a no-op in f32; in bf16 it mirrors the model's decode
// step, which forms kv in the activation dtype), then
// tmp = fmaf(u, kv, s), y += r * tmp, s = fmaf(w, s, kv) in f32, and y
// is rounded once to the input type.  The library is built with
// --fmad=false, so every fused multiply-add here is an explicit fmaf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 16;  // steps per staged chunk
constexpr int KG = 4;   // lanes that share one state column

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  __device__ static float ld(const float* p) { return *p; }
  __device__ static float st(float x) { return x; }
  __device__ static float round(float x) { return x; }
};

template <>
struct Elt<__nv_bfloat16> {
  __device__ static float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static __nv_bfloat16 st(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  float* s1;
  void* y;
  const int* lens;
  int B, H, T;
  long long r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long w_sb, w_sh, w_st, y_sb, y_sh, y_st;
};

template <int N>
struct Shape {
  static constexpr int WARPS = N / 8 < 4 ? N / 8 : 4;
  static constexpr int NT = WARPS * 32;     // threads per block
  static constexpr int VS = WARPS * 8;      // state columns per block
  static constexpr int SLICES = N / VS;     // blocks per (b, h)
  static constexpr int KP = N / KG;         // state rows per lane
  static constexpr int PK = TC * N / NT;    // staged r/k/w values per thread
  static constexpr int PV = TC * VS / NT;   // staged v values per thread
};

template <typename T, int N>
__global__ void __launch_bounds__(Shape<N>::NT)
    wkv_kernel(const Args a) {
  using S = Shape<N>;
  __shared__ float sr[TC][N];
  __shared__ float sk[TC][N];
  __shared__ float sw[TC][N];
  __shared__ float sv[TC][S::VS];
  __shared__ float sy[TC][S::VS];

  const int slice = blockIdx.x % S::SLICES;
  const int bh = blockIdx.x / S::SLICES;
  const int h = bh % a.H;
  const int b = bh / a.H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 3;                       // row group of this lane
  const int cl = (tid >> 5) * 8 + (lane & 7);    // column within the slice
  const int col = slice * S::VS + cl;            // column of the state
  int n = a.lens ? a.lens[b] : a.T;
  n = max(0, min(n, a.T));

  const T* r = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh +
               slice * S::VS;
  const float* w = a.w + b * a.w_sb + h * a.w_sh;
  T* y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + slice * S::VS;
  const size_t sbase = (static_cast<size_t>(b) * a.H + h) * N * N;

  float s[S::KP], u[S::KP];
#pragma unroll
  for (int j = 0; j < S::KP; ++j) {
    const int row = j * KG + g;
    s[j] = a.s0 ? a.s0[sbase + row * N + col] : 0.f;
    u[j] = a.u[h * N + row];
  }

  float pr[S::PK], pk[S::PK], pw[S::PK], pv[S::PV];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < S::PK; ++i) {
      const int idx = tid + i * S::NT;
      const int t = t0 + idx / N;
      const int kk = idx % N;
      const bool ok = t < n;
      pr[i] = ok ? Elt<T>::ld(r + t * a.r_st + kk) : 0.f;
      pk[i] = ok ? Elt<T>::ld(k + t * a.k_st + kk) : 0.f;
      pw[i] = ok ? w[t * a.w_st + kk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < S::PV; ++i) {
      const int idx = tid + i * S::NT;
      const int t = t0 + idx / S::VS;
      pv[i] = t < n ? Elt<T>::ld(v + t * a.v_st + idx % S::VS) : 0.f;
    }
  };

  if (n > 0) fetch(0);
  for (int t0 = 0; t0 < n; t0 += TC) {
    __syncthreads();  // the previous chunk is computed and written out
#pragma unroll
    for (int i = 0; i < S::PK; ++i) {
      const int idx = tid + i * S::NT;
      sr[idx / N][idx % N] = pr[i];
      sk[idx / N][idx % N] = pk[i];
      sw[idx / N][idx % N] = pw[i];
    }
#pragma unroll
    for (int i = 0; i < S::PV; ++i) {
      const int idx = tid + i * S::NT;
      sv[idx / S::VS][idx % S::VS] = pv[i];
    }
    __syncthreads();
    if (t0 + TC < n) fetch(t0 + TC);  // in flight while this chunk runs
    const int steps = min(TC, n - t0);
#pragma unroll 2
    for (int tt = 0; tt < steps; ++tt) {
      const float vv = sv[tt][cl];
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int j = 0; j < S::KP; ++j) {
        const int row = j * KG + g;
        const float kv = Elt<T>::round(sk[tt][row] * vv);
        const float tmp = fmaf(u[j], kv, s[j]);
        if (j & 1)
          y1 = fmaf(sr[tt][row], tmp, y1);
        else
          y0 = fmaf(sr[tt][row], tmp, y0);
        s[j] = fmaf(sw[tt][row], s[j], kv);
      }
      float yv = y0 + y1;
      yv += __shfl_xor_sync(0xffffffffu, yv, 8);
      yv += __shfl_xor_sync(0xffffffffu, yv, 16);
      if (g == 0) sy[tt][cl] = yv;
    }
    __syncthreads();
    for (int i = tid; i < steps * S::VS; i += S::NT) {
      const int tt = i / S::VS;
      y[(t0 + tt) * a.y_st + i % S::VS] = Elt<T>::st(sy[tt][i % S::VS]);
    }
  }
  // steps past n_b: y = 0, state untouched
  for (int i = tid; i < (a.T - n) * S::VS; i += S::NT) {
    y[(n + i / S::VS) * a.y_st + i % S::VS] = Elt<T>::st(0.f);
  }
#pragma unroll
  for (int j = 0; j < S::KP; ++j) {
    a.s1[sbase + (j * KG + g) * N + col] = s[j];
  }
}

template <typename T, int N>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using S = Shape<N>;
  const long long blocks = static_cast<long long>(a.B) * a.H * S::SLICES;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wkv_kernel<T, N><<<static_cast<unsigned>(blocks), S::NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const Args& a, int n, cudaStream_t stream) {
  switch (n) {
    case 16: return launch<T, 16>(a, stream);
    case 64: return launch<T, 64>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dims: B H T N, then the (batch, head, step) strides of r, k, v, w and
// y, in elements.  dtype (of r, k, v and y): 0 f32, 1 bf16.
// s0 and lens may be null.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int disc_rwkv6(const void* r, const void* k, const void* v,
                          const float* w, const float* u, const float* s0,
                          float* s1, void* y, const int* lens,
                          const long long* dims, int dtype, void* stream) {
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = w;
  a.u = u;
  a.s0 = s0;
  a.s1 = s1;
  a.y = y;
  a.lens = lens;
  a.B = static_cast<int>(dims[0]);
  a.H = static_cast<int>(dims[1]);
  a.T = static_cast<int>(dims[2]);
  const int n = static_cast<int>(dims[3]);
  a.r_sb = dims[4];
  a.r_sh = dims[5];
  a.r_st = dims[6];
  a.k_sb = dims[7];
  a.k_sh = dims[8];
  a.k_st = dims[9];
  a.v_sb = dims[10];
  a.v_sh = dims[11];
  a.v_st = dims[12];
  a.w_sb = dims[13];
  a.w_sh = dims[14];
  a.w_st = dims[15];
  a.y_sb = dims[16];
  a.y_sh = dims[17];
  a.y_st = dims[18];
  if (a.B == 0 || a.H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_n<float>(a, n, s));
    case 1: return static_cast<int>(launch_n<__nv_bfloat16>(a, n, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* disc_rwkv6_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

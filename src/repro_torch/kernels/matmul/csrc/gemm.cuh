// Blocked GEMM with a generated elementwise epilogue, for sm_90a.
//
// C = A(M, K) . B(K, N) with an f32 accumulator, then, per output
// element, a fused epilogue functor (generated per fusion-cluster program
// by repro_torch/kernels/matmul/matmul.py) that reads the accumulator and
// any (M, N) extras and stores every output of the cluster.
//
// Replaces the JAX package's Pallas TPU kernels matmul_kernel
// (kernels/matmul/matmul.py:54) and matmul_epilogue_kernel (:116).
//
// What bounds it on an H100: operations.  At the path's shapes (T x 2048
// x 5632 and T x 5632 x 2048) each A and B element is reused by hundreds
// of outputs, far above the card's ~295 flop/byte balance point, so the
// design feeds the arithmetic units from registers and moves each operand
// byte from device memory about once per 128-wide output tile.  Two
// bodies share the contract below: gemm_kernel, f32 FFMA for f32
// operands, and gemm_mma_kernel (further down), tensor-core mma.sync for
// bf16 / f16 operands.  gemm_kernel:
//
// * a BM x BN output tile per block, TM x TN outputs per thread held in
//   registers (128 x 128 and 8 x 8 for the kDot instance: 64 FMAs per
//   four 16-byte shared-memory loads), capped at 128 registers so that
//   two 256-thread blocks share an SM (uncapped, ptxas took 154 and one
//   block fit; the cap cost a few bytes of spills and took the kDot GEMM
//   at 1999 x 5632 x 2048 from 2.26 ms to 1.61 ms on an H100 80GB HBM3
//   at 700 W, PERF.md);
// * A and B tiles of depth BK staged through registers into two
//   shared-memory buffers: the global loads of step k+1 are in flight
//   while step k computes, one __syncthreads per step;
// * A is stored transposed (k-major) with 4 floats of padding per row, so
//   the transposing stores do not collide on banks and every thread reads
//   its TM rows as aligned float4s; a thread's rows and columns come in
//   groups of 4 spread 4*(BM/TM) apart, which keeps the float4 reads of a
//   quarter-warp on distinct banks.
//
// Numerics.  f32: true f32 FFMA (fmaf) on f32 operands -- never TF32 --
// as the reference contracts f32 operands in f32.  bf16 / f16: the
// operands are read in their own type and multiplied on the tensor cores
// (mma.sync.m16n8k16) into an f32 accumulator: the products of 16-bit
// values are exact, so this is the reference's f32 contraction of bf16
// operands up to the order of the f32 sums.  wgmma and TMA, the way to
// the card's full tensor-core rate, are a later version's work.
//
// Lengths are runtime ints, never template constants: M, N, K, the valid
// extents vm <= M, vn <= N, vk <= K and the strides.  Loads beyond the
// valid extents are masked to zero on BOTH operands (so padded-bucket
// garbage never enters the contraction, and no padded copy is needed);
// the K loop stops at vk; blocks entirely outside (vm, vn) skip the loop.
// Outputs at m >= vm or n >= vn are stored as exact zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace disc {

struct GemmArgs {
  int M, N, K;      // padded sizes (array extents)
  int vm, vn, vk;   // valid sizes, runtime
  long long sam, sak, sbk, sbn;  // element strides of A (M, K), B (K, N)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// a float value rounded to the precision of storage type T, back in f32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_f16(float x) {
  return __half2float(__float2half_rn(x));
}

// NaN-propagating max / min, as torch.maximum / torch.minimum
template <typename T>
__device__ __forceinline__ T disc_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T disc_min(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

template <int BM, int BN, int BK, int TM, int TN>
struct Tile {
  static constexpr int TX = BN / TN;  // threads along N
  static constexpr int TY = BM / TM;  // threads along M
  static constexpr int THREADS = TX * TY;
  static constexpr int A_PER = BM * BK / THREADS;  // A loads per thread
  static constexpr int B_PER = BK * BN / THREADS;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "TM, TN: multiples of 4");
  static_assert(BM % TM == 0 && BN % TN == 0, "tile / thread shape");
  static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0,
                "every thread stages the same number of elements");
  static_assert(THREADS <= 1024, "threads per block");
};

template <int BM, int BN, int BK, int TM, int TN, typename T, typename Epi>
__global__ void __launch_bounds__(Tile<BM, BN, BK, TM, TN>::THREADS, 2)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, GemmArgs g,
            Epi epi) {
  static_assert(sizeof(T) == 4, "f32 operands; 16-bit ones take the "
                                "tensor-core body");
  using Cfg = Tile<BM, BN, BK, TM, TN>;
  constexpr int TX = Cfg::TX, TY = Cfg::TY, THREADS = Cfg::THREADS;
  constexpr int AP = BM + 4;  // padded row of the k-major A tile
  __shared__ __align__(16) float As[2][BK][AP];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kend = (m0 < g.vm && n0 < g.vn) ? g.vk : 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  float ra[Cfg::A_PER], rb[Cfg::B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Cfg::A_PER; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      ra[i] = (gm < g.vm && gk < g.vk)
                  ? to_f32(A[gm * g.sam + gk * g.sak]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < Cfg::B_PER; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      rb[i] = (gk < g.vk && gn < g.vn)
                  ? to_f32(B[gk * g.sbk + gn * g.sbn]) : 0.0f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < Cfg::A_PER; ++i) {
      const int e = tid + i * THREADS;
      As[buf][e % BK][e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < Cfg::B_PER; ++i) {
      const int e = tid + i * THREADS;
      Bs[buf][e / BN][e % BN] = rb[i];
    }
  };

  if (kend > 0) {
    load(0);
    stage(0);
  }
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    const bool more = k0 + BK < kend;
    if (more) load(k0 + BK);  // in flight while this step computes
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[buf][k][(q * TY + ty) * 4]);
        a[q * 4 + 0] = v.x; a[q * 4 + 1] = v.y;
        a[q * 4 + 2] = v.z; a[q * 4 + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[buf][k][(q * TX + tx) * 4]);
        b[q * 4 + 0] = v.x; b[q * 4 + 1] = v.y;
        b[q * 4 + 2] = v.z; b[q * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ((i / 4) * TY + ty) * 4 + i % 4;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + ((j / 4) * TX + tx) * 4 + j % 4;
      if (n < g.N) epi(m, n, acc[i][j], m < g.vm && n < g.vn);
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN, typename T, typename Epi>
cudaError_t launch_gemm(const T* A, const T* B, const GemmArgs& g,
                        const Epi& epi, cudaStream_t stream) {
  using Cfg = Tile<BM, BN, BK, TM, TN>;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  gemm_kernel<BM, BN, BK, TM, TN, T, Epi>
      <<<grid, Cfg::THREADS, 0, stream>>>(A, B, g, epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// Tensor-core version for bf16 / f16 operands.
//
// The same contract (runtime lengths, both operands' K tails masked,
// zero M/N tails, the generated epilogue) on mma.sync.m16n8k16 with an
// f32 accumulator: 8 warps per block as 2 (M) x 4 (N), each warp a
// (BM/2) x (BN/4) tile of 16 x 8 MMA tiles held in registers.  The A tile
// is kept k-contiguous and B n-contiguous in shared memory (rows padded by
// 8 halves, so ldmatrix reads them without bank conflicts); ldmatrix
// gathers the A fragments, ldmatrix.trans the column-major B fragments.
// Global loads are 16-byte vectors where the contiguous stride is 1, the
// address is aligned and all 8 elements are valid, element loads with
// masks at the edges; they are staged through registers into two
// shared-memory buffers, one __syncthreads per K step of 32.

__device__ __forceinline__ uint4 pack8(const unsigned short (&h)[8]) {
  uint4 v;
  v.x = h[0] | (unsigned(h[1]) << 16);
  v.y = h[2] | (unsigned(h[3]) << 16);
  v.z = h[4] | (unsigned(h[5]) << 16);
  v.w = h[6] | (unsigned(h[7]) << 16);
  return v;
}

// 8 consecutive elements along the contiguous axis of an operand, from
// (row, col) on: the element at offset j is valid iff row_ok and
// col + j < col_end; invalid ones read as zero
__device__ __forceinline__ uint4 load8(const unsigned short* base,
                                       long long srow, long long scol,
                                       int row, int col, bool row_ok,
                                       int col_end, bool unit) {
  if (row_ok && unit && col + 8 <= col_end) {
    const unsigned short* p = base + row * srow + col;
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0)
      return *reinterpret_cast<const uint4*>(p);
  }
  unsigned short h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    h[j] = (row_ok && col + j < col_end) ? base[row * srow + (col + j) * scol]
                                         : (unsigned short)0;
  return pack8(h);
}

template <int BM, int BN, typename T, typename Epi>
__global__ void __launch_bounds__(256)
gemm_mma_kernel(const T* __restrict__ A_, const T* __restrict__ B_,
                GemmArgs g, Epi epi) {
  constexpr int BK = 32, THREADS = 256;
  constexpr int WM = BM / 2, WN = BN / 4;  // warp tile
  constexpr int MT = WM / 16, NT = WN / 8;  // MMA tiles per warp
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile of 16 x 8 tiles");
  constexpr int AS = BK + 8, BS = BN + 8;  // padded rows, in halves
  constexpr int A_CH = BM * BK / 8, B_CH = BK * BN / 8;  // 16-byte chunks
  constexpr int A_PER = (A_CH + THREADS - 1) / THREADS;
  constexpr int B_PER = (B_CH + THREADS - 1) / THREADS;
  __shared__ __align__(16) unsigned short As[2][BM][AS];
  __shared__ __align__(16) unsigned short Bs[2][BK][BS];

  const unsigned short* A = reinterpret_cast<const unsigned short*>(A_);
  const unsigned short* B = reinterpret_cast<const unsigned short*>(B_);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / 4) * WM, wn0 = (warp % 4) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kend = (m0 < g.vm && n0 < g.vn) ? g.vk : 0;
  const bool a_unit = g.sak == 1, b_unit = g.sbn == 1;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  uint4 ra[A_PER], rb[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * THREADS;
      if (A_CH % THREADS == 0 || e < A_CH) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        ra[i] = load8(A, g.sam, g.sak, m0 + r, k0 + c, m0 + r < g.vm, g.vk,
                      a_unit);
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * THREADS;
      if (B_CH % THREADS == 0 || e < B_CH) {
        const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
        rb[i] = load8(B, g.sbk, g.sbn, k0 + r, n0 + c, k0 + r < g.vk, g.vn,
                      b_unit);
      }
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * THREADS;
      if (A_CH % THREADS == 0 || e < A_CH)
        *reinterpret_cast<uint4*>(&As[buf][e / (BK / 8)][(e % (BK / 8)) * 8]) =
            ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * THREADS;
      if (B_CH % THREADS == 0 || e < B_CH)
        *reinterpret_cast<uint4*>(&Bs[buf][e / (BN / 8)][(e % (BN / 8)) * 8]) =
            rb[i];
    }
  };

  if (kend > 0) {
    load(0);
    stage(0);
  }
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    const bool more = k0 + BK < kend;
    if (more) load(k0 + BK);  // in flight while this step computes
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], &As[buf][wm0 + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
      const int brow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int j = 0; j + 1 < NT; j += 2) {
        unsigned r[4];
        ldsm_x4_t(r, &Bs[buf][brow][wn0 + (j + (lane >> 4)) * 8]);
        bf[j][0] = r[0]; bf[j][1] = r[1];
        bf[j + 1][0] = r[2]; bf[j + 1][1] = r[3];
      }
      if (NT % 2) {
        unsigned r[2];
        ldsm_x2_t(r, &Bs[buf][brow][wn0 + (NT - 1) * 8]);
        bf[NT - 1][0] = r[0]; bf[NT - 1][1] = r[1];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma16816<T>(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + i * 16 + (lane >> 2) + h * 8;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn0 + j * 8 + (lane & 3) * 2 + c;
          if (n < g.N) epi(m, n, acc[i][j][h * 2 + c], m < g.vm && n < g.vn);
        }
    }
}

template <int BM, int BN, typename T, typename Epi>
cudaError_t launch_gemm_mma(const T* A, const T* B, const GemmArgs& g,
                            const Epi& epi, cudaStream_t stream) {
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  gemm_mma_kernel<BM, BN, T, Epi><<<grid, 256, 0, stream>>>(A, B, g, epi);
  return cudaGetLastError();
}

}  // namespace disc

extern "C" const char* disc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// of outputs, far above the card's ~295 flop/byte balance point.  Two
// bodies share the contract below:
//
// * gemm_wgmma_kernel, bf16 / f16 operands: Hopper's warpgroup MMA fed
//   by the Tensor Memory Accelerator.  A 128 x BN output tile per block
//   (BN = 256, 128 or 64), K steps of 64 (128 bytes of 16-bit values:
//   the 128-byte swizzle atom), a ring of STAGES shared-memory stages.
//   One producer thread issues the 2-D TMA loads of each stage (A as one
//   128 x 64 box, B as BN / 64 boxes of 64 x 64) against a "full"
//   mbarrier; two consumer warpgroups, each 64 rows of the tile, wait for
//   it and issue wgmma.mma_async m64nBNk16 (A K-major, B N-major read
//   through the transposed-B descriptor) into f32 accumulators in
//   registers, keep one wgmma group in flight, and release a stage on its
//   "empty" mbarrier once the group that read it has retired.  setmaxnreg
//   moves registers from the producer warpgroup (40) to the consumers
//   (232: BN / 2 accumulators a thread).  The loads cost the consumers no
//   registers or instructions, and no __syncthreads runs after the
//   set-up.  The epilogue passes the f32 tile through the ring, row-major,
//   and walks it row by row (coalesced extras and outputs) in batches
//   whose extras' loads come first and whose arithmetic has no branch.
//   Measured no faster on the path's shapes, and so not kept (PERF.md):
//   a persistent block an SM; a cluster of two blocks sharing each B
//   tile by TMA multicast; epilogue warps that run one tile's epilogue
//   under the next tile's K loop.
// * gemm_kernel, f32 operands: IEEE f32 FFMA (fmaf, never TF32, as the
//   reference contracts f32 operands in f32) on the CUDA cores, bounded
//   by FFMA issue: 67 TFLOP/s at the boost clock, 128 FFMA an SM a
//   cycle.  Shared memory returns 128 bytes an SM a cycle, so a thread
//   tile of 8 x 8 outputs (16 floats loaded per 64 FFMA) would need all
//   of it at the FFMA peak; the kDot tile takes 8 x 16 a thread (24 per
//   128, 75 %) in 32 x 128 warp tiles of a 128 x 256 block, one block an
//   SM with up to 255 registers.  Everything but the FFMAs is cut down to
//   leave them the issue slots.  Operands move 16 bytes a thread: B
//   (N-contiguous) by cp.async straight into a ring of STAGES
//   shared-memory stages, A (K-contiguous) one step ahead through
//   registers (LDG.128, in flight during a step's FFMAs) into a k-major
//   tile whose 4-float m-chunks are XOR-swizzled by k, so the transposing
//   stores hit distinct banks.  K steps of 32 and one __syncthreads a
//   step, placed before the step's last depth so that the next step's
//   first fragments load while that depth's FFMAs issue.  A block whose
//   tile lies inside (vm, vn) loads its full K steps without a bounds
//   check; edge blocks and the K tail load masked, with zeros.  A warp's
//   lanes are 4 x 8 and a thread's outputs groups of 4 x 4, so the
//   fragments are 16-byte shared loads of a few distinct chunks,
//   broadcast, and each depth's load while the previous depth's FFMAs
//   issue.  The launch bound caps the registers so that MINB blocks share
//   an SM (gemm_plan's split-K counts on MINB).  Tiles and the variants
//   measured and not kept: matmul.py TILES, tune.py, PERF.md.  The epilogue passes the
//   f32 tile through the freed ring and walks it row by row, as the wgmma
//   body does; split-K partials leave 16 bytes at a time.  Operands that
//   the 16-byte loads cannot read in place (a start off 16 bytes, a row
//   stride that is no multiple of 4 floats, a transposed view) take the
//   element-by-element instance of the same kernel (VEC = false): the
//   same tiles, filled one element at a time.
//
// Split-K.  Where the output tiles leave SMs idle (the small §4.5
// shapes, path 2's small buckets) the wrapper cuts K into `splits`
// ranges of `kchunk` (a multiple of BK) and launches a grid of
// (N tiles, M tiles, splits): each block writes its f32 partial tile to a
// workspace (splits, M, N), and gemm_finish_kernel sums the splits in a
// fixed order and applies the same epilogue and tails.  No atomics, so
// two launches give the same bits.
//
// Numerics.  bf16 / f16: the products of 16-bit values are exact and the
// accumulator is f32, so this is the reference's f32 contraction of the
// 16-bit operands up to the order of the f32 sums.  The epilogue functor
// is called on every accumulator element with its (m, n).
//
// Lengths are runtime ints, never template constants: M, N, K, the valid
// extents vm <= M, vn <= N, vk <= K, the strides and the split.  Nothing
// beyond the valid extents enters the contraction: the wgmma body's
// tensor maps are encoded on every call over the VALID (vk, vm) of A and
// (vn, vk) of B, with the padded row strides, so TMA fills the K tail of
// both operands and the M / N edge with zeros; the FFMA body masks the
// loads of its edge blocks and K tail.  Blocks entirely outside (vm, vn)
// skip the K loop.  Outputs at m >= vm or n >= vn are stored as exact
// zeros.  vm, vn or vk = 0 (no tensor map may have an extent of 0) runs
// the epilogue alone over a zero accumulator.  Both bodies read A with
// unit stride along K and B with unit stride along N, 16-byte aligned
// with row strides that are multiples of 16 bytes, where the wrapper
// lets them: it copies other 16-bit layouts first, and runs other f32
// layouts on the FFMA body's element-by-element instance.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "tma_sm90.cuh"

namespace disc {

struct GemmArgs {
  int M, N, K;      // padded sizes (array extents)
  int vm, vn, vk;   // valid sizes, runtime
  long long sam, sak, sbk, sbn;  // element strides of A (M, K), B (K, N)
  int splits;       // K ranges (split-K); 1: the epilogue runs in the GEMM
  int kchunk;       // K elements per range, a multiple of the body's BK
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

// ------------------------------------------------------------ split-K --

// Sums the splits' f32 partial tiles (workspace (splits, M, N), written
// only where m < vm and n < vn) in split order and applies the epilogue
// to every (m, n) of (M, N); splits = 0 runs it over a zero accumulator.
template <typename Epi>
__global__ void __launch_bounds__(256)
gemm_finish_kernel(const float* __restrict__ ws, GemmArgs g, int splits,
                   Epi epi) {
  const long long total = static_cast<long long>(g.M) * g.N;
  const long long plane = total;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    const int m = static_cast<int>(i / g.N), n = static_cast<int>(i % g.N);
    const bool keep = m < g.vm && n < g.vn;
    float acc = 0.0f;
    if (keep)
      for (int z = 0; z < splits; ++z) acc += ws[z * plane + i];
    epi(m, n, acc, keep);
  }
}

template <typename Epi>
cudaError_t launch_finish(const float* ws, const GemmArgs& g, int splits,
                          const Epi& epi, cudaStream_t stream) {
  const long long total = static_cast<long long>(g.M) * g.N;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  gemm_finish_kernel<Epi><<<blocks, 256, 0, stream>>>(ws, g, splits, epi);
  return cudaGetLastError();
}

// ----------------------------------------------- the tile's epilogue --

// The epilogue of a BM x BN f32 tile held in shared memory (row-major,
// ld floats a row) at corner (m0, n0), by the THREADS threads of which
// this is thread t: thread t takes column t % BN of every THREADS / BN-th
// row, so a warp's extras' loads and outputs' stores are coalesced and
// each thread's addresses step by whole rows.  A loop that is not
// unrolled (unrolled over a tile's elements, a generated epilogue outgrew
// the instruction cache: PERF.md); each step loads a batch of G
// elements' extras first, then computes all G without a branch and
// stores each under a predicate.
template <int BM, int BN, int THREADS, int G, typename Epi>
__device__ __forceinline__ void tile_epilogue(const float* tile, int ld,
                                              int m0, int n0, int t,
                                              const GemmArgs& g,
                                              const Epi& epi) {
  constexpr int RSTEP = THREADS / BN;  // rows a pass of the threads covers
  static_assert(THREADS % BN == 0 && BM % (G * RSTEP) == 0, "tile walk");
  const int cc = t % BN, n = n0 + cc;
#pragma unroll 1
  for (int r0 = t / BN; r0 < BM; r0 += G * RSTEP) {
    typename Epi::In in[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int m = m0 + r0 + j * RSTEP;
      const bool keep = m < g.vm && n < g.vn;
      in[j] = keep ? epi.load(m, n) : typename Epi::In{};
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int r = r0 + j * RSTEP, m = m0 + r;
      epi.apply(m, n, tile[r * ld + cc], m < g.vm && n < g.vn,
                m < g.M && n < g.N, in[j]);
    }
  }
}

// --------------------------------------------------------- f32: FFMA --

// cp.async of 16 (4) bytes from device to shared memory that reads the
// first `bytes` of them and writes zeros for the rest (bytes = 0: reads
// nothing).  16-byte copies bypass L1 (.cg), 4-byte ones may not (.ca).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(bytes) : "memory");
}

// The FFMA body's shape.  A BM x BN block tile of THREADS threads in
// warps of 4 TM x 8 TN outputs (32 x 128 for the kDot's 8 x 16): a
// warp's lanes are WTY x WTX, and each thread holds TM x TN outputs as
// (TM / 4) x (TN / 4) groups of 4 x 4, groups WTY * 4 rows and WTX * 4
// columns apart, so that a warp's fragment loads are 16-byte reads of 4
// (A) and 8 (B) distinct chunks, broadcast to the rest.  K steps of BK in
// a ring of STAGES shared-memory stages; MINB blocks an SM (the launch
// bound caps the registers at 65536 / (THREADS * MINB)).
template <int BM, int BN, int BK, int TM, int TN, int STAGES, int MINB>
struct Tile {
  static constexpr int WTY = 4, WTX = 8;  // a warp's lanes along M, N
  static constexpr int WM = TM * WTY, WN = TN * WTX;
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int A_CHUNKS = BM * BK / 4 / THREADS;  // 16 B a thread
  static constexpr int B_CHUNKS = BK * BN / 4 / THREADS;
  // XOR of an A row's 16-byte m-chunk index at depth k: (k / 4) * SWZ,
  // below 8, so a warp's transposing stores hit 32 distinct banks
  static constexpr int SWZ = 32 / BK;
  static constexpr int RING = STAGES * BK * (BM + BN);  // floats
  static constexpr int SMEM = 4 * (RING > BM * BN ? RING : BM * BN);
  static_assert(TM % 4 == 0 && TN % 4 == 0, "TM, TN: groups of 4");
  static_assert(BM % WM == 0 && BN % WN == 0, "whole warps");
  static_assert(BM == 32 || BM == 64 || BM == 128 || BM == 256,
                "BM: a power of two with at least 8 chunks of 4 a row");
  static_assert(BK == 8 || BK == 16 || BK == 32, "BK: the swizzle's steps");
  static_assert(A_CHUNKS >= 1 && B_CHUNKS >= 1 &&
                    A_CHUNKS * THREADS * 4 == BM * BK &&
                    B_CHUNKS * THREADS * 4 == BK * BN,
                "every thread loads the same number of 16-byte chunks");
  static_assert(THREADS <= 1024 && STAGES >= 2, "threads, stages");
  static_assert(MINB * (SMEM + 1024) <= 233472, "MINB blocks' shared memory");
};

// ws == nullptr: the epilogue runs here; else the block's f32 partial
// over its K range goes to ws[blockIdx.z].  VEC: A is K-contiguous and B
// N-contiguous, both 16-byte aligned with row strides of a multiple of 4
// floats, and are read 16 bytes a thread; else (any strides) element by
// element into the same tiles.
template <int BM, int BN, int BK, int TM, int TN, int STAGES, int MINB,
          bool VEC, typename Epi>
__global__ void __launch_bounds__(
    (Tile<BM, BN, BK, TM, TN, STAGES, MINB>::THREADS), MINB)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
            GemmArgs g, Epi epi, float* __restrict__ ws) {
  using Cfg = Tile<BM, BN, BK, TM, TN, STAGES, MINB>;
  constexpr int THREADS = Cfg::THREADS, WTX = Cfg::WTX, WTY = Cfg::WTY;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const As = smem;                       // STAGES x BK x BM, k-major
  float* const Bs = smem + STAGES * BK * BM;    // STAGES x BK x BN

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = lane / WTX, tx = lane % WTX;
  const int wm = warp % Cfg::WARPS_M, wn = warp / Cfg::WARPS_M;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool live = m0 < g.vm && n0 < g.vn;
  // the tile lies wholly inside (vm, vn): its full K steps load unmasked
  const bool inner = m0 + BM <= g.vm && n0 + BN <= g.vn;
  const int kbeg = blockIdx.z * g.kchunk;
  const int kend = kbeg + g.kchunk < g.vk ? kbeg + g.kchunk : g.vk;
  const int nk = live && kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  // B: straight into the stage by cp.async (zeros past vn and kend)
  auto load_b = [&](int st, int k0) {
    const bool full = inner && k0 + BK <= kend;
    float* bs = Bs + st * BK * BN;
    if constexpr (VEC) {
#pragma unroll
      for (int c = 0; c < Cfg::B_CHUNKS; ++c) {
        const int e = tid + c * THREADS;
        const int r = e / (BN / 4), q = e % (BN / 4);
        const int gk = k0 + r, gn = n0 + q * 4;
        int bytes = 16;
        if (!full) {
          const int left = g.vn - gn;
          bytes = gk < kend ? 4 * (left < 0 ? 0 : (left > 4 ? 4 : left)) : 0;
        }
        cp_async16_zfill(bs + r * BN + q * 4,
                         bytes ? B + (long long)gk * g.sbk + gn : B, bytes);
      }
    } else {
      // not unrolled, so that no element's 64-bit offset stays live
      // across the K loop (they spill at the register cap)
#pragma unroll 1
      for (int i = 0; i < 4 * Cfg::B_CHUNKS; ++i) {
        const int e = tid + (i / 4) * THREADS;
        const int r = e / (BN / 4), gk = k0 + r;
        const int cn = (e % (BN / 4)) * 4 + i % 4, gn = n0 + cn;
        const bool ok = full || (gk < kend && gn < g.vn);
        cp_async4_zfill(
            bs + r * BN + cn,
            ok ? B + (long long)gk * g.sbk + (long long)gn * g.sbn : B,
            ok ? 4 : 0);
      }
    }
  };
  // A: 16 bytes along K a thread into registers, then stored k-major
  // (transposed) into the stage, its 4-float m-chunks XOR-swizzled by k
  float4 ra[Cfg::A_CHUNKS];
  auto load_a = [&](int k0) {
    const bool full = inner && k0 + BK <= kend;
#pragma unroll
    for (int c = 0; c < Cfg::A_CHUNKS; ++c) {
      const int e = tid + c * THREADS;
      const int gm = m0 + e / (BK / 4), gk = k0 + (e % (BK / 4)) * 4;
      float v[4];
      if constexpr (VEC) {
        const float* src = A + (long long)gm * g.sam + gk;
        if (full) {
          ra[c] = __ldg(reinterpret_cast<const float4*>(src));
          continue;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = gm < g.vm && gk + j < kend ? src[j] : 0.0f;
      } else {
        // one pointer stepped along K: per-element offsets would stay
        // live across the K loop and spill at the register cap
        const float* src = A + (long long)gm * g.sam + (long long)gk * g.sak;
#pragma unroll
        for (int j = 0; j < 4; ++j, src += g.sak)
          v[j] = full || (gm < g.vm && gk + j < kend) ? *src : 0.0f;
      }
      ra[c] = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  auto store_a = [&](int st) {
    float* as = As + st * BK * BM;
#pragma unroll
    for (int c = 0; c < Cfg::A_CHUNKS; ++c) {
      const int e = tid + c * THREADS;
      const int r = e / (BK / 4), q = e % (BK / 4);
      float* col = as + q * 4 * BM + (((r / 4) ^ (q * Cfg::SWZ)) * 4 + r % 4);
      col[0] = ra[c].x;
      col[BM] = ra[c].y;
      col[2 * BM] = ra[c].z;
      col[3 * BM] = ra[c].w;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // fragments of depth k of stage st: 16-byte reads
  float a[2][TM], b[2][TN];
  auto frag = [&](int buf, int st, int k) {
    const float* as = As + st * BK * BM;
    const float* bs = Bs + st * BK * BN;
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) {
      const int chunk = (wm * Cfg::WM) / 4 + q * WTY + ty;
      const float4 v = *reinterpret_cast<const float4*>(
          as + k * BM + ((chunk ^ ((k / 4) * Cfg::SWZ)) * 4));
      a[buf][q * 4 + 0] = v.x; a[buf][q * 4 + 1] = v.y;
      a[buf][q * 4 + 2] = v.z; a[buf][q * 4 + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          bs + k * BN + wn * Cfg::WN + (q * WTX + tx) * 4);
      b[buf][q * 4 + 0] = v.x; b[buf][q * 4 + 1] = v.y;
      b[buf][q * 4 + 2] = v.z; b[buf][q * 4 + 3] = v.w;
    }
  };
  auto ffma = [&](int buf) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = fmaf(a[buf][i], b[buf][j], acc[i][j]);
  };

  // the ring: B STAGES - 1 steps ahead, A one step ahead through
  // registers; one barrier a step, before the step's last depth, so the
  // next step's first fragments load while that depth's FFMAs issue
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nk) load_b(p, kbeg + p * BK);
    cp_async_commit();
  }
  if (nk > 0) {
    load_a(kbeg);
    store_a(0);
    cp_async_wait<STAGES - 2>();  // this thread's copies of step 0 landed
    __syncthreads();              // everyone's
    frag(0, 0, 0);
  }
  for (int s = 0; s < nk; ++s) {
    const int st = s % STAGES, pf = s + STAGES - 1;
    // into the stage step s - 1 read: every thread is past its reads
    if (pf < nk) load_b(pf % STAGES, kbeg + pf * BK);
    cp_async_commit();
    const bool more = s + 1 < nk;
    if (more) load_a(kbeg + (s + 1) * BK);  // in flight during the FFMAs
#pragma unroll
    for (int k = 0; k + 1 < BK; ++k) {
      frag((k + 1) % 2, st, k + 1);  // the next depth's, during this one's
      ffma(k % 2);
    }
    if (more) {
      store_a((s + 1) % STAGES);  // its stage was read at s + 1 - STAGES
      cp_async_wait<STAGES - 2>();  // this thread's copies of step s + 1
      __syncthreads();  // everyone's, and stage st's reads are done
      frag(0, (s + 1) % STAGES, 0);
    }
    ffma((BK - 1) % 2);
  }
  cp_async_wait<0>();

  // this thread's outputs: rows rm(q) + i, columns cn(q) + j, i, j < 4
  auto rm = [&](int q) { return wm * Cfg::WM + (q * WTY + ty) * 4; };
  auto cn = [&](int q) { return wn * Cfg::WN + (q * WTX + tx) * 4; };
  if (ws != nullptr) {
    // split-K: the f32 partial tile, 16 bytes at a time where the row
    // allows; the finish kernel stores the zeros of blocks outside
    // (vm, vn)
    if (!live) return;
    float* part = ws + static_cast<long long>(blockIdx.z) * g.M * g.N;
    const bool vec_rows = g.N % 4 == 0;
#pragma unroll
    for (int qm = 0; qm < TM / 4; ++qm)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + rm(qm) + i;
        if (m >= g.vm) continue;
#pragma unroll
        for (int qn = 0; qn < TN / 4; ++qn) {
          const int n = n0 + cn(qn), row = qm * 4 + i, col = qn * 4;
          float* dst = part + static_cast<long long>(m) * g.N + n;
          if (vec_rows && n + 4 <= g.vn) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[row][col], acc[row][col + 1],
                            acc[row][col + 2], acc[row][col + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < g.vn) dst[j] = acc[row][col + j];
          }
        }
      }
    return;
  }
  // the ring is free: the f32 tile goes there, row-major (a quarter
  // warp's 16-byte stores cover 128 contiguous bytes), and the block
  // walks it row by row
  __syncthreads();
  float* tile = smem;
#pragma unroll
  for (int qm = 0; qm < TM / 4; ++qm)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int qn = 0; qn < TN / 4; ++qn) {
        const int row = qm * 4 + i, col = qn * 4;
        *reinterpret_cast<float4*>(&tile[(rm(qm) + i) * BN + cn(qn)]) =
            make_float4(acc[row][col], acc[row][col + 1], acc[row][col + 2],
                        acc[row][col + 3]);
      }
  __syncthreads();
  constexpr int RSTEP = THREADS / BN;
  constexpr int G = BM / RSTEP < 16 ? BM / RSTEP : 16;
  tile_epilogue<BM, BN, THREADS, G>(tile, BN, m0, n0, tid, g, epi);
}

// VEC: the 16-byte instance (the wrapper checks the layout first, as
// matmul.ffma_ready); else the element-by-element one
template <int BM, int BN, int BK, int TM, int TN, int STAGES, int MINB,
          bool VEC, typename Epi>
cudaError_t launch_gemm(const float* A, const float* B, const GemmArgs& g,
                        const Epi& epi, float* ws, cudaStream_t stream) {
  using Cfg = Tile<BM, BN, BK, TM, TN, STAGES, MINB>;
  if (g.vm == 0 || g.vn == 0 || g.vk == 0)
    return launch_finish(nullptr, g, 0, epi, stream);
  if (g.splits < 1 || g.kchunk % BK || (g.splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  if (VEC && (g.sak != 1 || g.sbn != 1 || g.sam % 4 || g.sbk % 4 ||
              reinterpret_cast<uintptr_t>(A) % 16 ||
              reinterpret_cast<uintptr_t>(B) % 16))
    return cudaErrorInvalidValue;
  auto kernel = gemm_kernel<BM, BN, BK, TM, TN, STAGES, MINB, VEC, Epi>;
  cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, g.splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
      A, B, g, epi, g.splits > 1 ? ws : nullptr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  return launch_finish(ws, g, g.splits, epi, stream);
}

// ------------------------------------------------ bf16 / f16: wgmma --

template <int BM, int BN, int STAGES>
struct WgTile {
  static constexpr int BK = 64;  // 128 bytes of 16-bit values
  static constexpr int CONSUMERS = BM / 64;  // warpgroups of 64 rows
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int B_BOX_BYTES = BK * 64 * 2;  // one 64-wide N box
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment
  // setmaxnreg moves registers only within the block's own allocation
  // (launch bounds: 65536 / THREADS a thread, in steps of 8), or an inc
  // waits forever
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <=
                    THREADS * (65536 / THREADS / 8 * 8),
                "setmaxnreg within the block's registers");
  static_assert(BM == 128, "two consumer warpgroups of 64 rows");
  static_assert(BN % 64 == 0 && BN >= 64 && BN <= 256,
                "N boxes of 64 (128-byte swizzle), at most 256");
  // the ring, its alignment slack and the two barriers of each stage
  static_assert(STAGES >= 2 && SMEM + 16 * STAGES <= 232448,
                "227 KB of shared memory");
  static_assert(STAGES * STAGE_BYTES >= BM * (BN + 8) * 4,
                "the ring holds the f32 tile for the epilogue");
};

template <typename T> struct TmaType;
template <> struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct TmaType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

template <int BM, int BN, int STAGES, typename T, typename Epi>
__global__ void __launch_bounds__(WgTile<BM, BN, STAGES>::THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b, GemmArgs g,
                  Epi epi, float* __restrict__ ws) {
  using Cfg = WgTile<BM, BN, STAGES>;
  constexpr int BK = Cfg::BK, CT = Cfg::CONSUMERS * 128;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring so
  // the descriptors see the pattern TMA wrote
  unsigned char* smem =
      smem_raw + ((1024 - (shared_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sa = smem;                           // STAGES x A tile
  unsigned char* sb = smem + STAGES * Cfg::A_BYTES;   // STAGES x B tile

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool live = m0 < g.vm && n0 < g.vn;
  const int k_tiles = (g.vk + BK - 1) / BK, k_per = g.kchunk / BK;
  const int kt0 = blockIdx.z * k_per;
  const int kt1 = kt0 + k_per < k_tiles ? kt0 + k_per : k_tiles;
  const int nk = live && kt1 > kt0 ? kt1 - kt0 : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Cfg::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer warpgroup: one thread keeps the ring's loads in flight
    setmaxnreg_dec<Cfg::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], Cfg::STAGE_BYTES);
        const int k = (kt0 + it) * BK;
        tma_load_2d(sa + s * Cfg::A_BYTES, &tma_a, &full[s], k, m0);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_2d(sb + s * Cfg::B_BYTES + b * Cfg::B_BOX_BYTES, &tma_b,
                      &full[s], n0 + b * 64, k);
      }
    }
  } else {
    // consumer warpgroup c: rows c * 64 .. c * 64 + 63 of the tile
    setmaxnreg_inc<Cfg::CONSUMER_REGS>();
    const int c = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      acc[i] = 0.0f;
      fence_operand(acc[i]);
    }
    for (int it = 0; it < nk; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* a = sa + s * Cfg::A_BYTES + c * 64 * 128;
      const unsigned char* b = sb + s * Cfg::B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: K-major, 16 K values = 32 bytes along the swizzled row;
        // B: N-major, 16 K rows of 128 bytes, 64-wide N boxes apart
        const uint64_t da = wgmma_desc_sw128(a + kk * 32, 16, 1024);
        const uint64_t db =
            wgmma_desc_sw128(b + kk * 16 * 128, Cfg::B_BOX_BYTES, 1024);
        wgmma_m64k16<BN, T>(acc, da, db);
      }
      wgmma_commit();
      // the group of the previous stage has retired: release its buffers
      wgmma_wait<1>();
      if (it > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);

    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    // this thread's accumulators: rows r0 + 8 h, columns c0 + 8 i + e
    const int r0 = c * 64 + warp * 16 + lane / 4, c0 = (lane % 4) * 2;
    if (ws != nullptr) {
      // split-K: the f32 partial tile, straight from the registers; the
      // finish kernel stores the zeros of blocks outside (vm, vn)
      if (!live) return;
      float* part = ws + static_cast<long long>(blockIdx.z) * g.M * g.N;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = m0 + r0 + (q / 2) * 8, n = n0 + c0 + 8 * i + q % 2;
          if (m < g.vm && n < g.vn)
            part[static_cast<long long>(m) * g.N + n] = acc[i * 4 + q];
        }
      return;
    }
    // The ring is free once both consumer warpgroups are past their last
    // wgmma: the f32 tile goes there, rows padded by 8 floats so the
    // fragments' 8-byte stores hit distinct banks, and the consumers run
    // its epilogue over it.
    constexpr int LD = BN + 8;
    float* tile = reinterpret_cast<float*>(smem);
    named_barrier_sync<1, CT>();
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(&tile[(r0 + 8 * h) * LD + c0 + 8 * i]) =
            make_float2(acc[i * 4 + h * 2], acc[i * 4 + h * 2 + 1]);
    named_barrier_sync<1, CT>();
    tile_epilogue<BM, BN, CT, 32>(tile, LD, m0, n0, threadIdx.x - 128, g,
                                  epi);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime at first
// use, so the library needs no link against libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 2-D map of a row-major operand whose valid part is (rows, cols) with
// rows row_bytes apart, read in boxes of (box_rows, 64) with the 128-byte
// swizzle; everything outside (rows, cols) reads as zero.
template <typename T>
bool encode_operand(CUtensorMap* map, const T* base, int rows, int cols,
                    long long row_bytes, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, TmaType<T>::value, 2, const_cast<T*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN, int STAGES, typename T, typename Epi>
cudaError_t launch_gemm_wgmma(const T* A, const T* B, const GemmArgs& g,
                              const Epi& epi, float* ws,
                              cudaStream_t stream) {
  using Cfg = WgTile<BM, BN, STAGES>;
  if (g.vm == 0 || g.vn == 0 || g.vk == 0)
    return launch_finish(nullptr, g, 0, epi, stream);
  if (g.splits < 1 || g.kchunk % Cfg::BK || (g.splits > 1 && ws == nullptr)
      || g.sak != 1 || g.sbn != 1)
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!encode_operand(&ta, A, g.vm, g.vk, g.sam * 2, BM) ||
      !encode_operand(&tb, B, g.vk, g.vn, g.sbk * 2, Cfg::BK))
    return cudaErrorInvalidValue;
  auto kernel = gemm_wgmma_kernel<BM, BN, STAGES, T, Epi>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, g.splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
      ta, tb, g, epi, g.splits > 1 ? ws : nullptr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  return launch_finish(ws, g, g.splits, epi, stream);
}

}  // namespace disc

extern "C" const char* disc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// t) strides with a unit stride along N and 16-byte aligned rows, so the
// model's token-major projections are read in place; w (the decay, in
// (0, 1)) is f32, u (H, N) f32.
//
// What bounds it on an H100.  At T = 2048, B = 1, H = 40, N = 64 the
// function moves ~64 MB (r, k, v, y in bf16, w in f32; 0.019 ms at
// 3.35 TB/s) and does ~2.3 GFLOP in f32 (7 flops per state element per
// step: k*v, u*kv + s, r*tmp + y, w*s + kv), 0.035 ms at the 67 TFLOP/s
// FFMA rate: operations.  In f32 the bonus factors out, y_t = r_t . S +
// (sum_k r_k u_k k_k) v_t, so the function needs 5 flops per element and
// step: ~1.7 GFLOP, 0.025 ms, under the ~105 MB of f32 inputs and
// outputs (0.032 ms): bytes.  Only bf16 needs all 7, because it rounds
// k*v per element.
//
// Two instances, picked by the wrapper's plan (rwkv6.wkv_plan):
//
// Decode (T <= DECODE_MAX_T, the engine's T = 1): one block a (b, h,
// half of the state's columns), a streaming pass that reads s0 once and
// writes s1 once, the steps read straight from device memory.
//
// Chunked (longer T): the recurrence is linear in the state.  Split T
// into chunks of CHUNK steps; with S_c the state at the start of chunk c,
// P_t = prod_{start <= j < t} w_j (per row k; every factor in (0, 1), so
// no exp, log or division) and L_t the same recurrence run from a zero
// state with the same kv:
//
//   S_t     = diag(P_t) S_c + L_t
//   y_t     = r_t . (L_t + diag(u) kv_t)  +  (r_t o P_t) . S_c
//   S_{c+1} = diag(P_end) S_c + L_end
//
// One launch over (b, chunk, head), a block a whole head, in three
// phases.  A: the step loop over the chunk's steps from a zero state,
// the chunk's r, k, v and w staged through shared memory by cp.async in
// sub-chunks of SUB steps, double buffered; the local y_t kept in shared
// memory, and r_t o P_t and P_end formed beside it by one thread a row.
// B: the block takes its chunk from a ticket in launch order
// (chunk-major), waits for the previous chunk's block of its (b, h) to
// release S_c (an acquire load of a flag), writes S_{c+1} = P_end o S_c
// + L_end through a two-slot ring in L2 (s1 at the row's last chunk) and
// releases the flag: the SSD's hand-off (mamba2.cu).  C: y_t += (r_t o
// P_t) . S_c, a (steps x N) . (N x N) product on TF32 mma.sync by the
// SSD's 3 x TF32 split (S_c staged over the stages), then y written once,
// 16 bytes a store.  On FFMA in the state layout the product's per-step
// column sums cost as much as its multiply-adds; on the tensor cores the
// phase is short beside phase A.
//
// Thread layout (both instances): a lane holds R = 8 rows x CC = 4
// columns of the state in registers (N = 16: 2 x 4), rows g R ..,
// columns cg CC .., with lane = cg RG + g (RG = N / R row groups): per
// step it loads R values each of r, k and w and CC of v from shared
// memory (16 or 8 bytes a load) and does 4 R CC operations, and the CC
// column sums over the RG lanes of its column group meet by a transposed
// butterfly of shuffles (each lane ends with one column).  N = 64: 128
// threads a head; N = 16: one warp.
//
// What holds it (B = 1, T = 2048 on an H100): the hand-off.  The chunks
// of a row hop in turn, each hop two L2 round trips and a poll on SMs
// busy with other blocks' phase A, so the blocks of the first wave wait
// on every hop before theirs; then phase A's issue rate.  CHUNK = 64 and
// SUB = 16 were chosen among the candidates rwkv6/tune.py times (chunks
// of 32, 64, 96 and 128 steps; sub-chunks of 8 and 16; 4 or 8 rows a
// lane; PERF.md): 64 divides the serve path's prefill chunk (512) and
// buckets, so a prompt's chunks fall on the same steps whether it is
// prefilled in one launch or in several, and both give the same y and
// state bit for bit (96 steps were a few per cent faster, but not so).
//
// Numerics follow the plain version (ref.py): kv = k * v is rounded to
// the input type (a no-op in f32; in bf16 it mirrors the model's decode
// step, which forms kv in the activation dtype), then
// tmp = fmaf(u, kv, s), y += r * tmp, s = fmaf(w, s, kv) in f32, and y
// is rounded once to the input type.  In f32 phase A takes the factored
// form, y += r * s and s = fmaf(w, s, k * v) with the bonus a_t v_t added
// to the column's total, a_t = sum_k r_k u_k k_k formed once a step: the
// same sums in another order.  The chunked instance adds the carry in
// f32: P by one multiply a step, (r o P) . S_c by 3 x TF32 (within 2^-20
// of each product; tests/test_torch_rwkv.py emulates it on the CPU), the
// next state as fmaf(P_end, S_c, L_end).  The library is built with
// --fmad=false, so every fused multiply-add here is an explicit fmaf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

// the chunk length, sub-chunk length and state rows a lane at N = 64;
// rwkv6/tune.py defines them to build its candidates
#ifndef WKV_CHUNK
#define WKV_CHUNK 64
#endif
#ifndef WKV_SUB
#define WKV_SUB 16
#endif
#ifndef WKV_R64
#define WKV_R64 8
#endif

namespace {

constexpr int CHUNK = WKV_CHUNK;  // steps per chunk (rwkv6.CHUNK)
constexpr int SUB = WKV_SUB;      // steps per staged sub-chunk
constexpr int DECODE_MAX_T = 8;   // rwkv6.DECODE_MAX_T
constexpr unsigned FULL = 0xffffffffu;

static_assert(CHUNK % SUB == 0 && CHUNK % 16 == 0,
              "a chunk is whole sub-chunks and whole 16-row mma tiles");

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  __device__ static float word(const uint32_t* w, int i) {
    return __uint_as_float(w[i]);
  }
  __device__ static float one(const float* p) { return *p; }
  __device__ static float st(float x) { return x; }
  // kv of one row at two columns, in the input type (f32: as formed)
  __device__ static void kv2(float k, float v0, float v1, float& a,
                             float& b) {
    a = k * v0;
    b = k * v1;
  }
  __device__ static uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};

template <>
struct Elt<__nv_bfloat16> {
  __device__ static float word(const uint32_t* w, int i) {
    const uint32_t x = w[i >> 1];
    return __uint_as_float((i & 1) ? (x & 0xffff0000u) : (x << 16));
  }
  __device__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static __nv_bfloat16 st(float x) {
    return __float2bfloat16_rn(x);
  }
  // both products rounded to bf16 by one cvt.rn.bf16x2.f32
  __device__ static void kv2(float k, float v0, float v1, float& a,
                             float& b) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(k * v0, k * v1);
    a = __low2float(p);
    b = __high2float(p);
  }
  __device__ static uint4 pack(const float* x) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// how a vector load reads: shared memory, read-only device memory, or
// device memory another block wrote (L2, not the SM's L1)
enum Mode { SMEM, RO, CG };

template <Mode M, int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4* a = reinterpret_cast<const uint4*>(p) + q;
      const uint4 c = M == RO ? __ldg(a) : M == CG ? __ldcg(a) : *a;
      w[4 * q] = c.x;
      w[4 * q + 1] = c.y;
      w[4 * q + 2] = c.z;
      w[4 * q + 3] = c.w;
    }
  } else if constexpr (W == 2) {
    const uint2* a = reinterpret_cast<const uint2*>(p);
    const uint2 c = M == RO ? __ldg(a) : M == CG ? __ldcg(a) : *a;
    w[0] = c.x;
    w[1] = c.y;
  } else {
    static_assert(W == 1, "loads of 4, 8 or a multiple of 16 bytes");
    const unsigned* a = reinterpret_cast<const unsigned*>(p);
    w[0] = M == RO ? __ldg(a) : M == CG ? __ldcg(a) : *a;
  }
}

// CNT consecutive elements of T at p (aligned to their size), as f32
template <typename T, Mode M, int CNT>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[CNT]) {
  constexpr int W = CNT * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[W];
  load_words<M, W>(p, w);
#pragma unroll
  for (int i = 0; i < CNT; ++i) out[i] = Elt<T>::word(w, i);
}

template <int CNT>
__device__ __forceinline__ void store_f32(float* p, const float (&x)[CNT]) {
  static_assert(CNT % 4 == 0, "16-byte stores");
#pragma unroll
  for (int q = 0; q < CNT / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// A staged row of N elements of E in shared memory: 16 bytes of padding
// after every 128, so that row groups 128 bytes apart fall on other banks
template <typename E, int N>
struct Row {
  static constexpr int PER = 128 / static_cast<int>(sizeof(E));
  static constexpr int PAD = 16 / static_cast<int>(sizeof(E));
  static constexpr int LD = N + PAD * (N / PER);
  __device__ static int at(int k) { return k + PAD * (k / PER); }
};

template <int N>
struct Lay;
template <>
struct Lay<64> {
  static constexpr int R = WKV_R64;
  static constexpr int CC = 32 / R;
};
template <>
struct Lay<16> {
  static constexpr int R = 2;
  static constexpr int CC = 4;
};

template <int N>
struct Shape {
  static constexpr int R = Lay<N>::R;     // state rows a lane holds
  static constexpr int CC = Lay<N>::CC;   // state columns a lane holds
  static constexpr int RG = N / R;        // lanes that share a column group
  static constexpr int CG = N / CC;       // column groups of a head
  static constexpr int NT = RG * CG;      // threads of a chunked block
  static constexpr int LOGCC = CC == 8 ? 3 : CC == 4 ? 2 : 1;
  static_assert(RG >= CC && RG <= 32 && (RG & (RG - 1)) == 0 &&
                    NT % 32 == 0 && (1 << LOGCC) == CC,
                "a column group's lanes lie in one warp and outnumber "
                "its columns");
  // the decode instance: blocks of DNT threads, SLICES a head
  static constexpr int DNT = NT < 64 ? NT : 64;
  static constexpr int SLICES = NT / DNT;
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
  float* work;  // chunked: the hand-off ring (2, B, H, N, N)
  int* sync;    // chunked: the ticket, then a flag per (b, h); zero
  int B, H, T, nc;
  long long r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long w_sb, w_sh, w_st, y_sb, y_sh, y_st;
};

__device__ __forceinline__ int valid_steps(const Args& a, int b) {
  const int n = a.lens ? a.lens[b] : a.T;
  return max(0, min(n, a.T));
}

// The CC partial column sums y of each of the RG lanes of a column group
// into one total a lane: at round s the lanes whose bit s of g is set
// keep the upper half of their columns and send the lower half to the
// lane g ^ 2^s, the others the reverse; after LOGCC rounds a lane holds
// column col_of(g), and the rounds left add the copies.
template <int N>
__device__ __forceinline__ float column_sum(float (&y)[Shape<N>::CC], int g) {
  using S = Shape<N>;
#pragma unroll
  for (int s = 0; s < S::LOGCC; ++s) {
    const int half = S::CC >> (s + 1);
    const bool up = (g >> s) & 1;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = up ? y[i + half] : y[i];
      const float send = up ? y[i] : y[i + half];
      y[i] = keep + __shfl_xor_sync(FULL, send, 1 << s);
    }
  }
  float t = y[0];
#pragma unroll
  for (int o = S::CC; o < S::RG; o <<= 1) t += __shfl_xor_sync(FULL, t, o);
  return t;
}

// the column (within the group) whose total column_sum leaves in lane g
template <int N>
__device__ __forceinline__ int col_of(int g) {
  using S = Shape<N>;
  int c = 0;
#pragma unroll
  for (int s = 0; s < S::LOGCC; ++s)
    if ((g >> s) & 1) c += S::CC >> (s + 1);
  return c;
}

// One step of the recurrence on a lane's R x CC block of the state:
// y (CC partial sums over its rows) = r . (s + u kv), s = w s + kv
template <typename T, int N>
__device__ __forceinline__ void step(float (&s)[Shape<N>::R][Shape<N>::CC],
                                     const float (&u)[Shape<N>::R],
                                     const float (&rr)[Shape<N>::R],
                                     const float (&kk)[Shape<N>::R],
                                     const float (&ww)[Shape<N>::R],
                                     const float (&vv)[Shape<N>::CC],
                                     float (&y)[Shape<N>::CC]) {
  using S = Shape<N>;
#pragma unroll
  for (int i = 0; i < S::CC; ++i) y[i] = 0.f;
#pragma unroll
  for (int j = 0; j < S::R; ++j) {
#pragma unroll
    for (int i = 0; i < S::CC; i += 2) {
      float kv0, kv1;
      Elt<T>::kv2(kk[j], vv[i], vv[i + 1], kv0, kv1);
      const float t0 = fmaf(u[j], kv0, s[j][i]);
      const float t1 = fmaf(u[j], kv1, s[j][i + 1]);
      y[i] = fmaf(rr[j], t0, y[i]);
      y[i + 1] = fmaf(rr[j], t1, y[i + 1]);
      s[j][i] = fmaf(ww[j], s[j][i], kv0);
      s[j][i + 1] = fmaf(ww[j], s[j][i + 1], kv1);
    }
  }
}

// Phase A's step in f32, where the bonus factors out of the dot:
// y_t = r_t . S + (sum_k r_k u_k k_k) v_t, so a lane adds r . s over its
// rows (y, CC partial sums) and the block adds the bonus term a_t v_t to
// the column total; s = w s + kv as in step.  In bf16 kv is rounded per
// element, so phase A takes step there.
template <int N>
__device__ __forceinline__ void step_factored(
    float (&s)[Shape<N>::R][Shape<N>::CC], const float (&rr)[Shape<N>::R],
    const float (&kk)[Shape<N>::R], const float (&ww)[Shape<N>::R],
    const float (&vv)[Shape<N>::CC], float (&y)[Shape<N>::CC]) {
  using S = Shape<N>;
#pragma unroll
  for (int i = 0; i < S::CC; ++i) y[i] = 0.f;
#pragma unroll
  for (int j = 0; j < S::R; ++j) {
#pragma unroll
    for (int i = 0; i < S::CC; ++i) {
      y[i] = fmaf(rr[j], s[j][i], y[i]);
      s[j][i] = fmaf(ww[j], s[j][i], kk[j] * vv[i]);
    }
  }
}

// ---------------------------------------------------------- chunked --

// polls of a predecessor's flag before a block gives up (__trap: a
// launch error, never a hung card)
constexpr long long kSpinLimit = 1ll << 26;

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

// the chunked block's dynamic shared memory, in bytes
template <typename T, int N>
struct Smem {
  using RT = Row<T, N>;
  using RF = Row<float, N>;
  // one sub-chunk: r, k, v in T, w in f32, rows of SUB steps
  static constexpr int STAGE =
      SUB * (3 * RT::LD * static_cast<int>(sizeof(T)) + RF::LD * 4);
  // the two stages, then (once phase A is done) S_c [N][N + 8] for phase C
  static constexpr int SC = N * (N + 8) * 4;
  static constexpr int RP = 2 * STAGE > SC ? 2 * STAGE : SC;
  // r o P [CHUNK][N + 4], local y [CHUNK][N]
  static constexpr int Y = RP + CHUNK * (N + 4) * 4;
  static constexpr int PEND = Y + CHUNK * N * 4;       // P_end [N]
  static constexpr int BONUS = PEND + N * 4;           // a_t [SUB] (f32)
  static constexpr int BYTES = BONUS + SUB * 4;
  // blocks an SM's 227 KB hold (1 KB of each block's is the system's)
  static constexpr int FIT = 232448 / (BYTES + 1024);
  static constexpr int MINB = FIT < 4 ? FIT : 4;
  static_assert(STAGE % 16 == 0, "16-byte aligned stages");
};

// cp.async of one sub-chunk (steps t0 .. t0 + SUB - 1 of the chunk; steps
// past `steps` read as zeros) of an input of E into a stage's rows
template <typename E, int N, int NT>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, long long st,
                                           int t0, int steps) {
  using RW = Row<E, N>;
  constexpr int VEC = 16 / static_cast<int>(sizeof(E));
  constexpr int PER_ROW = N / VEC;
  constexpr int TOTAL = SUB * PER_ROW;
#pragma unroll
  for (int n = 0; n < (TOTAL + NT - 1) / NT; ++n) {
    const int i = threadIdx.x + n * NT;
    if (TOTAL % NT != 0 && i >= TOTAL) break;
    const int row = i / PER_ROW;
    const int col = (i % PER_ROW) * VEC;
    const bool ok = t0 + row < steps;
    disc::cp_async16(dst + row * RW::LD + RW::at(col),
                     ok ? src + (t0 + row) * st + col : src, ok);
  }
}

// registers capped so that as many blocks fit an SM as its shared memory
// holds (three at N = 64)
template <typename T, int N>
__global__ void __launch_bounds__(Shape<N>::NT, Smem<T, N>::MINB)
    wkv_chunked(const Args a) {
  using S = Shape<N>;
  using M = Smem<T, N>;
  using RT = Row<T, N>;
  using RF = Row<float, N>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tk_s;
  float* rp = reinterpret_cast<float*>(smem + M::RP);
  float* sy = reinterpret_cast<float*>(smem + M::Y);
  float* pend = reinterpret_cast<float*>(smem + M::PEND);
  float* bonus = reinterpret_cast<float*>(smem + M::BONUS);
  // row strides of r o P (the mma's A) and S_c (its B): g LDA + t and t
  // LDB + g fall on 32 banks
  constexpr int LDA = N + 4;
  constexpr int LDB = N + 8;
  constexpr int NW = S::NT / 32;  // warps
  constexpr bool FACTOR = sizeof(T) == 4;  // f32: the bonus factors out
  // the bonus sums: 16 lanes a step, RPL rows a lane
  constexpr int RPL = N / 16;

  const int tid = threadIdx.x;
  if (tid == 0) tk_s = atomicAdd(a.sync, 1);
  __syncthreads();
  const int tk = tk_s;
  const int per_chunk = a.B * a.H;
  const int c = tk / per_chunk;
  const int b = (tk % per_chunk) / a.H;
  const int h = tk % a.H;
  const int c0 = c * CHUNK;
  const int n_b = valid_steps(a, b);
  const int ncb = (n_b + CHUNK - 1) / CHUNK;
  const int rows = min(CHUNK, a.T - c0);  // rows of y in this chunk
  const size_t sbase = (static_cast<size_t>(b) * a.H + h) * N * N;
  T* Y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + c0 * a.y_st;
  constexpr int YV = 16 / static_cast<int>(sizeof(T));  // y elements a store

  if (c >= ncb) {  // every step past the row's length: y = 0
    for (int i = tid; i < rows * (N / YV); i += S::NT)
      *reinterpret_cast<uint4*>(Y + (i / (N / YV)) * a.y_st +
                                (i % (N / YV)) * YV) =
          make_uint4(0u, 0u, 0u, 0u);
    if (c == 0) {  // lens 0: the state is s0 (or 0) as it came
      for (int i = tid; i < N * N / 4; i += S::NT)
        reinterpret_cast<float4*>(a.s1 + sbase)[i] =
            a.s0 ? reinterpret_cast<const float4*>(a.s0 + sbase)[i]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int steps = min(CHUNK, n_b - c0);
  const int g = tid % S::RG;
  const int cg = tid / S::RG;
  const int row0 = g * S::R;
  const int col0 = cg * S::CC;
  const int ycol = col0 + col_of<N>(g);

  const T* R0 = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh +
                c0 * a.r_st;
  const T* K0 = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh +
                c0 * a.k_st;
  const T* V0 = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh +
                c0 * a.v_st;
  const float* W0 = a.w + b * a.w_sb + h * a.w_sh + c0 * a.w_st;
  auto stage = [&](int sc) {
    unsigned char* base = smem + (sc & 1) * M::STAGE;
    T* sr = reinterpret_cast<T*>(base);
    T* sk = sr + SUB * RT::LD;
    T* sv = sk + SUB * RT::LD;
    float* sw = reinterpret_cast<float*>(sv + SUB * RT::LD);
    stage_rows<T, N, S::NT>(sr, R0, a.r_st, sc * SUB, steps);
    stage_rows<T, N, S::NT>(sk, K0, a.k_st, sc * SUB, steps);
    stage_rows<T, N, S::NT>(sv, V0, a.v_st, sc * SUB, steps);
    stage_rows<float, N, S::NT>(sw, W0, a.w_st, sc * SUB, steps);
    disc::cp_async_commit();
  };

  float s[S::R][S::CC], u[S::R], ub[RPL];
#pragma unroll
  for (int j = 0; j < S::R; ++j) {
    u[j] = a.u[h * N + row0 + j];
#pragma unroll
    for (int i = 0; i < S::CC; ++i) s[j][i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < RPL; ++j) ub[j] = a.u[h * N + (tid % 16) * RPL + j];

  // A: the local scan from a zero state; the thread of row tid (tid < N)
  // forms r_t o P_t and P over the valid steps
  float prun = 1.f;
  const int nsub = (steps + SUB - 1) / SUB;
  stage(0);
  for (int sc = 0; sc < nsub; ++sc) {
    if (sc + 1 < nsub) {
      stage(sc + 1);
      disc::cp_async_wait<1>();
    } else {
      disc::cp_async_wait<0>();
    }
    __syncthreads();  // sub-chunk sc is in shared memory
    const unsigned char* base = smem + (sc & 1) * M::STAGE;
    const T* sr = reinterpret_cast<const T*>(base);
    const T* sk = sr + SUB * RT::LD;
    const T* sv = sk + SUB * RT::LD;
    const float* sw = reinterpret_cast<const float*>(sv + SUB * RT::LD);
    const int t0 = sc * SUB;
    const int nst = min(SUB, steps - t0);
    if (tid < N) {
      const int kt = RT::at(tid), kf = RF::at(tid);
      for (int tt = 0; tt < nst; ++tt) {
        rp[(t0 + tt) * LDA + tid] = Elt<T>::one(sr + tt * RT::LD + kt) * prun;
        prun = prun * sw[tt * RF::LD + kf];
      }
    }
    if constexpr (FACTOR) {  // a_t = sum_k r_k u_k k_k, 16 lanes a step
#pragma unroll
      for (int q = 0; q < SUB * 16 / S::NT; ++q) {
        const int tt = (tid + q * S::NT) / 16;
        const int k0 = (tid % 16) * RPL;
        float rr[RPL], kk[RPL];
        load_vec<T, SMEM, RPL>(sr + tt * RT::LD + RT::at(k0), rr);
        load_vec<T, SMEM, RPL>(sk + tt * RT::LD + RT::at(k0), kk);
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < RPL; ++j) part = fmaf(rr[j], ub[j] * kk[j], part);
#pragma unroll
        for (int o = 1; o < 16; o <<= 1)
          part += __shfl_xor_sync(FULL, part, o);
        if (tid % 16 == 0) bonus[tt] = part;
      }
      __syncthreads();
    }
#pragma unroll 2
    for (int tt = 0; tt < nst; ++tt) {
      float rr[S::R], kk[S::R], ww[S::R], vv[S::CC], y[S::CC];
      load_vec<T, SMEM, S::R>(sr + tt * RT::LD + RT::at(row0), rr);
      load_vec<T, SMEM, S::R>(sk + tt * RT::LD + RT::at(row0), kk);
      load_vec<float, SMEM, S::R>(sw + tt * RF::LD + RF::at(row0), ww);
      load_vec<T, SMEM, S::CC>(sv + tt * RT::LD + RT::at(col0), vv);
      float tot;
      if constexpr (FACTOR) {
        step_factored<N>(s, rr, kk, ww, vv, y);
        tot = fmaf(bonus[tt], Elt<T>::one(sv + tt * RT::LD + RT::at(ycol)),
                   column_sum<N>(y, g));
      } else {
        step<T, N>(s, u, rr, kk, ww, vv, y);
        tot = column_sum<N>(y, g);
      }
      if (g < S::CC) sy[(t0 + tt) * N + ycol] = tot;
    }
    __syncthreads();  // done with this stage before it is refilled
  }

  // B: S_c from the previous chunk (s0 or 0 at chunk 0), P_end o S_c +
  // L_end to the next through the two-slot ring (s1 at the row's last
  // chunk): the block's stores, a barrier, then thread 0's release of the
  // (b, h) flag (cumulative: it orders the stores the barrier ordered
  // before it); the next chunk's block acquires it.  A
  // block only waits on a smaller ticket, whose block is running or
  // done, and the slot a block overwrites was read before its predecessor
  // released the flag, so every wait ends.
  if (tid < N) pend[tid] = prun;
  int* flag = a.sync + 1 + b * a.H + h;
  if (c > 0 && tid == 0) {
    long long polls = 0;
    while (ld_acquire(flag) < c) {
      if (++polls > kSpinLimit) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
  const bool last = c == ncb - 1;
  const size_t ring = static_cast<size_t>(a.B) * a.H * N * N;
  float sprev[S::R][S::CC];
  if (c > 0) {
    const float* prev = a.work + ((c - 1) & 1) * ring + sbase;
#pragma unroll
    for (int j = 0; j < S::R; ++j)
      load_vec<float, CG, S::CC>(prev + (row0 + j) * N + col0, sprev[j]);
  } else if (a.s0) {
#pragma unroll
    for (int j = 0; j < S::R; ++j)
      load_vec<float, RO, S::CC>(a.s0 + sbase + (row0 + j) * N + col0,
                                 sprev[j]);
  } else {
#pragma unroll
    for (int j = 0; j < S::R; ++j)
#pragma unroll
      for (int i = 0; i < S::CC; ++i) sprev[j][i] = 0.f;
  }
  float* next = last ? a.s1 + sbase : a.work + (c & 1) * ring + sbase;
#pragma unroll
  for (int j = 0; j < S::R; ++j) {
    const float pe = pend[row0 + j];
    float nx[S::CC];
#pragma unroll
    for (int i = 0; i < S::CC; ++i) nx[i] = fmaf(pe, sprev[j][i], s[j][i]);
    store_f32<S::CC>(next + (row0 + j) * N + col0, nx);
  }
  __syncthreads();
  if (tid == 0 && !last) st_release(flag, c + 1);
  // S_c to shared memory (over the stages, done with) for phase C
  float* sct = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < S::R; ++j)
    store_f32<S::CC>(sct + (row0 + j) * LDB + col0, sprev[j]);
  __syncthreads();

  // C: y_t += (r_t o P_t) . S_c, (steps x N) . (N x N) on TF32 mma.sync
  // by the 3 x TF32 split, a warp 16 rows at a time, the accumulators
  // started from the local y; then y written once
  {
    constexpr int NTILE = N / 8;
    const int lane = tid & 31, warp = tid >> 5;
    const int gq = lane >> 2, tq = lane & 3;
    for (int m0 = warp * 16; m0 < steps; m0 += NW * 16) {
      float acc[NTILE][4];
      const int ra = m0 + gq, rb = ra + 8;
#pragma unroll
      for (int jn = 0; jn < NTILE; ++jn) {
        const int col = 8 * jn + 2 * tq;
        acc[jn][0] = sy[ra * N + col];
        acc[jn][1] = sy[ra * N + col + 1];
        acc[jn][2] = sy[rb * N + col];
        acc[jn][3] = sy[rb * N + col + 1];
      }
#pragma unroll 2
      for (int k0 = 0; k0 < N; k0 += 8) {
        uint32_t ah[4], al[4];
        disc::split<true>(rp[ra * LDA + k0 + tq], ah[0], al[0]);
        disc::split<true>(rp[rb * LDA + k0 + tq], ah[1], al[1]);
        disc::split<true>(rp[ra * LDA + k0 + tq + 4], ah[2], al[2]);
        disc::split<true>(rp[rb * LDA + k0 + tq + 4], ah[3], al[3]);
#pragma unroll
        for (int jn = 0; jn < NTILE; ++jn) {
          uint32_t bh0, bl0, bh1, bl1;
          disc::split<true>(sct[(k0 + tq) * LDB + 8 * jn + gq], bh0, bl0);
          disc::split<true>(sct[(k0 + tq + 4) * LDB + 8 * jn + gq], bh1, bl1);
          disc::mma_tf32(acc[jn], al, bh0, bh1);
          disc::mma_tf32(acc[jn], ah, bl0, bl1);
          disc::mma_tf32(acc[jn], ah, bh0, bh1);
        }
      }
#pragma unroll
      for (int jn = 0; jn < NTILE; ++jn) {
        const int col = 8 * jn + 2 * tq;
        *reinterpret_cast<float2*>(sy + ra * N + col) =
            make_float2(acc[jn][0], acc[jn][1]);
        *reinterpret_cast<float2*>(sy + rb * N + col) =
            make_float2(acc[jn][2], acc[jn][3]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * (N / YV); i += S::NT) {
    const int t = i / (N / YV);
    const int q = (i % (N / YV)) * YV;
    *reinterpret_cast<uint4*>(Y + t * a.y_st + q) =
        t < steps ? Elt<T>::pack(sy + t * N + q) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// ----------------------------------------------------------- decode --

// One block a (b, h, slice of DNT threads of the chunked layout): the
// state's R x CC blocks in registers, read from s0 and written to s1 once;
// each step's r, k, w and v read straight from device memory.
template <typename T, int N>
__global__ void __launch_bounds__(Shape<N>::DNT) wkv_decode(const Args a) {
  using S = Shape<N>;
  const int slice = blockIdx.x % S::SLICES;
  const int bh = blockIdx.x / S::SLICES;
  const int h = bh % a.H;
  const int b = bh / a.H;
  const int tid = threadIdx.x + slice * S::DNT;
  const int g = tid % S::RG;
  const int cg = tid / S::RG;
  const int row0 = g * S::R;
  const int col0 = cg * S::CC;
  const int ycol = col0 + col_of<N>(g);
  const int n = valid_steps(a, b);
  const size_t sbase = (static_cast<size_t>(b) * a.H + h) * N * N;

  float s[S::R][S::CC], u[S::R];
#pragma unroll
  for (int j = 0; j < S::R; ++j) {
    u[j] = a.u[h * N + row0 + j];
    if (a.s0) {
      load_vec<float, RO, S::CC>(a.s0 + sbase + (row0 + j) * N + col0, s[j]);
    } else {
#pragma unroll
      for (int i = 0; i < S::CC; ++i) s[j][i] = 0.f;
    }
  }
  const T* R0 = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* K0 = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* V0 = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* W0 = a.w + b * a.w_sb + h * a.w_sh;
  T* Y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh;
  for (int t = 0; t < a.T; ++t) {
    float tot = 0.f;
    if (t < n) {  // uniform over the block
      float rr[S::R], kk[S::R], ww[S::R], vv[S::CC], y[S::CC];
      load_vec<T, RO, S::R>(R0 + t * a.r_st + row0, rr);
      load_vec<T, RO, S::R>(K0 + t * a.k_st + row0, kk);
      load_vec<float, RO, S::R>(W0 + t * a.w_st + row0, ww);
      load_vec<T, RO, S::CC>(V0 + t * a.v_st + col0, vv);
      step<T, N>(s, u, rr, kk, ww, vv, y);
      tot = column_sum<N>(y, g);
    }
    if (g < S::CC) Y[t * a.y_st + ycol] = Elt<T>::st(tot);
  }
#pragma unroll
  for (int j = 0; j < S::R; ++j)
    store_f32<S::CC>(a.s1 + sbase + (row0 + j) * N + col0, s[j]);
}

template <typename T, int N>
cudaError_t launch(const Args& a, int instance, cudaStream_t stream) {
  using S = Shape<N>;
  if (instance == 0) {
    if (a.T > DECODE_MAX_T) return cudaErrorInvalidValue;
    const long long blocks = static_cast<long long>(a.B) * a.H * S::SLICES;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    wkv_decode<T, N><<<static_cast<unsigned>(blocks), S::DNT, 0, stream>>>(a);
    return cudaGetLastError();
  }
  constexpr int bytes = Smem<T, N>::BYTES;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv_chunked<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  if (a.work == nullptr || a.sync == nullptr) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(a.B) * a.nc * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wkv_chunked<T, N><<<static_cast<unsigned>(blocks), S::NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const Args& a, int n, int instance, cudaStream_t stream) {
  switch (n) {
    case 16: return launch<T, 16>(a, instance, stream);
    case 64: return launch<T, 64>(a, instance, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dims: B H T N, then the (batch, head, step) strides of r, k, v, w and
// y, in elements (unit stride along N, rows 16-byte aligned).  dtype (of
// r, k, v and y): 0 f32, 1 bf16.  instance: 0 decode (T <= 8), 1 chunked,
// with `work` 2 * B * H * N * N floats (the hand-off ring) and `sync`
// 1 + B * H ints, zero (the ticket and flags).  s0 and lens may be null.
// Returns the launch's cudaError_t (0 on success).
extern "C" int disc_rwkv6(const void* r, const void* k, const void* v,
                          const float* w, const float* u, const float* s0,
                          float* s1, void* y, const int* lens, float* work,
                          int* sync, const long long* dims, int dtype,
                          int instance, void* stream) {
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
  a.work = work;
  a.sync = sync;
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
  // chunk 0 also carries a row with no step (T = 0): it copies s0 to s1
  a.nc = a.T > 0 ? (a.T + CHUNK - 1) / CHUNK : 1;
  if (a.B == 0 || a.H == 0) return 0;
  if (instance != 0 && instance != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_n<float>(a, n, instance, st));
    case 1:
      return static_cast<int>(launch_n<__nv_bfloat16>(a, n, instance, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the chunk length the library was built with (rwkv6.CHUNK)
extern "C" int disc_rwkv6_chunk() { return CHUNK; }

extern "C" const char* disc_rwkv6_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

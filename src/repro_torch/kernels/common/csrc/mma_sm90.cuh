// Tensor-core and asynchronous-copy primitives for sm_90a, shared by the
// port's CUDA C++ kernels (matmul/csrc/gemm.cuh, flash_attention/csrc/
// flash_attention.cu).
//
// * smem_u32: a generic pointer into shared memory as the 32-bit shared
//   address that ldmatrix and cp.async take.
// * ldsm_x4 / ldsm_x4_t / ldsm_x2_t: ldmatrix of four (two) 8 x 8 tiles
//   of 16-bit elements, plain or transposed; lanes 8i .. 8i + 7 give the
//   row addresses of tile i.
// * mma16816<T>: mma.sync.m16n8k16 with an f32 accumulator, for T bf16 or
//   f16 (A row-major, B column-major, fragments as the PTX ISA lays them
//   out).
// * tf32_bits / split<SPLIT> / mma_tf32: the 3 x TF32 products of the
//   SSD and WKV kernels (mamba2/csrc/mamba2.cu, rwkv6/csrc/rwkv6.cu): an
//   f32 operand split into a TF32 high part and the rest, and
//   mma.sync.m16n8k8 TF32 with an f32 accumulator.
// * cp_async16: a 16-byte cp.async.cg copy from device to shared memory;
//   with pred false it reads nothing and writes 16 zero bytes.
//   cp_async_commit closes the group of copies issued since the last
//   commit, and cp_async_wait<N> waits until at most N groups are in
//   flight.  A copy's data is visible to other threads only after the
//   wait and a barrier.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace disc {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return __float_as_uint(v) & 0xffffe000u;
}

// v = hi + lo: hi is v with its low 13 mantissa bits cleared, lo = v - hi
// (exact), whose own low 13 bits the tensor core does not use (it reads
// lo to within 2^-10 of itself, 2^-20 of v: the emulation in
// tests/test_torch_zamba.py clears them); SPLIT false: v is exact in
// TF32 and lo is not used
template <bool SPLIT>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (SPLIT) {
    hi = tf32_bits(v);
    lo = __float_as_uint(v - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

// not volatile: the compiler may interleave independent products (a
// volatile asm keeps every mma in source order, each waiting on the last)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(smem)), "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace disc

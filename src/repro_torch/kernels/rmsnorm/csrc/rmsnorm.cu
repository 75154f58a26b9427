// RMSNorm for sm_90a: y = x * rsqrt(mean(x^2) + eps) * w over rows of width
// D, x f32, bf16 or f16, w f32, bf16 or f16.
//
// Replaces the JAX package's Pallas TPU kernel rmsnorm_kernel
// (kernels/rmsnorm/rmsnorm.py:26).  The kernel is the RMSNorm instance of
// common/csrc/row_norm.cuh, whose header comment holds the design, what
// bounds it and its numerics; this file is the library's C entry.
#include "row_norm.cuh"

// see disc::norm_entry; b is not read
extern "C" int disc_rmsnorm(const void* x, const void* w, const void* b,
                            void* o, long long R, int D, long long xs,
                            int cfg, int grid, float eps, void* stream) {
  return disc::norm_entry<false, 3>(x, w, b, o, R, D, xs, cfg, grid, eps,
                                    stream);
}

extern "C" const char* disc_rmsnorm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

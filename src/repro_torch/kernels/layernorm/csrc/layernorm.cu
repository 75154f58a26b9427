// LayerNorm for sm_90a: y = (x - mu) * rsqrt(mean((x - mu)^2) + eps) * g + b
// over rows of width D, x f32 or bf16, g and b f32, bf16 or f16.
//
// Replaces the JAX package's Pallas TPU kernel layernorm_kernel
// (kernels/layernorm/layernorm.py:24).  The kernel is the LayerNorm
// instance of common/csrc/row_norm.cuh, whose header comment holds the
// design, what bounds it and its numerics; this file is the library's C
// entry.
#include "row_norm.cuh"

// see disc::norm_entry
extern "C" int disc_layernorm(const void* x, const void* g, const void* b,
                              void* o, long long R, int D, long long xs,
                              int cfg, int grid, float eps, void* stream) {
  return disc::norm_entry<true, 2>(x, g, b, o, R, D, xs, cfg, grid, eps,
                                   stream);
}

extern "C" const char* disc_layernorm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

from .ops import GEMM_LIBRARY, matmul, select_gemm_version  # noqa: F401

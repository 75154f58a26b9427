from .ops import mamba2_scan  # noqa: F401

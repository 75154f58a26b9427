from .ops import flash_attention, flash_decode  # noqa: F401

from .ops import rwkv6  # noqa: F401

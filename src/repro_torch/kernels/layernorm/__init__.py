from .ops import layernorm  # noqa: F401

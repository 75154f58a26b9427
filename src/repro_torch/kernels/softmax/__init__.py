from .ops import masked_softmax  # noqa: F401

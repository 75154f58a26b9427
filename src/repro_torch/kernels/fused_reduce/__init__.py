"""kInput: fused reduce kernel (``ops.fused_reduce``)."""

"""kLoop: fused elementwise kernel (``ops.fused_elementwise``)."""

"""DISC core for the PyTorch port: the DHLO IR, shape constraints, fusion,
placement, memory planning, bucketing, code generation and dispatch."""

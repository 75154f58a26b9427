"""Hand-written Hopper kernels for DISC's fused patterns (PyTorch port).

Each kernel directory holds:
  <name>.py — the kernel (Triton source generated per fusion-cluster
              program, built and launched on the card),
  ops.py    — the wrapper: picks the kernel for a CUDA tensor and the
              plain version for a CPU tensor, and counts launches,
  ref.py    — the plain PyTorch version of the same function.
"""

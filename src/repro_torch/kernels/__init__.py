"""Hand-written Hopper kernels for DISC's fused patterns (PyTorch port).

Each kernel directory holds:
  <name>.py — the kernel, built and launched on the card (Triton
              source generated per fusion-cluster program, or a CUDA
              C++ library from csrc/, or, for the norms, from
              common/csrc/row_norm.cuh through row_norm.py),
  ops.py    — the wrapper: picks the kernel for a CUDA tensor and the
              plain version for a CPU tensor, and counts launches,
  ref.py    — the plain PyTorch version of the same function.
"""

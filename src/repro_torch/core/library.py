"""Static-shape kernel library interface — DISC §4.5.

    "we implement an interface to choose the best kernel from a library
     according to different runtime shapes.  The library contains both
     vendor libraries such as cuBLAS/cuDNN, and pre-generated kernels that
     has been hand-tuned for each shape."

The library itself lives with the kernels (``kernels/matmul``): the
reference's version table, each version run by the Hopper GEMM at its own
tile, plus the vendor entry (``torch.matmul``, cuBLAS on the card).  This
module is the compiler-side interface: :func:`pick` chooses a
compute-intensive op's implementation at dispatch time, keyed on the
*runtime* shape.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["pick", "LibraryChoice"]


class LibraryChoice:
    def __init__(self, name: str, fn: Callable):
        self.name = name
        self.fn = fn

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<LibraryChoice {self.name}>"


def pick(m: int, k: int, n: int) -> LibraryChoice:
    """Choose the GEMM implementation for a runtime (m, k, n):
    ``library:<version>`` or ``vendor:torch_matmul``."""
    from ..kernels.matmul.ops import matmul, select_gemm_version

    version = select_gemm_version(m, k, n)
    if version is None:
        return LibraryChoice("vendor:torch_matmul", torch.matmul)
    return LibraryChoice(f"library:{version}",
                         lambda a, b: matmul(a, b, version=version))

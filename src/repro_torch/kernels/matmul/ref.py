"""Plain PyTorch versions of the GEMM kernels (kDot and the §4.5 library).

Used by the tests, by the CPU path and by ``chip_smoke.py``'s comparison;
nothing on the card path calls them.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..program import Program, eval_program

__all__ = ["matmul_ref", "matmul_fused_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` contracted in f32, in ``a``'s dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def matmul_fused_ref(a: torch.Tensor, b: torch.Tensor,
                     extras: Sequence[torch.Tensor], program: Program,
                     valid_mnk: Sequence[int],
                     out_dtypes: Sequence[torch.dtype]
                     ) -> List[torch.Tensor]:
    """``a (M, K) @ b (K, N)`` with the K tail (k >= valid K) masked to zero
    on both operands, contracted in f32, cast to the accumulator's dtype
    (``program.in_dtypes[0]``), then ``program`` over it and the (M, N)
    ``extras``; every output is zero where m >= valid M or n >= valid N."""
    m, k = a.shape
    n = b.shape[1]
    vm, vn, vk = (int(v) for v in valid_mnk)
    keep_k = torch.arange(k, device=a.device) < vk
    af = torch.where(keep_k[None, :], a.float(), 0.0)
    bf = torch.where(keep_k[:, None], b.float(), 0.0)
    acc = (af @ bf).to(program.in_dtypes[0])
    ys = eval_program(program, [acc] + [torch.broadcast_to(x, (m, n))
                                        for x in extras])
    keep = (torch.arange(m, device=a.device) < vm)[:, None] & \
        (torch.arange(n, device=a.device) < vn)[None, :]
    return [torch.where(keep, torch.broadcast_to(y, (m, n)).to(dt),
                        torch.zeros((), dtype=dt, device=a.device))
            for y, dt in zip(ys, out_dtypes)]

"""Plain PyTorch version of the fused elementwise (kLoop) kernel."""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..program import Program, eval_program


def fused_elementwise_ref(program: Program, inputs: Sequence[torch.Tensor],
                          n_valid: int, shape: Sequence[int]
                          ) -> List[torch.Tensor]:
    """``program`` over ``inputs`` broadcast to ``shape``; every output is
    zero at flat positions ``>= n_valid``."""
    shape = tuple(shape)
    ys = eval_program(program, [torch.broadcast_to(x, shape)
                                for x in inputs])
    total = 1
    for d in shape:
        total *= d
    outs = []
    for y, dt in zip(ys, program.out_dtypes):
        flat = torch.broadcast_to(y, shape).reshape(-1)
        keep = torch.arange(total, device=flat.device) < n_valid
        outs.append(torch.where(keep, flat, torch.zeros_like(flat))
                    .to(dt).reshape(shape))
    return outs

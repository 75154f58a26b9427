"""Plain PyTorch version of the fused reduce (kInput) kernel."""
from __future__ import annotations

from typing import Sequence

import torch

from ..program import Program, eval_program

REDUCE_IDENTITY = {"sum": 0.0, "max": float("-inf"), "min": float("inf"),
                   "prod": 1.0}

_REDUCERS = {"sum": lambda y: torch.sum(y, dim=-1),
             "max": lambda y: torch.amax(y, dim=-1),
             "min": lambda y: torch.amin(y, dim=-1),
             "prod": lambda y: torch.prod(y, dim=-1)}


def fused_reduce_ref(program: Program, inputs: Sequence[torch.Tensor],
                     n_valid_cols: int, kind: str, axis: int,
                     shape: Sequence[int], out_dtype) -> torch.Tensor:
    """Reduce ``program(*inputs)`` (broadcast to ``shape``) over ``axis``:
    positions ``>= n_valid_cols`` along it take the reduce identity, the
    sum accumulates in f32 and the result is stored in ``out_dtype``.
    ``n_valid_cols`` is an int or an integer tensor of one element, which
    is compared on its device, never read on the host."""
    shape = tuple(shape)
    (y,) = eval_program(program, [torch.broadcast_to(x, shape)
                                  for x in inputs])
    y = torch.broadcast_to(y, shape).movedim(axis, -1).float()
    cols = torch.arange(y.shape[-1], device=y.device)
    if isinstance(n_valid_cols, torch.Tensor):
        n_valid_cols = n_valid_cols.reshape(())
    y = torch.where(cols < n_valid_cols, y,
                    torch.full_like(y, REDUCE_IDENTITY[kind]))
    return _REDUCERS[kind](y).to(out_dtype)

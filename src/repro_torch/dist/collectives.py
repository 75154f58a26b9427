"""Counting the collectives a call issues, by kind and bytes.

DTensor's redistributions and the port's own explicit collectives (the
MoE's expert-parallel all-reduce, a kernel's ``Partial`` output) all go
through ``torch.distributed``'s functional collectives, the
``_c10d_functional`` operators.  :class:`CollectiveCounter` is a dispatch
mode that sees each one and tallies it: ``{kind: {"count", "bytes"}}``,
``bytes`` being the input this rank contributed.  It counts what runs
eagerly: a compiled artifact counts a bucket entry's first call (its
trace), which its CUDA graph then replays unchanged.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveCounter", "COLLECTIVE_KINDS"]

#: functional collective operator name -> the kind it is counted as
COLLECTIVE_KINDS = {
    "all_reduce": "all_reduce",
    "all_reduce_coalesced": "all_reduce",
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "all_to_all_single": "all_to_all",
    "broadcast": "broadcast",
}


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """``with CollectiveCounter() as c: ...`` — ``c.counts`` then holds
    the collectives the block issued."""

    def __init__(self) -> None:
        super().__init__()
        self.counts: Dict[str, Dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a CUDA graph's capture pass repeats the eager call it follows
        if func.namespace == "_c10d_functional" and not _capturing():
            kind = COLLECTIVE_KINDS.get(func._opname)
            if kind is not None:
                c = self.counts.setdefault(kind, {"count": 0, "bytes": 0})
                c["count"] += 1
                c["bytes"] += _nbytes(args[0] if args else None)
        return func(*args, **kwargs)

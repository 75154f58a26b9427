"""Lengths in device memory, for the kernels that read their valid
extents there (kInput's column count, kDot's (M, N, K)).

A kernel that takes its lengths as host ints bakes them into its launch:
a CUDA graph captured at one length replays that length.  The cluster
kernels instead read them from an ``int32`` tensor on the card, so one
captured launch serves every length of its bucket.  The tensor is built
by device ops alone (a fill, a cast, a concatenation): a copy from host
memory cannot be captured.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

__all__ = ["device_ints"]


def device_ints(values: Sequence[Any], device) -> torch.Tensor:
    """``values`` (ints, or integer tensors of one element on ``device``)
    as one ``int32`` tensor of ``len(values)`` on ``device``."""
    return torch.cat([v.reshape(1).to(torch.int32)
                      if isinstance(v, torch.Tensor)
                      else torch.full((1,), int(v), dtype=torch.int32,
                                      device=device) for v in values])

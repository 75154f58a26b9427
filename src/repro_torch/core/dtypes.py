"""Element types of DHLO values in the PyTorch port.

A :class:`~repro_torch.core.dhlo.DValue` carries a ``torch.dtype``.  The
IR modules only ever ask three questions of a dtype — its byte width, a
stable textual key (folded into the shape-free graph fingerprint) and
whether it is an integer type — so they go through this module instead of
``numpy.dtype``: numpy has no ``bfloat16``.

The keys are numpy's ``dtype.str`` spellings (``"<f4"``, ``"|b1"``, and
``"<V2"`` for bfloat16, as ``ml_dtypes`` spells it), so a graph built with
the same wiring in the JAX package fingerprints identically.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["as_torch", "itemsize", "dtype_key", "dtype_name", "is_integer",
           "is_floating"]

_KEYS = {
    torch.float64: "<f8", torch.float32: "<f4", torch.float16: "<f2",
    torch.bfloat16: "<V2", torch.int64: "<i8", torch.int32: "<i4",
    torch.int16: "<i2", torch.int8: "|i1", torch.uint8: "|u1",
    torch.bool: "|b1",
}

_BY_NAME = {str(dt).replace("torch.", ""): dt for dt in _KEYS}


def as_torch(dt: Any) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, numpy dtype/type or name."""
    if isinstance(dt, torch.dtype):
        return dt
    name = dt if isinstance(dt, str) else getattr(dt, "name", None)
    if name is None:
        name = np.dtype(dt).name
    try:
        return _BY_NAME[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {dt!r}") from None


def itemsize(dt: Any) -> int:
    return as_torch(dt).itemsize


def dtype_key(dt: Any) -> str:
    return _KEYS[as_torch(dt)]


def dtype_name(dt: Any) -> str:
    return str(as_torch(dt)).replace("torch.", "")


def is_integer(dt: Any) -> bool:
    t = as_torch(dt)
    return not t.is_floating_point and t is not torch.bool


def is_floating(dt: Any) -> bool:
    return as_torch(dt).is_floating_point

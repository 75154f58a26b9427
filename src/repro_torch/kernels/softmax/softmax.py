"""Masked row softmax for Hopper (CUDA C++).

Replaces the JAX package's Pallas TPU kernel ``masked_softmax_kernel``
(``kernels/softmax/softmax.py:37``).  The kernel is ``csrc/softmax.cu``
(its header comment holds the design and what bounds it); this module
builds it once with ``nvcc`` (``kernels/cuda_build.py``) into one small
library with a plain C entry point, and launches it through
:mod:`ctypes` on PyTorch's current stream.

:func:`softmax_plan` says how a launch covers the rows (testable without
a card): a group of threads a row, each holding a few chunks of the row
in registers, rows a block, and a grid sized to the rows; a row too wide
for registers takes the loop instance, a block of 1024 threads a row
that reads it three times.  The row count and ``n_valid`` are runtime
arguments; C only picks the plan, and every C has one.  The
wrapper reads x in place through its row stride (a tensor whose last
axis is not unit-stride is copied first) and raises on what the kernel
does not take.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
import threading
from typing import NamedTuple, Tuple

import torch

from .. import cuda_build

__all__ = ["SoftmaxPlan", "softmax_plan", "masked_softmax_kernel",
           "source_job", "MAX_COLS"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "softmax.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: values of a row one thread holds at most (csrc MAX_ELEMS), and loads
#: (the register instances' CH: 1, 2, 4, 8)
_MAX_ELEMS = 32
_MAX_CHUNKS = 8
#: widest row held in registers: 1024 threads of _MAX_ELEMS values (a
#: wider row, or one wider than 8192 columns that is not 16-byte
#: readable, takes the loop instance)
MAX_COLS = 1024 * _MAX_ELEMS
#: threads of the loop instance's block, one row
_LOOP_THREADS = 1024
#: threads a block aims at when a row takes less than that
_BLOCK_THREADS = 128

_LOCK = threading.Lock()
_FN = None


class SoftmaxPlan(NamedTuple):
    """How one launch covers R rows of C columns."""
    vec: int        # consecutive columns a load (1, or 16 bytes' worth)
    chunks: int     # loads a thread (1, 2, 4, 8 held in registers; more,
    #                 or more than 32 values: the loop instance, a pass)
    group: int      # threads a row (a power of two, 1 to 1024)
    rows: int       # rows a block
    threads: int    # threads a block
    grid: int       # blocks


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=256)
def softmax_plan(n_rows: int, n_cols: int, elt: int = 4,
                 wide: bool = True) -> SoftmaxPlan:
    """The plan for ``n_rows`` x ``n_cols`` of ``elt``-byte elements.
    ``wide``: the rows may be read in 16-byte chunks (aligned, C a
    multiple of 16 / elt).  Rows of at most 32 columns take one column a
    thread, a group of the next power of two of C threads (at C = 16,
    two rows a warp); wider rows take 16-byte chunks where ``wide`` allows
    and a group of a warp or more, up to 4 chunks a thread (8 where the
    group is a whole 1024-thread block).  The block holds whole rows, at
    most ``_BLOCK_THREADS`` threads where a row needs fewer, and no more
    than the rows need; the grid covers the rows.  A row that needs more
    than 8 loads or 32 values a thread (more than ``MAX_COLS`` columns,
    or more than 8192 where it is not 16-byte readable) takes the loop
    instance: one block of 1024 threads a row, ``chunks`` loads a thread
    a pass."""
    if n_cols <= 32:
        vec, group = 1, _pow2(n_cols)
    else:
        vec = 16 // elt if wide and n_cols % (16 // elt) == 0 else 1
        group = min(1024, max(32, _pow2(-(-n_cols // vec // 4))))
    units = -(-n_cols // vec)
    chunks = _pow2(-(-units // group))
    if chunks > _MAX_CHUNKS or vec * chunks > _MAX_ELEMS:
        return SoftmaxPlan(vec, -(-units // _LOOP_THREADS), _LOOP_THREADS,
                           1, _LOOP_THREADS, max(1, n_rows))
    if group >= _BLOCK_THREADS:
        rows, threads = 1, group
    else:
        threads = min(_BLOCK_THREADS,
                      -(-max(n_rows, 1) * group // 32) * 32)
        threads = max(threads, group)
        rows = threads // group
    return SoftmaxPlan(vec, chunks, group, rows, threads,
                       max(1, -(-n_rows // rows)))


def source_job() -> Tuple[str, str, list]:
    """The ``(name, source, include_dirs)`` build job of the library (a
    caller that knows its kernels ahead builds several at once with
    ``cuda_build.build``)."""
    return "masked_softmax", SOURCE.read_text(), [CSRC]


def _function():
    global _FN
    if _FN is None:
        with _LOCK:
            if _FN is None:
                lib = cuda_build.load(*source_job())
                fn = lib.disc_masked_softmax
                fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                               + [ctypes.c_longlong] * 2
                               + [ctypes.c_int] * 6 + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                err = lib.disc_masked_softmax_error
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                _FN = (fn, err)
    return _FN


def masked_softmax_kernel(x: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Launch the masked softmax over the rows of ``x`` (R, C); returns an
    (R, C) tensor of x's dtype."""
    if x.dim() != 2:
        raise ValueError(f"masked softmax: x must be (R, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"masked softmax: x {x.dtype}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("masked softmax kernel: x on a CUDA device")
    n_rows, n_cols = x.shape
    if n_rows >= 2 ** 31:
        raise ValueError("masked softmax: row count exceeds int32")
    if n_cols and x.stride(-1) != 1:
        x = x.contiguous()
    out = torch.empty((n_rows, n_cols), dtype=x.dtype, device=dev)
    if not (n_rows and n_cols):
        return out
    elt = x.element_size()
    vec = 16 // elt
    wide = (x.data_ptr() % 16 == 0 and (n_rows == 1 or x.stride(0) % vec
                                        == 0))
    plan = softmax_plan(n_rows, n_cols, elt, wide)
    fn, err = _function()
    args = (x.data_ptr(), out.data_ptr(), n_rows, n_cols,
            min(max(int(n_valid), 0), n_cols), x.stride(0), out.stride(0),
            _DTYPES[x.dtype], plan.vec, plan.chunks,
            plan.group.bit_length() - 1, plan.threads, plan.grid,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"masked softmax kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return out

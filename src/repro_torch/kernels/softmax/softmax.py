"""Masked row softmax for Hopper (Triton).

Replaces the JAX package's Pallas TPU kernel ``masked_softmax_kernel``
(``kernels/softmax/softmax.py:37``): the softmax of each row of (R, C)
over its columns below ``n_valid``; the other columns are exactly 0, and
a row with no valid column is all zeros (its max kept finite, its sum of
0 replaced by 1).  On the serve path it is the MoE router's softmax over
the E experts (``n_valid = E``).

* **What bounds it on an H100: bytes.**  One read of x and one write of
  the output, ~5 flops per element (max, subtract, exp, sum, divide).
  Each program holds a block of ``BLOCK_R`` whole rows in registers, so
  x is read from device memory once and both row reductions fuse into
  that pass.  At the router's C = 16 a program per row would leave most
  of a warp's lanes idle: ``BLOCK_R`` is chosen from C so that a program
  covers ~2048 elements (128 rows of 16), whatever the row count.  At
  the router's sizes (2048 x 16 f32 is 256 KB) the kernel is bound by
  its launch, not by bytes.
* **Lengths are runtime arguments** (``do_not_specialize``): the row
  count (batch x sequence, the dynamic axis) and ``n_valid`` (the
  reference's scalar-prefetched length) never recompile the kernel.  C
  sets the block sizes, as the model's width sets the norms'.
* **Numerics follow the plain version**: max, ``exp`` (``libdevice``'s,
  as ``torch.exp`` on the card), sum and an IEEE divide (``div_rn``;
  Triton's ``/`` is the approximate ``div.full``) in f32, rounded once
  to x's dtype; only the summation order differs.  The reference's row
  blocking for the TPU's VMEM (``ROW_VERSIONS``, a 4 MiB budget) is not
  carried over.

The source below is written to ``build/torch_kernels/`` and imported
through ``triton_build.load_kernel`` on the first launch; nothing here
imports Triton.
"""
from __future__ import annotations

import hashlib

import torch

from ..triton_build import load_kernel

__all__ = ["masked_softmax_kernel", "block_rows", "SOURCE"]

SOURCE = '''\
import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit(do_not_specialize=["n_rows", "n_valid"])
def masked_softmax_kernel(x_ptr, o_ptr, n_rows, n_cols, n_valid, x_stride,
                          o_stride, BLOCK_R: tl.constexpr,
                          BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    row_ok = rows < n_rows
    in_row = cols < n_cols
    valid = in_row & (cols < n_valid)
    r64 = rows.to(tl.int64)[:, None]
    x = tl.load(x_ptr + r64 * x_stride + cols[None, :],
                mask=row_ok[:, None] & valid[None, :],
                other=float("-inf")).to(tl.float32)
    m = tl.max(x, axis=1)
    # a row without a finite max (no valid column): keep m finite, as
    # the reference does, so that no -inf - -inf makes a nan
    m = tl.where(tl.abs(m) < float("inf"), m, 0.0)
    e = libdevice.exp(x - m[:, None])
    e = tl.where(valid[None, :], e, 0.0)
    s = tl.sum(e, axis=1)
    s = tl.where(s == 0.0, 1.0, s)
    y = libdevice.div_rn(e, tl.broadcast_to(s[:, None], (BLOCK_R, BLOCK_C)))
    tl.store(o_ptr + r64 * o_stride + cols[None, :],
             y.to(o_ptr.dtype.element_ty),
             mask=row_ok[:, None] & in_row[None, :])
'''

_NAME = "masked_softmax_" + hashlib.sha1(SOURCE.encode()).hexdigest()[:12]
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: elements one program covers (whole rows; at least one row)
_BLOCK_ELEMS = 2048


def block_rows(n_cols: int):
    """``(BLOCK_R, BLOCK_C, num_warps)`` for rows of ``n_cols`` columns:
    BLOCK_C the next power of two, BLOCK_R rows of it per program."""
    block_c = 1 << max(n_cols - 1, 0).bit_length()
    block_r = max(1, _BLOCK_ELEMS // block_c)
    elems = block_r * block_c
    warps = 4 if elems <= 2048 else 8 if elems <= 8192 else 16
    return block_r, block_c, warps


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
    if n_cols and x.stride(-1) != 1:
        x = x.contiguous()
    out = torch.empty((n_rows, n_cols), dtype=x.dtype, device=dev)
    if n_rows and n_cols:
        mod = load_kernel(_NAME, lambda: SOURCE)
        block_r, block_c, warps = block_rows(n_cols)
        grid = (-(-n_rows // block_r),)
        with torch.cuda.device(dev):
            mod.masked_softmax_kernel[grid](
                x, out, n_rows, n_cols, int(n_valid), x.stride(0),
                out.stride(0), BLOCK_R=block_r, BLOCK_C=block_c,
                num_warps=warps)
    return out

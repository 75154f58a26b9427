"""Fused RMSNorm for Hopper (Triton).

Replaces the JAX package's Pallas TPU kernel ``rmsnorm_kernel``
(``kernels/rmsnorm/rmsnorm.py:26``): ``y = x * rsqrt(mean(x^2) + eps) *
w`` over rows of width D, accumulated in f32 whatever the input type,
then cast to the input type.

* **What bounds it on an H100: bytes.**  One read of x, one write of y
  and ~4 flops per element: some 0.5-1 flop per byte.  One program per
  row holds the whole row (D = 2048 on TinyLlama: one 16 B load per
  thread at 4 warps and bf16) in registers, so x is read from device
  memory once and the reduction and the scale fuse into that one pass.
* **The row count is a runtime argument** (``do_not_specialize``): the
  dynamic-shape axis is batch x sequence, and a new length launches the
  kernel already compiled.  The width D is the model's, a block size.
* **Numerics follow the plain version** (``models/layers.py``
  ``norm_apply``): the mean is the f32 sum times 1/D, as PyTorch's mean
  reduction computes it, and ``rsqrt`` is ``libdevice``'s, as
  ``torch.rsqrt`` on the card; only the summation order differs.

The source below is written to ``build/torch_kernels/`` and imported
through ``triton_build.load_kernel`` on the first launch; nothing here
imports Triton.
"""
from __future__ import annotations

import hashlib

import torch

from ..triton_build import load_kernel

__all__ = ["rmsnorm_kernel", "SOURCE"]

SOURCE = '''\
import triton
import triton.language as tl


@triton.jit(do_not_specialize=["n_rows"])
def rmsnorm_kernel(x_ptr, w_ptr, o_ptr, n_rows, d, x_stride, o_stride,
                   inv_d, eps, BLOCK_D: tl.constexpr):
    row = tl.program_id(0)
    if row < n_rows:
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        r64 = row.to(tl.int64)
        x = tl.load(x_ptr + r64 * x_stride + cols, mask=mask,
                    other=0.0).to(tl.float32)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        ms = tl.sum(x * x, axis=0) * inv_d
        y = x * tl.math.rsqrt(ms + eps) * w
        tl.store(o_ptr + r64 * o_stride + cols,
                 y.to(o_ptr.dtype.element_ty), mask=mask)
'''

_NAME = "rmsnorm_" + hashlib.sha1(SOURCE.encode()).hexdigest()[:12]
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def rmsnorm_kernel(x: torch.Tensor, w: torch.Tensor, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """Launch RMSNorm over the last axis of ``x`` with weight ``w`` (D,);
    returns a tensor of ``x``'s shape and dtype."""
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} for width {d}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: x {x.dtype}, w {w.dtype}")
    dev = x.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError("rmsnorm kernel: x and w on one CUDA device")
    rows = x.reshape(-1, d)
    if d and rows.stride(-1) != 1:
        rows = rows.contiguous()
    n_rows = rows.shape[0]
    out = torch.empty((n_rows, d), dtype=x.dtype, device=dev)
    if n_rows and d:
        mod = load_kernel(_NAME, lambda: SOURCE)
        block = 1 << (d - 1).bit_length()
        with torch.cuda.device(dev):
            mod.rmsnorm_kernel[(n_rows,)](
                rows, w.contiguous(), out, n_rows, d, rows.stride(0),
                out.stride(0), 1.0 / d, eps, BLOCK_D=block,
                num_warps=4 if block <= 2048 else 8)
    return out.reshape(x.shape)

"""Fused LayerNorm for Hopper (Triton).

Replaces the JAX package's Pallas TPU kernel ``layernorm_kernel``
(``kernels/layernorm/layernorm.py:24``): ``y = (x - mean) * rsqrt(var +
eps) * g + b`` over rows of width D, accumulated in f32 whatever the
input type, then cast to the input type.

* **What bounds it on an H100: bytes.**  One read of x, one write of y
  and ~7 flops per element: about 1-2 flops per byte.  One program per
  row holds the whole row in registers (D = 2560 on RWKV-6 3B: a 4096
  block, masked, at 8 warps), so x is read from device memory once and
  both reductions and the affine pass fuse into that one read.
* **Two passes over the row, in registers**: the mean first, then the
  variance of the centred row (the masked lanes are zeroed after
  centring), as the plain version computes it.  A one-pass
  ``E[x^2] - E[x]^2`` would cancel badly for rows far from zero mean.
* **The row count is a runtime argument** (``do_not_specialize``): the
  dynamic-shape axis is batch x sequence, and a new length launches the
  kernel already compiled.  The width D is the model's, a block size.
* **Numerics follow the plain version** (``models/layers.py``
  ``norm_apply``): each mean is the f32 sum times 1/D, as PyTorch's mean
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

__all__ = ["layernorm_kernel", "SOURCE"]

SOURCE = '''\
import triton
import triton.language as tl


@triton.jit(do_not_specialize=["n_rows"])
def layernorm_kernel(x_ptr, g_ptr, b_ptr, o_ptr, n_rows, d, x_stride,
                     o_stride, inv_d, eps, BLOCK_D: tl.constexpr):
    row = tl.program_id(0)
    if row < n_rows:
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        r64 = row.to(tl.int64)
        x = tl.load(x_ptr + r64 * x_stride + cols, mask=mask,
                    other=0.0).to(tl.float32)
        g = tl.load(g_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        mu = tl.sum(x, axis=0) * inv_d
        xc = tl.where(mask, x - mu, 0.0)
        var = tl.sum(xc * xc, axis=0) * inv_d
        y = xc * tl.math.rsqrt(var + eps) * g + b
        tl.store(o_ptr + r64 * o_stride + cols,
                 y.to(o_ptr.dtype.element_ty), mask=mask)
'''

_NAME = "layernorm_" + hashlib.sha1(SOURCE.encode()).hexdigest()[:12]
_DTYPES = (torch.float32, torch.bfloat16)


def layernorm_kernel(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *,
                     eps: float = 1e-5) -> torch.Tensor:
    """Launch LayerNorm over the last axis of ``x`` with scale ``g`` and
    bias ``b`` (D,) each; returns a tensor of ``x``'s shape and dtype."""
    d = x.shape[-1]
    if g.shape != (d,) or b.shape != (d,):
        raise ValueError(f"layernorm: scale {tuple(g.shape)}, bias "
                         f"{tuple(b.shape)} for width {d}")
    if any(t.dtype not in _DTYPES for t in (x, g, b)):
        raise TypeError(f"layernorm: x {x.dtype}, scale {g.dtype}, "
                        f"bias {b.dtype}")
    dev = x.device
    if dev.type != "cuda" or g.device != dev or b.device != dev:
        raise ValueError("layernorm kernel: x, scale and bias on one CUDA "
                         "device")
    rows = x.reshape(-1, d)
    if d and rows.stride(-1) != 1:
        rows = rows.contiguous()
    n_rows = rows.shape[0]
    out = torch.empty((n_rows, d), dtype=x.dtype, device=dev)
    if n_rows and d:
        mod = load_kernel(_NAME, lambda: SOURCE)
        block = 1 << (d - 1).bit_length()
        with torch.cuda.device(dev):
            mod.layernorm_kernel[(n_rows,)](
                rows, g.contiguous(), b.contiguous(), out, n_rows, d,
                rows.stride(0), out.stride(0), 1.0 / d, eps, BLOCK_D=block,
                num_warps=4 if block <= 2048 else 8)
    return out.reshape(x.shape)

"""RWKV-6 WKV recurrence for Hopper (CUDA C++).

Replaces the JAX package's Pallas TPU kernel ``rwkv6_kernel``
(``kernels/rwkv6/rwkv6.py:60``).  The kernel is ``csrc/rwkv6.cu`` (its
header comment holds the design and what bounds it); this module builds
it once with ``nvcc`` (``kernels/cuda_build.py``) into one small library
with a plain C entry point, and launches it through :mod:`ctypes` on
PyTorch's current stream.

The wrapper checks devices, dtypes and shapes and raises on what the
kernel does not take; it passes T, every stride and ``lens`` as runtime
arguments.  r, k, v and w are read in place through their (b, h, t)
strides when the head axis is unit-stride (the model's token-major
projections, viewed as (B, H, T, N)); y is allocated token-major,
(B, T, H, N), and returned as its (B, H, T, N) view, so the caller's
``transpose(1, 2).reshape(B, T, H * N)`` copies nothing.
"""
from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Optional, Tuple

import torch

from .. import cuda_build

__all__ = ["HEAD_SIZES", "rwkv6_kernel", "source_job"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "rwkv6.cu"

#: head sizes (K = V) the library is instantiated for
HEAD_SIZES = (16, 64)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_N_DIMS = 19

_LOCK = threading.Lock()
_FN = None


def source_job() -> Tuple[str, str, list]:
    """The ``(name, source, include_dirs)`` build job of the library (a
    caller that knows its kernels ahead builds several at once with
    ``cuda_build.build``)."""
    return "rwkv6", SOURCE.read_text(), [CSRC]


def _function():
    global _FN
    if _FN is None:
        with _LOCK:
            if _FN is None:
                lib = cuda_build.load(*source_job())
                fn = lib.disc_rwkv6
                fn.argtypes = [ctypes.c_void_p] * 10 + [
                    ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                err = lib.disc_rwkv6_error
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                _FN = (fn, err)
    return _FN


def _unit_stride(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def rwkv6_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 s0: Optional[torch.Tensor] = None,
                 lens: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the WKV recurrence on the card.

    r, k, v (B, H, T, N) of one dtype, w (B, H, T, N) (cast to f32),
    u (H, N) f32, ``s0`` (B, H, N, N) f32 or None (zeros), ``lens`` (B,)
    or None (T).  Returns ``(y, s_final)``: y (B, H, T, N) in r's dtype,
    zero at steps ``>= lens[b]``; s_final (B, H, N, N) f32.
    """
    if r.dim() != 4:
        raise ValueError(f"rwkv6: r must be (B, H, T, N), got "
                         f"{tuple(r.shape)}")
    b, h, t, n = r.shape
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"rwkv6: {name} {tuple(x.shape)} for r "
                             f"{tuple(r.shape)}")
    if u.shape != (h, n):
        raise ValueError(f"rwkv6: u {tuple(u.shape)} for {h} heads of {n}")
    if n not in HEAD_SIZES:
        raise ValueError(f"rwkv6: head size {n}; the kernel is built for "
                         f"{HEAD_SIZES}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6: r {r.dtype}, k {k.dtype}, v {v.dtype}")
    dev = r.device
    others = [k, v, w, u] + [x for x in (s0, lens) if x is not None]
    if dev.type != "cuda" or any(x.device != dev for x in others):
        raise ValueError("rwkv6 kernel: every tensor on one CUDA device")
    if s0 is not None and s0.shape != (b, h, n, n):
        raise ValueError(f"rwkv6: s0 {tuple(s0.shape)}, want "
                         f"{(b, h, n, n)}")
    if lens is not None and lens.shape != (b,):
        raise ValueError(f"rwkv6: lens {tuple(lens.shape)}, want ({b},)")
    if max(b * h * t, t * n) >= 2 ** 31:
        raise ValueError("rwkv6: extent exceeds int32")
    r, k, v = _unit_stride(r), _unit_stride(k), _unit_stride(v)
    w = _unit_stride(w.float())
    u = u.float().contiguous()
    if s0 is not None:
        s0 = s0.float().contiguous()
    if lens is not None:
        lens = lens.to(torch.int32).contiguous()
    y = torch.empty((b, t, h, n), dtype=r.dtype, device=dev).transpose(1, 2)
    s1 = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    fn, err = _function()
    dims = (ctypes.c_longlong * _N_DIMS)(
        b, h, t, n, *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *w.stride()[:3], *y.stride()[:3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if s0 is None else s0.data_ptr(),
                s1.data_ptr(), y.data_ptr(),
                None if lens is None else lens.data_ptr(), dims,
                _DTYPES[r.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6 kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return y, s1

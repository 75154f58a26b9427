"""Variable-length grouped-query flash attention for Hopper (CUDA C++).

Replaces the JAX package's Pallas TPU kernel ``flash_attention_kernel``
(``kernels/flash_attention/flash_attention.py:94``) and its decode use
(``ops.py:54`` ``flash_decode``).  The kernel is ``csrc/flash_attention.cu``
(its header comment holds the design and what bounds it); this module
builds it once with ``nvcc`` (``kernels/cuda_build.py``) into one small
library with a plain C entry point, and launches it through
:mod:`ctypes` on PyTorch's current stream.

The wrapper checks devices, dtypes and shapes and raises on what the
kernel does not take; it passes every size, stride, ``lens`` and
``q_offset`` as runtime arguments.  A tensor whose rows are not 16-byte
aligned, or whose head dim is not unit-stride, is copied contiguous
first.  The output is allocated token-major, (B, Sq, H, hd), and
returned as its (B, H, Sq, hd) view, so the caller's ``transpose(1, 2)
.reshape(B, Sq, H * hd)`` copies nothing.
"""
from __future__ import annotations

import ctypes
import math
import pathlib
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import cuda_build

__all__ = ["HEAD_DIMS", "BLOCK_Q", "BLOCK_K", "flash_attention_kernel",
           "source_job"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"

#: head dims the library is instantiated for
HEAD_DIMS = (64, 128)
#: query rows per prefill block; keys per step of both forms
BLOCK_Q, BLOCK_K = 64, 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_N_DIMS = 19

_LOCK = threading.Lock()
_FN = None


def source_job() -> Tuple[str, str, list]:
    """The ``(name, source, include_dirs)`` build job of the library (a
    caller that knows its kernels ahead builds several at once with
    ``cuda_build.build``)."""
    return "flash_attention", SOURCE.read_text(), [CSRC]


def _function():
    global _FN
    if _FN is None:
        with _LOCK:
            if _FN is None:
                lib = cuda_build.load(*source_job())
                fn = lib.disc_flash_attention
                fn.argtypes = [ctypes.c_void_p] * 7 + [
                    ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
                err = lib.disc_flash_attention_error
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                _FN = (fn, err)
    return _FN


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its head dim is unit-stride and every row starts
    on 16 bytes (the kernel moves 16-byte chunks), else a contiguous
    copy."""
    vec = 16 // t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % vec for s in t.stride()[:-1])):
        return t.contiguous()
    return t


def _rows(x: Optional[torch.Tensor], b: int, dev, what: str):
    if x is None:
        return None
    if x.shape != (b,) or x.device != dev:
        raise ValueError(f"flash attention: {what} must be a ({b},) tensor "
                         f"on {dev}, got {tuple(x.shape)} on {x.device}")
    return x.to(torch.int32).contiguous()


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           lens: Optional[torch.Tensor] = None,
                           q_offset: Union[int, torch.Tensor] = 0, *,
                           causal: bool = True,
                           decode: bool = False) -> torch.Tensor:
    """Launch ``softmax(q k^T / sqrt(hd)) v`` on the card.

    q (B, H, Sq, hd); k, v (B, Hkv, Sk, hd) with H a multiple of Hkv.
    ``lens`` (B,) masks keys ``>= lens[b]``; with ``causal``, key ``k``
    is visible to query ``i`` when ``k <= q_offset[b] + i`` (``q_offset``
    an int or a (B,) tensor).  ``decode`` takes the one-query form
    (Sq = 1, not causal).  Returns (B, H, Sq, hd) in q's dtype.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention: q, k, v must be 4-D")
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, sk, hd) or v.shape != k.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash attention: {h} heads over {hkv} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {hd}; the kernel is "
                         f"built for {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention: q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash attention kernel: q, k, v on one CUDA "
                         "device")
    if decode and (sq != 1 or causal):
        raise ValueError("flash attention: the decode form takes one "
                         "query row and no causal mask")
    if max(b * h * sq, sk) >= 2 ** 31:
        raise ValueError("flash attention: extent exceeds int32")
    lens = _rows(lens, b, dev, "lens")
    if isinstance(q_offset, torch.Tensor):
        q_offset = _rows(q_offset, b, dev, "q_offset")
    elif q_offset:
        q_offset = torch.full((b,), int(q_offset), dtype=torch.int32,
                              device=dev)
    else:
        q_offset = None
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev) \
        .transpose(1, 2)
    fn, err = _function()
    dims = (ctypes.c_longlong * _N_DIMS)(
        b, h, hkv, sq, sk, hd, int(causal), *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    scale = float(np.float32(1.0) / np.float32(math.sqrt(hd)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lens is None else lens.data_ptr(),
                None if q_offset is None else q_offset.data_ptr(),
                dims, scale, _DTYPES[q.dtype], int(decode), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return out

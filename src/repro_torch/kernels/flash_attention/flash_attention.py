"""Variable-length grouped-query flash attention for Hopper (CUDA C++).

Replaces the JAX package's Pallas TPU kernel ``flash_attention_kernel``
(``kernels/flash_attention/flash_attention.py:94``) and its decode use
(``ops.py:54`` ``flash_decode``).  The kernel is ``csrc/flash_attention.cu``
(its header comment holds the design and what bounds it: bf16 / f16
prefill on the tensor cores, f32 prefill on FFMA, decode split over the
keys); this module builds it once with ``nvcc`` (``kernels/cuda_build.py``)
into one small library with a plain C entry point, and launches it
through :mod:`ctypes` on PyTorch's current stream.

The wrapper checks devices, dtypes and shapes and raises on what the
kernel does not take; it passes every size, stride, ``lens`` and
``q_offset`` as runtime arguments.  A tensor whose rows are not 16-byte
aligned, or whose head dim is not unit-stride, is copied contiguous
first.  The output is allocated token-major, (B, Sq, H, hd), and
returned as its (B, H, Sq, hd) view, so the caller's ``transpose(1, 2)
.reshape(B, Sq, H * hd)`` copies nothing.  The decode form's split plan
comes from ``ops.decode_splits`` (the cache's extent, the batch, the kv
heads and the card's SM count; never ``lens``), and its f32 partials
from ``torch.empty`` here.

q and k share one head dim and v may have another (MLA's prefill: 192
and 128); the scale defaults to ``1 / sqrt(q's head dim)``.
:func:`mla_decode_kernel` launches the same library's MLA absorbed
decode: the 576-wide ``[q_abs | q_pe]`` query heads against the latent
cache's two leaves, read in place.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import cuda_build

__all__ = ["HEAD_DIMS", "MLA_DIMS", "BLOCK_Q", "BLOCK_K",
           "flash_attention_kernel", "mla_decode_kernel", "source_job"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"

#: (q / k, v) head dims the library is instantiated for (16 and (24, 16):
#: the reduced configs'; (192, 128): DeepSeek-V2's MLA prefill and
#: expanded decode)
HEAD_DIMS = ((16, 16), (24, 16), (64, 64), (112, 112), (128, 128),
             (192, 128))
#: (latent, rope) widths of the MLA absorbed decode: the reduced configs'
#: and DeepSeek-V2's
MLA_DIMS = ((32, 8), (512, 64))
#: query rows per prefill block; keys per step of both forms
BLOCK_Q, BLOCK_K = 64, 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_N_DIMS = 22
_N_MLA_DIMS = 17

_LOCK = threading.Lock()
_FN = None


def source_job() -> Tuple[str, str, list]:
    """The ``(name, source, include_dirs)`` build job of the library (a
    caller that knows its kernels ahead builds several at once with
    ``cuda_build.build``)."""
    return ("flash_attention", SOURCE.read_text(),
            [CSRC, cuda_build.COMMON_CSRC])


def _function():
    global _FN
    if _FN is None:
        with _LOCK:
            if _FN is None:
                lib = cuda_build.load(*source_job())
                fn = lib.disc_flash_attention
                fn.argtypes = [ctypes.c_void_p] * 7 + [
                    ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                err = lib.disc_flash_attention_error
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                mla = lib.disc_mla_decode
                mla.argtypes = [ctypes.c_void_p] * 7 + [
                    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p]
                mla.restype = ctypes.c_int
                _FN = (fn, err, mla)
    return _FN


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rows(x: Optional[torch.Tensor], b: int, dev, what: str):
    if x is None:
        return None
    if x.shape != (b,) or x.device != dev:
        raise ValueError(f"flash attention: {what} must be a ({b},) tensor "
                         f"on {dev}, got {tuple(x.shape)} on {x.device}")
    return x.to(torch.int32).contiguous()


def _scale(scale: Optional[float], hd: int) -> float:
    """The f32 softmax scale: ``scale``, or ``1 / sqrt(hd)``."""
    if scale is None:
        return float(np.float32(1.0) / np.float32(math.sqrt(hd)))
    return float(np.float32(scale))


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           lens: Optional[torch.Tensor] = None,
                           q_offset: Union[int, torch.Tensor] = 0, *,
                           causal: bool = True,
                           decode: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Launch ``softmax(q k^T * scale) v`` on the card.

    q (B, H, Sq, hd); k (B, Hkv, Sk, hd), v (B, Hkv, Sk, dv) with H a
    multiple of Hkv.  ``scale`` defaults to ``1 / sqrt(hd)``.  ``lens``
    (B,) masks keys ``>= lens[b]``; with ``causal``, key ``k`` is visible
    to query ``i`` when ``k <= q_offset[b] + i`` (``q_offset`` an int or
    a (B,) tensor).  ``decode`` takes the one-query form (Sq = 1, not
    causal).  Returns (B, H, Sq, dv) in q's dtype.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention: q, k, v must be 4-D")
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if k.shape != (b, hkv, sk, hd) or v.shape != (b, hkv, sk, dv):
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash attention: {h} heads over {hkv} kv heads")
    if (hd, dv) not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dims (q/k {hd}, v {dv}); "
                         f"the kernel is built for {HEAD_DIMS}")
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
    q, k, v = (cuda_build.aligned_rows(t) for t in (q, k, v))
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev) \
        .transpose(1, 2)
    n_split = kps = 0
    part = None
    if decode:
        from .ops import decode_splits

        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        n_split, kps = decode_splits(sk, b, hkv, _sm_count(index))
        part = torch.empty(b * h * n_split * (dv + 2), dtype=torch.float32,
                           device=dev)
    fn, err, _ = _function()
    dims = (ctypes.c_longlong * _N_DIMS)(
        b, h, hkv, sq, sk, hd, dv, int(causal), *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], n_split, kps)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lens is None else lens.data_ptr(),
                None if q_offset is None else q_offset.data_ptr(),
                dims, _scale(scale, hd), _DTYPES[q.dtype], int(decode),
                None if part is None else part.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return out


def mla_decode_kernel(q_abs: torch.Tensor, q_pe: torch.Tensor,
                      kv_c: torch.Tensor, k_pe: torch.Tensor,
                      lens: Optional[torch.Tensor],
                      scale: float) -> torch.Tensor:
    """Launch MLA's absorbed decode on the card: ``softmax((q_abs kv_c^T +
    q_pe k_pe^T) * scale) kv_c`` per query head, one kv head (the latent)
    for all of them.

    q_abs (B, 1, H, L), q_pe (B, 1, H, R); the cache's leaves kv_c (B, S,
    L) and k_pe (B, S, R), read in place; ``lens`` (B,) masks keys ``>=
    lens[b]`` (None: all S).  (L, R) must be one of :data:`MLA_DIMS`.
    Returns (B, 1, H, L) in q_abs's dtype.
    """
    if q_abs.dim() != 4 or q_pe.dim() != 4 or kv_c.dim() != 3 \
            or k_pe.dim() != 3:
        raise ValueError("mla decode: q_abs, q_pe 4-D; kv_c, k_pe 3-D")
    b, one, h, lat = q_abs.shape
    rdim = q_pe.shape[-1]
    sk = kv_c.shape[1]
    if one != 1 or q_pe.shape != (b, 1, h, rdim) \
            or kv_c.shape != (b, sk, lat) or k_pe.shape != (b, sk, rdim):
        raise ValueError(f"mla decode: q_abs {tuple(q_abs.shape)}, q_pe "
                         f"{tuple(q_pe.shape)}, kv_c {tuple(kv_c.shape)}, "
                         f"k_pe {tuple(k_pe.shape)}")
    if (lat, rdim) not in MLA_DIMS:
        raise ValueError(f"mla decode: latent {lat}, rope {rdim}; the "
                         f"kernel is built for {MLA_DIMS}")
    dt = q_abs.dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in (q_pe, kv_c, k_pe)):
        raise TypeError(f"mla decode: q_abs {dt}, q_pe {q_pe.dtype}, kv_c "
                        f"{kv_c.dtype}, k_pe {k_pe.dtype}")
    dev = q_abs.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (q_pe, kv_c, k_pe)):
        raise ValueError("mla decode kernel: every tensor on one CUDA "
                         "device")
    if max(b * h, sk) >= 2 ** 31:
        raise ValueError("mla decode: extent exceeds int32")
    lens = _rows(lens, b, dev, "lens")
    qa, qr = (cuda_build.aligned_rows(t[:, 0]) for t in (q_abs, q_pe))
    kv_c, k_pe = (cuda_build.aligned_rows(t) for t in (kv_c, k_pe))
    out = torch.empty((b, 1, h, lat), dtype=dt, device=dev)
    from .ops import decode_splits

    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    n_split, kps = decode_splits(sk, b, 1, _sm_count(index))
    part = torch.empty(b * h * n_split * (lat + 2), dtype=torch.float32,
                       device=dev)
    _, err, fn = _function()
    dims = (ctypes.c_longlong * _N_MLA_DIMS)(
        b, h, sk, lat, rdim, *qa.stride()[:2], *qr.stride()[:2],
        *kv_c.stride()[:2], *k_pe.stride()[:2], out.stride(0),
        out.stride(2), n_split, kps)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(qa.data_ptr(), qr.data_ptr(), kv_c.data_ptr(),
                k_pe.data_ptr(), out.data_ptr(),
                None if lens is None else lens.data_ptr(), dims,
                _scale(scale, lat + rdim), _DTYPES[dt], part.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"mla decode kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return out

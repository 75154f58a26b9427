"""RWKV-6 WKV recurrence for Hopper (CUDA C++).

Replaces the JAX package's Pallas TPU kernel ``rwkv6_kernel``
(``kernels/rwkv6/rwkv6.py:60``).  The kernel is ``csrc/rwkv6.cu`` (its
header comment holds the design and what bounds it); this module builds
it once with ``nvcc`` (``kernels/cuda_build.py``) into one small library
with a plain C entry point, and launches it through :mod:`ctypes` on
PyTorch's current stream.

:func:`wkv_plan` picks the instance a call runs (testable without a
card): the decode instance, one streaming pass over the state per (b, h,
column slice), up to ``DECODE_MAX_T`` steps (the engine's decode is T =
1); else the chunked instance, one launch over a (b, chunk of ``CHUNK``
steps, head) grid whose blocks hand each chunk's end state to the next
through a small ring the wrapper allocates with the ticket and flags
they synchronise on (zeroed per call).

The wrapper checks devices, dtypes and shapes and raises on what the
kernel does not take; it passes T, every stride and ``lens`` as runtime
arguments.  r, k, v and w are read in place through their (b, h, t)
strides when the head axis is unit-stride and every row starts on 16
bytes (the model's token-major projections, viewed as (B, H, T, N)),
else copied contiguous first; y is allocated token-major, (B, T, H, N),
and returned as its (B, H, T, N) view, so the caller's
``transpose(1, 2).reshape(B, T, H * N)`` copies nothing.
"""
from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from .. import cuda_build

__all__ = ["HEAD_SIZES", "CHUNK", "DECODE_MAX_T", "WkvPlan", "wkv_plan",
           "rwkv6_kernel", "source_job"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "rwkv6.cu"

#: head sizes (K = V) the library is instantiated for
HEAD_SIZES = (16, 64)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_N_DIMS = 19
#: steps a chunked block takes (csrc CHUNK): it divides the serve path's
#: prefill chunk and buckets, so a prompt prefilled in one launch or in
#: several meets the same chunk boundaries and gets the same bits
CHUNK = 64
#: the longest T the decode instance takes (csrc DECODE_MAX_T)
DECODE_MAX_T = 8
#: threads of a chunked block, a whole head, by head size: a lane holds
#: 8 x 4 (N = 64) or 2 x 4 (N = 16) of the state (csrc Lay)
_THREADS = {64: 128, 16: 32}
#: threads of a decode block (csrc Shape::DNT): a slice of the chunked
#: block's lanes
_DECODE_THREADS = 64
_INSTANCES = {"decode": 0, "chunked": 1}

_LOCK = threading.Lock()
_FN = None


class WkvPlan(NamedTuple):
    """What one WKV launch runs."""
    instance: str      # "decode" or "chunked"
    chunk: int         # steps a chunked block takes (0 for decode)
    chunks: int        # chunks of the launch (0 for decode)
    threads: int       # threads a block
    blocks: int        # blocks of the launch
    work_floats: int   # the chunked instance's hand-off ring, else 0
    sync_ints: int     # its ticket and flags (zeroed), else 0


def wkv_plan(b: int, h: int, t: int, n: int = 64) -> WkvPlan:
    """The instance and grid of a call over (B, H, T) with head size n:
    decode for T <= ``DECODE_MAX_T``, one block a (b, h, slice of the
    state's columns); else chunked, one launch of a block a (b, chunk of
    ``CHUNK`` steps, h) in ticket order, each chunk's end state handed to
    the next chunk's block through a two-slot ring of (B, H, N, N) states,
    with a ticket and a flag a (b, h).  T = 0 takes the decode instance,
    which copies s0 to the final state."""
    if n not in _THREADS:
        raise ValueError(f"rwkv6: head size {n}; the kernel is built for "
                         f"{HEAD_SIZES}")
    threads = _THREADS[n]
    if t <= DECODE_MAX_T:
        dthreads = min(threads, _DECODE_THREADS)
        return WkvPlan("decode", 0, 0, dthreads,
                       b * h * (threads // dthreads), 0, 0)
    nc = -(-t // CHUNK)
    return WkvPlan("chunked", CHUNK, nc, threads, b * nc * h,
                   2 * b * h * n * n, 1 + b * h)


def source_job() -> Tuple[str, str, list]:
    """The ``(name, source, include_dirs)`` build job of the library (a
    caller that knows its kernels ahead builds several at once with
    ``cuda_build.build``)."""
    return "rwkv6", SOURCE.read_text(), [CSRC, cuda_build.COMMON_CSRC]


def bind(lib: ctypes.CDLL):
    """``(launch, error string, chunk length)`` of a built library."""
    fn = lib.disc_rwkv6
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.disc_rwkv6_error
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    lib.disc_rwkv6_chunk.restype = ctypes.c_int
    return fn, err, lib.disc_rwkv6_chunk()


def _function():
    global _FN
    if _FN is None:
        with _LOCK:
            if _FN is None:
                fns = bind(cuda_build.load(*source_job()))
                if fns[2] != CHUNK:
                    raise RuntimeError(f"rwkv6: the library's chunk length "
                                       f"{fns[2]} is not {CHUNK}")
                _FN = fns
    return _FN


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
    r, k, v, w = (cuda_build.aligned_rows(x) for x in (r, k, v, w.float()))
    u = u.float().contiguous()
    if s0 is not None:
        s0 = s0.float().contiguous()
    if lens is not None:
        lens = lens.to(torch.int32).contiguous()
    y = torch.empty((b, t, h, n), dtype=r.dtype, device=dev).transpose(1, 2)
    s1 = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    plan = wkv_plan(b, h, t, n)
    work = (torch.empty(plan.work_floats, dtype=torch.float32, device=dev)
            if plan.work_floats else None)
    sync = (torch.zeros(plan.sync_ints, dtype=torch.int32, device=dev)
            if plan.sync_ints else None)
    fn, err, _ = _function()
    dims = (ctypes.c_longlong * _N_DIMS)(
        b, h, t, n, *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *w.stride()[:3], *y.stride()[:3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if s0 is None else s0.data_ptr(),
                s1.data_ptr(), y.data_ptr(),
                None if lens is None else lens.data_ptr(),
                None if work is None else work.data_ptr(),
                None if sync is None else sync.data_ptr(), dims,
                _DTYPES[r.dtype], _INSTANCES[plan.instance], stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6 kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return y, s1

"""Mamba-2 SSD chunked scan for Hopper (CUDA C++).

Replaces the JAX package's Pallas TPU kernel ``mamba2_kernel``
(``kernels/mamba2/mamba2.py:68``).  The kernel is ``csrc/mamba2.cu`` (its
header comment holds the design and what bounds it); this module builds
it once with ``nvcc`` (``kernels/cuda_build.py``) into one small library
with a plain C entry point, and launches it through :mod:`ctypes` on
PyTorch's current stream.

:func:`ssd_plan` picks the instance a call runs (testable without a
card): the decode instance, one streaming pass over the state per (b, h)
and step, up to ``DECODE_MAX_T`` steps (the engine's decode is T = 1);
else the chunked instance, one launch over a (b, chunk, head group) grid
whose blocks hand each chunk's end state to the next through a small
ring the wrapper allocates with the ticket and flags they synchronise
on (zeroed per call).

The wrapper checks devices, dtypes and shapes and raises on what the
kernel does not take; it passes T, every stride and ``lens`` as runtime
arguments.  x (B, H, T, P) and the decay a (B, H, T) are read in place
through their (b, h, t) strides, b and c (B, T, N) through their (b, t)
strides, so the model's token-major projections and its (B, T, 2N)
``bc`` halves are read where they lie; a tensor whose rows are not
16-byte aligned is copied contiguous first.  y is allocated token-major,
(B, T, H, P) f32, and returned as its (B, H, T, P) view, so the caller's
``transpose(1, 2).reshape(B, T, H * P)`` copies nothing.
"""
from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from .. import cuda_build
from .ref import CHUNK

__all__ = ["STATE_SHAPES", "DECODE_MAX_T", "SsdPlan", "ssd_plan",
           "mamba2_kernel", "source_job"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "mamba2.cu"

#: (N, P) state shapes the library is instantiated for
STATE_SHAPES = ((64, 64),)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_N_DIMS = 18
#: the longest T the decode instance takes (csrc DECODE_MAX_T)
DECODE_MAX_T = 8
#: heads a chunked block walks (csrc HG): at 2, a block's tiles (108 KB
#: of shared memory) leave room for two blocks an SM
HEADS_PER_BLOCK = 2
_INSTANCES = {"decode": 0, "chunked": 1}

_LOCK = threading.Lock()
_FN = None


class SsdPlan(NamedTuple):
    """What one SSD launch runs."""
    instance: str          # "decode" or "chunked"
    chunks: int            # chunks of CHUNK steps (0 for decode)
    heads_per_block: int   # heads a chunked block walks (1 for decode)
    blocks: int            # blocks of the launch
    work_floats: int       # the chunked instance's hand-off ring, else 0
    sync_ints: int         # its ticket and flags (zeroed), else 0


def ssd_plan(b: int, h: int, t: int, n: int = 64, p: int = 64) -> SsdPlan:
    """The instance and grid of a call over (B, H, T): decode for T <=
    ``DECODE_MAX_T``, one block a (b, h); else chunked, one launch of a
    block a (b, chunk, group of ``HEADS_PER_BLOCK`` heads) (the heads of
    a block share its C B^T), each chunk's end state handed to the next
    chunk's block through a two-slot ring of (B, H, N, P) states, with a
    ticket and a flag a (b, group)."""
    if t <= DECODE_MAX_T:
        return SsdPlan("decode", 0, 1, b * h, 0, 0)
    heads = HEADS_PER_BLOCK
    nc = -(-t // CHUNK)
    groups = -(-h // heads)
    return SsdPlan("chunked", nc, heads, b * nc * groups, 2 * b * h * n * p,
                   1 + b * groups)


def source_job() -> Tuple[str, str, list]:
    """The ``(name, source, include_dirs)`` build job of the library (a
    caller that knows its kernels ahead builds several at once with
    ``cuda_build.build``)."""
    return "mamba2", SOURCE.read_text(), [CSRC, cuda_build.COMMON_CSRC]


def _function():
    global _FN
    if _FN is None:
        with _LOCK:
            if _FN is None:
                lib = cuda_build.load(*source_job())
                fn = lib.disc_mamba2
                fn.argtypes = [ctypes.c_void_p] * 11 + [
                    ctypes.c_int] * 2 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                err = lib.disc_mamba2_error
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                _FN = (fn, err)
    return _FN


def mamba2_kernel(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, s0: Optional[torch.Tensor] = None,
                  lens: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the SSD scan on the card.

    x (B, H, T, P) and b, c (B, T, N) of one dtype, a (B, H, T) (cast to
    f32), ``s0`` (B, H, N, P) f32 or None (zeros), ``lens`` (B,) or None
    (T).  Returns ``(y, s_final)``: y (B, H, T, P) f32, zero at steps
    ``>= lens[b]``; s_final (B, H, N, P) f32.
    """
    if x.dim() != 4:
        raise ValueError(f"mamba2: x must be (B, H, T, P), got "
                         f"{tuple(x.shape)}")
    bs, h, t, p = x.shape
    if b.dim() != 3 or b.shape[:2] != (bs, t) or c.shape != b.shape:
        raise ValueError(f"mamba2: b {tuple(b.shape)}, c {tuple(c.shape)} "
                         f"for x {tuple(x.shape)}; want (B, T, N)")
    n = b.shape[-1]
    if a.shape != (bs, h, t):
        raise ValueError(f"mamba2: a {tuple(a.shape)}, want {(bs, h, t)}")
    if (n, p) not in STATE_SHAPES:
        raise ValueError(f"mamba2: state {n} x {p}; the kernel is built "
                         f"for {STATE_SHAPES}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"mamba2: x {x.dtype}, b {b.dtype}, c {c.dtype}")
    dev = x.device
    others = [a, b, c] + [v for v in (s0, lens) if v is not None]
    if dev.type != "cuda" or any(v.device != dev for v in others):
        raise ValueError("mamba2 kernel: every tensor on one CUDA device")
    if s0 is not None and s0.shape != (bs, h, n, p):
        raise ValueError(f"mamba2: s0 {tuple(s0.shape)}, want "
                         f"{(bs, h, n, p)}")
    if lens is not None and lens.shape != (bs,):
        raise ValueError(f"mamba2: lens {tuple(lens.shape)}, want ({bs},)")
    if max(bs * h, t) >= 2 ** 31:
        raise ValueError("mamba2: extent exceeds int32")
    x, b, c = (cuda_build.aligned_rows(t) for t in (x, b, c))
    a = a.float()
    if s0 is not None:
        s0 = s0.float().contiguous()
    if lens is not None:
        lens = lens.to(torch.int32).contiguous()
    y = torch.empty((bs, t, h, p), dtype=torch.float32,
                    device=dev).transpose(1, 2)
    s1 = torch.empty((bs, h, n, p), dtype=torch.float32, device=dev)
    plan = ssd_plan(bs, h, t, n, p)
    work = (torch.empty(plan.work_floats, dtype=torch.float32, device=dev)
            if plan.work_floats else None)
    sync = (torch.zeros(plan.sync_ints, dtype=torch.int32, device=dev)
            if plan.sync_ints else None)
    fn, err = _function()
    dims = (ctypes.c_longlong * _N_DIMS)(
        bs, h, t, n, p, *x.stride()[:3], *a.stride(), *b.stride()[:2],
        *c.stride()[:2], *y.stride()[:3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                None if s0 is None else s0.data_ptr(), s1.data_ptr(),
                y.data_ptr(), None if lens is None else lens.data_ptr(),
                None if work is None else work.data_ptr(),
                None if sync is None else sync.data_ptr(), dims,
                _DTYPES[x.dtype], _INSTANCES[plan.instance], stream)
    if rc != 0:
        raise RuntimeError(f"mamba2 kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return y, s1

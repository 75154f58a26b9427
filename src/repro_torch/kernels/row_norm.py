"""The plan and launch of the row normalisations (CUDA C++), shared by the
RMSNorm and LayerNorm kernels.

The kernels are ``common/csrc/row_norm.cuh`` (its header comment holds the
design, what bounds them and their numerics).  Each norm is built once with
``nvcc`` (``kernels/cuda_build.py``) into a small library with a plain C
entry point (``rmsnorm/csrc/rmsnorm.cu``, ``layernorm/csrc/layernorm.cu``)
and launched through :mod:`ctypes` on PyTorch's current stream.

:func:`norm_plan` says how one launch covers the rows (testable without a
card): a group of threads a row, each holding a few chunks of the row in
registers at the row's exact width, groups a block, and a grid sized to
the card for many rows (each group walks rows, holding its weight chunks
across them) or to the rows for few.  A row wider than registers hold
takes the loop instance, a block a row that reads the row in passes.  The
row count and the row stride are runtime arguments; the width picks only
the plan, and every width has one.

:func:`launch` reads x in place through its row stride (a tensor whose
rows are not one stride apart is copied first), allocates nothing but the
output, and takes the one-column instance for rows that are not 16-byte
readable rather than copying them.  The callers (``rmsnorm/rmsnorm.py``,
``layernorm/layernorm.py``) check dtypes, device and weight shapes.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import cuda_build

__all__ = ["NormPlan", "norm_plan", "launch_word", "launch", "source_job",
           "DTYPES"]

KERNELS = pathlib.Path(__file__).resolve().parent

#: dtype codes of the C entry (x, weight and bias)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: threads a row at most (csrc kNormThreads), and the loop instance's
#: threads, a block a row
MAX_GROUP = LOOP_THREADS = 512
#: chunks a thread holds at most in registers (csrc kNormChunks), and
#: values: RMSNorm / LayerNorm, whose bias beside the scale takes registers
#: (csrc kNormElemsRms, kNormElemsLn)
MAX_CHUNKS = 8
MAX_ELEMS = {False: 32, True: 24}
#: chunks a thread aims at: 2 for fewer rows than the card has SMs
#: (decode: a short chain from load to store), 4 for more; a group stays
#: at GROUP_CAP threads where its values allow more chunks a thread
#: (candidates timed with ``tools/row_norm_tune.py``, PERF.md §6)
DECODE_CHUNKS, PREFILL_CHUNKS, GROUP_CAP = 2, 4, 256
#: threads a block where a group is narrower
BLOCK_THREADS = 128
#: a walking grid keeps SM_GROUPS groups an SM, and at least SM_THREADS
#: threads; an SM holds MAX_SM_THREADS (the grid stops at the card's
#: share, and each group takes several rows in turn)
SM_GROUPS, SM_THREADS, MAX_SM_THREADS = 8, 512, 2048

_LOCK = threading.Lock()
_FNS: Dict[str, tuple] = {}
_SMS: Dict[int, int] = {}


class NormPlan(NamedTuple):
    """How one launch covers R rows of D columns."""
    vec: int        # consecutive columns a chunk (1, or 16 bytes' worth)
    chunks: int     # chunks a thread (the loop instance: a pass)
    group: int      # threads a row (a power of two, 1 to 512)
    rows: int       # rows (groups) a block
    threads: int    # threads a block: rows x group, a multiple of 32
    grid: int       # blocks
    loop: bool      # the loop instance (rows wider than registers hold)
    walk: bool      # groups take several rows (the grid does not cover them)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=512)
def norm_plan(n_rows: int, d: int, elt: int = 4, wide: bool = True,
              sms: int = 132, layernorm: bool = False) -> NormPlan:
    """The plan for ``n_rows`` x ``d`` of ``elt``-byte elements on a card
    of ``sms`` SMs.  ``wide``: the rows may be read in 16-byte chunks (x
    and its row stride 16-byte aligned); a width that is not a multiple of
    16 / ``elt`` is read a column a chunk all the same.  The group is the
    smallest power of two of threads whose chunks, ``DECODE_CHUNKS`` a
    thread below ``sms`` rows, else ``PREFILL_CHUNKS``, cover the row's
    units, but no wider than ``GROUP_CAP`` where more chunks a thread fit
    (at most ``MAX_CHUNKS``, and ``MAX_ELEMS[layernorm]`` values); the
    chunks then cover the units once, the last one partly.  Groups
    narrower than ``BLOCK_THREADS`` share a block.  The grid covers the
    rows, but stops at ``SM_GROUPS`` groups an SM, at least ``SM_THREADS``
    and at most ``MAX_SM_THREADS`` threads: each group then takes
    every ``grid x rows``-th row, the grid chosen so that every group
    takes as many.  A row that would need more than ``MAX_CHUNKS`` chunks
    or ``MAX_ELEMS[layernorm]`` values a thread at 512 threads takes the
    loop instance, one block of 512 threads a row, ``chunks`` loads a
    thread a pass."""
    step = 16 // elt
    vec = step if wide and d % step == 0 else 1
    units = -(-d // vec)
    most = min(MAX_CHUNKS, MAX_ELEMS[layernorm] // vec)   # chunks a thread
    target = DECODE_CHUNKS if n_rows < sms else PREFILL_CHUNKS
    group = _pow2(-(-units // max(1, min(target, most))))
    if group > GROUP_CAP:               # more chunks a thread, not threads
        group = max(GROUP_CAP, _pow2(-(-units // max(1, most))))
    group = min(MAX_GROUP, group)
    chunks = -(-units // group)
    if chunks > MAX_CHUNKS or vec * chunks > MAX_ELEMS[layernorm]:
        grid = max(1, min(n_rows, sms * MAX_SM_THREADS // LOOP_THREADS))
        return NormPlan(vec, -(-units // LOOP_THREADS), LOOP_THREADS, 1,
                        LOOP_THREADS, grid, True, grid < n_rows)
    rows = max(1, BLOCK_THREADS // group)
    threads = rows * group
    sm_threads = min(MAX_SM_THREADS, max(SM_THREADS, SM_GROUPS * group))
    blocks = max(1, -(-n_rows // rows))
    cap = sms * max(1, sm_threads // threads)
    walk = -(-blocks // cap)
    grid = -(-blocks // walk)
    return NormPlan(vec, chunks, group, rows, threads, grid, False,
                    grid * rows < n_rows)


def launch_word(plan: NormPlan, xdt: int, wdt: int, bdt: int = 0) -> int:
    """The C entry's ``cfg`` but its weight path: the dtype codes and the
    plan in one int (``row_norm.cuh`` ``norm_entry`` gives the bits)."""
    return (xdt | wdt << 2 | bdt << 4 | int(plan.vec > 1) << 6
            | int(plan.loop) << 7 | (0 if plan.loop else plan.chunks) << 8
            | (plan.group.bit_length() - 1) << 12 | plan.rows << 16
            | int(plan.walk) << 26)


@functools.lru_cache(maxsize=512)
def _word(kind: str, n_rows: int, d: int, elt: int, wide: bool, sms: int,
          codes: Tuple[int, int, int]) -> Tuple[int, int]:
    plan = norm_plan(n_rows, d, elt, wide, sms,
                     layernorm=kind == "layernorm")
    return launch_word(plan, *codes), plan.grid


def _weight_path(word: int, codes: Tuple[int, int, int], w: torch.Tensor,
                 b: Optional[torch.Tensor]) -> int:
    """The instance's weight path (``row_norm.cuh`` ``load_weight_sel``):
    0 reads an f32 weight (and bias) in whole chunks, where the rows are
    read in 16-byte chunks and the weight and bias are 16-byte aligned, as
    in every model; else 1, an element a load."""
    _, wdt, bdt = codes
    whole = (word >> 6 & 1 and wdt == 0 and w.data_ptr() % 16 == 0
             and (b is None or (bdt == 0 and b.data_ptr() % 16 == 0)))
    return 0 if whole else 1


def source_job(kind: str) -> Tuple[str, str, list]:
    """The ``(name, source, include_dirs)`` build job of ``kind``'s
    library (``"rmsnorm"`` or ``"layernorm"``)."""
    csrc = KERNELS / kind / "csrc"
    return (kind, (csrc / f"{kind}.cu").read_text(),
            [csrc, cuda_build.COMMON_CSRC])


def _function(kind: str):
    fns = _FNS.get(kind)
    if fns is None:
        with _LOCK:
            fns = _FNS.get(kind)
            if fns is None:
                lib = cuda_build.load(*source_job(kind))
                fn = getattr(lib, f"disc_{kind}")
                fn.argtypes = ([ctypes.c_void_p] * 4
                               + [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_float,
                                  ctypes.c_void_p])
                fn.restype = ctypes.c_int
                err = getattr(lib, f"disc_{kind}_error")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                fns = _FNS[kind] = (fn, err)
    return fns


def _sms(index: int) -> int:
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def launch(kind: str, x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor], eps: float,
           codes: Tuple[int, int, int]) -> torch.Tensor:
    """One launch of ``kind``'s kernel over the last axis of the CUDA
    tensor ``x`` with weight ``w`` (and bias ``b``), each (D,); ``codes``
    the dtype codes of x, w and b.  Returns a tensor of ``x``'s shape and
    dtype."""
    d = x.shape[-1]
    if x.is_contiguous():
        rows, xs = x, d
        n_rows = x.numel() // d if d else 0
    else:
        rows = x.reshape(-1, d)
        if d and rows.stride(-1) != 1:
            rows = rows.contiguous()
        n_rows, xs = rows.shape[0], rows.stride(0)
    dev = x.device
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if not (n_rows and d):
        return out
    if not w.is_contiguous():
        w = w.contiguous()
    if b is not None and not b.is_contiguous():
        b = b.contiguous()
    ptr = rows.data_ptr()
    elt = x.element_size()
    wide = ptr % 16 == 0 and (n_rows == 1 or xs * elt % 16 == 0)
    idx = dev.index
    word, grid = _word(kind, n_rows, d, elt, wide, _sms(idx), codes)
    word |= _weight_path(word, codes, w, b) << 24
    fn, err = _function(kind)
    args = (ptr, w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), n_rows, d, xs, word, grid, eps,
            torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{kind} kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return out

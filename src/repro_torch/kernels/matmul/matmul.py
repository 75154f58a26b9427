"""Blocked GEMM with a fused elementwise epilogue for Hopper — DISC §4.3
kDot codegen and the §4.5 library GEMM.

Replaces the JAX package's Pallas TPU kernels ``matmul_epilogue_kernel``
(``kernels/matmul/matmul.py:116``, kDot) and ``matmul_kernel`` (``:54``,
the library GEMM).  Both are one CUDA C++ template for ``sm_90a``,
``csrc/gemm.cuh``; this module generates, per cluster program, the
``.cu`` file that instantiates it with the program's epilogue, builds it
with ``nvcc`` (``kernels/cuda_build.py``) and launches it through
:mod:`ctypes` on PyTorch's current stream.

* **The epilogue.**  The cluster's elementwise ops after the dot arrive
  as a :class:`~repro_torch.kernels.program.Program` whose input 0 is the
  accumulator, cast to the dot's dtype first (the reference's
  ``acc_dtype``), and whose other inputs are the (M, N) extras.
  :func:`~repro_torch.kernels.program.cuda_lines` generates it as a
  ``__device__`` functor with eager's per-op numerics; it writes one
  (M, N) output per program output.  The identical clusters of every
  layer share one library, named by the program's fingerprint.
* **Extras** are read in place through their strides: a broadcast view
  (a bias row, stride 0 along M) is never materialised.
* **Lengths are runtime ints** (M, N, K, the valid ``valid_mnk``, every
  stride, the split): a new length inside a bucket, or a new bucket,
  launches the library already built.  Nothing past the valid extents
  enters the contraction, the M/N tails are exact zeros, and the padded
  operands are read as they are (the reference pads to block multiples
  on the host).
* **What bounds it on an H100: operations.**  At the path's shapes
  (T × 2048 × 5632 and T × 5632 × 2048) the GEMM does some 700 flops
  per byte it must move, above the card's balance point.  bf16 / f16
  operands run on ``wgmma`` fed by a TMA ring (:data:`WGMMA_TILES`:
  128 × BN tiles, K steps of 64, a producer thread and two consumer
  warpgroups), toward the 989 TFLOP/s dense tensor-core rate.  Their
  tensor maps are encoded on every call over the valid extents, so TMA
  fills every tail with zeros; A must be K-contiguous and B
  N-contiguous, 16-byte aligned with row strides of a multiple of 16
  bytes (:func:`tma_ready`), and other layouts are copied once first
  (counted in ``ops.OPERAND_COPIES``).  f32 operands run in IEEE f32 FFMA
  on the CUDA cores (as the reference contracts, never TF32), bounded by
  FFMA issue at 67 TFLOP/s; shared memory's 128 bytes an SM a cycle feed
  the fragments, all of them at that rate for 8 × 8 outputs a thread,
  three quarters for 8 × 16.  :data:`TILES` gives the kDot (and
  ``square_big``) 128 × 256 block tiles of 32 × 128 warp tiles, 8 × 16
  outputs a thread, one block an SM, K steps of 32 in a 4-stage ring (B
  by 16-byte ``cp.async``, A one step ahead through registers into a
  swizzled k-major tile), unmasked loads in blocks inside the valid
  extents, and the f32 tile walked row by row for the epilogue.  Operands
  that are K- / N-contiguous, 16-byte aligned, with rows a multiple of 4
  floats apart are read 16 bytes a thread; any other strides take the
  same kernel's element-by-element instance (:func:`ffma_operands`;
  counted in ``ops.FFMA_SCALAR_LAUNCHES``), never a copy.
* **Split-K** (:func:`gemm_splits`): where the valid output tiles leave
  SMs idle (the small §4.5 shapes, path 2's small buckets) K is cut
  into ranges of whole K steps, each block writes an f32 partial tile
  into a workspace this module allocates, and a second kernel of the
  same library sums the ranges in a fixed order and applies the
  epilogue: deterministic, no atomics.

Each tile name has one shape per body: ``"kdot"`` for the fused entry
and one per §4.5 library version (``ops.GEMM_LIBRARY`` keeps the
reference's version names and divisibility rules; edge handling makes
any tile exact on any shape).  :func:`gemm_plan` says which body, tile
and split a call takes.
"""
from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from .. import cuda_build
from ..program import (Program, cuda_lines, cuda_load, cuda_store,
                       cuda_type)
from .ops import BODY_LAUNCHES, FFMA_SCALAR_LAUNCHES, OPERAND_COPIES

__all__ = ["TILES", "WGMMA_TILES", "INCLUDE_DIRS", "GemmPlan", "gemm_splits",
           "gemm_plan", "tma_ready", "ffma_operands",
           "matmul_epilogue_kernel",
           "matmul_kernel", "identity_program", "kernel_source", "prebuild"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: the include directories of every generated source (``gemm.cuh`` and
#: the shared ``tma_sm90.cuh``)
INCLUDE_DIRS = [CSRC, cuda_build.COMMON_CSRC]

#: f32 (FFMA) body: tile name -> (BM, BN, BK, TM, TN, STAGES, MINB): block
#: tile, K step, outputs per thread, ring stages and blocks an SM.
#: Threads per block = (BM / TM) * (BN / TN); the launch bound caps a
#: thread's registers at 65536 / (threads * MINB).
#: Each the fastest of ``tune.CANDIDATES`` at its shapes (PERF.md).
TILES: Dict[str, Tuple[int, ...]] = {
    "kdot": (128, 256, 32, 8, 16, 4, 1),
    "square_big": (128, 256, 32, 8, 16, 4, 1),
    "balanced": (128, 64, 32, 8, 4, 3, 2),
    "skinny_m": (32, 64, 16, 4, 4, 4, 4),
    "skinny_n": (64, 32, 16, 4, 4, 4, 2),
    "deep_k": (64, 64, 32, 4, 4, 4, 2),
}

#: bf16 / f16 (wgmma) body: tile name -> (BM, BN, STAGES): a 128 x BN
#: block tile (two consumer warpgroups of 64 rows), K steps of
#: :data:`WGMMA_BK`, a ring of STAGES stages; one block an SM.  The small
#: library shapes fill the card through split-K, not through the tile,
#: where 128 x 64 tiles (more tiles, fewer splits) measured faster than
#: 128 x 128 (PERF.md).
WGMMA_TILES: Dict[str, Tuple[int, int, int]] = {
    "kdot": (128, 256, 4),
    "square_big": (128, 256, 4),
    "balanced": (128, 64, 8),
    "skinny_m": (128, 64, 8),
    "skinny_n": (128, 64, 8),
    "deep_k": (128, 64, 8),
}
WGMMA_BK = 64
#: SMs of an H100 SXM; the wrapper asks the device for its own count
SMS = 132


#: the tile instances each kind of library carries
KDOT_TILES = ("kdot",)
LIBRARY_TILES = ("square_big", "balanced", "skinny_m", "skinny_n", "deep_k")

_OPERAND_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_WGMMA_DTYPES = (torch.bfloat16, torch.float16)  # run on wgmma
_ACC_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_N_DIMS = 12  # M N K vm vn vk sam sak sbk sbn splits kchunk


def gemm_splits(m_tiles: int, n_tiles: int, vk: int, bk: int,
                sms: int = SMS) -> int:
    """How many K ranges, each a whole number of ``bk`` steps and none
    empty, a GEMM of ``m_tiles`` x ``n_tiles`` working output tiles and
    valid depth ``vk`` is cut into so that tiles x splits about fill
    ``sms`` block slots; 1 where the tiles already do (or K is one
    step)."""
    k_steps = -(-vk // bk)
    tiles = m_tiles * n_tiles
    if tiles == 0 or k_steps <= 1 or 2 * tiles > sms:
        return 1
    per = -(-k_steps // min(sms // tiles, k_steps))
    return -(-k_steps // per)


def split_chunk(vk: int, bk: int, splits: int) -> int:
    """K elements per range of a ``splits``-way split: whole ``bk`` steps,
    the last range the shortest."""
    k_steps = max(1, -(-vk // bk))
    return -(-k_steps // splits) * bk


class GemmPlan(NamedTuple):
    """What one GEMM launch runs."""
    body: str                # "wgmma" (bf16 / f16) or "ffma" (f32)
    tile: Tuple[int, ...]    # WGMMA_TILES or TILES entry
    bk: int                  # K step
    splits: int              # K ranges (1: no split, no workspace)
    kchunk: int              # K elements per range


def gemm_plan(dtype: torch.dtype, tile: str, vm: int, vn: int, vk: int,
              sms: int = SMS) -> GemmPlan:
    """The body, tile and split of a launch at ``tile`` over valid extents
    (vm, vn, vk): only blocks inside (vm, vn) do work, so they are the
    tiles that must fill the SMs (one wgmma block an SM, the FFMA tile's
    MINB)."""
    if dtype in _WGMMA_DTYPES:
        body, shape, bk, slots = "wgmma", WGMMA_TILES[tile], WGMMA_BK, sms
    else:
        body, shape = "ffma", TILES[tile]
        bk, slots = shape[2], shape[6] * sms
    bm, bn = shape[0], shape[1]
    splits = gemm_splits(-(-vm // bm), -(-vn // bn), vk, bk, slots)
    return GemmPlan(body, shape, bk, splits, split_chunk(vk, bk, splits))


def tma_ready(shape: Sequence[int], strides: Sequence[int], address: int,
              element_size: int) -> bool:
    """Whether a 2-D operand is read in place by the wgmma body's TMA
    loads: unit stride along its second axis, a 16-byte-aligned start,
    and rows a multiple of 16 bytes apart that do not overlap (one row,
    or one column, needs no stride there)."""
    rows, cols = shape
    s_row, s_col = strides
    if cols > 1 and s_col != 1:
        return False
    if address % 16:
        return False
    return rows <= 1 or (s_row * element_size % 16 == 0 and s_row >= cols)


def _tma_operand(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``t`` (copied once, and counted, where :func:`tma_ready` refuses
    it) and its row stride in elements, for the wgmma body."""
    vec = 16 // t.element_size()
    rows, cols = t.shape
    if not tma_ready(t.shape, t.stride(), t.data_ptr(), t.element_size()):
        out = torch.empty((rows, -(-cols // vec) * vec), dtype=t.dtype,
                          device=t.device)[:, :cols]
        out.copy_(t)
        OPERAND_COPIES.launches += 1
        t = out
    return t, (t.stride(0) if rows > 1 else -(-max(cols, 1) // vec) * vec)


def _row_strides(t: torch.Tensor) -> Tuple[int, int]:
    """``t``'s strides, with the stride of an axis of extent 1 (never
    stepped) given as 0 along rows and 1 along columns."""
    rows, cols = t.shape
    return (t.stride(0) if rows > 1 else 0, t.stride(1) if cols > 1 else 1)


def ffma_operands(a: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[bool, Tuple[int, int], Tuple[int, int]]:
    """Which f32 instance reads ``a`` (M, K) and ``b`` (K, N) in place:
    the 16-byte one where both pass :func:`tma_ready` (unit stride along
    the contiguous axis, a 16-byte-aligned start, rows a multiple of 4
    floats apart), else the element-by-element one; and the strides the
    kernel is given."""
    vec = all(tma_ready(t.shape, t.stride(), t.data_ptr(), t.element_size())
              for t in (a, b))
    return vec, _row_strides(a), _row_strides(b)


_SM_COUNTS: Dict[int, int] = {}


def _sms(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNTS[index]


_LOCK = threading.Lock()
_FNS: Dict[Tuple, object] = {}


def identity_program(dtype: torch.dtype) -> Program:
    """The empty epilogue: store the accumulator cast to ``dtype``."""
    return Program((dtype,), (), (("in", 0),))


def kernel_source(program: Program, dtype: torch.dtype,
                  tiles: Sequence[str]) -> Tuple[str, str]:
    """``(name, .cu text)`` of the library instantiating the GEMM for
    operands of ``dtype`` with ``program`` as epilogue, at ``tiles``."""
    acc_dt = program.in_dtypes[0]
    if dtype not in _OPERAND_DTYPES:
        raise TypeError(f"GEMM kernel: no operand type {dtype}")
    if acc_dt not in _ACC_DTYPES:
        raise TypeError(f"GEMM kernel: no accumulator type {acc_dt}")
    n_in = len(program.in_dtypes)
    acc = {torch.float32: "acc", torch.bfloat16: "disc::round_bf16(acc)",
           torch.float16: "disc::round_f16(acc)"}[acc_dt]
    loaded = ["v0"] + [f"v{i}" for i in range(1, n_in)]
    body, outs = cuda_lines(program, loaded, indent="    ")
    L = ['#include "gemm.cuh"', "", "struct Epi {"]
    for i in range(1, n_in):
        L.append(f"  const {cuda_type(program.in_dtypes[i])}* x{i};")
        L.append(f"  long long x{i}_sm, x{i}_sn;")
    for k, dt in enumerate(program.out_dtypes):
        L.append(f"  {cuda_type(dt)}* o{k};")
    # the extras' stored values at one (m, n): load() reads them, apply()
    # computes and stores (only where ``inside``; zeros where not
    # ``keep``) without a branch, so a caller can issue a batch of loads
    # before the batch's stores (the outputs may alias the extras for all
    # the compiler knows, so it keeps a load after every earlier store)
    # and the batch's arithmetic interleaves
    L += ["  long long ld;", "  struct In {"]
    for i in range(1, n_in):
        L.append(f"    {cuda_type(program.in_dtypes[i])} x{i};")
    L += ["  };",
          "  __device__ __forceinline__ In load(int m, int n) const {",
          "    In r;"]
    for i in range(1, n_in):
        L.append(f"    r.x{i} = x{i}[(long long)m * x{i}_sm + "
                 f"(long long)n * x{i}_sn];")
    L += ["    return r;", "  }",
          "  __device__ __forceinline__ void apply(int m, int n, float acc, "
          "bool keep, bool inside, const In& in) const {",
          "    const long long o = (long long)m * ld + n;",
          f"    const float v0 = {acc};"]
    for i in range(1, n_in):
        dt = program.in_dtypes[i]
        L.append(f"    const auto v{i} = {cuda_load(dt, f'in.x{i}')};")
    L += body
    L.append("    if (inside) {")
    for k, (name, dt) in enumerate(zip(outs, program.out_dtypes)):
        L.append(f"      o{k}[o] = keep ? {cuda_store(dt, name)} : "
                 f"{cuda_store(dt, '0')};")
    L += ["    }", "  }",
          "  __device__ __forceinline__ void operator()(int m, int n, "
          "float acc, bool keep) const {",
          "    apply(m, n, acc, keep, true, keep ? load(m, n) : In{});",
          "  }", "};", "",
          'extern "C" int disc_gemm(const void* a, const void* b, '
          "const void* const* extras, const long long* xstrides, "
          "void* const* outs, const long long* dims, int tile, "
          "float* ws, void* stream) {",
          "  disc::GemmArgs g;",
          "  g.M = (int)dims[0]; g.N = (int)dims[1]; g.K = (int)dims[2];",
          "  g.vm = (int)dims[3]; g.vn = (int)dims[4]; g.vk = (int)dims[5];",
          "  g.sam = dims[6]; g.sak = dims[7]; g.sbk = dims[8]; "
          "g.sbn = dims[9];",
          "  g.splits = (int)dims[10]; g.kchunk = (int)dims[11];",
          "  Epi epi;"]
    for i in range(1, n_in):
        ct = cuda_type(program.in_dtypes[i])
        L.append(f"  epi.x{i} = static_cast<const {ct}*>(extras[{i - 1}]);")
        L.append(f"  epi.x{i}_sm = xstrides[{2 * (i - 1)}]; "
                 f"epi.x{i}_sn = xstrides[{2 * (i - 1) + 1}];")
    for k, dt in enumerate(program.out_dtypes):
        L.append(f"  epi.o{k} = static_cast<{cuda_type(dt)}*>(outs[{k}]);")
    ct = cuda_type(dtype)
    L += ["  epi.ld = g.N;",
          f"  const {ct}* A = static_cast<const {ct}*>(a);",
          f"  const {ct}* B = static_cast<const {ct}*>(b);",
          "  cudaStream_t s = static_cast<cudaStream_t>(stream);",
          "  switch (tile) {"]
    for t, tname in enumerate(tiles):
        if dtype in _WGMMA_DTYPES:
            bm, bn, stages = WGMMA_TILES[tname]
            cases = [(t, f"launch_gemm_wgmma<{bm}, {bn}, {stages}>", "")]
        else:
            shape = ", ".join(map(str, TILES[tname]))
            cases = [(2 * t, f"launch_gemm<{shape}, true>", ", 16-byte"),
                     (2 * t + 1, f"launch_gemm<{shape}, false>",
                      ", element by element")]
        for case, launch, note in cases:
            L.append(f"    case {case}: return (int)disc::{launch}(A, B, g, "
                     f"epi, ws, s);  // {tname}{note}")
    L += ["  }", "  return (int)cudaErrorInvalidValue;", "}", ""]
    name = f"gemm_{program.key}_{str(dtype).split('.')[-1]}_" + \
        "-".join(tiles)
    return name, "\n".join(L)


def _bind(lib: ctypes.CDLL):
    fn = lib.disc_gemm
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.disc_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _function(program: Program, dtype: torch.dtype, tiles: Tuple[str, ...]):
    key = (program.key, dtype, tiles)
    hit = _FNS.get(key)
    if hit is None:
        with _LOCK:
            hit = _FNS.get(key)
            if hit is None:
                name, src = kernel_source(program, dtype, tiles)
                hit = _FNS[key] = _bind(
                    cuda_build.load(name, src, INCLUDE_DIRS))
    return hit


def prebuild(jobs: Sequence[Tuple[Program, torch.dtype, Sequence[str]]]
             ) -> None:
    """Build the libraries for ``(program, operand dtype, tiles)`` jobs at
    once, one ``nvcc`` each, before their first launch."""
    sources = [kernel_source(p, dt, tuple(t)) for p, dt, t in jobs]
    cuda_build.build([(n, s, INCLUDE_DIRS) for n, s in sources])


def _tiles_for(tile: str) -> Tuple[Tuple[str, ...], int]:
    group = KDOT_TILES if tile in KDOT_TILES else LIBRARY_TILES
    if tile not in group:
        raise ValueError(f"unknown GEMM tile {tile!r}; known: {list(TILES)}")
    return group, group.index(tile)


def matmul_epilogue_kernel(a: torch.Tensor, b: torch.Tensor,
                           extras: Sequence[torch.Tensor], program: Program,
                           valid_mnk: Sequence[int],
                           out_dtypes: Sequence[torch.dtype],
                           tile: str = "kdot") -> List[torch.Tensor]:
    """Launch ``a (M, K) @ b (K, N)`` with ``program`` as epilogue (CUDA).

    ``extras`` are tensors broadcastable to (M, N), read through their
    strides; ``valid_mnk`` the actual sizes.  Returns one dense (M, N)
    tensor per ``out_dtypes`` entry, zero where m >= valid M or
    n >= valid N.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"GEMM operands {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"GEMM operands of {a.dtype} and {b.dtype}")
    dev = a.device
    if dev.type != "cuda" or b.device != dev or \
            any(x.device != dev for x in extras):
        raise ValueError("GEMM kernel: every operand on one CUDA device")
    m, k = a.shape
    n = b.shape[1]
    vm, vn, vk = (int(v) for v in valid_mnk)
    if not (0 <= vm <= m and 0 <= vn <= n and 0 <= vk <= k):
        raise ValueError(f"valid {valid_mnk} outside ({m}, {n}, {k})")
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"GEMM extent ({m}, {n}, {k}) exceeds int32")
    if len(program.in_dtypes) != 1 + len(extras):
        raise ValueError(f"epilogue takes {len(program.in_dtypes) - 1} "
                         f"extras, got {len(extras)}")
    views = [torch.broadcast_to(x, (m, n)) for x in extras]
    for i, x in enumerate(views):
        if x.dtype != program.in_dtypes[i + 1]:
            raise TypeError(f"extra {i} is {x.dtype}, the epilogue reads "
                            f"{program.in_dtypes[i + 1]}")
    if tuple(out_dtypes) != program.out_dtypes:
        raise TypeError(f"out_dtypes {tuple(out_dtypes)} != the program's "
                        f"{program.out_dtypes}")
    outs = [torch.empty((m, n), dtype=dt, device=dev) for dt in out_dtypes]
    if m == 0 or n == 0:
        return outs
    tiles, index = _tiles_for(tile)
    fn, err = _function(program, a.dtype, tiles)
    plan = gemm_plan(a.dtype, tile, vm, vn, vk, _sms(dev))
    scalar = False  # the FFMA body's element-by-element instance
    if plan.body == "wgmma":
        a_strides, b_strides = a.stride(), b.stride()
        if min(vm, vn, vk) > 0:
            a, lda = _tma_operand(a)
            b, ldb = _tma_operand(b)
            a_strides, b_strides = (lda, 1), (ldb, 1)
    else:
        vec, a_strides, b_strides = ffma_operands(a, b)
        scalar = not vec
        index = 2 * index + scalar
    ws = (torch.empty((plan.splits, m, n), dtype=torch.float32, device=dev)
          if plan.splits > 1 else None)
    ptrs = (ctypes.c_void_p * max(1, len(views)))(
        *[x.data_ptr() for x in views])
    strides = (ctypes.c_longlong * max(2, 2 * len(views)))(
        *[s for x in views for s in x.stride()])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    dims = (ctypes.c_longlong * _N_DIMS)(
        m, n, k, vm, vn, vk, *a_strides, *b_strides, plan.splits,
        plan.kchunk)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), ptrs, strides, out_ptrs, dims,
                index, None if ws is None else ws.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"GEMM kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    BODY_LAUNCHES[plan.body].launches += 1
    FFMA_SCALAR_LAUNCHES.launches += scalar
    return outs


def matmul_kernel(a: torch.Tensor, b: torch.Tensor,
                  tile: str) -> torch.Tensor:
    """The §4.5 library GEMM: ``a @ b`` in ``a``'s dtype, f32 accumulation,
    at the library ``tile`` (an empty epilogue on the same template)."""
    m, k = a.shape
    n = b.shape[1]
    (out,) = matmul_epilogue_kernel(a, b, [], identity_program(a.dtype),
                                    (m, n, k), [a.dtype], tile=tile)
    return out

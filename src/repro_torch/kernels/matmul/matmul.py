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
  stride): a new length inside a bucket, or a new bucket, launches the
  library already built.  The kernel masks the K tail of both operands to
  zero, stores exact zeros in the M/N tails, and reads the padded
  operands as they are (no padded copies: the reference pads to block
  multiples on the host).
* **What bounds it on an H100: operations.**  At the path's shapes
  (T × 2048 × 5632 and T × 5632 × 2048) the GEMM does some 700 flops
  per byte it must move, above the card's balance point.  f32 operands
  run in IEEE f32 FFMA on the CUDA cores (as the reference contracts;
  never TF32): 128 × 128 block tiles, 8 × 8 outputs per thread in
  registers, register-staged double buffering; its ceiling is the
  67 TFLOP/s FFMA rate.  bf16 / f16 operands run on the tensor cores
  (``mma.sync.m16n8k16``, f32 accumulator, fragments through
  ``ldmatrix``); the card's full 989 TFLOP/s needs ``wgmma`` and TMA,
  which are a later version's work.

:data:`TILES` holds the tile shapes: ``"kdot"`` for the fused entry and
one per §4.5 library version (``ops.GEMM_LIBRARY`` keeps the reference's
version names and divisibility rules; edge masking makes any tile safe on
any shape).  The tensor-core body takes the block tile (BM, BN) of each
and a K step of 32.
"""
from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, List, Sequence, Tuple

import torch

from .. import cuda_build
from ..program import (Program, cuda_lines, cuda_load, cuda_store,
                       cuda_type)

__all__ = ["TILES", "INCLUDE_DIRS", "matmul_epilogue_kernel",
           "matmul_kernel", "identity_program", "kernel_source", "prebuild"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: the include directories of every generated source (``gemm.cuh`` and
#: the shared ``mma_sm90.cuh``)
INCLUDE_DIRS = [CSRC, cuda_build.COMMON_CSRC]

#: tile name -> (BM, BN, BK, TM, TN): block tile, K step, outputs per
#: thread.  Threads per block = (BM / TM) * (BN / TN).
TILES: Dict[str, Tuple[int, int, int, int, int]] = {
    "kdot": (128, 128, 8, 8, 8),
    "square_big": (128, 128, 8, 8, 8),
    "balanced": (64, 64, 16, 4, 4),
    "skinny_m": (32, 64, 16, 4, 4),
    "skinny_n": (64, 32, 16, 4, 4),
    "deep_k": (64, 64, 32, 4, 4),
}

#: the tile instances each kind of library carries
KDOT_TILES = ("kdot",)
LIBRARY_TILES = ("square_big", "balanced", "skinny_m", "skinny_n", "deep_k")

_OPERAND_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MMA_DTYPES = (torch.bfloat16, torch.float16)  # run on mma.sync
_ACC_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_N_DIMS = 10  # M N K vm vn vk sam sak sbk sbn

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
    L += ["  long long ld;",
          "  __device__ __forceinline__ void operator()(int m, int n, "
          "float acc, bool keep) const {",
          "    const long long o = (long long)m * ld + n;",
          "    if (!keep) {"]
    for k, dt in enumerate(program.out_dtypes):
        L.append(f"      o{k}[o] = {cuda_store(dt, '0')};")
    L += ["      return;", "    }",
          f"    const float v0 = {acc};"]
    for i in range(1, n_in):
        dt = program.in_dtypes[i]
        x = f"x{i}[(long long)m * x{i}_sm + (long long)n * x{i}_sn]"
        L.append(f"    const auto v{i} = {cuda_load(dt, x)};")
    L += body
    for k, (name, dt) in enumerate(zip(outs, program.out_dtypes)):
        L.append(f"    o{k}[o] = {cuda_store(dt, name)};")
    L += ["  }", "};", "",
          'extern "C" int disc_gemm(const void* a, const void* b, '
          "const void* const* extras, const long long* xstrides, "
          "void* const* outs, const long long* dims, int tile, "
          "void* stream) {",
          "  disc::GemmArgs g;",
          "  g.M = (int)dims[0]; g.N = (int)dims[1]; g.K = (int)dims[2];",
          "  g.vm = (int)dims[3]; g.vn = (int)dims[4]; g.vk = (int)dims[5];",
          "  g.sam = dims[6]; g.sak = dims[7]; g.sbk = dims[8]; "
          "g.sbn = dims[9];",
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
        bm, bn, bk, tm, tn = TILES[tname]
        if dtype in _MMA_DTYPES:  # tensor cores: the block tile only
            launch = f"launch_gemm_mma<{bm}, {bn}>"
        else:
            launch = f"launch_gemm<{bm}, {bn}, {bk}, {tm}, {tn}>"
        L.append(f"    case {t}: return (int)disc::{launch}(A, B, g, epi, "
                 f"s);  // {tname}")
    L += ["  }", "  return (int)cudaErrorInvalidValue;", "}", ""]
    name = f"gemm_{program.key}_{str(dtype).split('.')[-1]}_" + \
        "-".join(tiles)
    return name, "\n".join(L)


def _bind(lib: ctypes.CDLL):
    fn = lib.disc_gemm
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
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
    ptrs = (ctypes.c_void_p * max(1, len(views)))(
        *[x.data_ptr() for x in views])
    strides = (ctypes.c_longlong * max(2, 2 * len(views)))(
        *[s for x in views for s in x.stride()])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    dims = (ctypes.c_longlong * _N_DIMS)(
        m, n, k, vm, vn, vk, *a.stride(), *b.stride())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), ptrs, strides, out_ptrs, dims,
                index, stream)
    if rc != 0:
        raise RuntimeError(f"GEMM kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
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

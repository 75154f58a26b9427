"""Building generated Triton kernels, and the strided indexing they share.

The cluster kernels are generated per fusion-cluster program as Triton
source text (``triton.jit`` needs a real source file).  :func:`load_kernel`
writes the text under ``build/torch_kernels/`` at the repository root (a
directory git ignores) on first use, imports it, and caches the module by
its name — which carries the program's fingerprint, the dtypes and the
block configuration — so the 22 identical layers of a model share one
compiled kernel per cluster shape.  Triton's own cache
(``TRITON_CACHE_DIR``) points into the same directory.

Nothing here imports Triton: the generated modules do, when the first
kernel is built on a machine with a card.

Kernel operands are tensors *broadcastable* to the iteration shape, with
any strides: :func:`index_terms` describes how a flat iteration index maps
to an operand's storage offset, so broadcast operands are read in place
instead of being materialized at full size first.
"""
from __future__ import annotations

import importlib.util
import os
import pathlib
import sys
import threading
from typing import Callable, Dict, List, Sequence, Tuple

import torch

__all__ = ["BUILD_DIR", "triton", "load_kernel", "index_terms",
           "term_source", "LaunchCounter"]

#: repo-root/build/torch_kernels (src/repro_torch/kernels/<this file>)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "torch_kernels"

_LOCK = threading.Lock()
_MODULES: Dict[str, object] = {}


def triton():
    """The ``triton`` module, imported with its cache pointed into
    ``build/torch_kernels/`` (first use only; never at module import)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton_cache"))
    import triton as _triton

    return _triton


def load_kernel(name: str, make_source: Callable[[], str]):
    """Import the generated module ``name``; ``make_source()`` generates
    its text the first time the name is asked for."""
    mod = _MODULES.get(name)
    if mod is not None:
        return mod
    with _LOCK:
        mod = _MODULES.get(name)
        if mod is not None:
            return mod
        source = make_source()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        triton()
        path = BUILD_DIR / f"{name}.py"
        if not path.exists() or path.read_text() != source:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(source)
            tmp.replace(path)
        spec = importlib.util.spec_from_file_location(
            f"repro_torch_generated.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _MODULES[name] = mod
        return mod


Term = Tuple[int, int, int]  # (inner, size, stride): ((i // inner) % size) * stride


def index_terms(t: torch.Tensor, shape: Sequence[int]) -> List[Term]:
    """How the flat row-major index ``i`` over ``shape`` maps to an offset
    into ``t`` (broadcastable to ``shape``): the sum over terms of
    ``((i // inner) % size) * stride``.  Broadcast dims contribute nothing;
    dims that are contiguous in ``t`` merge into one term, so a dense
    operand is the single term ``(1, numel, 1)``."""
    strides = t.expand(tuple(shape)).stride()
    dims = [(int(n), int(st)) for n, st in zip(shape, strides) if n != 1]
    merged: List[List[int]] = []  # [size, stride] outermost first
    for n, st in dims:
        if merged and ((merged[-1][1] == 0 and st == 0)
                       or (st != 0 and merged[-1][1] == st * n)):
            merged[-1][0] *= n
            merged[-1][1] = st
        else:
            merged.append([n, st])
    terms: List[Term] = []
    inner = 1
    for n, st in reversed(merged):
        if st != 0:
            terms.append((inner, n, st))
        inner *= n
    return list(reversed(terms))


def term_source(var: str, index: str, n_terms: int, outermost: bool,
                prefix: str) -> str:
    """Source of ``var = Σ terms`` over runtime arguments named
    ``{prefix}{k}_inner/_size/_stride``.  The outermost term of a dense
    iteration never wraps, so it skips the modulo."""
    if n_terms == 0:
        return f"{var} = {index} * 0"
    parts = []
    for k in range(n_terms):
        q = f"({index} // {prefix}{k}_inner)"
        if not (outermost and k == 0):
            q = f"({q} % {prefix}{k}_size)"
        parts.append(f"{q} * {prefix}{k}_stride")
    return f"{var} = " + " + ".join(parts)


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one where it launches the
    kernel on the card, and nowhere else (the plain version does not
    count), so a run can show the main path went through the kernel."""

    def __init__(self) -> None:
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0

"""Building generated Triton kernels, and the row offsets they share.

The cluster kernels are generated per fusion-cluster program as Triton
source text (``triton.jit`` needs a real source file).  :func:`load_kernel`
writes the text under ``build/torch_kernels/`` at the repository root (a
directory git ignores) on first use, imports it, and caches the module by
its name — which carries the program's fingerprint and its operands'
structure — so the 22 identical layers of a model share one
compiled kernel per cluster shape.  Triton's own cache
(``TRITON_CACHE_DIR``) points into the same directory.

Nothing here imports Triton: the generated modules do, when the first
kernel is built on a machine with a card.

Kernel operands are tensors *broadcastable* to the iteration shape, with
any strides, read in place: ``cluster_plan`` describes each as rows ×
columns, and :func:`term_source` writes a row's offset as the sum of its
terms.
"""
from __future__ import annotations

import importlib.util
import os
import pathlib
import re
import sys
import threading
import weakref
from typing import Callable, Dict

__all__ = ["BUILD_DIR", "CLUSTER_OPTIONS", "triton", "load_kernel",
           "compiled", "ptx_accesses",
           "term_source", "LaunchCounter", "launch_counts"]

#: repo-root/build/torch_kernels (src/repro_torch/kernels/<this file>)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "torch_kernels"

#: compile options of the generated cluster kernels: nothing contracted
#: into FMAs, and libdevice without flush-to-zero (Triton's default flushes
#: subnormals in its calls: div_rn, rsqrt), so that every op rounds as the
#: plain version's does
CLUSTER_OPTIONS = dict(num_stages=1, enable_fp_fusion=False,
                       enable_reflect_ftz=False)

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


def compiled(name: str, fn: str) -> list:
    """The kernels Triton has compiled for the jit function ``fn`` of the
    generated module ``name``, one per specialisation (none if the module
    was never loaded); each has ``asm["ptx"]``, ``n_regs``, ``n_spills``."""
    mod = _MODULES.get(name)
    if mod is None:
        return []
    jit = getattr(mod, fn)
    caches = getattr(jit, "device_caches", None)
    if caches is not None:  # Triton 3: device -> (kernel cache, ...)
        return [k for c in caches.values() for k in c[0].values()]
    return [k for c in getattr(jit, "cache", {}).values() for k in c.values()]


def ptx_accesses(ptx: str) -> Dict[str, int]:
    """Global loads and stores in ``ptx`` by vector width: ``ld.v4`` /
    ``st.v4`` are 16-byte accesses of 32-bit words, ``v1`` one word or
    less."""
    out: Dict[str, int] = {}
    for op in re.findall(r"\b((?:ld|st)\.global\S*)", ptx):
        width = re.search(r"\.(v[248])\.", op)
        key = f"{op[:2]}.{width.group(1) if width else 'v1'}"
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def term_source(var: str, index: str, n_terms: int, outermost: bool,
                prefix: str) -> str:
    """Source of ``var = Σ terms`` over runtime arguments named
    ``{prefix}{k}_inner/_size/_stride`` (``cluster_plan.Operand.terms``).
    The outermost term of a dense iteration never wraps, so it skips the
    modulo."""
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
        _COUNTERS.add(self)

    def reset(self) -> None:
        self.launches = 0


#: every LaunchCounter made: a CUDA graph entry reads them around its
#: capture and adds what the capture counted on every replay
_COUNTERS: "weakref.WeakSet[LaunchCounter]" = weakref.WeakSet()


def launch_counts() -> Dict[LaunchCounter, int]:
    """Every launch counter's count now."""
    return {c: c.launches for c in list(_COUNTERS)}

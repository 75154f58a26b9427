"""Building the port's CUDA C++ kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with :mod:`ctypes`.

The CUDA counterpart of ``triton_build.py``.  A kernel module generates
the text of one ``.cu`` file per kernel instance (the GEMM template of
``matmul/csrc/gemm.cuh`` with a generated epilogue, say); this module

* writes it under ``build/torch_kernels/`` at the repository root (a
  directory git ignores) and compiles it there with ::

      nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
           --fmad=false -shared -Xcompiler -fPIC -I<csrc dirs>

  (``--fmad=false``: the generated epilogues compute each op as its own
  rounded IEEE op, as eager PyTorch does; a GEMM loop that wants fused
  multiply-adds writes ``fmaf`` itself);
* names the library by the fingerprint of its source, the headers of the
  include directories and the flags, so a library built earlier in the
  same checkout is loaded as it is, and a changed header rebuilds;
* builds several sources at once, one ``nvcc`` process each
  (:func:`build`), so a caller that knows its kernels ahead of the first
  call pays for the slowest build only.

A failing ``nvcc`` raises :class:`KernelBuildError` with its output.
Nothing here falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

import torch

from .triton_build import BUILD_DIR

__all__ = ["NVCC_FLAGS", "COMMON_CSRC", "KernelBuildError", "nvcc",
           "build", "load", "resources", "aligned_rows"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

#: headers shared by the kernels' sources (``mma_sm90.cuh``: ldmatrix,
#: mma.sync, cp.async); a source that includes them lists this directory
#: among its include directories, so its fingerprint hashes them
COMMON_CSRC = pathlib.Path(__file__).resolve().parent / "common" / "csrc"

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` was not found or refused a generated source."""


def nvcc() -> str:
    """The ``nvcc`` on ``PATH``, else the one of the toolkit PyTorch
    finds (``CUDA_HOME``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")


def _fingerprint(source: str, include_dirs: Sequence[pathlib.Path]) -> str:
    h = hashlib.sha1(source.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for d in include_dirs:
        for p in sorted(pathlib.Path(d).glob("*.cuh")):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _paths(name: str, source: str, include_dirs) -> Tuple[str, pathlib.Path]:
    key = f"{name}_{_fingerprint(source, include_dirs)}"
    return key, BUILD_DIR / f"{key}.so"


def build(jobs: Sequence[Tuple[str, str, Sequence[pathlib.Path]]]
          ) -> List[pathlib.Path]:
    """Compile every ``(name, source, include_dirs)`` not built yet, one
    ``nvcc`` process each, all started together; returns the libraries'
    paths in the order of ``jobs``.  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: List[pathlib.Path] = []
    running = []
    for name, source, include_dirs in jobs:
        key, lib = _paths(name, source, include_dirs)
        out.append(lib)
        if lib.exists() or any(r[1] == lib for r in running):
            continue
        src = BUILD_DIR / f"{key}.cu"
        src.write_text(source)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS,
               *[f"-I{pathlib.Path(d)}" for d in include_dirs],
               "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((proc, lib, tmp, src))
    failures = []
    for proc, lib, tmp, src in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src} (exit {proc.returncode})"
                            f":\n{log}")
            continue
        tmp.replace(lib)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return out


def load(name: str, source: str,
         include_dirs: Sequence[pathlib.Path]) -> ctypes.CDLL:
    """The loaded library built from ``source`` (built first if needed)."""
    key, lib = _paths(name, source, include_dirs)
    hit = _LIBS.get(key)
    if hit is not None:
        return hit
    with _LOCK:
        hit = _LIBS.get(key)
        if hit is None:
            (path,) = build([(name, source, include_dirs)])
            hit = _LIBS[key] = ctypes.CDLL(str(path))
        return hit


def resources(job: Tuple[str, str, Sequence[pathlib.Path]]) -> dict:
    """Registers, stack, static shared and local memory of each kernel
    instance of the library built from ``job`` (``cuobjdump
    -res-usage``), and its FFMA and tensor-core instructions
    (``cuobjdump -sass``: HMMA, ``mma.sync``; HGMMA, ``wgmma``), keyed
    by the demangled name and template arguments without the epilogue
    type.  Raises ``OSError`` where the toolkit has no ``cuobjdump``."""
    (lib,) = build([job])
    tool = pathlib.Path(nvcc()).with_name("cuobjdump")
    if not tool.exists():
        found = shutil.which("cuobjdump")
        if found is None:
            raise OSError("no cuobjdump")
        tool = pathlib.Path(found)

    def dump(flag):
        return subprocess.run([str(tool), flag, str(lib)],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout

    usage = re.findall(r"Function ([^\s:]+):\s*REG:(\d+) STACK:(\d+) "
                       r"SHARED:(\d+) LOCAL:(\d+)", dump("-res-usage"))
    ops: dict = {}
    fn = None
    for line in dump("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn is not None:
            for op, pat in (("HGMMA", r"\bHGMMA\."), ("HMMA", r"\bHMMA\."),
                            ("FFMA", r"\bFFMA\b")):
                if re.search(pat, line):
                    ops.setdefault(fn, {}).setdefault(op, 0)
                    ops[fn][op] += 1
    names = [u[0] for u in usage]
    filt = pathlib.Path(nvcc()).with_name("cu++filt")
    shown = names
    if filt.exists() and names:
        out = subprocess.run([str(filt)], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0:
            shown = out.stdout.splitlines()
    res = {}
    for (name, reg, stack, shared, local), pretty in zip(usage, shown):
        # the name and template arguments, without the parameter list
        pretty = (pretty[:pretty.index(">(") + 1] if ">(" in pretty
                  else pretty.split("(")[0])
        pretty = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|"
                        r"disc::", "", pretty)
        pretty = re.sub(r", Epi>$", ">", pretty)
        counts = ops.get(name, {})
        res[pretty] = dict(reg=int(reg), stack=int(stack),
                           static_shared=int(shared), local=int(local),
                           hgmma=counts.get("HGMMA", 0),
                           hmma=counts.get("HMMA", 0),
                           ffma=counts.get("FFMA", 0))
    return res


def aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last axis is unit-stride and every row starts
    on 16 bytes (kernels that move 16-byte chunks read it in place), else
    a contiguous copy."""
    vec = 16 // t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % vec for s in t.stride()[:-1])):
        return t.contiguous()
    return t

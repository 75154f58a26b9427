"""Where a kernel wrapper chooses between its kernel and its plain version.

The serve path's wrappers (``flash_attention/ops.py``, ``rmsnorm/ops.py``)
run the kernel for a CUDA tensor and the plain PyTorch version for a CPU
tensor; any other device raises.  :func:`plain_versions` is the one
explicit way to get the plain versions on the card: the DHLO bridge
traces model functions inside it (so the fake CUDA tensors of its trace
never reach a kernel, and the traced plan is the plain one), and tests
and ``chip_smoke.py`` use it to compare the kernels with their plain
versions on the same card inputs.  Nothing falls back: a kernel that
fails to build or launch raises.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

__all__ = ["plain_versions", "in_plain_versions", "use_kernel"]

_PLAIN = contextvars.ContextVar("repro_torch_plain_versions", default=False)
# open plain_versions() contexts, as a module global: dynamo reads (and
# guards on) a global, while it cannot trace ContextVar.get
_PLAIN_DEPTH = 0


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Inside this context every wrapper runs its plain version, whatever
    the device of its tensors."""
    global _PLAIN_DEPTH
    token = _PLAIN.set(True)
    _PLAIN_DEPTH += 1
    try:
        yield
    finally:
        _PLAIN_DEPTH -= 1
        _PLAIN.reset(token)


def in_plain_versions() -> bool:
    """True inside :func:`plain_versions`."""
    return _PLAIN.get()


def use_kernel(t: torch.Tensor, op: str) -> bool:
    """True where ``op``'s wrapper launches its kernel: a CUDA tensor
    outside :func:`plain_versions`.  A CPU tensor (or the context) takes
    the plain version; any other device raises.  Inside a dynamo trace
    (the body of a ``while_loop`` / ``scan`` / ``cond``, captured while
    the DHLO bridge traces it) the context is read from its module
    global: inside it the trace records the plain version, outside it
    the call raises, since a compiled graph cannot launch the kernel."""
    dev = t.device.type
    if dev == "cpu":
        return False
    if torch.compiler.is_compiling():
        if _PLAIN_DEPTH > 0:
            return False
        raise RuntimeError(
            f"{op}: a kernel wrapper on a {t.device} tensor inside "
            f"torch.compile / torch.export; trace it inside plain_versions()")
    if _PLAIN.get():
        return False
    if dev == "cuda":
        return True
    raise ValueError(f"{op}: no kernel for a tensor on {t.device}")

"""The GEMM library and the kDot entry — DISC §4.5 and §4.3.

``GEMM_LIBRARY`` keeps the JAX package's version names and block shapes
as its divisibility table, and :func:`select_gemm_version` its selection
rules, so every runtime (m, k, n) picks the version the reference picks:
that table is the §4.5 dispatch contract.  Each version then runs the
Hopper GEMM at its own tile (``matmul.TILES``), whose edge masking makes
it exact on any shape.  Shapes that fit no version go to the vendor
entry, ``torch.matmul`` (cuBLAS), as the reference's go to ``jnp.dot``.

:func:`matmul_fused` is the kDot entry of the ``"hopper"`` backend's
cluster codegen.

Device routing, with no fallback: a CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the kernel (and counts the launch) or
raises.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..program import Program
from ..triton_build import LaunchCounter
from .ref import matmul_fused_ref, matmul_ref

__all__ = ["GEMM_LIBRARY", "select_gemm_version", "matmul", "matmul_fused",
           "LAUNCHES", "EPILOGUE_LAUNCHES", "OPERAND_COPIES",
           "BODY_LAUNCHES", "FFMA_SCALAR_LAUNCHES"]

# name -> (block_m, block_k, block_n) of the reference's library: the
# divisibility table of the selection rules
GEMM_LIBRARY = {
    "square_big": (256, 128, 256),
    "balanced": (128, 128, 128),
    "skinny_m": (8, 128, 128),
    "skinny_n": (128, 128, 8),
    "deep_k": (128, 512, 128),
}

#: launches of the library GEMM (``matmul_kernel``) on the card
LAUNCHES = LaunchCounter()
#: launches of the kDot GEMM (``matmul_epilogue_kernel``) on the card
EPILOGUE_LAUNCHES = LaunchCounter()
#: operands the 16-bit (wgmma) body copied before a launch, of either
#: GEMM: a layout its TMA loads cannot read in place (``matmul.tma_ready``)
OPERAND_COPIES = LaunchCounter()
#: launches of either GEMM by the body they ran: "wgmma" (bf16 / f16
#: operands) or "ffma" (f32)
BODY_LAUNCHES = {"wgmma": LaunchCounter(), "ffma": LaunchCounter()}
#: f32 launches of either GEMM on the FFMA body's element-by-element
#: instance: an operand its 16-byte loads cannot read in place
#: (``matmul.ffma_operands``)
FFMA_SCALAR_LAUNCHES = LaunchCounter()


def select_gemm_version(m: int, k: int, n: int) -> Optional[str]:
    """Pick a library kernel for a runtime shape; None -> vendor."""
    def fits(name):
        bm, bk, bn = GEMM_LIBRARY[name]
        return m % bm == 0 and k % bk == 0 and n % bn == 0

    if m >= 1024 and n >= 1024 and fits("square_big"):
        return "square_big"
    if m <= 32 and fits("skinny_m"):
        return "skinny_m"
    if n <= 32 and fits("skinny_n"):
        return "skinny_n"
    if k >= 4 * max(m, n) and fits("deep_k"):
        return "deep_k"
    if fits("balanced"):
        return "balanced"
    return None  # vendor library (torch.matmul)


def _device(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {x.device}")
    return x.device.type


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           version: Optional[str] = None) -> torch.Tensor:
    """``a @ b`` through the library version for its shape (or
    ``version``); the vendor entry where none fits."""
    m, k = a.shape
    n = b.shape[1]
    if version is None:
        version = select_gemm_version(m, k, n)
    if version is None:
        return torch.matmul(a, b)  # vendor entry
    if version not in GEMM_LIBRARY:
        raise ValueError(f"unknown GEMM version {version!r}")
    if _device(a, "matmul") == "cpu":
        return matmul_ref(a, b)
    from .matmul import matmul_kernel

    out = matmul_kernel(a, b, version)
    LAUNCHES.launches += 1
    return out


def matmul_fused(a: torch.Tensor, b: torch.Tensor,
                 extras: Sequence[torch.Tensor], program: Program, *,
                 valid_mnk: Sequence[int],
                 out_dtypes: Sequence[torch.dtype]) -> List[torch.Tensor]:
    """(M, K) @ (K, N) with ``program`` as fused elementwise epilogue
    (kDot).  ``extras`` are epilogue operands broadcastable to (M, N);
    ``valid_mnk`` the runtime actual sizes masking the padded M/N/K
    tails.  Returns one (M, N) tensor per ``out_dtypes`` entry."""
    if _device(a, "matmul_fused") == "cpu":
        return matmul_fused_ref(a, b, extras, program, valid_mnk,
                                out_dtypes)
    from .matmul import matmul_epilogue_kernel

    outs = matmul_epilogue_kernel(a, b, extras, program, valid_mnk,
                                  out_dtypes)
    EPILOGUE_LAUNCHES.launches += 1
    return outs

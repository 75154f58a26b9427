"""Lax-level primitives PyTorch has no single ATen op for.

The DHLO bridge maps ATen ops onto the lax opcode names the IR was built
around.  One of them has no ATen counterpart at all: ``dot_general``, a
contraction with explicit batch and contracting dimensions whose result
is ``batch dims + lhs free dims + rhs free dims``.  ``torch.einsum`` and
``@`` decompose into ``view``/``permute``/``bmm`` chains while tracing,
which would scatter one contraction over several DHLO ops; registering
``dot_general`` as a custom op keeps it one traced node, exactly as
``lax.dot_general`` is one jaxpr equation in the JAX package.

Eagerly it runs as ``torch.einsum`` (cuBLAS on the card, as the JAX
package leaves the contraction to XLA), and its gradient is the two
einsums ``lax.dot_general``'s transpose rule gives.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["dot_general", "einsum_dot", "dot_general_shape"]

_LETTERS = "abcdefghijklmnopqrstuvwxyz"

DimensionNumbers = Tuple[Tuple[Sequence[int], Sequence[int]],
                         Tuple[Sequence[int], Sequence[int]]]


def _subscripts(lrank: int, rrank: int, lc, rc, lb, rb) -> str:
    lhs = list(_LETTERS[:lrank])
    rhs = list(_LETTERS[lrank:lrank + rrank])
    for a, b in zip(lc, rc):
        rhs[b] = lhs[a]
    for a, b in zip(lb, rb):
        rhs[b] = lhs[a]
    out = [lhs[a] for a in lb]
    out += [lhs[i] for i in range(lrank) if i not in set(lc) | set(lb)]
    out += [rhs[i] for i in range(rrank) if i not in set(rc) | set(rb)]
    return f"{''.join(lhs)},{''.join(rhs)}->{''.join(out)}"


def dot_general_shape(lshape, rshape, lc, rc, lb, rb) -> Tuple[int, ...]:
    """Result shape: batch dims, then lhs free dims, then rhs free dims."""
    out = [lshape[a] for a in lb]
    out += [d for i, d in enumerate(lshape) if i not in set(lc) | set(lb)]
    out += [d for i, d in enumerate(rshape) if i not in set(rc) | set(rb)]
    return tuple(out)


def einsum_dot(lhs: torch.Tensor, rhs: torch.Tensor,
               dimension_numbers: DimensionNumbers) -> torch.Tensor:
    """``lax.dot_general`` semantics through ``torch.einsum``."""
    (lc, rc), (lb, rb) = dimension_numbers
    if type(lhs) is not torch.Tensor or type(rhs) is not torch.Tensor:
        lhs, rhs = _dot_layouts(lhs, rhs, lc, rc, lb, rb)
    return torch.einsum(_subscripts(lhs.dim(), rhs.dim(), lc, rc, lb, rb),
                        lhs, rhs)


def _dot_layouts(lhs, rhs, lc, rc, lb, rb):
    """DTensor operands laid out for ``torch.einsum``, which flattens
    each operand's batch, free and contracting dims into one apiece: a
    dim keeps its sharding where it leads its group (the first batch dim,
    the first free dim, the first contracting dim), the rest are
    gathered (a counted collective) first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def lay(x, contract, batch):
        if not isinstance(x, DTensor):
            return x
        free = [d for d in range(x.dim())
                if d not in contract and d not in batch]
        lead = {g[0] for g in (list(batch), free, list(contract)) if g}
        place = tuple(p if not isinstance(p, Shard) or p.dim in lead
                      else Replicate() for p in x.placements)
        if place == tuple(x.placements):
            return x
        return x.redistribute(x.device_mesh, place)

    return lay(lhs, lc, lb), lay(rhs, rc, rb)


@torch.library.custom_op("repro_torch::dot_general", mutates_args=())
def _dot_general_op(lhs: torch.Tensor, rhs: torch.Tensor,
                    lhs_contract: List[int], rhs_contract: List[int],
                    lhs_batch: List[int], rhs_batch: List[int]
                    ) -> torch.Tensor:
    out = einsum_dot(lhs, rhs, ((lhs_contract, rhs_contract),
                                (lhs_batch, rhs_batch)))
    # a custom op's result may not alias its inputs (einsum returns a view
    # when nothing is contracted)
    if out.untyped_storage().data_ptr() in (
            lhs.untyped_storage().data_ptr(),
            rhs.untyped_storage().data_ptr()):
        out = out.clone()
    return out


@_dot_general_op.register_fake
def _(lhs, rhs, lhs_contract, rhs_contract, lhs_batch, rhs_batch):
    shape = dot_general_shape(lhs.shape, rhs.shape, lhs_contract,
                              rhs_contract, lhs_batch, rhs_batch)
    return lhs.new_empty(shape, dtype=torch.promote_types(lhs.dtype,
                                                          rhs.dtype))


def _setup_context(ctx, inputs, output):
    lhs, rhs, lc, rc, lb, rb = inputs
    ctx.save_for_backward(lhs, rhs)
    ctx.subs = _subscripts(lhs.dim(), rhs.dim(), lc, rc, lb, rb)


def _backward(ctx, grad):
    lhs, rhs = ctx.saved_tensors
    ins, out = ctx.subs.split("->")
    ls, rs = ins.split(",")
    g_lhs = g_rhs = None
    if ctx.needs_input_grad[0]:
        g_lhs = torch.einsum(f"{out},{rs}->{ls}", grad,
                             rhs.to(grad.dtype)).to(lhs.dtype)
    if ctx.needs_input_grad[1]:
        g_rhs = torch.einsum(f"{out},{ls}->{rs}", grad,
                             lhs.to(grad.dtype)).to(rhs.dtype)
    return g_lhs, g_rhs, None, None, None, None


_dot_general_op.register_autograd(_backward, setup_context=_setup_context)


#: the traced op the frontend lowers to DHLO ``dot_general``
DOT_GENERAL_OP = torch.ops.repro_torch.dot_general.default


def dot_general(lhs: torch.Tensor, rhs: torch.Tensor,
                dimension_numbers: DimensionNumbers) -> torch.Tensor:
    """``lax.dot_general`` for PyTorch: ``dimension_numbers`` is
    ``((lhs_contract, rhs_contract), (lhs_batch, rhs_batch))``."""
    (lc, rc), (lb, rb) = dimension_numbers
    return _dot_general_op(lhs, rhs, list(lc), list(rc), list(lb), list(rb))

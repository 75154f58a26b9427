"""AdamW with f32 moments over a parameter tree (nested dicts and lists
of tensors), the JAX package's ``optim/adamw.py``: plain elementwise
PyTorch, leaf by leaf, in place (the counterpart of the reference
launcher's donated state)."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
from torch.utils import _pytree

__all__ = ["OptState", "adamw_init", "adamw_update", "tree_leaves"]


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any              # f32, the params' tree
    nu: Any


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree`` in the JAX package's order: dict keys
    sorted, sequences and NamedTuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def adamw_init(params) -> OptState:
    """Step 0 and zero f32 moments shaped as ``params``, on their
    devices."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=_pytree.tree_map(zeros, params),
                    nu=_pytree.tree_map(zeros, params))


def adamw_update(params, grads, state: OptState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0
                 ) -> Tuple[Any, OptState, torch.Tensor]:
    """One AdamW step, written into the tensors passed in; returns
    ``(params, state, gnorm)``, the same params and moments updated and
    the gradients' global norm (f32, before the clip).

    The gradients are clipped by their global norm, taken in f32 over
    the leaves in the reference's tree order; the bias corrections are
    ``1 - b ** step`` in f32; the moments are f32 and each parameter goes
    back to its own dtype."""
    gsq = [g.float().square().sum() for g in tree_leaves(grads)]
    gnorm = torch.sqrt(sum(gsq))
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1 - b1 ** step.float()
    b2c = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        return p

    new = _pytree.tree_map(upd, params, grads, state.mu, state.nu)
    return new, OptState(step=step, mu=state.mu, nu=state.nu), gnorm

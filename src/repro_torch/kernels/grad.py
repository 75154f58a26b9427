"""Gradients through the hand-written kernels: the plain version's.

A kernel writes its output into a tensor from ``torch.empty`` through
``ctypes``, so the output has no ``grad_fn``: a loss taken through it
would silently lose every gradient that flows through the kernel.  The
JAX package has no backward kernel either; its model layers are plain
``jnp`` that ``jax.value_and_grad`` differentiates.  So the port's
gradient of a kernel call is the gradient of the kernel's plain version:

* the forward launches the kernel on the inputs, detached, and saves
  them;
* the backward runs the plain version again on the saved inputs, inside
  :func:`~repro_torch.kernels.select.plain_versions` and
  ``torch.enable_grad()``, and returns ``torch.autograd.grad`` of it.

The backward launches no kernel and counts no launch.  A wrapper takes
this route (:func:`kernel_call`) only where it is about to launch its
kernel with grad enabled and an input that requires grad; everywhere
else (every serve path, every CUDA graph) it launches the kernel as
before.  Arguments that are not tensors (``eps``, ``causal``, ``scale``,
an int ``q_offset``), and integer tensors (``lens``, a per-row
``q_offset``), get no gradient.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .select import in_plain_as_kernels, plain_versions

__all__ = ["kernel_call", "plain_call", "PlainGrad"]


def _needs_grad(*args: Any) -> bool:
    """True when grad is enabled and a tensor among ``args`` requires
    it."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


class PlainGrad(torch.autograd.Function):
    """The kernel's values forward, the plain version's gradient
    backward (see the module's docstring)."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, *args: Any):
        ctx.plain = plain
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.others = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*(a for a, t in zip(args, ctx.is_tensor)
                                if t))
        ctx.set_materialize_grads(False)
        with torch.no_grad():
            out = kernel(*(a.detach() if t else a
                           for a, t in zip(args, ctx.is_tensor)))
        ctx.tuple_out = isinstance(out, tuple)
        return out

    @staticmethod
    def backward(ctx, *grads: Any):
        saved = iter(ctx.saved_tensors)
        args = []
        for t, other, wants in zip(ctx.is_tensor, ctx.others,
                                   ctx.needs_input_grad[2:]):
            if not t:
                args.append(other)
                continue
            a = next(saved).detach()
            args.append(a.requires_grad_() if wants else a)
        inputs = [a for a, wants in zip(args, ctx.needs_input_grad[2:])
                  if wants]
        with torch.enable_grad(), plain_versions(), \
                torch.profiler.record_function("plain_grad_recompute"):
            out = ctx.plain(*args)
            outs = out if ctx.tuple_out else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            got = torch.autograd.grad(
                [o for o, _ in pairs], inputs, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(inputs)
        got = iter(got)
        return (None, None, *(next(got) if wants else None
                              for wants in ctx.needs_input_grad[2:]))


def kernel_call(kernel: Callable, plain: Callable, *args: Any):
    """``kernel(*args)``, differentiable as ``plain(*args)`` is.

    Without grad, or with no input that requires grad, this is exactly
    ``kernel(*args)``.  Otherwise the output (each output, for a kernel
    that returns a tuple) carries :class:`PlainGrad`'s ``grad_fn``: its
    values are the kernel's, its gradient the plain version's at the same
    inputs.  ``plain`` takes the same arguments as ``kernel``."""
    if not _needs_grad(*args):
        return kernel(*args)
    return PlainGrad.apply(kernel, plain, *args)


def plain_call(plain: Callable, *args: Any):
    """``plain(*args)``, a wrapper's plain version.  Inside
    :func:`~repro_torch.kernels.select.plain_as_kernels`, with grad and
    an input that requires it, it takes :func:`kernel_call`'s route with
    the plain version in the kernel's place."""
    if in_plain_as_kernels() and _needs_grad(*args):
        return PlainGrad.apply(plain, plain, *args)
    return plain(*args)

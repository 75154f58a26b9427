"""Train-step factory: loss, gradients, AdamW, with microbatch
accumulation and optional gradient compression, the JAX package's
``train/step.py`` on one device.

The step is functional, as the reference's: ``model.loss(params,
batch)`` is differentiated with ``torch.autograd.grad`` over the
parameter leaves (no ``nn.Module``).  On the card the model's norms and
attention run their hand-written kernels, whose gradient is their plain
version's (``kernels/grad.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.utils import _pytree

from ..models.registry import Model
from ..optim.adamw import OptState, adamw_init, adamw_update
from ..optim.compress import compress_grads, decompress_grads
from ..optim.schedule import cosine_schedule

__all__ = ["TrainConfig", "TrainState", "train_state_init",
           "train_state_for", "value_and_grad", "make_train_step"]


@dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatches: int = 1          # grad accumulation
    grad_compression: Optional[str] = None  # None | "bf16" | "topk"
    topk_frac: float = 0.01


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    residual: Any                  # error-feedback for compression (or ())


def train_state_for(params, tcfg: TrainConfig) -> TrainState:
    """The initial train state over ``params``: zero f32 moments, and a
    zero f32 residual where the config compresses gradients."""
    residual = ()
    if tcfg.grad_compression is not None:
        residual = _pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return TrainState(params=params, opt=adamw_init(params),
                      residual=residual)


def train_state_init(model: Model, generator: torch.Generator,
                     tcfg: TrainConfig, device="cuda") -> TrainState:
    """The model's random weights drawn from ``generator`` on ``device``,
    and :func:`train_state_for` over them."""
    return train_state_for(model.init(generator, device), tcfg)


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``, the grads in the
    params' tree and dtypes (zeros for a leaf the loss does not reach)."""
    leaves, spec = _pytree.tree_flatten(params)
    xs = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(_pytree.tree_unflatten(xs, spec), batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _pytree.tree_unflatten(grads, spec)


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, metrics
    ``{"loss", "lr", "step"}`` as the reference's, and ``"grad_norm"``,
    the global norm the update clips by (0-d tensors).

    The state passed in may be updated in place (the moments and the
    params are written into its tensors), the counterpart of the
    reference launcher's ``donate_argnums=(0,)``: use the state returned
    and not the one passed.  With ``microbatches = m > 1`` the batch is
    cut into m equal slices of axis 0 whose losses and grads are summed
    in f32 and scaled by ``1 / m`` (so the grads are f32; with ``m = 1``
    they are in the params' dtypes, as in the reference).  The
    optimizer's passes are the profiler range ``train_step.update``."""
    loss_fn = model.loss

    def _grads(state: TrainState, batch: Dict[str, torch.Tensor]):
        m = tcfg.microbatches
        if m > 1:
            loss = grads = None
            for i in range(m):
                mb = {k: v[i * (v.shape[0] // m):(i + 1) * (v.shape[0] // m)]
                      for k, v in batch.items()}
                l, g = value_and_grad(loss_fn, state.params, mb)
                g = _pytree.tree_map(lambda x: x.float(), g)
                loss, grads = (l, g) if loss is None else \
                    (loss + l, _pytree.tree_map(torch.add, grads, g))
            inv = 1.0 / m
            return loss * inv, _pytree.tree_map(lambda g: g * inv, grads)
        return value_and_grad(loss_fn, state.params, batch)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, grads = _grads(state, batch)
        with torch.no_grad(), \
                torch.profiler.record_function("train_step.update"):
            residual = state.residual
            if tcfg.grad_compression is not None:
                topk = (tcfg.topk_frac if tcfg.grad_compression == "topk"
                        else None)
                wire, residual = compress_grads(grads, residual,
                                                topk_frac=topk)
                grads = decompress_grads(wire)
            lr = cosine_schedule(state.opt.step, peak_lr=tcfg.peak_lr,
                                 warmup=tcfg.warmup, total=tcfg.total_steps)
            params, opt, gnorm = adamw_update(
                state.params, grads, state.opt, lr=lr,
                weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        metrics = {"loss": loss.float(), "lr": lr, "step": opt.step,
                   "grad_norm": gnorm}
        return TrainState(params=params, opt=opt, residual=residual), metrics

    return train_step

"""Plain PyTorch version of the RWKV-6 WKV recurrence.

The mirror of the JAX package's ``kernels/rwkv6/ref.py`` ``rwkv6_ref``,
vectorised over (B, H) with a loop over T, extended as the kernel is: an
optional initial state ``s0`` and per-row ``lens``, and the final state
returned.  Per step, in f32:

    kv  = k_t v_t^T     (formed in the input type: exact in f32; in bf16
                         this is the rounding the model's decode step
                         applies, models/layers.py rwkv6_apply)
    y_t = r_t . (S + u kv)
    S  <- w_t S + kv

Steps ``t >= lens[b]`` leave row b's state alone and give ``y = 0``.

The loop is one traced op, ``repro_torch::wkv_plain``, whose gradient is
a second op, ``repro_torch::wkv_plain_backward``: a hand-written reverse
recurrence over the states of a stored forward.  So a trace
(``make_fx``, the dry run's) holds one node for the forward and one for
the backward at any T, where the loop itself would unroll every step;
:data:`STEPWISE` names the loops the cost walk extends over T
(``roofline/cost.py``).  Eagerly each op runs its loop, with no
compiler in between.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rwkv6_ref", "wkv_loop", "wkv_backward_loop", "STEPWISE"]


def wkv_loop(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None,
             lens: Optional[torch.Tensor] = None, *,
             states: Optional[list] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence step by step (see the module docstring); with
    ``states`` (a list), the state each step starts from is appended to
    it."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    uf = u.float()[None, :, :, None]
    ys = []
    for i in range(t):
        if states is not None:
            states.append(s)
        kv = (k[:, :, i, :, None] * v[:, :, i, None, :]).float()
        yt = torch.einsum("bhk,bhkv->bhv", r[:, :, i].float(), s + uf * kv)
        s_new = w[:, :, i, :, None].float() * s + kv
        if lens is not None:
            keep = (i < lens).reshape(b, 1, 1)
            yt = torch.where(keep, yt, 0.0)
            s_new = torch.where(keep[..., None], s_new, s)
        s = s_new
        ys.append(yt)
    y = (torch.stack(ys, dim=2) if ys else
         torch.zeros((b, h, 0, dv), dtype=torch.float32, device=r.device))
    return y.to(r.dtype), s


def wkv_backward_loop(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor,
                      s0: Optional[torch.Tensor],
                      lens: Optional[torch.Tensor], dy: torch.Tensor,
                      ds: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv_loop`'s ``(y, s)`` against ``(dy,
    ds)``: ``(dr, dk, dv, dw, du, ds0)``, each in its input's dtype
    (``ds0`` f32).  The forward runs again, keeping the state each step
    starts from; then, from the last step to the first, with dS the
    gradient of the state a step leaves (``ds`` at the end):

        dr_t  = (S_{t-1} + diag(u) kv_t) dy_t
        dkv_t = diag(u) r_t dy_t^T + dS_t     dk_t = dkv_t v_t
                                              dv_t = dkv_t^T k_t
        dw_t  = sum_v dS_t * S_{t-1}
        du   += sum over rows of r_t * (kv_t dy_t)
        dS_{t-1} = r_t dy_t^T + diag(w_t) dS_t

    A step ``t >= lens[b]`` passes row b's dS through and gives it zero
    gradients.  In bf16, k and v take dkv rounded to their type, as the
    gradient of the forward's rounded product is."""
    b, h, t, dk = r.shape
    states: list = []
    wkv_loop(r, k, v, w, u, s0, lens, states=states)
    uf = u.float()[None, :, :, None]
    dyf = dy.float()
    d_s = ds.float()
    du = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    drs, dks, dvs, dws = [], [], [], []
    for i in reversed(range(t)):
        s_prev = states[i]
        rt = r[:, :, i].float()
        kt, vt = k[:, :, i], v[:, :, i]
        kv = (kt[..., :, None] * vt[..., None, :]).float()
        dyt = dyf[:, :, i]
        dr = torch.einsum("bhkv,bhv->bhk", s_prev + uf * kv, dyt)
        rdy = rt[..., :, None] * dyt[..., None, :]
        dkv = uf * rdy + d_s
        dw = (d_s * s_prev).sum(-1)
        dut = rt * torch.einsum("bhkv,bhv->bhk", kv, dyt)
        d_prev = rdy + w[:, :, i, :, None].float() * d_s
        if lens is not None:
            keep = (i < lens).reshape(b, 1, 1)
            dr = torch.where(keep, dr, 0.0)
            dkv = torch.where(keep[..., None], dkv, 0.0)
            dw = torch.where(keep, dw, 0.0)
            dut = torch.where(keep, dut, 0.0)
            d_prev = torch.where(keep[..., None], d_prev, d_s)
        dkv_in = dkv.to(kt.dtype)
        dks.append((dkv_in * vt[..., None, :]).sum(-1))
        dvs.append((dkv_in * kt[..., :, None]).sum(-2))
        drs.append(dr)
        dws.append(dw)
        du = du + dut.sum(0)
        d_s = d_prev

    def stacked(parts, like):
        if not parts:
            return torch.zeros_like(like)
        return torch.stack(parts[::-1], dim=2).to(like.dtype)

    return (stacked(drs, r), stacked(dks, k), stacked(dvs, v),
            stacked(dws, w), du.to(u.dtype),
            d_s.clone() if d_s is ds else d_s)


@torch.library.custom_op("repro_torch::wkv_plain", mutates_args=())
def _wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
               lens: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    y, s = wkv_loop(r, k, v, w, u, s0, lens)
    # an op's outputs never alias its inputs (T = 0 returns s0 itself)
    return y, (s.clone() if s is s0 else s)


@_wkv_plain.register_fake
def _(r, k, v, w, u, s0, lens):
    b, h, t, dk = r.shape
    return (r.new_empty((b, h, t, v.shape[-1])),
            r.new_empty((b, h, dk, v.shape[-1]), dtype=torch.float32))


@torch.library.custom_op("repro_torch::wkv_plain_backward", mutates_args=())
def _wkv_plain_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        s0: Optional[torch.Tensor],
                        lens: Optional[torch.Tensor], dy: torch.Tensor,
                        ds: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor, torch.Tensor]:
    return wkv_backward_loop(r, k, v, w, u, s0, lens, dy, ds)


@_wkv_plain_backward.register_fake
def _(r, k, v, w, u, s0, lens, dy, ds):
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(w), torch.empty_like(u),
            ds.new_empty(ds.shape, dtype=torch.float32))


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy, ds):
    r, k, v, w, u, s0, lens = ctx.saved_tensors
    b, h, t, n = r.shape
    if dy is None:
        dy = r.new_zeros((b, h, t, v.shape[-1]))
    if ds is None:
        ds = r.new_zeros((b, h, n, v.shape[-1]), dtype=torch.float32)
    *grads, ds0 = _wkv_plain_backward(r, k, v, w, u, s0, lens, dy, ds)
    return (*grads, None if s0 is None else ds0.to(s0.dtype), None)


_wkv_plain.register_autograd(_backward, setup_context=_setup)

#: the recurrence ops and the loops they run, for the cost walk: each
#: loop takes the op's arguments, and the T axis is axis 2 of the ones
#: named by index
STEPWISE = {
    torch.ops.repro_torch.wkv_plain.default: (wkv_loop, (0, 1, 2, 3)),
    torch.ops.repro_torch.wkv_plain_backward.default:
        (wkv_backward_loop, (0, 1, 2, 3, 7)),
}


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None,
              lens: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w (B, H, T, K); v (B, H, T, V); u (H, K); s0 (B, H, K, V)
    or None.  Returns ``(y (B, H, T, V) in r's dtype, s (B, H, K, V)
    f32)``: :func:`wkv_loop` as the op ``repro_torch::wkv_plain``,
    differentiable through ``repro_torch::wkv_plain_backward``."""
    return _wkv_plain(r, k, v, w, u, s0, lens)

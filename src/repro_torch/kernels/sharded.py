"""The kernel wrappers on DTensors: each kernel runs on local shards.

DTensor cannot see inside a raw kernel launch, so a wrapper that is
given a DTensor runs here: its operands are redistributed to the
placements the kernel declares, the kernel (or, on the CPU, its plain
version) runs once on each rank's local shards, and its outputs are
wrapped back into DTensors.  Where an operand's layout is not one the
kernel takes, it is redistributed first — a collective, which the
artifact's collective counter sees; nothing is replicated by itself.

The placements each kernel declares:

* **kLoop** (``fused_elementwise``): operands and outputs share one
  placement, taken from the first sharded operand; a replicated operand
  (a broadcast view) is sliced locally, with no collective.
* **kInput** (``fused_reduce``): a reduce over an axis no mesh dim
  shards runs locally; over a sharded axis each rank reduces its slice
  (its valid count ``clamp(n − r·n_loc, 0, n_loc)``, masked with the
  reduction's identity) into a ``Partial``, and one all-reduce follows.
* **kDot** (``matmul_fused``): M and N keep their sharding; a
  contraction over a sharded K gives a ``Partial`` where the epilogue is
  the identity, otherwise K is gathered first.
* **flash attention / MLA decode / WKV / SSD**: batch and heads shard.
* **RMSNorm / LayerNorm / masked softmax**: rows shard.

**Local lengths.**  A kernel that reads valid lengths on the card (kDot's
``(M, N, K)``, kInput's count, flash attention's per-row ``lens``) is
given its shard's: rank ``r`` of ``m`` along a dim of padded extent
``n·m`` holds entries ``[r·n, (r+1)·n)``, so its valid count is
``clamp(len − r·n, 0, n)``, computed on the card from the replicated
lengths and the rank's mesh coordinate — one CUDA graph still serves
every length of a bucket, and padded tails stay zero.  Per-row lengths
shard with their rows.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

__all__ = ["is_dtensor", "elementwise", "reduce", "matmul_fused", "rows",
           "flash_attention", "mla_decode", "batch_heads"]


def is_dtensor(x: Any) -> bool:
    """``x`` is a DTensor (cheap for plain tensors: no import)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _placement_types():
    from torch.distributed.tensor import Partial, Replicate, Shard
    return Partial, Replicate, Shard


def _contig(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _wrap(local: torch.Tensor, mesh, placements, shape) -> Any:
    """A kernel's local output as a DTensor of the global ``shape``,
    contiguous as its strides declare (a kernel writes a contiguous
    output; a plain version may return a view)."""
    from torch.distributed.tensor import DTensor
    if not local.is_contiguous():
        local = local.contiguous()
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contig(shape))


def _coord(mesh, dims: Sequence[int]) -> Tuple[int, int]:
    """This rank's index ``r`` over mesh dims ``dims`` (in mesh order,
    major to minor) and their size product ``m``."""
    coord = mesh.get_coordinate()
    r, m = 0, 1
    for j in sorted(dims):
        r = r * mesh.size(j) + coord[j]
        m *= mesh.size(j)
    return r, m


def _sharding(placements, d: int) -> List[int]:
    """The mesh dims sharding tensor dim ``d``."""
    _, _, Shard = _placement_types()
    return [j for j, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == d]


class _LaidOutGrad(torch.autograd.Function):
    """The identity on a DTensor's local shard whose gradient is laid out
    as the shard is.  DTensor rebuilds the shard's gradient with the
    DTensor's own strides, whatever the local gradient's layout; a plain
    version's backward may hand back a transposed one (attention's
    ``(B, H, S, hd)``), and a later ``view`` of the gradient then fails."""

    @staticmethod
    def forward(ctx, local):
        ctx.stride = local.stride()
        return local.view_as(local)

    @staticmethod
    def backward(ctx, grad):
        if grad.stride() == ctx.stride:
            return grad
        return torch.empty_strided(grad.shape, ctx.stride, dtype=grad.dtype,
                                   device=grad.device).copy_(grad)


def _local(x: Any, mesh, placements, split: Optional[tuple] = None):
    """``x``'s local shard under ``placements``: a DTensor is
    redistributed (a collective where its layout differs), and its shard
    is differentiable where it requires grad; a plain
    tensor — the same on every rank, or a broadcast view of such — is
    sliced locally.

    ``split`` is the placements of the kernel's output: over a mesh dim
    it shards while ``x`` is whole there (a norm's weight beside sharded
    rows), each rank's gradient for ``x`` is its share of a sum
    (``Partial``)."""
    if is_dtensor(x):
        if tuple(x.placements) != tuple(placements):
            x = x.redistribute(mesh, tuple(placements))
        # to_local() carries the gradient back to the DTensor (training
        # under a mesh); the bare shard is the same tensor without it
        if x.requires_grad and torch.is_grad_enabled():
            # a shard laid out as the DTensor's strides say (DTensor's
            # redistribute keeps a transposed view's strides while it
            # gathers into a fresh, contiguous shard), so that the
            # gradient DTensor rebuilds from it is laid out as it says
            if not x.is_contiguous():
                x = x.contiguous()
            grad = None
            if split is not None:
                Partial, _, Shard = _placement_types()
                grad = tuple(Partial() if isinstance(s, Shard)
                             and not isinstance(p, Shard) else p
                             for p, s in zip(placements, split))
            return _LaidOutGrad.apply(x.to_local(grad_placements=grad))
        return x._local_tensor
    if not isinstance(x, torch.Tensor):
        return x
    for d in range(x.dim()):
        dims = _sharding(placements, d)
        if not dims:
            continue
        r, m = _coord(mesh, dims)
        n = x.shape[d] // m
        x = x.narrow(d, r * n, n)
    return x


def _replicated(x: Any, mesh) -> Any:
    """``x`` whole on every rank (a DTensor is gathered)."""
    _, Replicate, _ = _placement_types()
    return _local(x, mesh, (Replicate(),) * mesh.ndim)


def _mesh_of(*xs) -> Any:
    for x in xs:
        if is_dtensor(x):
            return x.device_mesh
    raise ValueError("no DTensor among the operands")


def local_count(n: Any, r: int, n_loc: int) -> Any:
    """The valid count of slice ``r`` (extent ``n_loc``) of a dim whose
    valid length is ``n`` (an int or a tensor on the card)."""
    if isinstance(n, torch.Tensor):
        return (n - r * n_loc).clamp(min=0, max=n_loc).to(n.dtype)
    return max(0, min(int(n) - r * n_loc, n_loc))


def _common(inputs: Sequence[Any], shape: Sequence[int], mesh) -> tuple:
    """One placement per mesh dim for operands of ``shape``: the first
    dividing ``Shard`` any DTensor operand has there, else replicated."""
    _, Replicate, Shard = _placement_types()
    out = []
    for j in range(mesh.ndim):
        pj = Replicate()
        for x in inputs:
            if not is_dtensor(x) or tuple(x.shape) != tuple(shape):
                continue
            p = x.placements[j]
            if isinstance(p, Shard) and shape[p.dim] % mesh.size(j) == 0:
                pj = p
                break
        out.append(pj)
    # a dim split over several mesh dims must divide by their product
    for d in range(len(shape)):
        dims = _sharding(out, d)
        if dims and shape[d] % math.prod(mesh.size(j) for j in dims):
            for j in dims:
                out[j] = Replicate()
    return tuple(out)


def _local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for d in range(len(out)):
        dims = _sharding(placements, d)
        if dims:
            out[d] //= math.prod(mesh.size(j) for j in dims)
    return tuple(out)


# ------------------------------------------------------------ clusters --
def elementwise(fn: Callable, program, inputs: Sequence[Any], n_valid: int,
                shape: Sequence[int]) -> List[Any]:
    """kLoop on local shards: every operand (``shape``, or a broadcast
    view of it) and every output share one placement."""
    mesh = _mesh_of(*inputs)
    place = _common(inputs, shape, mesh)
    loc_shape = _local_shape(shape, place, mesh)
    if n_valid != math.prod(shape):
        raise ValueError("fused_elementwise on DTensors: the padded tail "
                         "must be the whole domain's")
    locs = [_local(x, mesh, place) for x in inputs]
    outs = fn(program, locs, math.prod(loc_shape), loc_shape)
    return [_wrap(o, mesh, place, shape) for o in outs]


def reduce(fn: Callable, program, inputs: Sequence[Any], n_valid_cols,
           kind: str, axis: int, shape: Sequence[int], out_dtype) -> Any:
    """kInput on local shards.  Over a sharded reduce axis each rank
    reduces its slice of the valid columns into a ``Partial`` of
    ``kind``, and one all-reduce follows."""
    Partial, Replicate, Shard = _placement_types()
    mesh = _mesh_of(*inputs)
    axis = axis % len(shape)
    place = _common(inputs, shape, mesh)
    loc_shape = _local_shape(shape, place, mesh)
    locs = [_local(x, mesh, place) for x in inputs]
    red = _sharding(place, axis)
    n_loc = n_valid_cols
    if red:
        r, _ = _coord(mesh, red)
        n_loc = local_count(n_valid_cols, r, loc_shape[axis])
    out = fn(program, locs, n_loc, kind, axis=axis, shape=loc_shape,
             out_dtype=out_dtype)
    op = {"sum": "sum", "max": "max", "min": "min", "prod": "product"}[kind]
    out_place = []
    for p in place:
        if isinstance(p, Shard) and p.dim == axis:
            out_place.append(Partial(op))
        elif isinstance(p, Shard) and p.dim > axis:
            out_place.append(Shard(p.dim - 1))
        else:
            out_place.append(p)
    out_shape = tuple(n for i, n in enumerate(shape) if i != axis)
    y = _wrap(out, mesh, out_place, out_shape)
    if red:
        y = y.redistribute(mesh, tuple(
            Replicate() if isinstance(p, Partial) else p
            for p in out_place))
    return y


def matmul_fused(fn: Callable, a: Any, b: Any, extras: Sequence[Any],
                 program, valid_mnk, out_dtypes) -> List[Any]:
    """kDot on local shards: per mesh dim, M (a's rows) and N (b's
    columns) keep their sharding; K sharded on both operands gives a
    ``Partial`` (the epilogue must then be the identity, else K is
    gathered first); b is gathered where its sharding conflicts with
    a's (ZeRO-3 weights are gathered per use)."""
    Partial, Replicate, Shard = _placement_types()
    mesh = _mesh_of(a, b, *extras)
    m_, k_ = a.shape
    n_ = b.shape[1]
    identity = not program.steps and not extras and \
        all(o == ("in", 0) for o in program.outs)

    def pl(x, j):
        return x.placements[j] if is_dtensor(x) else Replicate()

    pa, pb, po = [], [], []
    for j in range(mesh.ndim):
        sa, sb = pl(a, j), pl(b, j)
        ra = sa.dim if isinstance(sa, Shard) else None     # 0: M, 1: K
        rb = sb.dim if isinstance(sb, Shard) else None     # 0: K, 1: N
        size = mesh.size(j)
        if ra == 0 and m_ % size == 0:
            pa.append(Shard(0)), pb.append(Replicate()), po.append(Shard(0))
        elif ra is None and rb == 1 and n_ % size == 0:
            pa.append(Replicate()), pb.append(Shard(1)), po.append(Shard(1))
        elif identity and (ra == 1 or rb == 0) and k_ % size == 0:
            pa.append(Shard(1)), pb.append(Shard(0)), po.append(Partial())
        else:
            pa.append(Replicate()), pb.append(Replicate())
            po.append(Replicate())
    la, lb = _local(a, mesh, pa), _local(b, mesh, pb)
    out_shape = (m_, n_)
    ext_place = tuple(Replicate() if isinstance(p, Partial) else p
                      for p in po)
    lext = [_local(torch.broadcast_to(e, out_shape) if not is_dtensor(e)
                   else e, mesh, ext_place) for e in extras]
    # the shard's valid (M, N, K): dims a mesh dim splits take their
    # slice of the valid length
    vm = valid_mnk
    parts = []
    for i, (pls, d, ext) in enumerate(((pa, 0, m_), (pb, 1, n_),
                                       (pa, 1, k_))):
        dims = _sharding(pls, d)
        v = vm[i] if isinstance(vm, torch.Tensor) else vm[i]
        if dims:
            r, m = _coord(mesh, dims)
            v = local_count(v, r, ext // m)
        parts.append(v)
    if isinstance(vm, torch.Tensor):
        # made on the card (a CUDA graph captures it)
        lvm = torch.stack(parts).to(vm.dtype)
    else:
        lvm = [int(p) for p in parts]
    outs = fn(la, lb, lext, program, valid_mnk=lvm, out_dtypes=out_dtypes)
    return [_wrap(o, mesh, po, out_shape) for o in outs]


# --------------------------------------------------------------- rows --
def rows(fn: Callable, x: Any, *params: Any, **kw) -> Any:
    """A row kernel (RMSNorm, LayerNorm, masked softmax) on local shards:
    any leading dim of ``x`` may shard, the last is whole on every rank;
    its parameters (a norm's scale and bias) are replicated."""
    _, Replicate, Shard = _placement_types()
    mesh = _mesh_of(x, *params)
    last = x.dim() - 1
    place = tuple(p if isinstance(p, Shard) and p.dim != last
                  else Replicate() for p in x.placements) \
        if is_dtensor(x) else (Replicate(),) * mesh.ndim
    lx = _local(x, mesh, place)
    whole = (Replicate(),) * mesh.ndim
    lp = [_local(p, mesh, whole, split=place) for p in params]
    return _wrap(fn(lx, *lp, **kw), mesh, place, x.shape)


# ------------------------------------------------- batch / heads kernels --
def _bh_placements(x: Any, bdim: int, hdim: Optional[int], mesh) -> tuple:
    """``x``'s placements kept where they shard its batch or heads dim,
    replicated elsewhere."""
    _, Replicate, Shard = _placement_types()
    keep = {bdim} if hdim is None else {bdim, hdim}
    return tuple(p if isinstance(p, Shard) and p.dim in keep
                 else Replicate() for p in x.placements)


def _like(place: tuple, role: dict) -> tuple:
    """Placements for another operand of a (B, H, ...) lead with
    placements ``place``: mesh dims that shard the lead's batch (dim 0)
    or heads (dim 1) shard this operand's dim of that role (``role``
    maps ``"B"`` / ``"H"`` to a dim, or None where it has none)."""
    _, Replicate, Shard = _placement_types()
    out = []
    for p in place:
        r = {0: "B", 1: "H"}.get(p.dim) if isinstance(p, Shard) else None
        d = role.get(r) if r is not None else None
        out.append(Shard(d) if d is not None else Replicate())
    return tuple(out)


def _rows_of(v: Any, mesh, place: tuple, bdim: int) -> Any:
    """Per-row lengths (or offsets) for the local rows: a tensor of one
    entry a row is sliced as its rows are; anything else passes."""
    if not isinstance(v, torch.Tensor) or v.dim() == 0:
        return v
    _, Replicate, Shard = _placement_types()
    rows = tuple(Shard(0) if isinstance(p, Shard) and p.dim == bdim
                 else Replicate() for p in place)
    return _local(v, mesh, rows)


def flash_attention(fn: Callable, q: Any, k: Any, v: Any, lens: Any, *,
                    causal: bool, q_offset: Any, scale) -> Any:
    """Attention on local shards: q (B, H, Sq, D) keeps its batch and
    heads sharding; k / v (B, Hkv, Sk, D) shard batch with q and their
    heads with q's where the KV heads divide, else each rank takes the
    KV heads its query heads read (a local slice, GQA's groups intact);
    per-row ``lens`` / ``q_offset`` shard with their rows."""
    _, Replicate, Shard = _placement_types()
    mesh = _mesh_of(q, k, v)
    bh = _bh_placements(q, 0, 1, mesh) if is_dtensor(q) else \
        (Replicate(),) * mesh.ndim
    hdims = _sharding(bh, 1)
    hq, hkv = q.shape[1], k.shape[1]
    r_h, m_h = _coord(mesh, hdims) if hdims else (0, 1)
    kv_heads_split = bool(hdims) and hkv % m_h == 0
    kv_place = tuple(p if isinstance(p, Shard) and
                     (p.dim == 0 or kv_heads_split) else Replicate()
                     for p in bh)
    lq = _local(q, mesh, bh)
    lk = _local(k, mesh, kv_place, split=bh)
    lv = _local(v, mesh, kv_place, split=bh)
    if hdims and not kv_heads_split:
        # every rank's query heads read a contiguous range of KV heads
        g = hq // hkv
        hq_loc = hq // m_h
        start = (r_h * hq_loc) // g
        count = max(1, hq_loc // g)
        lk = lk[:, start:start + count]
        lv = lv[:, start:start + count]
    out = fn(lq, lk, lv, _rows_of(lens, mesh, bh, 0), causal=causal,
             q_offset=_rows_of(q_offset, mesh, bh, 0), scale=scale)
    return _wrap(out, mesh, bh, (q.shape[0], hq, q.shape[2],
                                 v.shape[-1]))


def mla_decode(fn: Callable, q_abs: Any, q_pe: Any, kv_c: Any, k_pe: Any,
               lens: Any, scale) -> Any:
    """MLA's absorbed decode on local shards: the queries (B, 1, H, ·)
    shard batch and heads, the latent cache (B, S, ·) batch only."""
    _, Replicate, Shard = _placement_types()
    mesh = _mesh_of(q_abs, q_pe, kv_c, k_pe)
    place = _bh_placements(q_abs, 0, 2, mesh) if is_dtensor(q_abs) else \
        (Replicate(),) * mesh.ndim
    cache_place = tuple(p if isinstance(p, Shard) and p.dim == 0
                        else Replicate() for p in place)
    out = fn(_local(q_abs, mesh, place), _local(q_pe, mesh, place),
             _local(kv_c, mesh, cache_place, split=place),
             _local(k_pe, mesh, cache_place, split=place),
             _rows_of(lens, mesh, place, 0), scale)
    return _wrap(out, mesh, place, q_abs.shape)


def batch_heads(fn: Callable, lead: Any, operands: Sequence[Any],
                roles: Sequence[Optional[dict]],
                out_roles: Sequence[dict], lens: Any = None) -> tuple:
    """A recurrence kernel (WKV, SSD) on local shards: the lead operand
    (B, H, ...) keeps its batch and heads sharding; each other operand
    follows by the role of its dims (``roles[i]``: ``{"B": dim, "H": dim
    or None}``, None for a non-tensor); ``lens`` shards with the rows.
    Returns the outputs wrapped by ``out_roles``."""
    mesh = _mesh_of(lead, *operands)
    place = _bh_placements(lead, 0, 1, mesh)
    locs = [_local(x, mesh, _like(place, role), split=place)
            if role is not None else x for x, role in zip(operands, roles)]
    outs = fn(*locs, lens=_rows_of(lens, mesh, place, 0))
    wrapped = []
    for o, role in zip(outs, out_roles):
        pl = _like(place, role)
        full = list(o.shape)
        for d in range(len(full)):
            dims = _sharding(pl, d)
            if dims:
                full[d] *= math.prod(mesh.size(j) for j in dims)
        wrapped.append(_wrap(o, mesh, pl, full))
    return tuple(wrapped)
